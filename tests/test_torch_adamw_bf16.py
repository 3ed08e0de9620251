"""``adamw_bf16`` (the port's ``AdamW(moment_dtype="bfloat16")``) and the
blocked AdamW update against the JAX reference on the CPU.

* The optimizer alone, one and two steps from the same gradients against
  ``repro.optim.make_optimizer("adamw_bf16")``: fp32 params within 1e-6
  (the port's bias corrections are float64, the reference's fp32; lr
  1e-2), bf16 params within one bf16 step of the reference's; the bf16
  moments within one bf16 step of the reference's (both compute them in
  fp32 and round them once, after the step).
* One or two ``make_train_step`` steps of qwen1_5_110b's smoke model at
  2 microbatches (bf16 gradient accumulation in both packages), in fp32
  and in bf16 params: the losses within 1e-5 and the gradient norm (over
  the bf16-accumulated gradients) within 1e-5 relative in fp32 params, all
  within 2^-8 relative in bf16 params (whose forward rounds every product
  to bf16 at other places than XLA's); each moment leaf within 2^-5 of its largest, for the
  bf16 rounding of near-cancelling summands that ``tests/test_torch_mla.py``
  states; each param within 1e-5 (fp32) or one bf16 step of the param
  (bf16) plus lr x (the measured difference of the AdamW directions of
  the two packages' stored moments + 2^-6, for the rounding of both
  packages' moments to bf16) a step, as ``tests/test_torch_separate.py``'s
  ``_adam_check`` holds fp32 AdamW.
* Blocked against whole: the same bits for fp32 and bf16 moments.
* ``state_bytes``, the engine's accounting and the simulator's traced
  optimizer fraction against the reference's.
* Two PPO iterations with adamw_bf16 at offload "all" (the bf16 moments
  parked in the host lot between their phases) give the bits of
  offload "none", on both engines.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import core as JC  # noqa: E402
from repro import steps as JS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.rlhf.engine import ModelEngine as JaxModelEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import core as TC  # noqa: E402
from repro_torch import steps as TS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import AdamW, make_optimizer  # noqa: E402
from repro_torch.optim import adamw as ADAMW  # noqa: E402
from repro_torch.rlhf import ModelEngine, RLHFConfig, RLHFTrainer  # noqa: E402
from repro_torch.rlhf.reward import make_target_token_reward  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ARCH = "qwen1_5_110b"
SHAPES = [(40, 30), (7,), (5, 3, 4), (1, 9)]
LR = 1e-2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small CPU ops (the suite runs
    several test processes at once). Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x).copy(), tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _f64(t):
    if isinstance(t, torch.Tensor):
        return t.double().numpy()
    return np.asarray(t, np.float64)


def _bf16_step(x):
    """One bf16 step (ulp) at each element's magnitude."""
    x = np.abs(np.asarray(x, np.float64))
    e = np.floor(np.log2(np.maximum(x, 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _within_bf16_step(got, want):
    got, want = _f64(got), _f64(want)
    assert np.all(np.abs(got - want) <= _bf16_step(want)), \
        np.abs(got - want).max()


# ------------------------------------------------------- the optimizer
def test_make_optimizer_adamw_bf16_state():
    """bf16 moments, 4 bytes a parameter plus the count (the reference's
    ``state_bytes_per_param``), and an unknown moment dtype refused."""
    opt, jopt = make_optimizer("adamw_bf16"), jax_make_optimizer("adamw_bf16")
    assert opt == AdamW(moment_dtype="bfloat16")
    assert make_optimizer("adamw").moment_dtype == "float32"
    params = [torch.zeros(s) for s in SHAPES]
    st = opt.init(params)
    assert {t.dtype for t in [*leaves(st["mu"]), *leaves(st["nu"])]} == \
        {torch.bfloat16}
    n = sum(p.numel() for p in params)
    assert jopt.state_bytes_per_param() == 4
    assert opt.state_bytes(params) == 4 * n + 4
    assert make_optimizer("adamw").state_bytes(params) == 8 * n + 4
    with pytest.raises(ValueError, match="moment_dtype"):
        AdamW(moment_dtype="float16")


def _grads(seed, dtype):
    rng = np.random.default_rng(seed)
    return [(1e-2 * rng.standard_normal(s)).astype(np.float32)
            for s in SHAPES]


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adamw_bf16_update_matches_reference(param_dtype):
    """Two steps from the same gradients (in the params' dtype, as the
    train step hands them over at 2 microbatches): the params and the
    bf16 moments after each step against the reference's."""
    rng = np.random.default_rng(0)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[param_dtype]
    opt, jopt = make_optimizer("adamw_bf16"), jax_make_optimizer("adamw_bf16")
    pt = [_t(p).to(tdt) for p in p0]
    pj = [jnp.asarray(p, jdt) for p in p0]
    st, sj = opt.init(pt), jopt.init(pj)
    for i in range(2):
        g = _grads(i + 1, param_dtype)
        opt.update_([_t(x).to(tdt) for x in g], st, pt, LR)
        pj, sj = jopt.update([jnp.asarray(x, jdt) for x in g], sj, pj, LR)
        assert st["count"] == int(sj["count"]) == i + 1
        for name in ("mu", "nu"):
            for a, b in zip(st[name], sj[name]):
                assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
                _within_bf16_step(a, b)
        for a, b in zip(pt, pj):
            assert a.dtype == tdt
            if param_dtype == "float32":
                np.testing.assert_allclose(_f64(a), _f64(b), atol=1e-6,
                                           rtol=0)
            else:
                _within_bf16_step(a, b)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_blocked_update_equals_whole(moment_dtype, monkeypatch):
    """Three steps with ``BLOCK_ELEMS`` at 37 (rows of the first dim; the
    [1, 9] leaf is one block, the [40, 30] one 40 single-row blocks) give
    the bits of the whole-leaf update, params and moments."""
    rng = np.random.default_rng(1)
    opt = AdamW(moment_dtype=moment_dtype)
    a = [_t(rng.standard_normal(s).astype(np.float32)) for s in SHAPES]
    b = [t.clone() for t in a]
    sa, sb = opt.init(a), opt.init(b)
    for i in range(3):
        g = [_t(x) for x in _grads(10 + i, "float32")]
        opt.update_(g, sa, a, LR)
        with monkeypatch.context() as m:
            m.setattr(ADAMW, "BLOCK_ELEMS", 37)
            assert len(ADAMW._blocks(b[0])) == 40
            opt.update_(g, sb, b, LR)
    for x, y in zip(a + sa["mu"] + sa["nu"], b + sb["mu"] + sb["nu"]):
        assert torch.equal(x, y)


# ---------------------------------------------------------- the step
def _cfgs(**kw):
    kw = {"optimizer": "adamw_bf16", "microbatches": 2, **kw}
    return (dataclasses.replace(jax_get_config(ARCH).smoke(), **kw),
            dataclasses.replace(get_config(ARCH).smoke(), **kw))


def _lm_batch(cfg, seed, B=4, n=12):
    rng = np.random.default_rng(seed)
    mask = np.zeros((B, n), np.float32)
    mask[:, 3:] = 1.0
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, n)).astype(
        np.int32), "loss_mask": mask}


def _direction(m, v, count, b1=0.9, b2=0.95, eps=1e-8):
    return (m / (1 - b1 ** count)) / (np.sqrt(v / (1 - b2 ** count)) + eps)


@pytest.mark.parametrize("param_dtype,steps", [("float32", 2),
                                               ("bfloat16", 1)])
def test_adamw_bf16_train_step_matches_reference(param_dtype, steps):
    """``make_train_step(kind="lm")`` of the qwen1_5_110b smoke model with
    its own optimizer and 2 microbatches against the reference's jitted
    step (tolerances in the module docstring)."""
    jcfg, tcfg = _cfgs(param_dtype=param_dtype)
    jmodel, model = JaxModel(jcfg), Model(tcfg, device="cpu")
    lr = 1e-3
    jstep = JS.make_train_step(jmodel, jcfg, kind="lm", lr=lr)
    tstep = TS.make_train_step(model, tcfg, kind="lm", lr=lr)
    assert tstep.optimizer.moment_dtype == "bfloat16"
    assert TS.acc_dtype(tcfg) == torch.bfloat16
    jstate = JS.init_train_state(jmodel, jcfg, jax.random.PRNGKey(3),
                                 jstep.optimizer)
    tstate = TS.init_train_state(
        model, tcfg, None, tstep.optimizer,
        params=bridge.from_jax(_np(jstate["params"]), tcfg, "cpu"))
    batch = _lm_batch(tcfg, 4)
    run = jax.jit(jstep)
    bf = param_dtype == "bfloat16"
    slack = None
    for i in range(steps):
        jp_prev = [_f64(x) for x in jax.tree.leaves(jstate["params"])]
        tstate, tm = tstep(tstate, {k: _t(v).long() if k == "tokens"
                                    else _t(v) for k, v in batch.items()})
        jstate, jm = run(jstate, jax.tree.map(jnp.asarray, batch))
        assert tstate["opt"]["count"] == int(jstate["opt"]["count"]) == i + 1
        assert set(tm) == set(jm)
        for k in jm:
            want = float(jm[k])
            tol = 2 ** -8 * abs(want) if bf else \
                1e-5 * abs(want) if k == "grad_norm" else 1e-5
            assert abs(float(tm[k]) - want) <= tol, (k, float(tm[k]), want)
        mom = {}
        for name in ("mu", "nu"):
            got = [_f64(x) for x in
                   jax.tree.leaves(bridge.to_jax(tstate["opt"][name], tcfg))]
            want = [_f64(x) for x in jax.tree.leaves(jstate["opt"][name])]
            assert {x.dtype for x in
                    jax.tree.leaves(jstate["opt"][name])} == {jnp.dtype("bfloat16")}
            for a, b in zip(got, want):
                np.testing.assert_allclose(a, b, rtol=0,
                                           atol=2 ** -5 * np.abs(b).max())
            mom[name] = (got, want)
        (mu, jmu), (nu, jnu) = mom["mu"], mom["nu"]
        step = [lr * (np.abs(_direction(m, v, i + 1) -
                             _direction(jm_, jv, i + 1)) + 2 ** -6)
                for m, v, jm_, jv in zip(mu, nu, jmu, jnu)]
        slack = step if slack is None else [s + d for s, d in
                                            zip(slack, step)]
        got = [_f64(x) for x in
               jax.tree.leaves(bridge.to_jax(tstate["params"], tcfg))]
        want = [_f64(x) for x in jax.tree.leaves(jstate["params"])]
        for a, b, s, b0 in zip(got, want, slack, jp_prev):
            assert a.shape == b.shape
            base = _bf16_step(b) if bf else 1e-5
            over = np.abs(a - b) > base + s
            assert not over.any(), (np.abs(a - b)[over], s[over])
            # the step moved every fp32 leaf (a bf16 norm scale at 1.0,
            # whose step 2^-7 is over lr, stays put in both packages)
            assert bf or np.abs(b - b0).max() > 0


# ---------------------------------------------- accounting and the simulator
def test_accounting_and_traced_fractions_match_reference():
    """The hydra engine's ``memory_accounting`` (adapter and full-parameter
    optimizer bytes at 4 a parameter, bf16 gradients) and the simulator's
    traced per-device fractions at ZeRO-3, ndp 4, with ``adamw_bf16``,
    against the reference's."""
    jcfg, tcfg = _cfgs(num_heads=4, num_kv_heads=2)
    eng = ModelEngine(tcfg, torch.Generator().manual_seed(0), rank=4)
    jeng = JaxModelEngine(jcfg, jax.random.PRNGKey(0), rank=4)
    assert eng.memory_accounting() == jeng.memory_accounting()
    n = sum(t.numel() for t in leaves(eng.base_params))
    sep = eng.memory_accounting()["separate"]["actor"]
    assert sep == {"params": 4 * n, "opt": 4 * n + 4, "grad": 2 * n}
    for engine in ("separate", "hydra"):
        got = TC.traced_zero_scales(tcfg, ndp=4, zero_stage=3, engine=engine)
        want = JC.traced_zero_scales(jcfg, ndp=4, zero_stage=3,
                                     engine=engine)
        assert [k for k, _ in got] == [k for k, _ in want]
        for (k, a), (_, b) in zip(got, want):
            assert a == pytest.approx(b, rel=1e-12), (engine, k)


# ------------------------------------------------------------ offload
@pytest.mark.parametrize("engine", ["separate", "hydra"])
def test_offload_all_with_bf16_moments_matches_none(engine):
    """A bf16 micro llama with adamw_bf16 at 2 microbatches, two PPO
    iterations at offload "all" against "none" (as
    ``tests/test_torch_offload.py`` holds AdamW): the same metrics and
    every persistent tree the same bits; the optimizer trees hold bf16
    moments and the lot parked them."""
    cfg = dataclasses.replace(
        get_config("llama3_2_3b").smoke(), num_layers=2, d_model=32,
        d_ff=64, vocab_size=32, num_heads=2, num_kv_heads=1, head_dim=16,
        param_dtype="bfloat16", optimizer="adamw_bf16", microbatches=2)
    prompts = torch.randint(0, 32, (2, 4),
                            generator=torch.Generator().manual_seed(1))
    got = {}
    for level in ("none", "all"):
        rl = RLHFConfig(engine=engine, offload=level, memory_policy="none",
                        prompt_len=4, gen_len=4, lr=1e-3, critic_lr=1e-3,
                        kl_coef=0.1, temperature=0.0, top_k=0, lora_rank=2)
        tr = RLHFTrainer(cfg, cfg, rl, torch.Generator().manual_seed(0),
                         reward_fn=make_target_token_reward(7)
                         if engine == "hydra" else None)
        ms = [tr.train_step(prompts, torch.Generator().manual_seed(s))
              for s in range(2)]
        if tr.offload is not None:
            assert tr.offload_lot.stats.bytes_parked_total > 0
            for n in list(tr.offload_lot.names()):       # everything home
                tr.offload.states[n][1](tr.offload_lot.fetch(n))
        trees = tr.persistent_trees()
        opt = [t for k, v in trees.items() if k.endswith("_opt")
               for t in leaves({"mu": v["mu"], "nu": v["nu"]})]
        assert opt and {t.dtype for t in opt} == {torch.bfloat16}
        got[level] = ms, [t.detach().contiguous().view(torch.uint8)
                          for t in leaves(trees)]
    assert got["all"][0] == got["none"][0]
    assert all(torch.equal(a, b) for a, b in zip(got["all"][1],
                                                  got["none"][1]))
