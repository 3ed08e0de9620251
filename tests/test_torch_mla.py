"""DeepSeek-V3's multi-head latent attention (MLA) and the model that runs
it, ``deepseek_v3_671b``, on the port against the JAX reference on the
CPU: the MLA layer functions, the decode cache, prefill and decode, the
greedy dense rollout and batcher, the Adafactor train step with bf16
gradient accumulation, one separate PPO iteration, the refusals, and
``chip_smoke.py`` phase 18's launch reckonings.

The smoke config in f32 (two segments: a dense MLA layer, then an MLA
layer with a 4-expert MoE FFN; an MTP module), with ``optimizer=
"adafactor"`` set explicitly (``smoke()`` forces adamw,
``tests/test_layer_gather.py:150-165``); weights from the reference's
init (``bridge.from_jax``), inputs from numpy seeds. Tolerances: 1e-5 on
layer outputs, logits, caches and a train step's loss (the forwards of
``tests/test_torch_families.py``); 1e-4 on a PPO iteration's metrics
(``tests/test_torch_separate.py``); greedy tokens identical. A train
step's params after Adafactor are held within 1e-5 plus, where the two
packages' bf16-accumulated gradients round an element to neighbouring
bf16 values (2^-8 of it), lr times the update that difference moves.
"""
import dataclasses
import pathlib
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import steps as JS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.rlhf import RLHFConfig as JaxRLHFConfig  # noqa: E402
from repro.rlhf import RLHFTrainer as JaxRLHFTrainer  # noqa: E402
from repro.rlhf import Rollout as JaxRollout  # noqa: E402
from repro.rlhf.reward import \
    make_target_token_reward as jax_target_reward  # noqa: E402
from repro.serving import ContinuousBatcher as JaxBatcher  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import steps as TS  # noqa: E402
from repro_torch.configs import MLAConfig, get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.rlhf import ModelEngine, RLHFConfig, Rollout  # noqa: E402
from repro_torch.rlhf.reward import make_target_token_reward  # noqa: E402
from repro_torch.serving import ContinuousBatcher  # noqa: E402
from repro_torch.sharding import tp as TP  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ARCH = "deepseek_v3_671b"
TOL = 1e-5
TOL_PPO = 1e-4
S = 24


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


def _cfgs(**kw):
    kw = {"param_dtype": "float32", "optimizer": "adafactor", **kw}
    return (dataclasses.replace(jax_get_config(ARCH).smoke(), **kw),
            dataclasses.replace(get_config(ARCH).smoke(), **kw))


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _cfgs()
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jcfg, tcfg, jm, jp, Model(tcfg, device="cpu"), \
        bridge.from_jax(_np(jp), tcfg, "cpu")


def _tokens(cfg, B=2, n=S, seed=3):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                               (B, n)).astype(np.int32)


def _chip_smoke():
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=0)


# ------------------------------------------------------------ the config
def test_config_segments_and_bridge_round_trip(pair):
    """Two segments (the dense first_k_dense layer, then the MoE one)
    carried into the port's one list and back bit for bit; MLA's leaves
    where the reference has them."""
    jcfg, tcfg, jm, jp, tm, tp = pair
    assert tcfg.segment_layers() == (1, 1)
    assert {k for k in jp if k.startswith("segment")} == {"segment0",
                                                           "segment1"}
    assert bridge.segment_groups(get_config(ARCH)) == [3, 58]
    back = bridge.to_jax(tp, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(_np(jp))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(_np(jp))):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    dense, moe = tp["layers"]
    assert "router" not in dense["ffn"] and "router" in moe["ffn"]
    m = tcfg.mla
    assert dense["mixer"]["kv_up"].shape == (
        m.kv_lora_rank, tcfg.num_heads * (m.qk_nope_head_dim + m.v_head_dim))
    assert "router" in tp["mtp"][0]["layer"]["ffn"]


# ------------------------------------------------------------ the layers
def _layer_inputs(cfg, seed=1, B=2, n=S):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(n, dtype=np.int32), (B, n)).copy()
    return x, pos


@pytest.mark.parametrize("window", [0, 8])
def test_mla_fwd_matches_reference(pair, window):
    """``mla_fwd`` of the dense layer's mixer, with the filled cache
    (latent, rope key, positions), against the reference's."""
    jcfg, tcfg, jm, jp, tm, tp = pair
    x, pos = _layer_inputs(tcfg)
    jmix = jax.tree.map(lambda a: a[0], jp["segment0"]["slot0"]["mixer"])
    cap = S + 4
    jout, jcache = jax.jit(lambda p, xx, pp, c: JL.mla_fwd(
        p, xx, pp, jcfg, window=window, init_cache=c))(
            jmix, jnp.asarray(x), jnp.asarray(pos),
            JL.init_mla_cache(jcfg, 2, cap, jnp.float32))
    cache = L.init_mla_cache(tcfg, 2, cap, torch.float32, "cpu")
    out, got = L.mla_fwd(tp["layers"][0]["mixer"], _t(x), _t(pos), tcfg,
                         window=window, init_cache=cache)
    assert got is cache
    _close(out.numpy(), jout)
    for name in ("c_kv", "k_rope", "pos"):
        _close(got[name].numpy(), jcache[name])


@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("absorbed", [True, False])
def test_mla_decode_matches_reference(pair, absorbed, window):
    """Three ``mla_decode`` steps after a prefill, absorbed (attention in
    the latent space) and not (the cache expanded to per-head K and V),
    against the reference's; and the two forms against each other. The
    port writes the cache in place."""
    jcfg, tcfg, jm, jp, tm, tp = pair
    x, pos = _layer_inputs(tcfg, seed=2, n=10)
    jmix = jax.tree.map(lambda a: a[0], jp["segment1"]["slot0"]["mixer"])
    mix = tp["layers"][1]["mixer"]
    cap = 12                       # the rolling buffer wraps at step 3
    _, jc = jax.jit(lambda p, xx, pp, c: JL.mla_fwd(
        p, xx, pp, jcfg, window=window, init_cache=c))(
            jmix, jnp.asarray(x), jnp.asarray(pos),
            JL.init_mla_cache(jcfg, 2, cap, jnp.float32))
    jdecode = jax.jit(lambda p, xx, pp, c: JL.mla_decode(
        p, xx, pp, c, jcfg, window=window, absorbed=absorbed))
    cache = L.init_mla_cache(tcfg, 2, cap, torch.float32, "cpu")
    L.mla_fwd(mix, _t(x), _t(pos), tcfg, window=window, init_cache=cache)
    other = {k: v.clone() for k, v in cache.items()}
    rng = np.random.default_rng(5)
    for t in range(3):
        xt = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
        p = np.array([10 + t, 11 + t], np.int32)
        jo, jc = jdecode(jmix, jnp.asarray(xt), jnp.asarray(p), jc)
        o, c = L.mla_decode(mix, _t(xt), _t(p), cache, tcfg, window=window,
                            absorbed=absorbed)
        o2, _ = L.mla_decode(mix, _t(xt), _t(p), other, tcfg, window=window,
                             absorbed=not absorbed)
        assert c is cache
        _close(o.numpy(), jo)
        _close(o.numpy(), o2.numpy())
        for name in ("c_kv", "k_rope", "pos"):
            _close(cache[name].numpy(), jc[name])


def test_mla_cache_is_the_latent(pair):
    """The decode cache holds kv_lora_rank + qk_rope_head_dim values a
    token (the reference's ``init_mla_cache``), where a plain cache of the
    same heads would hold 2 H (nope + rope + v); at full size 1,152 bytes
    a token a layer in bf16 against 81,920."""
    jcfg, tcfg = pair[:2]
    got = L.init_mla_cache(tcfg, 3, 7, torch.float32, "cpu")
    want = JL.init_mla_cache(jcfg, 3, 7, jnp.float32)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert (got["pos"] == -1).all()
    assert _chip_smoke().mla_cache_bytes(get_config(ARCH)) == (1152, 81920)


# ------------------------------------------------------------ the model
def test_forward_aux_and_mtp_logits_match_reference(pair):
    jcfg, tcfg, jm, jp, tm, tp = pair
    tokens = _tokens(tcfg)
    lj, aj, mj = jax.jit(lambda p, t: (lambda o: (o[0], o[1], jm.mtp_logits(
        p, o[2], t)))(jm.forward(p, {"tokens": t})))(jp, jnp.asarray(tokens))
    with torch.no_grad():
        lt, at, ht = tm.forward(tp, {"tokens": _t(tokens).long()})
        mt = tm.mtp_logits(tp, ht, _t(tokens).long())
    _close(lt.numpy(), lj)
    _close(float(at), float(aj))
    _close(mt.numpy(), mj)


def test_prefill_and_eight_decode_steps_match_reference(pair):
    """A right-padded prefill with ``lengths`` (the reference admits MLA
    there; ``tests/test_torch_families.py`` holds the unpadded one) and
    eight greedy decode steps from each row's own length: logits and both
    segments' caches within 1e-5."""
    jcfg, tcfg, jm, jp, tm, tp = pair
    tokens = _tokens(tcfg)
    lens = np.array([S, S - 5], np.int32)
    kw_j, kw_t = {"lengths": jnp.asarray(lens)}, {"lengths": _t(lens)}
    cap = S + 8
    lj, cj = jax.jit(lambda p, t, n: jm.prefill(p, {"tokens": t}, cap,
                                                 lengths=n))(
        jp, jnp.asarray(tokens), kw_j["lengths"])
    lt, ct = tm.prefill(tp, {"tokens": _t(tokens).long()}, cap, **kw_t)
    _close(lt.numpy(), lj)

    def caches_close():
        want = bridge.caches_from_jax(_np(cj), tcfg, "cpu")
        assert len(want) == len(ct["layers"]) == tcfg.num_layers
        for w, g in zip(want, ct["layers"]):
            assert set(w) == set(g) == {"c_kv", "k_rope", "pos"}
            for name in w:
                _close(g[name].numpy(), w[name].numpy())

    caches_close()
    tok = np.argmax(np.asarray(lj), -1).astype(np.int32)
    jdecode = jax.jit(jm.decode_step)
    for t in range(8):
        pos = (lens + t).astype(np.int32)
        lj, cj = jdecode(jp, cj, jnp.asarray(tok), jnp.asarray(pos))
        lt, ct = tm.decode_step(tp, ct, _t(tok).long(), _t(pos))
        _close(lt.numpy(), lj)
        tok = np.argmax(np.asarray(lj), -1).astype(np.int32)
    caches_close()


@pytest.mark.parametrize("buckets", [None, (16, 24)])
def test_greedy_dense_rollout_matches_reference(pair, buckets):
    """The greedy dense rollout token for token, log-probs within 1e-5;
    with a compile-bucket ladder the prompts are right-padded and the
    prefill lengths-masked."""
    jcfg, tcfg, jm, jp, tm, tp = pair
    prompts = _tokens(tcfg, n=13 if buckets else 20, seed=4)
    kw = dict(capacity=32, temperature=0.0, capture_buckets=buckets)
    want = JaxRollout(jm, jcfg, **kw).generate(
        jp, {"tokens": jnp.asarray(prompts)}, 10, jax.random.PRNGKey(0))
    got = Rollout(tm, tcfg, **kw).generate(
        tp, {"tokens": _t(prompts).long()}, 10, torch.Generator())
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    _close(got.logp.numpy(), want.logp)


def test_dense_batcher_matches_reference(pair):
    """Ragged greedy traffic on 4 slots with decode rungs (2, 4): tokens,
    steps and compile-cache stats equal the JAX batcher's; each slot's
    caches are the latent, rope key and positions."""
    jcfg, tcfg, jm, jp, tm, tp = pair
    rng = np.random.RandomState(1)
    traffic = [(rng.randint(0, tcfg.vocab_size,
                            size=int(rng.randint(4, 18))),
                int(rng.randint(3, 12))) for _ in range(6)]
    out = []
    for cls, model, cfg, params in ((JaxBatcher, jm, jcfg, jp),
                                    (ContinuousBatcher, tm, tcfg, tp)):
        cb = cls(model, cfg, params, slots=4, capacity=32, temperature=0.0,
                 seed=7, capture_buckets=(2, 4))
        for prompt, gen in traffic:
            cb.submit(prompt, gen)
        reqs = sorted(cb.queue, key=lambda r: r.rid)
        while cb.n_queued or any(r is not None for r in cb.active):
            cb.step()
        out.append(([r.out_tokens for r in reqs], cb.steps,
                    cb.compile_cache.stats()))
    assert out[1] == out[0]
    assert {frozenset(c) for c in cb.caches["layers"]} == {
        frozenset(("c_kv", "k_rope", "pos"))}


def test_paged_spec_hydra_and_tp_refuse_mla(pair):
    """What the reference refuses for MLA the port refuses: the paged
    backend (rollout and batcher), speculative decoding, the hydra
    engine; and tensor parallelism names ROADMAP A10c 7."""
    jcfg, tcfg, jm, jp, tm, tp = pair
    assert not jm.supports_paged() and not tm.supports_paged()
    assert not jm.supports_spec_decode() and not tm.supports_spec_decode()
    with pytest.raises(ValueError, match="paged"):
        Rollout(tm, tcfg, capacity=32, backend="paged", page_size=4)
    with pytest.raises(ValueError, match="paged"):
        tm.init_paged_pools(8, 4, torch.float32)
    with pytest.raises(ValueError, match="spec decode"):
        Rollout(tm, tcfg, capacity=32, temperature=0.0, spec_decode=True)
    with pytest.raises(ValueError, match="spec decode"):
        ContinuousBatcher(tm, tcfg, tp, slots=2, capacity=32,
                          temperature=0.0, spec_decode=True)
    with pytest.raises(ValueError):
        ContinuousBatcher(tm, tcfg, tp, slots=2, capacity=32,
                          cache_backend="paged", page_size=4)
    with pytest.raises(ValueError, match="hydra engine"):
        ModelEngine(tcfg, torch.Generator(), rank=4)
    with pytest.raises(NotImplementedError, match="MLA.*A10c 7"):
        TP.check_supported(tcfg, 2)


# ------------------------------------------------------------ training
def _lm_batch(cfg, seed, B=4, n=12):
    rng = np.random.default_rng(seed)
    mask = np.zeros((B, n), np.float32)
    mask[:, 3:] = 1.0
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, n)).astype(
        np.int32), "loss_mask": mask}


@pytest.mark.parametrize("kind,microbatches", [("lm", 1), ("lm", 2),
                                               ("ppo", 2)])
def test_adafactor_train_step_matches_reference(kind, microbatches):
    """One ``make_train_step`` (the MTP loss and the MoE aux loss added)
    with Adafactor against the reference's: the metrics, the factored and
    full second moments, and every param. At 2 microbatches both packages
    accumulate the gradients in bf16, the port's accumulators bf16 (at 1
    they keep autograd's dtype, f32 here)."""
    jcfg, tcfg = _cfgs(microbatches=microbatches)
    jmodel, model = JaxModel(jcfg), Model(tcfg, device="cpu")
    lr = 1e-3
    jstep = JS.make_train_step(jmodel, jcfg, kind=kind, lr=lr)
    tstep = TS.make_train_step(model, tcfg, kind=kind, lr=lr)
    assert type(tstep.optimizer).__name__ == "Adafactor"
    assert tstep.optimizer.segments == (1, 1)
    jstate = JS.init_train_state(jmodel, jcfg, jax.random.PRNGKey(3),
                                 jstep.optimizer)
    tstate = TS.init_train_state(
        model, tcfg, None, tstep.optimizer,
        params=bridge.from_jax(_np(jstate["params"]), tcfg, "cpu"))
    rng = np.random.default_rng(7)
    batch = _lm_batch(tcfg, 4)
    if kind == "ppo":
        m = batch["loss_mask"]
        batch.update(
            advantages=rng.standard_normal(m.shape).astype(np.float32),
            old_logp=((-3 + 0.1 * rng.standard_normal(m.shape)) * m
                      ).astype(np.float32),
            ref_logp=((-3 + 0.1 * rng.standard_normal(m.shape)) * m
                      ).astype(np.float32))
    acc = {}
    plain = TS._accumulated_grads
    TS._accumulated_grads = lambda *a, **kw: acc.setdefault(
        "grads", plain(*a, **kw))
    try:
        tnew, tm = tstep(tstate, {k: _t(v).long() if k == "tokens"
                                  else _t(v) for k, v in batch.items()})
    finally:
        TS._accumulated_grads = plain
    jp0 = jstate["params"]
    jnew, jm = jax.jit(jstep)(jstate, jax.tree.map(jnp.asarray, batch))
    want_dt = torch.bfloat16 if microbatches > 1 else torch.float32
    assert {t.dtype for t in leaves(acc["grads"][1])} == {want_dt}
    assert tnew["opt"]["count"] == int(jnew["opt"]["count"]) == 1
    assert set(tm) == set(jm) and "mtp_loss" in tm
    for k in jm:
        _close(float(tm[k]), float(jm[k]))
    stats = jax.tree.leaves(bridge.to_jax(tnew["opt"]["v"], tcfg))
    jstats = jax.tree.leaves(jnew["opt"]["v"])
    assert [s.shape for s in stats] == [s.shape for s in jstats]
    # at 2 microbatches the f32 microbatch gradients (equal to ~1e-7) are
    # rounded to bf16 at three places (each cast and their sum): an element
    # near a rounding boundary may sit up to two bf16 steps of the summands
    # (2 x 2^-8 of the larger) from the reference's, which where they
    # nearly cancel is much of the element itself. So there each leaf's
    # statistics are held to 2^-5 of the leaf's largest, and its params to
    # 1e-5 plus 2^-5 of its largest step (lr times the largest update)
    bf = microbatches > 1
    for a, b in zip(stats, jstats):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0 if bf else 1e-4,
                                   atol=2 ** -5 * np.abs(b).max() if bf
                                   else 1e-12)
    for a, b, b0 in zip(
            jax.tree.leaves(bridge.to_jax(tnew["params"], tcfg)),
            jax.tree.leaves(jnew["params"]), jax.tree.leaves(jp0)):
        b, b0 = np.asarray(b, np.float64), np.asarray(b0, np.float64)
        slack = 2 ** -5 * np.abs(b - b0).max() if bf else 0.0
        _close(a, b, TOL + slack)


RL_KW = dict(prompt_len=8, gen_len=8, lr=1e-2, critic_lr=1e-2, kl_coef=0.1,
             temperature=0.0, top_k=0, engine="separate")


def test_separate_ppo_iteration_matches_reference():
    """One greedy f32 separate PPO iteration of the deepseek smoke model
    (MLA, a dense and an MoE segment, the MTP loss, Adafactor on actor and
    critic) against the JAX trainer: tokens identical, metrics within
    1e-4, the trained actor within 1e-4."""
    jcfg, tcfg = _cfgs()
    jtr = JaxRLHFTrainer(jcfg, jcfg, JaxRLHFConfig(**RL_KW),
                         jax.random.PRNGKey(0),
                         reward_fn=jax_target_reward(7))
    a0, c0 = (_np(jtr.actor_state["params"]),
              _np(jtr.critic_state["params"]))
    prompts = np.random.RandomState(2).randint(0, jcfg.vocab_size, (4, 8))
    toks = []
    gen = jtr._gen

    def spy(p, key):
        ro = gen(p, key)
        toks.append(np.asarray(ro.tokens))
        return ro

    jtr._gen = spy
    want = {k: float(v) for k, v in
            jtr.train_step(jnp.asarray(prompts), jax.random.PRNGKey(0))
            .items()}
    tr = bridge.separate_trainer_from_jax(
        a0, c0, tcfg, tcfg, RLHFConfig(**RL_KW),
        reward_fn=make_target_token_reward(7), device="cpu")
    got_toks = []
    tgen = tr._gen
    tr._gen = lambda p, g: got_toks.append(tgen(p, g)) or got_toks[-1]
    got = tr.train_step(torch.from_numpy(prompts).long(),
                        torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got_toks[0].tokens.numpy(), toks[0])
    for k in ("loss", "ppo_loss", "kl", "vf_loss", "grad_norm",
              "mean_reward"):
        assert got[k] == pytest.approx(want[k], abs=TOL_PPO), k
    for a, b in zip(
            jax.tree.leaves(bridge.to_jax(tr.actor_state["params"], tcfg)),
            jax.tree.leaves(_np(jtr.actor_state["params"]))):
        _close(a, b, TOL_PPO)
    assert tr.actor_state["opt"]["count"] == 1


def test_memory_accounting_counts_bf16_gradients(pair):
    """``memory_accounting``'s gradient item is 2 bytes a trainable for
    any optimizer but AdamW (the reference's ``grad_item``), and the
    optimizer bytes Adafactor's statistics: on a llama smoke trunk (the
    hydra engine takes no MLA) with each optimizer."""
    for opt, item in (("adamw", 4), ("adafactor", 2)):
        cfg = dataclasses.replace(get_config("llama3_2_3b").smoke(),
                                  optimizer=opt)
        eng = ModelEngine(cfg, torch.Generator().manual_seed(0), rank=4)
        acc = eng.memory_accounting()
        n = sum(t.numel() for t in leaves(eng.base_params))
        assert acc["separate"]["actor"]["grad"] == item * n
        if opt == "adafactor":
            assert acc["separate"]["actor"]["opt"] < 8 * n


# ------------------------------------- chip_smoke.py phase 18's reckonings
@pytest.fixture
def card_counts(monkeypatch):
    """The kernels' wrappers stood in for by their plain versions and
    every tensor taken for a card's, so a CPU run counts the launches the
    card's would (``tests/test_torch_families.py::card_counts``)."""
    chip_smoke = _chip_smoke()
    from repro_torch.kernels import ops, ref

    monkeypatch.setattr(ops, "_on_cpu", lambda t: False)
    monkeypatch.setattr(ops._fa, "flash_attention_fwd",
                        lambda q, k, v, **kw: ref.attention_ref(q, k, v, **kw))
    monkeypatch.setattr(ops._fab, "flash_attention_bwd",
                        ref.flash_attention_bwd_ref)
    monkeypatch.setattr(ops._dec, "decode_attention",
                        ref.decode_attention_ref)
    monkeypatch.setattr(ops._rn, "rmsnorm", ref.rmsnorm_ref)
    monkeypatch.setattr(ops._rn, "rmsnorm_bwd",
                        lambda x, s, dy, eps, dscale=True:
                        ref.rmsnorm_bwd_ref(x, s, dy, eps))
    for name, value in (("BATCH", 2), ("PROMPT", 16), ("GEN", 4)):
        monkeypatch.setattr(chip_smoke, name, value)
    return chip_smoke


def test_phase18_serving_launch_reckoning(card_counts):
    """Two requests through ``serve.run`` on the deepseek smoke model:
    B2 once an MLA layer a request, no B3 (the absorbed decode is plain
    products), B1 at four norms a layer (norm1, q_norm, kv_norm, norm2)
    and the final one, at the prefill and each step."""
    chip_smoke = card_counts
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    cfg = get_config(ARCH).smoke()
    ops.reset_launches()
    serve.run(cfg, batch=2, prompt_len=16, gen=4, requests=2, device="cpu",
              log=lambda s: None)
    assert dict(ops.launches) == chip_smoke.serve_launches(cfg, 2)
    assert chip_smoke.step_norms(cfg) == 4 * cfg.num_layers + 1
    assert dict(ops.launches)["decode_attention"] == 0


@pytest.mark.parametrize("cut", ["dense_mtp", "moe"])
def test_phase18_train_launch_reckoning(card_counts, cut):
    """One Adafactor ``make_train_step`` of kind "lm" on phase 18's two
    cuts of deepseek, at the smoke width, remat "full": the trunk's first
    dense layer with its MTP module (a dense MTP layer, the reference's
    last segment's kind) at 2 microbatches, and one MoE layer without
    MTP at 1: launches as ``train_launches`` reckons them."""
    chip_smoke = card_counts
    from repro_torch.kernels import ops
    kw = dict(num_layers=1, first_k_dense=1, microbatches=2) \
        if cut == "dense_mtp" else dict(num_layers=1, first_k_dense=0,
                                        mtp_depth=0, microbatches=1)
    cfg = dataclasses.replace(get_config(ARCH).smoke(), remat="full",
                              optimizer="adafactor", **kw)
    model = Model(cfg, device="cpu")
    step = TS.make_train_step(model, cfg, kind="lm")
    state = TS.init_train_state(model, cfg, torch.Generator().manual_seed(0),
                                step.optimizer)
    moe = ["router" in layer["ffn"] for layer in
           state["params"]["layers"] + [m["layer"] for m in
                                        state["params"].get("mtp", [])]]
    assert moe == ([False, False] if cut == "dense_mtp" else [True])
    batch = {k: _t(v).long() if k == "tokens" else _t(v)
             for k, v in _lm_batch(cfg, 2, B=2).items()}
    ops.reset_launches()
    step(state, batch)
    assert dict(ops.launches) == chip_smoke.train_launches(
        cfg, cfg.microbatches)
    assert step.optimizer.state_bytes(state["params"]) - 4 == sum(
        t.numel() * t.element_size() for t in leaves(state["opt"]["v"]))


def test_phase18_small_mla_config_takes_the_kernel_pair():
    """Phase 18 (d)'s small model: the smoke config at MLA's own head
    widths, whose q/k and v widths are the pair B2 and B2-bwd take on the
    card (the smoke's own 48 / 32 are not)."""
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import flash_attention_bwd as tfab
    m = MLAConfig(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128)
    pair_ = (m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim)
    assert pair_ in tfa.HEAD_DIMS
    assert tfab.route(torch.float32, *pair_) == "simt"
    assert tfab.route(torch.bfloat16, *pair_) == "simt"
    assert tfab.route(torch.bfloat16, 128) == "wgmma"
    sm = get_config(ARCH).smoke().mla
    with pytest.raises(ValueError, match="head_dim"):
        tfab.route(torch.float32, sm.qk_nope_head_dim + sm.qk_rope_head_dim,
                   sm.v_head_dim)
