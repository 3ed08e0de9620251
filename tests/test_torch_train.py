"""The port's training slice against the JAX reference on the CPU: the
plain backward versions of B2 and B1, the autograd of ``kernels/ops.py``,
LoRA, AdamW and clipping, the PPO math, the losses and one LoRA train
step, and the whole slice — two hydra PPO iterations, greedy, f32, from
the reference trainer's own initial weights.

Inputs are made with numpy from a seed (or carried across with
``repro_torch.bridge``) and go through both packages. Tolerances: 1e-4
for gradients, as the reference's own flash gradient test
(``tests/test_kernels.py:57``); 1e-5 for the norm and the elementwise PPO
math; 1e-4 for whole-model quantities (f32 products summed in another
order, through two PPO updates). Greedy tokens must be identical.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.flash import _flash_fwd_res, flash_sdpa  # noqa: E402
from repro.optim import clip_by_global_norm as jax_clip  # noqa: E402
from repro.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.rlhf import RLHFConfig as JaxRLHFConfig  # noqa: E402
from repro.rlhf import RLHFTrainer as JaxRLHFTrainer  # noqa: E402
from repro.rlhf import ppo as JPPO  # noqa: E402
from repro.rlhf.reward import \
    make_target_token_reward as jax_target_reward  # noqa: E402
from repro import steps as JS  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import steps as TS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import RUNTIME_RLHF_PHASE_SEQUENCE  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import lora as TLORA  # noqa: E402
from repro_torch.optim import clip_by_global_norm_, make_optimizer  # noqa: E402
from repro_torch.rlhf import (MEMORY_POLICIES, PhaseMemoryManager,  # noqa: E402
                              RLHFConfig, RLHFTrainer)
from repro_torch.rlhf import ppo as TPPO  # noqa: E402
from repro_torch.rlhf.reward import make_target_token_reward  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

GRAD_TOL = 1e-4
SMALL = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=64,
             num_heads=4, num_kv_heads=2, head_dim=16)


def small_cfgs(**kw):
    """The reference's ``tests/test_hydra.py::small_cfg`` in both packages."""
    kw = {**SMALL, **kw}
    return (dataclasses.replace(jax_get_config("llama3_2_3b").smoke(), **kw),
            dataclasses.replace(get_config("llama3_2_3b").smoke(), **kw))


def _t(a, requires_grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(requires_grad)


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x).copy(), tree)


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol, rtol=0)


def _trees_close(port_tree, jax_tree, atol):
    """Leaf for leaf, an adapter carried to the reference's layout first."""
    if "lora" in port_tree:
        port_tree = bridge.adapter_to_jax(port_tree, small_cfgs()[1])
    got = jax.tree.leaves(tree_map(lambda t: np.asarray(
        t.detach() if torch.is_tensor(t) else t), port_tree))
    want = jax.tree.leaves(jax_tree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == np.shape(b)
        _close(a, b, atol)


# ---------------------------------------------------------------- B2, B1
FLASH_GRAD_CASES = [          # tests/test_kernels.py:38-42
    (2, 64, 64, 8, 2, 32, True, 0),
    (2, 128, 128, 4, 4, 16, True, 24),
    (1, 37, 53, 6, 3, 8, False, 0),
]


def _qkv(B, Sq, Sk, H, K, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, K, D)).astype(np.float32),
            rng.standard_normal((B, Sk, K, D)).astype(np.float32),
            rng.standard_normal((B, Sq, H, D)).astype(np.float32))


@pytest.mark.parametrize("B,Sq,Sk,H,K,D,causal,window", FLASH_GRAD_CASES)
def test_attention_lse_matches_flash_residual(B, Sq, Sk, H, K, D, causal,
                                              window):
    """attention_ref's lse [B,Sq,H] against the reference's saved residual
    ``_flash_fwd_res`` lse [B,Sq,K,G]."""
    q, k, v, _ = _qkv(B, Sq, Sk, H, K, D)
    out, lse = _flash_fwd_res(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal, window, 16, 0)
    o, tl = ref.attention_ref(_t(q), _t(k), _t(v), causal=causal,
                              window=window, return_lse=True)
    _close(tl.numpy(), np.asarray(lse).reshape(B, Sq, H), 1e-5)
    _close(o.numpy(), out, 5e-5)


@pytest.mark.parametrize("B,Sq,Sk,H,K,D,causal,window", FLASH_GRAD_CASES)
def test_flash_bwd_ref_matches_flash_sdpa_vjp(B, Sq, Sk, H, K, D, causal,
                                              window):
    """flash_attention_bwd_ref against ``jax.vjp`` of the reference's
    ``flash_sdpa`` (its custom VJP ``_bwd``)."""
    q, k, v, dout = _qkv(B, Sq, Sk, H, K, D, seed=1)
    _, vjp = jax.vjp(lambda a, b, c: flash_sdpa(a, b, c, causal, window, 16),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    out, lse = ref.attention_ref(_t(q), _t(k), _t(v), causal=causal,
                                 window=window, return_lse=True)
    got = ref.flash_attention_bwd_ref(_t(q), _t(k), _t(v), out, lse,
                                      _t(dout), causal=causal, window=window,
                                      chunk=16)
    for a, b in zip(got, want):
        _close(a.numpy(), b, GRAD_TOL)


def test_rmsnorm_bwd_ref_matches_xla_grad():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, 48)).astype(np.float32)
    s = (1 + 0.1 * rng.standard_normal(48)).astype(np.float32)
    dy = rng.standard_normal((6, 48)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: JL.rms_norm(a, {"scale": b}, 1e-5),
                     jnp.asarray(x), jnp.asarray(s))
    want_dx, want_ds = vjp(jnp.asarray(dy))
    dx, ds = ref.rmsnorm_bwd_ref(_t(x), _t(s), _t(dy), 1e-5)
    _close(dx.numpy(), want_dx, 1e-5)
    _close(ds.numpy(), want_ds, 1e-5)


@pytest.mark.parametrize("B,Sq,Sk,H,K,D,causal,window",
                         [c for c in FLASH_GRAD_CASES if c[1] == c[2]])
def test_ops_autograd_on_cpu_matches_reference_grads(B, Sq, Sk, H, K, D,
                                                     causal, window):
    """The autograd functions of kernels/ops.py on CPU tensors (their
    plain versions) give the reference's gradients of a loss through
    flash_sdpa and rms_norm."""
    q, k, v, _ = _qkv(B, Sq, Sk, H, K, D, seed=3)
    s = np.linspace(0.5, 1.5, H * D).astype(np.float32)
    # a loss whose gradients stay O(1) however many rows the sum runs over
    w = np.random.default_rng(4).standard_normal((B, Sq, H * D)).astype(
        np.float32) / np.sqrt(B * Sq)

    def jloss(a, b, c, sc):
        o = flash_sdpa(a, b, c, causal, window, 16)
        y = JL.rms_norm(o.reshape(B, Sq, H * D), {"scale": sc}, 1e-5)
        return jnp.sum(y * y * w)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray,
                                                      (q, k, v, s)))
    ts = [_t(x, True) for x in (q, k, v, s)]
    o = ops.flash_attention(*ts[:3], causal=causal, window=window)
    y = ops.rmsnorm(o.reshape(B, Sq, H * D), ts[3], 1e-5)
    torch.sum(y * y * _t(w)).backward()
    for t, w in zip(ts, want):
        _close(t.grad.numpy(), w, GRAD_TOL)


def test_ops_forward_without_grad_is_the_plain_launch():
    """Serving's calls (no grad) take the forward alone: no autograd node."""
    q, k, v, _ = _qkv(1, 16, 16, 4, 2, 8)
    out = ops.flash_attention(_t(q, True), _t(k), _t(v))
    assert out.grad_fn is not None
    with torch.no_grad():
        assert ops.flash_attention(_t(q, True), _t(k), _t(v)).grad_fn is None
    assert ops.rmsnorm(_t(q), torch.ones(8)).grad_fn is None


# ------------------------------------------------------------------ LoRA
@pytest.fixture(scope="module")
def lora_setup():
    jcfg, tcfg = small_cfgs()
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    ad = jmodel.init_adapter(jax.random.PRNGKey(1), jparams, 4,
                             with_value=True)
    # nonzero B, so the delta changes the forward (test_hydra.py:26-33)
    flat, treedef = jax.tree.flatten(ad)
    ks = jax.random.split(jax.random.PRNGKey(1), len(flat))
    ad = jax.tree.unflatten(treedef, [0.05 * jax.random.normal(kk, l.shape)
                                      for kk, l in zip(ks, flat)])
    model = Model(tcfg, device="cpu")
    params = bridge.from_jax(_np(jparams), tcfg, "cpu")
    adapter = bridge.adapter_from_jax(_np(ad), tcfg, "cpu")
    tokens = np.random.default_rng(4).integers(0, 64, (2, 12))
    return jmodel, jparams, ad, model, params, adapter, tokens


def test_lora_forward_and_value_match_reference(lora_setup):
    jmodel, jparams, ad, model, params, adapter, tokens = lora_setup
    want, _, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens)},
                                adapter=ad)
    got, _ = model.forward(params, {"tokens": torch.from_numpy(tokens)},
                           adapter=adapter)
    _close(got.detach().numpy(), want, 1e-4)
    want_v = jmodel.forward_value(jparams, {"tokens": jnp.asarray(tokens)},
                                  adapter=ad)
    got_v = model.forward_value(params, {"tokens": torch.from_numpy(tokens)},
                                adapter=adapter)
    _close(got_v.detach().numpy(), want_v, 1e-4)


def test_lora_merged_matches_unmerged_and_unmerge_restores(lora_setup):
    _, _, _, model, params, adapter, tokens = lora_setup
    batch = {"tokens": torch.from_numpy(tokens)}
    unmerged, _ = model.forward(params, batch, adapter=adapter)
    merged = model.merge_adapter(params, adapter)
    merged_lg, _ = model.forward(merged, batch)
    _close(unmerged.detach().numpy(), merged_lg.numpy(), 2e-5)
    base_lg, _ = model.forward(params, batch)
    assert float((unmerged - base_lg).abs().max()) > 1e-3
    restored = model.unmerge_adapter(merged, adapter)
    for a, b in zip(leaves(params), leaves(restored)):
        _close(a.numpy(), b.numpy(), 1e-6)
    # the fresh leaves are exactly the adapted sites; the rest alias
    fresh = TLORA.merged_leaves(merged, adapter["lora"])
    n_sites = len(list(leaves(adapter["lora"]))) // 2
    assert len(fresh) == n_sites == 7 * model.cfg.num_layers
    base_ids = {id(t) for t in leaves(params)}
    assert not any(id(t) in base_ids for t in fresh)
    assert sum(id(t) in base_ids for t in leaves(merged)) == \
        len(list(leaves(params))) - n_sites
    TLORA.delete_merged(merged, adapter["lora"])
    assert TLORA.merged_leaves(merged, adapter["lora"]) == [None] * n_sites


def test_lora_rank0_is_base_forward_and_init_matches_reference_layout(
        lora_setup):
    jmodel, jparams, _, model, params, _, tokens = lora_setup
    batch = {"tokens": torch.from_numpy(tokens)}
    g = torch.Generator().manual_seed(0)
    ad0 = model.init_adapter(g, params, 0, with_value=True)
    assert ad0["lora"] == {}
    _close(model.forward(params, batch, adapter=ad0)[0].numpy(),
           model.forward(params, batch)[0].numpy(), 0)
    ad = model.init_adapter(g, params, 4, with_value=True)
    # B = 0: the initial delta is exactly zero
    _close(model.forward(params, batch, adapter=ad)[0].numpy(),
           model.forward(params, batch)[0].numpy(), 0)
    jad = jmodel.init_adapter(jax.random.PRNGKey(1), jparams, 4,
                              with_value=True)
    got = bridge.adapter_to_jax(ad, model.cfg)
    assert jax.tree.map(np.shape, got) == jax.tree.map(np.shape, jad)
    assert TLORA.adapter_param_count(ad) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(jad))
    a_std = float(torch.cat([t["a"].flatten() for layer in ad["lora"]["layers"]
                             for site in layer.values()
                             for t in site.values()]).std())
    assert 0.015 < a_std < 0.025


def test_adapter_bridge_round_trip(lora_setup):
    _, _, ad, model, _, adapter, _ = lora_setup
    back = bridge.adapter_to_jax(adapter, model.cfg)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(_np(ad))):
        assert np.array_equal(a, b)


# --------------------------------------------------------------- optim
def _grad_trees(seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": (4, 3), "b": {"c": (5,), "d": (2, 2)}}
    mk = lambda s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (jax.tree.map(mk, shapes, is_leaf=lambda x: isinstance(x, tuple)),
            jax.tree.map(mk, shapes, is_leaf=lambda x: isinstance(x, tuple)))


def test_adamw_update_and_clip_match_reference():
    params, grads = _grad_trees(5)
    grads = jax.tree.map(lambda g: 3 * g, grads)      # a norm above 1
    jc, jnorm = jax_clip(jax.tree.map(jnp.asarray, grads), 1.0)
    tc, tnorm = clip_by_global_norm_(tree_map(_t, grads), 1.0)
    _close(float(tnorm), float(jnorm), 1e-5)
    _trees_close(tc, jc, 1e-6)
    jopt, topt = jax_make_optimizer("adamw"), make_optimizer("adamw")
    jstate = jopt.init(jax.tree.map(jnp.asarray, params))
    tstate = topt.init(tree_map(_t, params))
    jp, tp = jax.tree.map(jnp.asarray, params), tree_map(_t, params)
    for step in range(2):                 # the second sees nonzero moments
        jp, jstate = jopt.update(jc, jstate, jp, 1e-2)
        topt.update_(tc, tstate, tp, 1e-2)
        _trees_close(tp, jp, 1e-6)
        _trees_close(tstate["mu"], jstate["mu"], 1e-6)
        _trees_close(tstate["nu"], jstate["nu"], 1e-6)
    assert tstate["count"] == int(jstate["count"]) == 2


# ------------------------------------------------------------ PPO math
def test_ppo_math_matches_reference():
    rng = np.random.default_rng(6)
    B, S = 3, 10
    mask = np.zeros((B, S), np.float32)
    mask[:, 4:] = 1.0
    mask[1, 8:] = 0.0                         # a row that ends early
    logp, ref_logp, values = (rng.standard_normal((B, S)).astype(np.float32)
                              for _ in range(3))
    term = np.array([0.3, -7.0, 2.0], np.float32)    # one past the clip
    jr = JPPO.kl_shaped_rewards(*map(jnp.asarray, (logp, ref_logp, term,
                                                    mask)), kl_coef=0.1)
    tr = TPPO.kl_shaped_rewards(*map(_t, (logp, ref_logp, term, mask)),
                                kl_coef=0.1)
    _close(tr.numpy(), jr, 1e-6)
    jadv, jret = JPPO.gae(jr, jnp.asarray(values), jnp.asarray(mask),
                          gamma=0.99, lam=0.95)
    tadv, tret = TPPO.gae(tr, _t(values), _t(mask), gamma=0.99, lam=0.95)
    _close(tadv.numpy(), jadv, 1e-5)
    _close(tret.numpy(), jret, 1e-5)
    _close(TPPO.whiten(tadv, _t(mask)).numpy(),
           JPPO.whiten(jadv, jnp.asarray(mask)), 1e-5)


# ----------------------------------------------------- losses and a step
@pytest.fixture(scope="module")
def step_setup(lora_setup):
    jmodel, jparams, ad, model, params, adapter, tokens = lora_setup
    rng = np.random.default_rng(7)
    B, S = tokens.shape
    mask = np.zeros((B, S), np.float32)
    mask[:, 5:] = 1.0
    exp = {"tokens": tokens.astype(np.int32), "loss_mask": mask,
           "advantages": rng.standard_normal((B, S)).astype(np.float32),
           "old_logp": (-3 + 0.1 * rng.standard_normal((B, S))
                        ).astype(np.float32) * mask,
           "ref_logp": (-3 + 0.1 * rng.standard_normal((B, S))
                        ).astype(np.float32) * mask,
           "returns": rng.standard_normal((B, S)).astype(np.float32),
           "old_values": rng.standard_normal((B, S)).astype(np.float32)}
    return jmodel, jparams, ad, model, params, adapter, exp


def _texp(exp):
    return {k: torch.from_numpy(v.astype(np.int64) if k == "tokens" else v)
            for k, v in exp.items()}


def test_losses_match_reference(step_setup):
    jmodel, jparams, ad, model, params, adapter, exp = step_setup
    jexp = jax.tree.map(jnp.asarray, exp)
    tex = _texp(exp)
    jlg, _, _ = jmodel.forward(jparams, jexp, adapter=ad)
    tlg, _ = model.forward(params, tex, adapter=adapter)
    jl, jm = JS.ppo_actor_loss(jlg, jexp, kl_coef=0.1)
    tl, tm = TS.ppo_actor_loss(tlg, tex, kl_coef=0.1)
    _close(float(tl), float(jl), 1e-5)
    for k in jm:
        _close(float(tm[k]), float(jm[k]), 1e-5)
    _close(float(TS.lm_loss(tlg, tex["tokens"], tex["loss_mask"])),
           float(JS.lm_loss(jlg, jexp["tokens"], jexp["loss_mask"])), 1e-5)
    jv = jmodel.forward_value(jparams, jexp, adapter=ad)
    tv = model.forward_value(params, tex, adapter=adapter)
    _close(float(TS.critic_loss(tv, tex)[0]),
           float(JS.critic_loss(jv, jexp)[0]), 1e-5)


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("kind", ["ppo", "critic"])
def test_lora_train_step_matches_reference(step_setup, kind, remat):
    """One make_lora_train_step: metrics and the updated adapter (so the
    clipped adapter grads through AdamW) against the reference's, with
    and without per-layer checkpointing (the reference's
    ``jax.checkpoint`` against the port's non-reentrant
    ``torch.utils.checkpoint``, whose recompute re-runs each layer with
    its adapter leaves and the autograd functions of B2 and B1)."""
    jmodel, jparams, ad, model, params, adapter, exp = step_setup
    jcfg = dataclasses.replace(jmodel.cfg, remat=remat)
    tcfg = dataclasses.replace(model.cfg, remat=remat)
    jmodel, model = JaxModel(jcfg), Model(tcfg, device="cpu")
    slot_fwd, calls = model._slot_fwd, []

    def counted(*a, **kw):
        calls.append(1)
        return slot_fwd(*a, **kw)

    model._slot_fwd = counted
    jstep = JS.make_lora_train_step(jmodel, jcfg, kind=kind, lr=1e-2)
    tstep = TS.make_lora_train_step(model, tcfg, kind=kind, lr=1e-2)
    jstate = JS.init_lora_train_state(ad, jstep.optimizer)
    tstate = TS.init_lora_train_state(tree_map(torch.clone, adapter),
                                      tstep.optimizer)
    jnew, jm = jstep(jstate, jparams, jax.tree.map(jnp.asarray, exp))
    tnew, tm = tstep(tstate, params, _texp(exp))
    # one forward and backward: under remat each layer runs again
    assert len(calls) == tcfg.num_layers * (2 if remat == "full" else 1)
    assert set(tm) == set(jm)
    for k in jm:
        _close(float(tm[k]), float(jm[k]), GRAD_TOL)
    _trees_close(tnew["params"], jnew["params"], GRAD_TOL)
    # the trunk never gets a gradient
    assert all(not t.requires_grad for t in leaves(params))


def test_microbatched_step_matches_reference(step_setup):
    """Two microbatches (``_accumulated_grads``) against the reference's
    accumulation."""
    jmodel, jparams, ad, model, params, adapter, exp = step_setup
    jcfg = dataclasses.replace(jmodel.cfg, microbatches=2)
    tcfg = dataclasses.replace(model.cfg, microbatches=2)
    jstep = JS.make_lora_train_step(jmodel, jcfg, kind="ppo", lr=1e-2)
    tstep = TS.make_lora_train_step(model, tcfg, kind="ppo", lr=1e-2)
    jnew, jm = jstep(JS.init_lora_train_state(ad, jstep.optimizer), jparams,
                     jax.tree.map(jnp.asarray, exp))
    tnew, tm = tstep(TS.init_lora_train_state(tree_map(torch.clone, adapter),
                                              tstep.optimizer),
                     params, _texp(exp))
    for k in jm:
        _close(float(tm[k]), float(jm[k]), GRAD_TOL)
    _trees_close(tnew["params"], jnew["params"], GRAD_TOL)


# ------------------------------------------------------- the whole slice
RL_KW = dict(prompt_len=8, gen_len=8, lr=3e-3, critic_lr=3e-3, kl_coef=0.1,
             temperature=0.0, top_k=0, engine="hydra", lora_rank=4)
STEPS = 2


def _run_jax(reward):
    """The reference trainer: its initial weights, and per step the greedy
    tokens, metrics, adapters and record phases."""
    jcfg, _ = small_cfgs()
    tr = JaxRLHFTrainer(jcfg, jcfg, JaxRLHFConfig(**RL_KW),
                        jax.random.PRNGKey(0),
                        reward_fn=jax_target_reward(7) if reward else None)
    init = (_np(tr.base_params), _np(tr.engine.adapters))
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 8), 0,
                                            jcfg.vocab_size))
    gen, tokens = tr._gen, []

    def spy(p, key):
        ro = gen(p, key)
        tokens.append(np.asarray(ro.tokens))
        return ro

    tr._gen = spy
    out = []
    for s in range(STEPS):
        n0 = len(tr.memory.records)
        m = tr.train_step(jnp.asarray(prompts), jax.random.PRNGKey(s))
        out.append({"metrics": {k: float(v) for k, v in m.items()},
                    "actor": _np(tr.actor_state["params"]),
                    "critic": _np(tr.critic_state["params"]),
                    "tokens": tokens[-1],
                    "phases": [r["phase"] for r in tr.memory.records[n0:]]})
    return init, prompts, out


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX trainer, run once per reward setting for the module."""
    return {reward: _run_jax(reward) for reward in (True, False)}


@pytest.mark.parametrize("reward", [True, False],
                         ids=["target_token_reward", "reward_adapter"])
def test_hydra_ppo_iterations_match_reference(jax_runs, reward):
    """Two greedy f32 hydra PPO iterations from the reference trainer's
    own initial weights: identical greedy tokens; loss, ppo_loss, kl,
    vf_loss, grad_norm and mean_reward, and the actor and critic adapters
    after each update, within 1e-4; the reference's 8 record phases."""
    (base, adapters), prompts, want = jax_runs[reward]
    _, tcfg = small_cfgs()
    tr = bridge.trainer_from_jax(
        base, adapters, tcfg, RLHFConfig(**RL_KW),
        reward_fn=make_target_token_reward(7) if reward else None,
        device="cpu")
    base_before = [t.clone() for t in leaves(tr.base_params)]
    gen, tokens = tr._gen, []

    def spy(p, g):
        ro = gen(p, g)
        tokens.append(ro.tokens.numpy())
        return ro

    tr._gen = spy
    for s, w in enumerate(want):
        n0 = len(tr.memory.records)
        m = tr.train_step(torch.from_numpy(prompts.copy()).long(),
                          torch.Generator().manual_seed(s))
        assert np.array_equal(tokens[-1], w["tokens"])
        for k in ("loss", "ppo_loss", "kl", "vf_loss", "grad_norm",
                  "mean_reward"):
            _close(m[k], w["metrics"][k], GRAD_TOL)
        _trees_close(tr.actor_state["params"], w["actor"], GRAD_TOL)
        _trees_close(tr.critic_state["params"], w["critic"], GRAD_TOL)
        assert [r["phase"] for r in tr.memory.records[n0:]] == w["phases"]
    assert w["phases"] == ["rollout_decode", *RUNTIME_RLHF_PHASE_SEQUENCE]
    for a, b in zip(base_before, leaves(tr.base_params)):
        assert torch.equal(a, b), "frozen base moved"


def test_phase_records_on_cpu_count_tracked_tensors():
    """On the CPU the live bytes are the tracked trees' (aliases once),
    the merged rollout weights show at the mid-rollout sample only, and
    the allocator's metrics are None."""
    _, tcfg = small_cfgs()
    tr = RLHFTrainer(tcfg, tcfg, RLHFConfig(**RL_KW),
                     torch.Generator().manual_seed(0),
                     reward_fn=make_target_token_reward(7))
    prompts = torch.randint(0, 64, (4, 8),
                            generator=torch.Generator().manual_seed(1))
    m = tr.train_step(prompts, torch.Generator().manual_seed(2))
    assert np.isfinite(m["loss"])
    recs = {r["phase"]: r for r in tr.memory.records}
    assert [r["phase"] for r in tr.memory.records] == \
        ["rollout_decode", *RUNTIME_RLHF_PHASE_SEQUENCE]
    merged = sum(t.numel() * t.element_size()
                 for layer in tr.base_params["layers"]
                 for part in ("mixer", "ffn") for t in layer[part].values())
    # rollout's record: the merged leaves are gone, the rollout's tokens
    # (int64), logp and mask (fp32) [4, 16] have come
    assert recs["rollout_decode"]["live_bytes"] - recs["rollout"][
        "live_bytes"] == merged - 4 * 16 * (8 + 4 + 4)
    assert all(r["reserved_bytes"] is None and r["peak_bytes"] is None
               and r["seconds"] >= 0 for r in tr.memory.records)


def test_memory_manager_validates_policy_and_records():
    with pytest.raises(ValueError):
        PhaseMemoryManager(policy="after_lunch", device="cpu")
    for policy in MEMORY_POLICIES:
        dead = {"x": torch.ones(16)}
        mm = PhaseMemoryManager(policy=policy, device="cpu",
                                tracked=lambda: dead)
        mm.boundary("rollout", "inference", dead)
        assert dead == {}
        assert mm.records[0]["live_bytes"] == 0


def test_memory_manager_defaults_to_the_card():
    """Without a device the manager records on CUDA, as every entry point
    runs, and raises where there is no card: it never falls back to the
    CPU's figures (no reserved, no peak)."""
    if torch.cuda.is_available():
        assert PhaseMemoryManager().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            PhaseMemoryManager()


def test_trainer_refuses_what_is_not_ported():
    _, tcfg = small_cfgs()
    with pytest.raises(NotImplementedError):
        RLHFTrainer(tcfg, tcfg, RLHFConfig(**{**RL_KW, "spec_decode": True}),
                    torch.Generator())
    with pytest.raises(NotImplementedError):
        TS.make_lora_train_step(Model(tcfg, device="cpu"), tcfg, shard=object())


@pytest.mark.parametrize("remat,reward", [("full", False), ("none", True),
                                          ("offload", True), ("dots", False)])
def test_ppo_launch_reckoning_matches_a_run(monkeypatch, remat, reward):
    """chip_smoke.py phase 7 asserts the launches of one PPO iteration as
    ``ppo_launches`` reckons them. Here the kernels' wrappers are stood in
    for by their plain versions and every tensor is taken for a card's,
    so a CPU iteration counts what the card's would: remat's recompute,
    the backward kernels, and the forward that does not need a gradient
    (layer 0's norm1)."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

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
    _, tcfg = small_cfgs(remat=remat, num_layers=3)
    rl = RLHFConfig(**{**RL_KW, "gen_len": 5})
    tr = RLHFTrainer(tcfg, tcfg, rl, torch.Generator().manual_seed(0),
                     reward_fn=make_target_token_reward(7) if reward
                     else None)
    ops.reset_launches()
    tr.train_step(torch.randint(0, 64, (2, 8)), torch.Generator())
    assert dict(ops.launches) == chip_smoke.ppo_launches(tcfg, rl,
                                                         not reward)
