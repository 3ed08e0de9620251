"""The port's MTP self-speculative decoding against the JAX reference on
the CPU: the MTP chain (init, the bridge's ``mtp``/``mtp_extra`` layouts,
``mtp_chain_logits``, ``mtp_draft``), the T-token verify forwards
(``decode_multi``, ``append_decode_multi``, ``paged_decode_multi``), the
paged suffix prefill, the speculative rollout on both backends (with
random heads, which accept almost nothing, and with a drafter that
proposes vanilla's own continuation, which accepts nearly all), the
hydra merged weights, ``spec_k`` beyond ``mtp_depth``, the MTP loss in
both train steps, and 2 PPO iterations with ``spec_decode=True`` on both
engines.

The configs are ``tests/test_specdec.py``'s tiny f32 llama (2 layers,
d_model 64, head_dim 16) at ``mtp_depth`` 1 and 3; weights come from the
reference's init through ``bridge.from_jax``, inputs from numpy with a
seed. On the CPU the kernels take their plain versions and nothing is
graphed; ``tests/test_torch_gpu.py`` holds the graphed step to the eager
one on the card.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import steps as JS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.paged import PageManager as JaxPageManager  # noqa: E402
from repro.paged import paged_cache as JPC  # noqa: E402
from repro.rlhf import RLHFConfig as JaxRLHFConfig  # noqa: E402
from repro.rlhf import RLHFTrainer as JaxRLHFTrainer  # noqa: E402
from repro.rlhf import Rollout as JaxRollout  # noqa: E402
from repro.rlhf.reward import \
    make_target_token_reward as jax_target_reward  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import steps as TS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.paged import PageManager  # noqa: E402
from repro_torch.paged import paged_cache as PC  # noqa: E402
from repro_torch.rlhf import RLHFConfig, RLHFTrainer, Rollout  # noqa: E402
from repro_torch.rlhf.reward import make_target_token_reward  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

TOL = 1e-5
MULTI_TOL = 2e-5       # tests/test_specdec.py:114
LOGP_TOL = 1e-6
METRIC_TOL = 1e-4
TINY = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=64, num_heads=4,
            num_kv_heads=2, head_dim=16, param_dtype="float32")


def _cfgs(**kw):
    kw = {**TINY, **kw}
    return (dataclasses.replace(jax_get_config("llama3_2_3b").smoke(), **kw),
            dataclasses.replace(get_config("llama3_2_3b").smoke(), **kw))


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x).copy(), tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=tol, rtol=tol)


@pytest.fixture(scope="module", params=[1, 3], ids=["depth1", "depth3"])
def setup(request):
    jcfg, tcfg = _cfgs(mtp_depth=request.param)
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = Model(tcfg, device="cpu")
    params = bridge.from_jax(_np(jparams), tcfg, "cpu")
    return jmodel, jparams, model, params


@pytest.fixture(scope="module")
def deep():
    jcfg, tcfg = _cfgs(mtp_depth=3)
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = Model(tcfg, device="cpu")
    return jmodel, jparams, model, bridge.from_jax(_np(jparams), tcfg, "cpu")


# ------------------------------------------------------------- MTP chain
def test_init_and_bridge_round_trip(setup):
    """The port's init has the reference's MTP leaves (one module a depth,
    each leaf the shape and dtype of the reference's), and the bridge
    carries ``mtp``/``mtp_extra`` across and back bit for bit."""
    jmodel, jparams, model, params = setup
    depth = model.cfg.mtp_depth
    back = bridge.to_jax(params, model.cfg)
    assert sorted(back) == sorted(jparams)
    assert ("mtp_extra" in jparams) == (depth > 1)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, np.asarray(b))
    mine = model.init(torch.Generator().manual_seed(0))
    assert len(mine["mtp"]) == len(params["mtp"]) == depth
    shapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                          bridge.to_jax(mine, model.cfg))
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jparams)
    assert shapes == want
    assert model.supports_spec_decode()
    assert not Model(dataclasses.replace(model.cfg, mtp_depth=0),
                     device="cpu").supports_spec_decode()


@pytest.mark.parametrize("window", [0, 1])
def test_mtp_chain_logits_match_reference(setup, window):
    jmodel, jparams, model, params = setup
    toks = np.random.default_rng(1).integers(0, 64, (2, 10))
    _, _, jh = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
    h = _t(jh)
    want = jmodel.mtp_chain_logits(jparams, jh, jnp.asarray(toks),
                                   window=window)
    with torch.no_grad():
        got = model.mtp_chain_logits(params, h, _t(toks), window=window)
        single = model.mtp_logits(params, h, _t(toks))
    assert len(got) == len(want) == model.cfg.mtp_depth
    for g, w in zip(got, want):
        _close(g, w, TOL)
    if window == 0:
        assert torch.equal(got[0], single)


@pytest.mark.parametrize("k", [1, 2, 5])
def test_mtp_draft_matches_reference(setup, k):
    """Greedy drafts from the chain; k beyond ``mtp_depth`` reuses the
    deepest module, as the reference does."""
    jmodel, jparams, model, params = setup
    rng = np.random.default_rng(2)
    h = rng.standard_normal((3, 64)).astype(np.float32)
    tok = rng.integers(0, 64, (3,))
    want = jmodel.mtp_draft(jparams, jnp.asarray(h),
                            jnp.asarray(tok, jnp.int32), k)
    got = model.mtp_draft(params, _t(h), _t(tok), k)
    assert got.shape == (3, k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------- dense verify forward
def _prefilled(jmodel, jparams, model, params, B=2, P=6, cap=32, seed=3):
    prompts = np.random.default_rng(seed).integers(0, 64, (B, P))
    _, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompts)}, cap)
    _, tc = model.prefill(params, {"tokens": _t(prompts)}, cap)
    return prompts, jc, tc


def test_decode_multi_matches_reference_and_sequential(deep):
    jmodel, jparams, model, params = deep
    B, P, T = 2, 6, 4
    prompts, jc, tc = _prefilled(jmodel, jparams, model, params)
    toks = np.random.default_rng(4).integers(0, 64, (B, T))
    positions = (P + np.arange(T))[None].repeat(B, 0).astype(np.int32)
    jl, jh, _ = jmodel.decode_multi(jparams, jc, jnp.asarray(toks),
                                    jnp.asarray(positions))
    seq = {"layers": [{k: v.clone() for k, v in c.items()}
                      for c in tc["layers"]]}
    seq_logits = [model.decode_step(params, seq, _t(toks[:, t]),
                                    _t(positions[:, t]))[0]
                  for t in range(T)]
    logits, h, out = model.decode_multi(params, tc, _t(toks), _t(positions))
    assert out is tc and logits.shape == (B, T, 64) and h.shape == (B, T, 64)
    _close(logits, jl, TOL)
    _close(h, jh, TOL)
    _close(logits, torch.stack(seq_logits, 1), MULTI_TOL)
    for a, b in zip(tc["layers"], seq["layers"]):
        assert torch.equal(a["pos"], b["pos"])
        _close(a["k"], b["k"], MULTI_TOL)


def test_decode_multi_dead_row_writes_only_dead_entries(deep):
    """A row at position -1 leaves its live entries as they were: it
    writes only a slot whose position is -1."""
    jmodel, jparams, model, params = deep
    B, P, T = 2, 6, 3
    _, _, tc = _prefilled(jmodel, jparams, model, params)
    before = [{k: v.clone() for k, v in c.items()} for c in tc["layers"]]
    positions = np.array([[P, P + 1, P + 2], [-1, -1, -1]], np.int32)
    toks = np.random.default_rng(5).integers(0, 64, (B, T))
    model.decode_multi(params, tc, _t(toks), _t(positions))
    for a, b in zip(tc["layers"], before):
        live = b["pos"][1] >= 0
        assert torch.equal(a["pos"][1][live], b["pos"][1][live])
        assert torch.equal(a["k"][1][live], b["k"][1][live])
        assert torch.equal(a["v"][1][live], b["v"][1][live])
        assert (a["pos"][1][~live] == -1).all()
        assert a["pos"][0, P:P + T].tolist() == [P, P + 1, P + 2]


# ----------------------------------------------------- paged verify forward
def test_append_decode_multi_matches_reference_and_sequential():
    _, tcfg = _cfgs()
    ps, num_pages, B, T = 4, 12, 2, 3
    kvh, hd = tcfg.num_kv_heads, tcfg.resolved_head_dim()
    rng = np.random.default_rng(6)
    pool = {n: rng.standard_normal((num_pages, ps, kvh, hd)).astype(
        np.float32) for n in ("k", "v")}
    k_t, v_t = (rng.standard_normal((B, T, kvh, hd)).astype(np.float32)
                for _ in range(2))
    bt = np.array([[0, 1, 2], [3, 4, -1]], np.int32)
    positions = np.array([[5, 6, 7], [2, 3, -1]], np.int32)   # -1 = dead
    want = JPC.append_decode_multi({n: jnp.asarray(a) for n, a in
                                    pool.items()}, jnp.asarray(k_t),
                                   jnp.asarray(v_t), jnp.asarray(bt),
                                   jnp.asarray(positions))

    def port_pool():
        return {n: _t(np.concatenate([a, np.zeros_like(a[:1])]))
                for n, a in pool.items()}

    multi = PC.append_decode_multi(port_pool(), _t(k_t), _t(v_t), _t(bt),
                                   _t(positions))
    seq = port_pool()
    for t in range(T):
        PC.append_decode(seq, _t(k_t[:, t]), _t(v_t[:, t]), _t(bt),
                         _t(positions[:, t]))
    for n in ("k", "v"):
        np.testing.assert_array_equal(multi[n][:-1].numpy(),
                                      np.asarray(want[n]))
        assert torch.equal(multi[n][:-1], seq[n][:-1])


def _paged_setup(jmodel, jparams, model, params, B=2, P=6, T=3, ps=4):
    """Both packages' pools after a paged prefill of the same prompts,
    each row grown by T tokens; -> (prompts, jpools, pools, table)."""
    cfg = model.cfg
    nb = -(-(P + T) // ps)
    prompts = np.random.default_rng(7).integers(0, 64, (B, P))
    pm = PageManager(B * nb, ps)
    for b in range(B):
        pm.allocate(b, P)
    bt = pm.block_table_array(list(range(B)), nb)
    lens = np.full((B,), P, np.int32)
    jpools = jmodel.init_paged_pools(B * nb, ps, jnp.float32)
    _, jpools = jmodel.paged_prefill(jparams, {"tokens": jnp.asarray(prompts)},
                                     jpools, jnp.asarray(bt),
                                     jnp.asarray(lens))
    pools = model.init_paged_pools(B * nb, ps, torch.float32)
    model.paged_prefill(params, {"tokens": _t(prompts)}, pools, _t(bt),
                        _t(lens))
    for b in range(B):
        pm.append_tokens(b, T)
    return prompts, jpools, pools, pm.block_table_array(list(range(B)), nb), \
        cfg


def test_paged_decode_multi_matches_reference(deep):
    jmodel, jparams, model, params = deep
    B, P, T = 2, 6, 3
    _, jpools, pools, bt, cfg = _paged_setup(jmodel, jparams, model, params)
    toks = np.random.default_rng(8).integers(0, 64, (B, T))
    positions = np.array([[P, P + 1, P + 2], [-1, -1, -1]], np.int32)
    jl, jh, jpools = jmodel.paged_decode_multi(
        jparams, jpools, jnp.asarray(toks), jnp.asarray(positions),
        jnp.asarray(bt))
    logits, h, out = model.paged_decode_multi(params, pools, _t(toks),
                                              _t(positions), _t(bt))
    assert out is pools
    _close(logits[0], jl[0], TOL)          # row 1 is dead: its rows garbage
    _close(h[0], jh[0], TOL)
    for a, b in zip(jax.tree.leaves(bridge.pools_to_jax(pools, cfg)),
                    jax.tree.leaves(jpools)):
        _close(a, b, TOL)


def test_paged_prefill_suffix_warm_equals_cold():
    """A prompt whose first 16 tokens sit in revived prefix-cache pages
    prefills only its 6-token tail; its logits are the bits of the same
    tail over privately written pages (``tests/test_prefix_cache.py``'s
    case), and the cold run (start = 0) agrees with ``paged_prefill`` and
    with the reference's suffix prefill."""
    jcfg, tcfg = _cfgs()
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = Model(tcfg, device="cpu")
    params = bridge.from_jax(_np(jparams), tcfg, "cpu")
    ps = 8
    toks_a = (np.arange(16) * 3) % 64
    toks_b = np.concatenate([toks_a, [5, 9, 2, 7, 1, 4]])     # 22 tokens

    def suffix(pm, pools, seq_id, start):
        s = np.zeros(8, np.int64)
        s[:len(toks_b) - start] = toks_b[start:]
        bt = pm.block_table_array([seq_id], 4)
        return model.paged_prefill_suffix(
            params, {"tokens": _t(s)[None]}, pools, _t(bt),
            torch.tensor([start], dtype=torch.int32),
            torch.tensor([len(toks_b)], dtype=torch.int32), return_h=True)

    def prefilled(n_alloc):
        pm = PageManager(16, ps)
        pools = model.init_paged_pools(16, ps, torch.float32)
        pm.allocate(0, n_alloc)
        model.paged_prefill(params, {"tokens": _t(toks_a)[None]}, pools,
                            _t(pm.block_table_array([0], 4)),
                            torch.tensor([16], dtype=torch.int32))
        return pm, pools

    pm, pools = prefilled(len(toks_b))
    cold, _, h_cold = suffix(pm, pools, 0, 16)
    pm, pools = prefilled(len(toks_a))
    pm.commit_prefix(0, list(toks_a))
    pm.free_seq(0)
    _, n_cached = pm.allocate_prefix(1, list(toks_b))
    assert n_cached == 16
    warm, _, h_warm = suffix(pm, pools, 1, 16)
    assert torch.equal(warm, cold) and torch.equal(h_warm, h_cold)

    # start = 0: the whole prompt through the suffix path
    pm = PageManager(16, ps)
    pools = model.init_paged_pools(16, ps, torch.float32)
    pm.allocate(0, len(toks_b))
    bt = pm.block_table_array([0], 4)
    s = np.zeros(24, np.int64)
    s[:22] = toks_b
    got, _ = model.paged_prefill_suffix(
        params, {"tokens": _t(s)[None]}, pools, _t(bt),
        torch.tensor([0], dtype=torch.int32),
        torch.tensor([22], dtype=torch.int32))
    pools2 = model.init_paged_pools(16, ps, torch.float32)
    dense, _ = model.paged_prefill(params, {"tokens": _t(s)[None]}, pools2,
                                   _t(bt), torch.tensor([22],
                                                        dtype=torch.int32))
    _close(got, dense, MULTI_TOL)
    _close(got, cold, MULTI_TOL)
    jpm = JaxPageManager(16, ps)
    jpm.allocate(0, len(toks_b))
    jpools = jmodel.init_paged_pools(16, ps, jnp.float32)
    want, _ = jmodel.paged_prefill_suffix(
        jparams, {"tokens": jnp.asarray(s, jnp.int32)[None]}, jpools,
        jnp.asarray(jpm.block_table_array([0], 4)),
        jnp.asarray([0], jnp.int32), jnp.asarray([22], jnp.int32))
    _close(got, want, TOL)


# ------------------------------------------------------ speculative rollout
def _chip_smoke():
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("backend", ["dense", "paged"])
@pytest.mark.parametrize("forced", [False, True], ids=["random", "forced"])
def test_spec_rollout_matches_vanilla_and_reference(deep, backend, forced,
                                                    monkeypatch):
    """Tokens equal to the port's vanilla greedy and to the reference's
    spec rollout, logp within 1e-6, pages freed with the invariants kept.
    With random heads almost nothing is accepted; with the forced drafter
    (``chip_smoke.forced_drafts``: vanilla's own continuation) nearly
    every draft is, so rows emit k+1 tokens a step, get capped at
    ``max_new_tokens`` and go dead, and the pages truncate every step."""
    jmodel, jparams, model, params = deep
    B, P, N, k = 3, 9, 14, 3
    prompts = np.random.default_rng(9).integers(0, 64, (B, P))
    kw = dict(capacity=P + N, temperature=0.0, top_k=0, backend=backend,
              page_size=4)
    van = Rollout(model, model.cfg, **kw).generate(
        params, {"tokens": _t(prompts)}, N, torch.Generator())
    spec = Rollout(model, model.cfg, spec_decode=True, spec_k=k, **kw)
    if forced:
        monkeypatch.setattr(model, "mtp_draft", _chip_smoke().forced_drafts(
            model, van.tokens[:, P:], k))
    out = spec.generate(params, {"tokens": _t(prompts)}, N,
                        torch.Generator())
    assert torch.equal(out.tokens, van.tokens)
    _close(out.logp, van.logp, LOGP_TOL)
    assert torch.equal(out.mask, van.mask)
    st = spec.spec_stats
    assert st["steps"] == spec.decode_stats["steps"]
    if forced:
        # every draft is accepted but those of the last step that run past
        # vanilla's N tokens
        assert st["accepted"] >= st["drafted"] - B * k
        assert st["steps"] == -(-(N - 1) // (k + 1))
    else:
        assert st["steps"] >= (N - 1) // (k + 1)
        jro = JaxRollout(jmodel, jmodel.cfg, spec_decode=True, spec_k=k,
                         **kw)
        want = jro.generate(jparams, {"tokens": jnp.asarray(prompts,
                                                            jnp.int32)},
                            N, jax.random.PRNGKey(0))
        np.testing.assert_array_equal(out.tokens.numpy(),
                                      np.asarray(want.tokens))
        _close(out.logp, want.logp, LOGP_TOL)
        assert st == jro.spec_stats
    assert not spec.decode_stats["graphed"]
    if backend == "paged":
        pm = spec.page_manager
        assert pm.stats.pages_in_use == 0
        pm.check_invariants()


def test_spec_rollout_group_expands_up_front(deep):
    """``group_size`` G repeats the prompts before the spec path, on the
    paged backend too: the rows equal vanilla greedy's of the repeat."""
    jmodel, jparams, model, params = deep
    B, P, N, G = 2, 5, 9, 3
    prompts = _t(np.random.default_rng(10).integers(0, 64, (B, P)))
    kw = dict(capacity=P + N, temperature=0.0, top_k=0, backend="paged",
              page_size=4)
    van = Rollout(model, model.cfg, backend="dense", capacity=P + N,
                  temperature=0.0, top_k=0).generate(
        params, {"tokens": torch.repeat_interleave(prompts, G, 0)}, N,
        torch.Generator())
    spec = Rollout(model, model.cfg, spec_decode=True, spec_k=2, **kw)
    out = spec.generate(params, {"tokens": prompts}, N, torch.Generator(),
                        group_size=G)
    assert out.tokens.shape == (B * G, P + N)
    assert torch.equal(out.tokens, van.tokens)
    assert spec.page_manager.stats.n_forks == 0


def test_spec_rollout_hydra_merged(deep):
    """Spec decode from hydra's merged weights: the adapter's A·B folds
    into the MTP modules as into the trunk (the reference adapts them
    too), drafts and verify both read the merged tree, and the output is
    vanilla greedy's from it and the reference's merged spec rollout."""
    jmodel, jparams, model, params = deep
    from tests.test_hydra import randomized_adapter
    jad = randomized_adapter(jmodel, jparams, 4, jax.random.PRNGKey(7))
    assert "mtp" in jad["lora"] and "mtp_extra" in jad["lora"]
    adapter = bridge.adapter_from_jax(_np(jad), model.cfg, "cpu")
    assert len(adapter["lora"]["mtp"]) == model.cfg.mtp_depth
    back = bridge.adapter_to_jax(adapter, model.cfg)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jad)):
        np.testing.assert_array_equal(a, np.asarray(b))
    merged = model.merge_adapter(params, adapter)
    assert not torch.equal(merged["mtp"][1]["layer"]["mixer"]["wq"],
                           params["mtp"][1]["layer"]["mixer"]["wq"])
    B, P, N = 2, 8, 12
    prompts = np.random.default_rng(11).integers(0, 64, (B, P))
    kw = dict(capacity=P + N, temperature=0.0, top_k=0)
    van = Rollout(model, model.cfg, **kw).generate(
        merged, {"tokens": _t(prompts)}, N, torch.Generator())
    out = Rollout(model, model.cfg, spec_decode=True, spec_k=2,
                  **kw).generate(merged, {"tokens": _t(prompts)}, N,
                                 torch.Generator())
    want = JaxRollout(jmodel, jmodel.cfg, spec_decode=True, spec_k=2,
                      **kw).generate(jparams, {"tokens": jnp.asarray(
                          prompts, jnp.int32)}, N, jax.random.PRNGKey(8),
        adapter=jad)
    assert torch.equal(out.tokens, van.tokens)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(want.tokens))
    _close(out.logp, van.logp, LOGP_TOL)
    _close(out.logp, want.logp, LOGP_TOL)


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_spec_k_beyond_mtp_depth(backend):
    """spec_k above ``mtp_depth`` (1) reuses the deepest module: tokens
    still vanilla greedy's and the reference's."""
    jcfg, tcfg = _cfgs(mtp_depth=1)
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = Model(tcfg, device="cpu")
    params = bridge.from_jax(_np(jparams), tcfg, "cpu")
    B, P, N = 2, 6, 10
    prompts = np.random.default_rng(12).integers(0, 64, (B, P))
    kw = dict(capacity=P + N, temperature=0.0, top_k=0, backend=backend,
              page_size=4)
    van = Rollout(model, tcfg, **kw).generate(
        params, {"tokens": _t(prompts)}, N, torch.Generator())
    out = Rollout(model, tcfg, spec_decode=True, spec_k=3, **kw).generate(
        params, {"tokens": _t(prompts)}, N, torch.Generator())
    want = JaxRollout(jmodel, jcfg, spec_decode=True, spec_k=3,
                      **kw).generate(jparams, {"tokens": jnp.asarray(
                          prompts, jnp.int32)}, N, jax.random.PRNGKey(0))
    assert torch.equal(out.tokens, van.tokens)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(want.tokens))


def test_spec_rollout_refuses_what_it_cannot_do(deep):
    _, _, model, _ = deep
    cfg = model.cfg
    for kw in (dict(temperature=1.0), dict(top_k=5), dict(eos_id=3),
               dict(window=4)):
        with pytest.raises(ValueError):
            Rollout(model, cfg, capacity=16, spec_decode=True,
                    **{"temperature": 0.0, "top_k": 0, **kw})
    plain = Model(dataclasses.replace(cfg, mtp_depth=0), device="cpu")
    with pytest.raises(ValueError, match="mtp_depth"):
        Rollout(plain, plain.cfg, capacity=16, temperature=0.0, top_k=0,
                spec_decode=True)


# ------------------------------------------------------------ MTP training
def _batch(tokens, rng):
    B, S = tokens.shape
    mask = np.zeros((B, S), np.float32)
    mask[:, 4:] = 1.0
    return {"tokens": tokens.astype(np.int32), "loss_mask": mask,
            "advantages": rng.standard_normal((B, S)).astype(np.float32),
            "old_logp": (-3 + 0.1 * rng.standard_normal((B, S))
                         ).astype(np.float32) * mask,
            "ref_logp": (-3 + 0.1 * rng.standard_normal((B, S))
                         ).astype(np.float32) * mask,
            "returns": rng.standard_normal((B, S)).astype(np.float32)}


def _texp(exp):
    return {k: torch.from_numpy(v.astype(np.int64) if k == "tokens" else v)
            for k, v in exp.items()}


@pytest.mark.parametrize("kind", ["ppo", "lm", "critic"])
def test_full_train_step_with_mtp_matches_reference(setup, kind):
    """One ``make_train_step`` with MTP heads: the loss with 0.1 x the
    chain's mean cross-entropy, ``mtp_loss``, and the updated params (the
    heads trained) against the reference's; the critic has no MTP
    loss."""
    jmodel, jparams, model, params = setup
    value = kind == "critic"
    jcfg, tcfg = jmodel.cfg, model.cfg
    jm, tm = JaxModel(jcfg, with_value=value), Model(tcfg, device="cpu",
                                                      with_value=value)
    jstep = JS.make_train_step(jm, jcfg, kind=kind, lr=1e-2)
    tstep = TS.make_train_step(tm, tcfg, kind=kind, lr=1e-2)
    jstate = JS.init_train_state(jm, jcfg, jax.random.PRNGKey(3),
                                 jstep.optimizer)
    tstate = TS.init_train_state(
        tm, tcfg, None, tstep.optimizer,
        params=bridge.from_jax(_np(jstate["params"]), tcfg, "cpu"))
    before = [t.detach().clone() for t in leaves(tstate["params"]["mtp"])]
    exp = _batch(np.random.default_rng(4).integers(0, 64, (4, 12)),
                 np.random.default_rng(7))
    jnew, jmet = jstep(jstate, jax.tree.map(jnp.asarray, exp))
    _, tmet = tstep(tstate, _texp(exp))
    assert set(tmet) == set(jmet)
    assert ("mtp_loss" in tmet) == (kind != "critic")
    for k in jmet:
        _close(float(tmet[k]), float(jmet[k]), METRIC_TOL)
    if kind != "critic":        # (a critic's heads move by weight decay)
        assert all(not torch.equal(a, b) for a, b in
                   zip(before, leaves(tstate["params"]["mtp"])))
    for a, b in zip(jax.tree.leaves(bridge.to_jax(tstate["params"], tcfg)),
                    jax.tree.leaves(jnew["params"])):
        _close(a, b, METRIC_TOL)


def test_lora_train_step_with_mtp_matches_reference(setup):
    """The hydra step: the chain runs on the frozen trunk, adapter-free,
    and its loss trains the adapter through the trunk's hidden states."""
    jmodel, jparams, model, params = setup
    from tests.test_hydra import randomized_adapter
    jad = randomized_adapter(jmodel, jparams, 4, jax.random.PRNGKey(5))
    adapter = bridge.adapter_from_jax(_np(jad), model.cfg, "cpu")
    jstep = JS.make_lora_train_step(jmodel, jmodel.cfg, kind="ppo", lr=1e-2)
    tstep = TS.make_lora_train_step(model, model.cfg, kind="ppo", lr=1e-2)
    jstate = JS.init_lora_train_state(jad, jstep.optimizer)
    tstate = TS.init_lora_train_state(adapter, tstep.optimizer)
    exp = _batch(np.random.default_rng(6).integers(0, 64, (4, 12)),
                 np.random.default_rng(8))
    jnew, jmet = jstep(jstate, jparams, jax.tree.map(jnp.asarray, exp))
    _, tmet = tstep(tstate, params, _texp(exp))
    assert "mtp_loss" in tmet and set(tmet) == set(jmet)
    for k in jmet:
        _close(float(tmet[k]), float(jmet[k]), METRIC_TOL)
    got = bridge.adapter_to_jax(tstate["params"], model.cfg)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jnew["params"])):
        _close(a, b, METRIC_TOL)
    assert all(not t.requires_grad for t in leaves(params))


# ------------------------------------------------- PPO with spec decoding
RL = dict(prompt_len=8, gen_len=8, lr=3e-3, critic_lr=3e-3, kl_coef=0.1,
          temperature=0.7, top_k=5, spec_decode=True, spec_k=2)


def _spy(tr, tokens, to_np):
    gen = tr._gen

    def spy(p, key):
        ro = gen(p, key)
        tokens.append(to_np(ro.tokens))
        return ro

    tr._gen = spy


@pytest.mark.parametrize("engine", ["hydra", "separate"])
def test_spec_ppo_iterations_match_reference(engine):
    """Two PPO iterations with ``spec_decode=True`` (temperature and top_k
    set, and overridden to greedy for the rollout, as the reference's
    trainer does) from the reference trainer's own initial weights, the
    programmatic reward: identical greedy tokens, the reference's spec
    stats, and loss (its ``mtp_loss`` term included), kl, vf_loss and
    mean_reward within 1e-4."""
    jcfg, tcfg = _cfgs(mtp_depth=2)
    rl = dict(RL, engine=engine)
    if engine == "hydra":
        rl["lora_rank"] = 4
    jtr = JaxRLHFTrainer(jcfg, jcfg, JaxRLHFConfig(**rl),
                         jax.random.PRNGKey(0),
                         reward_fn=jax_target_reward(7))
    if engine == "hydra":
        ttr = bridge.trainer_from_jax(
            _np(jtr.base_params), _np(jtr.engine.adapters), tcfg,
            RLHFConfig(**rl), reward_fn=make_target_token_reward(7),
            device="cpu")
    else:
        ttr = bridge.separate_trainer_from_jax(
            _np(jtr.actor_state["params"]), _np(jtr.critic_state["params"]),
            tcfg, tcfg, RLHFConfig(**rl),
            reward_fn=make_target_token_reward(7), device="cpu")
    assert isinstance(ttr, RLHFTrainer) and ttr.rollout.spec_decode
    assert ttr.rollout.temperature == 0.0 and ttr.rollout.top_k == 0
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 8), 0,
                                            jcfg.vocab_size))
    jtoks, ttoks = [], []
    _spy(jtr, jtoks, np.asarray)
    _spy(ttr, ttoks, lambda t: t.numpy())
    for s in range(2):
        want = jtr.train_step(jnp.asarray(prompts), jax.random.PRNGKey(s))
        got = ttr.train_step(torch.from_numpy(prompts.copy()).long(),
                             torch.Generator().manual_seed(s))
        np.testing.assert_array_equal(ttoks[-1], jtoks[-1])
        assert ttr.rollout.spec_stats == jtr.rollout.spec_stats
        for k in ("loss", "kl", "vf_loss", "mean_reward"):
            _close(got[k], float(want[k]), METRIC_TOL)


@pytest.mark.parametrize("engine", ["hydra", "separate"])
def test_spec_ppo_launch_reckoning_matches_a_run(monkeypatch, engine):
    """``chip_smoke.ppo_launches`` with ``spec_decode`` and MTP heads
    against a CPU iteration whose kernel wrappers are stood in for by
    their plain versions (every tensor taken for a card's): the
    speculative rollout's launches (no B3) and the MTP chain's in the
    actor step, forward and backward."""
    from repro_torch.kernels import ops, ref
    cs = _chip_smoke()
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
    _, tcfg = _cfgs(mtp_depth=2, num_layers=3, remat="full")
    rl = RLHFConfig(**dict(RL, engine=engine, gen_len=7, lora_rank=4))
    tr = RLHFTrainer(tcfg, tcfg, rl, torch.Generator().manual_seed(0),
                     reward_fn=make_target_token_reward(7))
    ops.reset_launches()
    tr.train_step(torch.randint(0, 64, (2, 8)), torch.Generator())
    steps = tr.rollout.spec_stats["steps"]
    assert steps >= 2
    assert dict(ops.launches) == cs.ppo_launches(tcfg, rl, False,
                                                 spec_steps=steps)
    ops.reset_launches()
    tr.rollout.generate(tr.ref_params, {"tokens": torch.randint(
        0, 64, (2, 8))}, 7, torch.Generator())
    assert dict(ops.launches) == cs.spec_launches(
        tcfg, tr.rollout.spec_stats["steps"], rl.spec_k)
