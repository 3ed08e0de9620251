"""The port's paged KV path against the JAX reference on the CPU: the page
manager, the pool writes, the paged-decode plain version (against the
reference's oracle and its Pallas kernel in interpret mode), the model's
paged prefill and decode, and the paged GRPO rollout with its group fork.

Sizes are those of ``tests/test_paged.py::_tiny_cfg``, in f32. Inputs
are made with numpy from a seed. Tolerances: 1e-5 f32 and 2e-2 bf16 for
attention (``tests/test_paged.py:165``), 1e-5 for the model's logits
(``tests/test_paged.py:206``); the pool's contents are exact copies.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import paged as JP  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.rlhf import Rollout as JaxRollout  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import paged as TP  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.rlhf import Rollout  # noqa: E402

TINY = dict(num_layers=2, d_model=128, d_ff=256, vocab_size=64, num_heads=4,
            num_kv_heads=2, head_dim=32, param_dtype="float32")


def _cfgs():
    return (dataclasses.replace(jax_get_config("llama3_2_3b").smoke(), **TINY),
            dataclasses.replace(get_config("llama3_2_3b").smoke(), **TINY))


def _models(seed=0):
    jcfg, tcfg = _cfgs()
    jm = JaxModel(jcfg)
    jparams = jm.init(jax.random.PRNGKey(seed))
    tm = Model(tcfg, device="cpu")
    tparams = bridge.from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, tcfg, jm, jparams, tm, tparams


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# PageManager: the port's copy against the reference, op for op
# ---------------------------------------------------------------------------
def _drive(pm, ops_seq):
    """Apply an op sequence; record every return value or exception."""
    out = []
    live = []
    next_id = 0
    for op, arg in ops_seq:
        try:
            if op == "alloc":
                out.append(pm.allocate(next_id, arg))
                live.append(next_id)
                next_id += 1
            elif op == "fork" and live:
                out.append(pm.fork(live[arg % len(live)], next_id))
                live.append(next_id)
                next_id += 1
            elif op == "append" and live:
                out.append(pm.append_token(live[arg % len(live)]))
            elif op == "free" and live:
                pm.free_seq(live.pop(arg % len(live)))
            elif op == "prefix":
                toks = list(np.arange(arg) % 7)
                out.append(pm.allocate_prefix(next_id, toks))
                pm.commit_prefix(next_id, toks)
                live.append(next_id)
                next_id += 1
            elif op == "truncate" and live:
                sid = live[arg % len(live)]
                pm.truncate(sid, pm.seq_len(sid) // 2)
        except (JP.PagePoolExhausted, TP.PagePoolExhausted) as e:
            out.append(("exhausted", str(e)))
        pm.check_invariants()
        out.append(pm.block_table_array(live, 16).tolist())
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_manager_copy_matches_reference(seed):
    rng = np.random.RandomState(seed)
    names = ["alloc", "fork", "append", "append", "append", "free",
             "prefix", "truncate"]
    seq = [(names[rng.randint(len(names))], int(rng.randint(1, 20)))
           for _ in range(120)]
    pms = [JP.PageManager(24, 4, bytes_per_token=64),
           TP.PageManager(24, 4, bytes_per_token=64)]
    outs = [_drive(pm, seq) for pm in pms]
    assert outs[0] == outs[1]
    assert pms[0].events == pms[1].events
    assert dataclasses.asdict(pms[0].stats) == dataclasses.asdict(pms[1].stats)
    assert pms[1].stats.n_page_alloc > 0
    # both event streams replay through the allocator simulators alike
    a_j, a_t = pms[0].replay_into(), pms[1].replay_into()
    assert type(a_t).__module__ == "repro_torch.core.allocator"
    assert dataclasses.asdict(a_j.stats) == dataclasses.asdict(a_t.stats)


# ---------------------------------------------------------------------------
# Pool writes
# ---------------------------------------------------------------------------
def _pool_pair(rng, P, ps, K, D):
    k = rng.randn(P, ps, K, D).astype(np.float32)
    v = rng.randn(P, ps, K, D).astype(np.float32)
    jpool = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    tpool = TP.init_pool(_cfgs()[1], P, ps, torch.float32, "cpu")
    tpool["k"][:P] = _t(k)
    tpool["v"][:P] = _t(v)
    return jpool, tpool


def _assert_pool(tpool, jpool):
    for name in ("k", "v"):
        np.testing.assert_array_equal(tpool[name][:-1].numpy(),
                                      np.asarray(jpool[name]))


def test_scatter_prefill_and_append_match_reference():
    """Rows past ``lengths``, -1 blocks and idle rows (position -1) write
    nothing; everything else lands where the reference puts it."""
    rng = np.random.RandomState(0)
    _, tcfg = _cfgs()
    P, ps, K, D = 10, 4, tcfg.num_kv_heads, tcfg.resolved_head_dim()
    jpool, tpool = _pool_pair(rng, P, ps, K, D)
    bt = np.array([[3, 1, -1], [0, 7, 2], [5, -1, -1]], np.int32)
    lengths = np.array([6, 11, 3], np.int32)
    kn = rng.randn(3, 12, K, D).astype(np.float32)
    vn = rng.randn(3, 12, K, D).astype(np.float32)
    jpool = JP.scatter_prefill(jpool, jnp.asarray(kn), jnp.asarray(vn),
                               jnp.asarray(bt), jnp.asarray(lengths))
    TP.scatter_prefill(tpool, _t(kn), _t(vn), _t(bt), _t(lengths))
    _assert_pool(tpool, jpool)
    kt = rng.randn(3, K, D).astype(np.float32)
    for position in ([6, 11, -1], [8, 4, 2], [9, -1, 4]):
        position = np.array(position, np.int32)
        jpool = JP.append_decode(jpool, jnp.asarray(kt), jnp.asarray(kt),
                                 jnp.asarray(bt), jnp.asarray(position))
        TP.append_decode(tpool, _t(kt), _t(kt), _t(bt), _t(position))
        _assert_pool(tpool, jpool)
        kt = kt + 1.0


def test_append_decode_writes_only_live_rows():
    """Mirror of ``tests/test_paged.py:177-188``: an idle row writes
    nothing anywhere in the addressable pool."""
    ps, P, K, D = 4, 8, 2, 16
    pool = {"k": torch.zeros((P + 1, ps, K, D)),
            "v": torch.zeros((P + 1, ps, K, D))}
    bt = torch.tensor([[0, 1], [2, -1]], dtype=torch.int32)
    kt = torch.ones((2, K, D))
    TP.append_decode(pool, kt, kt, bt, torch.tensor([5, -1],
                                                    dtype=torch.int32))
    k = pool["k"][:P]
    assert k[1, 1].sum() == K * D          # seq 0, logical idx 5 -> page 1
    assert k.sum() == K * D                # idle row dropped, nothing else
    assert TP.pool_pages(pool) == P


def test_copy_pages_and_gather_match_reference():
    rng = np.random.RandomState(1)
    jpool, tpool = _pool_pair(rng, 9, 4, 2, 32)
    jpool = JP.copy_pages(jpool, [1, 4], [6, 0])
    TP.copy_pages(tpool, [1, 4], [6, 0])
    _assert_pool(tpool, jpool)
    bt = np.array([[6, -1, 2], [0, 8, -1]], np.int32)
    for a, b in zip(TP.gather_kv(tpool, _t(bt)),
                    JP.gather_kv(jpool, jnp.asarray(bt))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# The paged-decode plain version (B4's)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,H,K,D,ps,nb,dt,holes", [
    (2, 4, 2, 32, 8, 6, "f32", False),
    (3, 8, 8, 16, 4, 9, "f32", False),
    (1, 4, 1, 64, 16, 4, "bf16", False),
    (4, 6, 2, 32, 4, 5, "f32", True),
    (3, 8, 4, 64, 8, 4, "bf16", True),
])
def test_paged_attention_ref_matches_reference_and_pallas(B, H, K, D, ps, nb,
                                                          dt, holes):
    """The ``tests/test_paged.py:130-134`` cases, and cases with -1 holes in
    the middle and at the end of a block table, a partial last page, a
    shared page and a row at position -1 (the uniform mean of its
    gathered V rows, not zero)."""
    rng = np.random.RandomState(B * H + D)
    P = B * nb + 1
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    pool_k = rng.randn(P, ps, K, D).astype(np.float32)
    pool_v = rng.randn(P, ps, K, D).astype(np.float32)
    bt = rng.permutation(P)[:B * nb].reshape(B, nb).astype(np.int32)
    position = rng.randint(0, nb * ps, size=B).astype(np.int32)
    if holes:
        bt[0, 1] = -1                    # a hole in the middle
        bt[1, -2:] = -1                  # a tail past the position
        position[1] = (nb - 2) * ps - 3  # a partial last page
        bt[2] = bt[1]                    # pages shared with row 1
        position[-1] = -1                # an idle row
    q = rng.randn(B, H, D).astype(np.float32)
    qj, kj, vj = (jnp.asarray(a).astype(jdt) for a in (q, pool_k, pool_v))
    qt, kt, vt = (torch.from_numpy(a).to(tdt) for a in (q, pool_k, pool_v))
    want = JP.paged_attention_reference(qj, {"k": kj, "v": vj},
                                        jnp.asarray(bt), jnp.asarray(position))
    pallas = JP.paged_decode_attention(qj, kj, vj, jnp.asarray(bt),
                                       jnp.asarray(position), interpret=True)
    got = ref.paged_attention_ref(qt, kt, vt, _t(bt), _t(position))
    assert got.dtype == tdt and got.shape == (B, H, D)
    tol = 2e-2 if dt == "bf16" else 1e-5
    got = got.float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol)
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32), atol=tol)
    if holes:
        # position -1: every slot masked, so the mean of all gathered rows
        pages = np.maximum(bt[-1], 0)
        v_all = pool_v[pages].reshape(nb * ps, K, D).mean(0)
        mean = np.repeat(v_all, H // K, axis=0)
        np.testing.assert_allclose(got[-1], mean, atol=tol)


# ---------------------------------------------------------------------------
# Model: paged prefill and decode against the reference
# ---------------------------------------------------------------------------
def test_model_paged_prefill_and_decode_match_reference():
    """Prefill of ragged lengths and 4 decode steps: logits within 1e-5
    and every layer's pool equal to the reference's (via pools_to_jax)."""
    jcfg, tcfg, jm, jparams, tm, tparams = _models()
    B, S, ps, nb = 3, 9, 4, 4
    P = B * nb
    rng = np.random.RandomState(0)
    toks = rng.randint(0, 64, (B, S)).astype(np.int32)
    lengths = np.array([9, 6, 7], np.int32)
    pm = TP.PageManager(P, ps)
    for b in range(B):
        pm.allocate(b, int(lengths[b]) + 4)
    bt = pm.block_table_array(list(range(B)), nb)
    jpools = jm.init_paged_pools(P, ps, jnp.float32)
    tpools = tm.init_paged_pools(P, ps, torch.float32)
    lg_j, jpools = jm.paged_prefill(jparams, {"tokens": jnp.asarray(toks)},
                                    jpools, jnp.asarray(bt),
                                    jnp.asarray(lengths))
    lg_t, tpools = tm.paged_prefill(tparams, {"tokens": _t(toks)}, tpools,
                                    _t(bt), _t(lengths))
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), atol=1e-5)

    def same_pools():
        back = bridge.pools_to_jax(tpools, tcfg)
        for name in ("k", "v"):
            np.testing.assert_allclose(back[0]["slot0"][name],
                                       np.asarray(jpools[0]["slot0"][name]),
                                       atol=1e-5)

    same_pools()
    tok = np.argmax(np.asarray(lg_j), -1).astype(np.int32)
    pos = lengths.copy()
    for _ in range(4):
        lg_j, jpools = jm.paged_decode_step(jparams, jpools, jnp.asarray(tok),
                                            jnp.asarray(pos), jnp.asarray(bt))
        lg_t, tpools = tm.paged_decode_step(tparams, tpools, _t(tok),
                                            _t(pos), _t(bt))
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), atol=1e-5)
        same_pools()
        tok = np.argmax(np.asarray(lg_j), -1).astype(np.int32)
        pos = pos + 1


def test_pools_round_trip_through_the_bridge():
    jcfg, tcfg = _cfgs()
    rng = np.random.RandomState(3)
    shape = (tcfg.num_layers, 5, 4, tcfg.num_kv_heads,
             tcfg.resolved_head_dim())
    jpools = [{"slot0": {"k": rng.randn(*shape).astype(np.float32),
                         "v": rng.randn(*shape).astype(np.float32)}}]
    tpools = bridge.pools_from_jax(jpools, tcfg, device="cpu")
    assert len(tpools) == tcfg.num_layers
    assert tpools[1]["k"].shape == (6,) + shape[2:]      # + the drop page
    assert not tpools[1]["v"][-1].any()
    back = bridge.pools_to_jax(tpools, tcfg)
    for name in ("k", "v"):
        np.testing.assert_array_equal(back[0]["slot0"][name],
                                      jpools[0]["slot0"][name])


def test_prefill_lengths_mask_padding_like_reference():
    jcfg, tcfg, jm, jparams, tm, tparams = _models(1)
    toks = np.random.RandomState(2).randint(0, 64, (2, 8)).astype(np.int32)
    lengths = np.array([8, 5], np.int32)
    lg_j, c_j, h_j = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, 8,
                                lengths=jnp.asarray(lengths), return_h=True)
    lg_t, c_t, h_t = tm.prefill(tparams, {"tokens": _t(toks)}, 8,
                                lengths=_t(lengths), return_h=True)
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), atol=1e-5)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=1e-5)
    for i, c in enumerate(c_t["layers"]):
        np.testing.assert_array_equal(
            c["pos"].numpy(), np.asarray(c_j["segments"][0]["slot0"]["pos"][i]))


# ---------------------------------------------------------------------------
# Rollout: the paged backend and the GRPO group fork
# ---------------------------------------------------------------------------
def test_greedy_paged_group_rollout_matches_reference():
    """Greedy, group_size 3, a prompt length that is not a multiple of the
    page size (so each child CoW-copies its partial prompt page): tokens
    identical to the JAX paged rollout, logp within 1e-5, and the page
    manager's stats identical."""
    jcfg, tcfg, jm, jparams, tm, tparams = _models(2)
    prompts = np.random.RandomState(4).randint(0, 64, (2, 7)).astype(np.int32)
    jro = JaxRollout(jm, jcfg, capacity=20, temperature=0.0,
                     backend="paged", page_size=4)
    tro = Rollout(tm, tcfg, capacity=20, temperature=0.0, backend="paged",
                  page_size=4)
    want = jro.generate(jparams, {"tokens": jnp.asarray(prompts)}, 9,
                        jax.random.PRNGKey(0), group_size=3)
    ops.reset_launches()
    got = tro.generate(tparams, {"tokens": _t(prompts)}, 9,
                       torch.Generator(), group_size=3)
    assert got.tokens.shape == (6, 16)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.logp.numpy(), np.asarray(want.logp),
                               atol=1e-5)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert dataclasses.asdict(tro.page_manager.stats) == \
        dataclasses.asdict(jro.page_manager.stats)
    assert tro.page_manager.stats.n_cow_copies == 4    # (G-1) per group
    assert tro.page_manager.stats.pages_in_use == 0
    assert all(v == 0 for v in ops.launches.values())     # plain path


def test_grpo_group_fork_matches_repeat_with_fewer_pages():
    """Within the port, the case of ``tests/test_prefix_cache.py:358-382``:
    at temperature > 0, forking G samples off one prefill gives the same
    tokens and logp as pre-repeating the prompts through the unshared
    paged path, with (G-1)*B forks and a strictly lower page peak."""
    _, tcfg, _, _, tm, tparams = _models()
    prompts = torch.from_numpy(
        np.stack([np.arange(8), np.arange(8) + 3]) % tcfg.vocab_size)
    ro = Rollout(tm, tcfg, capacity=20, temperature=0.8, top_k=20,
                 backend="paged", page_size=4)
    fork = ro.generate(tparams, {"tokens": prompts}, 12,
                       torch.Generator().manual_seed(5), group_size=3)
    pm_fork = ro.page_manager
    rep = ro.generate(tparams,
                      {"tokens": torch.repeat_interleave(prompts, 3, dim=0)},
                      12, torch.Generator().manual_seed(5))
    pm_rep = ro.page_manager
    assert torch.equal(fork.tokens, rep.tokens)
    assert torch.equal(fork.logp, rep.logp)
    assert pm_fork.stats.n_forks == 4              # (G-1) * B
    assert pm_fork.stats.peak_pages_in_use < pm_rep.stats.peak_pages_in_use
    pm_fork.check_invariants()


def test_dense_group_size_repeats_prompts():
    """On the dense backend G > 1 is ``repeat_interleave`` of the prompts,
    and gives the paged fork's greedy tokens."""
    _, tcfg, _, _, tm, tparams = _models()
    prompts = torch.from_numpy(
        np.random.RandomState(6).randint(0, 64, (2, 6)))
    dense = Rollout(tm, tcfg, capacity=16, temperature=0.0)
    paged = Rollout(tm, tcfg, capacity=16, temperature=0.0, backend="paged",
                    page_size=4)
    a = dense.generate(tparams, {"tokens": prompts}, 8, torch.Generator(),
                       group_size=2)
    b = paged.generate(tparams, {"tokens": prompts}, 8, torch.Generator(),
                       group_size=2)
    assert torch.equal(a.tokens[:, :6],
                       torch.repeat_interleave(prompts, 2, dim=0))
    assert torch.equal(a.tokens, b.tokens)
    with pytest.raises(ValueError, match="full-attention"):
        Rollout(tm, tcfg, capacity=16, backend="paged", window=8)
