"""The port's continuous batcher (``repro_torch.serving.ContinuousBatcher``)
against the JAX reference's on the CPU: the same requests through both
batchers on the same weights (the reference's init carried across by
``bridge.from_jax``), f32 smoke configs.

Where the reference decodes greedily the tokens must agree token for
token, and so must the schedule: steps, per-step pages in use, the
compile cache's stats, preemptions and the order of admission. Where it
samples, the two random streams differ, so the structure is compared
(requests drained, their lengths, steps). Twins of
``tests/test_serving_grpo.py:22-75``, ``tests/test_paged.py:218-296``,
``tests/test_prefix_cache.py:200-434``, ``tests/test_specdec.py:224-302``,
``tests/test_obs.py:210-237`` and ``tests/test_attrib.py:215-245``, plus
the dense batcher on the mamba2_370m smoke config with no buckets (the SSD
scan's path), ``DecodeGraph``'s per-row positions, and ``update_params``
dropping the decode graphs. On the CPU nothing is captured;
``tests/test_torch_gpu.py`` holds the graphed batcher to the eager one on
the card.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.obs import FlightRecorder as JaxFlightRecorder  # noqa: E402
from repro.obs import RunTelemetry as JaxRunTelemetry  # noqa: E402
from repro.paged import PageManager as JaxPageManager  # noqa: E402
from repro.serving import ContinuousBatcher as JaxBatcher  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.obs import FlightRecorder, RunTelemetry  # noqa: E402
from repro_torch.paged import PageManager  # noqa: E402
from repro_torch.rlhf.decode_graph import DecodeGraph  # noqa: E402
from repro_torch.serving import ContinuousBatcher, Request  # noqa: E402
from repro_torch.sharding import SpecMesh  # noqa: E402

TINY = dict(num_layers=2, d_model=128, d_ff=256, vocab_size=64, num_heads=4,
            num_kv_heads=2, head_dim=32, param_dtype="float32")
SPEC = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=64, num_heads=4,
            num_kv_heads=2, head_dim=16, mtp_depth=3, param_dtype="float32")
MICRO = dict(num_layers=2, d_model=128, d_ff=64, vocab_size=32, num_heads=2,
             num_kv_heads=1, head_dim=64, param_dtype="float32")
SUFFIX_TOL = 2e-5          # tests/test_prefix_cache.py:277
LOGIT_TOL = 1e-5


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x).copy(), tree)


def _pair(arch="llama3_2_3b", seed=0, **kw):
    """(JAX model, cfg, params), (port model, cfg, params) on the same
    weights."""
    jcfg = dataclasses.replace(jax_get_config(arch).smoke(), **kw)
    tcfg = dataclasses.replace(get_config(arch).smoke(), **kw)
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    model = Model(tcfg, device="cpu")
    return ((jmodel, jcfg, jparams),
            (model, tcfg, bridge.from_jax(_np(jparams), tcfg, "cpu")))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small CPU ops: the suite runs
    several test processes at once, and each op's thread pool would
    otherwise contend with theirs (the step loops here are many tiny
    ops). Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    return _pair(**TINY)


@pytest.fixture(scope="module")
def spec():
    return _pair(**SPEC)


def _drive(cb):
    """Step ``cb`` until drained, recording the schedule: pages in use
    after each step (paged) and the step at which each request was first
    admitted."""
    pages, admitted = [], {}
    reqs = sorted(cb.queue, key=lambda r: r.rid)
    while cb.n_queued or any(r is not None for r in cb.active):
        cb.step()
        if cb.backend == "paged":
            pages.append(cb.pm.stats.pages_in_use)
        for r in reqs:
            if r.out_tokens and r.rid not in admitted:
                admitted[r.rid] = cb.steps
    return {"tokens": [r.out_tokens for r in reqs], "steps": cb.steps,
            "pages": pages, "cache": cb.compile_cache.stats(),
            "preempted": [r.n_preempted for r in reqs],
            "admitted": admitted, "done": [r.done for r in reqs],
            "cached": [r.n_cached_tokens for r in reqs]}


def _both(pair, submit, **kw):
    """The same traffic through the JAX batcher and the port's ->
    (reference schedule, port schedule, port batcher)."""
    out = []
    for cls, (model, cfg, params) in zip((JaxBatcher, ContinuousBatcher),
                                         pair):
        cb = cls(model, cfg, params, **kw)
        submit(cb)
        out.append((_drive(cb), cb))
    return out[0][0], out[1][0], out[1][1]


def _ragged(n, seed=1, vocab=64, lens=(4, 20), gens=(5, 15)):
    def submit(cb):
        rng = np.random.RandomState(seed)
        for _ in range(n):
            cb.submit(rng.randint(0, vocab, size=int(rng.randint(*lens))),
                      int(rng.randint(*gens)))
    return submit


# --------------------------------------------------------- greedy parity
GREEDY = {
    "dense": dict(),
    "paged": dict(cache_backend="paged", page_size=8),
    "paged_tiny_pool": dict(cache_backend="paged", page_size=8,
                            num_pages=8),
    "dense_buckets": dict(capture_buckets=(4, 8, 16, 32)),
    "paged_buckets": dict(cache_backend="paged", page_size=8,
                          capture_buckets=(2, 4, 8, 16, 32)),
    "paged_buckets_tiny_pool": dict(cache_backend="paged", page_size=8,
                                    num_pages=8,
                                    capture_buckets=(2, 4, 8, 16, 32)),
    "prefix_cache": dict(cache_backend="paged", page_size=8,
                         prefix_cache=True),
    "prefix_cache_buckets": dict(cache_backend="paged", page_size=8,
                                 prefix_cache=True,
                                 capture_buckets=(2, 4, 8, 16, 32)),
}


@pytest.mark.parametrize("case", sorted(GREEDY))
def test_greedy_schedule_matches_reference(tiny, case):
    """Ragged greedy traffic: tokens, steps, per-step pages, compile-cache
    stats, preemptions and admission steps equal the JAX batcher's (the
    tiny pools, with longer generations, preempt)."""
    traffic = _ragged(7, gens=(10, 30)) if "tiny_pool" in case else \
        _ragged(7)
    ref, out, cb = _both(tiny, traffic, slots=3, capacity=64,
                         temperature=0.0, seed=7, **GREEDY[case])
    assert out == ref
    if cb.backend == "paged":
        cb.pm.check_invariants()
        assert cb.pm.stats.pages_in_use == cb.pm.num_cached_pages
    if "tiny_pool" in case:
        assert sum(out["preempted"]) >= 1


def test_drains_all_requests(tiny):
    """tests/test_serving_grpo.py:22: sampled traffic drains with every
    request at its length, in fewer steps than the lengths' sum; the
    schedule (no EOS) is the reference's."""
    def submit(cb):
        rng = np.random.RandomState(0)
        for i in range(7):
            cb.submit(rng.randint(0, 64, size=8), max_new_tokens=5 + i)

    ref, out, _ = _both(tiny, submit, slots=3, capacity=64)
    assert all(out["done"]) and all(ref["done"])
    assert [len(t) for t in out["tokens"]] == [5 + i for i in range(7)]
    assert out["steps"] == ref["steps"] < sum(5 + i for i in range(7))
    assert [len(t) for t in ref["tokens"]] == [len(t) for t in out["tokens"]]
    assert out["admitted"] == ref["admitted"]


def test_matches_isolated_decode(tiny):
    """tests/test_serving_grpo.py:39: a request served beside others
    gives the tokens it gives alone, and the reference's."""
    (jm, jcfg, jp), (model, cfg, params) = tiny
    prompt = np.arange(8) % cfg.vocab_size

    def greedy_run(cls, m, c, p, slots, extra):
        cb = cls(m, c, p, slots=slots, capacity=64, temperature=0.0, seed=7)
        r = cb.submit(prompt, 10)
        rng = np.random.RandomState(1)
        for _ in range(extra):
            cb.submit(rng.randint(0, 64, size=8), 10)
        cb.run_until_drained()
        return r.out_tokens

    alone = greedy_run(ContinuousBatcher, model, cfg, params, 1, 0)
    crowded = greedy_run(ContinuousBatcher, model, cfg, params, 3, 2)
    assert alone == crowded == greedy_run(JaxBatcher, jm, jcfg, jp, 3, 2)


def test_eos_frees_slot(tiny):
    """tests/test_serving_grpo.py:63: sampled with an EOS id, every request
    drains and ends at its EOS or its budget."""
    _, (model, cfg, params) = tiny
    cb = ContinuousBatcher(model, cfg, params, slots=2, capacity=64,
                           temperature=1.0, eos_id=3, seed=3)
    for i in range(4):
        cb.submit((np.arange(8) + i) % cfg.vocab_size, 30)
    done = cb.run_until_drained()
    assert len(done) == 4
    for r in done:
        assert 1 <= len(r.out_tokens) <= 30
        if 3 in r.out_tokens:
            assert r.out_tokens.index(3) == len(r.out_tokens) - 1
    assert any(len(r.out_tokens) < 30 for r in done)   # EOS retired one


def test_sampling_is_seeded(tiny):
    """The batcher's draws come from its generator, seeded from ``seed``:
    two batchers of one seed sample the same stream, another seed
    another."""
    _, (model, cfg, params) = tiny

    def run(seed):
        cb = ContinuousBatcher(model, cfg, params, slots=2, capacity=64,
                               temperature=1.0, top_k=20, seed=seed)
        reqs = [cb.submit(np.arange(8) + i, 12) for i in range(3)]
        cb.run_until_drained()
        return [r.out_tokens for r in reqs]

    assert run(3) == run(3) != run(4)


# ------------------------------------------------------------ paged twins
def test_paged_matches_dense_greedy(tiny):
    """tests/test_paged.py:218."""
    _, (model, cfg, params) = tiny
    prompt = np.arange(8) % cfg.vocab_size

    def run(backend):
        cb = ContinuousBatcher(model, cfg, params, slots=3, capacity=64,
                               temperature=0.0, seed=7,
                               cache_backend=backend, page_size=8)
        r = cb.submit(prompt, 10)
        rng = np.random.RandomState(1)
        for _ in range(2):
            cb.submit(rng.randint(0, 64, size=8), 10)
        cb.run_until_drained()
        return r.out_tokens, cb

    dense, _ = run("dense")
    paged, cb = run("paged")
    assert dense == paged
    assert cb.pm.stats.pages_in_use == 0
    cb.pm.check_invariants()
    assert cb.pm.stats.peak_pages_in_use * cb.page_size < 3 * 64
    assert cb.kv_reserved_bytes() == 0


def test_paged_preempts_and_completes_on_tiny_pool(tiny):
    """tests/test_paged.py:244, with the reference's schedule."""
    def submit(cb):
        for i in range(4):
            cb.submit((np.arange(8) + i) % 64, 20)

    ref, out, cb = _both(tiny, submit, slots=3, capacity=64,
                         temperature=0.0, seed=7, cache_backend="paged",
                         page_size=8, num_pages=9)
    assert out == ref
    assert all(len(t) == 20 for t in out["tokens"])
    assert sum(out["preempted"]) >= 1
    cb.pm.check_invariants()
    assert cb.pm.stats.pages_in_use == 0


def test_preemption_preserves_greedy_output(tiny):
    """tests/test_paged.py:261: a starved pool (repeated recompute
    preemption) gives the unstarved pool's tokens."""
    _, (model, cfg, params) = tiny

    def run(num_pages):
        cb = ContinuousBatcher(model, cfg, params, slots=3, capacity=64,
                               temperature=0.0, seed=7,
                               cache_backend="paged", page_size=8,
                               num_pages=num_pages)
        reqs = [cb.submit((np.arange(8) + i) % cfg.vocab_size, 24)
                for i in range(4)]
        cb.run_until_drained()
        return [r.out_tokens for r in reqs], sum(r.n_preempted for r in reqs)

    roomy, p0 = run(24)
    tight, p1 = run(8)
    assert p0 == 0 and p1 >= 1
    assert roomy == tight
    assert all(len(t) == 24 for t in tight)


def test_rejects_request_beyond_capacity(tiny):
    """tests/test_paged.py:287; a pool below one sequence, a prefix cache
    on the dense backend, a mesh that is none and a captured graph asked
    for under a tensor-parallel mesh are refused too."""
    _, (model, cfg, params) = tiny
    cb = ContinuousBatcher(model, cfg, params, slots=2, capacity=32,
                           cache_backend="paged", page_size=8)
    with pytest.raises(ValueError):
        cb.submit(np.arange(30), 10)
    cb.submit(np.arange(8), 10)
    assert len(cb.queue) == 1 and cb.n_queued == 1
    with pytest.raises(ValueError):
        ContinuousBatcher(model, cfg, params, capacity=32,
                          cache_backend="paged", page_size=8, num_pages=3)
    with pytest.raises(ValueError):
        ContinuousBatcher(model, cfg, params, prefix_cache=True)
    with pytest.raises(TypeError):
        ContinuousBatcher(model, cfg, params, mesh=object())
    with pytest.raises(NotImplementedError, match="graph"):
        ContinuousBatcher(model, cfg, params, graphs=True,
                          mesh=SpecMesh({"data": 1, "model": 2}))


# ------------------------------------------------------------ prefix cache
def test_warm_suffix_prefill_bit_identical_to_cold(tiny):
    """tests/test_prefix_cache.py:200: a hash-hit suffix prefill over
    revived prefix pages gives the cold suffix prefill's logits bit for
    bit, the one-shot paged prefill's within 2e-5, and the reference's."""
    (jm, _, jp), (model, cfg, params) = tiny
    ps = 8
    toks_a = (np.arange(16) * 3) % cfg.vocab_size
    toks_b = np.concatenate([toks_a, [5, 9, 2, 7, 1, 4]])

    def suffix_prefill(pm, pools, seq_id, start):
        suffix = np.zeros(8, np.int64)
        suffix[:len(toks_b) - start] = toks_b[start:]
        bt = torch.from_numpy(pm.block_table_array([seq_id], 4))
        return model.paged_prefill_suffix(
            params, {"tokens": torch.from_numpy(suffix)[None]}, pools, bt,
            torch.tensor([start], dtype=torch.int32),
            torch.tensor([len(toks_b)], dtype=torch.int32))

    def prefill(pm, pools, seq_id, toks):
        bt = torch.from_numpy(pm.block_table_array([seq_id], 4))
        return model.paged_prefill(
            params, {"tokens": torch.from_numpy(toks.astype(np.int64))[None]},
            pools, bt, torch.tensor([len(toks)], dtype=torch.int32))

    pm = PageManager(16, ps)
    pools = model.init_paged_pools(16, ps, torch.float32)
    pm.allocate(0, len(toks_b))
    prefill(pm, pools, 0, toks_a)
    cold, _ = suffix_prefill(pm, pools, 0, 16)

    pm = PageManager(16, ps)
    pools = model.init_paged_pools(16, ps, torch.float32)
    pm.allocate(0, len(toks_a))
    prefill(pm, pools, 0, toks_a)
    pm.commit_prefix(0, toks_a)
    pm.free_seq(0)
    _, n_cached = pm.allocate_prefix(1, toks_b)
    assert n_cached == 16
    warm, _ = suffix_prefill(pm, pools, 1, 16)
    assert torch.equal(warm, cold)

    pm2 = PageManager(16, ps)
    pools2 = model.init_paged_pools(16, ps, torch.float32)
    pm2.allocate(0, len(toks_b))
    dense, _ = prefill(pm2, pools2, 0, toks_b)
    np.testing.assert_allclose(warm.numpy(), dense.numpy(), atol=SUFFIX_TOL)

    jpm = JaxPageManager(16, ps)
    jpools = jm.init_paged_pools(16, ps, np.float32)
    jpm.allocate(0, len(toks_b))
    jlg, _ = jm.paged_prefill(jp, {"tokens": toks_b[None].astype(np.int32)},
                              jpools, jpm.block_table_array([0], 4),
                              np.array([len(toks_b)], np.int32))
    np.testing.assert_allclose(warm.numpy(), np.asarray(jlg),
                               atol=SUFFIX_TOL)


def _shared_prompts(cfg, n, width=16, scale=1, extra=3):
    base = (np.arange(width) * scale) % cfg.vocab_size
    return [np.concatenate([base, np.arange(i, i + extra) % cfg.vocab_size])
            for i in range(n)]


def _serve(pair_side, prompts, cls=ContinuousBatcher, **kw):
    model, cfg, params = pair_side
    cb = cls(model, cfg, params, slots=2, capacity=48, temperature=0.0,
             seed=3, page_size=8, **kw)
    reqs = [cb.submit(p, 12) for p in prompts]
    cb.run_until_drained()
    if cb.backend == "paged":
        cb.pm.check_invariants()
    return [r.out_tokens for r in reqs], cb


def test_prefix_cache_greedy_identity(tiny):
    """tests/test_prefix_cache.py:293: dense == paged == paged with the
    prefix cache, and == the reference's prefix-cache batcher."""
    cfg = tiny[1][1]
    prompts = _shared_prompts(cfg, 4)
    dense, _ = _serve(tiny[1], prompts, cache_backend="dense")
    off, _ = _serve(tiny[1], prompts, cache_backend="paged")
    on, cb = _serve(tiny[1], prompts, cache_backend="paged",
                    prefix_cache=True)
    ref, jcb = _serve(tiny[0], prompts, cls=JaxBatcher,
                      cache_backend="paged", prefix_cache=True)
    assert dense == off == on == ref
    assert cb.prefix_hit_rate() == jcb.prefix_hit_rate() > 0.4
    assert cb.pm.stats.n_prefix_hits == jcb.pm.stats.n_prefix_hits > 0


def _random_adapter(jm, jp, key):
    ad = jm.init_adapter(jax.random.PRNGKey(key), jp, 4)
    leaves_, treedef = jax.tree.flatten(ad)
    ks = jax.random.split(jax.random.PRNGKey(key + 1), len(leaves_))
    return jax.tree.unflatten(treedef, [
        0.05 * jax.random.normal(k, x.shape, x.dtype)
        for k, x in zip(ks, leaves_)])


def test_prefix_cache_greedy_identity_hydra_merged(tiny):
    """tests/test_prefix_cache.py:310: the cache is transparent under
    merged adapter weights: the port's own merge off == on, and the
    reference's merged tree served by both batchers gives one stream."""
    (jm, jcfg, jp), (model, cfg, params) = tiny
    ad = _random_adapter(jm, jp, 1)
    merged = model.merge_adapter(params, bridge.adapter_from_jax(
        _np(ad), cfg, "cpu"))
    prompts = _shared_prompts(cfg, 3, scale=5, extra=2)
    side = (model, cfg, merged)
    off, _ = _serve(side, prompts, cache_backend="paged")
    on, cb = _serve(side, prompts, cache_backend="paged", prefix_cache=True)
    assert off == on
    assert cb.prefix_hit_rate() > 0.3
    jmerged = jm.merge_adapter(jp, ad)
    ref, _ = _serve((jm, jcfg, jmerged), prompts, cls=JaxBatcher,
                    cache_backend="paged", prefix_cache=True)
    port, _ = _serve((model, cfg, bridge.from_jax(_np(jmerged), cfg, "cpu")),
                     prompts, cache_backend="paged", prefix_cache=True)
    assert port == ref


def test_prefix_cache_reduces_peak_pages(tiny):
    """tests/test_prefix_cache.py:330, peaks equal to the reference's."""
    cfg = tiny[1][1]
    base = np.arange(24) % cfg.vocab_size
    prompts = [np.concatenate([base, [i]]) for i in range(6)]
    peaks = {}
    for on in (False, True):
        _, cb = _serve(tiny[1], prompts, cache_backend="paged",
                       prefix_cache=on, num_pages=32)
        _, jcb = _serve(tiny[0], prompts, cls=JaxBatcher,
                        cache_backend="paged", prefix_cache=on, num_pages=32)
        peaks[on] = cb.pm.stats.peak_pages_in_use
        assert peaks[on] == jcb.pm.stats.peak_pages_in_use
    assert peaks[True] < peaks[False]


def test_update_params_invalidates_prefix_cache(tiny):
    """tests/test_prefix_cache.py:345: a weight update flushes every
    cached prefix, and serving goes on; the next drain hits nothing old
    and serves the new weights (a fresh batcher's tokens on them)."""
    _, (model, cfg, params) = tiny
    cb = ContinuousBatcher(model, cfg, params, slots=2, capacity=48,
                           temperature=0.0, seed=0, cache_backend="paged",
                           page_size=8, prefix_cache=True)
    prompt = np.arange(17) % cfg.vocab_size
    cb.submit(prompt, 8)
    cb.run_until_drained()
    assert cb.pm.match_prefix(np.concatenate([prompt, [1]]))[1] > 0
    other = model.init(torch.Generator().manual_seed(5))
    cb.update_params(other, weight_version=1)
    assert cb.pm.match_prefix(np.concatenate([prompt, [1]]))[1] == 0
    assert cb.pm.stats.n_prefix_invalidations == 1
    hits = cb.pm.stats.n_prefix_hits
    r = cb.submit(prompt, 8)
    cb.run_until_drained()
    assert len(r.out_tokens) == 8 and r.n_cached_tokens == 0
    assert cb.pm.stats.n_prefix_hits == hits
    cb.pm.check_invariants()
    fresh = ContinuousBatcher(model, cfg, other, slots=2, capacity=48,
                              temperature=0.0, seed=0, cache_backend="paged",
                              page_size=8, prefix_cache=True)
    f = fresh.submit(prompt, 8)
    fresh.run_until_drained()
    assert r.out_tokens == f.out_tokens


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_update_params_drops_graphs_and_serves_new_weights(tiny, backend):
    """``update_params`` drops every decode graph (they hold the old
    weights' addresses) and the next decode of each key makes it anew:
    the tokens are a fresh batcher's on the new weights."""
    _, (model, cfg, params) = tiny
    kw = dict(slots=3, capacity=64, temperature=0.0, seed=7,
              cache_backend=backend, page_size=8,
              capture_buckets=(2, 4, 8, 16, 32))
    cb = ContinuousBatcher(model, cfg, params, **kw)
    keys = set(cb.graphs)
    assert keys and cb.compile_cache.warmed
    _ragged(4)(cb)
    cb.run_until_drained()
    other = model.init(torch.Generator().manual_seed(5))
    cb.update_params(other)
    assert not cb.graphs
    reqs = []
    rng = np.random.RandomState(2)
    for _ in range(4):
        reqs.append(cb.submit(rng.randint(0, 64, size=9), 7))
    cb.run_until_drained()
    assert set(cb.graphs) <= keys
    assert cb.compile_cache.recompiles == 0
    fresh = ContinuousBatcher(model, cfg, other, **kw)
    rng = np.random.RandomState(2)
    want = [fresh.submit(rng.randint(0, 64, size=9), 7) for _ in range(4)]
    fresh.run_until_drained()
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in want]


# ---------------------------------------------------------------- tenants
def _admission_order(pair_side, cls, weights, flood, trickle, gen):
    model, cfg, params = pair_side
    cb = cls(model, cfg, params, slots=1, capacity=32, temperature=0.0,
             seed=0, cache_backend="paged", page_size=8, num_pages=8,
             tenant_weights=weights)
    first, second = list(weights)
    reqs = [cb.submit(p, gen, tenant=first) for p in flood] + \
        [cb.submit(p, gen, tenant=second) for p in trickle]
    sched = _drive(cb)
    return reqs, sched


def test_tenant_fairness_bounds_starvation(tiny):
    """tests/test_prefix_cache.py:384: under equal weights a light tenant
    is admitted long before a flood drains, in the reference's order."""
    cfg = tiny[1][1]
    flood = [np.arange(8) + (i % 4) for i in range(10)]
    trickle = [np.arange(8) * 2 % cfg.vocab_size for _ in range(2)]
    weights = {"heavy": 1.0, "light": 1.0}
    reqs, sched = _admission_order(tiny[1], ContinuousBatcher, weights,
                                   flood, trickle, 8)
    _, ref = _admission_order(tiny[0], JaxBatcher, weights, flood,
                              trickle, 8)
    assert sched == ref
    assert all(len(t) == 8 for t in sched["tokens"])
    admit = sched["admitted"]
    last_heavy = max(admit[r.rid] for r in reqs if r.tenant == "heavy")
    assert all(admit[r.rid] < last_heavy - 8 for r in reqs
               if r.tenant == "light")


def test_tenant_weights_shape_admission_order(tiny):
    """tests/test_prefix_cache.py:414: 4:1 weights admit the favoured
    tenant earlier on average, in the reference's order."""
    prompts = [np.arange(8) + i % 3 for i in range(6)]
    weights = {"gold": 4.0, "bronze": 1.0}
    reqs, sched = _admission_order(tiny[1], ContinuousBatcher, weights,
                                   prompts, prompts, 6)
    _, ref = _admission_order(tiny[0], JaxBatcher, weights, prompts,
                              prompts, 6)
    assert sched == ref
    admit = sched["admitted"]

    def mean(t):
        return np.mean([admit[r.rid] for r in reqs if r.tenant == t])

    assert mean("gold") < mean("bronze")
    assert all(len(t) == 6 for t in sched["tokens"])


# ------------------------------------------------------------ spec decode
def _spec_traffic(cb):
    rng = np.random.RandomState(0)
    for n, g in zip((5, 9, 12, 7, 3), (11, 8, 13, 11, 9)):
        cb.submit(rng.randint(0, 64, size=n), g)


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_spec_batcher_bit_identical(spec, backend):
    """tests/test_specdec.py:236: spec decode (with EOS and buckets) gives
    vanilla greedy's tokens, and the reference spec batcher's schedule."""
    kw = dict(slots=3, capacity=64, temperature=0.0, seed=7,
              cache_backend=backend, page_size=8, eos_id=5)
    ref, out, cb = _both(spec, _spec_traffic, spec_decode=True, spec_k=3,
                         capture_buckets=(4, 8, 16, 32), **kw)
    assert out == ref
    model, cfg, params = spec[1]
    van = ContinuousBatcher(model, cfg, params, **kw)
    _spec_traffic(van)
    assert _drive(van)["tokens"] == out["tokens"]
    if backend == "paged":
        cb.pm.check_invariants()
        assert cb.pm.stats.pages_in_use == 0
    assert cb.calls["spec"] >= out["steps"]


def test_spec_preemption(spec):
    """tests/test_specdec.py:262: growing by k+1 preempts on a tiny pool,
    and the tokens stay vanilla's and the reference's."""
    def submit(cb):
        rng = np.random.RandomState(1)
        for _ in range(4):
            cb.submit(rng.randint(0, 64, size=8), 14)

    kw = dict(slots=3, capacity=64, temperature=0.0, seed=7,
              cache_backend="paged", page_size=8, num_pages=9)
    ref, out, cb = _both(spec, submit, spec_decode=True, spec_k=2, **kw)
    assert out == ref
    model, cfg, params = spec[1]
    van = ContinuousBatcher(model, cfg, params, **kw)
    submit(van)
    assert _drive(van)["tokens"] == out["tokens"]
    cb.pm.check_invariants()


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_bucket_boundary_identical_and_no_recompiles(spec, backend):
    """tests/test_specdec.py:286: prompts at b-1, b, b+1 of a rung give the
    unbucketed tokens with no recompile and every shape warmed; the port's
    graphs are one per decode rung."""
    def submit(cb):
        rng = np.random.RandomState(2)
        for n in (7, 8, 9):
            cb.submit(rng.randint(0, 64, size=n), 10)

    kw = dict(slots=3, capacity=64, temperature=0.0, seed=7,
              cache_backend=backend, page_size=8)
    ref, out, cb = _both(spec, submit, capture_buckets=(4, 8, 16, 32), **kw)
    assert out == ref
    assert out["cache"]["recompiles"] == 0 and out["cache"]["hit_rate"] == 1.0
    model, cfg, params = spec[1]
    plain = ContinuousBatcher(model, cfg, params, **kw)
    submit(plain)
    assert _drive(plain)["tokens"] == out["tokens"]
    # 3 slots clip every rung to 3: one graph, dense or paged
    assert set(cb.graphs) == {("decode", backend, 3)}


def test_mamba_dense_batcher_matches_reference():
    """The dense batcher on the mamba2_370m smoke config with no buckets:
    the unmasked prefill through the SSD scan, then the recurrent decode,
    each admission copying the conv and SSM states into its slot; prompt
    lengths multiples of the chunk (``repro/models/mamba.py:45``)."""
    pair = _pair("mamba2_370m", param_dtype="float32")
    chunk = pair[1][1].ssm.chunk_size

    def submit(cb):
        rng = np.random.RandomState(0)
        for n, g in zip((1, 2, 1, 2), (6, 4, 7, 5)):
            cb.submit(rng.randint(0, cb.cfg.vocab_size, size=n * chunk), g)

    ref, out, cb = _both(pair, submit, slots=3, capacity=64,
                         temperature=0.0, seed=7)
    assert out == ref
    assert cb.kv_reserved_bytes() == sum(
        t.numel() * t.element_size() for c in cb.caches["layers"]
        for t in c.values())


# ------------------------------------------------------- decode graph rows
def test_decode_graph_rows_per_row_positions():
    """``DecodeGraph.rows`` writes a position per row (idle rows at -1)
    and runs the body on the static buffers; ``__call__`` still fills one
    position into every row."""
    seen = []

    def body(tok, pos, table):
        seen.append((tok.clone(), pos.clone(), table.clone()))
        return tok * 10 + pos.long()

    g = DecodeGraph(body, 4, "cpu", steps=5, table_blocks=2)
    assert not g.stats["graphed"]
    g.write_table(np.arange(8, dtype=np.int32).reshape(4, 2))
    out = g.rows(torch.tensor([1, 2, 3, 4]),
                 torch.tensor([5, -1, 7, -1], dtype=torch.int32))
    assert out.tolist() == [15, 19, 37, 39]
    assert g.position.dtype == torch.int32
    assert seen[-1][2].tolist() == [[0, 1], [2, 3], [4, 5], [6, 7]]
    out = g(torch.tensor([1, 2, 3, 4]), 9)
    assert out.tolist() == [19, 29, 39, 49]
    assert seen[-1][1].tolist() == [9, 9, 9, 9]


# -------------------------------------------------------------- telemetry
def test_serving_batcher_metrics():
    """tests/test_obs.py:211: the serving counters, histogram, gauges and
    one ``serve_step:<n>`` span a step, with the JAX batcher's metric
    names, span names and span argument keys."""
    pair = _pair(**MICRO)
    out = []
    for (cls, tel_cls), (model, cfg, params) in zip(
            ((JaxBatcher, JaxRunTelemetry),
             (ContinuousBatcher, RunTelemetry)), pair):
        tel = tel_cls.create(sim_delta=False)
        cb = cls(model, cfg, params, slots=2, capacity=32, temperature=0.0,
                 seed=0, cache_backend="paged", page_size=8, telemetry=tel)
        rng = np.random.RandomState(0)
        for g in (4, 6, 5):
            cb.submit(rng.randint(0, cfg.vocab_size, size=4), g)
        done = cb.run_until_drained()
        out.append((tel, cb, done))
    (jtel, _, _), (tel, cb, done) = out
    assert len(done) == 3
    reg = tel.registry
    assert reg.counter("serving_requests_total").value() == 3
    assert reg.counter("serving_admissions_total").value() >= 3
    assert reg.counter("serving_tokens_total").value() == \
        sum(len(r.out_tokens) for r in done)
    assert reg.histogram("serving_admission_latency_s").summary()[
        "count"] == 3
    assert reg.gauge("paged_pages_in_use").peak() > 0
    steps = [s for s in tel.tracer.spans if s.cat == "serving"]
    assert len(steps) == cb.steps
    assert all("kv_reserved_bytes" in s.args for s in steps)

    def names(t):
        return ({m["name"] for m in t.registry.snapshot()},
                [(s.name, sorted(s.args)) for s in t.tracer.spans],
                [e["name"] for e in t.tracer.records()
                 if e.get("type") == "instant"])

    assert names(tel) == names(jtel)


def test_serving_spec_and_preemption_telemetry():
    """Spec decode on a tiny pool with telemetry: the accept histogram,
    the rejected-draft and preemption counters and the ``preempt:`` and
    ``compile:`` instants are the reference's, by name and count."""
    pair = _pair(**{**MICRO, "mtp_depth": 2})
    out = []
    for (cls, tel_cls), (model, cfg, params) in zip(
            ((JaxBatcher, JaxRunTelemetry),
             (ContinuousBatcher, RunTelemetry)), pair):
        tel = tel_cls.create(sim_delta=False)
        cb = cls(model, cfg, params, slots=3, capacity=32, temperature=0.0,
                 seed=0, cache_backend="paged", page_size=8, num_pages=5,
                 spec_decode=True, spec_k=2, telemetry=tel)
        rng = np.random.RandomState(1)
        for _ in range(4):
            cb.submit(rng.randint(0, cfg.vocab_size, size=8), 12)
        cb.run_until_drained()
        snap = {m["name"]: m for m in tel.registry.snapshot()}
        inst = sorted(e["name"] for e in tel.tracer.records()
                      if e.get("type") == "instant")
        out.append((snap, inst, cb.steps))
    (jsnap, jinst, jsteps), (snap, inst, steps) = out
    assert steps == jsteps and inst == jinst
    assert any(n.startswith("preempt:") for n in inst)
    assert set(snap) == set(jsnap)
    for name in ("serving_preemptions_total", "serving_tokens_total",
                 "serving_specdec_drafts_rejected_total"):
        assert snap[name]["value"] == jsnap[name]["value"], name


def test_serving_attribution_and_compiled_memory():
    """tests/test_attrib.py:217: the owners split the live bytes exactly,
    every compile-cache key the reference notes carries compiled-memory
    stats, and the forced watermark dumps from the serving source."""
    pair = _pair(**MICRO)
    out = []
    for (cls, tel_cls, fl_cls), (model, cfg, params) in zip(
            ((JaxBatcher, JaxRunTelemetry, JaxFlightRecorder),
             (ContinuousBatcher, RunTelemetry, FlightRecorder)), pair):
        fl = fl_cls(watermark=0.99, ring=32)
        tel = tel_cls.create(run="serving-test", flight=fl)
        cb = cls(model, cfg, params, slots=2, capacity=32, temperature=0.0,
                 seed=0, cache_backend="paged", page_size=8, telemetry=tel,
                 capture_buckets=(4, 8))
        rng = np.random.RandomState(0)
        for _ in range(3):
            cb.submit(rng.randint(0, cfg.vocab_size, size=4), 4)
        cb.run_until_drained()
        out.append((tel, cb, fl))
    (jtel, jcb, _), (tel, cb, fl) = out
    snap = tel.attribution.snapshot()
    assert snap.owners["serving_params"] > 0
    assert snap.owners["kv_pool"] > 0
    assert snap.owners["kv_cache"] == snap.owners["spec_state"] == 0
    assert sum(snap.owners.values()) + snap.unattributed == snap.total_bytes
    assert set(snap.owners) == set(jtel.attribution.snapshot().owners)
    assert set(cb.compiled_memory) == set(jcb.compiled_memory)
    for stats in cb.compiled_memory.values():
        assert stats["temp_bytes"] >= 0 and stats["argument_bytes"] > 0
    programs = {m["labels"]["program"] for m in tel.registry.snapshot()
                if m["name"] == "compiled_temp_bytes"}
    assert programs == {":".join(map(str, k)) for k in cb.compiled_memory}
    if fl.dumps:
        assert fl.dumps[0]["source"] == "serving"


def test_oom_in_step_is_recorded_and_raised(tiny, monkeypatch):
    """An out-of-memory error inside a step reaches the flight recorder
    (a ``resource_exhausted`` dump from the serving source) and is
    re-raised."""
    _, (model, cfg, params) = tiny
    fl = FlightRecorder(watermark=0.99)
    tel = RunTelemetry.create(flight=fl)
    cb = ContinuousBatcher(model, cfg, params, slots=2, capacity=32,
                           temperature=0.0, cache_backend="paged",
                           page_size=8, telemetry=tel)
    cb.submit(np.arange(8), 4)

    def oom(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")

    monkeypatch.setattr(cb, "_grow_pages", oom)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        cb.step()
    assert fl.dumps[-1]["trigger"] == "resource_exhausted"
    assert fl.dumps[-1]["source"] == "serving"


def test_request_fields_are_the_reference():
    from repro.serving.scheduler import Request as JaxRequest
    assert [f.name for f in dataclasses.fields(Request)] == \
        [f.name for f in dataclasses.fields(JaxRequest)]


# ------------------------------------------------------ chip_smoke phase 14
@pytest.mark.parametrize("run", ["dense", "paged", "paged_tight", "prefix",
                                 "spec_dense", "spec_paged"])
def test_phase14_schedule_and_launch_reckoning(monkeypatch, run):
    """chip_smoke.py phase 14's runs at a tiny width on the CPU, with its
    traffic, slots, capacity and ladder (the schedule does not depend on
    the tokens: there is no EOS): every request drains at its length with
    no recompile after warmup, the pool empties, the tight pool waits on
    pages and preempts, and the launches are what ``batcher_launches``
    reckons from the run's program calls. The kernels' wrappers are stood
    in for by their plain versions and every tensor is taken for a
    card's, so the CPU run counts what the card's would."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.kernels import ops, ref

    monkeypatch.setattr(ops, "_on_cpu", lambda t: False)
    monkeypatch.setattr(ops._fa, "flash_attention_fwd",
                        lambda q, k, v, **kw: ref.attention_ref(q, k, v, **kw))
    monkeypatch.setattr(ops._dec, "decode_attention", ref.decode_attention_ref)
    monkeypatch.setattr(ops._pa, "paged_decode_attention",
                        ref.paged_attention_ref)
    monkeypatch.setattr(ops._rn, "rmsnorm", ref.rmsnorm_ref)
    cfg = dataclasses.replace(get_config("llama3_2_3b").smoke(),
                              num_layers=2, d_model=64, d_ff=128, num_heads=2,
                              num_kv_heads=1, head_dim=32, vocab_size=128,
                              mtp_depth=chip_smoke.SPEC_DEPTH)
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    kw, kind = {**chip_smoke.CB_RUNS, **chip_smoke.CB_SPEC_RUNS}[run]
    dev = torch.device("cpu")
    traffic = chip_smoke.batcher_traffic(cfg.vocab_size, kind, seed=0)
    rec = chip_smoke.serve_batcher(model, cfg, params, kw, traffic, False,
                                   dev)
    chip_smoke._check_batcher_run(run, rec, print)
    assert rec["launches"] == rec["want"]
    assert max(len(p) for p, _, _ in traffic) <= chip_smoke.CB_PROMPT[1]
    if run == "paged_tight":
        assert sum(rec["preempted"]) >= 1
        assert any(s["waited"] for s in rec["steps"])
    if run == "prefix":
        assert rec["hit_rate"] > 0.3 and rec["parked_pages"] > 0
        assert {t for _, _, t in traffic} == set(chip_smoke.CB_TENANTS)
    rungs = {s["rung"] for s in rec["steps"]}
    assert rungs == ({8} if kw["cache_backend"] == "dense" else {2, 4, 8})
