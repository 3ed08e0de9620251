"""The port's compile-bucket ladder and bucketed rollout against the JAX
reference on the CPU, and the decode step's static-buffer loop
(``rlhf/decode_graph.py``, which the card captures and replays) against a
plain decode loop.

- ``serving/buckets.py``: ``BucketLadder`` and ``CompileCache`` against
  the reference's on the same calls.
- ``Rollout(capture_buckets=)`` against the reference's on the setup of
  ``tests/test_specdec.py:304-322`` (ladder (8, 16), ``warmup(params, 2,
  16)``, P in 5, 7, 8, 11), dense and paged (G = 4): greedy tokens
  identical, logp within 1e-5 (``tests/test_kernel_model_paths.py``), the
  compile-cache stats equal.
- The static-buffer loop against a plain loop that makes its position and
  block table anew every step (the pre-graph rollout): dense, paged with
  G = 8 across several page boundaries and a CoW copy, and Mamba; the
  same CPU ops in the same order, so tokens and logp bit for bit.
- Two PPO iterations with ``capture_buckets`` against the JAX trainer on
  both engines: greedy tokens identical, metrics within 1e-4 (as
  ``tests/test_torch_train.py``), the compile-cache stats equal.

Weights and prompts come from the reference (``repro_torch.bridge``) or
from numpy with a seed. f32 smoke configs.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.rlhf import RLHFConfig as JaxRLHFConfig  # noqa: E402
from repro.rlhf import RLHFTrainer as JaxRLHFTrainer  # noqa: E402
from repro.rlhf import Rollout as JaxRollout  # noqa: E402
from repro.rlhf.reward import \
    make_target_token_reward as jax_target_reward  # noqa: E402
from repro.serving import buckets as JB  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.paged import PageManager, copy_pages  # noqa: E402
from repro_torch.rlhf import RLHFConfig, Rollout, sample_token  # noqa: E402
from repro_torch.rlhf import decode_graph as DG  # noqa: E402
from repro_torch.rlhf.reward import make_target_token_reward  # noqa: E402
from repro_torch.serving import BucketLadder, CompileCache  # noqa: E402

LOGP_TOL = 1e-5
METRIC_TOL = 1e-4
# tests/test_specdec.py::tiny_cfg without the MTP heads (not ported), f32
TINY = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=64, num_heads=4,
            num_kv_heads=2, head_dim=16, param_dtype="float32")


def _cfgs(**kw):
    kw = {**TINY, **kw}
    return (dataclasses.replace(jax_get_config("llama3_2_3b").smoke(), **kw),
            dataclasses.replace(get_config("llama3_2_3b").smoke(), **kw))


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x).copy(), tree)


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol, rtol=0)


# ------------------------------------------------------ ladder and cache
@pytest.mark.parametrize("buckets", [(8, 16), (32, 4, 4, 1, 0, -3),
                                     (512, 2048, 1024)])
def test_bucket_ladder_matches_reference(buckets):
    """fit, up_to and the rungs, for extents below, on, between and above
    every rung."""
    mine, want = BucketLadder(buckets), JB.BucketLadder(buckets)
    assert mine.buckets == want.buckets
    for n in list(range(0, 40)) + [511, 512, 513, 2048, 2049, 5000]:
        assert mine.fit(n) == want.fit(n)
        assert mine.up_to(n) == want.up_to(n)


@pytest.mark.parametrize("cap", [None, 1, 3, 48, 64, 100, 4096])
def test_default_ladder_matches_reference(cap):
    assert BucketLadder.default(cap).buckets == \
        JB.BucketLadder.default(cap).buckets


def test_empty_ladder_is_refused_by_both():
    with pytest.raises(ValueError, match="empty"):
        BucketLadder([0, -1])
    with pytest.raises(AssertionError):
        JB.BucketLadder([0, -1])


def test_compile_cache_stats_match_reference():
    """The same warm / finish_warmup / lookup sequence: the same returns
    and stats at every step (hits, misses, recompiles after warmup, hit
    rate, keys)."""
    mine, want = CompileCache(), JB.CompileCache()
    assert mine.stats() == want.stats()          # empty: hit rate 1.0
    seq = [("warm", ("prefill", "dense", 8)),
           ("lookup", ("prefill", "dense", 8)),
           ("lookup", ("prefill", "paged", 16)),     # a miss before warmup
           ("finish", None),
           ("lookup", ("prefill", "paged", 16)),
           ("lookup", ("prefill", "dense", 32)),     # a recompile
           ("warm", ("prefill", "dense", 64)),
           ("lookup", ("prefill", "dense", 64)),
           ("lookup", ("prefill", "dense", 32))]
    for op, key in seq:
        for cache in (mine, want):
            if op == "warm":
                cache.warm(key)
            elif op == "finish":
                cache.finish_warmup()
        if op == "lookup":
            assert mine.lookup(key) == want.lookup(key)
        assert mine.stats() == want.stats()
        assert mine.warmed == want.warmed
    assert mine.stats()["recompiles"] == 1


# ------------------------------------------------- bucketed rollout vs JAX
@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = _cfgs()
    jm = JaxModel(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = Model(tcfg, device="cpu")
    tparams = bridge.from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, tcfg, jm, jparams, tm, tparams


@pytest.mark.parametrize("backend,group", [("dense", 1), ("paged", 4)])
def test_bucketed_rollout_matches_reference(tiny, backend, group):
    """Ragged prompt lengths (5, 7, 8, 11) through a (8, 16) ladder after
    ``warmup(params, 2, 16)``: greedy tokens identical to the reference's
    bucketed rollout, logp within 1e-5, masks equal, and the compile
    cache's stats equal after each call. The dense backend warms both
    rungs, so it never recompiles; the reference's paged warmup registers
    no key, so there each rung's first call counts as a recompile on both
    sides."""
    jcfg, tcfg, jm, jparams, tm, tparams = tiny
    kw = dict(capacity=26, temperature=0.0, top_k=0,
              capture_buckets=(8, 16))
    if backend == "paged":
        kw.update(backend="paged", page_size=4)
    jro, tro = JaxRollout(jm, jcfg, **kw), Rollout(tm, tcfg, **kw)
    jro.warmup(jparams, 2, 16)
    tro.warmup(tparams, 2, 16)
    assert tro.compile_cache.stats() == jro.compile_cache.stats()
    for P in (5, 7, 8, 11):
        prompts = np.random.RandomState(P).randint(0, 64, (2, P))
        want = jro.generate(jparams, {"tokens": jnp.asarray(prompts)}, 10,
                            jax.random.PRNGKey(13), group_size=group)
        got = tro.generate(tparams, {"tokens": torch.from_numpy(prompts)},
                           10, torch.Generator(), group_size=group)
        assert got.tokens.shape == (2 * group, P + 10)
        np.testing.assert_array_equal(got.tokens.numpy(),
                                      np.asarray(want.tokens))
        _close(got.logp.numpy(), want.logp, LOGP_TOL)
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
        assert tro.compile_cache.stats() == jro.compile_cache.stats()
    st = tro.compile_cache.stats()
    assert st["hits"] + st["misses"] == 4
    assert st["recompiles"] == (0 if backend == "dense" else 2)


def test_bucketed_prompt_pads_to_the_rung(tiny):
    _, tcfg, _, _, tm, _ = tiny
    ro = Rollout(tm, tcfg, capacity=26, capture_buckets=(8, 16))
    batch, lens, Sb = ro._bucketed_prompt(torch.arange(1, 12)[None])
    assert Sb == 16 and batch["tokens"].shape == (1, 16)
    assert batch["tokens"][0, 11:].eq(0).all()
    assert lens.tolist() == [11] and lens.dtype == torch.int32
    plain = Rollout(tm, tcfg, capacity=26)
    batch, lens, Sb = plain._bucketed_prompt(torch.arange(1, 12)[None])
    assert Sb == 11 and batch["tokens"].shape == (1, 11)


def test_dense_rung_above_capacity_raises(tiny):
    """A rung above the dense cache's capacity would keep the padding
    and drop the prompt's first positions from the rolling cache: the
    dense call raises. A prompt that is its own rung pads nothing and
    runs; the paged backend, whose prefill keeps every position, runs the
    same prompt and rung."""
    _, tcfg, _, _, tm, tparams = tiny
    prompt = {"tokens": torch.from_numpy(
        np.random.RandomState(0).randint(0, 64, (2, 11)))}
    ro = Rollout(tm, tcfg, capacity=14, temperature=0.0,
                 capture_buckets=(8, 16))
    with pytest.raises(ValueError, match="capacity 14"):
        ro.generate(tparams, prompt, 3, torch.Generator())
    res = ro.generate(tparams, {"tokens": prompt["tokens"][:, :8]}, 3,
                      torch.Generator())
    assert res.tokens.shape == (2, 11)
    paged = Rollout(tm, tcfg, capacity=14, temperature=0.0,
                    capture_buckets=(8, 16), backend="paged", page_size=4)
    res = paged.generate(tparams, prompt, 3, torch.Generator())
    assert res.tokens.shape == (2, 14)
    assert paged.compile_cache.lookup(("prefill", "paged", 16))


def test_ladder_on_a_mamba_model_raises():
    """The lengths mask cannot cover a Mamba state: the bucketed prefill
    (warmup and generate) raises, as the reference's asserts."""
    cfg = get_config("mamba2_370m").smoke()
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    ro = Rollout(model, cfg, capacity=48, capture_buckets=(32,))
    with pytest.raises(ValueError, match="Mamba"):
        ro.warmup(params, 1, 32)
    with pytest.raises(ValueError, match="Mamba"):
        ro.generate(params, {"tokens": torch.zeros((1, 20), dtype=torch.long)},
                    4, torch.Generator())


# ----------------------------------------- static-buffer loop vs plain loop
def _plain_dense(ro, model, params, tokens, gen, g):
    """The pre-graph dense loop: a fresh position tensor every step."""
    B, P = tokens.shape
    kw = dict(temperature=ro.temperature, top_k=ro.top_k)
    logits, caches = model.prefill(params, {"tokens": tokens}, ro.capacity)
    tok, lp = sample_token(g, logits, **kw)
    toks, lps = [tok], [lp]
    for t in range(1, gen):
        pos = torch.full((B,), P + t - 1, dtype=torch.int32)
        tok, lp = sample_token(
            g, model.decode_step(params, caches, tok, pos)[0], **kw)
        toks.append(tok)
        lps.append(lp)
    return torch.stack(toks, 1), torch.stack(lps, 1)


def _plain_paged(ro, model, cfg, params, tokens, gen, g, G):
    """The pre-graph paged GRPO loop: the block table uploaded anew every
    step, CoW copies before the step."""
    B, P = tokens.shape
    ps, BG = ro.page_size, B * G
    nb = -(-(P + gen) // ps)
    kw = dict(temperature=ro.temperature, top_k=ro.top_k)
    pm = PageManager(B * (-(-P // ps)) + BG * (nb - P // ps), ps)
    for b in range(B):
        pm.allocate(b * G, P)
    pools = model.init_paged_pools(pm.num_pages, ps, torch.float32)
    bt = torch.from_numpy(pm.block_table_array([b * G for b in range(B)], nb))
    _, pools, h = model.paged_prefill(
        params, {"tokens": tokens}, pools, bt,
        torch.full((B,), P, dtype=torch.int32), return_h=True)
    for b in range(B):
        for k in range(1, G):
            pm.fork(b * G, b * G + k)
    logits = model.unembed(params, torch.repeat_interleave(h, G, 0)[:, None])
    tok, lp = sample_token(g, logits[:, 0], **kw)
    toks, lps, cows = [tok], [lp], 0
    for t in range(1, gen):
        copies = []
        for s in range(BG):
            copies += pm.append_token(s)
        if copies:
            cows += len(copies)
            for pool in pools:
                copy_pages(pool, [c[0] for c in copies],
                           [c[1] for c in copies])
        pos = torch.full((BG,), P + t - 1, dtype=torch.int32)
        table = torch.from_numpy(pm.block_table_array(list(range(BG)), nb))
        tok, lp = sample_token(g, model.paged_decode_step(
            params, pools, tok, pos, table)[0], **kw)
        toks.append(tok)
        lps.append(lp)
    return torch.stack(toks, 1), torch.stack(lps, 1), cows


def test_static_buffer_loop_matches_plain_dense(tiny):
    _, tcfg, _, _, tm, tparams = tiny
    tokens = torch.from_numpy(np.random.RandomState(1).randint(0, 64, (3, 9)))
    ro = Rollout(tm, tcfg, capacity=24, temperature=0.8, top_k=20)
    got = ro.generate(tparams, {"tokens": tokens}, 12,
                      torch.Generator().manual_seed(2))
    toks, lps = _plain_dense(ro, tm, tparams, tokens, 12,
                             torch.Generator().manual_seed(2))
    assert torch.equal(got.tokens[:, 9:], toks)
    assert torch.equal(got.logp[:, 9:], lps)
    st = ro.decode_stats
    assert not st["graphed"] and st["replays"] == 0 and st["steps"] == 11


def test_static_buffer_loop_matches_plain_paged(tiny, monkeypatch):
    """G = 8 forks of prompts of 7 tokens (a partial shared page: seven
    CoW copies a group at step 1) over pages of 4, generating 14 tokens
    across four page boundaries: the in-place table written only on steps
    where a page was taken gives the plain loop's tokens and logp bit for
    bit. The same loop with every table write one step late (a mutation)
    differs, so a table written at the wrong step shows."""
    _, tcfg, _, _, tm, tparams = tiny
    tokens = torch.from_numpy(np.random.RandomState(3).randint(0, 64, (2, 7)))
    ro = Rollout(tm, tcfg, capacity=21, temperature=0.8, top_k=20,
                 backend="paged", page_size=4)
    run = lambda: ro.generate(  # noqa: E731
        tparams, {"tokens": tokens}, 14, torch.Generator().manual_seed(4),
        group_size=8)
    got = run()
    toks, lps, cows = _plain_paged(ro, tm, tcfg, tparams, tokens, 14,
                                   torch.Generator().manual_seed(4), 8)
    assert cows == 14 == ro.page_manager.stats.n_cow_copies
    assert torch.equal(got.tokens[:, 7:], toks)
    assert torch.equal(got.logp[:, 7:], lps)
    assert ro.decode_stats["page_manager_ms"] > 0

    write = DG.DecodeGraph.write_table
    late = {}

    def write_late(self, table):
        prev = late.get(id(self))
        late[id(self)] = table
        write(self, table if prev is None else prev)

    monkeypatch.setattr(DG.DecodeGraph, "write_table", write_late)
    bad = run()
    assert not torch.equal(bad.logp[:, 7:], lps)
    assert not torch.equal(bad.tokens[:, 7:], toks)


def test_static_buffer_loop_matches_plain_mamba():
    cfg = get_config("mamba2_370m").smoke()
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(5))
    tokens = torch.from_numpy(np.random.RandomState(6).randint(
        0, cfg.vocab_size, (2, 32)))
    ro = Rollout(model, cfg, capacity=48, temperature=0.8, top_k=20)
    got = ro.generate(params, {"tokens": tokens}, 10,
                      torch.Generator().manual_seed(7))
    toks, lps = _plain_dense(ro, model, params, tokens, 10,
                             torch.Generator().manual_seed(7))
    assert torch.equal(got.tokens[:, 32:], toks)
    assert torch.equal(got.logp[:, 32:], lps)


def test_decode_graph_on_cpu_runs_the_body_on_its_buffers():
    """On the CPU the step never captures (there are no CUDA graphs):
    every call runs the body on the static buffers it just wrote, counts
    nothing as a replay, and release drops the body."""
    seen = []

    def body(tok, pos, table):
        seen.append((tok.clone(), pos.clone(), table.clone()))
        return tok.float()[:, None] + pos[:, None]

    g = DG.DecodeGraph(body, 2, "cpu", steps=5, table_blocks=3,
                       capture=True)
    assert not g.stats["graphed"]
    g.write_table(np.array([[0, 1, -1], [2, -1, -1]], np.int32))
    out = g(torch.tensor([5, 6]), 9)
    assert out.tolist() == [[14.0], [15.0]]
    assert seen[0][1].tolist() == [9, 9] and seen[0][1].dtype == torch.int32
    assert seen[0][2].tolist() == [[0, 1, -1], [2, -1, -1]]
    ops.reset_launches()
    with ops.capturing() as made:
        ops.launches["rmsnorm"] += 3
    assert made["rmsnorm"] == 3 and ops.launches["rmsnorm"] == 0
    ops.add_launches(made)
    assert ops.launches["rmsnorm"] == 3
    ops.reset_launches()
    stats = g.release()
    assert stats["replays"] == 0 and g.token is None


# ------------------------------------------------- PPO iterations vs JAX
RL_HYDRA = dict(prompt_len=8, gen_len=8, lr=3e-3, critic_lr=3e-3,
                kl_coef=0.1, temperature=0.0, top_k=0, engine="hydra",
                lora_rank=4, capture_buckets=(6, 12))
RL_SEPARATE = dict(prompt_len=8, gen_len=8, lr=1e-2, critic_lr=1e-2,
                   kl_coef=0.1, temperature=0.0, top_k=0, engine="separate",
                   capture_buckets=(6, 12))
# tests/test_torch_separate.py's OPT-shaped pair, cut small
OPT = dict(num_layers=2, vocab_size=64, num_heads=4, head_dim=16,
           num_kv_heads=4)


def _opt_cfgs(d_model):
    kw = {**OPT, "d_model": d_model, "d_ff": 2 * d_model,
          "param_dtype": "float32"}
    return (dataclasses.replace(jax_get_config("opt_1_3b").smoke(), **kw),
            dataclasses.replace(get_config("opt_1_3b").smoke(), **kw))


def _spy(tr, tokens, to_np):
    gen = tr._gen

    def spy(p, key):
        ro = gen(p, key)
        tokens.append(to_np(ro.tokens))
        return ro

    tr._gen = spy


@pytest.mark.parametrize("engine", ["hydra", "separate"])
def test_bucketed_ppo_iterations_match_reference(engine):
    """Two greedy f32 PPO iterations with a (6, 12) ladder (the 8-token
    prompts pad to 12) from the reference trainer's own initial weights,
    the programmatic reward: identical greedy tokens, loss, kl, vf_loss
    and mean_reward within 1e-4, and the rollout's compile-cache stats
    equal (one miss, one hit)."""
    hydra = engine == "hydra"
    if hydra:
        jcfg, tcfg = _cfgs(d_model=64, d_ff=128, head_dim=16)
        jcrit, tcrit = jcfg, tcfg
        rl = RL_HYDRA
    else:
        (jcfg, tcfg), (jcrit, tcrit) = _opt_cfgs(128), _opt_cfgs(64)
        rl = RL_SEPARATE
    jtr = JaxRLHFTrainer(jcfg, jcrit, JaxRLHFConfig(**rl),
                         jax.random.PRNGKey(0),
                         reward_fn=jax_target_reward(7))
    if hydra:
        ttr = bridge.trainer_from_jax(
            _np(jtr.base_params), _np(jtr.engine.adapters), tcfg,
            RLHFConfig(**rl), reward_fn=make_target_token_reward(7),
            device="cpu")
    else:
        ttr = bridge.separate_trainer_from_jax(
            _np(jtr.actor_state["params"]), _np(jtr.critic_state["params"]),
            tcfg, tcrit, RLHFConfig(**rl),
            reward_fn=make_target_token_reward(7), device="cpu")
    assert ttr.rollout.prefill_ladder.buckets == (6, 12)
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
        for k in ("loss", "kl", "vf_loss", "mean_reward"):
            _close(got[k], float(want[k]), METRIC_TOL)
        assert ttr.rollout.compile_cache.stats() == \
            jtr.rollout.compile_cache.stats()
    assert ttr.rollout.compile_cache.stats()["misses"] == 1
