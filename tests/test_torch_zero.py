"""ZeRO at run time (``repro_torch.sharding``, ``RLHFTrainer(shard=)``) on
the CPU: ranks spawned over gloo, the reference harness's smoke config
(``tests/test_zero_rlhf.py:42-66``: 2 layers, d_model 128, vocab 64, 8
prompt and 12 generated tokens), f32, one thread a rank.

One group of 2 ranks and one of 4 run together, once for the module; each
rank rendezvouses through a ``FileStore`` under ``tmp_path`` with a 60 s
timeout, and the group must report within ``JOIN_S``. Every rank runs the
unsharded trainer beside the sharded ones, so each comparison is within a
process. With 3 prompts (ndp 2 and 4 do not divide 3) the batch replicates:

* 2-step PPO at ZeRO-1, ZeRO-3 ``tree`` and ZeRO-3 ``layer``, both
  engines: metrics and the trained trees (gathered) bit for bit ndp 1's;
* the persistent state a rank falls at every stage, to at most 0.30 of
  ndp 1's at ZeRO-3 separate with ndp 4;
* offload ``all`` over hydra ZeRO-3: the same bits, the trunk still
  sharded after the fetches;
* the dense and the paged greedy rollout from ``gather_copy``: the
  unsharded tokens;
* ``batch_shard``: "strict" raises on 3 prompts, "throughput" warns; with
  4 prompts at ndp 2 the split batch is within 1e-5 of ndp 1 (a change of
  summation order);
* the ``sharding_*`` counters and the ``zero_gather`` owner
  (``tests/test_obs.py::test_gather_copy_counts_bytes``);
* a ZeRO-3 ``layer`` run at ndp 2 from the JAX trainer's initial weights,
  greedy, against the JAX trainer's single-device metrics within 1e-4
  (the parity tolerance of ``tests/test_torch_separate.py``);
* the same on granite's MoE shape (2 layers, 4 experts, top 2, capacity
  factor 1.25): each rank holds the replicated batch and routes it as 2
  groups where the token count is even (``models/moe.py``), against the
  JAX trainer with ``repro.models.moe._num_dp_shards`` patched to 2 for
  its run (the reference's routing under a 2-way data mesh; its own
  pure-DP trainer traces without a mesh); and with 4 prompts under
  ``batch_shard="throughput"``, where each rank scores and trains on its
  own 2 rows and routes them as one group.
"""
import dataclasses
import datetime
import hashlib
import queue as queue_mod
import time
import warnings

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.obs import RunTelemetry, set_global_registry  # noqa: E402
from repro_torch.obs import global_registry  # noqa: E402
from repro_torch.rlhf import RLHFConfig, RLHFTrainer, Rollout  # noqa: E402
from repro_torch.rlhf.reward import make_target_token_reward  # noqa: E402
from repro_torch.sharding import ShardedContext  # noqa: E402
from repro_torch.sharding import tree_per_device_bytes  # noqa: E402
from repro_torch.tree import leaves, nbytes  # noqa: E402

SMOKE = dict(num_layers=2, d_model=128, d_ff=256, vocab_size=64,
             num_heads=4, num_kv_heads=2, head_dim=32, param_dtype="float32")
P, G, B = 8, 12, 3
ENGINES = ("separate", "hydra")
RUNS = ((1, "tree"), (3, "tree"), (3, "layer"))
NDPS = (2, 4)
JOIN_S = 240
TOL_JAX = 1e-4
TOL_SPLIT = 1e-5


def _cfg(get=get_config, **kw):
    return dataclasses.replace(get("llama3_2_3b").smoke(), **SMOKE, **kw)


def _moe_cfg(get=get_config):
    cfg = dataclasses.replace(get("granite_moe_3b_a800m").smoke(),
                              **dict(SMOKE, d_ff=0))
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.25))


def _two_shards(T):
    """The reference's routing groups under a 2-way data mesh."""
    return 2 if T % 2 == 0 else 1


def _rl(engine, **kw):
    base = dict(prompt_len=P, gen_len=G, lr=1e-3, critic_lr=1e-3,
                kl_coef=0.0, top_k=0, engine=engine, lora_rank=8)
    return RLHFConfig(**{**base, **kw})


def _prompts(n=B, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 64, (n, P))).long()


def _digest(tr) -> str:
    """A hash of the trained trees, gathered whole (a collective under
    ZeRO-3, which every rank runs)."""
    h = hashlib.sha1()
    if tr.engine is None:
        trees = [(tr.actor_plan, tr.actor_state["params"]),
                 (tr.critic_plan, tr.critic_state["params"])]
    else:
        ap = tr.engine.adapter_plans
        trees = [(ap.get("actor"), tr.actor_state["params"]),
                 (ap.get("critic"), tr.critic_state["params"])]
    for plan, tree in trees:
        full = tree if plan is None else plan.gather_copy(tree)[0]
        for t in leaves(full):
            h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _run(engine, shard, *, steps=2, n=B, telemetry=None, params=None,
         remat="none", cfg=None, **rl_kw):
    cfg = dataclasses.replace(cfg or _cfg(), remat=remat)
    kw = {} if params is None else {"params": params}
    tr = RLHFTrainer(cfg, cfg, _rl(engine, **rl_kw),
                     None if params is not None
                     else torch.Generator().manual_seed(0),
                     reward_fn=make_target_token_reward(7), shard=shard,
                     telemetry=telemetry, **kw)
    ms = [tr.train_step(_prompts(n), torch.Generator().manual_seed(10 + s))
          for s in range(steps)]
    return tr, ms


def _greedy_tokens(tr, params, backend):
    ro = Rollout(tr.actor, tr.actor_cfg, capacity=P + G, temperature=0.0,
                 top_k=0, backend=backend, page_size=4)
    return ro.generate(params, {"tokens": _prompts()}, G,
                       torch.Generator().manual_seed(3)).tokens.numpy()


def _rank_jobs(ndp, jax_params):
    """What a rank of the ndp group runs -> its results."""
    out = {}
    comm = ShardedContext.create(ndp, device="cpu").comm
    g = torch.Generator().manual_seed(comm.rank)
    parts = [torch.randn(4, 6, generator=g), torch.randn(8, 2, generator=g),
             torch.randn(3, 5, generator=g).double(),
             torch.randn(2, 3, generator=g)]
    dims = [0, 1, 1, 0]
    many = comm.all_gather_many(parts, dims)
    out["coalesced"] = (
        [torch.equal(a, comm.all_gather(t, d))
         for a, t, d in zip(many, parts, dims)],
        len({t.untyped_storage().data_ptr() for t in many}))
    for engine in ENGINES:
        if engine == "hydra":
            set_global_registry(None)
        tr1, m1 = _run(engine, None)
        out[(engine, "base")] = {"metrics": m1, "digest": _digest(tr1),
                                 "state": tr1.per_device_state_bytes()}
        if engine == "hydra":
            out["unsharded_gather_copy_bytes"] = global_registry().counter(
                "sharding_gather_copy_bytes_total").value()
        for stage, mode in RUNS:
            sc = ShardedContext.create(ndp, zero_stage=stage,
                                       gather_mode=mode, device="cpu")
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                tr, ms = _run(engine, sc)
            out[(engine, stage, mode)] = {
                "metrics": ms, "digest": _digest(tr),
                "state": tr.per_device_state_bytes(),
                "local": nbytes(list(tr.persistent_trees().values())),
                "warned": any("does not divide" in str(w.message)
                              for w in caught)}
            if mode == "layer" and stage == 3:
                lg = (tr.actor_plan if engine == "separate"
                      else tr.engine.base_plan).layer_specs
                out[(engine, "layer_stats")] = (lg.regathered,
                                                lg.norms_taken)
            if engine == "separate" and stage == 3 and mode == "layer":
                full, owned = tr.actor_plan.gather_copy(
                    tr.actor_state["params"])
                out["rollout"] = {
                    b: (_greedy_tokens(tr1, tr1.actor_state["params"], b),
                        _greedy_tokens(tr, full, b), owned)
                    for b in ("dense", "paged")}
    if ndp == 4:
        sc = ShardedContext.create(ndp, zero_stage=3, device="cpu")
        tr, ms = _run("hydra", sc, offload="all")
        plan, base = tr.engine.base_plan, tr.base_params
        out["offload"] = {
            "metrics": ms, "digest": _digest(tr),
            "per_device": tree_per_device_bytes(base, sc.comm),
            "whole": _whole_bytes(plan, base),
            "at_whole_shapes": [tuple(t.shape) == tuple(s) for t, s in zip(
                leaves(base), _shape_leaves(plan.shapes))]}
        set_global_registry(None)
        tel = RunTelemetry.create(sim_delta=False)
        sc = ShardedContext.create(ndp, zero_stage=3, device="cpu")
        tr, _ = _run("hydra", sc, steps=1, telemetry=tel)
        copies = global_registry().counter(
            "sharding_gather_copy_bytes_total").value()
        sample = [r for r in tr.memory.records if r.get("sample")][-1]
        step = tel.registry.counter("sharding_step_gathered_bytes_total")
        out["telemetry"] = {
            "copy_bytes": copies,
            "want_copy_bytes": _whole_bytes(tr.engine.base_plan,
                                            tr.base_params)
            + _whole_bytes(tr.engine.adapter_plans["actor"],
                           tr.actor_state["params"]),
            "step_actor": step.value(program="train_actor"),
            "step_critic": step.value(program="train_critic"),
            "plan_bytes": tr._role_gather_bytes(),
            "owners": tel.attribution.owners(),
            "sample_zero_gather": sample.get("attrib", {}).get(
                "zero_gather", 0),
            "per_device_spans": [s.args.get("measured_bytes_per_device")
                                 for s in tel.tracer.spans
                                 if s.cat == "phase"]}
    if ndp == 2:
        for engine in ENGINES:
            tr1, m1 = _run(engine, None, remat="full")
            sc = ShardedContext.create(ndp, zero_stage=3, device="cpu")
            tr, ms = _run(engine, sc, remat="full")
            lg = (tr.actor_plan if engine == "separate"
                  else tr.engine.base_plan).layer_specs
            out[(engine, "remat")] = {
                "base": (m1, _digest(tr1)), "layer": (ms, _digest(tr)),
                "regathered": lg.regathered}
        sc = ShardedContext.create(ndp, zero_stage=3, device="cpu")
        try:
            _run("separate", sc, steps=1, batch_shard="strict")
            out["strict"] = None
        except ValueError as e:
            out["strict"] = str(e)
        tr1, m1 = _run("separate", None, n=4, temperature=0.0)
        sc = ShardedContext.create(ndp, zero_stage=3, gather_mode="layer",
                                   device="cpu")
        tr, ms = _run("separate", sc, n=4, temperature=0.0)
        out["split"] = {"base": m1, "split": ms}
        sc = ShardedContext.create(ndp, zero_stage=3, gather_mode="layer",
                                   device="cpu")
        params = torch.load(jax_params)
        tr, ms = _run("separate", sc, temperature=0.0, params=params)
        out["jax"] = ms
        sc = ShardedContext.create(ndp, zero_stage=3, gather_mode="layer",
                                   device="cpu")
        params = torch.load(_moe_path(jax_params))
        tr, ms = _run("separate", sc, temperature=0.0, params=params,
                      cfg=_moe_cfg())
        out["jax_moe"] = ms
        sc = ShardedContext.create(ndp, zero_stage=3, gather_mode="layer",
                                   device="cpu")
        params = torch.load(_moe_path(jax_params))    # the run above trains
        tr, ms = _run("separate", sc, n=4, temperature=0.0, params=params,
                      cfg=_moe_cfg(), batch_shard="throughput")
        out["jax_moe_split"] = (ms, tr._split(4))
    return out


def _moe_path(path: str) -> str:
    return path.replace(".pt", "_moe.pt")


def _whole_bytes(plan, tree) -> int:
    """The bytes of ``tree``'s leaves at their whole shapes."""
    return sum(int(np.prod(s)) * t.element_size()
               for t, s in zip(leaves(tree), _shape_leaves(plan.shapes)))


def _shape_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _shape_leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _shape_leaves(v)
    elif tree is not None:
        yield tree      # a whole shape (a tuple of ints)


def _worker(rank, ndp, store, results, jax_params):
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, ndp), rank=rank,
            world_size=ndp, timeout=datetime.timedelta(seconds=60))
        out = _rank_jobs(ndp, jax_params)
        dist.destroy_process_group()
        results.put((ndp, rank, out, None))
    except BaseException as e:          # the parent fails the tests
        import traceback
        results.put((ndp, rank, None, f"{e!r}\n{traceback.format_exc()}"))


def _jax_reference(path):
    """The JAX trainers (separate, greedy, f32) on the smoke config and on
    the MoE one (under the two-group routing patch; with 3 prompts and
    with 4), each config from its own initial weights: a function running
    the three for their 2 metrics each, and those weights in the port's
    layout saved to ``path`` and ``_moe_path(path)``."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.models import moe as jax_moe
    from repro.rlhf import RLHFConfig as JaxRLHFConfig
    from repro.rlhf import RLHFTrainer as JaxRLHFTrainer
    from repro.rlhf.reward import make_target_token_reward as jax_reward
    from repro_torch import bridge

    rl = JaxRLHFConfig(prompt_len=P, gen_len=G, lr=1e-3, critic_lr=1e-3,
                       kl_coef=0.0, top_k=0, temperature=0.0,
                       engine="separate")
    np_tree = lambda t: jax.tree.map(lambda x: np.asarray(x).copy(), t)  # noqa: E731
    prompts = jnp.asarray(_prompts().numpy())
    trainers = []
    for get_cfg, out in ((_cfg, path), (_moe_cfg, _moe_path(path))):
        jcfg = get_cfg(jax_get_config)
        tr = JaxRLHFTrainer(jcfg, jcfg, rl, jax.random.PRNGKey(0),
                            reward_fn=jax_reward(7))
        cfg = get_cfg()
        torch.save({"actor": bridge.from_jax(
                        np_tree(tr.actor_state["params"]), cfg, "cpu"),
                    "critic": bridge.from_jax(
                        np_tree(tr.critic_state["params"]), cfg, "cpu")},
                   out)
        trainers.append(tr)
    jcfg = _moe_cfg(jax_get_config)
    trainers.append(JaxRLHFTrainer(jcfg, jcfg, rl, jax.random.PRNGKey(0),
                                   reward_fn=jax_reward(7)))
    prompts4 = jnp.asarray(_prompts(4).numpy())

    def run():
        dense = [trainers[0].train_step(prompts, jax.random.PRNGKey(s))
                 for s in range(2)]
        plain = jax_moe._num_dp_shards
        jax_moe._num_dp_shards = _two_shards
        try:
            moe = [trainers[1].train_step(prompts, jax.random.PRNGKey(s))
                   for s in range(2)]
            split = [trainers[2].train_step(prompts4, jax.random.PRNGKey(s))
                     for s in range(2)]
        finally:
            jax_moe._num_dp_shards = plain
        return dense, moe, split
    return run


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """({ndp: [rank 0's results, rank 1's, ...]}, the JAX metrics, the
    JAX metrics of the MoE run with 3 prompts and with 4)."""
    tmp = tmp_path_factory.mktemp("zero")
    jax_params = str(tmp / "jax_params.pt")
    jax_steps = _jax_reference(jax_params)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(r, ndp, str(tmp / f"store{ndp}"),
                                               results, jax_params))
             for ndp in NDPS for r in range(ndp)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        jax_metrics, jax_moe, jax_split = (
            [{k: float(v) for k, v in m.items()} for m in ms]
            for ms in jax_steps())
        got = {}
        while len(got) < len(procs):
            if time.perf_counter() - t0 > JOIN_S:
                pytest.fail(f"the ranks did not report in {JOIN_S} s "
                            f"({sorted(got)})")
            try:
                ndp, rank, out, err = results.get(timeout=2.0)
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    pytest.fail(f"a rank exited without a result: {dead}")
                continue
            if err is not None:
                pytest.fail(f"ndp {ndp} rank {rank}: {err}")
            got[ndp, rank] = out
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    return ({ndp: [got[ndp, r] for r in range(ndp)] for ndp in NDPS},
            jax_metrics, jax_moe, jax_split)


@pytest.mark.parametrize("mode", [f"{s}-{m}" for s, m in RUNS])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("ndp", NDPS)
def test_ppo_bit_identity(ranks, ndp, engine, mode):
    """2-step PPO with a replicated batch: every rank's metrics and its
    gathered trained trees are ndp 1's bit for bit; the batch that does
    not divide ndp warned."""
    stage, gm = mode.split("-")
    for out in ranks[0][ndp]:
        base = out[(engine, "base")]
        got = out[(engine, int(stage), gm)]
        assert got["metrics"] == base["metrics"]
        assert got["digest"] == base["digest"]
        assert got["warned"]


@pytest.mark.parametrize("engine", ENGINES)
def test_layer_mode_regathers_saved_weights(ranks, engine):
    """Layer mode without remat: the weights a layer's ops save for the
    backward are kept as shards and gathered again there (so the gathered
    layer dies with the forward); on the separate engine each layer
    shard's norm term comes from its gather's backward (no gradient
    gathered for the norm). The frozen hydra trunk has no gradients."""
    for ndp in NDPS:
        for out in ranks[0][ndp]:
            regathered, norms = out[(engine, "layer_stats")]
            assert regathered > 0
            if engine == "separate":
                assert norms > 0
            else:
                assert norms == 0


@pytest.mark.parametrize("ndp", NDPS)
def test_coalesced_all_gather_is_the_per_tensor_one(ranks, ndp):
    """``Collectives.all_gather_many`` (one collective a dtype, mixed
    dims) gives each tensor's own ``all_gather``, each in storage of its
    own (the per-layer gather tells gathered weights by storage)."""
    for out in ranks[0][ndp]:
        same, storages = out["coalesced"]
        assert same == [True] * 4
        assert storages == 4


@pytest.mark.parametrize("engine", ENGINES)
def test_layer_gather_inside_remat_checkpoint(ranks, engine):
    """Under remat "full" the per-layer gather runs inside each layer's
    checkpoint (the checkpoint keeps the shards, its recompute gathers
    again; no saved weight is kept as a shard by the hooks): ZeRO-3 layer
    mode at ndp 2 gives the unsharded remat run's bits."""
    for out in ranks[0][2]:
        run = out[(engine, "remat")]
        assert run["layer"] == run["base"]
        assert run["regathered"] == 0


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("ndp", NDPS)
def test_per_device_state_falls_at_every_stage(ranks, ndp, engine):
    for out in ranks[0][ndp]:
        base = out[(engine, "base")]["state"]
        z1, z3 = out[(engine, 1, "tree")], out[(engine, 3, "tree")]
        assert z3["state"] < z1["state"] < base
        assert out[(engine, 3, "layer")]["state"] == z3["state"]
        assert z3["local"] <= z3["state"]


def test_zero3_separate_cut_at_ndp4(ranks):
    """ZeRO-3 keeps at most 0.30 of ndp 1's persistent bytes a rank on the
    separate engine at ndp 4 (the reference's bound)."""
    for out in ranks[0][4]:
        cut = out[("separate", 3, "tree")]["state"] / \
            out[("separate", "base")]["state"]
        assert cut <= 0.30, cut


def test_offload_composes_with_zero3(ranks):
    """offload "all" over hydra ZeRO-3: ndp 1's bits, and the trunk comes
    back from each park sharded: its sharded leaves at the shards' shapes,
    under 0.30 of the whole trunk a rank."""
    for out in ranks[0][4]:
        off = out["offload"]
        assert off["metrics"] == out[("hydra", "base")]["metrics"]
        assert off["digest"] == out[("hydra", "base")]["digest"]
        assert not all(off["at_whole_shapes"])
        assert off["per_device"] < 0.30 * off["whole"]


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_rollout_from_gather_copy(ranks, backend):
    """The greedy rollout (dense and paged) from a ZeRO-3 ``gather_copy``
    gives the unsharded trainer's tokens; the copy is owned."""
    for ndp in NDPS:
        for out in ranks[0][ndp]:
            want, got, owned = out["rollout"][backend]
            assert owned
            np.testing.assert_array_equal(got, want)


def test_batch_shard_strict_raises_and_throughput_warns(ranks):
    out = ranks[0][2][0]
    assert out["strict"] is not None and "does not divide" in out["strict"]
    assert out[("separate", 1, "tree")]["warned"]


def test_divisible_batch_splits_within_tolerance(ranks):
    """4 prompts at ndp 2 under "throughput": each rank scores and trains
    on its 2 rows, loss denominators over all 4, gradients summed; within
    1e-5 of ndp 1 (the summation order moves)."""
    for out in ranks[0][2]:
        base, split = out["split"]["base"], out["split"]["split"]
        for a, b in zip(base, split):
            assert a.keys() == b.keys()
            for k in a:
                assert b[k] == pytest.approx(a[k], abs=TOL_SPLIT), k


def test_gather_counters_and_zero_gather_owner(ranks):
    """``sharding_gather_copy_bytes_total`` counts nothing unsharded and
    the rollout's gathered trunk and adapter at ZeRO-3;
    ``sharding_step_gathered_bytes_total`` counts each update's plan bytes;
    the ``zero_gather`` and ``tp_gather`` owners are registered and the
    rollout's sample charges the copy to ``zero_gather``; every phase span
    carries the largest live bytes over the ranks."""
    for out in ranks[0][4]:
        assert out["unsharded_gather_copy_bytes"] == 0
        tel = out["telemetry"]
        assert tel["copy_bytes"] == tel["want_copy_bytes"] > 0
        assert tel["step_actor"] == tel["plan_bytes"]["train_actor"] > 0
        assert tel["step_critic"] == tel["plan_bytes"]["train_critic"] > 0
        owners = tel["owners"]
        assert owners.index("zero_gather") < owners.index("merged_rollout")
        assert "tp_gather" in owners
        assert tel["sample_zero_gather"] > 0
        assert len(tel["per_device_spans"]) == 7
        assert all(b is not None and b > 0 for b in tel["per_device_spans"])


def test_zero3_matches_jax_trainer(ranks):
    """A ZeRO-3 ``layer`` run at ndp 2 (3 prompts: replicated) from the
    JAX trainer's initial weights, greedy: the JAX trainer's metrics on
    one device within 1e-4 (closing the loop: the reference shows its own
    sharded run equals its single device)."""
    want = ranks[1]
    for out in ranks[0][2]:
        for a, b in zip(want, out["jax"]):
            for k in ("loss", "ppo_loss", "kl", "vf_loss", "grad_norm",
                      "mean_reward"):
                assert b[k] == pytest.approx(a[k], abs=TOL_JAX), k


def test_zero3_moe_matches_jax_trainer(ranks):
    """Granite's MoE shape at ZeRO-3 ``layer``, ndp 2, 3 prompts
    (replicated): each rank routes its whole batch as 2 groups where the
    token count is even (the prefill's 24 tokens, the scoring and training
    forwards' 60; a decode step's 3 rows route as one), as the JAX trainer
    does with its routing patched to 2 groups: its metrics within 1e-4."""
    want = ranks[2]
    for out in ranks[0][2]:
        for a, b in zip(want, out["jax_moe"]):
            for k in ("loss", "ppo_loss", "kl", "vf_loss", "grad_norm",
                      "mean_reward"):
                assert b[k] == pytest.approx(a[k], abs=TOL_JAX), k


def test_zero3_moe_split_batch_matches_jax_trainer(ranks):
    """Granite's MoE shape at ZeRO-3 ``layer``, ndp 2, 4 prompts under
    ``batch_shard="throughput"``: the scoring and training forwards split
    the batch, so each rank routes its own 2 rows as one group and its aux
    loss is half that group's (``models/moe.py``), while the rollout from
    the gathered copy routes the whole batch as 2 groups; the step's sum
    over the ranks is the JAX trainer's mean over its 2 patched groups:
    its metrics within 1e-4."""
    want = ranks[3]
    for out in ranks[0][2]:
        got, split = out["jax_moe_split"]
        assert split
        for a, b in zip(want, got):
            for k in ("loss", "ppo_loss", "kl", "vf_loss", "grad_norm",
                      "mean_reward"):
                assert b[k] == pytest.approx(a[k], abs=TOL_JAX), k
