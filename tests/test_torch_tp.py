"""Tensor parallelism at run time (``repro_torch.sharding.tp``,
``ShardedContext.create(model=2)``, ``RLHFTrainer(shard=)``,
``Rollout(mesh=)``, ``ContinuousBatcher(mesh=)``) on the CPU: ranks
spawned over gloo with the reference harness's smoke config
(``tests/test_tp.py:47-66``: 2 layers, d_model 128, d_ff 256, vocab 64, 4
heads, 2 KV heads, head_dim 32, f32, 8 prompt and 12 generated tokens, 4
prompts), one thread a rank.

One group of 2 ranks (ndp 1, ntp 2) and one of 4 (ndp 2, ntp 2) run
together, once for the module; each rank rendezvouses through a
``FileStore`` under ``tmp_path`` with a 60 s timeout, and the group must
report within ``JOIN_S``. Every rank runs the unsharded trainer beside the
sharded ones, so each comparison is within a process. The bar is the
reference's (DESIGN.md §9.5): TP splits the row products' contractions, so
losses are allclose (rtol 1e-4, atol 1e-6), not bitwise; greedy f32
rollouts keep the tokens.

* 2-step PPO at ZeRO 0 and ZeRO-3 ``layer``, both engines, against ndp 1
  ntp 1; and from the JAX trainer's initial weights against the JAX
  trainer's one-device metrics within 1e-4;
* the dense and paged greedy rollout (the paged one forked 2 ways) and the
  hydra merged rollout from a ZeRO-3 ``gather_copy``, and the continuous
  batcher dense and paged, against the unsharded tokens; the batcher's KV
  reservation a rank half the unsharded one;
* the persistent state a rank: at most 0.60 of ntp 1's from pure TP on
  the separate engine, and less again composed with ZeRO-3;
* a scoring forward's all-reduces: 2 a layer, 1 at the embedding, 2 for
  the log-probs, and no gather;
* the hydra actor's and critic's adapter gradients and the separate
  actor's gradients: each rank's the unsharded ones' cut;
* the ``tp_gather`` owner filled by the rollout's gather copies and
  ``zero_gather`` empty;
* hydra at ZeRO-3 under offload "all", against ntp 1;
* 2 greedy GRPO steps on the paged backend against ``shard=None``.
The refusals (a KV head count that does not divide, Mamba, MTP and
speculative decoding, a graph under a TP mesh) need no group.
"""
import dataclasses
import datetime
import queue as queue_mod
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.obs import RunTelemetry  # noqa: E402
from repro_torch.rlhf import (GRPOConfig, GRPOTrainer, ModelEngine,  # noqa: E402
                              RLHFConfig, RLHFTrainer, Rollout)
from repro_torch.rlhf.reward import make_target_token_reward  # noqa: E402
from repro_torch.serving import ContinuousBatcher  # noqa: E402
from repro_torch.sharding import ShardedContext, SpecMesh, use_mesh  # noqa: E402
from repro_torch.sharding import ShardingStrategy, TensorParallel  # noqa: E402
from repro_torch.sharding.context import _model_dim  # noqa: E402
from repro_torch.sharding.rules import spec_leaves  # noqa: E402
from repro_torch.steps import (_accumulated_grads, _action_logp,  # noqa: E402
                               critic_loss, ppo_actor_loss)
from repro_torch.tree import leaves  # noqa: E402

SMOKE = dict(num_layers=2, d_model=128, d_ff=256, vocab_size=64,
             num_heads=4, num_kv_heads=2, head_dim=32, param_dtype="float32",
             remat="none")
P, G, B = 8, 12, 4
NTP = 2
NDPS = (1, 2)
ENGINES = ("separate", "hydra")
STAGES = (0, 3)
JOIN_S = 240
RTOL, ATOL = 1e-4, 1e-6
TOL_JAX = 1e-4


def _cfg(get=get_config):
    return dataclasses.replace(get("llama3_2_3b").smoke(), **SMOKE)


def _rl(engine, **kw):
    return RLHFConfig(**{**dict(prompt_len=P, gen_len=G, lr=1e-3,
                                critic_lr=1e-3, kl_coef=0.0, top_k=0,
                                temperature=0.0, engine=engine, lora_rank=8),
                         **kw})


def _prompts(n=B, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 64, (n, P))).long()


def _run(engine, shard, *, steps=2, telemetry=None, params=None,
         engine_obj=None, **rl_kw):
    cfg = _cfg()
    kw = {}
    if params is not None:
        kw["params"] = params
    if engine_obj is not None:
        kw["engine"] = engine_obj
    gen = None if kw else torch.Generator().manual_seed(0)
    tr = RLHFTrainer(cfg, cfg, _rl(engine, **rl_kw), gen,
                     reward_fn=make_target_token_reward(7), shard=shard,
                     telemetry=telemetry, **kw)
    ms = [tr.train_step(_prompts(), torch.Generator().manual_seed(10 + s))
          for s in range(steps)]
    return tr, ms


def _create(ndp, stage):
    return ShardedContext.create(ndp, zero_stage=stage, model=NTP,
                                 device="cpu", cfg=_cfg())


def _greedy(model, params, backend, mesh=None, group=1):
    ro = Rollout(model, _cfg(), capacity=P + G, temperature=0.0, top_k=0,
                 backend=backend, page_size=4, mesh=mesh)
    return ro.generate(params, {"tokens": _prompts()}, G,
                       torch.Generator().manual_seed(3),
                       group_size=group).tokens.numpy()


def _serve(model, params, backend, mesh=None):
    cb = ContinuousBatcher(model, _cfg(), params, slots=2, capacity=32,
                           temperature=0.0, cache_backend=backend,
                           page_size=8, mesh=mesh)
    for i, n in enumerate((6, 10, 7)):
        cb.submit(_prompts(3, seed=5)[i].numpy()[:n], 8)
    done = sorted(cb.run_until_drained(), key=lambda r: r.rid)
    if backend == "paged":
        return [r.out_tokens for r in done], cb.pm.bytes_per_token
    kv = sum(c[n].numel() * c[n].element_size()
             for c in cb.caches["layers"] for n in ("k", "v"))
    return [r.out_tokens for r in done], kv


def _mine(full, spec, tp):
    """This rank's cut of ``full`` under ``spec``'s model entry."""
    t = _model_dim(spec)
    if t is None:
        return full
    n = full.shape[t] // tp.size
    return full.narrow(t, tp.rank * n, n)


def _grad_pairs(specs, full_grads, tp_grads, tp):
    """(want, got) per leaf: the unsharded gradient's cut, the rank's (as
    numpy arrays: a tensor sent between processes needs its sender
    alive)."""
    return [(_mine(f, s, tp).numpy().copy(), g.numpy().copy())
            for s, f, g in zip(spec_leaves(specs), leaves(full_grads),
                               leaves(tp_grads))]


def _grad_batch():
    g = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, 64, (B, P + 4), generator=g)
    mask = torch.ones(B, P + 4)
    return {"tokens": tokens, "loss_mask": mask,
            "advantages": torch.randn(B, P + 4, generator=g),
            "old_logp": -torch.rand(B, P + 4, generator=g),
            "ref_logp": -torch.rand(B, P + 4, generator=g),
            "returns": torch.randn(B, P + 4, generator=g)}


def _adapter_grads(sc):
    """The hydra actor's (PPO loss) and critic's (value loss) adapter
    gradients, unsharded and on ``sc``, with nonzero ``b`` factors."""
    cfg = _cfg()
    out = {}
    engines = []
    for shard in (None, sc):
        eng = ModelEngine(cfg, torch.Generator().manual_seed(0), rank=8)
        g = torch.Generator().manual_seed(9)
        for role in ("actor", "critic"):
            for t in leaves(eng.adapters[role]["lora"]):
                if t.shape[0] == 8:            # a "b" factor [r, d_out]
                    t.copy_(0.02 * torch.randn(t.shape, generator=g))
        if shard is not None:
            eng.shard_with(shard)
        engines.append(eng)
    batch = _grad_batch()
    for role in ("actor", "critic"):
        grads = []
        for eng, tp in zip(engines, (None, sc.tp)):
            def loss(ad, b, eng=eng, role=role):
                if role == "actor":
                    return ppo_actor_loss(eng.logits(eng.base_params, ad, b),
                                          b)
                return critic_loss(eng.values(eng.base_params, ad, b), b)
            ad = eng.adapters[role]
            for t in leaves(ad):
                t.requires_grad_(True)
            with use_mesh(tp), torch.enable_grad():
                grads.append(_accumulated_grads(loss, ad, batch, 1)[1])
        out[role] = _grad_pairs(engines[1].adapter_plans[role].param_specs,
                                grads[0], grads[1], sc.tp)
    return out


def _separate_grads(sc):
    cfg = _cfg()
    model = Model(cfg, device="cpu")
    full = model.init(torch.Generator().manual_seed(0))
    plan = sc.plan_params(cfg, Model(cfg, device="meta").init())
    part = plan.place_params(full)
    batch = _grad_batch()
    grads = []
    for params, tp in ((full, None), (part, sc.tp)):
        for t in leaves(params):
            t.requires_grad_(True)
        with use_mesh(tp), torch.enable_grad():
            grads.append(_accumulated_grads(
                lambda p, b: ppo_actor_loss(model.forward(p, b)[0], b),
                params, batch, 1)[1])
    return _grad_pairs(plan.param_specs, grads[0], grads[1], sc.tp)


def _rank_jobs(ndp, jax_params):
    """What a rank of the (ndp, 2) group runs -> its results."""
    out = {}
    cfg = _cfg()
    base = {}
    for engine in ENGINES:
        tr1, m1 = _run(engine, None)
        base[engine] = tr1
        out[(engine, "base")] = {"metrics": m1,
                                 "state": tr1.per_device_state_bytes()}
        for stage in STAGES:
            sc = _create(ndp, stage)
            tel = RunTelemetry.create(sim_delta=False) \
                if engine == "hydra" and stage == 3 else None
            tr, ms = _run(engine, sc, telemetry=tel)
            out[(engine, stage)] = {"metrics": ms,
                                    "state": tr.per_device_state_bytes()}
            if tel is not None:
                sample = [r for r in tr.memory.records if r.get("sample")][-1]
                out["owners"] = (sample["attrib"].get("tp_gather", 0),
                                 sample["attrib"].get("zero_gather", 0),
                                 tel.registry.counter(
                                     "sharding_tp_staged_bytes_total").value())
            if stage == 3 and engine == "separate":
                p2, owned = tr.actor_plan.gather_copy(tr.actor_state["params"])
                p1 = tr1.actor_state["params"]
                out["rollout"] = {
                    (b, grp): (_greedy(tr1.actor, p1, b, group=grp),
                               _greedy(tr.actor, p2, b, sc, group=grp), owned)
                    for b, grp in (("dense", 1), ("paged", 1), ("paged", 2))}
            if stage == 3 and engine == "hydra":
                m1p = tr1.actor.merge_adapter(tr1.base_params,
                                              tr1.actor_state["params"])
                b2, _ = tr.engine.base_plan.gather_copy(tr.base_params)
                a2, _ = tr.engine.adapter_plans["actor"].gather_copy(
                    tr.actor_state["params"])
                m2p = tr.actor.merge_adapter(b2, a2)
                out["merged"] = {b: (_greedy(tr1.actor, m1p, b),
                                     _greedy(tr.actor, m2p, b, sc))
                                 for b in ("dense", "paged")}
            if stage == 0 and engine == "separate":
                p1, p2 = tr1.actor_state["params"], tr.actor_state["params"]
                out["batcher"] = {b: (_serve(tr1.actor, p1, b),
                                      _serve(tr.actor, p2, b, sc))
                                  for b in ("dense", "paged")}
                t = _prompts()
                sc.tp.reset_counts()
                with use_mesh(sc), torch.no_grad():
                    _action_logp(tr.actor.forward(p2, {"tokens": t})[0], t)
                out["counts"] = dict(sc.tp.counts)
    out["offload"] = _run("hydra", _create(ndp, 3), offload="all")[1]
    sc = _create(ndp, 0)
    out["adapter_grads"] = _adapter_grads(sc)
    out["separate_grads"] = _separate_grads(sc)
    grpo = []
    for shard in (None, _create(ndp, 3)):
        tr = GRPOTrainer(cfg, GRPOConfig(prompt_len=P, gen_len=G,
                                         group_size=2, temperature=0.0,
                                         rollout_backend="paged",
                                         page_size=4),
                         torch.Generator().manual_seed(0),
                         make_target_token_reward(7), shard=shard)
        grpo.append([tr.train_step(_prompts(2), torch.Generator())
                     for _ in range(2)])
    out["grpo"] = grpo
    params = torch.load(jax_params)
    sc = _create(ndp, 3)
    _, out["jax_separate"] = _run("separate", sc, params={
        "actor": params["actor"], "critic": params["critic"]})
    eng = ModelEngine(cfg, None, rank=8, base_params=params["base"],
                      adapters=params["adapters"])
    _, out["jax_hydra"] = _run("hydra", _create(ndp, 3), engine_obj=eng)
    return out


def _worker(rank, ndp, store, results, jax_params):
    torch.set_num_threads(1)
    world = ndp * NTP
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=60))
        out = _rank_jobs(ndp, jax_params)
        dist.destroy_process_group()
        results.put((ndp, rank, out, None))
    except BaseException as e:          # the parent fails the tests
        import traceback
        results.put((ndp, rank, None, f"{e!r}\n{traceback.format_exc()}"))


def _jax_reference(path):
    """The JAX trainers (separate and hydra, greedy, f32, the smoke config)
    from their own initial weights: their 2 metrics each, and those
    weights in the port's layout saved to ``path``."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.rlhf import RLHFConfig as JaxRLHFConfig
    from repro.rlhf import RLHFTrainer as JaxRLHFTrainer
    from repro.rlhf.reward import make_target_token_reward as jax_reward
    from repro_torch import bridge

    jcfg = _cfg(jax_get_config)
    cfg = _cfg()
    np_tree = lambda t: jax.tree.map(lambda x: np.asarray(x).copy(), t)  # noqa: E731
    trainers, saved = {}, {}
    for engine in ENGINES:
        rl = JaxRLHFConfig(prompt_len=P, gen_len=G, lr=1e-3, critic_lr=1e-3,
                           kl_coef=0.0, top_k=0, temperature=0.0,
                           engine=engine, lora_rank=8)
        tr = JaxRLHFTrainer(jcfg, jcfg, rl, jax.random.PRNGKey(0),
                            reward_fn=jax_reward(7))
        trainers[engine] = tr
        if engine == "separate":
            saved["actor"] = bridge.from_jax(
                np_tree(tr.actor_state["params"]), cfg, "cpu")
            saved["critic"] = bridge.from_jax(
                np_tree(tr.critic_state["params"]), cfg, "cpu")
        else:
            saved["base"] = bridge.from_jax(np_tree(tr.base_params), cfg,
                                            "cpu")
            saved["adapters"] = {
                role: bridge.adapter_from_jax(np_tree(ad), cfg, "cpu")
                for role, ad in tr.engine.adapters.items()}
    torch.save(saved, path)
    prompts = jnp.asarray(_prompts().numpy())
    return lambda: {e: [{k: float(v) for k, v in tr.train_step(
        prompts, jax.random.PRNGKey(s)).items()} for s in range(2)]
        for e, tr in trainers.items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """({ndp: [rank 0's results, ...]}, the JAX metrics by engine)."""
    tmp = tmp_path_factory.mktemp("tp")
    jax_params = str(tmp / "jax_params.pt")
    jax_steps = _jax_reference(jax_params)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(r, ndp, str(tmp / f"store{ndp}"),
                                               results, jax_params))
             for ndp in NDPS for r in range(ndp * NTP)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        jax_metrics = jax_steps()
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
    return ({ndp: [got[ndp, r] for r in range(ndp * NTP)] for ndp in NDPS},
            jax_metrics)


def _allclose(want, got, keys=("loss", "ppo_loss", "vf_loss", "kl",
                               "grad_norm", "mean_reward")):
    for a, b in zip(want, got):
        for k in keys:
            if k in a:
                assert abs(a[k] - b[k]) <= ATOL + RTOL * abs(a[k]), \
                    (k, a[k], b[k])


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("ndp", NDPS)
def test_ppo_losses_allclose_to_one_rank(ranks, ndp, engine, stage):
    """2-step PPO at (ndp, 2), ZeRO 0 and ZeRO-3 ``layer``: every rank's
    metrics allclose to ntp 1's (rtol 1e-4, atol 1e-6; the reference's
    ``tests/test_tp.py:72-93``)."""
    for out in ranks[0][ndp]:
        _allclose(out[(engine, "base")]["metrics"],
                  out[(engine, stage)]["metrics"])


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("ndp", NDPS)
def test_tp_matches_jax_trainer(ranks, ndp, engine):
    """(ndp, 2) at ZeRO-3 from the JAX trainer's initial weights, greedy:
    the JAX trainer's one-device metrics within 1e-4 (the reference's own
    TP contract, DESIGN.md §9.5, closed against it)."""
    want = ranks[1][engine]
    for out in ranks[0][ndp]:
        for a, b in zip(want, out[f"jax_{engine}"]):
            for k in ("loss", "ppo_loss", "kl", "vf_loss", "grad_norm",
                      "mean_reward"):
                assert b[k] == pytest.approx(a[k], abs=TOL_JAX), k


@pytest.mark.parametrize("run", ["dense-1", "paged-1", "paged-2"])
def test_rollout_tokens_equal_one_rank(ranks, run):
    """Greedy dense and paged (G = 1 and a 2-way fork) rollouts from a
    ZeRO-3 TP ``gather_copy`` under ``Rollout(mesh=)``: ntp 1's tokens."""
    backend, group = run.split("-")
    for ndp in NDPS:
        for out in ranks[0][ndp]:
            want, got, owned = out["rollout"][backend, int(group)]
            assert owned
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_hydra_merged_rollout_equals_one_rank(ranks, backend):
    """The merge of a TP base and adapter cut (``rules.adapter_pspecs``)
    is shard-local exact: the merged rollout gives ntp 1's tokens."""
    for ndp in NDPS:
        for out in ranks[0][ndp]:
            want, got = out["merged"][backend]
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_batcher_tokens_equal_mesh_none(ranks, backend):
    """``ContinuousBatcher(mesh=)``, greedy, 3 requests over 2 slots: the
    tokens of ``mesh=None`` on the unsharded weights; its KV a rank (the
    dense caches' K and V, a paged token's bytes) is half."""
    for ndp in NDPS:
        for out in ranks[0][ndp]:
            (want, kv1), (got, kv2) = out["batcher"][backend]
            assert got == want
            assert kv2 * NTP == kv1


@pytest.mark.parametrize("engine", ENGINES)
def test_persistent_state_cut(ranks, engine):
    """Per rank, the persistent state falls from TP alone (at most 0.60 of
    ntp 1's on the separate engine, the reference's bar) and again from
    ZeRO-3 over data beside it."""
    for out in ranks[0][2]:
        base = out[(engine, "base")]["state"]
        z0, z3 = out[(engine, 0)]["state"], out[(engine, 3)]["state"]
        assert z3 < z0 < base
        if engine == "separate":
            assert z0 <= 0.60 * base, z0 / base


def test_all_reduce_count_of_a_forward(ranks):
    """A scoring forward and its log-probs: 2 all-reduces a layer, one at
    the vocab-parallel embedding, 2 for the vocab-parallel log-probs (the
    MAX of the row max, the SUM of the exp-sum and the target's logit);
    nothing gathered, no backward all-reduce."""
    L = _cfg().num_layers
    for ndp in NDPS:
        for out in ranks[0][ndp]:
            assert out["counts"] == {"row": 2 * L, "embed": 1, "logits": 2,
                                     "lora": 0, "grad": 0, "gather": 0}


@pytest.mark.parametrize("role", ["actor", "critic"])
def test_adapter_gradients_are_the_unsharded_cut(ranks, role):
    """The hydra adapters' gradients (nonzero ``b``): a column site's ``a``
    (whole, its gradient all-reduced) and a row site's ``b`` (whole, after
    the reduced rank-r product) are the unsharded ones; the cut factors
    are the unsharded gradients' cut."""
    for ndp in NDPS:
        for out in ranks[0][ndp]:
            pairs = out["adapter_grads"][role]
            assert any(np.abs(w).max() > 0 for w, _ in pairs)
            for want, got in pairs:
                np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_separate_gradients_are_the_unsharded_cut(ranks):
    for ndp in NDPS:
        for out in ranks[0][ndp]:
            for want, got in out["separate_grads"]:
                np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_tp_gather_owner(ranks):
    """Under TP the rollout's ZeRO-3 gather copies are ``tp_gather``'s
    (DP-gathered, still cut), ``zero_gather`` stays empty; on the CPU the
    gloo collectives stage nothing."""
    for out in ranks[0][2]:
        tp_bytes, zero_bytes, staged = out["owners"]
        assert tp_bytes > 0 and zero_bytes == 0 and staged == 0


def test_offload_all_composes_with_tp(ranks):
    """Hydra at (ndp, 2), ZeRO-3, offload "all" (each rank parks and
    fetches its cuts): ntp 1's metrics, allclose."""
    for ndp in NDPS:
        for out in ranks[0][ndp]:
            _allclose(out[("hydra", "base")]["metrics"], out["offload"])


def test_grpo_steps_allclose(ranks):
    for ndp in NDPS:
        for out in ranks[0][ndp]:
            want, got = out["grpo"]
            _allclose(want, got)


# ---------------------------------------------------------------- refusals
def _spec_ctx():
    return ShardedContext(SpecMesh({"data": 1, "model": NTP}),
                          ShardingStrategy(zero_stage=0, ntp=NTP))


def test_bad_kv_heads_refused_before_any_group():
    cfg = dataclasses.replace(_cfg(), num_kv_heads=1)
    with pytest.raises(NotImplementedError, match="head_dim.*A10c"):
        ShardedContext.create(1, model=NTP, device="cpu", cfg=cfg)
    with pytest.raises(ValueError, match="num_heads"):
        ShardedContext.create(1, model=3, device="cpu", cfg=_cfg())


def test_mamba_mtp_and_spec_decode_refused():
    mamba = get_config("mamba2_370m").smoke()
    with pytest.raises(NotImplementedError, match="Mamba.*A10c"):
        Rollout(Model(mamba, device="cpu"), mamba, capacity=16,
                mesh=_spec_ctx())
    with pytest.raises(NotImplementedError, match="Mamba.*A10c"):
        ContinuousBatcher(Model(mamba, device="cpu"), mamba, {},
                          mesh=SpecMesh({"data": 1, "model": NTP}))
    mtp = dataclasses.replace(_cfg(), mtp_depth=1)
    with pytest.raises(NotImplementedError, match="MTP.*A10c"):
        RLHFTrainer(mtp, mtp, _rl("hydra"), torch.Generator(),
                    shard=_spec_ctx())
    with pytest.raises(NotImplementedError, match="speculative.*A10c"):
        RLHFTrainer(_cfg(), _cfg(), _rl("separate", spec_decode=True),
                    torch.Generator(), shard=_spec_ctx())


def test_graph_under_tp_mesh_raises():
    """A captured decode step under a TP mesh is refused, never dropped to
    eager behind the caller's back; the default runs eagerly."""
    cfg = _cfg()
    model = Model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="graph.*A10c"):
        Rollout(model, cfg, capacity=16, mesh=_spec_ctx(), graphs=True)
    with pytest.raises(NotImplementedError, match="graph.*A10c"):
        ContinuousBatcher(model, cfg, {}, mesh=_spec_ctx(), graphs=True)
    with pytest.raises(ValueError, match="SpecMesh"):
        Rollout(model, cfg, capacity=16, mesh=_spec_ctx())


class _Comm:
    """A model group of 2 that is never asked for a collective."""
    size, rank = 2, 0


@pytest.mark.parametrize("tp", [False, True])
def test_decode_graphs_asked_only_without_tp(monkeypatch, tp):
    """The rollout's and the batcher's decode step ask for a capture by
    default, and run eagerly under a TP group (never a capture: a gloo
    collective cannot be captured); the batcher's KV then holds K/2 heads
    a rank. ``DecodeGraph`` is stood in for to read what was asked."""
    from repro_torch.serving import scheduler
    asked = []

    class Recorder:
        def __init__(self, body, batch, device, **kw):
            asked.append(kw["capture"])
            self.stats = {"graphed": False}

    monkeypatch.setattr(scheduler, "DecodeGraph", Recorder)
    cfg = _cfg()
    model = Model(cfg, device="cpu")
    mesh = TensorParallel(_Comm()) if tp else None
    assert Rollout(model, cfg, capacity=16, mesh=mesh)._capture() is not tp
    cb = ContinuousBatcher(model, cfg, {"embed": torch.zeros(1)}, slots=2,
                           capacity=16, mesh=mesh)
    cb._graph(2)
    assert asked == [not tp]
    assert cb.caches["layers"][0]["k"].shape[2] == \
        cfg.num_kv_heads // (2 if tp else 1)
