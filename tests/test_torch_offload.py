"""The port's host offload (``repro_torch.offload``) against the JAX
reference on the CPU: the touch maps and managed states, the compiled
plan, the parking lot's round trips and event stream, the executor's
aliases, the trainer at every level on both engines (exactly the
``offload="none"`` metrics; the reference trainer's lot events and, at
``all``, its metrics), and ``remat`` "offload" and "dots".

Small f32 configs (two layers, d_model 32); bf16 where bits must round
trip. Tolerances: exact where offload only moves bytes (the same values
go through the same code); 1e-4 against the JAX trainer, as
``tests/test_torch_train.py``; 1e-5 for remat gradients against the JAX
model, as ``tests/test_offload.py:228``.
"""
import dataclasses
import pathlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import steps as JS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import OFFLOAD_LEVELS as JAX_LEVELS  # noqa: E402
from repro.core import offload_managed_states as jax_managed  # noqa: E402
from repro.core import phase_state_touches as jax_touches  # noqa: E402
from repro.core import runtime_state_touches as jax_runtime  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import lora as JLORA  # noqa: E402
from repro.offload import OffloadPlan as JaxPlan  # noqa: E402
from repro.offload import tree_nbytes as jax_tree_nbytes  # noqa: E402
from repro.rlhf import RLHFConfig as JaxRLHFConfig  # noqa: E402
from repro.rlhf import RLHFTrainer as JaxRLHFTrainer  # noqa: E402
from repro.rlhf.engine import ModelEngine as JaxModelEngine  # noqa: E402
from repro.rlhf.reward import \
    make_target_token_reward as jax_target_reward  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import steps as TS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (OFFLOAD_LEVELS, offload_managed_states,  # noqa: E402
                              phase_state_touches, runtime_state_touches)
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import lora as TLORA  # noqa: E402
from repro_torch.offload import (RUNTIME_PHASE_SEQUENCE,  # noqa: E402
                                 HostParkingLot, OffloadExecutor,
                                 OffloadPlan, tree_nbytes)
from repro_torch.rlhf import (MEMORY_POLICIES, ModelEngine,  # noqa: E402
                              RLHFConfig, RLHFTrainer)
from repro_torch.rlhf.reward import make_target_token_reward  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

TOL = 1e-4
REMAT_TOL = 1e-5
ENGINES = ("hydra", "separate")
LEVELS = ("optimizer", "roles", "all")
MICRO = dict(num_layers=2, d_model=32, d_ff=64, vocab_size=32, num_heads=2,
             num_kv_heads=1, head_dim=16)
RL_KW = dict(prompt_len=4, gen_len=4, lr=1e-3, critic_lr=1e-3, kl_coef=0.1,
             temperature=0.0, top_k=0, lora_rank=2)


def micro_cfgs(**kw):
    """The reference's ``tests/test_offload.py::micro_cfg`` in both
    packages."""
    kw = {**MICRO, **kw}
    return (dataclasses.replace(jax_get_config("llama3_2_3b").smoke(), **kw),
            dataclasses.replace(get_config("llama3_2_3b").smoke(), **kw))


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x).copy(), tree)


def _bits(t):
    return t.detach().contiguous().view(torch.uint8)


def _reward(engine):
    """Hydra scores with a programmatic reward (its reward adapter is
    parked once, never fetched); separate with the reward model (parked
    and fetched every iteration)."""
    return engine == "hydra"


def _port_trainer(engine, level="none", cfg=None, **kw):
    cfg = cfg or micro_cfgs()[1]
    rl = RLHFConfig(engine=engine, offload=level, **{**RL_KW, **kw})
    return RLHFTrainer(cfg, cfg, rl, torch.Generator().manual_seed(0),
                       reward_fn=make_target_token_reward(7)
                       if _reward(engine) else None)


def _prompts(seed=1):
    return torch.randint(0, MICRO["vocab_size"], (2, RL_KW["prompt_len"]),
                         generator=torch.Generator().manual_seed(seed))


# ------------------------------------------------- touch maps and the plan
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("level", OFFLOAD_LEVELS)
def test_touch_maps_and_managed_states_match_reference(engine, level):
    assert OFFLOAD_LEVELS == JAX_LEVELS
    assert phase_state_touches(engine) == jax_touches(engine)
    assert runtime_state_touches(engine) == jax_runtime(engine)
    names = set(jax_touches(engine)) | {"base_params", "ref_params", "x"}
    assert offload_managed_states(level, names) == jax_managed(level, names)


@pytest.mark.parametrize("frozen_unused", [(), ("reward_params",)],
                         ids=["all_used", "reward_unused"])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("level", OFFLOAD_LEVELS)
def test_plan_matches_reference(level, engine, frozen_unused):
    """``managed``, ``required``, ``resident_for``, ``evict_before`` and
    ``next_phase`` for every phase, over the trainer's state names."""
    states = tuple(runtime_state_touches(engine))
    got = OffloadPlan.compile(level, engine=engine, states=states,
                              frozen_unused=frozen_unused)
    want = JaxPlan.compile(level, engine=engine, states=states,
                           frozen_unused=frozen_unused)
    assert got.sequence == want.sequence == RUNTIME_PHASE_SEQUENCE
    assert got.managed == want.managed
    assert dict(got.required) == dict(want.required)
    for ph in RUNTIME_PHASE_SEQUENCE:
        assert got.resident_for(ph) == want.resident_for(ph)
        assert got.evict_before(ph) == want.evict_before(ph)
        assert got.next_phase(ph) == want.next_phase(ph)


def test_plan_and_executor_refuse_what_they_cannot_do():
    with pytest.raises(ValueError):
        OffloadPlan.compile("everything")
    plan = OffloadPlan.compile("roles", engine="separate")
    lot = HostParkingLot("cpu")
    with pytest.raises(ValueError):            # a managed state unbound
        OffloadExecutor(plan, lot, {})
    with pytest.raises(NotImplementedError):   # telemetry is not ported
        OffloadExecutor(OffloadPlan.compile("none"), lot, {},
                        telemetry=object())
    tcfg = micro_cfgs()[1]
    with pytest.raises(ValueError):
        RLHFTrainer(tcfg, tcfg,
                    RLHFConfig(engine="hydra", offload="bogus", **RL_KW),
                    torch.Generator())


# ---------------------------------------------------------------- the lot
def _role_trees(engine):
    """Every persistent tree of a bf16 trainer of ``engine``, with its
    AdamW states' Python-int counts."""
    cfg = micro_cfgs(param_dtype="bfloat16")[1]
    return _port_trainer(engine, cfg=cfg).persistent_trees()


@pytest.mark.parametrize("engine", ENGINES)
def test_lot_round_trips_every_role_tree_bit_for_bit(engine):
    trees = _role_trees(engine)
    assert any(t.dtype == torch.bfloat16 for t in leaves(trees))
    lot = HostParkingLot("cpu")
    originals = {k: [(_bits(t).clone(), t.dtype, t.requires_grad)
                     for t in leaves(v)] for k, v in trees.items()}
    for name, tree in trees.items():
        lot.park(name, tree)
        assert name in lot
    assert lot.names() == tuple(trees)
    assert lot.parked_bytes() == sum(tree_nbytes(v) for v in trees.values())
    for name in trees:
        got = lot.fetch(name)
        back = [(_bits(t), t.dtype, t.requires_grad) for t in leaves(got)]
        assert len(back) == len(originals[name])
        assert all(torch.equal(a, b) and da == db and ga == gb
                   for (a, da, ga), (b, db, gb) in zip(back, originals[name]))
        if name.endswith("_opt"):           # the step count passes through
            assert got["count"] == trees[name]["count"] == 0
    assert lot.parked_bytes() == 0 and lot.stats.n_fetch == len(trees)


def test_lot_prefetch_then_fetch_is_a_hit():
    lot = HostParkingLot("cpu")
    w = torch.arange(64, dtype=torch.float32)
    lot.park("x", {"w": w})
    lot.prefetch("x")
    assert "x" in lot                        # prefetch does not remove
    assert torch.equal(lot.fetch("x")["w"], w)
    assert [op for op, n in lot.events if n == "x"] == \
        ["park", "prefetch", "fetch_hit"]
    assert lot.stats.n_prefetch_hits == 1
    lot.park("y", {"w": torch.ones(4)})
    lot.fetch("y")                           # cold: a plain fetch
    assert ("fetch", "y") in lot.events


def test_lot_nonblocking_park_and_drain():
    lot = HostParkingLot("cpu")
    src = torch.arange(128, dtype=torch.int32)
    lot.park("x", {"w": src}, block=False)
    assert lot._entries["x"].sources == [src]   # kept until drained
    lot.drain()
    assert lot._entries["x"].sources is None
    assert torch.equal(lot.fetch("x")["w"], src)


def test_lot_adopt_and_discard():
    lot = HostParkingLot("cpu")
    lot.adopt("x", {"w": torch.arange(8, dtype=torch.float32)})
    assert lot.parked_bytes() == 32 and ("park", "x") in lot.events
    lot.discard("x")
    assert "x" not in lot and lot.parked_bytes() == 0
    lot.park("y", {"w": torch.ones(2)})
    with pytest.raises(KeyError):
        lot.park("y", {"w": torch.ones(2)})


@pytest.mark.parametrize("engine", ENGINES)
def test_executor_repoints_every_alias(engine):
    """At ``all``: while a tree is parked every alias the trainer holds
    is its host view; once fetched, every alias is the fetched tree; and
    ``adopt_parked`` installs a host tree whose leaves train again."""
    tr = _port_trainer(engine, "all")
    lot = tr.offload_lot
    parked = {id(t) for n in lot.names() for t in leaves(lot.peek(n))}
    if engine == "hydra":
        assert tr.base_params is tr.engine.base_params is tr.ref_params
        assert tr.engine.adapters["actor"] is tr.actor_state["params"]
        assert tr.engine.adapters["critic"] is tr.critic_state["params"]
        assert tr.engine.adapters["reward"] is tr.reward_adapter
        assert all(id(t) in parked for t in leaves(tr.reward_adapter))
    else:
        assert all(id(t) in parked for t in leaves(tr.ref_params))
    assert all(id(t) in parked for t in leaves(tr.critic_state))
    tr.train_step(_prompts(), torch.Generator().manual_seed(0))
    if engine == "hydra":
        assert tr.base_params is tr.engine.base_params is tr.ref_params
        assert tr.engine.adapters["critic"] is tr.critic_state["params"]
        assert tr.engine.adapters["reward"] is tr.reward_adapter
        sites = tr.engine.lora_sites()
        # the trunk's adapted leaves came back; the rest never moved
        assert all(id(t) not in parked for t in
                   leaves(TLORA.adapted_subtree(tr.base_params, sites)))
    restored = tree_map(lambda t: t.detach().clone(),
                        tr.critic_state["params"])
    tr.offload.adopt_parked("critic_params", restored)
    assert tr.critic_state["params"] is not restored
    fetched = lot.fetch("critic_params")
    assert all(t.requires_grad and torch.equal(t, h) for t, h in
               zip(leaves(fetched), leaves(restored)))


def test_adapted_subtree_is_the_merged_sites_and_matches_reference():
    """The trunk's adapted leaves are exactly those ``merge_adapter``
    replaces, with the reference's bytes; ``with_adapted_leaves`` puts a
    replacement back and leaves every other leaf by reference."""
    jcfg, tcfg = micro_cfgs()
    jeng = JaxModelEngine(jcfg, jax.random.PRNGKey(0), rank=2)
    eng = ModelEngine(tcfg, None, rank=2,
                      base_params=bridge.from_jax(_np(jeng.base_params),
                                                  tcfg, "cpu"),
                      adapters={r: bridge.adapter_from_jax(_np(a), tcfg,
                                                           "cpu")
                                for r, a in jeng.adapters.items()})
    sites = eng.lora_sites()
    sub = TLORA.adapted_subtree(eng.base_params, sites)
    merged = TLORA.merge_adapter(eng.base_params, eng.adapters["actor"]["lora"])
    assert len(list(leaves(sub))) == \
        len(TLORA.merged_leaves(merged, eng.adapters["actor"]["lora"]))
    jsites = jax.tree.map(lambda _: True, jeng.adapters["actor"]["lora"])
    assert tree_nbytes(sub) == jax_tree_nbytes(
        JLORA.adapted_subtree(jeng.base_params, jsites))
    new_sub = TLORA.adapted_subtree(
        {"layers": [{k: ({n: t.clone() for n, t in v.items()}
                         if isinstance(v, dict) else v)
                     for k, v in layer.items()}
                    for layer in eng.base_params["layers"]]}, sites)
    rebuilt = TLORA.with_adapted_leaves(eng.base_params, sites, new_sub)
    fresh = {id(t) for t in leaves(new_sub)}
    for a, b in zip(leaves(rebuilt), leaves(eng.base_params)):
        assert torch.equal(a, b)
        assert (a is b) != (id(a) in fresh)


# ------------------------------------------------------------ the trainer
def _run_jax(engine, level):
    """The reference trainer at ``level``: its initial weights, its lot's
    events after one iteration, and at ``all`` the metrics of two."""
    jcfg = micro_cfgs()[0]
    tr = JaxRLHFTrainer(jcfg, jcfg, JaxRLHFConfig(engine=engine,
                                                  offload=level, **RL_KW),
                        jax.random.PRNGKey(0),
                        reward_fn=jax_target_reward(7) if _reward(engine)
                        else None)
    init = (_np(tr.base_params), _np(tr.engine.adapters)) \
        if engine == "hydra" else (_np(tr.actor_state["params"]),
                                   _np(tr.critic_state["params"]))
    prompts = np.asarray(_prompts())
    out = {"init": init, "prompts": prompts, "metrics": []}
    for s in range(2 if level == "all" else 1):
        m = tr.train_step(jnp.asarray(prompts), jax.random.PRNGKey(s))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if s == 0:
            out["events"] = list(tr.offload_lot.events)
    return out


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX trainer once per engine and level, for the module."""
    return {(e, lv): _run_jax(e, lv) for e in ENGINES for lv in LEVELS}


def _port_from(run, engine, level):
    tcfg = micro_cfgs()[1]
    rl = RLHFConfig(engine=engine, offload=level, **RL_KW)
    reward_fn = make_target_token_reward(7) if _reward(engine) else None
    a, b = run["init"]
    if engine == "hydra":
        return bridge.trainer_from_jax(a, b, tcfg, rl, reward_fn=reward_fn,
                                       device="cpu")
    return bridge.separate_trainer_from_jax(a, b, tcfg, tcfg, rl,
                                            reward_fn=reward_fn, device="cpu")


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("level", LEVELS)
def test_lot_events_match_jax_trainer(jax_runs, engine, level):
    """The initial placement and one iteration's parks, prefetches and
    fetches, in the reference's order."""
    run = jax_runs[engine, level]
    tr = _port_from(run, engine, level)
    tr.train_step(torch.from_numpy(run["prompts"].copy()).long(),
                  torch.Generator().manual_seed(0))
    assert tr.offload_lot.events == run["events"]


@pytest.mark.parametrize("engine", ENGINES)
def test_two_steps_at_all_match_jax_trainer(jax_runs, engine):
    run = jax_runs[engine, "all"]
    tr = _port_from(run, engine, "all")
    prompts = torch.from_numpy(run["prompts"].copy()).long()
    for s, want in enumerate(run["metrics"]):
        m = tr.train_step(prompts, torch.Generator().manual_seed(s))
        for k in ("loss", "ppo_loss", "kl", "vf_loss", "grad_norm",
                  "mean_reward"):
            np.testing.assert_allclose(m[k], want[k], atol=TOL, rtol=0)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("level", LEVELS)
def test_two_steps_equal_offload_none_exactly(engine, level):
    """Offload is a pure placement change: the same metrics to the bit,
    and every trained leaf the same bits, as ``offload="none"``."""
    got = {}
    for lv in ("none", level):
        tr = _port_trainer(engine, lv, memory_policy="none")
        ms = [tr.train_step(_prompts(), torch.Generator().manual_seed(s))
              for s in range(2)]
        if tr.offload is not None:
            for n in list(tr.offload_lot.names()):   # everything home
                tr.offload.states[n][1](tr.offload_lot.fetch(n))
        got[lv] = ms, [_bits(t) for t in leaves(tr.persistent_trees())]
    assert got[level][0] == got["none"][0]
    assert all(torch.equal(a, b) for a, b in zip(got[level][1],
                                                  got["none"][1]))


@pytest.mark.parametrize("level", OFFLOAD_LEVELS)
def test_offload_level_x_memory_policy_grid(level):
    """Every level runs under every memory policy (cycled on one trainer),
    with finite losses; beyond ``none`` state lands on host and every
    boundary fetch is a prefetch hit; the records carry the park and
    fetch seconds and bytes."""
    tr = _port_trainer("hydra", level, memory_policy=MEMORY_POLICIES[0])
    at_start = 0 if tr.offload is None else \
        tr.offload_lot.stats.bytes_parked_total
    for policy in MEMORY_POLICIES:
        tr.memory.policy = policy
        m = tr.train_step(_prompts(), torch.Generator().manual_seed(2))
        assert np.isfinite(m["loss"]) and np.isfinite(m["vf_loss"])
    recs = tr.memory.records
    assert len(recs) == 4 * 8
    host = [r["host_bytes"] for r in recs]
    bounds = [r for r in recs if not r.get("sample")]
    assert all(r["park_seconds"] >= 0 and r["fetch_seconds"] >= 0 and
               r["hygiene_seconds"] + r["park_seconds"] + r["fetch_seconds"]
               <= r["seconds"] for r in bounds)
    if level == "none":
        assert tr.offload is None and all(h == 0 for h in host)
        return
    assert min(host) > 0
    st = tr.offload_lot.stats
    assert st.n_prefetch_hits > 0 and st.n_fetch == st.n_prefetch_hits
    assert sum(r.get("park_bytes", 0) for r in recs) == \
        st.bytes_parked_total - at_start
    assert sum(r.get("fetch_bytes", 0) for r in recs) == \
        st.bytes_fetched_total


@pytest.mark.parametrize("engine", ENGINES)
def test_records_on_cpu_leave_parked_trees_out(engine):
    """On the CPU a record's live bytes count no parked tree: at ``all``
    each is lower than at ``none`` by at least the bytes parked there
    (rollout's sample by the trunk's adapted leaves as well)."""
    recs = {}
    for lv in ("none", "all"):
        tr = _port_trainer(engine, lv)
        tr.train_step(_prompts(), torch.Generator().manual_seed(0))
        recs[lv] = tr.memory.records
    for a, b in zip(recs["none"], recs["all"]):
        assert a["phase"] == b["phase"]
        assert b["host_bytes"] > 0
        assert a["live_bytes"] - b["live_bytes"] >= b["host_bytes"]


# -------------------------------------------------------------- remat
class _CountMM(TorchDispatchMode):
    """Counts the projections (``aten.mm``) dispatched while active."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


def _lm_grads(remat):
    """Loss, gradients (as a tree in the reference's layout) and the mm
    count of the backward: the reference's lm loss through the port's
    model, from the JAX model's initial weights."""
    jcfg, tcfg = micro_cfgs(remat=remat)
    jparams = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    params = bridge.from_jax(_np(jparams), tcfg, "cpu")
    for t in leaves(params):
        t.requires_grad_(True)
    tokens = np.random.default_rng(1).integers(0, 32, (2, 8))
    batch = {"tokens": torch.from_numpy(tokens), "loss_mask": torch.ones(2, 8)}
    logits, _ = Model(tcfg, device="cpu").forward(params, batch)
    loss = TS.lm_loss(logits, batch["tokens"], batch["loss_mask"])
    with _CountMM() as mm:
        grads = torch.autograd.grad(loss, list(leaves(params)))
    it = iter(grads)
    return loss, tree_map(lambda _: next(it), params), mm.n, jparams, tokens


@pytest.mark.parametrize("remat", ["offload", "dots"])
def test_remat_matches_full_and_reference(remat):
    """The same loss and gradients as ``remat="full"``, bit for bit (the
    same recompute from the same input), and as the JAX model's
    ``remat="offload"`` within 1e-5. "offload" recomputes the
    projections in the backward as "full" does (six of a layer's seven:
    the recompute stops at the last tensor the backward needs, w_out's
    input); "dots" recomputes none of them."""
    loss, grads, n_mm, jparams, tokens = _lm_grads(remat)
    loss_full, grads_full, n_full, _, _ = _lm_grads("full")
    assert torch.equal(loss, loss_full)
    assert all(torch.equal(a, b) for a, b in zip(leaves(grads),
                                                  leaves(grads_full)))
    assert n_full - n_mm == (6 * MICRO["num_layers"] if remat == "dots"
                             else 0)
    jcfg = micro_cfgs(remat="offload")[0]
    batch = {"tokens": jnp.asarray(tokens),
             "loss_mask": jnp.ones(tokens.shape, jnp.float32)}

    def loss_fn(p):
        logits, aux, _ = JaxModel(jcfg).forward(p, batch)
        return JS.lm_loss(logits, batch["tokens"], batch["loss_mask"]) + aux
    jloss, jgrads = jax.value_and_grad(loss_fn)(jparams)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               atol=REMAT_TOL)
    got = bridge.to_jax(tree_map(torch.Tensor.detach, grads), micro_cfgs()[1])
    assert jax.tree.structure(got) == jax.tree.structure(_np(jgrads))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32),
                                   atol=REMAT_TOL, rtol=0)


@pytest.mark.parametrize("remat", ["offload", "dots", "full"])
def test_remat_offload_moves_only_the_layer_inputs(monkeypatch, remat):
    """``"offload"`` sends exactly each layer's saved input, [B, S, D], to
    host, and nothing of the logits or the loss; the other remats send
    nothing."""
    packed = []

    class Spy(torch.autograd.graph.saved_tensors_hooks):
        def __init__(self, pin_memory=False):
            super().__init__(lambda t: packed.append(tuple(t.shape)) or t,
                             lambda t: t)

    monkeypatch.setattr(torch.autograd.graph, "save_on_cpu", Spy)
    _lm_grads(remat)
    assert packed == ([(2, 8, MICRO["d_model"])] * MICRO["num_layers"]
                      if remat == "offload" else [])


def test_example_runs_offload_and_remat_on_cpu(capsys):
    """``examples/torch_rlhf_e2e.py --smoke --device cpu --offload all
    --remat offload`` trains and reports host MiB and park/fetch ms."""
    import importlib.util
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "torch_rlhf_e2e", root / "examples" / "torch_rlhf_e2e.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    example.main(["--smoke", "--device", "cpu", "--steps", "1",
                  "--offload", "all", "--remat", "offload", "--layers", "1",
                  "--d-model", "64"])
    out = capsys.readouterr().out
    assert "offload=all" in out and "host" in out and "park" in out
