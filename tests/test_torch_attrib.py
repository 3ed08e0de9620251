"""The port's memory attribution and OOM flight recorder
(``repro_torch.obs``) on the CPU: the attributor's exactness and residue,
alias priority by storage, a ``None`` getter, top buffers and host
owners; the flight recorder's watermark and latch, calibration, ``is_oom``
on a ``torch.cuda.OutOfMemoryError`` built by hand, phase history and its
dump's schema against the reference recorder's; the attribution tables on
the phase spans of both engines at every offload level (exact, with the
simulator's per-owner deltas, losses bit-equal to a run without
telemetry); the watermark dump of a real PPO run; an OOM caught in
``train_step``; and per-program memory from a ``meta`` trace.

The watermark test is the reference's ``tests/test_attrib.py::
test_ppo_watermark_dump_names_owners``, which fails there when its whole
file runs in one process (its CPU calibration takes every live JAX array
of the process as the budget). Here the trainer's CPU records count only
its own tensors, so the test passes in any order; it runs last in this
file, after the other trainer runs, as the driver runs the file.
Micro config as ``tests/test_torch_obs.py`` (head_dim 64 for the
simulator's ``meta`` trace of the port's kernels).
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro.obs.flight import FlightRecorder as JaxFlightRecorder  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import RUNTIME_RLHF_PHASE_SEQUENCE  # noqa: E402
from repro_torch.obs import (FlightRecorder, MemoryAttributor,  # noqa: E402
                             MetricsRegistry, RunTelemetry,
                             record_compiled_memory)
from repro_torch.offload import HostParkingLot  # noqa: E402
from repro_torch.rlhf import RLHFConfig, RLHFTrainer  # noqa: E402
from repro_torch.rlhf.reward import make_target_token_reward  # noqa: E402
from repro_torch.tree import nbytes  # noqa: E402

MICRO = dict(num_layers=2, d_model=128, d_ff=64, vocab_size=32, num_heads=2,
             num_kv_heads=1, head_dim=64)
RL_KW = dict(prompt_len=4, gen_len=4, lr=1e-3, critic_lr=1e-3, kl_coef=0.0,
             top_k=0, lora_rank=2)
LEVELS = ("none", "optimizer", "roles", "all")
STATE = ("actor_params", "actor_opt", "critic_params", "critic_opt",
         "reward_params")


def run_ppo(engine, telemetry, steps=2, **rl_kw):
    cfg = dataclasses.replace(get_config("llama3_2_3b").smoke(), **MICRO)
    rl = RLHFConfig(engine=engine, **{**RL_KW, **rl_kw})
    tr = RLHFTrainer(cfg, cfg, rl, torch.Generator().manual_seed(0),
                     reward_fn=make_target_token_reward(7)
                     if engine == "hydra" else None, telemetry=telemetry)
    ms = [tr.train_step(
        torch.randint(0, MICRO["vocab_size"], (2, rl.prompt_len),
                      generator=torch.Generator().manual_seed(s)),
        torch.Generator().manual_seed(100 + s)) for s in range(steps)]
    return tr, ms


def _phase_spans(tel):
    return [sp for sp in tel.tracer.spans if sp.cat == "phase"]


# ------------------------------------------------------------- attributor
def test_attributor_exactness_and_residue():
    """sum(owners) + unattributed == total_bytes; the total is the tracked
    set's storages, an unregistered tensor lands in the residue."""
    a, b, c = torch.ones(64, 64), torch.ones(32, 32), torch.ones(16, 16)
    live = [a, b]
    at = MemoryAttributor(device="cpu", tracked=lambda: live)
    at.register("a", lambda: {"x": a})
    at.register("b", lambda: b)
    snap = at.snapshot()
    assert snap.owners == {"a": a.nbytes, "b": b.nbytes}
    assert snap.unattributed == 0 and snap.total_bytes == nbytes(live)
    live.append(c)
    snap2 = at.snapshot()
    assert snap2.unattributed == c.nbytes
    assert sum(snap2.owners.values()) + snap2.unattributed == \
        snap2.total_bytes == nbytes(live)
    assert snap2.walk_s > 0 and snap2.n_arrays == 3


def test_attributor_alias_first_registration_wins():
    """Identity is the storage: a view or an alias counts once, for the
    first owner registered."""
    shared = torch.ones(8, 8)
    at = MemoryAttributor(device="cpu")
    at.register("first", lambda: shared)
    at.register("second", lambda: {"alias": shared, "view": shared[2:]})
    snap = at.snapshot()
    assert snap.owners == {"first": shared.nbytes, "second": 0}
    assert sum(snap.owners.values()) + snap.unattributed == snap.total_bytes
    # a view registered first charges its whole storage
    at2 = MemoryAttributor(device="cpu")
    at2.register("view", lambda: shared[::2])
    assert at2.snapshot().owners["view"] == shared.nbytes


def test_attributor_none_getter_and_top_buffers():
    big, small = torch.ones(128, 128), torch.ones(4)
    at = MemoryAttributor(top_k=3, device="cpu",
                          tracked=lambda: [big, small, torch.ones(2)])
    at.register("gone", lambda: None)          # owner holds nothing now
    at.register("broken", lambda: 1 / 0)       # a failing getter: nothing
    at.register("big", lambda: {"w": [big]})
    assert at.snapshot().top_buffers == []      # the per-record walk
    snap = at.snapshot(full=True)
    assert snap.owners["gone"] == snap.owners["broken"] == 0
    assert len(snap.top_buffers) == 3           # capped at top_k
    tb = snap.top_buffers[0]
    assert tb == {"nbytes": big.nbytes, "shape": "(128, 128)",
                  "dtype": "float32", "owner": "big", "path": "['w'][0]"}
    assert snap.top_buffers[1]["owner"] == "(unattributed)"
    assert snap.ranked() == ["big"]
    assert snap.table() == {"big": big.nbytes}
    rec = snap.to_record()
    assert rec["owners"] == {"big": big.nbytes}
    json.dumps(rec)                             # metadata only


def test_attributor_host_owners_are_the_parked_trees():
    """A parked tree counts under ``host_owners`` by its lot name and
    never in the device total, though its getter returns the host view."""
    lot = HostParkingLot("cpu")
    state = {"opt": {"mu": torch.ones(32, 32)}, "w": torch.ones(16)}
    lot.park("opt", state["opt"])
    state["opt"] = lot.peek("opt")
    at = MemoryAttributor(device="cpu", lot=lot, tracked=lambda: state)
    at.register("opt", lambda: state["opt"])
    at.register("w", lambda: state["w"])
    snap = at.snapshot()
    assert snap.host_owners == {"opt": 32 * 32 * 4}
    assert snap.owners == {"opt": 0, "w": 64}
    assert snap.total_bytes == 64 and snap.unattributed == 0


def test_attributor_device_is_bound_or_raises():
    """With no device and no card, the first snapshot raises (the port's
    default device is CUDA); a trainer binds its own device."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError):
        MemoryAttributor().snapshot()


# --------------------------------------------------------- flight recorder
def test_flight_watermark_trigger_and_latch(tmp_path):
    path = str(tmp_path / "dump.json")
    fl = FlightRecorder(watermark=0.5, capacity_bytes=1000, ring=4,
                        path=path)
    for i in range(10):
        fl.note("tick", i=i)
    assert len(fl.ring) == 4
    assert fl.check(100) is None
    x = torch.ones(4, 4)
    at = MemoryAttributor(device="cpu")
    at.register("x", lambda: x)
    dump = fl.check(600, snapshot_fn=lambda: at.snapshot(full=True),
                    phase="p", source="t")
    assert dump is not None and dump["trigger"] == "watermark"
    assert dump["schema"] == "flight-recorder/v1"
    assert dump["live_bytes"] == 600 and dump["capacity_bytes"] == 1000
    assert dump["owners"] == {"x": x.nbytes}
    assert dump["owners_ranked"] == ["x"]
    assert dump["top_buffers"][0]["owner"] == "x"
    assert len(dump["ring"]) == 4
    assert fl.check(999) is None and len(fl.dumps) == 1
    assert json.load(open(path))["trigger"] == "watermark"
    fl.record_oom(torch.cuda.OutOfMemoryError("x"))
    assert json.load(open(path + ".1"))["trigger"] == "resource_exhausted"


def test_flight_dump_schema_matches_reference():
    """The same keys, trigger names, ring and phase history as the
    reference recorder's dump on the same events."""
    dumps = []
    for rec in (FlightRecorder(watermark=0.5, capacity_bytes=1000),
                JaxFlightRecorder(watermark=0.5, capacity_bytes=1000)):
        rec.note("phase", phase="rollout", live_bytes=10, host_bytes=5)
        rec.note("offload", op="park:rollout", parked_bytes=3)
        dumps.append(rec.check(700, phase="rollout", source="rlhf"))
    got, want = dumps
    assert set(got) == set(want)
    for k in ("schema", "trigger", "phase", "source", "live_bytes",
              "capacity_bytes", "watermark", "phase_history"):
        assert got[k] == want[k], k
    assert [{k: v for k, v in r.items() if k != "t"} for r in got["ring"]] \
        == [{k: v for k, v in r.items() if k != "t"} for r in want["ring"]]


def test_flight_calibration_fallback():
    """On the CPU (no card, no explicit capacity) the first check latches
    the budget and cannot itself breach; the next check crossing
    watermark * budget trips."""
    fl = FlightRecorder(watermark=0.5, ring=8, device="cpu")
    assert fl.capacity_bytes is None
    assert fl.check(1000) is None
    assert fl.capacity_bytes == 1000
    assert fl.check(400) is None
    assert fl.check(600) is not None


def test_flight_is_oom_and_record_oom():
    fl = FlightRecorder(capacity_bytes=1 << 30)
    msg = "CUDA out of memory. Tried to allocate 2.50 GiB."
    exc = torch.cuda.OutOfMemoryError(msg)
    assert fl.is_oom(exc)
    assert not fl.is_oom(RuntimeError(msg))     # by type, not by text
    assert not fl.is_oom(ValueError("shape mismatch"))
    dump = fl.record_oom(exc, live_bytes=123, phase="train_actor",
                         source="rlhf")
    assert dump["trigger"] == "resource_exhausted"
    assert dump["error"] == f"OutOfMemoryError: {msg}"
    assert dump["phase"] == "train_actor" and dump["live_bytes"] == 123
    assert fl.record_oom(exc) is None            # latched per kind
    assert fl.check(1 << 30) is not None         # watermark latch apart


def test_flight_phase_history():
    fl = FlightRecorder(capacity_bytes=1 << 30)
    fl.note("phase", phase="rollout", live_bytes=10, host_bytes=5)
    fl.note("sample", phase="x", live_bytes=99)
    fl.note("phase", phase="train_actor", live_bytes=20, host_bytes=0)
    assert [p["phase"] for p in fl.phase_history] == \
        ["rollout", "train_actor"]


# ------------------------------------------------- trainer integration
@pytest.mark.parametrize("engine", ["hydra", "separate"])
@pytest.mark.parametrize("level", LEVELS)
def test_ppo_spans_carry_exact_attribution(engine, level):
    """Every record and span: the owner table and the residue sum to the
    measured bytes, the state owners hold their trees' bytes where they
    are on the device, and the parked trees are host owners; every phase
    span carries the simulator's bytes and delta, with per-owner deltas
    over the simulator's state groups; the offload spans are there; the
    metrics equal a run without telemetry to the bit."""
    tel = RunTelemetry.create(engine=engine)
    tr, ms = run_ppo(engine, tel, offload=level)
    _, plain = run_ppo(engine, None, offload=level)
    assert ms == plain
    spans = _phase_spans(tel)
    assert [s.name for s in spans] == list(RUNTIME_RLHF_PHASE_SEQUENCE) * 2
    for sp in spans:
        a = sp.args
        assert sum(a["attrib"].values()) + a["attrib_unattributed"] \
            == a["measured_bytes"], sp.name
        assert a["sim_delta_bytes"] == a["measured_bytes"] - a["sim_bytes"]
        assert a["sim_peak_bytes"] >= a["sim_bytes"] >= 0
    for rec in tr.memory.records:
        assert sum(rec["attrib"].values()) + rec["attrib_unattributed"] \
            == rec["live_bytes"]
    deltas = [sp.args["attrib_sim_delta"] for sp in spans
              if "attrib_sim_delta" in sp.args]
    assert deltas
    groups = set().union(*deltas)
    assert groups <= set(STATE) | {"base_params", "ref_params",
                                   "merged_rollout"}
    # at the last boundary the state alone is live: each owner on the
    # device holds its tree's bytes, each parked one is a host owner
    last = tr.memory.records[-1]
    parked = ()
    if tr.offload is not None:      # the record comes before the fetch
        plan = tr.offload.plan
        parked = plan.managed - (plan.resident_for("train_critic")
                                 & plan.resident_for("rollout"))
    trees = tr.persistent_trees()
    for name in STATE:
        if name in parked:
            assert name not in last["attrib"]
        elif nbytes(trees[name]):
            assert last["attrib"][name] == nbytes(trees[name]), name
    assert last["host_bytes"] == sum(nbytes(trees[n]) for n in parked)
    off = [s.name for s in tel.tracer.spans if s.cat == "offload"]
    if level == "none":
        assert not off
    else:
        assert any(n.startswith("park:") for n in off)
        assert any(n.startswith("fetch:") for n in off)
    assert tel.registry.get("rlhf_owner_live_bytes") is not None


def test_oom_in_train_step_is_recorded_and_reraised():
    """A ``torch.cuda.OutOfMemoryError`` raised inside the actor's update
    is dumped with the owner table and the phase in progress, then
    re-raised unchanged; any other error is not dumped."""
    fl = FlightRecorder(watermark=2.0, capacity_bytes=1 << 40)
    tel = RunTelemetry.create(sim_delta=False, flight=fl)
    tr, _ = run_ppo("hydra", tel, steps=1)
    err = torch.cuda.OutOfMemoryError("CUDA out of memory. (made by hand)")

    def boom(exp):
        raise err
    tr._actor_update = boom
    prompts = torch.zeros(2, RL_KW["prompt_len"], dtype=torch.long)
    with pytest.raises(torch.cuda.OutOfMemoryError) as got:
        tr.train_step(prompts, torch.Generator().manual_seed(0))
    assert got.value is err
    (dump,) = fl.dumps
    assert dump["trigger"] == "resource_exhausted" and dump["source"] == "rlhf"
    assert dump["phase"] == "train_actor"
    assert dump["error"] == f"OutOfMemoryError: {err}"
    assert dump["owners"]["base_params"] > 0 and dump["top_buffers"]
    assert dump["live_bytes"] == tr.memory.live_bytes() > 0
    tr._actor_update = lambda exp: 1 / 0
    with pytest.raises(ZeroDivisionError):
        tr.train_step(prompts, torch.Generator().manual_seed(0))
    assert len(fl.dumps) == 1


def test_telemetry_is_pure_observer():
    """Attribution + flight recorder leave the training math alone."""
    tel = RunTelemetry.create(engine="hydra",
                              flight=FlightRecorder(watermark=0.9,
                                                    device="cpu"))
    _, with_obs = run_ppo("hydra", tel)
    _, without = run_ppo("hydra", None)
    assert with_obs == without


# ------------------------------------------------------- compiled memory
def test_record_compiled_memory_unit():
    reg = MetricsRegistry()
    x = torch.ones(64, 64)
    stats = record_compiled_memory(reg, "double", lambda y: y * 2 + 1, x)
    assert stats == {"temp_bytes": 2 * x.nbytes, "argument_bytes": x.nbytes,
                     "output_bytes": x.nbytes, "generated_code_bytes": 0}
    for key, val in stats.items():
        assert reg.get(f"compiled_{key}").value(program="double") == val
    # a callable that reads values (or mixes in real tensors) cannot be
    # traced on meta: None, not an exception
    assert record_compiled_memory(reg, "item", lambda y: y.sum().item(),
                                  x) is None
    assert record_compiled_memory(reg, "mixed", lambda y: y + x, x) is None
    assert reg.get("compiled_temp_bytes").value(program="item") == 0


def test_trainer_records_compiled_programs():
    tel = RunTelemetry.create(sim_delta=False)
    run_ppo("separate", tel, steps=1)
    progs = {m["labels"]["program"] for m in tel.registry.snapshot()
             if m["name"] == "compiled_temp_bytes"}
    assert progs == {"score_reward", "score_ref", "score_values",
                     "score_old_logp", "train_actor", "train_critic"}
    g = tel.registry.get("compiled_argument_bytes")
    assert g.value(program="train_actor") > g.value(program="score_ref") > 0


# ------------------------------------------------- the watermark dump
def test_ppo_watermark_dump_names_owners(tmp_path):
    """The reference's test, with no capacity given: the CPU calibration
    latches the trainer's own bytes at its first record, and a later
    record at 0.9 of that trips, whatever else the process holds."""
    hold = [torch.ones(1 << 20) for _ in range(8)]   # 32 MiB elsewhere
    path = str(tmp_path / "flight.json")
    fl = FlightRecorder(watermark=0.9, ring=64, path=path, device="cpu")
    tel = RunTelemetry.create(engine="hydra", flight=fl)
    run_ppo("hydra", tel, steps=2)
    assert fl.dumps, "watermark never tripped"
    dump = fl.dumps[0]
    assert dump["trigger"] == "watermark" and dump["source"] == "rlhf"
    assert dump["owners_ranked"] and dump["top_buffers"]
    assert all(dump["owners"][o] > 0 for o in dump["owners_ranked"][:3])
    assert dump["phase_history"], "dump carries no phase history"
    assert json.load(open(path))["schema"] == "flight-recorder/v1"
    del hold
