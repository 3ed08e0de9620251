"""The port's runtime telemetry (``repro_torch.obs``) against the JAX
reference on the CPU: the metrics registry, span nesting and ordering,
the Chrome-trace schema (event for event the reference tracer's), the
``torch.profiler`` bridge, phase-span coverage and tiling on both
engines, the sim-vs-measured delta with offload spans, the pure-observer
property, the report rendered from a run's JSONL, and a 2-step micro PPO
with telemetry against the JAX trainer with telemetry on both engines.

The micro config is the reference's ``tests/test_obs.py::micro_cfg`` (2
layers) at head_dim 64 and d_model 128: the simulator replay traces the
port's kernels on ``meta``, and they take head_dim 64 or 128. Parity
compares structure, not bytes: the sequence of ``(cat, name)`` spans, the
arg keys of every phase and offload span, and the metric names with their
label sets; byte values are not compared across packages, because on the
CPU the reference counts every live JAX array of the process and the port
the trainer's own tensors, and the reference's trees are layer-stacked.
Losses match the JAX trainer's at 1e-4, as ``tests/test_torch_train.py``.
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.obs import RunTelemetry as JaxRunTelemetry  # noqa: E402
from repro.obs import SpanTracer as JaxSpanTracer  # noqa: E402
from repro.rlhf import RLHFConfig as JaxRLHFConfig  # noqa: E402
from repro.rlhf import RLHFTrainer as JaxRLHFTrainer  # noqa: E402
from repro.rlhf.reward import \
    make_target_token_reward as jax_target_reward  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import RUNTIME_RLHF_PHASE_SEQUENCE  # noqa: E402
from repro_torch.launch.report import load, phase_table, render  # noqa: E402
from repro_torch.obs import MetricsRegistry, RunTelemetry, SpanTracer  # noqa: E402
from repro_torch.rlhf import RLHFConfig, RLHFTrainer  # noqa: E402
from repro_torch.rlhf.reward import make_target_token_reward  # noqa: E402

TOL = 1e-4
ENGINES = ("hydra", "separate")
MICRO = dict(num_layers=2, d_model=128, d_ff=64, vocab_size=32, num_heads=2,
             num_kv_heads=1, head_dim=64)
RL_KW = dict(prompt_len=4, gen_len=4, lr=1e-3, critic_lr=1e-3, kl_coef=0.1,
             temperature=0.0, top_k=0, lora_rank=2)


def micro_cfgs():
    return (dataclasses.replace(jax_get_config("llama3_2_3b").smoke(), **MICRO),
            dataclasses.replace(get_config("llama3_2_3b").smoke(), **MICRO))


def _prompts(s):
    return torch.randint(0, MICRO["vocab_size"], (2, RL_KW["prompt_len"]),
                         generator=torch.Generator().manual_seed(s))


def run_ppo(engine, telemetry, steps=2, **rl_kw):
    """``steps`` greedy iterations of the port's trainer; hydra scores with
    a programmatic reward, separate with the reward model."""
    cfg = micro_cfgs()[1]
    rl = RLHFConfig(engine=engine, **{**RL_KW, **rl_kw})
    tr = RLHFTrainer(cfg, cfg, rl, torch.Generator().manual_seed(0),
                     reward_fn=make_target_token_reward(7)
                     if engine == "hydra" else None, telemetry=telemetry)
    ms = [tr.train_step(_prompts(s), torch.Generator().manual_seed(100 + s))
          for s in range(steps)]
    return tr, ms


def _phase_spans(tel):
    return [s for s in tel.tracer.spans if s.cat == "phase"]


# ---------------------------------------------------------------- metrics
def test_registry_counter_gauge_histogram():
    reg = MetricsRegistry()
    c = reg.counter("c", "a counter")
    c.inc()
    c.inc(2.5, phase="rollout")
    assert c.value() == 1.0 and c.value(phase="rollout") == 2.5
    with pytest.raises(AssertionError):
        c.inc(-1)
    g = reg.gauge("g")
    g.set(5)
    g.set(3)
    assert g.value() == 3 and g.peak() == 5
    h = reg.histogram("h")
    for v in (1e-5, 1e-3, 0.1, 7.0):
        h.observe(v)
    s = h.summary()
    assert s["count"] == 4 and s["min"] == 1e-5 and s["max"] == 7.0
    assert reg.counter("c") is c
    with pytest.raises(TypeError):
        reg.gauge("c")


def test_registry_snapshot_and_jsonl_roundtrip(tmp_path):
    reg = MetricsRegistry()
    reg.counter("x").inc(3, phase="train_actor")
    reg.gauge("y").set(1.5)
    reg.histogram("z").observe(0.25)
    path = tmp_path / "m.jsonl"
    n = reg.write_jsonl(str(path))
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(recs) == n == 3
    assert recs == reg.snapshot()
    byname = {r["name"]: r for r in recs}
    assert byname["x"]["labels"] == {"phase": "train_actor"}
    assert byname["x"]["value"] == 3
    assert byname["y"]["peak"] == 1.5
    assert byname["z"]["count"] == 1 and byname["z"]["buckets"]["+Inf"] == 1


# ----------------------------------------------------------------- tracer
def test_span_nesting_and_ordering():
    tr = SpanTracer()
    with tr.span("outer", "iteration"):
        with tr.span("inner", "phase"):
            pass
        tr.instant("evt", "phase")
    assert [s.name for s in tr.spans] == ["inner", "outer"]
    inner, outer = tr.spans
    assert inner.depth == 1 and outer.depth == 0
    assert outer.ts_us <= inner.ts_us
    assert inner.ts_us + inner.dur_us <= outer.ts_us + outer.dur_us + 1
    assert [r["name"] for r in tr.records()] == ["outer", "inner", "evt"]
    sp = tr.complete("retro", "phase", 5.0, 2.0, foo=1)
    assert sp.ts_us == 5.0 and sp.dur_us == 2.0 and sp.args == {"foo": 1}
    assert tr.self_time_s > 0


def test_unbalanced_end_asserts():
    with pytest.raises(AssertionError):
        SpanTracer().end()


def _drive(tr):
    with tr.span("a", "phase", bytes=7):
        pass
    tr.complete("park:rollout", "offload", 1.0, 2.0, parked_bytes=3)
    tr.instant("i", "offload")
    tr.sample("memory", {"device_mib": 1.0})


def _shape(trace):
    """A Chrome trace without its times and pid."""
    return [{k: v for k, v in e.items() if k not in ("ts", "dur", "pid")}
            for e in trace["traceEvents"]]


def test_chrome_trace_schema_matches_reference(tmp_path):
    tr = SpanTracer()
    _drive(tr)
    path = tr.write_chrome_trace(str(tmp_path / "t.json"))
    d = json.load(open(path))
    assert {e["ph"] for e in d["traceEvents"]} == {"M", "X", "i", "C"}
    for e in d["traceEvents"]:
        assert isinstance(e["pid"], int) and isinstance(e["tid"], int)
        if e["ph"] == "X" and e["name"] == "a":
            assert e["dur"] > 0 and e["args"] == {"bytes": 7}
    names = {e["args"]["name"] for e in d["traceEvents"] if e["ph"] == "M"}
    assert {"repro-telemetry", "phase", "offload"} <= names
    assert d["otherData"]["self_time_s"] >= 0
    ref = JaxSpanTracer()
    _drive(ref)
    want = ref.chrome_trace()
    assert _shape(d) == _shape(want)
    assert set(d) == set(want) and set(d["otherData"]) == set(
        want["otherData"])
    assert [set(r) for r in tr.records()] == [set(r) for r in ref.records()]


def test_annotate_puts_spans_in_a_profiler_trace():
    """``annotate=True``: ``begin``/``end`` spans and ``push_annotation``
    ranges are user annotations of a ``torch.profiler`` trace; without it
    none is recorded."""
    from torch.profiler import ProfilerActivity, profile

    def run(tr):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            tr.begin("ppo_iteration", "iteration")
            tr.push_annotation("rollout")
            torch.ones(4).sum()
            tr.pop_annotation()
            tr.end()
        return {e.key for e in prof.key_averages()}
    assert {"ppo_iteration", "rollout"} <= run(SpanTracer(annotate=True))
    assert not {"ppo_iteration", "rollout"} & run(SpanTracer())


# ---------------------------------------------------- trainer integration
@pytest.mark.parametrize("engine", ENGINES)
def test_phase_span_coverage_both_engines(engine):
    """One span per runtime phase, in order, tiling each iteration span:
    the first starts with it, each starts where the last ended."""
    tel = RunTelemetry.create(sim_delta=False)
    run_ppo(engine, tel, steps=2)
    spans = _phase_spans(tel)
    assert [s.name for s in spans] == list(RUNTIME_RLHF_PHASE_SEQUENCE) * 2
    for s in spans:
        for k in ("measured_bytes", "measured_peak_bytes", "host_bytes",
                  "pcie_bytes", "measured_bytes_per_device"):
            assert s.args[k] >= 0, k
        assert s.args["measured_bytes_per_device"] == s.args["measured_bytes"]
        assert s.args["measured_peak_bytes"] >= s.args["measured_bytes"]
    iters = [s for s in tel.tracer.spans if s.cat == "iteration"]
    assert len(iters) == 2
    n = len(RUNTIME_RLHF_PHASE_SEQUENCE)
    for i, it in enumerate(iters):
        mine = spans[i * n:(i + 1) * n]
        assert mine[0].ts_us == it.ts_us
        for a, b in zip(mine, mine[1:]):
            assert b.ts_us == a.ts_us + a.dur_us
        assert mine[-1].ts_us + mine[-1].dur_us <= it.ts_us + it.dur_us
        assert it.args["n"] == i and "mean_reward" in it.args
    assert tel.registry.counter("rlhf_iterations_total").value() == 2


class _FakeClock:
    """``time.perf_counter``/``perf_counter_ns`` held at ``seconds`` until
    the test moves it."""

    def __init__(self):
        self.seconds = 0.0

    def perf_counter(self):
        return self.seconds

    def perf_counter_ns(self):
        return int(round(self.seconds * 1e9))


def test_phase_spans_tile_exactly_under_awkward_clock(monkeypatch):
    """Phase spans tile their iteration to the bit even where the clock's
    readings do not add up in plain float µs: the readings of a run where
    ``ts + dur`` came out one ulp off the next phase's start (12154.938...
    µs to the first boundary, then 1113306.859... µs)."""
    import time as _time
    from repro_torch.rlhf import PhaseMemoryManager
    clock = _FakeClock()
    monkeypatch.setattr(_time, "perf_counter", clock.perf_counter)
    monkeypatch.setattr(_time, "perf_counter_ns", clock.perf_counter_ns)
    tel = RunTelemetry.create(sim_delta=False)
    mm = PhaseMemoryManager(policy="none", device="cpu", telemetry=tel)
    readings = [12154.938000094262, 1125461.797000753, 1125461.9,
                2231890.123456789, 3000000.1, 3333333.3333333335,
                4321987.654321, 5555555.555555556]
    kinds = ("inference",) * 5 + ("training",) * 2
    clock.seconds = readings[0] / 1e6
    mm.iteration_start()
    for phase, kind, t in zip(RUNTIME_RLHF_PHASE_SEQUENCE, kinds,
                              readings[1:]):
        clock.seconds = t / 1e6
        mm.boundary(phase, kind)
    mm.iteration_end()
    spans = _phase_spans(tel)
    (it,) = [s for s in tel.tracer.spans if s.cat == "iteration"]
    assert [s.name for s in spans] == list(RUNTIME_RLHF_PHASE_SEQUENCE)
    assert spans[0].ts_us == it.ts_us
    for a, b in zip(spans, spans[1:]):
        assert b.ts_us == a.ts_us + a.dur_us
    assert spans[-1].ts_us + spans[-1].dur_us == it.ts_us + it.dur_us


@pytest.mark.slow
def test_sim_vs_measured_delta_smoke():
    tel = RunTelemetry.create(sim_delta=True)
    tr, _ = run_ppo("hydra", tel, steps=2, offload="all")
    assert set(tr.memory.sim_phase_bytes) == set(RUNTIME_RLHF_PHASE_SEQUENCE)
    for s in _phase_spans(tel):
        assert "sim_peak_bytes" in s.args
        assert s.args["sim_delta_bytes"] == \
            s.args["measured_bytes"] - s.args["sim_bytes"]
    off = [s for s in tel.tracer.spans if s.cat == "offload"]
    assert any(s.name.startswith("park:") for s in off)
    assert any(s.name.startswith("fetch:") for s in off)
    for s in off:
        assert set(s.args) == {"parked_bytes", "fetched_bytes",
                               "prefetch_hits", "host_bytes"}
    reg = tel.registry
    for kind in ("parked", "fetched"):
        assert reg.counter(f"offload_{kind}_bytes_total").value() == sum(
            s.args[f"{kind}_bytes"] for s in off) > 0
    assert reg.gauge("offload_host_bytes").value() == \
        tr.offload_lot.stats.parked_bytes
    assert sum(s.args["pcie_bytes"] for s in _phase_spans(tel)) > 0


def test_telemetry_does_not_change_numerics():
    """Instrumentation is a pure observer: PPO metrics bit-identical with
    and without a telemetry bundle (offload, attribution and the
    simulator replay included)."""
    _, plain = run_ppo("hydra", None, steps=2, offload="all")
    _, seen = run_ppo("hydra", RunTelemetry.create(sim_delta=True), steps=2,
                      offload="all")
    for a, b in zip(plain, seen):
        assert a == b


# --------------------------------------------------------------- report
def test_report_renders_from_jsonl(tmp_path):
    tel = RunTelemetry.create(sim_delta=False, engine="hydra")
    run_ppo("hydra", tel, steps=1, offload="all")
    path = str(tmp_path / "run.jsonl")
    tel.write_jsonl(path)
    meta, events, samples, metrics = load(path)
    assert meta["type"] == "meta" and "self_time_s" in meta
    assert meta["engine"] == "hydra"
    assert any(e["cat"] == "phase" for e in events)
    assert any(s["track"] == "memory" for s in samples)
    assert metrics
    table = phase_table(events)
    for ph in RUNTIME_RLHF_PHASE_SEQUENCE:
        assert ph in table
    out = render(path, show_metrics=True)
    assert "live device memory" in out and "rlhf_iterations_total" in out
    assert "per-owner attribution" in out


# -------------------------------------------------- parity with the JAX run
def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x).copy(), tree)


def _structure(tel):
    """(the (cat, name) of every span in start order, a parent before the
    first phase it starts with; the arg keys of each phase and offload
    span; the metric (name, labels) series)."""
    spans = sorted(tel.tracer.spans, key=lambda s: (s.ts_us, s.depth))
    return ([(s.cat, s.name) for s in spans],
            [sorted(s.args) for s in spans if s.cat in ("phase", "offload")],
            {(m["name"], tuple(sorted(m["labels"].items())))
             for m in tel.registry.snapshot()})


def _run_jax(engine):
    jcfg = micro_cfgs()[0]
    tel = JaxRunTelemetry.create(sim_delta=True)
    tr = JaxRLHFTrainer(jcfg, jcfg, JaxRLHFConfig(engine=engine, offload="all",
                                                  **RL_KW),
                        jax.random.PRNGKey(0),
                        reward_fn=jax_target_reward(7)
                        if engine == "hydra" else None, telemetry=tel)
    init = (_np(tr.base_params), _np(tr.engine.adapters)) \
        if engine == "hydra" else (_np(tr.actor_state["params"]),
                                   _np(tr.critic_state["params"]))
    ms = [{k: float(v) for k, v in tr.train_step(
        jnp.asarray(np.asarray(_prompts(s))), jax.random.PRNGKey(s)).items()}
        for s in range(2)]
    return {"init": init, "metrics": ms, "structure": _structure(tel)}


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX trainer with telemetry once per engine, at offload "all"."""
    return {e: _run_jax(e) for e in ENGINES}


@pytest.mark.parametrize("engine", ENGINES)
def test_telemetry_matches_jax_trainer(jax_runs, engine):
    """The same spans in the same order, the same arg keys on every phase
    and offload span, the same metric names and label sets, and the
    losses within 1e-4. Two label differences are expected and checked:
    the reference's last boundary still holds the rollout's log-probs and
    the experience's 0-d mean reward (it drops them after its
    ``train_critic`` record, the port before), so it alone has their owner
    gauges there; and its XLA lowering of a scoring program whose trees
    are parked on the host fails and records nothing, where the port's
    ``meta`` trace records every program."""
    run = jax_runs[engine]
    tcfg = micro_cfgs()[1]
    rl = RLHFConfig(engine=engine, offload="all", **RL_KW)
    tel = RunTelemetry.create(sim_delta=True)
    a, b = run["init"]
    if engine == "hydra":
        tr = bridge.trainer_from_jax(a, b, tcfg, rl, device="cpu",
                                     reward_fn=make_target_token_reward(7),
                                     telemetry=tel)
    else:
        tr = bridge.separate_trainer_from_jax(a, b, tcfg, tcfg, rl,
                                              device="cpu", telemetry=tel)
    for s, want in enumerate(run["metrics"]):
        got = tr.train_step(_prompts(s), torch.Generator().manual_seed(s))
        for k in ("loss", "ppo_loss", "kl", "vf_loss", "grad_norm",
                  "mean_reward"):
            np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=0)
    spans, keys, series = _structure(tel)
    jspans, jkeys, jseries = run["structure"]
    assert spans == jspans
    assert keys == jkeys
    assert {n for n, _ in series} == {n for n, _ in jseries}
    held = {(("owner", o), ("phase", "train_critic"))
            for o in ("experience", "rollout_buffers")}
    assert jseries - series == {("rlhf_owner_live_bytes", h) for h in held}
    extra = series - jseries
    assert extra and all(n.startswith("compiled_") for n, _ in extra)
