"""The port's copy of ``launch/report.py`` (``repro_torch.launch.report``)
on the reference's ``tests/test_report.py`` cases — empty samples, spans
without the simulator prediction, a zero-width timeline, a metrics-only
file, the owner x phase attribution table, the flight-recorder dump
summary and the cross-run trend table — and the two packages' renderers
on the same inputs: every case's file, a JSONL from the port's 1-step
PPO with telemetry, and a port flight-recorder dump, each rendered to the
same text by both.
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro.launch import report as jax_report  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import report  # noqa: E402
from repro_torch.launch.report import (attribution_table,  # noqa: E402
                                       flight_summary, load, phase_table,
                                       render, timeline, trend_table)
from repro_torch.obs import FlightRecorder, RunTelemetry  # noqa: E402
from repro_torch.rlhf import RLHFConfig, RLHFTrainer  # noqa: E402
from repro_torch.rlhf.reward import make_target_token_reward  # noqa: E402


def _span(name, dur_us=1000.0, **args):
    return {"type": "span", "name": name, "cat": "phase", "ts_us": 0.0,
            "dur_us": dur_us, "depth": 0, "args": args}


def _write_jsonl(path, records):
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    return str(path)


# --------------------------------------------------------------- edge cases
def test_render_empty_file(tmp_path):
    path = _write_jsonl(tmp_path / "empty.jsonl", [])
    out = render(path)
    assert "(no phase spans in file)" in out
    assert "(no 'memory/device_mib' samples in file)" in out


def test_phase_table_span_missing_sim_bytes():
    """A span recorded without the simulator prediction renders '-' in the
    sim/delta columns instead of crashing."""
    out = phase_table([
        _span("rollout", measured_bytes=2 << 20, measured_peak_bytes=3 << 20,
              host_bytes=0, pcie_bytes=0),
        _span("train_actor", measured_bytes=1 << 20,
              measured_peak_bytes=1 << 20, host_bytes=0, pcie_bytes=0,
              sim_peak_bytes=1 << 20, sim_delta_bytes=-(1 << 18)),
    ])
    lines = out.splitlines()
    roll = next(ln for ln in lines if ln.startswith("rollout"))
    assert roll.rstrip().endswith("-")
    actor = next(ln for ln in lines if ln.startswith("train_actor"))
    assert "-0.25" in actor


def test_timeline_zero_width():
    """All samples at the same timestamp: max(t_hi - t_lo, 1) guards the
    bucketing division."""
    samples = [{"type": "sample", "track": "memory", "ts_us": 100.0,
                "values": {"device_mib": float(v)}} for v in (1, 2, 3)]
    out = timeline(samples)
    assert "ZeroDivision" not in out and "█" in out


def test_timeline_too_few_samples():
    assert timeline([]) == "(no 'memory/device_mib' samples in file)"
    one = [{"type": "sample", "track": "memory", "ts_us": 0.0,
            "values": {"device_mib": 1.0}}]
    assert timeline(one).startswith("(no ")


def test_render_metrics_only_file(tmp_path):
    """A file holding only metric records (registry.write_jsonl with no
    tracer output) still renders, and --metrics shows the snapshot."""
    recs = [
        {"type": "metric", "name": "rlhf_phase_total", "kind": "counter",
         "labels": {"phase": "rollout"}, "value": 4.0},
        {"type": "metric", "name": "rlhf_phase_seconds", "kind": "histogram",
         "labels": {}, "count": 4, "sum": 2.0, "min": 0.25, "max": 1.0,
         "buckets": {}},
    ]
    path = _write_jsonl(tmp_path / "metrics.jsonl", recs)
    meta, events, samples, metrics = load(path)
    assert not events and not samples and len(metrics) == 2
    out = render(path, show_metrics=True)
    assert "rlhf_phase_total{phase=rollout}" in out
    assert "n=4 mean=0.5" in out


# -------------------------------------------------------- attribution table
def test_attribution_table_basic():
    events = [
        _span("rollout", attrib={"base_params": 4 << 20},
              attrib_unattributed=1 << 19),
        _span("train_actor", attrib={"actor_opt": 8 << 20, "kv": 1 << 20},
              attrib_unattributed=0),
        # a second rollout span: the LAST one per phase must win
        _span("rollout", attrib={"base_params": 2 << 20},
              attrib_unattributed=1 << 20),
    ]
    out = attribution_table(events)
    lines = out.splitlines()
    # rows sorted by largest cell; residue row last
    owners = [ln.split()[0] for ln in lines[2:]]
    assert owners == ["actor_opt", "base_params", "kv", "(unattributed)"]
    base = next(ln for ln in lines if ln.startswith("base_params"))
    assert "2.00" in base and "4.00" not in base     # last span won
    kv = next(ln for ln in lines if ln.startswith("kv"))
    assert "-" in kv            # kv owns nothing during rollout


def test_attribution_table_empty_and_sim_delta():
    assert attribution_table([]).startswith("(no per-owner")
    assert attribution_table(
        [_span("rollout", attrib={"a": 1})],
        key="attrib_sim_delta").startswith("(no per-owner")
    out = attribution_table(
        [_span("rollout", attrib_sim_delta={"base_params": -(1 << 20),
                                            "actor_opt": 1 << 21})],
        key="attrib_sim_delta")
    assert "-1.00" in out and "+2.00" in out


def test_render_includes_attribution_sections(tmp_path):
    path = _write_jsonl(tmp_path / "run.jsonl", [
        _span("rollout", measured_bytes=1, measured_peak_bytes=1,
              host_bytes=0, pcie_bytes=0, attrib={"base_params": 1 << 20},
              attrib_unattributed=0,
              attrib_sim_delta={"base_params": 1 << 19})])
    out = render(path)
    assert "per-owner attribution" in out
    assert "per-owner sim delta" in out
    # and a file without attrib args omits the sections entirely
    path2 = _write_jsonl(tmp_path / "run2.jsonl", [
        _span("rollout", measured_bytes=1, measured_peak_bytes=1,
              host_bytes=0, pcie_bytes=0)])
    assert "per-owner attribution" not in render(path2)


# ------------------------------------------------------------ flight summary
def test_flight_summary_full_dump():
    dump = {"schema": "flight-recorder/v1", "trigger": "watermark",
            "source": "rlhf", "phase": "rollout_decode",
            "live_bytes": 3 << 20, "capacity_bytes": 4 << 20,
            "watermark": 0.9,
            "owners": {"merged_rollout": 2 << 20, "actor_params": 1 << 19},
            "owners_ranked": ["merged_rollout", "actor_params"],
            "unattributed": 1 << 19,
            "top_buffers": [{"nbytes": 1 << 20, "shape": "(2, 128, 256)",
                             "dtype": "bfloat16", "owner": "merged_rollout",
                             "path": "['w_in']"}],
            "phase_history": [{"phase": "rollout", "live_bytes": 1 << 20,
                               "host_bytes": 2 << 20}],
            "ring": [{"event": "phase"}] * 5}
    out = flight_summary(dump)
    assert "trigger: watermark" in out and "phase: rollout_decode" in out
    assert "merged_rollout" in out and "66.7%" in out
    assert "@['w_in']" in out
    assert "ring: 5 context events" in out


def test_flight_summary_minimal_dump():
    """An OOM dump captured with no snapshot available (owners empty)
    still renders, including the error line."""
    out = flight_summary({"trigger": "resource_exhausted",
                          "error": "XlaRuntimeError('RESOURCE_EXHAUSTED')",
                          "live_bytes": 0})
    assert "resource_exhausted" in out
    assert "RESOURCE_EXHAUSTED" in out
    assert "(unattributed)" in out


# --------------------------------------------------------------- trend table
def test_trend_table(tmp_path):
    path = tmp_path / "HISTORY_obs.jsonl"
    rows = [
        {"t": 1.0, "iso": "2026-08-08T00:00:00", "sha": "abc1234",
         "bench": "obs", "gated": {"telemetry_overhead_pct": 0.08}},
        # a later run gains a metric: column union, '-' for the old row
        {"t": 2.0, "iso": "2026-08-08T01:00:00", "sha": "def5678",
         "bench": "obs", "gated": {"telemetry_overhead_pct": 0.07,
                                   "attrib_unattributed_pct": 0.8}},
    ]
    _write_jsonl(path, rows)
    out = trend_table(str(path))
    assert "bench history: obs (last 2 runs)" in out
    assert "abc1234" in out and "def5678" in out
    assert "telemetry_overhead_pct" in out
    assert "attrib_unattributed_pct" in out
    first = next(ln for ln in out.splitlines() if "abc1234" in ln)
    assert first.rstrip().endswith("-")


def test_trend_table_empty(tmp_path):
    path = tmp_path / "HISTORY_x.jsonl"
    path.write_text("")
    assert trend_table(str(path)) == "(empty history file)"


def test_trend_table_last_window(tmp_path):
    path = tmp_path / "HISTORY_y.jsonl"
    rows = [{"t": float(i), "iso": f"2026-08-08T00:00:{i:02d}",
             "sha": f"s{i}", "bench": "y", "gated": {"m": float(i)}}
            for i in range(30)]
    _write_jsonl(path, rows)
    out = trend_table(str(path), last=5)
    assert "(last 5 runs)" in out and "s29" in out and "s10" not in out


# ------------------------------------------------ both packages, same text
MIB = 1 << 20
RUN_FILES = {
    "empty": [],
    "phases": [
        _span("rollout", measured_bytes=2 * MIB, measured_peak_bytes=3 * MIB,
              host_bytes=MIB, pcie_bytes=MIB // 2),
        _span("train_actor", measured_bytes=MIB, measured_peak_bytes=MIB,
              host_bytes=0, pcie_bytes=0, sim_peak_bytes=MIB,
              sim_delta_bytes=-(1 << 18)),
        {"type": "instant", "name": "rollout_decode:sample", "cat": "phase",
         "ts_us": 5.0, "args": {"measured_bytes": 7}},
        {"type": "span", "name": "park:rollout", "cat": "offload",
         "ts_us": 1.0, "dur_us": 2.0, "depth": 1, "args": {}}],
    "timeline": [{"type": "sample", "track": "memory", "ts_us": float(t),
                  "values": {"device_mib": float(v), "host_mib": float(h)}}
                 for t, v, h in ((0, 1, 0), (10, 3, 2), (20, 2, 1))],
    "zero_width": [{"type": "sample", "track": "memory", "ts_us": 100.0,
                    "values": {"device_mib": float(v)}} for v in (1, 2, 3)],
    "metrics_only": [
        {"type": "metric", "name": "rlhf_phase_total", "kind": "counter",
         "labels": {"phase": "rollout"}, "value": 4.0},
        {"type": "metric", "name": "offload_host_bytes", "kind": "gauge",
         "labels": {}, "value": 2.0, "peak": 5.0},
        {"type": "metric", "name": "rlhf_phase_seconds",
         "kind": "histogram", "labels": {}, "count": 4, "sum": 2.0,
         "min": 0.25, "max": 1.0, "buckets": {}}],
    "attribution": [
        {"type": "meta", "t0_wall": 0.0, "written": 1.0, "engine": "hydra"},
        _span("rollout", measured_bytes=1, measured_peak_bytes=1,
              host_bytes=0, pcie_bytes=0, attrib={"base_params": MIB},
              attrib_unattributed=MIB // 4,
              attrib_sim_delta={"base_params": MIB // 2}),
        _span("train_actor", measured_bytes=1, measured_peak_bytes=1,
              host_bytes=0, pcie_bytes=0,
              attrib={"actor_opt": 8 * MIB, "kv": MIB},
              attrib_unattributed=0)],
}
DUMPS = {
    "full": {"schema": "flight-recorder/v1", "trigger": "watermark",
             "source": "rlhf", "phase": "rollout_decode",
             "live_bytes": 3 * MIB, "capacity_bytes": 4 * MIB,
             "watermark": 0.9,
             "owners": {"merged_rollout": 2 * MIB, "actor_params": MIB // 2},
             "owners_ranked": ["merged_rollout", "actor_params"],
             "unattributed": MIB // 2,
             "top_buffers": [{"nbytes": MIB, "shape": "(2, 128, 256)",
                              "dtype": "bfloat16", "owner": "merged_rollout",
                              "path": "['w_in']"}],
             "phase_history": [{"phase": "rollout", "live_bytes": MIB,
                                "host_bytes": 2 * MIB}],
             "ring": [{"event": "phase"}] * 5},
    "minimal": {"trigger": "resource_exhausted",
                "error": "OutOfMemoryError: CUDA out of memory.",
                "live_bytes": 0},
}


@pytest.mark.parametrize("name", sorted(RUN_FILES))
def test_both_packages_render_the_same_file(tmp_path, name):
    path = _write_jsonl(tmp_path / f"{name}.jsonl", RUN_FILES[name])
    for metrics in (False, True):
        for width in (16, 64):
            assert render(path, width=width, show_metrics=metrics) == \
                jax_report.render(path, width=width, show_metrics=metrics)


@pytest.mark.parametrize("name", sorted(DUMPS))
def test_both_packages_render_the_same_dump(name):
    assert flight_summary(DUMPS[name]) == jax_report.flight_summary(
        DUMPS[name])


def test_both_packages_render_the_same_trend(tmp_path):
    path = tmp_path / "HISTORY_obs.jsonl"
    _write_jsonl(path, [{"t": float(i), "iso": f"2026-08-08T00:00:{i:02d}",
                         "sha": f"s{i}", "bench": "obs",
                         "gated": {"m": float(i), "s": "x" * i}
                         if i % 2 else {"m": float(i)}} for i in range(25)])
    for last in (5, 20):
        assert trend_table(str(path), last=last) == \
            jax_report.trend_table(str(path), last=last)


def _main(module, argv, monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["report"] + argv)
    module.main()
    return capsys.readouterr().out


def test_port_run_renders_the_same_in_both(tmp_path, monkeypatch, capsys):
    """A JSONL and a flight dump from the port's 1-step hydra PPO with
    offload, through both modules' command lines."""
    cfg = dataclasses.replace(
        get_config("llama3_2_3b").smoke(), num_layers=2, d_model=128,
        d_ff=64, vocab_size=32, num_heads=2, num_kv_heads=1, head_dim=64)
    dump = str(tmp_path / "flight.json")
    tel = RunTelemetry.create(engine="hydra", flight=FlightRecorder(
        watermark=0.5, ring=16, path=dump, device="cpu"))
    tr = RLHFTrainer(cfg, cfg, RLHFConfig(engine="hydra", offload="all",
                                          prompt_len=4, gen_len=4,
                                          temperature=0.0, top_k=0,
                                          lora_rank=2),
                     torch.Generator().manual_seed(0),
                     reward_fn=make_target_token_reward(7), telemetry=tel)
    tr.train_step(torch.zeros(2, 4, dtype=torch.long),
                  torch.Generator().manual_seed(0))
    path = tel.write_jsonl(str(tmp_path / "run.jsonl"))
    tel.write_chrome_trace(str(tmp_path / "trace.json"))
    argv = [path, "--metrics", "--flight", dump]
    got = _main(report, argv, monkeypatch, capsys)
    assert got == _main(jax_report, argv, monkeypatch, capsys)
    for part in ("flight recorder dump", "per-owner attribution",
                 "per-owner sim delta", "host (parked) memory",
                 "compiled_temp_bytes{program=train_actor}",
                 "offload_parked_bytes_total"):
        assert part in got, part
    assert json.load(open(tmp_path / "trace.json"))["traceEvents"]
