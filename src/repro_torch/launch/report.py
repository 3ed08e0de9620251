"""Render a run's telemetry JSONL (``repro_torch.obs.RunTelemetry.
write_jsonl``) as a per-phase table and an ASCII memory timeline — a copy
of the JAX package's ``repro/launch/report.py`` (which imports no JAX),
kept here so the port imports nothing of ``repro``; the two render the
same file to the same text, and either package's flight-recorder dumps.

Everything printed here is read straight off the file — phase wall times,
measured/simulated bytes and PCIe traffic all rode the spans when the run
recorded them, so the report involves zero recomputation (and can be run
on another machine, long after the run).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.report RUN.jsonl [--width 64]
  PYTHONPATH=src python -m repro_torch.launch.report RUN.jsonl --metrics
  PYTHONPATH=src python -m repro_torch.launch.report --flight DUMP.json
"""
from __future__ import annotations

import argparse
import json
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

_MIB = 2 ** 20


def load(path: str) -> Tuple[dict, List[dict], List[dict], List[dict]]:
    """Split a telemetry JSONL into (meta, spans+instants, samples,
    metrics)."""
    meta: dict = {}
    events: List[dict] = []
    samples: List[dict] = []
    metrics: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            t = rec.get("type")
            if t == "meta":
                meta = rec
            elif t == "sample":
                samples.append(rec)
            elif t == "metric":
                metrics.append(rec)
            elif t in ("span", "instant"):
                events.append(rec)
    return meta, events, samples, metrics


def phase_table(events: List[dict]) -> str:
    """Aggregate the ``cat == "phase"`` spans per phase name, preserving
    first-seen order (the canonical phase sequence)."""
    rows: Dict[str, dict] = {}
    order: List[str] = []
    for ev in events:
        if ev.get("type") != "span" or ev.get("cat") != "phase":
            continue
        name, args = ev["name"], ev.get("args", {})
        if name not in rows:
            order.append(name)
            rows[name] = {"n": 0, "wall_us": 0.0, "live": 0, "peak": 0,
                          "host": 0, "pcie": 0.0, "sim": None, "delta": None}
        r = rows[name]
        r["n"] += 1
        r["wall_us"] += ev.get("dur_us", 0.0)
        r["live"] = max(r["live"], args.get("measured_bytes", 0))
        r["peak"] = max(r["peak"], args.get("measured_peak_bytes", 0))
        r["host"] = max(r["host"], args.get("host_bytes", 0))
        r["pcie"] += args.get("pcie_bytes", 0)
        if "sim_peak_bytes" in args:
            r["sim"] = args["sim_peak_bytes"]
            r["delta"] = args.get("sim_delta_bytes")
    if not rows:
        return "(no phase spans in file)"
    hdr = (f"{'phase':16s} {'n':>3s} {'wall ms':>9s} {'live MiB':>9s} "
           f"{'peak MiB':>9s} {'host MiB':>9s} {'PCIe MiB':>9s} "
           f"{'sim MiB':>9s} {'delta MiB':>10s}")
    out = [hdr, "-" * len(hdr)]
    for name in order:
        r = rows[name]
        sim = f"{r['sim']/_MIB:9.2f}" if r["sim"] is not None else f"{'-':>9s}"
        dl = (f"{r['delta']/_MIB:+10.2f}" if r["delta"] is not None
              else f"{'-':>10s}")
        out.append(f"{name:16s} {r['n']:3d} {r['wall_us']/1e3:9.1f} "
                   f"{r['live']/_MIB:9.2f} {r['peak']/_MIB:9.2f} "
                   f"{r['host']/_MIB:9.2f} {r['pcie']/_MIB:9.2f} {sim} {dl}")
    return "\n".join(out)


def timeline(samples: List[dict], *, track: str = "memory",
             key: str = "device_mib", width: int = 64,
             height: int = 10) -> str:
    """ASCII area chart of one counter-track series over the run."""
    pts = [(s["ts_us"], s["values"][key]) for s in samples
           if s.get("track") == track and key in s.get("values", {})]
    if len(pts) < 2:
        return f"(no '{track}/{key}' samples in file)"
    pts.sort()
    t_lo, t_hi = pts[0][0], pts[-1][0]
    v_hi = max(v for _, v in pts) or 1.0
    # bucket samples into `width` columns, keep each column's max
    cols: List[Optional[float]] = [None] * width
    for t, v in pts:
        c = min(int((t - t_lo) / max(t_hi - t_lo, 1) * (width - 1)),
                width - 1)
        cols[c] = v if cols[c] is None else max(cols[c], v)
    last = 0.0
    for i, c in enumerate(cols):          # carry last value through gaps
        last = last if c is None else c
        cols[i] = last
    grid = []
    for row in range(height, 0, -1):
        thr = v_hi * (row - 0.5) / height
        line = "".join("█" if v >= thr else " " for v in cols)
        label = f"{v_hi * row / height:8.1f} |" if row in (1, height) \
            else f"{'':8s} |"
        grid.append(label + line)
    grid.append(f"{'':8s} +" + "-" * width)
    grid.append(f"{'':10s}0 ms{'':{max(width - 18, 1)}s}"
                f"{(t_hi - t_lo)/1e3:8.1f} ms")
    return "\n".join(grid)


def attribution_table(events: List[dict], *, key: str = "attrib") -> str:
    """Owner x phase matrix in MiB, read from the LAST span of each phase
    name (the steady-state iteration). ``key="attrib"`` renders measured
    per-owner bytes plus the unattributed residue row;
    ``key="attrib_sim_delta"`` renders the signed measured-minus-sim
    per-owner deltas instead."""
    cols: Dict[str, dict] = {}
    order: List[str] = []
    for ev in events:
        if ev.get("type") != "span" or ev.get("cat") != "phase":
            continue
        args = ev.get("args", {})
        if key not in args:
            continue
        name = ev["name"]
        if name not in cols:
            order.append(name)
        tab = dict(args[key])
        if key == "attrib":
            tab["(unattributed)"] = args.get("attrib_unattributed", 0)
        cols[name] = tab
    if not cols:
        return f"(no per-owner '{key}' tables in file)"
    # rows sorted by the owner's largest (absolute) cell, residue last
    peak: Dict[str, int] = {}
    for tab in cols.values():
        for k, v in tab.items():
            peak[k] = max(peak.get(k, 0), abs(int(v)))
    names = sorted((k for k in peak if k != "(unattributed)"),
                   key=lambda k: -peak[k])
    if "(unattributed)" in peak:
        names.append("(unattributed)")
    w = max(9, *(len(p) for p in order))
    signed = key != "attrib"
    hdr = f"{'owner':18s} " + " ".join(f"{p:>{w}s}" for p in order)
    out = [hdr, "-" * len(hdr)]
    for k in names:
        cells = []
        for p in order:
            v = cols[p].get(k)
            if v is None:
                cells.append(f"{'-':>{w}s}")
            elif signed:
                cells.append(f"{v / _MIB:>+{w}.2f}")
            else:
                cells.append(f"{v / _MIB:>{w}.2f}")
        out.append(f"{k:18s} " + " ".join(cells))
    return "\n".join(out)


def flight_summary(dump: dict) -> str:
    """Human rendering of one flight-recorder dump bundle
    (``obs.flight`` schema ``flight-recorder/v1``)."""
    cap = dump.get("capacity_bytes") or 0
    live = dump.get("live_bytes", 0)
    head = f"flight recorder dump — trigger: {dump.get('trigger', '?')}" \
           f" (source: {dump.get('source') or '?'}"
    if dump.get("phase"):
        head += f", phase: {dump['phase']}"
    out = [head + ")",
           f"  live {live / _MIB:.2f} MiB / capacity {cap / _MIB:.2f} MiB"
           f" (watermark {dump.get('watermark', 0):.0%})"]
    if dump.get("error"):
        out.append(f"  error: {dump['error'][:200]}")
    owners = dump.get("owners", {})
    if owners:
        out.append("  owners:")
        ranked = dump.get("owners_ranked") or \
            sorted(owners, key=owners.get, reverse=True)
        for k in ranked:
            out.append(f"    {k:20s} {owners[k] / _MIB:9.2f} MiB "
                       f"{owners[k] / max(live, 1):6.1%}")
    un = dump.get("unattributed", 0)
    out.append(f"    {'(unattributed)':20s} {un / _MIB:9.2f} MiB "
               f"{un / max(live, 1):6.1%}")
    tb = dump.get("top_buffers", [])
    if tb:
        out.append(f"  top {len(tb)} live buffers:")
        for b in tb:
            line = (f"    {b.get('nbytes', 0) / _MIB:9.2f} MiB "
                    f"{str(b.get('dtype', '?')):>10s} "
                    f"{str(b.get('shape', '?')):16s} "
                    f"{b.get('owner', '?')}")
            if b.get("path"):
                line += f" @{b['path']}"
            out.append(line)
    ph = dump.get("phase_history", [])
    if ph:
        out.append(f"  phase history ({len(ph)} boundaries, oldest first):")
        for p in ph[-10:]:
            out.append(f"    {str(p.get('phase', '?')):16s} "
                       f"live {p.get('live_bytes', 0) / _MIB:9.2f} MiB  "
                       f"host {(p.get('host_bytes') or 0) / _MIB:9.2f} MiB")
    out.append(f"  ring: {len(dump.get('ring', []))} context events")
    return "\n".join(out)


def trend_table(path: str, *, last: int = 20) -> str:
    """Cross-run trajectory of one bench's gated metrics, read from a
    ``benchmarks/history/HISTORY_<name>.jsonl`` file (one line per run,
    appended by ``benchmarks.run``)."""
    rows: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    if not rows:
        return "(empty history file)"
    rows = rows[-last:]
    keys: List[str] = []
    for r in rows:
        for k in r.get("gated", {}):
            if k not in keys:
                keys.append(k)
    w = {k: max(len(k), 10) for k in keys}
    hdr = f"{'when':>16s} {'sha':>9s} " + \
        " ".join(f"{k:>{w[k]}s}" for k in keys)
    out = [f"bench history: {rows[-1].get('bench', '?')} "
           f"(last {len(rows)} runs)", hdr, "-" * len(hdr)]
    for r in rows:
        cells = []
        for k in keys:
            v = r.get("gated", {}).get(k)
            if v is None:
                cells.append(f"{'-':>{w[k]}s}")
            elif isinstance(v, (int, float)):
                cells.append(f"{v:>{w[k]}.4g}")
            else:
                cells.append(f"{str(v)[:w[k]]:>{w[k]}s}")
        out.append(f"{str(r.get('iso', ''))[:16]:>16s} "
                   f"{str(r.get('sha', '-')):>9s} " + " ".join(cells))
    return "\n".join(out)


def metric_lines(metrics: List[dict]) -> str:
    out = []
    for m in metrics:
        lab = ",".join(f"{k}={v}" for k, v in sorted(
            m.get("labels", {}).items()))
        name = m["name"] + (f"{{{lab}}}" if lab else "")
        if m["kind"] == "histogram":
            mean = m["sum"] / m["count"] if m["count"] else 0.0
            out.append(f"  {name:48s} n={m['count']} mean={mean:.6g} "
                       f"max={m['max']:.6g}")
        else:
            peak = f" peak={m['peak']:.6g}" if "peak" in m else ""
            out.append(f"  {name:48s} {m['value']:.6g}{peak}")
    return "\n".join(out) if out else "  (no metrics in file)"


def render(path: str, *, width: int = 64, show_metrics: bool = False) -> str:
    meta, events, samples, metrics = load(path)
    run_meta = {k: v for k, v in meta.items()
                if k not in ("type", "t0_wall", "written")}
    out = [f"telemetry report: {path}"]
    if run_meta:
        out.append("  " + " ".join(f"{k}={v}" for k, v in
                                   sorted(run_meta.items())))
    n_off = sum(1 for e in events if e.get("cat") == "offload")
    n_srv = sum(1 for e in events if e.get("cat") == "serving")
    out += ["", phase_table(events)]
    attr = attribution_table(events)
    if not attr.startswith("(no"):
        out += ["", "per-owner attribution (MiB, last span per phase):",
                attr]
        sd = attribution_table(events, key="attrib_sim_delta")
        if not sd.startswith("(no"):
            out += ["", "per-owner sim delta (measured - sim, MiB):", sd]
    out += ["", "live device memory (MiB) over the run:",
            timeline(samples, width=width)]
    host = [s for s in samples if s.get("track") == "memory"
            and s.get("values", {}).get("host_mib")]
    if host:
        out += ["", "host (parked) memory (MiB) over the run:",
                timeline(samples, key="host_mib", width=width)]
    if n_off or n_srv:
        out += ["", f"other spans: {n_off} offload, {n_srv} serving"]
    if show_metrics:
        out += ["", "metrics snapshot:", metric_lines(metrics)]
    return "\n".join(out)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("jsonl", nargs="?",
                    help="run telemetry JSONL "
                         "(RunTelemetry.write_jsonl output)")
    ap.add_argument("--width", type=int, default=64,
                    help="timeline width in columns")
    ap.add_argument("--metrics", action="store_true",
                    help="also print the final metrics snapshot")
    ap.add_argument("--trend", metavar="HISTORY_JSONL",
                    help="render a benchmarks/history/HISTORY_<name>.jsonl "
                         "cross-run trajectory")
    ap.add_argument("--flight", metavar="DUMP_JSON",
                    help="render a flight-recorder dump bundle")
    args = ap.parse_args()
    shown = False
    if args.trend:
        print(trend_table(args.trend))
        shown = True
    if args.flight:
        with open(args.flight) as f:
            print(flight_summary(json.load(f)))
        shown = True
    if args.jsonl:
        if shown:
            print()
        print(render(args.jsonl, width=args.width,
                     show_metrics=args.metrics))
    elif not shown:
        ap.error("nothing to render: give a run JSONL, --trend, "
                 "or --flight")


if __name__ == "__main__":
    main()
