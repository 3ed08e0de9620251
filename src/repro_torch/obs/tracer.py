"""SpanTracer: nested phase/step spans with memory samples, exported as
Chrome-trace/Perfetto JSON — the port of ``repro/obs/tracer.py``.

A span is a named wall-clock interval with arbitrary ``args``: the
instrumented subsystems attach the live device bytes, host bytes and PCIe
transfer bytes taken at the span boundary, and the RLHF trainer attaches
the traced allocator simulator's predicted bytes for the phase, so the
sim-vs-measured delta rides every phase span (see
``rlhf.trainer.PhaseMemoryManager``).

Three ways to record:

  * ``begin(name)`` / ``end()`` — stack-nested, for intervals whose
    endpoints the caller controls (the per-iteration parent span);
  * ``complete(name, t0, t1)`` — retroactive, for intervals delimited by
    events (phase boundaries: a phase's start is the previous boundary;
    offload park/fetch windows);
  * ``instant(name)`` / ``sample(values)`` — point events and counter
    tracks (the live device/host-bytes timeline Perfetto renders as an
    area chart).

Export targets, the same files as the reference's, key for key:

  * :meth:`chrome_trace` / :meth:`write_chrome_trace` — the Trace Event
    Format JSON (``{"traceEvents": [...]}``): ``X`` complete events for
    spans, ``C`` counter events for memory tracks, ``i`` instants, ``M``
    thread-name metadata naming one row per category;
  * :meth:`write_jsonl` — one JSON object per span/instant/sample, the
    file ``launch/report.py`` renders without recomputation.

The clock is whole microseconds held in floats (integer nanoseconds from
``time.perf_counter_ns``, floored to the µs): sums and differences of
such values are exact below 2**53, so a span recorded as ``complete(name,
t0, now - t0)`` ends exactly where the next one, starting at ``now``,
begins — phase spans tile their iteration bit for bit.

Self-accounting: every public recording method adds its own elapsed time
to ``self_time_s``, so a run reports the telemetry tax directly
(``overhead_fraction(wall_s)``).

``annotate=True`` (the reference's ``jax_annotate=``) brackets every
``begin``/``end`` span, and every range opened with
:meth:`push_annotation`, in a ``torch.profiler.record_function`` — a user
annotation in a ``torch.profiler`` trace — and, where CUDA is available,
an NVTX range, so the spans line up with the kernels in a profiler or
Nsight timeline.
"""
from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

# stable tid per category → one named row per subsystem in Perfetto
_CATEGORY_TIDS = {"iteration": 1, "phase": 2, "offload": 3, "serving": 4,
                  "bench": 5, "misc": 9}


@dataclass
class Span:
    name: str
    cat: str
    ts_us: float                 # start, whole µs since tracer epoch
    dur_us: float = 0.0          # whole µs
    depth: int = 0
    args: Dict[str, Any] = field(default_factory=dict)

    def record(self) -> dict:
        return {"type": "span", "name": self.name, "cat": self.cat,
                "ts_us": round(self.ts_us, 1), "dur_us": round(self.dur_us, 1),
                "depth": self.depth, "args": self.args}


class SpanTracer:
    def __init__(self, *, annotate: bool = False):
        self.t0_wall = time.time()           # epoch anchor for export
        self._t0_ns = time.perf_counter_ns()
        self.spans: List[Span] = []          # finished, in completion order
        self.instants: List[dict] = []
        self.samples: List[dict] = []        # counter-track samples
        self._stack: List[Span] = []
        self._annotations: List[Any] = []
        self.annotate = annotate
        self._nvtx = annotate and torch.cuda.is_available()
        self.self_time_s = 0.0

    # ------------------------------------------------------------- clock
    def now_us(self) -> float:
        """Whole µs since the tracer's epoch, as a float (exact: see the
        module's note)."""
        return float((time.perf_counter_ns() - self._t0_ns) // 1000)

    @property
    def depth(self) -> int:
        return len(self._stack)

    # ----------------------------------------------------------- recording
    def begin(self, name: str, cat: str = "misc", **args) -> Span:
        t = time.perf_counter()
        sp = Span(name, cat, self.now_us(), depth=len(self._stack),
                  args=dict(args))
        self._stack.append(sp)
        if self.annotate:
            self._annotations.append(self._enter_annotation(name))
        self.self_time_s += time.perf_counter() - t
        return sp

    def end(self, **args) -> Span:
        t = time.perf_counter()
        assert self._stack, "SpanTracer.end() with no open span"
        sp = self._stack.pop()
        if self.annotate and self._annotations:
            self._exit_annotation(self._annotations.pop())
        sp.dur_us = self.now_us() - sp.ts_us
        sp.args.update(args)
        self.spans.append(sp)
        self.self_time_s += time.perf_counter() - t
        return sp

    @contextmanager
    def span(self, name: str, cat: str = "misc", **args):
        sp = self.begin(name, cat, **args)
        try:
            yield sp
        finally:
            self.end()

    def complete(self, name: str, cat: str, ts_us: float, dur_us: float,
                 **args) -> Span:
        """Add a retroactive span: the interval ``[ts_us, ts_us+dur_us]``
        is already over (phase boundaries delimit phases after the fact).
        Nesting depth is the current stack depth — a completed phase sits
        under whatever parent span is open."""
        t = time.perf_counter()
        sp = Span(name, cat, ts_us, dur_us, depth=len(self._stack),
                  args=dict(args))
        self.spans.append(sp)
        self.self_time_s += time.perf_counter() - t
        return sp

    def instant(self, name: str, cat: str = "misc", **args) -> None:
        t = time.perf_counter()
        self.instants.append({"type": "instant", "name": name, "cat": cat,
                              "ts_us": round(self.now_us(), 1),
                              "args": dict(args)})
        self.self_time_s += time.perf_counter() - t

    def sample(self, track: str, values: Dict[str, float],
               ts_us: Optional[float] = None) -> None:
        """One point on a counter track (Perfetto area chart) — e.g.
        ``sample("memory", {"device_mib": ..., "host_mib": ...})``."""
        t = time.perf_counter()
        self.samples.append({"type": "sample", "track": track,
                             "ts_us": round(ts_us if ts_us is not None
                                            else self.now_us(), 1),
                             "values": {k: float(v)
                                        for k, v in values.items()}})
        self.self_time_s += time.perf_counter() - t

    # ------------------------------------------------ torch.profiler bridge
    def push_annotation(self, name: str) -> None:
        """Open a profiler annotation (and NVTX range) with no span of its
        own: for an interval recorded later with :meth:`complete`, such as
        a phase, whose end is the next boundary. No-op unless
        ``annotate``."""
        if self.annotate:
            t = time.perf_counter()
            self._annotations.append(self._enter_annotation(name))
            self.self_time_s += time.perf_counter() - t

    def pop_annotation(self) -> None:
        """Close the innermost range :meth:`push_annotation` opened."""
        if self.annotate and self._annotations:
            t = time.perf_counter()
            self._exit_annotation(self._annotations.pop())
            self.self_time_s += time.perf_counter() - t

    def _enter_annotation(self, name: str):
        rf = torch.profiler.record_function(name)
        rf.__enter__()
        if self._nvtx:
            torch.cuda.nvtx.range_push(name)
        return rf

    def _exit_annotation(self, rf) -> None:
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        rf.__exit__(None, None, None)

    # -------------------------------------------------------------- export
    def overhead_fraction(self, wall_s: float) -> float:
        """Telemetry self-time as a fraction of ``wall_s``."""
        return self.self_time_s / wall_s if wall_s > 0 else 0.0

    @staticmethod
    def _tid(cat: str) -> int:
        return _CATEGORY_TIDS.get(cat, _CATEGORY_TIDS["misc"])

    def chrome_trace(self) -> dict:
        """Trace Event Format dict (Perfetto / chrome://tracing)."""
        pid = os.getpid()
        ev: List[dict] = [
            {"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
             "args": {"name": "repro-telemetry"}}]
        cats = {sp.cat for sp in self.spans}
        cats |= {i["cat"] for i in self.instants}
        for cat in sorted(cats, key=self._tid):
            ev.append({"ph": "M", "pid": pid, "tid": self._tid(cat),
                       "name": "thread_name", "args": {"name": cat}})
        for sp in self.spans:
            ev.append({"ph": "X", "pid": pid, "tid": self._tid(sp.cat),
                       "name": sp.name, "cat": sp.cat,
                       "ts": round(sp.ts_us, 1),
                       "dur": round(max(sp.dur_us, 0.1), 1),
                       "args": sp.args})
        for it in self.instants:
            ev.append({"ph": "i", "pid": pid, "tid": self._tid(it["cat"]),
                       "name": it["name"], "cat": it["cat"],
                       "ts": it["ts_us"], "s": "t", "args": it["args"]})
        for sm in self.samples:
            ev.append({"ph": "C", "pid": pid, "tid": 0, "name": sm["track"],
                       "ts": sm["ts_us"], "args": sm["values"]})
        return {"traceEvents": ev, "displayTimeUnit": "ms",
                "otherData": {"t0_wall": self.t0_wall,
                              "self_time_s": round(self.self_time_s, 6)}}

    def write_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path

    def records(self) -> List[dict]:
        """All spans/instants/samples as JSONL-ready dicts, time-ordered."""
        out = [sp.record() for sp in self.spans]
        out.extend(self.instants)
        out.extend(self.samples)
        out.sort(key=lambda r: r["ts_us"])
        return out

    def write_jsonl(self, path_or_file) -> int:
        recs = self.records()
        if hasattr(path_or_file, "write"):
            for r in recs:
                path_or_file.write(json.dumps(r, sort_keys=True) + "\n")
        else:
            with open(path_or_file, "a") as f:
                for r in recs:
                    f.write(json.dumps(r, sort_keys=True) + "\n")
        return len(recs)
