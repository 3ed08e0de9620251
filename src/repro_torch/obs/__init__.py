"""Unified runtime telemetry — the port of ``repro/obs``: one metrics
registry + one span tracer per run, written out as

  * a **JSONL** file — meta line, then every span/instant/memory sample,
    then the final metrics snapshot — that ``launch/report.py`` renders
    into a per-phase table and ASCII memory timeline with zero
    recomputation, and
  * a **Chrome-trace JSON** (Perfetto / ``chrome://tracing``) with one
    row per subsystem (phases, offload) and counter tracks for the live
    device/host-bytes timeline.

``RunTelemetry`` is the object the instrumented subsystems share:
``RLHFTrainer(..., telemetry=...)`` emits one span per runtime PPO phase
carrying measured bytes AND the traced allocator simulator's prediction
(the sim-vs-measured delta), with the per-owner attribution table;
``OffloadExecutor`` emits park/fetch spans with PCIe bytes;
``ContinuousBatcher(..., telemetry=...)`` one ``serve_step:<n>`` span a
step with the ``serving_*`` and ``paged_*`` metrics, its owners and each
compile-cache key's program memory; ZeRO's gathers count their bytes
into the global registry (``global_registry()``:
``sharding_gather_copy_bytes_total``) and the trainer's
(``sharding_step_gathered_bytes_total``). The files are the reference's,
key for key (DESIGN.md §4 has the span taxonomy and metric names).
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from repro_torch.obs.attribution import (AttributionSnapshot,
                                         MemoryAttributor,
                                         compiled_memory_stats,
                                         record_compiled_memory)
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, global_registry,
                                     set_global_registry)
from repro_torch.obs.tracer import Span, SpanTracer

__all__ = ["AttributionSnapshot", "Counter", "FlightRecorder", "Gauge",
           "Histogram", "MemoryAttributor", "MetricsRegistry", "RunTelemetry",
           "Span", "SpanTracer", "compiled_memory_stats", "global_registry",
           "record_compiled_memory", "set_global_registry"]


@dataclass
class RunTelemetry:
    """One run's telemetry bundle: a registry, a tracer, and run metadata.

    ``sim_delta=True`` asks the RLHF trainer to run the traced allocator
    simulator once (lazily, at the first ``train_step``) and attach the
    per-phase predicted bytes to every phase span — divergence between
    the analytic model and the measured run becomes a first-class metric.
    Setup cost is one-time and is excluded from the tracer's self-time
    accounting.
    """
    registry: MetricsRegistry = field(default_factory=MetricsRegistry)
    tracer: SpanTracer = field(default_factory=SpanTracer)
    sim_delta: bool = True
    meta: Dict[str, Any] = field(default_factory=dict)
    # Optional memory-attribution engine; the trainer creates one (and
    # registers its owner trees) when absent.
    attribution: Optional[MemoryAttributor] = None
    # Optional OOM flight recorder; shared by every subsystem on the run.
    flight: Optional[FlightRecorder] = None

    @classmethod
    def create(cls, *, sim_delta: bool = True, annotate: bool = False,
               registry: Optional[MetricsRegistry] = None,
               attribution: Optional[MemoryAttributor] = None,
               flight: Optional[FlightRecorder] = None,
               **meta) -> "RunTelemetry":
        return cls(registry=registry or MetricsRegistry(),
                   tracer=SpanTracer(annotate=annotate),
                   sim_delta=sim_delta, meta=dict(meta),
                   attribution=attribution, flight=flight)

    # ------------------------------------------------------------- export
    def write_jsonl(self, path: str) -> str:
        """The single-file run record ``launch/report.py`` consumes."""
        with open(path, "w") as f:
            f.write(json.dumps(
                {"type": "meta", "t0_wall": self.tracer.t0_wall,
                 "written": time.time(),
                 "self_time_s": round(self.tracer.self_time_s, 6),
                 **self.meta}, sort_keys=True) + "\n")
            self.tracer.write_jsonl(f)
            self.registry.write_jsonl(f)
        return path

    def write_chrome_trace(self, path: str) -> str:
        return self.tracer.write_chrome_trace(path)

    def write(self, jsonl_path: Optional[str] = None,
              trace_path: Optional[str] = None) -> None:
        if jsonl_path:
            self.write_jsonl(jsonl_path)
        if trace_path:
            self.write_chrome_trace(trace_path)
