"""MetricsRegistry: counters, gauges, and histograms with labels.

A copy of the JAX package's ``repro/obs/metrics.py`` (which imports no
JAX), kept here so the port imports nothing of ``repro``. The serving
launcher writes into a registry and a run snapshots it once at the end
(``snapshot()`` / ``write_jsonl()``); nothing is aggregated
out-of-process.

Design points:

  * **Cheap when hot.** ``inc``/``set``/``observe`` are a dict lookup and
    a float add — no locks beyond the GIL, no string formatting, no I/O.
  * **Labels are kwargs.** ``counter("x").inc(3, phase="rollout")`` keys
    a child series by the sorted label items. Unlabeled use keys the
    ``()`` series.
  * **Idempotent registration.** ``registry.counter("x")`` returns the
    existing instrument (same-kind check) so call sites don't coordinate.

JSONL schema (one line per series, the reference's format):

    {"type": "metric", "name": ..., "kind": "counter|gauge|histogram",
     "labels": {...}, "value": ...}                 # counter/gauge
    {"type": "metric", "name": ..., "kind": "histogram", "labels": {...},
     "count": n, "sum": s, "min": ..., "max": ..., "buckets": {"le": n}}
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


@dataclass
class _Metric:
    name: str
    help: str = ""

    kind = "abstract"

    def series(self) -> Iterable[Tuple[LabelKey, dict]]:  # pragma: no cover
        raise NotImplementedError


@dataclass
class Counter(_Metric):
    """Monotonically-increasing sum per label set."""
    values: Dict[LabelKey, float] = field(default_factory=dict)

    kind = "counter"

    def inc(self, v: float = 1.0, **labels) -> None:
        assert v >= 0, f"counter {self.name} cannot decrease (inc {v})"
        k = _label_key(labels)
        self.values[k] = self.values.get(k, 0.0) + v

    def value(self, **labels) -> float:
        return self.values.get(_label_key(labels), 0.0)

    def series(self):
        for k, v in self.values.items():
            yield k, {"value": v}


@dataclass
class Gauge(_Metric):
    """Last-written value per label set (plus the max ever seen, so peak
    residency/occupancy survives the final ``set`` of a drained pool)."""
    values: Dict[LabelKey, float] = field(default_factory=dict)
    peaks: Dict[LabelKey, float] = field(default_factory=dict)

    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        k = _label_key(labels)
        self.values[k] = float(v)
        if v > self.peaks.get(k, -math.inf):
            self.peaks[k] = float(v)

    def inc(self, v: float = 1.0, **labels) -> None:
        k = _label_key(labels)
        self.set(self.values.get(k, 0.0) + v, **dict(k))

    def value(self, **labels) -> float:
        return self.values.get(_label_key(labels), 0.0)

    def peak(self, **labels) -> float:
        return self.peaks.get(_label_key(labels), 0.0)

    def series(self):
        for k, v in self.values.items():
            yield k, {"value": v, "peak": self.peaks[k]}


# default: exponential, 1 us .. ~16 s when observing seconds
_DEFAULT_BUCKETS = tuple(1e-6 * 4 ** i for i in range(13))


@dataclass
class Histogram(_Metric):
    """Cumulative-bucket histogram (+count/sum/min/max) per label set."""
    buckets: Tuple[float, ...] = _DEFAULT_BUCKETS
    values: Dict[LabelKey, dict] = field(default_factory=dict)

    kind = "histogram"

    def observe(self, v: float, **labels) -> None:
        k = _label_key(labels)
        s = self.values.get(k)
        if s is None:
            s = self.values[k] = {
                "count": 0, "sum": 0.0, "min": math.inf, "max": -math.inf,
                "bucket_counts": [0] * (len(self.buckets) + 1)}
        s["count"] += 1
        s["sum"] += v
        s["min"] = min(s["min"], v)
        s["max"] = max(s["max"], v)
        for i, le in enumerate(self.buckets):
            if v <= le:
                s["bucket_counts"][i] += 1
                break
        else:
            s["bucket_counts"][-1] += 1               # +Inf bucket

    def summary(self, **labels) -> Optional[dict]:
        return self.values.get(_label_key(labels))

    def series(self):
        for k, s in self.values.items():
            cum, out = 0, {}
            for le, n in zip(self.buckets, s["bucket_counts"]):
                cum += n
                out[f"{le:g}"] = cum
            out["+Inf"] = s["count"]
            yield k, {"count": s["count"], "sum": s["sum"],
                      "min": s["min"], "max": s["max"], "buckets": out}


class MetricsRegistry:
    """Process-local instrument registry with an in-process pull API
    (:meth:`snapshot`) and a JSONL snapshot writer (:meth:`write_jsonl`)."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, cls, name: str, help: str, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name=name, help=help, **kw)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, requested {cls.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Tuple[float, ...]] = None) -> Histogram:
        if buckets is not None:
            return self._get(Histogram, name, help, buckets=tuple(buckets))
        return self._get(Histogram, name, help)

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def clear(self) -> None:
        self._metrics.clear()

    # --------------------------------------------------------------- export
    def snapshot(self) -> List[dict]:
        """One dict per (metric, label set) — the in-process pull API and
        exactly what :meth:`write_jsonl` serializes."""
        out = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            for key, payload in m.series():
                rec = {"type": "metric", "name": name, "kind": m.kind,
                       "labels": dict(key)}
                if m.help:
                    rec["help"] = m.help
                rec.update(payload)
                out.append(rec)
        return out

    def write_jsonl(self, path_or_file) -> int:
        """Append the snapshot as JSON lines; returns lines written."""
        recs = self.snapshot()
        if hasattr(path_or_file, "write"):
            for r in recs:
                path_or_file.write(json.dumps(r, sort_keys=True) + "\n")
        else:
            with open(path_or_file, "a") as f:
                for r in recs:
                    f.write(json.dumps(r, sort_keys=True) + "\n")
        return len(recs)
