"""OOM flight recorder — the port of ``repro/obs/flight.py``.

A crash dump for memory: :class:`FlightRecorder` keeps a bounded ring
buffer of recent context — phase spans, memory samples, offload park/fetch
events — and when device memory crosses a configurable watermark fraction
(or a ``torch.cuda.OutOfMemoryError`` is caught in flight), it dumps a
forensic JSON bundle: who owned how many bytes (from the attribution
snapshot), the top-k live buffers with owner paths, and the phase history
leading up to the breach. The bundle's schema, trigger names and ring are
the reference's (``flight-recorder/v1``), so ``launch/report.py --flight``
renders the dumps of both packages.

Capacity resolution, in order:
  1. explicit ``capacity_bytes`` (tests, known budgets);
  2. the card's total memory, ``torch.cuda.mem_get_info(device)[1]``, when
     ``device`` is CUDA (or not given and a card is present);
  3. calibration fallback — the first ``check()`` latches its own live
     bytes as capacity, so a *forced* low watermark (< 1.0) still
     triggers on the CPU, which reports no limit. The trainer's CPU
     records count only its own tensors, so the latched figure does not
     depend on what else the process holds.

The recorder is a pure observer: it never frees, never retries, never
swallows the exception — ``record_oom`` captures and the caller
re-raises. Each trigger kind fires at most once per recorder (latched)
so a breached run doesn't dump on every subsequent boundary.
"""
from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import torch

__all__ = ["FlightRecorder"]

SCHEMA = "flight-recorder/v1"


def _device_bytes_limit(device=None) -> Optional[int]:
    """The card's total memory, or None off the card."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda")
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(device)[1])


class FlightRecorder:
    """Watermark-triggered forensic memory dump.

    Parameters
    ----------
    watermark : fraction of capacity at which ``check()`` trips.
    capacity_bytes : device budget; None -> the card's memory, else the
        calibration fallback described in the module docstring.
    ring : max retained context events (spans/samples/offload events).
    top_k : live buffers listed in the dump.
    path : when set, each dump is also written to ``path`` (a single
        trigger) or ``path`` with an index suffix for later triggers.
    device : the device the run measures (None: CUDA where present); a
        CPU run on a machine with a card passes ``"cpu"``.
    """

    def __init__(self, watermark: float = 0.92,
                 capacity_bytes: Optional[int] = None, ring: int = 256,
                 top_k: int = 10, path: Optional[str] = None, device=None):
        self.watermark = float(watermark)
        self.capacity_bytes = capacity_bytes if capacity_bytes \
            else _device_bytes_limit(device)
        self._calibrated = self.capacity_bytes is not None
        self.top_k = top_k
        self.path = path
        self.ring: deque = deque(maxlen=ring)
        self.phase_history: deque = deque(maxlen=64)
        self.dumps: List[dict] = []
        self.triggered: Dict[str, bool] = {}

    # ------------------------------------------------------------- context
    def note(self, event: str, **payload) -> None:
        """Push one context event into the ring (cheap; no walk)."""
        rec = {"event": event, "t": time.time()}
        rec.update(payload)
        self.ring.append(rec)
        if event == "phase":
            self.phase_history.append(
                {k: payload.get(k) for k in
                 ("phase", "live_bytes", "host_bytes") if k in payload})

    # ------------------------------------------------------------ triggers
    def check(self, live_bytes: int,
              snapshot_fn: Optional[Callable[[], Any]] = None,
              phase: Optional[str] = None, source: str = "") -> Optional[dict]:
        """Trip on ``live_bytes >= watermark * capacity``. The snapshot is
        taken lazily (only on a trigger) so the steady-state cost of a
        check is two comparisons."""
        if not self._calibrated:
            # CPU fallback: latch the first observation as the budget so a
            # forced watermark < 1.0 still has something to breach. The
            # calibration sample itself cannot breach (it IS the budget);
            # the next check that reaches watermark * this value trips.
            self.capacity_bytes = max(int(live_bytes), 1)
            self._calibrated = True
            return None
        if self.triggered.get("watermark"):
            return None
        if live_bytes < self.watermark * self.capacity_bytes:
            return None
        self.triggered["watermark"] = True
        return self._dump("watermark", live_bytes=int(live_bytes),
                          snapshot_fn=snapshot_fn, phase=phase,
                          source=source)

    @staticmethod
    def is_oom(exc: BaseException) -> bool:
        """A CUDA out-of-memory error, by type (the message varies)."""
        return isinstance(exc, torch.cuda.OutOfMemoryError)

    def record_oom(self, exc: BaseException,
                   snapshot_fn: Optional[Callable[[], Any]] = None,
                   live_bytes: int = 0, phase: Optional[str] = None,
                   source: str = "") -> Optional[dict]:
        """Capture a dump for a caught out-of-memory error, under the
        reference's trigger name ``resource_exhausted``; ``error`` keeps
        the CUDA message. The caller re-raises; the recorder only
        observes."""
        if self.triggered.get("resource_exhausted"):
            return None
        self.triggered["resource_exhausted"] = True
        return self._dump("resource_exhausted", live_bytes=int(live_bytes),
                          snapshot_fn=snapshot_fn, phase=phase,
                          source=source,
                          error=f"{type(exc).__name__}: {exc}"[:2000])

    # ---------------------------------------------------------------- dump
    def _dump(self, trigger: str, *, live_bytes: int, snapshot_fn,
              phase: Optional[str], source: str,
              error: Optional[str] = None) -> dict:
        snap = None
        if snapshot_fn is not None:
            try:
                snap = snapshot_fn()
            except Exception:
                snap = None
        owners = dict(getattr(snap, "owners", {}) or {})
        owners = {k: v for k, v in owners.items() if v}
        bundle = {
            "schema": SCHEMA,
            "trigger": trigger,
            "t_wall": time.time(),
            "source": source,
            "phase": phase,
            "live_bytes": live_bytes,
            "capacity_bytes": self.capacity_bytes,
            "watermark": self.watermark,
            "owners": owners,
            "owners_ranked": [k for k, _ in sorted(owners.items(),
                                                   key=lambda kv: -kv[1])],
            "unattributed": int(getattr(snap, "unattributed", 0)),
            "host_owners": dict(getattr(snap, "host_owners", {}) or {}),
            "top_buffers": list(getattr(snap, "top_buffers",
                                        []) or [])[:self.top_k],
            "phase_history": list(self.phase_history),
            "ring": list(self.ring),
        }
        if error is not None:
            bundle["error"] = error
        self.dumps.append(bundle)
        if self.path:
            path = self.path if len(self.dumps) == 1 else \
                f"{self.path}.{len(self.dumps) - 1}"
            try:
                d = os.path.dirname(path)
                if d:
                    os.makedirs(d, exist_ok=True)
                with open(path, "w") as fh:
                    json.dump(bundle, fh, indent=1, default=str)
            except OSError:
                pass
        return bundle
