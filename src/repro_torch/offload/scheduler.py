"""OffloadPlan / OffloadExecutor: the phase schedule of the offload
subsystem — the port of ``repro/offload/scheduler.py:44-211``.

``OffloadPlan`` is compiled from the runtime PPO phase sequence and the
per-state touch map of ``core.phases`` (``runtime_state_touches``).

``OffloadExecutor`` binds a plan to a :class:`~repro_torch.offload.
host_store.HostParkingLot` and a registry of *state accessors* — ``name ->
(get, set)`` closures owned by the trainer, whose ``set`` repoints every
alias of the tree. At each ``PhaseMemoryManager.boundary()`` the executor:

  1. **parks** every managed tree the next phase doesn't touch (before the
     boundary's gc/record, so the eviction shows in the live bytes);
  2. **fetches** the next phase's parked trees: all copies are started
     first (prefetch), then installed.

The one mid-phase event is hydra rollout: once ``merge_adapter`` has
folded A·B into a rollout copy of the trunk, the trunk's adapted leaves
are redundant until scoring — ``rollout_merged()`` parks them (the
``offload="all"`` level), and the rollout boundary fetches them back.

With ``telemetry=`` (``obs.RunTelemetry``) each boundary's park and
fetch close an ``offload`` span (``park:<phase>`` / ``fetch:<phase>``)
with the lot's byte and prefetch-hit deltas, feed the
``offload_{parked,fetched}_bytes_total`` counters and the
``offload_host_bytes`` gauge, and note the traffic to the run's flight
recorder, as the reference's ``:100-185`` do.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Tuple

from repro_torch.core.phases import (RUNTIME_RLHF_PHASE_SEQUENCE,
                                     runtime_state_touches)
from repro_torch.core.strategies import OFFLOAD_LEVELS, offload_managed_states
from repro_torch.offload.host_store import HostParkingLot, _flatten

# one PPO iteration as the trainer bounds it
RUNTIME_PHASE_SEQUENCE = RUNTIME_RLHF_PHASE_SEQUENCE

StateAccessor = Tuple[Callable[[], Any], Callable[[Any], None]]


@dataclass(frozen=True)
class OffloadPlan:
    """Which state trees must be device-resident during which phase, and
    which of them the chosen level swaps."""
    level: str
    engine: str
    sequence: Tuple[str, ...]
    required: Mapping[str, frozenset]     # phase -> state names it touches
    managed: frozenset                    # states the level parks off-phase

    @classmethod
    def compile(cls, level: str, *, engine: str = "hydra",
                states=None, frozen_unused=()) -> "OffloadPlan":
        """Compile the plan for an offload level. ``states`` (optional)
        restricts it to the state names the caller registers.
        ``frozen_unused`` names states the run never touches (e.g.
        ``reward_params`` when a programmatic ``reward_fn`` scores): they
        park at ``start()`` and are never fetched."""
        if level not in OFFLOAD_LEVELS:
            raise ValueError(f"unknown offload level {level!r}; "
                             f"expected one of {OFFLOAD_LEVELS}")
        touches = runtime_state_touches(engine)
        if states is not None:
            touches = {k: v for k, v in touches.items() if k in set(states)}
        touches.update({n: frozenset() for n in frozen_unused
                        if n in touches})
        required = {
            ph: frozenset(n for n, phs in touches.items() if ph in phs)
            for ph in RUNTIME_PHASE_SEQUENCE}
        managed = frozenset(offload_managed_states(level, touches))
        return cls(level=level, engine=engine,
                   sequence=RUNTIME_PHASE_SEQUENCE, required=required,
                   managed=managed)

    def next_phase(self, phase: str) -> str:
        i = self.sequence.index(phase)
        return self.sequence[(i + 1) % len(self.sequence)]

    def resident_for(self, phase: str) -> frozenset:
        """Managed states that must be on device during ``phase``."""
        return self.managed & self.required[phase]

    def evict_before(self, phase: str) -> frozenset:
        """Managed states ``phase`` does not touch (park candidates)."""
        return self.managed - self.required[phase]


class OffloadExecutor:
    """Drives a plan against the trainer's live state at phase boundaries.

    ``states`` maps each plan state name to ``(get, set)`` closures; ``set``
    must repoint *every* alias the trainer holds (train-state dict, engine
    views, ...) so no reference to a parked device tensor survives.
    """

    def __init__(self, plan: OffloadPlan, lot: HostParkingLot,
                 states: Dict[str, StateAccessor], *, telemetry=None):
        missing = plan.managed - set(states)
        if missing:
            raise ValueError(f"no accessor for managed states {missing}")
        self.plan = plan
        self.lot = lot
        self.states = states
        self.telemetry = telemetry          # obs.RunTelemetry | None

    # ------------------------------------------------------------ telemetry
    def _marks(self) -> Tuple[int, int, int]:
        st = self.lot.stats
        return (st.bytes_parked_total, st.bytes_fetched_total,
                st.n_prefetch_hits)

    def _emit(self, name: str, t0_us: float, parked0: int, fetched0: int,
              hits0: int) -> None:
        """One offload span + the PCIe traffic counters, measured as lot
        stats deltas across the park/fetch window (nothing recomputed)."""
        tel = self.telemetry
        st = self.lot.stats
        parked = st.bytes_parked_total - parked0
        fetched = st.bytes_fetched_total - fetched0
        tr = tel.tracer
        tr.complete(name, "offload", t0_us, tr.now_us() - t0_us,
                    parked_bytes=parked, fetched_bytes=fetched,
                    prefetch_hits=st.n_prefetch_hits - hits0,
                    host_bytes=st.parked_bytes)
        reg = tel.registry
        if parked:
            reg.counter("offload_parked_bytes_total",
                        "cumulative device->host park traffic").inc(parked)
        if fetched:
            reg.counter("offload_fetched_bytes_total",
                        "cumulative host->device fetch traffic").inc(fetched)
        reg.gauge("offload_host_bytes",
                  "bytes currently parked on host").set(st.parked_bytes)
        # flight-recorder context: a dump replays the recent park/fetch
        # traffic leading up to the breach
        fl = getattr(tel, "flight", None)
        if fl is not None:
            fl.note("offload", op=name, parked_bytes=parked,
                    fetched_bytes=fetched, host_bytes=st.parked_bytes)

    def start(self) -> None:
        """Initial placement: park everything the first phase (rollout)
        doesn't touch."""
        self._park_except(self.plan.sequence[0])

    def park_for_boundary(self, completed: str) -> None:
        """Boundary half 1 (before the record): evict managed trees the
        next phase doesn't touch."""
        if self.telemetry is None:
            self._park_except(self.plan.next_phase(completed))
            return
        t0, marks = self.telemetry.tracer.now_us(), self._marks()
        self._park_except(self.plan.next_phase(completed))
        self._emit(f"park:{completed}", t0, *marks)

    def fetch_for_boundary(self, completed: str) -> None:
        """Boundary half 2 (after the record): bring the next phase's
        parked trees back — every copy started first, back to back, then
        each installed as a prefetch hit."""
        nxt = self.plan.next_phase(completed)
        names = [n for n in sorted(self.plan.resident_for(nxt))
                 if n in self.lot]
        if self.telemetry is not None:
            t0, marks = self.telemetry.tracer.now_us(), self._marks()
        for name in names:
            self.lot.prefetch(name)
        for name in names:
            self.states[name][1](self.lot.fetch(name))
        if self.telemetry is not None:
            self._emit(f"fetch:{nxt}", t0, *marks)

    def rollout_merged(self) -> None:
        """Hydra mid-rollout hook: the merged rollout weights now carry the
        adapted leaves, so the trunk's own copies are phase-dead — park
        them (level "all"; no-op otherwise). Their fetch rides the rollout
        boundary like any other state."""
        if "base_params" in self.plan.managed and \
                "base_params" not in self.lot:
            get, set_ = self.states["base_params"]
            self.lot.park("base_params", get())
            set_(self.lot.peek("base_params"))

    def adopt_parked(self, name: str, host_tree) -> None:
        """Install a host-resident tree directly into the lot (a restore
        that lands on the host) and point the state at it. Its leaves
        require grad on fetch where the state's did."""
        if name in self.lot:
            flags = self.lot.requires_grad(name)
            self.lot.discard(name)        # replace a stale parked copy
        else:
            flags = [getattr(x, "requires_grad", False)
                     for x in _flatten(self.states[name][0]())[0]]
        self.lot.adopt(name, host_tree, requires_grad=flags)
        self.states[name][1](self.lot.peek(name))

    def _park_except(self, phase: str) -> None:
        for name in sorted(self.plan.evict_before(phase)):
            if name not in self.lot:
                get, set_ = self.states[name]
                self.lot.park(name, get())
                # leave the host view installed: the fetch repoints it
                set_(self.lot.peek(name))
