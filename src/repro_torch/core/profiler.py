"""Memory profiler: replays RLHF phase traces through the caching-allocator
simulator under a (strategy, empty_cache policy) pair and reports the
paper's measurements — peak reserved / fragmentation / peak allocated,
per-phase timelines (Figure 1), and the modelled end-to-end time — the
port of ``repro/core/profiler.py``, term for term.

Realism notes (each maps to a paper observation):
  * inference-phase outputs (experience tensors, KV caches) stay live until
    the phase named by ``free_after`` completes — so training allocates on
    top of partially-occupied segments, the paper's §3.1 mechanism;
  * generation length varies per PPO iteration (sampling stops at EOS), so
    successive iterations have *different* allocation patterns — the
    "varying object sizes" of Appendix A;
  * the time model is max(flops/rate, weight-bytes/bandwidth) per phase plus
    cudaMalloc and empty_cache latencies — decode is bandwidth-bound. Its
    constants are the reference's, a 3090-class GPU's; they are no
    figure of the card the port runs on, whose own comparison passes its
    ``capacity`` (``torch.cuda.mem_get_info()[1]``).

empty_cache policies (paper §3.3): none | after_inference | after_training |
after_all.

The runtime-offload axis (``strategy.offload`` / the ``offload=`` kwarg, see
``repro_torch.offload``) is modelled at *phase granularity*: a managed
persistent buffer group is device-resident exactly during the phases that
touch it (``PersistentBuffers.required_by``). At each boundary, evicted
groups are freed **before** ``empty_cache`` runs (so their segments can
release — the order the runtime scheduler uses too) and the next phase's
groups are malloc'd after the boundary record. Swap traffic pays a
host-link term that overlaps phase compute: per phase, max(compute/HBM
time, swap time).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.allocator import CachingAllocator
from repro_torch.core.phases import PersistentBuffers, Phase
from repro_torch.core.strategies import MemoryStrategy, offload_managed_states

POLICIES = ("none", "after_inference", "after_training", "after_all")

# the reference's time model (DESIGN.md §1), kept term for term so the two
# packages give the same RunResult: a 3090-class GPU, not the H100 the
# port runs on
_FLOPS_RATE = 60e12            # sustained bf16 FLOP/s per GPU (3090-class)
_HBM_BW = 800e9                # B/s
_CUDA_MALLOC_MS = 0.75         # cudaMalloc/cudaFree latency
_EMPTY_CACHE_MS = 2.0          # empty_cache API call overhead
_PCIE_BW = 16e9                # B/s host<->device swap bandwidth


@dataclass
class PhaseRecord:
    name: str
    kind: str
    reserved_end: int
    allocated_end: int
    peak_reserved: int
    frag_end: int
    host_bytes: int = 0            # parked on host at phase end (offload)
    alloc_peak: int = 0            # peak live bytes *within* this phase
    # device-resident persistent groups -> modelled bytes at the boundary
    # record — the simulator's per-state ledger the runtime attribution
    # engine diffs its measured owner table against (per-owner sim deltas)
    state_bytes_end: Dict[str, int] = field(default_factory=dict)


@dataclass
class RunResult:
    strategy: str
    policy: str
    peak_reserved: int
    peak_allocated: int
    frag_at_peak: int
    max_frag: int
    n_cuda_malloc: int
    n_empty_cache: int
    time_s: float
    phase_records: List[PhaseRecord] = field(default_factory=list)
    timeline: List[Tuple[int, int, int]] = field(default_factory=list)
    offload: str = "none"
    peak_host_bytes: int = 0       # peak parked on host (offload)
    swapped_bytes: int = 0         # cumulative host<->device swap traffic
    ndp: int = 1                   # DP/ZeRO domain size the run modelled
    ntp: int = 1                   # TP domain size the run modelled

    def row(self) -> dict:
        GB = 1 << 30
        return {
            "strategy": self.strategy, "policy": self.policy,
            "reserved_gb": round(self.peak_reserved / GB, 2),
            "frag_gb": round(self.frag_at_peak / GB, 2),
            "allocated_gb": round(self.peak_allocated / GB, 2),
            "time_s": round(self.time_s, 2),
        }


def _should_empty(policy: str, phase_kind: str) -> bool:
    if policy == "after_all":
        return True
    if policy == "after_inference":
        return phase_kind == "inference"
    if policy == "after_training":
        return phase_kind == "training"
    return False


def run_iteration(plans, persistent: PersistentBuffers,
                  strategy: MemoryStrategy, policy: str = "none", *,
                  ndp: int = 4, ntp: int = 1,
                  trainable_fraction: float = 1.0,
                  capacity: int = 24 << 30,
                  timeline: bool = False,
                  offload: Optional[str] = None) -> RunResult:
    """Replay PPO iterations. ``plans`` is a list of phase lists — one per
    iteration (varying generation lengths) — or a single phase list.
    ``capacity`` models the device HBM (24 GB RTX-3090 for Table 1,
    80 GB A100 for Table 2). ``offload`` (default: ``strategy.offload``)
    selects the runtime-offload level; see the module docstring.

    ``ntp`` records the TP domain of the run being modelled. The per-tag
    *fractions* of a TP run come in through ``strategy.traced`` (built on
    the dp x tp mesh by ``strategies.traced_strategy`` when
    ``strategy.ntp > 1``); the closed-form fallback stays the paper's
    pure-DP model, so passing ``ntp`` without a traced strategy only
    labels the result."""
    if plans and isinstance(plans[0], Phase):
        plans = [plans]
    offload = offload if offload is not None else \
        getattr(strategy, "offload", "none")
    alloc = CachingAllocator(timeline=timeline, capacity=capacity)
    # persistent groups pass their state name through, so a traced strategy
    # (``strategies.traced_strategy``: per-device fractions from the real
    # sharded trees) applies its exact per-group fraction; trace-level
    # events fall back to the per-tag aggregate (or the closed-form 1/ndp)
    scale = lambda tag, state=None: strategy.scale(
        tag, ndp=ndp, trainable_fraction=trainable_fraction, state=state)

    # phase-scoped buffer groups: offload-managed role state + transients
    # (e.g. the hydra merged rollout weights); everything else is resident
    # for the whole run, exactly as before the offload axis existed
    managed = offload_managed_states(offload, persistent.buffers) \
        & set(persistent.required_by)
    scoped = managed | (set(persistent.transient) & set(persistent.buffers))
    resident: Dict[str, List[int]] = {}
    state_bytes: Dict[str, int] = {}
    swapped_total = 0
    peak_host = 0
    parked_now = 0

    def group_bytes(name: str) -> int:
        total = 0
        for nb, tag in persistent.buffers[name]:
            s = scale(tag, name)
            if s > 0 and nb * s >= 4096:
                total += int(nb * s)
        return total

    def group_malloc(name: str):
        hs = []
        for nb, tag in persistent.buffers[name]:
            s = scale(tag, name)
            if s > 0 and nb * s >= 4096:
                hs.append(alloc.malloc(int(nb * s)))
        resident[name] = hs

    def group_free(name: str):
        for h in resident.pop(name):
            alloc.free(h)

    for name in persistent.buffers:
        state_bytes[name] = group_bytes(name)
        if name not in scoped:
            group_malloc(name)

    # flattened schedule (across iterations) for next-phase lookups
    flat: List[Phase] = [ph for phases in plans for ph in phases]

    def needed(idx: int) -> frozenset:
        if idx >= len(flat):
            return frozenset()
        pname = flat[idx].name
        return frozenset(n for n in scoped
                         if pname in persistent.required_by.get(n, ()))

    # initial placement for the first phase (not counted as swap traffic);
    # managed groups not needed by it start out parked on host
    for n in needed(0):
        group_malloc(n)
    parked_now = sum(state_bytes[n] for n in managed if n not in resident)
    peak_host = parked_now

    total_time = 0.0
    n_empty = 0
    gi = 0
    records: List[PhaseRecord] = []
    for phases in plans:
        deferred: Dict[str, List[int]] = {}
        for ph in phases:
            alloc_peak = alloc.allocated
            for rep in range(ph.repeats):
                handle_map: Dict[int, int] = {}
                for op, vid, nb, tag in ph.trace.events:
                    size = int(nb * scale(tag))
                    if size < 512:
                        continue
                    if op == "alloc":
                        handle_map[vid] = alloc.malloc(size)
                        alloc_peak = max(alloc_peak, alloc.allocated)
                    else:
                        h = handle_map.pop(vid, None)
                        if h is not None:
                            alloc.free(h)
                leftovers = list(handle_map.values())
                if ph.free_after and rep == ph.repeats - 1:
                    deferred.setdefault(ph.free_after, []).extend(leftovers)
                else:
                    for h in leftovers:
                        alloc.free(h)
            # outputs scheduled to die after this phase
            for h in deferred.pop(ph.name, []):
                alloc.free(h)
            # boundary, offload half 1: park groups the next phase doesn't
            # touch (free BEFORE empty_cache so their segments can release)
            nxt = needed(gi + 1)
            boundary_swap = 0
            for n in [r for r in list(resident) if r in scoped and r not in nxt]:
                group_free(n)
                if n in managed:
                    boundary_swap += state_bytes[n]
                    parked_now += state_bytes[n]
            if _should_empty(policy, ph.kind):
                alloc.empty_cache()
                n_empty += 1
            peak_host = max(peak_host, parked_now)
            records.append(PhaseRecord(
                ph.name, ph.kind, alloc.reserved, alloc.allocated,
                alloc.stats.peak_reserved, alloc.fragmentation(),
                host_bytes=parked_now, alloc_peak=alloc_peak,
                state_bytes_end={n: state_bytes[n] for n in resident
                                 if state_bytes[n] > 0}))
            # boundary, offload half 2: fetch the next phase's groups (the
            # runtime starts these as async copies at the same point)
            for n in nxt - frozenset(resident):
                group_malloc(n)
                if n in managed:
                    boundary_swap += state_bytes[n]
                    parked_now -= state_bytes[n]
            swapped_total += boundary_swap
            # swap copies overlap phase compute (double-buffered prefetch)
            total_time += max(max(ph.flops / _FLOPS_RATE,
                                  ph.hbm_bytes / _HBM_BW),
                              boundary_swap / _PCIE_BW)
            gi += 1
        # anything still deferred dies at iteration end
        for hs in deferred.values():
            for h in hs:
                alloc.free(h)

    st = alloc.stats
    time_s = (total_time + st.n_cuda_malloc * _CUDA_MALLOC_MS / 1e3
              + (n_empty + st.n_forced_flush) * _EMPTY_CACHE_MS / 1e3)
    return RunResult(
        strategy=strategy.name, policy=policy,
        peak_reserved=st.peak_reserved, peak_allocated=st.peak_allocated,
        frag_at_peak=st.frag_at_peak, max_frag=st.max_frag,
        n_cuda_malloc=st.n_cuda_malloc, n_empty_cache=n_empty,
        time_s=time_s, phase_records=records,
        timeline=alloc.timeline if timeline else [],
        offload=offload, peak_host_bytes=peak_host,
        swapped_bytes=swapped_total, ndp=ndp, ntp=ntp)
