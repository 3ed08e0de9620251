"""The decode step as a CUDA graph, captured once per rollout — the port's
counterpart of the reference's jitted decode step
(``repro/rlhf/rollout.py:178-188, 208-218``: ``jax.jit(decode,
donate_argnums=(1,))``).

:class:`DecodeGraph` holds the step's static inputs — the token [B]
int64, the position [B] int32 and, on the paged backend, the block table
[B, nb] int32 — and the step's body (``Model.decode_step`` or
``Model.paged_decode_step``, unchanged), which writes the caches or pools
in place and covers every kernel of the step (B1, B3 or B4) and the
cuBLAS products. Its output is the step's logits [B, V]. Sampling, the
EOS mask, the page manager, CoW page copies and the block-table write
stay outside, in ``rlhf/rollout.py``, so the sampled stream is the eager
one.

On the card the first call runs the step eagerly on the stream that will
capture it (which loads every kernel and ctypes entry, builds what is
still unbuilt and sets cuBLAS up on that stream), then captures it,
which records and runs nothing, so no cache or Mamba state is written
twice. It captures only where a replay follows: a call of fewer than two
decode steps runs them eagerly, since a capture costs about two eager
steps. Every later call writes the static inputs and replays the graph,
whose logits land in one static buffer. There is no fallback: a capture
or a replay that fails raises (after setting right the default CUDA
generator, which a failed capture leaves marked as capturing). The graph
bakes in the addresses of the weights, the caches and the pools, which
each ``generate`` call makes anew (a prefill's caches, hydra's merged
weights, offload's fetched trees), so it lives for one call:
:meth:`DecodeGraph.release` frees it and its private memory pool with
the caches, before the phase boundary's ``empty_cache``. On the CPU,
where CUDA graphs do not exist, the same static-buffer loop runs the
body every step, as the kernels take their plain versions there.

The continuous batcher (``serving/scheduler.py``) keeps one graph per
decode shape for its whole life instead: :meth:`DecodeGraph.rows` takes a
position per row (idle and pad rows at -1), and ``pool`` lets the
batcher's graphs share one memory pool (``torch.cuda.graph_pool_handle``),
since they replay one at a time on one stream and each keeps its outputs.

Launch counts: a capture counts nothing (``ops.capturing``) and each
replay adds what the capture recorded (``ops.add_launches``), so
``ops.launches`` after a graphed run equals the eager run's.

:class:`SpecGraph` is the same for the speculative-decode step (the
counterpart of the reference's jitted ``_spec``,
``repro/rlhf/rollout.py:190-199, 226-233``): MTP drafts, the T-token
verify forward and the greedy accept, over static buffers for the trunk
state ``h_last`` [B, D], the token [B], the per-row positions [B] and
``live`` [B] (and the paged block table), with the step's outputs
(greedy tokens, their log-probs, accepted counts and the new trunk state)
in static buffers the host reads each step.
"""
from __future__ import annotations

import functools
import gc
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import ops


@functools.lru_cache(maxsize=None)
def capture_stream(device_index: int) -> "torch.cuda.Stream":
    """The one stream each card's decode steps are captured on, for the
    life of the process. cuBLAS keeps a workspace for every stream it has
    run on (allocated at its first product there, never freed), so one
    capture stream costs one workspace, where a fresh stream a call would
    cost one a call."""
    return torch.cuda.Stream(torch.device("cuda", device_index))


def _capture(graph: "torch.cuda.CUDAGraph", fn: Callable[[], torch.Tensor],
             pool=None) -> torch.Tensor:
    """Capture ``fn`` into ``graph`` on the current stream; returns its
    output (in the graph's private pool, or in ``pool`` when one is
    given). A capture that fails is ended before its error propagates."""
    graph.capture_begin(pool=pool)
    try:
        out = fn()
    except BaseException:
        _end_capture(graph, strict=False)
        raise
    _end_capture(graph, strict=True)
    return out


def _end_capture(graph: "torch.cuda.CUDAGraph", *, strict: bool) -> None:
    """End a capture. Where it fails, PyTorch skips its capture epilogue,
    which leaves the default CUDA generator marked as capturing, so every
    later draw from it would raise; one capture that succeeds runs the
    epilogue and sets it right. ``strict`` re-raises the failure."""
    try:
        graph.capture_end()
    except RuntimeError:
        mend = torch.cuda.CUDAGraph()
        mend.capture_begin()
        torch.zeros(1, device="cuda")
        mend.capture_end()
        mend.reset()
        if strict:
            raise


def _tensors(out) -> Sequence[torch.Tensor]:
    return (out,) if isinstance(out, torch.Tensor) else tuple(out)


class DecodeGraph:
    """One rollout's decode step over static inputs (see the module's
    note). ``body(token, position[, table]) -> logits`` closes over the
    weights and the caches or pools; ``table_blocks`` > 0 adds the paged
    block table [batch, table_blocks]. ``capture=False`` (or a CPU
    ``device``, or ``steps`` < 2: no replay would follow the capture)
    runs the body every step on the same static buffers; ``steps`` is the
    number of calls the rollout will make. ``pool`` (a
    ``torch.cuda.graph_pool_handle()``) captures into a pool shared with
    other graphs. ``stats`` holds whether the step was graphed, the
    replays, the capture's host ms (synchronised) and the bytes the
    capture added to the allocator's reserve (its pool's growth)."""

    def __init__(self, body: Callable[..., torch.Tensor], batch: int,
                 device, *, steps: int, table_blocks: int = 0,
                 capture: bool = True, pool=None):
        dev = torch.device(device)
        self.token = torch.zeros(batch, dtype=torch.int64, device=dev)
        self.position = torch.zeros(batch, dtype=torch.int32, device=dev)
        self.table: Optional[torch.Tensor] = None if not table_blocks else \
            torch.full((batch, table_blocks), -1, dtype=torch.int32,
                       device=dev)
        self._body: Optional[Callable[..., torch.Tensor]] = body
        self._staging: Optional[torch.Tensor] = None
        self._copied: Optional["torch.cuda.Event"] = None
        self._graph: Optional["torch.cuda.CUDAGraph"] = None
        self._out = None      # the step's output(s), static on replay
        self._made: dict = {}
        self._pool = pool
        self.stats = {"graphed": capture and dev.type == "cuda"
                      and steps >= 2, "replays": 0, "capture_ms": None,
                      "pool_bytes": None}

    def _inputs(self) -> tuple:
        return (self.token, self.position) + \
            (() if self.table is None else (self.table,))

    def write_table(self, table: np.ndarray) -> None:
        """Write the block table into its static buffer, in place (the
        caller does so only on steps where it changed). On the card the
        rows go through a pinned staging buffer, copied without blocking;
        before rewriting the staging buffer the host waits on the event of
        the previous copy out of it, so it never writes under an
        unfinished copy."""
        src = torch.from_numpy(table)
        if self.table.device.type != "cuda":
            self.table.copy_(src)
            return
        if self._staging is None:
            self._staging = torch.empty(self.table.shape, dtype=torch.int32,
                                        pin_memory=True)
            self._copied = torch.cuda.Event()
        else:
            self._copied.synchronize()
        self._staging.copy_(src)
        self.table.copy_(self._staging, non_blocking=True)
        self._copied.record()

    def __call__(self, token: torch.Tensor, position: int) -> torch.Tensor:
        """One decode step of ``token`` [B] at ``position`` -> logits [B, V].
        A replay's logits are the static buffer, rewritten by the next
        replay: read them (sample) before calling again."""
        self.token.copy_(token)
        self.position.fill_(position)
        return self._run()

    def rows(self, token: torch.Tensor, position: torch.Tensor
             ) -> torch.Tensor:
        """One decode step with a position per row: ``token`` [B] and
        ``position`` [B] int32 (-1: an idle row, whose paged write is
        dropped) -> logits [B, V], as :meth:`__call__`."""
        self.token.copy_(token)
        self.position.copy_(position)
        return self._run()

    def _run(self):
        """The step on the static inputs as they stand: the body (eager),
        step 1 and the capture, or a replay."""
        if not self.stats["graphed"]:
            return self._body(*self._inputs())
        if self._graph is None:
            return self._first()
        self._graph.replay()
        ops.add_launches(self._made)
        self.stats["replays"] += 1
        return self._out

    def _first(self):
        """Step 1 eagerly on the capturing stream, then the capture."""
        dev = self.token.device
        index = torch.cuda.current_device() if dev.index is None else dev.index
        main = torch.cuda.current_stream(dev)
        side = capture_stream(index)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self._body(*self._inputs())
        side.synchronize()
        reserved = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        # no cyclic collection inside the capture: a collected object
        # holding another graph would reset it, which CUDA forbids while
        # a stream captures, and which invalidates this capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(side), ops.capturing() as made:
                self._out = _capture(graph, lambda: self._body(
                    *self._inputs()), self._pool)
        finally:
            if collecting:
                gc.enable()
        side.synchronize()
        self.stats["capture_ms"] = (time.perf_counter() - t0) * 1e3
        self.stats["pool_bytes"] = torch.cuda.memory_reserved(dev) - reserved
        self._graph, self._made = graph, made
        main.wait_stream(side)
        for t in _tensors(out):
            t.record_stream(main)
        return out

    def release(self) -> dict:
        """Drop the graph, its private pool, the static buffers and the
        body (and with it the weights and caches it closes over); returns
        ``stats``."""
        self._body = self._out = None
        if self._graph is not None:
            self._graph.reset()
            self._graph = None
        self.token = self.position = self.table = self._staging = None
        self._copied = None
        return self.stats


class SpecGraph(DecodeGraph):
    """One rollout's speculative-decode step over static inputs (see the
    module's note). ``body(h_last, token, position, live[, table]) ->
    (greedy [B, k+1], logp [B, k+1], n_acc [B], h_new [B, D])`` closes
    over the weights, the caches or pools and the draft depth; ``width``
    and ``dtype`` are the trunk state's. ``position`` here is per row
    (int32 [B]), ``live`` bool [B]. ``steps`` is the least number of
    calls the rollout will make (every call emits at most k+1 tokens a
    row)."""

    def __init__(self, body: Callable[..., tuple], batch: int, device, *,
                 width: int, dtype, steps: int, table_blocks: int = 0,
                 capture: bool = True, pool=None):
        super().__init__(body, batch, device, steps=steps,
                         table_blocks=table_blocks, capture=capture,
                         pool=pool)
        dev = self.token.device
        self.h_last = torch.zeros((batch, width), dtype=dtype, device=dev)
        self.live = torch.zeros(batch, dtype=torch.bool, device=dev)

    def _inputs(self) -> tuple:
        return (self.h_last, self.token, self.position, self.live) + \
            (() if self.table is None else (self.table,))

    def __call__(self, token: torch.Tensor, position: torch.Tensor,
                 live: torch.Tensor) -> tuple:
        """One draft + verify + accept step from the state in ``h_last``
        (the caller writes it: the prefill's, then each step's ``h_new``).
        A replay's outputs are static buffers, rewritten by the next
        replay: read them before calling again."""
        self.token.copy_(token)
        self.position.copy_(position)
        self.live.copy_(live)
        return self._run()

    def release(self) -> dict:
        self.h_last = self.live = None
        return super().release()
