"""Continuous-batching serving scheduler with selectable KV-cache backends —
the port of ``repro/serving/scheduler.py``.

Two cache layouts behind one admit/decode/retire loop:

  * ``dense`` — a fixed pool of B slots over one ``[B, capacity]`` rolling
    cache per layer. Every slot reserves ``capacity`` tokens of KV however
    short its request. An admission prefills the request at batch 1 and
    copies that cache's row (``k``, ``v`` and ``pos``, or a Mamba layer's
    states) into its slot, in place.
  * ``paged`` — a global page pool (``repro_torch.paged``): slots hold
    block tables, pages are claimed as sequences grow and freed the step
    they retire, and admission is gated on free pages. When the pool runs
    dry mid-decode the youngest request is preempted (pages freed,
    request re-queued with its generated prefix for recompute).

One decode step serves all active slots either way; idle slots decode
into entries that are masked out (at their stale position on the dense
backend, at position -1, a dropped write, on the paged one).

On top of it, as in the reference: ``capture_buckets`` (prompts pad to a
prefill rung and are masked exactly by per-row ``lengths``; paged decode
batches pad to a live-slot rung ``[min(b, slots) for b in buckets] +
[slots]``; ``warmup`` runs every rung before traffic with dead writes
only), ``spec_decode`` (MTP self-speculative greedy decoding through
``rlhf.rollout.spec_verify_step``: draft ``spec_k`` tokens a slot, verify
them in one batched forward, accept the greedy-consistent prefix; the
paged backend grows each slot by ``spec_k + 1`` tokens first and
truncates after acceptance), ``prefix_cache`` (paged: every prefill goes
through ``Model.paged_prefill_suffix``, bucketed on the suffix, so a
hash hit and a cold prefill are one computation; ``update_params`` bumps
the pool's weight version), per-tenant weighted round-robin admission on
virtual time with aging, and telemetry (``serve_step:<n>`` spans,
``compile:`` and ``preempt:`` instants, the ``pages`` sample, the
``serving_*`` and ``paged_*`` metrics, the ``serving_params`` /
``kv_cache`` / ``kv_pool`` / ``spec_state`` owners, compiled memory per
compile-cache key, and the flight recorder's watermark check and OOM dump
on ``torch.cuda.OutOfMemoryError``).

**CUDA graphs.** Where the reference compiles one jitted program per
``CompileCache`` key, the port captures one CUDA graph per decode shape
(``rlhf/decode_graph.py``): the dense decode at ``slots`` rows, each paged
live-slot rung, and the spec step (``SpecGraph``) for each. A graph is
captured at its key's first call (``warmup``'s, or traffic's: a
post-warmup miss is a capture and counts as a recompile, as in the
reference) and replayed every later step. The graphs live as long as the
batcher, so they close over tensors that are only ever written in place:
the caches, the pools, the block tables (written through
``DecodeGraph.write_table`` on the steps where they change) and the
spec step's ``h_last``. Prefills, sampling and the EOS check stay eager,
outside the graphs. The batcher's graphs share one memory pool: they
replay one at a time on one stream, and each step reads its graph's
outputs before the next replay. A graph replays the weight addresses it
captured, so :meth:`ContinuousBatcher.update_params` drops every graph
and each key recaptures at its next call, on the new weights. Set
``ContinuousBatcher._graphs = False`` (on the class or an instance) to
run the same loop eagerly on the card, to hold the graphs against it; it
is not a fallback: a capture or replay that fails raises. On the CPU
nothing is captured.

Random draws come from one ``torch.Generator`` on the model's device,
seeded from ``seed``; the reference's ``jax.random`` stream differs, so
the two packages agree token for token only where decoding is greedy.

``mesh=`` (a ``ShardedContext`` or its ``DeviceMesh``) with a ``model``
axis above 1 serves tensor parallel, as the reference's ``mesh=``: the
construction, ``warmup`` and every ``step`` run under
``sharding.ctx.use_mesh``, ``params`` are the rank's Megatron cuts, the
dense caches and paged pools hold K/ntp KV heads a rank (so
``kv_reserved_bytes`` is a rank's), the page manager and the admission
order run the same on every rank, and sampling all-gathers the ``[B, V]``
rows it draws from (``rlhf.rollout.sample_token``), each rank drawing the
same token from the same seed. The decode steps then run eagerly: a gloo
collective stages through host memory and cannot be captured (capture
over NCCL waits for a machine with more than one card), and
``graphs=True`` under such a mesh raises. Speculative decoding and Mamba
layers under TP raise (ROADMAP A10c).
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from collections import OrderedDict, deque
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, check_token_inputs
from repro_torch.models import Model
from repro_torch.paged import (PageManager, PagePoolExhausted, copy_pages,
                               pool_token_bytes)
# the module, not its names: rlhf.rollout imports repro_torch.serving
from repro_torch.rlhf import rollout as RO
from repro_torch.rlhf.decode_graph import DecodeGraph, SpecGraph
from repro_torch.serving.buckets import BucketLadder, CompileCache
from repro_torch.sharding import ctx as shctx
from repro_torch.sharding import tp as TP
from repro_torch.tree import leaves, nbytes


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # [P] int32
    max_new_tokens: int
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    n_preempted: int = 0
    t_submit: float = 0.0        # wall time at submit(); admission latency
    tenant: str = "default"
    step_submit: int = 0         # batcher step at submit(); aging clock
    n_cached_tokens: int = 0     # prompt tokens served from the prefix cache


class ContinuousBatcher:
    """The reference's batcher on the port's model (see the module's
    note). ``calls`` counts the programs run, warmup's included
    (``prefill``, ``decode``, ``spec``), from which a caller reckons the
    kernels' launches; ``n_captures`` counts graph captures."""

    # class-level switch read at each graph's creation; False runs the
    # decode steps eagerly on the card (to hold the graphs against it)
    _graphs = True

    def __init__(self, model: Model, cfg: ModelConfig, params, *,
                 slots: int = 4, capacity: int = 128,
                 temperature: float = 1.0, top_k: int = 0,
                 eos_id: Optional[int] = None, seed: int = 0,
                 cache_backend: str = "dense", page_size: int = 16,
                 num_pages: Optional[int] = None, telemetry=None,
                 capture_buckets: Optional[Sequence[int]] = None,
                 spec_decode: bool = False, spec_k: int = 2,
                 warmup: bool = True, prefix_cache: bool = False,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 aging: float = 1.0, mesh=None,
                 graphs: Optional[bool] = None):
        check_token_inputs(cfg, "ContinuousBatcher")
        if cache_backend not in ("dense", "paged"):
            raise ValueError(f"cache_backend must be dense or paged, got "
                             f"{cache_backend}")
        ntp = TP.degree(mesh)
        TP.check_supported(cfg, ntp, spec_decode=spec_decode)
        if ntp > 1 and graphs:
            raise TP.refuse_graphs()
        self.mesh, self.want_graphs = mesh, graphs
        self.tp = TP.resolve(mesh)
        if prefix_cache and cache_backend != "paged":
            raise ValueError("prefix caching needs the paged backend")
        self.model, self.cfg, self.params = model, cfg, params
        self.device = model.device
        self.telemetry = telemetry          # obs.RunTelemetry | None
        # memory observatory: owner registration, the run's flight
        # recorder, and compiled-memory stats joined to CompileCache keys
        self.flight = getattr(telemetry, "flight", None)
        self.attributor = None
        self.compiled_memory: dict = {}
        if telemetry is not None:
            self._init_attribution(telemetry)
        self.B, self.capacity = slots, capacity
        self.temperature, self.top_k, self.eos_id = temperature, top_k, eos_id
        self.backend = cache_backend
        self.prefix_cache = prefix_cache
        # per-tenant FIFO queues under weighted round-robin admission;
        # single-tenant traffic degenerates to one global FIFO
        self.queues: "OrderedDict[str, Deque[Request]]" = OrderedDict()
        self.tenant_weights: Dict[str, float] = dict(tenant_weights or {})
        self.aging = aging
        self._vtime: Dict[str, float] = {}
        self._prefix_tokens_hit = 0
        self._prefix_tokens_total = 0
        self.active: List[Optional[Request]] = [None] * slots
        self.pos = np.zeros(slots, np.int64)        # next absolute position
        self.last_tok = np.zeros(slots, np.int64)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.steps = 0
        self._next_rid = 0
        self.calls = {"prefill": 0, "decode": 0, "spec": 0}
        self.n_captures = 0
        self.graphs: Dict[tuple, DecodeGraph] = {}
        self._tables: Dict[tuple, np.ndarray] = {}  # last table written
        self._graph_pool = None
        cache_dtype = params["embed"].dtype

        # compile-bucket ladders + compile-cache accounting
        self.compile_cache = CompileCache()
        self.prefill_ladder = (BucketLadder(capture_buckets)
                               if capture_buckets else None)
        self.slot_ladder = None
        if capture_buckets and cache_backend == "paged":
            # live-slot rungs clipped to the slot count (the dense rows
            # cannot be subset: its decode stays full-B)
            self.slot_ladder = BucketLadder(
                [min(b, slots) for b in capture_buckets] + [slots])

        self.spec_decode, self.spec_k = spec_decode, spec_k
        self.h_last = None
        if spec_decode:
            if not model.supports_spec_decode():
                raise ValueError("spec decode needs a token-input "
                                 "attention-only model with mtp_depth > 0")
            if temperature > 0.0 or top_k:
                raise ValueError("spec decode is greedy-only "
                                 "(temperature=0, top_k=0)")
            self.h_last = torch.zeros((slots, cfg.d_model), dtype=cache_dtype,
                                      device=self.device)

        self.caches = self.pools = self.pm = None
        with shctx.use_mesh(self.tp):       # a rank's K/ntp heads under TP
            self._init_kv(model, cfg, slots, capacity, cache_backend,
                          page_size, num_pages, cache_dtype)
        if warmup and self.prefill_ladder is not None:
            self.warmup()

    def _init_kv(self, model, cfg, slots, capacity, cache_backend,
                 page_size, num_pages, cache_dtype) -> None:
        """The dense caches, or the page manager and its pools."""
        if cache_backend == "dense":
            self.caches = {"layers": model.init_cache(slots, capacity,
                                                      cache_dtype)}
            # the lengths-masked prefill needs attention layers; plain
            # traffic on a Mamba model keeps the unmasked prefill
            self._rich_prefill = self.prefill_ladder is not None or \
                self.spec_decode
        else:
            self.page_size = page_size
            self.max_blocks = -(-capacity // page_size)
            if num_pages is None:
                # default pool: what the dense layout would reserve
                num_pages = slots * self.max_blocks
            if num_pages < self.max_blocks:
                raise ValueError("pool smaller than one max-length sequence")
            self.pm = PageManager(
                num_pages, page_size,
                bytes_per_token=pool_token_bytes(cfg, cache_dtype)
                * cfg.num_layers)
            self.pools = model.init_paged_pools(num_pages, page_size,
                                                cache_dtype)

    # -- telemetry set-up ----------------------------------------------------
    def _init_attribution(self, telemetry) -> None:
        """Create (or adopt) the run's MemoryAttributor and register the
        batcher's owners; on the CPU its live set is the batcher's own
        tensors."""
        from repro_torch.obs import MemoryAttributor
        at = telemetry.attribution
        if at is None:
            at = telemetry.attribution = MemoryAttributor(device=self.device)
        elif at.device is None:
            at.device = self.device
        elif at.device.type != self.device.type:
            raise ValueError(f"the telemetry's attributor measures "
                             f"{at.device}, the batcher runs on "
                             f"{self.device}")
        if at.tracked is None:
            at.tracked = self._tracked
        at.register("serving_params", lambda: self.params)
        at.register("kv_cache", lambda: self.caches)
        at.register("kv_pool", lambda: self.pools)
        at.register("spec_state", lambda: self.h_last)
        self.attributor = at

    def _tracked(self) -> list:
        """The tensors the batcher holds: weights, caches or pools, the
        spec state and its graphs' static buffers."""
        graphs = [[g.token, g.position, g.table, getattr(g, "h_last", None),
                   getattr(g, "live", None)] for g in self.graphs.values()]
        return [self.params, self.caches, self.pools, self.h_last,
                [t for ts in graphs for t in ts if t is not None]]

    def _live_bytes(self) -> int:
        """``memory_allocated`` on the card; the batcher's own tensors on
        the CPU."""
        live = RO.live_device_bytes(self.device)
        return nbytes(self._tracked()) if live is None else live

    # -- programs -------------------------------------------------------------
    def _prefill_fn(self):
        """The backend's prefill as a function of its tensors -> (logits
        [1, V], the dense batch-of-1 caches or None, h_last [1, D] or
        None)."""
        m, cap = self.model, self.capacity
        if self.backend == "dense":
            if self._rich_prefill:
                def fn(params, batch, lens):
                    return m.prefill(params, batch, cap, lengths=lens,
                                     return_h=True)
            else:
                def fn(params, batch):
                    lg, caches = m.prefill(params, batch, cap)
                    return lg, caches, None
        elif self.prefix_cache:
            def fn(params, batch, pools, bt, start, lens):
                lg, _, h = m.paged_prefill_suffix(params, batch, pools, bt,
                                                  start, lens, return_h=True)
                return lg, None, h
        else:
            def fn(params, batch, pools, bt, lens):
                lg, _, h = m.paged_prefill(params, batch, pools, bt, lens,
                                           return_h=True)
                return lg, None, h
        return fn

    def _decode_fn(self):
        """The backend's decode (or spec) step as a function of all its
        tensors: what a graph captures and ``record_compiled_memory``
        traces."""
        m, k = self.model, self.spec_k
        if self.backend == "dense" and self.spec_decode:
            def fn(params, caches, h, tok, pos, live):
                return RO.spec_verify_step(
                    m, k, lambda seq, positions: m.decode_multi(
                        params, caches, seq, positions)[:2],
                    params, h, tok, pos, live)
        elif self.backend == "dense":
            def fn(params, caches, tok, pos):
                return m.decode_step(params, caches, tok, pos)[0]
        elif self.spec_decode:
            def fn(params, pools, h, tok, pos, live, bt):
                return RO.spec_verify_step(
                    m, k, lambda seq, positions: m.paged_decode_multi(
                        params, pools, seq, positions, bt)[:2],
                    params, h, tok, pos, live)
        else:
            def fn(params, pools, tok, pos, bt):
                return m.paged_decode_step(params, pools, tok, pos, bt)[0]
        return fn

    def _kv(self):
        return self.caches if self.backend == "dense" else self.pools

    def _graph(self, nb: int) -> DecodeGraph:
        """The decode (or spec) step at ``nb`` rows, created at its key's
        first call: on the card that call runs the step eagerly and
        captures it, and every later call replays it."""
        key = self._decode_key(nb)
        g = self.graphs.get(key)
        if g is not None:
            return g
        fn, paged = self._decode_fn(), self.backend == "paged"
        capture = bool(self._graphs if self.want_graphs is None
                       else self.want_graphs) and self.tp is None
        kw = dict(steps=2, capture=capture,
                  table_blocks=self.max_blocks if paged else 0)
        if self.device.type == "cuda" and capture:
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            kw["pool"] = self._graph_pool
        # the body reads the weights at each eager call; a captured graph
        # keeps the addresses it saw (update_params drops the graphs). It
        # holds the batcher weakly: no cycle keeps a dead batcher's graphs
        # and pools alive until a collection
        me = weakref.ref(self)
        if self.spec_decode:
            g = SpecGraph(lambda h, tok, pos, live, *bt: fn(
                me().params, me()._kv(), h, tok, pos, live, *bt), nb,
                self.device, width=self.cfg.d_model, dtype=self.h_last.dtype,
                **kw)
        else:
            g = DecodeGraph(lambda tok, pos, *bt: fn(
                me().params, me()._kv(), tok, pos, *bt), nb, self.device,
                **kw)
        if g.stats["graphed"]:
            self.n_captures += 1
        self.graphs[key] = g
        return g

    def _write_table(self, g: DecodeGraph, nb: int,
                     sids: Sequence[Optional[int]]) -> None:
        """Write graph ``g``'s block table, only where it changed since
        the table last written into it."""
        key = self._decode_key(nb)
        table = self.pm.block_table_array(sids, self.max_blocks)
        last = self._tables.get(key)
        if last is None or not np.array_equal(last, table):
            g.write_table(table)
            self._tables[key] = table

    def graph_stats(self) -> Dict[str, dict]:
        """Each live graph's ``stats`` (graphed, replays, capture ms, the
        bytes its capture added to the pool), by compile-cache key."""
        return {":".join(str(k) for k in key): dict(g.stats)
                for key, g in self.graphs.items()}

    def _drop_graphs(self) -> None:
        for g in self.graphs.values():
            g.release()
        self.graphs.clear()
        self._tables.clear()
        self._graph_pool = None

    # -- warmup capture -------------------------------------------------------
    def warmup(self, max_prompt_len: Optional[int] = None) -> None:
        """Run every ladder rung before traffic arrives: each prefill rung
        and each decode rung once, on the live caches with dead writes
        only (``lengths = 0``, ``position = -1``), so it must precede
        admission — as it does at construction, when both backends are
        empty. On the card each decode rung's graph is captured here.
        After this, any compile-cache miss is a recompile."""
        with shctx.use_mesh(self.tp):
            self._warmup(max_prompt_len)

    def _warmup(self, max_prompt_len: Optional[int]) -> None:
        cc = self.compile_cache
        dev = self.device
        pfn = self._prefill_fn()
        if self.prefill_ladder is not None:
            for Sb in self.prefill_ladder.up_to(
                    max_prompt_len or self.capacity):
                batch = {"tokens": torch.zeros((1, Sb), dtype=torch.long,
                                               device=dev)}
                lens = torch.zeros((1,), dtype=torch.int32, device=dev)
                if self.backend == "dense":
                    args = (self.params, batch, lens)
                else:
                    bt = torch.full((1, self.max_blocks), -1,
                                    dtype=torch.int32, device=dev)
                    start = torch.zeros((1,), dtype=torch.int32, device=dev)
                    args = (self.params, batch, self.pools, bt) + \
                        ((start, lens) if self.prefix_cache else (lens,))
                pfn(*args)
                self.calls["prefill"] += 1
                key = ("prefill", self.backend, Sb)
                cc.warm(key)
                self._note_compiled(key, pfn, *args)
        for nb in (self.slot_ladder.up_to(self.B)
                   if self.slot_ladder is not None else (self.B,)):
            if self.backend == "dense" and nb != self.B:
                continue                        # dense decode is full-B only
            tok = torch.zeros((nb,), dtype=torch.long)
            pos = torch.full((nb,), -1, dtype=torch.int32)
            live = torch.zeros((nb,), dtype=torch.bool)
            g = self._graph(nb)
            if self.backend == "paged":
                self._write_table(g, nb, [None] * nb)
            if self.spec_decode:
                g.h_last.zero_()
                g(tok, pos, live)
                self.calls["spec"] += 1
            else:
                g.rows(tok, pos)
                self.calls["decode"] += 1
            key = self._decode_key(nb)
            cc.warm(key)
            if self.telemetry is not None:
                self._note_compiled(key, self._decode_fn(),
                                    *self._decode_args(g))
        cc.finish_warmup()

    def _decode_args(self, g: DecodeGraph) -> tuple:
        """The decode program's arguments, on graph ``g``'s buffers."""
        table = () if g.table is None else (g.table,)
        if self.spec_decode:
            return (self.params, self._kv(), g.h_last, g.token, g.position,
                    g.live) + table
        return (self.params, self._kv(), g.token, g.position) + table

    def _decode_key(self, nb: int):
        kind = "spec" if self.spec_decode else "decode"
        extents = (nb, self.spec_k + 1) if self.spec_decode else (nb,)
        return (kind, self.backend) + extents

    def _note_compiled(self, key, fn, *args) -> None:
        """Join this CompileCache key with its program's memory stats (a
        ``meta`` trace, never executed: ``obs.record_compiled_memory``):
        temp/argument/output bytes land in the registry under
        ``program=<key>`` and in ``self.compiled_memory``. Under a TP
        mesh nothing is recorded: a ``meta`` trace cannot run the model
        group's collectives (the trainer skips its sharded programs
        likewise)."""
        if self.telemetry is None or self.tp is not None or \
                key in self.compiled_memory:
            return
        from repro_torch.obs import record_compiled_memory
        stats = record_compiled_memory(
            self.telemetry.registry, ":".join(str(k) for k in key),
            fn, *args)
        if stats is not None:
            self.compiled_memory[key] = stats

    def _record_key(self, key, fn=None, *args) -> None:
        hit = self.compile_cache.lookup(key)
        if self.telemetry is not None and not hit:
            self.telemetry.tracer.instant(
                f"compile:{':'.join(str(k) for k in key)}", "serving",
                recompile=self.compile_cache.warmed)
            # a post-warmup miss is a recompile: account its memory too
            if fn is not None:
                self._note_compiled(key, fn, *args)

    # -- traffic --------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int,
               tenant: str = "default") -> Request:
        prompt = np.asarray(prompt, np.int32)
        if self.backend == "paged" and \
                len(prompt) + max_new_tokens > self.capacity:
            # refuse up front: an unservable request must not reach _admit
            raise ValueError(
                f"request needs {len(prompt) + max_new_tokens} tokens, "
                f"capacity is {self.capacity}")
        req = Request(self._next_rid, prompt, max_new_tokens,
                      t_submit=time.perf_counter(), tenant=tenant,
                      step_submit=self.steps)
        self._next_rid += 1
        q = self.queues.get(tenant)
        if q is None:
            q = self.queues[tenant] = deque()
        if not q:
            # a tenant going from idle to backlogged re-enters at the
            # current service frontier: it must not bank idle time and
            # then monopolise admission catching up
            floor = min((self._vtime.get(t, 0.0)
                         for t, tq in self.queues.items()
                         if tq and t != tenant),
                        default=self._vtime.get(tenant, 0.0))
            self._vtime[tenant] = max(self._vtime.get(tenant, 0.0), floor)
        q.append(req)
        if self.telemetry is not None:
            self.telemetry.registry.counter(
                "serving_requests_total", "requests submitted").inc()
        return req

    @property
    def queue(self) -> List[Request]:
        """Flat view of all queued requests (oldest first), across tenants."""
        out = [r for q in self.queues.values() for r in q]
        out.sort(key=lambda r: r.rid)
        return out

    @property
    def n_queued(self) -> int:
        return sum(len(q) for q in self.queues.values())

    # -- paged helpers --------------------------------------------------------
    def _table_rows(self, sids: Sequence[Optional[int]]) -> torch.Tensor:
        return torch.from_numpy(
            self.pm.block_table_array(sids, self.max_blocks)).to(self.device)

    def _apply_copies(self, copies) -> None:
        """Perform CoW page copies on every layer's pool, in place."""
        if not copies:
            return
        src = [s for s, _ in copies]
        dst = [d for _, d in copies]
        for pool in self.pools:
            copy_pages(pool, src, dst)

    def _preempt_youngest(self, *, protect: Optional[int] = None) -> bool:
        """Free a victim request's pages and re-queue it; re-admission
        recomputes its prompt *plus* generated-so-far prefill (``prompt``
        itself is never mutated, so repeated preemption cannot duplicate
        tokens). The victim is the youngest active request; with the
        prefix cache on, the one holding the most *exclusively owned*
        pages (refcount 1), since shared prefix pages survive preemption
        and free nothing. Returns False if no victim is available."""
        victims = [s for s, r in enumerate(self.active)
                   if r is not None and s != protect]
        if not victims:
            return False
        if self.prefix_cache:
            s = max(victims, key=lambda s: (
                self.pm.reclaimable_pages(self.active[s].rid),
                self.active[s].rid))
        else:
            s = max(victims, key=lambda s: self.active[s].rid)
        req = self.active[s]
        self.pm.free_seq(req.rid)
        req.n_preempted += 1
        self.queues[req.tenant].appendleft(req)
        self.active[s] = None
        if self.telemetry is not None:
            self.telemetry.registry.counter(
                "serving_preemptions_total",
                "requests preempted on page-pool exhaustion").inc()
            self.telemetry.tracer.instant(
                f"preempt:r{req.rid}", "serving", rid=req.rid,
                n_preempted=req.n_preempted)
        return True

    # -- internals ------------------------------------------------------------
    def _pick_tenant(self) -> Optional[str]:
        """Weighted round-robin with anti-starvation aging: among
        backlogged tenants, pick the one minimising ``vtime[tenant] -
        aging * steps_waited`` for its queue head. Lowest virtual time
        wins, and every waiting head's score falls by ``aging`` a step, so
        no tenant starves whatever the weights. Ties break on the oldest
        request."""
        best, best_score = None, None
        for t, q in self.queues.items():
            if not q:
                continue
            score = (self._vtime.get(t, 0.0)
                     - self.aging * (self.steps - q[0].step_submit))
            if best is None or score < best_score or \
                    (score == best_score
                     and q[0].rid < self.queues[best][0].rid):
                best, best_score = t, score
        return best

    def _tokens(self, padded: np.ndarray) -> dict:
        return {"tokens": torch.from_numpy(padded.astype(np.int64))[None]
                .to(self.device)}

    def _scalar(self, v: int) -> torch.Tensor:
        return torch.full((1,), v, dtype=torch.int32, device=self.device)

    def _admit(self) -> None:
        pfn = self._prefill_fn()
        for s in range(self.B):
            if self.active[s] is not None:
                continue
            tenant = self._pick_tenant()
            if tenant is None:
                break
            req = self.queues[tenant][0]
            # recompute prefill: original prompt plus anything generated
            # before a preemption (empty for fresh requests)
            full = np.concatenate(
                [req.prompt, np.asarray(req.out_tokens, np.int32)])
            P = len(full)
            n_cached = 0
            if self.backend == "paged" and self.prefix_cache:
                # gate admission on pages for the non-cached tail + first
                # decode token; matched pages are reused, not claimed
                if not self.pm.can_allocate_prefix(full, 1):
                    break
                self.queues[tenant].popleft()
                _, n_cached = self.pm.allocate_prefix(req.rid, full)
                suffix = full[n_cached:]
                # bucket on the *suffix* length: a hash hit computes only
                # the tail
                Sb = self.prefill_ladder.fit(len(suffix)) \
                    if self.prefill_ladder else len(suffix)
                padded = np.zeros(Sb, np.int32)
                padded[:len(suffix)] = suffix
                args = (self.params, self._tokens(padded), self.pools,
                        self._table_rows([req.rid]), self._scalar(n_cached),
                        self._scalar(P))
                lg, _, h1 = pfn(*args)
                self.pm.commit_prefix(req.rid, full)
                self._prefix_tokens_hit += n_cached
                self._prefix_tokens_total += P
                req.n_cached_tokens = n_cached
            else:
                # pad the prompt up to its rung; the per-row ``lengths``
                # makes the padding exactly invisible
                Sb = self.prefill_ladder.fit(P) if self.prefill_ladder \
                    else P
                padded = np.zeros(Sb, np.int32)
                padded[:P] = full
                if self.backend == "paged":
                    # gate admission on pages for the prefill + first decode
                    if not self.pm.can_allocate(P + 1):
                        break
                    self.queues[tenant].popleft()
                    self.pm.allocate(req.rid, P)
                    args = (self.params, self._tokens(padded), self.pools,
                            self._table_rows([req.rid]), self._scalar(P))
                    lg, _, h1 = pfn(*args)
                else:
                    self.queues[tenant].popleft()
                    args = (self.params, self._tokens(padded))
                    if self._rich_prefill:
                        args += (self._scalar(P),)
                    lg, caches1, h1 = pfn(*args)
                    # slot s of the live cache from the batch-of-1 prefill,
                    # in place: its whole row, positions too, so the
                    # entries the idle slot decoded are dead
                    for c, c1 in zip(self.caches["layers"],
                                     caches1["layers"]):
                        for name, t in c.items():
                            t[s].copy_(c1[name][0])
                    del caches1
            self.calls["prefill"] += 1
            self._record_key(("prefill", self.backend, Sb), pfn, *args)
            # charge the tenant's virtual time for the service footprint it
            # just claimed (prompt + remaining generation budget)
            cost = P + req.max_new_tokens - len(req.out_tokens)
            self._vtime[tenant] = self._vtime.get(tenant, 0.0) \
                + cost / max(self.tenant_weights.get(tenant, 1.0), 1e-9)
            tok, _ = RO.sample_token(self.generator, lg,
                                  temperature=self.temperature,
                                  top_k=self.top_k)
            tok = int(tok[0])
            self.active[s] = req
            self.pos[s] = P
            self.last_tok[s] = tok
            req.out_tokens.append(tok)
            if self.spec_decode:
                self.h_last[s].copy_(h1[0])
            if self.telemetry is not None:
                reg = self.telemetry.registry
                reg.counter("serving_admissions_total",
                            "admissions incl. preemption re-admits").inc()
                if n_cached:
                    reg.counter(
                        "paged_prefix_hit_tokens_total",
                        "prompt tokens served from the prefix cache").inc(
                        n_cached)
                # latency only for first admission: a re-admit's wait is
                # a preemption artifact, not queueing delay
                if req.n_preempted == 0:
                    reg.histogram(
                        "serving_admission_latency_s",
                        "submit -> first admission wall time").observe(
                        time.perf_counter() - req.t_submit)

    def _retire(self) -> List[Request]:
        done = []
        for s, req in enumerate(self.active):
            if req is None:
                continue
            hit_eos = (self.eos_id is not None
                       and req.out_tokens
                       and req.out_tokens[-1] == self.eos_id)
            if hit_eos or len(req.out_tokens) >= req.max_new_tokens:
                req.done = True
                done.append(req)
                if self.backend == "paged":
                    self.pm.free_seq(req.rid)   # pages back to the pool
                self.active[s] = None           # slot freed
        return done

    def _grow_pages(self, n: int = 1) -> None:
        """Claim the page(s) each live slot's next ``n`` tokens will write
        (spec decode grows by ``spec_k + 1`` before the verify forward);
        preempt the youngest request when the pool is dry."""
        for s in range(self.B):
            req = self.active[s]
            if req is None:
                continue
            while True:
                try:
                    self._apply_copies(self.pm.append_tokens(req.rid, n))
                    break
                except PagePoolExhausted:
                    if not self._preempt_youngest(protect=s):
                        raise

    # -- decode flavours ------------------------------------------------------
    def _append_emitted(self, s: int, emitted_toks) -> int:
        """Append a run of emitted tokens to slot ``s``'s request, stopping
        at EOS or the request's token budget. Returns the count taken (the
        position advance). Any truncation here retires the slot this very
        step, so the cache's extra draft entries — masked by position until
        overwritten — are never observed."""
        req = self.active[s]
        taken = 0
        for tokv in emitted_toks:
            req.out_tokens.append(int(tokv))
            taken += 1
            if (self.eos_id is not None and int(tokv) == self.eos_id) or \
                    len(req.out_tokens) >= req.max_new_tokens:
                break
        self.pos[s] += taken
        self.last_tok[s] = req.out_tokens[-1]
        return taken

    def _vanilla_decode(self, live_slots: List[int]) -> None:
        sids = None
        if self.backend == "paged" and self.slot_ladder is not None:
            # gather live rows into a slot rung; pad rows are idle
            # (position -1: dropped writes, their tokens discarded)
            nb, rows = self.slot_ladder.fit(len(live_slots)), live_slots
            tok_in, pos_in, sids = self._rows_in(live_slots, nb)
        elif self.backend == "paged":
            nb, rows = self.B, range(self.B)
            tok_in, pos_in, sids = self._slot_rows()
        else:
            # idle slots decode at their stale position; admission
            # overwrites their whole row
            nb, rows = self.B, range(self.B)
            tok_in = torch.from_numpy(self.last_tok.copy())
            pos_in = torch.from_numpy(self.pos.astype(np.int32))
        self._record_key(self._decode_key(nb))
        g = self._graph(nb)
        if sids is not None:
            self._write_table(g, nb, sids)
        logits = g.rows(tok_in, pos_in)
        self.calls["decode"] += 1
        tok, _ = RO.sample_token(self.generator, logits,
                                 temperature=self.temperature,
                                 top_k=self.top_k)
        tok = tok.cpu().numpy()
        for j, s in enumerate(rows):
            if self.active[s] is not None:
                self._append_emitted(s, [tok[j]])

    def _rows_in(self, live_slots: List[int], nb: int):
        """(token [nb], position [nb] int32 with pad rows at -1, sids) for
        the live slots gathered into ``nb`` rows."""
        n = len(live_slots)
        tok_in = np.zeros(nb, np.int64)
        pos_in = np.full(nb, -1, np.int32)
        tok_in[:n] = self.last_tok[live_slots]
        pos_in[:n] = self.pos[live_slots]
        sids = [self.active[s].rid for s in live_slots] + [None] * (nb - n)
        return torch.from_numpy(tok_in), torch.from_numpy(pos_in), sids

    def _slot_rows(self):
        """(token [B], position [B] int32 with idle slots at -1, sids)
        over every slot, in slot order."""
        live = np.array([r is not None for r in self.active])
        pos_in = np.where(live, self.pos, -1).astype(np.int32)
        sids = [r.rid if r is not None else None for r in self.active]
        return (torch.from_numpy(self.last_tok.copy()),
                torch.from_numpy(pos_in), sids)

    def _spec_decode_step(self, live_slots: List[int]) -> None:
        """Draft + one batched verify + accept for all live slots."""
        n_live = len(live_slots)
        idx = torch.as_tensor(live_slots, device=self.device)
        if self.backend == "paged":
            nb = self.slot_ladder.fit(n_live) \
                if self.slot_ladder is not None else self.B
            tok_in, pos_in, sids = self._rows_in(live_slots, nb)
            live_v = torch.from_numpy(np.arange(nb) < n_live)
            self._record_key(self._decode_key(nb))
            g = self._graph(nb)
            self._write_table(g, nb, sids)
            g.h_last.zero_()
            g.h_last[:n_live].copy_(self.h_last[idx])
            rows = range(n_live)
        else:
            nb = self.B
            live = np.array([r is not None for r in self.active])
            tok_in = torch.from_numpy(self.last_tok.copy())
            pos_in = torch.from_numpy(np.where(live, self.pos, -1)
                                      .astype(np.int32))
            live_v = torch.from_numpy(live)
            self._record_key(self._decode_key(nb))
            g = self._graph(nb)
            g.h_last.copy_(self.h_last)
            rows = live_slots
        greedy, _lp, n_acc, h_new = g(tok_in, pos_in, live_v)
        self.calls["spec"] += 1
        # live rows of h_new are the trunk state at each slot's new last
        # accepted position; stale rows are refreshed at admission
        if self.backend == "paged":
            self.h_last[idx] = h_new[:n_live]
        else:
            self.h_last.copy_(h_new)
        greedy = greedy.cpu().numpy()
        n_acc_np = n_acc.cpu().numpy()
        reg = self.telemetry.registry if self.telemetry is not None else None
        for j, s in zip(rows, live_slots):
            pos_before = int(self.pos[s])
            take = int(n_acc_np[j]) + 1
            taken = self._append_emitted(s, greedy[j, :take])
            if self.backend == "paged":
                # drop the page claim for rejected (and untaken) drafts
                self.pm.truncate(self.active[s].rid, pos_before + taken)
            if reg is not None:
                reg.histogram(
                    "serving_specdec_accepted_len",
                    "accepted draft-prefix length per slot step").observe(
                    int(n_acc_np[j]))
                rejected = self.spec_k - int(n_acc_np[j])
                if rejected:
                    reg.counter(
                        "serving_specdec_drafts_rejected_total",
                        "draft tokens rejected by the verify step").inc(
                        rejected)

    def _emit_step(self, t0_us: float, n_tokens: int, n_done: int) -> None:
        """One ``serve_step`` span + the backend occupancy/throughput
        metrics, all read from state the step already maintains.
        ``n_tokens`` is a delta of per-request token counts, so bucket
        padding and idle decode rows never inflate tokens/s."""
        tel = self.telemetry
        tr = tel.tracer
        dur_us = tr.now_us() - t0_us
        cc = self.compile_cache
        args = {"tokens": n_tokens, "retired": n_done,
                "queued": self.n_queued,
                "active": sum(r is not None for r in self.active),
                "recompiles": cc.recompiles,
                "kv_reserved_bytes": self.kv_reserved_bytes()}
        reg = tel.registry
        if n_tokens:
            reg.counter("serving_tokens_total",
                        "tokens generated (prefill-sampled + decoded)").inc(
                n_tokens)
        if dur_us > 0:
            reg.gauge("serving_tokens_per_s",
                      "decode throughput of the last step").set(
                n_tokens / (dur_us * 1e-6))
        reg.gauge("serving_compile_cache_hit_rate",
                  "compile-cache hit rate over all program keys").set(
            cc.hit_rate)
        rec = reg.counter("serving_recompiles_total",
                          "post-warmup compile-cache misses (bucket escapes)")
        rec.inc(cc.recompiles - rec.value())
        if self.backend == "paged":
            st = self.pm.stats
            args.update(pages_in_use=st.pages_in_use,
                        cow_copies=st.n_cow_copies - self._cow_mark,
                        forks=st.n_forks - self._fork_mark)
            self._cow_mark, self._fork_mark = st.n_cow_copies, st.n_forks
            reg.gauge("paged_pages_in_use",
                      "pages currently allocated").set(st.pages_in_use)
            reg.gauge("paged_pages_free", "pages currently free").set(
                self.pm.num_pages - st.pages_in_use)
            cow = reg.counter("paged_cow_copies_total",
                              "copy-on-write page copies")
            cow.inc(st.n_cow_copies - cow.value())
            forks = reg.counter("paged_forks_total", "sequence forks")
            forks.inc(st.n_forks - forks.value())
            if self.prefix_cache:
                reg.gauge("paged_prefix_cached_pages",
                          "zero-ref pages parked in the prefix LRU").set(
                    self.pm.num_cached_pages)
                reg.gauge("paged_prefix_cached_bytes",
                          "KV bytes held by parked prefix pages").set(
                    self.pm.cached_bytes())
                reg.gauge("serving_prefix_hit_rate",
                          "cumulative prompt tokens served from cache").set(
                    self.prefix_hit_rate())
                hits = reg.counter("paged_prefix_hits_total",
                                   "pages reused via prefix match")
                hits.inc(st.n_prefix_hits - hits.value())
                ev = reg.counter("paged_prefix_evictions_total",
                                 "parked pages evicted under pool pressure")
                ev.inc(st.n_prefix_evictions - ev.value())
                args.update(prefix_cached_pages=self.pm.num_cached_pages,
                            prefix_hit_rate=round(self.prefix_hit_rate(), 4))
            tr.sample("pages", {"in_use": st.pages_in_use,
                                "free": self.pm.num_pages - st.pages_in_use},
                      ts_us=t0_us + dur_us)
        tr.complete(f"serve_step:{self.steps - 1}", "serving", t0_us, dur_us,
                    **args)

    def step(self) -> List[Request]:
        """Admit, one decode step for all live slots, retire. Returns the
        requests completed this step. With a flight recorder attached the
        step is watermark-checked, and a caught
        ``torch.cuda.OutOfMemoryError`` is captured (owner table, top
        buffers, recent serve steps) before the re-raise."""
        try:
            with shctx.use_mesh(self.tp):
                done = self._step_inner()
        except Exception as e:
            fl = self.flight
            if fl is not None and fl.is_oom(e):
                at = self.attributor
                fl.record_oom(
                    e, snapshot_fn=None if at is None
                    else lambda: at.snapshot(full=True),
                    live_bytes=self._live_bytes(), source="serving")
            raise
        if self.flight is not None:
            live = self._live_bytes()
            self.flight.note("serve_step", step=self.steps,
                             live_bytes=live, queued=self.n_queued,
                             kv_reserved_bytes=self.kv_reserved_bytes())
            at = self.attributor
            self.flight.check(
                live, snapshot_fn=None if at is None
                else lambda: at.snapshot(full=True), source="serving")
        return done

    def _step_inner(self) -> List[Request]:
        t0_us = None
        if self.telemetry is not None:
            t0_us = self.telemetry.tracer.now_us()
            if not hasattr(self, "_cow_mark"):
                self._cow_mark = self._fork_mark = 0
        tokens_before = self._tokens_outstanding() \
            if self.telemetry is not None else 0
        self._admit()
        if self.backend == "paged":
            # spec decode writes up to k+1 tokens a slot this step
            self._grow_pages(self.spec_k + 1 if self.spec_decode else 1)
        # recompute after growth: preemption may have evicted a slot
        live_slots = [s for s, r in enumerate(self.active) if r is not None]
        if live_slots:
            if self.spec_decode:
                self._spec_decode_step(live_slots)
            else:
                self._vanilla_decode(live_slots)
        self.steps += 1
        done = self._retire()
        if self.telemetry is not None:
            n_tokens = (self._tokens_outstanding()
                        + sum(len(r.out_tokens) for r in done)
                        - tokens_before)
            self._emit_step(t0_us, n_tokens, len(done))
        return done

    def _tokens_outstanding(self) -> int:
        """Generated tokens held by not-yet-retired requests (active or
        queued: preemption re-queues with tokens kept, so the per-step
        delta against this sum counts each token exactly once)."""
        return (sum(len(r.out_tokens) for r in self.active if r is not None)
                + sum(len(r.out_tokens) for r in self.queue))

    def run_until_drained(self, max_steps: int = 10_000) -> List[Request]:
        finished = []
        for _ in range(max_steps):
            finished.extend(self.step())
            if not self.n_queued and all(r is None for r in self.active):
                break
        return finished

    # -- weight updates -------------------------------------------------------
    def update_params(self, params, *,
                      weight_version: Optional[int] = None) -> None:
        """Swap serving weights (an RLHF iteration just updated the
        policy). The decode graphs captured the old weights' addresses, so
        they are dropped, with their pool; each decode key recaptures at
        its next call, on ``params`` (a capture, not a compile-cache
        miss). With the prefix cache on, the pool's weight version is
        bumped and every cached prefix invalidated, so KV produced under
        the old weights is never matched again. In-flight sequences are
        unaffected: callers swap weights between rollouts, when nothing
        is active."""
        self.params = params
        self._drop_graphs()
        if self.backend == "paged" and self.prefix_cache:
            self.pm.set_weight_version(
                self.pm.weight_version + 1 if weight_version is None
                else weight_version)

    # -- introspection --------------------------------------------------------
    def prefix_hit_rate(self) -> float:
        """Cumulative fraction of admitted prompt tokens served from the
        prefix cache (0.0 before any admission)."""
        if not self._prefix_tokens_total:
            return 0.0
        return self._prefix_tokens_hit / self._prefix_tokens_total

    def kv_reserved_bytes(self) -> int:
        """Bytes of KV/state the backend currently reserves. Dense reserves
        the whole [B, capacity] cache up front (measured from the cache
        tensors, so Mamba states count too); paged reserves live pages."""
        if self.backend == "paged":
            return self.pm.reserved_bytes()
        return sum(t.numel() * t.element_size()
                   for t in leaves(self.caches))
