"""Rollout: prompt prefill + sampled decoding — the dense and paged
backends of ``repro/rlhf/rollout.py``, with the GRPO group fork.

The dense cache is allocated once at ``capacity`` and every decode step
writes its slot in place, so the allocator sees no per-step growth (the
paper's App. B finding about growing ``generate()`` buffers). The paged
backend allocates one pool per layer up front and a PageManager hands out
its pages. On the card every decode step after the first replays one CUDA
graph of the step (``rlhf/decode_graph.py``, captured once per call: the
counterpart of the reference's jitted decode); sampling, the EOS mask,
the page manager and CoW copies stay outside it.

``capture_buckets`` pads prompts to a rung of a compile-bucket ladder
(``serving/buckets.py``) and masks the padding exactly with per-row
``lengths``, as the reference does, with its compile-cache keys. The
port's prefill runs eagerly, so a rung saves no compile here: the ladder
gives the reference's results and cache stats, at the cost of the padded
prefill work. On the dense backend a rung above ``capacity`` raises,
since the rolling cache would keep the padding and drop the prompt's
first positions.
``spec_decode`` is the reference's MTP self-speculative greedy decoding:
each step drafts ``spec_k`` tokens from the model's MTP chain, verifies
them in one (spec_k+1)-token forward and accepts the greedy-consistent
prefix, so every emitted token is the verify forward's own fp32 argmax
and its logp the same ``log_softmax`` gather as vanilla greedy; only the
number of forwards changes. Greedy only (temperature 0, top_k 0), no EOS
early exit, full attention. On the card the draft + verify + accept step
is captured once per call (``decode_graph.SpecGraph``) and replayed; the
host reads each step's accepted counts, as the reference's does.
Adapters are not taken: the trainer hands the rollout merged weights.

``mesh=`` (a ``ShardedContext``, or its ``DeviceMesh``) with a ``model``
axis above 1 runs the rollout tensor parallel, as the reference's
``Rollout(mesh=)``: generation runs under ``sharding.ctx.use_mesh``, the
params are the rank's Megatron cuts (a TP plan's ``gather_copy``, or the
live tree below ZeRO-3), the dense caches and paged pools hold the rank's
K/ntp KV heads (the reference's ``place_kv_tp``), the page manager runs
the same on every rank, and :func:`sample_token` all-gathers only the
``[B, V]`` rows it draws from, so every rank draws the same token from the
same generator seed. The decode loop then runs eagerly on the kernels: a
gloo collective stages through host memory and cannot be captured, and
capture over NCCL waits for a machine with more than one card;
``graphs=True`` under such a mesh raises (``sharding.tp.refuse_graphs``).
Speculative decoding and Mamba layers under TP raise (ROADMAP A10c).

On a Mamba model the dense backend runs unchanged: a Mamba layer's cache
is its conv and SSM states, which ``capacity`` does not size and the
decode position does not touch.

A model over prefix embeddings (``input_mode`` "embeddings") or an
encoder-decoder ("encdec") runs on the dense backend alone, as the
reference's does: the batch carries ``prefix_embeds`` or
``frame_embeds`` beside the tokens and goes to the prefill whole; with
prefix embeddings the cache holds the prefix too, so ``capacity`` must
cover prefix + prompt + new tokens and the decode positions start after
the prefix (the reference's ``prefix + P + t - 1``); an
encoder-decoder's cross K/V live in the caches from the prefill on, read
in place by every (graphed) decode step, and go with them at the end.
The paged backend, spec decode, ``capture_buckets`` and ``group_size``
above 1 raise on them (the reference's refuse the first three; its
group path repeats the tokens alone, so the embeddings would no longer
match the rows).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import Model
from repro_torch.paged import PageManager, copy_pages, pool_token_bytes
from repro_torch.rlhf.decode_graph import DecodeGraph, SpecGraph
from repro_torch.serving import BucketLadder, CompileCache
from repro_torch.sharding import ctx as shctx
from repro_torch.sharding import tp as TP
from repro_torch.steps import _prefix_len


@dataclass
class RolloutResult:
    tokens: torch.Tensor     # [B, S_total] prompt + generated
    logp: torch.Tensor       # [B, S_total] sampled-token logprobs (0 on prompt)
    mask: torch.Tensor       # [B, S_total] 1.0 on generated tokens
    prompt_len: int


def sample_token(generator: torch.Generator, logits: torch.Tensor, *,
                 temperature: float = 1.0, top_k: int = 0):
    """Top-k / temperature sampling (argmax at temperature 0). Returns
    (tokens [B] int64, logp [B]) where logp is the log-softmax of the
    top-k-masked logits, as in the reference. Under an ambient TP group
    ``logits`` are the rank's vocab columns: the rows are all-gathered
    first."""
    tp = TP.current()
    if tp is not None:
        logits = tp.gather_vocab(logits)
    logits = logits.float()
    if top_k:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, -1e30),
                             logits)
    if temperature <= 0.0:
        tok = torch.argmax(logits, dim=-1)
    else:
        probs = torch.softmax(logits / temperature, dim=-1)
        tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
    logp = torch.log_softmax(logits, dim=-1)
    return tok, torch.gather(logp, -1, tok[:, None])[:, 0]


def spec_verify_step(model: Model, spec_k: int, verify_fn, params, h_last,
                     tok, pos, live):
    """The draft / verify / accept core of self-speculative greedy decode
    (``repro/rlhf/rollout.py:59-88``), on tensors alone (no host sync, so
    a CUDA graph captures it whole). ``verify_fn(seq [B,T], positions
    [B,T]) -> (logits [B,T,V], h [B,T,D])`` runs the T = spec_k + 1 token
    forward; rows with ``live`` False get position -1 (dead writes).

    logits[:, j] is the function of its context a sequential decode
    would compute there (drafts j' <= j are context for query j), so
    ``argmax(fp32 logits[:, j])`` is the vanilla greedy token once tokens
    0..j-1 are accepted, and its gathered ``log_softmax`` is
    ``sample_token``'s logp at top_k 0: the accepted prefix yields
    ``n_acc + 1`` vanilla-exact (token, logp) pairs.

    Returns (greedy [B, k+1], logp [B, k+1], n_acc [B], h_new [B, D]: the
    trunk state at each row's last accepted position)."""
    B = tok.shape[0]
    drafts = model.mtp_draft(params, h_last, tok, spec_k)        # [B, k]
    seq = torch.cat([tok[:, None], drafts], dim=1)               # [B, k+1]
    steps = torch.arange(spec_k + 1, dtype=torch.int32, device=tok.device)
    positions = pos[:, None] + steps[None]
    positions = torch.where(live[:, None], positions,
                            torch.full_like(positions, -1))
    logits, h = verify_fn(seq, positions)
    lg32 = logits.float()
    greedy = torch.argmax(lg32, dim=-1)
    logp = torch.gather(torch.log_softmax(lg32, dim=-1), -1,
                        greedy[..., None])[..., 0]
    acc = torch.cumprod((greedy[:, :-1] == drafts).int(), dim=1)
    n_acc = acc.sum(dim=1)                                       # [B]
    h_new = h[torch.arange(B, device=h.device), n_acc]           # [B, D]
    return greedy, logp, n_acc, h_new


def live_device_bytes(device: torch.device) -> Optional[int]:
    """Bytes the CUDA caching allocator holds in live tensors on
    ``device``; None off the card (no device metric exists there)."""
    if device.type != "cuda":
        return None
    return torch.cuda.memory_allocated(device)


class Rollout:
    """``backend="dense"`` keeps one rolling ``[B, capacity]`` cache per
    layer; ``backend="paged"`` keeps the KV in page pools addressed by
    block tables (``repro_torch.paged``), so a GRPO group of G samples
    shares its prompt's pages copy-on-write.

    ``capture_buckets`` (a ladder of prompt lengths) pads every prompt to
    its rung and prefills with ``lengths``; on a Mamba model the prefill
    then raises, as the reference's does, since the mask cannot cover its
    states, and on the dense backend a rung above ``capacity`` raises. ``decode_stats`` holds the last call's decode-loop record:
    the graph's stats (``DecodeGraph.stats``), its steps, the loop's host
    ms and, on the paged backend, the page manager's share of them.

    ``spec_decode`` (greedy only: ``temperature`` 0, ``top_k`` 0, no
    ``eos_id``, ``window`` 0, a model with MTP heads and attention
    layers alone) drafts ``spec_k`` tokens a step; the rolling cache and
    the pool's page count are sized ``capacity + spec_k``, since a verify
    writes up to ``spec_k`` positions past the last one needed.
    ``spec_stats`` holds the last spec call's steps, drafted and accepted
    tokens.

    ``mesh`` runs the rollout tensor parallel (the module's note);
    ``graphs`` asks for the captured decode step (None: captured on the
    card unless the mesh has a model axis above 1, where the loop runs
    eagerly; True there raises)."""

    # class-level switch read per call; an instance set to False runs the
    # decode loop eagerly on the card (to hold the graph against it)
    _graphs = True

    def __init__(self, model: Model, cfg: ModelConfig, *, capacity: int,
                 temperature: float = 1.0, top_k: int = 0,
                 eos_id: Optional[int] = None, window: int = 0,
                 backend: str = "dense", page_size: int = 16,
                 capture_buckets: Optional[Sequence[int]] = None,
                 spec_decode: bool = False, spec_k: int = 2, mesh=None,
                 graphs: Optional[bool] = None):
        if backend not in ("dense", "paged"):
            raise ValueError(f"backend must be dense or paged, got {backend}")
        what = f"{cfg.name} (input_mode {cfg.input_mode!r})"
        if capture_buckets and cfg.input_mode != "tokens":
            raise ValueError(f"capture_buckets pads token prompts (a "
                             f"lengths-masked prefill): not for {what}")
        ntp = TP.degree(mesh)
        TP.check_supported(cfg, ntp, spec_decode=spec_decode)
        if ntp > 1 and graphs:
            raise TP.refuse_graphs()
        self.mesh, self.want_graphs = mesh, graphs
        self.tp = TP.resolve(mesh)
        if spec_decode:
            if not model.supports_spec_decode():
                raise ValueError("spec decode needs a token-input "
                                 "attention-only model with mtp_depth > 0, "
                                 f"not {what}")
            if temperature > 0.0 or top_k:
                raise ValueError("spec decode is greedy-only "
                                 "(temperature=0, top_k=0)")
            if eos_id is not None:
                raise ValueError(
                    "spec decode has no EOS early exit (vanilla feeds "
                    "zeroed post-EOS tokens through the cache); mask EOS "
                    "downstream")
            if window:
                raise ValueError("spec decode is full-attention")
            if spec_k < 1:
                raise ValueError(f"spec_k must be at least 1, not {spec_k}")
        if backend == "paged":
            if not model.supports_paged():
                raise ValueError("paged rollout needs an attention-only "
                                 f"token model, not {what}")
            if window:
                raise ValueError("paged rollout is full-attention")
        self.model, self.cfg = model, cfg
        self.capacity = capacity
        self.temperature, self.top_k = temperature, top_k
        self.eos_id = eos_id
        self.window = window
        self.backend = backend
        self.page_size = page_size
        self.page_manager: Optional[PageManager] = None   # set per paged call
        self.decode_stats: Optional[dict] = None          # set per call
        self.compile_cache = CompileCache()
        self.prefill_ladder = (BucketLadder(capture_buckets)
                               if capture_buckets else None)
        self.spec_decode, self.spec_k = spec_decode, spec_k
        self._cap_eff = capacity + (spec_k if spec_decode else 0)
        self.spec_stats: Optional[dict] = None           # set per spec call

    def warmup(self, params, batch_size: int,
               max_prompt_len: Optional[int] = None) -> None:
        """Run the bucketed dense prefill once at every ladder rung up to
        ``max_prompt_len`` (or ``capacity``), registering each key, as the
        reference pre-compiles it (here it sets up each rung's cuBLAS and
        kernel plans); the paged backend has no per-rung warmup there
        either. Marks the compile cache warmed either way."""
        if self.prefill_ladder is not None and self.backend == "dense":
            dev = params["embed"].device
            for Sb in self.prefill_ladder.up_to(max_prompt_len
                                                or self.capacity):
                batch = {"tokens": torch.zeros((batch_size, Sb),
                                               dtype=torch.long, device=dev)}
                lens = torch.zeros((batch_size,), dtype=torch.int32,
                                   device=dev)
                with shctx.use_mesh(self.mesh):
                    self.model.prefill(params, batch, self._cap_eff,
                                       window=self.window, lengths=lens)
                self.compile_cache.warm(("prefill", self.backend, Sb))
        self.compile_cache.finish_warmup()

    def _capture(self) -> bool:
        """Whether this call's decode step is captured (on the card)."""
        on = self._graphs if self.want_graphs is None else self.want_graphs
        return bool(on) and self.tp is None

    def generate(self, params, batch, max_new_tokens: int,
                 generator: torch.Generator,
                 group_size: int = 1) -> RolloutResult:
        """batch: {"tokens": [B, P]} prompt ids (see :meth:`_generate`);
        under the rollout's mesh when it has one."""
        with shctx.use_mesh(self.mesh):
            return self._generate(params, batch, max_new_tokens, generator,
                                  group_size)

    def _generate(self, params, batch, max_new_tokens: int,
                  generator: torch.Generator,
                  group_size: int = 1) -> RolloutResult:
        """batch: {"tokens": [B, P]} prompt ids on the model's device. One
        prefill, then a Python loop of decode steps — the serving pattern
        the paper's §3.1 traces.

        ``group_size = G > 1`` (GRPO / best-of-N) expands every prompt to a
        group of G samples, returning ``[B*G, ...]`` results ordered as
        ``torch.repeat_interleave`` (the reference's ``jnp.repeat``) would.
        The dense backend repeats the prompts up front; the paged backend
        prefills each prompt once and forks its G samples off it, sharing
        the prompt's pages copy-on-write — the same sampling stream (the
        prefill's logits come out replicated row-wise, G per prompt). The
        speculative path repeats the prompts up front on both backends."""
        if self.spec_decode:
            tokens = batch["tokens"]
            if group_size > 1:
                tokens = torch.repeat_interleave(tokens, group_size, dim=0)
            return self._generate_spec(params, tokens, max_new_tokens)
        if self.backend == "paged":
            return self._generate_paged(params, batch, max_new_tokens,
                                        generator, group_size)
        tokens = batch["tokens"]
        if group_size > 1:
            if self.cfg.input_mode != "tokens":
                raise ValueError(
                    f"group_size {group_size} with input_mode "
                    f"{self.cfg.input_mode!r}: the group repeats the tokens "
                    "alone, as the reference's does, so its prefix or "
                    "frame embeddings would not match the rows")
            tokens = torch.repeat_interleave(tokens, group_size, dim=0)
        B, P = tokens.shape
        prefix = _prefix_len(self.cfg)       # the prefix embeddings' slots
        if self.prefill_ladder is not None:
            pbatch, lens, Sb = self._dense_prompt(tokens)
            logits, caches = self.model.prefill(params, pbatch, self.capacity,
                                                window=self.window,
                                                lengths=lens)
        else:
            logits, caches = self.model.prefill(
                params, dict(batch, tokens=tokens), self.capacity,
                window=self.window)
        graph = self._decode_graph(lambda tok, pos: self.model.decode_step(
            params, caches, tok, pos, window=self.window)[0], B,
            tokens.device, max_new_tokens)
        out_toks, out_logp = self._sample_loop(
            logits, lambda t, tok: graph(tok, prefix + P + t - 1),
            max_new_tokens, generator)
        return self._finalize(tokens, out_toks, out_logp, caches["layers"],
                              graph, caches.get("cross_kv"))

    def _decode_graph(self, body, batch: int, device, max_new_tokens: int,
                      table_blocks: int = 0):
        """This call's decode step (graphed on the card unless
        ``_graphs`` is off, or fewer than two steps follow), with a fresh
        ``decode_stats`` record."""
        self.decode_stats = {"steps": 0, "host_ms": 0.0,
                             "page_manager_ms": 0.0}
        return DecodeGraph(body, batch, device,
                           steps=max(max_new_tokens - 1, 0),
                           table_blocks=table_blocks, capture=self._capture())

    def _sample_loop(self, logits, step, max_new_tokens: int,
                     generator: torch.Generator):
        """Sample the first token from the prefill's ``logits``, then
        ``step(t, tok) -> logits`` for t = 1 .. max_new_tokens-1. Rows are
        zeroed (token and logp) from the step after their EOS. The loop's
        host time goes to ``decode_stats``."""
        t0 = time.perf_counter()
        tok, logp0 = sample_token(generator, logits,
                                  temperature=self.temperature,
                                  top_k=self.top_k)
        done = torch.zeros(tok.shape, dtype=torch.bool, device=tok.device)
        out_toks = [tok]
        out_logp = [logp0]
        for t in range(1, max_new_tokens):
            tok, lp = sample_token(generator, step(t, tok),
                                   temperature=self.temperature,
                                   top_k=self.top_k)
            tok = torch.where(done, torch.zeros_like(tok), tok)
            lp = torch.where(done, torch.zeros_like(lp), lp)
            if self.eos_id is not None:
                done = done | (out_toks[-1] == self.eos_id)
            out_toks.append(tok)
            out_logp.append(lp)
        self.decode_stats["steps"] = max(max_new_tokens - 1, 0)
        self.decode_stats["host_ms"] = (time.perf_counter() - t0) * 1e3
        return out_toks, out_logp

    def _dense_prompt(self, tokens: torch.Tensor):
        """:meth:`_bucketed_prompt` for the dense backend, whose rolling
        cache holds ``capacity`` positions (``capacity + spec_k`` on the
        speculative path): a rung above that raises; the compile-cache key
        is looked up."""
        P = tokens.shape[1]
        pbatch, lens, Sb = self._bucketed_prompt(tokens)
        if Sb != P and Sb > self._cap_eff:
            raise ValueError(
                f"a prompt of {P} tokens pads to the rung {Sb}, above "
                f"the dense cache's capacity {self._cap_eff}: the "
                "padding would push the prompt's first positions out")
        self.compile_cache.lookup(("prefill", "dense", Sb))
        return pbatch, lens, Sb

    def _bucketed_prompt(self, tokens: torch.Tensor):
        """Pad [B, P] prompts (right, with 0) up to their ladder rung Sb;
        returns the padded batch, per-row lengths (all P) and Sb for the
        compile-cache key. Without a ladder Sb = P."""
        B, P = tokens.shape
        Sb = self.prefill_ladder.fit(P) if self.prefill_ladder else P
        if Sb != P:
            tokens = F.pad(tokens, (0, Sb - P))
        return {"tokens": tokens}, torch.full((B,), P, dtype=torch.int32,
                                              device=tokens.device), Sb

    def _generate_paged(self, params, batch, max_new_tokens: int,
                        generator: torch.Generator, group_size: int):
        """Paged generation: KV lives in a page pool that grows by one page
        per sequence only when a page boundary is crossed.
        ``self.page_manager`` afterwards holds the alloc/free event stream
        for the allocator simulator.

        With ``group_size = G > 1`` each prompt is prefilled ONCE and
        forked into G sequences sharing its pages (``PageManager.fork``);
        a shared partial prompt page is copied on each child's first
        append, on every layer's pool, before the decode writes to it."""
        tokens = batch["tokens"]
        B, P = tokens.shape
        dev = tokens.device
        G = group_size
        BG = B * G
        ps = self.page_size
        nb = -(-(P + max_new_tokens) // ps)
        dtype = params["embed"].dtype
        if G == 1:
            num_pages = B * nb
        else:
            # shared prompt pages once per unique prompt, plus each group
            # member's own growth: pages past the shared full-page prefix
            # (a partial prompt page is CoW-copied on first append)
            num_pages = B * (-(-P // ps)) + BG * (nb - P // ps)
        pm = PageManager(num_pages, ps,
                         bytes_per_token=pool_token_bytes(self.cfg, dtype)
                         * self.cfg.num_layers)
        for b in range(B):
            pm.allocate(b * G, P)           # group parent row
        pools = self.model.init_paged_pools(num_pages, ps, dtype)
        pbatch, lens, Sb = self._bucketed_prompt(tokens)
        self.compile_cache.lookup(("prefill", "paged", Sb))
        logits, pools, h_last = self.model.paged_prefill(
            params, pbatch, pools, torch.from_numpy(pm.block_table_array(
                [b * G for b in range(B)], nb)).to(dev), lens, return_h=True)
        if G > 1:
            for b in range(B):
                for g in range(1, G):
                    pm.fork(b * G, b * G + g)
            # the logits replicated row-wise, G per prompt: the last hidden
            # state is replicated and unembedded over all B*G rows, the
            # product shape of a G-times repeated batch (a GEMM's rounding
            # may depend on its row count; on the CPU it does below 6 rows)
            h_rep = torch.repeat_interleave(h_last, G, dim=0)
            logits = self.model.unembed(params, h_rep[:, None])[:, 0]
            tokens = torch.repeat_interleave(tokens, G, dim=0)
        seq_ids = list(range(BG))
        graph = self._decode_graph(
            lambda tok, pos, bt: self.model.paged_decode_step(
                params, pools, tok, pos, bt)[0], BG, dev, max_new_tokens,
            table_blocks=nb)
        graph.write_table(pm.block_table_array(seq_ids, nb))

        def step(t, tok):
            # the page manager's host time, apart from the step's dispatch
            t0 = time.perf_counter()
            allocs = pm.stats.n_page_alloc
            copies = []
            for s in seq_ids:
                copies += pm.append_token(s)   # page for index P + t - 1
            # a page was taken (a new one, or a CoW copy's): the table moved
            table = pm.block_table_array(seq_ids, nb) \
                if pm.stats.n_page_alloc != allocs else None
            self.decode_stats["page_manager_ms"] += \
                (time.perf_counter() - t0) * 1e3
            if copies:
                src = torch.tensor([c[0] for c in copies], device=dev)
                dst = torch.tensor([c[1] for c in copies], device=dev)
                for pool in pools:
                    copy_pages(pool, src, dst)
            if table is not None:
                graph.write_table(table)
            return graph(tok, P + t - 1)

        out_toks, out_logp = self._sample_loop(logits, step, max_new_tokens,
                                               generator)
        for s in seq_ids:
            pm.free_seq(s)
        self.page_manager = pm
        return self._finalize(tokens, out_toks, out_logp, pools, graph)

    def _generate_spec(self, params, tokens: torch.Tensor,
                       max_new_tokens: int) -> RolloutResult:
        """Self-speculative greedy generation on either backend
        (``repro/rlhf/rollout.py:447-533``). Each step drafts ``spec_k``
        tokens a row from the MTP chain, runs one (spec_k+1)-token verify
        forward and accepts the greedy-consistent prefix: ``n_acc + 1``
        tokens and log-probs, the same as vanilla greedy's. Rows that
        reach ``max_new_tokens`` early get position -1 (dead writes) until
        the batch drains; emission counts are host state, so rows advance
        at their own accept rates. On the paged backend each live row
        grows by spec_k+1 tokens before a verify and is truncated back to
        its accepted length after it."""
        B, P = tokens.shape
        dev = tokens.device
        N = max_new_tokens
        k1 = self.spec_k + 1
        stats = self.spec_stats = {"steps": 0, "drafted": 0, "accepted": 0}
        pm = None
        if self.backend == "paged":
            pbatch, lens, Sb = self._bucketed_prompt(tokens)
            self.compile_cache.lookup(("prefill", "paged", Sb))
            ps = self.page_size
            # one pool shape a Rollout: sized by capacity, not P + N
            nb = -(-self._cap_eff // ps)
            dtype = params["embed"].dtype
            pm = PageManager(B * nb, ps,
                             bytes_per_token=pool_token_bytes(self.cfg, dtype)
                             * self.cfg.num_layers)
            seq_ids = list(range(B))
            for b in seq_ids:
                pm.allocate(b, P)
            kv = self.model.init_paged_pools(B * nb, ps, dtype)
            table = pm.block_table_array(seq_ids, nb)
            logits, kv, h_last = self.model.paged_prefill(
                params, pbatch, kv, torch.from_numpy(table).to(dev), lens,
                return_h=True)

            def verify(seq, positions, bt):
                return self.model.paged_decode_multi(params, kv, seq,
                                                     positions, bt)[:2]
        else:
            pbatch, lens, Sb = self._dense_prompt(tokens)
            logits, caches, h_last = self.model.prefill(
                params, pbatch, self._cap_eff, lengths=lens, return_h=True)
            kv = caches["layers"]

            def verify(seq, positions):
                return self.model.decode_multi(params, caches, seq,
                                               positions)[:2]

        def body(h, tok, pos, live, *table):
            return spec_verify_step(
                self.model, self.spec_k,
                lambda seq, positions: verify(seq, positions, *table),
                params, h, tok, pos, live)

        self.decode_stats = {"steps": 0, "host_ms": 0.0,
                             "page_manager_ms": 0.0}
        graph = SpecGraph(body, B, dev, width=h_last.shape[-1],
                          dtype=h_last.dtype, steps=-(-(N - 1) // k1),
                          table_blocks=nb if pm is not None else 0,
                          capture=self._capture())
        graph.h_last.copy_(h_last)
        del h_last
        t0 = time.perf_counter()
        tok0, logp0 = sample_token(None, logits, temperature=0.0)
        gen = np.zeros((B, N), np.int64)
        gen_lp = np.zeros((B, N), np.float32)
        gen[:, 0] = tok0.cpu().numpy()
        gen_lp[:, 0] = logp0.cpu().numpy()
        n_em = np.ones(B, np.int64)              # tokens emitted a row
        last_tok = gen[:, 0].copy()
        written = None
        while (n_em < N).any():
            live = n_em < N
            pos = np.where(live, P + n_em - 1, -1).astype(np.int32)
            if pm is not None:
                t1 = time.perf_counter()
                for b in np.nonzero(live)[0]:
                    pm.append_tokens(int(b), k1)
                table = pm.block_table_array(seq_ids, nb)
                self.decode_stats["page_manager_ms"] += \
                    (time.perf_counter() - t1) * 1e3
                if written is None or not np.array_equal(table, written):
                    graph.write_table(table)
                    written = table
                self.compile_cache.lookup(("spec", "paged", B, k1))
            else:
                self.compile_cache.lookup(("spec", "dense", B, k1))
            greedy, lp, n_acc, h_new = graph(torch.from_numpy(last_tok),
                                             torch.from_numpy(pos),
                                             torch.from_numpy(live))
            graph.h_last.copy_(h_new)
            greedy = greedy.cpu().numpy()
            lp = lp.cpu().numpy()
            n_acc = n_acc.cpu().numpy()
            stats["steps"] += 1
            stats["drafted"] += self.spec_k * int(live.sum())
            stats["accepted"] += int(n_acc[live].sum())
            t1 = time.perf_counter()
            for b in np.nonzero(live)[0]:
                take = min(int(n_acc[b]) + 1, N - int(n_em[b]))
                e = int(n_em[b])
                gen[b, e:e + take] = greedy[b, :take]
                gen_lp[b, e:e + take] = lp[b, :take]
                n_em[b] += take
                last_tok[b] = greedy[b, take - 1]
                if pm is not None:
                    # drop the pages of rejected or untaken drafts: the
                    # logical length is the position of the row's last token
                    pm.truncate(int(b), P + int(n_em[b]) - 1)
            if pm is not None:
                self.decode_stats["page_manager_ms"] += \
                    (time.perf_counter() - t1) * 1e3
        self.decode_stats["steps"] = stats["steps"]
        self.decode_stats["host_ms"] = (time.perf_counter() - t0) * 1e3
        if pm is not None:
            for b in seq_ids:
                pm.free_seq(b)
            self.page_manager = pm
        out_toks = torch.from_numpy(gen).to(dev)
        out_logp = torch.from_numpy(gen_lp).to(dev)
        return self._finalize(tokens, out_toks, out_logp, kv, graph)

    def _finalize(self, tokens, out_toks, out_logp, kv: List[dict],
                  graph: DecodeGraph,
                  cross_kv: Optional[List[dict]] = None) -> RolloutResult:
        """Stack outputs (per-step lists, or [B, N] tensors), mask
        everything after (and including the pad after) EOS, and drop the
        decode graph (its private pool, static buffers and the body's
        references), the per-layer caches or pools and an
        encoder-decoder's cross K/V, so their memory returns to the
        allocator at the phase boundary."""
        B, P = tokens.shape
        dev = tokens.device
        gen = out_toks if isinstance(out_toks, torch.Tensor) else \
            torch.stack(out_toks, dim=1)
        gen = gen.to(tokens.dtype)
        gen_logp = out_logp if isinstance(out_logp, torch.Tensor) else \
            torch.stack(out_logp, dim=1)
        full = torch.cat([tokens, gen], dim=1)
        logp = torch.cat([torch.zeros((B, P), device=dev), gen_logp], dim=1)
        mask = torch.cat([torch.zeros((B, P), device=dev),
                          torch.ones((B, gen.shape[1]), device=dev)], dim=1)
        if self.eos_id is not None:
            is_eos = (full == self.eos_id) & (mask > 0)
            keep = (torch.cumsum(is_eos.int(), dim=1) - is_eos.int()) == 0
            mask = mask * keep
            logp = logp * keep
        self.decode_stats.update(graph.release())
        kv.clear()
        if cross_kv:
            cross_kv.clear()
        return RolloutResult(tokens=full, logp=logp, mask=mask, prompt_len=P)
