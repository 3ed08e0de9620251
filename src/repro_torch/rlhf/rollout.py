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
Speculative decoding, adapters and meshes are not ported yet.

On a Mamba model the dense backend runs unchanged: a Mamba layer's cache
is its conv and SSM states, which ``capacity`` does not size and the
decode position does not touch.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import Model
from repro_torch.paged import PageManager, copy_pages, pool_token_bytes
from repro_torch.rlhf.decode_graph import DecodeGraph
from repro_torch.serving import BucketLadder, CompileCache


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
    top-k-masked logits, as in the reference."""
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
    ms and, on the paged backend, the page manager's share of them."""

    # class-level switch read per call; an instance set to False runs the
    # decode loop eagerly on the card (to hold the graph against it)
    _graphs = True

    def __init__(self, model: Model, cfg: ModelConfig, *, capacity: int,
                 temperature: float = 1.0, top_k: int = 0,
                 eos_id: Optional[int] = None, window: int = 0,
                 backend: str = "dense", page_size: int = 16,
                 capture_buckets: Optional[Sequence[int]] = None):
        if backend not in ("dense", "paged"):
            raise ValueError(f"backend must be dense or paged, got {backend}")
        if backend == "paged":
            if not model.supports_paged():
                raise ValueError("paged rollout needs an attention-only "
                                 "token model")
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
                self.model.prefill(params, batch, self.capacity,
                                   window=self.window, lengths=lens)
                self.compile_cache.warm(("prefill", self.backend, Sb))
        self.compile_cache.finish_warmup()

    def generate(self, params, batch, max_new_tokens: int,
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
        prefill's logits come out replicated row-wise, G per prompt)."""
        if self.backend == "paged":
            return self._generate_paged(params, batch, max_new_tokens,
                                        generator, group_size)
        tokens = batch["tokens"]
        if group_size > 1:
            tokens = torch.repeat_interleave(tokens, group_size, dim=0)
        B, P = tokens.shape
        if self.prefill_ladder is not None:
            pbatch, lens, Sb = self._bucketed_prompt(tokens)
            if Sb != P and Sb > self.capacity:
                raise ValueError(
                    f"a prompt of {P} tokens pads to the rung {Sb}, above "
                    f"the dense cache's capacity {self.capacity}: the "
                    "padding would push the prompt's first positions out")
            self.compile_cache.lookup(("prefill", "dense", Sb))
            logits, caches = self.model.prefill(params, pbatch, self.capacity,
                                                window=self.window,
                                                lengths=lens)
        else:
            logits, caches = self.model.prefill(params, {"tokens": tokens},
                                                self.capacity,
                                                window=self.window)
        graph = self._decode_graph(lambda tok, pos: self.model.decode_step(
            params, caches, tok, pos, window=self.window)[0], B,
            tokens.device, max_new_tokens)
        out_toks, out_logp = self._sample_loop(
            logits, lambda t, tok: graph(tok, P + t - 1), max_new_tokens,
            generator)
        return self._finalize(tokens, out_toks, out_logp, caches["layers"],
                              graph)

    def _decode_graph(self, body, batch: int, device, max_new_tokens: int,
                      table_blocks: int = 0):
        """This call's decode step (graphed on the card unless
        ``_graphs`` is off, or fewer than two steps follow), with a fresh
        ``decode_stats`` record."""
        self.decode_stats = {"steps": 0, "host_ms": 0.0,
                             "page_manager_ms": 0.0}
        return DecodeGraph(body, batch, device,
                           steps=max(max_new_tokens - 1, 0),
                           table_blocks=table_blocks, capture=self._graphs)

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

    def _finalize(self, tokens, out_toks, out_logp, kv: List[dict],
                  graph: DecodeGraph) -> RolloutResult:
        """Stack outputs, mask everything after (and including the pad
        after) EOS, and drop the decode graph (its private pool, static
        buffers and the body's references) and the per-layer caches or
        pools, so their memory returns to the allocator at the phase
        boundary."""
        B, P = tokens.shape
        dev = tokens.device
        gen = torch.stack(out_toks, dim=1).to(tokens.dtype)
        gen_logp = torch.stack(out_logp, dim=1)
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
        return RolloutResult(tokens=full, logp=logp, mask=mask, prompt_len=P)
