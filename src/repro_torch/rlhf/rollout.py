"""Rollout: prompt prefill + sampled decoding — the dense and paged
backends of ``repro/rlhf/rollout.py``, with the GRPO group fork.

The dense cache is allocated once at ``capacity`` and every decode step
writes its slot in place, so the allocator sees no per-step growth (the
paper's App. B finding about growing ``generate()`` buffers). The paged
backend allocates one pool per layer up front and a PageManager hands out
its pages. Buckets, speculative decoding, adapters and meshes are not
ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import Model
from repro_torch.paged import PageManager, copy_pages, pool_token_bytes


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
    shares its prompt's pages copy-on-write."""

    def __init__(self, model: Model, cfg: ModelConfig, *, capacity: int,
                 temperature: float = 1.0, top_k: int = 0,
                 eos_id: Optional[int] = None, window: int = 0,
                 backend: str = "dense", page_size: int = 16):
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
        logits, caches = self.model.prefill(params, {"tokens": tokens},
                                            self.capacity,
                                            window=self.window)

        def step(t, tok):
            pos = torch.full((B,), P + t - 1, dtype=torch.int32,
                             device=tokens.device)
            return self.model.decode_step(params, caches, tok, pos,
                                          window=self.window)[0]

        out_toks, out_logp = self._sample_loop(logits, step, max_new_tokens,
                                               generator)
        return self._finalize(tokens, out_toks, out_logp, caches["layers"])

    def _sample_loop(self, logits, step, max_new_tokens: int,
                     generator: torch.Generator):
        """Sample the first token from the prefill's ``logits``, then
        ``step(t, tok) -> logits`` for t = 1 .. max_new_tokens-1. Rows are
        zeroed (token and logp) from the step after their EOS."""
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
        return out_toks, out_logp

    def _bucketed_prompt(self, tokens: torch.Tensor):
        """The prefill batch and per-row lengths. The reference pads to a
        compile-bucket rung here; the port has no ladder yet, so every row
        is its full length P."""
        B, P = tokens.shape
        return {"tokens": tokens}, torch.full((B,), P, dtype=torch.int32,
                                              device=tokens.device)

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

        def table(seq_ids):
            return torch.from_numpy(pm.block_table_array(seq_ids, nb)).to(dev)

        pbatch, lens = self._bucketed_prompt(tokens)
        logits, pools, h_last = self.model.paged_prefill(
            params, pbatch, pools, table([b * G for b in range(B)]), lens,
            return_h=True)
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

        def step(t, tok):
            copies = []
            for s in seq_ids:
                copies += pm.append_token(s)   # page for index P + t - 1
            if copies:
                src = torch.tensor([c[0] for c in copies], device=dev)
                dst = torch.tensor([c[1] for c in copies], device=dev)
                for pool in pools:
                    copy_pages(pool, src, dst)
            pos = torch.full((BG,), P + t - 1, dtype=torch.int32, device=dev)
            return self.model.paged_decode_step(params, pools, tok, pos,
                                                table(seq_ids))[0]

        out_toks, out_logp = self._sample_loop(logits, step, max_new_tokens,
                                               generator)
        for s in seq_ids:
            pm.free_seq(s)
        self.page_manager = pm
        return self._finalize(tokens, out_toks, out_logp, pools)

    def _finalize(self, tokens, out_toks, out_logp,
                  kv: List[dict]) -> RolloutResult:
        """Stack outputs, mask everything after (and including the pad
        after) EOS, and drop the per-layer caches or pools so their memory
        returns to the allocator at the phase boundary."""
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
        kv.clear()
        return RolloutResult(tokens=full, logp=logp, mask=mask, prompt_len=P)
