"""Rollout: prompt prefill + sampled decoding over a fixed-capacity rolling
KV cache — the dense backend of ``repro/rlhf/rollout.py``.

The cache is allocated once at ``capacity`` and every decode step writes
its slot in place, so the allocator sees no per-step growth (the paper's
App. B finding about growing ``generate()`` buffers). Buckets,
speculative decoding, the paged backend and meshes are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import Model


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
    def __init__(self, model: Model, cfg: ModelConfig, *, capacity: int,
                 temperature: float = 1.0, top_k: int = 0,
                 eos_id: Optional[int] = None, window: int = 0):
        self.model, self.cfg = model, cfg
        self.capacity = capacity
        self.temperature, self.top_k = temperature, top_k
        self.eos_id = eos_id
        self.window = window

    def generate(self, params, batch, max_new_tokens: int,
                 generator: torch.Generator) -> RolloutResult:
        """batch: {"tokens": [B, P]} prompt ids on the model's device. One
        prefill, then a Python loop of decode steps — the serving pattern
        the paper's §3.1 traces."""
        tokens = batch["tokens"]
        B, P = tokens.shape
        dev = tokens.device
        logits, caches = self.model.prefill(params, batch, self.capacity,
                                            window=self.window)
        tok, logp0 = sample_token(generator, logits,
                                  temperature=self.temperature,
                                  top_k=self.top_k)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        out_toks = [tok]
        out_logp = [logp0]
        for t in range(1, max_new_tokens):
            pos = torch.full((B,), P + t - 1, dtype=torch.int32, device=dev)
            logits, caches = self.model.decode_step(params, caches, tok, pos,
                                                    window=self.window)
            tok, lp = sample_token(generator, logits,
                                   temperature=self.temperature,
                                   top_k=self.top_k)
            tok = torch.where(done, torch.zeros_like(tok), tok)
            lp = torch.where(done, torch.zeros_like(lp), lp)
            if self.eos_id is not None:
                done = done | (out_toks[-1] == self.eos_id)
            out_toks.append(tok)
            out_logp.append(lp)
        return self._finalize(tokens, out_toks, out_logp, caches)

    def _finalize(self, tokens, out_toks, out_logp, caches) -> RolloutResult:
        """Stack outputs, mask everything after (and including the pad
        after) EOS, and drop the caches so their memory returns to the
        allocator at the phase boundary."""
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
        caches["layers"].clear()
        return RolloutResult(tokens=full, logp=logp, mask=mask, prompt_len=P)
