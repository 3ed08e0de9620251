"""Core transformer layers: RMSNorm, RoPE, GQA attention (+QKV bias,
sliding window, rolling KV cache) and (gated) MLPs — the port of
``repro/models/layers.py:22-281, 424-444`` without LoRA adapters.

Parameters are plain dicts of tensors. Projection weights keep the
reference's *fused* head layout (``[d_model, heads*head_dim]``), so the
bridge copies them as they are. RMSNorm, prefill attention and decode
attention go through ``kernels/ops.py``: the hand-written kernel on CUDA,
the plain version on the CPU.

Unlike the reference's pure functions, :func:`_fill_cache` and
:func:`attention_decode` write the KV cache in place: the cache is
allocated once and a functional update would copy a layer's whole cache
on every decode step.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

NEG_INF = -1e30


def _init(generator: torch.Generator, shape, scale=0.02,
          dtype=torch.float32) -> torch.Tensor:
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (scale * x).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def init_norm(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rms_norm(x: torch.Tensor, params: dict, eps: float = 1e-5) -> torch.Tensor:
    return ops.rmsnorm(x, params["scale"], eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings (NeoX-style half rotation)
# ---------------------------------------------------------------------------
def rope_tables(positions: torch.Tensor, dim: int, theta: float):
    """positions [..., S] -> (sin, cos) of shape [..., S, dim/2], fp32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv_freq = 1.0 / (theta ** exps)
    angles = positions.float()[..., None] * inv_freq
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, D]; sin/cos [B, S, D/2]."""
    dtype = x.dtype
    x = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    sin = sin[:, :, None, :]
    cos = cos[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dtype)


# ---------------------------------------------------------------------------
# Masked softmax attention core
# ---------------------------------------------------------------------------
def sdpa(q, k, v, mask):
    """q [B,Sq,H,D], k/v [B,Sk,K,D] with H % K == 0; mask [B,1|H,Sq,Sk]
    bool. Softmax in fp32, probabilities cast to q's dtype (as the
    reference's ``sdpa``). The model routes its attention through the
    kernels; this dense form is the layer-level counterpart of the
    reference's."""
    B, Sq, H, D = q.shape
    K = k.shape[2]
    group = H // K
    qg = q.reshape(B, Sq, K, group, D)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    logits = logits / math.sqrt(D)
    m = mask[:, :, None] if mask.shape[1] == 1 else \
        mask.reshape(B, K, group, Sq, -1)
    logits = torch.where(m, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, Sq, H, v.shape[-1])


def attn_core(q, k, v, *, causal: bool, window: int = 0):
    """Structural-mask attention, always through the flash kernel (B2) —
    on the CPU its plain version."""
    return ops.flash_attention(q, k, v, causal=causal, window=window)


def causal_mask(Sq: int, Sk: int, q_offset: int = 0, window: int = 0,
                device=None) -> torch.Tensor:
    """[1, 1, Sq, Sk] causal (optionally sliding-window) mask."""
    qi = torch.arange(Sq, device=device)[:, None] + q_offset
    kj = torch.arange(Sk, device=device)[None, :]
    m = kj <= qi
    if window:
        m &= kj > qi - window
    return m[None, None]


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------
def init_attention(generator: torch.Generator, cfg: ModelConfig,
                   dtype) -> dict:
    d, h, kvh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim()
    p = {
        "wq": _init(generator, (d, h * hd), dtype=dtype),
        "wk": _init(generator, (d, kvh * hd), dtype=dtype),
        "wv": _init(generator, (d, kvh * hd), dtype=dtype),
        "wo": _init(generator, (h * hd, d),
                    scale=0.02 / math.sqrt(2 * cfg.num_layers), dtype=dtype),
    }
    if cfg.qkv_bias:
        dev = generator.device
        p["bq"] = torch.zeros((h * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((kvh * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((kvh * hd,), dtype=dtype, device=dev)
    return p


def _project_qkv(params, x, cfg: ModelConfig):
    B, S, _ = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    return (q.reshape(B, S, h, hd), k.reshape(B, S, kvh, hd),
            v.reshape(B, S, kvh, hd))


def _fill_cache(cache: dict, entries: dict, positions: torch.Tensor) -> dict:
    """Write the last min(S, capacity) per-position entries into a rolling
    cache, in place. ``entries``: dict name -> [B,S,...]; positions [B,S]."""
    B, S = positions.shape
    cap = cache["pos"].shape[1]
    n = min(S, cap)
    slots = (positions[:, -n:] % cap).long()
    bi = torch.arange(B, device=positions.device)[:, None]
    for name, val in entries.items():
        cache[name][bi, slots] = val[:, -n:]
    cache["pos"][bi, slots] = positions[:, -n:].to(torch.int32)
    return cache


def attention_fwd(params, x, positions, cfg: ModelConfig, *,
                  window: int = 0, init_cache: Optional[dict] = None):
    """Full-sequence (prefill) self-attention. With ``init_cache`` also
    returns the filled rolling KV cache (single-pass prefill)."""
    q, k, v = _project_qkv(params, x, cfg)
    sin, cos = rope_tables(positions, cfg.resolved_head_dim(), cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    out = attn_core(q, k, v, causal=True, window=window)
    out = out.reshape(x.shape[0], x.shape[1], -1) @ params["wo"]
    if init_cache is None:
        return out
    return out, _fill_cache(init_cache, {"k": k, "v": v}, positions)


# --- KV cache ---------------------------------------------------------------
def init_kv_cache(cfg: ModelConfig, batch: int, capacity: int, dtype,
                  device) -> dict:
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim()
    return {
        "k": torch.zeros((batch, capacity, kvh, hd), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, capacity, kvh, hd), dtype=dtype,
                         device=device),
        # absolute position stored in each slot; -1 = empty
        "pos": torch.full((batch, capacity), -1, dtype=torch.int32,
                          device=device),
    }


def attention_decode(params, x, position, cache, cfg: ModelConfig, *,
                     window: int = 0):
    """One-token decode. x [B,1,D], position [B] absolute. Rolling buffer:
    slot = position % capacity. The cache is updated in place; returns
    (out [B,1,D], cache)."""
    B = x.shape[0]
    cap = cache["k"].shape[1]
    q, k, v = _project_qkv(params, x, cfg)
    sin, cos = rope_tables(position[:, None], cfg.resolved_head_dim(),
                           cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    slot = (position % cap).long()
    bidx = torch.arange(B, device=x.device)
    cache["k"][bidx, slot] = k[:, 0]
    cache["v"][bidx, slot] = v[:, 0]
    cache["pos"][bidx, slot] = position.to(torch.int32)
    # flash-decode kernel (B3): masks come from the per-slot positions
    out = ops.decode_attention(q[:, 0], cache["k"], cache["v"], cache["pos"],
                               position, window=window)
    out = out.reshape(B, 1, -1) @ params["wo"]
    return out, cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def init_mlp(generator: torch.Generator, d: int, d_ff: int, gated: bool,
             num_layers: int, dtype) -> dict:
    p = {
        "w_in": _init(generator, (d, d_ff), dtype=dtype),
        "w_out": _init(generator, (d_ff, d),
                       scale=0.02 / math.sqrt(2 * num_layers), dtype=dtype),
    }
    if gated:
        p["w_gate"] = _init(generator, (d, d_ff), dtype=dtype)
    return p


def mlp_fwd(params, x, gated: bool) -> torch.Tensor:
    h = x @ params["w_in"]
    if gated:
        h = F.silu(x @ params["w_gate"]) * h
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default form
    return h @ params["w_out"]
