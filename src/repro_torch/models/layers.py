"""Core transformer layers: RMSNorm, RoPE, GQA attention (+QKV bias,
sliding window, rolling KV cache, the T-token verify of speculative
decoding), the cross-attention of an encoder-decoder, DeepSeek-V3's
multi-head latent attention (MLA) and (gated) MLPs — the port of
``repro/models/layers.py:22-444``, with the LoRA delta
at the projection sites when an adapter is given (``adapter=``: the layer's
subtree of a ``models/lora.py`` adapter; the small products stay
``torch.matmul``, as the reference leaves them to XLA).

Parameters are plain dicts of tensors. Projection weights keep the
reference's *fused* head layout (``[d_model, heads*head_dim]``), so the
bridge copies them as they are. RMSNorm, prefill attention and decode
attention go through ``kernels/ops.py``: the hand-written kernel on CUDA,
the plain version on the CPU.

Under an ambient tensor-parallel group (``sharding.tp.current()``) the
params are the rank's Megatron cuts and the head counts the rank's (H/ntp
query and K/ntp KV heads, read from the weights' widths; the caches hold
K/ntp heads): a column block's input passes "copy to model" and a row
product (``wo``, ``w_out``) ends in one all-reduce, its LoRA delta added
after it (``TensorParallel.lora_row``/``lora_col``).

Unlike the reference's pure functions, :func:`_fill_cache`,
:func:`attention_decode`, :func:`attention_decode_multi` and
:func:`mla_decode` write the KV (or MLA latent) cache in place: the cache is
allocated once and a functional update would copy a layer's whole cache
on every decode step.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.lora import lora_delta
from repro_torch.sharding import tp as TP
from repro_torch.sharding.rules import TP_ROW_SITES

NEG_INF = -1e30


class ShapeOnly:
    """The generator of a model on ``meta``, which has no
    ``torch.Generator``: the init functions build shapes and dtypes from
    it, and no values."""
    device = torch.device("meta")


SHAPE_ONLY = ShapeOnly()


def draws(generator):
    """What a random draw takes as its generator: None on ``meta``."""
    return None if generator.device.type == "meta" else generator


# a leaf of more elements is drawn in blocks of its leading axis, so its
# fp32 draw never exists whole (DeepSeek-V3's expert leaves hold 3.76 G
# elements: 15 GB in fp32 beside the 53 GB of a cut model)
_INIT_BLOCK = 1 << 30


def _init(generator: torch.Generator, shape, scale=0.02,
          dtype=torch.float32) -> torch.Tensor:
    n = math.prod(shape)
    if n <= _INIT_BLOCK or len(shape) < 2:
        x = torch.randn(shape, generator=draws(generator),
                        dtype=torch.float32, device=generator.device)
        return (scale * x).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    rows = max(1, _INIT_BLOCK // (n // shape[0]))
    for i in range(0, shape[0], rows):
        out[i:i + rows] = _init(generator, out[i:i + rows].shape, scale,
                                dtype)
    return out


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
    kernels, but for the speculative verify's T queries a row, which no
    kernel takes: there it runs on fp32 copies of q, k and v, so its
    scores stay fp32 as B3's and B4's do (in bf16 the reference's rounds
    them, which would part the verify from the one-query decode kernels
    more than the products' rounding does)."""
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


def _linear(params, x, name, ad):
    """x @ params[name], plus the LoRA delta where ``ad`` adapts it; under
    TP a row site's product is summed over the ranks first."""
    tp = TP.current()
    y = x @ params[name]
    row = name in TP_ROW_SITES
    if tp is not None and row:
        y = tp.reduce_from(y)
    ab = ad.get(name)
    if not ab:
        return y
    if tp is None:
        return y + lora_delta(x, ab)
    return y + (tp.lora_row(x, ab) if row else tp.lora_col(x, ab))


def _column_input(x: torch.Tensor) -> torch.Tensor:
    """A column block's input: under TP, "copy to model"."""
    tp = TP.current()
    return x if tp is None else tp.copy_to(x)


def _project_qkv(params, x, cfg: ModelConfig, adapter=None):
    """(q, k, v) at the rank's head counts (the weights' widths)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim()
    ad = adapter or {}
    x = _column_input(x)
    q = _linear(params, x, "wq", ad)
    k = _linear(params, x, "wk", ad)
    v = _linear(params, x, "wv", ad)
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    return (q.reshape(B, S, -1, hd), k.reshape(B, S, -1, hd),
            v.reshape(B, S, -1, hd))


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
                  window: int = 0, init_cache: Optional[dict] = None,
                  adapter=None):
    """Full-sequence (train / prefill) self-attention. With ``init_cache``
    also returns the filled rolling KV cache (single-pass prefill)."""
    q, k, v = _project_qkv(params, x, cfg, adapter)
    sin, cos = rope_tables(positions, cfg.resolved_head_dim(), cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    out = attn_core(q, k, v, causal=True, window=window)
    out = _linear(params, out.reshape(x.shape[0], x.shape[1], -1), "wo",
                  adapter or {})
    if init_cache is None:
        return out
    return out, _fill_cache(init_cache, {"k": k, "v": v}, positions)


def cross_attention_fwd(params, x, cross: dict,
                        cfg: ModelConfig) -> torch.Tensor:
    """Cross-attention of x [B,S,D] over the encoder's K/V (``cross``: from
    :func:`encode_cross_kv`): no RoPE, no mask, no LoRA (the reference's
    ``cross_attention_fwd``). Every S goes through B2, non-causal, S
    queries over Se keys: the training forward, the prefill and a decode
    step's one query a row alike."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim()
    q = x @ params["wq"]
    if cfg.qkv_bias:
        q = q + params["bq"]
    out = attn_core(q.reshape(B, S, -1, hd), cross["k"], cross["v"],
                    causal=False)
    return out.reshape(B, S, -1) @ params["wo"]


def encode_cross_kv(params, enc_out: torch.Tensor, cfg: ModelConfig) -> dict:
    """A decoder layer's cross-attention K and V [B,Se,K,hd] from the
    encoder's output enc_out [B,Se,D] (the reference's
    ``encode_cross_kv``)."""
    B, Se, _ = enc_out.shape
    hd = cfg.resolved_head_dim()
    k = enc_out @ params["wk"]
    v = enc_out @ params["wv"]
    if cfg.qkv_bias:
        k, v = k + params["bk"], v + params["bv"]
    return {"k": k.reshape(B, Se, -1, hd), "v": v.reshape(B, Se, -1, hd)}


# --- KV cache ---------------------------------------------------------------
def init_kv_cache(cfg: ModelConfig, batch: int, capacity: int, dtype,
                  device) -> dict:
    kvh, hd = TP.kv_heads(cfg), cfg.resolved_head_dim()
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
                     window: int = 0, adapter=None):
    """One-token decode. x [B,1,D], position [B] absolute. Rolling buffer:
    slot = position % capacity. ``adapter`` is the layer's LoRA site dict
    (unmerged A·B on the projections). The cache is updated in place;
    returns (out [B,1,D], cache)."""
    B = x.shape[0]
    cap = cache["k"].shape[1]
    q, k, v = _project_qkv(params, x, cfg, adapter)
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
    return _linear(params, out.reshape(B, 1, -1), "wo", adapter or {}), cache


def attention_decode_multi(params, x, positions, cache, cfg: ModelConfig, *,
                           window: int = 0, adapter=None):
    """T-token decode (the speculative-decode verify). x [B,T,D], positions
    [B,T] absolute (consecutive per row; a -1 row writes a dead entry that
    stays masked). All T K/V entries are written first, then every query
    attends over the updated rolling buffer under its own position mask,
    so draft token j is context for draft token j+1, as if the T tokens
    had been decoded one by one. The attention is plain masked softmax
    (:func:`sdpa` in fp32; the reference's is plain too: no kernel takes
    T queries a row). ``adapter`` as in :func:`attention_decode`. The
    cache is updated in place; returns (out [B,T,D], cache)."""
    B, T = x.shape[:2]
    cap = cache["k"].shape[1]
    q, k, v = _project_qkv(params, x, cfg, adapter)
    sin, cos = rope_tables(positions, cfg.resolved_head_dim(), cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    slots = (positions % cap).long()                        # [B, T]
    bi = torch.arange(B, device=x.device)[:, None]
    cache["k"][bi, slots] = k
    cache["v"][bi, slots] = v
    cache["pos"][bi, slots] = positions.to(torch.int32)
    pos = cache["pos"][:, None, :]
    qpos = positions[:, :, None]
    valid = (pos >= 0) & (pos <= qpos)                      # [B, T, cap]
    if window:
        valid &= pos > qpos - window
    out = sdpa(q.float(), cache["k"].float(), cache["v"].float(),
               valid[:, None]).to(q.dtype)
    return _linear(params, out.reshape(B, T, -1), "wo", adapter or {}), cache


# ---------------------------------------------------------------------------
# DeepSeek-V3 multi-head latent attention (MLA)
# ---------------------------------------------------------------------------
def init_mla(generator: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    m: MLAConfig = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
    dev = generator.device
    return {
        "q_down": _init(generator, (d, m.q_lora_rank), dtype=dtype),
        "q_norm": init_norm(m.q_lora_rank, dtype, dev),
        "q_up": _init(generator, (m.q_lora_rank, h * qk_hd), dtype=dtype),
        "kv_down": _init(generator, (d, m.kv_lora_rank + m.qk_rope_head_dim),
                         dtype=dtype),
        "kv_norm": init_norm(m.kv_lora_rank, dtype, dev),
        "kv_up": _init(generator, (m.kv_lora_rank,
                                   h * (m.qk_nope_head_dim + m.v_head_dim)),
                       dtype=dtype),
        "wo": _init(generator, (h * m.v_head_dim, d),
                    scale=0.02 / math.sqrt(2 * cfg.num_layers), dtype=dtype),
    }


def _mla_q(params, x, positions, cfg: ModelConfig):
    """(q_nope [B,S,H,nope], q_rope [B,S,H,rope]), RoPE applied."""
    m: MLAConfig = cfg.mla
    B, S, _ = x.shape
    ql = rms_norm(x @ params["q_down"], params["q_norm"], cfg.norm_eps)
    q = (ql @ params["q_up"]).reshape(
        B, S, cfg.num_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    sin, cos = rope_tables(positions, m.qk_rope_head_dim, cfg.rope_theta)
    return q_nope, apply_rope(q_rope, sin, cos)


def _mla_latent(params, x, positions, cfg: ModelConfig):
    """The compressed KV a token caches: (c_kv [B,S,r] normed, k_rope
    [B,S,1,rope] with RoPE, the one rope key all heads share)."""
    m: MLAConfig = cfg.mla
    down = x @ params["kv_down"]
    c_kv = rms_norm(down[..., :m.kv_lora_rank], params["kv_norm"],
                    cfg.norm_eps)
    sin, cos = rope_tables(positions, m.qk_rope_head_dim, cfg.rope_theta)
    k_rope = apply_rope(down[..., m.kv_lora_rank:][:, :, None, :], sin, cos)
    return c_kv, k_rope


def _mla_kv_from_latent(params, c_kv, cfg: ModelConfig):
    """Expand latent [B,S,r] into per-head K_nope and V."""
    m: MLAConfig = cfg.mla
    B, S, _ = c_kv.shape
    kv = (c_kv @ params["kv_up"]).reshape(
        B, S, cfg.num_heads, m.qk_nope_head_dim + m.v_head_dim)
    return kv[..., :m.qk_nope_head_dim], kv[..., m.qk_nope_head_dim:]


def _mla_qk(q_nope, q_rope, k_nope, k_rope):
    """Per-head q and k of width nope + rope: the one rope key broadcast
    over the heads."""
    k_rope = k_rope.expand(*k_nope.shape[:3], k_rope.shape[-1])
    return torch.cat([q_nope, q_rope], -1), torch.cat([k_nope, k_rope], -1)


def mla_fwd(params, x, positions, cfg: ModelConfig, *, window: int = 0,
            init_cache: Optional[dict] = None):
    """Full-sequence (train / prefill) MLA: the latent expanded to per-head
    K and V, attention through B2 at q/k width nope + rope and v width
    ``v_head_dim`` (192 / 128 on DeepSeek-V3). With ``init_cache`` also
    returns it filled with the latent and rope key (single-pass
    prefill)."""
    B, S, _ = x.shape
    q_nope, q_rope = _mla_q(params, x, positions, cfg)
    c_kv, k_rope = _mla_latent(params, x, positions, cfg)
    k_nope, v = _mla_kv_from_latent(params, c_kv, cfg)
    q, k = _mla_qk(q_nope, q_rope, k_nope, k_rope)
    out = attn_core(q, k, v, causal=True, window=window)
    out = out.reshape(B, S, -1) @ params["wo"]
    if init_cache is None:
        return out
    return out, _fill_cache(init_cache,
                            {"c_kv": c_kv, "k_rope": k_rope[:, :, 0]},
                            positions)


def init_mla_cache(cfg: ModelConfig, batch: int, capacity: int, dtype,
                   device) -> dict:
    """The MLA decode cache: the latent and the rope key a slot
    (kv_lora_rank + qk_rope_head_dim values a token, where a plain cache
    keeps 2 H head widths), and each slot's position (-1 = empty)."""
    m: MLAConfig = cfg.mla
    return {
        "c_kv": torch.zeros((batch, capacity, m.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, capacity, m.qk_rope_head_dim),
                              dtype=dtype, device=device),
        "pos": torch.full((batch, capacity), -1, dtype=torch.int32,
                          device=device),
    }


def mla_decode(params, x, position, cache, cfg: ModelConfig, *,
               window: int = 0, absorbed: bool = True):
    """One-token MLA decode over the latent cache, written in place. x
    [B,1,D], position [B] absolute; returns (out [B,1,D], cache).

    ``absorbed=True`` (the default, as the reference's) attends in the
    latent space: q_nope is absorbed through kv_up's K half, the scores
    are taken against the cached latent and rope key in fp32, and the
    context is re-expanded through its V half once, so the cache is never
    expanded to per-head K and V. These are plain products, as the
    reference computes them in XLA outside any Pallas kernel
    (``repro/models/layers.py:402-417``). ``absorbed=False`` expands the
    cache and runs :func:`sdpa`; the two compute the same function."""
    m: MLAConfig = cfg.mla
    B = x.shape[0]
    H = cfg.num_heads
    cap = cache["c_kv"].shape[1]
    q_nope, q_rope = _mla_q(params, x, position[:, None], cfg)
    c_kv_t, k_rope_t = _mla_latent(params, x, position[:, None], cfg)
    slot = (position % cap).long()
    bidx = torch.arange(B, device=x.device)
    cache["c_kv"][bidx, slot] = c_kv_t[:, 0]
    cache["k_rope"][bidx, slot] = k_rope_t[:, 0, 0]
    cache["pos"][bidx, slot] = position.to(torch.int32)
    c_kv, k_rope, pos = cache["c_kv"], cache["k_rope"], cache["pos"]
    valid = (pos >= 0) & (pos <= position[:, None])
    if window:
        valid &= pos > position[:, None] - window

    if not absorbed:
        k_nope, v = _mla_kv_from_latent(params, c_kv, cfg)   # [B,cap,H,*]
        q, k = _mla_qk(q_nope, q_rope, k_nope, k_rope[:, :, None, :])
        out = sdpa(q, k, v, valid[:, None, None, :])
        return out.reshape(B, 1, -1) @ params["wo"], cache

    kv_up = params["kv_up"].reshape(m.kv_lora_rank, H,
                                    m.qk_nope_head_dim + m.v_head_dim)
    w_uk = kv_up[..., :m.qk_nope_head_dim]             # [r, H, nope]
    w_uv = kv_up[..., m.qk_nope_head_dim:]             # [r, H, v]
    # q absorbed through the K expansion: the scores live in latent space
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope[:, 0], w_uk)
    s = torch.einsum("bhr,bcr->bhc", q_lat.float(), c_kv.float())
    s = s + torch.einsum("bhp,bcp->bhc", q_rope[:, 0].float(), k_rope.float())
    s = s / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    s = torch.where(valid[:, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    ctx_lat = torch.einsum("bhc,bcr->bhr", p.to(c_kv.dtype), c_kv)
    out = torch.einsum("bhr,rhv->bhv", ctx_lat, w_uv)  # [B, H, v]
    return out.reshape(B, 1, H * m.v_head_dim) @ params["wo"], cache


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


def mlp_fwd(params, x, gated: bool, adapter=None) -> torch.Tensor:
    """The (gated) MLP at the rank's d_ff (the weights' width)."""
    ad = adapter or {}
    x = _column_input(x)
    h = _linear(params, x, "w_in", ad)
    if gated:
        h = F.silu(_linear(params, x, "w_gate", ad)) * h
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default form
    return _linear(params, h, "w_out", ad)
