"""Layer-level paged decode — the port of
``repro/paged/attention.py::paged_attention_decode`` (the paged twin of
``layers.attention_decode``, with its LoRA ``adapter=``), and of its
T-query twin for the speculative-decode verify
(``paged_attention_reference_multi``, ``paged_attention_decode_multi``).

The one-query attention goes through ``kernels/ops.py``: the
hand-written paged-decode kernel (B4) on CUDA, its plain version on the
CPU. The T-query attention is the reference's plain gather and masked
fp32 softmax on both, as the reference runs it outside Pallas.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.paged.paged_cache import (Pool, append_decode,
                                           append_decode_multi, gather_kv)


def paged_attention_decode(params, x: torch.Tensor, position: torch.Tensor,
                           pool: Pool, block_tables: torch.Tensor,
                           cfg: ModelConfig, adapter=None):
    """One-token decode against a paged pool. x [B,1,D]; position [B]
    absolute (== logical index; paged sequences are densely 0-indexed).
    ``adapter``: the layer's LoRA site dict (unmerged A·B on the
    projections). Appends this step's K/V to the pool in place, then
    attends over the block table. Returns (out [B,1,D], pool)."""
    B = x.shape[0]
    q, k, v = L._project_qkv(params, x, cfg, adapter)
    sin, cos = L.rope_tables(position[:, None], cfg.resolved_head_dim(),
                             cfg.rope_theta)
    q = L.apply_rope(q, sin, cos)
    k = L.apply_rope(k, sin, cos)
    append_decode(pool, k[:, 0], v[:, 0], block_tables, position)
    out = ops.paged_decode_attention(q[:, 0], pool["k"], pool["v"],
                                     block_tables, position)
    return L._linear(params, out.reshape(B, 1, -1), "wo", adapter or {}), pool


def paged_attention_reference_multi(q: torch.Tensor, pool: Pool,
                                    block_tables: torch.Tensor,
                                    positions: torch.Tensor) -> torch.Tensor:
    """Multi-query paged attention. q [B,T,H,D]; positions [B,T] (each
    query's last valid logical index; a -1 query sees nothing and gives a
    row the caller ignores) -> [B,T,H,D]. Token j of a draft run is
    context for token j+1, since validity is per query. Gathers the
    sequences' pages ([B, nb*ps, K, D]), then ``layers.sdpa`` in fp32."""
    B = q.shape[0]
    ps = pool["k"].shape[1]
    k, v = gather_kv(pool, block_tables)                 # [B, S, K, D]
    S = k.shape[1]
    idx = torch.arange(S, device=q.device)
    nb = block_tables.shape[1]
    # expanded, not repeat_interleave'd: no host sync inside a graph capture
    allocated = (block_tables >= 0)[:, :, None].expand(B, nb, ps) \
        .reshape(B, S)
    valid = allocated[:, None, :] \
        & (idx[None, None, :] <= positions[:, :, None])  # [B, T, S]
    return L.sdpa(q.float(), k.float(), v.float(),
                  valid[:, None]).to(q.dtype)


def paged_attention_decode_multi(params, x: torch.Tensor,
                                 positions: torch.Tensor, pool: Pool,
                                 block_tables: torch.Tensor,
                                 cfg: ModelConfig, adapter=None):
    """T-token decode against a paged pool (the speculative-decode
    verify). x [B,T,D]; positions [B,T] logical indices (consecutive per
    row; -1 entries are dropped writes and all-masked queries);
    ``adapter`` as in :func:`paged_attention_decode`. Appends all T K/V
    in place first, then attends with per-query position masks. Returns
    (out [B,T,D], pool)."""
    B, T = x.shape[:2]
    q, k, v = L._project_qkv(params, x, cfg, adapter)
    sin, cos = L.rope_tables(positions, cfg.resolved_head_dim(),
                             cfg.rope_theta)
    q = L.apply_rope(q, sin, cos)
    k = L.apply_rope(k, sin, cos)
    append_decode_multi(pool, k, v, block_tables, positions)
    out = paged_attention_reference_multi(q, pool, block_tables, positions)
    return L._linear(params, out.reshape(B, T, -1), "wo", adapter or {}), pool
