"""Layer-level paged decode — the port of
``repro/paged/attention.py::paged_attention_decode`` (the paged twin of
``layers.attention_decode``), without the LoRA adapter.

The attention itself goes through ``kernels/ops.py``: the hand-written
paged-decode kernel (B4) on CUDA, its plain version on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.paged.paged_cache import Pool, append_decode


def paged_attention_decode(params, x: torch.Tensor, position: torch.Tensor,
                           pool: Pool, block_tables: torch.Tensor,
                           cfg: ModelConfig):
    """One-token decode against a paged pool. x [B,1,D]; position [B]
    absolute (== logical index; paged sequences are densely 0-indexed).
    Appends this step's K/V to the pool in place, then attends over the
    block table. Returns (out [B,1,D], pool)."""
    B = x.shape[0]
    q, k, v = L._project_qkv(params, x, cfg)
    sin, cos = L.rope_tables(position[:, None], cfg.resolved_head_dim(),
                             cfg.rope_theta)
    q = L.apply_rope(q, sin, cos)
    k = L.apply_rope(k, sin, cos)
    append_decode(pool, k[:, 0], v[:, 0], block_tables, position)
    out = ops.paged_decode_attention(q[:, 0], pool["k"], pool["v"],
                                     block_tables, position)
    return out.reshape(B, 1, -1) @ params["wo"], pool
