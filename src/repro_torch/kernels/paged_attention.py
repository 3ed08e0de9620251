"""Paged flash-decode over a block-table-indexed KV pool — the CUDA kernel
in ``csrc/paged_attention.cu`` (B4).

Replaces ``repro/paged/attention.py::paged_decode_attention`` (Pallas,
``_paged_decode_kernel``). See the source's note for its bound on the
H100 and its design. The pools are read in place: this wrapper copies
neither of them and raises on a pool that is not contiguous. CUDA tensors
only; ``kernels/ops.py`` routes a CPU tensor to
``ref.paged_attention_ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

SOURCE = "src/repro_torch/kernels/csrc/paged_attention.cu"
REPLACES = "src/repro/paged/attention.py:127"
HEAD_DIMS = (64, 128)
MAX_GROUP = 8


@functools.lru_cache(maxsize=None)
def _fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.entry("rt_paged_decode_attention",
                       [p, p, p, p, p, p, i, i, i, i, i, i, i, p])


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           position: torch.Tensor) -> torch.Tensor:
    """q [B,H,D]; pools [P,ps,K,D]; block_tables [B,nb] int32 with entries
    in [-1, P); position [B] int32 -> [B,H,D]."""
    tensors = (q, k_pool, v_pool, block_tables, position)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("paged decode kernel needs CUDA tensors on one "
                         f"device, got {[str(t.device) for t in tensors]}")
    B, H, D = q.shape
    _, ps, K, Dp = k_pool.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"paged decode kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {D}")
    if Dp != D or v_pool.shape != k_pool.shape or H % K \
            or block_tables.dim() != 2 or block_tables.shape[0] != B \
            or block_tables.shape[1] < 1 or position.shape != (B,):
        raise ValueError(
            f"bad shapes q {tuple(q.shape)} pools {tuple(k_pool.shape)} "
            f"block_tables {tuple(block_tables.shape)} position "
            f"{tuple(position.shape)}")
    if H // K > MAX_GROUP:
        raise ValueError(f"paged decode kernel takes at most {MAX_GROUP} "
                         f"query heads per KV head, got {H // K}")
    if not (q.dtype == k_pool.dtype == v_pool.dtype):
        raise TypeError("q and pool dtypes differ")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("paged decode kernel reads the pools in place and "
                         "needs them contiguous")
    q = q.contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    position = position.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool, out)):
        raise ValueError("paged decode kernel loads 16 bytes at a time and "
                         "needs 16-byte aligned q and pools")
    err = _fn()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                bt.data_ptr(), position.data_ptr(), out.data_ptr(),
                B, bt.shape[1], ps, H, K, D, build.dtype_code(q),
                build.stream_ptr())
    build.check(err, "rt_paged_decode_attention")
    return out
