"""Flash-decode over the dense rolling KV cache — the CUDA kernel in
``csrc/decode_attention.cu`` (B3).

Replaces ``repro/kernels/decode_attention.py::decode_attention`` (Pallas,
``_decode_kernel``). See the source's note for its bound on the H100 and
its design. Masks come only from the cache's per-slot positions. CUDA
tensors only; ``kernels/ops.py`` routes a CPU tensor to
``ref.decode_attention_ref``.

The kernel splits the cache across blocks ("flash-decoding"). The split
rule, :func:`split_plan`, reads the shapes alone, never the data, so a
CUDA graph of the decode step could capture it: it aims at
``TARGET_BLOCKS`` = two blocks per SM of the H100's 132 over the B·K
(row, KV head) pairs, at most one split per ``STEP`` = 32 slots, and a
span that is a multiple of 32 slots, so no split is empty. With more
than one split, each block writes its unnormalised partial (m and l per
query head, acc [G, D], fp32) to scratch of B·H·splits·(D + 2) floats
that this wrapper allocates with ``torch.empty``, and a second kernel on
the same stream combines them; with one split the first kernel writes
the output and no scratch is made.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

SOURCE = "src/repro_torch/kernels/csrc/decode_attention.cu"
REPLACES = "src/repro/kernels/decode_attention.py:67"
HEAD_DIMS = (64, 128)
MAX_GROUP = 8
STEP = 32                   # slots a block reads per step (csrc STEP)
TARGET_BLOCKS = 2 * 132     # two blocks per SM of the H100


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_plan(B: int, K: int, C: int) -> tuple:
    """(splits, span) for a [B, C, K, D] cache: ``splits`` spans of
    ``span`` slots cover the C slots and none is empty."""
    splits = min(_cdiv(TARGET_BLOCKS, B * K), _cdiv(C, STEP))
    span = _cdiv(_cdiv(C, splits), STEP) * STEP
    return _cdiv(C, span), span


@functools.lru_cache(maxsize=None)
def _fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.entry("rt_decode_attention",
                       [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p])


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor,
                     position: torch.Tensor, *,
                     window: int = 0) -> torch.Tensor:
    """q [B,H,D]; caches [B,C,K,D]; pos [B,C] int32; position [B] ->
    [B,H,D]."""
    tensors = (q, k_cache, v_cache, pos, position)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("decode kernel needs CUDA tensors on one device, "
                         f"got {[str(t.device) for t in tensors]}")
    B, H, D = q.shape
    Bc, C, K, Dc = k_cache.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"decode kernel takes head_dim in {HEAD_DIMS}, got {D}")
    if (Bc, Dc) != (B, D) or v_cache.shape != k_cache.shape or H % K \
            or pos.shape != (B, C) or position.shape != (B,):
        raise ValueError(
            f"bad shapes q {tuple(q.shape)} caches {tuple(k_cache.shape)} "
            f"pos {tuple(pos.shape)} position {tuple(position.shape)}")
    if H // K > MAX_GROUP:
        raise ValueError(f"decode kernel takes at most {MAX_GROUP} query "
                         f"heads per KV head, got {H // K}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise TypeError("q and cache dtypes differ")
    q, k_cache, v_cache = q.contiguous(), k_cache.contiguous(), \
        v_cache.contiguous()
    pos = pos.to(torch.int32).contiguous()
    position = position.to(torch.int32).contiguous()
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("decode kernel loads 16 bytes a lane: q and the "
                         "caches must start on a 16-byte boundary")
    out = torch.empty_like(q)
    splits, span = split_plan(B, K, C)
    part = None if splits == 1 else torch.empty(
        B * H * splits * (D + 2), dtype=torch.float32, device=q.device)
    err = _fn()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                pos.data_ptr(), position.data_ptr(), out.data_ptr(),
                None if part is None else part.data_ptr(),
                B, C, H, K, D, span, splits, int(window),
                build.dtype_code(q), build.stream_ptr())
    build.check(err, "rt_decode_attention")
    return out
