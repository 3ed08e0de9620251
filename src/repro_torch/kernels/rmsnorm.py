"""Fused RMSNorm and its backward — the CUDA kernels in ``csrc/rmsnorm.cu``
(B1, and B1-bwd in :func:`rmsnorm_bwd`).

Replaces ``repro/kernels/rmsnorm.py::rmsnorm`` (Pallas, ``_rmsnorm_kernel``).
See the source's note for its bound on the H100 and its design: one warp
per row, several rows a block, 16-byte loads where :func:`plan` allows
them, and a streaming variant for many rows. The plan reads the row
count, the width, the dtypes and whether the pointers are 16-byte
aligned, never the data, and is cached: the decode step calls this
wrapper ~60-100 times, and its host time counts there. This module
launches the kernel on CUDA tensors only; ``kernels/ops.py`` routes a CPU
tensor to ``ref.rmsnorm_ref``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

SOURCE = "src/repro_torch/kernels/csrc/rmsnorm.cu"
REPLACES = "src/repro/kernels/rmsnorm.py:21"
REPLACES_BWD = "src/repro/models/layers.py:33 (rms_norm, XLA autodiff)"
VEC_BYTES = 16
MAX_WARPS = 8                       # rows a block (csrc MAX_WARPS)
PER_LANE = (1, 2, 4, 8, 12, 16)     # 16-byte vectors a lane may hold
STREAM_ROWS = 1024                  # from here on, the streaming variant
DSCALE_CHUNK = 64                   # rows a dscale partial sums
BWD_PER_LANE = 12                   # the backward's vector route holds dy too


class Plan(NamedTuple):
    route: str        # "vector" (16-byte loads, x read once) or "scalar"
    vec: int          # elements a load: 8 bf16 / 4 fp32, or 1
    per_lane: int     # 16-byte vectors of x a lane holds; 0 on "scalar"
    warps: int        # rows (warps) a block
    blocks: int
    streaming: bool   # many rows: scale read late, x and y evict-first


@functools.lru_cache(maxsize=256)
def plan(rows: int, D: int, x_dtype: torch.dtype, scale_dtype: torch.dtype,
         aligned: bool = True) -> Plan:
    """The launch for ``rows`` rows of width D: one warp a row, up to
    ``MAX_WARPS`` rows a block; the vector route where x and the scale
    share a dtype, a row is whole 16-byte vectors and fits in 16 of them a
    lane, and the pointers are ``aligned`` (its streaming variant from
    ``STREAM_ROWS`` rows on); the scalar route otherwise."""
    warps = max(1, min(MAX_WARPS, rows))
    blocks = -(-rows // warps)
    vec = VEC_BYTES // x_dtype.itemsize
    if scale_dtype == x_dtype and aligned and D % vec == 0:
        need = -(-(D // vec) // 32)
        for per_lane in PER_LANE:
            if per_lane >= need:
                return Plan("vector", vec, per_lane, warps, blocks,
                            rows >= STREAM_ROWS)
    return Plan("scalar", 1, 0, warps, blocks, False)


@functools.lru_cache(maxsize=None)
def _fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.entry("rt_rmsnorm",
                       [p, p, p, i, i, ctypes.c_float, i, i, i, i, i, p])


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x [..., D] (bf16 or f32), scale [D] -> x's shape and dtype."""
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"rmsnorm kernel needs CUDA tensors on one device, "
                         f"got {x.device} and {scale.device}")
    D = x.shape[-1]
    if scale.shape != (D,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != ({D},)")
    x = x.contiguous()
    scale = scale.contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // D
    ptrs = x.data_ptr() | scale.data_ptr() | out.data_ptr()
    aligned = ptrs % VEC_BYTES == 0
    pl = plan(rows, D, x.dtype, scale.dtype, aligned)
    err = _fn()(x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, D,
                float(eps), build.dtype_code(x), build.dtype_code(scale),
                pl.per_lane, pl.warps, int(pl.streaming), build.stream_ptr())
    build.check(err, "rt_rmsnorm")
    return out


@functools.lru_cache(maxsize=None)
def _bwd_fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.entry("rt_rmsnorm_bwd",
                       [p] * 7 + [i, i, ctypes.c_float] + [i] * 5 + [p])


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-5, *, dscale: bool = True):
    """Gradients of :func:`rmsnorm`: x and dy [..., D] of one dtype, scale
    [D] -> (dx like x, dscale [D] of scale's dtype, or None when
    ``dscale`` is False). Launched with :func:`rmsnorm`'s plan (the vector
    route needs dy and dx aligned too, and takes rows of up to
    ``BWD_PER_LANE`` vectors a lane; wider rows take the scalar route).
    """
    if not (x.device.type == "cuda" and scale.device == x.device
            and dy.device == x.device):
        raise ValueError(f"rmsnorm backward needs CUDA tensors on one device, "
                         f"got {x.device}, {scale.device}, {dy.device}")
    D = x.shape[-1]
    if scale.shape != (D,) or dy.shape != x.shape:
        raise ValueError(f"shapes x {tuple(x.shape)} scale "
                         f"{tuple(scale.shape)} dy {tuple(dy.shape)}")
    if dy.dtype != x.dtype:
        raise TypeError(f"dy dtype {dy.dtype} != x dtype {x.dtype}")
    x, scale, dy = x.contiguous(), scale.contiguous(), dy.contiguous()
    dx = torch.empty_like(x)
    rows = x.numel() // D
    ptrs = x.data_ptr() | scale.data_ptr() | dy.data_ptr() | dx.data_ptr()
    pl = plan(rows, D, x.dtype, scale.dtype, ptrs % VEC_BYTES == 0)
    per_lane = pl.per_lane if pl.per_lane <= BWD_PER_LANE else 0
    ds = rstd = part = None
    if dscale:
        ds = torch.empty_like(scale)
        rstd = torch.empty((rows,), dtype=torch.float32, device=x.device)
        part = torch.empty((-(-rows // DSCALE_CHUNK), D), dtype=torch.float32,
                           device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    err = _bwd_fn()(x.data_ptr(), scale.data_ptr(), dy.data_ptr(),
                    dx.data_ptr(), ptr(ds), ptr(rstd), ptr(part), rows, D,
                    float(eps), build.dtype_code(x), build.dtype_code(scale),
                    per_lane, pl.warps, DSCALE_CHUNK, build.stream_ptr())
    build.check(err, "rt_rmsnorm_bwd")
    return dx, ds
