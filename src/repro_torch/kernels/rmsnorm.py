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
tensor to ``ref.rmsnorm_ref``. The backward's launch, :func:`bwd_plan`, is
shape-only and cached too: with dscale it fixes the blocks, the rows each
covers and so the order of dscale's sum.
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
BWD_PER_LANE = 12                   # the backward's vector route holds dy too
SMS = 132                           # the H100's SMs
SMEM_BYTES = 227 * 1024             # shared memory a block may use


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
    if x.device.type not in build.DEVICES or scale.device != x.device:
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
    if build.shape_only(x):
        return out
    err = _fn()(x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, D,
                float(eps), build.dtype_code(x), build.dtype_code(scale),
                pl.per_lane, pl.warps, int(pl.streaming), build.stream_ptr())
    build.check(err, "rt_rmsnorm")
    return out


class BwdPlan(NamedTuple):
    route: str        # "vector" (16-byte loads, x and dy read once) or "scalar"
    per_lane: int     # 16-byte vectors of x (and of dy) a lane holds
    warps: int        # warps a block
    blocks: int       # with dscale, also the partial rows summed
    rows: int

    def block_rows(self, b: int) -> range:
        """The contiguous rows block ``b`` takes (csrc ``block_rows``)."""
        return range(b * self.rows // self.blocks,
                     (b + 1) * self.rows // self.blocks)

    def warp_rows(self, b: int, w: int) -> range:
        """The rows warp ``w`` of block ``b`` walks, in order."""
        rows = self.block_rows(b)
        return range(rows.start + w, rows.stop, self.warps)


@functools.lru_cache(maxsize=256)
def bwd_plan(rows: int, D: int, x_dtype: torch.dtype,
             scale_dtype: torch.dtype, aligned: bool = True,
             dscale: bool = True) -> BwdPlan:
    """The backward's launch: :func:`plan`'s route, vectors and warps
    (the vector route up to ``BWD_PER_LANE`` vectors a lane). Without
    dscale one warp a row, as the forward. With dscale one block an SM
    (no more than the rows' warps ask for), each over a contiguous range
    of rows, and each block writes one fp32 partial row that a second
    kernel sums; the scalar route's warps keep a row of D fp32 each in
    shared memory, so fewer of them fit a block as D grows."""
    fwd = plan(rows, D, x_dtype, scale_dtype, aligned)
    route, per_lane = fwd.route, fwd.per_lane
    if per_lane > BWD_PER_LANE:
        route, per_lane = "scalar", 0
    warps = fwd.warps
    if dscale and route == "scalar":
        warps = min(warps, SMEM_BYTES // (4 * D))
        if warps < 1:
            raise ValueError(f"rmsnorm backward with dscale takes rows of "
                             f"at most {SMEM_BYTES // 4} elements, got {D}")
    blocks = -(-rows // warps)
    if dscale:
        blocks = min(blocks, SMS)
    return BwdPlan(route, per_lane, warps, blocks, rows)


@functools.lru_cache(maxsize=None)
def _bwd_fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.entry("rt_rmsnorm_bwd",
                       [p] * 6 + [i, i, ctypes.c_float] + [i] * 5 + [p])


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-5, *, dscale: bool = True):
    """Gradients of :func:`rmsnorm`: x and dy [..., D] of one dtype, scale
    [D] -> (dx like x, dscale [D] of scale's dtype, or None when
    ``dscale`` is False), launched by :func:`bwd_plan` (the vector route
    needs dy and dx aligned too). With dscale, dx and dscale come from one
    pass over x and dy; dscale's sum has a fixed order (no atomics), so two
    calls give the same bits."""
    if not (x.device.type in build.DEVICES and scale.device == x.device
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
    pl = bwd_plan(rows, D, x.dtype, scale.dtype, ptrs % VEC_BYTES == 0,
                  dscale)
    ds = part = None
    if dscale:
        ds = torch.empty_like(scale)
        part = torch.empty((pl.blocks, D), dtype=torch.float32,
                           device=x.device)
    if build.shape_only(x):
        return dx, ds
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    err = _bwd_fn()(x.data_ptr(), scale.data_ptr(), dy.data_ptr(),
                    dx.data_ptr(), ptr(ds), ptr(part), rows, D, float(eps),
                    build.dtype_code(x), build.dtype_code(scale),
                    pl.per_lane, pl.warps, pl.blocks, build.stream_ptr())
    build.check(err, "rt_rmsnorm_bwd")
    return dx, ds
