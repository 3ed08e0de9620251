"""Mamba2 SSD chunk scan — the CUDA kernels in ``csrc/ssd_scan.cu`` (B5).

Replaces ``repro/kernels/ssd_scan.py::ssd_scan`` (Pallas, ``_ssd_kernel``).
See the source's note for its bound on the H100 and its design. Two
routes, picked by :func:`route` from the dtype and the widths alone: bf16
at P 64, N 64 or 128 and a chunk that is a multiple of 64 (up to 512) runs
on the tensor cores (``wgmma``, tiles fed by TMA); the rest (fp32, the
smoke configs' small widths) on the CUDA cores. A route that does not
launch raises; nothing falls back.

x is read in place in its ``[B,S,H,P]`` layout and b and c in theirs: they
may be column slices of one wider tensor (the Mamba2 block's ``xbc``, rows
``d_inner + 2 d_state`` apart), so this wrapper copies no input. It raises
on any other layout, and, on the tensor-core route, on rows or pointers
that are not 16-byte aligned (TMA's rule). CUDA tensors only;
``kernels/ops.py`` routes a CPU tensor to ``ref.ssd_scan_ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

SOURCE = "src/repro_torch/kernels/csrc/ssd_scan.cu"
REPLACES = "src/repro/kernels/ssd_scan.py:72"
MAX_P, MAX_N = 64, 128
ROUTES = ("simt", "wgmma")          # the C entry's route codes 0 and 1
WG_P, WG_N, WG_TILE, WG_MAX_CHUNK = 64, (64, 128), 64, 512


def route(P: int, N: int, chunk: int, dtype: torch.dtype) -> str:
    """The kernel a call of these widths and dtype takes: "wgmma" (tensor
    cores) for bf16 at P 64, N 64 or 128 and a chunk that is a multiple of
    64 up to 512; "simt" (CUDA cores) otherwise."""
    if (dtype == torch.bfloat16 and P == WG_P and N in WG_N
            and chunk % WG_TILE == 0 and chunk <= WG_MAX_CHUNK):
        return "wgmma"
    return "simt"


def bc_row_stride(b: torch.Tensor, c: torch.Tensor) -> int:
    """The row stride (elements) that b and c [B,S,N] share, both laid out
    as rows of one [B,S,ld] tensor (contiguous, or column slices of a
    wider one); ValueError otherwise."""
    B, S, N = b.shape
    ld = b.stride(1)
    if (b.stride(2) != 1 or ld < N or (B > 1 and b.stride(0) != S * ld)
            or c.stride() != b.stride()):
        raise ValueError(f"ssd scan kernel reads b and c as rows of one "
                         f"[B,S,ld] layout; got strides {b.stride()} and "
                         f"{c.stride()} for shape {tuple(b.shape)}")
    return ld


@functools.lru_cache(maxsize=None)
def _fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.entry("rt_ssd_scan",
                       [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p])


def ssd_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, chunk: int):
    """x [B,S,H,P] (pre-multiplied by dt), a [B,S,H] log-decay increments
    (fp32 or x's dtype), b/c [B,S,N] of x's dtype -> (y [B,S,H,P],
    final_state [B,H,P,N]) in x's dtype, from a zero initial state."""
    tensors = (x, a, b, c)
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError("ssd scan kernel needs CUDA tensors on one device, "
                         f"got {[str(t.device) for t in tensors]}")
    B, S, H, P = x.shape
    N = b.shape[-1]
    if a.shape != (B, S, H) or b.shape != (B, S, N) or c.shape != b.shape:
        raise ValueError(f"bad shapes x {tuple(x.shape)} a {tuple(a.shape)} "
                         f"b {tuple(b.shape)} c {tuple(c.shape)}")
    if chunk <= 0 or S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of chunk {chunk}")
    if P > MAX_P or N > MAX_N:
        raise ValueError(f"ssd scan kernel takes head_dim <= {MAX_P} and "
                         f"d_state <= {MAX_N}, got {P} and {N}")
    if x.dtype not in (torch.bfloat16, torch.float32) or \
            not (b.dtype == c.dtype == x.dtype) or \
            a.dtype not in (torch.float32, x.dtype):
        raise TypeError(f"ssd scan kernel takes x in bf16 or fp32, b and c "
                        f"of x's dtype and a in fp32 or x's dtype, got x "
                        f"{x.dtype} a {a.dtype} b {b.dtype} c {c.dtype}")
    if not (x.is_contiguous() and a.is_contiguous()):
        raise ValueError("ssd scan kernel reads x and a in place and needs "
                         "them contiguous")
    ld = bc_row_stride(b, c)
    kind = route(P, N, chunk, x.dtype)
    if kind == "wgmma" and (ld % 8 or any(
            t.data_ptr() % 16 for t in (x, b, c))):
        raise ValueError("the tensor-core ssd scan loads its tiles by TMA: "
                         "x, b and c must start on 16-byte boundaries and "
                         f"b/c rows be a multiple of 16 bytes apart (ld {ld})")
    y = torch.empty_like(x)
    fin = torch.empty((B, H, P, N), dtype=x.dtype, device=x.device)
    err = _fn()(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                y.data_ptr(), fin.data_ptr(), B, S, H, P, N, chunk, ld,
                ROUTES.index(kind), build.dtype_code(x), build.dtype_code(a),
                build.stream_ptr())
    build.check(err, "rt_ssd_scan")
    return y, fin
