"""Mamba2 SSD chunk scan — the CUDA kernel in ``csrc/ssd_scan.cu`` (B5).

Replaces ``repro/kernels/ssd_scan.py::ssd_scan`` (Pallas, ``_ssd_kernel``).
See the source's note for its bound on the H100 and its design. x is read
in place in its ``[B,S,H,P]`` layout: this wrapper copies no input and
raises on one that is not contiguous. CUDA tensors only;
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


@functools.lru_cache(maxsize=None)
def _fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.entry("rt_ssd_scan",
                       [p, p, p, p, p, p, i, i, i, i, i, i, i, i, p])


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
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd scan kernel reads its inputs in place and "
                         "needs them contiguous")
    y = torch.empty_like(x)
    fin = torch.empty((B, H, P, N), dtype=x.dtype, device=x.device)
    err = _fn()(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                y.data_ptr(), fin.data_ptr(), B, S, H, P, N, chunk,
                build.dtype_code(x), build.dtype_code(a), build.stream_ptr())
    build.check(err, "rt_ssd_scan")
    return y, fin
