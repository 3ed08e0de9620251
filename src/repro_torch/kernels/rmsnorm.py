"""Fused RMSNorm — the CUDA kernel in ``csrc/rmsnorm.cu`` (B1).

Replaces ``repro/kernels/rmsnorm.py::rmsnorm`` (Pallas, ``_rmsnorm_kernel``).
See the source's note for its bound on the H100 and its design. This
module launches the kernel on CUDA tensors only; ``kernels/ops.py``
routes a CPU tensor to ``ref.rmsnorm_ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

SOURCE = "src/repro_torch/kernels/csrc/rmsnorm.cu"
REPLACES = "src/repro/kernels/rmsnorm.py:21"


@functools.lru_cache(maxsize=None)
def _fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.entry("rt_rmsnorm",
                       [p, p, p, i, i, ctypes.c_float, i, i, p])


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
    err = _fn()(x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, D,
                float(eps), build.dtype_code(x), build.dtype_code(scale),
                build.stream_ptr())
    build.check(err, "rt_rmsnorm")
    return out
