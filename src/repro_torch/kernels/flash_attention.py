"""Flash-attention forward — the CUDA kernel in ``csrc/flash_attention.cu``
(B2).

Replaces ``repro/kernels/flash_attention.py::flash_attention_fwd``
(Pallas, ``_fwd_kernel``). See the source's note for its bound on the
H100 and its design. Ragged Sq and Sk are masked inside the kernel, so
this wrapper pads nothing. CUDA tensors only; ``kernels/ops.py`` routes
a CPU tensor to ``ref.attention_ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:73"
HEAD_DIMS = (64, 128)


@functools.lru_cache(maxsize=None)
def _fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.entry("rt_flash_attention_fwd",
                       [p, p, p, p, i, i, i, i, i, i, i, i, i, p])


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """q [B,Sq,H,D]; k/v [B,Sk,K,D] with H % K == 0 -> [B,Sq,H,D]."""
    if not (q.device.type == "cuda" and k.device == q.device
            and v.device == q.device):
        raise ValueError(f"flash kernel needs CUDA tensors on one device, "
                         f"got {q.device}, {k.device}, {v.device}")
    B, Sq, H, D = q.shape
    Bk, Sk, K, Dk = k.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {HEAD_DIMS}, got {D}")
    if (Bk, Dk) != (B, D) or v.shape != k.shape or H % K:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, Sq, Sk, H, K, D, int(causal), int(window),
                build.dtype_code(q), build.stream_ptr())
    build.check(err, "rt_flash_attention_fwd")
    return out
