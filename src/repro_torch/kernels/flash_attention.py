"""Flash-attention forward — the CUDA kernel in ``csrc/flash_attention.cu``
(B2).

Replaces ``repro/kernels/flash_attention.py::flash_attention_fwd``
(Pallas, ``_fwd_kernel``). See the source's note for its bound on the
H100 and its design: bf16 runs on the tensor cores (``wgmma``, K/V tiles
fed by TMA), fp32 on the CUDA cores, a dispatch by dtype inside the one C
entry. Ragged Sq and Sk are masked inside the kernel, so this wrapper
pads nothing. The (q/k, v) head widths are one of :data:`HEAD_DIMS`:
(64, 64), (128, 128), or DeepSeek-V3 MLA's (192, 128), whose v rows are
narrower than its q and k rows; any other pair raises. CUDA tensors
only; ``kernels/ops.py`` routes a CPU tensor to ``ref.attention_ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:73"
HEAD_DIMS = ((64, 64), (128, 128), (192, 128))     # (q/k width, v width)


@functools.lru_cache(maxsize=None)
def _fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.entry("rt_flash_attention_fwd",
                       [p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p])


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        return_lse: bool = False):
    """q [B,Sq,H,D], k [B,Sk,K,D], v [B,Sk,K,Dv] with H % K == 0 and
    (D, Dv) in :data:`HEAD_DIMS` -> out [B,Sq,H,Dv];
    with ``return_lse``, (out, lse) where lse [B,Sq,H] fp32 is each row's
    log-normaliser, the residual the backward (``flash_attention_bwd``)
    starts from."""
    if not (q.device.type in build.DEVICES and k.device == q.device
            and v.device == q.device):
        raise ValueError(f"flash kernel needs CUDA tensors on one device, "
                         f"got {q.device}, {k.device}, {v.device}")
    B, Sq, H, D = q.shape
    Bk, Sk, K, Dk = k.shape
    Dv = v.shape[-1]
    if (D, Dv) not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim pairs (q/k, v) in "
                         f"{HEAD_DIMS}, got ({D}, {Dv})")
    if (Bk, Dk) != (B, D) or v.shape[:3] != k.shape[:3] or H % K:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash kernel's tile loads need q, k and v to start "
                         "on a 16-byte boundary")
    out = q.new_empty((B, Sq, H, Dv))
    lse = torch.empty((B, Sq, H), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if build.shape_only(q):
        return (out, lse) if return_lse else out
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(),
                B, Sq, Sk, H, K, D, Dv, int(causal), int(window),
                build.dtype_code(q), build.stream_ptr())
    build.check(err, "rt_flash_attention_fwd")
    return (out, lse) if return_lse else out
