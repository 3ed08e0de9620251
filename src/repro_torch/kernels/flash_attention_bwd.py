"""Flash-attention backward — the CUDA kernels in
``csrc/flash_attention_bwd.cu`` (B2-bwd).

The TPU package has no Pallas backward; its model differentiates
attention through the XLA custom VJP ``repro/models/flash.py::_bwd``,
which this replaces. See the source's note for its bound on the H100 and
its design (a delta pre-pass, a dK/dV kernel per key tile that sums over
the query group inside the block, a dQ kernel per query tile; no atomics).
CUDA tensors only; ``kernels/ops.py`` routes a CPU tensor to
``ref.flash_attention_bwd_ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import HEAD_DIMS

SOURCE = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
REPLACES = "src/repro/models/flash.py:98 (_bwd, XLA)"


@functools.lru_cache(maxsize=None)
def _fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.entry("rt_flash_attention_bwd",
                       [p] * 10 + [i] * 9 + [p])


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: int = 0):
    """q/out/dout [B,Sq,H,D], k/v [B,Sk,K,D], lse [B,Sq,H] fp32 (from
    ``flash_attention_fwd(return_lse=True)``) -> (dq, dk, dv) in the
    inputs' shapes and dtype."""
    ts = (q, k, v, out, lse, dout)
    if not all(t.device.type == "cuda" and t.device == q.device for t in ts):
        raise ValueError("flash backward needs CUDA tensors on one device, "
                         f"got {[str(t.device) for t in ts]}")
    B, Sq, H, D = q.shape
    Bk, Sk, K, Dk = k.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"flash backward takes head_dim in {HEAD_DIMS}, "
                         f"got {D}")
    if (Bk, Dk) != (B, D) or v.shape != k.shape or H % K or \
            out.shape != q.shape or dout.shape != q.shape or \
            lse.shape != (B, Sq, H):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} out {tuple(out.shape)} dout "
                         f"{tuple(dout.shape)} lse {tuple(lse.shape)}")
    if not (q.dtype == k.dtype == v.dtype == out.dtype == dout.dtype) or \
            lse.dtype != torch.float32:
        raise TypeError(f"dtypes q {q.dtype} k {k.dtype} v {v.dtype} out "
                        f"{out.dtype} dout {dout.dtype} lse {lse.dtype}")
    q, k, v, out, lse, dout = (t.contiguous() for t in ts)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, Sq, H), dtype=torch.float32, device=q.device)
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                B, Sq, Sk, H, K, D, int(causal), int(window),
                build.dtype_code(q), build.stream_ptr())
    build.check(err, "rt_flash_attention_bwd")
    return dq, dk, dv
