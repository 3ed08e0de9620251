"""Dispatch over the port's kernels.

A tensor on the CPU goes to the kernel's plain PyTorch version
(``kernels/ref.py``); a CUDA tensor goes to the hand-written kernel, which
launches or raises — nothing falls back to the plain version. Unlike the
JAX package, where ``use_kernel`` flags default to off, the model always
routes these functions through here.

``launches`` counts, per kernel, the launches made through this module
(and only those), so a run can show that its path went through the
kernels; :func:`reset_launches` sets every count to 0.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssd_scan as _ssd

KERNELS = ("rmsnorm", "flash_attention", "decode_attention",
           "paged_decode_attention", "ssd_scan")
launches = {name: 0 for name in KERNELS}


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    if _on_cpu(q):
        return _ref.attention_ref(q, k, v, causal=causal, window=window)
    out = _fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    launches["flash_attention"] += 1
    return out


def decode_attention(q, k_cache, v_cache, pos, position, *, window: int = 0):
    if _on_cpu(q):
        return _ref.decode_attention_ref(q, k_cache, v_cache, pos, position,
                                         window=window)
    out = _dec.decode_attention(q, k_cache, v_cache, pos, position,
                                window=window)
    launches["decode_attention"] += 1
    return out


def paged_decode_attention(q, k_pool, v_pool, block_tables, position):
    if _on_cpu(q):
        return _ref.paged_attention_ref(q, k_pool, v_pool, block_tables,
                                        position)
    out = _pa.paged_decode_attention(q, k_pool, v_pool, block_tables,
                                     position)
    launches["paged_decode_attention"] += 1
    return out


def rmsnorm(x, scale, eps: float = 1e-5):
    if _on_cpu(x):
        return _ref.rmsnorm_ref(x, scale, eps)
    out = _rn.rmsnorm(x, scale, eps)
    launches["rmsnorm"] += 1
    return out


def ssd_scan(x, a, b, c, chunk: int, initial_state=None):
    """Mamba2 SSD chunk scan -> (y, final_state). The kernel starts from a
    zero state (the prefill's case), as the reference's kernel path does
    (``repro/kernels/ops.py:37-42``). ``initial_state`` mirrors the
    reference's signature; nothing on the port's path passes it until the
    paged suffix prefill is ported."""
    if _on_cpu(x):
        return _ref.ssd_scan_ref(x, a, b, c, chunk, initial_state)
    if initial_state is not None:
        raise NotImplementedError(
            "the ssd scan kernel starts from a zero state (prefill)")
    out = _ssd.ssd_scan(x, a, b, c, chunk)
    launches["ssd_scan"] += 1
    return out
