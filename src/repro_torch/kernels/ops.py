"""Dispatch over the port's kernels.

A tensor on the CPU goes to the kernel's plain PyTorch version
(``kernels/ref.py``); a CUDA tensor goes to the hand-written kernel, which
launches or raises — nothing falls back to the plain version. Unlike the
JAX package, where ``use_kernel`` flags default to off, the model always
routes these functions through here.

Attention and RMSNorm carry gradients: when autograd needs one (grad mode
on and an input that requires grad), :class:`FlashAttention` and
:class:`RMSNorm` run the forward kernel and save its residuals, and their
backward is a kernel too (B2-bwd, B1-bwd), or its plain version for a CPU
tensor. Without a gradient the forward is the plain launch serving makes.

A ``meta`` tensor (``core.trace``'s walk) goes to the kernel's wrapper,
which allocates what its launch would and launches nothing
(``build.shape_only``): it counts no launch.

``launches`` counts, per kernel, the launches made through this module
(and only those), so a run can show that its path went through the
kernels; :func:`reset_launches` sets every count to 0. The counts are
kept on the host, and a CUDA graph's replay runs no Python: a capture
(which records launches and runs none) goes inside :func:`capturing`,
which takes what it counted back off, and each replay adds it again with
:func:`add_launches`, so a graphed run counts what an eager one does.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_attention_bwd as _fab
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssd_scan as _ssd

KERNELS = ("rmsnorm", "flash_attention", "decode_attention",
           "paged_decode_attention", "ssd_scan", "flash_attention_bwd",
           "rmsnorm_bwd")
launches = {name: 0 for name in KERNELS}


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0


@contextlib.contextmanager
def capturing() -> Iterator[Dict[str, int]]:
    """Around a CUDA graph capture: yields a dict that holds, on exit, the
    launches counted inside, per kernel, and takes them back off
    ``launches``."""
    before = dict(launches)
    made: Dict[str, int] = {}
    try:
        yield made
    finally:
        for name in KERNELS:
            made[name] = launches[name] - before[name]
            launches[name] = before[name]


def add_launches(made: Dict[str, int]) -> None:
    """Count one replay of a graph whose capture counted ``made``."""
    for name, n in made.items():
        launches[name] += n


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def _count(name: str, t: torch.Tensor) -> None:
    """One launch of ``name``, made on ``t``'s device (none on ``meta``)."""
    if not _build.shape_only(t):
        launches[name] += 1


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _flash_fwd(q, k, v, causal, window, return_lse):
    if _on_cpu(q):
        return _ref.attention_ref(q, k, v, causal=causal, window=window,
                                  return_lse=return_lse)
    out = _fa.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                  return_lse=return_lse)
    _count("flash_attention", q)
    return out


class FlashAttention(torch.autograd.Function):
    """B2 with its gradient: the forward saves (q, k, v, out, lse); the
    backward is B2-bwd (``flash_attention_bwd``). Under activation
    checkpointing the recompute's forward saves its own out and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = _flash_fwd(q, k, v, causal, window, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        kw = dict(causal=ctx.causal, window=ctx.window)
        if _on_cpu(q):
            dq, dk, dv = _ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                                      **kw)
        else:
            dq, dk, dv = _fab.flash_attention_bwd(q, k, v, out, lse, dout,
                                                  **kw)
            _count("flash_attention_bwd", q)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    if _needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window)
    return _flash_fwd(q, k, v, causal, window, False)


def decode_attention(q, k_cache, v_cache, pos, position, *, window: int = 0):
    if _on_cpu(q):
        return _ref.decode_attention_ref(q, k_cache, v_cache, pos, position,
                                         window=window)
    out = _dec.decode_attention(q, k_cache, v_cache, pos, position,
                                window=window)
    _count("decode_attention", q)
    return out


def paged_decode_attention(q, k_pool, v_pool, block_tables, position):
    if _on_cpu(q):
        return _ref.paged_attention_ref(q, k_pool, v_pool, block_tables,
                                        position)
    out = _pa.paged_decode_attention(q, k_pool, v_pool, block_tables,
                                     position)
    _count("paged_decode_attention", q)
    return out


def _rmsnorm_fwd(x, scale, eps):
    if _on_cpu(x):
        return _ref.rmsnorm_ref(x, scale, eps)
    out = _rn.rmsnorm(x, scale, eps)
    _count("rmsnorm", x)
    return out


class RMSNorm(torch.autograd.Function):
    """B1 with its gradient: the forward saves (x, scale); the backward is
    B1-bwd (``rmsnorm.rmsnorm_bwd``), which computes dscale only when
    autograd asks for it (a frozen scale never does)."""

    @staticmethod
    def forward(ctx, x, scale, eps: float):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rmsnorm_fwd(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        want_ds = ctx.needs_input_grad[1]
        if _on_cpu(x):
            dx, ds = _ref.rmsnorm_bwd_ref(x, scale, dy, ctx.eps)
        else:
            dx, ds = _rn.rmsnorm_bwd(x, scale, dy, ctx.eps, dscale=want_ds)
            _count("rmsnorm_bwd", x)
        return dx, (ds if want_ds else None), None


def rmsnorm(x, scale, eps: float = 1e-5):
    if _needs_grad(x, scale):
        return RMSNorm.apply(x, scale, eps)
    return _rmsnorm_fwd(x, scale, eps)


def ssd_scan(x, a, b, c, chunk: int, initial_state=None):
    """Mamba2 SSD chunk scan -> (y, final_state). The kernel starts from a
    zero state (the prefill's case), as the reference's kernel path does
    (``repro/kernels/ops.py:37-42``). ``initial_state`` mirrors the
    reference's signature; nothing on the port's path passes it until the
    paged suffix prefill is ported. B5 has no backward kernel: on a CUDA
    tensor that needs a gradient it raises rather than return outputs
    the gradient would not flow through (a Mamba layer trains on the CPU
    path only; ROADMAP A11)."""
    if _on_cpu(x):
        return _ref.ssd_scan_ref(x, a, b, c, chunk, initial_state)
    if initial_state is not None:
        raise NotImplementedError(
            "the ssd scan kernel starts from a zero state (prefill)")
    if x.device.type == "cuda" and _needs_grad(x, a, b, c):
        raise NotImplementedError(
            "the ssd scan kernel (B5) has no backward: training a Mamba "
            "layer on the card is not ported (ROADMAP A11)")
    out = _ssd.ssd_scan(x, a, b, c, chunk)
    _count("ssd_scan", x)
    return out
