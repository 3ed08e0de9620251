"""Plain PyTorch versions of the three kernels on the serving path.

Written the way ``repro/kernels/ref.py`` writes the JAX oracles: dense,
fp32, deliberately naive. On a CPU tensor the kernel wrappers in
``kernels/ops.py`` use these; on the card ``chip_smoke.py`` holds each
kernel against them. They compute in fp32; a caller on the card turns
TF32 off (``torch.backends.cuda.matmul.allow_tf32 = False``) so the
products stay fp32.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  q_offset: int = 0):
    """q [B,Sq,H,D], k/v [B,Sk,K,Dv]; H % K == 0. fp32 softmax, dense."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, D).float()
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k.float()) / math.sqrt(D)
    qi = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kj = torch.arange(Sk, device=q.device)[None, :]
    m = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        m = kj <= qi
        if window:
            m &= kj > qi - window
    s = torch.where(m, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,btkd->bqkgd", p, v.float())
    return o.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, pos, position, *,
                         window: int = 0):
    """One-token decode. q [B,H,D]; caches [B,C,K,D]; pos [B,C] absolute
    positions (-1 empty); position [B] current."""
    B, H, D = q.shape
    K = k_cache.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, D).float()
    s = torch.einsum("bkgd,bckd->bkgc", qg, k_cache.float()) / math.sqrt(D)
    cur = position[:, None]
    valid = (pos >= 0) & (pos <= cur)
    if window:
        valid &= pos > (cur - window)
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgc,bckd->bkgd", p, v_cache.float())
    return o.reshape(B, H, v_cache.shape[-1]).to(q.dtype)


def rmsnorm_ref(x, scale, eps: float = 1e-5):
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
