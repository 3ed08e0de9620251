"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) block — the port
of ``repro/models/mamba.py:85-197``.

The full-sequence path runs the chunked SSD scan through
``kernels/ops.py::ssd_scan``: the hand-written kernel (B5) on CUDA, the
plain chunked version on the CPU. Decode is the O(1)-state recurrence,
which has no kernel. Every dtype cast of the reference is kept: the
decay parameters ``dt_bias``, ``A_log`` and ``D`` stay fp32 in a bf16
model, and dt is computed in fp32.

Unlike the reference's pure function, :func:`mamba_decode` writes the
layer's conv and SSM states in place, as the port's KV caches are
written.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L


def init_mamba(generator: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    s: SSMConfig = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.n_heads(d)
    conv_dim = di + 2 * s.d_state
    dev = generator.device
    u = torch.rand((nh,), generator=L.draws(generator), device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    return {
        "in_proj": L._init(generator, (d, 2 * di + 2 * s.d_state + nh),
                           dtype=dtype),
        "conv_w": L._init(generator, (s.d_conv, conv_dim), scale=0.2,
                          dtype=dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "dt_bias": (dt + torch.log(-torch.expm1(-dt))).float(),
        "A_log": torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                        device=dev)),
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "norm": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": L._init(generator, (di, d),
                            scale=0.02 / math.sqrt(2 * cfg.num_layers),
                            dtype=dtype),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 prepend: Optional[torch.Tensor] = None):
    """Depthwise causal conv. xbc [B,S,C], w [W,C]. Returns (y, tail) where
    tail is the last W-1 inputs (the decode conv state). The sum of W
    shifted products, as the reference writes it, so bf16 rounds at the
    same points."""
    W = w.shape[0]
    B, S, C = xbc.shape
    if prepend is None:
        prepend = torch.zeros((B, W - 1, C), dtype=xbc.dtype,
                              device=xbc.device)
    full = torch.cat([prepend, xbc], dim=1)                    # [B,S+W-1,C]
    y = sum(full[:, i:i + S] * w[i] for i in range(W))
    # a copy, so the decode state does not keep ``full`` alive
    tail = full[:, -(W - 1):].clone() if W > 1 else full[:, :0].clone()
    return y + bias, tail


def _split_zxbcdt(z_xbc_dt: torch.Tensor, di: int, n: int, nh: int):
    z = z_xbc_dt[..., :di]
    xbc = z_xbc_dt[..., di:2 * di + 2 * n]
    dt = z_xbc_dt[..., 2 * di + 2 * n:]
    return z, xbc, dt


def mamba_fwd(params, x: torch.Tensor, cfg: ModelConfig, *,
              return_state: bool = False):
    """Full-sequence forward. x [B,S,D] -> y [B,S,D] (and, with
    ``return_state``, the decode cache {conv_state, ssm_state})."""
    s: SSMConfig = cfg.ssm
    d = cfg.d_model
    di, n, nh, p = s.d_inner(d), s.d_state, s.n_heads(d), s.head_dim
    B, S, _ = x.shape
    z, xbc, dt = _split_zxbcdt(x @ params["in_proj"], di, n, nh)
    xbc, conv_tail = _causal_conv(xbc, params["conv_w"], params["conv_b"])
    xbc = F.silu(xbc)
    xs = xbc[..., :di].reshape(B, S, nh, p)
    # b and c are column slices of xbc (rows d_inner + 2 d_state apart); the
    # kernel reads them in place
    b_mat = xbc[..., di:di + n]
    c_mat = xbc[..., di + n:]
    dt = F.softplus(dt.float() + params["dt_bias"])            # [B,S,nh]
    A = -torch.exp(params["A_log"])                            # [nh]
    y, final_state = ops.ssd_scan(
        xs * dt.to(xs.dtype)[..., None], dt * A, b_mat, c_mat,
        min(s.chunk_size, S))
    y = y + params["D"].to(y.dtype)[None, None, :, None] * xs
    y = y.reshape(B, S, di)
    y = L.rms_norm(y * F.silu(z), {"scale": params["norm"]}, cfg.norm_eps)
    out = y @ params["out_proj"]
    if return_state:
        return out, {"conv_state": conv_tail, "ssm_state": final_state}
    return out


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    s: SSMConfig = cfg.ssm
    d = cfg.d_model
    di, n, nh, p = s.d_inner(d), s.d_state, s.n_heads(d), s.head_dim
    return {
        "conv_state": torch.zeros((batch, s.d_conv - 1, di + 2 * n),
                                  dtype=dtype, device=device),
        "ssm_state": torch.zeros((batch, nh, p, n), dtype=dtype,
                                 device=device),
    }


def mamba_decode(params, x: torch.Tensor, cache: dict, cfg: ModelConfig):
    """One-token recurrent step. x [B,1,D] -> (y [B,1,D], cache); the
    cache's conv and SSM states are updated in place."""
    s: SSMConfig = cfg.ssm
    d = cfg.d_model
    di, n, nh, p = s.d_inner(d), s.d_state, s.n_heads(d), s.head_dim
    B = x.shape[0]
    z, xbc_t, dt = _split_zxbcdt(x[:, 0] @ params["in_proj"], di, n, nh)
    window = torch.cat([cache["conv_state"], xbc_t[:, None]], dim=1)
    conv = torch.einsum("bwc,wc->bc", window, params["conv_w"]) + \
        params["conv_b"]
    conv = F.silu(conv)
    cache["conv_state"].copy_(window[:, 1:])
    xs = conv[..., :di].reshape(B, nh, p)
    b_vec = conv[..., di:di + n]
    c_vec = conv[..., di + n:]
    dt = F.softplus(dt.float() + params["dt_bias"])            # [B,nh]
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt * A)                                     # [B,nh]
    upd = (dt.to(xs.dtype)[..., None] * xs)[..., None] * \
        b_vec[:, None, None, :]
    state = cache["ssm_state"]
    state.mul_(dA[..., None, None].to(xs.dtype)).add_(upd)
    y = torch.einsum("bhpn,bn->bhp", state, c_vec)
    y = y + params["D"].to(y.dtype)[None, :, None] * xs
    y = y.reshape(B, di)
    y = L.rms_norm(y * F.silu(z), {"scale": params["norm"]}, cfg.norm_eps)
    out = (y @ params["out_proj"])[:, None]
    return out, cache
