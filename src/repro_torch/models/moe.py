"""Mixture-of-Experts FFN with sort-based dispatch and capacity dropping —
the port of ``repro/models/moe.py:28-150``.

Routing is per data-parallel shard, as in the reference: the tokens [T, D]
are viewed as [ndp, T/ndp, D] (:func:`_num_dp_shards`), and each group is
routed on its own (top-k over the fp32 router, a stable sort of the
assignments by expert, each expert's first ``C`` kept), so capacity
``C = ceil(T_local * k / E * cf)``, rounded up to a multiple of 4 and at
least 4, drops per group. The experts run as three batched products
``[s, E, C, D] x [E, D, F]`` (``torch.matmul``; the reference leaves them
to XLA outside any kernel).

Every shape comes from host integers and every op is static: no
``nonzero``, no boolean indexing, no ``.item()``, so a decode step with
MoE layers is captured as one CUDA graph and traced on ``meta``. Top-k is
a stable descending sort, which like ``jax.lax.top_k`` takes the lower
expert on ties; the dispatch writes each kept assignment to its own row
(a dropped one to a spare row that is cut off); the combine gathers each
token's k expert outputs in its own top-k order and sums them in ``x``'s
dtype, with no atomics, so two runs give the same bits (the reference
scatter-adds them).

Under an ambient tensor-parallel group MoE raises (``moe_shard_map``,
ROADMAP A10c 4).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import layers as L
from repro_torch.sharding import ctx
from repro_torch.sharding import tp as TP


def init_moe(generator: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    """``router`` [D, E] fp32 (in a bf16 model too), ``w_in``/``w_gate``
    [E, D, F], ``w_out`` [E, F, D]; ``shared`` (a gated MLP of
    ``num_shared_experts * d_expert``) where the config has shared
    experts."""
    e: MoEConfig = cfg.moe
    d = cfg.d_model
    p = {
        "router": L._init(generator, (d, e.num_experts), scale=0.02,
                          dtype=torch.float32),
        "w_in": L._init(generator, (e.num_experts, d, e.d_expert),
                        dtype=dtype),
        "w_gate": L._init(generator, (e.num_experts, d, e.d_expert),
                          dtype=dtype),
        "w_out": L._init(generator, (e.num_experts, e.d_expert, d),
                         scale=0.02 / math.sqrt(2 * cfg.num_layers),
                         dtype=dtype),
    }
    if e.num_shared_experts:
        p["shared"] = L.init_mlp(generator, d,
                                 e.num_shared_experts * e.d_expert, True,
                                 cfg.num_layers, dtype)
    return p


def router_topk(logits: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits [..., T, E] fp32 -> (gates [..., T, k], idx [..., T, k],
    aux [...]): the top-k of the softmax renormalised, and the
    Switch-style load-balance loss ``E * sum_e fraction_e * prob_e``."""
    E = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[..., :k], order[..., :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(-2)                                  # mean prob per expert
    flat = idx.flatten(-2)
    ce = torch.zeros(flat.shape[:-1] + (E,), dtype=torch.float32,
                     device=logits.device)
    ce = ce.scatter_add(-1, flat, torch.ones_like(flat, dtype=torch.float32))
    ce = ce / flat.shape[-1]
    aux = E * torch.sum(me * ce, dim=-1)
    return gates, idx, aux


def _num_dp_shards(T: int) -> Tuple[int, int]:
    """(routing groups, the share of the aux loss) for a token grid of T
    rows on this rank. A rank that holds the whole batch under a mesh with
    a data axis above 1 routes it as the reference does under that mesh:
    ``ndp`` groups where ``T % ndp == 0``, else one. A rank that holds its
    own share of a split batch (the ambient ``ShardedContext``'s
    ``comm.batch_sharded``, set by ``sharded_batch()``) holds one group's
    rows: it routes one group, and its aux loss is 1/ndp of the mean over
    the ranks' groups (the step sums the ranks' losses)."""
    mesh = ctx.current_mesh()
    ndp = ctx.dp_size(mesh)
    if ndp <= 1:
        return 1, 1
    if getattr(getattr(mesh, "comm", None), "batch_sharded", False):
        return 1, ndp
    return (ndp if T % ndp == 0 else 1), 1


def capacity(tokens: int, cfg: ModelConfig,
             capacity_factor: Optional[float] = None) -> int:
    """Slots an expert takes in a routing group of ``tokens`` rows."""
    e = cfg.moe
    cf = e.capacity_factor if capacity_factor is None else capacity_factor
    C = int(math.ceil(tokens * e.top_k / e.num_experts * cf))
    return max(4, -(-C // 4) * 4)


def _route(xs: torch.Tensor, router: torch.Tensor, k: int, C: int):
    """Routing of each group of xs [s, Tl, D] -> (dest [s, Tl*k], gates
    [s, Tl*k], keep [s, Tl*k], aux [s]), the assignments in token-major
    order (token t's j-th choice at t*k + j). ``dest`` is the expert's
    row ``expert * C + position`` for a kept assignment and ``E * C`` (a
    spare row) for a dropped one; an expert keeps its first C assignments
    in that order (a stable sort by expert)."""
    s, Tl, _ = xs.shape
    E = router.shape[-1]
    logits = xs.float() @ router
    gates, idx, aux = router_topk(logits, k)
    expert = idx.reshape(s, Tl * k)
    order = torch.argsort(expert, dim=-1, stable=True)
    sorted_expert = torch.gather(expert, 1, order)
    counts = torch.zeros((s, E), dtype=torch.long, device=xs.device)
    counts = counts.scatter_add(1, expert, torch.ones_like(expert))
    starts = torch.cumsum(counts, dim=1) - counts
    ar = torch.arange(Tl * k, device=xs.device).expand(s, Tl * k)
    pos_sorted = ar - torch.gather(starts, 1, sorted_expert)
    pos = torch.empty_like(pos_sorted).scatter(1, order, pos_sorted)
    keep = pos < C
    dest = torch.where(keep, expert * C + pos, torch.full_like(pos, E * C))
    return dest, gates.reshape(s, Tl * k), keep, aux


def _experts(ge: torch.Tensor, params) -> torch.Tensor:
    """Every expert's SwiGLU over its slots: ge [s, E, C, D] -> [s, E, C,
    D], three batched products ``[s, E, C, D] x [E, D, F]``. One group
    takes the products on [E, C, D] directly (the same batched product),
    so that a weight's gradient is the product's own, with no sum over a
    broadcast group axis: that sum copies the whole gradient (7.5 GB at
    DeepSeek-V3's [256, 7168, 2048] expert leaves)."""
    x = ge[0] if ge.shape[0] == 1 else ge
    h = torch.matmul(x, params["w_in"])                   # [(s,) E, C, F]
    g = torch.matmul(x, params["w_gate"])
    out = torch.matmul(F.silu(g) * h, params["w_out"])
    return out[None] if ge.shape[0] == 1 else out


def moe_fwd(params, x: torch.Tensor, cfg: ModelConfig, *,
            capacity_factor: Optional[float] = None):
    """x [B, S, D] -> (y [B, S, D], aux loss: a 0-d fp32 tensor, the mean
    of the groups' losses times ``router_aux_coef``)."""
    if TP.current() is not None:
        raise TP.moe_refusal(cfg.name)
    e: MoEConfig = cfg.moe
    B, S, D = x.shape
    T = B * S
    ndp, share = _num_dp_shards(T)
    Tl = T // ndp
    k, E = e.top_k, e.num_experts
    C = capacity(Tl, cfg, capacity_factor)

    xs = x.reshape(ndp, Tl, D)
    dest, gate, keep, aux = _route(xs, params["router"], k, C)
    # dispatch: each assignment's token to its row (kept rows are
    # distinct; the dropped ones share the spare row, which is cut off)
    xk = xs[:, :, None].expand(ndp, Tl, k, D).reshape(ndp, Tl * k, D)
    rows = torch.zeros((ndp, E * C + 1, D), dtype=x.dtype, device=x.device)
    rows = rows.scatter(1, dest[..., None].expand(ndp, Tl * k, D), xk)
    ge = rows[:, :E * C].reshape(ndp, E, C, D)
    out_rows = _experts(ge, params).reshape(ndp, E * C, D)
    # combine: each assignment's expert output, weighted by its gate (0
    # where dropped), summed over a token's k choices in x's dtype
    src = torch.clamp(dest, max=E * C - 1)
    contrib = torch.gather(out_rows, 1, src[..., None].expand(ndp, Tl * k, D))
    contrib = contrib * (gate * keep).to(x.dtype)[..., None]
    y = contrib.reshape(ndp, Tl, k, D).sum(2).reshape(B, S, D)
    if e.num_shared_experts:
        y = y + L.mlp_fwd(params["shared"], x, True)
    return y, aux.mean() * e.router_aux_coef / share
