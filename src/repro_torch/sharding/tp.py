"""Megatron tensor parallelism on ``torch.distributed`` — the execution of
the reference's ``"model"`` axis (DESIGN.md §9), SPMD: every rank of a
model group runs the same calls on its ``1/ntp`` math cut of each weight
(``rules.param_pspecs``' ``"model"`` entries) and the activations between
the cuts are whole on every rank.

Where the reference lets the XLA partitioner insert the collectives, the
port issues them by hand through two ``torch.autograd.Function`` s:

  * :meth:`TensorParallel.copy_to` ("copy to model"): identity forward,
    all-reduce backward — at the input of a column-parallel block (``wq``,
    ``wk``, ``wv``; ``w_in``, ``w_gate``; the vocab columns of the
    logits), whose replicated input feeds every rank's columns;
  * :meth:`TensorParallel.reduce_from` ("reduce from model"): all-reduce
    forward, identity backward — at the output of a row-parallel product
    (``wo``, ``w_out``) and of the vocab-parallel embedding lookup.

So a transformer layer's forward carries two all-reduces (the Megatron
count), the embedding one, and the vocab-parallel log-probs of a loss two
more (the row max, then the exp-sum with the target's logit), with no
``[B, S, V]`` logits ever gathered; sampling all-gathers only the ``[B,
V]`` rows it draws from (:meth:`TensorParallel.gather_vocab`). LoRA under
TP follows ``rules.adapter_pspecs``: a column site's ``b`` and a row
site's ``a`` are cut with their base weight, their partner factor is
whole; a row site reduces its rank-r product ``x @ a`` before ``@ b``
(:meth:`TensorParallel.lora_row`) and a column site all-reduces ``a``'s
gradient (:meth:`TensorParallel.lora_col`), so both factors' gradients
are the unsharded ones. Half-precision partial sums are added in fp32 and
rounded once.

The model reads the TP group from the ambient mesh
(``sharding.ctx.use_mesh``, :func:`current`), as the reference's model
reads its constraint hints; ``TensorParallel.counts`` counts the
all-reduces and gathers by site. What the port does not run under TP
raises :class:`NotImplementedError` naming ROADMAP A10c
(:func:`check_supported`): Mamba layers, MTP heads and speculative
decoding, a KV head count that does not divide ``ntp`` (the reference's
head_dim fallback), MoE (``moe_shard_map``), and a captured CUDA graph
(a host-staged gloo collective cannot be captured; capture over NCCL
waits for a machine with more than one card).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import MAMBA, MLA, ModelConfig
from repro_torch.sharding import ctx as shctx

A10C = "ROADMAP A10c"

# all-reduce and gather sites :attr:`TensorParallel.counts` keys
SITES = ("row", "embed", "logits", "lora", "grad", "gather")


def _not_ported(what: str, item: str = "") -> NotImplementedError:
    return NotImplementedError(
        f"tensor parallelism (ntp > 1) with {what} is not ported "
        f"({A10C}{' ' + item if item else ''})")


def moe_refusal(name: str) -> NotImplementedError:
    """MoE under TP: ``models/moe_shard_map.py`` is ROADMAP A10c 4."""
    return _not_ported(f"{name}'s MoE layers (moe_shard_map)", "4")


def check_supported(cfg: ModelConfig, ntp: int, *,
                    spec_decode: bool = False) -> None:
    """Refuse what the port does not run tensor-parallel, naming its
    ROADMAP item; nothing at ``ntp`` 1."""
    if ntp <= 1:
        return
    if MLA in cfg.period:
        raise _not_ported(f"{cfg.name}'s MLA layers (the latent "
                          "projections' cuts)", "7")
    if cfg.moe is not None and any(cfg.layer_is_moe()):
        raise moe_refusal(cfg.name)
    if MAMBA in cfg.period:
        raise _not_ported(f"{cfg.name}'s Mamba layers")
    if cfg.mtp_depth:
        raise _not_ported(f"{cfg.name}'s MTP heads (the proj site and the "
                          "T-query verify)")
    if spec_decode:
        raise _not_ported("speculative decoding (the MTP proj site and the "
                          "T-query verify)")
    if cfg.input_mode == "encdec":
        raise _not_ported(f"{cfg.name}'s encoder-decoder (the encoder's and "
                          "the cross-attention's cuts, and the reference's "
                          "head_dim fallback for the cross K/V)", "8")
    if cfg.input_mode == "embeddings":
        raise _not_ported(f"{cfg.name}'s prefix embeddings (the prefix "
                          "beside a vocab-parallel embedding)", "8")
    if cfg.num_kv_heads % ntp:
        raise _not_ported(
            f"num_kv_heads={cfg.num_kv_heads} not divisible by ntp={ntp}: "
            "the reference's head_dim fallback for the KV cut")


def refuse_graphs() -> NotImplementedError:
    return _not_ported(
        "a captured decode graph: a gloo collective stages through host "
        "memory and cannot be captured, and capture over NCCL waits for a "
        "machine with more than one card; the decode loop runs eagerly")


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp._all_reduce(g, "grad"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, site):
        return tp._all_reduce(x, site)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class TensorParallel:
    """The rank's Megatron operators over one model group (``comm``, a
    ``sharding.Collectives``; its ``staged_bytes`` counts the gloo staging
    on a card)."""

    def __init__(self, comm):
        self.comm = comm
        self.size, self.rank = comm.size, comm.rank
        self.counts: Dict[str, int] = dict.fromkeys(SITES, 0)

    def reset_counts(self) -> None:
        self.counts = dict.fromkeys(SITES, 0)

    # ------------------------------------------------------------ the ops
    def _all_reduce(self, x: torch.Tensor, site: str) -> torch.Tensor:
        """A new tensor: ``x`` summed over the model group (half precision
        added in fp32, rounded once)."""
        self.counts[site] += 1
        wide = x.dtype in (torch.bfloat16, torch.float16)
        out = x.to(torch.float32 if wide else x.dtype,
                   memory_format=torch.contiguous_format, copy=True)
        self.comm.all_reduce_(out)
        return out.to(x.dtype) if wide else out

    def copy_to(self, x: torch.Tensor) -> torch.Tensor:
        """"Copy to model": ``x`` itself forward, its gradient summed over
        the ranks backward."""
        if not (torch.is_grad_enabled() and x.requires_grad):
            return x
        return _CopyToModel.apply(x, self)

    def reduce_from(self, x: torch.Tensor, site: str = "row"
                    ) -> torch.Tensor:
        """"Reduce from model": the sum over the ranks forward, the
        gradient as it is backward."""
        if not (torch.is_grad_enabled() and x.requires_grad):
            return self._all_reduce(x, site)
        return _ReduceFromModel.apply(x, self, site)

    def lora_col(self, x: torch.Tensor, ab: dict) -> torch.Tensor:
        """A column site's LoRA delta: ``a`` whole, ``b``'s columns the
        rank's; ``a``'s gradient is summed over the ranks."""
        return (x @ self.copy_to(ab["a"]).to(x.dtype)) @ ab["b"].to(x.dtype)

    def lora_row(self, x: torch.Tensor, ab: dict) -> torch.Tensor:
        """A row site's LoRA delta: ``a``'s rows the rank's, ``b`` whole;
        the rank-r product is summed before ``@ b``."""
        u = self.reduce_from(x @ ab["a"].to(x.dtype), "lora")
        return u @ ab["b"].to(x.dtype)

    # ------------------------------------------------------ vocab parallel
    def _vocab_cut(self, ids: torch.Tensor, v_local: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(``ids`` less this rank's first row, clamped into its rows;
        whether each id is this rank's)."""
        local = ids - self.rank * v_local
        mine = (local >= 0) & (local < v_local)
        return local.clamp(0, v_local - 1), mine

    def embed(self, table: torch.Tensor, tokens: torch.Tensor
              ) -> torch.Tensor:
        """Vocab-parallel lookup: each rank's rows of its vocab slice (zero
        elsewhere), summed over the ranks."""
        local, mine = self._vocab_cut(tokens, table.shape[0])
        rows = torch.where(mine[..., None], table[local],
                           torch.zeros((), dtype=table.dtype,
                                       device=table.device))
        return self.reduce_from(rows, "embed")

    def logp(self, logits: torch.Tensor, targets: torch.Tensor
             ) -> torch.Tensor:
        """Per-position log-prob of ``targets`` under vocab-sharded
        ``logits`` [..., V/ntp], in fp32: a MAX all-reduce of the row max
        (a constant), one SUM all-reduce of the exp-sum beside the target's
        logit (from its owning rank); the gradient stays shard-local."""
        local, mine = self._vocab_cut(targets, logits.shape[-1])
        tgt = torch.gather(logits, -1, local[..., None])[..., 0]
        tgt = torch.where(mine, tgt, torch.zeros_like(tgt)).float()
        mx = logits.max(-1).values.detach().float()
        self.counts["logits"] += 1
        self.comm.all_reduce_(mx, op=dist.ReduceOp.MAX)
        se = torch.sum(torch.exp(logits.float() - mx[..., None]), dim=-1)
        both = self.reduce_from(torch.stack([se, tgt]), "logits")
        return both[1] - (mx + torch.log(both[0]))

    @torch.no_grad()
    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """The whole rows ``[..., V]`` of vocab-sharded ``logits`` (what a
        sampler draws from)."""
        self.counts["gather"] += 1
        return self.comm.all_gather(logits.contiguous(), logits.dim() - 1)


# ---------------------------------------------------------------------------
# The ambient group
# ---------------------------------------------------------------------------
_BY_MESH: Dict[int, Tuple[object, TensorParallel]] = {}


def register(mesh, tp: TensorParallel) -> None:
    """``tp`` is the group a ``use_mesh(mesh)`` scope runs on (a
    ``ShardedContext`` registers its own, so its counters see a rollout
    or a batcher built on its ``mesh``)."""
    _BY_MESH[id(mesh)] = (mesh, tp)


def degree(mesh) -> int:
    """The model axis's size of ``mesh`` (a ``ShardedContext``, a
    ``DeviceMesh``, a ``SpecMesh``, a :class:`TensorParallel` or None)."""
    if mesh is None:
        return 1
    if isinstance(mesh, TensorParallel):
        return mesh.size
    if hasattr(mesh, "spec_mesh"):
        return mesh.ntp
    if not hasattr(mesh, "shape"):
        raise TypeError(f"a mesh is a ShardedContext, a DeviceMesh, a "
                        f"SpecMesh or None, not {type(mesh).__name__}")
    shape = mesh.shape if isinstance(mesh.shape, dict) else \
        dict(zip(mesh.mesh_dim_names, mesh.shape))
    return shape.get("model", 1)


def resolve(mesh) -> Optional[TensorParallel]:
    """The TP group a scope on ``mesh`` runs on: None without a model axis
    above 1. A ``SpecMesh`` with one names specs only and raises."""
    if degree(mesh) <= 1:
        return None
    if isinstance(mesh, TensorParallel):
        return mesh
    if hasattr(mesh, "spec_mesh"):
        if mesh.tp is None:
            raise ValueError("a ShardedContext on a SpecMesh names specs "
                             "only; tensor parallelism needs a process group")
        return mesh.tp
    hit = _BY_MESH.get(id(mesh))
    if hit is not None and hit[0] is mesh:
        return hit[1]
    if not hasattr(mesh, "get_group"):
        raise ValueError(f"{mesh!r} names specs only; tensor parallelism "
                         "needs a DeviceMesh on a process group")
    from repro_torch.sharding.context import Collectives
    tp = TensorParallel(Collectives(mesh.get_group("model"),
                                    mesh.device_type))
    register(mesh, tp)
    return tp


def current() -> Optional[TensorParallel]:
    """The ambient TP group (``sharding.ctx.use_mesh``), or None."""
    return resolve(shctx.current_mesh())


def size() -> int:
    tp = current()
    return 1 if tp is None else tp.size


def kv_heads(cfg: ModelConfig) -> int:
    """The KV heads a rank's caches and pools hold: K, or K/ntp under the
    ambient TP group."""
    return cfg.num_kv_heads // size()


__all__ = ["A10C", "SITES", "TensorParallel", "check_supported", "current",
           "degree", "kv_heads", "moe_refusal", "refuse_graphs", "register",
           "resolve", "size"]
