"""Offload-aware rematerialization: ``cfg.remat`` in {"dots", "offload"} —
the port of ``repro/offload/policies.py``. ``models.transformer`` runs each
layer as one non-reentrant ``torch.utils.checkpoint``; the policy says what
that checkpoint keeps for the backward.

  * ``"full"``: only the layer's input; the whole layer recomputes;
  * ``"offload"``: the same, with the saved layer input (the reference's
    ``"residual"``, ``save_and_offload_only_these_names``) moved to host
    memory during the forward and back for the backward
    (``torch.autograd.graph.save_on_cpu``: pinned where PyTorch has CUDA;
    for a CPU model, a copy in the same memory);
  * ``"dots"`` (``checkpoint_dots_with_no_batch_dims``): the outputs of the
    projections (``aten.mm`` / ``aten.addmm``: every weight and LoRA
    product) are saved; norms, attention, RoPE and the activations
    recompute. Attention's batched products (``bmm``) recompute, as the
    reference's batch-dim dots do.
"""
from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

REMATS = ("none", "full", "dots", "offload")
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else \
        CheckpointPolicy.PREFER_RECOMPUTE


def offload_remat_policy():
    """The context around each layer's checkpoint behind
    ``cfg.remat == "offload"``: what the checkpoint saves (the layer's
    input) is packed to host memory."""
    return functools.partial(torch.autograd.graph.save_on_cpu,
                             pin_memory=True)


def remat_policy_for(remat: str):
    """``(checkpoint kwargs, context manager factory around each checkpoint
    call)`` for a ``cfg.remat`` of "full", "dots" or "offload"."""
    if remat == "full":
        return {}, contextlib.nullcontext
    if remat == "dots":
        return {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, _save_dots)}, \
            contextlib.nullcontext
    if remat == "offload":
        return {}, offload_remat_policy()
    raise ValueError(f"no checkpoint policy for remat={remat!r}")
