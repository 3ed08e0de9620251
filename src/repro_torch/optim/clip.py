"""Global-norm gradient clipping (``repro/optim/clip.py``)."""
from __future__ import annotations

import torch

from repro_torch.tree import leaves


# a leaf of more elements is squared and summed in blocks of its leading
# axis, so that no fp32 copy of it exists whole (DeepSeek-V3's bf16 expert
# gradients [256, 7168, 2048] would take 15 GB)
SQ_BLOCK = 1 << 28


def sq_sum(x: torch.Tensor) -> torch.Tensor:
    """sum(x^2) in fp32: one reduction, or one a block of leading
    indices for a leaf of more than ``SQ_BLOCK`` elements."""
    if x.numel() <= SQ_BLOCK or x.dim() < 2:
        return torch.sum(torch.square(x.float()))
    rows = max(1, SQ_BLOCK // (x.numel() // x.shape[0]))
    return sum(torch.sum(torch.square(x[i:i + rows].float()))
               for i in range(0, x.shape[0], rows))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(sq_sum(x) for x in leaves(tree)))


@torch.no_grad()
def clip_by_global_norm_(tree, max_norm: float):
    """Scales a tree of fp32 tensors in place by min(1, max_norm / norm)
    -> (tree, norm), the norm global over the tree in fp32."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for x in leaves(tree):
        x.mul_(scale)
    return tree, norm
