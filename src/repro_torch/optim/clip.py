"""Global-norm gradient clipping (``repro/optim/clip.py``)."""
from __future__ import annotations

import torch

from repro_torch.tree import leaves


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


@torch.no_grad()
def clip_by_global_norm_(tree, max_norm: float):
    """Scales a tree of fp32 tensors in place by min(1, max_norm / norm)
    -> (tree, norm), the norm global over the tree in fp32."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for x in leaves(tree):
        x.mul_(scale)
    return tree, norm
