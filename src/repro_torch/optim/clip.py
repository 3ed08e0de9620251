"""Global-norm gradient clipping (``repro/optim/clip.py``)."""
from __future__ import annotations

import torch

from repro_torch.tree import leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled by min(1, max_norm / norm), norm); fp32 math, each leaf
    back in its dtype."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), tree), norm
