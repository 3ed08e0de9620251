"""Parameter trees: nested dicts and lists with tensor leaves (the port's
stand-in for ``jax.tree``). ``None`` leaves are kept in place and skipped
by :func:`leaves`."""
from __future__ import annotations

from typing import Any, Callable, Iterator

import torch


def leaves(tree) -> Iterator[torch.Tensor]:
    """The tensor leaves in dict-insertion and list order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)


def tree_map(fn: Callable[..., Any], tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def nbytes(tree) -> int:
    """Bytes of the distinct tensors in ``tree`` (an aliased tensor counts
    once)."""
    seen = {}
    for t in leaves(tree):
        seen[t.data_ptr(), t.numel()] = \
            t.numel() * t.element_size()
    return sum(seen.values())
