"""LoRA adapter trees over the base parameter tree (the hydra engine's
per-role adapters) — the port of ``repro/models/lora.py``.

  * :func:`init_adapter`  — an adapter mirroring a base tree: A ~ N(0,
    0.02) from a ``torch.Generator``, B = 0 (the initial delta is exactly
    zero), fp32, plus a value head for the scalar-output roles;
  * :func:`lora_delta`    — the unmerged ``(x @ A) @ B`` of a training
    forward, in the activation dtype;
  * :func:`merge_adapter` / :func:`unmerge_adapter` — fold ``A @ B`` into
    the base weights for rollout-speed generation, and back out;
  * :func:`merged_leaves` / :func:`delete_merged` — the tensors a merge
    created, and dropping the merged tree's references to them at a phase
    boundary (the non-adapted leaves alias the frozen base);
  * :func:`adapted_subtree` / :func:`with_adapted_leaves` — the base
    leaves at the adapted sites (the unit the offload subsystem parks
    while merged weights serve rollout), and the base rebuilt around a
    replacement for them;
  * :func:`adapter_param_count` / :func:`trainable_fraction`.

Adapted sites, as in the reference: attention projections
(``wq/wk/wv/wo``, only where all four are present) and dense-MLP
projections (``w_in/w_gate/w_out``, only in dicts without a ``router``).
The port keeps one parameter dict per layer (``params["layers"]``), so its
factors are per layer, ``[d_in, r]`` and ``[r, d_out]``, where the
reference stacks them ``[G, d_in, r]`` (``bridge.adapter_from_jax``
converts).
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.tree import leaves

ATTN_SITES = ("wq", "wk", "wv", "wo")
MLP_SITES = ("w_in", "w_gate", "w_out")


def _is_site(node) -> bool:
    """An adapter site leaf-pair {"a": A, "b": B}."""
    return isinstance(node, dict) and set(node) == {"a", "b"}


def _adaptable_names(parent: Dict[str, Any], path_names) -> List[str]:
    """Which keys of ``parent`` get LoRA factors."""
    if "cross" in path_names:
        return []
    if all(k in parent for k in ATTN_SITES):
        return list(ATTN_SITES)
    if "router" not in parent and any(k in parent for k in MLP_SITES):
        return [k for k in MLP_SITES if k in parent]
    return []


def _normal(generator: torch.Generator, shape, scale: float, device):
    draw = None if generator.device.type == "meta" else generator
    x = torch.randn(shape, generator=draw, dtype=torch.float32,
                    device=generator.device)
    return (scale * x).to(device)


def init_adapter(generator: torch.Generator, base_params, rank: int, *,
                 with_value: bool = False, d_model: int = 0,
                 scale: float = 0.02) -> Dict[str, Any]:
    """Adapter tree for ``base_params``: {"lora": {...}, ["value_head"]},
    fp32 leaves on the base's device. ``rank=0`` gives an empty lora tree
    (the forward is then the plain base pass)."""

    def rec(node, path_names):
        if isinstance(node, list):
            out = [rec(v, path_names) for v in node]
            return out if any(out) else None
        if not isinstance(node, dict):
            return None
        out: Dict[str, Any] = {}
        for name in (_adaptable_names(node, path_names) if rank > 0 else []):
            w = node[name]
            if w.dim() < 2:
                continue
            d_in, d_out = w.shape
            out[name] = {
                "a": _normal(generator, (d_in, rank), scale, w.device),
                "b": torch.zeros((rank, d_out), dtype=torch.float32,
                                 device=w.device)}
        for k, v in node.items():
            if k in out or not isinstance(v, (dict, list)):
                continue
            sub = rec(v, path_names + (k,))
            if sub:
                out[k] = sub
        return out

    adapter: Dict[str, Any] = {"lora": rec(base_params, ()) or {}}
    if with_value:
        if d_model <= 0:
            raise ValueError("with_value adapters need d_model")
        device = next(leaves(base_params)).device
        adapter["value_head"] = {
            "w": _normal(generator, (d_model, 1), 0.02, device),
            "b": torch.zeros((1,), dtype=torch.float32, device=device)}
    return adapter


def lora_delta(x: torch.Tensor, ab: dict) -> torch.Tensor:
    """Unmerged low-rank delta ``(x @ A) @ B`` in x's dtype (the factors
    are fp32; the cast is differentiated through)."""
    return (x @ ab["a"].to(x.dtype)) @ ab["b"].to(x.dtype)


def _merge(base, lora, sign: float):
    if _is_site(lora):
        return base + sign * (lora["a"] @ lora["b"]).to(base.dtype)
    if isinstance(base, dict):
        return {k: _merge(v, lora[k], sign) if k in lora else v
                for k, v in base.items()}
    if isinstance(base, list):
        return [_merge(b, l, sign) for b, l in zip(base, lora)]
    return base


def merge_adapter(base_params, lora_tree) -> Any:
    """base + A@B at every adapted site, with no autograd graph.
    Non-adapted leaves are the base's own tensors (do not free them)."""
    with torch.no_grad():
        return _merge(base_params, lora_tree or {}, +1.0)


def unmerge_adapter(merged_params, lora_tree) -> Any:
    """Inverse of :func:`merge_adapter` (up to fp round-off)."""
    with torch.no_grad():
        return _merge(merged_params, lora_tree or {}, -1.0)


def _site_parents(merged_params, lora_tree):
    """(container, key) of every adapted site in the merged tree."""
    out = []

    def rec(node, lora):
        if isinstance(node, list):
            for i, (n, l) in enumerate(zip(node, lora)):
                if _is_site(l):
                    out.append((node, i))
                else:
                    rec(n, l)
        elif isinstance(node, dict):
            for k, sub in lora.items():
                if k not in node:
                    continue
                if _is_site(sub):
                    out.append((node, k))
                else:
                    rec(node[k], sub)

    rec(merged_params, lora_tree or {})
    return out


def merged_leaves(merged_params, lora_tree) -> List[torch.Tensor]:
    """The tensors :func:`merge_adapter` freshly allocated — the leaves at
    adapted sites."""
    return [parent[k] for parent, k in _site_parents(merged_params,
                                                     lora_tree)]


def delete_merged(merged_params, lora_tree) -> None:
    """Phase-boundary hygiene: drop the merged tree's references to the
    tensors the merge allocated (set to None), so the caching allocator
    gets them back once the caller's last reference goes; the aliased
    frozen base is untouched."""
    for parent, k in _site_parents(merged_params, lora_tree):
        parent[k] = None


def adapted_subtree(params, lora_tree) -> Any:
    """The sub-tree of ``params`` at the adapted sites — exactly the leaves
    :func:`merge_adapter` replaces (the non-adapted leaves, which a merged
    tree aliases, are left out). Walks ``params["layers"]``'s list."""
    if _is_site(lora_tree):
        return params
    if isinstance(lora_tree, list):
        return [adapted_subtree(p, sub) for p, sub in zip(params, lora_tree)]
    return {k: adapted_subtree(params[k], sub)
            for k, sub in (lora_tree or {}).items() if k in params}


def with_adapted_leaves(params, lora_tree, subtree) -> Any:
    """``params`` rebuilt with the adapted-site leaves replaced by
    ``subtree`` (an :func:`adapted_subtree`-shaped tree); every other leaf
    is returned by reference."""
    if _is_site(lora_tree):
        return subtree
    if isinstance(params, list):
        return [with_adapted_leaves(p, sub, s)
                for p, sub, s in zip(params, lora_tree, subtree)]
    if not isinstance(params, dict):
        return params
    lora_tree = lora_tree or {}
    return {k: with_adapted_leaves(v, lora_tree[k], subtree[k])
            if k in lora_tree else v for k, v in params.items()}


def adapter_param_count(adapter) -> int:
    """Trainable parameters in an adapter (lora factors + value head)."""
    return sum(t.numel() for t in leaves(adapter))


def trainable_fraction(base_params, adapter) -> float:
    """Adapter params / base params."""
    n_base = sum(t.numel() for t in leaves(base_params))
    return adapter_param_count(adapter) / max(n_base, 1)
