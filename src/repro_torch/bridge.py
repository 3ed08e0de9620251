"""Carry weights between the JAX reference's parameter pytree and the
port's.

The reference stacks each segment's layers on a leading group axis
(``params["segment{i}"]["slot{j}"][...]`` with shape ``[n_groups, ...]``,
``repro/models/transformer.py:49-50, 110-114``); the port keeps one dict
per layer in ``params["layers"]``. Layer ``g * len(period) + j`` is group
``g`` of slot ``j``. Leaves keep their fused ``[d_model, heads*head_dim]``
layout. Both sides are handled as numpy arrays, so this module needs no
JAX: the caller passes ``jax.tree.map(np.asarray, params)``.

Paged KV pools follow the same stacking in the reference
(``pools[0]["slot{j}"]["k"]`` of shape ``[n_groups, P, ps, K, D]``,
``repro/models/transformer.py:551-566``); the port keeps one pool per
layer with one more page, the drop page (``paged/paged_cache.py``), which
the converters add and strip.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.configs.base import ModelConfig

_TOP_LEVEL = ("embed", "final_norm", "lm_head")


def _to_torch(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)     # a writable, contiguous copy (jax arrays are read-only)
    if a.dtype.name == "bfloat16":
        # ml_dtypes.bfloat16, which torch.from_numpy refuses: same bits
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _check_supported(params_np: Dict[str, Any], cfg: ModelConfig) -> None:
    extra = set(params_np) - set(_TOP_LEVEL) - {"segment0"}
    if extra:
        raise NotImplementedError(
            f"the port carries token-input attention-only decoders; "
            f"unsupported parameter groups {sorted(extra)}")


def from_jax(params_np: Dict[str, Any], cfg: ModelConfig,
             device=None) -> dict:
    """The reference's pytree (numpy leaves) -> the port's parameters on
    ``device`` (``cuda`` unless one is given)."""
    device = default_device(device)
    _check_supported(params_np, cfg)
    out = {k: _map(params_np[k], lambda a: _to_torch(a, device))
           for k in _TOP_LEVEL if k in params_np}
    seg = params_np["segment0"]
    per = len(cfg.period)
    n_groups = cfg.num_layers // per
    layers = []
    for g in range(n_groups):
        for j in range(per):
            layers.append(_map(seg[f"slot{j}"],
                               lambda a, g=g: _to_torch(a[g], device)))
    out["layers"] = layers
    return out


def to_jax(params: dict, cfg: ModelConfig) -> Dict[str, Any]:
    """The port's parameters -> the reference's pytree layout, as numpy
    arrays (bf16 as ``ml_dtypes.bfloat16``)."""
    out = {k: _map(params[k], _to_numpy) for k in _TOP_LEVEL if k in params}
    per = len(cfg.period)
    layers = [_map(layer, _to_numpy) for layer in params["layers"]]
    slots = {}
    for j in range(per):
        group = layers[j::per]
        slots[f"slot{j}"] = _map_stack(group)
    out["segment0"] = slots
    return out


def _map_stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map_stack([t[k] for t in trees]) for k in first}
    return np.stack(trees)


def pools_from_jax(pools_np, cfg: ModelConfig, device=None) -> list:
    """The reference's paged pools (numpy leaves) -> the port's per-layer
    pools on ``device``, each with a zero drop page appended."""
    device = default_device(device)
    if len(pools_np) != 1:
        raise NotImplementedError("the port carries one-segment decoders")
    seg = pools_np[0]
    per = len(cfg.period)
    layers = []
    for g in range(cfg.num_layers // per):
        for j in range(per):
            layer = {}
            for name in ("k", "v"):
                a = np.asarray(seg[f"slot{j}"][name][g])
                layer[name] = _to_torch(
                    np.concatenate([a, np.zeros_like(a[:1])]), device)
            layers.append(layer)
    return layers


def pools_to_jax(pools: list, cfg: ModelConfig) -> list:
    """The port's per-layer pools -> the reference's one-segment stacked
    layout, as numpy arrays, drop pages stripped."""
    per = len(cfg.period)
    layers = [{name: _to_numpy(pool[name][:-1]) for name in ("k", "v")}
              for pool in pools]
    return [{f"slot{j}": _map_stack(layers[j::per]) for j in range(per)}]
