"""Carry weights between the JAX reference's parameter pytree and the
port's.

The reference stacks each segment's layers on a leading group axis
(``params["segment{i}"]["slot{j}"][...]`` with shape ``[n_groups, ...]``,
``repro/models/transformer.py:49-50, 110-114``); the port keeps one dict
per layer in ``params["layers"]``. Layer ``g * len(period) + j`` is group
``g`` of slot ``j``. Leaves keep their fused ``[d_model, heads*head_dim]``
layout and their own dtype (a Mamba mixer's ``dt_bias``, ``A_log`` and
``D`` stay fp32 in a bf16 model). Both sides are handled as numpy arrays,
so this module needs no JAX: the caller passes
``jax.tree.map(np.asarray, params)``.

Decode caches follow the same stacking
(``caches["segments"][0]["slot{j}"]``, each leaf ``[n_groups, B, ...]``:
an attention slot's ``k``/``v``/``pos``, a Mamba slot's ``conv_state`` and
``ssm_state``); :func:`caches_from_jax` gives the port's per-layer list.
Paged KV pools follow the same stacking in the reference
(``pools[0]["slot{j}"]["k"]`` of shape ``[n_groups, P, ps, K, D]``,
``repro/models/transformer.py:551-566``); the port keeps one pool per
layer with one more page, the drop page (``paged/paged_cache.py``), which
the converters add and strip.

LoRA adapters follow the same stacking in the reference
(``adapter["lora"]["segment0"]["slot{j}"]``, factors ``[n_groups, d_in,
r]`` / ``[n_groups, r, d_out]``); the port's are per layer
(``adapter["lora"]["layers"][i]``); the value head is fp32 ``{"w": [d, 1],
"b": [1]}`` on both sides (:func:`adapter_from_jax`,
:func:`adapter_to_jax`). :func:`trainer_from_jax` builds the port's hydra
trainer from the reference trainer's trunk and adapters, so the two train
from the same weights; :func:`separate_trainer_from_jax` builds the port's
separate (four-model) trainer from the reference's actor and critic
trees (a critic's fp32 ``value_head`` is a top-level group like
``embed``).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.configs.base import ModelConfig

_TOP_LEVEL = ("embed", "final_norm", "lm_head", "value_head")


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
            f"the port carries one-segment token-input decoders; "
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


def caches_from_jax(caches_np, cfg: ModelConfig, device=None) -> list:
    """The reference's decode caches (``{"segments": [...], ...}`` with
    numpy leaves) -> the port's per-layer caches on ``device``."""
    device = default_device(device)
    segments = caches_np["segments"]
    if len(segments) != 1:
        raise NotImplementedError("the port carries one-segment decoders")
    per = len(cfg.period)
    return [_map(segments[0][f"slot{j}"],
                 lambda a, g=g: _to_torch(np.asarray(a)[g], device))
            for g in range(cfg.num_layers // per) for j in range(per)]


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


def adapter_from_jax(adapter_np: Dict[str, Any], cfg: ModelConfig,
                     device=None) -> dict:
    """A reference adapter (numpy leaves) -> the port's, on ``device``."""
    device = default_device(device)
    lora = adapter_np.get("lora") or {}
    extra = set(lora) - {"segment0"}
    if extra:
        raise NotImplementedError(f"the port carries one-segment decoders; "
                                  f"unsupported adapter groups {sorted(extra)}")
    out: Dict[str, Any] = {"lora": {}}
    if lora:
        seg = lora["segment0"]
        per = len(cfg.period)
        out["lora"]["layers"] = [
            _map(seg[f"slot{j}"], lambda a, g=g: _to_torch(a[g], device))
            for g in range(cfg.num_layers // per) for j in range(per)]
    if "value_head" in adapter_np:
        out["value_head"] = _map(adapter_np["value_head"],
                                 lambda a: _to_torch(a, device))
    return out


def adapter_to_jax(adapter: dict, cfg: ModelConfig) -> Dict[str, Any]:
    """The port's adapter -> the reference's layout, as numpy arrays."""
    out: Dict[str, Any] = {"lora": {}}
    layers = (adapter.get("lora") or {}).get("layers")
    if layers:
        per = len(cfg.period)
        layers = [_map(layer, _to_numpy) for layer in layers]
        out["lora"]["segment0"] = {f"slot{j}": _map_stack(layers[j::per])
                                   for j in range(per)}
    if "value_head" in adapter:
        out["value_head"] = _map(adapter["value_head"], _to_numpy)
    return out


def trainer_from_jax(base_np: Dict[str, Any], adapters_np: Dict[str, Any],
                     cfg: ModelConfig, rl, reward_fn=None, device=None):
    """The port's hydra ``RLHFTrainer`` from the reference trainer's trunk
    (``trainer.base_params``) and per-role adapters
    (``trainer.engine.adapters``), all as numpy leaves, on ``device``."""
    from repro_torch.rlhf import ModelEngine, RLHFTrainer
    device = default_device(device)
    engine = ModelEngine(
        cfg, None, rank=rl.lora_rank, base_params=from_jax(base_np, cfg, device),
        adapters={role: adapter_from_jax(ad, cfg, device)
                  for role, ad in adapters_np.items()})
    return RLHFTrainer(cfg, cfg, rl, reward_fn=reward_fn, engine=engine)


def separate_trainer_from_jax(actor_np: Dict[str, Any],
                              critic_np: Dict[str, Any],
                              actor_cfg: ModelConfig, critic_cfg: ModelConfig,
                              rl, reward_fn=None, device=None):
    """The port's separate ``RLHFTrainer`` from the reference trainer's
    ``actor_state["params"]`` and ``critic_state["params"]`` (numpy
    leaves), on ``device``. As in the reference, the reference model is a
    copy of the actor's initial weights and the reward model one of the
    critic's."""
    from repro_torch.rlhf import RLHFTrainer
    device = default_device(device)
    params = {"actor": from_jax(actor_np, actor_cfg, device),
              "critic": from_jax(critic_np, critic_cfg, device)}
    return RLHFTrainer(actor_cfg, critic_cfg, rl, reward_fn=reward_fn,
                       params=params)
