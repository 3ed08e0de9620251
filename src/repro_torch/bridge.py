"""Carry weights between the JAX reference's parameter pytree and the
port's.

The reference stacks each segment's layers on a leading group axis
(``params["segment{i}"]["slot{j}"][...]`` with shape ``[n_groups, ...]``,
``repro/models/transformer.py:35-50, 110-114``); the port keeps one dict
per layer in ``params["layers"]``, the segments' layers one after the
other (:func:`segment_groups`: DeepSeek's ``first_k_dense`` layers are a
leading segment of their own, then the rest). Within a segment that
starts at layer ``s``, layer ``s + g * len(period) + j`` is group ``g`` of
slot ``j``; a one-segment model maps as it always has. Leaves keep their
fused ``[d_model, heads*head_dim]`` layout and their own dtype (a Mamba
mixer's ``dt_bias``, ``A_log`` and ``D`` stay fp32 in a bf16 model, as
does an MoE FFN's ``router``; its
experts' ``w_in``/``w_gate`` [E, D, F] and ``w_out`` [E, F, D] stack over
groups like any leaf). A period of several slots (Jamba's 8: Mamba,
attention, dense and MoE FFNs) maps slot by slot, each slot's dict of
its own shape. Both sides are handled as numpy arrays,
so this module needs no JAX: the caller passes
``jax.tree.map(np.asarray, params)``.

An encoder-decoder's encoder is one more stacked segment in the
reference (``params["encoder"]["slot0"]``, ``[encoder_layers, ...]``) and
a list of layer dicts in the port; ``encoder_norm`` is a top-level group
like ``final_norm``, and each decoder layer's ``norm_x`` and ``cross``
ride in its slot like any other leaf.

MTP heads: the reference keeps depth 1 in ``params["mtp"]`` (its layer
under ``["layer"]["slot0"]``) and stacks depths 2..k on
``params["mtp_extra"]``'s lead axis; the port keeps one module a depth in
the list ``params["mtp"]`` (its layer dict under ``["layer"]``). Adapters
over them follow the same two layouts.

Decode caches follow the same stacking
(``caches["segments"][i]["slot{j}"]``, each leaf ``[n_groups, B, ...]``:
an attention slot's ``k``/``v``/``pos``, an MLA slot's ``c_kv``/``k_rope``/
``pos``, a Mamba slot's ``conv_state`` and ``ssm_state``);
:func:`caches_from_jax` gives the port's per-layer list. An
encoder-decoder's cross K/V (``caches["cross_kv"]``: per segment a tuple
a slot of ``(k, v)``, each ``[n_groups, B, Se, K, hd]``) become the
port's per-layer ``{k, v}`` dicts (:func:`cross_kv_from_jax`).
Paged KV pools follow the same stacking in the reference
(``pools[0]["slot{j}"]["k"]`` of shape ``[n_groups, P, ps, K, D]``,
``repro/models/transformer.py:551-566``); the port keeps one pool per
layer with one more page, the drop page (``paged/paged_cache.py``), which
the converters add and strip.

LoRA adapters follow the same stacking in the reference
(``adapter["lora"]["segment{i}"]["slot{j}"]``, factors ``[n_groups, d_in,
r]`` / ``[n_groups, r, d_out]``); the port's are per layer
(``adapter["lora"]["layers"][i]``); the value head is fp32 ``{"w": [d, 1],
"b": [1]}`` on both sides (:func:`adapter_from_jax`,
:func:`adapter_to_jax`). :func:`trainer_from_jax` builds the port's hydra
trainer from the reference trainer's trunk and adapters, so the two train
from the same weights; :func:`separate_trainer_from_jax` builds the port's
separate (four-model) trainer, and :func:`grpo_trainer_from_jax` its GRPO
trainer, from the reference's actor and critic
trees (a critic's fp32 ``value_head`` is a top-level group like
``embed``).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.configs.base import ModelConfig

_TOP_LEVEL = ("embed", "final_norm", "lm_head", "value_head",
              "encoder_norm")
_ENCODER = "encoder"


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


_MTP = ("mtp", "mtp_extra")


def _mtp_from_jax(tree_np: Dict[str, Any], fn) -> list:
    """The reference's ``mtp`` module and stacked ``mtp_extra`` modules
    (parameters or their LoRA subtrees) -> the port's depth-ordered list,
    each leaf through ``fn``."""
    def module(m):
        out = {k: v for k, v in m.items() if k != "layer"}
        if "layer" in m:
            out["layer"] = m["layer"]["slot0"]
        return _map(out, fn)

    mods = [module(tree_np["mtp"])]
    extra = tree_np.get("mtp_extra")
    if extra is not None:
        n = len(np.asarray(_first_leaf(extra)))
        mods += [module(_map(extra, lambda a, j=j: np.asarray(a)[j]))
                 for j in range(n)]
    return mods


def _mtp_to_jax(mods: list) -> Dict[str, Any]:
    """The port's MTP list (numpy leaves) -> ``{"mtp": ...[, "mtp_extra":
    stacked depths 2..k]}`` in the reference's layout."""
    def module(m):
        out = {k: v for k, v in m.items() if k != "layer"}
        if "layer" in m:
            out["layer"] = {"slot0": m["layer"]}
        return out

    out = {"mtp": module(mods[0])}
    if len(mods) > 1:
        out["mtp_extra"] = _map_stack([module(m) for m in mods[1:]])
    return out


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def segment_groups(cfg: ModelConfig) -> list:
    """The reference's segments as their group counts, in order
    (``ModelConfig.segment_layers`` over the period)."""
    return [n // len(cfg.period) for n in cfg.segment_layers()]


def _segment_names(cfg: ModelConfig) -> list:
    return [f"segment{i}" for i in range(len(segment_groups(cfg)))]


def _unstack(segments: list, cfg: ModelConfig, fn) -> list:
    """Stacked segments (each ``{"slot{j}": tree of [n_groups, ...]}``)
    -> one tree a layer, in layer order, each leaf ``fn(a[g])``."""
    per = len(cfg.period)
    if len(segments) != len(segment_groups(cfg)):
        raise ValueError(f"{cfg.name} has {len(segment_groups(cfg))} "
                         f"segments, got {len(segments)}")
    return [_map(seg[f"slot{j}"], lambda a, g=g: fn(np.asarray(a)[g]))
            for seg, n in zip(segments, segment_groups(cfg))
            for g in range(n) for j in range(per)]


def _stack(layers: list, cfg: ModelConfig) -> list:
    """One tree a layer (numpy leaves), in layer order -> the stacked
    segments."""
    per = len(cfg.period)
    out, start = [], 0
    for n in segment_groups(cfg):
        seg = layers[start:start + n * per]
        out.append({f"slot{j}": _map_stack(seg[j::per])
                    for j in range(per)})
        start += n * per
    return out


def _check_supported(params_np: Dict[str, Any], cfg: ModelConfig) -> None:
    extra = set(params_np) - set(_TOP_LEVEL) - set(_segment_names(cfg)) - \
        set(_MTP) - {_ENCODER}
    if extra:
        raise NotImplementedError(
            f"the port carries decoders, an encoder and MTP heads; "
            f"unsupported parameter groups {sorted(extra)}")


def _encoder_from_jax(enc_np, fn) -> list:
    """The reference's stacked encoder (``{"slot0": tree of [n, ...]}``)
    -> one layer dict a layer, each leaf through ``fn``."""
    n = len(np.asarray(_first_leaf(enc_np)))
    return [_map(enc_np["slot0"], lambda a, g=g: fn(np.asarray(a)[g]))
            for g in range(n)]


def from_jax(params_np: Dict[str, Any], cfg: ModelConfig,
             device=None) -> dict:
    """The reference's pytree (numpy leaves) -> the port's parameters on
    ``device`` (``cuda`` unless one is given)."""
    device = default_device(device)
    _check_supported(params_np, cfg)
    out = {k: _map(params_np[k], lambda a: _to_torch(a, device))
           for k in _TOP_LEVEL if k in params_np}
    out["layers"] = _unstack([params_np[n] for n in _segment_names(cfg)],
                             cfg, lambda a: _to_torch(a, device))
    if _ENCODER in params_np:
        out[_ENCODER] = _encoder_from_jax(params_np[_ENCODER],
                                          lambda a: _to_torch(a, device))
    if "mtp" in params_np:
        out["mtp"] = _mtp_from_jax(params_np,
                                   lambda a: _to_torch(a, device))
    return out


def to_jax(params: dict, cfg: ModelConfig) -> Dict[str, Any]:
    """The port's parameters -> the reference's pytree layout, as numpy
    arrays (bf16 as ``ml_dtypes.bfloat16``)."""
    out = {k: _map(params[k], _to_numpy) for k in _TOP_LEVEL if k in params}
    segs = _stack([_map(layer, _to_numpy) for layer in params["layers"]],
                  cfg)
    out.update(zip(_segment_names(cfg), segs))
    if _ENCODER in params:
        out[_ENCODER] = {"slot0": _map_stack(
            [_map(layer, _to_numpy) for layer in params[_ENCODER]])}
    if "mtp" in params:
        out.update(_mtp_to_jax([_map(m, _to_numpy) for m in params["mtp"]]))
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
    return _unstack(list(caches_np["segments"]), cfg,
                    lambda a: _to_torch(a, device))


def cross_kv_from_jax(caches_np, cfg: ModelConfig, device=None) -> list:
    """An encoder-decoder's ``caches["cross_kv"]`` in the reference's
    layout (per segment, a tuple a slot of ``(k, v)`` numpy pairs, each
    ``[n_groups, B, Se, K, hd]``) -> the port's ``caches["cross_kv"]``:
    one dict a decoder layer, ``k`` and ``v`` [B, Se, K, hd]."""
    device = default_device(device)
    segs = [{f"slot{j}": {"k": kv[0], "v": kv[1]}
             for j, kv in enumerate(seg)} for seg in caches_np["cross_kv"]]
    return _unstack(segs, cfg, lambda a: _to_torch(a, device))


def pools_from_jax(pools_np, cfg: ModelConfig, device=None) -> list:
    """The reference's paged pools (numpy leaves) -> the port's per-layer
    pools on ``device``, each with a zero drop page appended."""
    device = default_device(device)
    return _unstack(list(pools_np), cfg, lambda a: _to_torch(
        np.concatenate([a, np.zeros_like(a[:1])]), device))


def pools_to_jax(pools: list, cfg: ModelConfig) -> list:
    """The port's per-layer pools -> the reference's stacked layout, as
    numpy arrays, drop pages stripped."""
    return _stack([{name: _to_numpy(pool[name][:-1]) for name in ("k", "v")}
                   for pool in pools], cfg)


def adapter_from_jax(adapter_np: Dict[str, Any], cfg: ModelConfig,
                     device=None) -> dict:
    """A reference adapter (numpy leaves) -> the port's, on ``device``."""
    device = default_device(device)
    lora = adapter_np.get("lora") or {}
    names = _segment_names(cfg)
    extra = set(lora) - set(names) - set(_MTP)
    if extra:
        raise NotImplementedError(f"the port carries token-input decoders; "
                                  f"unsupported adapter groups {sorted(extra)}")
    out: Dict[str, Any] = {"lora": {}}
    if lora:
        out["lora"]["layers"] = _unstack([lora[n] for n in names], cfg,
                                         lambda a: _to_torch(a, device))
    if "mtp" in lora:
        out["lora"]["mtp"] = _mtp_from_jax(lora,
                                           lambda a: _to_torch(a, device))
    if "value_head" in adapter_np:
        out["value_head"] = _map(adapter_np["value_head"],
                                 lambda a: _to_torch(a, device))
    return out


def adapter_to_jax(adapter: dict, cfg: ModelConfig) -> Dict[str, Any]:
    """The port's adapter -> the reference's layout, as numpy arrays."""
    out: Dict[str, Any] = {"lora": {}}
    layers = (adapter.get("lora") or {}).get("layers")
    if layers:
        segs = _stack([_map(layer, _to_numpy) for layer in layers], cfg)
        out["lora"].update(zip(_segment_names(cfg), segs))
    mtp = (adapter.get("lora") or {}).get("mtp")
    if mtp:
        out["lora"].update(_mtp_to_jax([_map(m, _to_numpy) for m in mtp]))
    if "value_head" in adapter:
        out["value_head"] = _map(adapter["value_head"], _to_numpy)
    return out


def trainer_from_jax(base_np: Dict[str, Any], adapters_np: Dict[str, Any],
                     cfg: ModelConfig, rl, reward_fn=None, device=None,
                     telemetry=None):
    """The port's hydra ``RLHFTrainer`` from the reference trainer's trunk
    (``trainer.base_params``) and per-role adapters
    (``trainer.engine.adapters``), all as numpy leaves, on ``device``,
    with ``telemetry`` (``obs.RunTelemetry``) if given."""
    from repro_torch.rlhf import ModelEngine, RLHFTrainer
    device = default_device(device)
    engine = ModelEngine(
        cfg, None, rank=rl.lora_rank, base_params=from_jax(base_np, cfg, device),
        adapters={role: adapter_from_jax(ad, cfg, device)
                  for role, ad in adapters_np.items()})
    return RLHFTrainer(cfg, cfg, rl, reward_fn=reward_fn, engine=engine,
                       telemetry=telemetry)


def separate_trainer_from_jax(actor_np: Dict[str, Any],
                              critic_np: Dict[str, Any],
                              actor_cfg: ModelConfig, critic_cfg: ModelConfig,
                              rl, reward_fn=None, device=None,
                              telemetry=None):
    """The port's separate ``RLHFTrainer`` from the reference trainer's
    ``actor_state["params"]`` and ``critic_state["params"]`` (numpy
    leaves), on ``device``, with ``telemetry`` if given. As in the
    reference, the reference model is a copy of the actor's initial
    weights and the reward model one of the critic's."""
    from repro_torch.rlhf import RLHFTrainer
    device = default_device(device)
    params = {"actor": from_jax(actor_np, actor_cfg, device),
              "critic": from_jax(critic_np, critic_cfg, device)}
    return RLHFTrainer(actor_cfg, critic_cfg, rl, reward_fn=reward_fn,
                       params=params, telemetry=telemetry)


def grpo_trainer_from_jax(actor_np: Dict[str, Any], cfg: ModelConfig, rl,
                          reward_fn, device=None):
    """The port's ``GRPOTrainer`` from the reference trainer's
    ``actor_state["params"]`` (numpy leaves), on ``device``; as in the
    reference, the frozen reference model is a copy of them."""
    from repro_torch.rlhf import GRPOTrainer
    device = default_device(device)
    return GRPOTrainer(cfg, rl, None, reward_fn,
                       params=from_jax(actor_np, cfg, device))
