"""Shared-base "hydra" RLHF engine: one frozen trunk, per-role LoRA
adapters — the port of ``repro/rlhf/engine.py::ModelEngine`` (one device,
no ``shard``).

  * **base**      — ONE frozen parameter tree;
  * **actor**     — base ⊕ actor adapter (trained);
  * **reference** — the plain base forward (no copy: at init the actor's
    delta is zero, so ref ≡ actor-at-init);
  * **critic**    — base ⊕ critic adapter + value head (trained);
  * **reward**    — base ⊕ reward adapter + value head (frozen; seeded
    from the critic's init).

Optimizer state and gradients exist only for adapter leaves
(``steps.make_lora_train_step``). :meth:`ModelEngine.memory_accounting`
reckons this layout's persistent bytes beside the separate engine's on
the same config.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.models import Model
from repro_torch.models import lora as LORA
from repro_torch.optim import make_optimizer
from repro_torch.tree import leaves, tree_map


def _tree_bytes(tree) -> int:
    """Bytes of every leaf of ``tree``, aliases counted each time (the
    reference's ``engine._tree_bytes``)."""
    return sum(t.numel() * t.element_size() for t in leaves(tree))


class ModelEngine:
    """One frozen base tree + per-role adapters (LoRA factors on every
    adapted projection, plus value heads for critic/reward)."""

    VALUE_ROLES = frozenset({"critic", "reward"})

    ROLES = ("actor", "critic", "reward")

    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator],
                 *, rank: int = 128, base_params=None,
                 adapters: Optional[Dict[str, Any]] = None):
        """Random weights from ``generator`` (on the device the engine
        runs on), or the given ``base_params`` and ``adapters`` (then
        ``generator`` may be None)."""
        if cfg.input_mode != "tokens":
            raise ValueError(f"hydra engine needs token-input models, got "
                             f"{cfg.input_mode}")
        if not all(k == ATTN for k in cfg.layer_kinds()):
            raise ValueError(f"hydra engine covers attention-only trunks, "
                             f"got {cfg.name}")
        self.cfg = cfg
        self.rank = rank
        if base_params is None:
            self.model = Model(cfg, device=generator.device)
            self.base_params = self.model.init(generator)       # frozen
        else:
            self.model = Model(cfg, device=next(leaves(base_params)).device)
            self.base_params = base_params
        self.adapters: Dict[str, Any] = {}
        for role in self.ROLES:
            if adapters is not None:
                self.adapters[role] = adapters[role]
            elif role == "reward" and "critic" in self.adapters:
                # seeded from the critic init (the reference's parity with
                # its separate path's reward <- copy(critic init))
                self.adapters[role] = tree_map(torch.clone,
                                               self.adapters["critic"])
            else:
                self.adapters[role] = self.model.init_adapter(
                    generator, self.base_params, rank,
                    with_value=role in self.VALUE_ROLES)

    # ------------------------------------------------------ role forwards
    def logits(self, base_params, adapter, batch):
        """Role-switched forward: base ⊕ adapter -> [B,S,V] logits."""
        return self.model.forward(base_params, batch, adapter=adapter)[0]

    def ref_logits(self, base_params, batch):
        """The reference forward IS the plain base pass."""
        return self.model.forward(base_params, batch)[0]

    def values(self, base_params, adapter, batch):
        """Critic/reward forward: base ⊕ adapter + its value head."""
        return self.model.forward_value(base_params, batch, adapter=adapter)

    def lora_sites(self):
        """Structure-only copy of the adapter site tree (every leaf True).
        The offload subsystem walks it to find the trunk's adapted leaves
        (``lora.adapted_subtree``); every role shares the site layout, so
        the actor's adapter defines it."""
        return tree_map(lambda _: True, self.adapters["actor"]["lora"])

    # ---------------------------------------------------------- accounting
    def base_param_count(self) -> int:
        return sum(t.numel() for t in leaves(self.base_params))

    def adapter_param_count(self, role: str) -> int:
        return LORA.adapter_param_count(self.adapters[role])

    def trainable_fraction(self, role: str = "actor") -> float:
        return LORA.trainable_fraction(self.base_params, self.adapters[role])

    def memory_accounting(self) -> Dict[str, Dict[str, Dict[str, int]]]:
        """Per-role {params, opt, grad} bytes for the hydra layout, plus the
        separate engine's on the same config, as the reference reckons them
        (``repro/rlhf/engine.py:139-171``): AdamW's state is 8 bytes a
        parameter and its int32 count; a trained role's gradients are one
        fp32 copy of its trainables (``steps._accumulated_grads``)."""
        opt = make_optimizer(self.cfg.optimizer)
        base_b = _tree_bytes(self.base_params)
        out: Dict[str, Dict[str, int]] = {
            "base": {"params": base_b, "opt": 0, "grad": 0}}
        for role, ad in self.adapters.items():
            trained = role != "reward"
            out[role] = {
                "params": _tree_bytes(ad),
                "opt": opt.state_bytes(ad) if trained else 0,
                "grad": 4 * LORA.adapter_param_count(ad) if trained else 0}
        trained_full = {"params": base_b,
                        "opt": opt.state_bytes(self.base_params),
                        "grad": 4 * self.base_param_count()}
        sep = {"actor": dict(trained_full), "critic": dict(trained_full),
               "ref": {"params": base_b, "opt": 0, "grad": 0},
               "reward": {"params": base_b, "opt": 0, "grad": 0}}
        return {"hydra": out, "separate": sep}
