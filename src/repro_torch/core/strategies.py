"""Memory-management strategies (paper §2.2) and how they scale the traced
allocation events — the port of ``repro/core/strategies.py``.

The paper's experiment grid is DP over 4 GPUs (no TP), LoRA dim 128. Each
strategy maps to per-tag size multipliers applied when a trace is replayed
through the allocator simulator:

  tag            None   ZeRO-1      ZeRO-2      ZeRO-3          cpu_offload
  param          1      1           1           1/ndp           -
  opt            1      1/ndp       1/ndp       1/ndp           0 (host)
  grad           1      1           1/ndp       1/ndp           -
  layer_slice    0      0           0           1 (gather temp) -
  temp/input     1      1           1           1               -

``layer_slice`` events are the per-layer parameter slices of the walk
(``core.trace``): with ZeRO-3 they are real transient buffers (the
per-layer all-gather of the sharded weights — the varied-size churn the
paper blames for fragmentation); without ZeRO-3 the layer weights are
persistent storage, so the events vanish. Gradient checkpointing is not a
multiplier — it swaps in the remat="full" trace of the same model.

The *runtime offload* axis, ``MemoryStrategy.offload``, is the
phase-aware device<->host swapping of ``repro_torch.offload``, which the
simulator models by parking/fetching whole persistent buffer groups at
phase boundaries (see ``profiler.run_iteration``) instead of scaling
them:

  offload level   parked off-phase
  none            nothing (every tree resident for the whole iteration)
  optimizer       optimizer moments  (*_opt)
  roles           + per-role params/adapters (actor/critic/ref/reward)
  all             + the frozen base trunk while merged weights serve rollout
                    (hydra engine)

LoRA scales grad/opt by the trainable fraction, counted EXACTLY from the
real adapter tree of ``models.lora`` built on ``meta`` (no allocation).

The traced ndp axis of the reference (``traced_zero_scales``,
``traced_strategy``: per-device fractions from the sharded spec trees)
reads the mesh rules of ``sharding/``, which the port does not have yet:
both raise. ``MemoryStrategy.traced`` keeps its lookup, so a strategy
carrying the reference's entries scales as it does there.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Iterable, Optional, Set, Tuple

OFFLOAD_LEVELS = ("none", "optimizer", "roles", "all")

# role params/adapters swapped at level "roles"; the frozen trunk joins at
# "all" (its rollout-phase eviction is what the hydra merged copy enables)
_ROLE_STATES = ("actor_params", "critic_params", "ref_params",
                "reward_params")


def offload_managed_states(level: str, names: Iterable[str]) -> Set[str]:
    """Which persistent-state names the runtime offload level swaps.
    Shared by the allocator simulator and ``offload.OffloadPlan`` so the
    analytic and runtime schedules agree by construction."""
    if level not in OFFLOAD_LEVELS:
        raise ValueError(f"unknown offload level {level!r}; "
                         f"expected one of {OFFLOAD_LEVELS}")
    out: Set[str] = set()
    for n in names:
        if level == "none":
            break
        if n.endswith("_opt"):
            out.add(n)
        elif level in ("roles", "all") and n in _ROLE_STATES:
            out.add(n)
        elif level == "all" and n == "base_params":
            out.add(n)
    return out


@lru_cache(maxsize=256)
def _traced_lookup(traced: tuple) -> dict:
    """Tuple->dict view of a traced-scales tuple, cached — ``scale`` sits
    on the profiler's per-buffer hot path."""
    return dict(traced)


@dataclass(frozen=True)
class MemoryStrategy:
    name: str
    zero_stage: int = 0          # 0 = none
    cpu_offload: bool = False
    grad_ckpt: bool = False
    lora_rank: int = 128         # LoRA rank of the trainable-fraction axis
    offload: str = "none"        # runtime swap level (repro_torch.offload)
    # ZeRO-3 all-gather granularity of the runtime being modelled: "layer"
    # = one layer transient, "tree" = whole-tree transient (realized
    # through a traced "layer_slice" entry)
    gather_mode: str = "layer"
    # TP degree of the runtime being modelled; only traced entries realize
    # it
    ntp: int = 1
    # traced per-device byte fractions from the sharded spec trees:
    # entries keyed "state:tag" (exact, per persistent group) with "tag"
    # aggregates as fallback. Empty = the closed-form 1/ndp model.
    traced: Tuple[Tuple[str, float], ...] = ()

    def scale(self, tag: str, *, ndp: int, trainable_fraction: float = 1.0,
              param_persistent: bool = True,
              state: Optional[str] = None) -> float:
        z = self.zero_stage
        if self.traced and tag in ("param", "opt", "grad"):
            if tag == "opt" and self.cpu_offload:
                return 0.0
            d = _traced_lookup(self.traced)
            v = d.get(f"{state}:{tag}") if state else None
            if v is None:
                v = d.get(tag)
            if v is not None:
                mult = trainable_fraction if tag in ("opt", "grad") else 1.0
                return v * mult
        if tag == "param":
            return 1.0 / ndp if z >= 3 else 1.0
        if tag == "opt":
            if self.cpu_offload:
                return 0.0
            base = 1.0 / ndp if z >= 1 else 1.0
            return base * trainable_fraction
        if tag == "grad":
            base = 1.0 / ndp if z >= 2 else 1.0
            return base * trainable_fraction
        if tag == "layer_slice":
            if z < 3:
                return 0.0
            if self.traced:
                v = _traced_lookup(self.traced).get("layer_slice")
                if v is not None:
                    return v
            return 1.0
        if tag in ("input", "temp", "cache"):
            return 1.0
        return 1.0


PAPER_STRATEGIES = (
    MemoryStrategy("None"),
    MemoryStrategy("ZeRO-1", zero_stage=1),
    MemoryStrategy("ZeRO-2", zero_stage=2),
    MemoryStrategy("ZeRO-3", zero_stage=3),
    MemoryStrategy("ZeRO-3 + CPU Offloading", zero_stage=3, cpu_offload=True),
    MemoryStrategy("Gradient Checkpointing", grad_ckpt=True),
    MemoryStrategy("All Enabled", zero_stage=3, cpu_offload=True,
                   grad_ckpt=True),
)


@lru_cache(maxsize=64)
def _exact_fraction(cfg, rank: int) -> float:
    from repro_torch.models import Model
    from repro_torch.models.lora import trainable_fraction

    model = Model(cfg, device="meta")
    base = model.init()
    adapter = model.init_adapter(None, base, rank)
    return min(1.0, trainable_fraction(base, adapter))


def lora_trainable_fraction(cfg, rank: int = 128) -> float:
    """EXACT LoRA-r trainable fraction for a model config: the real adapter
    tree is built on ``meta`` (no allocation) and its leaves counted
    against the base tree's. ``rank <= 0`` means full fine-tuning."""
    if rank <= 0:
        return 1.0
    return _exact_fraction(cfg, rank)


def traced_zero_scales(*args, **kwargs):
    """Per-device fractions from the sharded spec trees: not ported, since
    they read the mesh rules of ``sharding/``."""
    raise NotImplementedError(
        "traced_zero_scales reads the mesh rules of sharding/, which the "
        "port does not have yet; the closed-form 1/ndp of "
        "MemoryStrategy.scale applies")


def traced_strategy(*args, **kwargs):
    """A strategy with its ndp axis traced: not ported."""
    raise NotImplementedError(
        "traced_strategy reads the mesh rules of sharding/, which the port "
        "does not have yet; the closed-form 1/ndp of "
        "MemoryStrategy.scale applies")
