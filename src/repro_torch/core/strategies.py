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

The traced ndp axis (``traced_zero_scales``, ``traced_strategy``) takes
per-rank fractions from the sharded spec trees of ``sharding.rules``,
built on a ``SpecMesh`` from the role trees' shapes on ``meta``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Iterable, Optional, Set, Tuple

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


# ---------------------------------------------------------------------------
# Traced ndp axis: per-rank fractions from the sharded spec trees
# ---------------------------------------------------------------------------
def _tree_fraction(spec_tree, shape_tree, mesh,
                   extra_bytes: int = 0) -> Tuple[float, float]:
    """(total bytes, per-rank bytes) of a tree of tensors (shapes read)
    under its specs; ``extra_bytes`` are whole on every rank (the
    optimizer's count, a host int in the port and an int32 in the
    reference)."""
    from repro_torch.sharding.rules import spec_device_fraction, spec_map
    tot = dev = float(extra_bytes)

    def add(spec, leaf):
        nonlocal tot, dev
        if not hasattr(leaf, "numel"):          # the host-int count
            return spec
        nb = float(leaf.numel() * leaf.element_size())
        tot += nb
        dev += nb * spec_device_fraction(spec, leaf, mesh)
        return spec

    spec_map(add, spec_tree, shape_tree)
    return tot, dev


@lru_cache(maxsize=64)
def traced_zero_scales(actor_cfg, critic_cfg=None, *, ndp: int,
                       zero_stage: int, engine: str = "separate",
                       lora_rank: int = 128,
                       gather_mode: str = "layer",
                       ntp: int = 1,
                       ) -> Tuple[Tuple[str, float], ...]:
    """Per-rank byte fractions of every persistent RLHF state group, traced
    from the sharded spec trees (the role trees on ``meta`` under the mesh
    rules) instead of the closed-form ``1/ndp`` — the reference's
    arithmetic (``repro/core/strategies.py:217-366``).

    The tuple plugs into :attr:`MemoryStrategy.traced`: ``"<state>:<tag>"``
    entries for every group of ``core.phases.build_rlhf_phases`` (the
    hydra value heads stay whole, the trunk shards), byte-weighted
    ``"param"/"opt"/"grad"`` aggregates, and ``layer_slice``: 1 under
    per-layer gathers, the layer count under whole-tree gathers.
    ``merged_rollout`` carries the compute layout of the adapted subtree
    (1.0 at ``ntp=1``). ``ntp`` rebuilds the trees on a ``(data=ndp,
    model=ntp)`` mesh with the Megatron rules."""
    from repro_torch.models import Model
    from repro_torch.models.lora import adapted_subtree
    from repro_torch.optim import make_optimizer
    from repro_torch.sharding.context import _strip_dp
    from repro_torch.sharding.rules import (ShardingStrategy, SpecMesh,
                                            adapter_pspecs, param_pspecs,
                                            spec_map, zero_opt_pspecs)
    if engine not in ("separate", "hydra"):
        raise ValueError(f"engine must be separate or hydra, not {engine!r}")
    if ntp < 1:
        raise ValueError(f"ntp must be >= 1, got {ntp}")
    if gather_mode not in ("layer", "tree"):
        raise ValueError(f"gather_mode must be layer or tree, not "
                         f"{gather_mode!r}")
    axes = {"data": ndp, "model": ntp} if ntp > 1 else {"data": ndp}
    mesh = SpecMesh(axes)
    strat = ShardingStrategy(zero_stage=zero_stage, tensor_parallel=ntp > 1,
                             expert_parallel=False, ntp=ntp)
    actor = Model(actor_cfg, device="meta")
    a_shapes = actor.init()
    a_specs = param_pspecs(actor_cfg, mesh, strat, a_shapes)

    def opt_entry(pspecs, shapes, cfg):
        opt = make_optimizer(cfg.optimizer)
        o_shapes = opt.init(shapes)      # moments in their dtype, on meta
        o_specs = opt.init_specs(
            zero_opt_pspecs(pspecs, shapes, mesh, strat), shapes)
        return _tree_fraction(o_specs, o_shapes, mesh, extra_bytes=4)

    if engine == "hydra":
        a_ad = actor.init_adapter(None, a_shapes, lora_rank)
        c_ad = actor.init_adapter(None, a_shapes, lora_rank, with_value=True)
        ad_specs = adapter_pspecs(mesh, strat, a_ad)
        cad_specs = adapter_pspecs(mesh, strat, c_ad)
        merged = adapted_subtree(a_shapes, a_ad["lora"])
        merged_specs = spec_map(lambda s: _strip_dp(s, mesh),
                                adapted_subtree(a_specs, a_ad["lora"]))
        groups = {
            "base_params": ("param", _tree_fraction(a_specs, a_shapes, mesh)),
            "actor_params": ("param", _tree_fraction(ad_specs, a_ad, mesh)),
            "critic_params": ("param", _tree_fraction(cad_specs, c_ad, mesh)),
            "reward_params": ("param", _tree_fraction(cad_specs, c_ad, mesh)),
            "actor_opt": ("opt", opt_entry(ad_specs, a_ad, actor_cfg)),
            "critic_opt": ("opt", opt_entry(cad_specs, c_ad, actor_cfg)),
            "merged_rollout": ("param",
                               _tree_fraction(merged_specs, merged, mesh)),
        }
        trainables = [(ad_specs, a_ad), (cad_specs, c_ad)]
    else:
        critic_cfg = critic_cfg or actor_cfg
        c_shapes = Model(critic_cfg, device="meta", with_value=True).init()
        c_specs = param_pspecs(critic_cfg, mesh, strat, c_shapes)
        groups = {
            "actor_params": ("param", _tree_fraction(a_specs, a_shapes, mesh)),
            "critic_params": ("param", _tree_fraction(c_specs, c_shapes, mesh)),
            "ref_params": ("param", _tree_fraction(a_specs, a_shapes, mesh)),
            "reward_params": ("param", _tree_fraction(c_specs, c_shapes, mesh)),
            "actor_opt": ("opt", opt_entry(a_specs, a_shapes, actor_cfg)),
            "critic_opt": ("opt", opt_entry(c_specs, c_shapes, critic_cfg)),
        }
        trainables = [(a_specs, a_shapes), (c_specs, c_shapes)]

    out = []
    agg: Dict[str, Tuple[float, float]] = {}
    for name, (tag, (tot, dev)) in groups.items():
        out.append((f"{name}:{tag}", dev / tot if tot else 1.0))
        t, d = agg.get(tag, (0.0, 0.0))
        agg[tag] = (t + tot, d + dev)
    for tag, (tot, dev) in agg.items():
        out.append((tag, dev / tot if tot else 1.0))
    # grads: ZeRO >= 2 re-shards them onto the trainable trees' optimizer
    # layout; below, they stay at the compute layout (whole in pure DP,
    # the param specs less DP under TP)
    if zero_stage >= 2 or ntp > 1:
        gt = gd = 0.0
        for pspecs, shapes in trainables:
            specs = zero_opt_pspecs(pspecs, shapes, mesh, strat) \
                if zero_stage >= 2 else \
                spec_map(lambda s: _strip_dp(s, mesh), pspecs)
            t, d = _tree_fraction(specs, shapes, mesh)
            gt, gd = gt + t, gd + d
        out.append(("grad", gd / gt if gt else 1.0))
    else:
        out.append(("grad", 1.0))
    # ZeRO-3's gather transient: tree mode keeps every gathered layer live
    # across the stack, so each per-layer event scales by the layer count
    n_slices = actor_cfg.num_layers // len(actor_cfg.period)
    out.append(("layer_slice",
                1.0 if gather_mode == "layer" else float(n_slices)))
    return tuple(out)


def traced_strategy(base: MemoryStrategy, actor_cfg, critic_cfg=None, *,
                    ndp: int, engine: str = "separate",
                    lora_rank: Optional[int] = None) -> MemoryStrategy:
    """``base`` with its ndp (and, by ``base.ntp``, tp) axis traced from
    the sharded spec trees."""
    return dataclasses.replace(
        base, traced=traced_zero_scales(
            actor_cfg, critic_cfg, ndp=ndp, zero_stage=base.zero_stage,
            engine=engine, gather_mode=base.gather_mode, ntp=base.ntp,
            lora_rank=base.lora_rank if lora_rank is None else lora_rank))
