"""Which persistent state each runtime offload level swaps — copied from
``repro/core/strategies.py:61-86`` (``MemoryStrategy`` and the simulator's
scales are not ported yet).

The ``offload`` axis is the dynamic schedule: state is device-resident
exactly during the phases that touch it (``offload.OffloadPlan``)."""
from __future__ import annotations

from typing import Iterable, Set

OFFLOAD_LEVELS = ("none", "optimizer", "roles", "all")

# role params/adapters swapped at level "roles"; the frozen trunk joins at
# "all" (its rollout-phase eviction is what the hydra merged copy enables)
_ROLE_STATES = ("actor_params", "critic_params", "ref_params",
                "reward_params")


def offload_managed_states(level: str, names: Iterable[str]) -> Set[str]:
    """Which persistent-state names the runtime offload level swaps."""
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
