"""The phase sequence of one PPO iteration and the per-state touch map,
copied from ``repro/core/phases.py:59-124`` (the phase tracer and the
simulator's phase models are not ported yet)."""
from __future__ import annotations

from typing import Dict

# Canonical order of one PPO iteration — the phase sequence the runtime
# trainer executes and the offload scheduler compiles against.
RLHF_PHASE_SEQUENCE = (
    "rollout_prefill", "rollout_decode", "score_reward", "score_ref",
    "score_values", "score_old_logp", "train_actor", "train_critic")


def _collapse_rollout(seq):
    out = []
    for p in seq:
        c = "rollout" if p.startswith("rollout") else p
        if not out or out[-1] != c:
            out.append(c)
    return tuple(out)


# the same iteration at the granularity the runtime trainer bounds it
# (prefill+decode are one "rollout" phase between boundaries)
RUNTIME_RLHF_PHASE_SEQUENCE = _collapse_rollout(RLHF_PHASE_SEQUENCE)


def phase_state_touches(engine: str = "separate") -> Dict[str, frozenset]:
    """state name -> the phases (trace-level names) during which that
    persistent tree must be device-resident: the paper's
    phase-exclusivity map.

    Hydra: ``base_params`` sits out the rollout phases — generation runs
    from the *merged* copy (``merged_rollout``), so the trunk's adapted
    leaves are redundant there and ``offload="all"`` parks them."""
    if engine == "hydra":
        return {
            "base_params": frozenset(RLHF_PHASE_SEQUENCE)
            - {"rollout_prefill", "rollout_decode"},
            "merged_rollout": frozenset({"rollout_prefill", "rollout_decode"}),
            "actor_params": frozenset({"rollout_prefill", "rollout_decode",
                                       "score_old_logp", "train_actor"}),
            "actor_opt": frozenset({"train_actor"}),
            "critic_params": frozenset({"score_values", "train_critic"}),
            "critic_opt": frozenset({"train_critic"}),
            "reward_params": frozenset({"score_reward"}),
        }
    if engine != "separate":
        raise ValueError(f"engine must be separate or hydra, not {engine!r}")
    return {
        "actor_params": frozenset({"rollout_prefill", "rollout_decode",
                                   "score_old_logp", "train_actor"}),
        "actor_opt": frozenset({"train_actor"}),
        "critic_params": frozenset({"score_values", "train_critic"}),
        "critic_opt": frozenset({"train_critic"}),
        "ref_params": frozenset({"score_ref"}),
        "reward_params": frozenset({"score_reward"}),
    }


def runtime_state_touches(engine: str = "separate") -> Dict[str, frozenset]:
    """:func:`phase_state_touches` with the two rollout phases collapsed
    into the one ``"rollout"`` phase the trainer bounds — plus the trees
    the merge needs resident at rollout entry (hydra: the base trunk feeds
    ``merge_adapter`` before the scheduler's mid-phase park)."""
    out = {}
    for name, phases in phase_state_touches(engine).items():
        collapsed = {("rollout" if p.startswith("rollout") else p)
                     for p in phases}
        if engine == "hydra" and name == "base_params":
            collapsed.add("rollout")     # resident for the merge itself
        out[name] = frozenset(collapsed)
    out.pop("merged_rollout", None)      # the merged tree is phase-local
    return out
