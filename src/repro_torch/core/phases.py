"""The phase sequence of one PPO iteration, copied from
``repro/core/phases.py:59-70`` (the phase tracer and the simulator's
phase models are not ported yet)."""
from __future__ import annotations

# Canonical order of one PPO iteration — the phase sequence the runtime
# trainer executes.
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
