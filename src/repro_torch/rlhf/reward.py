"""Reward models: a learned value-head scorer and a programmatic reward
for the runnable examples — the port of ``repro/rlhf/reward.py``."""
from __future__ import annotations

import torch

from repro_torch.models import Model


def sequence_reward(model: Model, params, tokens, mask, adapter=None):
    """Score = value-head output at each row's last generated token. [B]."""
    v = model.forward_value(params, {"tokens": tokens}, adapter=adapter)
    idx = torch.clamp(mask.sum(-1).long() - 1, min=0)
    return torch.gather(v, 1, idx[:, None])[:, 0]


def make_target_token_reward(target_id: int):
    """Fraction of generated tokens equal to ``target_id``."""
    def fn(tokens, mask):
        hit = (tokens == target_id).float() * mask
        return hit.sum(-1) / torch.clamp(mask.sum(-1), min=1.0)
    return fn
