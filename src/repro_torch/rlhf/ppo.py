"""PPO math: per-token rewards (KL-shaped), GAE, advantage whitening —
the port of ``repro/rlhf/ppo.py``."""
from __future__ import annotations

import torch


def kl_shaped_rewards(logp, ref_logp, terminal_reward, mask, *,
                      kl_coef: float = 0.1, clip_reward: float = 5.0):
    """Per-token reward: -kl_coef * (logp - ref_logp), plus the clipped
    sequence reward on each row's last valid token. All [B, S]."""
    rewards = -kl_coef * (logp - ref_logp) * mask
    last = torch.clamp(mask.sum(-1).long() - 1, min=0, max=mask.shape[1] - 1)
    terminal = torch.clamp(terminal_reward, -clip_reward, clip_reward)
    rows = torch.arange(rewards.shape[0], device=rewards.device)
    return rewards.index_put((rows, last), terminal.to(rewards.dtype),
                             accumulate=True)


def gae(rewards, values, mask, *, gamma: float = 1.0, lam: float = 0.95):
    """Generalized advantage estimation over the generated region, a
    reversed loop over S (the reference's reversed ``lax.scan``).
    rewards/values/mask [B, S] -> (advantages, returns) [B, S]."""
    B, S = rewards.shape
    adv_next = torch.zeros(B, dtype=rewards.dtype, device=rewards.device)
    val_next = torch.zeros_like(adv_next)
    out = [None] * S
    for t in range(S - 1, -1, -1):
        r, v, m = rewards[:, t], values[:, t], mask[:, t]
        delta = r + gamma * val_next * m - v
        adv_next = delta + gamma * lam * adv_next * m
        val_next = v
        out[t] = adv_next
    advantages = torch.stack(out, dim=1) * mask
    return advantages, advantages + values


def whiten(x, mask, *, eps: float = 1e-8):
    n = torch.clamp(mask.sum(), min=1.0)
    mean = torch.sum(x * mask) / n
    var = torch.sum(torch.square(x - mean) * mask) / n
    return (x - mean) * torch.rsqrt(var + eps) * mask
