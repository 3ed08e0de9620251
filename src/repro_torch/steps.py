"""Losses, the full-parameter train step of the separate engine and the
LoRA train step of the hydra engine — the port of ``repro/steps.py``
(``:31-121``, ``_accumulated_grads`` ``:127``, ``make_train_step`` /
``init_train_state`` ``:201-297`` unsharded, ``make_lora_train_step`` /
``init_lora_train_state`` ``:300-395``).

A step computes its gradients with autograd (attention and norms
differentiate through the B2-bwd and B1-bwd kernels), clips them by their
global norm and applies the reference's AdamW, both in place, as the
reference's jitted step does with its state donated. The shard (ZeRO/TP)
and MTP paths of the reference are not ported: asking for them raises.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import Model
from repro_torch.optim import clip_by_global_norm_, make_optimizer
from repro_torch.tree import leaves, tree_map


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------
def _full_seq_logp(logits, targets):
    """Per-position log-prob of ``targets`` [B, T] under logits [B, T, V],
    with fp32 math: the target's logit minus the log-sum-exp, shifted by
    the (constant) row max as the reference does."""
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
    mx = logits.max(-1).values.detach().float()
    lse = mx + torch.log(torch.sum(torch.exp(logits.float() - mx[..., None]),
                                   dim=-1))
    return tgt.float() - lse                                # [B, T]


def _action_logp(logits, tokens, prefix: int = 0):
    """logits [B, P+S, V]; tokens [B, S]. Per-action log-probs aligned so
    out[:, t] scores tokens[:, t] (t >= 1); out[:, 0] = 0."""
    B, S = tokens.shape
    T = logits.shape[1]
    tgt_full = torch.zeros((B, T), dtype=tokens.dtype, device=tokens.device)
    tgt_full[:, prefix:prefix + S - 1] = tokens[:, 1:]
    logp_full = _full_seq_logp(logits, tgt_full.long())
    act = logp_full[:, prefix:prefix + S - 1]
    return torch.nn.functional.pad(act, (1, 0))             # [B, S]


def ppo_actor_loss(logits, batch, *, prefix: int = 0, clip_eps: float = 0.2,
                   kl_coef: float = 0.1):
    tokens = batch["tokens"]
    mask = batch["loss_mask"].float().clone()
    mask[:, 0] = 0.0
    denom = torch.clamp(mask.sum(), min=1.0)
    logp = _action_logp(logits, tokens, prefix)
    ratio = torch.exp(logp - batch["old_logp"])
    adv = batch["advantages"]
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1 - clip_eps, 1 + clip_eps) * adv
    ppo = -torch.sum(torch.minimum(unclipped, clipped) * mask) / denom
    # k3 KL estimator vs the frozen reference policy
    log_r = batch["ref_logp"] - logp
    kl = torch.sum((torch.exp(log_r) - 1.0 - log_r) * mask) / denom
    loss = ppo + kl_coef * kl
    clip_frac = torch.sum(((ratio - 1).abs() > clip_eps).float() * mask) \
        / denom
    return loss, {"ppo_loss": ppo, "kl": kl, "clip_frac": clip_frac}


def critic_loss(values, batch, *, clip_eps: float = 0.2):
    mask = batch["loss_mask"].float()
    denom = torch.clamp(mask.sum(), min=1.0)
    returns = batch["returns"]
    old_v = batch.get("old_values", returns)
    v_clip = old_v + torch.clamp(values - old_v, -clip_eps, clip_eps)
    sq = torch.maximum(torch.square(values - returns),
                       torch.square(v_clip - returns))
    loss = 0.5 * torch.sum(sq * mask) / denom
    return loss, {"vf_loss": loss}


def lm_loss(logits, tokens, mask, *, prefix: int = 0):
    nll = -_action_logp(logits, tokens, prefix)[:, 1:]
    m = mask[:, 1:].float()
    return torch.sum(nll * m) / torch.clamp(m.sum(), min=1.0)


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------
def _accumulated_grads(loss_fn: Callable, params, batch, N: int):
    """``((loss, metrics), grads)`` of ``loss_fn(params, batch)`` over the
    trainable leaves of ``params``, with N-way microbatch accumulation
    (N == 1 is one call), averaged over the microbatches, grads in fp32.
    Each microbatch's graph is freed by its backward before the next, and
    each of its gradients as soon as it is added."""
    ps = list(leaves(params))
    B = next(iter(batch.values())).shape[0]
    if B % N:
        raise ValueError(f"batch {B} does not split into {N} microbatches")
    mb = B // N
    gacc = [torch.zeros_like(p, dtype=torch.float32) for p in ps]
    lacc, macc = 0.0, {}
    for i in range(N):
        sub = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()} \
            if N > 1 else batch
        loss, met = loss_fn(params, sub)
        grads = list(torch.autograd.grad(loss, ps, allow_unused=True))
        for j, a in enumerate(gacc):
            if grads[j] is not None:
                a.add_(grads[j])        # fp32 sum, no fp32 copy of g
            grads[j] = None
        lacc = lacc + loss.detach()
        for k, v in met.items():
            macc[k] = macc.get(k, 0.0) + v.detach()
    if N > 1:
        for a in gacc:
            a.div_(N)
    it = iter(gacc)
    grads = tree_map(lambda _: next(it), params)
    return (lacc / N, {k: v / N for k, v in macc.items()}), grads


def _update_(optimizer, state, grads, lr: float, max_grad_norm: float):
    """Clips the fp32 ``grads`` by their global norm and takes one AdamW
    step of ``state``'s params and moments, all in place -> the norm."""
    grads, gnorm = clip_by_global_norm_(grads, max_grad_norm)
    optimizer.update_(grads, state["opt"], state["params"], lr)
    state["step"] += 1
    return gnorm


def _check_single_device(cfg: ModelConfig, *shards) -> None:
    if any(s is not None for s in shards):
        raise NotImplementedError("the port's train step is single-device")
    if getattr(cfg, "mtp_depth", 0):
        raise NotImplementedError("MTP heads are not ported")


def make_train_step(model: Model, cfg: ModelConfig, *, lr: float = 3e-5,
                    kind: str = "ppo", kl_coef: float = 0.1,
                    max_grad_norm: float = 1.0, shard=None):
    """``step(state, batch) -> (state, metrics)`` over every leaf of
    ``state["params"]`` (the separate engine's actor and critic). kind:
    ppo | critic | lm. The step moves the params and moments in place
    and returns the same state dict, one step on."""
    _check_single_device(cfg, shard)
    if kind not in ("ppo", "critic", "lm"):
        raise ValueError(f"kind must be ppo, critic or lm, not {kind!r}")
    optimizer = make_optimizer(cfg.optimizer)

    def loss_fn(params, batch):
        if kind == "critic":
            return critic_loss(model.forward_value(params, batch), batch)
        logits, _ = model.forward(params, batch)
        if kind == "lm":
            loss = lm_loss(logits, batch["tokens"], batch["loss_mask"])
            return loss, {"lm_loss": loss}
        return ppo_actor_loss(logits, batch, kl_coef=kl_coef)

    N = max(1, cfg.microbatches)

    def train_step(state, batch) -> Tuple[dict, Dict[str, torch.Tensor]]:
        params = state["params"]
        with torch.enable_grad():
            (loss, metrics), grads = _accumulated_grads(loss_fn, params,
                                                        batch, N)
        gnorm = _update_(optimizer, state, grads, lr, max_grad_norm)
        return state, dict(metrics, loss=loss, grad_norm=gnorm)

    train_step.optimizer = optimizer
    return train_step


def init_train_state(model: Model, cfg: ModelConfig, generator, optimizer,
                     *, params=None):
    """Train state over a whole parameter tree: ``params`` (the initial
    weights, e.g. from ``bridge.from_jax``) or ``model.init(generator)``;
    every leaf requires grad."""
    if params is None:
        params = model.init(generator)
    for p in leaves(params):
        p.requires_grad_(True)
    return {"params": params, "opt": optimizer.init(params), "step": 0}


def make_lora_train_step(model: Model, cfg: ModelConfig, *, lr: float = 3e-5,
                         kind: str = "ppo", kl_coef: float = 0.1,
                         max_grad_norm: float = 1.0, shard=None,
                         base_shard=None):
    """``step(state, base_params, batch) -> (state, metrics)`` for one
    role's adapter: gradients and the optimizer state cover only the
    adapter leaves in ``state["params"]``, which move in place; the frozen
    trunk is an input that is never differentiated. kind: ppo | critic."""
    _check_single_device(cfg, shard, base_shard)
    if kind not in ("ppo", "critic"):
        raise ValueError(f"the port's LoRA step trains ppo or critic, not "
                         f"{kind!r}")
    optimizer = make_optimizer(cfg.optimizer)

    def loss_fn(adapter, base_params, batch):
        if kind == "critic":
            values = model.forward_value(base_params, batch, adapter=adapter)
            return critic_loss(values, batch)
        logits, _ = model.forward(base_params, batch, adapter=adapter)
        return ppo_actor_loss(logits, batch, kl_coef=kl_coef)

    N = max(1, cfg.microbatches)

    def train_step(state, base_params, batch
                   ) -> Tuple[dict, Dict[str, torch.Tensor]]:
        adapter = state["params"]
        with torch.enable_grad():
            (loss, metrics), grads = _accumulated_grads(
                lambda ad, mb: loss_fn(ad, base_params, mb), adapter, batch,
                N)
        gnorm = _update_(optimizer, state, grads, lr, max_grad_norm)
        return state, dict(metrics, loss=loss, grad_norm=gnorm)

    train_step.optimizer = optimizer
    return train_step


def init_lora_train_state(adapter, optimizer):
    """Train state whose params (and so optimizer moments) are only the
    adapter tree; its leaves require grad."""
    for p in leaves(adapter):
        p.requires_grad_(True)
    return {"params": adapter, "opt": optimizer.init(adapter), "step": 0}
