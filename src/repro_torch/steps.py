"""Losses, the full-parameter train step of the separate engine and the
LoRA train step of the hydra engine — the port of ``repro/steps.py``
(``:31-121``, ``_accumulated_grads`` ``:127``, ``make_train_step`` /
``init_train_state`` ``:201-297`` unsharded, ``make_lora_train_step`` /
``init_lora_train_state`` ``:300-395``, ``make_prefill_step`` /
``make_decode_step`` ``:398-409``).

A step computes its gradients with autograd (attention and norms
differentiate through the B2-bwd and B1-bwd kernels), clips them by their
global norm and applies the config's optimizer (the reference's AdamW or
Adafactor), both in place, as the reference's jitted step does with its
state donated. Gradients accumulate over microbatches in fp32 for AdamW
and in bf16 for any other optimizer (the reference's ``acc_dtype``,
``repro/steps.py:256, 349``); at one microbatch they keep the dtype
autograd gives them, except that AdamW's are fp32 copies. With
``cfg.mtp_depth`` set, the ppo and lm steps add ``0.1 * mtp_chain_loss``
(``:90-110``); the hydra step runs the chain on the frozen trunk,
adapter-free, as the reference does.

``shard=`` (a ``sharding.TreePlan``; the LoRA step's ``base_shard=`` for
the frozen trunk) makes a step ZeRO-aware with the reference's contract
(``:156-279, 300-340``): the params are gathered to the compute specs
before the forward (a whole tree, or layer by layer inside the model in
"layer" mode), the loss and gradients are computed on the gathered values,
the gradients are clipped by the norm of the full gradients, sliced to the
rank's part of the update layout and AdamW runs there in place; stages
1-2 then all-gather the new params. Adafactor's update layout is whole
(``Adafactor.update_pspecs``): the gradients and params are gathered
whole, updated on every rank alike, and the new params cut back onto the
ZeRO layout. With a replicated batch every stage
gives the unsharded bits. Under ``ShardedContext.sharded_batch()`` each
rank runs on its share of the batch: loss denominators count the whole
batch and gradients and metrics are summed over the ranks (a change of
summation order, ~ulp).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import Model
from repro_torch.optim import clip_by_global_norm_, make_optimizer
from repro_torch.optim.clip import sq_sum
from repro_torch.sharding import ctx as shctx
from repro_torch.sharding import tp as TP
from repro_torch.tree import leaves, tree_map

Count = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _count(count: Count, x: torch.Tensor) -> torch.Tensor:
    """A loss denominator's count: ``x`` itself, or ``count(x)`` (under a
    sharded batch, its sum over the ranks)."""
    return x if count is None else count(x)


def _batch_count(plan) -> Count:
    """The losses' ``count`` for a step on ``plan``: the sum over the ranks
    while the batch is sharded (``ShardedContext.sharded_batch``)."""
    comm = getattr(plan, "comm", None)
    if comm is None or not comm.batch_sharded:
        return None
    return lambda x: comm.all_reduce_(x.detach().clone())


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------
def _full_seq_logp(logits, targets):
    """Per-position log-prob of ``targets`` [B, T] under logits [B, T, V],
    with fp32 math: the target's logit minus the log-sum-exp, shifted by
    the (constant) row max as the reference does. Under an ambient TP
    group the logits are the rank's vocab columns
    (``TensorParallel.logp``)."""
    tp = TP.current()
    if tp is not None:
        return tp.logp(logits, targets)
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
                   kl_coef: float = 0.1, count: Count = None):
    tokens = batch["tokens"]
    mask = batch["loss_mask"].float().clone()
    mask[:, 0] = 0.0
    denom = torch.clamp(_count(count, mask.sum()), min=1.0)
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


def critic_loss(values, batch, *, clip_eps: float = 0.2,
                count: Count = None):
    mask = batch["loss_mask"].float()
    denom = torch.clamp(_count(count, mask.sum()), min=1.0)
    returns = batch["returns"]
    old_v = batch.get("old_values", returns)
    v_clip = old_v + torch.clamp(values - old_v, -clip_eps, clip_eps)
    sq = torch.maximum(torch.square(values - returns),
                       torch.square(v_clip - returns))
    loss = 0.5 * torch.sum(sq * mask) / denom
    return loss, {"vf_loss": loss}


def mtp_loss(logits, tokens, mask, *, offset: int = 2, count: Count = None):
    """MTP cross-entropy: logits[:, i] scores tokens[:, i+offset]
    (full-length logits; the last ``offset`` positions are padding). The
    depth-d logits of the chain use ``offset = d + 1``."""
    S = tokens.shape[1]
    tgt_full = torch.nn.functional.pad(tokens[:, offset:], (0, offset))
    nll = -_full_seq_logp(logits, tgt_full.long())[:, :S - offset]
    m = mask[:, offset:].float()
    return torch.sum(nll * m) / torch.clamp(_count(count, m.sum()), min=1.0)


def mtp_chain_loss(model: Model, params, h, batch, count: Count = None):
    """Mean cross-entropy over the depth-k MTP chain. ``params`` may be a
    frozen trunk (hydra): the chain always runs adapter-free."""
    lgs = model.mtp_chain_logits(params, h, batch["tokens"])
    losses = [mtp_loss(lg, batch["tokens"], batch["loss_mask"], offset=d + 1,
                       count=count)
              for d, lg in enumerate(lgs, start=1)]
    total = losses[0]
    for extra in losses[1:]:
        total = total + extra
    return total / len(losses)


def _with_aux(cfg: ModelConfig, kind: str, loss, metrics, aux, mtp_fn):
    """Add the MTP auxiliary loss (``0.1 * mtp_chain_loss``, reported as
    ``mtp_loss``) where the config has MTP heads and the step is not the
    critic's, then the forward's MoE load-balance loss ``aux`` (the
    reference's ``loss + aux``; nothing on a model without MoE layers)."""
    if cfg.mtp_depth and kind != "critic":
        mtp = mtp_fn()
        loss = loss + 0.1 * mtp
        metrics = dict(metrics, mtp_loss=mtp)
    if torch.is_tensor(aux):
        loss = loss + aux
    return loss, metrics


def lm_loss(logits, tokens, mask, *, prefix: int = 0, count: Count = None):
    nll = -_action_logp(logits, tokens, prefix)[:, 1:]
    m = mask[:, 1:].float()
    return torch.sum(nll * m) / torch.clamp(_count(count, m.sum()), min=1.0)


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------
def _prefix_len(cfg: ModelConfig) -> int:
    """Positions before the tokens in a forward's logits and values: the
    prefix embeddings of ``input_mode`` "embeddings", else none (an
    encoder-decoder's frames feed the cross-attention, not the decoder's
    sequence)."""
    return cfg.num_prefix_embeddings if cfg.input_mode == "embeddings" else 0


def acc_dtype(cfg: ModelConfig) -> torch.dtype:
    """The gradient accumulators' dtype: fp32 for AdamW, bf16 for the
    memory-lean optimizers (``repro/steps.py:256``)."""
    return torch.float32 if cfg.optimizer == "adamw" else torch.bfloat16


def _accumulated_grads(loss_fn: Callable, params, batch, N: int,
                       dtype: torch.dtype = torch.float32):
    """``((loss, metrics), grads)`` of ``loss_fn(params, batch)`` over the
    trainable leaves of ``params``, with N-way microbatch accumulation
    (N == 1 is one call), averaged over the microbatches, the sums in
    ``dtype``. Each microbatch's graph is freed by its backward before the
    next, and each of its gradients as soon as it is added. In fp32 the
    grads are fp32 at every N; in bf16 (the reference's accumulation for
    the optimizers other than AdamW) a single call keeps autograd's grads
    as they are, in the params' dtype, as the reference's plain
    ``value_and_grad`` does."""
    ps = list(leaves(params))
    B = next(iter(batch.values())).shape[0]
    if B % N:
        raise ValueError(f"batch {B} does not split into {N} microbatches")
    mb = B // N
    if N == 1 and dtype != torch.float32:
        loss, met = loss_fn(params, batch)
        grads = list(torch.autograd.grad(loss, ps, allow_unused=True))
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, ps)]
        it = iter(grads)
        return (loss.detach(), {k: v.detach() for k, v in met.items()}), \
            tree_map(lambda _: next(it), params)
    gacc = [torch.zeros_like(p, dtype=dtype) for p in ps]
    lacc, macc = 0.0, {}
    for i in range(N):
        sub = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()} \
            if N > 1 else batch
        loss, met = loss_fn(params, sub)
        grads = list(torch.autograd.grad(loss, ps, allow_unused=True))
        for j, a in enumerate(gacc):
            if grads[j] is not None:
                # fp32: a sum with no fp32 copy of g; bf16: the
                # reference's a + g.astype(bf16)
                a.add_(grads[j] if dtype == torch.float32
                       else grads[j].to(dtype))
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
    """Clips ``grads`` by their global norm and takes one optimizer step
    of ``state``'s params and moments, all in place -> the norm."""
    grads, gnorm = clip_by_global_norm_(grads, max_grad_norm)
    optimizer.update_(grads, state["opt"], state["params"], lr)
    state["step"] += 1
    return gnorm


def _check_tp(cfg: ModelConfig, *plans) -> None:
    """``cfg`` against what the port runs tensor parallel at the plans'
    model degree (``sharding.tp.check_supported``). A sharded step runs
    under its plan's ``ShardedContext`` (``sharding.ctx.use_mesh``): its
    model group, its data axis and whether the batch is split."""
    ntp = max((getattr(p.strat, "ntp", 1) for p in plans if p is not None),
              default=1)
    TP.check_supported(cfg, ntp)


def _reset_stash(plan) -> None:
    if hasattr(plan.layer_specs, "reset"):
        plan.layer_specs.reset()


def _sharded_update_(optimizer, plan, state, grads, lr: float,
                     max_grad_norm: float):
    """The ZeRO half of a step, in place (the reference's
    ``_run_sharded_update``): under a sharded batch the per-rank partial
    gradients are summed (a layer-mode shard's was reduce-scattered in the
    backward); the global norm is taken over the full gradients, leaf by
    leaf in the unsharded order (a shard's leaf gathered for its sum
    alone); the gradients are sliced to this rank's part of the update
    layout and scaled there; AdamW updates the rank's part; stages 1-2
    all-gather the new params -> the norm. A layer-mode shard's sum of
    squares was noted by its gather's backward (one microbatch); with
    several, its gradient is gathered for it."""
    comm = plan.comm
    flat = list(leaves(grads))
    layout = plan.grad_layout(grads)
    if comm.batch_sharded:
        for g, (is_shard, _) in zip(flat, layout):
            if not is_shard:
                comm.all_reduce_(g)
    lg = plan.layer_specs
    sums = []
    with torch.no_grad():
        for p, g, (is_shard, d) in zip(leaves(state["params"]), flat,
                                       layout):
            s = lg.take_sumsq(p) if is_shard else None
            if s is None:
                full = comm.all_gather(g, d) if is_shard else g
                s = sq_sum(full)
                del full
            sums.append(s)
        if plan.tp is None:
            norm = torch.sqrt(sum(sums))
        else:
            # a model-cut leaf's squares sum over the model group; a whole
            # one (the same gradient on every rank) counts once
            cut = plan.tp_cut()
            part = torch.stack([s for s, c in zip(sums, cut) if c]).sum()
            part = plan.tp.comm.all_reduce_(part.reshape(1))[0]
            norm = torch.sqrt(part + sum(s for s, c in zip(sums, cut)
                                         if not c))
        scale = torch.clamp(max_grad_norm / torch.clamp(norm, min=1e-9),
                            max=1.0)
        upd = plan.place_grads(grads)
        del grads, flat
        for g in leaves(upd):
            g.mul_(scale)
        views = plan.update_views(state["params"])
        optimizer.update_(upd, state["opt"], views, lr)
    state["step"] += 1
    plan.all_gather_updated_(state["params"], views)
    return norm


def _summed_metrics(plan, metrics: dict) -> dict:
    """Under a sharded batch each rank's loss terms are its rows' share:
    sum them over the ranks."""
    comm = plan.comm
    if not comm.batch_sharded:
        return metrics
    return {k: comm.all_reduce_(v.detach().clone()) for k, v in
            metrics.items()}


def make_train_step(model: Model, cfg: ModelConfig, *, lr: float = 3e-5,
                    kind: str = "ppo", kl_coef: float = 0.1,
                    max_grad_norm: float = 1.0, shard=None):
    """``step(state, batch) -> (state, metrics)`` over every leaf of
    ``state["params"]`` (the separate engine's actor and critic). kind:
    ppo | critic | lm. The step moves the params and moments in place
    and returns the same state dict, one step on. ``shard`` (the tree's
    ``TreePlan``) makes it ZeRO-aware (the module docstring)."""
    if kind not in ("ppo", "critic", "lm"):
        raise ValueError(f"kind must be ppo, critic or lm, not {kind!r}")
    _check_tp(cfg, shard)
    optimizer = make_optimizer(cfg.optimizer, cfg)
    prefix = _prefix_len(cfg)
    # per-layer ZeRO-3 gather (gather_mode "layer") inside the model
    lspecs = getattr(shard, "layer_specs", None)

    def loss_fn(params, batch):
        count = _batch_count(shard)
        if kind == "critic":
            values = model.forward_value(params, batch, layer_specs=lspecs)
            S = batch["tokens"].shape[1]
            return critic_loss(values[:, prefix:prefix + S], batch,
                               count=count)
        logits, aux, h = model.forward(params, batch, layer_specs=lspecs)
        if kind == "lm":
            loss = lm_loss(logits, batch["tokens"], batch["loss_mask"],
                           prefix=prefix, count=count)
            metrics = {"lm_loss": loss}
        else:
            loss, metrics = ppo_actor_loss(logits, batch, prefix=prefix,
                                           kl_coef=kl_coef, count=count)
        return _with_aux(cfg, kind, loss, metrics, aux,
                         lambda: mtp_chain_loss(model, params, h, batch,
                                                count=count))

    N = max(1, cfg.microbatches)
    dt = acc_dtype(cfg)

    def train_step(state, batch) -> Tuple[dict, Dict[str, torch.Tensor]]:
        if shard is None:
            with torch.enable_grad():
                (loss, metrics), grads = _accumulated_grads(
                    loss_fn, state["params"], batch, N, dt)
            gnorm = _update_(optimizer, state, grads, lr, max_grad_norm)
            return state, dict(metrics, loss=loss, grad_norm=gnorm)
        _reset_stash(shard)
        with torch.enable_grad(), shctx.use_mesh(shard.context):
            compute = shard.gather(state["params"])
            (loss, metrics), grads = _accumulated_grads(loss_fn, compute,
                                                        batch, N, dt)
            del compute
            metrics = _summed_metrics(shard, dict(metrics, loss=loss))
            gnorm = _sharded_update_(optimizer, shard, state, grads, lr,
                                     max_grad_norm)
        return state, dict(metrics, grad_norm=gnorm)

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
    trunk is an input that is never differentiated. kind: ppo | critic.
    ``shard`` (the adapter's ``TreePlan``) and ``base_shard`` (the
    trunk's) make it ZeRO-aware: the trunk is gathered for the forward
    (layer by layer in "layer" mode), the adapter whole."""
    if kind not in ("ppo", "critic"):
        raise ValueError(f"the port's LoRA step trains ppo or critic, not "
                         f"{kind!r}")
    if base_shard is not None and shard is None:
        raise ValueError("base_shard without an adapter plan")
    _check_tp(cfg, shard, base_shard)
    optimizer = make_optimizer(cfg.optimizer, cfg)
    prefix = _prefix_len(cfg)
    blspecs = getattr(base_shard, "layer_specs", None)

    def loss_fn(adapter, base_params, batch):
        count = _batch_count(shard)
        if kind == "critic":
            values = model.forward_value(base_params, batch, adapter=adapter,
                                         layer_specs=blspecs)
            S = batch["tokens"].shape[1]
            return critic_loss(values[:, prefix:prefix + S], batch,
                               count=count)
        logits, aux, h = model.forward(base_params, batch, adapter=adapter,
                                       layer_specs=blspecs)
        loss, metrics = ppo_actor_loss(logits, batch, prefix=prefix,
                                       kl_coef=kl_coef, count=count)
        return _with_aux(cfg, kind, loss, metrics, aux,
                         lambda: mtp_chain_loss(model, base_params, h, batch,
                                                count=count))

    N = max(1, cfg.microbatches)
    dt = acc_dtype(cfg)

    def train_step(state, base_params, batch
                   ) -> Tuple[dict, Dict[str, torch.Tensor]]:
        if shard is None:
            with torch.enable_grad():
                (loss, metrics), grads = _accumulated_grads(
                    lambda ad, mb: loss_fn(ad, base_params, mb),
                    state["params"], batch, N, dt)
            gnorm = _update_(optimizer, state, grads, lr, max_grad_norm)
            return state, dict(metrics, loss=loss, grad_norm=gnorm)
        _reset_stash(shard)
        with torch.enable_grad(), shctx.use_mesh(shard.context):
            base = base_params if base_shard is None \
                else base_shard.gather(base_params)
            adapter = shard.gather(state["params"])
            (loss, metrics), grads = _accumulated_grads(
                lambda ad, mb: loss_fn(ad, base, mb), adapter, batch, N, dt)
            del base, adapter
            metrics = _summed_metrics(shard, dict(metrics, loss=loss))
            gnorm = _sharded_update_(optimizer, shard, state, grads, lr,
                                     max_grad_norm)
        return state, dict(metrics, grad_norm=gnorm)

    train_step.optimizer = optimizer
    return train_step


def init_lora_train_state(adapter, optimizer):
    """Train state whose params (and so optimizer moments) are only the
    adapter tree; its leaves require grad."""
    for p in leaves(adapter):
        p.requires_grad_(True)
    return {"params": adapter, "opt": optimizer.init(adapter), "step": 0}


def make_prefill_step(model: Model, cfg: ModelConfig, *, capacity: int,
                      window: int = 0):
    def prefill_step(params, batch):
        return model.prefill(params, batch, capacity, window=window)
    return prefill_step


def make_decode_step(model: Model, cfg: ModelConfig, *, window: int = 0):
    def decode_step(params, caches, token, position):
        return model.decode_step(params, caches, token, position,
                                 window=window)
    return decode_step
