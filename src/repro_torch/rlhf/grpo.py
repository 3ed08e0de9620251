"""GRPO (group-relative policy optimization) — critic-free RLHF; the port of
``repro/rlhf/grpo.py``.

For each prompt, sample a group of G responses; the advantage of response i
is its reward standardized within the group. Removes the critic and reward
*value* model from the memory picture entirely (two of the paper's four
models) — the memory-minimal member of the framework's RLHF family, and a
natural beyond-paper data point for the §Paper-claims study
(``core.phases.build_grpo_phases`` is its simulated counterpart).

``shard=`` (a ``sharding.ShardedContext``) runs the actor and the
reference on its plan, as ``RLHFTrainer(shard=)`` does: ZeRO over
``data`` with the batch replicated, and tensor parallelism over
``model``, every phase under the context (the rollout through
``Rollout(mesh=)``, eager decode, sampled rows all-gathered).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, check_token_inputs
from repro_torch.models import Model
from repro_torch.optim import make_optimizer
from repro_torch.rlhf.rollout import Rollout
from repro_torch.rlhf.trainer import PhaseMemoryManager, RLHFTrainer
from repro_torch.sharding import ctx as shctx
from repro_torch.sharding import tp as TP
from repro_torch.sharding.context import delete_tree
from repro_torch.steps import _action_logp, make_train_step
from repro_torch.tree import tree_map


@dataclasses.dataclass
class GRPOConfig:
    prompt_len: int = 8
    gen_len: int = 16
    group_size: int = 8
    kl_coef: float = 0.02
    lr: float = 1e-3
    temperature: float = 1.0
    top_k: int = 0
    memory_policy: str = "after_inference"
    rollout_backend: str = "dense"   # "paged": G samples fork ONE shared
    page_size: int = 16              # prompt prefill (CoW page sharing)


class GRPOTrainer:
    """Two models only: actor + frozen reference. ``reward_fn`` is
    programmatic (verifiable rewards) or any callable (tokens, mask) ->
    [B]. Random weights come from ``generator`` (its device is the
    trainer's), or the actor's initial weights are passed in whole as
    ``params`` (``bridge.grpo_trainer_from_jax``); the device is ``cuda``
    unless one of the two lies elsewhere. The boundaries ``rollout``,
    ``score`` and ``train_actor`` are recorded on the caching allocator
    (``PhaseMemoryManager``). ``shard`` runs it on a ``ShardedContext``
    (the module's note)."""

    def __init__(self, actor_cfg: ModelConfig, rl: GRPOConfig,
                 generator: Optional[torch.Generator], reward_fn: Callable,
                 *, params=None, shard=None):
        check_token_inputs(actor_cfg, "GRPOTrainer")
        if shard is not None:
            TP.check_supported(actor_cfg, shard.ntp)
            if shard.comm is None:
                raise ValueError("a ShardedContext on a SpecMesh names specs "
                                 "only; the trainer needs a process group")
        self.rl = rl
        self.actor_cfg = actor_cfg
        self.shard = shard
        device = generator.device if generator is not None else \
            params["embed"].device
        self.actor = Model(actor_cfg, device=device)
        self.device = self.actor.device
        self.reward_fn = reward_fn
        self.plan = None if shard is None else shard.plan_params(
            actor_cfg, Model(actor_cfg, device="meta").init(),
            make_optimizer(actor_cfg.optimizer))
        self.actor_step = make_train_step(self.actor, actor_cfg, kind="ppo",
                                          lr=rl.lr, kl_coef=rl.kl_coef,
                                          shard=self.plan)
        self.actor_state = RLHFTrainer._init_state(
            self.actor, actor_cfg, generator, self.actor_step.optimizer,
            params, self.plan)
        with torch.no_grad():
            self.ref_params = tree_map(torch.clone,
                                       self.actor_state["params"])
        self.rollout = Rollout(self.actor, actor_cfg,
                               capacity=rl.prompt_len + rl.gen_len,
                               temperature=rl.temperature, top_k=rl.top_k,
                               backend=rl.rollout_backend,
                               page_size=rl.page_size, mesh=shard)
        self._live: Dict[str, torch.Tensor] = {}
        self.memory = PhaseMemoryManager(
            policy=rl.memory_policy, device=self.device,
            tracked=lambda: [self.actor_state, self.ref_params, self._live])

    @torch.no_grad()
    def _token_logp(self, params, batch):
        plan = self.plan
        if plan is not None:
            params = plan.gather(params)
        logits = self.actor.forward(
            params, batch, layer_specs=getattr(plan, "layer_specs", None))[0]
        return _action_logp(logits, batch["tokens"])

    def _generate(self, prompts, generator, G: int):
        """The rollout, from a ZeRO-3 ``gather_copy`` under a sharded plan
        (freed after it)."""
        p, owned = self.actor_state["params"], False
        if self.plan is not None:
            p, owned = self.plan.gather_copy(p)
        try:
            with torch.no_grad():
                return self.rollout.generate(p, {"tokens": prompts},
                                             self.rl.gen_len, generator,
                                             group_size=G)
        finally:
            if owned:
                delete_tree(p)

    def train_step(self, prompts: torch.Tensor,
                   generator: torch.Generator) -> Dict[str, float]:
        """prompts [B, P]; each prompt is expanded to a group of G. On the
        paged rollout backend the G samples fork one shared prompt prefill
        (CoW page sharing) — same sampled stream as the dense repeat, with
        the prompt prefilled once per unique prompt."""
        with shctx.use_mesh(self.shard):
            return self._train_step(prompts, generator)

    def _train_step(self, prompts, generator) -> Dict[str, float]:
        G = self.rl.group_size
        B = prompts.shape[0]
        self.memory.iteration_start()
        ro = self._generate(prompts, generator, G)               # [B*G, ...]
        live = self._live
        live.update(tokens=ro.tokens, mask=ro.mask)
        del ro
        self.memory.boundary("rollout", "inference")

        batch = {"tokens": live["tokens"]}
        live["old_logp"] = self._token_logp(self.actor_state["params"], batch)
        live["ref_logp"] = self._token_logp(self.ref_params, batch)
        self.memory.boundary("score", "inference")

        mask = live["mask"]
        with torch.no_grad():
            rewards = self.reward_fn(live["tokens"], mask)      # [B*G]
            rg = rewards.reshape(B, G)
            adv_seq = (rg - rg.mean(dim=1, keepdim=True)) / (
                rg.std(dim=1, keepdim=True, unbiased=False) + 1e-6)
            adv = adv_seq.reshape(B * G)[:, None] * mask    # token-broadcast
        exp = {"tokens": live["tokens"], "loss_mask": mask,
               "advantages": adv, "old_logp": live["old_logp"] * mask,
               "ref_logp": live["ref_logp"] * mask,
               "returns": torch.zeros_like(mask)}
        live.clear()
        _, m = self.actor_step(self.actor_state, exp)
        out = {k: float(v) for k, v in m.items()}
        out["mean_reward"] = float(rewards.mean())
        del m, rewards
        self.memory.boundary("train_actor", "training", exp)
        return out
