"""The RLHF PPO trainer, with the paper's phase-boundary memory
management, in two engine layouts — the port of ``repro/rlhf/trainer.py``
(``PhaseMemoryManager`` ``:120-335``, ``RLHFConfig``, ``RLHFTrainer`` with
``_init_separate`` ``:646-745``, ``_init_hydra``'s merged rollout
``:812-856`` and ``make_experience``/``train_step`` ``:1064-1161``):

  * ``engine="separate"`` — the four-model pipeline the paper profiles:
    actor and reference on ``actor_cfg``, critic and reward on
    ``critic_cfg`` with a value head, as full parameter trees; the actor
    and critic train every leaf (``steps.make_train_step``, two full AdamW
    states); the reference is a frozen copy of the actor's initial
    weights and the reward model one of the critic's;
  * ``engine="hydra"`` — one frozen trunk with per-role LoRA adapters
    (``rlhf.engine``); rollout generates from weights with the actor's
    A·B merged in, dropped at the boundary.

One iteration runs the seven phases of
``core.phases.RUNTIME_RLHF_PHASE_SEQUENCE``: rollout, score_reward (the
frozen reward model's value at each row's last token, or a programmatic
``reward_fn``), score_ref, score_values, score_old_logp, train_actor and
train_critic (one step each per PPO epoch). ``PhaseMemoryManager`` records
each boundary on PyTorch's caching allocator — the allocator
``core/allocator.py`` simulates — so the paper's ``empty_cache()`` at a
phase boundary is measured, not simulated.

``rl.offload`` (``optimizer``, ``roles``, ``all``) parks the role state a
phase does not touch to host memory between the phases that do
(``repro_torch.offload``; the reference's ``_init_offload`` and
``_offload_states``, ``:563-643``): pinned memory on the card, committed
copies on the CPU. It is a pure placement change: the same phases run the
same kernels on the same values.

``rl.capture_buckets`` pads the rollout's prompts to a compile-bucket
rung (``Rollout(capture_buckets=)``), as the reference does. Not ported:
ZeRO/TP sharding, telemetry and attribution, and speculative decoding;
asking for any of them raises.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch import default_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import Model
from repro_torch.models import lora as LORA
from repro_torch.models.lora import delete_merged
from repro_torch.offload import HostParkingLot, OffloadExecutor, OffloadPlan
from repro_torch.rlhf.engine import ModelEngine
from repro_torch.rlhf.ppo import gae, kl_shaped_rewards, whiten
from repro_torch.rlhf.reward import sequence_reward
from repro_torch.rlhf.rollout import Rollout, live_device_bytes
from repro_torch.steps import (_action_logp, init_lora_train_state,
                               init_train_state, make_lora_train_step,
                               make_train_step)
from repro_torch.tree import leaves, nbytes, tree_map

MEMORY_POLICIES = ("none", "after_inference", "after_training", "after_all")


@dataclass
class PhaseMemoryManager:
    """Phase-boundary memory hygiene + per-phase memory records.

    At a boundary it drops the references it is handed, and under a
    policy that covers the phase's kind (``after_inference``,
    ``after_training``, ``after_all``) runs ``gc.collect()`` then
    ``torch.cuda.empty_cache()`` — the paper's insertion. Each record
    holds the phase's wall time since the last record (the device
    synchronised on CUDA), ``live_bytes`` (``torch.cuda.memory_allocated``),
    ``reserved_bytes`` (``memory_reserved``), ``peak_bytes``
    (``max_memory_allocated`` since the last boundary, which resets it) and
    ``requested_bytes`` (the live tensors' bytes as asked for, unrounded:
    ``memory_stats()["requested_bytes.all.current"]``);
    a boundary's record also holds the seconds its own hygiene took
    (``hygiene_seconds``, within ``seconds``).
    On the CPU no allocator metric exists: ``live_bytes`` is the bytes of
    the tensors ``tracked()`` returns, and the other three are None.
    ``device`` defaults to ``repro_torch.default_device()``: CUDA, raising
    where there is no card.

    With an ``offload`` executor attached (``rl.offload != "none"``) a
    boundary runs, in the reference's order (``repro/rlhf/trainer.py:
    309-334``): drop, **park** the trees the next phase does not touch,
    gc and ``empty_cache`` (per policy), record, reset the peak, then
    **fetch** the next phase's trees. Every record holds ``host_bytes``
    (the lot's parked bytes); a boundary's also ``park_seconds`` and
    ``fetch_seconds`` with the bytes each moved (``park_bytes``,
    ``fetch_bytes``), apart from ``hygiene_seconds`` and all within
    ``seconds``, which so runs to the end of the fetch."""
    policy: str = "after_inference"
    device: torch.device = field(default_factory=default_device)
    tracked: Optional[Callable[[], Any]] = None
    records: List[dict] = field(default_factory=list)
    offload: Optional[OffloadExecutor] = None

    def __post_init__(self):
        if self.policy not in MEMORY_POLICIES:
            raise ValueError(
                f"unknown memory policy {self.policy!r}; "
                f"expected one of {MEMORY_POLICIES}")
        self.device = torch.device(self.device)
        self._cuda = self.device.type == "cuda"
        self._mark = time.perf_counter()

    def _now(self) -> float:
        if self._cuda:
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def iteration_start(self):
        """Start the first phase's clock and peak."""
        self._mark = self._now()
        if self._cuda:
            torch.cuda.reset_peak_memory_stats(self.device)

    def _record(self, phase: str, kind: str, **extra) -> dict:
        now = self._now()
        if self._cuda:
            live = live_device_bytes(self.device)
            reserved = torch.cuda.memory_reserved(self.device)
            peak = torch.cuda.max_memory_allocated(self.device)
            requested = torch.cuda.memory_stats(self.device)[
                "requested_bytes.all.current"]
        else:
            live = nbytes(self.tracked()) if self.tracked else 0
            reserved = peak = requested = None
        host = 0 if self.offload is None else self.offload.lot.parked_bytes()
        rec = {"phase": phase, "kind": kind, "live_bytes": live,
               "reserved_bytes": reserved, "peak_bytes": peak,
               "requested_bytes": requested,
               "host_bytes": host, "seconds": now - self._mark,
               "t": time.time(), **extra}
        self._mark = now
        self.records.append(rec)
        return rec

    def sample(self, phase: str, kind: str = "inference", **extra) -> dict:
        """Mid-phase record (no hygiene, no peak reset): where the live set
        changes inside a phase, as in rollout decode from merged weights."""
        return self._record(phase, kind, sample=True, **extra)

    def _moved(self) -> tuple:
        """(bytes parked, bytes fetched) by the lot so far."""
        if self.offload is None:
            return 0, 0
        st = self.offload.lot.stats
        return st.bytes_parked_total, st.bytes_fetched_total

    def park_merged(self) -> dict:
        """Hydra rollout's mid-phase park (``offload="all"``: the trunk's
        adapted leaves are dead while merged weights serve; the rollout
        boundary fetches them back) -> its seconds and bytes, for the
        phase's sample."""
        t0, (parked0, _) = self._now(), self._moved()
        self.offload.rollout_merged()
        return {"park_seconds": self._now() - t0,
                "park_bytes": self._moved()[0] - parked0}

    def boundary(self, phase: str, kind: str, *drop: dict) -> dict:
        for tree in drop:
            tree.clear()
        t0 = self._now()
        parked0, _ = self._moved()
        if self.offload is not None:
            self.offload.park_for_boundary(phase)
        t1 = self._now()
        if (self.policy == "after_all"
                or (self.policy == "after_inference" and kind == "inference")
                or (self.policy == "after_training" and kind == "training")):
            gc.collect()
            if self._cuda:
                torch.cuda.empty_cache()
        parked1, fetched1 = self._moved()
        rec = self._record(phase, kind, hygiene_seconds=self._now() - t1,
                           park_seconds=t1 - t0, park_bytes=parked1 - parked0,
                           fetch_seconds=0.0, fetch_bytes=0)
        if self._cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        if self.offload is not None:
            self.offload.fetch_for_boundary(phase)
            now = self._now()
            rec["fetch_seconds"] = now - self._mark
            rec["fetch_bytes"] = self._moved()[1] - fetched1
            rec["seconds"] += rec["fetch_seconds"]
            self._mark = now
        return rec


@dataclass
class RLHFConfig:
    prompt_len: int = 32
    gen_len: int = 32
    kl_coef: float = 0.1
    gamma: float = 1.0
    lam: float = 0.95
    ppo_epochs: int = 1
    lr: float = 1e-5
    critic_lr: float = 1e-5
    temperature: float = 1.0
    top_k: int = 50
    whiten_advantages: bool = True
    memory_policy: str = "after_inference"
    engine: str = "separate"        # separate | hydra
    lora_rank: int = 128            # hydra adapter rank (paper grid: 128)
    # runtime host-offload level (repro_torch.offload): none | optimizer |
    # roles | all — which role state is parked to host between the phases
    # that touch it ("all" also parks the hydra trunk's adapted leaves
    # while merged weights serve rollout)
    offload: str = "none"
    # the reference's field for what the port does not have yet: it must
    # stay at its default
    spec_decode: bool = False
    # prefill compile-bucket ladder for the rollout's prompts (None: pad
    # nothing)
    capture_buckets: Optional[Sequence[int]] = None


_NOT_PORTED = {"spec_decode": False}


class RLHFTrainer:
    """PPO over (actor, critic, reference, reward). The reward is the
    frozen reward model's value at each row's last generated token, or any
    ``reward_fn(tokens, mask) -> [B]``.

    ``rl.engine`` picks the layout. Random weights come from ``generator``
    (its device is the trainer's); or the initial weights are passed in
    whole: ``params={"actor": ..., "critic": ...}`` for the separate engine
    (``bridge.separate_trainer_from_jax``), ``engine=`` for the hydra one
    (``bridge.trainer_from_jax``), whose path ignores ``critic_cfg``, as
    the reference's does."""

    def __init__(self, actor_cfg: ModelConfig, critic_cfg: ModelConfig,
                 rl: RLHFConfig, generator: Optional[torch.Generator] = None,
                 reward_fn: Optional[Callable] = None, shard=None,
                 telemetry=None, *, engine: Optional[ModelEngine] = None,
                 params: Optional[Dict[str, Any]] = None):
        if rl.engine not in ("separate", "hydra"):
            raise ValueError(f"engine must be separate or hydra, not "
                             f"{rl.engine!r}")
        for name, default in _NOT_PORTED.items():
            if getattr(rl, name) != default:
                raise NotImplementedError(f"RLHFConfig.{name} is not ported")
        if shard is not None or telemetry is not None:
            raise NotImplementedError("sharding and telemetry are not ported")
        self.rl = rl
        self.actor_cfg, self.critic_cfg = actor_cfg, critic_cfg
        self.reward_fn = reward_fn
        if rl.engine == "hydra":
            self._init_hydra(actor_cfg, rl, generator, engine)
        else:
            self._init_separate(actor_cfg, critic_cfg, rl, generator, params)
        # the phase-scoped buffers (merged rollout weights, rollout
        # outputs, experience), set and cleared by _gen / make_experience
        # / train_step
        self._live: Dict[str, Any] = {}
        self.memory = PhaseMemoryManager(policy=rl.memory_policy,
                                         device=self.device,
                                         tracked=self._tracked)
        self.rollout = Rollout(self.actor, actor_cfg,
                               capacity=rl.prompt_len + rl.gen_len,
                               temperature=rl.temperature, top_k=rl.top_k,
                               capture_buckets=rl.capture_buckets)
        self.offload = self.offload_lot = None
        if rl.offload != "none":
            self._init_offload(rl)

    def _init_separate(self, actor_cfg, critic_cfg, rl, generator, params):
        """Four full models; the actor and critic train every leaf, the
        reference and reward models are frozen clones of their initial
        weights."""
        self.engine = None
        params = params or {}
        device = generator.device if generator is not None else \
            next(leaves(params["actor"])).device
        # stateless: the actor's model serves the reference's params, the
        # critic's the reward model's
        self.actor = Model(actor_cfg, device=device)
        self.critic = Model(critic_cfg, device=device, with_value=True)
        self.device = self.actor.device
        self.actor_step = make_train_step(self.actor, actor_cfg, kind="ppo",
                                          lr=rl.lr, kl_coef=rl.kl_coef)
        self.critic_step = make_train_step(self.critic, critic_cfg,
                                           kind="critic", lr=rl.critic_lr)
        self.actor_state = init_train_state(
            self.actor, actor_cfg, generator, self.actor_step.optimizer,
            params=params.get("actor"))
        self.critic_state = init_train_state(
            self.critic, critic_cfg, generator, self.critic_step.optimizer,
            params=params.get("critic"))
        # reference = frozen copy of the (SFT) actor init; reward = frozen
        # copy of the critic init (a critic that stopped learning at
        # preference time)
        with torch.no_grad():
            self.ref_params = tree_map(torch.clone,
                                       self.actor_state["params"])
            self.reward_params = tree_map(torch.clone,
                                          self.critic_state["params"])

    def _init_hydra(self, cfg, rl, generator, engine):
        self.engine = engine if engine is not None else ModelEngine(
            cfg, generator, rank=rl.lora_rank)
        self.actor = self.engine.model          # the shared headless trunk
        self.device = self.actor.device
        self.base_params = self.ref_params = self.engine.base_params
        self.reward_adapter = self.engine.adapters["reward"]
        self.actor_step = make_lora_train_step(
            self.actor, cfg, kind="ppo", lr=rl.lr, kl_coef=rl.kl_coef)
        self.critic_step = make_lora_train_step(
            self.actor, cfg, kind="critic", lr=rl.critic_lr)
        self.actor_state = init_lora_train_state(
            self.engine.adapters["actor"], self.actor_step.optimizer)
        self.critic_state = init_lora_train_state(
            self.engine.adapters["critic"], self.critic_step.optimizer)

    def _tracked(self):
        """What the CPU's live-bytes record counts: the persistent trees
        and the phase-scoped buffers, less the parked trees (the lot's
        host copies, as the reference's numpy parks are not device
        bytes)."""
        frozen = [self.ref_params, self.reward_params] \
            if self.engine is None else [self.base_params,
                                         self.reward_adapter]
        trees = frozen + [self.actor_state, self.critic_state, self._live]
        if self.offload_lot is None:
            return trees
        lot = self.offload_lot
        parked = {id(t) for n in lot.names() for t in leaves(lot.peek(n))}
        return [t for t in leaves(trees) if id(t) not in parked]

    # ------------------------------------------------------------- offload
    def _init_offload(self, rl: RLHFConfig):
        """Runtime host offload: compile the phase plan, bind it to a
        parking lot over the trainer's state accessors, and do the initial
        placement (everything rollout does not touch goes to host)."""
        states = self._offload_states()
        # a programmatic reward_fn means score_reward never touches the
        # reward model: park it once at start instead of swapping it
        # every iteration
        unused = ("reward_params",) if self.reward_fn is not None else ()
        plan = OffloadPlan.compile(rl.offload, engine=rl.engine,
                                   states=states, frozen_unused=unused)
        self.offload_lot = HostParkingLot(self.device)
        self.offload = OffloadExecutor(plan, self.offload_lot, states)
        self.memory.offload = self.offload
        self.offload.start()

    def _offload_states(self) -> Dict[str, Any]:
        """name -> (get, set) accessors over the trainer's live trees. The
        setters repoint every alias (train-state dicts, engine views, the
        hydra reference), so a parked device tensor keeps no reference."""

        def state_slot(state_attr, slot, alias=None):
            def get():
                return getattr(self, state_attr)[slot]

            def set_(v):
                getattr(self, state_attr)[slot] = v
                if alias is not None:
                    self.engine.adapters[alias] = v
            return get, set_

        def attr(name):
            return (lambda: getattr(self, name),
                    lambda v: setattr(self, name, v))

        if self.engine is None:
            return {
                "actor_params": state_slot("actor_state", "params"),
                "actor_opt": state_slot("actor_state", "opt"),
                "critic_params": state_slot("critic_state", "params"),
                "critic_opt": state_slot("critic_state", "opt"),
                "ref_params": attr("ref_params"),
                "reward_params": attr("reward_params"),
            }

        # hydra: the swappable unit of the trunk is its adapted-site
        # subtree, exactly the leaves merge_adapter replaces; the merged
        # rollout copy aliases everything else, which must stay put
        sites = self.engine.lora_sites()

        def set_base(subtree):
            new = LORA.with_adapted_leaves(self.base_params, sites, subtree)
            self.base_params = self.engine.base_params = new
            self.ref_params = new          # the reference IS the base

        def set_reward(v):
            self.reward_adapter = self.engine.adapters["reward"] = v

        return {
            "base_params": (lambda: LORA.adapted_subtree(self.base_params,
                                                         sites), set_base),
            "actor_params": state_slot("actor_state", "params",
                                       alias="actor"),
            "actor_opt": state_slot("actor_state", "opt"),
            "critic_params": state_slot("critic_state", "params",
                                        alias="critic"),
            "critic_opt": state_slot("critic_state", "opt"),
            "reward_params": (lambda: self.reward_adapter, set_reward),
        }

    def persistent_trees(self) -> Dict[str, Any]:
        """The role state that lives across iterations (the reference's
        ``_persistent_trees``)."""
        out = {"actor_params": self.actor_state["params"],
               "actor_opt": self.actor_state["opt"],
               "critic_params": self.critic_state["params"],
               "critic_opt": self.critic_state["opt"]}
        if self.engine is None:
            out.update(ref_params=self.ref_params,
                       reward_params=self.reward_params)
        else:
            out.update(base_params=self.base_params,
                       reward_params=self.reward_adapter)
        return out

    # ---------------------------------------------------------- role calls
    def _gen(self, prompts, generator):
        """Rollout. Separate: from the actor's live params. Hydra: from
        merged weights, A·B of the actor folded into the trunk once per
        phase; the merged leaves' references are dropped before the
        boundary, so the caching allocator gets them back."""
        if self.engine is None:
            with torch.no_grad():
                return self.rollout.generate(
                    self.actor_state["params"], {"tokens": prompts},
                    self.rl.gen_len, generator)
        adapter = self.actor_state["params"]
        merged = self.actor.merge_adapter(self.base_params, adapter)
        self._live["merged_rollout"] = merged
        parked = self.memory.park_merged() if self.offload is not None \
            else {}
        try:
            ro = self.rollout.generate(merged, {"tokens": prompts},
                                       self.rl.gen_len, generator)
            # the live set changes inside this phase (merged weights
            # serve): record it before the merged leaves die
            self.memory.sample("rollout_decode", **parked)
            return ro
        finally:
            delete_merged(merged, adapter.get("lora"))
            self._live.pop("merged_rollout", None)

    def _reward_scores(self, tokens, mask):
        if self.engine is None:
            return sequence_reward(self.critic, self.reward_params, tokens,
                                   mask)
        return sequence_reward(self.actor, self.base_params, tokens, mask,
                               adapter=self.reward_adapter)

    def _token_logp(self, role, batch):
        """Per-action log-probs of the actor (``role="actor"``) or the
        frozen reference (``"ref"``)."""
        if self.engine is None:
            params = self.actor_state["params"] if role == "actor" \
                else self.ref_params
            logits = self.actor.forward(params, batch)[0]
        elif role == "actor":
            logits = self.engine.logits(self.base_params,
                                        self.actor_state["params"], batch)
        else:
            logits = self.engine.ref_logits(self.base_params, batch)
        return _action_logp(logits, batch["tokens"])

    def _values(self, batch):
        if self.engine is None:
            return self.critic.forward_value(self.critic_state["params"],
                                             batch)
        return self.engine.values(self.base_params,
                                  self.critic_state["params"], batch)

    def _actor_update(self, exp):
        """One step of the actor (its params and moments move in place)."""
        trunk = () if self.engine is None else (self.base_params,)
        return self.actor_step(self.actor_state, *trunk, exp)[1]

    def _critic_update(self, cbatch):
        trunk = () if self.engine is None else (self.base_params,)
        return self.critic_step(self.critic_state, *trunk, cbatch)[1]

    # ------------------------------------------------------------ phases
    def make_experience(self, prompts: torch.Tensor,
                        generator: torch.Generator) -> Dict[str, Any]:
        """Phases 1-5: rollout and the four scoring forwards (under
        ``torch.no_grad()``) -> the experience batch."""
        mm = self.memory
        ro = self._gen(prompts, generator)
        self._live["rollout"] = {"tokens": ro.tokens, "logp": ro.logp,
                                 "mask": ro.mask}
        mm.boundary("rollout", "inference")
        batch = {"tokens": ro.tokens}
        mask = ro.mask
        del ro
        with torch.no_grad():
            if self.reward_fn is not None:
                terminal = self.reward_fn(batch["tokens"], mask)
            else:
                terminal = self._reward_scores(batch["tokens"], mask)
            mm.boundary("score_reward", "inference")
            ref_logp = self._token_logp("ref", batch)
            mm.boundary("score_ref", "inference")
            values = self._values(batch) * mask
            mm.boundary("score_values", "inference")
            old_logp = self._token_logp("actor", batch)
            mm.boundary("score_old_logp", "inference")

            rewards = kl_shaped_rewards(old_logp, ref_logp, terminal, mask,
                                        kl_coef=self.rl.kl_coef)
            adv, returns = gae(rewards, values, mask, gamma=self.rl.gamma,
                               lam=self.rl.lam)
            if self.rl.whiten_advantages:
                adv = whiten(adv, mask)
        return {"tokens": batch["tokens"], "loss_mask": mask,
                "advantages": adv, "old_logp": old_logp * mask,
                "ref_logp": ref_logp * mask, "returns": returns,
                "old_values": values, "mean_reward": terminal.mean()}

    def train_step(self, prompts: torch.Tensor,
                   generator: torch.Generator) -> Dict[str, float]:
        """One full PPO iteration (all seven phases)."""
        self.memory.iteration_start()
        exp = self.make_experience(prompts, generator)
        self._live["experience"] = exp
        mean_reward = float(exp.pop("mean_reward"))
        old_values = exp.pop("old_values")
        metrics = {}
        for _ in range(self.rl.ppo_epochs):
            m = self._actor_update(exp)
            metrics.update({k: float(v) for k, v in m.items()})
        self.memory.boundary("train_actor", "training")
        cbatch = dict(exp, old_values=old_values)
        del old_values
        for _ in range(self.rl.ppo_epochs):
            mc = self._critic_update(cbatch)
            metrics.update({k: float(v) for k, v in mc.items()})
        self._live.pop("rollout", None)
        self._live.pop("experience", None)
        self.memory.boundary("train_critic", "training", exp, cbatch)
        metrics["mean_reward"] = mean_reward
        return metrics
