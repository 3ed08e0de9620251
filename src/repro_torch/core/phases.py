"""RLHF phase plans: the PPO iteration of DeepSpeed-Chat / ColossalChat as a
sequence of traced phases (paper §2.1 / §3.1) — the port of
``repro/core/phases.py``.

One PPO iteration touches four models:

  1. rollout      — actor prefill + N decode steps (experience generation)
  2. score_reward — reward-model forward over the generated sequences
  3. score_ref    — reference-model forward (KL logprobs)
  4. score_values — critic forward (value estimates)
  5. score_old    — actor forward (old logprobs)
  6. train_actor  — PPO update (fwd+bwd+opt)
  7. train_critic — value-function update

Each phase is the event trace (``core.trace``) of the port's own program
for it, run on ``meta`` tensors at the *paper's* scale (OPT-1.3b
actor/ref + OPT-350m critic/reward, batch 2, prompt 256 + generate 256):
``Model.prefill`` and ``Model.decode_step`` (in place on a fixed-capacity
cache, as the rollout runs them), the scoring phases as the trainer runs
them (the log-probs of the forward's logits, the values, the reward at
each row's last token), and ``steps.make_train_step`` /
``make_lora_train_step``. ``naive_generation`` models ColossalChat's
original ``generate()`` (paper App. B): every decode step reallocates a
grown KV cache instead of writing into a fixed-capacity one.

Models, parameters, adapters, optimizer state and caches are all built on
``meta``, as the reference builds them under ``jax.eval_shape``; the port
keeps one parameter dict per layer, so its persistent buffers are one per
layer's leaf where the reference's are stacked over the layers.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.trace import Trace, trace_function
from repro_torch.tree import leaves

META = torch.device("meta")


@dataclass
class Phase:
    name: str
    kind: str                     # "inference" | "training"
    trace: Trace
    repeats: int = 1              # decode steps replay the same trace
    model: str = "actor"          # which persistent model it touches
    flops: float = 0.0            # analytic, for the time-overhead model
    hbm_bytes: float = 0.0        # weight traffic (decode is BW-bound)
    # phase outputs (experience / kv caches) stay live until the named
    # phase completes — None frees them immediately
    free_after: Optional[str] = None


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


@dataclass
class PersistentBuffers:
    """Long-lived allocations (model weights, optimizer states) shared
    across phases: name -> list[(nbytes, tag)].

    ``required_by`` (name -> phase names) records which phases touch each
    buffer — the residency schedule the offload axis swaps against; names
    absent from it are always-resident. ``transient`` names are
    phase-local at *every* offload level (the hydra engine's merged
    rollout weights exist only while generation runs)."""
    buffers: Dict[str, List[Tuple[int, str]]] = field(default_factory=dict)
    required_by: Dict[str, frozenset] = field(default_factory=dict)
    transient: frozenset = frozenset()


def _batch_specs(cfg: ModelConfig, B: int, S: int, train: bool):
    """The batch a phase reads, on ``meta``: int64 tokens as the rollout
    makes them, and the experience's fp32 [B, S] rows for training."""
    batch = {"tokens": torch.empty((B, S), dtype=torch.long, device=META)}
    if train:
        for k in ("loss_mask", "advantages", "old_logp", "ref_logp",
                  "returns"):
            batch[k] = torch.empty((B, S), dtype=torch.float32, device=META)
    return batch


def _fwd_flops(cfg: ModelConfig, tokens: int) -> float:
    return 2.0 * cfg.param_count() * tokens


def _nbytes(tree) -> List[int]:
    return [t.numel() * t.element_size() for t in leaves(tree)]


def build_rlhf_phases(actor_cfg: ModelConfig, critic_cfg: ModelConfig, *,
                      batch: int = 2, prompt_len: int = 256,
                      gen_len: int = 256, grad_ckpt: bool = False,
                      naive_generation: bool = False,
                      min_bytes: int = 64 * 1024,
                      ppo_epochs: int = 1,
                      engine: str = "separate", lora_rank: int = 128):
    """Returns (phases, persistent buffers).

    ``engine="separate"`` is the paper's four-model pipeline;
    ``engine="hydra"`` traces the shared-base engine instead (one frozen
    trunk, per-role LoRA adapters at ``lora_rank``, adapter-only train
    steps, merged-weight rollout) so the analytic model covers the same
    layout the runtime offload subsystem swaps. The port's flash kernel
    serves every attention, so the reference's ``FLASH_MIN_ELEMS`` has no
    counterpart here."""
    # models and steps import the offload package, which imports this
    # module: import them at call time
    from repro_torch.models import Model
    from repro_torch.models.lora import adapted_subtree
    from repro_torch.rlhf.reward import sequence_reward
    from repro_torch.steps import (_action_logp, init_lora_train_state,
                                   init_train_state, make_decode_step,
                                   make_lora_train_step, make_prefill_step,
                                   make_train_step)
    if engine not in ("separate", "hydra"):
        raise ValueError(f"engine must be separate or hydra, not {engine!r}")
    remat = "full" if grad_ckpt else "none"
    # bf16 mixed precision as the paper's frameworks use
    actor_cfg = dataclasses.replace(actor_cfg, remat=remat,
                                    param_dtype="bfloat16")
    critic_cfg = dataclasses.replace(critic_cfg, remat=remat,
                                     param_dtype="bfloat16")
    S = prompt_len + gen_len
    actor = Model(actor_cfg, device=META)
    a_params = actor.init()

    persistent = PersistentBuffers()

    def add_persistent(name, tree, tag):
        persistent.buffers[name] = [(nb, tag) for nb in _nbytes(tree)]

    if engine == "hydra":
        critic = actor                       # heads ride the shared trunk
        actor_ad = actor.init_adapter(None, a_params, lora_rank)
        critic_ad = actor.init_adapter(None, a_params, lora_rank,
                                       with_value=True)
        a_step = make_lora_train_step(actor, actor_cfg, kind="ppo")
        c_step = make_lora_train_step(actor, actor_cfg, kind="critic")
        a_state = init_lora_train_state(actor_ad, a_step.optimizer)
        c_state = init_lora_train_state(critic_ad, c_step.optimizer)
        add_persistent("base_params", a_params, "param")   # ONE frozen trunk
        add_persistent("actor_params", a_state["params"], "param")
        add_persistent("actor_opt", a_state["opt"], "opt")
        add_persistent("critic_params", c_state["params"], "param")
        add_persistent("critic_opt", c_state["opt"], "opt")
        add_persistent("reward_params", critic_ad, "param")  # frozen adapter
        # rollout generates from merged weights: a phase-local copy of the
        # trunk's adapted leaves (non-adapted leaves alias the base)
        add_persistent("merged_rollout",
                       adapted_subtree(a_params, actor_ad["lora"]), "param")
    else:
        critic = Model(critic_cfg, device=META, with_value=True)
        c_params = critic.init()
        a_step = make_train_step(actor, actor_cfg, kind="ppo")
        c_step = make_train_step(critic, critic_cfg, kind="critic")
        a_state = init_train_state(actor, actor_cfg, None, a_step.optimizer)
        c_state = init_train_state(critic, critic_cfg, None,
                                   c_step.optimizer)
        add_persistent("actor_params", a_state["params"], "param")
        add_persistent("actor_opt", a_state["opt"], "opt")
        add_persistent("critic_params", c_state["params"], "param")
        add_persistent("critic_opt", c_state["opt"], "opt")
        add_persistent("ref_params", a_params, "param")     # frozen copy
        add_persistent("reward_params", c_params, "param")  # frozen copy

    # phase-exclusivity schedule: which phases touch which buffer (the
    # offload axis of profiler.run_iteration swaps against this)
    persistent.required_by = {
        k: v for k, v in phase_state_touches(engine).items()
        if k in persistent.buffers}
    persistent.transient = frozenset({"merged_rollout"}) & \
        frozenset(persistent.buffers)

    phases: List[Phase] = []

    # ---- rollout: prefill + gen_len decode steps --------------------------
    cap = S
    pf = make_prefill_step(actor, actor_cfg, capacity=cap)
    pf_batch = _batch_specs(actor_cfg, batch, prompt_len, train=False)
    tr_pf = trace_function(pf, (a_params, pf_batch), ("param", "input"),
                           min_bytes=min_bytes)
    a_bytes = actor_cfg.param_count() * 2
    # hydra scoring phases stream the shared trunk, not a separate critic
    c_bytes = a_bytes if engine == "hydra" else critic_cfg.param_count() * 2
    phases.append(Phase("rollout_prefill", "inference", tr_pf,
                        flops=_fwd_flops(actor_cfg, batch * prompt_len),
                        hbm_bytes=a_bytes,
                        free_after="rollout_decode"))

    caches = actor.init_cache(batch, cap, torch.bfloat16)
    caches_w = {"layers": caches}
    dec = make_decode_step(actor, actor_cfg)
    tok = torch.empty((batch,), dtype=torch.long, device=META)
    pos = torch.empty((batch,), dtype=torch.int32, device=META)
    tr_dec = trace_function(dec, (a_params, caches_w, tok, pos),
                            ("param", "cache", "input", "input"),
                            min_bytes=min_bytes // 8)
    if naive_generation:
        # HF-style dynamic KV cache, as the paper's frameworks used at the
        # time (DeepSpeed-Chat / ColossalChat generate(), paper App. B):
        # every step, every layer does new_kv = cat(old_kv, kv_t) — the new
        # (slightly larger) buffer is allocated while the old one is still
        # live, so no cached block ever fits and reserved memory churns.
        cache_bytes = sum(_nbytes(caches))
        L = actor_cfg.num_layers
        per_layer_tok = cache_bytes / (L * cap)     # bytes per layer per token
        grow = Trace()
        live = {}                                    # layer -> (vid, nb)
        vid = iter(range(10_000_000, 10**9))
        # decode-trace vids with no matching free (step outputs): free them
        # at step end so the synthetic trace stays balanced
        open_vids = {}
        for op, v, b, tg in tr_dec.events:
            if tg == "cache":
                continue
            if op == "alloc":
                open_vids[v] = (b, tg)
            else:
                open_vids.pop(v, None)
        for t in range(gen_len):
            cur = prompt_len + t + 1
            for l in range(L):
                v = next(vid)
                nb = int(per_layer_tok * cur)
                grow.alloc(v, nb, "temp")            # cat() result
                if l in live:
                    grow.free(*live[l], "temp")
                live[l] = (v, nb)
            # per-step activation temps from the real decode trace
            base = 500_000_000 + t * 200_000
            for op, v, b, tg in tr_dec.events:
                if tg == "cache":
                    continue
                (grow.alloc if op == "alloc" else grow.free)(base + v, b, tg)
            for v, (b, tg) in open_vids.items():
                grow.free(base + v, b, tg)
        for l, (v, nb) in live.items():
            grow.free(v, nb, "temp")
        phases.append(Phase("rollout_decode", "inference", grow,
                            flops=_fwd_flops(actor_cfg, batch * gen_len),
                            hbm_bytes=a_bytes * gen_len))
    else:
        phases.append(Phase("rollout_decode", "inference", tr_dec,
                            repeats=gen_len,
                            flops=_fwd_flops(actor_cfg, batch * gen_len),
                            hbm_bytes=a_bytes * gen_len))

    # ---- scoring inferences, as RLHFTrainer.make_experience runs them -----
    full_batch = _batch_specs(actor_cfg, batch, S, train=False)
    mask = torch.empty((batch, S), dtype=torch.float32, device=META)
    hy = engine == "hydra"

    def score_trace(fn, params, adapter, *extra):
        """Trace ``fn(params, adapter, batch, *extra)`` with no grad; the
        adapter (hydra: the role's LoRA tree over the shared trunk, or
        None) is a second persistent param input."""
        return trace_function(
            torch.no_grad()(fn), (params, adapter, full_batch) + extra,
            ("param", "param", "input") + ("input",) * len(extra),
            min_bytes=min_bytes)

    def logp(model):
        return lambda p, ad, b: _action_logp(
            model.forward(p, b, adapter=ad)[0], b["tokens"])

    def values(model):
        return lambda p, ad, b: model.forward_value(p, b, adapter=ad)

    def reward(model):
        return lambda p, ad, b, m: sequence_reward(model, p, b["tokens"], m,
                                                   adapter=ad)

    sc_params = a_params if hy else c_params
    phases.append(Phase("score_reward", "inference",
                        score_trace(reward(critic), sc_params,
                                    critic_ad if hy else None, mask),
                        model="reward", hbm_bytes=c_bytes,
                        flops=_fwd_flops(critic_cfg, batch * S),
                        free_after="train_critic"))
    phases.append(Phase("score_ref", "inference",
                        score_trace(logp(actor), a_params, None),
                        model="ref",
                        flops=_fwd_flops(actor_cfg, batch * S),
                        hbm_bytes=a_bytes, free_after="train_critic"))
    phases.append(Phase("score_values", "inference",
                        score_trace(values(critic), sc_params,
                                    critic_ad if hy else None),
                        model="critic", hbm_bytes=c_bytes,
                        flops=_fwd_flops(critic_cfg, batch * S),
                        free_after="train_critic"))
    phases.append(Phase("score_old_logp", "inference",
                        score_trace(logp(actor), a_params,
                                    actor_ad if hy else None),
                        model="actor",
                        flops=_fwd_flops(actor_cfg, batch * S),
                        hbm_bytes=a_bytes, free_after="train_critic"))

    # ---- training ----------------------------------------------------------
    tb = _batch_specs(actor_cfg, batch, S, train=True)
    # the critic's batch carries the scored values (trainer.train_step)
    cb = dict(tb, old_values=torch.empty((batch, S), dtype=torch.float32,
                                         device=META))
    st_tags = {"params": "param", "opt": "opt", "step": "opt"}
    if hy:
        # lora steps: (adapter_state, frozen_base, batch) — grads/opt cover
        # only the adapter leaves; the trunk rides along un-differentiated
        tr_actor = trace_function(a_step, (a_state, a_params, tb),
                                  (st_tags, "param", "input"),
                                  min_bytes=min_bytes)
        tr_critic = trace_function(c_step, (c_state, a_params, cb),
                                   (st_tags, "param", "input"),
                                   min_bytes=min_bytes)
    else:
        tr_actor = trace_function(a_step, (a_state, tb), (st_tags, "input"),
                                  min_bytes=min_bytes)
        tr_critic = trace_function(c_step, (c_state, cb), (st_tags, "input"),
                                   min_bytes=min_bytes)
    phases.append(Phase("train_actor", "training", tr_actor,
                        repeats=ppo_epochs, hbm_bytes=3 * a_bytes,
                        flops=3 * _fwd_flops(actor_cfg, batch * S)))
    phases.append(Phase("train_critic", "training", tr_critic,
                        repeats=ppo_epochs, model="critic",
                        hbm_bytes=3 * c_bytes,
                        flops=3 * _fwd_flops(critic_cfg, batch * S)))
    return phases, persistent


def build_grpo_phases(actor_cfg: ModelConfig, *, batch: int = 2,
                      group_size: int = 8, prompt_len: int = 256,
                      gen_len: int = 256, grad_ckpt: bool = False,
                      naive_generation: bool = False,
                      min_bytes: int = 64 * 1024):
    """GRPO (beyond-paper ablation): two models only — actor + frozen
    reference; no critic, no reward-value model, no value scoring phases.
    The rollout batch is batch*group_size. Same trace machinery as PPO."""
    ppo_phases, ppo_persist = build_rlhf_phases(
        actor_cfg, actor_cfg, batch=batch * group_size,
        prompt_len=prompt_len, gen_len=gen_len, grad_ckpt=grad_ckpt,
        naive_generation=naive_generation, min_bytes=min_bytes)
    keep = {"rollout_prefill", "rollout_decode", "score_ref",
            "score_old_logp", "train_actor"}
    phases = [p for p in ppo_phases if p.name in keep]
    for p in phases:
        if p.free_after == "train_critic":
            p.free_after = "train_actor"
    keep_bufs = ("actor_params", "actor_opt", "ref_params")
    persistent = PersistentBuffers(
        {k: v for k, v in ppo_persist.buffers.items() if k in keep_bufs},
        required_by={k: frozenset(p for p in v if p in {ph.name for ph in phases})
                     for k, v in ppo_persist.required_by.items()
                     if k in keep_bufs})
    return phases, persistent
