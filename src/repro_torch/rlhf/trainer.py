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
rung (``Rollout(capture_buckets=)``), as the reference does.
``rl.spec_decode`` makes the rollout MTP self-speculative
(``Rollout(spec_decode=, spec_k=)``; the actor's config needs
``mtp_depth`` > 0), greedy: it forces ``temperature`` 0 and ``top_k`` 0
on the rollout, as the reference does (``:372-376, 432-434``).

``telemetry=`` (``repro_torch.obs.RunTelemetry``; the reference's
``:130-335``, ``:448-486`` and ``:905-1123``) makes every boundary close a
``phase`` span with the record's measured bytes, the per-owner attribution
table (``obs.MemoryAttributor``) and the traced simulator's prediction
for the phase (``core.build_rlhf_phases`` + ``run_iteration``, replayed
once at the first ``train_step``), feeds the ``rlhf_*`` metrics, and
notes each record to the run's ``obs.FlightRecorder``; a caught
``torch.cuda.OutOfMemoryError`` is dumped with its owners and re-raised.
Telemetry observes: the same kernels run on the same values.

``shard=`` (``sharding.ShardedContext``; the reference's ``:358-371,
405-506``) runs ZeRO data parallelism on both engines, SPMD: every rank
runs the same calls with the same generator seeds. The separate engine
shards its four role trees; hydra the trunk (``rules.param_pspecs``) and
the role adapters (``rules.adapter_pspecs``). The rollout runs on every
rank from a ``gather_copy`` (the same tokens on every rank), freed at the
phase boundary; no collective runs inside a captured decode graph, since
the gather comes before ``generate``. Scoring and training gather as the
plans say (whole, or layer by layer). ``rl.batch_shard`` splits a batch
that divides ndp over the ranks (``"throughput"``: summed gradients, ~ulp
drift; a batch that does not divide is replicated with a warning,
``"strict"`` raises on it); a replicated batch gives the unsharded bits.
``offload`` composes: the lot parks and fetches each rank's shards.

A context with a ``model`` axis above 1 (``ShardedContext.create(ndp,
model=ntp)``; the reference's ``:405-506``, DESIGN.md §9) adds Megatron
tensor parallelism on both engines: each rank builds the whole trees from
the seed (or takes the weights given) and keeps its ``1/ntp`` math cut
under the plans' ``"model"`` entries, with ZeRO over ``data`` on top of
it; every phase runs under the context (``sharding.ctx.use_mesh``), so the
forwards issue the ``sharding/tp.py`` operators, the scoring and training
log-probs come from vocab-sharded logits, and the rollout
(``Rollout(mesh=)``) decodes eagerly with the rank's K/ntp KV heads and
samples from all-gathered rows. The rollout's ZeRO-3 gather copies are
then the ``tp_gather`` owner's (DP-gathered, still TP-cut), and
``zero_gather`` stays empty; with telemetry the model group's staged
bytes go to ``sharding_tp_staged_bytes_total``. Mamba layers, MTP heads
and ``spec_decode`` under TP raise (ROADMAP A10c).
"""
from __future__ import annotations

import dataclasses
import gc
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import default_device
from repro_torch.configs.base import ModelConfig, check_token_inputs
from repro_torch.core.phases import RUNTIME_RLHF_PHASE_SEQUENCE
from repro_torch.models import Model
from repro_torch.models import lora as LORA
from repro_torch.models.lora import delete_merged
from repro_torch.offload import HostParkingLot, OffloadExecutor, OffloadPlan
from repro_torch.optim import make_optimizer
from repro_torch.rlhf.engine import ModelEngine
from repro_torch.rlhf.ppo import gae, kl_shaped_rewards, whiten
from repro_torch.rlhf.reward import sequence_reward
from repro_torch.rlhf.rollout import Rollout, live_device_bytes
from repro_torch.sharding import ctx as shctx
from repro_torch.sharding import tp as TP
from repro_torch.sharding.context import delete_tree, tree_per_device_bytes
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
    ``seconds``, which so runs to the end of the fetch.

    With a ``telemetry`` bundle attached (``obs.RunTelemetry``), every
    boundary also closes one tracer span per runtime phase — carrying the
    measured bytes of the record it just took (nothing recomputed) and,
    when the trainer attached ``sim_phase_bytes``, the traced simulator's
    predicted bytes for that phase and the sim-vs-measured delta — feeds
    the ``rlhf_phase_*`` metrics, and notes the record to the run's flight
    recorder before the fetch. Phase spans tile the iteration: each runs
    from the previous boundary (or ``iteration_start``) to this one. On
    CUDA a span's ``measured_peak_bytes`` is the record's ``peak_bytes``,
    the allocator's own peak since the last boundary; on the CPU it is the
    largest of the phase's records, as in the reference. With an
    ``attributor`` (``obs.MemoryAttributor``) every record splits its live
    bytes by owner in one walk, and the record's ``live_bytes`` IS the
    walk's total, so ``attrib`` and ``attrib_unattributed`` sum to it.
    ``phase`` is the PPO phase in progress (the OOM dump's), the one after
    the last boundary in ``RUNTIME_RLHF_PHASE_SEQUENCE``; with
    ``annotate`` the tracer holds a profiler range open for it."""
    policy: str = "after_inference"
    device: torch.device = field(default_factory=default_device)
    tracked: Optional[Callable[[], Any]] = None
    records: List[dict] = field(default_factory=list)
    offload: Optional[OffloadExecutor] = None
    telemetry: Optional[Any] = None    # obs.RunTelemetry
    attributor: Optional[Any] = None   # obs.MemoryAttributor
    # runtime phase -> {"sim_bytes", "sim_peak_bytes", "sim_owner_bytes"}
    # from the traced simulator (attached by RLHFTrainer under sim_delta)
    sim_phase_bytes: Dict[str, dict] = field(default_factory=dict)
    # under ZeRO, a rank's bytes -> the largest over the ranks (the
    # spans' measured_bytes_per_device); None: this rank's
    per_device: Optional[Callable[[int], int]] = None

    def __post_init__(self):
        if self.policy not in MEMORY_POLICIES:
            raise ValueError(
                f"unknown memory policy {self.policy!r}; "
                f"expected one of {MEMORY_POLICIES}")
        self.device = torch.device(self.device)
        self._cuda = self.device.type == "cuda"
        self._mark = time.perf_counter()
        self.phase: Optional[str] = None         # the phase in progress
        self._phase_t0: Optional[float] = None   # tracer µs of phase start
        self._phase_peak = 0                     # mid-phase record peak
        self._pcie_mark = 0                      # lot traffic at phase start
        self._iter_n = 0

    def _now(self) -> float:
        if self._cuda:
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    @property
    def flight(self):
        """The run's ``obs.FlightRecorder``, if any."""
        return getattr(self.telemetry, "flight", None)

    def live_bytes(self) -> int:
        """The live bytes a record takes: ``memory_allocated`` on CUDA, the
        tracked tensors' bytes on the CPU."""
        if self._cuda:
            return live_device_bytes(self.device)
        return nbytes(self.tracked()) if self.tracked else 0

    @staticmethod
    def _next(phase: str) -> Optional[str]:
        """The PPO phase after ``phase`` in this iteration, if any."""
        seq = RUNTIME_RLHF_PHASE_SEQUENCE
        if phase not in seq or phase == seq[-1]:
            return None
        return seq[seq.index(phase) + 1]

    def iteration_start(self):
        """Start the first phase's clock and peak (and, with telemetry, the
        per-iteration parent span)."""
        self._mark = self._now()
        if self._cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        self.phase = RUNTIME_RLHF_PHASE_SEQUENCE[0]
        if self.telemetry is None:
            return
        tr = self.telemetry.tracer
        # the first phase starts with the iteration: the phases tile it
        self._phase_t0 = tr.begin("ppo_iteration", cat="iteration",
                                  n=self._iter_n).ts_us
        tr.push_annotation(self.phase)
        self._phase_peak = 0
        self._pcie_mark = self._pcie_total()

    def iteration_end(self, **args):
        if self.telemetry is None:
            return
        self.telemetry.tracer.end(**args)
        self.telemetry.registry.counter(
            "rlhf_iterations_total", "completed PPO iterations").inc()
        self._iter_n += 1
        self._phase_t0 = None

    def _record(self, phase: str, kind: str, **extra) -> dict:
        now = self._now()
        snap = None
        if self.attributor is not None:
            snap = self.attributor.snapshot()
            live = snap.total_bytes
            if self.telemetry is not None:
                # the classification pass is telemetry work: charge it to
                # self-time so the <=2% overhead gate covers attribution
                self.telemetry.tracer.self_time_s += snap.walk_s
        else:
            live = self.live_bytes()
        if self._cuda:
            reserved = torch.cuda.memory_reserved(self.device)
            peak = torch.cuda.max_memory_allocated(self.device)
            requested = torch.cuda.memory_stats(self.device)[
                "requested_bytes.all.current"]
        else:
            reserved = peak = requested = None
        host = 0 if self.offload is None else self.offload.lot.parked_bytes()
        rec = {"phase": phase, "kind": kind, "live_bytes": live,
               "reserved_bytes": reserved, "peak_bytes": peak,
               "requested_bytes": requested,
               "host_bytes": host, "seconds": now - self._mark,
               "t": time.time(), **extra}
        if snap is not None:
            rec["attrib"] = snap.table()
            rec["attrib_unattributed"] = snap.unattributed
        self._mark = now
        self.records.append(rec)
        return rec

    # ----------------------------------------------------------- telemetry
    def _pcie_total(self) -> int:
        return sum(self._moved())

    def _snapshot_for_dump(self):
        """The flight recorder's snapshot: a full walk (top buffers; on
        CUDA the allocator's blocks) of the live set the triggering record
        just took."""
        if self.attributor is None:
            return None
        return self.attributor.snapshot(full=True)

    def _observe(self, event: str, rec: dict, **note) -> None:
        """Note the record to the flight recorder and check its
        watermark."""
        fl = self.flight
        if fl is None:
            return
        fl.note(event, phase=rec["phase"], live_bytes=rec["live_bytes"],
                host_bytes=rec["host_bytes"], **note)
        fl.check(rec["live_bytes"], snapshot_fn=self._snapshot_for_dump,
                 phase=rec["phase"], source="rlhf")

    def _emit_phase_span(self, phase: str, kind: str, rec: dict):
        tel = self.telemetry
        tr = tel.tracer
        now = tr.now_us()
        t0 = self._phase_t0 if self._phase_t0 is not None else now
        pcie_now = self._pcie_total()
        peak = rec["peak_bytes"] if rec["peak_bytes"] is not None else \
            max(rec["live_bytes"], self._phase_peak)
        args = {"kind": kind,
                "measured_bytes": rec["live_bytes"],
                "measured_peak_bytes": peak,
                "measured_bytes_per_device": (
                    rec["live_bytes"] if self.per_device is None
                    else self.per_device(rec["live_bytes"])),
                "host_bytes": rec["host_bytes"],
                "pcie_bytes": pcie_now - self._pcie_mark}
        if "attrib" in rec:
            args["attrib"] = rec["attrib"]
            args["attrib_unattributed"] = rec["attrib_unattributed"]
        sim = self.sim_phase_bytes.get(phase)
        if sim is not None:
            args.update(sim)
            args["sim_delta_bytes"] = rec["live_bytes"] - sim["sim_bytes"]
            # per-owner sim deltas: the measured owner table against the
            # simulator's per-state ledger at this boundary, over the
            # simulator's group names (the same taxonomy on both sides)
            sim_owners = sim.get("sim_owner_bytes")
            if sim_owners and "attrib" in rec:
                args["attrib_sim_delta"] = {
                    k: rec["attrib"].get(k, 0) - v
                    for k, v in sim_owners.items()}
        tr.pop_annotation()
        tr.complete(phase, "phase", t0, now - t0, **args)
        tr.sample("memory", {"device_mib": rec["live_bytes"] / 2**20,
                             "host_mib": rec["host_bytes"] / 2**20},
                  ts_us=now)
        reg = tel.registry
        reg.counter("rlhf_phase_total", "phase boundaries crossed").inc(
            phase=phase)
        reg.gauge("rlhf_phase_live_bytes",
                  "live device bytes at phase end").set(
            rec["live_bytes"], phase=phase)
        reg.gauge("rlhf_phase_host_bytes",
                  "host-resident bytes at phase end").set(
            rec["host_bytes"], phase=phase)
        reg.histogram("rlhf_phase_seconds", "wall time per phase").observe(
            (now - t0) / 1e6, phase=phase)
        for owner, b in rec.get("attrib", {}).items():
            reg.gauge("rlhf_owner_live_bytes",
                      "live device bytes by owner at phase end").set(
                b, owner=owner, phase=phase)
        if self.phase is not None:
            tr.push_annotation(self.phase)
        self._phase_t0 = now
        self._phase_peak = 0
        self._pcie_mark = pcie_now

    def sample(self, phase: str, kind: str = "inference", **extra) -> dict:
        """Mid-phase record (no hygiene, no peak reset): where the live set
        changes inside a phase, as in rollout decode from merged weights."""
        rec = self._record(phase, kind, sample=True, **extra)
        self._phase_peak = max(self._phase_peak, rec["live_bytes"])
        if self.telemetry is not None:
            tr = self.telemetry.tracer
            attrib = {k: rec[k] for k in ("attrib", "attrib_unattributed")
                      if k in rec}
            tr.instant(f"{phase}:sample", cat="phase",
                       measured_bytes=rec["live_bytes"],
                       host_bytes=rec["host_bytes"], **attrib)
            tr.sample("memory", {"device_mib": rec["live_bytes"] / 2**20,
                                 "host_mib": rec["host_bytes"] / 2**20})
        self._observe("sample", rec)
        return rec

    def _moved(self) -> Tuple[int, int]:
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
        self.phase = self._next(phase)
        if self.telemetry is not None:
            self._emit_phase_span(phase, kind, rec)
        # checked before the fetch: the record is the post-hygiene,
        # pre-fetch trough, the point the simulator records
        self._observe("phase", rec, kind=kind)
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
    # MTP self-speculative greedy rollout: draft spec_k tokens a step from
    # the actor's MTP chain, verify them in one forward (tokens and logps
    # those of greedy decoding). Forces temperature=0 / top_k=0 for the
    # rollout.
    spec_decode: bool = False
    spec_k: int = 2
    # prefill compile-bucket ladder for the rollout's prompts (None: pad
    # nothing)
    capture_buckets: Optional[Sequence[int]] = None
    # DP batch sharding of the scoring and training batches under ZeRO:
    #   "throughput" — a batch that divides ndp is split over the ranks
    #     (loss denominators over the whole batch, gradients summed: a
    #     change of summation order, ~ulp); one that does not divide is
    #     replicated, with a warning;
    #   "strict" — a batch that does not divide ndp raises.
    batch_shard: str = "throughput"


class RLHFTrainer:
    """PPO over (actor, critic, reference, reward). The reward is the
    frozen reward model's value at each row's last generated token, or any
    ``reward_fn(tokens, mask) -> [B]``.

    ``rl.engine`` picks the layout. Random weights come from ``generator``
    (its device is the trainer's); or the initial weights are passed in
    whole: ``params={"actor": ..., "critic": ...}`` for the separate engine
    (``bridge.separate_trainer_from_jax``), ``engine=`` for the hydra one
    (``bridge.trainer_from_jax``), whose path ignores ``critic_cfg``, as
    the reference's does.

    ``telemetry`` (``obs.RunTelemetry``) instruments every iteration (the
    module docstring); the bundle's attributor is created when absent,
    and this trainer's owner trees are registered in it. ``shard``
    (``sharding.ShardedContext``) runs ZeRO over its ``data`` ranks and
    tensor parallelism over its ``model`` ranks."""

    def __init__(self, actor_cfg: ModelConfig, critic_cfg: ModelConfig,
                 rl: RLHFConfig, generator: Optional[torch.Generator] = None,
                 reward_fn: Optional[Callable] = None, shard=None,
                 telemetry=None, *, engine: Optional[ModelEngine] = None,
                 params: Optional[Dict[str, Any]] = None):
        if rl.engine not in ("separate", "hydra"):
            raise ValueError(f"engine must be separate or hydra, not "
                             f"{rl.engine!r}")
        if rl.batch_shard not in ("strict", "throughput"):
            raise ValueError(f"unknown batch_shard {rl.batch_shard!r}; "
                             "expected 'strict' or 'throughput'")
        for c in (actor_cfg, critic_cfg):
            check_token_inputs(c, f"RLHFTrainer ({rl.engine} engine)")
        if shard is not None:
            for c in ((actor_cfg,) if rl.engine == "hydra"
                      else (actor_cfg, critic_cfg)):
                TP.check_supported(c, shard.ntp, spec_decode=rl.spec_decode)
        if shard is not None and shard.comm is None:
            raise ValueError("a ShardedContext on a SpecMesh names specs "
                             "only; the trainer needs a process group")
        self.rl = rl
        self.shard = shard
        self._gather_step_bytes: Optional[Dict[str, int]] = None
        self._batch_shard_warned = False
        self.actor_cfg, self.critic_cfg = actor_cfg, critic_cfg
        self.reward_fn = reward_fn
        self.telemetry = telemetry
        self._sim_attached = False
        self._compiled_recorded: set = set()
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
                                         tracked=self._tracked,
                                         telemetry=telemetry)
        if shard is not None:
            self.memory.per_device = shard.comm.max_int
        self.rollout = Rollout(
            self.actor, actor_cfg, capacity=rl.prompt_len + rl.gen_len,
            temperature=0.0 if rl.spec_decode else rl.temperature,
            top_k=0 if rl.spec_decode else rl.top_k,
            capture_buckets=rl.capture_buckets,
            spec_decode=rl.spec_decode, spec_k=rl.spec_k, mesh=shard)
        self.offload = self.offload_lot = None
        if rl.offload != "none":
            self._init_offload(rl)
        if telemetry is not None:
            self._init_attribution(telemetry)

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
        # one ZeRO plan a role tree (the reference and reward models share
        # the actor's and the critic's), from the trees' shapes on meta
        self.actor_plan = self.critic_plan = None
        if self.shard is not None:
            self.actor_plan = self.shard.plan_params(
                actor_cfg, Model(actor_cfg, device="meta").init(),
                make_optimizer(actor_cfg.optimizer))
            self.critic_plan = self.shard.plan_params(
                critic_cfg,
                Model(critic_cfg, device="meta", with_value=True).init(),
                make_optimizer(critic_cfg.optimizer))
        self.actor_step = make_train_step(self.actor, actor_cfg, kind="ppo",
                                          lr=rl.lr, kl_coef=rl.kl_coef,
                                          shard=self.actor_plan)
        self.critic_step = make_train_step(self.critic, critic_cfg,
                                           kind="critic", lr=rl.critic_lr,
                                           shard=self.critic_plan)
        self.actor_state = self._init_state(
            self.actor, actor_cfg, generator, self.actor_step.optimizer,
            params.get("actor"), self.actor_plan)
        self.critic_state = self._init_state(
            self.critic, critic_cfg, generator, self.critic_step.optimizer,
            params.get("critic"), self.critic_plan)
        # reference = frozen copy of the (SFT) actor init; reward = frozen
        # copy of the critic init (a critic that stopped learning at
        # preference time)
        with torch.no_grad():
            self.ref_params = tree_map(torch.clone,
                                       self.actor_state["params"])
            self.reward_params = tree_map(torch.clone,
                                          self.critic_state["params"])

    @staticmethod
    def _init_state(model, cfg, generator, optimizer, params, plan):
        """A role's train state; under ZeRO this rank's part of it: the
        whole params drawn (every rank draws the same), placed, and the
        moments made at the placed shapes (no whole moments are made)."""
        if plan is None:
            return init_train_state(model, cfg, generator, optimizer,
                                    params=params)
        if params is None:
            params = model.init(generator)
        params = plan.place_params(params)
        for p in leaves(params):
            p.requires_grad_(True)
        return {"params": params,
                "opt": optimizer.init(plan.update_views(params)), "step": 0}

    def _init_hydra(self, cfg, rl, generator, engine):
        self.engine = engine if engine is not None else ModelEngine(
            cfg, generator, rank=rl.lora_rank)
        if self.shard is not None and self.engine.shard is None:
            self.engine.shard_with(self.shard)
        self.actor = self.engine.model          # the shared headless trunk
        self.device = self.actor.device
        self.base_params = self.ref_params = self.engine.base_params
        self.reward_adapter = self.engine.adapters["reward"]
        base_plan = self.engine.base_plan
        a_plan = self.engine.adapter_plans.get("actor")
        c_plan = self.engine.adapter_plans.get("critic")
        self.actor_step = make_lora_train_step(
            self.actor, cfg, kind="ppo", lr=rl.lr, kl_coef=rl.kl_coef,
            shard=a_plan, base_shard=base_plan)
        self.critic_step = make_lora_train_step(
            self.actor, cfg, kind="critic", lr=rl.critic_lr,
            shard=c_plan, base_shard=base_plan)
        self.actor_state = init_lora_train_state(
            self.engine.adapters["actor"], self.actor_step.optimizer)
        self.critic_state = init_lora_train_state(
            self.engine.adapters["critic"], self.critic_step.optimizer)
        if a_plan is not None:
            # the moments were made from the placed adapters: keep this
            # rank's part of those the ZeRO-1/2 layout shards
            self.actor_state["opt"] = a_plan.place_opt(
                self.actor_state["opt"])
            self.critic_state["opt"] = c_plan.place_opt(
                self.critic_state["opt"])

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

    # --------------------------------------------------------- attribution
    def _init_attribution(self, telemetry) -> None:
        """Create (or adopt) the run's MemoryAttributor and register this
        trainer's owner trees. Registration order is priority order on
        aliased storages: the hydra trunk goes first, so the reference
        (which IS the base) and the merged rollout leaves that alias
        non-adapted trunk tensors attribute to ``base_params``;
        ``merged_rollout`` then claims only the freshly merged copies.
        The ZeRO-3 rollout gather copies (``zero_gather``, or under tensor
        parallelism ``tp_gather``: DP-gathered, still 1/ntp a rank; one of
        the two is ever filled) register before ``merged_rollout``: the
        merged tree's non-adapted leaves alias the gathered trunk."""
        from repro_torch.obs import MemoryAttributor
        at = telemetry.attribution
        if at is None:
            at = telemetry.attribution = MemoryAttributor(device=self.device)
        elif at.device is None:
            at.device = self.device
        elif at.device.type != self.device.type:
            raise ValueError(f"the telemetry's attributor measures "
                             f"{at.device}, the trainer runs on "
                             f"{self.device}")
        at.tracked, at.lot = self._tracked, self.offload_lot
        if self.engine is None:
            at.register("ref_params", lambda: self.ref_params)
            at.register("reward_params", lambda: self.reward_params)
        else:
            at.register("base_params", lambda: self.base_params)
            at.register("reward_params", lambda: self.reward_adapter)
        at.register("actor_params", lambda: self.actor_state["params"])
        at.register("actor_opt", lambda: self.actor_state["opt"])
        at.register("critic_params", lambda: self.critic_state["params"])
        at.register("critic_opt", lambda: self.critic_state["opt"])
        for owner, key in (("zero_gather", "zero_gather"),
                           ("tp_gather", "tp_gather"),
                           ("merged_rollout", "merged_rollout"),
                           ("rollout_buffers", "rollout"),
                           ("experience", "experience")):
            at.register(owner, lambda key=key: self._live.get(key))
        self.memory.attributor = at

    def _attach_sim_predictions(self, batch_size: int) -> None:
        """Run the traced allocator simulator once for THIS run's shape
        (engine, batch, lengths, LoRA rank, remat, offload level) and
        attach its per-phase predicted bytes to the memory manager, so
        every phase span carries a sim-vs-measured delta: strategy "None",
        policy "none", one device, no capacity. One-time setup (at the
        first train_step); a failure degrades to spans without
        predictions, with a warning. ``run_iteration`` scales the traces'
        ``layer_slice`` events (ZeRO-3's per-layer gathers) to 0 below
        stage 3, so the predicted peaks leave them out. Under ``shard``
        the prediction is one rank's, its fractions traced from the spec
        trees the state was placed by (``core.traced_strategy``)."""
        from repro_torch.core import (MemoryStrategy, build_rlhf_phases,
                                      run_iteration, traced_strategy)
        ckpt = self.actor_cfg.remat == "full"
        try:
            ph, persist = build_rlhf_phases(
                self.actor_cfg, self.critic_cfg, batch=batch_size,
                prompt_len=self.rl.prompt_len, gen_len=self.rl.gen_len,
                engine=self.rl.engine, lora_rank=self.rl.lora_rank,
                grad_ckpt=ckpt, ppo_epochs=self.rl.ppo_epochs,
                min_bytes=2048)
            strat = MemoryStrategy("None", offload=self.rl.offload,
                                   grad_ckpt=ckpt)
            ndp = ntp = 1
            if self.shard is not None:
                ndp, ntp = self.shard.ndp, self.shard.ntp
                strat = traced_strategy(
                    dataclasses.replace(
                        strat, zero_stage=self.shard.zero_stage,
                        gather_mode=self.shard.strat.gather_mode, ntp=ntp),
                    self.actor_cfg, self.critic_cfg, ndp=ndp,
                    engine=self.rl.engine, lora_rank=self.rl.lora_rank)
            r = run_iteration(ph, persist, strat, "none", ndp=ndp, ntp=ntp,
                              trainable_fraction=1.0, capacity=None)
        except Exception as e:
            warnings.warn(f"telemetry: simulator prediction unavailable "
                          f"({e!r}); phase spans carry measured bytes only",
                          stacklevel=3)
            return
        sim: Dict[str, dict] = {}
        for rec in r.phase_records:
            # the simulator's rollout_prefill and rollout_decode fold into
            # the runtime's rollout: the last record's bytes, the larger
            # peak
            name = "rollout" if rec.name.startswith("rollout") else rec.name
            cur = sim.setdefault(name, {"sim_bytes": 0, "sim_peak_bytes": 0})
            cur["sim_bytes"] = rec.allocated_end
            cur["sim_peak_bytes"] = max(cur["sim_peak_bytes"], rec.alloc_peak)
            if rec.state_bytes_end:
                cur["sim_owner_bytes"] = dict(rec.state_bytes_end)
        self.memory.sim_phase_bytes = sim

    def _record_compiled(self, program: str, fn, *args) -> None:
        """Per-program memory accounting, once a program: a ``meta`` trace
        of ``fn(*args)`` (``obs.record_compiled_memory``; never executed)
        into the metrics registry. One-time setup, not charged to the
        tracer's self-time. Under ``shard`` nothing is recorded: a
        ``meta`` trace cannot run a sharded tree's gathers (the reference
        skips its ZeRO train programs likewise)."""
        if self.telemetry is None or self.shard is not None or \
                program in self._compiled_recorded:
            return
        self._compiled_recorded.add(program)
        from repro_torch.obs import record_compiled_memory
        record_compiled_memory(self.telemetry.registry, program, fn, *args)

    def _record_compiled_programs(self, batch, mask) -> None:
        """Compiled-memory stats for the scoring programs (at the first
        make_experience, on the real batch's shapes), each a function of
        the trees it reads so that the trace sees them as arguments."""
        if self.engine is None:
            def logp(p, b):
                return _action_logp(self.actor.forward(p, b)[0], b["tokens"])
            progs = {
                "score_old_logp": (logp, self.actor_state["params"], batch),
                "score_ref": (logp, self.ref_params, batch),
                "score_values": (self.critic.forward_value,
                                 self.critic_state["params"], batch),
                "score_reward": (
                    lambda p, t, m: sequence_reward(self.critic, p, t, m),
                    self.reward_params, batch["tokens"], mask)}
        else:
            eng = self.engine
            progs = {
                "score_old_logp": (
                    lambda base, ad, b: _action_logp(eng.logits(base, ad, b),
                                                     b["tokens"]),
                    self.base_params, self.actor_state["params"], batch),
                "score_ref": (
                    lambda base, b: _action_logp(eng.ref_logits(base, b),
                                                 b["tokens"]),
                    self.base_params, batch),
                "score_values": (eng.values, self.base_params,
                                 self.critic_state["params"], batch),
                "score_reward": (
                    lambda base, ad, t, m: sequence_reward(
                        self.actor, base, t, m, adapter=ad),
                    self.base_params, self.reward_adapter, batch["tokens"],
                    mask)}
        if self.reward_fn is not None:
            del progs["score_reward"]
        for name, (fn, *args) in progs.items():
            self._record_compiled(name, fn, *args)

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
        self.offload = OffloadExecutor(plan, self.offload_lot, states,
                                       telemetry=self.telemetry)
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

    # ------------------------------------------------------------ sharding
    def per_device_state_bytes(self) -> int:
        """The largest over the ranks of the persistent role state's bytes
        on a rank (params and moments): the figure the ZeRO stages cut.
        Unsharded, this process's bytes."""
        return tree_per_device_bytes(
            list(self.persistent_trees().values()),
            None if self.shard is None else self.shard.comm)

    @property
    def _gather_key(self) -> str:
        """The owner of the rollout's gather copies: ``tp_gather`` under
        tensor parallelism, else ``zero_gather``."""
        return "tp_gather" if self._tp is not None else "zero_gather"

    @property
    def _tp(self):
        return None if self.shard is None else self.shard.tp

    def _plans(self):
        """(trunk or actor plan, actor, critic, reward plans): the
        separate engine's reference and reward trees use the actor's and
        the critic's plans; all None unsharded."""
        if self.engine is not None:
            ap = self.engine.adapter_plans
            return (self.engine.base_plan, ap.get("actor"), ap.get("critic"),
                    ap.get("reward"))
        return (None, self.actor_plan, self.critic_plan, self.critic_plan)

    @staticmethod
    def _g(plan, tree):
        return tree if plan is None else plan.gather(tree)

    @staticmethod
    def _ls(plan):
        return getattr(plan, "layer_specs", None)

    def _split(self, B: int) -> bool:
        """Whether a batch of B rows runs split over the ranks
        (``rl.batch_shard``)."""
        if self.shard is None or self.shard.ndp <= 1:
            return False
        ndp = self.shard.ndp
        if B % ndp == 0:
            return True
        if self.rl.batch_shard == "strict":
            raise ValueError(
                f"batch_shard='strict': global batch {B} does not divide "
                f"the DP size {ndp}; the batch would replicate. Pad the "
                "batch or use batch_shard='throughput'.")
        if not self._batch_shard_warned:
            self._batch_shard_warned = True
            warnings.warn(f"RLHF batch {B} does not divide ndp={ndp}: "
                          "replicating the batch over the DP ranks (state "
                          "still shards; see RLHFConfig.batch_shard)",
                          stacklevel=3)
        return False

    def _rows(self, x: torch.Tensor, N: int) -> torch.Tensor:
        """This rank's rows of a split batch: with N microbatches, its
        share of each, so that microbatch i is every rank's share of the
        unsplit batch's microbatch i."""
        comm = self.shard.comm
        N = max(1, N)
        b = x.shape[0] // (N * comm.size)
        return x.reshape((N, comm.size, b) + tuple(x.shape[1:]))[
            :, comm.rank].reshape((N * b,) + tuple(x.shape[1:]))

    def _scored(self, fn, *args):
        """``fn(*args)`` over the batch's rows ([B, ...] tensors): split
        over the ranks where the batch splits, and the rows all-gathered
        back in order."""
        B = args[0].shape[0]
        if not self._split(B):
            return fn(*args)
        comm = self.shard.comm
        n = B // comm.size
        with self.shard.sharded_batch():
            out = fn(*(a.narrow(0, comm.rank * n, n) for a in args))
        return comm.all_gather(out, 0)

    def _role_gather_bytes(self) -> Dict[str, int]:
        """ZeRO-3 all-gather bytes of each update program (the plans'
        ``gathered_bytes``, computed once): what the step's tree or layer
        gathers move each time it runs."""
        if self._gather_step_bytes is None:
            base, a_plan, c_plan, _ = self._plans()
            if self.engine is not None:
                trunk = 0 if base is None else \
                    base.gathered_bytes(self.base_params)
                ga = trunk + (0 if a_plan is None else a_plan.gathered_bytes(
                    self.actor_state["params"]))
                gc_ = trunk + (0 if c_plan is None else c_plan.gathered_bytes(
                    self.critic_state["params"]))
            else:
                ga = 0 if a_plan is None else a_plan.gathered_bytes(
                    self.actor_state["params"])
                gc_ = 0 if c_plan is None else c_plan.gathered_bytes(
                    self.critic_state["params"])
            self._gather_step_bytes = {"train_actor": ga,
                                       "train_critic": gc_}
        return self._gather_step_bytes

    def _count_gather(self, program: str) -> None:
        if self.telemetry is None:
            return
        b = self._role_gather_bytes().get(program, 0)
        if b:
            self.telemetry.registry.counter(
                "sharding_step_gathered_bytes_total",
                "bytes all-gathered by ZeRO-3 per update program "
                "(analytic, from the TreePlan)").inc(b, program=program)

    # ---------------------------------------------------------- role calls
    def _gen(self, prompts, generator):
        """Rollout. Separate: from the actor's params. Hydra: from merged
        weights, A·B of the actor folded into the trunk once per phase.
        Under ZeRO-3 both run from a gathered copy (``gather_copy``), owned
        by ``zero_gather`` and dropped at the end of the phase; the merged
        leaves' references are dropped before the boundary, so the caching
        allocator gets them back."""
        base_plan, a_plan, _, _ = self._plans()
        if self.engine is None:
            p, owned = self.actor_state["params"], False
            if a_plan is not None:
                p, owned = a_plan.gather_copy(p)
                self._live[self._gather_key] = {"actor": p}
            try:
                with torch.no_grad():
                    return self.rollout.generate(
                        p, {"tokens": prompts}, self.rl.gen_len, generator)
            finally:
                self._live.pop(self._gather_key, None)
                if owned:
                    delete_tree(p)
        adapter, owned_a = self.actor_state["params"], False
        base, owned_b = self.base_params, False
        if base_plan is not None:
            base, owned_b = base_plan.gather_copy(base)
            adapter, owned_a = a_plan.gather_copy(adapter)
        copies = {k: t for k, t, owned in (("base", base, owned_b),
                                          ("adapter", adapter, owned_a))
                  if owned}
        if copies:
            self._live[self._gather_key] = copies
        merged = self.actor.merge_adapter(base, adapter)
        # the merged tree holds what the rollout reads; no live trunk may
        # be held here (offload "all" parks its adapted leaves mid-phase)
        del base
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
            self._live.pop(self._gather_key, None)
            delete_tree(copies)

    def _reward_scores(self, tokens, mask):
        base_plan, _, _, rw_plan = self._plans()
        if self.engine is None:
            return self._scored(lambda t, m: sequence_reward(
                self.critic, self._g(rw_plan, self.reward_params), t, m,
                layer_specs=self._ls(rw_plan)), tokens, mask)
        return self._scored(lambda t, m: sequence_reward(
            self.actor, self._g(base_plan, self.base_params), t, m,
            adapter=self._g(rw_plan, self.reward_adapter),
            layer_specs=self._ls(base_plan)), tokens, mask)

    def _token_logp(self, role, batch):
        """Per-action log-probs of the actor (``role="actor"``) or the
        frozen reference (``"ref"``)."""
        base_plan, a_plan, _, _ = self._plans()
        if self.engine is None:
            params = self.actor_state["params"] if role == "actor" \
                else self.ref_params

            def logits(b):
                return self.actor.forward(self._g(a_plan, params), b,
                                          layer_specs=self._ls(a_plan))[0]
        elif role == "actor":
            def logits(b):
                return self.engine.logits(
                    self._g(base_plan, self.base_params),
                    self._g(a_plan, self.actor_state["params"]), b,
                    layer_specs=self._ls(base_plan))
        else:
            def logits(b):
                return self.engine.ref_logits(
                    self._g(base_plan, self.base_params), b,
                    layer_specs=self._ls(base_plan))
        return self._scored(lambda t: _action_logp(logits({"tokens": t}), t),
                            batch["tokens"])

    def _values(self, batch):
        base_plan, _, c_plan, _ = self._plans()
        if self.engine is None:
            return self._scored(lambda t: self.critic.forward_value(
                self._g(c_plan, self.critic_state["params"]), {"tokens": t},
                layer_specs=self._ls(c_plan)), batch["tokens"])
        return self._scored(lambda t: self.engine.values(
            self._g(base_plan, self.base_params),
            self._g(c_plan, self.critic_state["params"]), {"tokens": t},
            layer_specs=self._ls(base_plan)), batch["tokens"])

    def _update(self, step, state, batch, cfg):
        """One step of a role (its params and moments move in place), on
        this rank's share of the batch where the batch splits."""
        trunk = () if self.engine is None else (self.base_params,)
        B = batch["tokens"].shape[0]
        if not self._split(B):
            return step(state, *trunk, batch)[1]
        local = {k: self._rows(v, cfg.microbatches)
                 if torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == B
                 else v for k, v in batch.items()}
        with self.shard.sharded_batch():
            return step(state, *trunk, local)[1]

    def _actor_update(self, exp):
        """One step of the actor (its params and moments move in place)."""
        return self._update(self.actor_step, self.actor_state, exp,
                            self.actor_cfg)

    def _critic_update(self, cbatch):
        cfg = self.critic_cfg if self.engine is None else self.actor_cfg
        return self._update(self.critic_step, self.critic_state, cbatch, cfg)

    # ------------------------------------------------------------ phases
    def make_experience(self, prompts: torch.Tensor,
                        generator: torch.Generator) -> Dict[str, Any]:
        """Phases 1-5: rollout and the four scoring forwards (under
        ``torch.no_grad()``) -> the experience batch."""
        with shctx.use_mesh(self.shard):
            return self._make_experience(prompts, generator)

    def _make_experience(self, prompts, generator) -> Dict[str, Any]:
        mm = self.memory
        ro = self._gen(prompts, generator)
        self._live["rollout"] = {"tokens": ro.tokens, "logp": ro.logp,
                                 "mask": ro.mask}
        mm.boundary("rollout", "inference")
        batch = {"tokens": ro.tokens}
        mask = ro.mask
        del ro
        with torch.no_grad():
            if self.telemetry is not None:
                self._record_compiled_programs(batch, mask)
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
        """One full PPO iteration (all seven phases). A caught
        ``torch.cuda.OutOfMemoryError`` is captured by the run's flight
        recorder (owner table, top buffers and the phase in progress at
        the moment of failure) and re-raised: the recorder observes, it
        never swallows."""
        try:
            with shctx.use_mesh(self.shard):
                return self._train_step(prompts, generator)
        except Exception as e:
            fl = self.memory.flight
            if fl is not None and fl.is_oom(e):
                at = self.memory.attributor
                fl.record_oom(
                    e, snapshot_fn=None if at is None
                    else lambda: at.snapshot(full=True),
                    live_bytes=self.memory.live_bytes(),
                    phase=self.memory.phase, source="rlhf")
            raise

    def _train_step(self, prompts, generator) -> Dict[str, float]:
        tel = self.telemetry
        if tel is not None and tel.sim_delta and not self._sim_attached:
            self._sim_attached = True
            self._attach_sim_predictions(int(prompts.shape[0]))
        self.memory.iteration_start()
        staged0 = 0 if self._tp is None else self._tp.comm.staged_bytes
        exp = self._make_experience(prompts, generator)
        self._live["experience"] = exp
        mean_reward = float(exp.pop("mean_reward"))
        old_values = exp.pop("old_values")
        trunk = () if self.engine is None else (self.base_params,)
        self._record_compiled(
            "train_actor", lambda s, *a: self.actor_step(s, *a)[1],
            self.actor_state, *trunk, exp)
        metrics = {}
        for _ in range(self.rl.ppo_epochs):
            m = self._actor_update(exp)
            metrics.update({k: float(v) for k, v in m.items()})
            self._count_gather("train_actor")
        self.memory.boundary("train_actor", "training")
        cbatch = dict(exp, old_values=old_values)
        del old_values
        self._record_compiled(
            "train_critic", lambda s, *a: self.critic_step(s, *a)[1],
            self.critic_state, *trunk, cbatch)
        for _ in range(self.rl.ppo_epochs):
            mc = self._critic_update(cbatch)
            metrics.update({k: float(v) for k, v in mc.items()})
            self._count_gather("train_critic")
        self._live.pop("rollout", None)
        self._live.pop("experience", None)
        self.memory.boundary("train_critic", "training", exp, cbatch)
        metrics["mean_reward"] = mean_reward
        if tel is not None and self._tp is not None:
            tel.registry.counter(
                "sharding_tp_staged_bytes_total",
                "bytes the model group's gloo collectives staged through "
                "pinned host memory").inc(self._tp.comm.staged_bytes - staged0)
        self.memory.iteration_end(mean_reward=mean_reward)
        return metrics
