"""End-to-end PPO on the PyTorch/CUDA port — the twin of
``examples/rlhf_e2e.py``: by default the hydra engine (ONE frozen trunk +
per-role LoRA adapters and value heads for actor, critic and reward, the
reference logp read off the base), or with ``--engine separate`` the
four-model pipeline it replaces (actor and reference on ``--arch``,
critic and reward on ``--critic-arch``, every actor and critic leaf
trained); the paper's phase-boundary memory management, and per-phase
records of the caching allocator (live, reserved and peak bytes).

On the card (the default device; it raises without one):

    PYTHONPATH=src python examples/torch_rlhf_e2e.py --arch llama3_2_3b \
        --steps 2 --batch 8 --prompt-len 512 --gen-len 64 --lora-rank 128
    PYTHONPATH=src python examples/torch_rlhf_e2e.py --engine separate \
        --arch opt_1_3b --critic-arch opt_350m --steps 2 --batch 8 \
        --prompt-len 256 --gen-len 256 --reward adapter

On the CPU, the reference example's small trunk (``--smoke``, with a
head_dim of 64, a width the card's attention kernels take; on the CPU the
plain PyTorch path, where the records count the trainer's tensors):

    PYTHONPATH=src python examples/torch_rlhf_e2e.py --arch llama3_2_3b \
        --smoke --device cpu --steps 20
    PYTHONPATH=src python examples/torch_rlhf_e2e.py --engine separate \
        --smoke --device cpu --steps 20

The MoE and hybrid families (``granite_moe_3b_a800m``, ``jamba_v0_1_52b``)
train on the separate engine only; the hydra engine refuses them, as the
reference's does:

    PYTHONPATH=src python examples/torch_rlhf_e2e.py --engine separate \
        --arch granite_moe_3b_a800m --smoke --device cpu --steps 3

``--reward adapter`` scores with the frozen reward model (the reward
adapter's value head, or on the separate engine the reward model's), so
every phase runs a model; the default ``target`` is the reference
example's programmatic reward (the fraction of generated 7s).

``--offload optimizer|roles|all`` parks the role state a phase does not
touch to host memory between the phases that do (pinned memory on the
card), and the report adds each phase's host MiB and park/fetch ms;
``--remat none|full|dots|offload`` sets the model's activation
checkpointing (``offload``: each layer's saved input goes to host):

    PYTHONPATH=src python examples/torch_rlhf_e2e.py --arch llama3_2_3b \
        --engine separate --offload roles --steps 1 --batch 8 \
        --prompt-len 512 --gen-len 64
    PYTHONPATH=src python examples/torch_rlhf_e2e.py --smoke --device cpu \
        --offload all

``--capture-buckets 8,16,32`` pads the rollout's prompts to a rung of that
compile-bucket ladder, as the reference example's flag does, and prints
the compile cache's hits, misses and recompiles at the end. On the card
every rollout's decode steps replay one CUDA graph of the step; the end
report gives the last rollout's capture ms and graph pool.

``--spec-decode`` (with ``--spec-k``, 2 by default) gives the actor
``mtp_depth = spec_k`` MTP heads and makes the rollout self-speculative,
as the reference example's flags do: greedy (temperature and top-k are
overridden), drafting spec_k tokens a step from the MTP chain and
verifying them in one forward, the same tokens as greedy decoding; the
end report gives the last rollout's spec steps and accept rate:

    PYTHONPATH=src python examples/torch_rlhf_e2e.py --smoke --device cpu \
        --steps 3 --spec-decode
    PYTHONPATH=src python examples/torch_rlhf_e2e.py --arch llama3_2_3b \
        --steps 2 --batch 8 --prompt-len 512 --gen-len 64 --spec-decode

``--ndp N`` runs ZeRO data parallelism (``repro_torch.sharding``) over N
ranks, one process each, spawned here: over gloo with ``--device cpu``,
over NCCL on N cards otherwise (rank r on ``cuda:r``; fewer cards raise).
``--zero-stage`` (3 by default) and ``--gather-mode layer|tree`` pick the
strategy; every rank runs the same steps with the same seeds, rank 0
prints, and the per-device persistent state line gives the largest over
the ranks, as the reference example's ``--ndp`` does:

    PYTHONPATH=src python examples/torch_rlhf_e2e.py --smoke --device cpu \
        --steps 3 --ndp 4 --zero-stage 3
    PYTHONPATH=src python examples/torch_rlhf_e2e.py --engine separate \
        --smoke --device cpu --steps 3 --ndp 2 --zero-stage 1

``--ntp M`` adds Megatron tensor parallelism over M ranks (the mesh is
``(data=ndp, model=ntp)``, ndp x ntp processes): each rank keeps its
``1/ntp`` cut of every weight, the rollout decodes eagerly and samples
from gathered rows (the reference example's ``--ntp``):

    PYTHONPATH=src python examples/torch_rlhf_e2e.py --smoke --device cpu \
        --steps 3 --ndp 2 --ntp 2 --zero-stage 3

Runtime telemetry (``repro_torch.obs``), the reference example's flags:
``--metrics-out`` writes the run's JSONL (phase spans with measured and
simulated bytes and the owner tables, offload spans, metrics),
``--trace-out`` a Chrome trace (Perfetto), ``--watermark F`` arms the OOM
flight recorder at that fraction of the card's memory, and
``--attrib-out`` writes the per-phase owner tables and any flight dumps:

    PYTHONPATH=src python examples/torch_rlhf_e2e.py --smoke --device cpu \
        --steps 2 --offload all --metrics-out /tmp/m.jsonl \
        --trace-out /tmp/t.json --watermark 0.9 --attrib-out /tmp/a.json
    PYTHONPATH=src python -m repro_torch.launch.report /tmp/m.jsonl --metrics
"""
import argparse
import dataclasses
import datetime
import json
import os
import pathlib
import shutil
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch import default_device  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.rlhf import RLHFConfig, RLHFTrainer  # noqa: E402
from repro_torch.rlhf.reward import make_target_token_reward  # noqa: E402
from repro_torch.tree import leaves, nbytes  # noqa: E402


def _mib(n):
    return "     n/a" if n is None else f"{n / 2**20:8.1f}"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_2_3b")
    ap.add_argument("--engine", default="hydra",
                    choices=("hydra", "separate"))
    ap.add_argument("--critic-arch", default="",
                    help="the separate engine's critic and reward model "
                         "(default: --arch)")
    ap.add_argument("--smoke", action="store_true",
                    help="the reference example's small trunk (CPU-sized)")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=0,
                    help="0 = 8 with --smoke, else 512")
    ap.add_argument("--gen-len", type=int, default=0,
                    help="0 = 16 with --smoke, else 64")
    ap.add_argument("--lora-rank", type=int, default=0,
                    help="0 = 16 with --smoke, else the paper's 128")
    ap.add_argument("--lr", type=float, default=0.0,
                    help="0 = 3e-2 hydra or 3e-3 separate with --smoke (the "
                         "reference example's rates), else 1e-5")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--reward", default="target", choices=("target", "adapter"))
    ap.add_argument("--memory-policy", default="after_inference",
                    choices=("none", "after_inference", "after_training",
                             "after_all"))
    ap.add_argument("--offload", default="none",
                    choices=("none", "optimizer", "roles", "all"))
    ap.add_argument("--remat", default="",
                    choices=("", "none", "full", "dots", "offload"),
                    help="the configs' own unless given")
    ap.add_argument("--capture-buckets", default="",
                    help="comma list of prefill compile-bucket sizes, "
                         "e.g. 8,16,32")
    ap.add_argument("--spec-decode", action="store_true",
                    help="MTP self-speculative greedy rollout (the tokens "
                         "of greedy decoding; gives the actor mtp_depth = "
                         "spec_k MTP heads)")
    ap.add_argument("--spec-k", type=int, default=2,
                    help="draft tokens per speculative step")
    ap.add_argument("--device", default=None,
                    help="cuda unless given; cpu runs the plain PyTorch path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out", default="", metavar="PATH",
                    help="write the run's telemetry JSONL (spans + metrics; "
                         "render with python -m repro_torch.launch.report)")
    ap.add_argument("--trace-out", default="", metavar="PATH",
                    help="write a Chrome-trace JSON (Perfetto-loadable)")
    ap.add_argument("--watermark", type=float, default=0.0,
                    metavar="FRACTION",
                    help="arm the OOM flight recorder: dump a forensic "
                         "owner/buffer bundle when live bytes cross this "
                         "fraction of capacity (or on a CUDA out-of-memory "
                         "error); 0 disables")
    ap.add_argument("--attrib-out", default="", metavar="PATH",
                    help="write the per-phase owner attribution tables + "
                         "any flight-recorder dumps as JSON (render dumps "
                         "with python -m repro_torch.launch.report --flight)")
    ap.add_argument("--ndp", type=int, default=1,
                    help="ZeRO data parallelism over this many ranks, one "
                         "process each (gloo on the CPU, NCCL on as many "
                         "cards)")
    ap.add_argument("--zero-stage", type=int, default=3,
                    choices=(0, 1, 2, 3), help="ZeRO stage for --ndp > 1")
    ap.add_argument("--gather-mode", default="layer",
                    choices=("layer", "tree"),
                    help="ZeRO-3's gathers: one layer at a time or the "
                         "whole tree")
    ap.add_argument("--ntp", type=int, default=1,
                    help="Megatron tensor parallelism over this many ranks "
                         "(ndp x ntp processes)")
    args = ap.parse_args(argv)
    world = args.ndp * args.ntp
    if world <= 1:
        return run(args)
    import torch.multiprocessing as mp
    cpu = torch.device(args.device or "cuda").type == "cpu"
    if not cpu and torch.cuda.device_count() < world:
        raise SystemExit(f"{world} ranks over NCCL need {world} cards, "
                         f"found {torch.cuda.device_count()}; pass "
                         "--device cpu for gloo ranks on the CPU")
    tmp = tempfile.mkdtemp(prefix="torch_rlhf_e2e-")
    try:
        mp.spawn(_rank, args=(args, os.path.join(tmp, "store")),
                 nprocs=world, join=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _rank(rank, args, store):
    """One rank of ``--ndp`` x ``--ntp``: its process group, its device,
    the run."""
    import torch.distributed as dist
    from repro_torch.sharding import ShardedContext
    cpu = torch.device(args.device or "cuda").type == "cpu"
    world = args.ndp * args.ntp
    if cpu:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    else:
        torch.cuda.set_device(rank)
        args.device = f"cuda:{rank}"
    dist.init_process_group("gloo" if cpu else "nccl",
                            store=dist.FileStore(store, world), rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        shard = ShardedContext.create(
            args.ndp, zero_stage=args.zero_stage, model=args.ntp,
            gather_mode=args.gather_mode, device="cpu" if cpu else "cuda")
        run(args, shard, rank)
    finally:
        dist.destroy_process_group()


def run(args, shard=None, rank=0):
    """The run (one rank's, under ``shard``): rank 0 prints."""
    print_ = print if rank == 0 else (lambda *a, **k: None)
    device = default_device(args.device)
    telemetry = None
    if args.metrics_out or args.trace_out or args.watermark \
            or args.attrib_out:
        from repro_torch.obs import FlightRecorder, RunTelemetry
        flight = FlightRecorder(watermark=args.watermark, device=device) \
            if args.watermark else None
        telemetry = RunTelemetry.create(
            engine=args.engine, offload=args.offload,
            memory_policy=args.memory_policy, flight=flight)

    def config(name):
        cfg = get_config(name)
        if args.smoke:
            cfg = dataclasses.replace(
                cfg.smoke(), num_layers=args.layers, d_model=args.d_model,
                d_ff=2 * args.d_model if cfg.d_ff else 0, vocab_size=64,
                num_heads=4,
                num_kv_heads=2, head_dim=64)
        if args.remat:
            cfg = dataclasses.replace(cfg, remat=args.remat)
        return cfg

    cfg = config(args.arch)
    critic_cfg = config(args.critic_arch or args.arch)
    if args.spec_decode:
        cfg = dataclasses.replace(cfg, mtp_depth=args.spec_k)
    small = args.smoke
    separate = args.engine == "separate"
    lr = args.lr or ((3e-3 if separate else 3e-2) if small else 1e-5)
    rl = RLHFConfig(
        prompt_len=args.prompt_len or (8 if small else 512),
        gen_len=args.gen_len or (16 if small else 64),
        lr=lr, critic_lr=lr,
        kl_coef=0.0 if small else 0.1, temperature=args.temperature,
        top_k=args.top_k, engine=args.engine,
        lora_rank=args.lora_rank or (16 if small else 128),
        memory_policy=args.memory_policy, offload=args.offload,
        spec_decode=args.spec_decode, spec_k=args.spec_k,
        capture_buckets=tuple(int(b) for b in args.capture_buckets.split(","))
        if args.capture_buckets else None)
    reward_fn = make_target_token_reward(7) if args.reward == "target" \
        else None
    trainer = RLHFTrainer(cfg, critic_cfg, rl,
                          torch.Generator(device=device).manual_seed(args.seed),
                          reward_fn=reward_fn, telemetry=telemetry,
                          shard=shard)
    if shard is not None:
        # a collective: every rank takes part, rank 0 prints
        per_device = trainer.per_device_state_bytes()
        mode = f" ({shard.strat.gather_mode} gathers)" \
            if shard.zero_stage >= 3 else ""
        print_(f"ZeRO-{shard.zero_stage}{mode} over {shard.ndp} ranks, "
               f"tensor parallel over {shard.ntp} ({shard.comm.backend})")
        print_(f"per-device persistent state: {per_device / 2**20:.2f} MiB")
    if separate:
        trees = trainer.persistent_trees()
        count = lambda t: sum(x.numel() for x in leaves(t))  # noqa: E731
        print_(f"separate engine on {device}: actor and reference "
              f"{cfg.name} ({count(trees['actor_params']):,} params), critic "
              f"and reward {critic_cfg.name} "
              f"({count(trees['critic_params']):,} params); persistent "
              f"state {nbytes(trees) / 2**20:.1f} MiB")
    else:
        eng = trainer.engine
        print_(f"hydra engine on {device}: {cfg.name}, trunk "
              f"{eng.base_param_count():,} params (frozen), actor adapter "
              f"{eng.adapter_param_count('actor'):,} "
              f"({100 * eng.trainable_fraction('actor'):.2f}% trainable), "
              f"rank {rl.lora_rank}")

    g = torch.Generator(device=device).manual_seed(args.seed + 1)
    t0 = time.time()
    for step in range(args.steps):
        prompts = torch.randint(0, cfg.vocab_size, (args.batch, rl.prompt_len),
                                generator=g, device=device)
        m = trainer.train_step(prompts, g)
        print_(f"step {step:4d} reward {m['mean_reward']:+.4f} "
              f"kl {m['kl']:.4f} clip {m['clip_frac']:.3f} "
              f"vf {m['vf_loss']:.4f} ({time.time() - t0:.0f}s)")

    ro = trainer.rollout
    if ro.prefill_ladder is not None:
        print_(f"compile cache: {ro.compile_cache.stats()}")
    ds = ro.decode_stats
    print_(f"last rollout: {ds['steps']} decode steps, "
          + (f"graphed ({ds['replays']} replays, capture "
             f"{ds['capture_ms']:.1f} ms, pool "
             f"{ds['pool_bytes'] / 2**20:.1f} MiB)" if ds["graphed"]
             else "eager")
          + f", loop host {ds['host_ms']:.1f} ms")
    if ro.spec_decode:
        st = ro.spec_stats
        print_(f"spec decode (k={ro.spec_k}): {st['steps']} verify steps, "
              f"accepted {st['accepted']}/{st['drafted']} drafts "
              f"({st['accepted'] / max(st['drafted'], 1):.1%})")

    lot = trainer.offload_lot
    if lot is not None:
        avail = [line for line in pathlib.Path("/proc/meminfo").read_text()
                 .splitlines() if line.startswith("MemAvailable")] \
            if pathlib.Path("/proc/meminfo").exists() else []
        print_(f"host offload {args.offload}: {lot.parked_bytes() / 2**30:.2f} "
              f"GiB parked now, peak {lot.stats.peak_parked_bytes / 2**30:.2f}"
              f" GiB, {lot.pinned_bytes() / 2**30:.2f} GiB pinned; "
              f"{lot.stats.bytes_parked_total / 1e9:.2f} GB parked and "
              f"{lot.stats.bytes_fetched_total / 1e9:.2f} GB fetched in all"
              + (f"; host {avail[0]}" if avail else ""))

    # the last iteration's records: one per phase (and on the hydra engine
    # a mid-rollout sample)
    print_(f"\nlast-iteration phases (policy={args.memory_policy}, "
          f"engine={args.engine}, offload={args.offload}; MiB; park and "
          f"fetch ms within the phase's):")
    print_("  phase            kind          ms     live reserved     peak"
          "     host    park   fetch")
    for r in trainer.memory.records[-(7 if separate else 8):]:
        print_(f"  {r['phase']:16s} {r['kind']:10s} "
              f"{r['seconds'] * 1e3:8.1f} {_mib(r['live_bytes'])} "
              f"{_mib(r['reserved_bytes'])} {_mib(r['peak_bytes'])} "
              f"{_mib(r['host_bytes'])} "
              f"{r.get('park_seconds', 0) * 1e3:7.1f} "
              f"{r.get('fetch_seconds', 0) * 1e3:7.1f}")

    if telemetry is not None:
        telemetry.write(args.metrics_out or None, args.trace_out or None)
        for p in (args.metrics_out, args.trace_out):
            if p:
                print_("telemetry:", p)
    if args.attrib_out and telemetry is not None:
        phases = {}
        for sp in telemetry.tracer.spans:
            if sp.cat == "phase" and "attrib" in sp.args:
                phases[sp.name] = {
                    "owners": sp.args["attrib"],
                    "unattributed": sp.args["attrib_unattributed"],
                    "measured_bytes": sp.args["measured_bytes"],
                    "sim_delta": sp.args.get("attrib_sim_delta")}
        fl = telemetry.flight
        bundle = {"schema": "attribution/v1", "engine": args.engine,
                  "offload": args.offload,
                  "final": telemetry.attribution.snapshot().to_record(),
                  "phases": phases,
                  "flight_dumps": list(fl.dumps) if fl is not None else []}
        with open(args.attrib_out, "w") as f:
            json.dump(bundle, f, indent=1, default=str)
        print_("attribution:", args.attrib_out)


if __name__ == "__main__":
    main()
