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
"""
import argparse
import dataclasses
import pathlib
import sys
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
    ap.add_argument("--device", default=None,
                    help="cuda unless given; cpu runs the plain PyTorch path")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = default_device(args.device)

    def config(name):
        cfg = get_config(name)
        if args.smoke:
            cfg = dataclasses.replace(
                cfg.smoke(), num_layers=args.layers, d_model=args.d_model,
                d_ff=2 * args.d_model, vocab_size=64, num_heads=4,
                num_kv_heads=2, head_dim=64)
        if args.remat:
            cfg = dataclasses.replace(cfg, remat=args.remat)
        return cfg

    cfg = config(args.arch)
    critic_cfg = config(args.critic_arch or args.arch)
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
        capture_buckets=tuple(int(b) for b in args.capture_buckets.split(","))
        if args.capture_buckets else None)
    reward_fn = make_target_token_reward(7) if args.reward == "target" \
        else None
    trainer = RLHFTrainer(cfg, critic_cfg, rl,
                          torch.Generator(device=device).manual_seed(args.seed),
                          reward_fn=reward_fn)
    if separate:
        trees = trainer.persistent_trees()
        count = lambda t: sum(x.numel() for x in leaves(t))  # noqa: E731
        print(f"separate engine on {device}: actor and reference "
              f"{cfg.name} ({count(trees['actor_params']):,} params), critic "
              f"and reward {critic_cfg.name} "
              f"({count(trees['critic_params']):,} params); persistent "
              f"state {nbytes(trees) / 2**20:.1f} MiB")
    else:
        eng = trainer.engine
        print(f"hydra engine on {device}: {cfg.name}, trunk "
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
        print(f"step {step:4d} reward {m['mean_reward']:+.4f} "
              f"kl {m['kl']:.4f} clip {m['clip_frac']:.3f} "
              f"vf {m['vf_loss']:.4f} ({time.time() - t0:.0f}s)")

    ro = trainer.rollout
    if ro.prefill_ladder is not None:
        print(f"compile cache: {ro.compile_cache.stats()}")
    ds = ro.decode_stats
    print(f"last rollout: {ds['steps']} decode steps, "
          + (f"graphed ({ds['replays']} replays, capture "
             f"{ds['capture_ms']:.1f} ms, pool "
             f"{ds['pool_bytes'] / 2**20:.1f} MiB)" if ds["graphed"]
             else "eager")
          + f", loop host {ds['host_ms']:.1f} ms")

    lot = trainer.offload_lot
    if lot is not None:
        avail = [line for line in pathlib.Path("/proc/meminfo").read_text()
                 .splitlines() if line.startswith("MemAvailable")] \
            if pathlib.Path("/proc/meminfo").exists() else []
        print(f"host offload {args.offload}: {lot.parked_bytes() / 2**30:.2f} "
              f"GiB parked now, peak {lot.stats.peak_parked_bytes / 2**30:.2f}"
              f" GiB, {lot.pinned_bytes() / 2**30:.2f} GiB pinned; "
              f"{lot.stats.bytes_parked_total / 1e9:.2f} GB parked and "
              f"{lot.stats.bytes_fetched_total / 1e9:.2f} GB fetched in all"
              + (f"; host {avail[0]}" if avail else ""))

    # the last iteration's records: one per phase (and on the hydra engine
    # a mid-rollout sample)
    print(f"\nlast-iteration phases (policy={args.memory_policy}, "
          f"engine={args.engine}, offload={args.offload}; MiB; park and "
          f"fetch ms within the phase's):")
    print("  phase            kind          ms     live reserved     peak"
          "     host    park   fetch")
    for r in trainer.memory.records[-(7 if separate else 8):]:
        print(f"  {r['phase']:16s} {r['kind']:10s} "
              f"{r['seconds'] * 1e3:8.1f} {_mib(r['live_bytes'])} "
              f"{_mib(r['reserved_bytes'])} {_mib(r['peak_bytes'])} "
              f"{_mib(r['host_bytes'])} "
              f"{r.get('park_seconds', 0) * 1e3:7.1f} "
              f"{r.get('fetch_seconds', 0) * 1e3:7.1f}")


if __name__ == "__main__":
    main()
