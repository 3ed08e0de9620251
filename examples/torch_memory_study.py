"""The paper's memory study through the port's core API — the twin of
``examples/memory_study.py``: trace the RLHF phases of the OPT workload
from the port's own PyTorch programs (on ``meta`` tensors: no card and no
allocation), replay them through the caching-allocator simulator under a
chosen strategy, and compare empty_cache policies — with the
runtime-offload axis (``--offload``, ``--engine hydra``) that parks
off-phase role state to host at phase boundaries.

    PYTHONPATH=src python examples/torch_memory_study.py [--strategy ZeRO-3]
    PYTHONPATH=src python examples/torch_memory_study.py --engine hydra --offload all
    PYTHONPATH=src python examples/torch_memory_study.py --ndp 8 --zero-stage 3

The ``--ndp``/``--zero-stage`` axis takes the closed-form ``1/ndp`` of
``MemoryStrategy.scale``: the reference's traced fractions read the mesh
rules of its ``sharding/``, which the port does not have yet.
"""
import argparse
import dataclasses
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (OFFLOAD_LEVELS, PAPER_STRATEGIES,  # noqa: E402
                              POLICIES, build_rlhf_phases,
                              lora_trainable_fraction, run_iteration)

GB = 1 << 30


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--strategy", default="All Enabled",
                    choices=[s.name for s in PAPER_STRATEGIES])
    ap.add_argument("--gen-lens", type=int, nargs="*",
                    default=[180, 256, 199, 243])
    ap.add_argument("--engine", default="separate",
                    choices=("separate", "hydra"))
    ap.add_argument("--offload", default="none", choices=OFFLOAD_LEVELS,
                    help="runtime host-offload level applied at phase "
                         "boundaries (repro_torch.offload)")
    ap.add_argument("--ndp", type=int, default=4,
                    help="DP/ZeRO domain size of the simulated node")
    ap.add_argument("--zero-stage", type=int, default=None,
                    choices=(0, 1, 2, 3),
                    help="override the strategy's ZeRO stage (closed-form "
                         "1/ndp fractions)")
    args = ap.parse_args()
    strat = {s.name: s for s in PAPER_STRATEGIES}[args.strategy]
    strat = dataclasses.replace(strat, offload=args.offload)
    if args.zero_stage is not None:
        strat = dataclasses.replace(strat, zero_stage=args.zero_stage)

    actor, critic = get_config("opt_1_3b"), get_config("opt_350m")
    # hydra phase plans carry exact adapter-sized opt/grad buffers already
    tf = 1.0 if args.engine == "hydra" else lora_trainable_fraction(actor, 128)
    print(f"building phase traces (grad_ckpt={strat.grad_ckpt}, "
          f"engine={args.engine}) ...")
    plans, persist = [], None
    for gl in args.gen_lens:
        ph, persist = build_rlhf_phases(actor, critic, gen_len=gl,
                                        naive_generation=True,
                                        grad_ckpt=strat.grad_ckpt,
                                        engine=args.engine)
        plans.append(ph)

    print(f"\nstrategy: {strat.name}  (DP={args.ndp}, "
          f"zero_stage={strat.zero_stage}, LoRA-128, 24 GB device, "
          f"offload={args.offload})")
    print(f"{'policy':16s} {'reserved':>9s} {'frag@peak':>10s} "
          f"{'allocated':>10s} {'time':>8s}")
    runs = {}
    for policy in POLICIES:
        r = runs[policy] = run_iteration(plans, persist, strat, policy,
                                         ndp=args.ndp, trainable_fraction=tf)
        host = f" (host {r.peak_host_bytes/GB:.2f}G)" \
            if r.peak_host_bytes else ""
        print(f"{policy:16s} {r.peak_reserved/GB:8.2f}G "
              f"{r.frag_at_peak/GB:9.2f}G {r.peak_allocated/GB:9.2f}G "
              f"{r.time_s:7.2f}s{host}")
    base, fixed = runs["none"], runs["after_inference"]
    print(f"\nempty_cache after inference: "
          f"-{100*(1-fixed.peak_reserved/base.peak_reserved):.0f}% memory, "
          f"+{100*(fixed.time_s/base.time_s-1):.1f}% time "
          f"(paper: -25%, +2%)")


if __name__ == "__main__":
    main()
