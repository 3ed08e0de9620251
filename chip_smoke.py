#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # needs one NVIDIA card and nvcc
    python3 chip_smoke.py --profile  # also profiles one request per path
                                     # and one PPO iteration

Phases, each failing with a non-zero exit:

1. the card (``nvidia-smi`` name and power limit), versions, and the
   kernels' build from ``src/repro_torch/kernels/csrc``; the SASS of the
   bf16 flash, flash-backward and SSD-scan kernels must hold HGMMA
   (tensor-core) instructions and the kernels redesigned for Hopper (B2's
   wgmma kernel, B3's and B4's split and combine kernels, B5's wgmma
   kernel, B1's vector and scalar kernels) and the backward kernels
   (B2-bwd's three of each route, B1-bwd's three) must not spill registers
   (their ptxas lines are printed);
2. each kernel against its plain PyTorch version at the shapes of the
   serving, paged GRPO and Mamba2 paths and at edge cases (ragged Sq/Sk
   across the 128-row q and 64-key k tiles, Sk below one tile, a window
   that cuts tiles, a wrapped rolling cache, B3 with most splits empty,
   C below one split, G = 1 and 8 and a row with no valid slot, head_dim
   64, fp32; for B5 b and c as column slices of one xbc-like tensor, one
   chunk, N 64 with chunks of 64 and 128, a chunk of 512, small head and
   state widths, a strongly decaying a and the step-by-step oracle; for
   B1 each route of its plan; for B4 the paged GRPO step's forked table,
   all-distinct and all-same tables of its shape, ragged positions, an
   idle row in a tile, a ragged last tile, pages of two units and a forced
   single split; B2's lse output on every case; B2-bwd at the PPO
   training shape in bf16 (tensor cores) and fp32, D 64, G 1 and 8,
   windows, ragged S = 100, causal Sk above and below Sq and a full
   ragged Sq != Sk in both dtypes; B1-bwd, dx and dscale, at the
   training rows of both PPO paths, rows not even over its blocks and
   each route, dscale the same bits in two calls), with its time, the
   plain version's, one PyTorch library call's (where one exists) and
   the least time the card could take; every kernel also with its
   device time from CUDA-graph replay, warm and cold (inputs rotated
   through more than the 50 MB L2, as the path finds them), B1 at
   every path shape beside ``F.rms_norm``'s, B4 on each of
   its three tables with its plan and the pages each block copies;
3. the serving path: full-width, full-depth llama3_2_3b (28 layers, bf16,
   random weights from a seed) serves 3 requests of batch 8 x 512 prompt
   tokens + 64 generated, through ``repro_torch.launch.serve.run``; the
   kernels' launch counts must be exactly what that path makes;
4. the outputs: shapes, ranges and finite log-probs, and a small model
   on the card against the same model on the CPU (the plain path);
5. the paged GRPO rollout: the same model serves 2 requests of 8 prompts
   x 504 tokens, each forked into G = 8 samples of 64 tokens off one
   prefill, through ``Rollout(backend="paged").generate(group_size=8)``;
   launch counts (B4 on every decode step, B3 never) and page-manager
   stats are asserted, and one dense request of the same prompts repeated
   8 times is run beside it: request time, peak memory above the weights
   (the paged fork's must be the lower), and the two results' first
   sampled tokens (identical) and log-probs (within bf16 rounding).
6. Mamba2 serving: full-width, full-depth mamba2_370m (48 layers,
   d_model 1024, bf16, random weights from a seed) serves 3 requests of
   batch 8 x 2048 prompt tokens + 64 generated through
   ``serve.run``, through B5 (the SSD chunk scan, once per layer in each
   prefill) and B1; launch counts asserted, outputs checked, the prefill
   and decode step timed apart, and a small Mamba model on the card
   against the CPU (16 greedy tokens identical).
7. the paper's workload: 2 hydra PPO iterations (the seven phases of
   ``RUNTIME_RLHF_PHASE_SEQUENCE``) of full llama3_2_3b with rank-128
   adapters, 8 prompts x (512 + 64), remat="full", the reward adapter
   scoring, through ``RLHFTrainer.train_step``; the launches of all seven
   counters per iteration asserted (``ppo_launches``), losses finite,
   trunk unchanged bit for bit, adapters moved; each phase's ms and
   live/reserved/peak MiB above the weights printed, then again for one
   iteration under memory_policy="none"; a small model's 2 greedy fp32
   PPO steps on the card against the CPU.
8. the paper's four-model PPO (``engine="separate"``, full-parameter
   training) on its own pair: an opt_1_3b actor and reference, an
   opt_350m critic and reward model (24 layers each, MHA at head_dim 64,
   bf16), 8 prompts x (256 + 256), the reward model scoring; 2 iterations
   with the launches of all seven counters asserted (``ppo_launches``
   from each config's depth; B1-bwd with dscale at every norm), finite
   metrics, the reference and reward models unchanged bit for bit,
   every trained leaf given a gradient and moved (bar the bf16 norm
   scales, whose lr-1e-5 steps round away), the persistent bytes equal to
   the six trees' ``nbytes``; per-phase ms and MiB, then one iteration
   under memory_policy="none", one hydra iteration of opt_1_3b at the
   same shape, ``memory_accounting`` of llama3_2_3b, and a small model's
   2 greedy fp32 separate iterations on the card against the CPU.
9. host offload (``RLHFConfig.offload``, ``repro_torch.offload``): the
   separate OPT pair of phase 8 at ``none`` twice (does the card repeat
   itself bit for bit?), then a fresh trainer at each of ``optimizer``,
   ``roles`` and ``all``, and at ``roles`` under memory_policy="none",
   each one warm and one measured iteration: the bytes left on the card
   after the initial parks held to the trees' ``nbytes``, launches
   (``ppo_launches``), metrics equal to ``none``'s, the reference and
   reward models bit for bit, every record's live bytes below ``none``'s
   by at least the bytes parked there; hydra llama3_2_3b at phase 7's
   shape at ``none`` and at ``all``, the rollout's mid-phase sample below
   ``none``'s by at least the trunk's adapted leaves; one actor step's
   forward and backward under remat "full", "offload" (gradients bit for
   bit "full"'s) and "dots" (within 2e-2), launches equal; and a 1 GiB
   pinned copy each way as the link's yardstick. Per phase: ms, park and
   fetch ms, GB moved and GB/s, live/reserved/peak/host MiB and the state
   on the card; the host's MemTotal/MemAvailable before and after.

10. decode graphs (``rlhf/decode_graph.py``): every decode path eagerly
   and graphed in this call, from one seed — serving llama3_2_3b 8 x
   (512 + 64), the paged GRPO rollout (8 x 504, G = 8, 64 generated),
   mamba2_370m 8 x (2048 + 64), the hydra PPO rollout of llama3_2_3b 8 x
   (512 + 64) and the separate PPO rollout of opt_1_3b 8 x (256 + 256):
   tokens and log-probs the same bits (sampled, and greedy), launches and
   the live bytes after each call equal; ms a decode step both ways, the
   capture's ms and the graph pool's MiB; the paged step's host time
   split between the page manager and the rest; one PPO iteration each
   way on both engines (the rollout boundary's live bytes equal); with
   ``--profile`` the idle share of a graphed and an eager serving call and
   of a graphed paged GRPO call, each with the kernels in its trace held
   to ``ops.launches`` for it.

Phases 3 and 5-9 run graphed, the default on the card: every decode step
after a call's first replays its captured step (in a call of two decode
steps or more), and the launch counts they assert are the eager path's
(``ops.capturing``).

It prints the per-kernel JSON line, the card line, and last the result
line ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import pathlib
import re
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as fab  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.data import PromptDataset, \
    synthetic_instruction_prompts  # noqa: E402
from repro_torch import steps as TS  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import lora as LORA  # noqa: E402
from repro_torch.offload.compat import pinned_buffer  # noqa: E402
from repro_torch.paged import PageManager, gather_kv  # noqa: E402
from repro_torch.rlhf import (ModelEngine, RLHFConfig, RLHFTrainer,  # noqa: E402
                              Rollout)
from repro_torch.tree import leaves  # noqa: E402
from repro_torch.tree import nbytes as tree_nbytes  # noqa: E402

OUT_DIR = ROOT / "chiprun_out"

# serving path: llama3_2_3b, batch 8, prompt 512, 64 generated tokens
BATCH, PROMPT, GEN, REQUESTS = 8, 512, 64, 3
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}   # other summation order
# B1-bwd: the scaled error of dx and dscale, at the forward kernels' fp32
# tolerance (tests/test_kernels.py:15)
TOL_RMS_BWD = {torch.bfloat16: 2e-2, torch.float32: 5e-5}
# paged GRPO rollout: 8 prompts of 504 tokens (not a multiple of the page
# size, so each forked row CoW-copies its partial prompt page), G = 8
# samples each, 64 generated tokens, 2 requests
GROUPS, GPROMPT, GSIZE, PAGE, GREQUESTS = 8, 504, 8, 16, 2
# Mamba2 serving: mamba2_370m, batch 8, prompt 2048 (Mamba2's training
# context, a multiple of the 256-step SSD chunk), 64 generated tokens
MBATCH, MPROMPT, MREQUESTS = 8, 2048, 3
TOL_SSD = {torch.bfloat16: 5e-2, torch.float32: 1e-3}   # test_kernels.py:98
# PPO iteration: llama3_2_3b, hydra engine, rank 128, 8 prompts of 512 + 64
# generated tokens, 2 iterations (and one more under memory_policy="none")
PBATCH, PPROMPT, PITERS = 8, 512, 2
# separate PPO (phase 8): the paper's own pair (DeepSpeed-Chat), an
# opt_1_3b actor and reference and an opt_350m critic and reward model, 8
# prompts x (256 + 256), the lengths build_rlhf_phases traces by default
SEP_ACTOR, SEP_CRITIC = "opt_1_3b", "opt_350m"
SBATCH, SPROMPT, SGEN, SITERS = 8, 256, 256, 2
SLEN = SPROMPT + SGEN

# (memory B/s, bf16 tensor FLOP/s, fp32 FLOP/s), NVIDIA data sheets, dense
PEAKS = {"SXM": (3.35e12, 989e12, 67e12), "PCIe": (2.0e12, 756e12, 51e12),
         "NVL": (3.9e12, 835e12, 60e12)}


def card_peaks(name: str):
    for key in ("PCIe", "NVL"):
        if key in name:
            return PEAKS[key]
    return PEAKS["SXM"]


def sh(cmd) -> str:
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_graph_ms(fn, n_sets: int = 1, rounds: int = 10) -> float:
    """Device time of one ``fn(i)``: ``rounds`` passes over the input sets
    ``i < n_sets`` captured in one CUDA graph and replayed, timed with CUDA
    events, so no host work sits between the launches (an eager loop of a
    small kernel measures its wrapper's Python instead). With several
    independent sets whose sum exceeds the 50 MB L2, each call finds its
    inputs evicted by the other sets' traffic: cold, as the path finds
    them."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for i in range(n_sets):
            fn(i)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(rounds):
            for i in range(n_sets):
                fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (rounds * n_sets)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(peaks, n_bytes: float, n_ops: float, dtype):
    mem, bf16, fp32 = peaks
    t_bytes = n_bytes / mem
    t_ops = n_ops / (bf16 if dtype == torch.bfloat16 else fp32)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def causal_pairs(Sq, Sk, causal, window) -> int:
    """Unmasked (query, key) pairs: the work this input needs."""
    total = 0
    for i in range(Sq):
        if not causal:
            total += Sk
            continue
        hi = min(i, Sk - 1)
        lo = max(0, i - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def rolling_pos(B, C, cur, device):
    """Per-slot positions of a rolling cache of capacity C after writing
    positions 0..cur (slot = position % C; -1 = never written)."""
    slots = torch.arange(C, device=device)
    base = cur - cur % C
    pos = torch.where(slots <= cur % C, base + slots, base - C + slots)
    pos = torch.where(pos < 0, torch.full_like(pos, -1), pos)
    return pos.to(torch.int32)[None].expand(B, C).contiguous()


# ---------------------------------------------------------------- phase 1
# the kernels this slice redesigned; their ptxas lines are printed and
# must show no spills
NEW_KERNELS = ("flash_wgmma_kernel", "decode_split_kernel", "combine_kernel",
               "paged_split_kernel", "paged_merge_kernel",
               "ssd_wgmma_kernel", "rmsnorm_vec_kernel",
               "rmsnorm_scalar_kernel", "flash_bwd_prep_kernel",
               "flash_bwd_dkdv_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
               "flash_bwd_delta_kernel", "flash_bwd_dkdv_kernel",
               "flash_bwd_dq_kernel",
               "rmsnorm_bwd_vec_kernel", "rmsnorm_bwd_scalar_kernel",
               "rmsnorm_dscale_sum_kernel")
# the kernels that must run on the tensor cores (HGMMA in their SASS)
HGMMA_KERNELS = ("flash_wgmma_kernel", "ssd_wgmma_kernel",
                 "flash_bwd_dkdv_wgmma_kernel", "flash_bwd_dq_wgmma_kernel")


def ptxas_table(log: str) -> dict:
    """{mangled kernel name: {"registers", "spill_stores", "spill_loads"}}
    from ``nvcc -Xptxas -v`` output."""
    table, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            table.setdefault(name, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            table[name].update(spill_stores=int(m.group(1)),
                               spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            table[name]["registers"] = int(m.group(1))
    return table


def sass_hgmma(lib_path) -> dict:
    """{mangled kernel name: count of HGMMA instructions} in the built
    library's SASS (``cuobjdump -sass``)."""
    tool = shutil.which("cuobjdump") or str(
        pathlib.Path(build.nvcc()).with_name("cuobjdump"))
    counts, name = {}, None
    for line in sh([tool, "-sass", str(lib_path)]).splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and "HGMMA" in line:
            counts[name] += 1
    return counts


def check_build(path, log):
    """Phase 1's checks of the built library: the bf16 flash, flash
    backward and SSD-scan kernels run on the tensor cores (HGMMA in their
    SASS), and no kernel redesigned for Hopper spills registers."""
    hgmma = sass_hgmma(path)
    for kname in HGMMA_KERNELS:
        found = {k: v for k, v in hgmma.items() if kname in k}
        for k, v in found.items():
            print(f"  SASS {k}: {v} HGMMA")
        if not found or not all(found.values()):
            raise SystemExit(f"{kname} without HGMMA: {found}")
    tensor = {k: v for k, v in hgmma.items()
              if any(n in k for n in HGMMA_KERNELS)}
    # ptxas's performance remarks (C7515, C7520: wgmma serialized) would
    # mean the flash kernel's pipelining is lost; shown, not fatal
    for line in log.splitlines():
        if "Potential Performance Loss" in line:
            print(f"  {line.strip()[:200]}")
    table = {k: v for k, v in ptxas_table(log).items()
             if any(n in k for n in NEW_KERNELS)}
    for k, v in sorted(table.items()):
        print(f"  ptxas {k}: {v.get('registers')} registers, "
              f"{v.get('spill_stores')} B spill stores, "
              f"{v.get('spill_loads')} B spill loads")
    spills = [k for k, v in table.items()
              if v.get("spill_stores") or v.get("spill_loads")]
    if not table or spills:
        raise SystemExit(f"redesigned kernels spill (or ptxas printed "
                         f"nothing): {spills or table}")
    return {"hgmma": tensor, "ptxas": table}


# ---------------------------------------------------------------- phase 2
def _gqa_sdpa(q, k, v, **kw):
    """SDPA in [B, heads, S, D] layout with grouped KV heads (yardstick)."""
    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2), enable_gqa=True,
                                          **kw)


def check_flash(dev, peaks, g):
    cases = [  # (name, B, Sq, Sk, H, K, D, causal, window, dtype)
        ("main", BATCH, PROMPT, PROMPT, 24, 8, 128, True, 0, torch.bfloat16),
        ("grpo_prefill", GROUPS, GPROMPT, GPROMPT, 24, 8, 128, True, 0,
         torch.bfloat16),
        ("ppo", PBATCH, PPROMPT + GEN, PPROMPT + GEN, 24, 8, 128, True, 0,
         torch.bfloat16),
        # the separate path's scoring and training: MHA (G = 1) at D 64
        ("sep_actor", SBATCH, SLEN, SLEN, 32, 32, 64, True, 0,
         torch.bfloat16),
        ("sep_critic", SBATCH, SLEN, SLEN, 16, 16, 64, True, 0,
         torch.bfloat16),
        ("sep_prefill", SBATCH, SPROMPT, SPROMPT, 32, 32, 64, True, 0,
         torch.bfloat16),
        ("ragged", 2, 100, 37, 24, 8, 128, False, 0, torch.bfloat16),
        ("ragged_causal", 2, 100, 37, 24, 8, 128, True, 0, torch.bfloat16),
        ("sq65_sk129", 2, 65, 129, 24, 8, 128, False, 0, torch.bfloat16),
        ("sq65_sk129_c", 2, 65, 129, 24, 8, 128, True, 0, torch.bfloat16),
        ("sk50_causal", 3, 50, 50, 24, 8, 128, True, 0, torch.bfloat16),
        ("window", 2, 256, 256, 24, 8, 128, True, 64, torch.bfloat16),
        ("window_cut", 2, 300, 300, 24, 8, 128, True, 100, torch.bfloat16),
        ("d64", 2, 192, 192, 8, 2, 64, True, 0, torch.bfloat16),
        ("d64_ragged", 2, 77, 77, 8, 2, 64, True, 40, torch.bfloat16),
        ("d64_full", 1, 129, 65, 4, 4, 64, False, 0, torch.bfloat16),
        ("fp32", 2, 130, 130, 6, 2, 128, True, 16, torch.float32),
        ("fp32_d64", 2, 100, 37, 4, 2, 64, False, 0, torch.float32),
    ]
    out = []
    for name, B, Sq, Sk, H, K, D, causal, window, dt in cases:
        q = torch.randn(B, Sq, H, D, generator=g, device=dev).to(dt)
        k = torch.randn(B, Sk, K, D, generator=g, device=dev).to(dt)
        v = torch.randn(B, Sk, K, D, generator=g, device=dev).to(dt)
        got = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
        want, want_lse = ref.attention_ref(q, k, v, causal=causal,
                                           window=window, return_lse=True)
        # the lse output (the training path's) beside the same out
        got2, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                           window=window, return_lse=True)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        if not torch.equal(got, got2):
            raise SystemExit(f"flash {name}: out differs with return_lse")
        rec = {"case": name, "shape": [B, Sq, Sk, H, K, D], "causal": causal,
               "window": window, "dtype": str(dt),
               "max_err": max(err, lse_err), "out_err": err,
               "lse_err": lse_err, "tol": TOL[dt]}
        if name == "main":
            rec["ms"] = time_ms(lambda: fa.flash_attention_fwd(
                q, k, v, causal=causal, window=window))
            rec["plain_ms"] = time_ms(lambda: ref.attention_ref(
                q, k, v, causal=causal, window=window), iters=5)
            rec["library_ms"] = time_ms(lambda: _gqa_sdpa(
                q, k, v, is_causal=causal))
            # device time (graph replay): warm on one set; cold over 3 sets
            # of 67 MB, each call's inputs evicted by the other sets' 134 MB
            # (one set alone exceeds the L2)
            sets = [[torch.randn_like(t) for t in (q, k, v)] for _ in range(3)]
            rec["device_ms"] = time_graph_ms(lambda i: fa.flash_attention_fwd(
                q, k, v, causal=causal, window=window))
            rec["cold_ms"] = time_graph_ms(lambda i: fa.flash_attention_fwd(
                *sets[i], causal=causal, window=window), len(sets))
            rec["library_cold_ms"] = time_graph_ms(lambda i: _gqa_sdpa(
                *sets[i], is_causal=causal), len(sets))
            del sets
            n_ops = 4 * B * H * D * causal_pairs(Sq, Sk, causal, window)
            rec["bound_ms"], rec["bound_by"] = bound(
                peaks, nbytes(q, k, v, got), n_ops, dt)
        if name in ("ppo", "sep_actor"):
            # the training path's call, with the lse output: device time
            # by graph replay, warm and cold, beside SDPA's at this shape
            def make_set():
                return [torch.randn_like(t) for t in (q, k, v)]
            rec["device_ms"], rec["cold_ms"] = time_graph_warm_cold(
                lambda *a: fa.flash_attention_fwd(
                    *a, causal=causal, window=window, return_lse=True),
                make_set)
            rec["library_cold_ms"] = time_graph_warm_cold(
                lambda *a: _gqa_sdpa(*a, is_causal=causal), make_set)[1]
            n_ops = 4 * B * H * D * causal_pairs(Sq, Sk, causal, window)
            rec["bound_ms"], rec["bound_by"] = bound(
                peaks, nbytes(q, k, v, got, lse), n_ops, dt)
        out.append(rec)
    return out


def check_decode(dev, peaks, g):
    cases = [  # (name, B, H, K, D, C, cur, window, dtype)
        ("main", BATCH, 24, 8, 128, PROMPT + GEN, PROMPT + GEN - 2, 0,
         torch.bfloat16),
        ("wrapped", 2, 24, 8, 128, 16, 19, 0, torch.bfloat16),
        ("window", 2, 24, 8, 128, 16, 19, 8, torch.bfloat16),
        # cur early: most slots masked, most of the 5 splits hold no valid
        # slot
        ("early", BATCH, 24, 8, 128, PROMPT + GEN, 40, 0, torch.bfloat16),
        ("c_lt_split", 2, 24, 8, 128, 20, 30, 0, torch.bfloat16),
        ("g1", 2, 8, 8, 128, 300, 250, 0, torch.bfloat16),
        ("g8", 2, 16, 2, 128, 300, 250, 64, torch.bfloat16),
        # row 1 has no valid slot: the uniform mean over its C slots
        ("masked_row", 4, 24, 8, 128, PROMPT + GEN, 500, 0, torch.bfloat16),
        ("d64", 2, 8, 2, 64, 100, 70, 0, torch.bfloat16),
        # the separate path's rollout (opt_1_3b, MHA at D 64), its last step
        ("sep", SBATCH, 32, 32, 64, SLEN, SLEN - 2, 0, torch.bfloat16),
        ("fp32", 2, 6, 1, 128, 200, 150, 32, torch.float32),
        ("fp32_g8_d64", 3, 16, 2, 64, 333, 400, 0, torch.float32),
    ]
    out = []
    for name, B, H, K, D, C, cur, window, dt in cases:
        q = torch.randn(B, H, D, generator=g, device=dev).to(dt)
        kc = torch.randn(B, C, K, D, generator=g, device=dev).to(dt)
        vc = torch.randn(B, C, K, D, generator=g, device=dev).to(dt)
        pos = rolling_pos(B, C, cur, dev)
        position = torch.full((B,), cur, dtype=torch.int32, device=dev)
        if name == "masked_row":
            position[1] = -1
        got = dec.decode_attention(q, kc, vc, pos, position, window=window)
        want = ref.decode_attention_ref(q, kc, vc, pos, position,
                                        window=window)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rec = {"case": name, "shape": [B, H, K, D, C], "cur": cur,
               "window": window, "dtype": str(dt), "max_err": err,
               "tol": TOL[dt], "splits": dec.split_plan(B, K, C)[0]}
        if name == "main":
            valid = (pos >= 0) & (pos <= position[:, None])
            mask = valid[:, None, None, :]
            rec["ms"] = time_ms(lambda: dec.decode_attention(
                q, kc, vc, pos, position, window=window))
            rec["plain_ms"] = time_ms(lambda: ref.decode_attention_ref(
                q, kc, vc, pos, position, window=window))
            rec["library_ms"] = time_ms(lambda: _gqa_sdpa(
                q[:, None], kc, vc, attn_mask=mask))
            # cold, as the path finds it (28 layers' caches a step): 6
            # independent 18.9 MB caches, 113 MB, rotated
            sets = [(torch.randn_like(q), torch.randn_like(kc),
                     torch.randn_like(vc)) for _ in range(6)]
            rec["device_ms"] = time_graph_ms(lambda i: dec.decode_attention(
                q, kc, vc, pos, position, window=window))
            rec["cold_ms"] = time_graph_ms(lambda i: dec.decode_attention(
                *sets[i], pos, position, window=window), len(sets))
            rec["library_cold_ms"] = time_graph_ms(lambda i: _gqa_sdpa(
                sets[i][0][:, None], sets[i][1], sets[i][2], attn_mask=mask),
                len(sets))
            del sets
            n_ops = 4 * H * D * int(valid.sum().item())
            rec["bound_ms"], rec["bound_by"] = bound(
                peaks, nbytes(q, kc, vc, pos, position, got), n_ops, dt)
        if name == "sep":
            valid = (pos >= 0) & (pos <= position[:, None])
            mask = valid[:, None, None, :]

            def make_set():
                return [torch.randn_like(t) for t in (q, kc, vc)]
            rec["device_ms"], rec["cold_ms"] = time_graph_warm_cold(
                lambda qq, kk, vv: dec.decode_attention(
                    qq, kk, vv, pos, position, window=window), make_set)
            rec["library_cold_ms"] = time_graph_warm_cold(
                lambda qq, kk, vv: _gqa_sdpa(qq[:, None], kk, vv,
                                             attn_mask=mask), make_set)[1]
            rec["bound_ms"], rec["bound_by"] = bound(
                peaks, nbytes(q, kc, vc, pos, position, got),
                4 * H * D * int(valid.sum().item()), dt)
        out.append(rec)
    return out


def cold_sets(set_bytes: int) -> int:
    """Input sets for a cold timing: together at least twice the 50 MB L2,
    so each call finds its inputs evicted (at least 3, at most 2048)."""
    return max(3, min(2048, -(-100 * 2**20 // set_bytes)))


def time_graph_warm_cold(fn, make_set):
    """(warm, cold) device ms of ``fn(*inputs)`` by CUDA-graph replay: warm
    on one set of inputs, cold rotating over ``cold_sets`` fresh sets from
    ``make_set()``."""
    first = make_set()
    warm = time_graph_ms(lambda i: fn(*first))
    n = cold_sets(nbytes(*first))
    sets = [first] + [make_set() for _ in range(n - 1)]
    rounds = max(1, 2000 // n)
    cold = time_graph_ms(lambda i: fn(*sets[i]), n, rounds=rounds)
    return warm, cold


# every shape the three paths give B1: (rows, width)
RMSNORM_PATH_SHAPES = {
    "main": (BATCH * PROMPT, 3072), "decode": (BATCH, 3072),
    "grpo_prefill": (GROUPS * GPROMPT, 3072),
    "grpo_decode": (GROUPS * GSIZE, 3072),
    # the PPO path's scoring and training forwards and their recompute
    # (its rollout gives the main and decode shapes)
    "ppo_prefill": (PBATCH * (PPROMPT + GEN), 3072),
    # the Mamba2 path: norm1 at d_model, the gated norm at d_inner
    "mamba_prefill": (MBATCH * MPROMPT, 1024),
    "mamba_gated": (MBATCH * MPROMPT, 2048),
    "mamba_decode": (MBATCH, 2048),
    # the separate path: opt_1_3b's and opt_350m's scoring and training
    # forwards, and the rollout's decode step
    "sep_actor": (SBATCH * SLEN, 2048), "sep_critic": (SBATCH * SLEN, 1024),
    "sep_decode": (SBATCH, 2048)}


def check_rmsnorm(dev, peaks, g):
    """B1 at every path shape, timed by CUDA-graph replay warm and cold
    against ``F.rms_norm`` (the eager ``ms`` of the main and decode shapes
    is kept for continuity), and at each route of its plan."""
    bf = torch.bfloat16
    cases = [(name, shape, bf, bf) for name, shape in
             RMSNORM_PATH_SHAPES.items()] + [
        ("fp32", (3, 100), torch.float32, torch.float32),
        ("fp32_scale", (7, 384), bf, torch.float32),      # scalar route
        ("rows13", (13, 3072), bf, bf),     # a block of 5 of its 8 warps
        ("d100_bf16", (5, 100), bf, bf),    # 200-byte rows: scalar route
        ("wide", (2, 8192), bf, bf),        # too wide for registers: scalar
    ]
    out = []
    for name, shape, dt, sdt in cases:
        x = torch.randn(*shape, generator=g, device=dev).to(dt)
        s = (1 + 0.1 * torch.randn(shape[-1], generator=g, device=dev)).to(sdt)
        got = rn.rmsnorm(x, s, 1e-5)
        want = ref.rmsnorm_ref(x, s, 1e-5)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        plan = rn.plan(shape[0], shape[1], dt, sdt)
        rec = {"case": name, "shape": list(shape), "dtype": str(dt),
               "max_err": err, "tol": TOL[dt], "route": plan.route,
               "per_lane": plan.per_lane, "warps": plan.warps}
        if name in RMSNORM_PATH_SHAPES:
            D = shape[-1]

            def make_set():
                return (torch.randn(*shape, device=dev).to(dt), s)
            rec["device_ms"], rec["cold_ms"] = time_graph_warm_cold(
                lambda xx, ss: rn.rmsnorm(xx, ss, 1e-5), make_set)
            rec["library_device_ms"], rec["library_cold_ms"] = \
                time_graph_warm_cold(
                    lambda xx, ss: F.rms_norm(xx, (D,), ss, 1e-5), make_set)
            rec["bound_ms"], rec["bound_by"] = bound(
                peaks, nbytes(x, s, got), 4 * x.numel(), dt)
        if name in ("main", "decode"):
            rec["ms"] = time_ms(lambda: rn.rmsnorm(x, s, 1e-5), iters=50)
            rec["plain_ms"] = time_ms(lambda: ref.rmsnorm_ref(x, s, 1e-5))
            rec["library_ms"] = time_ms(lambda: F.rms_norm(
                x, (shape[-1],), s, 1e-5), iters=50)
        out.append(rec)
    return out


def scaled_err(got, want) -> float:
    """max |got - want| / max(1, max |want|): gradients grow past 1, and a
    bf16 output rounds to a step relative to its size."""
    got, want = got.float(), want.float()
    return (got - want).abs().max().item() / max(1.0,
                                                 want.abs().max().item())


def _sdpa_fwd_bwd(q, k, v, dout, causal, backward=True):
    """SDPA (GQA) on [B, S, heads, D] inputs and, with ``backward``, its
    backward through autograd: the yardstick, captured whole in a graph."""
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
    o = _gqa_sdpa(qq, kk, vv, is_causal=causal)
    if backward:
        torch.autograd.grad(o, (qq, kk, vv), dout.transpose(1, 2))


def check_flash_bwd(dev, peaks, g):
    """B2-bwd against flash_attention_bwd_ref on the saved out and lse of
    B2's forward: at the PPO training shape (bf16 and fp32) and at D 64,
    G 1 and 8, windows of 100 that cut tiles, ragged S = 100, causal with
    Sk above and below Sq, and full (non-causal) ragged Sq != Sk in both
    dtypes, so the tensor-core route sees every mask. The main shape is
    timed: eager and by graph replay (warm, cold), beside the plain
    version and SDPA's backward (GQA), eager through autograd and by graph
    replay as its forward + backward less its forward."""
    S = PPROMPT + GEN
    bf, f32 = torch.bfloat16, torch.float32
    cases = [  # (name, B, Sq, Sk, H, K, D, causal, window, dtype)
        ("main", PBATCH, S, S, 24, 8, 128, True, 0, bf),
        ("fp32", PBATCH, S, S, 24, 8, 128, True, 0, f32),
        # the separate path's training: MHA (G = 1) at D 64
        ("sep_actor", SBATCH, SLEN, SLEN, 32, 32, 64, True, 0, bf),
        ("sep_critic", SBATCH, SLEN, SLEN, 16, 16, 64, True, 0, bf),
        ("d64", 2, 192, 192, 8, 2, 64, True, 0, bf),
        ("g1", 2, 192, 192, 8, 8, 64, True, 0, bf),
        ("g8", 1, 160, 160, 16, 2, 128, True, 0, bf),
        ("window", 1, 300, 300, 6, 2, 128, True, 100, bf),
        ("window_d64", 2, 200, 200, 4, 2, 64, True, 100, bf),
        ("ragged", 2, 100, 100, 6, 2, 128, True, 0, bf),
        ("sk_gt_sq", 2, 37, 100, 6, 2, 128, True, 0, bf),
        ("sq_gt_sk", 2, 100, 37, 6, 2, 128, True, 0, bf),
        ("full_ragged_bf16", 2, 65, 129, 4, 2, 64, False, 0, bf),
        ("full_ragged_d128", 2, 129, 65, 6, 2, 128, False, 0, bf),
        ("ragged_fp32", 2, 100, 100, 6, 2, 64, True, 0, f32),
        ("full_ragged", 2, 65, 129, 4, 2, 64, False, 0, f32),
    ]
    out_recs = []
    for name, B, Sq, Sk, H, K, D, causal, window, dt in cases:
        q = torch.randn(B, Sq, H, D, generator=g, device=dev).to(dt)
        k = torch.randn(B, Sk, K, D, generator=g, device=dev).to(dt)
        v = torch.randn(B, Sk, K, D, generator=g, device=dev).to(dt)
        dout = torch.randn(B, Sq, H, D, generator=g, device=dev).to(dt)
        kw = dict(causal=causal, window=window)
        out, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **kw)
        got = fab.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
        torch.cuda.synchronize()
        rec = {"case": name, "shape": [B, Sq, Sk, H, K, D], "causal": causal,
               "window": window, "dtype": str(dt),
               "route": fab.route(dt, D),
               "max_err": max(scaled_err(a, b) for a, b in zip(got, want)),
               "max_abs_err": max((a.float() - b.float()).abs().max().item()
                                  for a, b in zip(got, want)),
               "tol": TOL[dt]}
        del want
        if name == "main":
            rec["ms"] = time_ms(lambda: fab.flash_attention_bwd(
                q, k, v, out, lse, dout, **kw), iters=10)
            rec["plain_ms"] = time_ms(lambda: ref.flash_attention_bwd_ref(
                q, k, v, out, lse, dout, **kw), iters=2, warmup=1)
            qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
            oo = _gqa_sdpa(qq, kk, vv, is_causal=causal)
            do_t = dout.transpose(1, 2)
            rec["library_ms"] = time_ms(lambda: torch.autograd.grad(
                oo, (qq, kk, vv), do_t, retain_graph=True), iters=10)
            del qq, kk, vv, oo
        if name in ("main", "sep_actor"):
            def make_set():
                qs, ks, vs, ds = (torch.randn_like(t) for t in (q, k, v, dout))
                os_, ls = fa.flash_attention_fwd(qs, ks, vs, return_lse=True,
                                                 **kw)
                return qs, ks, vs, os_, ls, ds
            rec["device_ms"], rec["cold_ms"] = time_graph_warm_cold(
                lambda *a: fab.flash_attention_bwd(*a, **kw), make_set)
            both = time_graph_warm_cold(
                lambda qs, ks, vs, os_, ls, ds: _sdpa_fwd_bwd(
                    qs, ks, vs, ds, causal), make_set)
            fwd = time_graph_warm_cold(
                lambda qs, ks, vs, os_, ls, ds: _sdpa_fwd_bwd(
                    qs, ks, vs, ds, causal, backward=False), make_set)
            rec["library_device_ms"] = both[0] - fwd[0]
            rec["library_cold_ms"] = both[1] - fwd[1]
            rec["library_fwd_bwd_cold_ms"] = both[1]
            n_ops = 5 * 2 * D * B * H * causal_pairs(Sq, Sk, causal, window)
            rec["bound_ms"], rec["bound_by"] = bound(
                peaks, nbytes(q, k, v, out, lse, dout, *got), n_ops, dt)
        out_recs.append(rec)
    return out_recs


def check_rmsnorm_bwd(dev, peaks, g):
    """B1-bwd (dx and dscale) against rmsnorm_bwd_ref at the training
    path's rows ([8 x 576, 3072]), a decode step's rows, a row count that
    does not split evenly over the blocks and at each route of the plan;
    dx the same bits without dscale, dscale the same bits in a second
    call; the main shape timed without dscale (the hydra path's: the
    trunk is frozen) and with it, beside the backward of F.rms_norm with
    respect to x; the separate path's two widths ([8 x 512, 2048] and
    [8 x 512, 1024], where every scale trains) timed with dscale beside
    F.rms_norm's backward with the weight's gradient; each library time
    by graph replay as its forward and backward less its forward."""
    bf = torch.bfloat16
    cases = [("main", (PBATCH * (PPROMPT + GEN), 3072), bf, bf),
             ("sep_actor", (SBATCH * SLEN, 2048), bf, bf),
             ("sep_critic", (SBATCH * SLEN, 1024), bf, bf),
             ("uneven", (SBATCH * SLEN + 1, 2048), bf, bf),
             ("rows8", (8, 3072), bf, bf),
             ("fp32", (3, 100), torch.float32, torch.float32),
             ("fp32_scale", (7, 384), bf, torch.float32),   # scalar route
             ("d100_bf16", (5, 100), bf, bf),               # scalar route
             ("wide", (2, 8192), bf, bf),                   # scalar route
             ("fp32_rows", (2048, 512), torch.float32, torch.float32)]
    out = []
    for name, shape, dt, sdt in cases:
        x = torch.randn(*shape, generator=g, device=dev).to(dt)
        dy = torch.randn(*shape, generator=g, device=dev).to(dt)
        s = (1 + 0.1 * torch.randn(shape[-1], generator=g, device=dev)).to(sdt)
        dx, ds = rn.rmsnorm_bwd(x, s, dy, 1e-5)
        want_dx, want_ds = ref.rmsnorm_bwd_ref(x, s, dy, 1e-5)
        dx2, _ = rn.rmsnorm_bwd(x, s, dy, 1e-5, dscale=False)
        _, ds2 = rn.rmsnorm_bwd(x, s, dy, 1e-5)
        torch.cuda.synchronize()
        if not torch.equal(dx, dx2):
            raise SystemExit(f"rmsnorm_bwd {name}: dx differs without dscale")
        if not torch.equal(ds, ds2):
            raise SystemExit(f"rmsnorm_bwd {name}: dscale differs between "
                             f"two calls")
        pl = rn.bwd_plan(shape[0], shape[1], dt, sdt)
        rec = {"case": name, "shape": list(shape), "dtype": str(dt),
               "max_err": max(scaled_err(dx, want_dx),
                              scaled_err(ds, want_ds)),
               "max_abs_err": max((dx.float() - want_dx.float()).abs().max()
                                  .item(), (ds.float() - want_ds.float())
                                  .abs().max().item()),
               "tol": TOL_RMS_BWD[dt], "route": pl.route,
               "blocks": pl.blocks, "warps": pl.warps}
        if name == "main":
            D = shape[-1]
            rec["ms"] = time_ms(lambda: rn.rmsnorm_bwd(x, s, dy, 1e-5,
                                                       dscale=False), iters=50)
            rec["plain_ms"] = time_ms(lambda: ref.rmsnorm_bwd_ref(x, s, dy))
            xr = x.detach().requires_grad_()
            yy = F.rms_norm(xr, (D,), s, 1e-5)
            rec["library_ms"] = time_ms(lambda: torch.autograd.grad(
                yy, xr, dy, retain_graph=True), iters=50)
            del xr, yy

            def make_set():
                return (torch.randn(*shape, device=dev).to(dt), s,
                        torch.randn(*shape, device=dev).to(dt))
            rec["device_ms"], rec["cold_ms"] = time_graph_warm_cold(
                lambda xx, ss, gg: rn.rmsnorm_bwd(xx, ss, gg, 1e-5,
                                                  dscale=False), make_set)
            rec["dscale_device_ms"], rec["dscale_cold_ms"] = \
                time_graph_warm_cold(
                    lambda xx, ss, gg: rn.rmsnorm_bwd(xx, ss, gg, 1e-5),
                    make_set)
            both, fwd = (time_graph_warm_cold(
                lambda xx, ss, gg, b=b: _rms_fwd_bwd(
                    xx, ss, gg, backward=b, dscale=False), make_set)
                for b in (True, False))
            rec["library_device_ms"] = both[0] - fwd[0]
            rec["library_cold_ms"] = both[1] - fwd[1]
            rec["bound_ms"], rec["bound_by"] = bound(
                peaks, nbytes(x, s, dy, dx), 8 * x.numel(), dt)
        if name.startswith("sep"):
            def make_set():
                return (torch.randn(*shape, device=dev).to(dt), s,
                        torch.randn(*shape, device=dev).to(dt))
            rec["device_ms"], rec["cold_ms"] = time_graph_warm_cold(
                lambda xx, ss, gg: rn.rmsnorm_bwd(xx, ss, gg, 1e-5),
                make_set)
            both = time_graph_warm_cold(_rms_fwd_bwd, make_set)
            fwd = time_graph_warm_cold(
                lambda xx, ss, gg: _rms_fwd_bwd(xx, ss, gg, backward=False),
                make_set)
            rec["library_device_ms"] = both[0] - fwd[0]
            rec["library_cold_ms"] = both[1] - fwd[1]
            # dx's 8 operations an element, dscale's product and sum
            rec["bound_ms"], rec["bound_by"] = bound(
                peaks, nbytes(x, s, dy, dx, ds), 10 * x.numel(), dt)
        out.append(rec)
    return out


def _rms_fwd_bwd(x, s, dy, backward=True, dscale=True):
    """F.rms_norm and, with ``backward``, its backward through autograd,
    with the weight's gradient when ``dscale``: the yardstick, captured
    whole in a graph."""
    xx, ss = x.detach().requires_grad_(), s.detach().requires_grad_(dscale)
    y = F.rms_norm(xx, (x.shape[-1],), ss, 1e-5)
    if backward:
        torch.autograd.grad(y, (xx, ss) if dscale else (xx,), dy)


def ssd_ops(B, S, H, P, N, chunk) -> int:
    """Operations the chunked scan needs: per (batch, chunk) of l steps the
    causal half of C B^T (2 N per pair j <= i; it does not depend on the
    head), and per (batch, head, chunk) the causal product with x (2 P per
    pair), y_off and the state update (2 x 2 l N P)."""
    l, nc = chunk, S // chunk
    pairs = l * (l + 1) // 2
    return B * nc * (2 * N * pairs + H * (2 * P * pairs + 4 * l * N * P))


def _ssd_inputs(B, S, H, P, N, dt, adt, decay, g, dev, sliced=False):
    """x, a, b, c for B5; with ``sliced``, b and c are column slices of one
    [B, S, H*P + 2N] tensor, as the Mamba2 block passes them (xbc)."""
    x = (0.5 * torch.randn(B, S, H, P, generator=g, device=dev)).to(dt)
    a = (-decay * torch.randn(B, S, H, generator=g, device=dev).abs()
         ).to(adt)
    if sliced:
        bc = (torch.randn(B, S, H * P + 2 * N, generator=g, device=dev)
              * N ** -0.25).to(dt)
        return x, a, bc[..., H * P:H * P + N], bc[..., H * P + N:]
    b = (torch.randn(B, S, N, generator=g, device=dev) * N ** -0.25).to(dt)
    c = (torch.randn(B, S, N, generator=g, device=dev) * N ** -0.25).to(dt)
    return x, a, b, c


def check_ssd(dev, peaks, g):
    """B5 against its plain version on fp32 copies of the inputs (the plain
    version of the model path rounds L and the states to x's dtype; the
    kernel keeps the state in fp32). b and c are scaled by N^-1/4 so a
    score C B^T has unit variance and |y| stays well below 16, where a
    bf16 output's own rounding (half an ulp, 0.0625) would exceed 5e-2.
    The main case is also timed by CUDA-graph replay, warm and cold."""
    bf, f32 = torch.bfloat16, torch.float32
    cases = [  # (name, B, S, H, P, N, chunk, dtype, a dtype, decay, sliced)
        ("main", MBATCH, MPROMPT, 32, 64, 128, 256, bf, f32, 0.3, True),
        ("contiguous", MBATCH, MPROMPT, 32, 64, 128, 256, bf, f32, 0.3,
         False),
        ("fp32", 2, 512, 8, 64, 128, 256, f32, f32, 0.3, False),
        ("one_chunk", 4, 256, 32, 64, 128, 256, bf, f32, 0.3, False),
        ("p32_n16", 2, 256, 16, 32, 16, 32, bf, bf, 0.3, False),
        ("p16_n8", 2, 128, 4, 16, 8, 16, f32, f32, 0.3, False),
        ("decay", 2, 1024, 8, 64, 128, 256, bf, f32, 4.0, False),
        ("sequential", 1, 128, 4, 64, 128, 64, f32, f32, 0.3, False),
        ("n64_c64", 2, 512, 4, 64, 64, 64, bf, f32, 0.3, False),
        ("n64_c128", 2, 512, 4, 64, 64, 128, bf, f32, 4.0, True),
        ("a_bf16", 2, 512, 8, 64, 128, 128, bf, bf, 0.3, False),
        ("chunk512", 1, 1024, 2, 64, 128, 512, bf, f32, 0.3, True),
        ("fp32_sliced", 2, 256, 4, 64, 128, 64, f32, f32, 0.3, True),
    ]
    out = []
    for name, B, S, H, P, N, chunk, dt, adt, decay, sliced in cases:
        x, a, b, c = _ssd_inputs(B, S, H, P, N, dt, adt, decay, g, dev,
                                 sliced)
        y, fin = ssd.ssd_scan(x, a, b, c, chunk)
        f32s = [t.float() for t in (x, a, b, c)]
        if name == "sequential":
            want = ref.ssd_sequential_ref(*f32s)
        else:
            want = ref.ssd_scan_ref(*f32s, chunk)
        torch.cuda.synchronize()
        err = max((got.float() - w).abs().max().item()
                  for got, w in zip((y, fin), want))
        rec = {"case": name, "shape": [B, S, H, P, N], "chunk": chunk,
               "dtype": str(dt), "a_dtype": str(adt), "decay": decay,
               "sliced": sliced, "route": ssd.route(P, N, chunk, dt),
               "max_err": err, "tol": TOL_SSD[dt],
               "max_abs_y": y.float().abs().max().item()}
        if name == "main":
            rec["ms"] = time_ms(lambda: ssd.ssd_scan(x, a, b, c, chunk),
                                iters=10)
            rec["plain_ms"] = time_ms(lambda: ref.ssd_scan_ref(
                x, a, b, c, chunk), iters=5)
            rec["library_ms"] = None      # no one PyTorch call computes it
            rec["device_ms"], rec["cold_ms"] = time_graph_warm_cold(
                lambda *t: ssd.ssd_scan(*t, chunk),
                lambda: _ssd_inputs(B, S, H, P, N, dt, adt, decay, g, dev,
                                    sliced))
            rec["library_cold_ms"] = None
            rec["bound_ms"], rec["bound_by"] = bound(
                peaks, nbytes(x, a, b, c, y, fin),
                ssd_ops(B, S, H, P, N, chunk), dt)
        out.append(rec)
    return out


def forked_tables(B, P, G, gen, ps):
    """The paged GRPO rollout's block tables at its last decode step:
    B prompts of P tokens, each forked into G rows that each appended
    gen - 1 tokens (``Rollout._generate_paged``'s page manager)."""
    nb = -(-(P + gen) // ps)
    pm = PageManager(B * (-(-P // ps)) + B * G * (nb - P // ps), ps)
    for b in range(B):
        pm.allocate(b * G, P)
        for g in range(1, G):
            pm.fork(b * G, b * G + g)
    for _ in range(gen - 1):
        for s in range(B * G):
            pm.append_token(s)
    return torch.from_numpy(pm.block_table_array(range(B * G), nb)), \
        pm.num_pages


def holey_tables(B, nb, ps, P, g):
    """Random distinct pages with -1 holes in the middle and at the end,
    rows 2i and 2i+1 sharing their first pages, a partial last page and an
    idle row (position -1)."""
    bt = torch.randperm(P, generator=g)[:B * nb].reshape(B, nb).int()
    for i in range(0, B - 1, 2):
        bt[i + 1, :nb // 2] = bt[i, :nb // 2]
    bt[0, 1] = -1
    bt[1, -1] = -1
    position = torch.randint(0, (nb - 1) * ps, (B,), generator=g)
    position[2] = nb * ps - 3
    position[-1] = -1
    return bt, position.int()


def paged_work(bt, position, ps, K, D, H, itemsize):
    """(bytes, operations) the paged decode needs on this data: each
    distinct page that holds a valid slot read once (k and v; a row with
    no valid slot needs the V of every page it names, for its uniform
    mean), q read and the output written once; 4*H*D operations per valid
    slot. Also the bytes with pages counted once per row that reads them,
    and the number of distinct pages."""
    nb = bt.shape[1]
    idx = torch.arange(nb * ps)
    valid = torch.repeat_interleave(bt >= 0, ps, dim=1) & \
        (idx[None] <= position[:, None])
    page_valid = valid.reshape(-1, nb, ps).any(-1)            # [B, nb]
    needed = bt[page_valid]
    idle = bt[~page_valid.any(1)].clamp(min=0)
    page_kv = 2 * ps * K * D * itemsize
    io = 2 * len(position) * H * D * itemsize + 4 * (bt.numel() +
                                                     position.numel())
    unique = needed.unique().numel()
    n_bytes = unique * page_kv + idle.unique().numel() * page_kv // 2 + io
    row_bytes = needed.numel() * page_kv + idle.numel() * page_kv // 2 + io
    return n_bytes, 4 * H * D * int(valid.sum()), row_bytes, unique


# B4's three tables at the main shape, the yardstick of its redesign
PAGED_TABLES = ("forked", "distinct", "same")


def main_tables(kind):
    """Block tables of the paged GRPO rollout's last decode step (64 rows of
    36 pages at position 566) and the pool's page count: ``forked`` is the
    rollout's own (8 groups of 8 rows sharing a prompt's first 31 pages),
    ``distinct`` puts every row on 36 pages of its own, ``same`` all rows
    on one row's 36 pages. Each pool has one more page, the rollout's drop
    page."""
    if kind == "forked":
        bt, P = forked_tables(GROUPS, GPROMPT, GSIZE, GEN, PAGE)
        return bt, P + 1
    B, nb = GROUPS * GSIZE, -(-(GPROMPT + GEN) // PAGE)
    if kind == "distinct":
        return torch.arange(B * nb, dtype=torch.int32).reshape(B, nb), \
            B * nb + 1
    return torch.arange(nb, dtype=torch.int32).repeat(B, 1), nb + 1


def check_paged(dev, peaks, g):
    """B4 against its plain version: at the main shape over the forked,
    distinct and same tables (each timed by CUDA-graph replay, warm and
    cold, beside its bound, with its plan and the pages each block copies;
    the forked one also eagerly, with the plain version and the gather +
    SDPA yardstick), with ragged positions and an idle row inside a tile,
    and at edge cases (one forced split, holes, a tail of -1, an idle row,
    head_dim 64, G = 1 and 8, a tile of 5 rows, pages of 32 slots, fp32)."""
    cpu_g = torch.Generator().manual_seed(11)
    cases = [  # (name, B, H, K, D, ps, nb, P, dtype); nb None: main tables
        *[(kind, GROUPS * GSIZE, 24, 8, 128, PAGE, None, None,
           torch.bfloat16) for kind in PAGED_TABLES],
        *[(name, GROUPS * GSIZE, 24, 8, 128, PAGE, None, None,
           torch.bfloat16) for name in ("ragged", "idle_row")],
        # the block normalises its rows itself, with no merge
        ("one_split", 16, 24, 8, 128, 16, 30, 481, torch.bfloat16),
        ("holes", 8, 24, 8, 128, 16, 6, 49, torch.bfloat16),
        ("b13", 13, 24, 8, 128, 16, 9, 118, torch.bfloat16),
        ("ps32", 8, 24, 8, 128, 32, 5, 41, torch.bfloat16),
        ("d64", 6, 8, 2, 64, 16, 5, 31, torch.bfloat16),
        ("k_eq_h", 4, 8, 8, 128, 8, 7, 29, torch.bfloat16),
        ("k1_fp32", 5, 8, 1, 128, 4, 9, 46, torch.float32),
        ("fp32_d64", 4, 6, 2, 64, 16, 6, 25, torch.float32),
    ]
    out = []
    for name, B, H, K, D, ps, nb, P, dt in cases:
        if nb is None:
            bt, P = main_tables(name if name in PAGED_TABLES else "forked")
            position = torch.full((B,), GPROMPT + GEN - 2, dtype=torch.int32)
            if name == "ragged":                  # one row per decode step
                position = GPROMPT + torch.arange(B, dtype=torch.int32) % (
                    GEN - 1)
            if name == "idle_row":                # walks all 36 pages alone
                position[13] = -1
        else:
            bt, position = holey_tables(B, nb, ps, P, cpu_g)
        q = torch.randn(B, H, D, generator=g, device=dev).to(dt)
        kp = torch.randn(P, ps, K, D, generator=g, device=dev).to(dt)
        vp = torch.randn(P, ps, K, D, generator=g, device=dev).to(dt)
        bt, position = bt.to(dev), position.to(dev)
        got = pa.paged_decode_attention(
            q, kp, vp, bt, position,
            splits=1 if name == "one_split" else None)
        want = ref.paged_attention_ref(q, kp, vp, bt, position)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rec = {"case": name, "shape": [B, H, K, D, P, ps, bt.shape[1]],
               "dtype": str(dt), "max_err": err, "tol": TOL[dt]}
        if name in PAGED_TABLES:
            n_bytes, n_ops, row_bytes, n_pages = paged_work(
                bt.cpu(), position.cpu(), ps, K, D, H, q.element_size())
            rec["bound_ms"], rec["bound_by"] = bound(peaks, n_bytes, n_ops,
                                                     dt)
            rec.update(unique_pages=n_pages, unique_mib=n_bytes / 2**20,
                       per_row_mib=row_bytes / 2**20)
            pl = pa.plan(B, K, bt.shape[1])
            loads = pa.block_loads(bt, position, ps, pl)
            rec.update(plan=pl._asdict(), page_loads=int(loads.sum()),
                       block_loads_max=int(loads.max()),
                       block_loads_mean=loads.float().mean().item())

            def make_set():
                return tuple(torch.randn(*t.shape, device=dev).to(dt)
                             for t in (q, kp, vp))
            rec["device_ms"], rec["cold_ms"] = time_graph_warm_cold(
                lambda q_, k_, v_: pa.paged_decode_attention(
                    q_, k_, v_, bt, position), make_set)
        if name == "forked":
            rec["ms"] = time_ms(lambda: pa.paged_decode_attention(
                q, kp, vp, bt, position), iters=50)
            rec["plain_ms"] = time_ms(lambda: ref.paged_attention_ref(
                q, kp, vp, bt, position))
            # no one PyTorch call computes this function; gather + SDPA is
            # a two-call yardstick, not the library column
            idx = torch.arange(bt.shape[1] * ps, device=dev)
            valid = torch.repeat_interleave(bt >= 0, ps, dim=1) & \
                (idx[None] <= position[:, None])
            mask = valid[:, None, None, :]

            def yardstick():
                k, v = gather_kv({"k": kp, "v": vp}, bt)
                return _gqa_sdpa(q[:, None], k, v, attn_mask=mask)

            rec["yardstick_ms"] = time_ms(yardstick)
            rec["library_ms"] = None
        out.append(rec)
    return out


# ---------------------------------------------------------------- phase 4
def check_result(res, rows, prompt, vocab):
    if res.tokens.shape != (rows, prompt + GEN):
        raise SystemExit(f"bad result shape {tuple(res.tokens.shape)}")
    gen = res.tokens[:, prompt:]
    lp = res.logp[:, prompt:]
    if not (int(gen.min()) >= 0 and int(gen.max()) < vocab):
        raise SystemExit("generated token out of the vocabulary")
    if not (torch.isfinite(lp).all() and (lp <= 1e-6).all()):
        raise SystemExit("bad logp")
    if float(res.mask[:, prompt:].min()) != 1.0:
        raise SystemExit("bad mask")


def check_outputs(results, vocab):
    for r in results:
        check_result(r["result"], BATCH, PROMPT, vocab)


# ---------------------------------------------------------------- phase 5
def _req(fn):
    """Run one generate call; (result, seconds, peak bytes allocated above
    what was live before it)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, \
        torch.cuda.max_memory_allocated() - base


def paged_grpo(cfg, dev, log, profile=False):
    """Phase 5: the paged GRPO rollout at full width and depth, checked
    launch for launch, against one dense request of the repeated prompts.
    Returns the report and the launch counts of the paged requests; with
    ``profile``, also a profile of one more paged request."""
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    weights = torch.cuda.memory_allocated()
    data = PromptDataset(synthetic_instruction_prompts(
        GROUPS * GREQUESTS, seed=0), GPROMPT).batches(GROUPS, seed=0)
    prompts = [torch.from_numpy(next(data) % cfg.vocab_size).long().to(dev)
               for _ in range(GREQUESTS)]
    gen_kw = dict(temperature=0.8, top_k=serve.TOP_K)
    paged = Rollout(model, cfg, capacity=GPROMPT + GEN, backend="paged",
                    page_size=PAGE, **gen_kw)
    L = cfg.num_layers
    # rmsnorm: + 1 for the group's replicated unembedding after the prefill
    per_request = {"rmsnorm": (2 * L + 1) * GEN + 1, "flash_attention": L,
                   "decode_attention": 0,
                   "paged_decode_attention": L * (GEN - 1), "ssd_scan": 0,
                   "flash_attention_bwd": 0, "rmsnorm_bwd": 0}
    rows = GROUPS * GSIZE
    reqs = []
    torch.cuda.synchronize()
    ops.reset_launches()
    for r, ids in enumerate(prompts):
        before = dict(ops.launches)
        res, secs, peak = _req(lambda: paged.generate(
            params, {"tokens": ids}, GEN,
            torch.Generator(device=dev).manual_seed(r + 1),
            group_size=GSIZE))
        made = {k: ops.launches[k] - before[k] for k in ops.KERNELS}
        if made != per_request:
            raise SystemExit(f"paged request {r}: launches {made} != "
                             f"{per_request}")
        st = paged.page_manager.stats
        if st.n_forks != GROUPS * (GSIZE - 1) or st.pages_in_use != 0:
            raise SystemExit(f"paged request {r}: page stats {st}")
        check_result(res, rows, GPROMPT, cfg.vocab_size)
        page_peak = st.peak_pages_in_use * paged.page_manager.page_bytes
        reqs.append({"seconds": secs, "tokens_per_s": rows * GEN / secs,
                     "peak_above_weights": peak, "page_peak_bytes": page_peak,
                     "num_pages": st.num_pages, "cow_copies": st.n_cow_copies,
                     "forks": st.n_forks, "result": res})
        log(f"[smoke] paged request {r}: {secs * 1e3:.1f} ms "
            f"({rows * GEN / secs:.1f} tok/s), peak {peak / 2**20:.1f} MiB "
            f"above the weights, page peak {st.peak_pages_in_use} pages = "
            f"{page_peak / 2**20:.1f} MiB, {st.n_cow_copies} CoW copies")
    torch.cuda.synchronize()
    launches = dict(ops.launches)

    # the same prompts through the dense backend, repeated to 64 rows
    dense = Rollout(model, cfg, capacity=GPROMPT + GEN, **gen_kw)
    res_d, secs_d, peak_d = _req(lambda: dense.generate(
        params, {"tokens": prompts[0]}, GEN,
        torch.Generator(device=dev).manual_seed(1), group_size=GSIZE))
    check_result(res_d, rows, GPROMPT, cfg.vocab_size)
    log(f"[smoke] dense repeat: {secs_d * 1e3:.1f} ms "
        f"({rows * GEN / secs_d:.1f} tok/s), peak {peak_d / 2**20:.1f} MiB "
        f"above the weights")
    if not reqs[0]["peak_above_weights"] < peak_d:
        raise SystemExit(f"paged fork peak {reqs[0]['peak_above_weights']} "
                         f"not below the dense repeat's {peak_d}")

    # the first sampled step, read from the two timed results: the same
    # generator seed and, to bf16 rounding, the same logits (cuBLAS may pick
    # other kernels for the 8 x 504 and 64 x 504 prefills) give the same
    # first tokens and log-probs
    res_f = reqs[0]["result"]
    same_first = torch.equal(res_f.tokens[:, GPROMPT],
                             res_d.tokens[:, GPROMPT])
    lp_f, lp_d = res_f.logp[:, GPROMPT].float(), res_d.logp[:, GPROMPT].float()
    err = (lp_f - lp_d).abs().max().item()
    scale = lp_d.abs().max().item()
    same_all = (res_f.tokens[:, GPROMPT:] == res_d.tokens[:, GPROMPT:]
                ).float().mean().item()
    log(f"[smoke] fork vs repeat, first step: tokens identical {same_first}, "
        f"logp max_err {err:.3e} (max |logp| {scale:.3f}); {same_all:.3f} of "
        f"all {GEN} steps' tokens identical")
    if not same_first:
        raise SystemExit("fork vs repeat: first sampled tokens differ")
    if not err <= TOL[torch.bfloat16] * max(1.0, scale):
        raise SystemExit(f"fork vs repeat first-step logp differ by {err}")
    for r in reqs:
        del r["result"]
    out = {}
    if profile:
        out["profile"], out["profile_table"] = profile_call(
            lambda: paged.generate(params, {"tokens": prompts[0]}, GEN,
                                   torch.Generator(device=dev).manual_seed(1),
                                   group_size=GSIZE))
    return {**out, "requests": reqs, "weights_bytes": weights,
            "dense": {"seconds": secs_d, "tokens_per_s": rows * GEN / secs_d,
                      "peak_above_weights": peak_d},
            "first_step_logp_max_err": err, "max_abs_logp": scale,
            "same_first_tokens": same_first, "same_tokens": same_all,
            "launches": launches}


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device, copy=True)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return [_to(v, device) for v in tree]


def check_small_model_against_cpu(dev, cfg=None, prompt=40, seed=3):
    """A small model (default: a GQA smoke model, G = 2, head_dim 64, f32)
    on the card through the kernels vs the same weights on the CPU through
    the plain versions: prefill logits within 1e-4 and 16 greedy tokens
    identical."""
    if cfg is None:
        cfg = dataclasses.replace(get_config("llama3_2_3b").smoke(),
                                  num_kv_heads=2)
    cpu_model = Model(cfg, device="cpu")
    params = cpu_model.init(torch.Generator().manual_seed(seed))
    gpu_model = Model(cfg, device=dev)
    gparams = _to(params, dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, prompt),
                           generator=torch.Generator().manual_seed(seed + 1))
    results = []
    for model, p, device in ((cpu_model, params, "cpu"),
                             (gpu_model, gparams, dev)):
        ro = Rollout(model, cfg, capacity=prompt + 24, temperature=0.0)
        logits, _ = model.prefill(p, {"tokens": tokens.to(device)},
                                  prompt + 24)
        res = ro.generate(p, {"tokens": tokens.to(device)}, 16,
                          torch.Generator(device=device))
        results.append((logits.cpu(), res.tokens.cpu()))
    err = (results[0][0] - results[1][0]).abs().max().item()
    assert err <= 1e-4, f"small model prefill logits differ by {err}"
    assert torch.equal(results[0][1], results[1][1]), "greedy tokens differ"
    return err


def time_split(model, params, batch, prompt):
    """Unprofiled prefill time and mean decode-step time (host clock,
    synchronised; greedy) of one request, after a warm-up request."""
    dev = model.device
    ro = Rollout(model, model.cfg, capacity=prompt + GEN, temperature=0.8,
                 top_k=serve.TOP_K)
    toks = torch.randint(0, 256, (batch, prompt), device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    ro.generate(params, {"tokens": toks}, GEN, g)      # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, {"tokens": toks}, prompt + GEN)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tok = torch.argmax(logits, -1)
    for t in range(GEN - 1):
        pos = torch.full((batch,), prompt + t, dtype=torch.int32, device=dev)
        logits, caches = model.decode_step(params, caches, tok, pos)
        tok = torch.argmax(logits, -1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del caches
    return ro, toks, g, {"prefill_ms": (t1 - t0) * 1e3,
                         "decode_step_ms": (t2 - t1) * 1e3 / (GEN - 1)}


def profile_request(cfg, dev):
    """Where one request's time goes: prefill and per-decode-step wall
    time (host clock, synchronised), then kernel time by name over one
    whole request (torch.profiler; kernel events only, so the device's
    busy time is the sum of its kernels)."""
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    ro, toks, g, split = time_split(model, params, BATCH, PROMPT)
    prof, table = profile_call(lambda: ro.generate(params, {"tokens": toks},
                                                   GEN, g))
    prof.update(split)
    return prof, table


def mamba_serving(dev, log, profile=False):
    """Phase 6: mamba2_370m at full width and depth through serve.run, 3
    requests of 8 x (2048 + 64); launch counts asserted (B5 once per
    layer in each prefill, B1 at norm1 and the gated norm of each layer
    and the final norm, every step), outputs checked; then the prefill
    and decode step timed apart on a model of its own (with ``profile``,
    also one profiled request) and a small Mamba model on the card
    against the CPU."""
    cfg = get_config("mamba2_370m")
    torch.cuda.synchronize()
    ops.reset_launches()
    results = serve.run(cfg, batch=MBATCH, prompt_len=MPROMPT, gen=GEN,
                        requests=MREQUESTS, temperature=0.8, seed=0,
                        device=dev, log=log)
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    L = cfg.num_layers
    want = {"flash_attention": 0, "decode_attention": 0,
            "paged_decode_attention": 0, "ssd_scan": L * MREQUESTS,
            "rmsnorm": (2 * L + 1) * GEN * MREQUESTS,
            "flash_attention_bwd": 0, "rmsnorm_bwd": 0}
    log(f"[smoke] mamba launches {launches} (want {want})")
    if launches != want:
        raise SystemExit(f"mamba launch counts {launches} != {want}")
    reqs = []
    for r in results:
        check_result(r["result"], MBATCH, MPROMPT, cfg.vocab_size)
        # live after the request is the weights (the states were dropped)
        above = r["peak_bytes"] - r["live_bytes"]
        reqs.append({"seconds": r["seconds"],
                     "tokens_per_s": r["tokens_per_s"],
                     "live_bytes": r["live_bytes"],
                     "peak_bytes": r["peak_bytes"],
                     "peak_above_weights": above})
        log(f"[smoke] mamba request: {r['seconds'] * 1e3:.1f} ms "
            f"({r['tokens_per_s']:.1f} tok/s), peak {above / 2**20:.1f} MiB "
            f"above the weights ({r['live_bytes'] / 2**20:.1f} MiB live)")
    del results
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    ro, toks, g, split = time_split(model, params, MBATCH, MPROMPT)
    log(f"[smoke] mamba unprofiled: prefill {split['prefill_ms']:.1f} ms, "
        f"decode {split['decode_step_ms']:.2f} ms/step (greedy)")
    out = {"requests": reqs, "launches": launches, **split}
    if profile:
        out["profile"], out["profile_table"] = profile_call(
            lambda: ro.generate(params, {"tokens": toks}, GEN, g))
    del model, params, ro
    small = get_config("mamba2_370m").smoke()
    out["small_model_max_err"] = check_small_model_against_cpu(
        dev, small, prompt=64, seed=5)
    log(f"[smoke] small Mamba model card vs CPU: logits max_err "
        f"{out['small_model_max_err']:.3e}, 16 greedy tokens identical")
    return out


# ---------------------------------------------------------------- phase 7
def ppo_launches(cfg, rl, model_reward: bool, critic_cfg=None) -> dict:
    """Kernel launches of one PPO iteration, reckoned from the shapes
    (ppo_epochs updates of each role). ``cfg`` is the actor's; on the
    separate engine the reward model, the values and the critic's step
    run ``critic_cfg``'s depth (the hydra engine's roles all run the one
    trunk).
    - rollout: B2 once a layer (prefill), B3 once a layer at each of the
      gen - 1 decode steps, B1 at norm1, norm2 and the final norm of the
      prefill and each step: (2L + 1) gen;
    - each scoring forward (reward if a model scores, ref, values, old
      logp): B2 L, B1 2L + 1;
    - each training step (actor, critic): the forward (B2 L, B1 2L + 1);
      with remat other than "none" ("full", "dots", "offload") each
      layer's forward again inside the backward (B2 L, B1 2L; the final
      norm is outside the checkpoints); the
      backward: B2-bwd L and B1-bwd at every norm whose input or scale
      trains: 2L + 1 on the separate engine, where every leaf trains, 2L
      on the hydra engine (the final norm, every norm2 and the norm1 of
      layers 1 .. L-1: layer 0's norm1 reads the frozen embedding with a
      frozen scale, so no gradient reaches it)."""
    separate = rl.engine == "separate"
    actor = (cfg.num_layers, cfg.remat != "none")
    other = critic_cfg if separate and critic_cfg is not None else cfg
    critic = (other.num_layers, other.remat != "none")
    scored = [actor, actor, critic] + ([critic] if model_reward else [])
    trained = [actor, critic] * rl.ppo_epochs
    La, gen = cfg.num_layers, rl.gen_len
    want = {k: 0 for k in ops.KERNELS}
    want["flash_attention"] = La + sum(L for L, _ in scored) + \
        sum(L * (1 + remat) for L, remat in trained)
    want["decode_attention"] = La * (gen - 1)
    want["rmsnorm"] = (2 * La + 1) * gen + \
        sum(2 * L + 1 for L, _ in scored) + \
        sum(2 * L + 1 + remat * 2 * L for L, remat in trained)
    want["flash_attention_bwd"] = sum(L for L, _ in trained)
    want["rmsnorm_bwd"] = sum(2 * L + separate for L, _ in trained)
    return want


PPO_KW = dict(engine="hydra", lora_rank=128, prompt_len=PPROMPT,
              gen_len=GEN, kl_coef=0.1, temperature=1.0, top_k=50,
              ppo_epochs=1)


def _phase_rows(records, weights):
    """Per-phase ms and live/reserved/peak MiB above the weights."""
    return [{"phase": r["phase"], "kind": r["kind"],
             "ms": r["seconds"] * 1e3,
             "hygiene_ms": r.get("hygiene_seconds", 0.0) * 1e3,
             "live_mib": (r["live_bytes"] - weights) / 2**20,
             "reserved_mib": (r["reserved_bytes"] - weights) / 2**20,
             "peak_mib": (r["peak_bytes"] - weights) / 2**20}
            for r in records]


def _print_phases(label, rows, log):
    log(f"[smoke] {label}: phase ms (of which boundary gc + empty_cache) "
        f"/ MiB above the weights (live, reserved, peak)")
    for r in rows:
        log(f"  {r['phase']:16s} {r['ms']:9.1f} ms ({r['hygiene_ms']:7.1f}) "
            f"{r['live_mib']:9.1f} {r['reserved_mib']:9.1f} "
            f"{r['peak_mib']:9.1f}")


def _requested() -> int:
    """Bytes the caching allocator was asked for and holds, unrounded."""
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


def _fresh(make):
    """(what ``make()`` builds, the bytes it leaves allocated, the bytes
    it asked the allocator for)."""
    gc.collect()
    torch.cuda.synchronize()
    before, asked = torch.cuda.memory_allocated(), _requested()
    obj = make()
    torch.cuda.synchronize()
    return (obj, torch.cuda.memory_allocated() - before,
            _requested() - asked)


def _run_ppo(tr, prompts, g, want, label, n_records):
    """One asserted PPO iteration: launches as reckoned, finite metrics;
    -> (seconds, metrics, launches, its ``n_records`` phase records)."""
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    m = tr.train_step(prompts, g)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    made = dict(ops.launches)
    if made != want:
        raise SystemExit(f"{label}: launches {made} != {want}")
    if not all(math.isfinite(v) for v in m.values()):
        raise SystemExit(f"{label}: metrics {m}")
    return secs, m, made, tr.memory.records[-n_records:]


def _trainer(cfg, dev, policy, seed=0):
    """A fresh trainer and the bytes its persistent state holds (trunk,
    adapters, AdamW moments): what the records are read above."""
    return _fresh(lambda: RLHFTrainer(
        cfg, cfg, RLHFConfig(memory_policy=policy, **PPO_KW),
        torch.Generator(device=dev).manual_seed(seed)))[:2]


def ppo_iterations(dev, log, profile=False):
    """Phase 7: PITERS hydra PPO iterations of full llama3_2_3b (28
    layers, rank-128 adapters on all seven projections, 8 x (512 + 64)),
    the reward adapter scoring, remat="full": every phase runs the model.
    Asserts the launches of all seven counters per iteration, finite
    losses, a trunk unchanged bit for bit and moved adapters; prints each
    phase's ms and memory; then one iteration of a fresh trainer under
    memory_policy="none"; then a small model's 2 greedy fp32 PPO steps
    on the card against the CPU."""
    cfg = get_config("llama3_2_3b")
    tr, weights = _trainer(cfg, dev, "after_inference")
    want = ppo_launches(cfg, tr.rl, model_reward=True)
    log(f"[smoke] ppo: trunk {tr.engine.base_param_count() / 1e6:.1f}M "
        f"params, adapter {tr.engine.adapter_param_count('actor') / 1e6:.1f}M"
        f" (actor), persistent {weights / 2**30:.2f} GiB")
    trunk = [t.cpu() for t in leaves(tr.base_params)]
    adapters = {role: [t.detach().cpu() for t in
                       leaves(tr.engine.adapters[role])]
                for role in ("actor", "critic")}
    data = PromptDataset(synthetic_instruction_prompts(
        PBATCH * PITERS, seed=1), PPROMPT).batches(PBATCH, seed=1)
    g = torch.Generator(device=dev).manual_seed(7)
    iters = []
    launches = None
    for it in range(PITERS):
        prompts = torch.from_numpy(next(data) % cfg.vocab_size).long().to(dev)
        secs, m, launches, recs = _run_ppo(tr, prompts, g, want,
                                           f"ppo iteration {it}", 8)
        rows = _phase_rows(recs, weights)
        _print_phases(f"ppo iteration {it} ({secs * 1e3:.1f} ms)", rows, log)
        log(f"[smoke] ppo iteration {it}: " + ", ".join(
            f"{k} {v:.4g}" for k, v in sorted(m.items())))
        iters.append({"seconds": secs, "metrics": m, "phases": rows})
    for a, b in zip(trunk, leaves(tr.base_params)):
        if not torch.equal(a, b.cpu()):
            raise SystemExit("ppo: the frozen trunk moved")
    for role, before in adapters.items():
        if all(torch.equal(a, b.detach().cpu()) for a, b in
               zip(before, leaves(tr.engine.adapters[role]))):
            raise SystemExit(f"ppo: the {role} adapter did not move")
    log(f"[smoke] ppo launches per iteration {launches} (want {want}); "
        f"trunk unchanged, actor and critic adapters moved")
    out = {"iterations": iters, "launches": launches,
           "weights_bytes": weights}
    if profile:
        prompts = torch.from_numpy(next(PromptDataset(
            synthetic_instruction_prompts(PBATCH, seed=2), PPROMPT).batches(
                PBATCH, seed=2)) % cfg.vocab_size).long().to(dev)
        out["profile"], out["profile_table"] = profile_call(
            lambda: tr.train_step(prompts, g))
    del tr, trunk, adapters
    gc.collect()
    torch.cuda.empty_cache()

    # the paper's boundary empty_cache, on the real allocator: the same
    # iteration with no hygiene at the boundaries
    tr, weights = _trainer(cfg, dev, "none")
    prompts = torch.from_numpy(next(PromptDataset(
        synthetic_instruction_prompts(PBATCH, seed=1), PPROMPT).batches(
            PBATCH, seed=1)) % cfg.vocab_size).long().to(dev)
    tr.train_step(prompts, g)
    rows = _phase_rows(tr.memory.records[-8:], weights)
    _print_phases("ppo iteration, memory_policy=none", rows, log)
    out["policy_none"] = rows
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    out["small_model"] = check_small_ppo_against_cpu(dev)
    log(f"[smoke] small model PPO card vs CPU: greedy tokens identical, "
        f"metrics max_err {out['small_model']['max_err']:.3e}")
    return out


def check_small_ppo_against_cpu(dev, steps=2, tol=1e-4, engine="hydra"):
    """2 greedy fp32 PPO steps of a small model on the card and on the CPU
    from the same weights: the same greedy tokens, and the metrics within
    ``tol`` (fp32 sums in another order). Hydra: the reference tests'
    small config, remat="full" and the reward adapter, so every kernel and
    its backward runs. Separate: the paper pair's shape (MHA, qkv biases,
    a GELU MLP, tied embeddings), an actor of d_model 128 (remat="none")
    and a critic of 64 (remat="full"), heads of 64, every leaf trained,
    the reward model scoring."""
    small = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=64,
                 num_heads=4, head_dim=64, remat="full")
    kw = dict(prompt_len=8, gen_len=8, temperature=0.0, top_k=0)
    if engine == "hydra":
        cfg = dataclasses.replace(get_config("llama3_2_3b").smoke(),
                                  num_kv_heads=2, **small)
        rl = RLHFConfig(engine="hydra", lora_rank=4, lr=3e-3,
                        critic_lr=3e-3, **kw)
        cpu = RLHFTrainer(cfg, cfg, rl, torch.Generator().manual_seed(0))
        eng = cpu.engine
        card = RLHFTrainer(cfg, cfg, rl, engine=ModelEngine(
            cfg, None, rank=rl.lora_rank,
            base_params=_to(eng.base_params, dev),
            adapters={r: _to(a, dev) for r, a in eng.adapters.items()}))
    else:
        cfg = dataclasses.replace(get_config(SEP_CRITIC).smoke(),
                                  num_kv_heads=4, **small)
        actor = dataclasses.replace(get_config(SEP_ACTOR).smoke(),
                                    **{**small, "num_kv_heads": 4,
                                       "d_model": 128, "d_ff": 256,
                                       "remat": "none"})
        rl = RLHFConfig(engine="separate", lr=1e-3, critic_lr=1e-3, **kw)
        cpu = RLHFTrainer(actor, cfg, rl, torch.Generator().manual_seed(0))
        card = RLHFTrainer(actor, cfg, rl, params={
            "actor": _to(cpu.actor_state["params"], dev),
            "critic": _to(cpu.critic_state["params"], dev)})
    prompts = torch.randint(0, cfg.vocab_size, (4, rl.prompt_len),
                            generator=torch.Generator().manual_seed(1))
    got = {}
    for name, tr in (("cpu", cpu), ("card", card)):
        toks, gen = [], tr._gen

        def spy(p, gg, gen=gen, toks=toks):
            ro = gen(p, gg)
            toks.append(ro.tokens.cpu())
            return ro
        tr._gen = spy
        ms = [tr.train_step(prompts.to(tr.device),
                            torch.Generator(device=tr.device))
              for _ in range(steps)]
        got[name] = (toks, ms)
    if not all(torch.equal(a, b) for a, b in zip(got["cpu"][0],
                                                  got["card"][0])):
        raise SystemExit(f"small {engine} PPO: greedy tokens differ card vs "
                         "CPU")
    err = max(abs(a[k] - b[k]) for a, b in zip(got["cpu"][1], got["card"][1])
              for k in a)
    if not err <= tol:
        raise SystemExit(f"small {engine} PPO: metrics differ by {err}: "
                         f"{got}")
    return {"max_err": err, "tol": tol, "metrics": got["card"][1]}


# ---------------------------------------------------------------- phase 8
SEP_KW = dict(prompt_len=SPROMPT, gen_len=SGEN, kl_coef=0.1,
              temperature=1.0, top_k=50, ppo_epochs=1)


def _separate_trainer(dev, policy, seed=0):
    actor, critic = get_config(SEP_ACTOR), get_config(SEP_CRITIC)
    return _fresh(lambda: RLHFTrainer(
        actor, critic, RLHFConfig(engine="separate", memory_policy=policy,
                                  **SEP_KW),
        torch.Generator(device=dev).manual_seed(seed)))


def _sep_prompts(dev, seed, vocab):
    return torch.from_numpy(next(PromptDataset(synthetic_instruction_prompts(
        SBATCH, seed=seed), SPROMPT).batches(SBATCH, seed=seed)) % vocab
    ).long().to(dev)


def _accounting_gb(acc):
    """{layout: {"state": params + opt, "grad": ...}} in GB (1e9 bytes)."""
    return {layout: {"state": sum(r["params"] + r["opt"]
                                  for r in roles.values()) / 1e9,
                     "grad": sum(r["grad"] for r in roles.values()) / 1e9}
            for layout, roles in acc.items()}


def _norm_scales(params):
    """The norm scales of a model's tree: the final norm and every layer's
    norm1 and norm2."""
    return [params["final_norm"]["scale"]] + [
        layer[n]["scale"] for layer in params["layers"]
        for n in ("norm1", "norm2") if n in layer]


def _unmoved(tr, before):
    """{role: the number of norm scales equal to ``before``'s copies};
    raises if a trained leaf's first moment is zero (no gradient reached
    it) or if a leaf other than a norm scale did not move."""
    still = {}
    for role, copies in before.items():
        state = getattr(tr, role + "_state")
        scales = {id(t) for t in _norm_scales(state["params"])}
        for i, (a, b, mu) in enumerate(zip(copies, leaves(state["params"]),
                                           leaves(state["opt"]["mu"]))):
            if not mu.any():
                raise SystemExit(f"separate: {role} leaf {i} "
                                 f"{tuple(a.shape)} got no gradient")
            if torch.equal(a, b.detach().cpu()):
                if id(b) not in scales:
                    raise SystemExit(f"separate: {role} leaf {i} "
                                     f"{tuple(a.shape)} did not move")
                still[role] = still.get(role, 0) + 1
    return still


def separate_ppo(dev, log, profile=False):
    """Phase 8: the paper's four-model PPO (engine="separate") on its own
    pair, full width and depth, bf16: SITERS iterations under
    ``after_inference`` with the launches of all seven counters asserted
    (``ppo_launches`` from each config's depth), finite metrics, the
    reference and reward models unchanged bit for bit, every actor and
    critic leaf given a gradient and moved (a bf16 norm scale of 1.0
    cannot move at lr 1e-5: its step is below half a bf16 ulp), the
    persistent bytes equal to the six trees' ``nbytes``; each phase's ms
    and memory printed; then one iteration of a fresh trainer under
    ``none``; one hydra iteration of the actor's config at the same shape
    (the repo's alleviation beside the paper's layout); the ported
    ``memory_accounting`` of llama3_2_3b (whose separate layout does not
    fit the card); and a small model's 2 greedy fp32 separate iterations
    on the card against the CPU."""
    actor_cfg, critic_cfg = get_config(SEP_ACTOR), get_config(SEP_CRITIC)
    tr, weights, asked = _separate_trainer(dev, "after_inference")
    trees = tr.persistent_trees()
    tree_bytes = tree_nbytes(trees)
    sizes = [t.numel() * t.element_size() for t in leaves(trees)]
    # the caching allocator rounds every block up to 512 bytes, and gives a
    # block above 1 MiB its whole free block when no more than 1 MiB would
    # be left over
    slack = 512 * len(sizes) + 2**20 * sum(n > 2**20 for n in sizes)
    if asked != tree_bytes or not 0 <= weights - tree_bytes <= slack:
        raise SystemExit(f"separate: {asked} bytes asked, {weights} "
                         f"allocated for a state of {tree_bytes} "
                         f"({len(sizes)} tensors)")
    count = lambda t: sum(x.numel() for x in leaves(t))  # noqa: E731
    log(f"[smoke] separate: actor {count(trees['actor_params']) / 1e6:.1f}M "
        f"params, critic {count(trees['critic_params']) / 1e6:.1f}M; "
        f"persistent {asked} bytes asked of the allocator ({weights} "
        f"allocated), six trees {tree_bytes} bytes, "
        f"{tree_bytes / 1e9:.3f} GB (" + ", ".join(
            f"{k} {tree_nbytes(v) / 1e9:.3f}" for k, v in trees.items()) + ")")
    want = ppo_launches(actor_cfg, tr.rl, model_reward=True,
                        critic_cfg=critic_cfg)
    frozen = [t.to("cpu", copy=True)
              for t in leaves([tr.ref_params, tr.reward_params])]
    trained = {role: [t.detach().to("cpu", copy=True) for t in
                      leaves(getattr(tr, role + "_state")["params"])]
               for role in ("actor", "critic")}
    g = torch.Generator(device=dev).manual_seed(7)
    iters, launches = [], None
    for it in range(SITERS):
        secs, m, launches, recs = _run_ppo(
            tr, _sep_prompts(dev, 1 + it, actor_cfg.vocab_size), g, want,
            f"separate iteration {it}", 7)
        rows = _phase_rows(recs, weights)
        _print_phases(f"separate iteration {it} ({secs * 1e3:.1f} ms)", rows,
                      log)
        log(f"[smoke] separate iteration {it}: " + ", ".join(
            f"{k} {v:.4g}" for k, v in sorted(m.items())))
        iters.append({"seconds": secs, "metrics": m, "phases": rows})
    if not all(torch.equal(a, b.cpu()) for a, b in
               zip(frozen, leaves([tr.ref_params, tr.reward_params]))):
        raise SystemExit("separate: the reference or reward model moved")
    still = _unmoved(tr, trained)
    log(f"[smoke] separate launches per iteration {launches} (want {want}); "
        f"ref and reward unchanged, every actor and critic leaf given a "
        f"gradient and moved but " + ", ".join(
            f"{v} {k} norm scales" for k, v in still.items()))
    out = {"iterations": iters, "launches": launches,
           "weights_bytes": weights, "requested_bytes": asked,
           "tree_bytes": tree_bytes,
           "tree_bytes_by_name": {k: tree_nbytes(v) for k, v in trees.items()},
           "unmoved": still}
    if profile:
        prompts = _sep_prompts(dev, 9, actor_cfg.vocab_size)
        out["profile"], out["profile_table"] = profile_call(
            lambda: tr.train_step(prompts, g))
    del tr, trees, frozen, trained
    gc.collect()
    torch.cuda.empty_cache()

    tr, weights, _ = _separate_trainer(dev, "none")
    _, _, _, recs = _run_ppo(tr, _sep_prompts(dev, 1, actor_cfg.vocab_size),
                             g, want, "separate, policy none", 7)
    out["policy_none"] = _phase_rows(recs, weights)
    _print_phases("separate iteration, memory_policy=none",
                  out["policy_none"], log)
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    # the repo's alleviation at the same shape: one hydra iteration of the
    # actor's config (rank 128, the reward adapter scoring)
    rl = RLHFConfig(engine="hydra", lora_rank=128, **SEP_KW)
    tr, weights, asked = _fresh(lambda: RLHFTrainer(
        actor_cfg, actor_cfg, rl,
        torch.Generator(device=dev).manual_seed(0)))
    secs, _, hydra_launches, recs = _run_ppo(
        tr, _sep_prompts(dev, 1, actor_cfg.vocab_size), g,
        ppo_launches(actor_cfg, rl, model_reward=True), "hydra opt_1_3b", 8)
    out["hydra"] = {"seconds": secs, "weights_bytes": weights,
                    "requested_bytes": asked,
                    "launches": hydra_launches,
                    "phases": _phase_rows(recs, weights),
                    "accounting": tr.engine.memory_accounting()}
    _print_phases(f"hydra {SEP_ACTOR} iteration ({secs * 1e3:.1f} ms; "
                  f"persistent {weights / 1e9:.3f} GB)",
                  out["hydra"]["phases"], log)
    log(f"[smoke] hydra {SEP_ACTOR} launches {hydra_launches}")
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    # the reference's accounting of llama3_2_3b: its separate layout does
    # not fit one 80 GB card before any activation
    eng, _, _ = _fresh(lambda: ModelEngine(
        get_config("llama3_2_3b"), torch.Generator(device=dev).manual_seed(0),
        rank=128))
    acc = eng.memory_accounting()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    out["llama3_2_3b_accounting"] = acc
    for layout, gb in _accounting_gb(acc).items():
        log(f"[smoke] llama3_2_3b {layout}: params + AdamW state "
            f"{gb['state']:.2f} GB, fp32 grads of the trained roles "
            f"{gb['grad']:.2f} GB (memory_accounting)")
    out["small_model"] = check_small_ppo_against_cpu(dev, engine="separate")
    log(f"[smoke] small separate PPO card vs CPU: greedy tokens identical, "
        f"metrics max_err {out['small_model']['max_err']:.3e}")
    return out


# ---------------------------------------------------------------- phase 9
# the offload levels phase 9 runs on the separate OPT pair (``none`` is the
# baseline, run twice to see whether the card repeats itself bit for bit)
OFFLOAD_RUNS = ("optimizer", "roles", "all")
REMAT_RUNS = ("full", "offload", "dots")


def meminfo() -> dict:
    """The host's MemTotal and MemAvailable in bytes (``/proc/meminfo``)."""
    out = {}
    for line in pathlib.Path("/proc/meminfo").read_text().splitlines():
        key, val = line.split(":", 1)
        if key in ("MemTotal", "MemAvailable"):
            out[key] = int(val.split()[0]) * 1024
    return out


def link_rate(dev) -> dict:
    """A 1 GiB copy each way between the card and pinned host memory (the
    parking lot's own kind of buffer), timed with CUDA events: the link's
    yardstick; the bound of a park or fetch is its bytes over this rate."""
    n = 1 << 30
    host = pinned_buffer(n)
    d = torch.empty(n, dtype=torch.uint8, device=dev)
    d2h = time_ms(lambda: host.copy_(d, non_blocking=True), iters=5, warmup=1)
    h2d = time_ms(lambda: d.copy_(host, non_blocking=True), iters=5, warmup=1)
    del host, d
    torch.cuda.empty_cache()
    return {"bytes": n, "d2h_ms": d2h, "h2d_ms": h2d,
            "d2h_GBps": n / d2h / 1e6, "h2d_GBps": n / h2d / 1e6}


def _offload_rows(records, state_bytes, parked_at_start):
    """Per record: ms, park and fetch ms, GB moved and GB/s each way,
    live/reserved/peak/host MiB, and the persistent state resident on the
    card during the phase the record closes (GB: the state less what the
    lot held from the last fetch to this park; a sample's, at its own
    point)."""
    rows, parked = [], parked_at_start
    for r in records:
        sample = bool(r.get("sample"))
        held = r["host_bytes"] if sample else parked
        ps, fs = r.get("park_seconds", 0.0), r.get("fetch_seconds", 0.0)
        pb, fb = r.get("park_bytes", 0), r.get("fetch_bytes", 0)
        rows.append({
            "phase": r["phase"] + (" (sample)" if sample else ""),
            "ms": r["seconds"] * 1e3, "park_ms": ps * 1e3,
            "fetch_ms": fs * 1e3, "hygiene_ms":
            r.get("hygiene_seconds", 0.0) * 1e3,
            "park_GB": pb / 1e9, "fetch_GB": fb / 1e9,
            "park_GBps": pb / ps / 1e9 if pb else None,
            "fetch_GBps": fb / fs / 1e9 if fb else None,
            "live_mib": r["live_bytes"] / 2**20,
            "reserved_mib": r["reserved_bytes"] / 2**20,
            "peak_mib": r["peak_bytes"] / 2**20,
            "host_mib": r["host_bytes"] / 2**20,
            "resident_state_GB": (state_bytes - held) / 1e9})
        if not sample:
            parked = r["host_bytes"] - fb
    return rows


def _print_offload(label, rows, log):
    log(f"[smoke] {label}: phase ms (park, fetch, hygiene) / GB parked, "
        f"fetched (GB/s) / MiB live, reserved, peak, host / state on the "
        f"card GB")
    rate = lambda v: "   -  " if v is None else f"{v:6.2f}"  # noqa: E731
    for r in rows:
        log(f"  {r['phase']:25s} {r['ms']:8.1f} ({r['park_ms']:6.1f}, "
            f"{r['fetch_ms']:6.1f}, {r['hygiene_ms']:6.1f}) "
            f"{r['park_GB']:6.3f} ({rate(r['park_GBps'])}) "
            f"{r['fetch_GB']:6.3f} ({rate(r['fetch_GBps'])}) "
            f"{r['live_mib']:9.1f} {r['reserved_mib']:9.1f} "
            f"{r['peak_mib']:9.1f} {r['host_mib']:9.1f} "
            f"{r['resident_state_GB']:7.3f}")


def _bits(tree):
    """A CPU copy of every tensor of ``tree``, as raw bytes."""
    return [t.detach().to("cpu", copy=True).contiguous().view(torch.uint8)
            for t in leaves(tree)]


def _offload_run(dev, engine, level, policy, want, log, seed=0, iters=2):
    """A fresh trainer at ``level`` (the separate OPT pair, or hydra
    llama3_2_3b at phase 7's shape) and ``iters`` iterations of it (the
    first warm), each asserted (``_run_ppo``). Right after construction
    (whose ``start()`` parks) the allocator must have been asked for
    exactly the ``nbytes`` of the trees left on the card, and the lot must
    hold the managed rest."""
    if engine == "separate":
        acfg, ccfg = get_config(SEP_ACTOR), get_config(SEP_CRITIC)
        rl = RLHFConfig(engine="separate", memory_policy=policy,
                        offload=level, **SEP_KW)
        prompts = [_sep_prompts(dev, 1 + i, acfg.vocab_size)
                   for i in range(iters)]
        n_rec = 7
    else:
        acfg = ccfg = get_config("llama3_2_3b")
        rl = RLHFConfig(memory_policy=policy, offload=level, **PPO_KW)
        data = PromptDataset(synthetic_instruction_prompts(
            PBATCH * iters, seed=1), PPROMPT).batches(PBATCH, seed=1)
        prompts = [torch.from_numpy(next(data) % acfg.vocab_size).long()
                   .to(dev) for _ in range(iters)]
        n_rec = 8
    tr, alloc, asked = _fresh(lambda: RLHFTrainer(
        acfg, ccfg, rl, torch.Generator(device=dev).manual_seed(seed)))
    # (no reference to a tree may outlive this line: a parked tree's
    # device bytes come back only when the last one goes)
    state = sum(tree_nbytes(v) for v in tr.persistent_trees().values())
    lot = tr.offload_lot
    parked = 0 if lot is None else lot.parked_bytes()
    if lot is not None:
        plan = tr.offload.plan
        rest = plan.managed - plan.resident_for(plan.sequence[0])
        want_parked = sum(tree_nbytes(tr.offload.states[n][0]())
                          for n in rest)
        if parked != want_parked or set(lot.names()) != rest:
            raise SystemExit(f"{engine} {level}: the lot holds "
                             f"{lot.names()} ({parked} bytes), the plan "
                             f"parks {sorted(rest)} ({want_parked})")
    if asked != state - parked:
        raise SystemExit(f"{engine} {level}: {asked} bytes asked of the "
                         f"allocator after start(), {state - parked} on "
                         f"the card ({state} of state, {parked} parked)")
    g = torch.Generator(device=dev).manual_seed(7)
    out = {"level": level, "policy": policy, "state_bytes": state,
           "requested_after_start": asked, "allocated_after_start": alloc,
           "parked_after_start": parked}
    for it in range(iters):
        start = 0 if lot is None else lot.parked_bytes()
        secs, m, launches, recs = _run_ppo(
            tr, prompts[it], g, want, f"{engine} offload={level} "
            f"policy={policy} iteration {it}", n_rec)
    out.update(seconds=secs, metrics=m, launches=launches,
               records=[dict(r) for r in recs],
               rows=_offload_rows(recs, state, start))
    if lot is not None:
        out["pinned_bytes"] = lot.pinned_bytes()
        out["peak_parked_bytes"] = lot.stats.peak_parked_bytes
    return tr, out


def _same_or_within(got, a, b):
    """``got`` equals run ``a``'s metrics bit for bit when runs ``a`` and
    ``b`` (the same seed, no offload) agree bit for bit; otherwise each
    metric lies within their spread of one of them."""
    if a == b:
        return got == a
    return all(min(abs(got[k] - a[k]), abs(got[k] - b[k])) <=
               abs(a[k] - b[k]) for k in a)


def _remat_grads(tr, dev, log):
    """One actor step's forward and backward at 8 x 576 on a hydra
    llama3_2_3b trainer under each remat, from the same adapter, trunk
    and experience: the adapter's gradients, ms, peak MiB above what was
    allocated, and the launches (the AdamW update after it is the same
    for every remat)."""
    cfg = tr.actor_cfg
    g = torch.Generator(device=dev).manual_seed(11)
    B, S = PBATCH, PPROMPT + GEN
    mask = torch.zeros(B, S, device=dev)
    mask[:, PPROMPT:] = 1
    flat = torch.full((B, S), -math.log(cfg.vocab_size), device=dev)
    exp = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                   device=dev),
           "loss_mask": mask, "old_logp": flat * mask, "ref_logp": flat * mask,
           "advantages": torch.randn(B, S, generator=g, device=dev) * mask}
    adapter = tr.actor_state["params"]
    out = {}
    for remat in ("full",) + REMAT_RUNS:      # the first "full" warms up
        model = Model(dataclasses.replace(cfg, remat=remat), device=dev)
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        with torch.enable_grad():
            logits, _ = model.forward(tr.base_params, exp, adapter=adapter)
            loss, _ = TS.ppo_actor_loss(logits, exp, kl_coef=0.1)
            del logits
            grads = torch.autograd.grad(loss, list(leaves(adapter)))
        torch.cuda.synchronize()
        out[remat] = {"ms": (time.perf_counter() - t0) * 1e3,
                      "peak_mib": (torch.cuda.max_memory_allocated() - before)
                      / 2**20, "launches": dict(ops.launches),
                      "loss": float(loss.detach()), "grads": grads}
    full = out["full"]["grads"]
    if not all(torch.equal(a, b) for a, b in zip(out["offload"]["grads"],
                                                  full)):
        raise SystemExit("remat offload: gradients differ from full")
    err = max(scaled_err(a, b) for a, b in zip(out["dots"]["grads"], full))
    if not err <= TOL[torch.bfloat16]:
        raise SystemExit(f"remat dots: gradients {err} from full")
    if any(out[r]["launches"] != out["full"]["launches"] for r in REMAT_RUNS):
        raise SystemExit(f"remat launches differ: "
                         f"{ {r: out[r]['launches'] for r in REMAT_RUNS} }")
    for r in REMAT_RUNS:
        del out[r]["grads"]
        log(f"[smoke] remat {r:8s}: actor fwd + bwd {out[r]['ms']:8.1f} ms, "
            f"peak {out[r]['peak_mib']:8.1f} MiB above the state, loss "
            f"{out[r]['loss']:.6f}")
    log(f"[smoke] remat: offload gradients bit-identical to full, dots "
        f"within {err:.3e} (tol {TOL[torch.bfloat16]}); launches "
        f"{out['full']['launches']} under each")
    return {r: out[r] for r in REMAT_RUNS} | {"dots_max_err": err}


def offload_ppo(dev, log):
    """Phase 9: host offload on the card. (a) The separate OPT pair at
    phase 8's shape: the same-seed ``none`` iteration twice, then a fresh
    trainer at each of ``optimizer``, ``roles`` and ``all`` under
    ``after_inference`` and one at ``roles`` under ``none`` (no
    ``empty_cache``: parked bytes leave ``memory_allocated`` but stay
    reserved); each a warm iteration and a measured one, asserted: the
    bytes left on the card after ``start()``, launches (``ppo_launches``),
    metrics equal to ``none`` (bit for bit if ``none`` repeats itself,
    else within its spread), the reference and reward models bit for bit,
    and every record's live bytes below ``none``'s by at least the bytes
    parked there. (b) Hydra llama3_2_3b at ``all`` (phase 7's shape): the
    rollout's mid-phase sample below ``none``'s by at least the trunk's
    adapted leaves. (c) One actor step's forward and backward on that
    trainer under remat "full", "offload" and "dots". And the link's
    yardstick: a 1 GiB pinned copy each way."""
    out = {"meminfo_before": meminfo(), "link": link_rate(dev)}
    ln = out["link"]
    log(f"[smoke] offload: host {out['meminfo_before']}; 1 GiB pinned copy "
        f"D2H {ln['d2h_ms']:.2f} ms ({ln['d2h_GBps']:.2f} GB/s), H2D "
        f"{ln['h2d_ms']:.2f} ms ({ln['h2d_GBps']:.2f} GB/s)")
    acfg, ccfg = get_config(SEP_ACTOR), get_config(SEP_CRITIC)
    want = ppo_launches(acfg, RLHFConfig(engine="separate", **SEP_KW),
                        model_reward=True, critic_cfg=ccfg)
    runs, frozen = {}, None
    for key, level, policy in ([("none", "none", "after_inference"),
                                ("none_again", "none", "after_inference")]
                               + [(lv, lv, "after_inference")
                                  for lv in OFFLOAD_RUNS]
                               + [("roles_policy_none", "roles", "none")]):
        tr, run = _offload_run(dev, "separate", level, policy, want, log)
        bits = _bits([tr.ref_params, tr.reward_params])
        if frozen is None:
            frozen = bits
        elif not all(torch.equal(a, b) for a, b in zip(bits, frozen)):
            raise SystemExit(f"separate offload={level}: the reference or "
                             "reward model changed")
        del tr, bits
        gc.collect()
        torch.cuda.empty_cache()
        run["mem_available_after"] = meminfo()["MemAvailable"]
        runs[key] = run
        _print_offload(f"separate offload={level} policy={policy} "
                       f"({run['seconds'] * 1e3:.1f} ms)", run["rows"], log)
    a, b = runs["none"]["metrics"], runs["none_again"]["metrics"]
    out["none_repeats_bitwise"] = a == b
    out["none_spread"] = {k: abs(a[k] - b[k]) for k in a}
    log(f"[smoke] separate none twice: bit for bit {a == b}; spread "
        f"{out['none_spread']}")
    for key, run in runs.items():
        if key.startswith("none"):
            continue
        if not _same_or_within(run["metrics"], a, b):
            raise SystemExit(f"separate {key}: metrics {run['metrics']} "
                             f"against none {a}, {b}")
        for r0, r in zip(runs["none"]["records"], run["records"]):
            if r0["live_bytes"] - r["live_bytes"] < r["host_bytes"]:
                raise SystemExit(f"separate {key} {r['phase']}: live "
                                 f"{r['live_bytes']} against none's "
                                 f"{r0['live_bytes']}, {r['host_bytes']} "
                                 "parked")
        if run["policy"] == "none" and min(
                r["reserved_bytes"] for r in run["records"]) < \
                run["state_bytes"]:
            raise SystemExit(f"separate {key}: reserved fell below the "
                             "state without empty_cache")
        log(f"[smoke] separate {key}: metrics "
            f"{'bit for bit' if a == b else 'within the spread of'} none's; "
            f"{run['requested_after_start']} bytes on the card after "
            f"start(), {run['parked_after_start']} parked; pinned "
            f"{run['pinned_bytes']} bytes for a parked peak of "
            f"{run['peak_parked_bytes']}")
    out["separate"] = runs

    # (b) hydra llama3_2_3b at "all": the trunk's adapted leaves parked
    # while the merged copy serves rollout
    cfg = get_config("llama3_2_3b")
    want_h = ppo_launches(cfg, RLHFConfig(**PPO_KW), model_reward=True)
    tr, none_run = _offload_run(dev, "hydra", "none", "after_inference",
                                want_h, log)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    tr, all_run = _offload_run(dev, "hydra", "all", "after_inference",
                               want_h, log)
    adapted = tree_nbytes(LORA.adapted_subtree(tr.base_params,
                                               tr.engine.lora_sites()))
    drop = none_run["records"][0]["live_bytes"] - \
        all_run["records"][0]["live_bytes"]
    if all_run["records"][0]["phase"] != "rollout_decode" or drop < adapted:
        raise SystemExit(f"hydra all: the rollout sample is {drop} bytes "
                         f"below none's, the adapted leaves {adapted}")
    _print_offload("hydra llama3_2_3b offload=none", none_run["rows"], log)
    _print_offload(f"hydra llama3_2_3b offload=all "
                   f"({all_run['seconds'] * 1e3:.1f} ms)", all_run["rows"],
                   log)
    log(f"[smoke] hydra all: rollout sample {drop} bytes below none's "
        f"(the adapted leaves: {adapted})")
    out["hydra"] = {"none": none_run, "all": all_run,
                    "adapted_bytes": adapted, "sample_drop_bytes": drop}

    # (c) remat on the same trainer
    out["remat"] = _remat_grads(tr, dev, log)
    del tr, frozen
    gc.collect()
    torch.cuda.empty_cache()
    out["meminfo_after"] = meminfo()
    log(f"[smoke] offload: host MemAvailable after each separate run "
        f"{[r['mem_available_after'] for r in runs.values()]}, at the end "
        f"{out['meminfo_after']}")
    out["launches"] = runs["roles"]["launches"]
    out["hydra_launches"] = all_run["launches"]
    return out


# ---------------------------------------------------------------- phase 10
def _decode_call(ro, run, graphs, temperature, n):
    """One generate call of ``n`` new tokens through ``ro``, graphed or
    eager: ((tokens, log-probs) on the host, synchronised host seconds,
    launches from 0, live bytes after it with its result dropped, its
    decode stats)."""
    ro._graphs, ro.temperature = graphs, temperature
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = run(n)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    bits = (res.tokens.cpu(), res.logp.cpu())
    del res
    st = dict(ro.decode_stats)
    # a call captures only where a replay follows: two decode steps or more
    if st["graphed"] != (graphs and n >= 3):
        raise SystemExit(f"asked graphed={graphs}, ran {st}")
    return (bits, secs, dict(ops.launches), torch.cuda.memory_allocated(),
            st)


def _same_bits(a, b) -> bool:
    return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def decode_graph_path(label, ro, run, gen, log):
    """One decode path graphed against eager, from one seed, in this call:
    sampled at the path's temperature in turns (eager, graphed, graphed,
    eager: the host clock moves between calls) and greedy (graphed,
    eager). Fails unless every call gives the same tokens and log-probs
    (per temperature), the same launches and the same live bytes after
    it, and every graphed step after the first is a replay. ms a decode
    step: (call - prefill call) / (gen - 1), the prefill call being the
    same call with one new token (no decode step); graphed with the
    capture in it, and without it. The paged path's host time a step is
    split between the page manager and the rest (dispatch and sampling).
    ``run(n)`` makes one call of n new tokens from the path's seed."""
    temp = ro.temperature
    sampled = [_decode_call(ro, run, g, temp, gen)
               for g in (False, True, True, False)]
    greedy = [_decode_call(ro, run, g, 0.0, gen) for g in (True, False)]
    pre = _decode_call(ro, run, True, temp, 1)
    ro._graphs, ro.temperature = True, temp
    calls = sampled + greedy
    for name, group in (("sampled", sampled), ("greedy", greedy)):
        if not all(_same_bits(c[0], group[0][0]) for c in group):
            raise SystemExit(f"{label}: {name} tokens or log-probs differ "
                             f"graphed vs eager")
    if any(c[2] != calls[0][2] for c in calls):
        raise SystemExit(f"{label}: launches differ graphed vs eager: "
                         f"{[c[2] for c in calls]}")
    if any(c[3] != calls[0][3] for c in calls):
        raise SystemExit(f"{label}: live bytes after the call differ: "
                         f"{[c[3] for c in calls]}")
    for c in calls:
        st = c[4]
        if st["replays"] != (gen - 2 if st["graphed"] else 0) or \
                (st["graphed"] and st["capture_ms"] is None):
            raise SystemExit(f"{label}: not every graphed step after the "
                             f"first was a replay: {st}")
    gst = sampled[1][4]
    eager_s = (sampled[0][1] + sampled[3][1]) / 2
    graph_s = (sampled[1][1] + sampled[2][1]) / 2
    cap_ms = (sampled[1][4]["capture_ms"] + sampled[2][4]["capture_ms"]) / 2
    per = lambda s: (s - pre[1]) * 1e3 / (gen - 1)  # noqa: E731
    out = {"path": label, "gen": gen, "same_sampled_bits": True,
           "same_greedy_bits": True, "launches": calls[0][2],
           "live_bytes_after": calls[0][3],
           "call_ms": {"eager": [sampled[0][1] * 1e3, sampled[3][1] * 1e3],
                       "graphed": [sampled[1][1] * 1e3,
                                   sampled[2][1] * 1e3]},
           "prefill_call_ms": pre[1] * 1e3,
           "eager_step_ms": per(eager_s), "graphed_step_ms": per(graph_s),
           "graphed_step_ms_without_capture": per(graph_s - cap_ms / 1e3),
           "capture_ms": cap_ms, "pool_mib": gst["pool_bytes"] / 2**20,
           "greedy_step_ms": {"graphed": per(greedy[0][1]),
                              "eager": per(greedy[1][1])},
           "host_ms_a_step": {
               "eager": sampled[0][4]["host_ms"] / (gen - 1),
               "graphed": gst["host_ms"] / (gen - 1)},
           "greedy_host_ms_a_step": {
               "graphed": greedy[0][4]["host_ms"] / (gen - 1),
               "eager": greedy[1][4]["host_ms"] / (gen - 1)},
           "page_manager_ms_a_step": {
               "eager": sampled[0][4]["page_manager_ms"] / (gen - 1),
               "graphed": gst["page_manager_ms"] / (gen - 1)}}
    log(f"[smoke] decode graph {label}: tokens and log-probs the same bits "
        f"graphed and eager (sampled at T {temp}, and greedy); launches "
        f"equal {calls[0][2]}; live after {calls[0][3] / 2**20:.1f} MiB "
        f"both ways")
    log(f"[smoke]   ms a decode step: eager {out['eager_step_ms']:.3f}, "
        f"graphed {out['graphed_step_ms']:.3f} "
        f"({out['graphed_step_ms_without_capture']:.3f} without the "
        f"capture); capture {cap_ms:.1f} ms, pool {out['pool_mib']:.1f} MiB"
        f"; calls eager "
        f"{sampled[0][1] * 1e3:.1f} / {sampled[3][1] * 1e3:.1f} ms, graphed "
        f"{sampled[1][1] * 1e3:.1f} / {sampled[2][1] * 1e3:.1f} ms, prefill "
        f"call {pre[1] * 1e3:.1f} ms")
    hm, pm = out["host_ms_a_step"], out["page_manager_ms_a_step"]
    gs, gh = out["greedy_step_ms"], out["greedy_host_ms_a_step"]
    log(f"[smoke]   host ms a step in the loop (sampled; the sampler's "
        f"validity check waits for the card): eager {hm['eager']:.3f} "
        f"(page manager {pm['eager']:.3f}), graphed {hm['graphed']:.3f} "
        f"(page manager {pm['graphed']:.3f}); greedy (no wait in the "
        f"loop): ms a step eager {gs['eager']:.3f}, graphed "
        f"{gs['graphed']:.3f}, of which the loop's host ms eager "
        f"{gh['eager']:.3f}, graphed {gh['graphed']:.3f}")
    return out


def _trainer_run(tr, prompts, seed):
    """``run(n)`` for a trainer's rollout phase (``_gen``: the hydra
    engine's merged weights, or the separate actor's)."""
    gen_len = tr.rl.gen_len

    def run(n):
        tr.rl.gen_len = n
        try:
            return tr._gen(prompts, torch.Generator(
                device=prompts.device).manual_seed(seed))
        finally:
            tr.rl.gen_len = gen_len
    return run


def _iterations_both_ways(tr, prompts, want, label, log):
    """One PPO iteration eager, then one graphed, on the same trainer:
    iteration and rollout ms, and the rollout boundary's live bytes (the
    adapters move between the two, so this times, it does not compare
    bits); launches asserted both ways."""
    g = torch.Generator(device=prompts.device).manual_seed(11)
    out = {}
    n = 8 if tr.engine is not None else 7
    for graphs in (False, True):
        tr.rollout._graphs = graphs
        secs, _, _, recs = _run_ppo(tr, prompts, g, want,
                                    f"{label} graphed={graphs}", n)
        ro = [r for r in recs if r["phase"] == "rollout"][0]
        dec = [r for r in recs if r["phase"] == "rollout_decode"]
        out["graphed" if graphs else "eager"] = {
            "seconds": secs, "rollout_ms": (ro["seconds"] + sum(
                r["seconds"] for r in dec)) * 1e3,
            "rollout_live_bytes": ro["live_bytes"]}
    tr.rollout._graphs = True
    e, gr = out["eager"], out["graphed"]
    log(f"[smoke]   {label} iteration: eager {e['seconds'] * 1e3:.1f} ms "
        f"(rollout {e['rollout_ms']:.1f}), graphed "
        f"{gr['seconds'] * 1e3:.1f} ms (rollout {gr['rollout_ms']:.1f}); "
        f"live at the rollout boundary {e['rollout_live_bytes']} / "
        f"{gr['rollout_live_bytes']} bytes")
    if e["rollout_live_bytes"] != gr["rollout_live_bytes"]:
        raise SystemExit(f"{label}: live bytes at the rollout boundary "
                         f"differ graphed vs eager")
    return out


def profiled_call(label, ro, run, graphs, log):
    """One profiled call of ``GEN`` new tokens through ``ro``, graphed or
    eager. The first-kind kernels the trace holds, per wrapper, must equal
    ``ops.launches`` for the call: on a graphed call those counts are the
    capture's record added once a replay, so this holds them to what the
    card ran."""
    ro._graphs = graphs
    ops.reset_launches()
    prof, _ = profile_call(lambda: run(GEN))
    want = {w: ops.launches[w] for w in KERNEL_FUNCS}
    seen = {w: prof["port"].get(w, {}).get("calls", 0) for w in KERNEL_FUNCS}
    if seen != want:
        raise SystemExit(f"{label}: kernels in the trace {seen} differ from "
                         f"ops.launches {want}")
    print_profile(label, prof)
    log(f"[smoke]   {label}: the trace's kernels equal ops.launches "
        f"{ {w: n for w, n in want.items() if n} }")
    return prof


def decode_graphs(dev, log, profile=False):
    """Phase 10: every decode path eagerly and graphed in this call, from
    one seed (``decode_graph_path``): serving llama3_2_3b 8 x (512 + 64),
    the paged GRPO rollout (8 prompts x 504, G = 8, 64 generated), Mamba2
    mamba2_370m 8 x (2048 + 64), the hydra PPO rollout of llama3_2_3b 8 x
    (512 + 64) and the separate PPO rollout of opt_1_3b 8 x (256 + 256);
    for the two PPO paths also one iteration each way. With ``profile``,
    the device's idle share over a graphed and an eager serving call."""
    out = {}
    cfg = get_config("llama3_2_3b")
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    ids = torch.from_numpy(next(PromptDataset(synthetic_instruction_prompts(
        BATCH, seed=0), PROMPT).batches(BATCH, seed=0)) % cfg.vocab_size
    ).long().to(dev)
    ro = Rollout(model, cfg, capacity=PROMPT + GEN, temperature=0.8,
                 top_k=serve.TOP_K)
    run = lambda n: ro.generate(  # noqa: E731
        params, {"tokens": ids}, n, torch.Generator(device=dev).manual_seed(1))
    out["serve"] = decode_graph_path("serve llama3_2_3b", ro, run, GEN, log)
    if profile:
        for graphs in (True, False):
            key = "profile_graphed" if graphs else "profile_eager"
            prof = profiled_call(f"serving request, {key[8:]}", ro, run,
                                 graphs, log)
            out["serve"][key] = {k: prof[k] for k in (
                "profiled_wall_s", "kernel_busy_s", "idle_share")}
        ro._graphs = True

    gids = torch.from_numpy(next(PromptDataset(synthetic_instruction_prompts(
        GROUPS, seed=0), GPROMPT).batches(GROUPS, seed=0)) % cfg.vocab_size
    ).long().to(dev)
    pro = Rollout(model, cfg, capacity=GPROMPT + GEN, backend="paged",
                  page_size=PAGE, temperature=0.8, top_k=serve.TOP_K)
    prun = lambda n: pro.generate(  # noqa: E731
        params, {"tokens": gids}, n,
        torch.Generator(device=dev).manual_seed(1), group_size=GSIZE)
    out["paged_grpo"] = decode_graph_path("paged GRPO llama3_2_3b", pro,
                                          prun, GEN, log)
    log("[smoke] decode graphs: B3's combine and B4's merge were captured "
        "with their programmatic dependent launch (a toolkit that refused "
        "it would fail the capture)")
    if profile:
        prof = profiled_call("paged GRPO request, graphed", pro, prun, True,
                             log)
        out["paged_grpo"]["profile_graphed"] = {k: prof[k] for k in (
            "profiled_wall_s", "kernel_busy_s", "idle_share")}
    del model, params, ro, pro
    gc.collect()
    torch.cuda.empty_cache()

    mcfg = get_config("mamba2_370m")
    model = Model(mcfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    mids = torch.randint(0, mcfg.vocab_size, (MBATCH, MPROMPT), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(2))
    ro = Rollout(model, mcfg, capacity=MPROMPT + GEN, temperature=0.8,
                 top_k=serve.TOP_K)
    run = lambda n: ro.generate(  # noqa: E731
        params, {"tokens": mids}, n,
        torch.Generator(device=dev).manual_seed(1))
    out["mamba"] = decode_graph_path("mamba2 mamba2_370m", ro, run, GEN, log)
    del model, params, ro
    gc.collect()
    torch.cuda.empty_cache()

    tr, _ = _trainer(cfg, dev, "after_inference")
    prompts = torch.from_numpy(next(PromptDataset(
        synthetic_instruction_prompts(PBATCH, seed=1), PPROMPT).batches(
            PBATCH, seed=1)) % cfg.vocab_size).long().to(dev)
    out["ppo_hydra"] = decode_graph_path(
        "hydra PPO rollout llama3_2_3b", tr.rollout,
        _trainer_run(tr, prompts, 3), GEN, log)
    out["ppo_hydra"]["iterations"] = _iterations_both_ways(
        tr, prompts, ppo_launches(cfg, tr.rl, model_reward=True),
        "hydra PPO", log)
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    tr, _, _ = _separate_trainer(dev, "after_inference")
    prompts = _sep_prompts(dev, 1, tr.actor_cfg.vocab_size)
    out["ppo_separate"] = decode_graph_path(
        "separate PPO rollout opt_1_3b", tr.rollout,
        _trainer_run(tr, prompts, 3), SGEN, log)
    out["ppo_separate"]["iterations"] = _iterations_both_ways(
        tr, prompts, ppo_launches(tr.actor_cfg, tr.rl, model_reward=True,
                                  critic_cfg=tr.critic_cfg),
        "separate PPO", log)
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    # what one capture stream costs for the process: cuBLAS's workspace
    # for a stream it has not run on yet (one more stream, measured here)
    a = torch.randn(64, 64, device=dev)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        y = a @ a
    side.synchronize()
    out["stream_workspace_bytes"] = torch.cuda.memory_allocated() - before \
        - y.numel() * y.element_size()
    log(f"[smoke] decode graphs: the capture stream's cuBLAS workspace, "
        f"allocated once a process: {out['stream_workspace_bytes']} bytes")
    del y, a
    return out


# each wrapper's CUDA kernels, by function name (no name contains
# another's): one launch of the first kind per call; B3 and B4 add their
# combine kernel when they split, B2-bwd its dK/dV and prep (or delta)
# kernels,
# B1-bwd its dscale sum kernel when asked for dscale
KERNEL_FUNCS = {"flash_attention": ("flash_wgmma_kernel", "flash_fwd_kernel"),
                "decode_attention": ("decode_split_kernel",),
                "paged_decode_attention": ("paged_split_kernel",),
                "rmsnorm": ("rmsnorm_vec_kernel", "rmsnorm_scalar_kernel"),
                "ssd_scan": ("ssd_wgmma_kernel", "ssd_scan_kernel"),
                "flash_attention_bwd": ("flash_bwd_dq_wgmma_kernel",
                                        "flash_bwd_dq_kernel"),
                "rmsnorm_bwd": ("rmsnorm_bwd_vec_kernel",
                                "rmsnorm_bwd_scalar_kernel")}
SECOND_KERNELS = {"decode_attention": ("combine_kernel",),
                  "paged_decode_attention": ("paged_merge_kernel",),
                  "flash_attention_bwd": ("flash_bwd_dkdv_wgmma_kernel",
                                          "flash_bwd_prep_kernel",
                                          "flash_bwd_dkdv_kernel",
                                          "flash_bwd_delta_kernel"),
                  "rmsnorm_bwd": ("rmsnorm_dscale_sum_kernel",)}


def port_kernels(rows):
    """{wrapper: {"ms", "calls", "us_per_call", "us_per_call_by_kernel"}}
    from profiler rows (us, count, name): each wrapper's kernels' device
    time in the profiled run, in all and per kernel function, per call of
    the wrapper."""
    out = {}
    for wrapper, funcs in KERNEL_FUNCS.items():
        calls = sum(r[1] for r in rows if any(f in r[2] for f in funcs))
        if not calls:
            continue
        split = {f: sum(r[0] for r in rows if f in r[2])
                 for f in funcs + SECOND_KERNELS.get(wrapper, ())}
        us = sum(split.values())
        out[wrapper] = {"ms": us / 1e3, "calls": calls,
                        "us_per_call": us / calls,
                        "us_per_call_by_kernel": {
                            f: t / calls for f, t in split.items() if t}}
    return out


def profile_call(fn):
    """Kernel time by name over one call of ``fn`` (torch.profiler; kernel
    events only, so the device's busy time is the sum of its kernels),
    its wall time (host clock, synchronised) and the device's idle share
    of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    key = "self_device_time_total" if hasattr(events[0],
                                               "self_device_time_total") \
        else "self_cuda_time_total"
    rows = sorted(((getattr(e, key), e.count, e.key) for e in events
                   if e.device_type == DeviceType.CUDA and getattr(e, key) > 0),
                  reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    table = events.table(sort_by=key, row_limit=40)
    return {"profiled_wall_s": wall, "kernel_busy_s": busy_s,
            "idle_share": 1 - busy_s / wall, "port": port_kernels(rows),
            "top": [{"us": r[0], "count": r[1], "name": r[2]}
                    for r in rows[:15]]}, table


def print_profile(label, prof):
    print(f"[smoke] profiled {label}: wall "
          f"{prof['profiled_wall_s'] * 1e3:.1f} ms, kernels busy "
          f"{prof['kernel_busy_s'] * 1e3:.1f} ms, idle share "
          f"{prof['idle_share']:.3f}")
    for wrapper, k in prof["port"].items():
        by = k["us_per_call_by_kernel"]
        print(f"  port {wrapper:22s} {k['ms']:9.3f} ms {k['calls']:6d} calls "
              f"{k['us_per_call']:9.2f} us a call" + (" (" + ", ".join(
                  f"{f} {t:.2f}" for f, t in by.items()) + ")"
                  if len(by) > 1 else ""))
    for row in prof["top"][:10]:
        print(f"  {row['us'] / 1e3:9.3f} ms {row['count']:6d}x "
              f"{row['name'][:90]}")


# ------------------------------------------------------------------- main
def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="also profile one dense, one paged GRPO and one "
                         "Mamba2 request and one hydra and one separate "
                         "PPO iteration with torch.profiler, and one "
                         "serving request graphed and eager")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = False
    OUT_DIR.mkdir(exist_ok=True)
    report = {}

    # phase 1: card, versions, build
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"])
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "absent"
    print(f"[smoke] card: {smi}")
    print(f"[smoke] host memory: {meminfo()}")
    print(f"[smoke] torch {torch.__version__} cuda {torch.version.cuda} "
          f"triton {triton_v} (unused); peaks {peaks}")
    path, log, secs = build.build()
    print(f"[smoke] built {path.relative_to(ROOT)} in {secs:.1f} s")
    if not log:           # built before: the ptxas lines are in the log
        log = (path.parent / "ptxas.txt").read_text()
    (OUT_DIR / "ptxas.txt").write_text(log)
    report.update(card=smi, torch=torch.__version__, cuda=torch.version.cuda,
                  build_s=secs, sass=check_build(path, log))

    # phase 2: kernels against their plain versions
    g = torch.Generator(device=dev).manual_seed(0)
    checks = {"flash_attention": check_flash(dev, peaks, g),
              "decode_attention": check_decode(dev, peaks, g),
              "paged_decode_attention": check_paged(dev, peaks, g),
              "rmsnorm": check_rmsnorm(dev, peaks, g),
              "ssd_scan": check_ssd(dev, peaks, g),
              "flash_attention_bwd": check_flash_bwd(dev, peaks, g),
              "rmsnorm_bwd": check_rmsnorm_bwd(dev, peaks, g)}
    failures = []
    for kname, recs in checks.items():
        for r in recs:
            line = (f"[smoke] {kname:16s} {r['case']:13s} max_err "
                    f"{r['max_err']:.3e} (tol {r['tol']:g})")
            if "lse_err" in r:
                line += f" [out {r['out_err']:.3e}, lse {r['lse_err']:.3e}]"
            if "dscale_cold_ms" in r:
                line += (f"  with dscale: warm "
                         f"{r['dscale_device_ms'] * 1e3:.2f} us, cold "
                         f"{r['dscale_cold_ms'] * 1e3:.2f} us")
            if "ms" in r:
                lib = "none" if r["library_ms"] is None else \
                    f"{r['library_ms']:.4f} ms"
                line += (f"  kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f}"
                         f" ms  library {lib}  bound "
                         f"{r['bound_ms'] * 1e3:.1f} us ({r['bound_by']})")
                if "yardstick_ms" in r:
                    line += f"  gather+SDPA {r['yardstick_ms']:.4f} ms"
            if "cold_ms" in r:
                line += (f"  graph: warm {r['device_ms'] * 1e3:.2f} us, "
                         f"cold {r['cold_ms'] * 1e3:.2f} us")
                if r.get("library_cold_ms") is not None:
                    if "library_device_ms" in r:
                        line += (f"; library warm "
                                 f"{r['library_device_ms'] * 1e3:.2f} us")
                    line += (f", library cold "
                             f"{r['library_cold_ms'] * 1e3:.2f} us")
                if "bound_ms" in r and "ms" not in r:
                    line += (f"  bound {r['bound_ms'] * 1e3:.2f} us "
                             f"({r['bound_by']})")
            if "unique_pages" in r:
                line += (f"; {r['unique_pages']} distinct pages "
                         f"{r['unique_mib']:.1f} MiB, per row "
                         f"{r['per_row_mib']:.1f} MiB")
            if "plan" in r:
                pl = r["plan"]
                line += (f"; plan {pl['tiles']} tiles x {pl['splits']} "
                         f"splits of {pl['span']} pages, copies "
                         f"{r['page_loads']} pages a head (a block: max "
                         f"{r['block_loads_max']}, mean "
                         f"{r['block_loads_mean']:.1f})")
            print(line)
            if not r["max_err"] <= r["tol"]:
                failures.append(f"{kname}/{r['case']}: {r['max_err']}")
    report["checks"] = checks
    if failures:
        raise SystemExit(f"kernels disagree with their plain versions: "
                         f"{failures}")

    # phase 3: the serving path at full width and depth
    cfg = get_config("llama3_2_3b")
    torch.cuda.synchronize()
    ops.reset_launches()
    results = serve.run(cfg, batch=BATCH, prompt_len=PROMPT, gen=GEN,
                        requests=REQUESTS, temperature=0.8, seed=0,
                        device=dev, log=lambda s: print(s, flush=True))
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    L = cfg.num_layers
    want = {"flash_attention": L * REQUESTS,
            "decode_attention": L * (GEN - 1) * REQUESTS,
            "paged_decode_attention": 0, "ssd_scan": 0,
            "rmsnorm": (2 * L + 1) * GEN * REQUESTS,
            "flash_attention_bwd": 0, "rmsnorm_bwd": 0}
    print(f"[smoke] launches {launches} (want {want})")
    if launches != want:
        raise SystemExit(f"launch counts {launches} != {want}")
    report["requests"] = [{k: v for k, v in r.items() if k != "result"}
                          for r in results]

    # phase 4: outputs
    check_outputs(results, cfg.vocab_size)
    small_err = check_small_model_against_cpu(dev)
    print(f"[smoke] outputs ok; small GQA model card vs CPU: logits "
          f"max_err {small_err:.3e}, 16 greedy tokens identical")
    report["small_model_max_err"] = small_err

    # phase 5: the paged GRPO rollout at full width and depth
    grpo = paged_grpo(cfg, dev, lambda s: print(s, flush=True),
                      profile=args.profile)
    print(f"[smoke] paged GRPO launches {grpo['launches']} over "
          f"{GREQUESTS} requests; forks {grpo['requests'][0]['forks']}")
    report["paged_grpo"] = grpo

    # phase 6: Mamba2 serving at full width and depth
    mamba = mamba_serving(dev, lambda s: print(s, flush=True),
                          profile=args.profile)
    report["mamba"] = mamba

    # phase 7: hydra PPO iterations at full width and depth
    ppo = ppo_iterations(dev, lambda s: print(s, flush=True),
                         profile=args.profile)
    report["ppo"] = ppo

    # phase 8: the paper's four-model PPO at full width and depth
    sep = separate_ppo(dev, lambda s: print(s, flush=True),
                       profile=args.profile)
    report["ppo_separate"] = sep

    # phase 9: host offload on both engines at full width and depth
    off = offload_ppo(dev, lambda s: print(s, flush=True))
    report["offload"] = off
    # phase 10: every decode path graphed against eager in this call
    report["decode_graphs"] = decode_graphs(
        dev, lambda s: print(s, flush=True), profile=args.profile)

    paths = {"serve": launches, "paged_grpo": grpo["launches"],
             "mamba_serve": mamba["launches"], "ppo": ppo["launches"],
             "ppo_separate": sep["launches"],
             "ppo_separate_offload": off["launches"],
             "ppo_offload": off["hydra_launches"]}

    if args.profile:
        prof, table = profile_request(cfg, dev)
        (OUT_DIR / "profile.txt").write_text(table)
        print(f"[smoke] unprofiled: prefill {prof['prefill_ms']:.1f} ms, "
              f"decode {prof['decode_step_ms']:.2f} ms/step (greedy)")
        print_profile("request", prof)
        report["profile"] = prof
        print_profile("paged GRPO request", grpo["profile"])
        (OUT_DIR / "profile_paged.txt").write_text(grpo.pop("profile_table"))
        print_profile("mamba2 request", mamba["profile"])
        (OUT_DIR / "profile_mamba.txt").write_text(mamba.pop("profile_table"))
        print_profile("ppo iteration", ppo["profile"])
        (OUT_DIR / "profile_ppo.txt").write_text(ppo.pop("profile_table"))
        print_profile("separate ppo iteration", sep["profile"])
        (OUT_DIR / "profile_separate.txt").write_text(
            sep.pop("profile_table"))

    kernels = []
    main_path = {"paged_decode_attention": "paged_grpo",
                 "ssd_scan": "mamba_serve", "flash_attention_bwd": "ppo",
                 "rmsnorm_bwd": "ppo"}
    for kname, source, replaces in (
            ("flash_attention", fa.SOURCE, fa.REPLACES),
            ("decode_attention", dec.SOURCE, dec.REPLACES),
            ("paged_decode_attention", pa.SOURCE, pa.REPLACES),
            ("rmsnorm", rn.SOURCE, rn.REPLACES),
            ("ssd_scan", ssd.SOURCE, ssd.REPLACES),
            ("flash_attention_bwd", fab.SOURCE, fab.REPLACES),
            ("rmsnorm_bwd", rn.SOURCE, rn.REPLACES_BWD)):
        main_rec = checks[kname][0]
        path = main_path.get(kname, "serve")
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": paths[path][kname],
            "path": path,
            "launches_by_path": {p: c[kname] for p, c in paths.items()},
            "max_abs_err": max(r.get("max_abs_err", r["max_err"])
                               for r in checks[kname]),
            "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"],
            "bound_by": main_rec["bound_by"],
            "library_ms": main_rec["library_ms"],
            "device_ms": main_rec.get("device_ms"),
            "cold_ms": main_rec.get("cold_ms"),
            "library_cold_ms": main_rec.get("library_cold_ms"),
            "library_device_ms": main_rec.get("library_device_ms"),
            "yardstick_ms": main_rec.get("yardstick_ms"),
            "max_err": max(r["max_err"] for r in checks[kname]),
            "kernel_ms": main_rec["ms"],
            "bound_us": main_rec["bound_ms"] * 1e3,
        })
    report["kernels"] = kernels
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
