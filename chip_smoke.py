#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # needs one NVIDIA card and nvcc
    python3 chip_smoke.py --profile  # also profiles one request per path

Phases, each failing with a non-zero exit:

1. the card (``nvidia-smi`` name and power limit), versions, and the
   kernels' build from ``src/repro_torch/kernels/csrc``;
2. each kernel against its plain PyTorch version at the shapes of the
   serving, paged GRPO and Mamba2 paths and at edge cases (ragged Sq/Sk,
   window, a wrapped rolling cache, head_dim 64, fp32; for B5 one chunk,
   small head and state widths, a strongly decaying a and the
   step-by-step oracle), with its time, the plain version's, one PyTorch
   library call's (where one exists) and the least time the card could
   take;
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

It prints the per-kernel JSON line, the card line, and last the result
line ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
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
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.data import PromptDataset, \
    synthetic_instruction_prompts  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.paged import PageManager, gather_kv  # noqa: E402
from repro_torch.rlhf import Rollout  # noqa: E402

OUT_DIR = ROOT / "chiprun_out"

# serving path: llama3_2_3b, batch 8, prompt 512, 64 generated tokens
BATCH, PROMPT, GEN, REQUESTS = 8, 512, 64, 3
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}   # other summation order
# paged GRPO rollout: 8 prompts of 504 tokens (not a multiple of the page
# size, so each forked row CoW-copies its partial prompt page), G = 8
# samples each, 64 generated tokens, 2 requests
GROUPS, GPROMPT, GSIZE, PAGE, GREQUESTS = 8, 504, 8, 16, 2
# Mamba2 serving: mamba2_370m, batch 8, prompt 2048 (Mamba2's training
# context, a multiple of the 256-step SSD chunk), 64 generated tokens
MBATCH, MPROMPT, MREQUESTS = 8, 2048, 3
TOL_SSD = {torch.bfloat16: 5e-2, torch.float32: 1e-3}   # test_kernels.py:98

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
        ("ragged", 2, 100, 37, 24, 8, 128, False, 0, torch.bfloat16),
        ("ragged_causal", 2, 100, 37, 24, 8, 128, True, 0, torch.bfloat16),
        ("window", 2, 256, 256, 24, 8, 128, True, 64, torch.bfloat16),
        ("d64", 2, 192, 192, 8, 2, 64, True, 0, torch.bfloat16),
        ("fp32", 2, 130, 130, 6, 2, 128, True, 16, torch.float32),
    ]
    out = []
    for name, B, Sq, Sk, H, K, D, causal, window, dt in cases:
        q = torch.randn(B, Sq, H, D, generator=g, device=dev).to(dt)
        k = torch.randn(B, Sk, K, D, generator=g, device=dev).to(dt)
        v = torch.randn(B, Sk, K, D, generator=g, device=dev).to(dt)
        got = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
        want = ref.attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rec = {"case": name, "shape": [B, Sq, Sk, H, K, D], "causal": causal,
               "window": window, "dtype": str(dt), "max_err": err,
               "tol": TOL[dt]}
        if name == "main":
            rec["ms"] = time_ms(lambda: fa.flash_attention_fwd(
                q, k, v, causal=causal, window=window))
            rec["plain_ms"] = time_ms(lambda: ref.attention_ref(
                q, k, v, causal=causal, window=window), iters=5)
            rec["library_ms"] = time_ms(lambda: _gqa_sdpa(
                q, k, v, is_causal=causal))
            n_ops = 4 * B * H * D * causal_pairs(Sq, Sk, causal, window)
            rec["bound_ms"], rec["bound_by"] = bound(
                peaks, nbytes(q, k, v, got), n_ops, dt)
        out.append(rec)
    return out


def check_decode(dev, peaks, g):
    cases = [  # (name, B, H, K, D, C, cur, window, dtype)
        ("main", BATCH, 24, 8, 128, PROMPT + GEN, PROMPT + GEN - 2, 0,
         torch.bfloat16),
        ("wrapped", 2, 24, 8, 128, 16, 19, 0, torch.bfloat16),
        ("window", 2, 24, 8, 128, 16, 19, 8, torch.bfloat16),
        ("d64", 2, 8, 2, 64, 100, 70, 0, torch.bfloat16),
        ("fp32", 2, 6, 1, 128, 200, 150, 32, torch.float32),
    ]
    out = []
    for name, B, H, K, D, C, cur, window, dt in cases:
        q = torch.randn(B, H, D, generator=g, device=dev).to(dt)
        kc = torch.randn(B, C, K, D, generator=g, device=dev).to(dt)
        vc = torch.randn(B, C, K, D, generator=g, device=dev).to(dt)
        pos = rolling_pos(B, C, cur, dev)
        position = torch.full((B,), cur, dtype=torch.int32, device=dev)
        got = dec.decode_attention(q, kc, vc, pos, position, window=window)
        want = ref.decode_attention_ref(q, kc, vc, pos, position,
                                        window=window)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rec = {"case": name, "shape": [B, H, K, D, C], "cur": cur,
               "window": window, "dtype": str(dt), "max_err": err,
               "tol": TOL[dt]}
        if name == "main":
            valid = (pos >= 0) & (pos <= position[:, None])
            mask = valid[:, None, None, :]
            rec["ms"] = time_ms(lambda: dec.decode_attention(
                q, kc, vc, pos, position, window=window))
            rec["plain_ms"] = time_ms(lambda: ref.decode_attention_ref(
                q, kc, vc, pos, position, window=window))
            rec["library_ms"] = time_ms(lambda: _gqa_sdpa(
                q[:, None], kc, vc, attn_mask=mask))
            n_ops = 4 * H * D * int(valid.sum().item())
            rec["bound_ms"], rec["bound_by"] = bound(
                peaks, nbytes(q, kc, vc, pos, position, got), n_ops, dt)
        out.append(rec)
    return out


def check_rmsnorm(dev, peaks, g):
    cases = [  # (name, shape, x dtype, scale dtype)
        ("main", (BATCH * PROMPT, 3072), torch.bfloat16, torch.bfloat16),
        ("decode", (BATCH, 3072), torch.bfloat16, torch.bfloat16),
        ("grpo_prefill", (GROUPS * GPROMPT, 3072), torch.bfloat16,
         torch.bfloat16),
        ("grpo_decode", (GROUPS * GSIZE, 3072), torch.bfloat16,
         torch.bfloat16),
        # the Mamba2 path: norm1 at d_model, the gated norm at d_inner
        ("mamba_prefill", (MBATCH * MPROMPT, 1024), torch.bfloat16,
         torch.bfloat16),
        ("mamba_gated", (MBATCH * MPROMPT, 2048), torch.bfloat16,
         torch.bfloat16),
        ("mamba_decode", (MBATCH, 2048), torch.bfloat16, torch.bfloat16),
        ("fp32", (3, 100), torch.float32, torch.float32),
        ("fp32_scale", (7, 384), torch.bfloat16, torch.float32),
    ]
    out = []
    for name, shape, dt, sdt in cases:
        x = torch.randn(*shape, generator=g, device=dev).to(dt)
        s = (1 + 0.1 * torch.randn(shape[-1], generator=g, device=dev)).to(sdt)
        got = rn.rmsnorm(x, s, 1e-5)
        want = ref.rmsnorm_ref(x, s, 1e-5)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rec = {"case": name, "shape": list(shape), "dtype": str(dt),
               "max_err": err, "tol": TOL[dt]}
        if name in ("main", "decode"):
            rec["ms"] = time_ms(lambda: rn.rmsnorm(x, s, 1e-5), iters=50)
            rec["plain_ms"] = time_ms(lambda: ref.rmsnorm_ref(x, s, 1e-5))
            rec["library_ms"] = time_ms(lambda: F.rms_norm(
                x, (shape[-1],), s, 1e-5), iters=50)
            rec["bound_ms"], rec["bound_by"] = bound(
                peaks, nbytes(x, s, got), 4 * x.numel(), dt)
        out.append(rec)
    return out


def ssd_ops(B, S, H, P, N, chunk) -> int:
    """Operations the chunked scan needs: per (batch, chunk) of l steps the
    causal half of C B^T (2 N per pair j <= i; it does not depend on the
    head), and per (batch, head, chunk) the causal product with x (2 P per
    pair), y_off and the state update (2 x 2 l N P)."""
    l, nc = chunk, S // chunk
    pairs = l * (l + 1) // 2
    return B * nc * (2 * N * pairs + H * (2 * P * pairs + 4 * l * N * P))


def check_ssd(dev, peaks, g):
    """B5 against its plain version on fp32 copies of the inputs (the plain
    version of the model path rounds L and the states to x's dtype; the
    kernel keeps them in fp32). b and c are scaled by N^-1/4 so a score
    C B^T has unit variance and |y| stays well below 16, where a bf16
    output's own rounding (half an ulp, 0.0625) would exceed 5e-2."""
    cases = [  # (name, B, S, H, P, N, chunk, dtype, a dtype, decay)
        ("main", MBATCH, MPROMPT, 32, 64, 128, 256, torch.bfloat16,
         torch.float32, 0.3),
        ("fp32", 2, 512, 8, 64, 128, 256, torch.float32, torch.float32, 0.3),
        ("one_chunk", 4, 256, 32, 64, 128, 256, torch.bfloat16,
         torch.float32, 0.3),
        ("p32_n16", 2, 256, 16, 32, 16, 32, torch.bfloat16, torch.bfloat16,
         0.3),
        ("p16_n8", 2, 128, 4, 16, 8, 16, torch.float32, torch.float32, 0.3),
        ("decay", 2, 1024, 8, 64, 128, 256, torch.bfloat16, torch.float32,
         4.0),
        ("sequential", 1, 128, 4, 64, 128, 64, torch.float32, torch.float32,
         0.3),
    ]
    out = []
    for name, B, S, H, P, N, chunk, dt, adt, decay in cases:
        x = (0.5 * torch.randn(B, S, H, P, generator=g, device=dev)).to(dt)
        a = (-decay * torch.randn(B, S, H, generator=g, device=dev).abs()
             ).to(adt)
        b = (torch.randn(B, S, N, generator=g, device=dev) * N ** -0.25
             ).to(dt)
        c = (torch.randn(B, S, N, generator=g, device=dev) * N ** -0.25
             ).to(dt)
        y, fin = ssd.ssd_scan(x, a, b, c, chunk)
        f32 = [t.float() for t in (x, a, b, c)]
        if name == "sequential":
            want = ref.ssd_sequential_ref(*f32)
        else:
            want = ref.ssd_scan_ref(*f32, chunk)
        torch.cuda.synchronize()
        err = max((got.float() - w).abs().max().item()
                  for got, w in zip((y, fin), want))
        rec = {"case": name, "shape": [B, S, H, P, N], "chunk": chunk,
               "dtype": str(dt), "a_dtype": str(adt), "decay": decay,
               "max_err": err, "tol": TOL_SSD[dt],
               "max_abs_y": y.float().abs().max().item()}
        if name == "main":
            rec["ms"] = time_ms(lambda: ssd.ssd_scan(x, a, b, c, chunk),
                                iters=10)
            rec["plain_ms"] = time_ms(lambda: ref.ssd_scan_ref(
                x, a, b, c, chunk), iters=5)
            rec["library_ms"] = None      # no one PyTorch call computes it
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


def check_paged(dev, peaks, g):
    cpu_g = torch.Generator().manual_seed(11)
    bt_main, P_main = forked_tables(GROUPS, GPROMPT, GSIZE, GEN, PAGE)
    cases = [  # (name, B, H, K, D, ps, nb, P, dtype); nb/P None: forked
        ("main", GROUPS * GSIZE, 24, 8, 128, PAGE, None, None,
         torch.bfloat16),
        ("ragged", GROUPS * GSIZE, 24, 8, 128, PAGE, None, None,
         torch.bfloat16),
        ("holes", 8, 24, 8, 128, 16, 6, 49, torch.bfloat16),
        ("d64", 6, 8, 2, 64, 16, 5, 31, torch.bfloat16),
        ("k_eq_h", 4, 8, 8, 128, 8, 7, 29, torch.bfloat16),
        ("k1_fp32", 5, 8, 1, 128, 4, 9, 46, torch.float32),
        ("fp32_d64", 4, 6, 2, 64, 16, 6, 25, torch.float32),
    ]
    out = []
    for name, B, H, K, D, ps, nb, P, dt in cases:
        if nb is None:
            bt, P = bt_main, P_main + 1           # + the pool's drop page
            last = GPROMPT + GEN - 2
            position = torch.full((B,), last, dtype=torch.int32)
            if name == "ragged":                  # one row per decode step
                position = GPROMPT + torch.arange(B, dtype=torch.int32) % (
                    GEN - 1)
        else:
            bt, position = holey_tables(B, nb, ps, P, cpu_g)
        q = torch.randn(B, H, D, generator=g, device=dev).to(dt)
        kp = torch.randn(P, ps, K, D, generator=g, device=dev).to(dt)
        vp = torch.randn(P, ps, K, D, generator=g, device=dev).to(dt)
        bt, position = bt.to(dev), position.to(dev)
        got = pa.paged_decode_attention(q, kp, vp, bt, position)
        want = ref.paged_attention_ref(q, kp, vp, bt, position)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rec = {"case": name, "shape": [B, H, K, D, P, ps, bt.shape[1]],
               "dtype": str(dt), "max_err": err, "tol": TOL[dt]}
        if name == "main":
            n_bytes, n_ops, row_bytes, n_pages = paged_work(
                bt.cpu(), position.cpu(), ps, K, D, H, q.element_size())
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
            rec["bound_ms"], rec["bound_by"] = bound(peaks, n_bytes, n_ops,
                                                     dt)
            rec.update(unique_pages=n_pages, unique_mib=n_bytes / 2**20,
                       per_row_mib=row_bytes / 2**20)
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
                   "paged_decode_attention": L * (GEN - 1), "ssd_scan": 0}
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
        return tree.to(device)
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
            "rmsnorm": (2 * L + 1) * GEN * MREQUESTS}
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
            "idle_share": 1 - busy_s / wall,
            "top": [{"us": r[0], "count": r[1], "name": r[2]}
                    for r in rows[:15]]}, table


def print_profile(label, prof):
    print(f"[smoke] profiled {label}: wall "
          f"{prof['profiled_wall_s'] * 1e3:.1f} ms, kernels busy "
          f"{prof['kernel_busy_s'] * 1e3:.1f} ms, idle share "
          f"{prof['idle_share']:.3f}")
    for row in prof["top"][:10]:
        print(f"  {row['us'] / 1e3:9.3f} ms {row['count']:6d}x "
              f"{row['name'][:90]}")


# ------------------------------------------------------------------- main
def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="also profile one dense, one paged GRPO and one "
                         "Mamba2 request with torch.profiler")
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
    print(f"[smoke] torch {torch.__version__} cuda {torch.version.cuda} "
          f"triton {triton_v} (unused); peaks {peaks}")
    path, log, secs = build.build()
    (OUT_DIR / "ptxas.txt").write_text(log)
    print(f"[smoke] built {path.relative_to(ROOT)} in {secs:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {line.strip()}")
    report.update(card=smi, torch=torch.__version__, cuda=torch.version.cuda,
                  build_s=secs)

    # phase 2: kernels against their plain versions
    g = torch.Generator(device=dev).manual_seed(0)
    checks = {"flash_attention": check_flash(dev, peaks, g),
              "decode_attention": check_decode(dev, peaks, g),
              "paged_decode_attention": check_paged(dev, peaks, g),
              "rmsnorm": check_rmsnorm(dev, peaks, g),
              "ssd_scan": check_ssd(dev, peaks, g)}
    failures = []
    for kname, recs in checks.items():
        for r in recs:
            line = (f"[smoke] {kname:16s} {r['case']:13s} max_err "
                    f"{r['max_err']:.3e} (tol {r['tol']:g})")
            if "ms" in r:
                lib = "none" if r["library_ms"] is None else \
                    f"{r['library_ms']:.4f} ms"
                line += (f"  kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f}"
                         f" ms  library {lib}  bound "
                         f"{r['bound_ms'] * 1e3:.1f} us ({r['bound_by']})")
                if "yardstick_ms" in r:
                    line += (f"  gather+SDPA {r['yardstick_ms']:.4f} ms; "
                             f"{r['unique_pages']} distinct pages "
                             f"{r['unique_mib']:.1f} MiB, per row "
                             f"{r['per_row_mib']:.1f} MiB")
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
            "rmsnorm": (2 * L + 1) * GEN * REQUESTS}
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
    paths = {"serve": launches, "paged_grpo": grpo["launches"],
             "mamba_serve": mamba["launches"]}

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

    kernels = []
    main_path = {"paged_decode_attention": "paged_grpo",
                 "ssd_scan": "mamba_serve"}
    for kname, mod in (("flash_attention", fa), ("decode_attention", dec),
                       ("paged_decode_attention", pa), ("rmsnorm", rn),
                       ("ssd_scan", ssd)):
        main_rec = checks[kname][0]
        path = main_path.get(kname, "serve")
        kernels.append({
            "name": kname, "route": "cuda", "source": mod.SOURCE,
            "replaces": mod.REPLACES, "launches": paths[path][kname],
            "path": path,
            "launches_by_path": {p: c[kname] for p, c in paths.items()},
            "max_abs_err": max(r["max_err"] for r in checks[kname]),
            "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"],
            "bound_by": main_rec["bound_by"],
            "library_ms": main_rec["library_ms"],
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
