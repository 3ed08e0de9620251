#!/usr/bin/env python3
"""Device times of the port's B1 (RMSNorm), B2 (flash attention), B4
(paged decode), B5 (SSD chunk scan), B2-bwd (flash-attention backward)
and B1-bwd (RMSNorm backward) kernels by CUDA-graph replay, to compare
versions of them on one card in one call.

    python3 chip_ab.py TREE [TREE ...]   # each checkout in turn
    python3 chip_ab.py --ablate          # B5, B4, B2-bwd, B1-bwd: one part cut
    python3 chip_ab.py --ablate rmsnorm.cu   # one source only

With checkouts (directories holding ``src/repro_torch``, e.g. a parent
commit unpacked by ``git archive`` and ``.``), each is timed in a process
of its own, in the order given (parent, change, change, parent, to see the
drift): B1 and ``F.rms_norm`` at every shape the serving, paged GRPO and
Mamba2 paths give B1, B2 at the serving prefill's and the two PPO paths'
training shapes (head widths 128 and 64, the latter two with lse) and,
where the checkout takes it, at phase 18's MLA widths (q/k 192, v 128),
B4 at the paged GRPO rollout's last decode step over
its own forked block table and over one that puts every row on pages of
its own, B5 at the Mamba2 prefill's shape, and B2-bwd at the PPO
training shape beside SDPA's backward (fwd + bwd less fwd, both graphed)
and at the separate path's (head width 64),
and B1-bwd with dscale at the separate PPO path's two widths and without
it at the hydra path's training rows, each beside ``F.rms_norm``'s
backward (fwd + bwd less fwd), warm and cold as ``chip_smoke.py`` times
them. With ``--ablate``, B5's, B4's, B2-bwd's and B1-bwd's sources in this
checkout are compiled again with one of their steps removed at a time (the results are wrong; only the time
counts) and each variant is timed: the time a step's removal saves is an
upper bound on what making it faster can give. Needs one NVIDIA card and nvcc; prints one JSON line a run.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent

# (rows, width) of every B1 call on the three paths (chip_smoke.py)
RMSNORM_SHAPES = [(4096, 3072), (8, 3072), (4032, 3072), (64, 3072),
                  (16384, 1024), (16384, 2048), (8, 2048)]
SSD_SHAPE = (8, 2048, 32, 64, 128, 256)     # B, S, H, P, N, chunk
# B4: 8 prompts of 504 tokens forked 8 ways, 63 tokens appended (position
# 566), pages of 16: q [64,24,128], pools [P,16,8,128] bf16, tables [64,36]
PAGED = dict(groups=8, prompt=504, fork=8, appended=63, page=16, heads=24,
             kv_heads=8, head_dim=128)

# Ablations: (name, [(source text, replacement), ...]), each variant
# compiled with its texts replaced. B5's in csrc/ssd_scan.cu:
SSD_ABLATIONS = [
    ("no_CBt", [("""#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk)
          sm90::wgmma_ss_m64n64<0>(sc, desc_k(ct, kk), desc_k(bt, kk), kk > 0);""",
                 """#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = 0.01f;""")]),
    ("no_L_exp", [("const float l = sm90::exp2_approx(ai[hf] - aj);",
                   "const float l = aj;")]),
    ("no_y_off", [("      if (ci > 0) {\n        sm90::fence_regs(acc);",
                   "      if (ci < 0) {\n        sm90::fence_regs(acc);")]),
    ("no_state_update", [("""            if constexpr (N == 128)
              sm90::wgmma_ss_m64n128<1, 1>(st, desc_mn(xd, kk),
                                           desc_mn(bt, kk), 1);
            else
              sm90::wgmma_ss_m64n64<1, 1>(st, desc_mn(xd, kk),
                                          desc_mn(bt, kk), 1);""", "")]),
    ("no_x_product", [("""#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            sm90::wgmma_rs_m64n64<1>(acc, pa[kk], desc_mn(xt, kk));
          sm90::wgmma_commit();""", "          sm90::wgmma_commit();")]),
]
# B4's (bf16) in csrc/paged_attention.cu: its scores and softmax, its PV,
# both (the copy pipeline and the loop alone), and the merge kernel
# triggered at the end of each block rather than at its start
_B4_SCORES = """        softmax_mma<D, G>(tile, qf, prow, lane, cnt, nvalid,
                          qscale * kLog2e, m, l, alpha);"""
_B4_NO_SCORES = """#pragma unroll
        for (int g = 0; g < G; ++g) alpha[g] = 1.f;"""
_B4_PV = "        pv_mma<D, G>(oacc, alpha, prow, tile + KV, lane);"
_B4_TRIGGER = """  asm volatile("griddepcontrol.launch_dependents;\\n" ::: "memory");
"""
_B4_END = "  if (r >= nrows) return;\n  const int b = b0 + r;"
PAGED_ABLATIONS = [
    ("no_scores", [(_B4_SCORES, _B4_NO_SCORES)]),
    ("no_pv", [(_B4_PV, "")]),
    ("no_arith", [(_B4_SCORES, _B4_NO_SCORES), (_B4_PV, "")]),
    ("late_merge_trigger", [(_B4_TRIGGER, ""),
                            (_B4_END, _B4_TRIGGER + _B4_END)]),
]

# B2: (name, B, S, H, K, D, Dv, lse) at phase 2's shapes: the serving
# prefill, the hydra and separate PPO training (with lse), and phase 18's
# MLA serving prefill (a checkout whose B2 takes (192, 128))
FWD_SHAPES = [("serve", 8, 512, 24, 8, 128, 128, False),
              ("ppo", 8, 576, 24, 8, 128, 128, True),
              ("sep_actor", 8, 512, 32, 32, 64, 64, True),
              ("mla_serve", 8, 512, 128, 128, 192, 128, False)]
# B2-bwd: the PPO training shape, q/out/dout [8,576,24,128], k/v
# [8,576,8,128], bf16, causal; and the separate path's at head width 64
BWD_SHAPE = (8, 576, 24, 8, 128)          # B, S, H, K, D
BWD_SEP_SHAPE = (8, 512, 32, 32, 64)
# its ablations in csrc/flash_attention_bwd.cu (the bf16 route): the dQ
# kernel's recompute of S and dP, the exponent of both kernels, and each
# kernel whole (the prep pass alone is the time left with neither)
_DQ_LAUNCH = "  flash_bwd_dq_wgmma_kernel<D><<<n_dq"
_DKDV_LAUNCH = "  flash_bwd_dkdv_wgmma_kernel<D><<<n_dkdv"
BWD_ABLATIONS = [
    ("no_dq_recompute", [("""    issue_abt<D>(sc, qs, kt);
    issue_abt<D>(dp, dos, vt);
""", "")]),
    ("no_exp", [
        ("sm90::exp2_approx(fmaf(sc[i], scale_log2, e ? -l.y : -l.x))",
         "sc[i]"),
        ("sm90::exp2_approx(fmaf(sc[i], scale_log2, -lr[hf]))", "sc[i]")]),
    ("no_dq_kernel", [(_DQ_LAUNCH, "  if (0)" + _DQ_LAUNCH[1:])]),
    ("no_dkdv_kernel", [(_DKDV_LAUNCH, "  if (0)" + _DKDV_LAUNCH[1:])]),
]

# B1-bwd: (rows, width, dscale) of the separate PPO path's two widths
# (opt_1_3b and opt_350m, 8 x 512 rows, every norm scale trained) and of
# the hydra path's training rows (llama3_2_3b, 8 x 576, the trunk frozen)
RMSNORM_BWD_SHAPES = [(4096, 2048, True), (4096, 1024, True),
                      (4608, 3072, False)]
# its ablations in csrc/rmsnorm.cu (the vector route): the dscale column
# sum inside the fused pass, the block's sum of its warps, the kernel that
# sums the blocks' partial rows
RMSNORM_BWD_ABLATIONS = [
    ("no_dscale_accumulate", [(
        "            acc[k * V + e] = fmaf(g[e], f[e] * r, acc[k * V + e]);",
        "            acc[k * V + e] += 0.f;")]),
    ("no_block_partial", [("    block_partial<true>(slab, part, W, D);", "")]),
    ("no_sum_kernel", [(
        "  cudaError_t err = cudaLaunchKernelEx(",
        "  cudaError_t err = cudaSuccess;\n  if (0) err = cudaLaunchKernelEx(")]),
]


def time_graph_ms(torch, fn, n_sets=1, rounds=10):
    """As chip_smoke.time_graph_ms: device ms of one ``fn(i)``."""
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
    return start.elapsed_time(end) / (rounds * n_sets)


def warm_cold_us(torch, fn, make_set):
    """As chip_smoke.time_graph_warm_cold, in us."""
    first = make_set()
    warm = time_graph_ms(torch, lambda i: fn(*first))
    set_bytes = sum(t.numel() * t.element_size() for t in first)
    n = max(3, min(2048, -(-100 * 2**20 // set_bytes)))
    sets = [first] + [make_set() for _ in range(n - 1)]
    cold = time_graph_ms(torch, lambda i: fn(*sets[i]), n,
                         rounds=max(1, 2000 // n))
    return [round(warm * 1e3, 2), round(cold * 1e3, 2)]


def ssd_inputs(torch, sliced=True):
    """x, a, b, c for B5; b and c as column slices of one xbc tensor (the
    Mamba2 block's layout), or contiguous for a version that needs them
    so (the Mamba2 block copied them before PR 15)."""
    B, S, H, P, N, _ = SSD_SHAPE
    x = (0.5 * torch.randn(B, S, H, P, device="cuda")).bfloat16()
    a = -0.3 * torch.randn(B, S, H, device="cuda").abs()
    xbc = (torch.randn(B, S, H * P + 2 * N, device="cuda")
           * N ** -0.25).bfloat16()
    b, c = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    if not sliced:
        b, c = b.contiguous(), c.contiguous()
    return x, a, b, c


def paged_tables(torch, PageManager):
    """{name: (block tables [64,36] int32, pool pages)}: the paged GRPO
    rollout's own forked table (the checkout's page manager, as
    ``chip_smoke.forked_tables`` builds it) and an all-distinct one."""
    c = PAGED
    B = c["groups"] * c["fork"]
    nb = -(-(c["prompt"] + c["appended"] + 1) // c["page"])
    pm = PageManager(c["groups"] * -(-c["prompt"] // c["page"]) +
                     B * (nb - c["prompt"] // c["page"]), c["page"])
    for g in range(c["groups"]):
        pm.allocate(g * c["fork"], c["prompt"])
        for i in range(1, c["fork"]):
            pm.fork(g * c["fork"], g * c["fork"] + i)
    for _ in range(c["appended"]):
        for s in range(B):
            pm.append_token(s)
    forked = torch.from_numpy(pm.block_table_array(range(B), nb))
    distinct = torch.arange(B * nb, dtype=torch.int32).reshape(B, nb)
    return {"forked": (forked, pm.num_pages + 1),
            "distinct": (distinct, B * nb + 1)}


def paged_us(torch, pa, PageManager) -> dict:
    """B4 (the wrapper module ``pa``) warm and cold, us, over both of
    :func:`paged_tables`."""
    c = PAGED
    B = c["groups"] * c["fork"]
    position = torch.full((B,), c["prompt"] + c["appended"] - 1,
                          dtype=torch.int32, device="cuda")
    out = {}
    for name, (bt, P) in paged_tables(torch, PageManager).items():
        bt = bt.cuda()

        def make(P=P):
            return (torch.randn(B, c["heads"], c["head_dim"],
                                device="cuda").bfloat16(),
                    *(torch.randn(P, c["page"], c["kv_heads"], c["head_dim"],
                                  device="cuda").bfloat16()
                      for _ in range(2)))
        out[f"paged_decode {name}_us"] = warm_cold_us(
            torch, lambda q, k, v, bt=bt: pa.paged_decode_attention(
                q, k, v, bt, position), make)
    return out


def flash_fwd_us(torch, fa) -> dict:
    """B2 (the wrapper module ``fa``) warm and cold, us, at each of
    ``FWD_SHAPES`` the checkout takes."""
    out = {}
    for name, B, S, H, K, D, Dv, lse in FWD_SHAPES:
        pairs = [p if isinstance(p, tuple) else (p, p) for p in fa.HEAD_DIMS]
        if (D, Dv) not in pairs:
            continue

        def make(B=B, S=S, H=H, K=K, D=D, Dv=Dv):
            return (torch.randn(B, S, H, D, device="cuda").bfloat16(),
                    torch.randn(B, S, K, D, device="cuda").bfloat16(),
                    torch.randn(B, S, K, Dv, device="cuda").bfloat16())
        out[f"flash_fwd {name}_us"] = warm_cold_us(
            torch, lambda q, k, v, lse=lse: fa.flash_attention_fwd(
                q, k, v, causal=True, return_lse=lse), make)
    return out


def bwd_inputs(torch, fa, shape=BWD_SHAPE):
    """q, k, v, out, lse, dout of B2-bwd at ``shape``, out and lse from
    B2's forward (the checkout's ``fa``)."""
    B, S, H, K, D = shape
    q = torch.randn(B, S, H, D, device="cuda").bfloat16()
    k, v = (torch.randn(B, S, K, D, device="cuda").bfloat16()
            for _ in range(2))
    dout = torch.randn(B, S, H, D, device="cuda").bfloat16()
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True, return_lse=True)
    return q, k, v, out, lse, dout


def sdpa_fwd_bwd(torch, F, q, k, v, dout, backward=True):
    """SDPA in [B, heads, S, D] with grouped KV heads, causal, and its
    backward through autograd (the yardstick; captured whole)."""
    qq, kk, vv = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    o = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True,
                                       enable_gqa=True)
    if backward:
        torch.autograd.grad(o, (qq, kk, vv), dout.transpose(1, 2))


def flash_bwd_us(torch, fa, fab) -> dict:
    """B2-bwd (the wrapper module ``fab``) warm and cold, us, and SDPA's
    backward as its fwd + bwd less its fwd, each graphed."""
    import torch.nn.functional as F
    out = {"flash_bwd_us": warm_cold_us(
        torch, lambda *t: fab.flash_attention_bwd(*t, causal=True),
        lambda: bwd_inputs(torch, fa))}
    both = warm_cold_us(
        torch, lambda q, k, v, o, l, d: sdpa_fwd_bwd(torch, F, q, k, v, d),
        lambda: bwd_inputs(torch, fa))
    fwd = warm_cold_us(
        torch, lambda q, k, v, o, l, d: sdpa_fwd_bwd(torch, F, q, k, v, d,
                                                     backward=False),
        lambda: bwd_inputs(torch, fa))
    out["sdpa_fwd_bwd_us"] = both
    out["sdpa_bwd_us"] = [round(a - b, 2) for a, b in zip(both, fwd)]
    return out


def rms_fwd_bwd(torch, F, x, s, dy, dscale, backward=True):
    """F.rms_norm and, with ``backward``, its backward through autograd,
    with the weight's gradient when ``dscale`` (the yardstick; captured
    whole)."""
    xx, ss = x.detach().requires_grad_(), s.detach().requires_grad_(dscale)
    y = F.rms_norm(xx, (x.shape[-1],), ss, 1e-5)
    if backward:
        torch.autograd.grad(y, (xx, ss) if dscale else (xx,), dy)


def rmsnorm_bwd_us(torch, rn, library=True) -> dict:
    """B1-bwd (the wrapper module ``rn``) warm and cold, us, at each of
    ``RMSNORM_BWD_SHAPES``, and F.rms_norm's backward as its fwd + bwd less
    its fwd, each graphed."""
    import torch.nn.functional as F
    out = {}
    for rows, D, dscale in RMSNORM_BWD_SHAPES:
        scale = (1 + 0.1 * torch.randn(D, device="cuda")).bfloat16()

        def make(rows=rows, D=D, scale=scale):
            return (torch.randn(rows, D, device="cuda").bfloat16(), scale,
                    torch.randn(rows, D, device="cuda").bfloat16())
        key = f"rmsnorm_bwd {rows}x{D}" + (" dscale" if dscale else "")
        out[key] = {"kernel_us": warm_cold_us(
            torch, lambda x, s, g, ds=dscale: rn.rmsnorm_bwd(
                x, s, g, 1e-5, dscale=ds), make)}
        if library:
            both, fwd = (warm_cold_us(
                torch, lambda x, s, g, ds=dscale, b=b: rms_fwd_bwd(
                    torch, F, x, s, g, ds, backward=b), make)
                for b in (True, False))
            out[key]["library_us"] = [round(a - b, 2)
                                      for a, b in zip(both, fwd)]
    return out


def time_tree(tree: pathlib.Path) -> dict:
    """B1 against F.rms_norm, B2, B4, B5, B2-bwd against SDPA's backward
    and B1-bwd against F.rms_norm's, warm and cold, in checkout
    ``tree``."""
    sys.path.insert(0, str(tree / "src"))
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.paged import PageManager
    if not pathlib.Path(rn.__file__).is_relative_to(tree):
        raise SystemExit(f"imported {rn.__file__}, not from {tree}")
    out = {"tree": str(tree)}
    for rows, D in RMSNORM_SHAPES:
        scale = (1 + 0.1 * torch.randn(D, device="cuda")).bfloat16()

        def make(rows=rows, D=D, scale=scale):
            return torch.randn(rows, D, device="cuda").bfloat16(), scale
        out[f"rmsnorm {rows}x{D}"] = {
            "kernel_us": warm_cold_us(torch, lambda x, s: rn.rmsnorm(x, s),
                                      make),
            "library_us": warm_cold_us(
                torch, lambda x, s, D=D: F.rms_norm(x, (D,), s, 1e-5), make)}
    out.update(paged_us(torch, pa, PageManager))
    chunk = SSD_SHAPE[-1]
    sliced = hasattr(ssd, "bc_row_stride")    # reads b and c in place
    out["ssd_scan_us"] = warm_cold_us(
        torch, lambda *t: ssd.ssd_scan(*t, chunk),
        lambda: ssd_inputs(torch, sliced))
    out.update(flash_fwd_us(torch, fa))
    out.update(flash_bwd_us(torch, fa, fab))
    out["flash_bwd sep_actor_us"] = warm_cold_us(
        torch, lambda *t: fab.flash_attention_bwd(*t, causal=True),
        lambda: bwd_inputs(torch, fa, BWD_SEP_SHAPE))
    out.update(rmsnorm_bwd_us(torch, rn))
    return out


def ablate(only=()) -> list:
    """B5, B4, B2-bwd and B1-bwd of this checkout (or the sources named in
    ``only``), each whole and with each of its ablations applied
    (``SSD_ABLATIONS``, ``PAGED_ABLATIONS``, ``BWD_ABLATIONS``,
    ``RMSNORM_BWD_ABLATIONS``)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.kernels import build, ssd_scan as ssd
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.paged import PageManager
    fa._fn()        # B2's forward (the inputs of B2-bwd) from the whole build
    work = ROOT / "build" / "ablate"
    work.mkdir(parents=True, exist_ok=True)
    chunk = SSD_SHAPE[-1]
    kernels = {   # source: (ablations, wrapper module, timing)
        "ssd_scan.cu": (SSD_ABLATIONS, ssd, lambda: {
            "ssd_scan_us": warm_cold_us(
                torch, lambda *t: ssd.ssd_scan(*t, chunk),
                lambda: ssd_inputs(torch))}),
        "paged_attention.cu": (PAGED_ABLATIONS, pa,
                               lambda: paged_us(torch, pa, PageManager)),
        "flash_attention_bwd.cu": (BWD_ABLATIONS, fab,
                                   lambda: flash_bwd_us(torch, fa, fab)),
        "rmsnorm.cu": (RMSNORM_BWD_ABLATIONS, rn, lambda: rmsnorm_bwd_us(
            torch, rn, library=False)),
    }
    if only:
        kernels = {src: kernels[src] for src in only}
    variants = []                    # (source, name, text)
    for src, (ablations, _, _) in kernels.items():
        source = (build.CSRC / src).read_text()
        variants.append((src, "whole", source))
        for name, edits in ablations:
            text = source
            for old, new in edits:
                if text.count(old) != 1:
                    raise SystemExit(f"ablation {name}: its text is not in "
                                     f"{src} exactly once")
                text = text.replace(old, new)
            variants.append((src, name, text))
    procs = []
    for src, name, text in variants:
        stem = f"{pathlib.Path(src).stem}_{name}"
        (work / f"{stem}.cu").write_text(text)
        cmd = [build.nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-shared",
               str(work / f"{stem}.cu"), "-o", str(work / f"{stem}.so")]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    for (src, name, _), proc in zip(variants, procs):
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {src} {name}:\n{log}")
    out = []
    for src, name, _ in variants:
        _, module, time_fn = kernels[src]
        lib = ctypes.CDLL(str(work / f"{pathlib.Path(src).stem}_{name}.so"))
        build.lib = lambda lib=lib: lib        # the wrapper loads this one
        for entry in ("_fn", "_bwd_fn"):
            if hasattr(module, entry):
                getattr(module, entry).cache_clear()
        out.append({"source": src, "variant": name, **time_fn()})
        print(json.dumps(out[-1]), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*", type=pathlib.Path)
    ap.add_argument("--ablate", nargs="*", metavar="SOURCE",
                    help="ablate these sources' kernels (all when none "
                         "is named)")
    ap.add_argument("--one", type=pathlib.Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    if args.one:
        print(json.dumps(time_tree(args.one.resolve())), flush=True)
        return 0
    for tree in args.trees:          # a process each: one repro_torch each
        subprocess.run([sys.executable, __file__, "--one", str(tree)],
                       check=True)
    if args.ablate is not None:
        ablate(args.ablate)
    return 0


if __name__ == "__main__":
    sys.exit(main())
