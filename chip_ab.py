#!/usr/bin/env python3
"""Device times of the port's B1 (RMSNorm) and B5 (SSD chunk scan) kernels
by CUDA-graph replay, to compare versions of them on one card in one call.

    python3 chip_ab.py TREE [TREE ...]   # each checkout in turn
    python3 chip_ab.py --ablate          # B5 with one part of its work cut

With checkouts (directories holding ``src/repro_torch``, e.g. a parent
commit unpacked by ``git archive`` and ``.``), each is timed in a process
of its own, in the order given (parent, change, change, parent, to see the
drift): B1 and ``F.rms_norm`` at every shape the serving, paged GRPO and
Mamba2 paths give B1, and B5 at the Mamba2 prefill's shape, warm and cold
as ``chip_smoke.py`` times them. With ``--ablate``, B5's source in this
checkout is compiled again with one of its steps removed at a time (the
results are wrong; only the time counts) and each variant is timed: the
time a step's removal saves is an upper bound on what making it faster
can give. Needs one NVIDIA card and nvcc; prints one JSON line a run.
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

# B5 ablations: (name, source text, replacement) in csrc/ssd_scan.cu
ABLATIONS = [
    ("no_CBt", """#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk)
          sm90::wgmma_ss_m64n64<0>(sc, desc_k(ct, kk), desc_k(bt, kk), kk > 0);""",
     """#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = 0.01f;"""),
    ("no_L_exp", "const float l = sm90::exp2_approx(ai[hf] - aj);",
     "const float l = aj;"),
    ("no_y_off", "      if (ci > 0) {\n        sm90::fence_regs(acc);",
     "      if (ci < 0) {\n        sm90::fence_regs(acc);"),
    ("no_state_update", """            if constexpr (N == 128)
              sm90::wgmma_ss_m64n128<1, 1>(st, desc_mn(xd, kk),
                                           desc_mn(bt, kk), 1);
            else
              sm90::wgmma_ss_m64n64<1, 1>(st, desc_mn(xd, kk),
                                          desc_mn(bt, kk), 1);""", ""),
    ("no_x_product", """#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            sm90::wgmma_rs_m64n64<1>(acc, pa[kk], desc_mn(xt, kk));
          sm90::wgmma_commit();""", "          sm90::wgmma_commit();"),
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


def time_tree(tree: pathlib.Path) -> dict:
    """B1 against F.rms_norm and B5, warm and cold, in checkout ``tree``."""
    sys.path.insert(0, str(tree / "src"))
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as ssd
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
    chunk = SSD_SHAPE[-1]
    sliced = hasattr(ssd, "bc_row_stride")    # reads b and c in place
    out["ssd_scan_us"] = warm_cold_us(
        torch, lambda *t: ssd.ssd_scan(*t, chunk),
        lambda: ssd_inputs(torch, sliced))
    return out


def ablate() -> list:
    """B5 of this checkout whole and with each of ``ABLATIONS`` removed."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.kernels import build, ssd_scan as ssd
    work = ROOT / "build" / "ablate"
    work.mkdir(parents=True, exist_ok=True)
    source = (build.CSRC / "ssd_scan.cu").read_text()
    variants = [("whole", source)]
    for name, old, new in ABLATIONS:
        if source.count(old) != 1:
            raise SystemExit(f"ablation {name}: its text is not in the source "
                             "exactly once")
        variants.append((name, source.replace(old, new)))
    procs = []
    for name, text in variants:
        (work / f"{name}.cu").write_text(text)
        cmd = [build.nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-shared",
               str(work / f"{name}.cu"), "-o", str(work / f"{name}.so")]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    for (name, _), proc in zip(variants, procs):
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
    chunk = SSD_SHAPE[-1]
    out = []
    for name, _ in variants:
        lib = ctypes.CDLL(str(work / f"{name}.so"))
        build.lib = lambda lib=lib: lib        # the wrapper loads this one
        ssd._fn.cache_clear()
        out.append({"variant": name, "ssd_scan_us": warm_cold_us(
            torch, lambda *t: ssd.ssd_scan(*t, chunk),
            lambda: ssd_inputs(torch))})
        print(json.dumps(out[-1]), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*", type=pathlib.Path)
    ap.add_argument("--ablate", action="store_true")
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
    if args.ablate:
        ablate()
    return 0


if __name__ == "__main__":
    sys.exit(main())
