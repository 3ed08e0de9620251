"""Batched serving on the PyTorch/CUDA port — the twin of
``examples/serving.py``: prefill + decode with the fixed-capacity KV cache
(``Rollout``), printing live memory per request, which stays flat.

With ``--backend paged`` the same traffic runs through the continuous
batcher on the paged KV cache (``repro_torch.serving.ContinuousBatcher``):
ragged-length requests are admitted against a global page pool and the
example prints the pages in use as the pool breathes.

``--capture-buckets 8,16,32`` pads prompts (and paged live-slot batches)
to a bucket ladder; ``--spec-decode`` turns on MTP self-speculative
greedy decoding (the same tokens as greedy decoding, fewer decode steps).
``--prefix-cache`` shares one system prompt across all requests so later
arrivals reuse its KV pages; ``--tenants gold,silver,bronze`` splits the
traffic across tenants under weighted round-robin admission with aging.
``--watermark`` and ``--attrib-out`` arm the memory telemetry of the
paged batcher (the flight recorder, the owner table and each program's
memory). On the card (the default device; it raises without one) every
decode step replays one CUDA graph a live-slot rung.

    PYTHONPATH=src python examples/torch_serving.py --device cpu
    PYTHONPATH=src python examples/torch_serving.py --device cpu \
        --backend paged --spec-decode --capture-buckets 8,16,32
    PYTHONPATH=src python examples/torch_serving.py --device cpu \
        --backend paged --prefix-cache --tenants gold,silver,bronze
    PYTHONPATH=src python examples/torch_serving.py --backend paged
"""
import argparse
import dataclasses
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import default_device  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import PromptDataset, \
    synthetic_instruction_prompts  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.rlhf import Rollout, live_device_bytes  # noqa: E402
from repro_torch.serving import ContinuousBatcher  # noqa: E402


def _fast_decode_cfg(args, cfg):
    """Parse the bucket list and give the config an MTP head when
    speculation is asked for."""
    buckets = tuple(int(b) for b in args.capture_buckets.split(",")) \
        if args.capture_buckets else None
    if args.spec_decode and cfg.mtp_depth == 0:
        cfg = dataclasses.replace(cfg, mtp_depth=args.spec_k)
    return cfg, buckets


def _mib(n):
    return "n/a" if n is None else f"{n / 2**20:.1f} MiB"


def paged_demo(args, dev):
    cfg, buckets = _fast_decode_cfg(args, get_config(args.arch).smoke())
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    capacity = 24 + args.gen + (args.spec_k if args.spec_decode else 0)
    temperature, top_k = (0.0, 0) if args.spec_decode else (0.8, 40)
    telemetry = None
    if args.watermark or args.attrib_out:
        from repro_torch.obs import FlightRecorder, RunTelemetry
        flight = FlightRecorder(watermark=args.watermark) \
            if args.watermark else None
        telemetry = RunTelemetry.create(run="serving", arch=args.arch,
                                        backend="paged", flight=flight)
    tenants = [t for t in args.tenants.split(",") if t] or ["default"]
    weights = {t: float(len(tenants) - i) for i, t in enumerate(tenants)}
    cb = ContinuousBatcher(model, cfg, params, slots=args.batch,
                           capacity=capacity, temperature=temperature,
                           top_k=top_k, cache_backend="paged", page_size=16,
                           capture_buckets=buckets,
                           spec_decode=args.spec_decode, spec_k=args.spec_k,
                           prefix_cache=args.prefix_cache,
                           tenant_weights=weights, telemetry=telemetry)
    rng = np.random.RandomState(0)
    n_req = args.batch * args.requests
    # with --prefix-cache every request shares one 16-token system prompt,
    # so only the first prefills it; the rest reuse its pages
    system = rng.randint(0, cfg.vocab_size, size=16)
    for i in range(n_req):
        # ragged: every request decodes a different number of tokens
        tail = rng.randint(0, cfg.vocab_size, size=8)
        prompt = np.concatenate([system, tail]) if args.prefix_cache \
            else rng.randint(0, cfg.vocab_size, size=24)
        cb.submit(prompt, int(rng.randint(args.gen // 4, args.gen)),
                  tenant=tenants[i % len(tenants)])
    print(f"serving {cfg.name} [paged] on {dev} | pool {cb.pm.num_pages} "
          f"pages x {cb.pm.page_size} tokens")
    done, t0 = 0, time.time()
    while done < n_req:
        done += len(cb.step())
        if cb.steps % 8 == 0 or done == n_req:
            st = cb.pm.stats
            print(f"step {cb.steps:4d}: done {done:3d}/{n_req}  "
                  f"pages {st.pages_in_use:3d}/{st.num_pages}  "
                  f"reserved {cb.pm.reserved_bytes()/2**20:6.2f} MiB  "
                  f"frag {cb.pm.fragmentation_slots():3d} slots")
    if buckets or args.spec_decode:
        print("compile cache:", cb.compile_cache.stats())
        print("decode graphs:", cb.graph_stats())
    if args.prefix_cache:
        print(f"prefix cache: hit rate {cb.prefix_hit_rate():.3f} "
              f"({cb.pm.stats.n_prefix_hits} page hits, "
              f"{cb.pm.stats.n_prefix_evictions} evictions)")
    dense_bytes = cb.B * capacity * (cb.pm.bytes_per_token or 1)
    print(f"drained in {time.time()-t0:.1f}s | peak "
          f"{st.peak_pages_in_use * cb.pm.page_bytes / 2**20:.2f} MiB paged "
          f"vs {dense_bytes/2**20:.2f} MiB dense [B, capacity]")
    if args.attrib_out and telemetry is not None \
            and telemetry.attribution is not None:
        fl = telemetry.flight
        bundle = {"schema": "attribution/v1", "source": "serving",
                  "arch": args.arch,
                  "final": telemetry.attribution.snapshot().to_record(),
                  "compiled_memory": {":".join(str(k) for k in key): stats
                                      for key, stats in
                                      cb.compiled_memory.items()},
                  "flight_dumps": list(fl.dumps) if fl is not None else []}
        with open(args.attrib_out, "w") as f:
            json.dump(bundle, f, indent=1, default=str)
        print("attribution:", args.attrib_out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_2_3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=48)
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--backend", default="dense",
                    choices=("dense", "paged"))
    ap.add_argument("--spec-decode", action="store_true",
                    help="MTP self-speculative greedy decode (forces "
                         "temperature=0, top_k=0; greedy's tokens)")
    ap.add_argument("--spec-k", type=int, default=2,
                    help="draft tokens per speculative step")
    ap.add_argument("--capture-buckets", default="",
                    help="comma list of bucket sizes, e.g. 8,16,32")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="cross-request prefix caching (paged backend): "
                         "requests share one system prompt and reuse its "
                         "KV pages instead of prefilling them again")
    ap.add_argument("--tenants", default="",
                    help="comma list of tenant names for weighted "
                         "round-robin admission, e.g. gold,silver,bronze "
                         "(first listed gets the highest weight)")
    ap.add_argument("--watermark", type=float, default=0.0,
                    metavar="FRACTION",
                    help="arm the OOM flight recorder (paged backend): "
                         "dump owners/buffers when live bytes cross this "
                         "fraction of capacity; 0 disables")
    ap.add_argument("--attrib-out", default="", metavar="PATH",
                    help="write the serving attribution snapshot + "
                         "compiled-memory table + flight dumps as JSON "
                         "(paged backend)")
    ap.add_argument("--device", default=None,
                    help="cpu for the plain PyTorch path; the card "
                         "otherwise (raises without one)")
    args = ap.parse_args(argv)
    dev = default_device(args.device)
    if (args.watermark or args.attrib_out) and args.backend != "paged":
        print("note: --watermark/--attrib-out instrument the paged "
              "batcher; ignored for --backend dense")
    if args.backend == "paged":
        paged_demo(args, dev)
        return

    cfg, buckets = _fast_decode_cfg(args, get_config(args.arch).smoke())
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    prompt_len = 24
    temperature, top_k = (0.0, 0) if args.spec_decode else (0.8, 40)
    ro = Rollout(model, cfg, capacity=prompt_len + args.gen,
                 temperature=temperature, top_k=top_k,
                 capture_buckets=buckets, spec_decode=args.spec_decode,
                 spec_k=args.spec_k)
    ds = PromptDataset(
        synthetic_instruction_prompts(args.batch * args.requests),
        prompt_len)
    it = ds.batches(args.batch)
    gen = torch.Generator(device=dev).manual_seed(1)
    print(f"serving {cfg.name} on {dev} | live "
          f"{_mib(live_device_bytes(dev))}")
    for r in range(args.requests):
        batch = torch.as_tensor(next(it), device=dev) % cfg.vocab_size
        t0 = time.time()
        res = ro.generate(params, {"tokens": batch}, args.gen, gen)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.time() - t0
        print(f"req {r}: {dt*1e3:7.1f} ms  "
              f"{args.batch*args.gen/dt:7.0f} tok/s  "
              f"live {_mib(live_device_bytes(dev))}")
        del res
    if buckets or args.spec_decode:
        print("compile cache:", ro.compile_cache.stats())


if __name__ == "__main__":
    main()
