"""Serving launcher: batched generation (prefill + decode loop) over the
dense decode caches — a fixed-capacity rolling KV cache per attention
layer, the conv and SSM states per Mamba layer — reporting per-request
time, throughput and live/peak device memory; the port of
``repro/launch/serve.py``.

Usage (on the card; ``--device cpu`` runs the plain PyTorch path):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_2_3b \
      --batch 8 --prompt-len 512 --gen 64 --requests 3
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_370m \
      --batch 8 --prompt-len 2048 --gen 64 --requests 3

A Mamba prompt length must be a multiple of the SSD chunk (256 for
mamba2_370m) or shorter than it.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, List, Optional

import torch

from repro_torch import default_device
from repro_torch.configs import ModelConfig, check_token_inputs, get_config
from repro_torch.data import ByteTokenizer, PromptDataset, \
    synthetic_instruction_prompts
from repro_torch.models import Model
from repro_torch.obs import MetricsRegistry
from repro_torch.rlhf import Rollout, RolloutResult, live_device_bytes
from repro_torch.tree import leaves

TOP_K = 50


def _mib(n: Optional[int]) -> str:
    return "n/a" if n is None else f"{n / 2**20:.1f}"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg: ModelConfig, *, batch: int, prompt_len: int, gen: int,
        requests: int, temperature: float = 0.8, seed: int = 0,
        device=None, reg: Optional[MetricsRegistry] = None,
        log: Callable[[str], None] = print) -> List[dict]:
    """Init ``cfg`` from ``seed`` and serve ``requests`` generate calls of
    ``batch`` x ``prompt_len`` prompts + ``gen`` new tokens. Returns one
    dict per request: its RolloutResult, seconds, tokens/s and the live
    and peak device bytes (None off the card)."""
    check_token_inputs(cfg, "serve.run")
    device = default_device(device)
    reg = reg if reg is not None else MetricsRegistry()
    model = Model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(seed))
    n = sum(t.numel() for t in leaves(params))
    log(f"[serve] {cfg.name}: {n / 1e6:.2f}M params on {device}, "
        f"live {_mib(live_device_bytes(device))} MiB")
    reg.gauge("serve_params_m", "model size in M params").set(n / 1e6)

    rollout = Rollout(model, cfg, capacity=prompt_len + gen,
                      temperature=temperature, top_k=TOP_K)
    prompts = PromptDataset(
        synthetic_instruction_prompts(batch * requests, seed=seed), prompt_len)
    it = prompts.batches(batch, seed=seed)
    tok = ByteTokenizer()
    sampler = torch.Generator(device=device).manual_seed(seed + 1)
    out = []
    for r in range(requests):
        ids = torch.from_numpy(next(it) % cfg.vocab_size).long().to(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        _sync(device)
        t0 = time.perf_counter()
        res: RolloutResult = rollout.generate(params, {"tokens": ids}, gen,
                                              sampler)
        _sync(device)
        dt = time.perf_counter() - t0
        tput = batch * gen / dt
        live = live_device_bytes(device)
        peak = torch.cuda.max_memory_allocated(device) \
            if device.type == "cuda" else None
        log(f"[serve] request {r}: {dt * 1e3:7.1f} ms ({tput:7.1f} tok/s) "
            f"live {_mib(live)} MiB peak {_mib(peak)} MiB")
        reg.counter("serve_requests_total", "generate calls served").inc()
        reg.counter("serve_tokens_total", "tokens generated").inc(batch * gen)
        reg.histogram("serve_request_latency_s",
                      "wall time per generate call").observe(dt)
        reg.gauge("serve_tokens_per_s", "throughput of last request").set(tput)
        if live is not None:
            reg.gauge("serve_live_device_bytes",
                      "live device bytes (peak via gauge peak)").set(live)
            reg.gauge("serve_peak_device_bytes",
                      "allocator peak during the request").set(peak)
        if cfg.vocab_size >= 259 and r == 0:
            log("  sample: " + tok.decode(
                res.tokens[0, prompt_len:].cpu().numpy())[:60])
        out.append({"result": res, "seconds": dt, "tokens_per_s": tput,
                    "live_bytes": live, "peak_bytes": peak})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without it)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write a metrics-registry JSONL snapshot here")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    reg = MetricsRegistry()
    run(cfg, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
        requests=args.requests, temperature=args.temperature, seed=args.seed,
        device=args.device, reg=reg)
    if args.metrics_out:
        reg.write_jsonl(args.metrics_out)
        print(f"[serve] metrics -> {args.metrics_out}")


if __name__ == "__main__":
    main()
