"""Continuous batching on the PyTorch/CUDA port — the twin of
``examples/continuous_batching.py``: a slot pool over one static KV cache;
requests of different lengths join and leave between decode steps.

    PYTHONPATH=src python examples/torch_continuous_batching.py --device cpu
    PYTHONPATH=src python examples/torch_continuous_batching.py
    PYTHONPATH=src python examples/torch_continuous_batching.py --device cpu \
        --arch granite_moe_3b_a800m     # or jamba_v0_1_52b, qwen1_5_4b

``--arch`` picks the smoke config of any of the port's token-input
families (an MoE model routes each decode step's live and idle slot rows
alike; a hybrid's slots hold KV and Mamba states side by side).

Without ``--device cpu`` it runs on the card (and raises without one),
where each decode step replays one CUDA graph; the batcher's other
options (the paged backend, buckets, spec decode, the prefix cache,
tenants, telemetry) are driven by ``examples/torch_serving.py``.
"""
import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import default_device  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.rlhf import live_device_bytes  # noqa: E402
from repro_torch.serving import ContinuousBatcher  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_2_3b")
    ap.add_argument("--device", default=None,
                    help="cpu for the plain PyTorch path; the card "
                         "otherwise (raises without one)")
    args = ap.parse_args(argv)
    dev = default_device(args.device)
    cfg = get_config(args.arch).smoke()
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    cb = ContinuousBatcher(model, cfg, params, slots=4, capacity=96,
                           temperature=0.8, top_k=40)
    rng = np.random.RandomState(0)
    for i in range(10):
        cb.submit(rng.randint(0, cfg.vocab_size, size=16),
                  max_new_tokens=8 + 4 * (i % 4))
    t0 = time.time()
    done = cb.run_until_drained()
    dt = time.time() - t0
    tok = sum(len(r.out_tokens) for r in done)
    print(f"served {len(done)} requests, {tok} tokens in {cb.steps} decode "
          f"steps on {dev} ({dt:.1f}s, {tok/dt:.0f} tok/s)")
    live = live_device_bytes(dev)
    if live is not None:
        print(f"live device memory at end: {live/2**20:.1f} MiB "
              f"(static pool: no growth with request count)")
    for r in done[:3]:
        print(f"  req {r.rid}: {len(r.out_tokens)} tokens ->",
              r.out_tokens[:8], "...")


if __name__ == "__main__":
    main()
