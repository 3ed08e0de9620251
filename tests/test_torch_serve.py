"""The port's serving entry point on the CPU, its CUDA-by-default rule, and
the rule that the port imports neither JAX nor the JAX package."""
import json
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import default_device  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.rlhf import Rollout, sample_token  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_serve_run_on_cpu_smoke():
    cfg = get_config("llama3_2_3b").smoke()
    reg = MetricsRegistry()
    lines = []
    ops.reset_launches()
    out = serve.run(cfg, batch=2, prompt_len=16, gen=6, requests=2,
                    device="cpu", reg=reg, log=lines.append)
    assert len(out) == 2
    for r in out:
        res = r["result"]
        assert res.tokens.shape == (2, 22) and res.prompt_len == 16
        assert int(res.tokens[:, 16:].max()) < cfg.vocab_size
        assert torch.isfinite(res.logp).all()
        assert (res.logp[:, 16:] <= 0).all() and (res.logp[:, :16] == 0).all()
        assert res.mask[:, 16:].eq(1).all() and res.mask[:, :16].eq(0).all()
        assert r["live_bytes"] is None and r["peak_bytes"] is None
    assert sum("request" in s for s in lines) == 2
    assert reg.counter("serve_tokens_total").value() == 2 * 2 * 6
    assert all(v == 0 for v in ops.launches.values())


def test_serve_main_writes_metrics(tmp_path, capsys):
    path = tmp_path / "m.jsonl"
    serve.main(["--arch", "llama3_2_3b", "--smoke", "--batch", "2",
                "--prompt-len", "8", "--gen", "3", "--requests", "1",
                "--device", "cpu", "--metrics-out", str(path)])
    assert "request 0" in capsys.readouterr().out
    names = {json.loads(line)["name"] for line in path.read_text().splitlines()}
    assert {"serve_requests_total", "serve_tokens_per_s"} <= names


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("llama3_2_3b").smoke()
    with pytest.raises(RuntimeError, match="CUDA"):
        default_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.run(cfg, batch=1, prompt_len=4, gen=2, requests=1)
    assert default_device("cpu") == torch.device("cpu")


def test_rollout_eos_masks_after_first_eos():
    cfg = get_config("llama3_2_3b").smoke()
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.RandomState(0).randint(0, 512, (2, 6)))
    greedy = Rollout(model, cfg, capacity=16, temperature=0.0)
    res = greedy.generate(params, {"tokens": tokens}, 5, torch.Generator())
    eos = int(res.tokens[0, 7])             # row 0's second generated token
    ro = Rollout(model, cfg, capacity=16, temperature=0.0, eos_id=eos)
    res2 = ro.generate(params, {"tokens": tokens}, 5, torch.Generator())
    first = int((res2.tokens[0, 6:] == eos).nonzero()[0])
    # the EOS token itself stays; everything after it is masked out
    assert res2.mask[0, 6:7 + first].eq(1).all()
    assert res2.mask[0, 7 + first:].eq(0).all()
    # as in the reference, a row is marked done one step after its EOS
    assert res2.tokens[0, 8 + first:].eq(0).all()


def test_sample_token_top_k_and_greedy():
    logits = torch.tensor([[0.0, 3.0, 1.0, 2.0]])
    tok, lp = sample_token(None, logits, temperature=0.0, top_k=2)
    assert int(tok) == 1
    # top-k masks everything but {1, 3}: logp is the masked log-softmax
    want = 3.0 - np.log(np.exp(3.0) + np.exp(2.0))
    assert abs(float(lp) - want) < 1e-6
    g = torch.Generator().manual_seed(0)
    toks = {int(sample_token(g, logits, temperature=1.0, top_k=2)[0])
            for _ in range(50)}
    assert toks <= {1, 3} and len(toks) == 2


_IMPORT_ALL = """
import importlib, pathlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = [m for m, mod in sys.modules.items() if mod is not None
       and (m in ("jax", "repro") or m.startswith(("jax.", "repro.")))]
assert not bad, bad
print(len(names))
"""


def test_port_imports_neither_jax_nor_repro():
    code = _IMPORT_ALL.format(src=str(ROOT / "src"), root=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip().splitlines()[-1]) >= 15


def test_chip_smoke_fails_without_a_card():
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"},
                         cwd=str(ROOT))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
