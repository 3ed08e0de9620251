"""The port's CUDA kernels against their plain versions, on a card.

These tests need an NVIDIA card and nvcc; elsewhere they skip (the kernels
have no CPU mode). The file imports no JAX, so it runs on a machine that
has only PyTorch: ``pytest -m gpu tests/test_torch_gpu.py``. Tolerances:
2e-2 in bf16 and 5e-5 in f32, as ``tests/test_kernels.py:15`` (another
order of summation, and bf16 output rounding).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import decode_attention as tdec  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as trn  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.rlhf import Rollout  # noqa: E402

pytestmark = pytest.mark.gpu

DT = {"f32": torch.float32, "bf16": torch.bfloat16}
TOL = {"f32": 5e-5, "bf16": 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False    # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(g, *shape, dt, device):
    return torch.randn(*shape, generator=g, device=device).to(DT[dt])


@pytest.mark.parametrize("B,Sq,Sk,H,K,D,causal,window,dt", [
    (2, 128, 128, 4, 2, 64, True, 0, "f32"),
    (1, 100, 37, 6, 2, 128, False, 0, "bf16"),
    (1, 100, 37, 6, 2, 128, True, 0, "bf16"),
    (1, 96, 96, 2, 2, 128, True, 32, "bf16"),
])
def test_flash_kernel_matches_plain(cuda, B, Sq, Sk, H, K, D, causal,
                                    window, dt):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = _randn(g, B, Sq, H, D, dt=dt, device=cuda)
    k = _randn(g, B, Sk, K, D, dt=dt, device=cuda)
    v = _randn(g, B, Sk, K, D, dt=dt, device=cuda)
    out = tfa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dt],
                               rtol=0)


@pytest.mark.parametrize("B,H,K,D,C,cur,window,dt", [
    (2, 24, 8, 128, 64, 39, 0, "bf16"),
    (2, 6, 2, 64, 16, 19, 8, "f32"),
])
def test_decode_kernel_matches_plain(cuda, B, H, K, D, C, cur, window, dt):
    """C = 16 after 20 positions: the rolling cache has wrapped."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q = _randn(g, B, H, D, dt=dt, device=cuda)
    kc = _randn(g, B, C, K, D, dt=dt, device=cuda)
    vc = _randn(g, B, C, K, D, dt=dt, device=cuda)
    slots = torch.arange(C, device=cuda)
    base = cur - cur % C
    pos = torch.where(slots <= cur % C, base + slots, base - C + slots)
    pos = torch.where(pos < 0, -1, pos).to(torch.int32).expand(B, C)
    position = torch.full((B,), cur, dtype=torch.int32, device=cuda)
    out = tdec.decode_attention(q, kc, vc, pos, position, window=window)
    want = ref.decode_attention_ref(q, kc, vc, pos, position, window=window)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dt],
                               rtol=0)


@pytest.mark.parametrize("shape,dt", [((64, 3072), "bf16"), ((3, 100), "f32")])
def test_rmsnorm_kernel_matches_plain(cuda, shape, dt):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = _randn(g, *shape, dt=dt, device=cuda)
    s = torch.randn(shape[-1], generator=g, device=cuda)
    torch.testing.assert_close(trn.rmsnorm(x, s).float(),
                               ref.rmsnorm_ref(x, s).float(), atol=TOL[dt],
                               rtol=0)


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return [_to(v, device) for v in tree]


def test_greedy_decode_on_card_matches_cpu(cuda):
    """A GQA smoke model (G = 2, head_dim 64, f32) through the kernels on
    the card gives the CPU plain path's greedy tokens; the card's run
    launched each kernel as often as the path makes it."""
    cfg = dataclasses.replace(get_config("llama3_2_3b").smoke(),
                              num_kv_heads=2)
    cpu_model = Model(cfg, device="cpu")
    params = cpu_model.init(torch.Generator().manual_seed(4))
    tokens = torch.randint(0, cfg.vocab_size, (2, 24),
                           generator=torch.Generator().manual_seed(3))
    got = []
    ops.reset_launches()
    for model, p in ((cpu_model, params),
                     (Model(cfg, device=cuda), _to(params, cuda))):
        ro = Rollout(model, cfg, capacity=40, temperature=0.0)
        res = ro.generate(p, {"tokens": tokens.to(model.device)}, 12,
                          torch.Generator(device=model.device))
        got.append(res.tokens.cpu())
    assert torch.equal(got[0], got[1])
    L = cfg.num_layers
    assert ops.launches == {"flash_attention": L,
                            "decode_attention": L * 11,
                            "rmsnorm": (2 * L + 1) * 12}
