"""The port's CUDA kernels against their plain versions, on a card.

These tests need an NVIDIA card and nvcc; elsewhere they skip (the kernels
have no CPU mode). The file imports no JAX, so it runs on a machine that
has only PyTorch: ``pytest -m gpu tests/test_torch_gpu.py``. Tolerances:
2e-2 in bf16 and 5e-5 in f32, as ``tests/test_kernels.py:15`` (another
order of summation, and bf16 output rounding); B5 is held against its
plain version on fp32 copies of its inputs at 5e-2 in bf16 and 1e-3 in
f32, as ``tests/test_kernels.py:98`` holds the Pallas SSD kernel.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import decode_attention as tdec  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.kernels import rmsnorm as trn  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402
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


def _paged_case(g, B, H, K, D, ps, nb, dt, device):
    """Pools, forked block tables (rows 2i and 2i+1 share their first
    pages) with -1 holes in the middle and at the end, and positions that
    end on a partial page; the last row is idle (position -1)."""
    P = B * nb + 1
    q = _randn(g, B, H, D, dt=dt, device=device)
    kp = _randn(g, P, ps, K, D, dt=dt, device=device)
    vp = _randn(g, P, ps, K, D, dt=dt, device=device)
    bt = torch.randperm(P - 1, generator=torch.Generator().manual_seed(B))
    bt = bt[:B * nb].reshape(B, nb).to(torch.int32)
    for i in range(0, B - 1, 2):
        bt[i + 1, :nb // 2] = bt[i, :nb // 2]         # shared prefix pages
    bt[0, 1] = -1                                     # a hole
    bt[1, -1] = -1                                    # a tail
    position = torch.randint(0, (nb - 1) * ps, (B,),
                             generator=torch.Generator().manual_seed(D))
    position[2] = nb * ps - 3                         # a partial last page
    position[-1] = -1                                 # an idle row
    return (q, kp, vp, bt.to(device), position.to(torch.int32).to(device))


@pytest.mark.parametrize("B,H,K,D,ps,nb,dt", [
    (8, 24, 8, 128, 16, 6, "bf16"),
    (6, 8, 2, 64, 16, 5, "bf16"),
    (5, 8, 8, 128, 8, 7, "f32"),
    (4, 6, 1, 64, 4, 9, "f32"),
])
def test_paged_decode_kernel_matches_plain(cuda, B, H, K, D, ps, nb, dt):
    g = torch.Generator(device=cuda).manual_seed(5)
    args = _paged_case(g, B, H, K, D, ps, nb, dt, cuda)
    out = tpa.paged_decode_attention(*args)
    want = ref.paged_attention_ref(*args)
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


@pytest.mark.parametrize("B,S,H,P,N,chunk,dt", [
    (8, 2048, 32, 64, 128, 256, "bf16"),      # the mamba2_370m path's
    (2, 512, 4, 64, 128, 256, "f32"),
    (2, 128, 4, 32, 16, 32, "f32"),           # the smoke config's
])
def test_ssd_kernel_matches_plain(cuda, B, S, H, P, N, chunk, dt):
    """b and c are scaled by N^-1/4, so a score C B^T has unit variance and
    |y| stays well below 16, where the bf16 output's own rounding (half
    an ulp, 0.0625) would exceed the tolerance."""
    g = torch.Generator(device=cuda).manual_seed(8)
    x = (0.5 * torch.randn(B, S, H, P, generator=g, device=cuda)).to(DT[dt])
    a = -0.3 * torch.randn(B, S, H, generator=g, device=cuda).abs()
    b = (torch.randn(B, S, N, generator=g, device=cuda) * N ** -0.25
         ).to(DT[dt])
    c = (torch.randn(B, S, N, generator=g, device=cuda) * N ** -0.25
         ).to(DT[dt])
    y, fin = tssd.ssd_scan(x, a, b, c, chunk)
    want = ref.ssd_scan_ref(x.float(), a, b.float(), c.float(), chunk)
    tol = 5e-2 if dt == "bf16" else 1e-3
    for got, w in zip((y, fin), want):
        assert got.dtype == x.dtype
        torch.testing.assert_close(got.float(), w, atol=tol, rtol=0)


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
                            "paged_decode_attention": 0, "ssd_scan": 0,
                            "rmsnorm": (2 * L + 1) * 12}


def test_paged_group_rollout_on_card_matches_cpu(cuda):
    """The paged GRPO fork (G = 3, a partial prompt page, so every child
    but one CoW-copies it) through B2, B4 and B1 on the card gives the
    CPU plain path's greedy tokens."""
    cfg = dataclasses.replace(get_config("llama3_2_3b").smoke(),
                              num_kv_heads=2)
    cpu_model = Model(cfg, device="cpu")
    params = cpu_model.init(torch.Generator().manual_seed(6))
    tokens = torch.randint(0, cfg.vocab_size, (2, 21),
                           generator=torch.Generator().manual_seed(7))
    got = []
    ops.reset_launches()
    for model, p in ((cpu_model, params),
                     (Model(cfg, device=cuda), _to(params, cuda))):
        ro = Rollout(model, cfg, capacity=40, temperature=0.0,
                     backend="paged", page_size=8)
        res = ro.generate(p, {"tokens": tokens.to(model.device)}, 12,
                          torch.Generator(device=model.device), group_size=3)
        got.append(res.tokens.cpu())
        assert ro.page_manager.stats.n_forks == 4
    assert torch.equal(got[0], got[1])
    L = cfg.num_layers
    assert ops.launches == {"flash_attention": L,
                            "decode_attention": 0,
                            "paged_decode_attention": L * 11,
                            "ssd_scan": 0,
                            # + the group's replicated unembedding
                            "rmsnorm": (2 * L + 1) * 12 + 1}


def test_mamba_greedy_decode_on_card_matches_cpu(cuda):
    """The mamba2_370m smoke model (f32) through B5 and B1 on the card
    gives the CPU plain path's greedy tokens; B5 ran once per layer in
    the prefill."""
    cfg = get_config("mamba2_370m").smoke()
    cpu_model = Model(cfg, device="cpu")
    params = cpu_model.init(torch.Generator().manual_seed(9))
    tokens = torch.randint(0, cfg.vocab_size, (2, 64),
                           generator=torch.Generator().manual_seed(10))
    got = []
    ops.reset_launches()
    for model, p in ((cpu_model, params),
                     (Model(cfg, device=cuda), _to(params, cuda))):
        ro = Rollout(model, cfg, capacity=80, temperature=0.0)
        res = ro.generate(p, {"tokens": tokens.to(model.device)}, 16,
                          torch.Generator(device=model.device))
        got.append(res.tokens.cpu())
    assert torch.equal(got[0], got[1])
    L = cfg.num_layers
    assert ops.launches == {"flash_attention": 0, "decode_attention": 0,
                            "paged_decode_attention": 0, "ssd_scan": L,
                            "rmsnorm": (2 * L + 1) * 16}
