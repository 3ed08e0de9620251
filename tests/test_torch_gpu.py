"""The port's CUDA kernels against their plain versions, on a card, and
the decode step's CUDA graph against the eager loop.

These tests need an NVIDIA card and nvcc; elsewhere they skip (the kernels
have no CPU mode). The file imports no JAX, so it runs on a machine that
has only PyTorch: ``pytest -m gpu tests/test_torch_gpu.py``. Tolerances:
2e-2 in bf16 and 5e-5 in f32, as ``tests/test_kernels.py:15`` (another
order of summation, and bf16 output rounding); B5 is held against its
plain version on fp32 copies of its inputs at 5e-2 in bf16 and 1e-3 in
f32, as ``tests/test_kernels.py:98`` holds the Pallas SSD kernel. The
backward kernels (B2-bwd, B1-bwd) are held at 2e-2 in bf16 and 1e-4 in
f32 (the reference's own gradient tolerance, ``tests/test_kernels.py:57``;
B1-bwd at the forward kernels' 5e-5 in f32) on the error over max(1, max
|plain|): gradients grow past 1, and a bf16 output rounds to a step
relative to its size.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import decode_attention as tdec  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as tfab  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.kernels import rmsnorm as trn  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.offload import (HostParkingLot, OffloadExecutor,  # noqa: E402
                                 OffloadPlan, tree_nbytes)
from repro_torch.rlhf import Rollout  # noqa: E402
from repro_torch.rlhf import decode_graph as DG  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

pytestmark = pytest.mark.gpu

DT = {"f32": torch.float32, "bf16": torch.bfloat16}
TOL = {"f32": 5e-5, "bf16": 2e-2}
TOL_BWD = {"f32": 1e-4, "bf16": 2e-2}


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
    # ragged edges of the 128-row q tiles and 64-key k tiles, at D 64 and
    # 128 in bf16 (tensor cores) and fp32 (CUDA cores)
    (2, 65, 129, 6, 2, 128, False, 0, "bf16"),
    (2, 65, 129, 6, 2, 128, True, 0, "bf16"),
    (2, 65, 129, 4, 4, 64, False, 0, "bf16"),
    (2, 65, 129, 6, 2, 128, True, 0, "f32"),
    (2, 65, 129, 4, 2, 64, False, 0, "f32"),
    (3, 50, 50, 6, 2, 128, True, 0, "bf16"),      # Sk below one k tile
    (2, 40, 40, 4, 1, 64, True, 0, "bf16"),
    (1, 300, 300, 6, 2, 128, True, 100, "bf16"),  # the window cuts tiles
    (1, 300, 300, 4, 2, 64, True, 100, "f32"),
    (2, 512, 512, 6, 2, 128, True, 0, "bf16"),    # several q tiles a block
    (2, 192, 192, 8, 2, 64, True, 0, "bf16"),
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


# DeepSeek-V3 MLA's head widths: q/k rows of 192 (128 nope + 64 rope), v
# rows of 128, G 1 (every head its own KV head)
MLA_FLASH_CASES = [
    (2, 256, 256, 4, 4, 192, 128, True, 0, "bf16"),
    (1, 100, 100, 3, 3, 192, 128, True, 0, "bf16"),     # ragged S
    (1, 300, 300, 2, 2, 192, 128, True, 100, "bf16"),   # a window that cuts tiles
    (2, 65, 129, 2, 2, 192, 128, False, 0, "bf16"),     # full, Sq != Sk
    (1, 600, 600, 2, 2, 192, 128, True, 0, "bf16"),     # q buffers reused
    (2, 256, 256, 4, 4, 192, 128, True, 0, "f32"),
    (1, 300, 300, 2, 2, 192, 128, True, 100, "f32"),
    (2, 65, 129, 2, 2, 192, 128, False, 0, "f32"),
]


def _mla_qkv(g, B, Sq, Sk, H, K, D, Dv, dt, device):
    return (_randn(g, B, Sq, H, D, dt=dt, device=device),
            _randn(g, B, Sk, K, D, dt=dt, device=device),
            _randn(g, B, Sk, K, Dv, dt=dt, device=device))


@pytest.mark.parametrize("B,Sq,Sk,H,K,D,Dv,causal,window,dt", MLA_FLASH_CASES)
def test_flash_mla_widths_match_plain(cuda, B, Sq, Sk, H, K, D, Dv, causal,
                                      window, dt):
    """B2 at (192, 128), out and lse, against attention_ref."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = _mla_qkv(g, B, Sq, Sk, H, K, D, Dv, dt, cuda)
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                       return_lse=True)
    want, want_lse = ref.attention_ref(q, k, v, causal=causal, window=window,
                                       return_lse=True)
    assert out.shape == (B, Sq, H, Dv)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dt],
                               rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=TOL[dt], rtol=0)


@pytest.mark.parametrize("B,Sq,Sk,H,K,D,Dv,causal,window,dt", MLA_FLASH_CASES)
def test_flash_bwd_mla_widths_match_plain(cuda, B, Sq, Sk, H, K, D, Dv,
                                          causal, window, dt):
    """B2-bwd at (192, 128) (the CUDA-core route, bf16 and fp32) against
    flash_attention_bwd_ref on the same saved out and lse."""
    assert tfab.route(DT[dt], D, Dv) == "simt"
    g = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = _mla_qkv(g, B, Sq, Sk, H, K, D, Dv, dt, cuda)
    dout = _randn(g, B, Sq, H, Dv, dt=dt, device=cuda)
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                       return_lse=True)
    got = tfab.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                   window=window)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                       causal=causal, window=window)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        _assert_scaled(a, b, TOL_BWD[dt])


@pytest.mark.parametrize("D,Dv", [(192, 192), (128, 64), (96, 96)])
def test_flash_refuses_other_widths(cuda, D, Dv):
    """A pair the kernels do not take raises; nothing falls back."""
    q = torch.zeros(1, 64, 2, D, dtype=torch.bfloat16, device=cuda)
    v = torch.zeros(1, 64, 2, Dv, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_fwd(q, q, v)
    lse = torch.zeros(1, 64, 2, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        tfab.flash_attention_bwd(q, q, v, v, lse, v)


def _assert_scaled(got, want, tol):
    """max |got - want| <= tol * max(1, max |want|)."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    scale = max(1.0, want.abs().max().item())
    assert err <= tol * scale, (err, scale)


FLASH_BWD_CASES = [
    (8, 576, 576, 24, 8, 128, True, 0, "bf16"),    # the training shape
    (8, 576, 576, 24, 8, 128, True, 0, "f32"),
    (2, 100, 100, 6, 2, 128, True, 0, "bf16"),     # ragged S = 100
    (2, 100, 100, 6, 2, 64, True, 0, "f32"),
    (2, 192, 192, 8, 8, 64, True, 0, "bf16"),      # G 1, D 64
    (1, 160, 160, 16, 2, 128, True, 0, "bf16"),    # G 8
    (1, 300, 300, 6, 2, 128, True, 100, "bf16"),   # a window that cuts tiles
    (2, 200, 200, 4, 2, 64, True, 100, "bf16"),
    (2, 65, 129, 4, 2, 64, False, 0, "f32"),       # full, ragged Sq != Sk
    (2, 65, 129, 4, 2, 64, False, 0, "bf16"),
    (2, 129, 65, 6, 2, 128, False, 0, "bf16"),
    (2, 37, 100, 6, 2, 128, True, 0, "bf16"),      # causal, Sk above Sq
    (2, 100, 37, 6, 2, 128, True, 0, "bf16"),      # causal, Sk below Sq
]


@pytest.mark.parametrize("B,Sq,Sk,H,K,D,causal,window,dt",
                         [c for c in FLASH_BWD_CASES if c[1] < 576])
def test_flash_lse_matches_plain(cuda, B, Sq, Sk, H, K, D, causal, window,
                                 dt):
    """B2's lse output, on both routes, against attention_ref's."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q = _randn(g, B, Sq, H, D, dt=dt, device=cuda)
    k = _randn(g, B, Sk, K, D, dt=dt, device=cuda)
    v = _randn(g, B, Sk, K, D, dt=dt, device=cuda)
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                       return_lse=True)
    want, want_lse = ref.attention_ref(q, k, v, causal=causal, window=window,
                                       return_lse=True)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dt],
                               rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=TOL[dt], rtol=0)


@pytest.mark.parametrize("B,Sq,Sk,H,K,D,causal,window,dt", FLASH_BWD_CASES)
def test_flash_bwd_kernel_matches_plain(cuda, B, Sq, Sk, H, K, D, causal,
                                        window, dt):
    """B2-bwd against flash_attention_bwd_ref on the same saved out/lse:
    bf16 on the tensor-core route, fp32 on the CUDA cores."""
    g = torch.Generator(device=cuda).manual_seed(4)
    q = _randn(g, B, Sq, H, D, dt=dt, device=cuda)
    k = _randn(g, B, Sk, K, D, dt=dt, device=cuda)
    v = _randn(g, B, Sk, K, D, dt=dt, device=cuda)
    dout = _randn(g, B, Sq, H, D, dt=dt, device=cuda)
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                       return_lse=True)
    got = tfab.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                   window=window)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                       causal=causal, window=window)
    for a, b in zip(got, want):
        _assert_scaled(a, b, TOL_BWD[dt])


@pytest.mark.parametrize("shape,dt,sdt", [
    ((4608, 3072), "bf16", "bf16"),       # the training prefill's rows
    ((4096, 2048), "bf16", "bf16"),       # the separate path: opt_1_3b
    ((4096, 1024), "bf16", "bf16"),       # and opt_350m
    ((4097, 2048), "bf16", "bf16"),       # rows not even over the blocks
    ((4095, 1024), "bf16", "bf16"),
    ((8, 3072), "bf16", "bf16"),
    ((3, 100), "f32", "f32"),
    ((7, 384), "bf16", "f32"),            # the scalar route
    ((2, 8192), "bf16", "bf16"),          # too wide for registers: scalar
    ((300, 8192), "bf16", "bf16"),        # the scalar route over 43 blocks
    ((2048, 512), "f32", "f32"),
])
def test_rmsnorm_bwd_kernel_matches_plain(cuda, shape, dt, sdt):
    """B1-bwd, dx and dscale, against rmsnorm_bwd_ref; dx is the same bits
    without dscale, and dscale (summed in a fixed order) the same bits in
    a second call."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x = _randn(g, *shape, dt=dt, device=cuda)
    dy = _randn(g, *shape, dt=dt, device=cuda)
    s = (1 + 0.1 * torch.randn(shape[-1], generator=g, device=cuda)
         ).to(DT[sdt])
    dx, ds = trn.rmsnorm_bwd(x, s, dy, 1e-5)
    want_dx, want_ds = ref.rmsnorm_bwd_ref(x, s, dy, 1e-5)
    _assert_scaled(dx, want_dx, TOL[dt])
    _assert_scaled(ds, want_ds, TOL[sdt])
    dx2, none = trn.rmsnorm_bwd(x, s, dy, 1e-5, dscale=False)
    assert none is None and torch.equal(dx2, dx)
    assert torch.equal(trn.rmsnorm_bwd(x, s, dy, 1e-5)[1], ds)


def test_autograd_counts_backward_launches(cuda):
    """ops' autograd functions launch B2-bwd and B1-bwd once per backward,
    and their gradients are the plain versions' on the same inputs."""
    g = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = (_randn(g, 2, 96, h, 64, dt="bf16", device=cuda)
               .requires_grad_() for h in (4, 2, 2))
    x = _randn(g, 96, 256, dt="bf16", device=cuda).requires_grad_()
    s = torch.ones(256, device=cuda, dtype=torch.bfloat16)
    ops.reset_launches()
    out = ops.flash_attention(q, k, v, causal=True)
    y = ops.rmsnorm(x, s)
    (out.float().square().sum() + y.float().square().sum()).backward()
    assert ops.launches["flash_attention"] == 1
    assert ops.launches["flash_attention_bwd"] == 1
    assert ops.launches["rmsnorm"] == 1 and ops.launches["rmsnorm_bwd"] == 1
    _, lse = ref.attention_ref(q, k, v, causal=True, return_lse=True)
    want = ref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                       out.detach(), lse,
                                       2 * out.detach().float().to(q.dtype))
    for t, w in zip((q, k, v), want):
        _assert_scaled(t.grad, w, TOL_BWD["bf16"])


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


@pytest.mark.parametrize("B,H,K,D,C,cur,window,dt", [
    (8, 24, 8, 128, 576, 574, 0, "bf16"),     # the serving path: 5 splits
    (8, 24, 8, 128, 576, 40, 0, "bf16"),      # most splits hold no valid slot
    (2, 24, 8, 128, 20, 30, 0, "bf16"),       # C below one span: 1 split
    (2, 8, 8, 128, 300, 250, 0, "bf16"),      # G = 1, 10 splits
    (2, 16, 2, 128, 300, 250, 64, "bf16"),    # G = 8, a window
    (64, 24, 8, 128, 100, 99, 0, "bf16"),     # enough rows: 1 split
    (3, 16, 2, 64, 333, 400, 0, "f32"),       # wrapped, G = 8, D 64
    (2, 6, 1, 128, 200, 150, 32, "f32"),      # wrapped, a window, G = 6
])
def test_decode_kernel_splits_match_plain(cuda, B, H, K, D, C, cur, window,
                                          dt):
    """B3 at several split counts (``split_plan``), wrapped rolling caches,
    windows, G = 1 and G = 8, and row 1 with no valid slot, which the
    oracle answers with the uniform mean over its C slots."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q = _randn(g, B, H, D, dt=dt, device=cuda)
    kc = _randn(g, B, C, K, D, dt=dt, device=cuda)
    vc = _randn(g, B, C, K, D, dt=dt, device=cuda)
    slots = torch.arange(C, device=cuda)
    base = cur - cur % C
    pos = torch.where(slots <= cur % C, base + slots, base - C + slots)
    pos = torch.where(pos < 0, -1, pos).to(torch.int32).expand(B, C)
    position = torch.full((B,), cur, dtype=torch.int32, device=cuda)
    position[1] = -1
    out = tdec.decode_attention(q, kc, vc, pos, position, window=window)
    want = ref.decode_attention_ref(q, kc, vc, pos, position, window=window)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dt],
                               rtol=0)


def _paged_case(g, B, H, K, D, ps, nb, dt, device, table="holey"):
    """Pools, block tables and positions. ``holey``: random pages, rows 2i
    and 2i+1 sharing their first pages, -1 holes in the middle and at the
    end, positions that end on a partial last page and an idle last row
    (position -1). ``forked``: GRPO groups of 8 consecutive rows sharing
    all but their last two pages, each row at the last slot but two.
    ``distinct``: every row on pages of its own; ``same``: all rows on one
    row's pages; both at the last slot but one."""
    P = B * nb + 1
    q = _randn(g, B, H, D, dt=dt, device=device)
    kp = _randn(g, P, ps, K, D, dt=dt, device=device)
    vp = _randn(g, P, ps, K, D, dt=dt, device=device)
    bt = torch.randperm(P - 1, generator=torch.Generator().manual_seed(B))
    bt = bt[:B * nb].reshape(B, nb).to(torch.int32)
    position = torch.full((B,), nb * ps - 2)
    if table == "holey":
        for i in range(0, B - 1, 2):
            bt[i + 1, :nb // 2] = bt[i, :nb // 2]     # shared prefix pages
        bt[0, 1] = -1                                 # a hole
        bt[1, -1] = -1                                # a tail
        position = torch.randint(0, (nb - 1) * ps, (B,),
                                 generator=torch.Generator().manual_seed(D))
        position[2] = nb * ps - 3                     # a partial last page
        position[-1] = -1                             # an idle row
    elif table == "forked":
        for i in range(B):
            bt[i, :nb - 2] = bt[i - i % 8, :nb - 2]
        position[:] = nb * ps - 3
    elif table == "same":
        bt[:] = bt[0]
    return (q, kp, vp, bt.to(device), position.to(torch.int32).to(device))


@pytest.mark.parametrize("B,H,K,D,ps,nb,dt,table", [
    (8, 24, 8, 128, 16, 6, "bf16", "holey"),
    (6, 8, 2, 64, 16, 5, "bf16", "holey"),
    (5, 8, 8, 128, 8, 7, "f32", "holey"),
    (4, 6, 1, 64, 4, 9, "f32", "holey"),
    (16, 24, 8, 128, 16, 9, "bf16", "forked"),
    (16, 24, 8, 128, 16, 9, "bf16", "distinct"),
    (16, 24, 8, 128, 16, 9, "bf16", "same"),
    (13, 24, 8, 128, 16, 9, "bf16", "forked"),     # a tile of 5 rows
    (10, 16, 2, 128, 16, 7, "bf16", "holey"),      # G = 8
    (9, 16, 2, 64, 8, 12, "f32", "forked"),        # G = 8, fp32
    (8, 24, 8, 128, 32, 5, "bf16", "holey"),       # two units a page
])
def test_paged_decode_kernel_matches_plain(cuda, B, H, K, D, ps, nb, dt,
                                           table):
    g = torch.Generator(device=cuda).manual_seed(5)
    args = _paged_case(g, B, H, K, D, ps, nb, dt, cuda, table)
    out = tpa.paged_decode_attention(*args)
    want = ref.paged_attention_ref(*args)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dt],
                               rtol=0)


@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_paged_decode_one_split_matches_plan(cuda, dt):
    """A forced single split (the block normalises its rows itself) and
    the plan's split with the merge kernel give the same result."""
    g = torch.Generator(device=cuda).manual_seed(6)
    args = _paged_case(g, 24, 24, 8, 128, 16, 20, dt, cuda, "forked")
    assert tpa.launch_plan(args[0], args[1], args[3])[0] > 1
    split = tpa.paged_decode_attention(*args)
    whole = tpa.paged_decode_attention(*args, splits=1)
    want = ref.paged_attention_ref(*args)
    torch.testing.assert_close(split.float(), whole.float(), atol=TOL[dt],
                               rtol=0)
    torch.testing.assert_close(whole.float(), want.float(), atol=TOL[dt],
                               rtol=0)


# groups of more than 8 query heads a KV head: command_r_plus_104b's 96 over
# 8 (G 12), an uneven cut (G 9: B3 blocks of 5 and 4 heads, B4's 16-head
# instance with 7 spare) and the largest (G 16), in both dtypes and head dims
LARGE_GROUPS = [(g, D, dt) for g in (9, 12, tdec.MAX_GROUP)
                for D in (64, 128) for dt in ("bf16", "f32")]


@pytest.mark.parametrize("G,D,dt", LARGE_GROUPS)
def test_decode_kernel_large_groups_match_plain(cuda, G, D, dt):
    """B3 at G 9-16 over 2 KV heads: a wrapped cache split several ways,
    a window, and row 1 with no valid slot."""
    assert tdec.MAX_GROUP == tpa.MAX_GROUP == 16
    B, K, C, cur = 3, 2, 300, 420
    g = torch.Generator(device=cuda).manual_seed(G)
    q = _randn(g, B, G * K, D, dt=dt, device=cuda)
    kc = _randn(g, B, C, K, D, dt=dt, device=cuda)
    vc = _randn(g, B, C, K, D, dt=dt, device=cuda)
    slots = torch.arange(C, device=cuda)
    base = cur - cur % C
    pos = torch.where(slots <= cur % C, base + slots, base - C + slots)
    pos = torch.where(pos < 0, -1, pos).to(torch.int32).expand(B, C)
    position = torch.full((B,), cur, dtype=torch.int32, device=cuda)
    position[1] = -1
    assert tdec.split_plan(B, K, C)[0] > 1
    for window in (0, 96):
        out = tdec.decode_attention(q, kc, vc, pos, position, window=window)
        want = ref.decode_attention_ref(q, kc, vc, pos, position,
                                        window=window)
        torch.testing.assert_close(out.float(), want.float(), atol=TOL[dt],
                                   rtol=0)


@pytest.mark.parametrize("G,D,dt", LARGE_GROUPS)
def test_paged_decode_kernel_large_groups_match_plain(cuda, G, D, dt):
    """B4 at G 9-16 over 2 KV heads: holey tables (shared prefixes, holes,
    an idle row) over two tiles, and forked GRPO tables split and whole."""
    g = torch.Generator(device=cuda).manual_seed(G)
    for table, B, nb in (("holey", 10, 7), ("forked", 16, 9)):
        args = _paged_case(g, B, G * 2, 2, D, 16, nb, dt, cuda, table)
        want = ref.paged_attention_ref(*args)
        for splits in (None, 1):
            out = tpa.paged_decode_attention(*args, splits=splits)
            torch.testing.assert_close(out.float(), want.float(),
                                       atol=TOL[dt], rtol=0)


@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_decode_kernels_refuse_groups_above_the_maximum(cuda, dt):
    """One query head a KV head above ``MAX_GROUP``: both wrappers raise,
    and so do their C entries when called past the wrapper's check."""
    G = tdec.MAX_GROUP + 1
    g = torch.Generator(device=cuda).manual_seed(0)
    q = _randn(g, 2, G, 128, dt=dt, device=cuda)
    kc = _randn(g, 2, 64, 1, 128, dt=dt, device=cuda)
    pos = torch.arange(64, device=cuda, dtype=torch.int32).expand(2, 64)
    position = torch.full((2,), 63, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="at most 16"):
        tdec.decode_attention(q, kc, kc, pos, position)
    args = _paged_case(g, 8, G, 1, 128, 16, 4, dt, cuda, "holey")
    with pytest.raises(ValueError, match="at most 16"):
        tpa.paged_decode_attention(*args)
    out = torch.empty_like(q)
    err = tdec._fn()(q.data_ptr(), kc.data_ptr(), kc.data_ptr(),
                     pos.contiguous().data_ptr(), position.data_ptr(),
                     out.data_ptr(), None, 2, 64, G, 1, 128, 64, 1, 0,
                     tdec.build.dtype_code(q), tdec.build.stream_ptr())
    assert err != 0
    pq, kp, vp, bt, pp = args
    err = tpa._fn()(pq.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                    bt.data_ptr(), pp.data_ptr(), torch.empty_like(pq)
                    .data_ptr(), None, 8, 4, 16, G, 1, 128, 1,
                    tpa.build.dtype_code(pq), tpa.build.stream_ptr())
    assert err != 0


@pytest.mark.parametrize("shape,dt", [((64, 3072), "bf16"), ((3, 100), "f32")])
def test_rmsnorm_kernel_matches_plain(cuda, shape, dt):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = _randn(g, *shape, dt=dt, device=cuda)
    s = torch.randn(shape[-1], generator=g, device=cuda)
    torch.testing.assert_close(trn.rmsnorm(x, s).float(),
                               ref.rmsnorm_ref(x, s).float(), atol=TOL[dt],
                               rtol=0)


@pytest.mark.parametrize("shape,dt,sdt", [
    # every shape the serving, paged GRPO, Mamba2 and PPO paths give B1
    ((4096, 3072), "bf16", "bf16"), ((8, 3072), "bf16", "bf16"),
    ((4032, 3072), "bf16", "bf16"), ((64, 3072), "bf16", "bf16"),
    ((4608, 3072), "bf16", "bf16"),
    ((16384, 1024), "bf16", "bf16"), ((16384, 2048), "bf16", "bf16"),
    ((8, 2048), "bf16", "bf16"),
    ((3, 100), "f32", "f32"),             # 25 vectors: lanes left idle
    ((7, 384), "bf16", "f32"),            # mixed dtypes: the scalar route
    ((13, 3072), "bf16", "bf16"),         # 13 rows: a block of 5 of 8 warps
    ((5, 100), "bf16", "bf16"),           # 200-byte rows: the scalar route
    ((2, 8192), "bf16", "bf16"),          # too wide for registers: scalar
    ((2048, 512), "f32", "f32"),          # the streaming variant in fp32
    ((1025, 3072), "bf16", "bf16"),       # streaming, a block of 1 warp
])
def test_rmsnorm_plan_routes_match_plain(cuda, shape, dt, sdt):
    """B1 at each shape of the paths and at each route of its plan."""
    g = torch.Generator(device=cuda).manual_seed(12)
    x = _randn(g, *shape, dt=dt, device=cuda)
    s = (1 + 0.1 * torch.randn(shape[-1], generator=g, device=cuda)
         ).to(DT[sdt])
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


@pytest.mark.parametrize("B,S,H,N,chunk,decay,sliced", [
    (8, 2048, 32, 128, 256, 0.3, False),      # the path's, tensor cores
    (8, 2048, 32, 128, 256, 0.3, True),       # b, c as slices of xbc
    (2, 512, 4, 64, 64, 0.3, False),          # N 64, chunk 64: 8 chunks
    (2, 512, 4, 64, 128, 4.0, True),          # N 64, chunk 128, decaying
    (2, 1024, 8, 128, 256, 4.0, False),       # strongly decaying a
    (1, 1024, 2, 128, 512, 0.3, True),        # the largest chunk taken
])
def test_ssd_wgmma_route_matches_plain(cuda, B, S, H, N, chunk, decay,
                                       sliced):
    """B5's tensor-core route (bf16, P 64) against its plain version on
    fp32 copies of its inputs; with ``sliced``, b and c are column slices
    of one [B, S, H*P + 2N] tensor, as the Mamba2 block passes them."""
    P = 64
    assert tssd.route(P, N, chunk, torch.bfloat16) == "wgmma"
    g = torch.Generator(device=cuda).manual_seed(13)
    x = (0.5 * torch.randn(B, S, H, P, generator=g, device=cuda)).bfloat16()
    a = -decay * torch.randn(B, S, H, generator=g, device=cuda).abs()
    bc = (torch.randn(B, S, H * P + 2 * N, generator=g, device=cuda)
          * N ** -0.25).bfloat16()
    b, c = bc[..., H * P:H * P + N], bc[..., H * P + N:]
    if not sliced:
        b, c = b.contiguous(), c.contiguous()
    y, fin = tssd.ssd_scan(x, a, b, c, chunk)
    want = ref.ssd_scan_ref(x.float(), a, b.float(), c.float(), chunk)
    for got, w in zip((y, fin), want):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), w, atol=5e-2, rtol=0)


def test_ssd_kernel_refuses_misaligned_rows(cuda):
    """The tensor-core route reads b and c by TMA: rows that are not a
    multiple of 16 bytes apart raise rather than take another route."""
    x = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16, device=cuda)
    a = torch.zeros(1, 64, 2, device=cuda)
    bc = torch.zeros(1, 64, 2 * 64 + 2, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        tssd.ssd_scan(x, a, bc[..., :64], bc[..., 64:128], 64)


def test_ssd_scan_refuses_a_gradient_on_card(cuda):
    """B5 has no backward kernel: ``ops.ssd_scan`` on CUDA inputs that
    need a gradient raises (a Mamba layer trains on the CPU path only),
    and runs under ``no_grad``."""
    x = torch.randn(1, 64, 2, 32, device=cuda, requires_grad=True)
    a = -torch.rand(1, 64, 2, device=cuda)
    b = torch.randn(1, 64, 16, device=cuda)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.ssd_scan(x, a, b, b.clone(), 32)
    with torch.no_grad():
        y, _ = ops.ssd_scan(x, a, b, b.clone(), 32)
    assert y.shape == x.shape


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
                            "rmsnorm": (2 * L + 1) * 12,
                            "flash_attention_bwd": 0, "rmsnorm_bwd": 0}


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
                            "rmsnorm": (2 * L + 1) * 12 + 1,
                            "flash_attention_bwd": 0, "rmsnorm_bwd": 0}


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
                            "rmsnorm": (2 * L + 1) * 16,
                            "flash_attention_bwd": 0, "rmsnorm_bwd": 0}


# ---------------------------------------------------- decode CUDA graphs
def _small(cuda, case):
    """A small model on the card, random weights from a seed: the GQA
    smoke model (f32, head_dim 64) or mamba2_370m's smoke config."""
    cfg = get_config("mamba2_370m").smoke() if case == "mamba" else \
        dataclasses.replace(get_config("llama3_2_3b").smoke(),
                            num_kv_heads=2)
    model = Model(cfg, device=cuda)
    return cfg, model, model.init(torch.Generator(device=cuda).manual_seed(0))


@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "sampled"])
@pytest.mark.parametrize("case", ["dense", "paged", "mamba"])
def test_graphed_decode_matches_eager(cuda, case, temperature):
    """Every decode step after the first replays the captured step: the
    tokens and log-probs are the eager loop's bits (greedy and sampled;
    the paged case forks G = 3 off a partial prompt page), ``ops.launches``
    counts the same, and the live bytes after the call are the same (the
    graph and its pool went with the caches)."""
    cfg, model, params = _small(cuda, case)
    P, G = (64, 1) if case == "mamba" else (21, 3 if case == "paged" else 1)
    tokens = torch.randint(0, cfg.vocab_size, (2, P), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(1))
    kw = dict(backend="paged", page_size=8) if case == "paged" else {}
    ro = Rollout(model, cfg, capacity=P + 12, temperature=temperature,
                 top_k=20 if temperature else 0, **kw)
    out = []
    for graphs in (True, False):
        ro._graphs = graphs
        torch.cuda.synchronize()
        ops.reset_launches()
        res = ro.generate(params, {"tokens": tokens}, 12,
                          torch.Generator(device=cuda).manual_seed(2),
                          group_size=G)
        torch.cuda.synchronize()
        bits = (res.tokens.cpu(), res.logp.cpu())
        del res                       # live bytes without this call's result
        out.append((bits, dict(ops.launches), dict(ro.decode_stats),
                    torch.cuda.memory_allocated()))
    (gres, glaunch, gst, glive), (eres, elaunch, est, elive) = out
    assert gst["graphed"] and gst["replays"] == 10 and gst["capture_ms"] > 0
    assert gst["pool_bytes"] > 0
    assert not est["graphed"] and est["replays"] == 0
    assert torch.equal(gres[0], eres[0]) and torch.equal(gres[1], eres[1])
    assert glaunch == elaunch
    L = cfg.num_layers
    assert glaunch["rmsnorm"] == (2 * L + 1) * 12 + (G > 1)
    assert glive == elive


def test_a_call_without_a_replay_is_not_captured(cuda):
    """A call of two new tokens makes one decode step, which no replay
    would follow: it runs eagerly and captures nothing. Three new tokens
    make two steps: step 1 eager, then the capture, and one replay."""
    cfg, model, params = _small(cuda, "dense")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(5))
    ro = Rollout(model, cfg, capacity=24, temperature=0.0)
    for n, graphed, replays in ((1, False, 0), (2, False, 0), (3, True, 1)):
        ro.generate(params, {"tokens": tokens}, n, torch.Generator(
            device=cuda))
        st = ro.decode_stats
        assert (st["graphed"], st["replays"]) == (graphed, replays), n
        assert (st["capture_ms"] is not None) == graphed


def test_capture_after_an_offload_cycle_reads_the_new_trees(cuda):
    """The weights park to pinned host memory and come back at new
    addresses (the old device tensors are kept, so no address is reused,
    and then zeroed): the next call's capture reads the fetched trees and
    gives the eager loop's tokens and log-probs."""
    cfg, model, params = _small(cuda, "dense")
    tokens = torch.randint(0, cfg.vocab_size, (2, 24), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(3))
    ro = Rollout(model, cfg, capacity=40, temperature=0.8, top_k=20)

    def run(p, graphs):
        ro._graphs = graphs
        return ro.generate(p, {"tokens": tokens}, 10,
                           torch.Generator(device=cuda).manual_seed(4))

    want = run(params, False)
    first = run(params, True)
    lot = HostParkingLot(cuda)
    lot.park("p", params)
    lot.prefetch("p")
    fetched = lot.fetch("p")
    old = {t.data_ptr() for t in leaves(params)}
    assert old.isdisjoint(t.data_ptr() for t in leaves(fetched))
    for t in leaves(params):
        t.zero_()
    second = run(fetched, True)
    assert ro.decode_stats["graphed"] and ro.decode_stats["replays"] == 8
    for res in (first, second):
        assert torch.equal(res.tokens, want.tokens)
        assert torch.equal(res.logp, want.logp)


def _spec_call(ro, params, tokens, n, cuda):
    torch.cuda.synchronize()
    ops.reset_launches()
    res = ro.generate(params, {"tokens": tokens}, n,
                      torch.Generator(device=cuda))
    torch.cuda.synchronize()
    return ((res.tokens.cpu(), res.logp.cpu()), dict(ops.launches),
            dict(ro.decode_stats), dict(ro.spec_stats or {}))


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_graphed_spec_step_matches_eager(cuda, backend):
    """The speculative step (MTP drafts through B2's one-position layer,
    the verify forward, the accept) replayed from its capture gives the
    eager step's tokens and log-probs to the bit, counts the launches the
    reckoning gives (B3 and B4 never), and every step after the first is
    a replay; the paged pool's pages are all free after the call."""
    cfg, _, _ = _small(cuda, "dense")
    cfg = dataclasses.replace(cfg, mtp_depth=2)
    model = Model(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (3, 21), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(1))
    kw = dict(backend="paged", page_size=8) if backend == "paged" else {}
    ro = Rollout(model, cfg, capacity=21 + 12, temperature=0.0, top_k=0,
                 spec_decode=True, spec_k=2, **kw)
    out = []
    for graphs in (True, False):
        ro._graphs = graphs
        out.append(_spec_call(ro, params, tokens, 12, cuda))
        if backend == "paged":
            ro.page_manager.check_invariants()
            assert ro.page_manager.stats.pages_in_use == 0
    (gbits, glaunch, gst, gspec), (ebits, elaunch, est, espec) = out
    assert gst["graphed"] and not est["graphed"]
    assert gst["replays"] == gspec["steps"] - 1 and gst["capture_ms"] > 0
    assert gspec == espec
    assert torch.equal(gbits[0], ebits[0]) and torch.equal(gbits[1], ebits[1])
    want = _chip_smoke().spec_launches(cfg, gspec["steps"], 2)
    assert glaunch == elaunch == want
    assert want["decode_attention"] == want["paged_decode_attention"] == 0
    van = Rollout(model, cfg, capacity=21 + 12, temperature=0.0, top_k=0,
                  **kw)
    vbits = _spec_call(van, params, tokens, 12, cuda)[0]
    assert torch.equal(vbits[0], gbits[0])


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_spec_rollout_at_full_acceptance(cuda, backend):
    """With ``chip_smoke.forced_drafts`` proposing vanilla greedy's own
    continuation (a device counter, advanced inside the captured step),
    every draft but those past the end is accepted: k+1 tokens a verify
    step, vanilla's tokens and log-probs (f32, within 1e-5), the heads'
    own drafts still launched (and dropped), B3/B4 never."""
    cs = _chip_smoke()
    cfg, _, _ = _small(cuda, "dense")
    cfg = dataclasses.replace(cfg, mtp_depth=2)
    model = Model(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (3, 21), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(2))
    kw = dict(backend="paged", page_size=8) if backend == "paged" else {}
    N, k = 16, 2
    van = Rollout(model, cfg, capacity=21 + N, temperature=0.0, top_k=0,
                  **kw)
    vbits = _spec_call(van, params, tokens, N, cuda)[0]
    ro = Rollout(model, cfg, capacity=21 + N, temperature=0.0, top_k=0,
                 spec_decode=True, spec_k=k, **kw)
    model.mtp_draft = cs.forced_drafts(model, vbits[0][:, 21:].to(cuda), k)
    try:
        bits, launches, st, spec = _spec_call(ro, params, tokens, N, cuda)
    finally:
        del model.mtp_draft
    assert st["graphed"] and spec["steps"] == -(-(N - 1) // (k + 1))
    assert spec["accepted"] >= spec["drafted"] - 3 * k
    assert torch.equal(bits[0], vbits[0])
    assert float((bits[1] - vbits[1]).abs().max()) <= 1e-5
    assert launches == cs.spec_launches(cfg, spec["steps"], k)


def test_a_capture_that_cannot_succeed_raises(cuda):
    """A step whose body syncs with the host (``.item()``) runs eagerly
    at step 1 and cannot be captured: the call raises (no eager fallback),
    the capture counts no launch, and the card goes on working, the
    default generator included (a failed capture leaves it marked as
    capturing until a capture succeeds)."""
    x = torch.ones(4, device=cuda)

    def body(tok, pos):
        ops.launches["rmsnorm"] += 1
        return x * float(pos.sum().item())

    ops.reset_launches()
    g = DG.DecodeGraph(body, 4, cuda, steps=2)
    with pytest.raises(RuntimeError):
        g(torch.zeros(4, dtype=torch.long, device=cuda), 3)
    assert ops.launches["rmsnorm"] == 1          # step 1's, not the capture's
    ops.reset_launches()
    torch.cuda.synchronize()
    assert float((x * 2).sum()) == 8.0
    assert torch.rand(3, device=cuda).shape == (3,)


# ------------------------------------------------------------ host offload
def test_offload_pinned_round_trip_is_bit_for_bit(cuda):
    """A tree of bf16, fp32 (trainable) and int64 leaves and a Python int
    parks into one pinned buffer the size of its bytes (up to each leaf's
    alignment) and comes back bit for bit, the trainable leaf still
    trainable; a second park reuses the buffer."""
    g = torch.Generator(device=cuda).manual_seed(0)
    tree = {"w": _randn(g, 1000, 77, dt="bf16", device=cuda),
            "b": [torch.randn(5, generator=g, device=cuda).requires_grad_(),
                  3],
            "m": torch.arange(10, device=cuda)}
    want = [t.detach().clone() for t in leaves(tree)]
    lot = HostParkingLot(cuda)
    lot.park("t", tree)
    host = list(leaves(lot.peek("t")))
    assert all(t.device.type == "cpu" and t.is_pinned() for t in host)
    assert 0 <= lot.pinned_bytes() - tree_nbytes(tree) < 8 * len(host)
    buf = lot._buffers["t"].data_ptr()
    lot.prefetch("t")
    got = lot.fetch("t")
    assert got["b"][1] == 3 and got["b"][0].requires_grad
    for a, b in zip(leaves(got), want):
        assert a.device == b.device and a.dtype == b.dtype
        assert torch.equal(a.detach().view(torch.uint8) if a.dim() else a,
                           b.view(torch.uint8) if b.dim() else b)
    lot.park("t", got)
    assert lot._buffers["t"].data_ptr() == buf


def test_offload_park_frees_device_bytes(cuda):
    """Parking a state through the executor gives ``memory_allocated`` back
    its bytes once the setter drops the last device reference; the fetch
    takes them again."""
    state = {"params": {"w": torch.randn(1 << 20, device=cuda),
                        "v": torch.randn(3, 1 << 18, device=cuda)}}
    nb = tree_nbytes(state["params"])
    plan = OffloadPlan.compile("roles", engine="separate",
                               states=("actor_params",))
    ex = OffloadExecutor(plan, HostParkingLot(cuda), {"actor_params": (
        lambda: state["params"], lambda v: state.__setitem__("params", v))})
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    ex.park_for_boundary("rollout")          # score_reward: not the actor's
    assert torch.cuda.memory_allocated() == before - nb
    ex.fetch_for_boundary("score_ref")       # score_values: still parked
    assert torch.cuda.memory_allocated() == before - nb
    ex.fetch_for_boundary("score_values")    # score_old_logp: the actor's
    assert torch.cuda.memory_allocated() == before
    assert state["params"]["w"].is_cuda


def test_offload_parked_tree_reached_by_a_forward_raises(cuda):
    """While parked, a tree's stand-in is pinned host memory, which the
    card could read over the bus: a forward that reaches it raises
    instead, as does every kernel wrapper handed a host tensor."""
    cfg = dataclasses.replace(get_config("llama3_2_3b").smoke(),
                              num_kv_heads=2)
    model = Model(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    lot = HostParkingLot(cuda)
    lot.park("p", {"layers": params["layers"]})
    parked = dict(params, **lot.peek("p"))
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), device=cuda)
    with pytest.raises((RuntimeError, ValueError)):
        model.forward(parked, {"tokens": tokens})
    g = torch.Generator(device=cuda).manual_seed(1)
    x = _randn(g, 16, 128, dt="bf16", device=cuda)
    q = _randn(g, 2, 16, 4, 64, dt="bf16", device=cuda)
    q1 = _randn(g, 2, 4, 64, dt="bf16", device=cuda)
    host = lambda t: t.cpu().pin_memory()  # noqa: E731
    pos = torch.zeros(2, 16, dtype=torch.int32, device=cuda)
    at = torch.full((2,), 15, dtype=torch.int32, device=cuda)
    calls = [
        lambda: trn.rmsnorm(x, host(x[0]), 1e-5),
        lambda: trn.rmsnorm_bwd(x, x[0], host(x), 1e-5),
        lambda: tfa.flash_attention_fwd(q, host(q), q),
        lambda: tfab.flash_attention_bwd(q, q, q, q, host(q[..., 0]), q),
        lambda: tdec.decode_attention(q1, host(q), q, pos, at),
        lambda: tpa.paged_decode_attention(q1, host(q), q, pos, at),
        lambda: tssd.ssd_scan(q, host(q[..., 0]), q[..., 0, :], q[..., 0, :],
                              16),
    ]
    for call in calls:
        with pytest.raises(ValueError):
            call()


def _chip_smoke():
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


def _small_opt(**kw):
    return dataclasses.replace(get_config("opt_1_3b").smoke(), num_layers=2,
                               d_model=128, d_ff=256, vocab_size=64,
                               num_heads=2, num_kv_heads=2, head_dim=64, **kw)


def test_allocator_stream_replays_to_requested_bytes(cuda):
    """chip_smoke.py phase 11's stream check on a small separate PPO
    iteration: the caching allocator's recorded alloc / free_completed
    stream, seeded with the blocks live when recording began, holds at
    every boundary exactly the bytes ``requested_bytes.all.current``
    reports; the replay through the simulator ends with the stream's live
    blocks allocated."""
    from repro_torch.rlhf import RLHFConfig, RLHFTrainer
    from repro_torch.rlhf.reward import make_target_token_reward
    cs = _chip_smoke()
    cfg = _small_opt(param_dtype="bfloat16")
    tr = RLHFTrainer(cfg, cfg, RLHFConfig(engine="separate", prompt_len=16,
                                          gen_len=8, top_k=0),
                     torch.Generator(device=cuda).manual_seed(0),
                     reward_fn=make_target_token_reward(7))
    tr.rollout._graphs = False
    prompts = torch.randint(0, 64, (4, 16), device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    tr.train_step(prompts, g)
    _, seeds, reserved, events = cs.record_stream(
        lambda: tr.train_step(prompts, g))
    recs = tr.memory.records[-7:]
    rows, whole = cs.replay_stream(seeds, reserved, events, recs,
                                   tr.rl.memory_policy,
                                   torch.cuda.mem_get_info()[1])
    assert [r["stream_live"] for r in rows] == \
        [r["requested_bytes"] for r in recs]
    assert [r["card_reserved_from_stream"] for r in rows] == \
        [r["reserved_bytes"] for r in recs]
    assert rows[-1]["replay_allocated"] >= rows[-1]["stream_live"]
    assert len(whole["streams"]) == 1      # eager: one stream, one pool


def test_grpo_step_on_card_matches_cpu(cuda):
    """Two greedy f32 GRPO steps on the paged backend, card against CPU
    from the same weights: the same tokens' metrics within 1e-4, the
    launches as ``chip_smoke.grpo_launches`` reckons them."""
    from repro_torch.rlhf import GRPOConfig, GRPOTrainer
    from repro_torch.rlhf.reward import make_target_token_reward
    cfg = _small_opt()
    rl = GRPOConfig(prompt_len=16, gen_len=6, group_size=4, lr=1e-3,
                    temperature=0.0, rollout_backend="paged", page_size=4)
    cpu = GRPOTrainer(cfg, rl, torch.Generator().manual_seed(0),
                      make_target_token_reward(7))
    card = GRPOTrainer(cfg, rl, None, make_target_token_reward(7),
                       params=_to_device(cpu.actor_state["params"], cuda))
    prompts = torch.randint(0, 64, (2, 16),
                            generator=torch.Generator().manual_seed(3))
    for step in range(2):
        ops.reset_launches()
        got = card.train_step(prompts.to(cuda), torch.Generator(device=cuda))
        assert dict(ops.launches) == _chip_smoke().grpo_launches(
            cfg, rl.gen_len)
        want = cpu.train_step(prompts, torch.Generator())
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-4, (step, k, got[k], want[k])


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.detach().to(device)


# ------------------------------------------------------ runtime telemetry
def test_attribution_is_exact_on_cuda(cuda):
    """On the card the total is ``memory_allocated`` and each owner is
    charged its storage's block: the request rounded to 512 bytes, or with
    ``full`` the allocator's own block; a view counts once; a parked tree
    is a host owner; the residue is what no owner holds."""
    from repro_torch.obs import MemoryAttributor
    torch.cuda.synchronize()
    a = torch.ones(1000, device=cuda)               # 4000 -> 4096
    b = torch.ones(3, 5, device=cuda)               # 60 -> 512
    c = torch.ones(1 << 20, device=cuda)            # 4 MiB, unowned
    lot = HostParkingLot(cuda)
    parked = {"w": torch.ones(256, device=cuda)}
    lot.park("opt", parked)
    at = MemoryAttributor(device=cuda, lot=lot, top_k=1 << 20)
    at.register("a", lambda: {"x": a, "view": a[10:]})
    at.register("b", lambda: [b, a])
    at.register("opt", lambda: lot.peek("opt"))
    for full in (False, True):
        snap = at.snapshot(full=full)
        assert snap.total_bytes == torch.cuda.memory_allocated(cuda)
        assert snap.owners == {"a": 4096, "b": 512, "opt": 0}
        assert snap.unattributed == snap.total_bytes - 4608 >= c.nbytes
        assert snap.host_owners == {"opt": 1024}
    top = snap.top_buffers             # every active block, largest first
    assert [t["nbytes"] for t in top] == sorted(
        (t["nbytes"] for t in top), reverse=True)
    assert sum(t["nbytes"] for t in top) == snap.total_bytes
    assert {"nbytes": c.nbytes, "shape": "?", "dtype": "?",
            "owner": "(unattributed)", "path": ""} in top
    assert {"nbytes": 4096, "shape": "(1000,)", "dtype": "float32",
            "owner": "a", "path": "['x']"} in top


def test_is_oom_on_a_capped_allocation(cuda):
    """A real out-of-memory error under a per-process cap is one the
    flight recorder recognises, and its dump keeps the CUDA message."""
    from repro_torch.obs import FlightRecorder
    fl = FlightRecorder(device=cuda)
    assert fl.capacity_bytes == torch.cuda.mem_get_info(cuda)[1]
    card = torch.cuda.current_device()
    torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction(0.01, card)
    try:
        with pytest.raises(torch.cuda.OutOfMemoryError) as err:
            torch.empty(fl.capacity_bytes // 10, dtype=torch.uint8,
                        device=cuda)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, card)
    assert fl.is_oom(err.value)
    dump = fl.record_oom(err.value, live_bytes=1, phase="p")
    assert "out of memory" in dump["error"]


def test_annotated_spans_in_a_cuda_profile(cuda):
    """``annotate=True`` on the card: record_function ranges (and NVTX
    ranges) around the spans show in a torch.profiler trace with CUDA
    activity."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs import SpanTracer
    tr = SpanTracer(annotate=True)
    assert tr._nvtx
    x = torch.ones(256, 256, device=cuda)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.begin("ppo_iteration", "iteration")
        tr.push_annotation("train_actor")
        (x @ x).sum().item()
        tr.pop_annotation()
        tr.end()
    names = {e.key for e in prof.key_averages()}
    assert {"ppo_iteration", "train_actor"} <= names


def test_ppo_telemetry_on_card(cuda):
    """A small separate PPO iteration with telemetry on the card: every
    record's owner table and residue sum to ``memory_allocated``, the
    spans carry the simulator's bytes, the launches are the run's without
    telemetry, and the metrics the same bits."""
    from repro_torch.obs import RunTelemetry
    from repro_torch.rlhf import RLHFConfig, RLHFTrainer
    from repro_torch.rlhf.reward import make_target_token_reward
    cfg = _small_opt(param_dtype="bfloat16")
    rl = RLHFConfig(engine="separate", prompt_len=16, gen_len=8, top_k=0)
    prompts = torch.randint(0, 64, (4, 16), device=cuda)
    out = []
    for tel in (None, RunTelemetry.create(annotate=True)):
        tr = RLHFTrainer(cfg, cfg, rl,
                         torch.Generator(device=cuda).manual_seed(0),
                         reward_fn=make_target_token_reward(7),
                         telemetry=tel)
        seen = []
        if tel is not None:
            record = tr.memory._record

            def checked(*a, **k):
                rec = record(*a, **k)
                seen.append((sum(rec["attrib"].values())
                             + rec["attrib_unattributed"], rec["live_bytes"],
                             torch.cuda.memory_allocated(cuda)))
                return rec
            tr.memory._record = checked
        ops.reset_launches()
        m = tr.train_step(prompts, torch.Generator(device=cuda).manual_seed(1))
        out.append((m, dict(ops.launches)))
        del tr
    assert out[0] == out[1]
    assert len(seen) == 7 and all(a == b == c for a, b, c in seen)
    spans = [s for s in tel.tracer.spans if s.cat == "phase"]
    assert all("sim_peak_bytes" in s.args for s in spans)
    assert all(s.args["measured_peak_bytes"] >= s.args["measured_bytes"]
               for s in spans)


# ------------------------------------------------ the continuous batcher
BATCHER_CASES = {
    "dense": dict(cache_backend="dense"),
    "paged": dict(cache_backend="paged", page_size=8),
    "paged_tight": dict(cache_backend="paged", page_size=8, num_pages=16),
    "prefix": dict(cache_backend="paged", page_size=8, prefix_cache=True),
    "spec_dense": dict(cache_backend="dense", spec_decode=True, spec_k=2),
    "spec_paged": dict(cache_backend="paged", page_size=8, spec_decode=True,
                       spec_k=2),
}


def _batcher_drain(model, cfg, params, graphs, traffic, **kw):
    """A batcher (graphed, or eager with the class switch off) through
    warmup and ``traffic`` -> ((tokens, preemptions) a request, steps,
    pages after each step, launches, its graphs' stats, the batcher)."""
    from repro_torch.serving import ContinuousBatcher
    ContinuousBatcher._graphs = graphs
    try:
        ops.reset_launches()
        cb = ContinuousBatcher(model, cfg, params, slots=4, capacity=96,
                               seed=5, capture_buckets=(2, 4, 32, 64), **kw)
        reqs = [cb.submit(p, n) for p, n in traffic]
        pages = []
        while cb.n_queued or any(r is not None for r in cb.active):
            cb.step()
            pages.append(cb.pm.stats.pages_in_use if cb.pm else None)
        if cb.device.type == "cuda":
            torch.cuda.synchronize()
        return ([(r.out_tokens, r.n_preempted) for r in reqs], cb.steps,
                pages,
                dict(ops.launches), cb.graph_stats(), cb)
    finally:
        ContinuousBatcher._graphs = True


def _batcher_traffic(cfg, seed, n=7):
    g = torch.Generator().manual_seed(seed)
    system = torch.randint(0, cfg.vocab_size, (16,), generator=g)
    out = []
    for i in range(n):
        tail = torch.randint(0, cfg.vocab_size,
                             (int(torch.randint(3, 30, (1,), generator=g)),),
                             generator=g)
        out.append((torch.cat([system, tail]).numpy(),
                    int(torch.randint(5, 24, (1,), generator=g))))
    return out


@pytest.mark.parametrize("case", sorted(BATCHER_CASES))
def test_graphed_batcher_matches_eager(cuda, case):
    """The batcher's decode graphs (one a slot rung, captured at warmup and
    replayed every step) give the eager batcher's tokens (sampled where
    the case allows it, greedy under spec decode), steps, pages at every
    step and launches; every graph replayed, none recompiled."""
    kw = BATCHER_CASES[case]
    spec = kw.get("spec_decode", False)
    cfg = dataclasses.replace(get_config("llama3_2_3b").smoke(),
                              num_kv_heads=2, mtp_depth=2 if spec else 0)
    model = Model(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    samp = dict(temperature=0.0) if spec else dict(temperature=0.8, top_k=20)
    traffic = _batcher_traffic(cfg, 1)
    g = _batcher_drain(model, cfg, params, True, traffic, **kw, **samp)
    e = _batcher_drain(model, cfg, params, False, traffic, **kw, **samp)
    assert g[:4] == e[:4]
    assert all(st["graphed"] and st["replays"] > 0 for st in g[4].values())
    assert not any(st["graphed"] for st in e[4].values())
    assert g[5].compile_cache.recompiles == 0
    if case == "paged_tight":
        assert sum(n for _, n in g[0]) >= 1


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_batcher_update_params_recaptures(cuda, backend):
    """``update_params`` drops the graphs (they captured the old weights'
    addresses); the next decodes recapture on the new weights, and the
    tokens are a fresh eager batcher's on them."""
    cfg = dataclasses.replace(get_config("llama3_2_3b").smoke(),
                              num_kv_heads=2)
    model = Model(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    other = model.init(torch.Generator(device=cuda).manual_seed(1))
    kw = dict(cache_backend=backend, page_size=8, temperature=0.0)
    _, _, _, _, _, cb = _batcher_drain(model, cfg, params, True,
                                       _batcher_traffic(cfg, 1), **kw)
    captures = cb.n_captures
    cb.update_params(other)
    assert not cb.graphs
    traffic = _batcher_traffic(cfg, 2)
    reqs = [cb.submit(p, n) for p, n in traffic]
    cb.run_until_drained()
    assert cb.n_captures > captures
    assert all(st["graphed"] for st in cb.graph_stats().values())
    fresh = _batcher_drain(model, cfg, other, False, traffic, **kw)
    assert [(r.out_tokens, r.n_preempted) for r in reqs] == fresh[0]


# ------------------------------------------------------------------ ZeRO
@pytest.fixture
def one_rank(tmp_path):
    """A process group of one rank for a test (``backend`` the fixture's
    param: NCCL, or gloo on CUDA tensors), destroyed after it."""
    import datetime

    import torch.distributed as dist

    def init(backend):
        dist.init_process_group(
            backend, store=dist.FileStore(str(tmp_path / backend), 1),
            rank=0, world_size=1, timeout=datetime.timedelta(seconds=60))
    yield init
    if dist.is_initialized():
        dist.destroy_process_group()


def _zero_run(cfg, engine, dev, shard):
    from repro_torch.rlhf import RLHFConfig, RLHFTrainer
    from repro_torch.rlhf.reward import make_target_token_reward
    rl = RLHFConfig(engine=engine, prompt_len=16, gen_len=8, top_k=0,
                    lora_rank=8)
    tr = RLHFTrainer(cfg, cfg, rl, torch.Generator(device=dev).manual_seed(0),
                     reward_fn=make_target_token_reward(7), shard=shard)
    prompts = torch.randint(0, 64, (3, 16), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(2))
    g = torch.Generator(device=dev).manual_seed(1)
    out = []
    for _ in range(2):
        ops.reset_launches()
        out.append((tr.train_step(prompts, g), dict(ops.launches)))
    return out, tr


@pytest.mark.parametrize("mode", ["1-layer", "3-tree", "3-layer"])
@pytest.mark.parametrize("engine", ["separate", "hydra"])
def test_zero_over_nccl_at_one_rank_matches_unsharded(cuda, one_rank, engine,
                                                      mode):
    """``chip_smoke.py`` phase 15's NCCL path on a small bf16 model: 2
    iterations at ZeRO-1 and ZeRO-3 (both gather modes), metrics and
    launches bit for bit the unsharded trainer's."""
    from repro_torch.sharding import ShardedContext
    one_rank("nccl")
    stage, gm = mode.split("-")
    cfg = _small_opt(param_dtype="bfloat16")
    want, _ = _zero_run(cfg, engine, cuda, None)
    sc = ShardedContext.create(1, zero_stage=int(stage), gather_mode=gm,
                               device="cuda")
    got, _ = _zero_run(cfg, engine, cuda, sc)
    assert got == want


def test_zero_over_gloo_on_cuda_stages_through_host(cuda, one_rank):
    """gloo on CUDA tensors (phase 15's two ranks on one card) at one rank:
    the unsharded bits, every collective copied through pinned host
    memory and counted."""
    from repro_torch.sharding import ShardedContext
    one_rank("gloo")
    cfg = _small_opt(param_dtype="bfloat16")
    want, _ = _zero_run(cfg, "separate", cuda, None)
    sc = ShardedContext.create(1, zero_stage=3, gather_mode="layer",
                               device="cuda", backend="gloo")
    got, _ = _zero_run(cfg, "separate", cuda, sc)
    assert got == want
    assert sc.comm.stage and sc.comm.staged_bytes > 0


# ----------------------------------------- prefix and encoder-decoder inputs
@pytest.mark.parametrize("B,Sq,Sk,dt", [
    (2, 100, 257, "bf16"),      # a cross-attention prefill: Sq != Sk
    (2, 257, 100, "bf16"),
    (2, 33, 70, "f32"),
    (3, 1, 200, "bf16"),        # one query a row over the frames
    (3, 1, 200, "f32"),
])
def test_flash_cross_attention_shapes_match_plain(cuda, B, Sq, Sk, dt):
    """B2 non-causal at MHA (G 1) and D 64, seamless's heads: the out and
    lse, and B2-bwd's gradients, against the plain versions at Sq != Sk
    and at one query a row."""
    g = torch.Generator(device=cuda).manual_seed(11)
    q = _randn(g, B, Sq, 4, 64, dt=dt, device=cuda)
    k = _randn(g, B, Sk, 4, 64, dt=dt, device=cuda)
    v = _randn(g, B, Sk, 4, 64, dt=dt, device=cuda)
    dout = _randn(g, B, Sq, 4, 64, dt=dt, device=cuda)
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=False,
                                       return_lse=True)
    want, want_lse = ref.attention_ref(q, k, v, causal=False,
                                       return_lse=True)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dt],
                               rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=TOL[dt], rtol=0)
    got = tfab.flash_attention_bwd(q, k, v, out, lse, dout, causal=False)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=False)
    for a, b in zip(got, want):
        _assert_scaled(a, b, TOL_BWD[dt])


@pytest.mark.parametrize("B,H,D,C,dt", [
    (8, 16, 64, 1024, "bf16"),  # seamless's cross decode: 1024 frames
    (2, 4, 64, 40, "f32"),
    (2, 4, 128, 333, "bf16"),
])
def test_decode_kernel_over_all_valid_frames_matches_plain(cuda, B, H, D, C,
                                                           dt):
    """B3 over an encoder's K/V with the positions that would make a
    cross-attention decode's every frame valid (0..C-1 a row, the query's C-1, so every slot is valid):
    against the plain version and against unmasked attention of the one
    query."""
    g = torch.Generator(device=cuda).manual_seed(12)
    q = _randn(g, B, H, D, dt=dt, device=cuda)
    kc = _randn(g, B, C, H, D, dt=dt, device=cuda)
    vc = _randn(g, B, C, H, D, dt=dt, device=cuda)
    pos = torch.arange(C, dtype=torch.int32, device=cuda).expand(B, C)
    position = torch.full((B,), C - 1, dtype=torch.int32, device=cuda)
    out = tdec.decode_attention(q, kc, vc, pos.contiguous(), position)
    want = ref.decode_attention_ref(q, kc, vc, pos, position)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dt],
                               rtol=0)
    full = ref.attention_ref(q[:, None], kc, vc, causal=False)[:, 0]
    torch.testing.assert_close(out.float(), full.float(), atol=TOL[dt],
                               rtol=0)


@pytest.mark.parametrize("arch", ["internvl2_2b", "seamless_m4t_large_v2"])
def test_embedding_inputs_on_card_match_cpu(cuda, arch):
    """The smoke internvl (8 prefix embeddings) and seamless (2 encoder
    layers over 8 frames, cross-attention) models, f32, through the
    kernels on the card give the CPU plain path's prefill logits (1e-4)
    and greedy tokens (``chip_smoke.check_small_model_against_cpu``)."""
    cs = _chip_smoke()
    err = cs.check_small_model_against_cpu(
        cuda, get_config(arch).smoke(), prompt=24, seed=7)
    assert err <= 1e-4
