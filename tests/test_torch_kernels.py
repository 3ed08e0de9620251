"""The port's kernels on the CPU: plain versions against the JAX Pallas
kernels (interpret mode, as ``tests/test_kernels.py`` runs them), the
CPU/CUDA dispatch in ``kernels/ops.py`` and the build commands. The CUDA
kernels themselves are tested on a card by ``tests/test_torch_gpu.py``.

Tolerances are those of ``tests/test_kernels.py:15``: 5e-5 in f32,
2e-2 in bf16 (another order of summation, and bf16 output rounding).
"""
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.decode_attention import decode_attention as jax_decode  # noqa: E402
from repro.kernels.flash_attention import flash_attention_fwd as jax_flash  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm  # noqa: E402
from repro.paged.attention import \
    paged_decode_attention as jax_paged  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as tdec  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as tfab  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.kernels import rmsnorm as trn  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402

DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dt):
    return 2e-2 if dt == "bf16" else 5e-5


def _pair(a, dt):
    """The same values as a JAX array and a torch tensor of dtype ``dt``."""
    jdt, tdt = DT[dt]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("B,Sq,Sk,H,K,D,causal,window,bq,bk,dt", [
    (2, 128, 128, 4, 2, 64, True, 0, 64, 64, "f32"),
    (2, 100, 100, 6, 2, 32, True, 0, 64, 64, "f32"),
    (1, 64, 192, 4, 1, 64, False, 0, 32, 64, "f32"),
    (1, 96, 96, 2, 2, 128, True, 32, 32, 32, "bf16"),
])
def test_attention_ref_matches_pallas(B, Sq, Sk, H, K, D, causal, window,
                                      bq, bk, dt):
    rng = np.random.RandomState(B + Sq)
    qj, qt = _pair(rng.randn(B, Sq, H, D).astype(np.float32), dt)
    kj, kt = _pair(rng.randn(B, Sk, K, D).astype(np.float32), dt)
    vj, vt = _pair(rng.randn(B, Sk, K, D).astype(np.float32), dt)
    out_j = jax_flash(qj, kj, vj, causal=causal, window=window,
                      block_q=bq, block_k=bk)
    out_t = ref.attention_ref(qt, kt, vt, causal=causal, window=window)
    assert out_t.dtype == qt.dtype and out_t.shape == qt.shape
    np.testing.assert_allclose(_np(out_t), _np(out_j), atol=_tol(dt))


def _rolling_pos(B, C, position):
    slots = np.arange(C)[None, :].repeat(B, 0)
    base = position[:, None] - (position[:, None] % C)
    pos = np.where(slots <= (position[:, None] % C), base + slots,
                   base - C + slots)
    return np.where(pos < 0, -1, pos).astype(np.int32)


@pytest.mark.parametrize("B,H,K,D,C,window,bc,dt", [
    (2, 8, 2, 64, 128, 0, 64, "f32"),
    (1, 4, 4, 32, 96, 24, 32, "f32"),
    (2, 6, 1, 128, 256, 0, 512, "bf16"),
])
def test_decode_attention_ref_matches_pallas(B, H, K, D, C, window, bc, dt):
    rng = np.random.RandomState(H + C)
    qj, qt = _pair(rng.randn(B, H, D).astype(np.float32), dt)
    kj, kt = _pair(rng.randn(B, C, K, D).astype(np.float32), dt)
    vj, vt = _pair(rng.randn(B, C, K, D).astype(np.float32), dt)
    position = np.full((B,), C + 5 if window else C - 2, np.int32)
    pos = _rolling_pos(B, C, position)
    out_j = jax_decode(qj, kj, vj, jnp.asarray(pos), jnp.asarray(position),
                       window=window, block_c=bc)
    out_t = ref.decode_attention_ref(qt, kt, vt, torch.from_numpy(pos),
                                     torch.from_numpy(position), window=window)
    np.testing.assert_allclose(_np(out_t), _np(out_j), atol=_tol(dt))


@pytest.mark.parametrize("shape,dt", [
    ((4, 64, 256), "bf16"),
    ((3, 100), "f32"),
    ((2, 7, 384), "bf16"),
    ((1, 1, 128), "f32"),
])
def test_rmsnorm_ref_matches_pallas(shape, dt):
    rng = np.random.RandomState(shape[-1])
    xj, xt = _pair(rng.randn(*shape).astype(np.float32), dt)
    s = rng.randn(shape[-1]).astype(np.float32)
    out_j = jax_rmsnorm(xj, jnp.asarray(s))
    out_t = ref.rmsnorm_ref(xt, torch.from_numpy(s))
    assert out_t.dtype == xt.dtype
    np.testing.assert_allclose(_np(out_t), _np(out_j), atol=_tol(dt))


def test_ops_take_the_plain_version_on_cpu_and_count_no_launch():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(3, 64).astype(np.float32))
    s = torch.from_numpy(rng.randn(64).astype(np.float32))
    q = torch.from_numpy(rng.randn(1, 8, 4, 64).astype(np.float32))
    kv = torch.from_numpy(rng.randn(1, 8, 2, 64).astype(np.float32))
    pos = torch.arange(8, dtype=torch.int32)[None]
    cur = torch.tensor([7], dtype=torch.int32)
    ops.reset_launches()
    torch.testing.assert_close(ops.rmsnorm(x, s), ref.rmsnorm_ref(x, s))
    torch.testing.assert_close(ops.flash_attention(q, kv, kv, window=3),
                               ref.attention_ref(q, kv, kv, window=3))
    torch.testing.assert_close(
        ops.decode_attention(q[:, 0], kv, kv, pos, cur),
        ref.decode_attention_ref(q[:, 0], kv, kv, pos, cur))
    bt = torch.tensor([[1, -1, 0]], dtype=torch.int32)
    pool = torch.from_numpy(rng.randn(2, 4, 2, 64).astype(np.float32))
    torch.testing.assert_close(
        ops.paged_decode_attention(q[:, 0], pool, pool, bt, cur),
        ref.paged_attention_ref(q[:, 0], pool, pool, bt, cur))
    xs = torch.from_numpy(rng.randn(1, 32, 2, 16).astype(np.float32))
    a = -torch.from_numpy(np.abs(rng.randn(1, 32, 2)).astype(np.float32))
    bc = torch.from_numpy(rng.randn(1, 32, 8).astype(np.float32))
    for got, want in zip(ops.ssd_scan(xs, a, bc, bc, 16),
                         ref.ssd_scan_ref(xs, a, bc, bc, 16)):
        torch.testing.assert_close(got, want)
    assert ops.launches == {k: 0 for k in ops.KERNELS}


@pytest.mark.parametrize("call", ["rmsnorm", "flash", "decode", "paged",
                                  "ssd", "flash_bwd", "flash_bwd_bf16",
                                  "rmsnorm_bwd"])
def test_kernel_wrappers_refuse_non_cuda_tensors(call):
    """A wrapper launches on CUDA tensors or raises; it never computes
    the plain version itself."""
    x = torch.zeros(2, 8, 4, 64, device="meta")
    kv = torch.zeros(2, 8, 2, 64, device="meta")
    pos = torch.zeros(2, 8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        if call == "rmsnorm":
            trn.rmsnorm(x, torch.ones(64, device="meta"))
        elif call == "flash":
            tfa.flash_attention_fwd(x, kv, kv)
        elif call == "flash_bwd":
            tfab.flash_attention_bwd(x, kv, kv, x, pos, x)
        elif call == "flash_bwd_bf16":      # the tensor-core route
            xb, kvb = x.bfloat16(), kv.bfloat16()
            assert tfab.route(xb.dtype, 64) == "wgmma"
            tfab.flash_attention_bwd(xb, kvb, kvb, xb,
                                     torch.zeros(2, 8, 4, device="meta"), xb)
        elif call == "rmsnorm_bwd":
            trn.rmsnorm_bwd(x, torch.ones(64, device="meta"), x)
        elif call == "ssd":         # CPU tensors: ops.py's to route
            tssd.ssd_scan(torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2),
                          torch.zeros(1, 8, 4), torch.zeros(1, 8, 4), 8)
        elif call == "paged":
            tpa.paged_decode_attention(x[:, 0], kv, kv, pos,
                                       torch.zeros(2, dtype=torch.int32,
                                                   device="meta"))
        else:
            tdec.decode_attention(x[:, 0], kv, kv, pos,
                                  torch.zeros(2, dtype=torch.int32,
                                              device="meta"))


def test_build_compiles_each_source_for_sm90a(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "nvcc", lambda: "nvcc")
    compiles, link = build.compile_commands(tmp_path)
    names = sorted(p.name for p in build.sources())
    assert names == ["decode_attention.cu", "flash_attention.cu",
                     "flash_attention_bwd.cu", "paged_attention.cu",
                     "rmsnorm.cu", "ssd_scan.cu"]
    assert len(compiles) == len(names)
    for cmd in compiles + [link]:
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert "-fPIC" in cmd and "-O3" in cmd and "-std=c++17" in cmd
    assert "-shared" in link and link[-1].endswith(build.LIB_NAME)
    assert len(build.source_hash()) == 16


@pytest.mark.parametrize("B,K,C", [
    (8, 8, 576),        # the serving path: 5 splits of 128 slots
    (64, 8, 576),       # the card is full without splitting
    (2, 8, 16),         # C below one step
    (2, 2, 100),
    (1, 8, 4096),
    (3, 1, 333),
])
def test_decode_split_plan(B, K, C):
    """The split rule reads only the shapes: spans are whole 32-slot
    steps, cover C, none is empty, and the grid aims at two blocks per SM
    without cutting the cache finer than one step a split."""
    splits, span = tdec.split_plan(B, K, C)
    assert span % tdec.STEP == 0
    assert splits * span >= C > (splits - 1) * span
    assert 1 <= splits <= -(-C // tdec.STEP)
    # never more than twice as coarse as aimed (rounding spans up to whole
    # steps), and never finer than one step a split
    aim = min(-(-tdec.TARGET_BLOCKS // (B * K)), -(-C // tdec.STEP))
    assert 2 * splits >= aim and splits <= aim
    assert tdec.split_plan(B, K, C) == (splits, span)
    if (B, K, C) == (8, 8, 576):
        assert (splits, span) == (5, 128)
    if (B, K, C) == (64, 8, 576):
        assert splits == 1


def _split_combine(q, kc, vc, pos, position, window, splits, span):
    """The split kernel's algebra in plain PyTorch (fp32): each span of
    slots gives an unnormalised partial (m, l, acc) over its real slots,
    masked ones scoring -1e30; the combine rescales the partials to their
    common max and sums them."""
    B, H, D = q.shape
    C, K = kc.shape[1], kc.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, D).float() / D ** 0.5
    cur = position[:, None]
    valid = (pos >= 0) & (pos <= cur)
    if window:
        valid &= pos > cur - window
    parts = []
    for sp in range(splits):
        lo, hi = sp * span, min(C, (sp + 1) * span)
        s = torch.einsum("bkgd,bckd->bkgc", qg, kc[:, lo:hi].float())
        s = torch.where(valid[:, None, None, lo:hi], s,
                        torch.full_like(s, ref.NEG_INF))
        m = s.max(-1).values
        p = torch.exp(s - m[..., None])
        parts.append((m, p.sum(-1),
                      torch.einsum("bkgc,bckd->bkgd", p, vc[:, lo:hi].float())))
    mx = torch.stack([m for m, _, _ in parts]).max(0).values
    lsum = sum(l_ * torch.exp(m - mx) for m, l_, _ in parts)
    acc = sum(a * torch.exp(m - mx)[..., None] for m, _, a in parts)
    return (acc / lsum.clamp_min(1e-30)[..., None]).reshape(B, H, D)


@pytest.mark.parametrize("B,H,K,D,C,cur,window,splits", [
    (2, 8, 2, 64, 576, 574, 0, None),     # the rule's own split
    (2, 8, 2, 64, 576, 40, 0, 5),         # most splits hold no valid slot
    (2, 6, 1, 32, 100, 130, 16, 4),       # wrapped, a window, one split
    (3, 4, 4, 32, 20, 30, 0, 1),          # C below one span
    (2, 8, 1, 64, 300, 250, 0, 10),       # G = 8
])
def test_decode_split_combine_matches_oracle(B, H, K, D, C, cur, window,
                                             splits):
    """Split-and-combine equals the oracle, empty splits, the -1e30 fill
    and a row with no valid slot (row 1: the uniform mean over its C real
    slots) included."""
    rng = np.random.RandomState(C + H)
    q = torch.from_numpy(rng.randn(B, H, D).astype(np.float32))
    kc = torch.from_numpy(rng.randn(B, C, K, D).astype(np.float32))
    vc = torch.from_numpy(rng.randn(B, C, K, D).astype(np.float32))
    position = np.full((B,), cur, np.int32)
    pos = torch.from_numpy(_rolling_pos(B, C, position))
    position = torch.from_numpy(position)
    position[1] = -1
    if splits is None:
        splits, span = tdec.split_plan(B, K, C)
    else:
        span = -(-C // splits)
    got = _split_combine(q, kc, vc, pos, position, window, splits, span)
    want = ref.decode_attention_ref(q, kc, vc, pos, position, window=window)
    torch.testing.assert_close(got, want, atol=5e-5, rtol=0)
    torch.testing.assert_close(got[1], vc[1].mean(0).repeat_interleave(
        H // K, 0), atol=5e-5, rtol=0)


@pytest.mark.parametrize("B,K,nb", [
    (64, 8, 36),        # the paged GRPO rollout's last decode step
    (64, 8, 300),       # a long context: spans of at most 64 pages
    (8, 8, 36),         # one tile
    (12, 2, 10),        # B not a multiple of the tile
    (8, 1, 3),          # nb below the split count aimed at
    (1, 1, 1),
    (3, 4, 200),
])
def test_paged_plan(B, K, nb):
    """B4's split rule reads only the shapes: tiles of 8 rows cover B,
    the splits deal the pages round-robin, none is empty or takes more
    than MAX_SPAN pages, and the grid aims at two blocks per SM without
    exceeding it."""
    pl = tpa.plan(B, K, nb)
    assert pl.rows == tpa.ROWS == 8
    assert pl.tiles * pl.rows >= B > (pl.tiles - 1) * pl.rows
    assert 1 <= pl.splits <= nb and pl.span == -(-nb // pl.splits)
    per_split = np.bincount(np.arange(nb) % pl.splits, minlength=pl.splits)
    assert per_split.min() >= 1 and per_split.max() == pl.span
    assert pl.span <= tpa.MAX_SPAN
    aim = max(1, tpa.TARGET_BLOCKS // (pl.tiles * K))
    if -(-nb // tpa.MAX_SPAN) <= aim:
        # at most the target (or one split), and as fine as it allows, to
        # rounding of whole pages
        assert pl.splits <= aim and 2 * pl.splits >= min(aim, nb)
    if (B, K, nb) == (64, 8, 36):
        assert tuple(pl) == (8, 8, 4, 9)         # 256 blocks of 9 pages
    if (B, K, nb) == (64, 8, 300):
        assert tuple(pl) == (8, 8, 10, 30)       # MAX_SPAN sets the count


def test_paged_launch_plan_reads_shapes_only():
    """The wrapper's plan comes from the tensors' shapes alone: tensors on
    the meta device (which hold no data) give it, and the forked, distinct
    and same tables of the paged GRPO step (``chip_smoke.main_tables``),
    with any positions, give the same one; the pages the kernel copies
    differ, and for the rollout's own table they are its distinct
    pages."""
    import chip_smoke
    B, K, nb, ps = 64, 8, 36, 16
    meta = [torch.empty(s, device="meta") for s in
            ((B, 24, 128), (577, ps, K, 128), (B, nb))]
    want = tpa.launch_plan(*meta)
    assert want == tuple(tpa.plan(B, K, nb)[2:]) == (4, 9)
    rng = np.random.RandomState(0)
    loads = {}
    for name in chip_smoke.PAGED_TABLES:
        bt, P = chip_smoke.main_tables(name)
        for position in (torch.full((B,), 566), torch.from_numpy(
                rng.randint(-1, 576, B))):
            assert tpa.launch_plan(torch.zeros(B, 24, 128),
                                   torch.zeros(P, ps, K, 128), bt) == want
        per_block = tpa.block_loads(bt, torch.full((B,), 566), ps,
                                    tpa.plan(B, K, nb))
        assert per_block.shape == (8, 4)
        loads[name] = int(per_block.sum())
        if name == "forked":
            # every distinct page copied once; a group's private pages
            # (31-35, its last five) dealt over the four splits
            assert bt.unique().numel() == 568
            assert per_block[0].tolist() == [8 + 8, 8 + 8, 8 + 8, 7 + 2 * 8]
    assert loads == {"forked": 568, "distinct": B * nb, "same": 8 * nb}
    assert tpa.launch_plan(*meta, splits=2) == (2, 18)
    with pytest.raises(ValueError, match="pages a split"):
        tpa.launch_plan(meta[0], meta[1], torch.empty(B, 40, device="meta"),
                        splits=1)


def _paged_split_combine(q, kp, vp, bt, position, pl):
    """B4's algebra in plain PyTorch (fp32): per tile of ``pl.rows`` rows
    and split of the pages (split s takes pages s, s + splits, ...), each
    row's unnormalised partial (m, l, acc) over the pages of the split it
    still walks (``walk_ends``), its masked slots scoring -1e30 and a
    split with none of them leaving m = -inf, l = 0; then the merge
    rescales the partials to their common max and sums them."""
    B, H, D = q.shape
    ps, K = kp.shape[1], kp.shape[2]
    G, nb = H // K, bt.shape[1]
    ends = tpa.walk_ends(bt, position, ps)
    qg = q.float().reshape(B, K, G, D) / D ** 0.5
    out = torch.zeros(B, K, G, D)
    for t in range(pl.tiles):
        for b in range(t * pl.rows, min(B, (t + 1) * pl.rows)):
            parts = []
            for sp in range(pl.splits):
                js = [j for j in range(sp, nb, pl.splits) if j < ends[b]]
                if not js:
                    parts.append((torch.full((K, G), -float("inf")),
                                  torch.zeros(K, G), torch.zeros(K, G, D)))
                    continue
                pages = bt[b, js].clamp(min=0).long()
                k = kp[pages].float().reshape(-1, K, D)
                v = vp[pages].float().reshape(-1, K, D)
                slots = torch.cat([torch.arange(j * ps, (j + 1) * ps)
                                   for j in js])
                valid = (bt[b, js] >= 0).repeat_interleave(ps) & \
                    (slots <= position[b])
                s = torch.einsum("kgd,skd->kgs", qg[b], k)
                s = torch.where(valid, s, torch.full_like(s, ref.NEG_INF))
                m = s.max(-1).values
                p = torch.exp(s - m[..., None])
                parts.append((m, p.sum(-1),
                              torch.einsum("kgs,skd->kgd", p, v)))
            mx = torch.stack([m for m, _, _ in parts]).max(0).values
            lsum = sum(l_ * torch.exp(m - mx) for m, l_, _ in parts)
            acc = sum(a * torch.exp(m - mx)[..., None] for m, _, a in parts)
            out[b] = acc / lsum.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, D)


@pytest.mark.parametrize("case,splits", [
    ("forked", None),       # 2 groups of 8 rows, CoW-copied partial page
    ("forked", 3),
    ("ragged", None),       # one position per row, a walk end per row
    ("holes", 2),           # -1 holes in the middle and a tail of -1
    ("idle", None),         # a row at position -1 inside a tile
    ("early", 4),           # later splits hold no valid slot for most rows
    ("b_odd", None),        # B = 13: a tile of 5 rows
    ("g8", 3),              # G = 8
    ("nb_small", None),     # nb 3 below the 33 splits aimed at
])
def test_paged_split_combine_matches_oracle_and_pallas(case, splits):
    """B4's split-and-merge over tiles of rows equals the oracle and the
    Pallas kernel (interpret mode) at 5e-5 in fp32, with the plan's splits
    or forced ones: partial prompt pages, ragged positions, holes, -1
    tails, an idle row (the uniform mean of every page it names), spans
    past a row's walk, a ragged last tile, G = 8 and nb below the split
    count the plan aims at."""
    rng = np.random.RandomState(len(case) + (splits or 0))
    B, H, K, D, ps = 16, 4, 2, 32, 4
    if case in ("forked", "ragged", "idle"):
        import chip_smoke                    # nb 7, prompt pages 5.25
        bt, P = chip_smoke.forked_tables(2, 21, 8, 6, ps)
        bt = bt.numpy()
        position = np.full(B, 25, np.int32)
        if case == "ragged":
            position = rng.randint(18, 26, B).astype(np.int32)
        if case == "idle":
            position[3] = -1
    else:
        B = {"b_odd": 13, "g8": 9, "nb_small": 8}.get(case, 10)
        nb = {"nb_small": 3}.get(case, 9)
        if case == "g8":
            H, K = 16, 2
        if case == "nb_small":
            K = 1
        P = B * nb + 1
        bt = rng.permutation(P)[:B * nb].reshape(B, nb).astype(np.int32)
        bt[1::2, :nb // 2] = bt[0::2, :nb // 2][:len(bt[1::2])]
        position = rng.randint(0, nb * ps, B).astype(np.int32)
        if case == "holes":
            bt[0, 1] = -1
            bt[2, -3:] = -1
            position[2] = nb * ps - 1
            bt[4, :3] = -1                       # only holes up to it
            position[4] = 2 * ps + 1
        if case == "early":
            position[:] = rng.randint(0, 2 * ps, B)
    q = rng.randn(B, H, D).astype(np.float32)
    kp = rng.randn(P, ps, K, D).astype(np.float32)
    vp = rng.randn(P, ps, K, D).astype(np.float32)
    tq, tk, tv, tbt, tpos = (torch.from_numpy(a) for a in
                             (q, kp, vp, bt, position))
    pl = tpa.plan(B, K, bt.shape[1])
    if splits is not None:
        pl = pl._replace(splits=splits, span=-(-bt.shape[1] // splits))
    if case == "nb_small":
        assert tpa.TARGET_BLOCKS // (pl.tiles * K) > bt.shape[1] == pl.splits
    if case == "early":           # most rows walk 2 pages of 9
        ends = tpa.walk_ends(tbt, tpos, ps)
        assert (ends <= 2).sum() > B // 2 and pl.splits > 2
    got = _paged_split_combine(tq, tk, tv, tbt, tpos, pl)
    want = ref.paged_attention_ref(tq, tk, tv, tbt, tpos)
    torch.testing.assert_close(got, want, atol=5e-5, rtol=0)
    pallas = jax_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                       jnp.asarray(bt), jnp.asarray(position),
                       interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=5e-5)
    idle = np.flatnonzero(tpa.walk_ends(tbt, tpos, ps).numpy() ==
                          bt.shape[1])
    for b in idle:                      # no valid slot: the uniform mean
        if position[b] < 0 or (bt[b, :position[b] // ps + 1] < 0).all():
            mean = vp[np.maximum(bt[b], 0)].reshape(-1, K, D).mean(0)
            np.testing.assert_allclose(
                got[b].numpy(), np.repeat(mean, H // K, 0), atol=5e-5)
    if case == "idle":
        assert 3 in idle


@pytest.mark.parametrize("rows,D,dt,sdt,want", [
    # (route, vec, per_lane, warps, blocks, streaming)
    (4096, 3072, "bf16", "bf16", ("vector", 8, 12, 8, 512, True)),
    (8, 3072, "bf16", "bf16", ("vector", 8, 12, 8, 1, False)),
    (4032, 3072, "bf16", "bf16", ("vector", 8, 12, 8, 504, True)),
    (64, 3072, "bf16", "bf16", ("vector", 8, 12, 8, 8, False)),
    (16384, 1024, "bf16", "bf16", ("vector", 8, 4, 8, 2048, True)),
    (16384, 2048, "bf16", "bf16", ("vector", 8, 8, 8, 2048, True)),
    (8, 2048, "bf16", "bf16", ("vector", 8, 8, 8, 1, False)),
    (3, 100, "f32", "f32", ("vector", 4, 1, 3, 1, False)),
    (7, 384, "bf16", "f32", ("scalar", 1, 0, 7, 1, False)),
    (13, 3072, "bf16", "bf16", ("vector", 8, 12, 8, 2, False)),
    (5, 100, "bf16", "bf16", ("scalar", 1, 0, 5, 1, False)),
    (2, 8192, "bf16", "bf16", ("scalar", 1, 0, 2, 1, False)),
    (2048, 512, "f32", "f32", ("vector", 4, 4, 8, 256, True)),
])
def test_rmsnorm_plan(rows, D, dt, sdt, want):
    """B1's plan reads only the shapes and dtypes: one warp a row, up to 8
    rows a block (8 decode rows make one block), 16-byte vectors where x
    and the scale share a dtype and a row is whole vectors that fit in 16
    a lane, the streaming variant from 1024 rows on."""
    pl = trn.plan(rows, D, DT[dt][1], DT[sdt][1])
    assert tuple(pl) == want
    assert pl.blocks * pl.warps >= rows > (pl.blocks - 1) * pl.warps
    if pl.route == "vector":
        assert D % pl.vec == 0 and pl.vec * DT[dt][1].itemsize == 16
        assert 32 * pl.per_lane * pl.vec >= D
    # a pointer that is not 16-byte aligned takes the scalar route
    assert trn.plan(rows, D, DT[dt][1], DT[sdt][1],
                    aligned=False).route == "scalar"


@pytest.mark.parametrize("dscale", [True, False])
@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("D", [100, 1024, 2048, 3072, 8192])
@pytest.mark.parametrize("rows", [1, 7, 4096, 4608, 4097])
def test_rmsnorm_bwd_plan_covers_each_row_once(rows, D, dt, dscale):
    """B1-bwd's launch from the shapes alone: the blocks take contiguous
    row ranges that differ by at most one row, each block's warps walk its
    rows in order, and every row is walked exactly once. Without dscale a
    warp takes at most one row (the forward's layout); with dscale there
    is at most one block an SM, each writing one partial row, and the
    shared-memory slab (a row of D fp32 a warp) fits a block."""
    tdt = DT[dt][1]
    pl = trn.bwd_plan(rows, D, tdt, tdt, True, dscale)
    fwd = trn.plan(rows, D, tdt, tdt)
    if fwd.route == "vector" and fwd.per_lane <= trn.BWD_PER_LANE:
        assert (pl.route, pl.per_lane) == ("vector", fwd.per_lane)
    else:
        assert (pl.route, pl.per_lane) == ("scalar", 0)
    seen = np.zeros(rows, np.int64)
    sizes = set()
    for b in range(pl.blocks):
        span = pl.block_rows(b)
        sizes.add(len(span))
        for w in range(pl.warps):
            walk = list(pl.warp_rows(b, w))
            assert all(span.start <= r < span.stop for r in walk)
            assert walk == sorted(walk)
            assert len(walk) <= 1 or dscale
            seen[walk] += 1
    assert (seen == 1).all()
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
    assert pl.block_rows(pl.blocks - 1).stop == rows
    if dscale:
        assert pl.blocks == min(trn.SMS, -(-rows // pl.warps))
        assert 4 * pl.warps * D <= trn.SMEM_BYTES
    else:
        assert pl.blocks == -(-rows // pl.warps)


def test_rmsnorm_bwd_plan_reads_shapes_only():
    """The backward plan is computed from meta tensors' shapes and dtypes
    without a tensor operation, and is cached."""
    from torch.overrides import TorchFunctionMode

    class NoTensors(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            raise AssertionError(f"plan ran {func}")

    x = torch.empty(8, 512, 2048, dtype=torch.bfloat16, device="meta")
    s = torch.empty(2048, dtype=torch.bfloat16, device="meta")
    args = (x.numel() // x.shape[-1], x.shape[-1], x.dtype, s.dtype, True,
            True)
    with NoTensors():
        pl = trn.bwd_plan.__wrapped__(*args)
    assert pl == trn.bwd_plan(*args)
    hits = trn.bwd_plan.cache_info().hits
    assert trn.bwd_plan(*args) is trn.bwd_plan(*args)
    assert trn.bwd_plan.cache_info().hits == hits + 2
    assert (pl.route, pl.per_lane, pl.warps, pl.blocks) == ("vector", 8, 8,
                                                            trn.SMS)


def _fused_dscale(pl, x, dy, eps):
    """dscale in the fused kernels' order, in fp32: each lane sums dy x r
    of its columns over its warp's rows in order, a block sums its warps
    in order, and the sum kernel sums parts [j k, (j + 1) k) in order
    (k = ceil(blocks / 32)), then the 32 chunks in order."""
    x32, dy32 = x.float(), dy.float()
    r = torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    contrib = dy32 * (x32 * r)
    parts = []
    for b in range(pl.blocks):
        part = torch.zeros(x.shape[-1])
        for w in range(pl.warps):
            acc = torch.zeros(x.shape[-1])
            for row in pl.warp_rows(b, w):
                acc = acc + contrib[row]
            part = part + acc
        parts.append(part)
    k = -(-pl.blocks // 32)
    total = torch.zeros(x.shape[-1])
    for j in range(32):
        chunk = torch.zeros(x.shape[-1])
        for b in range(j * k, min(pl.blocks, (j + 1) * k)):
            chunk = chunk + parts[b]
        total = total + chunk
    return total


@pytest.mark.parametrize("rows,D", [(4096, 2048), (4096, 1024),
                                    (4097, 2048)])
def test_rmsnorm_bwd_fused_order_matches_plain(rows, D):
    """The fused backward's dscale summation order, on the plan's own
    partition of the separate PPO path's rows (opt_1_3b's and opt_350m's
    widths, and a row count that does not split evenly), gives the plain
    version's fp32 dscale within 1e-5 of its largest element."""
    rng = np.random.RandomState(D)
    x = torch.from_numpy(rng.randn(rows, D).astype(np.float32)).bfloat16()
    dy = torch.from_numpy(rng.randn(rows, D).astype(np.float32)).bfloat16()
    s = torch.from_numpy(1 + 0.1 * rng.randn(D).astype(np.float32))
    pl = trn.bwd_plan(rows, D, torch.bfloat16, torch.bfloat16, True, True)
    got = _fused_dscale(pl, x, dy, 1e-5)
    _, want = ref.rmsnorm_bwd_ref(x, s, dy, 1e-5)      # fp32 scale: fp32 sum
    assert want.dtype == torch.float32
    err = (got - want).abs().max().item() / want.abs().max().item()
    assert err <= 1e-5, err


@pytest.mark.parametrize("P,N,chunk,dt,want", [
    (64, 128, 256, "bf16", "wgmma"),     # mamba2_370m's prefill
    (64, 64, 64, "bf16", "wgmma"),
    (64, 64, 128, "bf16", "wgmma"),
    (64, 128, 512, "bf16", "wgmma"),
    (64, 128, 1024, "bf16", "simt"),     # a_cum would not fit the kernel
    (64, 128, 96, "bf16", "simt"),       # not whole 64-row tiles
    (64, 128, 256, "f32", "simt"),       # fp32 stays on the CUDA cores
    (32, 16, 32, "bf16", "simt"),        # the smoke config's widths
    (64, 32, 64, "bf16", "simt"),
    (16, 8, 16, "f32", "simt"),
])
def test_ssd_route(P, N, chunk, dt, want):
    """B5's route reads only the widths, the chunk and the dtype."""
    assert tssd.route(P, N, chunk, DT[dt][1]) == want


def test_ssd_bc_row_stride():
    """b and c are read as rows of one [B,S,ld] layout: contiguous, or
    column slices of one wider tensor (the Mamba2 block's xbc); any other
    layout raises."""
    xbc = torch.zeros(2, 8, 64 + 2 * 16)
    b, c = xbc[..., 64:80], xbc[..., 80:]
    assert tssd.bc_row_stride(b, c) == 96
    assert tssd.bc_row_stride(b.contiguous(), c.contiguous()) == 16
    with pytest.raises(ValueError, match="one"):
        tssd.bc_row_stride(b, c.contiguous())
    with pytest.raises(ValueError, match="one"):
        tssd.bc_row_stride(b.transpose(0, 1), c.transpose(0, 1))
    with pytest.raises(ValueError, match="one"):
        tssd.bc_row_stride(xbc[..., 64:96:2], xbc[..., 65:96:2])


@pytest.mark.parametrize("dt,D,want", [
    ("bf16", 128, "wgmma"), ("bf16", 64, "wgmma"),   # tensor cores
    ("f32", 128, "simt"), ("f32", 64, "simt"),       # fp32 products
])
def test_flash_bwd_route(dt, D, want):
    """B2-bwd's route reads only the dtype (and takes D 64 or 128)."""
    assert tfab.route(DT[dt][1], D) == want
    with pytest.raises(ValueError, match="head_dim"):
        tfab.route(DT[dt][1], 96)


def _bwd_walks(pl, vis, B, H, K):
    """How often the plan's dK/dV and dQ blocks walk each (batch, query
    head, query, key) [B, H, Sq, Sk], and the tiles each kernel walks with
    no pair visible in ``vis`` [Sq, Sk], all heads; checks that each key
    (q) tile of each KV (query) head has one block."""
    t, G = pl.tile, H // K
    Sq, Sk = vis.shape
    walks = {}
    for name, blocks, heads, n in (("dkdv", pl.dkdv, K, -(-Sk // t)),
                                   ("dq", pl.dq, H, -(-Sq // t))):
        assert sorted(blk[:3] for blk in blocks) == sorted(
            (i, h, b) for b in range(B) for h in range(heads)
            for i in range(n))
        count = np.zeros((B, H, Sq, Sk), np.int64)
        empty = 0
        for tile, head, b, lo, hi in blocks:
            for other in range(lo, hi):
                qt, kt = (other, tile) if name == "dkdv" else (tile, other)
                rows = slice(qt * t, (qt + 1) * t)
                cols = slice(kt * t, (kt + 1) * t)
                for h in (range(head * G, head * G + G) if name == "dkdv"
                          else (head,)):
                    count[b, h, rows, cols] += 1
                    empty += not vis[rows, cols].any()
        walks[name] = (count, empty)
    return walks


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 2), st.integers(1, 200), st.integers(1, 200),
       st.sampled_from([1, 3, 8]), st.integers(1, 2), st.booleans(),
       st.integers(0, 130), st.sampled_from([64, 128]))
def test_flash_bwd_plan_walks_each_visible_pair_once(B, Sq, Sk, G, K, causal,
                                                     window, D):
    """B2-bwd's launch plan, from the shapes alone: across the dK/dV
    blocks and again across the dQ blocks, each visible (query, key) pair
    of each query head is walked exactly once; the tiles walked with no
    visible pair are counted; the pair count is the one ``chip_smoke``
    bounds the kernel by; blocks go longest walk first."""
    import chip_smoke
    window = window if causal else 0
    H = G * K
    pl = tfab.plan(B, Sq, Sk, H, K, D, causal, window)
    vis = ref._mask(Sq, Sk, causal, window, 0, "cpu").numpy()
    walks = _bwd_walks(pl, vis, B, H, K)
    for name, (count, _) in walks.items():
        assert (count[:, :, vis] == 1).all(), name
    assert pl.empty_tiles == walks["dkdv"][1] + walks["dq"][1]
    assert pl.pairs == B * H * int(vis.sum()) == B * H * \
        chip_smoke.causal_pairs(Sq, Sk, causal, window)
    for blocks in (pl.dkdv, pl.dq):
        lengths = [hi - lo for _, _, _, lo, hi in blocks]
        assert lengths == sorted(lengths, reverse=True)
    table = pl.table()
    assert table.dtype == torch.int32 and table.shape == (
        len(pl.dkdv) + len(pl.dq), 4)
    b0 = pl.dq[0]
    assert table[len(pl.dkdv)].tolist() == [b0[0], b0[2] * H + b0[1],
                                            b0[3], b0[4]]


def test_flash_bwd_plan_at_the_path_shape_reads_shapes_only():
    """At the PPO training shape (q [8,576,24,128], k/v [8,576,8,128],
    causal) the plan walks no tile without a visible pair, launches the
    key tiles with the most q tiles first, and is computed without a
    tensor operation."""
    import chip_smoke
    from torch.overrides import TorchFunctionMode

    class NoTensors(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            raise AssertionError(f"plan ran {func}")

    args = (8, 576, 576, 24, 8, 128, True, 0)
    with NoTensors():
        pl = tfab.plan.__wrapped__(*args)
    assert pl == tfab.plan(*args)
    assert pl.empty_tiles == 0 and pl.tile == tfab.TILE == 64
    assert pl.pairs == 8 * 24 * chip_smoke.causal_pairs(576, 576, True, 0)
    assert len(pl.dkdv) == 9 * 8 * 8 and len(pl.dq) == 9 * 24 * 8
    assert pl.dkdv[0] == (0, 0, 0, 0, 9) and pl.dkdv[-1][3:] == (8, 9)
    assert pl.dq[0] == (8, 0, 0, 0, 9) and pl.dq[-1][3:] == (0, 1)
