"""The port's Mamba2 path against the JAX reference on the CPU: the SSD
scan's plain versions (B5's), the Mamba block, the Model on a pure-Mamba
config, the dense rollout and the serving entry point.

Inputs are made with numpy from a seed and go through both packages; the
JAX side runs as its own tests run it (the Pallas kernel in interpret
mode). Tolerances: 1e-4 for the f32 scans (the reference's own,
``tests/test_kernels.py:116-117``), 1e-3 against the Pallas kernel and
5e-2 in bf16 (``test_kernels.py:98``); 2e-4 for the block
(``tests/test_kernel_model_paths.py:65``); 1e-5 for a whole model's
logits.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import mamba as JM  # noqa: E402
from repro.rlhf import Rollout as JaxRollout  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import mamba as TM  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.rlhf import Rollout  # noqa: E402

DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _ssd_inputs(B, S, H, P, N, decay, dt, seed):
    """x, a, b, c as JAX arrays and torch tensors holding the same values
    (a in x's dtype, as the reference's kernel test passes it)."""
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(B, S, H, P) * 0.5,
            -np.abs(rng.randn(B, S, H)) * decay,
            rng.randn(B, S, N) * 0.5,
            rng.randn(B, S, N) * 0.5]
    jdt, tdt = DT[dt]
    js = [jnp.asarray(a.astype(np.float32)).astype(jdt) for a in arrs]
    ts = [torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)
          for j in js]
    return js, ts


SSD_CASES = [  # (B, S, H, P, N, chunk, decay, dtype)
    (2, 128, 4, 32, 16, 32, 0.3, "f32"),
    (1, 256, 8, 64, 128, 128, 0.3, "f32"),
    (2, 64, 2, 16, 8, 16, 0.3, "f32"),
    (1, 128, 4, 64, 64, 64, 0.3, "bf16"),
    (2, 64, 3, 32, 16, 64, 0.3, "f32"),       # S == chunk: one chunk
    (1, 256, 2, 32, 16, 256, 4.0, "f32"),     # exp(a_cum) underflows to 0
]


@pytest.mark.parametrize("B,S,H,P,N,chunk,decay,dt", SSD_CASES)
def test_ssd_plain_versions_match_reference(B, S, H, P, N, chunk, decay, dt):
    """ssd_scan_ref against the reference model's ssd_chunked (the same
    casts), ssd_sequential_ref against the reference's sequential oracle
    ssd_ref, and both against the Pallas kernel (interpret mode); y and
    the final state. The kernel keeps L and the states in fp32 where the
    chunked form rounds them to x's dtype, so in bf16 it is held against
    the sequential form and the chunked form on fp32 copies, as B5 is on
    the card."""
    (xj, aj, bj, cj), (xt, at, bt, ct) = _ssd_inputs(B, S, H, P, N, decay,
                                                     dt, S + N)
    tol = 5e-2 if dt == "bf16" else 1e-4
    ktol = 5e-2 if dt == "bf16" else 1e-3
    chunked_t = ref.ssd_scan_ref(xt, at, bt, ct, chunk)
    chunked32_t = ref.ssd_scan_ref(xt.float(), at.float(), bt.float(),
                                   ct.float(), chunk)
    seq_t = ref.ssd_sequential_ref(xt, at, bt, ct)
    kernel_j = jax_ssd_scan(xj, aj, bj, cj, chunk=chunk)
    for got, want, atol in (
            (chunked_t, JM.ssd_chunked(xj, aj, bj, cj, chunk), tol),
            (seq_t, JR.ssd_ref(xj, aj, bj, cj), tol),
            (seq_t, kernel_j, ktol),
            (chunked32_t, kernel_j, ktol)):
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(_np(g), _np(w), atol=atol)
    for g in chunked_t + seq_t:
        assert g.dtype == xt.dtype
    if dt == "f32":   # the chunked form against the step-by-step oracle
        for g, w in zip(chunked_t, seq_t):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4)


def test_ops_ssd_scan_takes_plain_version_on_cpu():
    _, (x, a, b, c) = _ssd_inputs(1, 64, 2, 16, 8, 0.3, "f32", 0)
    ops.reset_launches()
    y, fin = ops.ssd_scan(x, a, b, c, 32)
    want = ref.ssd_scan_ref(x, a, b, c, 32)
    torch.testing.assert_close(y, want[0])
    torch.testing.assert_close(fin, want[1])
    # a non-zero initial state continues a scan: two halves == the whole
    y1, s1 = ops.ssd_scan(x[:, :32], a[:, :32], b[:, :32], c[:, :32], 32)
    y2, s2 = ops.ssd_scan(x[:, 32:], a[:, 32:], b[:, 32:], c[:, 32:], 32,
                          initial_state=s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, atol=1e-5, rtol=0)
    torch.testing.assert_close(s2, fin, atol=1e-5, rtol=0)
    assert ops.launches["ssd_scan"] == 0
    with pytest.raises(ValueError, match="multiple of chunk"):
        ops.ssd_scan(x, a, b, c, 48)


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _b5_tensor_core_emulation(x, a, b, c, chunk):
    """B5's tensor-core route (``csrc/ssd_scan.cu``, wg) in plain PyTorch,
    with its rounding points: S = C B^T in fp32 (products of bf16 values),
    (S o L) rounded to bf16 before its product with x, y_off from a bf16
    operand copy of the fp32 state, x o exp(a_last - a_cum) rounded to bf16
    before the state update, the carried state in fp32; y and the final
    state rounded to bf16. x, b, c hold bf16 values (as fp32); a is fp32."""
    B, S, H, P = x.shape
    state = torch.zeros(B, H, P, b.shape[-1])
    ys = []
    for c0 in range(0, S, chunk):
        xc = x[:, c0:c0 + chunk].permute(0, 2, 1, 3)              # [B,H,l,P]
        ac = torch.cumsum(a[:, c0:c0 + chunk], 1).permute(0, 2, 1)  # [B,H,l]
        bc, cc = b[:, c0:c0 + chunk], c[:, c0:c0 + chunk]
        s = torch.einsum("bin,bjn->bij", cc, bc)[:, None]         # fp32 S
        keep = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
        L = torch.where(keep, torch.exp(ac[..., :, None] - ac[..., None, :]),
                        torch.zeros(()))
        y_off = torch.exp(ac)[..., None] * torch.einsum(
            "bin,bhpn->bhip", cc, _bf16(state))
        ys.append((_bf16(s * L) @ xc + y_off).permute(0, 2, 1, 3))
        xd = _bf16(xc * torch.exp(ac[..., -1:] - ac)[..., None])
        state = torch.exp(ac[..., -1])[..., None, None] * state + \
            torch.einsum("bhjp,bjn->bhpn", xd, bc)
    return _bf16(torch.cat(ys, 1)), _bf16(state)


@pytest.mark.parametrize("S,N,chunk,decay", [
    (256, 128, 64, 0.3),        # 4 chunks of one 64-row tile
    (256, 128, 64, 4.0),        # exp(a_cum) underflows within a chunk
    (512, 64, 128, 0.3),        # N 64, 4 chunks of two tiles
    (512, 64, 128, 4.0),
    (1024, 128, 256, 0.3),      # the Mamba2 path's chunk, 4 chunks
    (1024, 128, 256, 4.0),
])
def test_b5_tensor_core_rounding_matches_pallas(S, N, chunk, decay):
    """The numerical design of B5's bf16 route holds before any card run:
    its emulation against the Pallas kernel (interpret mode, fp32 inside)
    at 5e-2, the tolerance of ``tests/test_kernels.py:98``. b and c are
    scaled by N^-1/4, so a score C B^T has unit variance and |y| stays
    below 8, where a bf16 output's own rounding (half an ulp) stays below
    1/64; at |y| of 8-16 two bf16 results one fp32 ulp apart already
    differ by 0.0625, whatever the kernel."""
    B, H, P = 1, 2, 64
    rng = np.random.RandomState(S + N + int(decay))
    arrs = [rng.randn(B, S, H, P) * 0.5, -np.abs(rng.randn(B, S, H)) * decay,
            rng.randn(B, S, N) * N ** -0.25, rng.randn(B, S, N) * N ** -0.25]
    js = [jnp.asarray(v.astype(np.float32)) for v in arrs]
    js = [js[0].astype(jnp.bfloat16), js[1], js[2].astype(jnp.bfloat16),
          js[3].astype(jnp.bfloat16)]
    ts = [torch.from_numpy(np.array(j.astype(jnp.float32))) for j in js]
    want = jax_ssd_scan(*js, chunk=chunk)
    got = _b5_tensor_core_emulation(*ts, chunk)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), _np(w), atol=5e-2)


def test_ssd_plain_version_reads_strided_b_c():
    """b and c as column slices of one xbc-like tensor (the Mamba2 block's
    layout, which B5 reads in place): the CPU path gives the answers it
    gives on contiguous copies."""
    rng = np.random.RandomState(7)
    B, S, H, P, N = 2, 64, 3, 16, 8
    x = torch.from_numpy(rng.randn(B, S, H, P).astype(np.float32))
    a = -torch.from_numpy(np.abs(rng.randn(B, S, H)).astype(np.float32))
    xbc = torch.from_numpy(rng.randn(B, S, H * P + 2 * N).astype(np.float32))
    b, c = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    assert not b.is_contiguous() and not c.is_contiguous()
    want = ref.ssd_scan_ref(x, a, b.contiguous(), c.contiguous(), 32)
    for got in (ref.ssd_scan_ref(x, a, b, c, 32), ops.ssd_scan(x, a, b, c, 32)):
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# The Mamba block
# ---------------------------------------------------------------------------
def _block(seed=0):
    jcfg = jax_get_config("mamba2_370m").smoke()
    tcfg = get_config("mamba2_370m").smoke()
    jp = JM.init_mamba(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


def test_causal_conv_matches_reference():
    _, _, jp, tp = _block()
    rng = np.random.RandomState(1)
    xbc = rng.randn(2, 12, jp["conv_w"].shape[1]).astype(np.float32)
    pre = rng.randn(2, 3, jp["conv_w"].shape[1]).astype(np.float32)
    for prepend in (None, pre):
        yj, tj = JM._causal_conv(
            jnp.asarray(xbc), jp["conv_w"], jp["conv_b"] + 0.1,
            None if prepend is None else jnp.asarray(prepend))
        yt, tt = TM._causal_conv(
            torch.from_numpy(xbc), tp["conv_w"], tp["conv_b"] + 0.1,
            None if prepend is None else torch.from_numpy(prepend))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-6)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))


def test_mamba_fwd_and_decode_match_reference():
    """mamba_fwd(return_state=True) over 64 tokens (two chunks of 32), then
    4 chained mamba_decode steps from its states; the port's states are
    updated in place."""
    jcfg, tcfg, jp, tp = _block()
    rng = np.random.RandomState(2)
    x = (rng.randn(2, 64, jcfg.d_model) * 0.3).astype(np.float32)
    yj, cj = JM.mamba_fwd(jp, jnp.asarray(x), jcfg, return_state=True)
    yt, ct = TM.mamba_fwd(tp, torch.from_numpy(x), tcfg, return_state=True)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=2e-4)
    for name in ("conv_state", "ssm_state"):
        assert tuple(ct[name].shape) == cj[name].shape
        np.testing.assert_allclose(ct[name].numpy(), np.asarray(cj[name]),
                                   atol=2e-4)
    state = ct["ssm_state"]
    for t in range(4):
        xt = (rng.randn(2, 1, jcfg.d_model) * 0.3).astype(np.float32)
        yj, cj = JM.mamba_decode(jp, jnp.asarray(xt), cj, jcfg)
        yt, ct = TM.mamba_decode(tp, torch.from_numpy(xt), ct, tcfg)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=2e-4)
        for name in ("conv_state", "ssm_state"):
            np.testing.assert_allclose(ct[name].numpy(), np.asarray(cj[name]),
                                       atol=2e-4)
    assert ct["ssm_state"] is state     # written in place


# ---------------------------------------------------------------------------
# The Model on mamba2_370m's smoke config
# ---------------------------------------------------------------------------
def _models(seed=0, param_dtype="float32"):
    jcfg = dataclasses.replace(jax_get_config("mamba2_370m").smoke(),
                               param_dtype=param_dtype)
    tcfg = dataclasses.replace(get_config("mamba2_370m").smoke(),
                               param_dtype=param_dtype)
    jm = JaxModel(jcfg)
    jparams = jm.init(jax.random.PRNGKey(seed))
    tm = Model(tcfg, device="cpu")
    tparams = bridge.from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, tcfg, jm, jparams, tm, tparams


def test_model_prefill_and_decode_match_reference():
    """Prefill logits and caches, then 8 decode steps' logits, within 1e-5
    of the reference Model with the same weights; greedy tokens fed to
    both."""
    jcfg, tcfg, jm, jparams, tm, tparams = _models()
    assert all("ffn" not in layer and "norm2" not in layer
               for layer in tparams["layers"])
    B, P = 2, 64
    prompt = np.random.RandomState(3).randint(0, tcfg.vocab_size, (B, P))
    lj, cj = jm.prefill(jparams, {"tokens": jnp.asarray(prompt, jnp.int32)},
                        P + 8)
    ops.reset_launches()
    lt, ct = tm.prefill(tparams, {"tokens": torch.from_numpy(prompt)}, P + 8)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5)
    want = bridge.caches_from_jax(jax.tree.map(np.asarray, cj), tcfg,
                                  device="cpu")
    assert len(ct["layers"]) == len(want) == tcfg.num_layers
    for got_c, want_c in zip(ct["layers"], want):
        assert set(got_c) == {"conv_state", "ssm_state"}
        for name in got_c:
            np.testing.assert_allclose(got_c[name].numpy(),
                                       want_c[name].numpy(), atol=1e-5)
    tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    for t in range(8):
        pos = np.full((B,), P + t, np.int32)
        lj, cj = jm.decode_step(jparams, cj, jnp.asarray(tok),
                                jnp.asarray(pos))
        lt, ct = tm.decode_step(tparams, ct, torch.from_numpy(tok).long(),
                                torch.from_numpy(pos))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5)
        tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    assert all(v == 0 for v in ops.launches.values())


def test_model_forward_last_position_matches_prefill():
    _, tcfg, _, _, tm, tparams = _models()
    tokens = torch.from_numpy(
        np.random.RandomState(5).randint(0, tcfg.vocab_size, (2, 32)))
    logits, _, h = tm.forward(tparams, {"tokens": tokens})
    assert logits.shape == (2, 32, tcfg.vocab_size)
    assert h.shape == (2, 32, tcfg.d_model)
    last, _ = tm.prefill(tparams, {"tokens": tokens}, 40)
    np.testing.assert_allclose(logits[:, -1].numpy(), last.numpy(),
                               atol=1e-5)


def test_greedy_rollout_matches_reference():
    """The dense Rollout on a Mamba model: position ignored, capacity
    sizes nothing, the states dropped at the end; tokens identical to the
    reference's, logp within 1e-5."""
    jcfg, tcfg, jm, jparams, tm, tparams = _models(1)
    prompts = np.random.RandomState(6).randint(0, 512, (2, 32)).astype(
        np.int32)
    jro = JaxRollout(jm, jcfg, capacity=48, temperature=0.0)
    tro = Rollout(tm, tcfg, capacity=48, temperature=0.0)
    want = jro.generate(jparams, {"tokens": jnp.asarray(prompts)}, 12,
                        jax.random.PRNGKey(0))
    got = tro.generate(tparams, {"tokens": torch.from_numpy(prompts).long()},
                       12, torch.Generator())
    assert got.tokens.shape == (2, 44)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.logp.numpy(), np.asarray(want.logp),
                               atol=1e-5)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))


def test_mamba_model_refuses_lengths_and_paged():
    _, tcfg, _, _, tm, tparams = _models()
    tokens = torch.zeros((2, 32), dtype=torch.long)
    with pytest.raises(ValueError, match="Mamba"):
        tm.prefill(tparams, {"tokens": tokens}, 40,
                   lengths=torch.full((2,), 32))
    assert not tm.supports_paged()
    with pytest.raises(ValueError, match="attention-only"):
        Rollout(tm, tcfg, capacity=40, backend="paged")
    with pytest.raises(ValueError, match="attention-only"):
        tm.init_paged_pools(4, 16, torch.float32)


def test_bridge_round_trip_keeps_fp32_decay_params_in_bf16_model():
    jcfg, tcfg, _, jparams, tm, tparams = _models(param_dtype="bfloat16")
    mixer = tparams["layers"][0]["mixer"]
    for name in ("dt_bias", "A_log", "D"):
        assert mixer[name].dtype == torch.float32, name
    for name in ("in_proj", "conv_w", "conv_b", "norm", "out_proj"):
        assert mixer[name].dtype == torch.bfloat16, name
    jnp_params = jax.tree.map(np.asarray, jparams)
    back = bridge.to_jax(tparams, tcfg)
    flat_j = jax.tree_util.tree_leaves_with_path(jnp_params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_b)
    for path, leaf in flat_j:
        assert flat_b[path].dtype == leaf.dtype, path
        np.testing.assert_array_equal(flat_b[path].view(np.uint8),
                                      leaf.view(np.uint8))
    # the port's own init keeps the same dtypes
    own = tm.init(torch.Generator().manual_seed(0))["layers"][1]["mixer"]
    assert {k: v.dtype for k, v in own.items()} == \
        {k: v.dtype for k, v in mixer.items()}


def test_serve_run_mamba_on_cpu_smoke():
    cfg = get_config("mamba2_370m").smoke()
    reg = MetricsRegistry()
    lines = []
    ops.reset_launches()
    out = serve.run(cfg, batch=2, prompt_len=64, gen=6, requests=2,
                    device="cpu", reg=reg, log=lines.append)
    assert len(out) == 2
    for r in out:
        res = r["result"]
        assert res.tokens.shape == (2, 70) and res.prompt_len == 64
        assert int(res.tokens[:, 64:].max()) < cfg.vocab_size
        assert torch.isfinite(res.logp).all()
        assert (res.logp[:, 64:] <= 0).all() and (res.logp[:, :64] == 0).all()
        assert res.mask[:, 64:].eq(1).all()
    assert sum("request" in s for s in lines) == 2
    assert reg.counter("serve_tokens_total").value() == 2 * 2 * 6
    assert all(v == 0 for v in ops.launches.values())


def test_chip_smoke_bounds_the_scan_by_the_work_it_needs():
    """B5's bound in ``chip_smoke.py`` counts only the pairs j <= i of each
    chunk, and C B^T (which no head changes) once per (batch, chunk); at
    the Mamba2 prefill's shape that leaves the bytes as the bound."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    B, S, H, P, N, chunk = 2, 96, 3, 8, 4, 32
    want = 0
    for _b in range(B):
        for _c in range(S // chunk):
            for i in range(chunk):
                for _j in range(i + 1):
                    want += 2 * N + H * 2 * P        # C B^T; its product with x
            want += H * 2 * 2 * chunk * N * P        # y_off; the state update
    assert chip_smoke.ssd_ops(B, S, H, P, N, chunk) == want

    B, S, H, P, N, chunk = 8, 2048, 32, 64, 128, 256
    n_bytes = 2 * (2 * B * S * H * P + 2 * B * S * N + B * H * P * N) \
        + 4 * B * S * H
    ms, by = chip_smoke.bound((3.35e12, 989e12, 67e12), n_bytes,
                              chip_smoke.ssd_ops(B, S, H, P, N, chunk),
                              torch.bfloat16)
    assert by == "bytes" and ms == pytest.approx(n_bytes / 3.35e12 * 1e3)
