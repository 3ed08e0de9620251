"""The port's kernels on the CPU: plain versions against the JAX Pallas
kernels (interpret mode, as ``tests/test_kernels.py`` runs them), the
CPU/CUDA dispatch in ``kernels/ops.py`` and the build commands. The CUDA
kernels themselves are tested on a card by ``tests/test_torch_gpu.py``.

Tolerances are those of ``tests/test_kernels.py:15``: 5e-5 in f32,
2e-2 in bf16 (another order of summation, and bf16 output rounding).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.decode_attention import decode_attention as jax_decode  # noqa: E402
from repro.kernels.flash_attention import flash_attention_fwd as jax_flash  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as tdec  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import rmsnorm as trn  # noqa: E402

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
    assert ops.launches == {k: 0 for k in ops.KERNELS}


@pytest.mark.parametrize("call", ["rmsnorm", "flash", "decode"])
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
        else:
            tdec.decode_attention(x[:, 0], kv, kv, pos,
                                  torch.zeros(2, dtype=torch.int32,
                                              device="meta"))


def test_build_compiles_each_source_for_sm90a(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "nvcc", lambda: "nvcc")
    compiles, link = build.compile_commands(tmp_path)
    names = sorted(p.name for p in build.sources())
    assert names == ["decode_attention.cu", "flash_attention.cu",
                     "rmsnorm.cu"]
    assert len(compiles) == len(names)
    for cmd in compiles + [link]:
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert "-fPIC" in cmd and "-O3" in cmd and "-std=c++17" in cmd
    assert "-shared" in link and link[-1].endswith(build.LIB_NAME)
    assert len(build.source_hash()) == 16
