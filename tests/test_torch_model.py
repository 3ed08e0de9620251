"""The port's layers and Model against the JAX reference on the CPU.

Inputs are made with numpy from a seed and go through both packages; the
port runs its plain PyTorch path (CPU tensors). Tolerances: 1e-5 for the
layer functions, as ``tests/test_kernel_model_paths.py``; 1e-4 for a
whole model's logits (two layers of f32 matmuls summed in another order).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402


def _cfgs(**kw):
    kw = {"param_dtype": "float32", **kw}
    jcfg = dataclasses.replace(jax_get_config("llama3_2_3b").smoke(), **kw)
    tcfg = dataclasses.replace(get_config("llama3_2_3b").smoke(), **kw)
    return jcfg, tcfg


def _t(a):
    return torch.from_numpy(np.array(a))


def _attn_params(jcfg):
    jp = JL.init_attention(jax.random.PRNGKey(0), jcfg, jnp.float32)
    return jp, {k: _t(v) for k, v in jp.items()}


def _field(cfg, name):
    """A config field; the SSM sub-config (another class in each package)
    as its dict of fields."""
    v = getattr(cfg, name)
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


def test_smoke_config_matches_reference_widths():
    """llama3_2_3b and mamba2_370m, full size and smoke, field for field
    against the reference's configs (the SSM dims included)."""
    for arch in ("llama3_2_3b", "mamba2_370m"):
        for full in (False, True):
            jcfg, tcfg = jax_get_config(arch), get_config(arch)
            if not full:
                jcfg, tcfg = jcfg.smoke(), tcfg.smoke()
            for f in dataclasses.fields(tcfg):
                assert _field(tcfg, f.name) == _field(jcfg, f.name), \
                    (arch, f.name)
            assert tcfg.layer_kinds() == jcfg.layer_kinds()
    full = get_config("llama3_2_3b")
    assert (full.num_layers, full.d_model, full.num_heads,
            full.num_kv_heads, full.d_ff, full.vocab_size) == \
        (28, 3072, 24, 8, 8192, 128256)
    m = get_config("mamba2_370m")
    assert (m.num_layers, m.d_model, m.d_ff, m.vocab_size,
            m.ssm.d_inner(m.d_model), m.ssm.n_heads(m.d_model),
            m.ssm.head_dim, m.ssm.d_state, m.ssm.d_conv,
            m.ssm.chunk_size) == (48, 1024, 0, 50280, 2048, 32, 64, 128, 4,
                                  256)
    assert m.smoke().ssm.chunk_size == 32 and m.smoke().ssm.d_state == 16


@pytest.mark.parametrize("window", [0, 16])
def test_attention_fwd_matches_reference(window):
    jcfg, tcfg = _cfgs(num_kv_heads=2)
    jp, tp = _attn_params(jcfg)
    x = np.random.RandomState(1).randn(2, 40, jcfg.d_model).astype(np.float32) * 0.3
    pos = np.broadcast_to(np.arange(40), (2, 40)).astype(np.int32)
    cap = 32
    y_j, c_j = JL.attention_fwd(jp, jnp.asarray(x), jnp.asarray(pos), jcfg,
                                window=window,
                                init_cache=JL.init_kv_cache(jcfg, 2, cap,
                                                            jnp.float32))
    y_t, c_t = TL.attention_fwd(tp, _t(x), _t(pos), tcfg, window=window,
                                init_cache=TL.init_kv_cache(
                                    tcfg, 2, cap, torch.float32, "cpu"))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)
    for name in ("k", "v"):
        np.testing.assert_allclose(c_t[name].numpy(), np.asarray(c_j[name]),
                                   atol=1e-5)
    np.testing.assert_array_equal(c_t["pos"].numpy(), np.asarray(c_j["pos"]))


@pytest.mark.parametrize("cap,window,steps", [(32, 0, 6), (16, 16, 20)])
def test_attention_decode_matches_reference(cap, window, steps):
    """Rolling cache; (16, 16, 20) wraps the buffer under a window."""
    jcfg, tcfg = _cfgs(num_kv_heads=2)
    jp, tp = _attn_params(jcfg)
    B = 2
    jc = JL.init_kv_cache(jcfg, B, cap, jnp.float32)
    tc = TL.init_kv_cache(tcfg, B, cap, torch.float32, "cpu")
    rng = np.random.RandomState(2)
    for t in range(steps):
        x = rng.randn(B, 1, jcfg.d_model).astype(np.float32) * 0.3
        pos = np.full((B,), t, np.int32)
        y_j, jc = JL.attention_decode(jp, jnp.asarray(x), jnp.asarray(pos),
                                      jc, jcfg, window=window)
        y_t, tc = TL.attention_decode(tp, _t(x), _t(pos), tc, tcfg,
                                      window=window)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_sdpa_and_causal_mask_match_reference():
    rng = np.random.RandomState(3)
    q = rng.randn(2, 12, 4, 16).astype(np.float32)
    k = rng.randn(2, 12, 2, 16).astype(np.float32)
    v = rng.randn(2, 12, 2, 16).astype(np.float32)
    mj = JL.causal_mask(12, 12, window=5)
    mt = TL.causal_mask(12, 12, window=5)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    mj = jnp.broadcast_to(mj, (2, 1, 12, 12))
    oj = JL.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mj)
    ot = TL.sdpa(_t(q), _t(k), _t(v), mt.expand(2, 1, 12, 12))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip(dtype):
    jcfg, tcfg = _cfgs(num_kv_heads=2, param_dtype=dtype)
    jparams = jax.tree.map(np.asarray, JaxModel(jcfg).init(
        jax.random.PRNGKey(0)))
    tparams = bridge.from_jax(jparams, tcfg, device="cpu")
    assert len(tparams["layers"]) == tcfg.num_layers
    assert tparams["layers"][1]["mixer"]["wk"].shape == \
        (tcfg.d_model, 2 * tcfg.resolved_head_dim())
    assert tparams["embed"].dtype == {"float32": torch.float32,
                                      "bfloat16": torch.bfloat16}[dtype]
    back = bridge.to_jax(tparams, tcfg)
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_b)
    for path, leaf in flat_j:
        assert flat_b[path].dtype == leaf.dtype
        np.testing.assert_array_equal(flat_b[path].view(np.uint8),
                                      leaf.view(np.uint8))


def test_model_prefill_and_greedy_decode_match_reference():
    """GQA (num_kv_heads=2, so G = 2): prefill logits and 16 greedy decode
    steps, logits within 1e-4 and tokens identical."""
    jcfg, tcfg = _cfgs(num_kv_heads=2)
    jm = JaxModel(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = Model(tcfg, device="cpu")
    tparams = bridge.from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    B, P, cap, n = 2, 12, 32, 16
    prompt = np.random.RandomState(4).randint(0, tcfg.vocab_size, (B, P))
    lj, cj = jm.prefill(jparams, {"tokens": jnp.asarray(prompt, jnp.int32)},
                        cap)
    lt, ct = tm.prefill(tparams, {"tokens": torch.from_numpy(prompt)}, cap)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
    tok_j = jnp.argmax(lj, -1).astype(jnp.int32)
    tok_t = torch.argmax(lt, -1)
    ops.reset_launches()
    for t in range(n):
        np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
        pos = np.full((B,), P + t, np.int32)
        lj, cj = jm.decode_step(jparams, cj, tok_j, jnp.asarray(pos))
        lt, ct = tm.decode_step(tparams, ct, tok_t, torch.from_numpy(pos))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
        tok_j = jnp.argmax(lj, -1).astype(jnp.int32)
        tok_t = torch.argmax(lt, -1)
    # on the CPU every call took the plain version: no kernel launched
    assert all(v == 0 for v in ops.launches.values())


def test_model_forward_last_position_matches_prefill():
    _, tcfg = _cfgs(num_kv_heads=2)
    tm = Model(tcfg, device="cpu")
    params = tm.init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(
        np.random.RandomState(5).randint(0, tcfg.vocab_size, (2, 10)))
    logits, _, h = tm.forward(params, {"tokens": tokens})
    assert logits.shape == (2, 10, tcfg.vocab_size)
    assert h.shape == (2, 10, tcfg.d_model)
    last, _ = tm.prefill(params, {"tokens": tokens}, 16)
    np.testing.assert_allclose(logits[:, -1].numpy(), last.numpy(), atol=1e-5)
