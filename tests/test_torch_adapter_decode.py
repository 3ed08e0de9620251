"""``adapter=`` on the port's seven cache paths (``Model.prefill``,
``decode_step``, ``paged_prefill``, ``paged_decode_step``,
``paged_prefill_suffix``, ``decode_multi``, ``paged_decode_multi``): LoRA
applied unmerged, held against the JAX reference on the CPU.

Twins of ``tests/test_hydra.py:95-133`` (an unmerged adapter's greedy
decode equals the adapter forward's argmax; the paged adapter decode
equals the dense one within 2e-5), each also against the reference's
tokens and logits; every path with a random adapter against the
reference's same path; and ``adapter=None`` bit for bit the call without
the argument, as is an adapter whose B factors are zero. The config is
``tests/test_hydra.py``'s small llama (2 layers, d_model 64, head_dim 16)
in f32, with the reference's weights and adapter carried across by
``bridge``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402

SMALL = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=64, num_heads=4,
             num_kv_heads=2, head_dim=16, param_dtype="float32")
TOL = 1e-5
PAGED_TOL = 2e-5           # tests/test_hydra.py:133
B, P, PS = 2, 12, 4
NB = -(-(P + 4) // PS)


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x).copy(), tree)


def _zero_b(tree):
    """The adapter with every B factor zeroed (a delta of exactly 0)."""
    if isinstance(tree, dict):
        return {k: (torch.zeros_like(v) if k == "b" else _zero_b(v))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zero_b(v) for v in tree]
    return tree


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small CPU ops: the suite runs
    several test processes at once, and each op's thread pool would
    otherwise contend with theirs (the step loops here are many tiny
    ops). Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_get_config("llama3_2_3b").smoke(), **SMALL)
    cfg = dataclasses.replace(get_config("llama3_2_3b").smoke(), **SMALL)
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    ad = jm.init_adapter(jax.random.PRNGKey(1), jp, 4)
    leaves, treedef = jax.tree.flatten(ad)
    ks = jax.random.split(jax.random.PRNGKey(1), len(leaves))
    jad = jax.tree.unflatten(treedef, [
        0.05 * jax.random.normal(k, x.shape, x.dtype)
        for k, x in zip(ks, leaves)])
    model = Model(cfg, device="cpu")
    params = bridge.from_jax(_np(jp), cfg, "cpu")
    adapter = bridge.adapter_from_jax(_np(jad), cfg, "cpu")
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (B, P), 0,
                                           cfg.vocab_size))
    return jm, jp, jad, model, params, adapter, tokens


def _port_path(model, params, tokens, path, **ad):
    """Run one cache path of the port -> its logits (numpy)."""
    t = torch.from_numpy(tokens.astype(np.int64))
    bt = torch.arange(B * NB, dtype=torch.int32).reshape(B, NB)
    lens = torch.full((B,), P, dtype=torch.int32)
    nxt = t[:, -1]
    if path == "prefill":
        return model.prefill(params, {"tokens": t}, P + 4, **ad)[0].numpy()
    if path in ("decode_step", "decode_multi"):
        _, caches = model.prefill(params, {"tokens": t}, P + 4, **ad)
        if path == "decode_step":
            pos = torch.full((B,), P, dtype=torch.int32)
            return model.decode_step(params, caches, nxt, pos,
                                     **ad)[0].numpy()
        seq = torch.stack([nxt, t[:, 0], t[:, 1]], 1)
        pos = P + torch.arange(3, dtype=torch.int32)[None].expand(B, 3)
        return model.decode_multi(params, caches, seq, pos, **ad)[0].numpy()
    pools = model.init_paged_pools(B * NB, PS, torch.float32)
    if path == "paged_prefill_suffix":
        return model.paged_prefill_suffix(
            params, {"tokens": t}, pools, bt,
            torch.zeros((B,), dtype=torch.int32), lens, **ad)[0].numpy()
    lg, pools = model.paged_prefill(params, {"tokens": t}, pools, bt, lens,
                                    **ad)
    if path == "paged_prefill":
        return lg.numpy()
    if path == "paged_decode_step":
        pos = torch.full((B,), P, dtype=torch.int32)
        return model.paged_decode_step(params, pools, nxt, pos, bt,
                                       **ad)[0].numpy()
    seq = torch.stack([nxt, t[:, 0], t[:, 1]], 1)
    pos = P + torch.arange(3, dtype=torch.int32)[None].expand(B, 3)
    return model.paged_decode_multi(params, pools, seq, pos, bt,
                                    **ad)[0].numpy()


def _jax_path(jm, jp, tokens, path, adapter):
    t = jnp.asarray(tokens, jnp.int32)
    bt = jnp.arange(B * NB, dtype=jnp.int32).reshape(B, NB)
    lens = jnp.full((B,), P, jnp.int32)
    nxt = t[:, -1]
    seq = jnp.stack([nxt, t[:, 0], t[:, 1]], 1)
    pos3 = P + jnp.broadcast_to(jnp.arange(3, dtype=jnp.int32)[None], (B, 3))
    pos1 = jnp.full((B,), P, jnp.int32)
    if path == "prefill":
        return jm.prefill(jp, {"tokens": t}, P + 4, adapter=adapter)[0]
    if path in ("decode_step", "decode_multi"):
        _, caches = jm.prefill(jp, {"tokens": t}, P + 4, adapter=adapter)
        if path == "decode_step":
            return jm.decode_step(jp, caches, nxt, pos1, adapter=adapter)[0]
        return jm.decode_multi(jp, caches, seq, pos3, adapter=adapter)[0]
    pools = jm.init_paged_pools(B * NB, PS, jnp.float32)
    if path == "paged_prefill_suffix":
        return jm.paged_prefill_suffix(jp, {"tokens": t}, pools, bt,
                                       jnp.zeros((B,), jnp.int32), lens,
                                       adapter=adapter)[0]
    lg, pools = jm.paged_prefill(jp, {"tokens": t}, pools, bt, lens,
                                 adapter=adapter)
    if path == "paged_prefill":
        return lg
    if path == "paged_decode_step":
        return jm.paged_decode_step(jp, pools, nxt, pos1, bt,
                                    adapter=adapter)[0]
    return jm.paged_decode_multi(jp, pools, seq, pos3, bt,
                                 adapter=adapter)[0]


PATHS = ("prefill", "decode_step", "paged_prefill", "paged_decode_step",
         "paged_prefill_suffix", "decode_multi", "paged_decode_multi")


@pytest.mark.parametrize("path", PATHS)
def test_adapter_path_matches_reference(setup, path):
    """Each cache path with a random adapter, unmerged, against the
    reference's same path and adapter; and not the adapter-free logits."""
    jm, jp, jad, model, params, adapter, tokens = setup
    got = _port_path(model, params, tokens, path, adapter=adapter)
    want = np.asarray(_jax_path(jm, jp, tokens, path, jad))
    tol = PAGED_TOL if "multi" in path or "suffix" in path else TOL
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    assert np.abs(got - _port_path(model, params, tokens, path)).max() > 1e-3


@pytest.mark.parametrize("path", PATHS)
def test_adapter_none_is_bit_identical(setup, path):
    """``adapter=None`` is the call without the argument, bit for bit, as
    is an adapter whose B factors are zero; and it is the reference's
    adapter-free path within 1e-5."""
    jm, jp, _, model, params, adapter, tokens = setup
    bare = _port_path(model, params, tokens, path)
    assert np.array_equal(bare, _port_path(model, params, tokens, path,
                                           adapter=None))
    assert np.array_equal(bare, _port_path(model, params, tokens, path,
                                           adapter=_zero_b(adapter)))
    tol = PAGED_TOL if "multi" in path or "suffix" in path else TOL
    np.testing.assert_allclose(
        bare, np.asarray(_jax_path(jm, jp, tokens, path, None)), atol=tol,
        rtol=tol)


def test_adapter_decode_matches_adapter_forward(setup):
    """tests/test_hydra.py:95: greedy decode with the unmerged adapter is
    the teacher-forced adapter forward's argmax, and the reference's
    greedy tokens."""
    jm, jp, jad, model, params, adapter, tokens = setup
    t = torch.from_numpy(tokens.astype(np.int64))
    logits, caches = model.prefill(params, {"tokens": t}, P + 4,
                                   adapter=adapter)
    toks = [torch.argmax(logits, -1)]
    for i in range(3):
        pos = torch.full((B,), P + i, dtype=torch.int32)
        lg, caches = model.decode_step(params, caches, toks[-1], pos,
                                       adapter=adapter)
        toks.append(torch.argmax(lg, -1))
    full = torch.cat([t, torch.stack(toks[:-1], 1)], 1)
    lg_full = model.forward(params, {"tokens": full}, adapter=adapter)[0]
    greedy = torch.argmax(lg_full[:, P - 1:], -1)
    assert torch.equal(torch.stack(toks, 1), greedy)

    jt = jnp.asarray(tokens, jnp.int32)
    jlg, jc = jm.prefill(jp, {"tokens": jt}, P + 4, adapter=jad)
    jtoks = [jnp.argmax(jlg, -1).astype(jnp.int32)]
    for i in range(3):
        jlg, jc = jm.decode_step(jp, jc, jtoks[-1],
                                 jnp.full((B,), P + i, jnp.int32),
                                 adapter=jad)
        jtoks.append(jnp.argmax(jlg, -1).astype(jnp.int32))
    np.testing.assert_array_equal(torch.stack(toks, 1).numpy(),
                                  np.asarray(jnp.stack(jtoks, 1)))


def test_paged_decode_adapter_matches_dense(setup):
    """tests/test_hydra.py:118: the paged adapter decode equals the dense
    one within 2e-5, and the reference's paged adapter decode."""
    jm, jp, jad, model, params, adapter, tokens = setup
    t = torch.from_numpy(tokens.astype(np.int64))
    nb = -(-(P + 1) // PS)
    pools = model.init_paged_pools(B * nb, PS, torch.float32)
    bt = torch.arange(B * nb, dtype=torch.int32).reshape(B, nb)
    _, pools = model.paged_prefill(params, {"tokens": t}, pools, bt,
                                   torch.full((B,), P, dtype=torch.int32),
                                   adapter=adapter)
    tok = torch.zeros((B,), dtype=torch.long)
    pos = torch.full((B,), P, dtype=torch.int32)
    lg_paged, _ = model.paged_decode_step(params, pools, tok, pos, bt,
                                          adapter=adapter)
    _, caches = model.prefill(params, {"tokens": t}, P + 1, adapter=adapter)
    lg_dense, _ = model.decode_step(params, caches, tok, pos,
                                    adapter=adapter)
    np.testing.assert_allclose(lg_paged.numpy(), lg_dense.numpy(),
                               atol=PAGED_TOL)
    jbt = jnp.arange(B * nb, dtype=jnp.int32).reshape(B, nb)
    jpools = jm.init_paged_pools(B * nb, PS, jnp.float32)
    _, jpools = jm.paged_prefill(jp, {"tokens": jnp.asarray(tokens,
                                                            jnp.int32)},
                                 jpools, jbt, jnp.full((B,), P, jnp.int32),
                                 adapter=jad)
    jlg, _ = jm.paged_decode_step(jp, jpools, jnp.zeros((B,), jnp.int32),
                                  jnp.full((B,), P, jnp.int32), jbt,
                                  adapter=jad)
    np.testing.assert_allclose(lg_paged.numpy(), np.asarray(jlg),
                               atol=PAGED_TOL)
