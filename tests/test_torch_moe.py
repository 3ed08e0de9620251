"""The port's MoE FFN (``repro_torch/models/moe.py``) against the JAX
reference's (``repro/models/moe.py``) on the CPU, f32, granite's smoke
widths (d_model 256, 4 experts, top 2, d_expert 128).

Parameters come from the reference's ``init_moe`` and inputs from numpy
seeds. Tolerances: 1e-6 on the router, 1e-5 on the FFN's output, its aux
loss and its gradients (``tests/test_kernel_model_paths.py``'s model-path
tolerance). Capacity factors 16.0 (nothing drops), 1.25 (the configs'
default) and 0.25 (most assignments drop). The grouped routing of a
data-parallel mesh (``ndp`` 2) is held against the reference with its
``_num_dp_shards`` patched to 2 in the test: without a mesh the
reference's ``ctx.constrain`` is the identity, so that is its two-shard
math. The reference's three property tests (``tests/test_moe_properties.py``)
close the file, on the port.
"""
import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.sharding import ShardedContext, ctx  # noqa: E402
from repro_torch.sharding.rules import SpecMesh  # noqa: E402

ARCH = "granite_moe_3b_a800m"
TOL = 1e-5


def _cfgs(**kw):
    kw = {"param_dtype": "float32", **kw}
    return (dataclasses.replace(jax_get_config(ARCH).smoke(), **kw),
            dataclasses.replace(get_config(ARCH).smoke(), **kw))


def _t(a):
    return torch.from_numpy(np.array(a))


def _params(jcfg, seed=0):
    jp = JMOE.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jp, {k: _t(v) for k, v in jp.items()}


def _x(shape, seed=1):
    return (np.random.RandomState(seed).randn(*shape) * 0.5).astype(
        np.float32)


def _two_shards(T):
    return 2 if T % 2 == 0 else 1


@pytest.mark.parametrize("T,E,k,ties", [(16, 4, 2, False),
                                        (33, 40, 8, False),
                                        (8, 16, 2, True)])
def test_router_topk_matches_reference(T, E, k, ties):
    """Gates, indices and aux; ``ties`` gives equal logits on half the
    rows, where both take the lower experts (lax.top_k's order)."""
    logits = np.random.RandomState(T).randn(T, E).astype(np.float32)
    if ties:
        logits[::2] = 0.25
    gj, ij, aj = JMOE.router_topk(jnp.asarray(logits), k)
    gt, it, at = TMOE.router_topk(_t(logits), k)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-6)
    np.testing.assert_allclose(float(at), float(aj), atol=1e-6)


@pytest.mark.parametrize("cf", [16.0, 1.25, 0.25])
def test_moe_fwd_matches_reference(cf):
    """Output and aux at each capacity factor (0.25 drops most
    assignments: which ones is fixed by the stable sort), and the
    gradients of a weighted sum of the output plus the aux loss with
    respect to x and every parameter."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    x = _x((2, 24, jcfg.d_model))
    w = _x((2, 24, jcfg.d_model), seed=2)

    def jloss(p, xx):
        y, aux = JMOE.moe_fwd(p, xx, jcfg, capacity_factor=cf)
        return jnp.sum(y * w) + aux, (y, aux)

    (_, (yj, aj)), (gpj, gxj) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    xt = _t(x).requires_grad_(True)
    yt, at = TMOE.moe_fwd(tp, xt, tcfg, capacity_factor=cf)
    (torch.sum(yt * _t(w)) + at).backward()
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj),
                               atol=TOL)
    np.testing.assert_allclose(float(at.detach()), float(aj), atol=TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gxj), atol=TOL)
    for name, g in gpj.items():
        np.testing.assert_allclose(tp[name].grad.numpy(), np.asarray(g),
                                   atol=TOL, err_msg=name)
    if cf == 0.25:
        # dropping happened: the output differs from a drop-free one
        free = TMOE.moe_fwd(tp, xt, tcfg, capacity_factor=16.0)[0]
        assert float((free - yt).abs().max().detach()) > 1e-4


@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_grouped_routing_at_ndp2_matches_reference(monkeypatch, cf):
    """Under an ambient mesh with a data axis of 2 the port routes the
    tokens as two groups (capacity per group), as the reference does
    under such a mesh; an odd token count routes as one group. Under a
    ``ShardedContext``'s ``sharded_batch()`` a rank holding one group's
    rows routes them alone, its aux loss half the group's (the step sums
    the ranks'); outside it the context routes its whole batch as two."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    monkeypatch.setattr(JMOE, "_num_dp_shards", _two_shards)
    mesh = SpecMesh({"data": 2, "model": 1})
    for shape in ((2, 20, jcfg.d_model), (1, 15, jcfg.d_model)):
        x = _x(shape)
        yj, aj = JMOE.moe_fwd(jp, jnp.asarray(x), jcfg, capacity_factor=cf)
        with ctx.use_mesh(mesh):
            yt, at = TMOE.moe_fwd(tp, _t(x), tcfg, capacity_factor=cf)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=TOL)
        np.testing.assert_allclose(float(at), float(aj), atol=TOL)
    # the grouping matters: one group of all 40 tokens is another result
    x = _x((2, 20, jcfg.d_model))
    one = TMOE.moe_fwd(tp, _t(x), tcfg, capacity_factor=cf)[1]
    with ctx.use_mesh(mesh):
        two = TMOE.moe_fwd(tp, _t(x), tcfg, capacity_factor=cf)[1]
    assert abs(float(one) - float(two)) > 1e-7
    # a rank's own share (row 0 of the batch): group 0 of the two
    yj, _ = JMOE.moe_fwd(jp, jnp.asarray(x), jcfg, capacity_factor=cf)
    monkeypatch.setattr(JMOE, "_num_dp_shards", lambda T: 1)
    _, aj0 = JMOE.moe_fwd(jp, jnp.asarray(x[:1]), jcfg, capacity_factor=cf)
    sc = ShardedContext(mesh)
    sc.comm = types.SimpleNamespace(batch_sharded=False)   # no group needed
    with ctx.use_mesh(sc):
        assert float(TMOE.moe_fwd(tp, _t(x), tcfg, capacity_factor=cf)[1]
                     ) == float(two)
        with sc.sharded_batch():
            yt0, at0 = TMOE.moe_fwd(tp, _t(x[:1]), tcfg, capacity_factor=cf)
    np.testing.assert_allclose(yt0.numpy(), np.asarray(yj)[:1], atol=TOL)
    np.testing.assert_allclose(float(at0), float(aj0) / 2, atol=TOL)


def test_capacity_matches_reference_rule():
    """C = ceil(T k / E cf), up to a multiple of 4, at least 4: granite's
    full-width decode step of 8 rows keeps 4 slots an expert, its 8 x 512
    prefill 1024."""
    cfg = get_config(ARCH)
    assert TMOE.capacity(8, cfg) == 4
    assert TMOE.capacity(8 * 512, cfg) == 1024
    jam = get_config("jamba_v0_1_52b")
    assert TMOE.capacity(8 * 512, jam) == 640


class _Comm:
    """A model group of 2 that is never asked for a collective."""
    size, rank = 2, 0


def test_moe_refused_under_tensor_parallelism():
    """Under an ambient TP group the FFN raises, as
    ``sharding.tp.check_supported`` does for an MoE config: both name
    ROADMAP A10c 4 (``moe_shard_map``)."""
    from repro_torch.sharding import tp as TP
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)
    with ctx.use_mesh(TP.TensorParallel(_Comm())), \
            pytest.raises(NotImplementedError, match="MoE.*A10c 4"):
        TMOE.moe_fwd(tp, _t(_x((1, 4, tcfg.d_model))), tcfg)
    with pytest.raises(NotImplementedError, match="MoE.*A10c 4"):
        TP.check_supported(tcfg, 2)
    TP.check_supported(tcfg, 1)


# --------------------------------------------------------------------------
# The reference's properties (tests/test_moe_properties.py), on the port
# --------------------------------------------------------------------------
def _port_params():
    jcfg, tcfg = _cfgs()
    return tcfg, _params(jcfg)[1]


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_moe_permutation_equivariance_dropfree(seed):
    """With capacity high enough that nothing drops, permuting the tokens
    permutes the outputs (routing is per token)."""
    cfg, params = _port_params()
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((1, 16, cfg.d_model), generator=g) * 0.5
    perm = torch.randperm(16, generator=g)
    y, _ = TMOE.moe_fwd(params, x, cfg, capacity_factor=16.0)
    y_p, _ = TMOE.moe_fwd(params, x[:, perm], cfg, capacity_factor=16.0)
    np.testing.assert_allclose(y_p.numpy(), y[:, perm].numpy(), atol=1e-5)


def test_moe_dropping_is_graceful():
    """Tiny capacity: outputs stay finite, differ from the drop-free ones,
    and do not grow."""
    cfg, params = _port_params()
    x = torch.randn((2, 32, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)) * 0.5
    y_tight, _ = TMOE.moe_fwd(params, x, cfg, capacity_factor=0.25)
    y_free, _ = TMOE.moe_fwd(params, x, cfg, capacity_factor=16.0)
    assert bool(torch.isfinite(y_tight).all())
    assert float((y_tight - y_free).abs().max()) > 1e-6
    assert float(y_tight.norm()) <= float(y_free.norm()) * 1.5


@settings(max_examples=20, deadline=None)
@given(st.integers(2, 64), st.integers(2, 16), st.integers(0, 2**31 - 1))
def test_router_topk_properties(T, E, seed):
    k = min(4, E)
    logits = torch.randn((T, E), generator=torch.Generator().manual_seed(seed))
    gates, idx, aux = TMOE.router_topk(logits, k)
    g, i = gates.numpy(), idx.numpy()
    assert g.shape == (T, k) and i.shape == (T, k)
    np.testing.assert_allclose(g.sum(-1), 1.0, atol=1e-5)   # renormalised
    assert (g >= 0).all()
    assert (i >= 0).all() and (i < E).all()
    for t in range(T):                  # distinct experts per token
        assert len(set(i[t])) == k
    assert 0.5 <= float(aux) <= E + 1e-3
