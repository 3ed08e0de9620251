"""The port's sharding rules (``repro_torch.sharding``) against the
reference's ``repro.sharding`` on devices-free ``SpecMesh``es, in process.

* ``param_pspecs``, ``zero_opt_pspecs`` and ``adapter_pspecs`` at ndp 2,
  4 and 8, ZeRO stages 0-3, with and without a model axis of 2, on every
  config the port has (llama3_2_3b, mamba2_370m and the OPT pair): each
  layer's spec equals the reference's stacked spec less its leading
  entry, and every other leaf's spec equals the reference's. The only
  differences are the stacked-axis leaves of :data:`STACKED_AXIS`: a
  ``[L, n]`` stack whose L is the largest dim dividing ndp, where the
  reference's ``zero_opt_pspecs`` shards the layer axis and the port,
  with no layer axis, shards n.
* ``traced_zero_scales``/``traced_strategy`` equal to the reference's on
  both engines, stages 0-3, offload none/all, ntp 1/2.
* The layer plan's structure, ``batch_pspecs``, ``cache_pspecs``,
  ``validate_tp``, ``resolve_entry`` and ``ShardedContext.create(model>1)``.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import core as JC  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.sharding import ctx as jctx  # noqa: E402
from repro.sharding import rules as JR  # noqa: E402
from repro_torch import core as TC  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.sharding import ctx as tctx  # noqa: E402
from repro_torch.sharding import rules as TR  # noqa: E402
from repro_torch.sharding import ShardedContext  # noqa: E402
from repro_torch.sharding.context import _strip_dp  # noqa: E402

CONFIGS = (("llama3_2_3b", False), ("mamba2_370m", False),
           ("opt_1_3b", False), ("opt_350m", True))
NDPS = (2, 4, 8)
STAGES = (0, 1, 2, 3)

# The stacked-axis leaves: (config, model axis) -> the port's leaf paths
# (layer 0 standing for every layer) whose ZeRO-1/2 optimizer spec differs
# from the reference's stacked one, at every ndp of NDPS. The reference's
# "largest unsharded dim that divides ndp" is there the layer axis: the
# port has none and shards the leaf's own dim, or keeps it whole.
#   * mamba2_370m's per-head vectors, [48, 32] stacked: 48 layers beat the
#     32 heads; the port shards the heads;
#   * with a model axis, mamba2_370m's conv_w [48, 4, 2304] and conv_b
#     [48, 2304] (2304 taken by "model", 48 beats 4) and the OPT pair's qkv
#     biases [24, 2048] (2048 taken by "model"): the port keeps them whole.
# Nothing else differs, at any stage.
STACKED_AXIS = {
    ("mamba2_370m", 1): ("layers.0.mixer.A_log", "layers.0.mixer.D",
                         "layers.0.mixer.dt_bias"),
    ("mamba2_370m", 2): ("layers.0.mixer.A_log", "layers.0.mixer.D",
                         "layers.0.mixer.conv_b", "layers.0.mixer.conv_w",
                         "layers.0.mixer.dt_bias"),
    ("opt_1_3b", 2): ("layers.0.mixer.bk", "layers.0.mixer.bq",
                      "layers.0.mixer.bv"),
    ("opt_350m", 2): ("layers.0.mixer.bk", "layers.0.mixer.bq",
                      "layers.0.mixer.bv"),
}


def _jflat(tree, is_leaf=None):
    """{dotted path: leaf} of a reference pytree."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): v for kp, v in flat}


def _tflat(tree, path=()):
    """{dotted path: leaf} of a port tree (dicts, lists, specs)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tflat(v, path + (str(k),)))
        return out
    if isinstance(tree, list) and not isinstance(tree, TR.P):
        out = {}
        for i, v in enumerate(tree):
            out.update(_tflat(v, path + (str(i),)))
        return out
    if tree is None:
        return {}
    return {".".join(path): tree}


def _norm(spec, ndim):
    """A spec as a tuple of ``ndim`` entries."""
    e = tuple(spec)
    return e + (None,) * (ndim - len(e))


@functools.lru_cache(maxsize=None)
def _shapes(name, with_value):
    jcfg, cfg = jax_get_config(name), get_config(name)
    jshapes = jax.eval_shape(JaxModel(jcfg, with_value=with_value).init,
                             jax.random.PRNGKey(0))
    shapes = Model(cfg, device="meta", with_value=with_value).init()
    return jcfg, cfg, jshapes, shapes


def _mesh(ndp, model):
    axes = {"data": ndp, "model": model} if model > 1 else {"data": ndp}
    return JR.SpecMesh(axes), TR.SpecMesh(axes)


def _strats(stage, model):
    kw = dict(zero_stage=stage, tensor_parallel=model > 1, ntp=model)
    return JR.ShardingStrategy(**kw), TR.ShardingStrategy(**kw)


def _port_path_to_ref(path, per):
    """layers.i.rest -> segment0.slot{j}.rest (with its stacked lead) for
    a layer leaf; other paths are the same in both trees."""
    parts = path.split(".")
    if parts[0] != "layers":
        return path, False
    i = int(parts[1])
    return ".".join(["segment0", f"slot{i % per}"] + parts[2:]), True


def _diffs(jspecs, jshapes, tspecs, tshapes, per):
    """Port leaf paths whose spec differs from the reference's (a layer
    leaf against the stacked spec less its lead)."""
    jsp = _jflat(jspecs, is_leaf=lambda x: isinstance(x, JP))
    jsh = _jflat(jshapes)
    tsp, tsh = _tflat(tspecs), _tflat(tshapes)
    assert set(tsp) == set(tsh)
    bad = set()
    seen = set()
    for path, spec in tsp.items():
        ref_path, stacked = _port_path_to_ref(path, per)
        assert ref_path in jsp, ref_path
        seen.add(ref_path)
        want = _norm(jsp[ref_path], len(jsh[ref_path].shape))
        if stacked:
            if want[0] is not None:      # the reference shards the layers
                bad.add(path)
                continue
            want = want[1:]
        assert tuple(tsh[path].shape) == tuple(
            jsh[ref_path].shape[1:] if stacked else jsh[ref_path].shape)
        if _norm(spec, len(tsh[path].shape)) != want:
            bad.add(path)
    assert seen == set(jsp)
    return bad


def _layer0(paths):
    """Layer leaves folded onto layer 0 (the differences are per leaf
    name, the same in every layer)."""
    return {".".join(["layers", "0"] + p.split(".")[2:])
            if p.startswith("layers.") else p for p in paths}


@pytest.mark.parametrize("model", [1, 2])
@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("ndp", NDPS)
@pytest.mark.parametrize("name,with_value", CONFIGS,
                         ids=[n for n, _ in CONFIGS])
def test_param_and_opt_specs_match_reference_per_layer(name, with_value,
                                                       ndp, stage, model):
    jcfg, cfg, jshapes, shapes = _shapes(name, with_value)
    jmesh, tmesh = _mesh(ndp, model)
    jstrat, tstrat = _strats(stage, model)
    per = len(cfg.period)
    jp = JR.param_pspecs(jcfg, jmesh, jstrat, jshapes)
    tp = TR.param_pspecs(cfg, tmesh, tstrat, shapes)
    assert _diffs(jp, jshapes, tp, shapes, per) == set()
    jo = JR.zero_opt_pspecs(jp, jshapes, jmesh, jstrat)
    to = TR.zero_opt_pspecs(tp, shapes, tmesh, tstrat)
    got = _layer0(_diffs(jo, jshapes, to, shapes, per))
    want = STACKED_AXIS.get((name, model), ()) if stage in (1, 2) else ()
    assert got == set(want), got


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("ndp", NDPS)
@pytest.mark.parametrize("model", [1, 2])
@pytest.mark.parametrize("name", ["llama3_2_3b", "opt_1_3b"])
def test_adapter_specs_match_reference_per_layer(name, model, ndp, stage):
    jcfg, cfg, jshapes, shapes = _shapes(name, False)
    jmesh, tmesh = _mesh(ndp, model)
    jstrat, tstrat = _strats(stage, model)
    jad = jax.eval_shape(lambda k: JaxModel(jcfg).init_adapter(
        k, jshapes, 128, with_value=True), jax.random.PRNGKey(0))
    model_ = Model(cfg, device="meta")
    ad = model_.init_adapter(None, shapes, 128, with_value=True)
    jsp = JR.adapter_pspecs(jmesh, jstrat, jad)
    tsp = TR.adapter_pspecs(tmesh, tstrat, ad)
    # the adapter's lora tree stacks like the params: lora.segment0...
    jl = {"lora": jsp["lora"], "value_head": jsp["value_head"]}
    jls = {"lora": jad["lora"], "value_head": jad["value_head"]}
    tl = {"lora": tsp["lora"], "value_head": tsp["value_head"]}
    tls = {"lora": ad["lora"], "value_head": ad["value_head"]}
    bad = _diffs(_unlora(jl), _unlora(jls), _unlora(tl), _unlora(tls),
                 len(cfg.period))
    assert bad == set()
    sharded = sum(any(e is not None for e in s)
                  for s in TR.spec_leaves(tsp))
    assert (sharded > 0) == (stage >= 3 or model > 1)


def _unlora(tree):
    """The adapter tree with its "lora" level folded, so the layer paths
    start with "layers"/"segment0" as in the parameter trees."""
    out = dict(tree["lora"])
    out["value_head"] = tree["value_head"]
    return out


# ---------------------------------------------------------- traced scales
SMALL = dict(num_layers=2, d_model=1024, d_ff=2048, vocab_size=64,
             num_heads=8, num_kv_heads=4, head_dim=128)


def _small(get):
    return dataclasses.replace(get("llama3_2_3b").smoke(), **SMALL)


def _close_tuple(got, want):
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        assert a == pytest.approx(b, rel=1e-12, abs=1e-15), k


@pytest.mark.parametrize("ntp", [1, 2])
@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("engine", ["separate", "hydra"])
def test_traced_zero_scales_match_reference(engine, stage, ntp):
    for mode in ("layer", "tree"):
        got = TC.traced_zero_scales(_small(get_config), _small(get_config),
                                    ndp=2, zero_stage=stage, engine=engine,
                                    lora_rank=16, gather_mode=mode, ntp=ntp)
        want = JC.traced_zero_scales(
            _small(jax_get_config), _small(jax_get_config), ndp=2,
            zero_stage=stage, engine=engine, lora_rank=16, gather_mode=mode,
            ntp=ntp)
        _close_tuple(got, want)


@pytest.mark.parametrize("offload", ["none", "all"])
@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("engine", ["separate", "hydra"])
def test_traced_strategy_matches_reference(engine, stage, offload):
    """``traced_strategy`` on the reference's accounting grid
    (``tests/test_zero_rlhf.py:206``) and on the paper's pair at ndp 4."""
    jb = JC.MemoryStrategy(f"Z{stage}", zero_stage=stage, offload=offload)
    tb = TC.MemoryStrategy(f"Z{stage}", zero_stage=stage, offload=offload)
    got = TC.traced_strategy(tb, _small(get_config), _small(get_config),
                             ndp=8, engine=engine, lora_rank=16)
    want = JC.traced_strategy(jb, _small(jax_get_config),
                              _small(jax_get_config), ndp=8, engine=engine,
                              lora_rank=16)
    _close_tuple(got.traced, want.traced)
    assert dataclasses.replace(got, traced=()) == tb
    if engine == "separate":
        pair = [("opt_1_3b", "opt_350m")]
        for a, c in pair:
            _close_tuple(
                TC.traced_strategy(tb, get_config(a), get_config(c),
                                   ndp=4).traced,
                JC.traced_strategy(jb, jax_get_config(a), jax_get_config(c),
                                   ndp=4).traced)


def test_traced_layer_slice_and_merged_rollout():
    """The reference's ``test_layer_gather.py:304`` and ``test_tp.py:373``
    checks on the port's numbers."""
    cfg = _small(get_config)
    t_dp = dict(TC.traced_zero_scales(cfg, cfg, ndp=2, zero_stage=3))
    t_tp = dict(TC.traced_zero_scales(cfg, cfg, ndp=2, zero_stage=3, ntp=2))
    for group in ("actor_params:param", "critic_params:param",
                  "actor_opt:opt", "critic_opt:opt"):
        assert 0.5 <= t_dp[group] <= 0.7
        assert 0.25 <= t_tp[group] <= 0.45
    h_dp = dict(TC.traced_zero_scales(cfg, cfg, ndp=2, zero_stage=3,
                                      engine="hydra", lora_rank=16))
    assert h_dp["merged_rollout:param"] == 1.0
    tree = dict(TC.traced_zero_scales(cfg, cfg, ndp=2, zero_stage=3,
                                      gather_mode="tree"))
    assert tree["layer_slice"] == float(cfg.num_layers)
    assert t_dp["layer_slice"] == 1.0


# ------------------------------------------------------------ plan structure
def test_layer_plan_spec_structure():
    """Layer mode: ``layers`` keeps its sharded state specs in the gather
    target, the per-layer specs drop every DP axis, and the other leaves
    (embedding, final norm) are DP-stripped: they gather whole."""
    cfg = get_config("llama3_2_3b")
    shapes = Model(cfg, device="meta").init()
    sc = ShardedContext(TR.SpecMesh({"data": 8}),
                        TR.ShardingStrategy(zero_stage=3,
                                            tensor_parallel=False,
                                            gather_mode="layer"))
    plan = sc.plan_params(cfg, shapes)
    assert plan.gather_mode == "layer"
    assert plan.layer_param_specs["layers"] is plan.param_specs["layers"]
    uses = lambda s: any(e == "data" or (isinstance(e, tuple) and "data" in e)  # noqa: E731
                         for e in s)
    for k in ("embed", "final_norm"):
        assert not any(uses(s) for s in TR.spec_leaves(
            plan.layer_param_specs[k]))
    assert len(plan.layer_specs) == cfg.num_layers     # one a layer
    n_sharded = 0
    for st, sl in zip(TR.spec_leaves(plan.param_specs["layers"]),
                      TR.spec_leaves(plan.layer_specs)):
        assert not uses(sl)
        n_sharded += uses(st)
    assert n_sharded > 0


@pytest.mark.parametrize("stage,mode,expect", [(3, "tree", False),
                                               (1, "layer", False),
                                               (3, "layer", True)])
def test_tree_mode_plan_has_no_layer_specs(stage, mode, expect):
    cfg = get_config("llama3_2_3b").smoke()
    sc = ShardedContext(TR.SpecMesh({"data": 8}),
                        TR.ShardingStrategy(zero_stage=stage,
                                            tensor_parallel=False,
                                            gather_mode=mode))
    plan = sc.plan_params(cfg, Model(cfg, device="meta").init())
    assert (plan.layer_specs is not None) == expect
    assert plan.gather_mode == ("layer" if expect else "tree")


def test_create_with_a_model_axis_raises_naming_tp():
    """A model axis runs (``tests/test_torch_tp.py``), but not for a config
    whose KV heads do not divide it: the reference's head_dim fallback is
    not ported (ROADMAP A10c), refused before any group is touched."""
    cfg = dataclasses.replace(get_config("llama3_2_3b").smoke(),
                              num_heads=4, num_kv_heads=1)
    with pytest.raises(NotImplementedError, match="tensor parallel.*head_dim"):
        ShardedContext.create(2, zero_stage=3, model=2, device="cpu",
                              cfg=cfg)


def test_strip_dp_keeps_tp_entries():
    mesh = TR.SpecMesh({"data": 2, "model": 2})
    assert _strip_dp(TR.P("data", "model"), mesh) == TR.P(None, "model")
    assert _strip_dp(TR.P(("data", "model"), None), mesh) == \
        TR.P("model", None)


# ------------------------------------------------------- batches and caches
@pytest.mark.parametrize("batch", [3, 8])
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_batch_pspecs_match_reference(batch, kind):
    for ndp in NDPS:
        jmesh, tmesh = _mesh(ndp, 1)
        shape = ShapeConfig(name="s", seq_len=16, global_batch=batch,
                            kind=kind)
        got = TR.batch_pspecs(get_config("llama3_2_3b"), shape, tmesh)
        want = JR.batch_pspecs(jax_get_config("llama3_2_3b"), shape, jmesh)
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("model", [1, 2])
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("name", ["llama3_2_3b", "mamba2_370m"])
def test_cache_pspecs_match_reference_per_layer(name, batch, model):
    jcfg, cfg = jax_get_config(name).smoke(), get_config(name).smoke()
    cap = 64
    jmodel = JaxModel(jcfg)
    jcaches = jax.eval_shape(lambda: jmodel.init_cache(batch, cap,
                                                       jax.numpy.float32))
    caches = Model(cfg, device="meta").init_cache(batch, cap, torch.float32)
    per = len(cfg.period)
    for ndp in NDPS:
        jmesh, tmesh = _mesh(ndp, model)
        jstrat, tstrat = _strats(3, model)
        want = JR.cache_pspecs(jmodel, jcfg, jmesh, batch, jstrat, jcaches)
        got = TR.cache_pspecs(None, cfg, tmesh, batch, tstrat, caches)
        for i, layer in enumerate(got):
            ref = want[0][f"slot{i % per}"]
            for k, spec in layer.items():
                w = _norm(ref[k], len(caches[i][k].shape) + 1)
                assert w[0] is None
                assert _norm(spec, len(caches[i][k].shape)) == w[1:], \
                    (name, ndp, i, k)


# ------------------------------------------------------------------- misc
@pytest.mark.parametrize("ntp", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("name", ["llama3_2_3b", "mamba2_370m", "opt_1_3b"])
def test_validate_tp_matches_reference(name, ntp):
    def outcome(fn, cfg):
        try:
            fn(cfg, ntp)
            return None
        except ValueError as e:
            return str(e)
    assert outcome(TR.validate_tp, get_config(name)) == \
        outcome(JR.validate_tp, jax_get_config(name))


def test_resolve_entry_and_identity_constraints():
    for shape in ({"data": 2, "model": 2}, {"data": 4}, {"pod": 2, "data": 2,
                                                         "model": 2}):
        jm, tm = JR.SpecMesh(shape), TR.SpecMesh(shape)
        for entry in (None, "dp", "model", "data", "pod", "nope"):
            for dim in (1, 2, 4, 6, 8):
                assert tctx.resolve_entry(tm, entry, dim) == \
                    jctx.resolve_entry(jm, entry, dim)
    x = torch.ones(2, 3)
    assert tctx.constrain(x, "dp", None) is x
    with tctx.use_mesh(TR.SpecMesh({"data": 2, "model": 1})):
        assert tctx.constrain(x, "dp", None) is x
        assert tctx.constrain_spec(x, TR.P("data", None)) is x
    with tctx.use_mesh(TR.SpecMesh({"data": 2, "model": 2})):
        with pytest.raises(NotImplementedError, match="tensor"):
            tctx.constrain(x, "dp", "model")
    assert tctx.current_mesh() is None


def test_sharding_strategy_checks_match_reference():
    for kw in (dict(ntp=0), dict(tp_mode="seq"),
               dict(ntp=2, tensor_parallel=False)):
        with pytest.raises(ValueError):
            TR.ShardingStrategy(**kw)
        with pytest.raises(ValueError):
            JR.ShardingStrategy(**kw)
    assert [f.name for f in dataclasses.fields(TR.ShardingStrategy)] == \
        [f.name for f in dataclasses.fields(JR.ShardingStrategy)]
    assert TR.TP_COL_SITES == JR.TP_COL_SITES
    assert TR.TP_ROW_SITES == JR.TP_ROW_SITES
