"""The port's memory study (``repro_torch.core``) against the reference's
``repro.core`` on the CPU.

* ``PersistentBuffers``: per group, the port's (nbytes, tag) multiset
  equals the reference's trees with each layer-stacked leaf split into its
  layers (the port keeps one dict a layer), less the 4-byte step count of
  each ``*_opt`` (the port's count is a Python int); the reference
  ``build_rlhf_phases``' own totals agree; ``required_by`` and ``transient`` equal —
  both engines, at a micro config and at the OPT pair's full size.
* ``Phase`` metadata (names, kinds, repeats, model, flops, hbm_bytes,
  free_after) equal, naive generation and gradient checkpointing on and
  off, and for ``build_grpo_phases``.
* The reference's own traces through the port's ``run_iteration``: a
  ``RunResult`` equal field for field, records and timeline included, for
  every strategy x policy x offload level on both engines.
* ``MemoryStrategy.scale`` on a grid; ``lora_trainable_fraction`` and
  ``param_count`` for every config the port registers.
* The ``meta`` route of each kernel wrapper: the plain version's shapes and
  dtypes, exactly the launch's allocations, no launch counted.
* ``tests/test_trace.py``'s five properties on the port's traces.
"""
import collections
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import core as JC  # noqa: E402
from repro.core.phases import build_grpo_phases as jax_grpo_phases  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models.lora import adapted_subtree as jax_adapted  # noqa: E402
from repro.optim import make_optimizer as jax_optimizer  # noqa: E402
from repro_torch import core as TC  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.trace import trace_function  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.steps import init_train_state, make_train_step  # noqa: E402

META = torch.device("meta")
MICRO = dict(num_layers=2, d_model=32, d_ff=64, vocab_size=32, num_heads=2,
             num_kv_heads=1, head_dim=16)
ENGINES = ("separate", "hydra")
CONFIGS = ("llama3_2_3b", "mamba2_370m", "opt_1_3b", "opt_350m", "gpt2_xl",
           "gpt2_medium", "opt_6_7b", "llama2_7b")


def _micro(get, **kw):
    return dataclasses.replace(get("llama3_2_3b").smoke(), **{**MICRO, **kw})


@pytest.fixture(autouse=True)
def _restore_flash_min():
    """The reference's ``build_rlhf_phases`` sets ``layers.FLASH_MIN_ELEMS``
    globally; test files share a process, so put it back."""
    before = jax_layers.FLASH_MIN_ELEMS
    yield
    jax_layers.FLASH_MIN_ELEMS = before


# ------------------------------------------------------ persistent buffers
def _split_sizes(tree, layers):
    """(nbytes) of each leaf of a reference shape tree, a layer-stacked leaf
    (under ``segment0``) split into its ``layers``; the step ``count``
    leaf dropped."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [getattr(p, "key", None) for p in path]
        nb = int(np.prod(leaf.shape)) * leaf.dtype.itemsize
        if keys[-1] == "count":
            continue
        if "segment0" in keys:
            out += [nb // layers] * layers
        else:
            out.append(nb)
    return out


def _reference_trees(actor_cfg, critic_cfg, engine, rank):
    """The reference's persistent trees, made as its ``build_rlhf_phases``
    makes them (bf16, under ``jax.eval_shape``) -> {group: (tree, tag)}."""
    actor_cfg = dataclasses.replace(actor_cfg, param_dtype="bfloat16")
    critic_cfg = dataclasses.replace(critic_cfg, param_dtype="bfloat16")
    key = jax.random.PRNGKey(0)
    actor = JaxModel(actor_cfg)
    a = jax.eval_shape(actor.init, key)
    opt = jax_optimizer("adamw")
    if engine == "hydra":
        ad = jax.eval_shape(lambda k: actor.init_adapter(k, a, rank), key)
        cad = jax.eval_shape(lambda k: actor.init_adapter(
            k, a, rank, with_value=True), key)
        return {"base_params": (a, "param"), "actor_params": (ad, "param"),
                "actor_opt": (jax.eval_shape(opt.init, ad), "opt"),
                "critic_params": (cad, "param"),
                "critic_opt": (jax.eval_shape(opt.init, cad), "opt"),
                "reward_params": (cad, "param"),
                "merged_rollout": (jax_adapted(a, ad["lora"]), "param")}
    c = jax.eval_shape(JaxModel(critic_cfg, with_value=True).init, key)
    return {"actor_params": (a, "param"),
            "actor_opt": (jax.eval_shape(opt.init, a), "opt"),
            "critic_params": (c, "param"),
            "critic_opt": (jax.eval_shape(opt.init, c), "opt"),
            "ref_params": (a, "param"), "reward_params": (c, "param")}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("size", ["micro", "opt_pair"])
def test_persistent_buffers_match_reference(engine, size):
    if size == "micro":
        a = c = _micro(get_config, head_dim=64, d_model=128)
        ja = jc = _micro(jax_get_config, head_dim=64, d_model=128)
    else:
        a, c = get_config("opt_1_3b"), get_config("opt_350m")
        ja, jc = jax_get_config("opt_1_3b"), jax_get_config("opt_350m")
    kw = dict(batch=1, prompt_len=8, gen_len=8, min_bytes=512, engine=engine,
              lora_rank=8)
    _, jper = JC.build_rlhf_phases(ja, jc, **kw)
    _, per = TC.build_rlhf_phases(a, c, **kw)
    trees = _reference_trees(ja, jc, engine, 8)
    assert set(per.buffers) == set(jper.buffers) == set(trees)
    for name, (tree, tag) in trees.items():
        want = collections.Counter((nb, tag) for nb in
                                   _split_sizes(tree, a.num_layers))
        assert collections.Counter(per.buffers[name]) == want, name
        step = 4 if name.endswith("_opt") else 0
        assert sum(nb for nb, _ in jper.buffers[name]) == \
            sum(nb for nb, _ in per.buffers[name]) + step, name
        assert {t for _, t in jper.buffers[name]} == {tag}
    assert per.required_by == jper.required_by
    assert per.transient == jper.transient


# --------------------------------------------------------- phase metadata
_META_FIELDS = ("name", "kind", "repeats", "model", "flops", "hbm_bytes",
                "free_after")


def _meta(phases):
    return [tuple(getattr(p, f) for f in _META_FIELDS) for p in phases]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("naive", [False, True])
@pytest.mark.parametrize("ckpt", [False, True])
def test_phase_metadata_matches_reference(engine, naive, ckpt):
    a = _micro(get_config, head_dim=64, d_model=128)
    ja = _micro(jax_get_config, head_dim=64, d_model=128)
    kw = dict(batch=2, prompt_len=8, gen_len=6, min_bytes=512,
              grad_ckpt=ckpt, naive_generation=naive, engine=engine,
              lora_rank=8, ppo_epochs=2)
    jph, _ = JC.build_rlhf_phases(ja, ja, **kw)
    ph, _ = TC.build_rlhf_phases(a, a, **kw)
    assert _meta(ph) == _meta(jph)
    assert [p.name for p in ph] == list(TC.RLHF_PHASE_SEQUENCE)


@pytest.mark.parametrize("ckpt", [False, True])
def test_grpo_phases_match_reference(ckpt):
    a = _micro(get_config, head_dim=64, d_model=128)
    ja = _micro(jax_get_config, head_dim=64, d_model=128)
    kw = dict(batch=2, group_size=4, prompt_len=8, gen_len=6, min_bytes=512,
              grad_ckpt=ckpt)
    jph, jper = jax_grpo_phases(ja, **kw)
    ph, per = TC.build_grpo_phases(a, **kw)
    assert _meta(ph) == _meta(jph)
    assert set(per.buffers) == set(jper.buffers) == {
        "actor_params", "actor_opt", "ref_params"}
    assert per.required_by == jper.required_by


def test_param_count_matches_flops_source():
    """Phase flops read ``param_count``: the OPT pair's, at full size."""
    for name in ("opt_1_3b", "opt_350m"):
        assert get_config(name).param_count() == \
            jax_get_config(name).param_count()


# ------------------------------------ run_iteration on the reference traces
@pytest.fixture(scope="module", params=ENGINES)
def reference_plans(request):
    """The reference's micro plans (``tests/test_offload.py``'s config),
    with and without checkpointing."""
    cfg = _micro(jax_get_config, num_heads=4, num_kv_heads=2, d_model=128,
                 d_ff=256)
    before = jax_layers.FLASH_MIN_ELEMS
    try:
        return request.param, {ck: JC.build_rlhf_phases(
            cfg, cfg, batch=2, prompt_len=4, gen_len=4, min_bytes=512,
            engine=request.param, lora_rank=8, grad_ckpt=ck)
            for ck in (False, True)}
    finally:
        jax_layers.FLASH_MIN_ELEMS = before


@pytest.mark.parametrize("strategy", [s.name for s in JC.PAPER_STRATEGIES])
def test_run_iteration_matches_reference_on_its_traces(reference_plans,
                                                       strategy):
    engine, plans = reference_plans
    js = {s.name: s for s in JC.PAPER_STRATEGIES}[strategy]
    ts = {s.name: s for s in TC.PAPER_STRATEGIES}[strategy]
    assert dataclasses.asdict(js) == dataclasses.asdict(ts)
    phases, per = plans[js.grad_ckpt]
    tf = 1.0 if engine == "hydra" else 0.25
    for policy in JC.POLICIES:
        for level in JC.OFFLOAD_LEVELS:
            kw = dict(ndp=4, trainable_fraction=tf, capacity=None,
                      timeline=True, offload=level)
            want = JC.run_iteration([phases, phases], per, js, policy, **kw)
            got = TC.run_iteration([phases, phases], per, ts, policy, **kw)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), \
                (policy, level)
    assert TC.POLICIES == JC.POLICIES
    assert TC.OFFLOAD_LEVELS == JC.OFFLOAD_LEVELS


# ------------------------------------------------------------- strategies
def test_strategy_scale_matches_reference_on_a_grid():
    traced = (("actor_params:param", 0.25), ("param", 0.5), ("opt", 0.125),
              ("layer_slice", 3.0))
    for js, ts in zip(JC.PAPER_STRATEGIES, TC.PAPER_STRATEGIES):
        for extra in ({}, {"traced": traced}):
            a = dataclasses.replace(js, **extra)
            b = dataclasses.replace(ts, **extra)
            for tag in ("param", "opt", "grad", "layer_slice", "temp",
                        "input", "cache", "other"):
                for ndp in (1, 2, 4, 8):
                    for tf in (1.0, 0.3):
                        for state in (None, "actor_params", "critic_opt"):
                            kw = dict(ndp=ndp, trainable_fraction=tf,
                                      state=state)
                            assert b.scale(tag, **kw) == a.scale(tag, **kw)


def test_traced_fractions_raise_until_sharding_is_ported():
    """Sharding is ported: the traced fractions no longer raise and give
    the reference's numbers (``tests/test_torch_sharding.py`` holds them
    on the whole grid)."""
    got = TC.traced_strategy(TC.PAPER_STRATEGIES[3], get_config("opt_1_3b"),
                             ndp=4).traced
    want = JC.traced_strategy(JC.PAPER_STRATEGIES[3],
                              jax_get_config("opt_1_3b"), ndp=4).traced
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a == pytest.approx(b, rel=1e-12)
    got = TC.traced_zero_scales(get_config("opt_1_3b"), ndp=4, zero_stage=3)
    want = JC.traced_zero_scales(jax_get_config("opt_1_3b"), ndp=4,
                                 zero_stage=3)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a == pytest.approx(b, rel=1e-12)


@pytest.mark.parametrize("name", CONFIGS)
def test_fraction_and_param_count_match_reference(name):
    cfg, jcfg = get_config(name), jax_get_config(name)
    assert cfg.param_count() == jcfg.param_count()
    for rank in (0, 8, 128):
        assert TC.lora_trainable_fraction(cfg, rank) == pytest.approx(
            JC.lora_trainable_fraction(jcfg, rank), rel=1e-12)


# ------------------------------------------------------------ meta route
def _kernel_cases(device):
    """name -> (call through ops, its inputs) on ``device``; each call
    returns a tuple of tensors."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s, dt=torch.float32: torch.randn(  # noqa: E731
        *s, generator=g).to(dt).to(device)
    B, S, H, K, D = 2, 80, 4, 2, 64
    C, P, ps, nb = 96, 9, 16, 4
    q, k, v = r(B, S, H, D), r(B, S, K, D), r(B, S, K, D)
    pos = torch.arange(C).repeat(B, 1).to(torch.int32).to(device)
    position = torch.tensor([C - 1, 50], dtype=torch.int32).to(device)
    table = torch.tensor([[0, 1, 2, 3], [4, 5, 6, -1]],
                         dtype=torch.int32).to(device)
    ppos = torch.tensor([60, 40], dtype=torch.int32).to(device)
    x, s = r(B, S, 256), r(256)

    def with_grad(f, *ins):
        ins = [t.detach().requires_grad_(True) for t in ins]
        with torch.enable_grad():
            out = f(*ins)
            return (out,) + torch.autograd.grad(out.sum(), ins)

    return {
        "rmsnorm": lambda: (ops.rmsnorm(x, s),),
        "rmsnorm_bwd": lambda: with_grad(ops.rmsnorm, x, s),
        "flash_attention": lambda: (ops.flash_attention(q, k, v),),
        "flash_attention_bwd": lambda: with_grad(
            lambda a, b, c: ops.flash_attention(a, b, c, window=24), q, k, v),
        "decode_attention": lambda: (ops.decode_attention(
            r(B, H, D), r(B, C, K, D), r(B, C, K, D), pos, position),),
        "paged_decode_attention": lambda: (ops.paged_decode_attention(
            r(B, H, D), r(P, ps, K, D), r(P, ps, K, D), table, ppos),),
        "ssd_scan": lambda: ops.ssd_scan(r(B, 64, 2, 32), -r(B, 64, 2).abs(),
                                         r(B, 64, 16), r(B, 64, 16), 32),
    }


@pytest.mark.parametrize("name", ops.KERNELS)
def test_meta_route_gives_plain_shapes_and_launches_nothing(name):
    want = _kernel_cases("cpu")[name]()
    ops.reset_launches()
    got = _kernel_cases(META)[name]()
    assert all(n == 0 for n in ops.launches.values()), ops.launches
    assert [(tuple(t.shape), t.dtype) for t in got] == \
        [(tuple(t.shape), t.dtype) for t in want]
    assert all(t.device.type == "meta" for t in got)


def test_meta_route_allocates_only_the_launch_footprint():
    """Traced on ``meta``, B1 allocates its output, B3 its output and split
    partials, B2-bwd dq, dk, dv and its fp32 scratch — not the plain
    versions' temporaries."""
    x, s = (torch.empty(*sh, device=META) for sh in ((512, 256), (256,)))
    tr = trace_function(lambda a, b: ops.rmsnorm(a, b), (x, s),
                        ("input", "param"), min_bytes=1)
    assert [e[2] for e in tr.events if e[0] == "alloc"] == [512 * 256 * 4]
    B, H, K, D, C = 2, 4, 2, 64, 1024
    q = torch.empty(B, H, D, device=META)
    kc = torch.empty(B, C, K, D, device=META)
    pos = torch.empty(B, C, dtype=torch.int32, device=META)
    p = torch.empty(B, dtype=torch.int32, device=META)
    tr = trace_function(lambda *a: ops.decode_attention(*a),
                        (q, kc, kc, pos, p), "input", min_bytes=1)
    from repro_torch.kernels import decode_attention as dec
    splits, _ = dec.split_plan(B, K, C)
    assert sorted(e[2] for e in tr.events if e[0] == "alloc") == sorted(
        [B * H * D * 4, B * H * splits * (D + 2) * 4])
    assert ops.launches["decode_attention"] == 0


# ------------------------------------------------ tests/test_trace.py's five
def _train_trace(remat, num_layers=4, d=128, B=2, S=64, min_bytes=512):
    cfg = dataclasses.replace(
        get_config("opt_1_3b").smoke(), num_layers=num_layers, d_model=d,
        d_ff=2 * d, vocab_size=256, remat=remat)
    m = Model(cfg, device=META)
    ts = make_train_step(m, cfg, kind="ppo")
    state = init_train_state(m, cfg, None, ts.optimizer)
    batch = {"tokens": torch.empty((B, S), dtype=torch.long, device=META)}
    for k in ("loss_mask", "advantages", "old_logp", "ref_logp", "returns"):
        batch[k] = torch.empty((B, S), device=META)
    tags = ({"params": "param", "opt": "opt", "step": "opt"}, "input")
    return trace_function(ts, (state, batch), tags, min_bytes=min_bytes)


def _check_balance(tr):
    live = {}
    for op, vid, nb, tag in tr.events:
        if op == "alloc":
            assert vid not in live, f"double alloc {vid}"
            live[vid] = nb
        else:
            assert vid in live, f"free of unallocated {vid}"
            assert live.pop(vid) == nb, f"size mismatch on free {vid}"
    return live


def test_trace_balanced():
    tr = _train_trace("none")
    leftovers = _check_balance(tr)
    # only the step outputs stay live
    assert len(leftovers) < 100


def test_remat_reduces_peak():
    t_none = _train_trace("none", num_layers=8, d=256, S=256)
    t_full = _train_trace("full", num_layers=8, d=256, S=256)
    assert t_full.peak_live() < 0.6 * t_none.peak_live(), (
        t_full.peak_live(), t_none.peak_live())
    # ... while total churn (recompute) goes up
    assert t_full.total_alloc_bytes() > t_none.total_alloc_bytes()


def test_layer_slices_emitted_per_layer_walk():
    tr = _train_trace("none", num_layers=6)
    slices = [e for e in tr.events if e[0] == "alloc" and e[3] == "layer_slice"]
    # at least one slice per layer for the forward and the backward
    assert len(slices) >= 12


def test_grad_tagging():
    tr = _train_trace("none")
    tags = {e[3] for e in tr.events}
    assert "grad" in tags
    assert "temp" in tags


def test_trace_scales_with_depth():
    tr4 = _train_trace("none", num_layers=4)
    tr8 = _train_trace("none", num_layers=8)
    assert tr8.total_alloc_bytes() > 1.5 * tr4.total_alloc_bytes()


def test_inplace_cache_writes_emit_nothing():
    """The decode step writes its cache in place and reads its params as
    views: no alloc of a cache's or a weight's size, only the step's
    activations (and each layer's slice)."""
    cfg = dataclasses.replace(get_config("opt_1_3b").smoke(), num_layers=2)
    m = Model(cfg, device=META)
    params = m.init()
    caches = {"layers": m.init_cache(4, 512, torch.float32)}
    tok = torch.empty(4, dtype=torch.long, device=META)
    pos = torch.empty(4, dtype=torch.int32, device=META)
    tr = trace_function(lambda *a: m.decode_step(*a)[0],
                        (params, caches, tok, pos),
                        ("param", "cache", "input", "input"), min_bytes=1)
    cache_nb = caches["layers"][0]["k"].numel() * 4
    assert not [e for e in tr.events if e[0] == "alloc" and e[3] != "layer_slice"
                and e[2] >= cache_nb]
    assert sum(e[3] == "layer_slice" for e in tr.events if e[0] == "alloc") == 2


def test_chip_replay_of_an_allocator_stream():
    """chip_smoke.py phase 11's replay of the card's allocator stream, on a
    made-up stream: the live requested bytes at each boundary, the card's
    segments and cudaMallocs per phase, and the simulator's allocated
    bytes (512-byte blocks) and empty_cache at the policy's boundaries."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    MB = 1 << 20
    seeds = [(1000, 3 * MB), (5000, 1000)]
    events = [("segment_alloc", 9000, 20 * MB, 10, 0),
              ("alloc", 9000, 5 * MB + 1, 11, 0),
              ("alloc", 7000, 100, 12, 0),
              ("free_completed", 9000, 5 * MB + 1, 30, 0),
              ("free_completed", 1000, 3 * MB, 31, 0),
              ("segment_free", 9000, 20 * MB, 40, 0),
              ("alloc", 8000, 2 * MB, 50, 0)]
    records = [{"phase": "rollout", "kind": "inference", "t": 20e-6,
                "requested_bytes": 8 * MB + 1101, "reserved_bytes": 42 * MB},
               {"phase": "score", "kind": "inference", "t": 45e-6,
                "requested_bytes": 1100, "reserved_bytes": 22 * MB},
               {"phase": "train_actor", "kind": "training", "t": 60e-6,
                "requested_bytes": 2 * MB + 1100, "reserved_bytes": 22 * MB}]
    rows, whole = chip_smoke.replay_stream(seeds, 22 * MB, events, records,
                                           "after_inference", 80 << 30)
    assert [r["stream_live"] for r in rows] == \
        [r["requested_bytes"] for r in records]
    assert [r["card_reserved_from_stream"] for r in rows] == \
        [42 * MB, 22 * MB, 22 * MB]
    assert [r["card_mallocs"] for r in rows] == [1, 0, 0]
    assert rows[1]["replay_allocated"] == 1024 + 512
    assert whole["card_peak_reserved"] == 42 * MB
    # the last cudaMalloc set the peak: reserved then less the live blocks
    assert whole["card_frag_at_peak"] == 22 * MB - (3 * MB + 1024)
    assert whole["streams"] == [0]
