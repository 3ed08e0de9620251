"""More model families on the port against the JAX reference on the
CPU: ``granite_moe_3b_a800m`` (every FFN MoE), ``jamba_v0_1_52b`` (Mamba,
attention and MoE in one 8-layer period), ``qwen1_5_4b`` (dense, qkv
bias, MHA), and for the checks that read a config, a tree or a forward,
``deepseek_v3_671b`` (MLA layers, a dense leading segment before the MoE
one, an MTP module; ``tests/test_torch_mla.py`` holds the rest of it), and
the two dense >= 100B configs: ``qwen1_5_110b`` (qkv bias, untied) and
``command_r_plus_104b`` (tied embeddings), the latter's forward, caches
and rollouts at a G 12 variant (12 query heads over 1 KV head, as its 96
over 8; ``tests/test_torch_adamw_bf16.py`` holds their optimizer).

f32 smoke configs; weights from the reference's init (``bridge.from_jax``;
qwen's zero-initialised qkv biases given random values so that they are
added), inputs from numpy seeds. Jamba's sequences stay at 32-40 tokens:
its seven Mamba layers run the Pallas scan in interpret mode on the JAX
side. Tolerances: 1e-5 on a forward's logits and aux loss, on prefill and
decode logits and caches (``tests/test_kernel_model_paths.py``); 1e-4 on a
PPO iteration's metrics (``tests/test_torch_separate.py``); greedy tokens
identical. The rollouts and the batcher run granite at capacity factor
1.0, where a prefill drops assignments; the batcher's decode rungs route
their idle rows too, as the reference's do.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.rlhf import RLHFConfig as JaxRLHFConfig  # noqa: E402
from repro.rlhf import RLHFTrainer as JaxRLHFTrainer  # noqa: E402
from repro.rlhf import Rollout as JaxRollout  # noqa: E402
from repro.rlhf.engine import ModelEngine as JaxModelEngine  # noqa: E402
from repro.rlhf.reward import \
    make_target_token_reward as jax_target_reward  # noqa: E402
from repro.serving import ContinuousBatcher as JaxBatcher  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import MLA, MLAConfig, get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.rlhf import ModelEngine, RLHFConfig, RLHFTrainer  # noqa: E402
from repro_torch.rlhf import Rollout  # noqa: E402
from repro_torch.rlhf.reward import make_target_token_reward  # noqa: E402
from repro_torch.serving import ContinuousBatcher  # noqa: E402
from repro_torch.sharding import tp as TP  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ARCHS = ("granite_moe_3b_a800m", "jamba_v0_1_52b", "qwen1_5_4b")
GRANITE = "granite_moe_3b_a800m"
DEEPSEEK = "deepseek_v3_671b"
FAM_ARCHS = ARCHS + (DEEPSEEK,)
BIG = ("qwen1_5_110b", "command_r_plus_104b")
CMDR_G12 = "command_r_plus_104b:g12"     # 12 query heads over 1 KV head
MODEL_ARCHS = FAM_ARCHS + ("qwen1_5_110b", CMDR_G12)
TOL = 1e-5
TOL_PPO = 1e-4
S = 32                  # a multiple of jamba's smoke chunk


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small CPU ops (the suite runs
    several test processes at once). Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x).copy(), tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(arch, **kw):
    kw = {"param_dtype": "float32", **kw}
    if arch == CMDR_G12:
        arch = BIG[1]
        kw = {"num_heads": 12, "num_kv_heads": 1, **kw}
    return (dataclasses.replace(jax_get_config(arch).smoke(), **kw),
            dataclasses.replace(get_config(arch).smoke(), **kw))


def _with_moe(cfg, cf):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def _with_biases(jparams, seed):
    """Random qkv biases (the reference initialises them to zero)."""
    rng = np.random.default_rng(seed)

    def fill(path, x):
        if jax.tree_util.keystr(path[-1:]) in ("['bq']", "['bk']", "['bv']"):
            return jnp.asarray(0.1 * rng.standard_normal(x.shape), x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(fill, jparams)


def _pair(jcfg, tcfg, seed=0):
    jm = JaxModel(jcfg)
    jp = _with_biases(jm.init(jax.random.PRNGKey(seed)), seed + 1)
    tm = Model(tcfg, device="cpu")
    return jm, jp, tm, bridge.from_jax(_np(jp), tcfg, "cpu")


@pytest.fixture(scope="module", params=MODEL_ARCHS)
def fam(request):
    jcfg, tcfg = _cfgs(request.param)
    return (jcfg, tcfg) + _pair(jcfg, tcfg)


def _field(cfg, name):
    v = getattr(cfg, name)
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", FAM_ARCHS + BIG)
def test_configs_and_param_counts_match_reference(arch):
    """Every field of the port's config, ``layer_is_moe``, ``param_count``
    and ``active_param_count``, at full size and smoke."""
    for full in (True, False):
        jcfg, tcfg = jax_get_config(arch), get_config(arch)
        if not full:
            jcfg, tcfg = jcfg.smoke(), tcfg.smoke()
        for f in dataclasses.fields(tcfg):
            assert _field(tcfg, f.name) == _field(jcfg, f.name), f.name
        assert tcfg.layer_kinds() == jcfg.layer_kinds()
        assert tcfg.layer_is_moe() == jcfg.layer_is_moe()
        assert tcfg.param_count() == jcfg.param_count()
        assert tcfg.active_param_count() == jcfg.active_param_count()
    g = get_config(GRANITE)
    assert (g.param_count(), g.active_param_count()) == (3298793472,
                                                        881301504)
    assert get_config(DEEPSEEK).param_count() == 671026279424
    if arch in BIG:
        cfg = get_config(arch)
        assert (cfg.optimizer, cfg.microbatches) == ("adamw_bf16", 2)
        assert cfg.num_heads // cfg.num_kv_heads == \
            {"qwen1_5_110b": 8, "command_r_plus_104b": 12}[arch]


_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _shapes_equal(port, ref, stacked: bool):
    """The port's tree of meta tensors against the reference's
    ``ShapeDtypeStruct`` s (a stacked slot's lead axis stripped)."""
    assert set(port) == set(ref), (sorted(port), sorted(ref))
    for k, v in port.items():
        if isinstance(v, dict):
            _shapes_equal(v, ref[k], stacked)
            continue
        want = tuple(ref[k].shape[1:] if stacked else ref[k].shape)
        assert tuple(v.shape) == want, k
        assert v.dtype == _DT[str(ref[k].dtype)], k


@pytest.mark.parametrize("arch", FAM_ARCHS + BIG)
def test_meta_init_matches_reference_eval_shape(arch):
    """``Model(cfg, device="meta").init()`` at full size: every leaf's
    shape and dtype against ``jax.eval_shape`` of the reference's init
    (within a segment starting at layer s, layer s + g * len(period) + j
    is group g of slot j; deepseek's 3 dense layers, then 58 MoE)."""
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    want = jax.eval_shape(JaxModel(jcfg).init, jax.random.PRNGKey(0))
    got = Model(tcfg, device="meta").init()
    per = len(tcfg.period)
    assert len(got["layers"]) == tcfg.num_layers
    names = [f"segment{i}" for i in range(len(tcfg.segment_layers()))]
    assert set(names) == {k for k in want if k.startswith("segment")}
    i = 0
    for name, n in zip(names, tcfg.segment_layers()):
        for j in range(n):
            ref = want[name][f"slot{j % per}"]
            assert jax.tree.leaves(ref)[0].shape[0] == n // per
            _shapes_equal(got["layers"][i], ref, stacked=True)
            i += 1
    top = {k: v for k, v in got.items() if k not in ("layers", "mtp")}
    _shapes_equal(top, {k: v for k, v in want.items()
                        if k not in names and k != "mtp"}, stacked=False)
    if tcfg.mtp_depth:          # depth 1: the reference's "mtp" module
        mtp, ref = dict(got["mtp"][0]), dict(want["mtp"])
        _shapes_equal(mtp.pop("layer"), ref.pop("layer")["slot0"],
                      stacked=False)
        _shapes_equal(mtp, ref, stacked=False)


def test_bridge_round_trip(fam):
    """from_jax then to_jax gives the reference's tree bit for bit (MoE
    leaves [E, D, F] stacked over groups; jamba's 8-slot period)."""
    jcfg, tcfg, jm, jp, tm, tp = fam
    back = bridge.to_jax(tp, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(_np(jp))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(_np(jp))):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    if tcfg.moe is not None:
        moe = [layer["ffn"] for layer in tp["layers"]
               if "router" in layer.get("ffn", {})]
        assert len(moe) == sum(tcfg.layer_is_moe())
        e = tcfg.moe
        assert moe[0]["w_in"].shape == (e.num_experts, tcfg.d_model,
                                        e.d_expert)
        assert moe[0]["w_out"].shape == (e.num_experts, e.d_expert,
                                         tcfg.d_model)


# ------------------------------------------------------------- the model
def _tokens(cfg, B=2, n=S, seed=3):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                               (B, n)).astype(np.int32)


def test_forward_logits_and_aux_match_reference(fam):
    jcfg, tcfg, jm, jp, tm, tp = fam
    tokens = _tokens(tcfg)
    lj, aj, hj = jm.forward(jp, {"tokens": jnp.asarray(tokens)})
    lt, at, ht = tm.forward(tp, {"tokens": _t(tokens).long()})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=TOL)
    np.testing.assert_allclose(float(at), float(aj), atol=TOL)
    assert (float(aj) > 0) == (tcfg.moe is not None)


def test_prefill_and_decode_match_reference(fam):
    """A prefill (the caches of both kinds, for jamba in one list) and
    six greedy decode steps: logits and caches within 1e-5."""
    jcfg, tcfg, jm, jp, tm, tp = fam
    tokens = _tokens(tcfg)
    cap = S + 8
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, cap)
    lt, ct = tm.prefill(tp, {"tokens": _t(tokens).long()}, cap)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL)

    def caches_close():
        want = bridge.caches_from_jax(_np(cj), tcfg, "cpu")
        assert len(want) == len(ct["layers"]) == tcfg.num_layers
        for w, g in zip(want, ct["layers"]):
            assert set(w) == set(g)
            for name in w:
                np.testing.assert_allclose(g[name].numpy(), w[name].numpy(),
                                           atol=TOL, err_msg=name)

    caches_close()
    tok = np.argmax(np.asarray(lj), -1).astype(np.int32)
    for t in range(6):
        pos = np.full((2,), S + t, np.int32)
        lj, cj = jm.decode_step(jp, cj, jnp.asarray(tok), jnp.asarray(pos))
        lt, ct = tm.decode_step(tp, ct, _t(tok).long(), _t(pos))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL)
        tok = np.argmax(np.asarray(lj), -1).astype(np.int32)
    caches_close()


ROLLOUTS = [(a, "dense", 1) for a in FAM_ARCHS + (CMDR_G12,)] + \
    [(GRANITE, "paged", 2), ("qwen1_5_4b", "paged", 2),
     ("qwen1_5_110b", "paged", 2), (CMDR_G12, "paged", 2)]


@pytest.mark.parametrize("arch,backend,G", ROLLOUTS)
def test_greedy_rollout_matches_reference(arch, backend, G):
    """Greedy rollouts token for token, log-probs within 1e-5; granite at
    capacity factor 1.0, so the prefill drops assignments (and the paged
    fork's decode routes its G * B rows)."""
    jcfg, tcfg = _cfgs(arch)
    if tcfg.moe is not None:
        jcfg, tcfg = _with_moe(jcfg, 1.0), _with_moe(tcfg, 1.0)
    jm, jp, tm, tp = _pair(jcfg, tcfg)
    n = S if backend == "dense" else 13
    prompts = _tokens(tcfg, n=n, seed=4)
    gen = 8 if arch == "jamba_v0_1_52b" else 10
    kw = dict(capacity=n + gen, temperature=0.0, backend=backend,
              page_size=4)
    want = JaxRollout(jm, jcfg, **kw).generate(
        jp, {"tokens": jnp.asarray(prompts)}, gen, jax.random.PRNGKey(0),
        group_size=G)
    got = Rollout(tm, tcfg, **kw).generate(
        tp, {"tokens": _t(prompts).long()}, gen, torch.Generator(),
        group_size=G)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.logp.numpy(), np.asarray(want.logp),
                               atol=TOL)


def _drive(cb):
    reqs = sorted(cb.queue, key=lambda r: r.rid)
    while cb.n_queued or any(r is not None for r in cb.active):
        cb.step()
    return {"tokens": [r.out_tokens for r in reqs], "steps": cb.steps,
            "cache": cb.compile_cache.stats()}


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_granite_batcher_matches_reference(backend):
    """Ragged greedy traffic on 4 slots with decode rungs (2, 4): the rung
    above the live slots decodes idle rows, which route through the MoE
    FFNs and take capacity as in the reference; tokens, steps and
    compile-cache stats equal the JAX batcher's."""
    jcfg, tcfg = (_with_moe(c, 1.0) for c in _cfgs(GRANITE))
    jm, jp, tm, tp = _pair(jcfg, tcfg)
    rng = np.random.RandomState(1)
    traffic = [(rng.randint(0, tcfg.vocab_size,
                            size=int(rng.randint(4, 18))),
                int(rng.randint(3, 12))) for _ in range(6)]
    out = []
    for cls, model, cfg, params in ((JaxBatcher, jm, jcfg, jp),
                                    (ContinuousBatcher, tm, tcfg, tp)):
        kw = dict(cache_backend="paged", page_size=8) \
            if backend == "paged" else {}
        cb = cls(model, cfg, params, slots=4, capacity=32, temperature=0.0,
                 seed=7, capture_buckets=(2, 4), **kw)
        for prompt, gen in traffic:
            cb.submit(prompt, gen)
        out.append(_drive(cb))
    assert out[1] == out[0]
    assert any(len(t) for t in out[1]["tokens"])


def test_jamba_dense_batcher_matches_reference():
    """The dense batcher on jamba's smoke period: each admission copies a
    batch-1 prefill's rows into its slot, the attention layer's K, V and
    positions and the seven Mamba layers' conv and SSM states, in one
    list; greedy tokens and steps equal the JAX batcher's (prompts a
    multiple of the smoke chunk or shorter than it)."""
    jcfg, tcfg = _cfgs("jamba_v0_1_52b")
    jm, jp, tm, tp = _pair(jcfg, tcfg)
    rng = np.random.RandomState(2)
    traffic = [(rng.randint(0, tcfg.vocab_size, size=n), g)
               for n, g in ((32, 5), (16, 7), (32, 4))]
    out = []
    for cls, model, cfg, params in ((JaxBatcher, jm, jcfg, jp),
                                    (ContinuousBatcher, tm, tcfg, tp)):
        cb = cls(model, cfg, params, slots=2, capacity=48, temperature=0.0,
                 seed=7)
        for prompt, gen in traffic:
            cb.submit(prompt, gen)
        out.append(_drive(cb))
    assert out[1]["tokens"] == out[0]["tokens"]
    assert out[1]["steps"] == out[0]["steps"]
    kinds = {frozenset(c) for c in cb.caches["layers"]}
    assert kinds == {frozenset(("k", "v", "pos")),
                     frozenset(("conv_state", "ssm_state"))}


# ------------------------------------------------------------ training
RL_KW = dict(prompt_len=8, gen_len=8, lr=1e-2, critic_lr=1e-2, kl_coef=0.1,
             temperature=0.0, top_k=0, engine="separate")


def test_granite_separate_ppo_step_matches_reference():
    """One greedy f32 separate PPO iteration on granite (actor and critic
    MoE, the load-balance loss added to the actor's): tokens identical,
    metrics within 1e-4, the trained actor within 1e-4."""
    jcfg, tcfg = _cfgs(GRANITE, num_layers=2)
    jtr = JaxRLHFTrainer(jcfg, jcfg, JaxRLHFConfig(**RL_KW),
                         jax.random.PRNGKey(0),
                         reward_fn=jax_target_reward(7))
    a0, c0 = (_np(jtr.actor_state["params"]),
              _np(jtr.critic_state["params"]))
    prompts = np.random.RandomState(2).randint(0, jcfg.vocab_size, (4, 8))
    toks = []
    gen = jtr._gen

    def spy(p, key):
        ro = gen(p, key)
        toks.append(np.asarray(ro.tokens))
        return ro

    jtr._gen = spy
    want = {k: float(v) for k, v in
            jtr.train_step(jnp.asarray(prompts), jax.random.PRNGKey(0))
            .items()}
    tr = bridge.separate_trainer_from_jax(
        a0, c0, tcfg, tcfg, RLHFConfig(**RL_KW),
        reward_fn=make_target_token_reward(7), device="cpu")
    got_toks = []
    tgen = tr._gen
    tr._gen = lambda p, g: got_toks.append(tgen(p, g)) or got_toks[-1]
    got = tr.train_step(torch.from_numpy(prompts).long(),
                        torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got_toks[0].tokens.numpy(), toks[0])
    for k in ("loss", "ppo_loss", "kl", "vf_loss", "grad_norm",
              "mean_reward"):
        assert got[k] == pytest.approx(want[k], abs=TOL_PPO), k
    _adam_close(tr.actor_state, _np(jtr.actor_state), tcfg, RL_KW["lr"])


def _adam_close(state, jstate, cfg, lr):
    """A port train state after one AdamW update against the reference's:
    the moments within 1e-5, each param within 1e-4 plus what the
    measured difference of the moments moves it (lr times the difference
    of the two step directions; where a gradient is near AdamW's eps a
    last-bit difference moves a param ~lr: ``tests/test_torch_separate.py::
    _adam_check``)."""
    assert state["opt"]["count"] == int(jstate["opt"]["count"]) == 1

    def tree(t):
        return [np.asarray(x, np.float64) for x in jax.tree.leaves(t)]

    mu, nu, p = (tree(bridge.to_jax(t, cfg)) for t in
                 (state["opt"]["mu"], state["opt"]["nu"], state["params"]))
    jmu, jnu, jp = (tree(jstate[k]) if k == "params" else
                    tree(jstate["opt"][k]) for k in ("mu", "nu", "params"))

    def direction(m, v):          # m^ / (sqrt(v^) + eps) after one step
        return (m / 0.1) / (np.sqrt(v / 0.05) + 1e-8)

    for x, y in zip(mu + nu, jmu + jnu):
        np.testing.assert_allclose(x, y, atol=1e-5)
    for x, y, m, v, jm, jv in zip(p, jp, mu, nu, jmu, jnu):
        slack = lr * np.abs(direction(m, v) - direction(jm, jv))
        assert not (np.abs(x - y) > TOL_PPO + slack).any()


@pytest.mark.parametrize("arch", FAM_ARCHS)
def test_hydra_and_tp_refuse_what_the_reference_refuses(arch):
    """The hydra engine covers attention-only dense-FFN trunks in both
    packages: granite (MoE), jamba (Mamba, MoE) and deepseek (MLA, MoE)
    are refused, qwen is taken. Under TP an MLA config raises naming
    ROADMAP A10c 7, an MoE one A10c 4; qwen's heads divide 2."""
    jcfg, tcfg = _cfgs(arch)
    refused = arch != "qwen1_5_4b"
    if refused:
        with pytest.raises(AssertionError):
            JaxModelEngine(jcfg, jax.random.PRNGKey(0), rank=4)
        with pytest.raises(ValueError, match="hydra engine"):
            ModelEngine(tcfg, torch.Generator(), rank=4)
        with pytest.raises(ValueError, match="hydra engine"):
            RLHFTrainer(tcfg, tcfg, RLHFConfig(**dict(RL_KW,
                                                      engine="hydra")),
                        torch.Generator())
    else:
        eng = ModelEngine(tcfg, torch.Generator().manual_seed(0), rank=4)
        assert len(list(leaves(eng.adapters["actor"]))) > 0
    if MLA in tcfg.period:
        with pytest.raises(NotImplementedError, match="MLA.*A10c 7"):
            TP.check_supported(tcfg, 2)
    elif tcfg.moe is not None:
        with pytest.raises(NotImplementedError, match="MoE.*A10c 4"):
            TP.check_supported(tcfg, 2)
    else:
        TP.check_supported(tcfg, 2)


@pytest.mark.parametrize("arch", [GRANITE, "jamba_v0_1_52b", DEEPSEEK])
def test_simulator_traces_moe_and_hybrid_phases(arch):
    """The memory simulator's phase programs (``core.build_rlhf_phases``)
    trace the MoE FFN (and jamba's Mamba layers, deepseek's MLA layers
    and Adafactor step) on ``meta``: eight phases, each with a peak; the
    actor's persistent bytes are its bf16 tree's (the fp32 routers
    included). Deepseek's MLA runs at its own head widths, 192 / 128 (the
    smoke config's 48 / 32 are no pair the kernels take)."""
    from repro_torch.core import build_rlhf_phases
    cfg = get_config(arch).smoke()
    if arch == DEEPSEEK:
        cfg = dataclasses.replace(cfg, optimizer="adafactor", mla=MLAConfig(
            q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=128,
            qk_rope_head_dim=64, v_head_dim=128))
    phases, per = build_rlhf_phases(cfg, cfg, batch=2, prompt_len=16,
                                    gen_len=8)
    assert [p.name for p in phases][-2:] == ["train_actor", "train_critic"]
    assert all(p.trace.peak_live() > 0 for p in phases)
    tree = Model(dataclasses.replace(cfg, param_dtype="bfloat16"),
                 device="meta").init()
    assert sum(n for n, _ in per.buffers["actor_params"]) == sum(
        t.numel() * t.element_size() for t in leaves(tree))
    assert any(t.dtype == torch.float32 for t in leaves(tree))


@pytest.mark.parametrize("kw,item", [
    (dict(period=("mla",), mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                                         qk_nope_head_dim=32,
                                         qk_rope_head_dim=16, v_head_dim=32)),
     "MLA layers.*A10c 7"),
    (dict(input_mode="encdec", encoder_layers=2),
     "encoder-decoder.*A10c 8"),
    (dict(input_mode="embeddings", num_prefix_embeddings=8),
     "prefix embeddings.*A10c 8")])
def test_model_refusal_names_what_is_unported(kw, item):
    """What the port does not run yet is refused by name, with its ROADMAP
    item: MLA layers, an encoder-decoder and prefix embeddings, which the
    ``Model`` runs, under tensor parallelism."""
    cfg = dataclasses.replace(get_config("llama3_2_3b").smoke(), **kw)
    with pytest.raises(NotImplementedError, match=item):
        Model(cfg, device="cpu")
        TP.check_supported(cfg, 2)


# ------------------------------------- chip_smoke.py phase 17's reckonings
@pytest.fixture
def card_counts(monkeypatch):
    """The kernels' wrappers stood in for by their plain versions and
    every tensor taken for a card's, so a CPU run counts the launches the
    card's would (``tests/test_torch_serving.py::
    test_phase14_schedule_and_launch_reckoning``); -> chip_smoke."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.kernels import ops, ref

    monkeypatch.setattr(ops, "_on_cpu", lambda t: False)
    monkeypatch.setattr(ops._fa, "flash_attention_fwd",
                        lambda q, k, v, **kw: ref.attention_ref(q, k, v, **kw))
    monkeypatch.setattr(ops._fab, "flash_attention_bwd",
                        ref.flash_attention_bwd_ref)
    monkeypatch.setattr(ops._dec, "decode_attention",
                        ref.decode_attention_ref)
    monkeypatch.setattr(ops._pa, "paged_decode_attention",
                        ref.paged_attention_ref)
    monkeypatch.setattr(ops._rn, "rmsnorm", ref.rmsnorm_ref)
    monkeypatch.setattr(ops._rn, "rmsnorm_bwd",
                        lambda x, s, dy, eps, dscale=True:
                        ref.rmsnorm_bwd_ref(x, s, dy, eps))
    monkeypatch.setattr(ops._ssd, "ssd_scan",
                        lambda x, a, b, c, chunk: ref.ssd_scan_ref(
                            x, a, b, c, chunk))
    for name, value in (("BATCH", 2), ("PROMPT", 32), ("GEN", 4),
                        ("FAM_REQUESTS", 2)):
        monkeypatch.setattr(chip_smoke, name, value)
    return chip_smoke


@pytest.mark.parametrize("arch", ARCHS)
def test_phase17_serving_launch_reckoning(card_counts, arch):
    """``family_serving`` (serve.run and ``serve_launches``) at a tiny
    shape: B2 and B3 on the attention layers, B5 on jamba's seven Mamba
    layers, B1 at every norm1, Mamba gated norm and norm2 (MoE or
    dense)."""
    chip_smoke = card_counts
    cfg = get_config(arch).smoke()
    out = chip_smoke.family_serving(cfg, torch.device("cpu"), print)
    want = {"jamba_v0_1_52b": (1, 7, 7 * 3 + 2 + 1)}.get(arch, (2, 0, 5))
    attn, mamba, norms = want
    assert out["launches"]["ssd_scan"] == mamba * 2
    assert out["launches"]["flash_attention"] == attn * 2
    assert out["launches"]["rmsnorm"] == norms * 4 * 2


def test_phase17_granite_paged_and_batcher_reckoning(card_counts):
    """Granite's paged group rollout and a paged batcher drain of phase
    17's traffic on the CPU: launches as ``step_norms`` and
    ``batcher_launches`` reckon them (every MoE layer's norm2)."""
    chip_smoke = card_counts
    from repro_torch.kernels import ops
    cfg = dataclasses.replace(get_config(GRANITE).smoke(), d_model=64,
                              num_heads=2, num_kv_heads=1, head_dim=32,
                              vocab_size=128)
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    ro = Rollout(model, cfg, capacity=24, backend="paged", page_size=4,
                 temperature=0.8, top_k=5)
    ops.reset_launches()
    ro.generate(params, {"tokens": torch.randint(0, 128, (2, 13))}, 6,
                torch.Generator().manual_seed(1), group_size=3)
    L = cfg.num_layers
    assert dict(ops.launches) == dict(
        {k: 0 for k in ops.KERNELS}, flash_attention=L,
        paged_decode_attention=L * 5,
        rmsnorm=chip_smoke.step_norms(cfg) * 6 + 1)
    traffic = chip_smoke.batcher_traffic(cfg.vocab_size, "mixed", seed=0,
                                         n=chip_smoke.FAM_CB_REQUESTS)
    rec = chip_smoke.serve_batcher(
        model, cfg, params, dict(cache_backend="paged",
                                 page_size=chip_smoke.CB_PAGE),
        traffic, False, torch.device("cpu"))
    chip_smoke._check_batcher_run("granite", rec, print)


@pytest.mark.parametrize("arch", [GRANITE, "jamba_v0_1_52b"])
def test_phase17_separate_launch_reckoning(card_counts, arch):
    """One separate PPO iteration with the critic shallower than the
    actor (phase 17 (f)'s shape of cut), remat "full", the reward model
    scoring: launches as ``ppo_launches`` reckons them, jamba's Mamba
    gated norms and their backward included."""
    chip_smoke = card_counts
    from repro_torch.kernels import ops
    actor = dataclasses.replace(get_config(arch).smoke(), remat="full",
                                vocab_size=64)
    layers = 4 if arch == GRANITE else 8
    actor = dataclasses.replace(actor, num_layers=layers)
    critic = dataclasses.replace(actor, num_layers=layers // 2)
    rl = RLHFConfig(**{**RL_KW, "gen_len": 4, "prompt_len": 28})
    tr = RLHFTrainer(actor, critic, rl, torch.Generator().manual_seed(0))
    ops.reset_launches()
    tr.train_step(torch.randint(0, 64, (2, 28)), torch.Generator())
    assert dict(ops.launches) == chip_smoke.ppo_launches(
        actor, rl, True, critic_cfg=critic)


# ------------------------------------- chip_smoke.py phase 19's reckonings
def test_phase19_paths_train_and_blocked_update_reckoning(card_counts,
                                                          monkeypatch):
    """Phase 19's functions at a tiny shape on the G 12 smoke model
    (command-r's, 12 query heads over 1 KV head): serving graphed and
    eager (the CPU captures nothing), the paged GRPO request, the dense
    and paged batcher drains (``serve_launches``, ``batcher_launches``),
    one adamw_bf16 train step at 2 microbatches (``train_launches``, the
    optimizer's bytes 4 a parameter) and the blocked update against one
    whole-leaf block."""
    chip_smoke = card_counts
    for name, value in (("GROUPS", 2), ("GPROMPT", 13), ("GSIZE", 3),
                        ("BIG_TBATCH", 4), ("BIG_TSEQ", 16),
                        ("BIG_CB_REQUESTS", 3)):
        monkeypatch.setattr(chip_smoke, name, value)
    cfg = dataclasses.replace(chip_smoke.g12_smoke_cfg(), vocab_size=128,
                              microbatches=2)
    assert cfg.num_heads // cfg.num_kv_heads == 12
    cpu = torch.device("cpu")
    out = chip_smoke.big_paths(cfg, cpu, print, "", "g12", batcher=True)
    L = cfg.num_layers
    assert out["launches"]["decode_attention"] == L * 3 * 2
    assert out["paged_grpo"]["launches"]["paged_decode_attention"] == L * 3
    assert set(out["batcher"]) == {"dense", "paged"}
    assert out["batcher"]["paged"]["launches"]["paged_decode_attention"] > 0
    tr = chip_smoke.big_train(cfg, cpu, print, "", "g12 train")
    assert tr["opt_bytes"] == 4 * tr["params"]
    assert tr["launches"]["flash_attention_bwd"] == L * 2
    from repro_torch.optim import adamw as ADAMW
    monkeypatch.setattr(ADAMW, "BLOCK_ELEMS", 1000)
    bl = chip_smoke.blocked_update_bits(cpu, print, "", shape=(64, 48))
    assert bl["same_bits"] and bl["blocks"] == 4
