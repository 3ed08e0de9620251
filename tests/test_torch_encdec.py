"""The port's prefix-embedding and encoder-decoder inputs against the JAX
reference on the CPU: ``internvl2_2b`` (``input_mode="embeddings"``: patch
embeddings before the tokens) and ``seamless_m4t_large_v2``
(``input_mode="encdec"``: a bidirectional encoder over frame embeddings,
cross-attention in every decoder layer, an ungated FFN).

f32 smoke configs (2 decoder layers; seamless's 2 encoder layers over 16
frames, internvl's 8 prefix embeddings); weights from the reference's
init (``bridge.from_jax``), random qkv-free; inputs from numpy seeds, the
embeddings scaled by 0.01 as the reference's own tests scale them.
Tolerances: 1e-5 on logits, values and caches
(``tests/test_kernel_model_paths.py``), 1e-4 on a train step's metrics
and params (``tests/test_torch_separate.py``), greedy tokens identical.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.rlhf import Rollout as JaxRollout  # noqa: E402
from repro.steps import init_lora_train_state as jax_init_lora  # noqa: E402
from repro.steps import make_lora_train_step as jax_lora_step  # noqa: E402
from repro.steps import make_train_step as jax_train_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import steps as TS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.rlhf import GRPOConfig, GRPOTrainer, RLHFConfig, \
    RLHFTrainer, Rollout  # noqa: E402
from repro_torch.serving import ContinuousBatcher  # noqa: E402
from repro_torch.sharding import tp as TP  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

VLM = "internvl2_2b"
AUDIO = "seamless_m4t_large_v2"
ARCHS = (VLM, AUDIO)
TOL = 1e-5
TOL_STEP = 1e-4
B, S, SE = 2, 12, 16     # batch, tokens, seamless's frames
# the reference's param_count leaves out the decoder's cross-attention
# blocks, their norm_x and the encoder_norm (seamless_m4t_large_v2)
SEAMLESS_UNDERCOUNT = 100_688_896


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


def _cfgs(arch):
    return (dataclasses.replace(jax_get_config(arch).smoke(),
                                param_dtype="float32"),
            dataclasses.replace(get_config(arch).smoke(),
                                param_dtype="float32"))


def _inputs(cfg, seed, batch=B, train=False):
    """A numpy batch: tokens and the config's embeddings (prefix or
    frames, 0.01 x a normal draw); with ``train``, the PPO and critic
    fields."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, S))
           .astype(np.int32)}
    if cfg.input_mode == "embeddings":
        out["prefix_embeds"] = 0.01 * rng.standard_normal(
            (batch, cfg.num_prefix_embeddings, cfg.d_model), np.float32)
    else:
        out["frame_embeds"] = 0.01 * rng.standard_normal(
            (batch, SE, cfg.d_model), np.float32)
    if train:
        out.update(loss_mask=np.ones((batch, S), np.float32),
                   advantages=rng.standard_normal((batch, S), np.float32),
                   old_logp=np.full((batch, S), -6.0, np.float32),
                   ref_logp=np.full((batch, S), -6.2, np.float32),
                   returns=rng.standard_normal((batch, S), np.float32))
    return out


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: _t(v).long() if k == "tokens" else _t(v)
            for k, v in batch.items()}


def _prefix(cfg):
    return cfg.num_prefix_embeddings if cfg.input_mode == "embeddings" else 0


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jcfg, tcfg, JAX model, its params, port model, its params) with a
    value head on both."""
    jcfg, tcfg = _cfgs(request.param)
    jm = JaxModel(jcfg, with_value=True)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(tcfg, device="cpu", with_value=True)
    return jcfg, tcfg, jm, jp, tm, bridge.from_jax(_np(jp), tcfg, "cpu")


# ------------------------------------------------------------- configs
def _field(cfg, name):
    v = getattr(cfg, name)
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_counts_match_reference(arch):
    """Every field of the port's config and ``param_count``, at full size
    and smoke; seamless's count is the reference's, 100,688,896 below
    its real tree (the cross-attention blocks, their ``norm_x`` and the
    ``encoder_norm`` are left out), internvl's is its tree's."""
    for full in (True, False):
        jcfg, tcfg = jax_get_config(arch), get_config(arch)
        if not full:
            jcfg, tcfg = jcfg.smoke(), tcfg.smoke()
        for f in dataclasses.fields(tcfg):
            assert _field(tcfg, f.name) == _field(jcfg, f.name), f.name
        assert tcfg.param_count() == jcfg.param_count()
    cfg = get_config(arch)
    tree = sum(t.numel() for t in leaves(Model(cfg, device="meta").init()))
    if arch == AUDIO:
        assert (cfg.param_count(), tree) == (1_531_442_176, 1_632_131_072)
        d, L = cfg.d_model, cfg.num_layers
        cross = 4 * d * d + d            # wq wk wv wo, norm_x
        assert tree - cfg.param_count() == SEAMLESS_UNDERCOUNT == \
            L * cross + d
    else:
        assert cfg.param_count() == tree == 1_889_146_880


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_init_matches_reference_eval_shape(arch):
    """``Model(cfg, device="meta").init()`` at full size against
    ``jax.eval_shape`` of the reference's init: the decoder layers (with
    ``norm_x`` and ``cross`` on seamless's), the encoder list against the
    stacked ``encoder`` segment, the top-level groups."""
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    want = jax.eval_shape(JaxModel(jcfg).init, jax.random.PRNGKey(0))
    got = Model(tcfg, device="meta").init()

    def same(port, ref, stacked):
        assert set(port) == set(ref), (sorted(port), sorted(ref))
        for k, v in port.items():
            if isinstance(v, dict):
                same(v, ref[k], stacked)
                continue
            shape = ref[k].shape[1:] if stacked else ref[k].shape
            assert tuple(v.shape) == tuple(shape), k
            assert str(v.dtype).endswith(str(ref[k].dtype)), k

    for layer in got["layers"]:
        same(layer, want["segment0"]["slot0"], True)
        assert ("cross" in layer) == (arch == AUDIO)
    if arch == AUDIO:
        assert len(got["encoder"]) == tcfg.encoder_layers == 24
        for layer in got["encoder"]:
            same(layer, want["encoder"]["slot0"], True)
    top = {k: v for k, v in got.items() if k not in ("layers", "encoder")}
    same(top, {k: v for k, v in want.items()
               if k not in ("segment0", "encoder")}, False)


def test_bridge_round_trip(pair):
    """from_jax then to_jax gives the reference's tree bit for bit (the
    stacked encoder segment, ``encoder_norm``, ``norm_x`` and ``cross``)."""
    jcfg, tcfg, jm, jp, tm, tp = pair
    back = bridge.to_jax(tp, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(_np(jp))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(_np(jp))):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# ------------------------------------------------------------- forward
def test_forward_and_value_match_reference(pair):
    """``forward`` (logits [B, P+S, V] with internvl's prefix, the final
    hidden state) and ``forward_value`` within 1e-5."""
    jcfg, tcfg, jm, jp, tm, tp = pair
    batch = _inputs(tcfg, 1)
    lj, _, hj = jm.forward(jp, _jb(batch))
    lt, _, ht = tm.forward(tp, _tb(batch))
    assert lt.shape == (B, _prefix(tcfg) + S, tcfg.vocab_size)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=TOL)
    vj = jm.forward_value(jp, _jb(batch))
    vt = tm.forward_value(tp, _tb(batch))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=TOL)


def test_prefill_and_decode_match_reference(pair):
    """A prefill (logits, the self-attention caches and seamless's cross
    K/V through ``bridge.caches_from_jax`` / ``cross_kv_from_jax``) and
    three greedy decode steps at the prefix-offset positions: logits and
    caches within 1e-5."""
    jcfg, tcfg, jm, jp, tm, tp = pair
    batch = _inputs(tcfg, 2)
    P = _prefix(tcfg)
    cap = P + S + 4
    lj, cj = jm.prefill(jp, _jb(batch), cap)
    lt, ct = tm.prefill(tp, _tb(batch), cap)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL)

    def caches_close():
        want = bridge.caches_from_jax(_np(cj), tcfg, "cpu")
        for w, g in zip(want, ct["layers"]):
            for name in ("k", "v", "pos"):
                np.testing.assert_allclose(g[name].numpy(), w[name].numpy(),
                                           atol=TOL, err_msg=name)
        if tcfg.input_mode != "encdec":
            assert ct["cross_kv"] is None and cj["cross_kv"] is None
            return
        cw = bridge.cross_kv_from_jax(_np(cj), tcfg, "cpu")
        assert len(cw) == len(ct["cross_kv"]) == tcfg.num_layers
        for w, g in zip(cw, ct["cross_kv"]):
            assert set(w) == set(g) == {"k", "v"}
            for name in w:
                np.testing.assert_allclose(g[name].numpy(), w[name].numpy(),
                                           atol=TOL, err_msg=name)

    caches_close()
    tok = np.argmax(np.asarray(lj), -1).astype(np.int32)
    for t in range(3):
        pos = np.full((B,), P + S + t, np.int32)
        lj, cj = jm.decode_step(jp, cj, jnp.asarray(tok), jnp.asarray(pos))
        lt, ct = tm.decode_step(tp, ct, _t(tok).long(), _t(pos))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL)
        tok = np.argmax(np.asarray(lj), -1).astype(np.int32)
    caches_close()


def test_greedy_rollout_matches_reference(pair):
    """A greedy dense ``Rollout.generate`` with the embeddings in the
    batch, token for token and log-probs within 1e-5, and the caches and
    cross K/V released by ``_finalize``."""
    jcfg, tcfg, jm, jp, tm, tp = pair
    batch = _inputs(tcfg, 3)
    n = 6
    cap = _prefix(tcfg) + S + n
    jr = JaxRollout(jm, jcfg, capacity=cap, temperature=0.0).generate(
        jp, _jb(batch), n, jax.random.PRNGKey(0))
    ro = Rollout(tm, tcfg, capacity=cap, temperature=0.0)
    seen = []
    prefill = tm.prefill

    def spy(*a, **k):
        out = prefill(*a, **k)
        seen.append(out[1])
        return out

    tm.prefill = spy
    try:
        tr = ro.generate(tp, _tb(batch), n, torch.Generator())
    finally:
        del tm.prefill
    np.testing.assert_array_equal(tr.tokens.numpy(), np.asarray(jr.tokens))
    np.testing.assert_allclose(tr.logp.numpy(), np.asarray(jr.logp),
                               atol=TOL)
    assert ro.decode_stats["steps"] == n - 1
    assert seen[0]["layers"] == [] and not seen[0]["cross_kv"]


# ------------------------------------------------------------ training
def _adam_close(state, jstate, cfg, lr):
    """A port train state after one AdamW step against the reference's,
    leaf by leaf (the encoder's included): the moments within 1e-5, each
    param within 1e-4 plus what the measured difference of the moments
    moves it (``tests/test_torch_families.py::_adam_close``)."""
    def tree(t):
        return [np.asarray(x, np.float64) for x in jax.tree.leaves(t)]

    mu, nu, p = (tree(bridge.to_jax(t, cfg)) for t in
                 (state["opt"]["mu"], state["opt"]["nu"], state["params"]))
    jmu, jnu, jp = (tree(jstate[k]) if k == "params" else
                    tree(jstate["opt"][k]) for k in ("mu", "nu", "params"))
    assert len(p) == len(jp)

    def direction(m, v):          # m^ / (sqrt(v^) + eps) after one step
        return (m / 0.1) / (np.sqrt(v / 0.05) + 1e-8)

    for x, y in zip(mu + nu, jmu + jnu):
        np.testing.assert_allclose(x, y, atol=1e-5)
    for x, y, m, v, jm, jv in zip(p, jp, mu, nu, jmu, jnu):
        slack = lr * np.abs(direction(m, v) - direction(jm, jv))
        assert not (np.abs(x - y) > TOL_STEP + slack).any()


@pytest.mark.parametrize("kind", ("ppo", "critic"))
def test_train_step_matches_reference(pair, kind):
    """One ``make_train_step`` step of ``kind`` (the logits' and values'
    prefix sliced off on internvl; the encoder trained through every
    layer's cross K/V on seamless): loss and grad norm within 1e-4, the
    AdamW moments and every leaf, the encoder's included."""
    jcfg, tcfg, jm, jp, tm, tp = pair
    lr = 1e-3
    batch = _inputs(tcfg, 4, train=True)
    jstep = jax_train_step(jm, jcfg, kind=kind, lr=lr)
    jstate = {"params": jp, "opt": jstep.optimizer.init(jp),
              "step": jnp.zeros((), jnp.int32)}
    jstate, jmet = jax.jit(jstep)(jstate, _jb(batch))
    step = TS.make_train_step(tm, tcfg, kind=kind, lr=lr)
    params = bridge.from_jax(_np(jp), tcfg, "cpu")
    state = TS.init_train_state(tm, tcfg, None, step.optimizer,
                                params=params)
    state, met = step(state, _tb(batch))
    for k in ("loss", "grad_norm"):
        assert float(met[k]) == pytest.approx(float(jmet[k]),
                                              abs=TOL_STEP), k
    _adam_close(state, _np(jstate), tcfg, lr)
    if tcfg.input_mode == "encdec":
        moved = [not torch.equal(a, b) for a, b in
                 zip(leaves(state["params"]["encoder"]),
                     leaves(bridge.from_jax(_np(jp), tcfg, "cpu")["encoder"]))]
        assert all(moved)


def test_lora_train_step_with_prefix_matches_reference():
    """internvl's hydra-style LoRA ppo step (``make_lora_train_step``)
    with its prefix sliced off the logits: loss, grad norm and the
    adapter's leaves within 1e-4 of the reference's."""
    jcfg, tcfg = _cfgs(VLM)
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    jad = jm.init_adapter(jax.random.PRNGKey(2), jp, 4)
    # B nonzero, so that the adapter moves the forward
    jad = jax.tree.map(lambda x: x + 0.01, jad)
    batch = _inputs(tcfg, 5, train=True)
    jstep = jax_lora_step(jm, jcfg, kind="ppo", lr=1e-3)
    jstate = jax_init_lora(jad, jstep.optimizer)
    jstate, jmet = jax.jit(jstep)(jstate, jp, _jb(batch))
    tm = Model(tcfg, device="cpu")
    step = TS.make_lora_train_step(tm, tcfg, kind="ppo", lr=1e-3)
    state = TS.init_lora_train_state(
        bridge.adapter_from_jax(_np(jad), tcfg, "cpu"), step.optimizer)
    state, met = step(state, bridge.from_jax(_np(jp), tcfg, "cpu"),
                      _tb(batch))
    for k in ("loss", "grad_norm"):
        assert float(met[k]) == pytest.approx(float(jmet[k]),
                                              abs=TOL_STEP), k
    got = bridge.adapter_to_jax(state["params"], tcfg)
    for a, b in zip(jax.tree.leaves(got),
                    jax.tree.leaves(_np(jstate["params"]))):
        np.testing.assert_allclose(a, b, atol=TOL_STEP)


# ----------------------------------------------------------- refusals
@pytest.mark.parametrize("arch", ARCHS)
def test_refusals_name_what_is_refused(arch):
    """What the reference refuses or fails on raises by name: the paged
    backend, spec decode, ``capture_buckets``, a lengths-masked prefill,
    ``group_size`` > 1; both trainer engines, GRPO, the batcher and
    ``serve.run`` (token batches only); tensor parallelism (A10c 8)."""
    from repro_torch.launch import serve
    _, tcfg = _cfgs(arch)
    tm = Model(tcfg, device="cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    mode = tcfg.input_mode
    for kw, what in ((dict(backend="paged"),
                      "paged rollout needs an attention-only token"),
                     (dict(spec_decode=True), "spec decode needs a token"),
                     (dict(capture_buckets=(16,)), "capture_buckets")):
        with pytest.raises(ValueError, match=what + ".*" + mode):
            Rollout(tm, tcfg, capacity=64, **kw)
    batch = _tb(_inputs(tcfg, 6))
    with pytest.raises(ValueError, match="lengths-masked.*token inputs"):
        tm.prefill(tp, batch, 64, lengths=torch.full((B,), S))
    with pytest.raises(ValueError, match="group_size 2 with input_mode"):
        Rollout(tm, tcfg, capacity=64).generate(tp, batch, 2,
                                                torch.Generator(),
                                                group_size=2)
    for engine in ("separate", "hydra"):
        with pytest.raises(ValueError, match=f"RLHFTrainer \\({engine} "
                           f"engine\\) builds token-only.*{mode}"):
            RLHFTrainer(tcfg, tcfg, RLHFConfig(engine=engine),
                        torch.Generator())
    with pytest.raises(ValueError, match="GRPOTrainer builds token-only"):
        GRPOTrainer(tcfg, GRPOConfig(), torch.Generator(), lambda t, m: t)
    with pytest.raises(ValueError, match="ContinuousBatcher builds"):
        ContinuousBatcher(tm, tcfg, tp, warmup=False)
    with pytest.raises(ValueError, match="serve.run builds token-only"):
        serve.run(tcfg, batch=1, prompt_len=4, gen=2, requests=1,
                  device="cpu")
    what = {"encdec": "encoder-decoder", "embeddings": "prefix embeddings"}
    with pytest.raises(NotImplementedError,
                       match=what[mode] + ".*A10c 8"):
        TP.check_supported(tcfg, 2)
    TP.check_supported(tcfg, 1)


# ------------------------------------- chip_smoke.py phase 20's reckonings
@pytest.fixture
def card_counts(monkeypatch):
    """The kernels' wrappers stood in for by their plain versions and
    every tensor taken for a card's, so a CPU run counts the launches the
    card's would (``tests/test_torch_families.py::card_counts``), at a
    tiny shape; -> chip_smoke."""
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
    monkeypatch.setattr(ops._rn, "rmsnorm", ref.rmsnorm_ref)
    monkeypatch.setattr(ops._rn, "rmsnorm_bwd",
                        lambda x, s, dy, eps, dscale=True:
                        ref.rmsnorm_bwd_ref(x, s, dy, eps))
    for name, value in (("BATCH", 2), ("PROMPT", 8), ("GEN", 3),
                        ("FAM_REQUESTS", 2), ("EMB_TBATCH", 2)):
        monkeypatch.setattr(chip_smoke, name, value)
    return chip_smoke


@pytest.mark.parametrize("arch", ARCHS)
def test_phase20_paths_and_train_reckoning(card_counts, arch):
    """Phase 20's functions at a tiny shape on the smoke configs (remat
    "full" for the train step): the dense rollout calls graphed and eager
    (the CPU captures nothing; ``emb_serve_launches``: seamless's encoder
    and cross-attention B2, at the prefill and every decode step), the live
    bytes and cross K/V checks, two ppo train steps
    (``emb_train_launches``: the encoder's and the cross-attention's
    checkpointed B2, B2-bwd, B1 and B1-bwd) with the encoder's leaves
    moved."""
    chip_smoke = card_counts
    cfg = dataclasses.replace(get_config(arch).smoke(), vocab_size=64)
    cpu = torch.device("cpu")
    out = chip_smoke.emb_paths(cfg, cpu, print, "", arch)
    L, E = cfg.num_layers, cfg.encoder_layers
    cross = cfg.input_mode == "encdec"
    assert out["launches"]["flash_attention"] == \
        (L + E + cross * L * 3) * 2
    assert out["launches"]["decode_attention"] == L * 2 * 2
    assert out["launches"]["rmsnorm"] == \
        ((2 * L + 1 + cross * L) * 3 + (2 * E + 1 if cross else 0)) * 2
    assert out["cross_kv_bytes"] == (L * 2 * 2 * 8 * 4 * 64 * 4 if cross
                                     else 0)
    tr = chip_smoke.emb_train(dataclasses.replace(cfg, remat="full"), cpu,
                              print, "", f"{arch} train")
    assert tr["launches"]["flash_attention"] == (L + E + cross * L) * 2
    assert tr["launches"]["flash_attention_bwd"] == L + E + cross * L
    n = 2 * L + 1 + cross * L
    enc = 2 * E + 1 if cross else 0
    assert tr["launches"]["rmsnorm"] == n + n - 1 + enc + 2 * E
    assert tr["launches"]["rmsnorm_bwd"] == n + enc
    assert tr["moved"] == tr["probes"]
    if cross:
        assert tr["moved_encoder"] == 4 * E + 2 * E
