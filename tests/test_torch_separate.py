"""The port's separate engine against the JAX reference on the CPU: the
paper's model configs, ``Model(with_value=True)``, the full-parameter
train step (ppo, critic, lm; one and two microbatches),
``ModelEngine.memory_accounting``, and the whole slice — two greedy f32
four-model PPO iterations from the reference trainer's own initial
weights, an actor and a critic of different widths.

Both models have the paper pair's shape, cut small: MHA with qkv biases, a
non-gated GELU MLP and tied embeddings. Inputs are made with numpy from a
seed (or carried across with ``repro_torch.bridge``) and go through both
packages. Tolerances: 1e-5 for one forward; 1e-4 for a train step's
metrics and for whole-iteration quantities (f32 sums in another order).
AdamW's moments are held to the reference's directly; each updated leaf
to 1e-4 plus what the measured difference of the moments moves it through
AdamW (:func:`_adam_check`). Greedy tokens must be identical; the frozen
reference and reward models must not move a bit.
"""
import dataclasses
import pathlib
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import steps as JS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.rlhf import RLHFConfig as JaxRLHFConfig  # noqa: E402
from repro.rlhf import RLHFTrainer as JaxRLHFTrainer  # noqa: E402
from repro.rlhf.engine import ModelEngine as JaxModelEngine  # noqa: E402
from repro.rlhf.reward import \
    make_target_token_reward as jax_target_reward  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import steps as TS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import RUNTIME_RLHF_PHASE_SEQUENCE  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.rlhf import ModelEngine, RLHFConfig, RLHFTrainer  # noqa: E402
from repro_torch.rlhf.reward import make_target_token_reward  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

TOL = 1e-4
# the paper pair's shape cut small: MHA, qkv biases, a GELU MLP, tied
# embeddings (``opt_1_3b``); the actor twice the critic's width. The step
# and the value model also run the hydra slice's shape (``llama3_2_3b``:
# GQA, no biases, SwiGLU, an untied head).
SMALL = dict(num_layers=2, vocab_size=64, num_heads=4, head_dim=16)
ARCHS = {"opt_1_3b": dict(num_kv_heads=4), "llama3_2_3b": dict(num_kv_heads=2)}
PAPER = ("opt_1_3b", "opt_350m", "gpt2_xl", "gpt2_medium", "opt_6_7b",
         "llama2_7b")


def small_cfgs(d_model=128, arch="opt_1_3b", **kw):
    kw = {**SMALL, **ARCHS[arch], "d_model": d_model, "d_ff": 2 * d_model,
          **kw}
    return (dataclasses.replace(jax_get_config(arch).smoke(), **kw),
            dataclasses.replace(get_config(arch).smoke(), **kw))


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x).copy(), tree)


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol, rtol=0)


def _with_biases(jparams, seed):
    """``jparams`` with random qkv biases (the reference initialises them
    to zero), so a forward adds them."""
    rng = np.random.default_rng(seed)

    def fill(path, x):
        if jax.tree_util.keystr(path[-1:]) in ("['bq']", "['bk']", "['bv']"):
            return jnp.asarray(0.1 * rng.standard_normal(x.shape), x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(fill, jparams)


def _params_close(port_params, jax_params, cfg, atol):
    """Leaf for leaf, the port's tree carried to the reference's layout."""
    got = bridge.to_jax(port_params, cfg)
    assert jax.tree.structure(got) == jax.tree.structure(_np(jax_params))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jax_params)):
        assert a.shape == np.shape(b) and a.dtype == np.asarray(b).dtype
        _close(a, b, atol)


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("name", PAPER)
def test_paper_configs_match_reference(name):
    """The port's copy of ``configs/paper_models.py`` registers each of the
    paper's models under its name, equal to the reference's in every
    field the port's ``ModelConfig`` has."""
    got, want = get_config(name), jax_get_config(name)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.smoke().d_model == want.smoke().d_model


# -------------------------------------------------------- the value model
@pytest.fixture(scope="module", params=list(ARCHS))
def value_setup(request):
    jcfg, tcfg = small_cfgs(64, request.param)
    jmodel = JaxModel(jcfg, with_value=True)
    jparams = _with_biases(jmodel.init(jax.random.PRNGKey(0)), 1)
    # a nonzero value-head bias, so the bias is carried and added
    jparams["value_head"]["b"] = jnp.full((1,), 0.25, jnp.float32)
    model = Model(tcfg, device="cpu", with_value=True)
    params = bridge.from_jax(_np(jparams), tcfg, "cpu")
    tokens = np.random.default_rng(4).integers(0, 64, (2, 12))
    return jmodel, jparams, model, params, tokens


def test_value_model_forward_value_matches_reference(value_setup):
    jmodel, jparams, model, params, tokens = value_setup
    want = jmodel.forward_value(jparams, {"tokens": jnp.asarray(tokens)})
    got = model.forward_value(params, {"tokens": torch.from_numpy(tokens)})
    assert got.dtype == torch.float32 and got.shape == tokens.shape
    _close(got.detach().numpy(), want, 1e-5)


def test_value_model_init_has_the_reference_layout(value_setup):
    """``init`` of a value model adds the fp32 ``value_head`` {"w": [d, 1],
    "b": [1] zeros}; the bridge carries it both ways."""
    jmodel, jparams, model, params, _ = value_setup
    own = model.init(torch.Generator().manual_seed(0))
    assert own["value_head"]["w"].shape == (64, 1)
    assert own["value_head"]["w"].dtype == torch.float32
    assert torch.equal(own["value_head"]["b"], torch.zeros(1))
    jaxed = bridge.to_jax(own, model.cfg)
    assert jax.tree.structure(jaxed) == jax.tree.structure(_np(jparams))
    _params_close(params, jparams, model.cfg, 0)
    assert "value_head" not in Model(model.cfg, device="cpu").init(
        torch.Generator().manual_seed(0))


# --------------------------------------------- the full-parameter step
def _batch(tokens, rng):
    B, S = tokens.shape
    mask = np.zeros((B, S), np.float32)
    mask[:, 5:] = 1.0
    return {"tokens": tokens.astype(np.int32), "loss_mask": mask,
            "advantages": rng.standard_normal((B, S)).astype(np.float32),
            "old_logp": (-3 + 0.1 * rng.standard_normal((B, S))
                         ).astype(np.float32) * mask,
            "ref_logp": (-3 + 0.1 * rng.standard_normal((B, S))
                         ).astype(np.float32) * mask,
            "returns": rng.standard_normal((B, S)).astype(np.float32),
            "old_values": rng.standard_normal((B, S)).astype(np.float32)}


def _texp(exp):
    return {k: torch.from_numpy(v.astype(np.int64) if k == "tokens" else v)
            for k, v in exp.items()}


def _adam_dir(mu, nu, count):
    """The reference AdamW's step direction m^ / (sqrt(v^) + eps) of one
    leaf, from its moments after ``count`` updates (float64)."""
    mu, nu = np.asarray(mu, np.float64), np.asarray(nu, np.float64)
    return (mu / (1 - 0.9 ** count)) / (np.sqrt(nu / (1 - 0.95 ** count))
                                          + 1e-8)


def _adam_check(state, jstate, cfg, lr, slack=None, moment_tol=1e-7):
    """Holds a port train state after an AdamW update to the reference's:
    the step counts equal, the moments within ``moment_tol``, and every
    param within TOL plus ``slack``, the sum over the updates so far of
    lr x |the direction from the port's moments - from the reference's|.

    The slack is what the measured difference of the moments moves a leaf.
    It matters where a gradient is near eps (1e-8): AdamW's first step is
    lr * g / (|g| + eps), so two f32 gradients of ~2e-9 that differ by
    ~1e-10 in their last rounding step a param ~1e-4 apart at lr 1e-2.
    Returns the slack after this update, for the next call."""
    count = state["opt"]["count"]
    assert count == int(jstate["opt"]["count"])
    tree = lambda t: [np.asarray(x, np.float64)  # noqa: E731
                      for x in jax.tree.leaves(t)]
    mu, nu, p = (tree(bridge.to_jax(t, cfg)) for t in
                 (state["opt"]["mu"], state["opt"]["nu"], state["params"]))
    jmu, jnu, jp = (tree(t) for t in (jstate["opt"]["mu"],
                                      jstate["opt"]["nu"],
                                      jstate["params"]))
    assert len(p) == len(jp)
    slack = slack or [0.0] * len(p)
    slack = [s + lr * np.abs(_adam_dir(*t, count) - _adam_dir(*j, count))
             for s, t, j in zip(slack, zip(mu, nu), zip(jmu, jnu))]
    for a, b in ((mu, jmu), (nu, jnu)):
        for x, y in zip(a, b):
            _close(x, y, moment_tol)
    for x, y, s in zip(p, jp, slack):
        assert x.shape == y.shape
        over = np.abs(x - y) > TOL + s
        assert not over.any(), (np.abs(x - y)[over], s[over])
    return slack


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("kind", ["ppo", "critic", "lm"])
def test_full_train_step_matches_reference(kind, microbatches, arch):
    """One ``make_train_step`` step over every leaf, qkv biases and the
    GELU MLP's included, with one and two microbatches, against the
    reference's at lr 1e-2: its metrics, AdamW's moments (so the clipped
    fp32 gradients) and the updated params (:func:`_adam_check`). The
    port's step updates the params and moments in place."""
    jcfg, tcfg = small_cfgs(64, arch, microbatches=microbatches)
    value = kind == "critic"
    jmodel = JaxModel(jcfg, with_value=value)
    model = Model(tcfg, device="cpu", with_value=value)
    jstep = JS.make_train_step(jmodel, jcfg, kind=kind, lr=1e-2)
    tstep = TS.make_train_step(model, tcfg, kind=kind, lr=1e-2)
    jstate = JS.init_train_state(jmodel, jcfg, jax.random.PRNGKey(3),
                                 jstep.optimizer)
    jstate["params"] = _with_biases(jstate["params"], 2)
    tstate = TS.init_train_state(
        model, tcfg, None, tstep.optimizer,
        params=bridge.from_jax(_np(jstate["params"]), tcfg, "cpu"))
    assert all(p.requires_grad for p in leaves(tstate["params"]))
    ids = [id(t) for t in leaves(tstate)]
    exp = _batch(np.random.default_rng(4).integers(0, 64, (4, 12)),
                 np.random.default_rng(7))
    jnew, jm = jstep(jstate, jax.tree.map(jnp.asarray, exp))
    tnew, tm = tstep(tstate, _texp(exp))
    assert tnew is tstate and tnew["step"] == 1
    assert [id(t) for t in leaves(tnew)] == ids
    assert set(tm) == set(jm)
    for k in jm:
        _close(float(tm[k]), float(jm[k]), TOL)
    _adam_check(tnew, jnew, tcfg, 1e-2)
    # the slack is spent only where AdamW divides a gradient near eps: an
    # element more than TOL from the reference's has |g| below 1e-7
    for a, b, mu in zip(jax.tree.leaves(bridge.to_jax(tnew["params"], tcfg)),
                        jax.tree.leaves(jnew["params"]),
                        jax.tree.leaves(jnew["opt"]["mu"])):
        off = np.abs(a - np.asarray(b)) > TOL
        assert np.all(np.abs(np.asarray(mu)[off]) / 0.1 < 1e-7)


def test_train_steps_refuse_what_is_not_ported():
    _, tcfg = small_cfgs(64)
    model = Model(tcfg, device="cpu")
    with pytest.raises(NotImplementedError):
        TS.make_train_step(model, tcfg, shard=object())
    with pytest.raises(ValueError):
        TS.make_train_step(model, tcfg, kind="dpo")


# ------------------------------------------------------------ accounting
def test_memory_accounting_matches_reference():
    """``ModelEngine.memory_accounting`` on the same trunk and adapters
    gives the reference's bytes, role by role, byte for byte."""
    jcfg, tcfg = small_cfgs(64)
    jeng = JaxModelEngine(jcfg, jax.random.PRNGKey(0), rank=4)
    eng = ModelEngine(
        tcfg, None, rank=4,
        base_params=bridge.from_jax(_np(jeng.base_params), tcfg, "cpu"),
        adapters={r: bridge.adapter_from_jax(_np(a), tcfg, "cpu")
                  for r, a in jeng.adapters.items()})
    want = jeng.memory_accounting()
    got = eng.memory_accounting()
    assert got == {e: {r: {k: int(v) for k, v in d.items()}
                       for r, d in roles.items()}
                   for e, roles in want.items()}


# ------------------------------------------------------- the whole slice
RL_KW = dict(prompt_len=8, gen_len=8, lr=1e-2, critic_lr=1e-2, kl_coef=0.1,
             temperature=0.0, top_k=0, engine="separate")
STEPS = 2


def _run_jax(reward):
    """The reference's separate trainer: its initial actor and critic, and
    per step the greedy tokens, metrics, trained trees and record
    phases."""
    (ja, _), (jc, _) = small_cfgs(128), small_cfgs(64)
    tr = JaxRLHFTrainer(ja, jc, JaxRLHFConfig(**RL_KW),
                        jax.random.PRNGKey(0),
                        reward_fn=jax_target_reward(7) if reward else None)
    init = (_np(tr.actor_state["params"]), _np(tr.critic_state["params"]))
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 8), 0,
                                            ja.vocab_size))
    gen, tokens = tr._gen, []

    def spy(p, key):
        ro = gen(p, key)
        tokens.append(np.asarray(ro.tokens))
        return ro

    tr._gen = spy
    out = []
    for s in range(STEPS):
        n0 = len(tr.memory.records)
        m = tr.train_step(jnp.asarray(prompts), jax.random.PRNGKey(s))
        out.append({"metrics": {k: float(v) for k, v in m.items()},
                    "actor": _np(tr.actor_state),
                    "critic": _np(tr.critic_state),
                    "tokens": tokens[-1],
                    "phases": [r["phase"] for r in tr.memory.records[n0:]]})
    return init, prompts, out


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX trainer, run once per reward setting for the module."""
    return {reward: _run_jax(reward) for reward in (True, False)}


@pytest.mark.parametrize("reward", [True, False],
                         ids=["target_token_reward", "reward_model"])
def test_separate_ppo_iterations_match_reference(jax_runs, reward):
    """Two greedy f32 separate PPO iterations from the reference trainer's
    own initial weights (actor d_model 128, critic 64): identical greedy
    tokens; loss, ppo_loss, kl, vf_loss, grad_norm and mean_reward within
    1e-4; after each iteration every actor and critic leaf and its AdamW
    moments (:func:`_adam_check`; the moments to 1e-5, as the second
    iteration's gradients are taken at params the first left apart); the
    reference and reward models unchanged bit for bit; the reference's
    record phases."""
    (actor0, critic0), prompts, want = jax_runs[reward]
    (_, ta), (_, tc) = small_cfgs(128), small_cfgs(64)
    tr = bridge.separate_trainer_from_jax(
        actor0, critic0, ta, tc, RLHFConfig(**RL_KW),
        reward_fn=make_target_token_reward(7) if reward else None,
        device="cpu")
    frozen = [t.clone() for t in leaves([tr.ref_params, tr.reward_params])]
    assert not any(t.requires_grad for t in
                   leaves([tr.ref_params, tr.reward_params]))
    gen, tokens = tr._gen, []

    def spy(p, g):
        ro = gen(p, g)
        tokens.append(ro.tokens.numpy())
        return ro

    tr._gen = spy
    slack = {"actor": None, "critic": None}
    for s, w in enumerate(want):
        n0 = len(tr.memory.records)
        m = tr.train_step(torch.from_numpy(prompts.copy()).long(),
                          torch.Generator().manual_seed(s))
        assert np.array_equal(tokens[-1], w["tokens"])
        for k in ("loss", "ppo_loss", "kl", "vf_loss", "grad_norm",
                  "mean_reward"):
            _close(m[k], w["metrics"][k], TOL)
        for role, cfg, lr in (("actor", ta, "lr"),
                              ("critic", tc, "critic_lr")):
            slack[role] = _adam_check(getattr(tr, role + "_state"), w[role],
                                      cfg, RL_KW[lr], slack[role], 1e-5)
        assert [r["phase"] for r in tr.memory.records[n0:]] == w["phases"]
    assert w["phases"] == list(RUNTIME_RLHF_PHASE_SEQUENCE)
    assert all(torch.equal(a, b) for a, b in
               zip(frozen, leaves([tr.ref_params, tr.reward_params])))
    _params_close(tr.ref_params, actor0, ta, 0)
    _params_close(tr.reward_params, critic0, tc, 0)


def test_separate_records_on_cpu_count_all_four_models():
    """On the CPU the live bytes count the four models, the two AdamW
    states and the phase's buffers; the persistent trees are the six the
    reference names."""
    (_, ta), (_, tc) = small_cfgs(128), small_cfgs(64)
    tr = RLHFTrainer(ta, tc, RLHFConfig(**RL_KW),
                     torch.Generator().manual_seed(0),
                     reward_fn=make_target_token_reward(7))
    trees = tr.persistent_trees()
    assert set(trees) == {"actor_params", "actor_opt", "critic_params",
                          "critic_opt", "ref_params", "reward_params"}
    size = lambda t: sum(x.numel() * x.element_size()  # noqa: E731
                         for x in leaves(t))
    assert size(trees["actor_opt"]) == 2 * 4 * sum(
        x.numel() for x in leaves(trees["actor_params"]))
    tr.train_step(torch.randint(0, 64, (4, 8)),
                  torch.Generator().manual_seed(2))
    recs = {r["phase"]: r for r in tr.memory.records}
    assert recs["score_reward"]["live_bytes"] == \
        sum(size(t) for t in trees.values()) + 4 * 16 * (8 + 4 + 4)


def test_trainer_rejects_an_unknown_engine():
    _, ta = small_cfgs(128)
    with pytest.raises(ValueError):
        RLHFTrainer(ta, ta, RLHFConfig(**{**RL_KW, "engine": "triple"}),
                    torch.Generator())


@pytest.mark.parametrize("reward", [False, True],
                         ids=["reward_model", "target_token_reward"])
def test_separate_launch_reckoning_matches_a_run(monkeypatch, reward):
    """chip_smoke.py phase 8 asserts the launches of one separate PPO
    iteration as ``ppo_launches`` reckons them from each config's own
    depth. Here the kernels' wrappers are stood in for by their plain
    versions and every tensor is taken for a card's, so a CPU iteration
    counts what the card's would: every norm's backward (the embedding
    and every scale train), an actor and a critic of different depths."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

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
    (_, ta), (_, tc) = small_cfgs(128, num_layers=3), small_cfgs(64)
    rl = RLHFConfig(**{**RL_KW, "gen_len": 5})
    tr = RLHFTrainer(ta, tc, rl, torch.Generator().manual_seed(0),
                     reward_fn=make_target_token_reward(7) if reward
                     else None)
    ops.reset_launches()
    tr.train_step(torch.randint(0, 64, (2, 8)), torch.Generator())
    assert dict(ops.launches) == chip_smoke.ppo_launches(
        ta, rl, not reward, critic_cfg=tc)


def test_example_runs_the_separate_engine_on_cpu(capsys):
    """``examples/torch_rlhf_e2e.py --engine separate --smoke --device
    cpu`` trains the four-model pipeline and prints the seven phases."""
    import importlib.util
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "torch_rlhf_e2e", root / "examples" / "torch_rlhf_e2e.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    example.main(["--engine", "separate", "--critic-arch", "llama3_2_3b",
                  "--smoke", "--device", "cpu", "--steps", "2",
                  "--reward", "adapter"])
    out = capsys.readouterr().out
    assert "separate engine on cpu" in out
    assert out.count("step ") == 2
    phases = [line.split()[0] for line in out.splitlines()[-7:]]
    assert phases == list(RUNTIME_RLHF_PHASE_SEQUENCE)
