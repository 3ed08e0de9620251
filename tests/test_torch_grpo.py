"""The port's GRPO trainer against the JAX reference's on the CPU: two
greedy f32 steps of ``GRPOTrainer`` with a programmatic reward, from the
reference trainer's own initial weights (``bridge.grpo_trainer_from_jax``),
on the dense and the paged rollout backends (the model of
``tests/test_serving_grpo.py``). A group's greedy samples are all alike,
so their standardized advantages cancel and the policy term's gradient is
rounding noise, which AdamW's first step (lr * g / (|g| + eps)) would
blow up to +-lr on each side; the two trainers' frozen references are
therefore set to the same perturbed copy of the actor, so that the KL
term gives both a real gradient from the first step. The programmatic
reward adds a bonus by row (the same function on both sides) so the
advantages are not all zero. Greedy rollout tokens must be identical;
each step's metrics agree within 1e-4 (f32 sums in another order), the
AdamW moments within 1e-6, the trained actor's leaves within 1e-4 plus
what the moments' difference moves them through AdamW, and the
frozen reference must not move a bit. Also the trainer's three boundaries
and their records."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.rlhf.grpo import GRPOConfig as JaxGRPOConfig  # noqa: E402
from repro.rlhf.grpo import GRPOTrainer as JaxGRPOTrainer  # noqa: E402
from repro.rlhf.reward import \
    make_target_token_reward as jax_target_reward  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.rlhf import GRPOConfig, GRPOTrainer  # noqa: E402
from repro_torch.rlhf.reward import make_target_token_reward  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

TOL = 1e-4
TINY = dict(num_layers=2, d_model=128, d_ff=256, vocab_size=64, num_heads=4,
            num_kv_heads=2, head_dim=32)
RL = dict(prompt_len=8, gen_len=12, group_size=4, lr=3e-3, kl_coef=0.02,
          temperature=0.0)
STEPS, PROMPTS = 2, 3


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol, rtol=0)


def _adam_dir(mu, nu, count=STEPS):
    """AdamW's step direction m^ / (sqrt(v^) + eps) after ``count``
    updates (the reference's b1 0.9, b2 0.95, eps 1e-8)."""
    return (mu / (1 - 0.9 ** count)) / (np.sqrt(nu / (1 - 0.95 ** count))
                                          + 1e-8)


def _jax_reward(tokens, mask):
    """The fraction of generated 7s, plus 0.25 x (row % 3)."""
    rows = jnp.arange(tokens.shape[0]) % 3
    return jax_target_reward(7)(tokens, mask) + 0.25 * rows


def _reward(tokens, mask):
    rows = torch.arange(tokens.shape[0]) % 3
    return make_target_token_reward(7)(tokens, mask) + 0.25 * rows


def _prompts(step):
    return np.random.default_rng(10 + step).integers(
        0, TINY["vocab_size"], (PROMPTS, RL["prompt_len"]))


@pytest.fixture(scope="module", params=["dense", "paged"])
def runs(request):
    """Both trainers from the reference's initial weights, two greedy steps
    each on the same prompts -> (reference, port, their metrics, the
    port's rollout tokens per step, the reference's, the frozen reference's
    initial leaves, and each step's AdamW directions, port and
    reference)."""
    backend = request.param
    jcfg = dataclasses.replace(jax_get_config("llama3_2_3b").smoke(), **TINY)
    tcfg = dataclasses.replace(get_config("llama3_2_3b").smoke(), **TINY)
    jt = JaxGRPOTrainer(jcfg, JaxGRPOConfig(rollout_backend=backend, **RL),
                        jax.random.PRNGKey(0), _jax_reward)
    init = jax.tree.map(lambda x: np.asarray(x).copy(),
                        jt.actor_state["params"])
    tt = bridge.grpo_trainer_from_jax(
        init, tcfg, GRPOConfig(rollout_backend=backend, **RL),
        _reward, device="cpu")
    rng = np.random.default_rng(3)
    ref = jax.tree.map(
        lambda x: (x + 0.02 * rng.standard_normal(x.shape)).astype(x.dtype),
        init)
    jt.ref_params = jax.tree.map(jnp.asarray, ref)
    tt.ref_params = bridge.from_jax(ref, tcfg, "cpu")
    ref0 = [t.clone() for t in leaves(tt.ref_params)]
    jm, tm, jtoks, ttoks, dirs = [], [], [], [], []
    jgen, tgen = jt.rollout.generate, tt.rollout.generate

    def jrec(*a, **k):
        out = jgen(*a, **k)
        jtoks.append(np.asarray(out.tokens))
        return out

    def trec(*a, **k):
        out = tgen(*a, **k)
        ttoks.append(out.tokens.numpy().copy())
        return out
    jt.rollout.generate, tt.rollout.generate = jrec, trec
    g = torch.Generator().manual_seed(1)
    for step in range(STEPS):
        p = _prompts(step)
        jm.append(jt.train_step(jnp.asarray(p, jnp.int32),
                                jax.random.PRNGKey(5 + step)))
        tm.append(tt.train_step(torch.from_numpy(p).long(), g))
        # the step's AdamW directions on both sides, for the leaves' slack
        dirs.append([
            [_adam_dir(np.asarray(m, np.float64), np.asarray(v, np.float64),
                       step + 1) for m, v in zip(
                *(jax.tree.leaves(bridge.to_jax(tt.actor_state["opt"][n],
                                                tcfg)) for n in ("mu", "nu")))],
            [_adam_dir(np.asarray(m, np.float64), np.asarray(v, np.float64),
                       step + 1) for m, v in zip(
                *(jax.tree.leaves(jt.actor_state["opt"][n])
                  for n in ("mu", "nu")))]])
    return jt, tt, jm, tm, jtoks, ttoks, ref0, dirs


def test_grpo_greedy_rollouts_identical(runs):
    _, _, _, _, jtoks, ttoks, _, _ = runs
    assert len(jtoks) == len(ttoks) == STEPS
    for a, b in zip(jtoks, ttoks):
        assert a.shape == (PROMPTS * RL["group_size"],
                           RL["prompt_len"] + RL["gen_len"])
        np.testing.assert_array_equal(a, b)


def test_grpo_metrics_match_reference(runs):
    _, _, jm, tm, _, _, _, _ = runs
    for a, b in zip(jm, tm):
        assert set(a) == set(b)
        for k in a:
            _close(b[k], a[k], TOL)
    # a real update: the KL term's gradient, far above rounding noise
    assert all(m["kl"] > 1e-3 and m["grad_norm"] > 1e-3 for m in tm)


def test_grpo_actor_and_moments_match_reference(runs):
    jt, tt, _, _, _, _, ref0, dirs = runs
    to_np = lambda t: [np.asarray(x, np.float64)  # noqa: E731
                       for x in jax.tree.leaves(t)]
    st, jst = tt.actor_state, jt.actor_state
    assert st["opt"]["count"] == int(jst["opt"]["count"]) == STEPS
    for name, atol in (("mu", 1e-6), ("nu", 1e-6)):
        for a, b in zip(to_np(bridge.to_jax(st["opt"][name], tt.actor_cfg)),
                        to_np(jst["opt"][name])):
            _close(a, b, atol)
    # each leaf within TOL plus what the moments' measured difference
    # moved it through AdamW over the steps (a leaf whose gradient is near
    # eps steps lr * g / (|g| + eps), so rounding there moves it most)
    slack = sum(RL["lr"] * np.abs(np.concatenate([d.ravel() for d in p])
                                  - np.concatenate([d.ravel() for d in j]))
                for p, j in dirs)
    got = np.concatenate([a.ravel() for a in to_np(
        bridge.to_jax(st["params"], tt.actor_cfg))])
    want = np.concatenate([b.ravel() for b in to_np(jst["params"])])
    assert not (np.abs(got - want) > TOL + slack).any()
    # the frozen reference is bit for bit its initial copy
    assert all(torch.equal(a, b) for a, b in zip(ref0, leaves(tt.ref_params)))


def test_grpo_records_its_three_boundaries(runs):
    """Each step records rollout, score and train_actor; on the CPU the
    live bytes are the trainer's tracked tensors (both models' params, the
    moments and the phase's live buffers)."""
    _, tt, _, _, _, _, _, _ = runs
    recs = tt.memory.records
    assert [r["phase"] for r in recs] == ["rollout", "score",
                                          "train_actor"] * STEPS
    state = sum(t.numel() * t.element_size()
                for t in leaves([tt.actor_state, tt.ref_params]))
    assert recs[-1]["live_bytes"] == state
    assert recs[0]["live_bytes"] > state
    assert all(r["reserved_bytes"] is None for r in recs)


def test_grpo_paged_raises_on_a_mamba_model():
    cfg = get_config("mamba2_370m").smoke()
    with pytest.raises(ValueError):
        GRPOTrainer(cfg, GRPOConfig(rollout_backend="paged"),
                    torch.Generator().manual_seed(0),
                    make_target_token_reward(7))


def test_grpo_launch_reckoning_matches_a_run(monkeypatch):
    """chip_smoke.py phase 11 asserts the launches of one paged GRPO
    iteration as ``grpo_launches`` reckons them. Here the kernels'
    wrappers are stood in for by their plain versions and every tensor is
    taken for a card's, so a CPU iteration counts what the card's would."""
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
    monkeypatch.setattr(ops._pa, "paged_decode_attention",
                        ref.paged_attention_ref)
    monkeypatch.setattr(ops._rn, "rmsnorm", ref.rmsnorm_ref)
    monkeypatch.setattr(ops._rn, "rmsnorm_bwd",
                        lambda x, s, dy, eps, dscale=True:
                        ref.rmsnorm_bwd_ref(x, s, dy, eps))
    cfg = dataclasses.replace(get_config("opt_1_3b").smoke(), num_layers=3,
                              d_model=128, d_ff=256, vocab_size=64,
                              num_heads=2, num_kv_heads=2, head_dim=64)
    rl = GRPOConfig(prompt_len=8, gen_len=5, group_size=4,
                    rollout_backend="paged", page_size=4)
    tr = GRPOTrainer(cfg, rl, torch.Generator().manual_seed(0), _reward)
    ops.reset_launches()
    tr.train_step(torch.randint(0, 64, (2, 8)), torch.Generator())
    assert dict(ops.launches) == chip_smoke.grpo_launches(cfg, rl.gen_len)
