"""Adafactor on the port (``repro_torch/optim/adafactor.py``) against the
JAX reference's (``repro/optim/adafactor.py``) on the CPU, and under
ZeRO at run time.

The update against the reference's over 3 steps, at 1e-6, on factored,
unfactored, 3-D and 4-D leaves; the update block by block (small
``BLOCK_ELEMS``: blocks of leading indices and of rows) against the
whole-leaf one, at 1e-6 (the RMS clip's and the column means' sums run in
another order); the state's shapes (``tests/test_optim.py:44``); the clip
over the reference's stacked leaf, which the port's per-layer list holds
as one path in every layer of a segment, in a train step of a 2-layer
llama smoke model against the reference's at 1e-5; the plan's whole
update layout; and ZeRO-1, 2 and 3 (tree and layer gathers) at ndp 2 on
gloo ranks, spawned once for the module, bit for bit ndp 1 (the
reference's ``tests/test_layer_gather.py::test_adafactor_zero_bit_
identity``).
"""
import dataclasses
import datetime
import hashlib
import queue as queue_mod
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro import steps as JS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.optim.adafactor import Adafactor as JaxAdafactor  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import steps as TS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import Adafactor, make_optimizer  # noqa: E402
from repro_torch.rlhf import RLHFConfig, RLHFTrainer  # noqa: E402
from repro_torch.rlhf.reward import make_target_token_reward  # noqa: E402
from repro_torch.sharding import (ShardedContext, ShardingStrategy,  # noqa: E402
                                  SpecMesh)
from repro_torch.sharding.rules import P, spec_leaves  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

TOL_OPT = 1e-6
TOL = 1e-5
SHAPES = {"factored": (200, 160), "unfactored": (64, 300),
          "stacked": (3, 130, 140), "experts": (2, 2, 128, 128),
          "vector": (50,)}
SMOKE = dict(num_layers=2, d_model=128, d_ff=256, vocab_size=64,
             num_heads=4, num_kv_heads=2, head_dim=32, param_dtype="float32",
             optimizer="adafactor")
P_LEN, G_LEN, B = 8, 8, 3
RUNS = ((1, "tree"), (2, "tree"), (3, "tree"), (3, "layer"))
NDP = 2
JOIN_S = 240


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x).copy(), tree)


def _params(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


# ------------------------------------------------------------ the update
def test_update_matches_reference_over_three_steps():
    """Three steps of growing gradients: params and statistics within
    1e-6 of the reference's, the count as its."""
    p0 = _params(0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    jopt, topt = JaxAdafactor(), Adafactor()
    js, ts = jopt.init(jp), topt.init(tp)
    rng = np.random.default_rng(1)
    for step in range(3):
        g = {k: (step + 1) * rng.standard_normal(s).astype(np.float32)
             for k, s in SHAPES.items()}
        jp, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                             jp, 1e-2)
        topt.update_({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp,
                     1e-2)
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=TOL_OPT, rtol=0)
    assert ts["count"] == int(js["count"]) == 3
    for k in SHAPES:
        for name, v in ts["v"][k].items():
            np.testing.assert_allclose(v.numpy(), np.asarray(js["v"][k][name]),
                                       rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("chunk", [1000, 20000])
def test_blocked_update_matches_whole_leaf(chunk, monkeypatch):
    """Blocks of rows (1000 elements: the factored leaves' column sums
    over row blocks) and of leading indices (20000) against one block a
    leaf: within 1e-6; the gradients read only."""
    from repro_torch.optim import adafactor as AF
    p0, rng = _params(2), np.random.default_rng(3)
    whole = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    blocked = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    opt = Adafactor()
    sa, sb = opt.init(whole), opt.init(blocked)
    for step in range(2):
        g = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for k, s in SHAPES.items()}
        g0 = {k: v.clone() for k, v in g.items()}
        opt.update_(g, sa, whole, 1e-2)
        with monkeypatch.context() as m:
            m.setattr(AF, "BLOCK_ELEMS", chunk)
            opt.update_(g, sb, blocked, 1e-2)
            blocks = list(opt._blocks((3, 130, 140)))
        assert all(torch.equal(g[k], g0[k]) for k in g)
    for k in SHAPES:
        torch.testing.assert_close(blocked[k], whole[k], atol=TOL_OPT,
                                   rtol=0)
    if chunk == 1000:       # rows of 140: 7 a block, one leading index
        assert blocks[:2] == [(slice(0, 1), slice(0, 7)),
                              (slice(0, 1), slice(7, 14))]
    else:                   # one leading index (18200 elements) a block
        assert blocks == [(slice(i, i + 1), slice(0, 130)) for i in range(3)]


def test_state_shapes_and_bytes():
    """As ``tests/test_optim.py:44``: a factored leaf keeps a row and a
    column statistic (per leading index), a small one a full one; the
    state's bytes as ``state_bytes`` reckons them, its specs replicated."""
    opt = Adafactor()
    params = {"big": torch.ones(256, 512), "small": torch.ones(8),
              "experts": torch.ones(4, 256, 128)}
    state = opt.init(params)
    assert state["v"]["big"]["vr"].shape == (256,)
    assert state["v"]["big"]["vc"].shape == (512,)
    assert state["v"]["small"]["v"].shape == (8,)
    assert state["v"]["experts"]["vr"].shape == (4, 256)
    assert state["v"]["experts"]["vc"].shape == (4, 128)
    assert opt.state_bytes(params) == 4 + sum(
        t.numel() * 4 for t in leaves(state["v"]))
    specs = opt.init_specs(None, params)
    assert all(all(e is None for e in s) for s in spec_leaves(specs["v"]))
    assert specs["count"] == P()


def test_make_optimizer():
    """``adafactor`` with a config clips each reference leaf over its
    segment's layers; ``adamw_bf16`` is AdamW with bf16 moments (as the
    reference's ``make_optimizer``); an unknown name raises."""
    ds = get_config("deepseek_v3_671b")
    opt = make_optimizer("adafactor", ds)
    assert opt.segments == (3, 58)
    assert opt._group(("layers", 2, "mixer", "wo")) == \
        opt._group(("layers", 0, "mixer", "wo"))
    assert opt._group(("layers", 3, "mixer", "wo")) != \
        opt._group(("layers", 2, "mixer", "wo"))
    assert opt._group(("mtp", 1, "proj")) == opt._group(("mtp", 2, "proj"))
    assert opt._group(("mtp", 0, "proj")) != opt._group(("mtp", 1, "proj"))
    assert Adafactor()._group(("layers", 1, "w")) != \
        Adafactor()._group(("layers", 0, "w"))
    assert make_optimizer("adamw_bf16").moment_dtype == "bfloat16"
    with pytest.raises(ValueError):
        make_optimizer("sgd")


@pytest.mark.parametrize("microbatches", [1, 2])
def test_stacked_clip_in_a_train_step_matches_reference(microbatches):
    """A 2-layer llama smoke model (one segment) with Adafactor: the
    reference clips each of its stacked [2, ...] leaves over both layers,
    the port over the same path in both of its layers. One lm step's loss,
    statistics and params against the reference's (at 2 microbatches,
    bf16 accumulation, as ``tests/test_torch_mla.py`` holds it)."""
    kw = dict(SMOKE, microbatches=microbatches)
    jcfg = dataclasses.replace(jax_get_config("llama3_2_3b").smoke(), **kw)
    tcfg = dataclasses.replace(get_config("llama3_2_3b").smoke(), **kw)
    jm, tm = JaxModel(jcfg), Model(tcfg, device="cpu")
    lr = 1e-2
    jstep = JS.make_train_step(jm, jcfg, kind="lm", lr=lr)
    tstep = TS.make_train_step(tm, tcfg, kind="lm", lr=lr)
    assert tstep.optimizer.segments == (2,)
    jstate = JS.init_train_state(jm, jcfg, jax.random.PRNGKey(1),
                                 jstep.optimizer)
    tstate = TS.init_train_state(
        tm, tcfg, None, tstep.optimizer,
        params=bridge.from_jax(_np(jstate["params"]), tcfg, "cpu"))
    rng = np.random.default_rng(4)
    mask = np.ones((4, 12), np.float32)
    batch = {"tokens": rng.integers(0, 64, (4, 12)).astype(np.int32),
             "loss_mask": mask}
    jp0 = jstate["params"]
    jnew, jmet = jax.jit(jstep)(jstate, jax.tree.map(jnp.asarray, batch))
    tnew, tmet = tstep(tstate, {"tokens": torch.from_numpy(
        batch["tokens"]).long(), "loss_mask": torch.from_numpy(mask)})
    for k in jmet:
        assert float(tmet[k]) == pytest.approx(float(jmet[k]), abs=TOL), k
    bf = microbatches > 1
    for a, b in zip(jax.tree.leaves(bridge.to_jax(tnew["opt"]["v"], tcfg)),
                    jax.tree.leaves(jnew["opt"]["v"])):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0 if bf else 1e-4,
                                   atol=2 ** -5 * np.abs(b).max() if bf
                                   else 1e-12)
    for a, b, b0 in zip(jax.tree.leaves(bridge.to_jax(tnew["params"], tcfg)),
                        jax.tree.leaves(jnew["params"]),
                        jax.tree.leaves(jp0)):
        b, b0 = np.asarray(b, np.float64), np.asarray(b0, np.float64)
        slack = 2 ** -5 * np.abs(b - b0).max() if bf else 0.0
        np.testing.assert_allclose(a, b, atol=TOL + slack, rtol=0)


def test_plan_updates_whole_and_refuses_tp():
    """Under ZeRO the plan takes Adafactor's update layout, whole on every
    rank, where AdamW's is the optimizer shards' (``zero_opt_pspecs``);
    Adafactor under a model axis is not ported."""
    cfg = dataclasses.replace(get_config("llama3_2_3b").smoke(), **SMOKE)
    shapes = Model(cfg, device="meta").init()
    ctx = ShardedContext(SpecMesh({"data": 2}), ShardingStrategy(zero_stage=1))
    ada = ctx.plan_params(cfg, shapes, make_optimizer("adafactor", cfg))
    adam = ctx.plan_params(cfg, shapes, make_optimizer("adamw"))
    assert all(all(e is None for e in s)
               for s in spec_leaves(ada.update_specs))
    assert any(any(e is not None for e in s)
               for s in spec_leaves(adam.update_specs))
    tp = ShardedContext(SpecMesh({"data": 1, "model": 2}),
                        ShardingStrategy(zero_stage=1, tensor_parallel=True,
                                         ntp=2))
    with pytest.raises(NotImplementedError, match="Adafactor"):
        tp.plan_params(cfg, shapes, make_optimizer("adafactor", cfg))


# ------------------------------------------------------------ ZeRO on gloo
def _cfg(**kw):
    return dataclasses.replace(get_config("llama3_2_3b").smoke(), **SMOKE,
                               **kw)


def _prompts():
    return torch.from_numpy(np.random.default_rng(1).integers(
        0, 64, (B, P_LEN))).long()


def _digest(tr) -> str:
    h = hashlib.sha1()
    for plan, tree in ((tr.actor_plan, tr.actor_state["params"]),
                       (tr.critic_plan, tr.critic_state["params"])):
        full = tree if plan is None else plan.gather_copy(tree)[0]
        for t in leaves(full):
            h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _run(shard, cfg):
    rl = RLHFConfig(prompt_len=P_LEN, gen_len=G_LEN, lr=1e-3, critic_lr=1e-3,
                    kl_coef=0.0, top_k=0, engine="separate")
    tr = RLHFTrainer(cfg, cfg, rl, torch.Generator().manual_seed(0),
                     reward_fn=make_target_token_reward(7), shard=shard)
    ms = [tr.train_step(_prompts(), torch.Generator().manual_seed(10 + s))
          for s in range(2)]
    return {"metrics": ms, "digest": _digest(tr),
            "opt": tr.actor_state["opt"]["count"]}


def _rank_jobs():
    out = {}
    for mb in (1, 3):
        cfg = _cfg(microbatches=mb)
        out[mb, "base"] = _run(None, cfg)
        for stage, mode in RUNS:
            sc = ShardedContext.create(NDP, zero_stage=stage,
                                       gather_mode=mode, device="cpu")
            out[mb, stage, mode] = _run(sc, cfg)
    return out


def _worker(rank, store, results):
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, NDP), rank=rank,
            world_size=NDP, timeout=datetime.timedelta(seconds=60))
        out = _rank_jobs()
        dist.destroy_process_group()
        results.put((rank, out, None))
    except BaseException as e:          # the parent fails the tests
        import traceback
        results.put((rank, None, f"{e!r}\n{traceback.format_exc()}"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """[rank 0's results, rank 1's] of 2-step separate PPO runs at ndp 2,
    each rank beside its own unsharded run."""
    tmp = tmp_path_factory.mktemp("adafactor_zero")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(r, str(tmp / "store"),
                                               results)) for r in range(NDP)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < NDP:
            if time.perf_counter() - t0 > JOIN_S:
                pytest.fail(f"the ranks did not report in {JOIN_S} s")
            try:
                rank, out, err = results.get(timeout=2.0)
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    pytest.fail(f"a rank exited without a result: {dead}")
                continue
            if err is not None:
                pytest.fail(f"rank {rank}: {err}")
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(NDP)]


@pytest.mark.parametrize("mode", [f"{s}-{m}" for s, m in RUNS])
@pytest.mark.parametrize("microbatches", [1, 3])
def test_zero_adafactor_bit_identity(ranks, microbatches, mode):
    """2-step separate PPO with Adafactor (bf16 accumulation at 3
    microbatches of the 3 prompts, which ndp 2 does not divide: the batch
    replicates) at ZeRO-1, 2 and 3 (tree and layer gathers), ndp 2 on
    gloo: every rank's metrics and gathered trained trees are ndp 1's bit
    for bit."""
    stage, gm = mode.split("-")
    for out in ranks:
        base = out[microbatches, "base"]
        got = out[microbatches, int(stage), gm]
        assert got["metrics"] == base["metrics"]
        assert got["digest"] == base["digest"]
        assert got["opt"] == base["opt"] == 2
