"""The paper's claims (R1-R3) asserted against the port's own traces
(``repro_torch.core``: the port's PyTorch programs traced on ``meta``)
replayed through the caching-allocator simulator, at the paper's own
workload scale (OPT-1.3b actor/ref + OPT-350m critic/reward, DP=4,
LoRA-128, naive HF-style generation) — the seven assertions of
``tests/test_paper_claims.py``, unchanged. Each (strategy, policy) pair is
replayed once, in the module's fixture.

Three of them fail on the port's traces: R1's share of fragmentation from
inference, R3's cut in peak reserved and R2's ZeRO-3 fragmentation. The
last test here shows where that comes from: with the reference's two
training traces in place of the port's, and nothing else changed, R1's
and R3's hold. The port's training allocates per layer (one gradient
accumulator a leaf, each leaf's update temporaries), blocks that fit what
inference left cached; the reference's are stacked over the layers."""
import pytest

pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (PAPER_STRATEGIES, build_rlhf_phases,  # noqa: E402
                              lora_trainable_fraction, run_iteration)

GEN_LENS = [180, 256, 199, 243]
PAIRS = [("None", "none"), ("None", "after_inference"),
         ("None", "after_all"), ("ZeRO-1", "none"), ("ZeRO-3", "none"),
         ("ZeRO-3 + CPU Offloading", "none"),
         ("Gradient Checkpointing", "none")]


@pytest.fixture(scope="module")
def study():
    actor = get_config("opt_1_3b")
    critic = get_config("opt_350m")
    tf = lora_trainable_fraction(actor, 128)
    plans = {}
    persist = {}
    for ckpt in (False, True):
        ps, pe = [], None
        for gl in GEN_LENS:
            ph, pe = build_rlhf_phases(actor, critic, gen_len=gl,
                                       naive_generation=True, grad_ckpt=ckpt)
            ps.append(ph)
        plans[ckpt], persist[ckpt] = ps, pe
    strat = {s.name: s for s in PAPER_STRATEGIES}
    results = {}
    for name, policy in PAIRS:
        s = strat[name]
        results[name, policy] = run_iteration(
            plans[s.grad_ckpt], persist[s.grad_ckpt], s, policy, ndp=4,
            trainable_fraction=tf)
    run = lambda strategy_name, policy: results[strategy_name, policy]  # noqa: E731
    run.plans, run.persist, run.tf = plans, persist, tf
    return run


@pytest.mark.slow
def test_r1_fragmentation_overhead_exists(study):
    """R1: peak reserved carries a significant fragmentation overhead."""
    r = study("None", "none")
    overhead = r.frag_at_peak / (r.peak_reserved - r.frag_at_peak)
    assert overhead > 0.15, overhead        # paper: 46% for all-enabled


@pytest.mark.slow
def test_r1_fragmentation_accumulates_from_inference(study):
    """R1: most fragmentation comes from the inference phases — cleaning
    only after inference recovers almost all of it."""
    base = study("None", "none")
    after_inf = study("None", "after_inference")
    assert after_inf.frag_at_peak < 0.3 * base.frag_at_peak


@pytest.mark.slow
def test_r3_empty_cache_reduces_consumption(study):
    """R3: empty_cache after inference cuts peak consumption by >=15%
    (paper: 25% average) at <=8% time overhead (paper: 2%)."""
    base = study("None", "none")
    fixed = study("None", "after_inference")
    reduction = 1 - fixed.peak_reserved / base.peak_reserved
    assert reduction >= 0.15, reduction
    overhead = fixed.time_s / base.time_s - 1
    assert overhead <= 0.08, overhead


@pytest.mark.slow
def test_r3_placement_ablation(study):
    """R3: after_inference ~ after_all; both strictly better than none."""
    none = study("None", "none").peak_reserved
    ai = study("None", "after_inference").peak_reserved
    aa = study("None", "after_all").peak_reserved
    assert ai < none and aa < none
    assert abs(ai - aa) / aa < 0.10


@pytest.mark.slow
def test_r2_zero3_raises_fragmentation(study):
    """R2: ZeRO-3's per-layer gather churn raises fragmentation vs ZeRO-1."""
    z1 = study("ZeRO-1", "none")
    z3 = study("ZeRO-3", "none")
    assert z3.frag_at_peak >= z1.frag_at_peak * 0.9
    # ...but ZeRO-3 still reduces *allocated* (weights sharded)
    assert z3.peak_allocated < z1.peak_allocated


@pytest.mark.slow
def test_r2_offload_and_ckpt_reduce_consumption(study):
    none = study("None", "none")
    off = study("ZeRO-3 + CPU Offloading", "none")
    ck = study("Gradient Checkpointing", "none")
    assert off.peak_reserved < none.peak_reserved
    assert ck.peak_allocated < none.peak_allocated


@pytest.mark.slow
def test_framework_static_cache_removes_decode_churn():
    """Beyond-paper: the fixed-capacity in-place KV cache (vs the HF-style
    growing cache the paper studied) removes the decode-phase reserved
    growth entirely."""
    actor = get_config("opt_1_3b")
    critic = get_config("opt_350m")
    tf = lora_trainable_fraction(actor, 128)
    strat = PAPER_STRATEGIES[0]

    def decode_growth(naive):
        ph, persist = build_rlhf_phases(actor, critic, gen_len=256,
                                        naive_generation=naive)
        r = run_iteration([ph], persist, strat, "none", ndp=4,
                          trainable_fraction=tf, capacity=None)
        recs = {p.name: p for p in r.phase_records}
        return (recs["rollout_decode"].reserved_end
                - recs["rollout_prefill"].reserved_end)

    naive = decode_growth(True)
    ours = decode_growth(False)
    assert ours < 0.5 * naive, (ours, naive)


@pytest.mark.slow
def test_reference_train_traces_restore_r1_and_r3(study):
    """The port's plans with the reference's train_actor and train_critic
    traces swapped in (the same gen lengths, no checkpointing): R1's
    inference share and R3's reserved cut then hold as the reference's
    tests assert them, so the two claims turn on the training traces."""
    from repro.configs import get_config as jax_get_config
    from repro.core import build_rlhf_phases as jax_build
    from repro.models import layers as jax_layers
    before = jax_layers.FLASH_MIN_ELEMS
    try:
        plans = []
        for gl, port in zip(GEN_LENS, study.plans[False]):
            ref, _ = jax_build(jax_get_config("opt_1_3b"),
                               jax_get_config("opt_350m"), gen_len=gl,
                               naive_generation=True)
            swapped = list(port)
            for i in (6, 7):
                assert ref[i].name == port[i].name
                swapped[i] = ref[i]
            plans.append(swapped)
    finally:
        jax_layers.FLASH_MIN_ELEMS = before
    strat = PAPER_STRATEGIES[0]
    base, fixed = (run_iteration(plans, study.persist[False], strat, policy,
                                 ndp=4, trainable_fraction=study.tf)
                   for policy in ("none", "after_inference"))
    assert fixed.frag_at_peak < 0.3 * base.frag_at_peak
    assert 1 - fixed.peak_reserved / base.peak_reserved >= 0.15
