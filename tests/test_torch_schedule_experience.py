"""The port's warmup-cosine LR schedule and PPO experience buffer
(``repro_torch.optim.schedule``, ``repro_torch.rlhf.experience``) against
the JAX reference on the CPU: the schedule step for step at 1e-6 (and
``tests/test_optim.py``'s shape assertions), the buffer's counts, shapes,
epochs, dropped partial minibatch and ``clear()`` as
``tests/test_system.py`` holds the reference's. The port's permutation
comes from a ``torch.Generator``, so the rows of a minibatch are not the
reference's; each epoch must cover every row once, and the same generator
seed must give the same minibatches.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.optim.schedule import warmup_cosine as jax_warmup_cosine  # noqa: E402
from repro_torch.optim import warmup_cosine  # noqa: E402
from repro_torch.rlhf import ExperienceBuffer  # noqa: E402

SCHEDULES = [dict(peak_lr=1.0, warmup_steps=10, total_steps=100),
             dict(peak_lr=3e-5, warmup_steps=0, total_steps=50, floor=0.0),
             dict(peak_lr=1e-3, warmup_steps=20, total_steps=20, floor=0.2)]


@pytest.mark.parametrize("kw", SCHEDULES)
@pytest.mark.parametrize("as_tensor", [False, True])
def test_warmup_cosine_matches_jax(kw, as_tensor):
    for s in range(121):
        want = float(jax_warmup_cosine(jnp.asarray(s), **kw))
        got = warmup_cosine(torch.tensor(s) if as_tensor else s, **kw)
        if as_tensor:
            assert got.dim() == 0 and got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-6 * max(kw["peak_lr"], 1.0), s


@pytest.mark.parametrize("as_tensor", [False, True])
def test_warmup_cosine_shape(as_tensor):
    lr = [float(warmup_cosine(torch.tensor(s) if as_tensor else s,
                              peak_lr=1.0, warmup_steps=10,
                              total_steps=100)) for s in range(100)]
    assert lr[0] < lr[9] <= 1.0
    assert abs(lr[9] - 1.0) < 0.01
    assert lr[99] < lr[50] < lr[10]
    assert lr[99] >= 0.1 - 1e-3   # floor


def _filled(n_batches=3, rows=4, width=8):
    buf = ExperienceBuffer()
    for i in range(n_batches):
        # row r of the whole buffer holds 100 r + (0 .. width-1)
        buf.add({"tokens": torch.arange(width).expand(rows, width)
                 + 100 * (i * rows + torch.arange(rows)[:, None]),
                 "advantages": torch.ones((rows, width))})
    return buf


def test_experience_buffer_minibatches():
    buf = _filled()
    assert len(buf) == 12
    mbs = list(buf.minibatches(6, torch.Generator().manual_seed(0),
                               epochs=2))
    assert len(mbs) == 4
    assert mbs[0]["tokens"].shape == (6, 8)
    assert mbs[0]["advantages"].shape == (6, 8)
    buf.clear()
    assert len(buf) == 0
    assert list(buf.minibatches(6, torch.Generator().manual_seed(0))) == []


def test_experience_buffer_epochs_cover_every_row_once():
    buf = _filled()
    rows = {int(r[0]) for b in buf._batches for r in b["tokens"]}
    mbs = list(buf.minibatches(4, torch.Generator().manual_seed(1),
                               epochs=3))
    assert len(mbs) == 9
    for e in range(3):
        seen = [int(r[0]) for mb in mbs[3 * e:3 * e + 3]
                for r in mb["tokens"]]
        assert sorted(seen) == sorted(rows)
    # each row comes whole, and its advantages with it
    for mb in mbs:
        assert torch.equal(mb["tokens"] - mb["tokens"][:, :1],
                           torch.arange(8).expand(4, 8))
        assert torch.equal(mb["advantages"], torch.ones((4, 8)))


def test_experience_buffer_drops_last_partial_minibatch():
    buf = _filled()
    mbs = list(buf.minibatches(5, torch.Generator().manual_seed(2),
                               epochs=2))
    assert len(mbs) == 4 and all(mb["tokens"].shape[0] == 5 for mb in mbs)


def test_experience_buffer_same_seed_same_minibatches():
    a = list(_filled().minibatches(3, torch.Generator().manual_seed(7),
                                   epochs=2))
    b = list(_filled().minibatches(3, torch.Generator().manual_seed(7),
                                   epochs=2))
    c = list(_filled().minibatches(3, torch.Generator().manual_seed(8),
                                   epochs=2))
    assert len(a) == len(b) == 8
    for x, y in zip(a, b):
        for k in x:
            assert torch.equal(x[k], y[k])
    assert any(not torch.equal(x["tokens"], y["tokens"])
               for x, y in zip(a, c))
