"""AdamW as the reference computes it (``repro/optim/adamw.py``), not
``torch.optim.AdamW``: b2 = 0.95, weight decay 0.1 added to the Adam step
inside the update (``:47-54``), bias correction from the step count and
fp32 math. The moments are stored in ``moment_dtype``: fp32 (``adamw``)
or bf16 (``adamw_bf16``, the >= 100B configs). As in the reference, the
new moments are computed in fp32 from the stored ones, the step is taken
from those fp32 values, and only then are the moments rounded to their
dtype.

:meth:`AdamW.update_` moves the params and moments in place, as the
reference's jitted step does with its state donated
(``repro/rlhf/trainer.py:52-58``), so a step holds no second copy of
them. A leaf of more than ``BLOCK_ELEMS`` elements is updated block by
block along its first dim: one qwen1_5_110b FFN leaf is 8192 x 49152 =
403M elements, 1.6 GB a temporary in fp32, and the update holds three
such temporaries at its peak. The update is elementwise, so the blocks
give the bits of the whole-leaf update. The threshold leaves the paper's
OPT pair (its largest leaf, opt_1_3b's embedding, is 103M elements)
updated whole, as the memory study traces it."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.tree import leaves, tree_map

# elements of a leaf a block of the update covers: its fp32 temporaries
# peak at three times this many (1.5 GiB at 2^27)
BLOCK_ELEMS = 1 << 27

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _blocks(t: torch.Tensor):
    """Views of ``t`` along its first dim of at most ``BLOCK_ELEMS``
    elements each (at least one index of that dim a block); ``t`` itself
    when it is no larger."""
    if t.numel() <= BLOCK_ELEMS or t.dim() == 0:
        return [t]
    rows = max(1, BLOCK_ELEMS // max(1, t[0].numel()))
    return list(torch.split(t, rows))


@dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "float32"

    def __post_init__(self):
        if self.moment_dtype not in _DTYPES:
            raise ValueError(f"moment_dtype must be one of {tuple(_DTYPES)}, "
                             f"not {self.moment_dtype!r}")

    def init(self, params):
        dt = _DTYPES[self.moment_dtype]

        def zeros(p):
            return torch.zeros(p.shape, dtype=dt, device=p.device)

        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
                "count": 0}

    def init_specs(self, param_specs, params=None):
        """Optimizer-state specs mirroring ``param_specs`` (ZeRO: the
        caller passes ``zero_opt_pspecs``); the count is a host int."""
        from repro_torch.sharding.rules import P
        return {"mu": param_specs, "nu": param_specs, "count": P()}

    def _update_leaf(self, g, m, v, p, bc1: float, bc2: float,
                     lr: float) -> None:
        b1, b2 = self.b1, self.b2
        g32 = g.float()
        # the new moments in fp32 from the stored ones (in place where
        # they are fp32), the step from those, then the moments rounded
        m32 = m if m.dtype == torch.float32 else m.float()
        v32 = v if v.dtype == torch.float32 else v.float()
        m32.mul_(b1).add_((1 - b1) * g32)
        v32.mul_(b2).add_((1 - b2) * torch.square(g32))
        del g32
        step = (m32 / bc1).div_(torch.sqrt(v32 / bc2).add_(self.eps))
        step.add_(self.weight_decay * p.float()).mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(step)
        else:
            p.copy_(p.float().sub_(step))
        if m32 is not m:
            m.copy_(m32)
        if v32 is not v:
            v.copy_(v32)

    @torch.no_grad()
    def update_(self, grads, state, params, lr: float) -> None:
        """One AdamW step of ``params`` by ``grads`` (read only), written
        into ``params`` and the moments of ``state`` in place."""
        state["count"] += 1
        bc1 = 1.0 - self.b1 ** state["count"]
        bc2 = 1.0 - self.b2 ** state["count"]
        for g, m, v, p in zip(leaves(grads), leaves(state["mu"]),
                              leaves(state["nu"]), leaves(params)):
            parts = [_blocks(t) for t in (g, m, v, p)]
            for gb, mb, vb, pb in zip(*parts):
                self._update_leaf(gb, mb, vb, pb, bc1, bc2, lr)

    def state_bytes(self, params) -> int:
        """Bytes of the reference's optimizer state for ``params``: two
        moments a parameter in ``moment_dtype`` and its int32 step count
        (the port keeps the count as a Python int)."""
        item = torch.empty((), dtype=_DTYPES[self.moment_dtype]).element_size()
        return sum(2 * item * t.numel() for t in leaves(params)) + 4
