"""AdamW as the reference computes it (``repro/optim/adamw.py``), not
``torch.optim.AdamW``: b2 = 0.95, weight decay 0.1 added to the Adam step
inside the update (``:47-54``), bias correction from the step count, fp32
math and fp32 moments. :meth:`AdamW.update_` moves the params and moments
in place, as the reference's jitted step does with its state donated
(``repro/rlhf/trainer.py:52-58``), so a step holds no second copy of
them."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.tree import leaves, tree_map


@dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
                "count": 0}

    @torch.no_grad()
    def update_(self, grads, state, params, lr: float) -> None:
        """One AdamW step of ``params`` by ``grads`` (read only), written
        into ``params`` and the moments of ``state`` in place."""
        state["count"] += 1
        b1, b2 = self.b1, self.b2
        bc1 = 1.0 - b1 ** state["count"]
        bc2 = 1.0 - b2 ** state["count"]
        for g, m, v, p in zip(leaves(grads), leaves(state["mu"]),
                              leaves(state["nu"]), leaves(params)):
            g32 = g.float()
            m.mul_(b1).add_((1 - b1) * g32)
            v.mul_(b2).add_((1 - b2) * torch.square(g32))
            step = (m / bc1).div_(torch.sqrt(v / bc2).add_(self.eps))
            step.add_(self.weight_decay * p.float()).mul_(lr)
            if p.dtype == torch.float32:
                p.sub_(step)
            else:
                p.copy_(p.float().sub_(step))

    def state_bytes(self, params) -> int:
        """Bytes of the reference's optimizer state for ``params``: two
        fp32 moments a parameter and its int32 step count (the port keeps
        the count as a Python int)."""
        return sum(8 * t.numel() for t in leaves(params)) + 4
