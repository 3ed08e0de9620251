"""AdamW as the reference computes it (``repro/optim/adamw.py``), not
``torch.optim.AdamW``: b2 = 0.95, weight decay 0.1 added to the Adam step
inside the update (``:47-54``), bias correction from the step count, fp32
math and fp32 moments. The update writes new tensors and leaves its
inputs as they are, as the reference's pure function does."""
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
    def update(self, grads, state, params, lr: float):
        count = state["count"] + 1
        b1, b2 = self.b1, self.b2
        bc1 = 1.0 - b1 ** count
        bc2 = 1.0 - b2 ** count

        def upd(g, m, v, p):
            g32 = g.float()
            m32 = b1 * m + (1 - b1) * g32
            v32 = b2 * v + (1 - b2) * torch.square(g32)
            step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + self.eps)
            step = step + self.weight_decay * p.float()
            return (p.float() - lr * step).to(p.dtype), m32, v32

        new = [upd(*x) for x in zip(leaves(grads), leaves(state["mu"]),
                                     leaves(state["nu"]), leaves(params))]

        def rebuild(i):
            it = iter([x[i] for x in new])
            return tree_map(lambda _: next(it), params)

        return rebuild(0), {"mu": rebuild(1), "nu": rebuild(2),
                            "count": count}
