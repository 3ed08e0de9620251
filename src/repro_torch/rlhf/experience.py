"""Experience buffer: accumulates rollout batches and serves PPO
minibatches (several PPO epochs over shuffled experience) — the port of
``repro/rlhf/experience.py``.

The reference draws each epoch's permutation from
``jax.random.permutation(fold_in(key, epoch))``; the port draws it from
an explicit ``torch.Generator`` (one ``randperm`` an epoch, in order), so
the same generator seed gives the same minibatches, but not the
reference's rows.
"""
from __future__ import annotations

from typing import Dict, Iterator, List

import torch


class ExperienceBuffer:
    def __init__(self):
        self._batches: List[Dict[str, torch.Tensor]] = []

    def add(self, batch: Dict[str, torch.Tensor]) -> None:
        self._batches.append(batch)

    def __len__(self) -> int:
        return sum(int(b["tokens"].shape[0]) for b in self._batches)

    def minibatches(self, size: int, generator: torch.Generator,
                    epochs: int = 1) -> Iterator[Dict[str, torch.Tensor]]:
        """``epochs`` passes over every row in a fresh random order, in
        minibatches of ``size`` rows; a last partial minibatch is dropped."""
        if not self._batches:
            return
        cat = {k: torch.cat([b[k] for b in self._batches])
               for k in self._batches[0]}
        n = cat["tokens"].shape[0]
        for _ in range(epochs):
            perm = torch.randperm(n, generator=generator,
                                  device=generator.device)
            for i in range(0, n - size + 1, size):
                idx = perm[i:i + size]
                yield {k: v[idx.to(v.device)] for k, v in cat.items()}

    def clear(self) -> None:
        """Phase-boundary hygiene: drop the references so the tensors die
        (the trainer's PhaseMemoryManager then collects)."""
        self._batches.clear()
