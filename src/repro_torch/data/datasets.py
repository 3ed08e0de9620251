"""Synthetic instruction prompts and fixed-length prompt batches (numpy
only; a copy of ``repro/data/datasets.py:1-57``, so the same seed gives
the same prompts in both packages)."""
from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from repro_torch.data.tokenizer import ByteTokenizer

_TEMPLATES = [
    "Summarize the following paragraph about {}.",
    "Write a short poem about {}.",
    "Explain {} to a five year old.",
    "List three facts about {}.",
    "Translate '{}' into French.",
    "What is the capital of {}?",
    "Give advice on how to learn {}.",
    "Describe the history of {}.",
]
_TOPICS = [
    "gradient descent", "the moon", "volcanoes", "sourdough bread",
    "distributed systems", "whales", "the Renaissance", "chess",
    "memory allocators", "reinforcement learning", "tensors", "compilers",
]


def synthetic_instruction_prompts(n: int, seed: int = 0) -> List[str]:
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        t = _TEMPLATES[rng.randint(len(_TEMPLATES))]
        out.append(t.format(_TOPICS[rng.randint(len(_TOPICS))]))
    return out


class PromptDataset:
    """Tokenized, fixed-length prompt batches for rollouts."""

    def __init__(self, prompts: List[str], prompt_len: int,
                 tokenizer: Optional[ByteTokenizer] = None):
        self.tok = tokenizer or ByteTokenizer()
        self.prompt_len = prompt_len
        self._ids = np.array(
            [self.tok.pad_to(self.tok.encode(p), prompt_len)
             for p in prompts], dtype=np.int32)

    def __len__(self):
        return len(self._ids)

    def batches(self, batch_size: int, seed: int = 0,
                epochs: int = 10_000) -> Iterator[np.ndarray]:
        rng = np.random.RandomState(seed)
        for _ in range(epochs):
            perm = rng.permutation(len(self._ids))
            for i in range(0, len(perm) - batch_size + 1, batch_size):
                yield self._ids[perm[i:i + batch_size]]
