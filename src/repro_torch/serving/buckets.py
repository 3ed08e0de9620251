"""Compile-bucket ladder + compile-cache accounting for the decode path —
a copy of ``repro/serving/buckets.py`` (pure Python; an empty ladder
raises ValueError where the reference asserts): the port imports nothing
of ``repro``.

In the reference, JAX recompiles a jitted function for every new input
shape, so a serving loop fed ragged traffic pays a fresh XLA compile per
distinct shape. The port's counterpart of a compiled program is a CUDA
graph (``rlhf/decode_graph.py``), and what changes with a shape there is
the set of cuBLAS and kernel launch plans the prefill warms; the ladder
and the key accounting are the reference's, so the two packages count the
same hits, misses and recompiles for the same traffic.

Pick every dynamic extent from a small sorted *bucket ladder*, pad the
inputs up to the bucket, and mask the padding (right-padded prompts via
per-row ``lengths``). :class:`CompileCache` tracks the key set presented
to the prefill — ``(kind, backend, bucket...)`` — and counts hits and
misses; a miss after warmup is a ``recompile`` (a shape escaped the
ladder).
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

Key = Tuple  # (kind, backend, *static extents)

# aphrodite's _BATCH_SIZES_TO_CAPTURE idiom: dense low end, then powers of
# two — covers both live-slot counts and (scaled up) prompt lengths
DEFAULT_CAPTURE = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)


class BucketLadder:
    """Sorted capture list; ``fit(n)`` returns the smallest bucket >= n.

    Values above the top bucket fall through to their exact size — the
    call still works, it just compiles its own program (and the compile
    cache reports it as a post-warmup miss, i.e. a recompile)."""

    def __init__(self, buckets: Iterable[int]):
        self.buckets = tuple(sorted({int(b) for b in buckets if int(b) > 0}))
        if not self.buckets:
            raise ValueError("empty bucket ladder")

    def fit(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return n

    def up_to(self, n: int) -> Tuple[int, ...]:
        """The ladder rungs <= n plus, when n overflows every rung, n
        itself — the shapes a warmup pass should capture for extent n."""
        rungs = tuple(b for b in self.buckets if b <= n)
        if not rungs or rungs[-1] < n:
            rungs += (self.fit(n),)
        return rungs

    @classmethod
    def default(cls, cap: Optional[int] = None) -> "BucketLadder":
        buckets: Sequence[int] = DEFAULT_CAPTURE
        if cap is not None:
            buckets = [b for b in DEFAULT_CAPTURE if b <= cap] or [cap]
            if buckets[-1] < cap:
                buckets.append(cap)
        return cls(buckets)


class CompileCache:
    """Shadow of the jit program cache, keyed on the static extents we
    control. ``lookup(key)`` returns True on a hit; the first sighting of a
    key is a miss (XLA compiled a new program for it). Misses recorded
    after ``finish_warmup()`` additionally count as recompiles — the
    metric a correctly-sized ladder drives to zero."""

    def __init__(self):
        self._keys: set = set()
        self.hits = 0
        self.misses = 0
        self.recompiles = 0
        self.warmed = False

    def warm(self, key: Key) -> None:
        """Register a key during warmup capture (not a hit, not a miss)."""
        self._keys.add(key)

    def finish_warmup(self) -> None:
        self.warmed = True

    def lookup(self, key: Key) -> bool:
        if key in self._keys:
            self.hits += 1
            return True
        self._keys.add(key)
        self.misses += 1
        if self.warmed:
            self.recompiles += 1
        return False

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 1.0

    def stats(self) -> Dict[str, float]:
        return {"hits": self.hits, "misses": self.misses,
                "recompiles": self.recompiles, "hit_rate": self.hit_rate,
                "keys": len(self._keys)}
