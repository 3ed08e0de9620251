"""Byte-level tokenizer with special tokens — a real, dependency-free
tokenizer for the runnable examples (vocab 256 bytes + specials)."""
from __future__ import annotations

from typing import List, Sequence


class ByteTokenizer:
    PAD = 256
    BOS = 257
    EOS = 258

    @property
    def vocab_size(self) -> int:
        return 259

    def encode(self, text: str, *, bos: bool = True,
               eos: bool = False) -> List[int]:
        ids = list(text.encode("utf-8"))
        if bos:
            ids = [self.BOS] + ids
        if eos:
            ids = ids + [self.EOS]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8",
                                                       errors="replace")

    def pad_to(self, ids: Sequence[int], length: int) -> List[int]:
        ids = list(ids)[:length]
        return ids + [self.PAD] * (length - len(ids))
