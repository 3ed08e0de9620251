"""Paged KV store: the device tensors behind the page manager — the port of
``repro/paged/paged_cache.py``.

One pool per attention layer, ``{"k", "v": [num_pages + 1, page_size,
kv_heads, head_dim]}``. Sequences address it through block tables
``[B, max_blocks]`` of page ids (-1 = unallocated); logical token ``i`` of
sequence ``b`` lives at ``pool[bt[b, i // ps], i % ps]``, so positions
stay dense (0..len) and validity is ``i <= position`` and ``bt >= 0``.

Unlike the reference's pure functions, the writes here are **in place**
(as the dense caches of ``models/layers.py``): a functional update would
copy a layer's whole pool on every decode step.

**The drop page.** The reference drops invalid writes (idle rows at
position -1, prompt tokens past ``lengths``, unallocated blocks) with
``.at[...].set(mode="drop")`` by aiming them at page ``num_pages``, one
past the end. PyTorch has no drop mode, so every pool carries one extra
page at index ``num_pages`` that no block table names, and invalid rows
write there. The writes stay one ``index_put_`` each, with no host sync
(a boolean-selected write would need one to size its index), and other
sequences' pages are never touched: two dropped rows may race on the
drop page, whose contents nobody reads. Attention never reads it either:
a -1 block aliases page 0 and is masked. :func:`pool_pages` gives the
pool's addressable page count.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding import tp as TP

Pool = Dict[str, torch.Tensor]


def init_pool(cfg: ModelConfig, num_pages: int, page_size: int, dtype,
              device) -> Pool:
    """One attention layer's paged pool: ``num_pages`` addressable pages
    plus the drop page (k/v only — positions are dense); under an ambient
    TP group the rank's K/ntp heads."""
    kvh, hd = TP.kv_heads(cfg), cfg.resolved_head_dim()
    shape = (num_pages + 1, page_size, kvh, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def pool_pages(pool: Pool) -> int:
    """Addressable pages of a pool (its drop page excluded)."""
    return pool["k"].shape[0] - 1


def pool_token_bytes(cfg: ModelConfig, dtype) -> int:
    """KV bytes for one token in one layer (sizing for PageManager events);
    a rank's under an ambient TP group."""
    kvh, hd = TP.kv_heads(cfg), cfg.resolved_head_dim()
    return 2 * kvh * hd * dtype.itemsize


def _flat_targets(block_tables: torch.Tensor, page_size: int, S: int):
    """Page/slot coordinates of logical tokens 0..S-1 per sequence.
    block_tables [B, nb] -> (page [B,S], slot [B,S]); unallocated entries
    keep their -1 (callers route those writes to the drop page)."""
    idx = torch.arange(S, device=block_tables.device)
    blk = torch.clamp(idx // page_size, max=block_tables.shape[1] - 1)
    page = block_tables[:, blk]                          # [B, S]
    return page, (idx % page_size).expand_as(page)


def scatter_prefill(pool: Pool, k_new: torch.Tensor, v_new: torch.Tensor,
                    block_tables: torch.Tensor,
                    lengths: torch.Tensor) -> Pool:
    """Scatter prompt K/V into the pool, in place. k_new/v_new [B, S, kvh,
    hd]; block_tables [B, nb]; lengths [B] (tokens valid per row)."""
    ps = pool["k"].shape[1]
    B, S = k_new.shape[:2]
    page, slot = _flat_targets(block_tables, ps, S)
    idx = torch.arange(S, device=page.device)
    valid = (idx[None, :] < lengths[:, None]) & (page >= 0)
    page = torch.where(valid, page, pool_pages(pool)).reshape(-1).long()
    slot = slot.reshape(-1).long()
    pool["k"][page, slot] = k_new.reshape(B * S, *k_new.shape[2:])
    pool["v"][page, slot] = v_new.reshape(B * S, *v_new.shape[2:])
    return pool


def append_decode(pool: Pool, k_t: torch.Tensor, v_t: torch.Tensor,
                  block_tables: torch.Tensor,
                  position: torch.Tensor) -> Pool:
    """Write one token per sequence at logical index ``position``, in
    place. k_t/v_t [B, kvh, hd]; position [B]. Rows whose block table has
    no page at that index, or at position -1 (idle slots), write to the
    drop page."""
    ps = pool["k"].shape[1]
    pos = torch.clamp(position, min=0).long()
    blk = torch.clamp(pos // ps, max=block_tables.shape[1] - 1)
    page = torch.gather(block_tables, 1, blk[:, None])[:, 0]
    valid = (page >= 0) & (position >= 0)
    page = torch.where(valid, page, pool_pages(pool)).long()
    slot = pos % ps
    pool["k"][page, slot] = k_t
    pool["v"][page, slot] = v_t
    return pool


def append_decode_multi(pool: Pool, k_t: torch.Tensor, v_t: torch.Tensor,
                        block_tables: torch.Tensor,
                        positions: torch.Tensor) -> Pool:
    """Write T tokens per sequence at logical indices ``positions`` (the
    speculative-decode verify), in place. k_t/v_t [B, T, kvh, hd];
    positions [B, T]. Entries at -1 or without an allocated page write to
    the drop page — :func:`append_decode`'s masking, over T at once."""
    ps = pool["k"].shape[1]
    B, T = positions.shape
    pos = torch.clamp(positions, min=0).long()
    blk = torch.clamp(pos // ps, max=block_tables.shape[1] - 1)   # [B, T]
    page = torch.gather(block_tables, 1, blk)                     # [B, T]
    valid = (page >= 0) & (positions >= 0)
    page = torch.where(valid, page, pool_pages(pool)).reshape(-1).long()
    slot = (pos % ps).reshape(-1)
    pool["k"][page, slot] = k_t.reshape(B * T, *k_t.shape[2:])
    pool["v"][page, slot] = v_t.reshape(B * T, *v_t.shape[2:])
    return pool


def gather_kv(pool: Pool, block_tables: torch.Tensor):
    """Materialise per-sequence K/V [B, nb*ps, kvh, hd] (plain path).
    Unallocated blocks gather page 0 — callers mask by position."""
    pages = torch.clamp(block_tables, min=0).long()      # [B, nb]
    k = pool["k"][pages]                                 # [B, nb, ps, kvh, hd]
    v = pool["v"][pages]
    B, nb, ps = k.shape[:3]
    return (k.reshape(B, nb * ps, *k.shape[3:]),
            v.reshape(B, nb * ps, *v.shape[3:]))


def copy_pages(pool: Pool, src: Sequence[int], dst: Sequence[int]) -> Pool:
    """Copy-on-write page copies, in place. src/dst: page ids (fresh
    ``dst`` pages, never a ``src`` of the same call)."""
    dev = pool["k"].device
    src = torch.as_tensor(src, dtype=torch.long).to(dev)
    dst = torch.as_tensor(dst, dtype=torch.long).to(dev)
    pool["k"][dst] = pool["k"][src]
    pool["v"][dst] = pool["v"][src]
    return pool
