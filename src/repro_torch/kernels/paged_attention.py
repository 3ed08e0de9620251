"""Paged flash-decode over a block-table-indexed KV pool — the CUDA kernels
in ``csrc/paged_attention.cu`` (B4).

Replaces ``repro/paged/attention.py::paged_decode_attention`` (Pallas,
``_paged_decode_kernel``). See the source's note for its bound on the
H100 and its design. The pools are read in place: this wrapper copies
neither of them and raises on a pool that is not contiguous. CUDA tensors
only; ``kernels/ops.py`` routes a CPU tensor to
``ref.paged_attention_ref``.

A block serves ``ROWS`` = 8 consecutive rows (a GRPO group, whose rows
share their prompt's pages, each read once for the tile), all query heads
of one KV head and every ``splits``-th page: split s takes pages s,
s + splits, ..., so a group's private last pages spread over the splits.
The split rule, :func:`plan`, reads the shapes alone, never the table or
the positions, so a CUDA graph of the decode step could capture it: it
aims at ``TARGET_BLOCKS`` = two blocks per SM of the H100's 132 over the
tiles x KV heads, without exceeding it, and at most ``MAX_SPAN`` pages a
split; no split is empty.
With more than one split, each block writes its unnormalised partials
(m and l per query head, acc [G, D], fp32) to scratch of
B·H·splits·(D + 2) floats that this wrapper allocates with
``torch.empty``, and a second kernel on the same stream merges them; with
one split the first kernel writes the output and no scratch is made.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build

SOURCE = "src/repro_torch/kernels/csrc/paged_attention.cu"
REPLACES = "src/repro/paged/attention.py:127"
HEAD_DIMS = (64, 128)
MAX_GROUP = 8
ROWS = 8                    # rows a tile (csrc R)
MAX_SPAN = 32               # pages a split (csrc MAX_SPAN)
TARGET_BLOCKS = 2 * 132     # two blocks per SM of the H100


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class Plan(NamedTuple):
    rows: int         # rows a tile
    tiles: int        # tiles of rows: cdiv(B, rows)
    splits: int       # split s takes pages s, s + splits, ...
    span: int         # pages of the largest split: cdiv(nb, splits)


@functools.lru_cache(maxsize=256)
def plan(B: int, K: int, nb: int) -> Plan:
    """The launch for B rows, K KV heads and block tables of nb pages:
    tiles of ``ROWS`` rows; as many splits of the pages as keep tiles x K
    x splits at most ``TARGET_BLOCKS`` (at least one, at most one a page,
    so none is empty), and enough that none takes more than ``MAX_SPAN``
    pages."""
    tiles = _cdiv(B, ROWS)
    aim = max(1, TARGET_BLOCKS // (tiles * K), _cdiv(nb, MAX_SPAN))
    splits = min(aim, nb)
    return Plan(ROWS, tiles, splits, _cdiv(nb, splits))


def walk_ends(block_tables: torch.Tensor, position: torch.Tensor,
              ps: int) -> torch.Tensor:
    """Pages each row walks: up to the page holding its position when an
    allocated page lies at or before it, else all nb pages (a row with no
    valid slot takes the uniform mean of every page it names)."""
    nb = block_tables.shape[1]
    last = torch.clamp(position.long(), min=0) // ps
    last = torch.clamp(last, max=nb - 1)
    j = torch.arange(nb, device=block_tables.device)
    alloc = ((block_tables >= 0) & (j[None] <= last[:, None])).any(1)
    return torch.where((position >= 0) & alloc, last + 1,
                       torch.full_like(last, nb))


def block_loads(block_tables: torch.Tensor, position: torch.Tensor,
                ps: int, pl: Plan) -> torch.Tensor:
    """Pages each block of the grid copies for its KV head, [tiles,
    splits]: per page index j of its split, the distinct pages (-1 read as
    page 0) among its rows still walking at j."""
    bt = torch.clamp(block_tables, min=0).cpu()
    walking = torch.arange(bt.shape[1])[None] < \
        walk_ends(block_tables, position, ps).cpu()[:, None]
    out = torch.zeros(pl.tiles, pl.splits, dtype=torch.long)
    for t in range(pl.tiles):
        rows = slice(t * pl.rows, (t + 1) * pl.rows)
        for j in range(bt.shape[1]):
            pages = bt[rows, j][walking[rows, j]]
            out[t, j % pl.splits] += pages.unique().numel()
    return out


def launch_plan(q: torch.Tensor, k_pool: torch.Tensor,
                block_tables: torch.Tensor,
                splits: Optional[int] = None) -> tuple:
    """(splits, span) of a call, read from its tensors' shapes alone:
    :func:`plan`'s, or ``splits`` (at most nb) where it is given; raises
    if a split would take more than ``MAX_SPAN`` pages."""
    B, K, nb = q.shape[0], k_pool.shape[2], block_tables.shape[1]
    if splits is None:
        return tuple(plan(B, K, nb)[2:])
    splits = max(1, min(splits, nb))
    if _cdiv(nb, splits) > MAX_SPAN:
        raise ValueError(f"{splits} splits of {nb} pages exceed "
                         f"{MAX_SPAN} pages a split")
    return splits, _cdiv(nb, splits)


@functools.lru_cache(maxsize=None)
def _fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.entry("rt_paged_decode_attention",
                       [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p])


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           position: torch.Tensor, *,
                           splits: Optional[int] = None) -> torch.Tensor:
    """q [B,H,D]; pools [P,ps,K,D]; block_tables [B,nb] int32 with entries
    in [-1, P); position [B] int32 -> [B,H,D]. ``splits`` overrides the
    plan's split count."""
    tensors = (q, k_pool, v_pool, block_tables, position)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("paged decode kernel needs CUDA tensors on one "
                         f"device, got {[str(t.device) for t in tensors]}")
    B, H, D = q.shape
    _, ps, K, Dp = k_pool.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"paged decode kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {D}")
    if Dp != D or v_pool.shape != k_pool.shape or H % K \
            or block_tables.dim() != 2 or block_tables.shape[0] != B \
            or block_tables.shape[1] < 1 or position.shape != (B,):
        raise ValueError(
            f"bad shapes q {tuple(q.shape)} pools {tuple(k_pool.shape)} "
            f"block_tables {tuple(block_tables.shape)} position "
            f"{tuple(position.shape)}")
    if H // K > MAX_GROUP:
        raise ValueError(f"paged decode kernel takes at most {MAX_GROUP} "
                         f"query heads per KV head, got {H // K}")
    if not (q.dtype == k_pool.dtype == v_pool.dtype):
        raise TypeError("q and pool dtypes differ")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("paged decode kernel reads the pools in place and "
                         "needs them contiguous")
    n_splits, _ = launch_plan(q, k_pool, block_tables, splits)
    q = q.contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    position = position.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool, out)):
        raise ValueError("paged decode kernel loads 16 bytes at a time and "
                         "needs 16-byte aligned q and pools")
    part = None if n_splits == 1 else torch.empty(
        B * H * n_splits * (D + 2), dtype=torch.float32, device=q.device)
    err = _fn()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                bt.data_ptr(), position.data_ptr(), out.data_ptr(),
                None if part is None else part.data_ptr(),
                B, bt.shape[1], ps, H, K, D, n_splits,
                build.dtype_code(q), build.stream_ptr())
    build.check(err, "rt_paged_decode_attention")
    return out
