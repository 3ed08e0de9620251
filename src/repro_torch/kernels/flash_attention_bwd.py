"""Flash-attention backward — the CUDA kernels in
``csrc/flash_attention_bwd.cu`` (B2-bwd).

The TPU package has no Pallas backward; its model differentiates
attention through the XLA custom VJP ``repro/models/flash.py::_bwd``,
which this replaces. See the source's note for its bound on the H100 and
its design. Two routes, picked by :func:`route` from the dtype and the
head widths: bf16 at (64, 64) and (128, 128) runs on the tensor cores
(``wgmma``, tiles fed by TMA); fp32, and bf16 at DeepSeek-V3 MLA's
(192, 128) (q and k rows of 192, v rows of 128), on the CUDA cores.
Both take the launch plan of :func:`plan`, which reads the shapes alone:
a dK/dV block per (key tile, KV head, batch) that walks the q tiles of
the G query heads that see its keys, and a dQ block per (q tile, query
head, batch) that walks the key tiles its rows see; no atomics. A route
that does not launch raises; nothing falls back. CUDA tensors only;
``kernels/ops.py`` routes a CPU tensor to ``ref.flash_attention_bwd_ref``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import HEAD_DIMS

SOURCE = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
REPLACES = "src/repro/models/flash.py:98 (_bwd, XLA)"
ROUTES = ("simt", "wgmma")          # the C entry's route codes 0 and 1
TILE = 64                           # q rows and keys a tile (csrc T)


def route(dtype: torch.dtype, D: int, Dv: int = 0) -> str:
    """The kernels a call of this dtype and (q/k, v) head widths takes
    (``Dv`` defaults to ``D``): "wgmma" (tensor cores) for bf16 at equal
    widths, "simt" (CUDA cores, fp32 products) for fp32 and for the MLA
    pair (192, 128)."""
    Dv = Dv or D
    if (D, Dv) not in HEAD_DIMS:
        raise ValueError(f"flash backward takes head_dim pairs (q/k, v) in "
                         f"{HEAD_DIMS}, got ({D}, {Dv})")
    return "wgmma" if dtype == torch.bfloat16 and D == Dv else "simt"


# a block of the plan: (its tile, head, batch row, first and end tile of
# the other kind that it walks)
Block = Tuple[int, int, int, int, int]


class Plan(NamedTuple):
    tile: int                   # q rows and keys a tile
    heads: int                  # query heads H and KV heads K
    kv_heads: int
    dkdv: Tuple[Block, ...]     # (key tile, KV head, batch, q tiles), launch order
    dq: Tuple[Block, ...]       # (q tile, query head, batch, key tiles), launch order
    pairs: int                  # visible (query, key) pairs the dQ blocks walk
    empty_tiles: int            # tile visits (both kernels) with no visible pair

    def table(self) -> torch.Tensor:
        """The plan as the kernels read it: int32 [len(dkdv) + len(dq), 4],
        a row (tile, batch * heads + head, begin, end) a block."""
        rows = [(t, b * n + h, lo, hi)
                for blocks, n in ((self.dkdv, self.kv_heads),
                                  (self.dq, self.heads))
                for t, h, b, lo, hi in blocks]
        return torch.tensor(rows, dtype=torch.int32)


def _span(lo: int, hi: int, n: int, causal: bool, window: int,
          keys: bool) -> Tuple[int, int]:
    """The positions [first, last] of the other side that see any of
    positions lo..hi: keys seen by queries lo..hi (``keys``), or queries
    that see keys lo..hi; n positions on the other side. Key j is seen by
    query i when j <= i (causal, top-left) and j > i - window (window)."""
    if not causal:
        return 0, n - 1
    if keys:
        return (max(0, lo - window + 1) if window else 0), min(hi, n - 1)
    return lo, (min(n - 1, hi + window - 1) if window else n - 1)


def _tiles(first: int, last: int, tile: int) -> Tuple[int, int]:
    return (first // tile, last // tile + 1) if first <= last else (0, 0)


def _tile_pairs(q0, k0, Sq, Sk, causal, window, tile) -> int:
    """Visible pairs of the (q tile at q0, key tile at k0) of one head."""
    n = 0
    for i in range(q0, min(q0 + tile, Sq)):
        lo, hi = _span(i, i, Sk, causal, window, keys=True)
        n += max(0, min(hi, k0 + tile - 1) - max(lo, k0) + 1)
    return n


@functools.lru_cache(maxsize=256)
def plan(B: int, Sq: int, Sk: int, H: int, K: int, D: int, causal: bool,
         window: int, Dv: int = 0) -> Plan:
    """The launch of a call of these shapes: tiles of 64 queries and keys
    (at every head-width pair); each dK/dV block walks, for each of its KV head's
    G query heads, the q tiles holding a query that sees one of its keys,
    and each dQ block the key tiles holding a key one of its rows sees;
    every key tile and q tile has its block, walk or none (its gradient is
    then 0). Blocks are launched longest walk first, so the causal
    triangle's long walks do not form the tail."""
    route(torch.bfloat16, D, Dv)        # validates the widths
    if H % K:
        raise ValueError(f"{H} query heads over {K} KV heads")
    t = TILE
    nq, nk = -(-Sq // t), -(-Sk // t)
    q_of_k = [_tiles(*_span(kt * t, min(kt * t + t, Sk) - 1, Sq, causal,
                            window, keys=False), t) for kt in range(nk)]
    k_of_q = [_tiles(*_span(qt * t, min(qt * t + t, Sq) - 1, Sk, causal,
                            window, keys=True), t) for qt in range(nq)]
    dkdv = sorted(((kt, kh, b, *q_of_k[kt]) for b in range(B)
                   for kh in range(K) for kt in range(nk)),
                  key=lambda blk: blk[3] - blk[4])
    dq = sorted(((qt, h, b, *k_of_q[qt]) for b in range(B) for h in range(H)
                 for qt in range(nq)), key=lambda blk: blk[3] - blk[4])
    # one head's tiles, as the dQ and the dK/dV blocks walk them
    by_dq = [(qt, kt) for qt in range(nq) for kt in range(*k_of_q[qt])]
    by_dkdv = [(qt, kt) for kt in range(nk) for qt in range(*q_of_k[kt])]
    count = {tl: _tile_pairs(tl[0] * t, tl[1] * t, Sq, Sk, causal, window, t)
             for tl in set(by_dq + by_dkdv)}
    pairs = B * H * sum(count[tl] for tl in by_dq)
    empty = B * H * sum(count[tl] == 0 for tl in by_dq + by_dkdv)
    return Plan(t, H, K, tuple(dkdv), tuple(dq), pairs, empty)


@functools.lru_cache(maxsize=64)
def _device_table(device: torch.device, *args) -> torch.Tensor:
    """:func:`plan` ``(*args)``'s table on ``device``, uploaded once."""
    return plan(*args).table().to(device)


@functools.lru_cache(maxsize=None)
def _fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.entry("rt_flash_attention_bwd",
                       [p] * 11 + [i] * 13 + [p])


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: int = 0):
    """q [B,Sq,H,D], out/dout [B,Sq,H,Dv], k [B,Sk,K,D], v [B,Sk,K,Dv],
    lse [B,Sq,H] fp32 (from ``flash_attention_fwd(return_lse=True)``) ->
    (dq, dk, dv) in the inputs' shapes and dtype."""
    ts = (q, k, v, out, lse, dout)
    if not all(t.device.type in build.DEVICES and t.device == q.device
               for t in ts):
        raise ValueError("flash backward needs CUDA tensors on one device, "
                         f"got {[str(t.device) for t in ts]}")
    B, Sq, H, D = q.shape
    Bk, Sk, K, Dk = k.shape
    Dv = v.shape[-1]
    kind = route(q.dtype, D, Dv)
    if (Bk, Dk) != (B, D) or v.shape[:3] != k.shape[:3] or H % K or \
            out.shape != (B, Sq, H, Dv) or dout.shape != out.shape or \
            lse.shape != (B, Sq, H):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} out {tuple(out.shape)} dout "
                         f"{tuple(dout.shape)} lse {tuple(lse.shape)}")
    if not (q.dtype == k.dtype == v.dtype == out.dtype == dout.dtype) or \
            lse.dtype != torch.float32:
        raise TypeError(f"dtypes q {q.dtype} k {k.dtype} v {v.dtype} out "
                        f"{out.dtype} dout {dout.dtype} lse {lse.dtype}")
    q, k, v, out, lse, dout = (t.contiguous() for t in ts)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if kind == "wgmma" and any(t.data_ptr() % 16 for t in
                               (q, k, v, out, dout, dq, dk, dv)):
        raise ValueError("the tensor-core flash backward loads and stores "
                         "its tiles by TMA: q, k, v, out and dout must "
                         "start on 16-byte boundaries")
    args = (B, Sq, Sk, H, K, D, bool(causal), int(window), Dv)
    pl = plan(*args)
    sqp = -(-Sq // TILE) * TILE
    scratch = torch.empty(2 * B * H * sqp if kind == "wgmma" else B * Sq * H,
                          dtype=torch.float32, device=q.device)
    if build.shape_only(q):
        return dq, dk, dv
    # uploaded once a shape and kept: not a per-call allocation
    table = _device_table(q.device, *args)
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
                table.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), B, Sq, Sk, H, K, D, Dv, int(causal),
                int(window),
                len(pl.dkdv), len(pl.dq), ROUTES.index(kind),
                build.dtype_code(q), build.stream_ptr())
    build.check(err, "rt_flash_attention_bwd")
    return dq, dk, dv
