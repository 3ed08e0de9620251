"""Adafactor as the reference computes it (``repro/optim/adafactor.py``):
no first moment, and for a leaf of rank >= 2 whose last two dims are both
at least 128 a second moment factored over them (``vr`` over the rows,
``vc`` over the columns, per index of any leading axis); smaller leaves
keep a full second moment ``v``. fp32 statistics, the update clipped to
an RMS of ``clip_threshold`` over the whole leaf.

:meth:`Adafactor.update_` moves the params and the statistics in place,
chunk by chunk, so that a large leaf never has a whole-leaf fp32
temporary: one of DeepSeek-V3's expert leaves ``[256, 7168, 2048]`` holds
3.76 G elements, 15 GB in fp32. A leaf is viewed as ``[lead, rows,
cols]`` and cut into blocks of leading indices, and of rows where one
leading index is itself too large (the embedding): ``vr`` is per row and
``vc`` a column sum over the row blocks. The clip needs the update's RMS
over the whole leaf before any of it is applied, so the update takes three
passes over the gradient: the statistics, the sum of squares of the
update, then the update itself, recomputed from the new statistics.

"The whole leaf" is the reference's: it stacks a segment's layers on a
leading axis (``repro/models/transformer.py:35-50``), so its leaf
``segment{i}/slot{j}/...`` is the same path in every layer of segment
``i`` of the port's per-layer list, and the reference's ``mtp_extra``
stacks MTP depths 2..k. ``segments`` (the layer counts of the segments,
``ModelConfig.segment_layers``) says which of ``params["layers"]`` (and of
an adapter's ``["lora"]["layers"]``) share a clip; without it each layer
clips alone, as an unstacked tree does.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import torch

from repro_torch.tree import tree_map

# elements of a leaf a block of the update covers: its fp32 temporaries are
# a few times this many (1 GiB in all at 2^26)
BLOCK_ELEMS = 1 << 26


def _factored(p) -> bool:
    return p.dim() >= 2 and p.shape[-1] >= 128 and p.shape[-2] >= 128


def _walk(tree, path=()) -> Iterator[Tuple[tuple, torch.Tensor]]:
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@dataclass(frozen=True)
class Adafactor:
    decay: float = 0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    # layer counts of the reference's segments (see the module docstring)
    segments: Optional[Tuple[int, ...]] = None

    def init(self, params):
        def per_leaf(p):
            dev = p.device
            if _factored(p):
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=dev),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32, device=dev)}
            return {"v": torch.zeros(p.shape, dtype=torch.float32,
                                     device=dev)}

        return {"v": tree_map(per_leaf, params), "count": 0}

    def init_specs(self, param_specs, params=None):
        """Replicated statistics, as the reference's: the update reduces
        across elements (the factored means, the RMS clip), so under ZeRO
        it runs on whole operands (:meth:`update_pspecs`); the factored
        statistics are O(rows + cols) and the full ones belong to small
        leaves. The count is a host int."""
        from repro_torch.sharding.rules import P

        def per_leaf(p):
            if _factored(p):
                return {"vr": P(*([None] * (p.dim() - 1))),
                        "vc": P(*([None] * (p.dim() - 1)))}
            return {"v": P(*([None] * p.dim()))}

        return {"v": tree_map(per_leaf, params), "count": P()}

    def update_pspecs(self, param_specs, params=None):
        """The layout the update runs on: whole on every rank. A ZeRO step
        gathers the (rank-identical) gradients and params whole, updates
        them with every reduction in one device's order, and cuts the new
        params back onto the ZeRO layout (``steps._sharded_update_``), so
        every stage gives the bits of one rank."""
        from repro_torch.sharding.rules import P
        return tree_map(lambda p: P(*([None] * p.dim())), params)

    def state_bytes(self, params) -> int:
        """Bytes of the reference's state for ``params``: the fp32
        statistics and its int32 count (the port keeps the count as a
        Python int)."""
        total = 0
        for p in (t for _, t in _walk(params)):
            if _factored(p):
                total += 4 * (math.prod(p.shape[:-1]) +
                              math.prod(p.shape[:-2] + p.shape[-1:]))
            else:
                total += 4 * p.numel()
        return total + 4

    # ------------------------------------------------------------ update
    def _group(self, path: tuple) -> tuple:
        """The key of the reference leaf a port leaf is part of."""
        out, i = [], 0
        while i < len(path):
            k = path[i]
            if k in ("layers", "mtp") and i + 1 < len(path) and \
                    isinstance(path[i + 1], int):
                j = path[i + 1]
                if k == "mtp":
                    out += [k, min(j, 1)]       # depth 1, then mtp_extra
                elif self.segments is None:
                    out += [k, j]
                else:
                    ends = list(itertools.accumulate(self.segments))
                    out += [k, next(s for s, e in enumerate(ends) if j < e)]
                i += 2
                continue
            out.append(k)
            i += 1
        return tuple(out)

    def _blocks(self, shape) -> Iterator[Tuple[slice, slice]]:
        """(leading indices, rows) blocks of a leaf viewed as [lead, rows,
        cols]."""
        lead = math.prod(shape[:-2])
        rows, cols = shape[-2], shape[-1]
        per = max(1, BLOCK_ELEMS // (rows * cols))
        if per > 1 or rows * cols <= BLOCK_ELEMS:
            for a in range(0, lead, per):
                yield slice(a, min(a + per, lead)), slice(0, rows)
            return
        rper = max(1, BLOCK_ELEMS // cols)
        for a in range(lead):
            for r in range(0, rows, rper):
                yield slice(a, a + 1), slice(r, min(r + rper, rows))

    @staticmethod
    def _as3(t, shape):
        """A tensor of ``shape`` (rank >= 2) as [lead, rows, cols]."""
        return t.reshape(-1, shape[-2], shape[-1])

    def _stats_(self, g, v, beta, omb) -> None:
        """Pass 1: the new second-moment statistics of one leaf, in place."""
        eps = self.eps
        if "vr" in v:
            shape = g.shape
            g3 = self._as3(g, shape)
            vr = v["vr"].reshape(-1, shape[-2])
            vc = v["vc"].reshape(-1, shape[-1])
            csum, cur = None, None
            for lb, rb in self._blocks(shape):
                g2 = torch.square(g3[lb, rb].float()).add_(eps)
                vr[lb, rb].mul_(beta).add_(g2.mean(-1).mul_(omb))
                part = g2.sum(-2)
                if rb.start == 0:
                    csum, cur = part, lb
                else:
                    csum.add_(part)
                if rb.stop == shape[-2]:
                    vc[cur].mul_(beta).add_(csum.div_(shape[-2]).mul_(omb))
            return
        flat, vf = g.reshape(-1), v["v"].reshape(-1)
        for a in range(0, flat.numel(), BLOCK_ELEMS):
            blk = slice(a, a + BLOCK_ELEMS)
            g2 = torch.square(flat[blk].float()).add_(eps)
            vf[blk].mul_(beta).add_(g2.mul_(omb))

    def _updates(self, g, v) -> Iterator[Tuple[tuple, torch.Tensor]]:
        """Passes 2 and 3: the unclipped update of one leaf, block by
        block, from the new statistics -> (index into the leaf's block
        view, u fp32)."""
        eps = self.eps
        if "vr" in v:
            shape = g.shape
            g3 = self._as3(g, shape)
            vr = v["vr"].reshape(-1, shape[-2])
            vc = v["vc"].reshape(-1, shape[-1])
            vrm = torch.clamp(vr.mean(-1), min=eps)
            for lb, rb in self._blocks(shape):
                denom = vr[lb, rb][..., None] * vc[lb][:, None, :] / \
                    vrm[lb][:, None, None]
                u = g3[lb, rb].to(torch.float32, copy=True).mul_(
                    torch.rsqrt(denom.add_(eps)))
                yield (lb, rb), u
            return
        flat, vf = g.reshape(-1), v["v"].reshape(-1)
        for a in range(0, flat.numel(), BLOCK_ELEMS):
            blk = slice(a, a + BLOCK_ELEMS)
            yield (blk,), flat[blk].to(torch.float32, copy=True).mul_(
                torch.rsqrt(vf[blk] + eps))

    @torch.no_grad()
    def update_(self, grads, state, params, lr: float) -> None:
        """One Adafactor step of ``params`` by ``grads`` (read only),
        written into ``params`` and the statistics of ``state`` in place."""
        state["count"] += 1
        c = torch.tensor(float(state["count"]), dtype=torch.float32)
        beta = 1.0 - c ** (-self.decay)
        omb = 1.0 - beta
        groups = {}
        for path, p in _walk(params):
            groups.setdefault(self._group(path), []).append(
                (p, _at(grads, path), _at(state["v"], path)))
        for items in groups.values():
            dev = items[0][0].device
            b, o = beta.to(dev), omb.to(dev)
            for _, g, v in items:
                self._stats_(g, v, b, o)
            sq = torch.zeros((), dtype=torch.float32, device=dev)
            n = 0
            for _, g, v in items:
                for _, u in self._updates(g, v):
                    sq.add_(torch.sum(torch.square(u)))
                n += g.numel()
            rms = torch.sqrt(sq / n + 1e-12)
            div = torch.clamp(rms / self.clip_threshold, min=1.0)
            for p, g, v in items:
                view = self._as3(p, p.shape) if "vr" in v else p.reshape(-1)
                for idx, u in self._updates(g, v):
                    u.div_(div)
                    dst = view[idx]
                    p32 = dst.float()
                    if self.weight_decay:
                        u.add_(self.weight_decay * p32)
                    dst.copy_(p32.sub_(u.mul_(lr)))
