"""Liveness tracer: turns a real PyTorch computation into the alloc/free
event stream that drives the allocator simulator — the port of
``repro/core/trace.py``.

The reference walks a jaxpr with last-use liveness. The port runs the
function itself, eagerly, on ``meta`` tensors (shapes and dtypes, no data,
no device) under a ``TorchDispatchMode`` that sees every ATen op, the
backward's included:

  * an op output whose storage is new (neither an input's storage nor a
    view of one) is an **alloc** of the storage's bytes; in-place ops and
    views allocate nothing;
  * the storage's death (PyTorch's own refcount, read through a weak
    reference after each op) is its **free** — the liveness the caching
    allocator sees, which the jaxpr's last use approximates;
  * **inputs** are persistent: they emit no event. The function's
    **outputs** stay live to the end, as in the reference;
  * the kernel wrappers' ``meta`` route (``kernels.build.shape_only``)
    allocates a kernel's outputs and scratch, and nothing of its plain
    version, as the reference's jaxpr holds one ``pallas_call``;
  * checkpointed layers (``cfg.remat``) recompute in the backward, so
    gradient checkpointing's liveness change emerges from the run.

Tags: inputs carry their own (param / opt / input / cache); an alloc is
``grad`` when it has a param leaf's shape and its bytes (or twice a bf16
leaf's: the fp32 accumulators of ``steps._accumulated_grads``) and is made
in the backward or after it (clipping, the update), or by a ``*_like`` of
a param; else ``temp``. The reference matches on bytes alone, which over
its layer-stacked leaves catches only gradients; over the port's
per-layer leaves it would also catch every activation of a weight's size
(at the paper's scale most of a layer's), which the strategies would then
scale as gradients. The
port keeps one parameter dict per layer where the reference scans stacked
leaves, so its ``layer_slice`` (the ZeRO-3 per-layer gather the
strategies scale) is one synthetic alloc of the layer's parameter bytes
each time the walk enters a layer — an op reads one of the layer's
``param`` leaves (forward, recompute, backward; a ``*_like`` factory
reads only a shape) — freed when it reads another layer's or a
top-level param. The optimizer update, from the
first op that touches an ``opt`` input on, is no layer walk: the
reference updates its stacked leaves outside any scan.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

Event = Tuple[str, int, int, str]   # (op, vid, nbytes, tag)

# ops that read a tensor's shape alone: they enter no layer
_SHAPE_OPS = frozenset(getattr(torch.ops.aten, n) for n in (
    "empty_like", "zeros_like", "ones_like", "full_like"))


@dataclass
class Trace:
    events: List[Event] = field(default_factory=list)
    n_vars: int = 0
    # vid -> the ATen op that allocated it (not in the reference's events)
    made_by: Dict[int, str] = field(default_factory=dict)
    # bytes of the persistent inputs, by tag
    inputs: Dict[str, int] = field(default_factory=dict)

    def alloc(self, vid: int, nbytes: int, tag: str):
        self.events.append(("alloc", vid, nbytes, tag))

    def free(self, vid: int, nbytes: int, tag: str):
        self.events.append(("free", vid, nbytes, tag))

    def total_alloc_bytes(self) -> int:
        return sum(e[2] for e in self.events if e[0] == "alloc")

    def peak_live(self) -> int:
        live = peak = 0
        for op, _, b, _ in self.events:
            live += b if op == "alloc" else -b
            peak = max(peak, live)
        return peak

    def live_at_peak(self) -> Tuple[Dict[str, int], Dict[str, int]]:
        """The bytes live at the (first) peak, by tag and by the op that
        allocated them."""
        live: Dict[int, Tuple[int, str]] = {}
        total = peak = 0
        snap: Dict[int, Tuple[int, str]] = {}
        for op, vid, b, tag in self.events:
            if op == "alloc":
                live[vid] = (b, tag)
                total += b
                if total > peak:
                    peak, snap = total, dict(live)
            else:
                live.pop(vid, None)
                total -= b
        by_tag: Dict[str, int] = {}
        by_op: Dict[str, int] = {}
        for vid, (b, tag) in snap.items():
            by_tag[tag] = by_tag.get(tag, 0) + b
            op = self.made_by.get(vid, tag)
            by_op[op] = by_op.get(op, 0) + b
        return by_tag, by_op


def _leaves_with_paths(tree, tags, path=()):
    """(path, tensor, tag) over ``tree``; ``tags`` mirrors it, or is one
    tag string for a whole subtree. Non-tensor leaves are skipped."""
    if isinstance(tree, torch.Tensor):
        yield path, tree, tags
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_paths(
                v, tags if isinstance(tags, str) else tags[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(
                v, tags if isinstance(tags, str) else tags[i], path + (i,))


def _layer_of(path) -> Optional[int]:
    """The layer index of a leaf under a ``"layers"`` list, else None."""
    for a, b in zip(path, path[1:]):
        if a == "layers" and isinstance(b, int):
            return b
    return None


class _Walk(TorchDispatchMode):
    """Emits the events of every op run under it (see the module doc)."""

    def __init__(self, trace: Trace, min_bytes: int, inputs: dict,
                 param_sizes: set, param_shapes: set,
                 layer_bytes: Dict[int, int]):
        super().__init__()
        self.trace, self.min_bytes = trace, min_bytes
        self.inputs = inputs                # storage key -> (tag, layer)
        self.param_sizes, self.param_shapes = param_sizes, param_shapes
        self.layer_bytes = layer_bytes
        self.ids = itertools.count(1)
        self.live: Dict[StorageWeakRef, Tuple[int, int, str]] = {}
        self.layer: Optional[int] = None
        self.slice: Optional[Tuple[int, int]] = None
        self.updating = False
        self.backward_seen = False

    def sweep(self):
        dead = [k for k in self.live if k.expired()]
        for k in dead:
            vid, nb, tag = self.live.pop(k)
            self.trace.free(vid, nb, tag)

    def _leave_layer(self):
        if self.slice is not None:
            self.trace.free(*self.slice, "layer_slice")
        self.layer = self.slice = None

    def _walk_layers(self, args):
        """Enter, leave or stay in a layer by the inputs ``args`` read."""
        read = [self.inputs.get(StorageWeakRef(t.untyped_storage()))
                for t in args if isinstance(t, torch.Tensor)]
        read = [r for r in read if r is not None]
        if any(tag == "opt" for tag, _ in read):
            self.updating = True
            self._leave_layer()
        if self.updating:
            return
        layers = {layer for tag, layer in read if tag == "param"}
        if not layers:
            return
        layer = layers.pop() if len(layers) == 1 else None
        if layer == self.layer:
            return
        self._leave_layer()
        if layer is None:
            return
        self.layer = layer
        nb = self.layer_bytes[layer]
        if nb >= self.min_bytes:
            self.slice = (next(self.ids), nb)
            self.trace.alloc(*self.slice, "layer_slice")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.sweep()
        shape_op = func.overloadpacket in _SHAPE_OPS
        if not shape_op:
            self._walk_layers(tree_leaves((args, kwargs)))
        if torch._C._current_autograd_node() is not None:
            self.backward_seen = True
        grads = self.backward_seen or shape_op
        out = func(*args, **kwargs)
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            nb = st.nbytes()
            if nb < self.min_bytes:
                continue
            key = StorageWeakRef(st)
            if key in self.live or key in self.inputs:
                continue
            tag = "grad" if grads and nb in self.param_sizes and \
                tuple(t.shape) in self.param_shapes else "temp"
            vid = next(self.ids)
            self.live[key] = (vid, nb, tag)
            self.trace.alloc(vid, nb, tag)
            self.trace.made_by[vid] = str(func.overloadpacket)
        return out


def trace_function(fn, args, arg_tags, *, min_bytes: int = 64 * 1024,
                   donate_tags: Sequence[str] = ()) -> Trace:
    """Trace ``fn(*args)`` on ``meta`` tensors. ``arg_tags`` mirrors
    ``args`` (a tag string may stand for a whole subtree) with the
    category of each persistent input: param | opt | input | cache.
    Returns the alloc/free event stream of what ``fn`` allocates (inputs
    emit no event; outputs stay live). ``donate_tags`` is the reference's
    argument; the port's steps write their state in place, so nothing is
    donated and it is ignored."""
    del donate_tags
    trace = Trace()
    inputs = {}
    param_sizes, param_shapes = set(), set()
    layer_bytes: Dict[int, int] = {}
    for path, t, tag in _leaves_with_paths(args, arg_tags):
        if t.device.type != "meta":
            raise ValueError(f"trace_function runs on meta tensors; "
                             f"{path} is on {t.device}")
        st = t.untyped_storage()
        layer = _layer_of(path) if tag == "param" else None
        inputs[StorageWeakRef(st)] = (tag, layer)
        nb = t.numel() * t.element_size()
        trace.inputs[tag] = trace.inputs.get(tag, 0) + nb
        if tag == "param":
            param_sizes.add(nb)
            param_shapes.add(tuple(t.shape))
            if t.element_size() == 2:
                param_sizes.add(2 * nb)   # fp32 grad/update temps of the leaf
            if layer is not None:
                layer_bytes[layer] = layer_bytes.get(layer, 0) + nb
    walk = _Walk(trace, min_bytes, inputs, param_sizes, param_shapes,
                 layer_bytes)
    with walk:
        out = fn(*args)
    walk.sweep()
    walk._leave_layer()
    # what is still live and not an output was held past the call (an
    # autograd graph or a cache): it dies with the call in the reference
    kept = {StorageWeakRef(t.untyped_storage()) for t in tree_leaves(out)
            if isinstance(t, torch.Tensor)}
    for key in [k for k in walk.live if k not in kept]:
        walk.trace.free(*walk.live.pop(key))
    trace.n_vars = next(walk.ids)
    return trace
