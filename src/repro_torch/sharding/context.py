"""ShardedContext and TreePlan: ZeRO data parallelism for the RLHF
engines — the port of ``repro/sharding/context.py`` (``:110-407``) on
``torch.distributed``.

The reference is one controller over many devices: it places global
arrays on a mesh and XLA derives the collectives. The port is SPMD: one
process a rank, each running the same trainer calls, each holding its own
part of every tree. A sharded leaf is the rank's contiguous ``narrow`` of
its spec's DP dim (``clone``d, so it owns only those bytes); a replicated
leaf is whole on every rank. A :class:`ShardedContext` wraps the mesh, the
``data`` group's collectives and a :class:`~repro_torch.sharding.rules.
ShardingStrategy`, and hands out one :class:`TreePlan` a parameter tree
(full model trees and hydra adapters) with

  * the **state specs** the tree is stored under between steps (ZeRO-3
    shards params over ``data``; stages 1-2 keep them whole),
  * the **optimizer specs** (sharded over ``data`` from ZeRO-1 up:
    ``zero_opt_pspecs`` and ``AdamW.init_specs``), which are also the
    **update specs** the gradients are sliced to,
  * the **compute specs**: the state specs with the DP entries stripped,
    what a forward gathers to.

The execution contract is the reference's (``:26-33``): a step gathers the
params to the compute specs before any product, computes the loss and the
gradients on the gathered values, clips them by the norm of the full
gradients, re-shards them onto the update layout (with a replicated batch
a **slice**, not a reduction), runs AdamW on the rank's shard in place, and
then all-gathers the new params (stages 1-2) or keeps the shard (stage 3).
So every stage gives the one-rank bits when the batch is replicated.

Gathers come in two granularities (``ShardingStrategy.gather_mode``):

  * ``"tree"``: the whole tree is gathered before the forward; the
    transient is the replicated model;
  * ``"layer"``: the layer leaves stay sharded and ``Model._stack_fwd``
    gathers each layer just before it runs (:class:`LayerGather`, a
    ``torch.autograd.Function`` whose backward slices the full gradient
    to the rank's shard, or reduce-scatters it under a sharded batch);
    the gathered layer dies after it. Under ``remat`` the gather sits
    inside the checkpoint, so the recompute re-gathers. Non-layer leaves
    (embedding, head, final norm, value head, MTP modules) gather whole.

Collectives go through :class:`Collectives`. On a gloo group, CUDA
tensors are copied through pinned host memory (``staged_bytes`` counts
them): the port uses gloo only on the CPU and for ranks sharing one card,
and its CUDA paths are never asked.

**Tensor parallelism** (``create(model=ntp)``, ntp > 1) adds a second
:class:`Collectives` on the ``model`` group, wrapped in a
``sharding.tp.TensorParallel`` (``ShardedContext.tp``), and the specs'
``"model"`` entries: a plan places a whole leaf by taking the rank's
``1/ntp`` cut along its model entry first (every rank builds the whole
tree from the seed, or from weights carried across from JAX, and keeps
its cut), then its ZeRO part of that. Everything above moves the DP dim
alone: ``shapes`` are the TP-local shapes, the compute specs keep their
model entries (``_strip_dp``), and ZeRO gathers never touch the math cut
(DESIGN.md §9). A step's global norm sums a model-cut leaf's squares over
the model group and counts a replicated leaf once
(``TreePlan.tp_cut``). Contexts on a ``SpecMesh`` give the same spec
trees for the simulator.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.optim.clip import sq_sum
from repro_torch.sharding.rules import (MODEL_AXIS, P, ShardingStrategy,
                                        SpecMesh, _axsize, adapter_pspecs,
                                        dp_axes, param_pspecs, spec_leaves,
                                        spec_map, validate_tp,
                                        zero_opt_pspecs)
from repro_torch.sharding.tp import (TensorParallel, check_supported,
                                     register)
from repro_torch.tree import leaves, nbytes


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------
# the most bytes (of shards) one coalesced all-gather packs
COALESCE_BYTES = 256 * 2**20


class Collectives:
    """The rank's collectives over one process group. ``batch_sharded``
    is set while a step runs on a rank's share of the batch
    (:meth:`ShardedContext.sharded_batch`): gradients are then summed over
    the ranks, and loss denominators counted over the whole batch."""

    def __init__(self, group, device):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = dist.get_backend(group)
        self.device = torch.device(device)
        # gloo on CUDA tensors: every collective stages through pinned host
        # memory (explicit, counted); never a fallback from another backend
        self.stage = self.backend == "gloo" and self.device.type == "cuda"
        self.staged_bytes = 0
        self.batch_sharded = False

    # ----------------------------------------------------------- staging
    def _out(self, t: torch.Tensor) -> torch.Tensor:
        if not (self.stage and t.is_cuda):
            return t.contiguous()
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        self.staged_bytes += h.numel() * h.element_size()
        return h

    def _back(self, h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if h.device == like.device:
            return h
        self.staged_bytes += h.numel() * h.element_size()
        return h.to(like.device)

    def _empty(self, shape, like: torch.Tensor) -> torch.Tensor:
        if self.stage and like.is_cuda:
            return torch.empty(shape, dtype=like.dtype, pin_memory=True)
        return torch.empty(shape, dtype=like.dtype, device=like.device)

    # ------------------------------------------------------- collectives
    @torch.no_grad()
    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The rank shards ``t`` concatenated along ``dim`` in rank order:
        a new tensor, also on one rank."""
        src = self._out(t)
        out = self._empty((self.size,) + tuple(t.shape), t)
        dist.all_gather(list(out.unbind(0)), src, group=self.group)
        out = self._back(out, t)
        if dim == 0:
            return out.reshape((self.size * t.shape[0],) + tuple(t.shape[1:]))
        return torch.cat(out.unbind(0), dim=dim)

    @torch.no_grad()
    def all_gather_many(self, tensors, dims) -> List[torch.Tensor]:
        """:meth:`all_gather` of each of ``tensors`` along its dim of
        ``dims``, packed into one collective a dtype and up to
        ``COALESCE_BYTES`` a call (fewer, larger messages; the same
        bits)."""
        out: List[Optional[torch.Tensor]] = [None] * len(tensors)
        groups: dict = {}
        for i, t in enumerate(tensors):
            grp = groups.setdefault(t.dtype, [[]])
            nb = sum(tensors[j].numel() for j in grp[-1]) * t.element_size()
            if grp[-1] and nb + t.numel() * t.element_size() > \
                    COALESCE_BYTES:
                grp.append([])
            grp[-1].append(i)
        for grp in groups.values():
            for idx in grp:
                if len(idx) == 1:
                    out[idx[0]] = self.all_gather(tensors[idx[0]],
                                                  dims[idx[0]])
                    continue
                flat = torch.cat([tensors[i].reshape(-1) for i in idx])
                parts = self.all_gather(flat, 0).view(self.size, -1)
                del flat
                off = 0
                for i in idx:
                    t, n = tensors[i], tensors[i].numel()
                    # one copy a tensor, into storage of its own (the
                    # per-layer gather tells gathered weights by storage)
                    out[i] = torch.cat([parts[r, off:off + n].view(t.shape)
                                        for r in range(self.size)],
                                       dim=dims[i])
                    off += n
                del parts
        return out

    @torch.no_grad()
    def all_reduce_(self, t: torch.Tensor, op=dist.ReduceOp.SUM
                    ) -> torch.Tensor:
        """Reduce ``t`` over the ranks, in place; returns ``t``."""
        src = self._out(t)
        dist.all_reduce(src, op=op, group=self.group)
        if src is not t:
            t.copy_(self._back(src, t))
        return t

    def max_int(self, x: int) -> int:
        """The largest of the ranks' ``x``."""
        t = torch.tensor([int(x)], dtype=torch.int64)
        if self.backend == "nccl":
            t = t.to(self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return int(t.item())

    def local(self, full: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's contiguous part of ``full`` along ``dim`` (a view)."""
        n = full.shape[dim] // self.size
        return full.narrow(dim, self.rank * n, n)

    def shard_grad(self, g: torch.Tensor, dim: int) -> torch.Tensor:
        """The full gradient ``g`` re-sharded to this rank's part of
        ``dim``: a slice, or under a sharded batch a reduce-scatter."""
        if self.batch_sharded:
            g = self.all_reduce_(g.clone(memory_format=torch.contiguous_format))
        return self.local(g, dim).contiguous()


# ---------------------------------------------------------------------------
# Spec helpers
# ---------------------------------------------------------------------------
def _strip_dp(spec: P, mesh) -> P:
    """Remove the DP axes from a spec, keeping TP entries: the compute
    layout a ZeRO-3 gather targets."""
    dp = set(dp_axes(mesh))

    def keep(entry):
        if entry is None:
            return None
        es = entry if isinstance(entry, tuple) else (entry,)
        kept = tuple(e for e in es if e not in dp)
        if not kept:
            return None
        return kept if len(kept) > 1 else kept[0]

    return P(*(keep(e) for e in spec))


def _dp_dim(spec: P, mesh) -> Optional[int]:
    """The dim a spec shards over the DP axes (None: whole over them)."""
    dp = set(dp_axes(mesh))
    for i, e in enumerate(spec):
        es = e if isinstance(e, tuple) else (e,)
        if any(a in dp for a in es if a is not None):
            return i
    return None


def _model_dim(spec: P) -> Optional[int]:
    """The dim a spec cuts over the ``model`` axis (None: whole over it)."""
    for i, e in enumerate(spec):
        if e == MODEL_AXIS or (isinstance(e, tuple) and MODEL_AXIS in e):
            return i
    return None


def delete_tree(tree) -> None:
    """Phase-boundary hygiene for owned copies (``TreePlan.gather_copy``):
    drop the tree's references to its tensors, so the caching allocator
    gets them back once nothing else holds them (the reference deletes
    the device buffers)."""
    if isinstance(tree, dict):
        for v in tree.values():
            delete_tree(v)
        tree.clear()
    elif isinstance(tree, list):
        for v in tree:
            delete_tree(v)
        tree.clear()


def tree_per_device_bytes(tree, comm: Optional[Collectives] = None) -> int:
    """The largest over the ranks of the bytes ``tree`` holds on a rank:
    replicated leaves count whole, ZeRO-3 leaves 1/ndp (the number that
    runs out of memory). Without ``comm``, this rank's bytes."""
    local = nbytes(tree)
    return local if comm is None else comm.max_int(local)


# ---------------------------------------------------------------------------
# Per-layer gathers
# ---------------------------------------------------------------------------
class _GatherLayer(torch.autograd.Function):
    """All-gathers a layer's shards in the forward; the backward gives
    each shard the rank's part of its full gradient, and notes the full
    gradient's sum of squares (``LayerGather.sumsq``) for the step's
    global norm."""

    @staticmethod
    def forward(ctx, lg, dims, *shards):
        ctx.lg, ctx.dims = lg, dims
        ctx.keys = tuple(id(s) for s in shards)
        return tuple(lg.comm.all_gather_many(shards, dims))

    @staticmethod
    def backward(ctx, *grads):
        comm, out = ctx.lg.comm, []
        for g, d, key, need in zip(grads, ctx.dims, ctx.keys,
                                   ctx.needs_input_grad[2:]):
            if g is None or not need:
                out.append(None)
                continue
            if comm.batch_sharded:
                g = comm.all_reduce_(
                    g.clone(memory_format=torch.contiguous_format))
            # the unsharded step squares the fp32 accumulation of this
            # gradient (0 + g: the same values, contiguous)
            full = g.to(torch.float32, memory_format=torch.contiguous_format)
            ctx.lg.sumsq.setdefault(key, []).append(sq_sum(full))
            del full
            out.append(comm.local(g, d).contiguous())
        return (None, None, *out)


class _Regather:
    """A gathered weight that autograd saved, kept as its shard: the
    backward gathers it again (``LayerGather.saving_shards``)."""

    def __init__(self, lg, shard, dim, size, stride, offset):
        self.lg, self.shard, self.dim = lg, shard, dim
        self.size, self.stride, self.offset = size, stride, offset

    def unpack(self) -> torch.Tensor:
        self.lg.regathered += 1
        full = self.lg.comm.all_gather(self.shard, self.dim)
        return full.as_strided(self.size, self.stride, self.offset)


class LayerGather:
    """The per-layer ZeRO-3 gather ``Model._stack_fwd`` runs: ``specs[i]``
    is layer i's state spec tree; :meth:`gather` returns layer i with its
    sharded leaves gathered (differentiably). ``sumsq`` collects, a
    backward at a time, each shard's full gradient's sum of squares, keyed
    by the shard tensor's ``id``; a step clears it (:meth:`reset`).
    ``regathered`` counts the saved weights gathered again in backwards,
    ``norms_taken`` the sums a step took from ``sumsq``."""

    def __init__(self, specs: list, comm: Collectives, mesh):
        self.specs, self.comm, self.mesh = specs, comm, mesh
        self.sumsq = {}
        self.regathered = self.norms_taken = 0

    def reset(self) -> None:
        self.sumsq = {}

    def take_sumsq(self, shard) -> Optional[torch.Tensor]:
        """The one full-gradient sum of squares noted for ``shard`` (None
        where there was none or several: microbatches)."""
        got = self.sumsq.pop(id(shard), None)
        if got is None or len(got) != 1:
            return None
        self.norms_taken += 1
        return got[0]

    def _gather(self, i: int, layer):
        """(layer i gathered, [(gathered, shard, dim)])."""
        flat: List[Tuple[torch.Tensor, int]] = []

        def collect(s, x):
            d = _dp_dim(s, self.mesh) if torch.is_tensor(x) else None
            if d is not None:
                flat.append((x, d))
            return x

        spec_map(collect, self.specs[i], layer)
        if not flat:
            return layer, []
        full = _GatherLayer.apply(self, tuple(d for _, d in flat),
                                  *(x for x, _ in flat))
        it = iter(full)
        tree = spec_map(
            lambda s, x: next(it) if (torch.is_tensor(x) and
                                      _dp_dim(s, self.mesh) is not None)
            else x, self.specs[i], layer)
        return tree, [(f, x, d) for f, (x, d) in zip(full, flat)]

    def gather(self, i: int, layer):
        return self._gather(i, layer)[0]

    @contextmanager
    def saving_shards(self, i: int, layer):
        """Layer i gathered, for a forward that autograd records: within,
        a gathered weight that an op saves for the backward is kept as its
        shard and gathered again when the backward needs it, so the
        gathered layer dies with the forward's last use (the unsharded
        weights' bits either way)."""
        tree, gathered = self._gather(i, layer)
        by_storage = {f.untyped_storage().data_ptr(): (x, d)
                      for f, x, d in gathered}

        def pack(t):
            hit = by_storage.get(t.untyped_storage().data_ptr()) \
                if t.device.type != "meta" else None
            if hit is None:
                return t
            return _Regather(self, hit[0], hit[1], t.size(), t.stride(),
                             t.storage_offset())

        def unpack(p):
            return p.unpack() if isinstance(p, _Regather) else p

        with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            yield tree


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TreePlan:
    """Sharding plan for one parameter tree and its optimizer state."""
    mesh: Any                      # SpecMesh the specs are named on
    strat: ShardingStrategy
    param_specs: Any               # state placement (ZeRO-3: DP-sharded)
    compute_specs: Any             # DP entries stripped (gather target)
    opt_specs: Optional[Any] = None
    # param-shaped layout of the optimizer shards (``zero_opt_pspecs``):
    # the layout the gradients are sliced to and the params updated on
    update_specs: Optional[Any] = None
    # per-layer mode (ZeRO-3, gather_mode "layer"): the tree-level gather
    # target, where "layers" keeps its state specs and every other leaf
    # goes to its compute spec; and the per-layer gather (a LayerGather on
    # a process group, a list of per-layer DP-stripped spec trees on a
    # SpecMesh). Both None in "tree" mode and below stage 3.
    layer_param_specs: Optional[Any] = None
    layer_specs: Optional[Any] = None
    comm: Optional[Collectives] = None
    # the whole leaves' shapes over ``data`` (param-shaped; each model
    # entry's dim already cut to the rank's 1/ntp), so that placement and
    # the gradients' slicing tell a whole tensor from a rank's part
    shapes: Optional[Any] = None
    # the model group's operators (tensor parallelism), or None
    tp: Optional[Any] = None
    # the ShardedContext that made the plan: the ambient mesh of a step on
    # it (``steps``), whose data axis and ``comm.batch_sharded`` the MoE
    # FFN's routing reads (``models/moe.py``)
    context: Optional[Any] = field(default=None, repr=False, compare=False)

    @property
    def gather_mode(self) -> str:
        return "layer" if self.layer_param_specs is not None else "tree"

    @property
    def sharded(self) -> bool:
        """Whether the params are stored sharded (ZeRO-3)."""
        return self.compute_specs is not self.param_specs

    def _need_comm(self) -> Collectives:
        if self.comm is None:
            raise RuntimeError("a plan on a SpecMesh names specs only; "
                               "build the context on a process group")
        return self.comm

    # ------------------------------------------------------------ gathers
    def _gather_leaves(self, params, targets, made, kept):
        """``params`` with each leaf whose state spec differs from its spec
        in ``targets`` gathered whole (coalesced collectives), passed
        through ``made(whole, leaf)``; every other leaf through
        ``kept(leaf)``."""
        comm = self._need_comm()
        todo = []

        def pick(s, c, x):
            if torch.is_tensor(x) and s != c:
                todo.append((x.detach(), _dp_dim(s, self.mesh)))
            return x

        spec_map(pick, self.param_specs, targets, params)
        whole = iter(comm.all_gather_many([x for x, _ in todo],
                                          [d for _, d in todo]))
        return spec_map(
            lambda s, c, x: (made(next(whole), x) if s != c else kept(x))
            if torch.is_tensor(x) else x,
            self.param_specs, targets, params)

    def gather(self, params):
        """The params at the gather target, for a forward: whole leaves
        where the state spec is sharded (fresh tensors, requiring grad as
        the state leaf does); the state leaves themselves elsewhere. In
        layer mode ``params["layers"]`` stays sharded (the model gathers
        each layer). A no-op below stage 3."""
        if not self.sharded:
            return params
        target = self.layer_param_specs if self.layer_param_specs \
            is not None else self.compute_specs
        return self._gather_leaves(
            params, target, lambda full, x: full.requires_grad_(
                x.requires_grad), lambda x: x)

    def gather_copy(self, params):
        """A DP-gathered copy of ``params`` for the rollout -> ``(tree,
        owned)``. Below ZeRO-3 the compute specs are the state specs: the
        live tree itself comes back (``owned=False``; the caller must not
        delete it). At ZeRO-3 every leaf is a fresh tensor
        (``owned=True``), whole leaves copied too, so that deleting the
        copy never touches live state; its bytes go to the global
        registry's ``sharding_gather_copy_bytes_total``."""
        if not self.sharded or self.strat.zero_stage < 3:
            return params, False
        with torch.no_grad():
            gathered = self._gather_leaves(
                params, self.compute_specs, lambda full, x: full,
                lambda x: x.detach().clone())
        from repro_torch.obs.metrics import global_registry
        global_registry().counter(
            "sharding_gather_copy_bytes_total",
            "bytes materialized by TreePlan.gather_copy (ZeRO-3 rollout "
            "gathers)").inc(nbytes(gathered))
        return gathered, True

    def gathered_bytes(self, params) -> int:
        """Global bytes this plan all-gathers a step at ZeRO-3: the leaves
        whose state spec differs from the compute spec, at their full
        size. Tree and layer modes move the same total."""
        if self.strat.zero_stage < 3 or not self.sharded:
            return 0
        total = 0

        def add(s, c, x, shape):
            nonlocal total
            if torch.is_tensor(x) and s != c:
                n = 1
                for d in shape:
                    n *= d
                total += n * x.element_size()
            return x

        spec_map(add, self.param_specs, self.compute_specs, params,
                 self.shapes)
        return total

    def tp_cut(self) -> List[bool]:
        """Per leaf (param-shaped, in tree order): whether its spec cuts it
        over the model axis (a gradient's squares are then summed over the
        model group for the global norm; a whole leaf counts once)."""
        return [self.tp is not None and _model_dim(s) is not None
                for s in spec_leaves(self.param_specs)]

    def grad_layout(self, grads) -> List[Tuple[bool, Optional[int]]]:
        """Per leaf of ``grads`` (param-shaped, in tree order): whether the
        step's gradient is already this rank's shard (a layer-mode layer
        leaf, gathered inside the model) and its spec's DP dim."""
        target = self.layer_param_specs if self.layer_param_specs \
            is not None else self.compute_specs
        out = []
        for s, c in zip(spec_leaves(self.param_specs), spec_leaves(target)):
            d = _dp_dim(s, self.mesh)
            out.append((self.sharded and d is not None and s == c, d))
        n = sum(1 for _ in leaves(grads))
        if n != len(out):
            raise ValueError(f"{n} gradients for a plan of {len(out)} leaves")
        return out

    # ---------------------------------------------------------- placement
    def _size(self) -> int:
        return 1 if self.comm is None else self.comm.size

    def _is_whole(self, x, shape) -> bool:
        """Whether ``x`` is a whole leaf of a sharded spec (so this rank
        keeps a part of it); at one rank the part is the whole."""
        return self._size() > 1 and tuple(x.shape) == tuple(shape)

    def _place(self, tree, specs, shapes):
        """Whole tensors -> this rank's parts under ``specs`` (owned
        copies; a leaf keeps its ``requires_grad``): the model entry's cut
        first (a leaf at its whole shape over the model axis), then the DP
        one. Leaves whose spec is whole, and leaves that are parts
        already, come back as they are (placing twice is placing once)."""
        if specs is None:
            return tree

        def place(s, x, shape):
            if not torch.is_tensor(x) or not isinstance(s, P):
                return x
            t = _model_dim(s)
            if self.tp is not None and t is not None and \
                    x.shape[t] == shape[t] * self.tp.size:
                x = self.tp.comm.local(x.detach(), t).clone(
                    memory_format=torch.contiguous_format
                ).requires_grad_(x.requires_grad)
            d = _dp_dim(s, self.mesh)
            if d is None or not self._is_whole(x, shape):
                return x
            part = self._need_comm().local(x.detach(), d).clone(
                memory_format=torch.contiguous_format)
            return part.requires_grad_(x.requires_grad)

        with torch.no_grad():
            return spec_map(place, specs, tree, shapes)

    def _opt_shapes(self, opt):
        """The optimizer state's whole shapes: AdamW's moments are
        param-shaped; any other state (Adafactor's statistics) has
        replicated specs, so its own shapes serve."""
        if set(opt) == {"mu", "nu", "count"}:
            return {"mu": self.shapes, "nu": self.shapes, "count": None}
        return spec_map(lambda s, x: tuple(x.shape) if torch.is_tensor(x)
                        else None, self.opt_specs, opt)

    def place_params(self, params):
        return self._place(params, self.param_specs, self.shapes)

    def place_opt(self, opt):
        return self._place(opt, self.opt_specs, self._opt_shapes(opt))

    def place_state(self, state):
        """Place a ``{"params", "opt", "step"}`` train state."""
        out = dict(state)
        out["params"] = self.place_params(state["params"])
        if "opt" in state:
            out["opt"] = self.place_opt(state["opt"])
        return out

    def _gathered_for_update(self, s, u) -> bool:
        """Whether a leaf of state spec ``s`` is updated whole (update spec
        ``u`` has no DP entry) while stored sharded: ZeRO-3 under a whole
        update layout (``Adafactor.update_pspecs``)."""
        return self.sharded and _dp_dim(s, self.mesh) is not None and \
            _dp_dim(u, self.mesh) is None

    def update_views(self, params):
        """The params on the update layout, for the optimizer in place: at
        ZeRO-3 the state shards themselves, or where the update layout is
        whole, whole gathered copies (:meth:`all_gather_updated_` cuts
        them back); below, views of this rank's part of each whole param
        (whole where the update spec is whole)."""
        if self.update_specs is None or self._size() == 1:
            return params
        if self.sharded:
            if not any(self._gathered_for_update(s, u) for s, u in zip(
                    spec_leaves(self.param_specs),
                    spec_leaves(self.update_specs))):
                return params
            with torch.no_grad():
                return self._gather_leaves(params, self.update_specs,
                                           lambda full, x: full,
                                           lambda x: x)
        comm = self._need_comm()

        def view(s, p):
            d = _dp_dim(s, self.mesh)
            return p if d is None else comm.local(p, d)

        return spec_map(view, self.update_specs, params)

    def place_grads(self, grads):
        """Gradients -> the update layout: a whole gradient is sliced to
        this rank's part (under a sharded batch it was summed over the
        ranks before); a gradient that is a part already (a layer-mode
        layer leaf's) stays, or is gathered whole where the update layout
        is whole."""
        if self.update_specs is None:
            return grads
        comm = self._need_comm()
        todo = []

        def slice_(s, u, g, shape):
            if g is not None and self._gathered_for_update(s, u) and \
                    tuple(g.shape) != tuple(shape):
                todo.append((g, _dp_dim(s, self.mesh)))
                return g
            d = _dp_dim(u, self.mesh)
            if g is None or d is None or not self._is_whole(g, shape):
                return g
            return comm.local(g, d).contiguous()

        out = spec_map(slice_, self.param_specs, self.update_specs, grads,
                       self.shapes)
        if not todo:
            return out
        whole = {id(g): w for (g, _), w in zip(todo, comm.all_gather_many(
            [g for g, _ in todo], [d for _, d in todo]))}
        return spec_map(lambda s, g: whole.get(id(g), g) if
                        torch.is_tensor(g) else g, self.param_specs, out)

    @torch.no_grad()
    def all_gather_updated_(self, params, views=None) -> None:
        """Stages 1-2: after the update of this rank's part of each whole
        param, all-gather the parts back into the whole param, in place
        (coalesced collectives). ZeRO-3 with a whole update layout: copy
        this rank's part of each updated whole copy (``views``, from
        :meth:`update_views`) into its state shard."""
        if self.update_specs is None or self._size() == 1:
            return
        comm = self._need_comm()
        if self.sharded:
            if views is None:
                return

            def cut(s, u, p, w):
                if torch.is_tensor(p) and self._gathered_for_update(s, u):
                    p.copy_(comm.local(w, _dp_dim(s, self.mesh)))
                return p

            spec_map(cut, self.param_specs, self.update_specs, params, views)
            return
        todo = []

        def pick(s, p):
            d = _dp_dim(s, self.mesh)
            if d is not None:
                todo.append((p, d))
            return p

        spec_map(pick, self.update_specs, params)
        whole = comm.all_gather_many([comm.local(p, d) for p, d in todo],
                                     [d for _, d in todo])
        for (p, _), w in zip(todo, whole):
            p.copy_(w)


class ShardedContext:
    """Mesh, collectives and ZeRO strategy, threaded through the trainer,
    the engine and the steps. ``mesh`` is a ``DeviceMesh`` with dims
    ``("data", "model")`` (runtime) or a ``SpecMesh`` (specs only)."""

    def __init__(self, mesh, strat: Optional[ShardingStrategy] = None, *,
                 device=None):
        self.strat = strat or ShardingStrategy()
        self.mesh = mesh
        self.tp: Optional[TensorParallel] = None
        if isinstance(mesh, SpecMesh):
            self.spec_mesh = mesh
            self.comm = None
        else:
            names = mesh.mesh_dim_names
            self.spec_mesh = SpecMesh(dict(zip(names, mesh.shape)))
            device = torch.device(device if device is not None
                                  else mesh.device_type)
            self.comm = Collectives(mesh.get_group("data"), device)
            if self.ntp > 1:
                self.tp = TensorParallel(Collectives(mesh.get_group("model"),
                                                     device))
                register(mesh, self.tp)

    @classmethod
    def create(cls, ndp: int = 1, *, zero_stage: int = 3, model: int = 1,
               gather_mode: str = "layer", device: str = "cuda",
               backend: Optional[str] = None,
               cfg=None) -> "ShardedContext":
        """A ``(data=ndp, model)`` context over the initialised default
        group (``launch.mesh.make_zero_mesh``): NCCL for ``device="cuda"``
        and gloo for ``"cpu"`` unless ``backend`` says otherwise (gloo on
        CUDA tensors for ranks sharing one card). ``model`` is the TP
        degree; at 1 the strategy keeps ``tensor_parallel`` off, so the
        spec trees are the pure-ZeRO ones. ``cfg`` (a config or a
        sequence of them) is checked against ``model`` before any group is
        touched: ``rules.validate_tp``, and what the port does not run
        tensor parallel (``sharding.tp.check_supported``, which refuses a
        KV head count that ``model`` does not divide, among others);
        ``plan_params`` checks again."""
        if gather_mode not in ("layer", "tree"):
            raise ValueError(f"gather_mode must be layer or tree, not "
                             f"{gather_mode!r}")
        for c in (() if cfg is None else
                  cfg if isinstance(cfg, (list, tuple)) else (cfg,)):
            validate_tp(c, model)
            check_supported(c, model)
        from repro_torch.launch.mesh import make_zero_mesh
        mesh = make_zero_mesh(ndp, model=model, device=device,
                              backend=backend)
        return cls(mesh, ShardingStrategy(zero_stage=zero_stage,
                                          tensor_parallel=model > 1,
                                          ntp=model,
                                          gather_mode=gather_mode),
                   device=device)

    @property
    def ndp(self) -> int:
        return _axsize(self.spec_mesh, dp_axes(self.spec_mesh))

    @property
    def ntp(self) -> int:
        return self.spec_mesh.shape.get("model", 1)

    @property
    def zero_stage(self) -> int:
        return self.strat.zero_stage

    @contextmanager
    def sharded_batch(self):
        """Within: each rank runs on its own share of the batch, so layer
        gradients reduce-scatter and loss denominators count the whole
        batch (``steps``)."""
        comm = self.comm
        prev = comm.batch_sharded
        comm.batch_sharded = True
        try:
            yield
        finally:
            comm.batch_sharded = prev

    # ------------------------------------------------------------- plans
    def _plan(self, pspecs, shapes, optimizer, *,
              layerwise: bool = False) -> TreePlan:
        strat, mesh = self.strat, self.spec_mesh
        opt_specs = update_specs = None
        if optimizer is not None:
            base = zero_opt_pspecs(pspecs, shapes, mesh, strat)
            opt_specs = optimizer.init_specs(base, shapes)
            # optimizers whose update reduces across elements (Adafactor)
            # declare their own, whole, update layout
            upd = getattr(optimizer, "update_pspecs", None)
            if upd is not None and self.ntp > 1:
                raise NotImplementedError(
                    f"{type(optimizer).__name__} under tensor parallelism "
                    "(its whole update layout over model cuts) is not ported")
            update_specs = upd(base, shapes) if upd is not None else base
        compute = spec_map(lambda s: _strip_dp(s, mesh), pspecs) \
            if strat.zero_stage >= 3 else pspecs
        layer_full = layer_slices = None
        if layerwise and strat.zero_stage >= 3 and \
                strat.gather_mode == "layer" and isinstance(pspecs, dict) \
                and "layers" in pspecs:
            layer_full = {k: (v if k == "layers" else compute[k])
                          for k, v in pspecs.items()}
            if self.comm is None:
                layer_slices = [spec_map(lambda s: _strip_dp(s, mesh), t)
                                for t in pspecs["layers"]]
            else:
                layer_slices = LayerGather(pspecs["layers"], self.comm, mesh)
        ntp = self.ntp

        def local_shape(s, x):
            shape, t = list(x.shape), _model_dim(s)
            if t is not None:
                shape[t] //= ntp
            return tuple(shape)

        shape_tree = spec_map(local_shape, pspecs, shapes)
        return TreePlan(mesh, strat, pspecs, compute, opt_specs,
                        update_specs, layer_param_specs=layer_full,
                        layer_specs=layer_slices, comm=self.comm,
                        shapes=shape_tree, tp=self.tp, context=self)

    def plan_params(self, cfg, params_shape, optimizer=None) -> TreePlan:
        """Plan for a full model tree (``rules.param_pspecs``). Layer mode
        gathers ``params["layers"]`` one layer at a time; configs whose
        layers are read outside the layer loop (encoder-decoder) gather
        whole, as in the reference."""
        if self.comm is not None:     # a run; a SpecMesh names specs only
            validate_tp(cfg, self.ntp)
            check_supported(cfg, self.ntp)
        pspecs = param_pspecs(cfg, self.spec_mesh, self.strat, params_shape)
        layerwise = getattr(cfg, "input_mode", "tokens") != "encdec"
        return self._plan(pspecs, params_shape, optimizer,
                          layerwise=layerwise)

    def plan_adapter(self, adapter_shape, optimizer=None) -> TreePlan:
        """Plan for a hydra LoRA adapter (``rules.adapter_pspecs``);
        adapters always gather whole."""
        pspecs = adapter_pspecs(self.spec_mesh, self.strat, adapter_shape)
        return self._plan(pspecs, adapter_shape, optimizer)


__all__ = ["Collectives", "LayerGather", "ShardedContext", "TreePlan",
           "delete_tree", "tree_per_device_bytes"]
