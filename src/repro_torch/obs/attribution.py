"""Per-buffer device-memory ownership attribution — the port of
``repro/obs/attribution.py``.

The sim-vs-measured delta on a phase span says *how far* a run diverged
from the allocator simulator; it cannot say *which subsystem owns the
divergent bytes*. A :class:`MemoryAttributor` holds a registry of **owner
trees** — named getters over the long-lived trees of a run (frozen trunk,
per-role adapters and value heads, optimizer states, rollout and
experience buffers, the merged rollout weights while they exist) — and
:meth:`MemoryAttributor.snapshot` splits the device's live bytes into an
owner -> bytes table.

PyTorch has no ``jax.live_arrays()``, so the walk differs from the
reference's; the contract does not:

    sum(owners.values()) + unattributed == total_bytes      (always, exactly)

and ``PhaseMemoryManager`` uses ``total_bytes`` *as* the record's live
bytes whenever an attributor is attached, so the owner table on a phase
span sums with the residue to the span's ``measured_bytes``.

  * **Identity is the storage** (``t.untyped_storage().data_ptr()``), not
    ``id()``: views and in-place outputs share a storage, which counts
    once. On an alias the first-registered owner wins, as in the
    reference (the hydra reference IS the base trunk).
  * **On CUDA** the total is ``torch.cuda.memory_allocated(device)``, the
    caching allocator's own figure. Each owner is charged the allocator
    block that holds its storage: the request rounded up to 512 bytes, the
    allocator's rule. ``unattributed`` is the rest (cuBLAS workspaces,
    graph pools, temporaries, and the slack of a block the allocator
    handed over whole). ``snapshot(full=True)`` walks
    ``torch.cuda.memory_snapshot()`` as well: owners are charged their
    blocks' real sizes and the top buffers are taken over every active
    block, owned or not. That walk costs more, so the per-record
    snapshot is the plain one (owner table and residue, no top buffers)
    and the flight recorder's dumps take the full one.
  * **On the CPU** no allocator metric exists: the walk covers the
    storages that ``tracked()`` returns together with the registered
    owners' — the set the trainer's CPU record counts — so the result is
    blind to tensors that other code left alive in the process.
  * **Host owners** are the ``HostParkingLot``'s parked trees, by name
    (``lot``); they never count in the device total.

Getters are re-read at every snapshot (offload repoints the state trees;
the merged rollout tree exists only inside the rollout phase); a getter
returning ``None`` contributes nothing. Snapshots store only metadata
(bytes, shape, dtype, owner, tree path) and never hold a tensor, so an
attributor cannot extend a buffer's lifetime.

The second half of the file is per-program memory accounting. The port
has no compiled program; the nearest counterpart of XLA's static
``memory_analysis()`` is a trace of the program on ``meta`` tensors
(``core.trace``), which never executes it: :func:`compiled_memory_stats`
and :func:`record_compiled_memory` (``temp`` is the trace's peak above the
arguments; ``generated_code`` is 0, there being no code object).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import default_device
from repro_torch.tree import tree_map

__all__ = ["AttributionSnapshot", "MemoryAttributor",
           "compiled_memory_stats", "record_compiled_memory"]


def _keystr(path: Tuple) -> str:
    """A tree path in ``jax.tree_util.keystr``'s form: ``['layers'][0]``."""
    return "".join(f"[{k!r}]" for k in path)


def _leaves(tree) -> List[torch.Tensor]:
    """The tensor leaves of a tree of dicts, lists and tuples, in order
    (an iterative walk: the per-record snapshot's hot loop)."""
    out, stack = [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, dict):
            stack.extend(reversed(x.values()))
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
    return out


def _path_of(tree, target: torch.Tensor, path=()) -> Optional[Tuple]:
    """The path of ``target`` in ``tree`` (for the few top buffers)."""
    if tree is target:
        return path
    items = tree.items() if isinstance(tree, dict) else \
        enumerate(tree) if isinstance(tree, (list, tuple)) else ()
    for k, v in items:
        found = _path_of(v, target, path + (k,))
        if found is not None:
            return found
    return None


@dataclass
class AttributionSnapshot:
    """One classification pass over the device's live bytes.

    ``owners`` maps owner name -> live *device* bytes; ``host_owners`` the
    parked trees' host bytes by name. ``total_bytes`` is the device total
    of the same walk, so the exactness identity in the module docstring
    holds by construction."""
    owners: Dict[str, int] = field(default_factory=dict)
    unattributed: int = 0
    total_bytes: int = 0
    host_owners: Dict[str, int] = field(default_factory=dict)
    # [{nbytes, shape, dtype, owner, path}] — metadata only, no tensors
    top_buffers: List[dict] = field(default_factory=list)
    n_arrays: int = 0
    walk_s: float = 0.0

    def ranked(self) -> List[str]:
        """Owner names by live device bytes, descending (nonzero only)."""
        return [k for k, v in sorted(self.owners.items(),
                                     key=lambda kv: -kv[1]) if v > 0]

    def table(self) -> Dict[str, int]:
        """Nonzero owner -> bytes (the dict that rides phase-span args)."""
        return {k: v for k, v in self.owners.items() if v}

    def to_record(self) -> dict:
        return {"owners": self.table(), "unattributed": self.unattributed,
                "total_bytes": self.total_bytes,
                "host_owners": dict(self.host_owners),
                "top_buffers": list(self.top_buffers),
                "n_arrays": self.n_arrays}


class MemoryAttributor:
    """Registry of named owner-tree getters + the live-bytes classifier.

    ``device``: the device whose bytes are split (None: bound by the
    trainer that adopts the attributor, else ``default_device()`` at the
    first snapshot, which raises where there is no card). ``tracked``:
    on the CPU, a getter of the trees whose storages make up the live set
    besides the owners'. ``lot``: the run's ``HostParkingLot``."""

    def __init__(self, *, top_k: int = 10, device=None,
                 tracked: Optional[Callable[[], Any]] = None, lot=None):
        self.top_k = top_k
        self.device = None if device is None else torch.device(device)
        self.tracked = tracked
        self.lot = lot
        self._getters: Dict[str, Callable[[], Any]] = {}

    # ------------------------------------------------------------ registry
    def register(self, name: str, getter: Callable[[], Any]) -> None:
        """Register an owner. ``getter`` is called at every snapshot and
        returns the owner's current tree (or None when the owner holds
        nothing right now). Re-registering a name replaces its getter but
        keeps its original priority slot."""
        self._getters[name] = getter

    def register_tree(self, name: str, tree: Any) -> None:
        """Convenience for owners whose tree object never gets replaced."""
        self.register(name, lambda: tree)

    def owners(self):
        return tuple(self._getters)

    # ------------------------------------------------------------ snapshot
    def _host(self, cuda: bool) -> Tuple[Dict[str, int], set]:
        """(parked bytes by lot name, the parked storages' addresses). On
        the card a parked leaf lives on the CPU, so the walk skips it
        without the addresses."""
        if self.lot is None:
            return {}, set()
        keys = set()
        if not cuda:
            for name in self.lot.names():
                keys.update(t.untyped_storage().data_ptr()
                            for t in _leaves(self.lot.peek(name)))
        return self.lot.parked_bytes_by_name(), keys

    def _owner_trees(self):
        """(owner, tree) for every owner holding something right now."""
        for name, get in self._getters.items():
            try:
                tree = get()
            except Exception:
                tree = None
            if tree is not None:
                yield name, tree

    def _identity_map(self, cuda: bool, host: set) -> Dict[int, tuple]:
        """storage address -> (bytes, owner, tree, tensor) over the owners'
        leaves on the card (``cuda``) or on the CPU, parked ones left out;
        first registration wins on aliases. Local to one snapshot. (One
        card: a second card's tensors would count as the first's.)"""
        ident: Dict[int, tuple] = {}
        for name, tree in self._owner_trees():
            for t in _leaves(tree):
                if t.is_cuda is cuda:
                    st = t.untyped_storage()
                    key = st.data_ptr()
                    if key not in ident and key not in host and key:
                        ident[key] = (st.nbytes(), name, tree, t)
        return ident

    def _cuda_owner_bytes(self, owners: Dict[str, int]) -> int:
        """The per-record walk on the card, in one pass: each owner's
        storages on the card, each charged its 512-byte-rounded block once
        (first owner wins) -> the number of storages."""
        seen = set()
        for name, tree in self._owner_trees():
            total = 0
            for t in _leaves(tree):
                if t.is_cuda:
                    st = t.untyped_storage()
                    key = st.data_ptr()
                    if key not in seen and key:
                        seen.add(key)
                        total += -(-st.nbytes() // 512) * 512
            owners[name] = total
        return len(seen)

    def snapshot(self, *, full: bool = False) -> AttributionSnapshot:
        """Classify the device's live bytes: the owner table and the
        residue. ``full`` adds the top buffers and, on CUDA, takes the
        allocator's block walk (the flight recorder's dumps); see the
        module docstring for the walk on each device and the exactness
        contract. The wall cost is returned in ``walk_s`` so callers can
        charge it to the telemetry self-time (the attribution pass counts
        against the <=2% overhead gate)."""
        t0 = time.perf_counter()
        if self.device is None:
            self.device = default_device()
        cuda = self.device.type == "cuda"
        host_owners, host = self._host(cuda)
        snap = AttributionSnapshot(
            owners={name: 0 for name in self._getters},
            host_owners=host_owners)
        owners = snap.owners
        ident: Dict[int, tuple] = {}
        if cuda:
            snap.total_bytes = torch.cuda.memory_allocated(self.device)
        if cuda and not full:
            snap.n_arrays = self._cuda_owner_bytes(owners)
        else:
            ident = self._identity_map(cuda, host)
            # storage address -> bytes of every buffer the walk sees
            if cuda:
                blocks = self._blocks(self.device)
                sizes = {key: blocks.get(key) or -(-nb // 512) * 512
                         for key, (nb, _, _, _) in ident.items()}
                sizes.update((k, v) for k, v in blocks.items()
                             if k not in sizes)
            else:
                sizes = {key: v[0] for key, v in ident.items()}
                if self.tracked is not None:
                    for t in _leaves(self.tracked()):
                        if not t.is_cuda:
                            st = t.untyped_storage()
                            key = st.data_ptr()
                            if key not in sizes and key not in host and key:
                                sizes[key] = st.nbytes()
                snap.total_bytes = sum(sizes.values())
            for key, who in ident.items():
                owners[who[1]] += sizes[key]
            snap.n_arrays = len(sizes)
            if full:
                top = sorted(sizes.items(),
                             key=lambda kv: -kv[1])[:self.top_k]
                snap.top_buffers = [self._describe(nb, ident.get(key))
                                    for key, nb in top]
        snap.unattributed = snap.total_bytes - sum(owners.values())
        if snap.unattributed < 0:
            raise RuntimeError(
                f"attribution: owners hold {sum(owners.values())} bytes, "
                f"above the {snap.total_bytes} live on {self.device}")
        snap.walk_s = time.perf_counter() - t0
        return snap

    @staticmethod
    def _blocks(device: torch.device) -> Dict[int, int]:
        """address -> size of every active block the caching allocator
        holds on ``device``."""
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        return {b["address"]: b["size"]
                for seg in torch.cuda.memory_snapshot()
                if seg["device"] == index
                for b in seg["blocks"] if b["state"] == "active_allocated"}

    @staticmethod
    def _describe(nb: int, who) -> dict:
        """Metadata of one buffer: never the tensor itself."""
        if who is None:
            return {"nbytes": nb, "shape": "?", "dtype": "?",
                    "owner": "(unattributed)", "path": ""}
        _, name, tree, t = who
        return {"nbytes": nb, "shape": str(tuple(t.shape)),
                "dtype": str(t.dtype).replace("torch.", ""),
                "owner": name, "path": _keystr(_path_of(tree, t) or ())}


# --------------------------------------------------- compiled-memory stats
def _meta(x):
    """A ``meta`` twin of a tensor (shape, dtype, requires_grad); other
    leaves pass through."""
    if not isinstance(x, torch.Tensor):
        return x
    return torch.empty_like(x, device="meta").requires_grad_(x.requires_grad)


def _meta_storages(tree) -> Dict[Any, int]:
    """Distinct storages of a tree of ``meta`` tensors -> their bytes (a
    meta storage has no address: it is told apart by a weak reference)."""
    from torch.multiprocessing.reductions import StorageWeakRef
    return {StorageWeakRef(t.untyped_storage()): t.untyped_storage().nbytes()
            for t in _leaves(tree)}


def compiled_memory_stats(fn, *args) -> Optional[Dict[str, int]]:
    """temp/argument/output/generated-code bytes of ``fn(*args)``, from a
    trace of it on ``meta`` twins of ``args`` (``core.trace``; ``fn`` never
    runs on data). None when ``fn`` cannot be traced (it reads values,
    or mixes in tensors of a real device)."""
    from repro_torch.core.trace import trace_function
    margs = tree_map(_meta, args)
    outs = []

    def run(*a):
        outs.append(fn(*a))
        return outs[-1]
    try:
        trace = trace_function(run, margs, "input", min_bytes=1)
    except Exception:
        return None
    ins = _meta_storages(margs)
    return {"temp_bytes": trace.peak_live(),
            "argument_bytes": sum(ins.values()),
            "output_bytes": sum(nb for k, nb in _meta_storages(outs).items()
                                if k not in ins),
            "generated_code_bytes": 0}


def record_compiled_memory(registry, program: str, fn, *args
                           ) -> Optional[Dict[str, int]]:
    """Trace ``fn(*args)`` on ``meta`` (:func:`compiled_memory_stats`) and
    feed its stats into ``registry`` as gauges labelled ``program=...``,
    the reference's ``compiled_{temp,argument,output,generated_code}_bytes``.

    The trace never executes the program, so this is a pure observer; it
    is one-time setup cost (like the simulator replay) and is not charged
    to the tracer's self-time. Returns the stats dict, or None when ``fn``
    cannot be traced."""
    stats = compiled_memory_stats(fn, *args)
    if stats is None:
        return None
    for key, val in stats.items():
        registry.gauge(
            f"compiled_{key}",
            "per-program memory accounting (a meta trace of the program: "
            "the counterpart of XLA's memory_analysis)").set(
            val, program=program)
    return stats
