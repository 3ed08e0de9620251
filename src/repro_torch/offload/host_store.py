"""HostParkingLot: runtime device <-> host swapping of whole parameter
trees — the port of ``repro/offload/host_store.py``.

Most RLHF state is *phase-exclusive*: each of the seven PPO phases touches
one role's trees and leaves the rest idle. The lot parks a named tree to
host memory and drops its device copy (once the caller's last reference
goes, the caching allocator has the bytes back), then fetches it back, bit
for bit, when its phase comes around again (``offload.scheduler`` holds
the schedule).

Two transports, selected by the probe in ``offload.compat``:

  * **pinned host memory** (a CUDA device): a park copies device to host
    on a dedicated copy stream that first waits on the compute stream; a
    fetch allocates on the compute stream and copies host to device on the
    copy stream, and the compute stream waits on the copy's event before
    first use. Each name keeps one pinned flat buffer, reused across
    iterations, with the leaves stored as views into it, so the host bytes
    are the tree's (pinning 10-70 GB anew on every park costs seconds, and
    ``torch.empty(pin_memory=True)`` rounds a block up to a power of two);
  * **committed copies** (a CPU device): the lot keeps ``clone()``s, the
    reference's committed-numpy path; host and device are one memory there.

Leaves that are not tensors (the optimizer's Python-int ``count``) pass
through unchanged and count 0 bytes. A fetched leaf requires grad exactly
where the parked one did.

Parks block by default; ``block=False`` keeps the device sources until
``drain()`` (or the next access), so the copy can overlap compute. Fetches
are asynchronous on the card: ``prefetch`` starts the copies, ``fetch``
installs them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.offload import compat
from repro_torch.tree import leaves, tree_map

_LEAF = object()


def tree_nbytes(tree) -> int:
    """Bytes of the tensor leaves of ``tree`` (non-tensor leaves count 0,
    aliases each time, as the reference sums ``nbytes`` per leaf)."""
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def _flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves in order — tensors and other values, ``None`` skipped — and
    a skeleton that holds no reference to them)."""
    flat: List[Any] = []

    def take(x):
        flat.append(x)
        return _LEAF
    return flat, tree_map(take, tree)


def _unflatten(skeleton, flat) -> Any:
    it = iter(flat)
    return tree_map(lambda _: next(it), skeleton)


@dataclass
class LotStats:
    parked_bytes: int = 0           # currently host-resident
    peak_parked_bytes: int = 0
    bytes_parked_total: int = 0     # cumulative device->host traffic
    bytes_fetched_total: int = 0    # cumulative host->device traffic
    n_park: int = 0
    n_fetch: int = 0
    n_prefetch_hits: int = 0


@dataclass
class _Entry:
    host: List[Any]                 # host leaves (or passed-through values)
    skeleton: Any
    nbytes: int
    requires_grad: List[bool]
    # an in-flight park: the device sources stay referenced until the copy
    # stream's event says the host copies are complete
    done: Optional[Any] = None
    sources: Optional[List[torch.Tensor]] = None


class HostParkingLot:
    """Named tree parking between ``device`` and host memory (pinned when
    ``device`` is CUDA, committed CPU copies when it is the CPU)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.host_kind = compat.host_memory_kind(self.device)
        self._copy = torch.cuda.Stream(self.device) \
            if self.host_kind is not None else None
        self._entries: Dict[str, _Entry] = {}
        self._prefetched: Dict[str, Tuple[List[Any], Any]] = {}
        self._buffers: Dict[str, torch.Tensor] = {}
        self.stats = LotStats()
        # (op, name) stream — "park" | "prefetch" | "fetch_hit" | "fetch"
        self.events: List[Tuple[str, str]] = []

    # ------------------------------------------------------------ transport
    def _views(self, name: str, tensors) -> List[torch.Tensor]:
        """Views shaped like ``tensors`` into ``name``'s pinned buffer, each
        at an offset aligned to its element size; the buffer is reused
        while it is large enough."""
        offsets, end = [], 0
        for t in tensors:
            end = -(-end // t.element_size()) * t.element_size()
            offsets.append(end)
            end += t.numel() * t.element_size()
        buf = self._buffers.get(name)
        if buf is None or buf.numel() < end:
            buf = self._buffers[name] = compat.pinned_buffer(end)
        return [buf[o:o + t.numel() * t.element_size()].view(t.dtype)
                .view(t.shape) for o, t in zip(offsets, tensors)]

    def _to_device(self, host) -> Tuple[List[Any], Any]:
        """Start the host->device copies of ``host``'s tensors: allocated on
        the compute stream, copied on the copy stream after it has waited
        for the compute stream (a freed block may still be read there)."""
        if self._copy is None:
            return list(host), None
        outs = [torch.empty(h.shape, dtype=h.dtype, device=self.device)
                if isinstance(h, torch.Tensor) else h for h in host]
        self._copy.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._copy):
            for d, h in zip(outs, host):
                if isinstance(h, torch.Tensor):
                    d.copy_(h, non_blocking=True)
        done = torch.cuda.Event()
        done.record(self._copy)
        return outs, done

    @staticmethod
    def _complete(entry: _Entry) -> None:
        if entry.done is not None:
            entry.done.synchronize()
        entry.done = entry.sources = None

    # ---------------------------------------------------------------- public
    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def names(self):
        return tuple(self._entries)

    def parked_bytes(self) -> int:
        return self.stats.parked_bytes

    def parked_bytes_by_name(self) -> Dict[str, int]:
        """Each parked tree's host bytes, by name."""
        return {name: e.nbytes for name, e in self._entries.items()}

    def requires_grad(self, name: str) -> List[bool]:
        """Per leaf of parked ``name``, in order: whether its fetch requires
        grad."""
        return list(self._entries[name].requires_grad)

    def pinned_bytes(self) -> int:
        """Host bytes the lot holds pinned (its buffers, parked or not)."""
        return sum(b.numel() for b in self._buffers.values())

    @torch.no_grad()
    def park(self, name: str, tree, *, block: bool = True) -> None:
        """Copy ``tree`` to host under ``name``; the caller drops its
        device references (the executor repoints them at :meth:`peek`).
        With ``block=False`` the device sources stay referenced until
        ``drain()`` (or the next access), so the copy can overlap compute."""
        if name in self._entries:
            raise KeyError(f"{name!r} already parked")
        flat, skeleton = _flatten(tree)
        tensors = [x for x in flat if isinstance(x, torch.Tensor)]
        if self._copy is None:
            host = [x.detach().clone() if isinstance(x, torch.Tensor) else x
                    for x in flat]
            done = None
        else:
            views = iter(self._views(name, tensors))
            host = [next(views) if isinstance(x, torch.Tensor) else x
                    for x in flat]
            self._copy.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self._copy):
                for h, x in zip(host, flat):
                    if isinstance(x, torch.Tensor):
                        h.copy_(x, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._copy)
        nbytes = tree_nbytes(tensors)
        entry = _Entry(host, skeleton, nbytes,
                       [isinstance(x, torch.Tensor) and x.requires_grad
                        for x in flat], done=done, sources=tensors)
        if block:
            self._complete(entry)
        self._entries[name] = entry
        st = self.stats
        st.n_park += 1
        st.bytes_parked_total += nbytes
        st.parked_bytes += nbytes
        st.peak_parked_bytes = max(st.peak_parked_bytes, st.parked_bytes)
        self.events.append(("park", name))

    def drain(self) -> None:
        """Complete every in-flight (non-blocking) park: wait for the host
        copies and drop the device sources."""
        for entry in self._entries.values():
            self._complete(entry)

    def adopt(self, name: str, tree, *, requires_grad=None) -> None:
        """Insert a tree that is already in host memory (pinned or plain CPU
        tensors) without a device round trip. ``requires_grad`` (a flag
        per leaf, in order) says which fetched leaves require grad; by
        default the tree's own flags."""
        if name in self._entries:
            raise KeyError(f"{name!r} already parked")
        flat, skeleton = _flatten(tree)
        if any(isinstance(x, torch.Tensor) and x.device.type != "cpu"
               for x in flat):
            raise ValueError(f"adopt takes host tensors; {name!r} has "
                             "device leaves")
        if requires_grad is None:
            requires_grad = [isinstance(x, torch.Tensor) and x.requires_grad
                             for x in flat]
        nbytes = tree_nbytes(tree)
        self._entries[name] = _Entry(
            [x.detach() if isinstance(x, torch.Tensor) else x for x in flat],
            skeleton, nbytes, list(requires_grad))
        st = self.stats
        st.parked_bytes += nbytes
        st.peak_parked_bytes = max(st.peak_parked_bytes, st.parked_bytes)
        self.events.append(("park", name))

    @torch.no_grad()
    def prefetch(self, name: str) -> None:
        """Start the host->device copy of a parked tree without removing it
        from the lot; the following ``fetch`` consumes the in-flight copy."""
        if name in self._prefetched or name not in self._entries:
            return
        entry = self._entries[name]
        self._complete(entry)
        self._prefetched[name] = self._to_device(entry.host)
        self.events.append(("prefetch", name))

    @torch.no_grad()
    def fetch(self, name: str):
        """Device-resident tree for ``name``; the entry leaves the lot. Uses
        the prefetched copy when one is in flight. On the card the compute
        stream waits for the copies before its next kernel."""
        entry = self._entries.pop(name)
        self._complete(entry)
        pre = self._prefetched.pop(name, None)
        if pre is not None:
            self.stats.n_prefetch_hits += 1
            self.events.append(("fetch_hit", name))
        else:
            pre = self._to_device(entry.host)
            self.events.append(("fetch", name))
        out, done = pre
        if done is not None:
            torch.cuda.current_stream(self.device).wait_event(done)
        for x, flag in zip(out, entry.requires_grad):
            if flag:
                x.requires_grad_(True)
        st = self.stats
        st.n_fetch += 1
        st.parked_bytes -= entry.nbytes
        st.bytes_fetched_total += entry.nbytes
        return _unflatten(entry.skeleton, out)

    def discard(self, name: str) -> None:
        """Drop a parked entry, and its pinned buffer, without fetching it
        back to the device."""
        entry = self._entries.pop(name)
        pre = self._prefetched.pop(name, None)
        if pre is not None and pre[1] is not None:
            pre[1].synchronize()       # its device copies die here
        self._complete(entry)
        self._buffers.pop(name, None)
        self.stats.parked_bytes -= entry.nbytes

    def peek(self, name: str):
        """The host-resident tree, without fetching. While parked it stands
        in for the device tree; on the card any use of it by a kernel or a
        device op raises (its leaves live on the CPU), and the scheduler
        treats such use as a plan fault."""
        entry = self._entries[name]
        return _unflatten(entry.skeleton, entry.host)
