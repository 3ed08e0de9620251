"""The port's memory-kind probe — the counterpart of
``repro/kernels/compat.py:31-63`` (Pallas's ``CompilerParams`` has none).

There is one host memory space: pinned (page-locked) CPU memory, which the
card's copy engines read and write asynchronously. It is used exactly when
the trainer's device is CUDA. On a CPU device the "host" is the device's
own memory, so :func:`host_memory_kind` is None there, as the reference's
is on its CPU backend, and the parking lot keeps committed copies. Pinning
that fails on a CUDA device raises: nothing falls back to pageable
copies."""
from __future__ import annotations

import functools
import mmap
from typing import Optional

import torch

PINNED_HOST = "pinned_host"


def host_memory_kind(device) -> Optional[str]:
    """``"pinned_host"`` for a CUDA device (once per process it pins a
    page, and raises if it cannot), None for the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return None
    if device.type != "cuda":
        raise ValueError(f"host offload covers cuda and cpu, not {device}")
    _probe_pinning()
    return PINNED_HOST


@functools.lru_cache(maxsize=None)
def _probe_pinning() -> None:
    pinned_buffer(1)


class _PinnedMap(mmap.mmap):
    """Anonymous host memory registered with CUDA (``cudaHostRegister``)
    (page-locked). Tensors over it hold it alive; when the last one dies
    it unregisters itself before its pages are unmapped."""
    _unregister = None
    ptr = 0

    def __del__(self):
        if self._unregister is not None:
            self._unregister(self.ptr)


def pinned_buffer(nbytes: int) -> torch.Tensor:
    """A flat uint8 buffer of exactly ``nbytes`` (page-rounded, not the
    power of two ``torch.empty(pin_memory=True)``'s caching host allocator
    rounds a block up to) in pinned host memory; raises if CUDA cannot
    pin it."""
    cudart = torch.cuda.cudart()
    m = _PinnedMap(-1, max(nbytes, 1))
    buf = torch.frombuffer(m, dtype=torch.uint8)[:nbytes]
    rc = cudart.cudaHostRegister(buf.data_ptr(), len(m), 0)
    if rc != cudart.cudaError.success:
        raise RuntimeError(f"cudaHostRegister of {len(m)} bytes failed "
                           f"({rc})")
    m.ptr, m._unregister = buf.data_ptr(), cudart.cudaHostUnregister
    if nbytes and not buf.is_pinned():
        raise RuntimeError(f"{nbytes} bytes of host memory are not pinned "
                           "after cudaHostRegister")
    return buf
