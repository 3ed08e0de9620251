# The port's copy of the reference's caching-allocator simulator
# (repro/core/allocator.py); the rest of repro/core is still to port.
from repro_torch.core.allocator import AllocatorStats, CachingAllocator

__all__ = ["AllocatorStats", "CachingAllocator"]
