# The port's copy of the reference's caching-allocator simulator
# (repro/core/allocator.py) and the PPO phase sequence
# (repro/core/phases.py:59-70); the rest of repro/core is still to port.
from repro_torch.core.allocator import AllocatorStats, CachingAllocator
from repro_torch.core.phases import (RLHF_PHASE_SEQUENCE,
                                     RUNTIME_RLHF_PHASE_SEQUENCE)

__all__ = ["AllocatorStats", "CachingAllocator", "RLHF_PHASE_SEQUENCE",
           "RUNTIME_RLHF_PHASE_SEQUENCE"]
