# The port's copies of the reference's caching-allocator simulator
# (repro/core/allocator.py), the PPO phase sequence and touch map
# (repro/core/phases.py:59-124) and the offload levels
# (repro/core/strategies.py:61-86); the rest of repro/core is still to port.
from repro_torch.core.allocator import AllocatorStats, CachingAllocator
from repro_torch.core.phases import (RLHF_PHASE_SEQUENCE,
                                     RUNTIME_RLHF_PHASE_SEQUENCE,
                                     phase_state_touches,
                                     runtime_state_touches)
from repro_torch.core.strategies import OFFLOAD_LEVELS, offload_managed_states

__all__ = ["AllocatorStats", "CachingAllocator", "OFFLOAD_LEVELS",
           "RLHF_PHASE_SEQUENCE", "RUNTIME_RLHF_PHASE_SEQUENCE",
           "offload_managed_states", "phase_state_touches",
           "runtime_state_touches"]
