# The paper's primary contribution: understanding + alleviating RLHF memory
# consumption — the port of repro/core. Allocator simulator (allocator.py),
# liveness tracer over meta tensors (trace.py), RLHF phase plans
# (phases.py), memory-management strategies (strategies.py),
# empty_cache-policy profiler (profiler.py).
from repro_torch.core.allocator import AllocatorStats, CachingAllocator
from repro_torch.core.phases import (RLHF_PHASE_SEQUENCE,
                                     RUNTIME_RLHF_PHASE_SEQUENCE, Phase,
                                     build_grpo_phases, build_rlhf_phases,
                                     phase_state_touches,
                                     runtime_state_touches)
from repro_torch.core.profiler import POLICIES, RunResult, run_iteration
from repro_torch.core.strategies import (MemoryStrategy, OFFLOAD_LEVELS,
                                         PAPER_STRATEGIES,
                                         lora_trainable_fraction,
                                         offload_managed_states,
                                         traced_strategy, traced_zero_scales)
from repro_torch.core.trace import Trace, trace_function

__all__ = ["CachingAllocator", "Phase", "build_rlhf_phases",
           "RLHF_PHASE_SEQUENCE", "phase_state_touches",
           "runtime_state_touches", "POLICIES", "RunResult", "run_iteration",
           "MemoryStrategy", "OFFLOAD_LEVELS", "PAPER_STRATEGIES",
           "lora_trainable_fraction", "offload_managed_states", "Trace",
           "trace_function", "traced_strategy", "traced_zero_scales",
           "AllocatorStats", "RUNTIME_RLHF_PHASE_SEQUENCE",
           "build_grpo_phases"]
