from repro_torch.rlhf.rollout import (Rollout, RolloutResult, live_device_bytes,
                                     sample_token)
from repro_torch.rlhf.trainer import (MEMORY_POLICIES, PhaseMemoryManager,
                                      RLHFConfig, RLHFTrainer)
from repro_torch.rlhf.engine import ModelEngine
from repro_torch.rlhf.experience import ExperienceBuffer
from repro_torch.rlhf.grpo import GRPOConfig, GRPOTrainer

__all__ = ["ExperienceBuffer", "GRPOConfig", "GRPOTrainer", "MEMORY_POLICIES", "ModelEngine", "PhaseMemoryManager",
           "RLHFConfig", "RLHFTrainer", "Rollout", "RolloutResult",
           "live_device_bytes", "sample_token"]
