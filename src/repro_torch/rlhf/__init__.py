from repro_torch.rlhf.rollout import (Rollout, RolloutResult, live_device_bytes,
                                     sample_token)

__all__ = ["Rollout", "RolloutResult", "live_device_bytes", "sample_token"]
