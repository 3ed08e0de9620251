from repro_torch.configs.base import ATTN, ModelConfig, get_config, register

__all__ = ["ATTN", "ModelConfig", "get_config", "register"]
