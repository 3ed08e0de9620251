from repro_torch.configs.base import ATTN, MAMBA, ModelConfig, SSMConfig, \
    get_config, register

__all__ = ["ATTN", "MAMBA", "ModelConfig", "SSMConfig", "get_config",
           "register"]
