from repro_torch.configs.base import ATTN, MAMBA, ModelConfig, SSMConfig, \
    get_config, register

# the paper's models register on import so that get_config("opt_1_3b")
# etc. work, as in the reference
from repro_torch.configs import paper_models as _paper_models  # noqa: F401,E402

__all__ = ["ATTN", "MAMBA", "ModelConfig", "SSMConfig", "get_config",
           "register"]
