"""mamba2-370m [ssm] — SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.configs.base import MAMBA, ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="mamba2_370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    period=(MAMBA,),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk_size=256),
    tie_embeddings=True,
    source="[arXiv:2405.21060]",
))
