"""qwen1.5-110b [dense] — QKV bias [hf:Qwen/Qwen1.5-0.5B]."""
from repro_torch.configs.base import ATTN, ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1_5_110b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    period=(ATTN,),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    optimizer="adamw_bf16",   # >=100B: bf16 moments, fp32 update math
    microbatches=2,
    source="[hf:Qwen/Qwen1.5-0.5B]",
))
