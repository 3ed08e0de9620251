"""qwen1.5-4b [dense] — QKV bias, MHA (kv == heads) [hf:Qwen/Qwen1.5-0.5B]."""
from repro_torch.configs.base import ATTN, ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1_5_4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    period=(ATTN,),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="[hf:Qwen/Qwen1.5-0.5B]",
))
