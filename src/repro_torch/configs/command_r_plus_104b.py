"""command-r-plus-104b [dense] — GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01]."""
from repro_torch.configs.base import ATTN, ModelConfig, register

CONFIG = register(ModelConfig(
    name="command_r_plus_104b",
    family="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    period=(ATTN,),
    qkv_bias=False,
    rope_theta=75_000_000.0,
    tie_embeddings=True,
    optimizer="adamw_bf16",   # >=100B: bf16 moments, fp32 update math
    microbatches=2,
    source="[hf:CohereForAI/c4ai-command-r-v01]",
))
