"""The paper's own study models (DeepSpeed-Chat / ColossalChat workloads)
— the port's copy of ``repro/configs/paper_models.py``.

OPT-1.3b / OPT-350m (actor-ref / critic-reward pair), GPT2-xl / GPT2-medium,
OPT-6.7b and Llama-2-7b from Appendix C. They register on import of
``repro_torch.configs``, so ``get_config("opt_1_3b")`` gives the same
configuration as the reference's.
"""
from repro_torch.configs.base import ATTN, ModelConfig, register

OPT_1_3B = register(ModelConfig(
    name="opt_1_3b", family="dense",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=50272, period=(ATTN,),
    qkv_bias=True, mlp_gated=False, tie_embeddings=True,
    remat="none", source="[hf:facebook/opt-1.3b]",
))

OPT_350M = register(ModelConfig(
    name="opt_350m", family="dense",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=50272, period=(ATTN,),
    qkv_bias=True, mlp_gated=False, tie_embeddings=True,
    remat="none", source="[hf:facebook/opt-350m]",
))

GPT2_XL = register(ModelConfig(
    name="gpt2_xl", family="dense",
    num_layers=48, d_model=1600, num_heads=25, num_kv_heads=25,
    d_ff=6400, vocab_size=50257, period=(ATTN,),
    qkv_bias=True, mlp_gated=False, tie_embeddings=True,
    remat="none", source="[hf:gpt2-xl]",
))

GPT2_MEDIUM = register(ModelConfig(
    name="gpt2_medium", family="dense",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=50257, period=(ATTN,),
    qkv_bias=True, mlp_gated=False, tie_embeddings=True,
    remat="none", source="[hf:gpt2-medium]",
))

OPT_6_7B = register(ModelConfig(
    name="opt_6_7b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=16384, vocab_size=50272, period=(ATTN,),
    qkv_bias=True, mlp_gated=False, tie_embeddings=True,
    remat="none", source="[hf:facebook/opt-6.7b]",
))

LLAMA2_7B = register(ModelConfig(
    name="llama2_7b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=11008, vocab_size=32000, period=(ATTN,),
    source="[hf:meta-llama/Llama-2-7b]",
))
