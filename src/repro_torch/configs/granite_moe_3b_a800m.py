"""granite-moe-3b-a800m [moe] — MoE 40e top-8 per the assigned structured
field (the bracket note says 32 experts; we follow the structured field,
see DESIGN.md §6) [hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.configs.base import ATTN, ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="granite_moe_3b_a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=0,                       # every FFN is MoE
    vocab_size=49155,
    period=(ATTN,),
    moe_period=(True,),
    moe=MoEConfig(num_experts=40, top_k=8, d_expert=512),
    tie_embeddings=True,
    source="[hf:ibm-granite/granite-3.0-1b-a400m-base]",
))
