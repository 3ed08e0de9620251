"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887].

Period of 8 layers: attention at offset 4 (attn_layer_period=8,
attn_layer_offset=4), MoE every other layer (expert_layer_period=2,
expert_layer_offset=1) — matching the Jamba-v0.1 card.
"""
from repro_torch.configs.base import ATTN, MAMBA, ModelConfig, MoEConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="jamba_v0_1_52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    period=(MAMBA, MAMBA, MAMBA, MAMBA, ATTN, MAMBA, MAMBA, MAMBA),
    moe_period=(False, True, False, True, False, True, False, True),
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=14336),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, chunk_size=256),
    microbatches=2,
    source="[arXiv:2403.19887]",
))
