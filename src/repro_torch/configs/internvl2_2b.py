"""internvl2-2b [vlm] — InternViT + InternLM2 [arXiv:2404.16821].

Backbone only: the ViT/projector frontend is a stub, as in the
reference — a batch carries precomputed patch embeddings
(``prefix_embeds`` [B, num_prefix_embeddings, d_model]) prepended to the
token embeddings.
"""
from repro_torch.configs.base import ATTN, ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2_2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    period=(ATTN,),
    input_mode="embeddings",
    num_prefix_embeddings=256,    # one 448x448 tile -> 256 patch tokens
    rope_theta=1_000_000.0,
    source="[arXiv:2404.16821]",
))
