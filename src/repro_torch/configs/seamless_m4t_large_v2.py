"""seamless-m4t-large-v2 [audio] — enc-dec, multimodal [arXiv:2308.11596].

Backbone only: the mel-spectrogram + conformer feature extractor is a
stub, as in the reference — a batch carries precomputed frame embeddings
(``frame_embeds`` [B, num_prefix_embeddings, d_model]) for the 24-layer
encoder; the 24-layer decoder runs self-attention with a KV cache and
cross-attention over the encoder's output.
"""
from repro_torch.configs.base import ATTN, ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless_m4t_large_v2",
    family="audio",
    num_layers=24,                # decoder layers
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    period=(ATTN,),
    input_mode="encdec",
    num_prefix_embeddings=1024,   # frame-embedding sequence length stub
    mlp_gated=False,              # classic transformer FFN
    source="[arXiv:2308.11596]",
))
