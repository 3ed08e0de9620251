"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, first 3 layers
dense, MTP [arXiv:2412.19437]."""
from repro_torch.configs.base import MLA, MLAConfig, ModelConfig, MoEConfig, \
    register

CONFIG = register(ModelConfig(
    name="deepseek_v3_671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,             # MLA: per-head KV reconstructed from latent
    d_ff=18432,                   # dense FFN width of the first_k_dense layers
    vocab_size=129280,
    period=(MLA,),
    moe_period=(True,),
    first_k_dense=3,
    moe=MoEConfig(num_experts=256, top_k=8, d_expert=2048,
                  num_shared_experts=1, router_aux_coef=0.001),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    mtp_depth=1,
    # factored second moment only: a 671B model's AdamW moments would be
    # 5.4 TB
    optimizer="adafactor",
    microbatches=4,
    source="[arXiv:2412.19437]",
))
