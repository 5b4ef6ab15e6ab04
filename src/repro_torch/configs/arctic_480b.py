"""arctic-480b [moe] — 128 experts top-2 with a dense residual branch
(Snowflake's dense-MoE hybrid). Adafactor keeps optimizer state within a
16 GiB/chip pod (DESIGN §6). [hf:Snowflake/snowflake-arctic-base; hf]"""
from repro_torch.models.config import ModelConfig

ARCH = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,              # per-expert FFN width
    vocab_size=32000,
    mlp_type="swiglu",
    qkv_bias=False,
    tie_embeddings=True,
    moe_experts=128,
    moe_top_k=2,
    moe_dense_ff=4864,      # dense residual branch
    moe_capacity_factor=1.25,
    # attn_over_model=True was REFUTED (see EXPERIMENTS §Perf): the per-layer
    # batch reshard bounces against FSDP-sharded weights (collective-permute
    # storm); attention stays replicated over model (heads !% 16)
    accum_dtype="bfloat16",
    optimizer="adafactor",
    remat="full",
    microbatches=16,  # bounds live activations at 480B
)
