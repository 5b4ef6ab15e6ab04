"""moonshot-v1-16b-a3b [moe] — kimi/moonlight-style, 64 experts top-6.
[hf:moonshotai/Moonlight-16B-A3B; hf]"""
from repro_torch.models.config import ModelConfig

ARCH = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,              # per-expert FFN width
    vocab_size=163840,
    mlp_type="swiglu",
    qkv_bias=False,
    tie_embeddings=True,
    moe_experts=64,
    moe_top_k=6,
    moe_capacity_factor=1.25,
    optimizer="adamw",
    remat="dots",
    microbatches=2,
)
