"""zamba2-1.2b [hybrid] — Mamba2 backbone with a single *shared* attention
block applied every 6th layer. Sub-quadratic backbone: runs long_500k.
[arXiv:2411.15242; hf]"""
from repro_torch.models.config import ModelConfig

ARCH = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,              # shared block MLP width
    vocab_size=32000,
    mlp_type="swiglu",
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,           # d_inner = 4096 -> 64 SSD heads @ head_dim 64
    ssm_head_dim=64,
    ssm_chunk=256,
    attn_every=6,           # 6 shared-block applications over 38 layers
    subquadratic=True,
    optimizer="adamw",
    remat="dots",
    microbatches=4,
)
