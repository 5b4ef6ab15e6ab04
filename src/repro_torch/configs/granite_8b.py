"""granite-8b [dense] — llama-architecture code model. [arXiv:2405.04324; hf]"""
from repro_torch.models.config import ModelConfig

ARCH = ModelConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49152,
    mlp_type="swiglu",
    qkv_bias=False,
    tie_embeddings=True,
    rope_theta=1e7,
    optimizer="adamw",
    remat="dots",
    microbatches=2,
)
