"""paligemma-3b [vlm] — SigLIP stub frontend + gemma backbone; image tokens
form a bidirectional prefix. [arXiv:2407.07726; hf]"""
from repro_torch.models.config import ModelConfig

ARCH = ModelConfig(
    name="paligemma-3b",
    family="dense",
    frontend="vision",
    num_patches=256,        # precomputed patch embeddings from input_specs()
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    mlp_type="geglu",
    qkv_bias=False,
    tie_embeddings=True,
    embed_scale=True,
    rope_theta=10000.0,
    tensor_parallel=False,  # gemma backbone: 8 heads; pure DP+FSDP
    optimizer="adamw",
    remat="dots",
    microbatches=1,
)
