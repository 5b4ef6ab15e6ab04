"""musicgen-medium [audio] — decoder-only LM over 4 EnCodec codebook
streams (stub frontend); GELU MLP, MHA. RoPE replaces the original
sinusoidal embedding (deviation noted in DESIGN §6). [arXiv:2306.05284; hf]"""
from repro_torch.models.config import ModelConfig

ARCH = ModelConfig(
    name="musicgen-medium",
    family="dense",
    frontend="audio",
    audio_codebooks=4,
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    mlp_type="gelu",
    qkv_bias=False,
    tie_embeddings=False,   # separate codebook embed/head tables
    tensor_parallel=False,  # 24 heads don't divide model=16; 1.4B -> pure DP+FSDP
    optimizer="adamw",
    remat="dots",
    microbatches=1,
)
