"""qwen2-0.5b [dense] — GQA with QKV bias. [arXiv:2407.10671; hf]"""
from repro_torch.models.config import ModelConfig

ARCH = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151936,
    mlp_type="swiglu",
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1e6,
    tensor_parallel=False,  # 14 heads don't divide model=16; 0.5B -> pure DP+FSDP
    optimizer="adamw",
    remat="dots",
    microbatches=1,
)
