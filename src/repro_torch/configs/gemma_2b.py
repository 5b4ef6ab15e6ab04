"""gemma-2b [dense] — GeGLU, head_dim=256, MQA (kv=1), sqrt(D) embed scale.
[arXiv:2403.08295; hf]"""
from repro_torch.models.config import ModelConfig

ARCH = ModelConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    mlp_type="geglu",
    qkv_bias=False,
    tie_embeddings=True,
    embed_scale=True,
    rope_theta=10000.0,
    tensor_parallel=False,  # 8 heads don't divide model=16; 2.5B -> pure DP+FSDP
    optimizer="adamw",
    remat="dots",
    microbatches=1,
)
