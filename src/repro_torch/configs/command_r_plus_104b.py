"""command-r-plus-104b [dense] — GQA, no biases, cohere parallel blocks,
tied embeddings. [hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from repro_torch.models.config import ModelConfig

ARCH = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab_size=256000,
    mlp_type="swiglu",
    qkv_bias=False,
    parallel_block=True,
    tie_embeddings=True,
    rope_theta=75e6,
    optimizer="adamw",
    remat="full",
    microbatches=8,   # bounds live activations at 104B scale
)
