"""mamba2-130m [ssm] — attention-free SSD (state-space duality).
Sub-quadratic: runs the long_500k cell. [arXiv:2405.21060; unverified]"""
from repro_torch.models.config import ModelConfig

ARCH = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    vocab_size=50280,
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,           # d_inner = 1536 -> 24 SSD heads @ head_dim 64
    ssm_head_dim=64,
    ssm_chunk=256,
    subquadratic=True,
    tensor_parallel=False,  # 24 SSD heads don't divide model=16; 130M -> pure DP
    optimizer="adamw",
    remat="dots",
    microbatches=1,
)
