from repro_torch.optim.optimizers import (
    Optimizer,
    adamw,
    get_optimizer,
    global_norm,
    clip_by_global_norm,
)
from repro_torch.optim.schedule import warmup_cosine

__all__ = [
    "Optimizer",
    "adamw",
    "get_optimizer",
    "global_norm",
    "clip_by_global_norm",
    "warmup_cosine",
]
