from repro_torch.models.config import ModelConfig, reduced_for_smoke
from repro_torch.models.zoo import Model, build, chunked_lm_xent, softmax_xent

__all__ = ["ModelConfig", "reduced_for_smoke", "Model", "build",
           "chunked_lm_xent", "softmax_xent"]
