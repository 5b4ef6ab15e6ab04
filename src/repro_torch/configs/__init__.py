"""Architecture registry: ``--arch <id>`` ids as the reference names them.

Every architecture of the reference is listed: the dense and the MoE text
transformers, the SSM model (mamba2-130m), the hybrid (zamba2-1.2b), the
vision-language model (paligemma-3b) and the audio model over codebooks
(musicgen-medium). Their configs are the reference's, field for field;
qwen2-0.5b trains on one card at full size, mamba2-130m and
musicgen-medium serve at full size, moonshot-v1-16b-a3b, zamba2-1.2b and
paligemma-3b train at full width (cut in depth), moonshot-v1-16b-a3b also
sharded over 4 ranks; the others' full sizes need more cards than one,
sharded by ``runtime/sharding.py``.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, reduced_for_smoke

_MODULES = {
    "qwen2-0.5b": "repro_torch.configs.qwen2_0_5b",
    "command-r-plus-104b": "repro_torch.configs.command_r_plus_104b",
    "granite-8b": "repro_torch.configs.granite_8b",
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
    "paligemma-3b": "repro_torch.configs.paligemma_3b",
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
}


def list_archs() -> list[str]:
    return list(_MODULES)


def get_config(name: str, *, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {list_archs()}")
    cfg = importlib.import_module(_MODULES[name]).ARCH
    return reduced_for_smoke(cfg) if smoke else cfg


__all__ = ["get_config", "list_archs", "ModelConfig", "reduced_for_smoke"]
