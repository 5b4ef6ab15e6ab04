"""Architecture registry: ``--arch <id>`` ids as the reference names them.

Only architectures whose model code is ported to PyTorch are listed: the
dense text transformers. Their configs are the reference's, field for
field; qwen2-0.5b trains on one card at full size, the others' full sizes
need the sharding the port does not have yet (``runtime/sharding.py``).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, reduced_for_smoke

_MODULES = {
    "qwen2-0.5b": "repro_torch.configs.qwen2_0_5b",
    "command-r-plus-104b": "repro_torch.configs.command_r_plus_104b",
    "granite-8b": "repro_torch.configs.granite_8b",
    "gemma-2b": "repro_torch.configs.gemma_2b",
}


def list_archs() -> list[str]:
    return list(_MODULES)


def get_config(name: str, *, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {list_archs()}")
    cfg = importlib.import_module(_MODULES[name]).ARCH
    return reduced_for_smoke(cfg) if smoke else cfg


__all__ = ["get_config", "list_archs", "ModelConfig", "reduced_for_smoke"]
