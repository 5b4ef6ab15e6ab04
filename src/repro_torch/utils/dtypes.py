"""Dtype names as the checkpoint format writes them, and their tensor types.

Manifests record each leaf's dtype by its numpy name (``"bfloat16"``,
``"float32"``, ...). The JAX reference maps names through ``ml_dtypes``;
the port maps them through this table instead, so it never needs
``ml_dtypes`` and can still read and write bfloat16 leaves.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

TORCH_DTYPES: dict[str, torch.dtype] = {
    "bool": torch.bool,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "uint16": torch.uint16,
    "int32": torch.int32,
    "uint32": torch.uint32,
    "int64": torch.int64,
    "uint64": torch.uint64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
}
DTYPE_NAMES: dict[torch.dtype, str] = {v: k for k, v in TORCH_DTYPES.items()}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return TORCH_DTYPES[name]
    except KeyError:
        raise KeyError(
            f"dtype {name!r} has no tensor type; have {sorted(TORCH_DTYPES)}"
        ) from None


def dtype_name(leaf: Any) -> str:
    """The manifest dtype name of a tensor, a numpy-convertible leaf, or a
    leaf that names its own (``core.shadow.HostShardView``)."""
    if isinstance(leaf, torch.Tensor):
        return DTYPE_NAMES[leaf.dtype]
    name = getattr(leaf, "dtype_name", None)
    if isinstance(name, str):
        return name
    return np.asarray(leaf).dtype.name


def leaf_shape(leaf: Any) -> list[int]:
    if isinstance(leaf, torch.Tensor):
        return list(leaf.shape)
    return list(np.shape(leaf))


def leaf_nbytes(leaf: Any) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return int(np.asarray(leaf).nbytes)


def byte_view(x: torch.Tensor) -> torch.Tensor:
    """A tensor's C-order bytes as a flat u8 tensor on its own device.

    ``reshape(-1)`` first, because ``.view(torch.uint8)`` refuses 0-d
    tensors; empty tensors get an empty byte tensor (their stride-0 views
    refuse a dtype view too). A non-contiguous tensor is copied.
    """
    flat = x.detach().reshape(-1)
    if flat.numel() == 0:
        return torch.empty(0, dtype=torch.uint8, device=x.device)
    return flat.view(torch.uint8)
