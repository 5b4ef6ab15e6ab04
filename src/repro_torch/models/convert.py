"""Weights across: the JAX reference's state, as numpy arrays, into tensors.

``state_from_numpy`` takes a tree of numpy arrays (what ``np.asarray``
makes of the reference's params and optimizer state) and returns the same
tree of tensors, same paths and shapes. bfloat16 arrays (an ``ml_dtypes``
type, which this package does not import) cross as their ``uint16`` bit
patterns and are viewed back as ``torch.bfloat16``, so no value is rounded.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.utils.tree import flatten_with_paths, unflatten_from_paths


def array_to_tensor(a: Any, device: torch.device | str = "cpu") -> torch.Tensor:
    a = np.array(a, order="C")  # a C-ordered copy (keeps 0-d arrays 0-d)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def state_from_numpy(tree: Any, device: torch.device | str = "cpu") -> Any:
    flat, treedef = flatten_with_paths(tree)
    return unflatten_from_paths(
        treedef, {p: array_to_tensor(a, device) for p, a in flat.items()}
    )
