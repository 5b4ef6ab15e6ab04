"""Quiesce the device before a snapshot (paper §3.4: cudaDeviceSynchronize).

PyTorch launches CUDA work asynchronously — the Python train loop runs
ahead of the device exactly like CRUM's pipelined proxy calls run ahead of
the GPU. ``drain`` is the pipeline flush: block until every in-flight
computation on the state's devices has landed.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.utils.timing import Timer
from repro_torch.utils.tree import flatten_with_paths


def drain(state: Any) -> float:
    """Returns seconds spent draining."""
    with Timer() as t:
        from repro_torch.core.shadow import HostShardView

        flat, _ = flatten_with_paths(state)
        leaves = [leaf.data if isinstance(leaf, HostShardView) else leaf
                  for leaf in flat.values()]
        devices = {
            leaf.device for leaf in leaves
            if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda"
        }
        for dev in devices:
            torch.cuda.synchronize(dev)
    return t.elapsed
