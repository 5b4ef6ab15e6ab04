"""Train steps: loss -> grad -> optimizer, over trees of tensors.

The reference's ``make_train_step`` (runtime/steps.py) at ``mb == 1``:
one batch, one ``value_and_grad``, one optimizer update. Microbatch
accumulation and shardings are not ported yet.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.zoo import Model
from repro_torch.optim import Optimizer, global_norm
from repro_torch.utils.tree import flatten_with_paths, unflatten_from_paths


def make_train_step(model: Model, optimizer: Optimizer, *, microbatches: int | None = None):
    """Returns ``step_fn(state, batch) -> (state, metrics)``.

    ``state`` is ``{"params", "opt", "step"}``; params and optimizer state
    are updated in place (see ``optim.optimizers``), ``step`` is replaced
    by ``step + 1``. Metrics stay on the device: reading them syncs.
    """
    mb = microbatches or model.cfg.microbatches
    if mb != 1:
        raise NotImplementedError("microbatch accumulation is not ported yet")

    def step_fn(state: Any, batch: Any):
        params, opt, step = state["params"], state["opt"], state["step"]
        flat, treedef = flatten_with_paths(params)
        leaves = {k: p.detach().requires_grad_(True) for k, p in flat.items()}
        loss, metrics = model.loss(unflatten_from_paths(treedef, leaves), batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        grads = unflatten_from_paths(treedef, dict(zip(leaves, grads)))
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        new_params, new_opt = optimizer.update(grads, opt, params, step)
        with torch.no_grad():
            metrics["grad_norm"] = global_norm(grads)
        return {"params": new_params, "opt": new_opt, "step": step + 1}, metrics

    return step_fn


def batch_to_device(batch: dict, device: torch.device | str) -> dict:
    """numpy batch (``data.SyntheticBatches``) -> tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
