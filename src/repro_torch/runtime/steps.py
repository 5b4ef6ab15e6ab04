"""Train steps: loss -> grad -> (microbatch accumulation) -> optimizer, over
trees of tensors.

The reference's ``make_train_step`` (runtime/steps.py): one batch and one
``value_and_grad`` at ``mb == 1``; at ``mb > 1`` the batch splits along
dim 0 into ``mb`` microbatches whose per-leaf grads are summed in
``cfg.accum_dtype`` and divided by ``mb``, the loss the mean of theirs.
Shardings are not ported yet.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.zoo import Model
from repro_torch.optim import Optimizer, global_norm
from repro_torch.utils.dtypes import torch_dtype
from repro_torch.utils.tree import flatten_with_paths, unflatten_from_paths


def loss_and_grads(model: Model, params: Any, batch: Any, microbatches: int = 1):
    """``(loss, metrics, grads)`` of ``model.loss`` at ``params``.

    At ``microbatches == 1`` the grads are in the params' dtypes and the
    metrics are the loss's own. Above it, each leaf of ``batch`` splits
    along dim 0 (which must divide), the grads come out in
    ``cfg.accum_dtype`` as the sum over microbatches divided by their
    count, and the metrics hold the loss alone: the mean of the
    microbatches' losses (the reference's keys).
    """
    flat, treedef = flatten_with_paths(params)
    mb = int(microbatches)
    if mb == 1:
        leaves = {k: p.detach().requires_grad_(True) for k, p in flat.items()}
        loss, metrics = model.loss(unflatten_from_paths(treedef, leaves), batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, unflatten_from_paths(treedef, dict(zip(leaves, grads)))
    acc_dt = torch_dtype(model.cfg.accum_dtype)
    n = {k: v.shape[0] for k, v in batch.items()}
    if any(size % mb for size in n.values()):
        raise ValueError(f"batch {n} does not split into {mb} microbatches")
    acc = {k: torch.zeros(p.shape, dtype=acc_dt, device=p.device) for k, p in flat.items()}
    loss_sum = None
    for i in range(mb):
        micro = {k: v[i * n[k] // mb : (i + 1) * n[k] // mb] for k, v in batch.items()}
        leaves = {k: p.detach().requires_grad_(True) for k, p in flat.items()}
        loss, _ = model.loss(unflatten_from_paths(treedef, leaves), micro)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        for k, g in zip(leaves, grads):
            acc[k] += g.to(acc_dt)
        loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
    # grads stay in the accumulation dtype: the optimizer upcasts per leaf
    grads = unflatten_from_paths(treedef, {k: g / mb for k, g in acc.items()})
    loss = loss_sum / mb
    return loss, {"loss": loss}, grads


def make_train_step(model: Model, optimizer: Optimizer, *, microbatches: int | None = None):
    """Returns ``step_fn(state, batch) -> (state, metrics)``.

    ``state`` is ``{"params", "opt", "step"}``; params and optimizer state
    are updated in place (see ``optim.optimizers``), ``step`` is replaced
    by ``step + 1``. ``microbatches`` (default ``cfg.microbatches``)
    splits each batch for gradient accumulation (:func:`loss_and_grads`).
    Metrics stay on the device: reading them syncs.
    """
    mb = microbatches or model.cfg.microbatches

    def step_fn(state: Any, batch: Any):
        params, opt, step = state["params"], state["opt"], state["step"]
        loss, metrics, grads = loss_and_grads(model, params, batch, mb)
        metrics["loss"] = loss
        new_params, new_opt = optimizer.update(grads, opt, params, step)
        with torch.no_grad():
            metrics["grad_norm"] = global_norm(grads)
        return {"params": new_params, "opt": new_opt, "step": step + 1}, metrics

    return step_fn


def batch_to_device(batch: dict, device: torch.device | str) -> dict:
    """numpy batch (``data.SyntheticBatches``) -> tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
