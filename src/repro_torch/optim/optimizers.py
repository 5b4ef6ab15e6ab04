"""AdamW as a functional optimizer over trees of tensors (never torch.optim).

The state is ``{"m": tree, "v": tree}`` of f32 tensors under the params'
paths — the reference's layout, so optimizer state checkpoints are shared.
``update`` follows the reference's ``adamw`` (optim/optimizers.py) step for
step: global-norm clipping, bias-corrected moments, decoupled weight decay
``u + wd * p``.

Unlike the reference, ``update`` works **in place**: it overwrites the
params and the moments it is given and returns the same tensors. At 0.5B
params that saves a second copy of the whole train state on the card. The
caller must not hold on to old values (the checkpointer copies what it
needs to the host during its blocking phase).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.utils.tree import flatten_with_paths, unflatten_from_paths


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, torch.Tensor], tuple[Any, Any]]
    """update(grads, state, params, step) -> (params, state), in place"""


def global_norm(tree: Any) -> torch.Tensor:
    leaves = flatten_with_paths(tree)[0].values()
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))


def clip_by_global_norm(tree: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    flat, treedef = flatten_with_paths(tree)
    clipped = {k: (x.float() * scale).to(x.dtype) for k, x in flat.items()}
    return unflatten_from_paths(treedef, clipped), norm


def adamw(
    lr: float | Callable = 1e-3,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.01,
    max_grad_norm: float = 1.0,
) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        flat, treedef = flatten_with_paths(params)
        def zeros():
            return unflatten_from_paths(treedef, {
                k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in flat.items()
            })
        return {"m": zeros(), "v": zeros()}

    @torch.no_grad()
    def update(grads, state, params, step):
        grads, _ = clip_by_global_norm(grads, max_grad_norm)
        t = step.float() + 1.0
        lr_t = lr_fn(step)
        bc1 = 1.0 - b1**t
        bc2 = 1.0 - b2**t
        fp, _ = flatten_with_paths(params)
        fg = flatten_with_paths(grads)[0]
        fm = flatten_with_paths(state["m"])[0]
        fv = flatten_with_paths(state["v"])[0]
        for k, p in fp.items():
            g, m, v = fg[k].float(), fm[k], fv[k]
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            u = u + weight_decay * p.float()
            p.copy_((p.float() - lr_t * u).to(p.dtype))
        return params, state

    return Optimizer(init=init, update=update)


def get_optimizer(name: str, lr: float | Callable = 1e-3, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(lr, **kw)
    raise NotImplementedError(f"optimizer {name!r} is not ported to PyTorch yet")
