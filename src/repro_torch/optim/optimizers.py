"""The reference's three optimizers, functional over trees of tensors
(never torch.optim), each with the reference's state tree under the
params' paths, so optimizer state checkpoints are shared:

  - adamw     : ``{"m", "v"}`` f32 (global-norm clipping, bias-corrected
                moments, decoupled weight decay ``u + wd * p``);
  - adafactor : ``{"f": {...: {"vr", "vc"} | {"v"}}}`` f32, the second
                moment factored over the last two dims of every leaf of
                rank 2 or more whose last two dims exceed 1, no momentum;
  - q8adam    : ``{"m": {...: {"q" int8 (n, 256), "s" f32 (n,)}}, "v"}``,
                m in 256-element blocks of int8 codes (round half to even)
                with a scale per block, v bf16.

``update`` follows the reference's (optim/optimizers.py) step for step.
Unlike the reference, it works **in place**: it overwrites the params and
the state it is given and returns the same tensors. At 0.5B params that
saves a second copy of the whole train state on the card. The caller must
not hold on to old values (the checkpointer copies what it needs to the
host during its blocking phase).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.utils.tree import flatten_with_paths, unflatten_from_paths


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]
    """update(grads, state, params, step, norm=None) -> (params, state), in
    place; ``norm`` is the grads' global norm when the caller has it (a
    sharded step, whose grads here are shards)"""
    # True: the update is the same function of each element (given the
    # norm), so it can run on shards as it runs on whole leaves
    elementwise: bool = False


def global_norm(tree: Any) -> torch.Tensor:
    leaves = flatten_with_paths(tree)[0].values()
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))


def clip_by_global_norm(tree: Any, max_norm: float,
                        norm: torch.Tensor | None = None) -> tuple[Any, torch.Tensor]:
    norm = global_norm(tree) if norm is None else norm
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
    def update(grads, state, params, step, norm=None):
        grads, _ = clip_by_global_norm(grads, max_grad_norm, norm)
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

    return Optimizer(init=init, update=update, elementwise=True)


def adafactor(
    lr: float | Callable = 1e-3,
    *,
    eps: float = 1e-30,
    weight_decay: float = 0.0,
    max_grad_norm: float = 1.0,
    decay: float = 0.8,
) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def factored(shape) -> bool:
        return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1

    def init(params):
        flat, treedef = flatten_with_paths(params)

        def zeros(shape, p):
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        def per_leaf(p):
            s = tuple(p.shape)
            if factored(s):
                return {"vr": zeros(s[:-1], p), "vc": zeros(s[:-2] + s[-1:], p)}
            return {"v": zeros(s, p)}

        return {"f": unflatten_from_paths(treedef, {k: per_leaf(p) for k, p in flat.items()})}

    @torch.no_grad()
    def update(grads, state, params, step, norm=None):
        grads, _ = clip_by_global_norm(grads, max_grad_norm, norm)
        t = step.float() + 1.0
        beta = 1.0 - t ** (-decay)
        lr_t = lr_fn(step)
        fp, _ = flatten_with_paths(params)
        fg = flatten_with_paths(grads)[0]
        for k, p in fp.items():
            s = _subtree(state["f"], k)
            g = fg[k].float()
            g2 = g * g + eps
            if "vr" in s:
                s["vr"].copy_(beta * s["vr"] + (1 - beta) * g2.mean(dim=-1))
                s["vc"].copy_(beta * s["vc"] + (1 - beta) * g2.mean(dim=-2))
                vr, vc = s["vr"], s["vc"]
                denom = (vr[..., None] * vc[..., None, :]
                         / torch.clamp(vr.mean(dim=-1)[..., None, None], min=1e-30))
                u = g / torch.sqrt(denom + eps)
            else:
                s["v"].copy_(beta * s["v"] + (1 - beta) * g2)
                u = g / torch.sqrt(s["v"] + eps)
            # update-norm clipping (adafactor's d=1.0 rule, simplified)
            rms = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp(rms, min=1.0)
            u = u + weight_decay * p.float()
            p.copy_((p.float() - lr_t * u).to(p.dtype))
        return params, state

    return Optimizer(init=init, update=update)


_Q8_BLOCK = 256


def _q8_encode(x: torch.Tensor) -> dict:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % _Q8_BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, _Q8_BLOCK)
    scale = blocks.abs().amax(dim=1) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127).to(torch.int8)
    return {"q": q, "s": scale.float()}


def _q8_decode(enc: dict, shape) -> torch.Tensor:
    x = (enc["q"].float() * enc["s"][:, None]).reshape(-1)
    n = math.prod(shape)
    return x[:n].reshape(shape)


def q8adam(
    lr: float | Callable = 1e-3,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.01,
    max_grad_norm: float = 1.0,
) -> Optimizer:
    """Quantized-state Adam: m as int8 blocks with f32 scales, v in bf16
    (the second moment spans too many decades for linear int8)."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        flat, treedef = flatten_with_paths(params)

        def zeros(p, dtype):
            return torch.zeros(p.shape, dtype=dtype, device=p.device)

        return {
            "m": unflatten_from_paths(treedef, {
                k: _q8_encode(zeros(p, torch.float32)) for k, p in flat.items()}),
            "v": unflatten_from_paths(treedef, {
                k: zeros(p, torch.bfloat16) for k, p in flat.items()}),
        }

    @torch.no_grad()
    def update(grads, state, params, step, norm=None):
        grads, _ = clip_by_global_norm(grads, max_grad_norm, norm)
        t = step.float() + 1.0
        lr_t = lr_fn(step)
        bc1, bc2 = 1.0 - b1**t, 1.0 - b2**t
        fp, _ = flatten_with_paths(params)
        fg = flatten_with_paths(grads)[0]
        fv = flatten_with_paths(state["v"])[0]
        for k, p in fp.items():
            enc, v_bf = _subtree(state["m"], k), fv[k]
            g = fg[k].float()
            m = b1 * _q8_decode(enc, p.shape) + (1 - b1) * g
            v = b2 * v_bf.float() + (1 - b2) * g * g
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p.float()
            p.copy_((p.float() - lr_t * u).to(p.dtype))
            new = _q8_encode(m)
            enc["q"].copy_(new["q"])
            enc["s"].copy_(new["s"])
            v_bf.copy_(v.to(torch.bfloat16))
        return params, state

    return Optimizer(init=init, update=update)


def _subtree(tree: dict, path: str) -> dict:
    """The dict at ``path`` ("blocks/attn/wq") of a nested dict."""
    for key in path.split("/"):
        tree = tree[key]
    return tree


def get_optimizer(name: str, lr: float | Callable = 1e-3, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(lr, **kw)
    if name == "adafactor":
        return adafactor(lr, **kw)
    if name == "q8adam":
        return q8adam(lr, **kw)
    raise KeyError(f"unknown optimizer {name!r}")
