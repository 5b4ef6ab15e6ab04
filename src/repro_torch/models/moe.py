"""Mixture-of-Experts MLP with group-local capacity dispatch.

The single-device semantics of the reference's ``_moe_gspmd``
(models/moe.py): the batch-major flattened tokens split into
``G = gcd(cfg.moe_groups, T)`` groups; each token's top-k experts give
``(token, k)`` slots, token-major; a slot's position within its expert is
the count of earlier slots of its group routed there, and the slots at or
past the group's capacity ``Cg = ceil(Tg * K / E * capacity_factor)`` are
dropped. The router is an f32 leaf in every model, and its aux loss
(Switch load balance + router z-loss) is taken over all tokens. Arctic's
dense residual FFN runs on the MoE input beside the experts and adds.

Where the reference scatter-adds (dispatch into ``(G, E, Cg, D)``, the
combine into tokens, the per-expert count), the port writes each value
once, so that a CUDA run is deterministic without the slow sorted paths
that deterministic algorithms give accumulating scatters:

- kept slots and expert rows are a partial one-to-one map, so dispatch and
  combine are row gathers whose gradients are the gathers of the inverse
  map (:class:`_Rows`), never an accumulation;
- a token's K weighted expert outputs are summed in slot order in the
  activations' dtype, as the reference's scatter-add into zeros does;
- the expert counts are a sum over an int32 one-hot.

The expert products are batched over experts (``(E, G*Cg, D) @ (E, D,
F)``), the reference's einsums. The reference's expert-parallel
formulation (``_moe_expert_parallel``) runs only under a mesh with a
``model`` axis; it waits for the port's sharding.
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import mlp_apply

# each moe_apply call's Routing while routing_log() is open
_LOG: list | None = None


@contextlib.contextmanager
def routing_log():
    """Collects each :func:`moe_apply` call's :class:`Routing` (tensors
    detached) into the yielded list, in call order: one entry per MoE
    layer a forward or decode step runs. A rematerialised layer logs again
    when its backward recomputes it."""
    global _LOG
    outer, _LOG = _LOG, []
    try:
        yield _LOG
    finally:
        _LOG = outer


class Routing(NamedTuple):
    """One call's routing: logits and probs (G, Tg, E) f32, the normalised
    gates and expert ids (G, Tg*K) slot-major, each slot's position in its
    expert (G, Tg*K) int32, ``keep`` (pos < Cg), the capacity ``Cg``, and
    each expert's count of ids over all groups (E,)."""

    logits: torch.Tensor
    probs: torch.Tensor
    gate: torch.Tensor
    ids: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    capacity: int
    counts: torch.Tensor


def route(cfg: ModelConfig, router: torch.Tensor, xt: torch.Tensor) -> Routing:
    """xt (G, Tg, D) -> the group-local routing of its Tg*K slots."""
    G, Tg, _ = xt.shape
    E, K = cfg.moe_experts, cfg.moe_top_k
    logits = xt.float() @ router
    probs = torch.softmax(logits, dim=-1)
    gate, ids = torch.topk(probs, K, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    ids = ids.reshape(G, Tg * K)
    # compared, not F.one_hot: no scatter and no check that syncs the card
    experts = torch.arange(E, dtype=ids.dtype, device=ids.device)
    onehot = (ids[..., None] == experts).to(torch.int32)          # (G, TgK, E)
    before = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    pos = before.gather(2, ids[..., None])[..., 0]
    capacity = int(math.ceil(Tg * K / E * cfg.moe_capacity_factor))
    return Routing(logits, probs, gate.reshape(G, Tg * K), ids, pos,
                   pos < capacity, capacity, onehot.sum((0, 1)))


class _Rows(torch.autograd.Function):
    """``out[i] = src[fwd[i]]``, and 0 where ``fwd[i] == len(src)``, for a
    partial one-to-one map: ``bwd`` is its inverse (``bwd[fwd[i]] == i``,
    ``len(out)`` where no row maps). The gradient is the gather of the
    inverse, so no row is ever accumulated."""

    @staticmethod
    def forward(ctx, src, fwd, bwd):
        ctx.save_for_backward(fwd, bwd)
        return F.pad(src, (0, 0, 0, 1)).index_select(0, fwd)

    @staticmethod
    def backward(ctx, grad):
        fwd, bwd = ctx.saved_tensors
        return F.pad(grad, (0, 0, 0, 1)).index_select(0, bwd), None, None


def _experts(cfg: ModelConfig, p: dict, xe: torch.Tensor) -> torch.Tensor:
    """xe (E, N, D) -> (E, N, D) through each expert's FFN."""
    if "wg" in p:
        act = F.silu if cfg.mlp_type == "swiglu" else (
            lambda t: F.gelu(t, approximate="tanh"))
        h = act(xe @ p["wg"]) * (xe @ p["wi"])
    else:
        h = F.gelu(xe @ p["wi"], approximate="tanh")
    return h @ p["wo"]


def moe_apply(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """x (B, S, D) -> (out (B, S, D), aux f32 scalar). ``p``: ``router``
    (D, E) f32, ``wi``/``wg`` (E, D, F), ``wo`` (E, F, D), optional
    ``dense`` (``wi``/``wg``/``wo`` of the residual FFN)."""
    B, S, D = x.shape
    E, K = cfg.moe_experts, cfg.moe_top_k
    T = B * S
    G = math.gcd(cfg.moe_groups, T)
    Tg = T // G
    r = route(cfg, p["router"], x.reshape(G, Tg, D))
    C = r.capacity

    # aux: Switch load balance over all T*K ids + router z-loss
    f = r.counts.float() / (T * K)
    p_mean = r.probs.reshape(-1, E).mean(0)
    balance = E * torch.sum(f * p_mean)
    z = torch.mean(torch.logsumexp(r.logits, dim=-1) ** 2)
    aux = balance + cfg.router_z_weight * z

    # slot (g, s) <-> expert row e*G*C + g*C + pos, kept slots only; the
    # dropped ones and the empty rows map to the zero row past the end
    n_slots, n_rows = G * Tg * K, E * G * C
    g_idx = torch.arange(G, device=x.device)[:, None]
    row = (r.ids.long() * G + g_idx) * C + r.pos.long()
    row = torch.where(r.keep, row, n_rows).reshape(-1)
    slot = torch.full((n_rows + n_slots,), n_slots, dtype=torch.long, device=x.device)
    # unique targets: each dropped slot writes a spare entry of its own
    spare = n_rows + torch.arange(n_slots, device=x.device)
    slot[torch.where(row < n_rows, row, spare)] = torch.arange(n_slots, device=x.device)
    slot = slot[:n_rows]

    x_slot = x.reshape(T, 1, D).expand(T, K, D).reshape(n_slots, D)
    expert_in = _Rows.apply(x_slot, slot, row)                  # (E*G*C, D)
    y = _experts(cfg, p, expert_in.reshape(E, G * C, D)).reshape(n_rows, D)
    w = r.gate.to(x.dtype) * r.keep.to(x.dtype)
    y_slot = (_Rows.apply(y, row, slot) * w.reshape(-1, 1)).reshape(T, K, D)
    out = y_slot[:, 0]
    for k in range(1, K):
        out = out + y_slot[:, k]
    out = out.reshape(B, S, D)

    if "dense" in p:
        d = p["dense"]
        out = out + mlp_apply(d["wi"], d["wo"], d.get("wg"), x, cfg.mlp_type)
    if _LOG is not None:
        _LOG.append(Routing(*(t.detach() if isinstance(t, torch.Tensor) else t for t in r)))
    return out, aux
