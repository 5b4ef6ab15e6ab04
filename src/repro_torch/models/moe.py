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
F)``), the reference's einsums.

Under a mesh (``launch.mesh.use_mesh``, set by the sharded train step) each
rank holds its slice of the batch, and :func:`moe_apply` chooses as the
reference does: with a ``model`` axis of M > 1, E % M == 0 and the tokens
T % (n_dp * M) == 0, the expert-parallel formulation
(:func:`_moe_expert_parallel`): each rank routes its own T / (n_dp * M)
tokens with a capacity per (source rank, expert), packs (M, E/M, C, D),
exchanges it by an all-to-all over ``model``, runs its E/M experts (their
weights gathered over the data axes by the step), and sends the outputs
back by a second all-to-all (``all_to_all_calls`` counts both, forward and
backward). Otherwise every rank runs the single-device formulation over all
tokens, gathered over the data axes, and keeps its own. In both the aux
loss is one pass over all tokens, as the reference's.
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.launch import mesh as _mesh
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import mlp_apply

# each moe_apply call's Routing while routing_log() is open
_LOG: list | None = None
# all-to-alls the expert-parallel path issued in this process (both
# directions of each exchange, forward and backward)
all_to_all_calls = 0


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
    ``dense`` (``wi``/``wg``/``wo`` of the residual FFN). Under a mesh, x
    is this rank's slice of the batch (see the module's docstring)."""
    mesh = _mesh.current_mesh()
    if mesh is not None:
        return _moe_under_mesh(cfg, p, x, mesh)
    return _moe_local(cfg, p, x)


def _aux_loss(cfg: ModelConfig, logits: torch.Tensor, probs: torch.Tensor,
              counts: torch.Tensor, n_ids: int) -> torch.Tensor:
    """Switch load balance over ``n_ids`` routed ids + router z-loss."""
    E = cfg.moe_experts
    f = counts.float() / n_ids
    balance = E * torch.sum(f * probs.reshape(-1, E).mean(0))
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return balance + cfg.router_z_weight * z


def _moe_local(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """The single-device formulation (the reference's ``_moe_gspmd``)."""
    B, S, D = x.shape
    E, K = cfg.moe_experts, cfg.moe_top_k
    T = B * S
    G = math.gcd(cfg.moe_groups, T)
    Tg = T // G
    r = route(cfg, p["router"], x.reshape(G, Tg, D))
    C = r.capacity

    aux = _aux_loss(cfg, r.logits, r.probs, r.counts, T * K)

    row, slot = _slot_maps(r, E)
    x_slot = x.reshape(T, 1, D).expand(T, K, D).reshape(-1, D)
    expert_in = _Rows.apply(x_slot, slot, row)                  # (E*G*C, D)
    y = _experts(cfg, p, expert_in.reshape(E, G * C, D)).reshape(E * G * C, D)
    out = _combine(y, row, slot, r, K).reshape(B, S, D)

    out = _dense_residual(cfg, p, x, out)
    _log(r)
    return out, aux


def _slot_maps(r: Routing, E: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Slot (g, s) <-> expert row ``(e*G + g)*C + pos``, kept slots only
    -> (row per slot, slot per row); the dropped slots and the empty rows
    map to the zero row past the end of the other side."""
    G, n = r.ids.shape
    C, device = r.capacity, r.ids.device
    n_slots, n_rows = G * n, E * G * C
    g_idx = torch.arange(G, device=device)[:, None]
    row = (r.ids.long() * G + g_idx) * C + r.pos.long()
    row = torch.where(r.keep, row, n_rows).reshape(-1)
    slot = torch.full((n_rows + n_slots,), n_slots, dtype=torch.long, device=device)
    # unique targets: each dropped slot writes a spare entry of its own
    spare = n_rows + torch.arange(n_slots, device=device)
    slot[torch.where(row < n_rows, row, spare)] = torch.arange(n_slots, device=device)
    return row, slot[:n_rows]


def _combine(y: torch.Tensor, row: torch.Tensor, slot: torch.Tensor, r: Routing,
             K: int) -> torch.Tensor:
    """Expert rows -> (T, D): each token's K gated outputs summed in slot
    order (the reference's scatter-add into zeros)."""
    w = r.gate.to(y.dtype) * r.keep.to(y.dtype)
    y_slot = (_Rows.apply(y, row, slot) * w.reshape(-1, 1)).reshape(-1, K, y.shape[-1])
    out = y_slot[:, 0]
    for k in range(1, K):
        out = out + y_slot[:, k]
    return out


def _dense_residual(cfg: ModelConfig, p: dict, x: torch.Tensor, out: torch.Tensor):
    if "dense" in p:
        d = p["dense"]
        out = out + mlp_apply(d["wi"], d["wo"], d.get("wg"), x, cfg.mlp_type)
    return out


def _log(r: Routing) -> None:
    if _LOG is not None:
        _LOG.append(Routing(*(t.detach() if isinstance(t, torch.Tensor) else t for t in r)))


# -- under a mesh --------------------------------------------------------------------

def token_axes(cfg: ModelConfig, mesh) -> tuple[str, ...]:
    """The mesh axes a rank's slice of the batch is cut along (the rules'
    ``data_axes``), in mesh order."""
    names = ("pod", "data") if cfg.tensor_parallel else ("pod", "data", "model")
    return tuple(a for a in mesh.mesh_dim_names if a in names)


class _GatherTokens(torch.autograd.Function):
    """Forward: all ranks' token blocks along ``axes`` (mesh order, the
    first axis major). Backward: the gradient's sum over those ranks, this
    rank's block: each rank's loss reaches every rank's tokens."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        for a in reversed(axes):
            x = _mesh.all_gather(x, mesh, a, 0)
        return x

    @staticmethod
    def backward(ctx, g):
        for a in ctx.axes:
            g = _mesh.reduce_scatter(g, ctx.mesh, a, 0)
        return g, None, None


class _SplitModel(torch.autograd.Function):
    """Forward: this rank's block of tokens that every rank of the
    ``model`` axis holds alike. Backward: the blocks' gradients gathered,
    so that every rank carries the whole gradient on."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        n = _mesh.axis_sizes(mesh)["model"]
        i = _mesh.coordinate(mesh, "model")
        return x.chunk(n, 0)[i].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _mesh.all_gather(g.contiguous(), ctx.mesh, "model", 0), None


class _GatherModel(torch.autograd.Function):
    """The inverse of :class:`_SplitModel`: every rank's block forward,
    this rank's block of the (alike) gradient backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _mesh.all_gather(x, mesh, "model", 0)

    @staticmethod
    def backward(ctx, g):
        n = _mesh.axis_sizes(ctx.mesh)["model"]
        return g.chunk(n, 0)[_mesh.coordinate(ctx.mesh, "model")].contiguous(), None


class _AllToAll(torch.autograd.Function):
    """Block i of dim 0 to rank i of ``model``, both ways (an equal-split
    all-to-all is its own inverse)."""

    @staticmethod
    def forward(ctx, x, mesh):
        global all_to_all_calls
        ctx.mesh = mesh
        all_to_all_calls += 1
        return _mesh.all_to_all(x, mesh, "model")

    @staticmethod
    def backward(ctx, g):
        global all_to_all_calls
        all_to_all_calls += 1
        return _mesh.all_to_all(g.contiguous(), ctx.mesh, "model"), None


def expert_parallel(cfg: ModelConfig, mesh, tokens: int) -> bool:
    """The reference's choice: a ``model`` axis of M > 1 ranks, E % M == 0
    and the tokens (all of one call) T % (n_dp * M) == 0."""
    sizes = _mesh.axis_sizes(mesh)
    M = sizes.get("model", 1)
    n_dp = math.prod(sizes[a] for a in ("pod", "data") if a in sizes)
    return (cfg.family == "moe" and M > 1 and cfg.moe_experts % M == 0
            and tokens % (n_dp * M) == 0)


def _moe_under_mesh(cfg: ModelConfig, p: dict, x: torch.Tensor, mesh):
    """``moe_apply`` on this rank's slice x (B/n, S, D) of the batch."""
    B, S, D = x.shape
    sizes = _mesh.axis_sizes(mesh)
    tok = token_axes(cfg, mesh)
    n_tok = math.prod(sizes[a] for a in tok)
    xt = x.reshape(B * S, D)
    x_all = _GatherTokens.apply(xt, mesh, tok)                      # (T, D)
    if not expert_parallel(cfg, mesh, B * S * n_tok):
        out, aux = _moe_local(cfg, p, x_all.reshape(B * n_tok, S, D))
        mine = sum(_mesh.coordinate(mesh, a) * math.prod(sizes[b] for b in tok[i + 1:])
                   for i, a in enumerate(tok))
        return out[mine * B : (mine + 1) * B], aux
    return _moe_expert_parallel(cfg, p, x, x_all, mesh, tok, sizes["model"])


def _moe_expert_parallel(cfg: ModelConfig, p: dict, x: torch.Tensor, x_all: torch.Tensor,
                         mesh, tok: tuple[str, ...], M: int):
    """The reference's ``_moe_expert_parallel``: route this rank's tokens,
    dispatch by all-to-all over ``model``, run the local experts, return."""
    B, S, D = x.shape
    E, K = cfg.moe_experts, cfg.moe_top_k
    E_loc = E // M
    if p["wi"].shape[0] != E_loc:
        raise ValueError(f"expert-parallel MoE wants this rank's {E_loc} of {E} experts, "
                         f"got {p['wi'].shape[0]}")
    # aux from one pass over all tokens (cheap; the same decisions)
    logits = x_all.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    ids = torch.topk(probs, K, dim=-1).indices.reshape(-1)
    experts = torch.arange(E, dtype=ids.dtype, device=ids.device)
    counts = (ids[:, None] == experts).to(torch.int32).sum(0)
    aux = _aux_loss(cfg, logits, probs, counts, ids.numel())

    xt = x.reshape(B * S, D)
    router = p["router"]
    if "model" in tok:
        x_loc = xt                                                  # (T_loc, D)
    else:
        # the ranks of ``model`` hold the router alike but apply it each to
        # its own tokens: its gradient is summed over them
        x_loc, router = _SplitModel.apply(xt, mesh), _mesh.sum_grad_over(router, mesh, "model")
    T_loc = x_loc.shape[0]
    r = route(cfg, router, x_loc.reshape(1, T_loc, D))              # C_loc per expert
    C = r.capacity
    row, slot = _slot_maps(r, E)
    x_slot = x_loc.reshape(T_loc, 1, D).expand(T_loc, K, D).reshape(-1, D)
    send = _Rows.apply(x_slot, slot, row)                  # (M * E_loc * C, D)
    recv = _AllToAll.apply(send, mesh)                     # block i: from rank i
    h = recv.reshape(M, E_loc, C, D).transpose(0, 1).reshape(E_loc, M * C, D)
    y = _experts(cfg, p, h).reshape(E_loc, M, C, D).transpose(0, 1)
    back = _AllToAll.apply(y.reshape(M * E_loc * C, D), mesh)   # my slots' outputs
    out = _combine(back, row, slot, r, K)
    if "model" not in tok:
        out = _GatherModel.apply(out, mesh)
    out = _dense_residual(cfg, p, x, out.reshape(B, S, D))
    _log(r)
    return out, aux
