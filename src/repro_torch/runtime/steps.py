"""Train steps: loss -> grad -> (microbatch accumulation) -> optimizer, over
trees of tensors.

The reference's ``make_train_step`` (runtime/steps.py): one batch and one
``value_and_grad`` at ``mb == 1``; at ``mb > 1`` the batch splits along
dim 0 into ``mb`` microbatches whose per-leaf grads are summed in
``cfg.accum_dtype`` and divided by ``mb``, the loss the mean of theirs.

Under a mesh (``rules``: :class:`runtime.sharding.ShardingRules` over a
``DeviceMesh``) the state is DTensors laid out by the rules
(:func:`make_train_state_specs`, :func:`distribute`) and each rank runs the
model on its slice of the batch (:func:`local_batch`) with plain tensors:

- every parameter is gathered over the mesh axes it is sharded along
  (FSDP) where the model uses it, except that the MoE experts stay split
  over ``model`` where the expert-parallel formulation runs
  (``models.moe``), the attention projections' heads where the rules split
  them over ``model`` (each rank then runs a model of its own heads), and
  the dense MLP's hidden units where the rules split them: the split parts'
  outputs are summed over ``model`` (``models.transformer.tensor_parallel``).
  The stacked layer weights of the transformer families are gathered one
  layer at a time inside the layer's remat
  (``models.transformer.gathered_layers``), so that a rank holds its blocks
  and one layer's gathered weights, and the backward gathers them again;
  the other leaves (embeddings, head, final norm, and every leaf of the
  SSM and hybrid families) are gathered whole as the loss starts;
- each gather's backward reduces the gradient onto the parameter's own
  placements (:class:`_Gather`): over the batch axes it is partial, over
  the other axes alike (every rank of a ``model`` group runs the same
  tokens); it is summed in f32 (a reduce-scatter where the parameter is
  sharded over a batch axis) and divided by the number of batch slices,
  so that each rank's grads are its blocks of the grads of the loss over
  the whole batch;
- the global norm sums each leaf's squares once, on the rank that owns
  its block, over all ranks;
- an elementwise optimizer (AdamW) updates each rank's blocks in place,
  any other (adafactor, q8adam) gathers each leaf's parameter, grad and
  state whole, updates them as one card would, and keeps its blocks: the
  largest leaf, three-fold, must fit on a card.

Every collective goes through ``launch.mesh`` (which stages CUDA tensors
through the host under gloo). A run without a mesh is the step above, the
same code and the same bits.
"""
from __future__ import annotations

import contextlib
import math
import re
from typing import Any

import torch

from repro_torch.launch import mesh as _mesh
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import expert_parallel, token_axes
from repro_torch.models.zoo import Model, build
from repro_torch.optim import Optimizer, global_norm
from repro_torch.runtime.sharding import ShardingRules, Spec, fit_spec, placements
from repro_torch.utils.dtypes import torch_dtype
from repro_torch.utils.tree import flatten_with_paths, unflatten_from_paths


def loss_and_grads(model: Model, params: Any, batch: Any, microbatches: int = 1,
                   prepare=None):
    """``(loss, metrics, grads)`` of ``model.loss`` at ``params``.

    At ``microbatches == 1`` the grads are in the params' dtypes and the
    metrics are the loss's own. Above it, each leaf of ``batch`` splits
    along dim 0 (which must divide), the grads come out in
    ``cfg.accum_dtype`` as the sum over microbatches divided by their
    count, and the metrics hold the loss alone: the mean of the
    microbatches' losses (the reference's keys). ``prepare`` maps the
    leaves ``{path: tensor}`` to what the model takes, inside the graph
    the grads are taken through (a sharded step's gathers).
    """
    flat, treedef = flatten_with_paths(params)
    mb = int(microbatches)
    if mb == 1:
        leaves = {k: p.detach().requires_grad_(True) for k, p in flat.items()}
        loss, metrics = model.loss(
            unflatten_from_paths(treedef, prepare(leaves) if prepare else leaves), batch)
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
        loss, _ = model.loss(
            unflatten_from_paths(treedef, prepare(leaves) if prepare else leaves), micro)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        for k, g in zip(leaves, grads):
            acc[k] += g.to(acc_dt)
        loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
    # grads stay in the accumulation dtype: the optimizer upcasts per leaf
    grads = unflatten_from_paths(treedef, {k: g / mb for k, g in acc.items()})
    loss = loss_sum / mb
    return loss, {"loss": loss}, grads


def make_train_step(model: Model, optimizer: Optimizer, *, microbatches: int | None = None,
                    rules: ShardingRules | None = None):
    """Returns ``step_fn(state, batch) -> (state, metrics)``.

    ``state`` is ``{"params", "opt", "step"}``; params and optimizer state
    are updated in place (see ``optim.optimizers``), ``step`` is replaced
    by ``step + 1``. ``microbatches`` (default ``cfg.microbatches``)
    splits each batch for gradient accumulation (:func:`loss_and_grads`).
    Metrics stay on the device: reading them syncs. With ``rules`` the
    state is sharded over their mesh and ``batch`` is the whole batch,
    which every rank holds alike (see the module's docstring).
    """
    mb = microbatches or model.cfg.microbatches
    if rules is not None:
        return _sharded_step(model, optimizer, rules, mb)

    def step_fn(state: Any, batch: Any):
        params, opt, step = state["params"], state["opt"], state["step"]
        loss, metrics, grads = loss_and_grads(model, params, batch, mb)
        metrics["loss"] = loss
        new_params, new_opt = optimizer.update(grads, opt, params, step)
        with torch.no_grad():
            metrics["grad_norm"] = global_norm(grads)
        return {"params": new_params, "opt": new_opt, "step": step + 1}, metrics

    return step_fn


# -- under a mesh -----------------------------------------------------------------------

_STRIP_PREFIX = ("m/", "v/", "f/")
_STRIP_SUFFIX = ("/q", "/s", "/vr", "/vc", "/v")
_EXPERTS = re.compile(r".*moe/w(i|g|o)$")
# the attention projections whose heads split over ``model``: the dim of
# the heads, counted from the end
_HEADS = {re.compile(r".*attn/(wq|wk|wv|bq|bk|bv)$"): 1, re.compile(r".*attn/wo$"): 2}
# the dense MLP's, whose hidden units split over ``model``
_MLP = {re.compile(r"blocks/mlp/w(i|g)$"): 1, re.compile(r"blocks/mlp/wo$"): 2}


def _opt_param_path(path: str) -> str:
    """The parameter an optimizer-state leaf belongs to: the m/v/f prefix
    and any quantisation or factoring suffix stripped."""
    for prefix in _STRIP_PREFIX:
        if path.startswith(prefix):
            path = path[len(prefix):]
            break
    for suffix in _STRIP_SUFFIX:
        if path.endswith(suffix):
            return path[: -len(suffix)]
    return path


def make_train_state_specs(params: Any, opt: Any, rules: ShardingRules) -> dict[str, Spec]:
    """{path: spec} of the train state ``{"params", "opt"}`` (leaves on any
    device, the meta device included; ``step`` stays a replicated plain
    tensor). Moments mirror their parameter's spec; leaves whose rank
    changed (q8 blocks, factored rows and columns) fall back to
    replication through ``fit_spec``, as the reference's do."""
    specs = {f"params/{k}": v for k, v in rules.params_specs(params).items()}
    for path, leaf in flatten_with_paths(opt)[0].items():
        shape = tuple(leaf.shape)
        spec = rules.spec_for(_opt_param_path(path), shape)
        specs[f"opt/{path}"] = fit_spec(rules.mesh, spec, shape)
    return specs


def shard_leaf(leaf: torch.Tensor, mesh, pl: tuple):
    """A whole tensor (the same on every rank) as a DTensor holding this
    rank's block of it, laid out by the placements ``pl``."""
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint.sharded import local_window

    start, stop = local_window(tuple(leaf.shape), mesh, pl)
    block = leaf[tuple(slice(a, b) for a, b in zip(start, stop))].contiguous()
    return DTensor.from_local(block, mesh, pl, run_check=False,
                              shape=leaf.shape, stride=leaf.stride())


def init_sharded_state(params: Any, optimizer: Optimizer, rules: ShardingRules) -> dict:
    """The train state of whole ``params`` (alike on every rank), sharded:
    each leaf's optimizer state is made whole, one leaf at a time, and cut
    to this rank's blocks, so that no rank holds the whole optimizer state
    at once."""
    mesh = rules.mesh
    flat, treedef = flatten_with_paths(params)
    opt_flat: dict[str, Any] = {}
    for path, p in flat.items():
        for opath, o in flatten_with_paths(optimizer.init(_nest({path: p})))[0].items():
            spec = fit_spec(mesh, rules.spec_for(path, tuple(o.shape)), tuple(o.shape))
            opt_flat[opath] = shard_leaf(o, mesh, placements(mesh, spec))
    specs = rules.params_specs(params)
    return {"params": unflatten_from_paths(treedef, {
                k: shard_leaf(p, mesh, placements(mesh, specs[k])) for k, p in flat.items()}),
            "opt": _nest(opt_flat),
            "step": torch.zeros((), dtype=torch.int32, device=next(iter(flat.values())).device)}


def _nest(flat: dict[str, Any]) -> dict:
    """The nested dict of ``{"a/b": leaf}``: ``{"a": {"b": leaf}}``."""
    tree: dict = {}
    for path, leaf in flat.items():
        node, keys = tree, path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return tree


def relayout(x: torch.Tensor, mesh, src, dst) -> torch.Tensor:
    """This rank's block of a leaf laid out by ``src`` (Shard, Replicate or
    Partial per mesh dim) as ``dst`` lays it out (Shard or Replicate).

    A mesh dim where both shard the same tensor dim, and no other mesh dim
    shards it, keeps its blocks. The others are gathered (the last mesh
    dim first: the reverse of how nested blocks were cut), then partial
    sums are reduced and blocks cut in mesh order: a reduce-scatter where
    ``dst`` shards, an all-reduce where it replicates."""
    names, sizes = tuple(mesh.mesh_dim_names), tuple(mesh.shape)

    def nested(pls, i):
        return pls[i].is_shard() and any(
            j != i and pls[j].is_shard() and pls[j].dim == pls[i].dim for j in range(len(pls)))

    keep = [src[i].is_shard() and src[i] == dst[i] and not nested(src, i) and not nested(dst, i)
            for i in range(len(names))]
    for i in reversed(range(len(names))):
        if src[i].is_shard() and not keep[i]:
            x = _mesh.all_gather(x, mesh, names[i], src[i].dim)
    # blocks cut alone first (no other mesh dim splits their tensor dim), so
    # that the reductions move only this rank's share
    for i in range(len(names)):
        if src[i].is_replicate() and dst[i].is_shard() and not nested(dst, i):
            x = x.chunk(sizes[i], dst[i].dim)[_mesh.coordinate(mesh, names[i])].contiguous()
            keep[i] = True
    for i in range(len(names)):
        if keep[i]:
            continue
        if src[i].is_partial():
            x = (_mesh.reduce_scatter(x, mesh, names[i], dst[i].dim) if dst[i].is_shard()
                 else _mesh.all_reduce(x, mesh, names[i]))
        elif dst[i].is_shard():
            x = x.chunk(sizes[i], dst[i].dim)[_mesh.coordinate(mesh, names[i])].contiguous()
    return x


def local_batch(batch: dict, rules: ShardingRules, microbatches: int = 1) -> dict:
    """This rank's rows of a whole batch: within each of the
    ``microbatches`` consecutive blocks, its slice over the batch axes
    (the first axis major), so that microbatch i on every rank is its
    share of the whole batch's microbatch i."""
    mesh = rules.mesh
    sizes = _mesh.axis_sizes(mesh)
    axes = token_axes(rules.cfg, mesh)
    n = math.prod(sizes[a] for a in axes)
    mine = 0
    for a in axes:
        mine = mine * sizes[a] + _mesh.coordinate(mesh, a)
    out = {}
    for k, v in batch.items():
        B = v.shape[0]
        if B % (n * microbatches):
            raise ValueError(f"batch {k} of {B} rows does not split into {microbatches} "
                             f"microbatches over {n} ranks")
        per = B // (n * microbatches)
        out[k] = v.reshape((microbatches, n, per) + tuple(v.shape[1:]))[:, mine].reshape(
            (microbatches * per,) + tuple(v.shape[1:]))
    return out


def split_config(cfg: ModelConfig, rules: ShardingRules) -> tuple[ModelConfig, bool, bool]:
    """What a rank of the sharded step runs under ``rules``' mesh (any mesh,
    abstract ones included): ``(config, heads, mlp)``. ``heads``: the
    attention is tensor-parallel over ``model`` (the rules split its heads),
    and the config has H/M heads and Hkv/M kv heads; ``mlp``: the dense
    MLP's hidden units split over ``model``."""
    M = _mesh.axis_sizes(rules.mesh).get("model", 1)
    split = cfg.family in ("dense", "moe") and rules.model_axis is not None and M > 1
    heads = split and not cfg.attn_over_model and rules.kv_heads_shardable()
    mlp = split and cfg.family == "dense" and cfg.d_ff % M == 0
    if heads:
        cfg = cfg.with_overrides(num_heads=cfg.num_heads // M, num_kv_heads=cfg.num_kv_heads // M)
    return cfg, heads, mlp


def compute_placements(rules: ShardingRules, path: str, ndim: int, ep: bool) -> tuple:
    """Where the sharded step uses a parameter on ``rules``' mesh: whole
    (replicated), or its experts (``ep``: the expert-parallel MoE runs),
    attention heads or MLP hidden units split over ``model``
    (:func:`split_config`)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(rules.mesh.mesh_dim_names)
    _cfg, heads, mlp = split_config(rules.cfg, rules)

    def over_model(dim: int) -> tuple:
        return tuple(Shard(dim) if a == "model" else Replicate() for a in names)

    if ep and ndim == 4 and _EXPERTS.fullmatch(path):
        return over_model(1)
    for table, on in ((_HEADS, heads), (_MLP, mlp)):
        for pattern, back in table.items():
            if on and pattern.fullmatch(path):
                return over_model(ndim - back)
    return (Replicate(),) * len(names)


class _Gather(torch.autograd.Function):
    """Forward: this rank's block ``x`` of a parameter laid out by ``src``,
    relaid as ``dst`` lays it out (gathered). Backward: the gradient, laid
    out by ``grad_src`` (partial over the batch axes), summed in f32 onto
    ``src``'s blocks and divided by the ``n`` batch slices."""

    @staticmethod
    def forward(ctx, x, mesh, src, dst, grad_src, n):
        ctx.mesh, ctx.src, ctx.grad_src, ctx.n = mesh, src, grad_src, n
        return relayout(x, mesh, src, dst)

    @staticmethod
    def backward(ctx, g):
        out = relayout(g.float().contiguous(), ctx.mesh, ctx.grad_src, ctx.src) / ctx.n
        return out.to(g.dtype), None, None, None, None, None


def _layer_slice(pls: tuple) -> tuple:
    """Placements of a stacked leaf's layer slice: its dims one lower (the
    layer dim is never sharded)."""
    from torch.distributed.tensor import Shard

    if any(p.is_shard() and p.dim == 0 for p in pls):
        raise ValueError(f"placements {pls} shard the layer dim")
    return tuple(Shard(p.dim - 1) if p.is_shard() else p for p in pls)


def _sharded_step(model: Model, optimizer: Optimizer, rules: ShardingRules, mb: int):
    from torch.distributed.tensor import Partial, Replicate

    cfg, mesh = model.cfg, rules.mesh
    names = tuple(mesh.mesh_dim_names)
    tok = token_axes(cfg, mesh)
    n_tok = math.prod(_mesh.axis_sizes(mesh)[a] for a in tok)
    transformer = cfg.family in ("dense", "moe")
    rank_cfg, heads, mlp = split_config(cfg, rules)
    if heads:
        model = build(rank_cfg)

    def reduce_all(x: torch.Tensor) -> torch.Tensor:
        for a in names:
            x = _mesh.all_reduce(x, mesh, a)
        return x

    def step_fn(state: Any, batch: Any):
        params, opt, step = state["params"], state["opt"], state["step"]
        tokens = math.prod(batch["inputs"].shape[:2]) // mb
        ep = expert_parallel(cfg, mesh, tokens)
        flat_p, p_def = flatten_with_paths(params)
        moves = {}
        for k, p in flat_p.items():
            dst = compute_placements(rules, k, p.dim(), ep)
            grad_src = tuple(pl if pl.is_shard() else (Partial() if a in tok else Replicate())
                             for a, pl in zip(names, dst))
            moves[k] = (p.placements, dst, grad_src)

        def gather(path: str, block: torch.Tensor) -> torch.Tensor:
            return _Gather.apply(block, mesh, *moves[path], n_tok)

        def gather_layer(path: str, block: torch.Tensor) -> torch.Tensor:
            return _Gather.apply(block, mesh, *map(_layer_slice, moves[path]), n_tok)

        def prepare(leaves: dict) -> dict:
            return {k: v if transformer and k.startswith("blocks/") else gather(k, v)
                    for k, v in leaves.items()}

        local = unflatten_from_paths(p_def, {k: p.to_local() for k, p in flat_p.items()})
        tp = tfm.tensor_parallel(mesh, heads=heads, mlp=mlp) if heads or mlp \
            else contextlib.nullcontext()
        layers = tfm.gathered_layers(gather_layer) if transformer else contextlib.nullcontext()
        with _mesh.use_mesh(mesh), tp, layers:
            loss, metrics, grads = loss_and_grads(
                model, local, local_batch(batch, rules, mb), mb, prepare=prepare)
        with torch.no_grad():
            shards = flatten_with_paths(grads)[0]
            sq = torch.zeros((), dtype=torch.float32, device=step.device)
            for k, p in flat_p.items():
                if all(c == 0 for c, pl in zip(mesh.get_coordinate(), p.placements)
                       if pl.is_replicate()):
                    sq = sq + torch.sum(torch.square(shards[k].float()))
            del grads
            norm = torch.sqrt(reduce_all(sq))
            metrics = {k: _mean_over(v, mesh, tok) for k, v in metrics.items()}
            metrics["loss"] = _mean_over(loss, mesh, tok)
            _update(optimizer, shards, opt, flat_p, step, norm, mesh)
            metrics["grad_norm"] = norm
        return {"params": params, "opt": opt, "step": step + 1}, metrics

    return step_fn


def _mean_over(x: torch.Tensor, mesh, axes: tuple[str, ...]) -> torch.Tensor:
    n = 1
    for a in axes:
        x = _mesh.all_reduce(x, mesh, a)
        n *= _mesh.axis_sizes(mesh)[a]
    return x / n


def _update(optimizer: Optimizer, grads: dict, opt: Any, params: dict, step, norm, mesh) -> None:
    """The optimizer on the sharded state, in place (see the module's
    docstring)."""
    o_flat, _ = flatten_with_paths(opt)
    if optimizer.elementwise:
        optimizer.update(_nest(grads), _nest({k: o.to_local() for k, o in o_flat.items()}),
                         _nest({k: p.to_local() for k, p in params.items()}), step, norm=norm)
        return
    from torch.distributed.tensor import Replicate

    for k, p in params.items():
        whole = (Replicate(),) * p.device_mesh.ndim
        mine = {o: v for o, v in o_flat.items() if _opt_param_path(o) == k}
        full = {o: relayout(v.to_local(), mesh, v.placements, whole) for o, v in mine.items()}
        full_p = relayout(p.to_local(), mesh, p.placements, whole)
        full_g = relayout(grads[k], mesh, p.placements, whole)
        optimizer.update(_nest({k: full_g}), _nest(full), _nest({k: full_p}), step, norm=norm)
        p.to_local().copy_(relayout(full_p, mesh, whole, p.placements))
        for o, v in mine.items():
            v.to_local().copy_(relayout(full[o], mesh, whole, v.placements))


def batch_to_device(batch: dict, device: torch.device | str) -> dict:
    """numpy batch (``data.SyntheticBatches``) -> tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
