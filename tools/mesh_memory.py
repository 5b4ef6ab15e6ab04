#!/usr/bin/env python3
"""Per-rank memory of the sharded train step, for every config at full
size on the four-rank meshes (data=4,) and (data=2, model=2), from the
shapes alone (the meta device; nothing is allocated, no rank is started):

    PYTHONPATH=src python3 tools/mesh_memory.py

Bytes a rank holds, in GB (1e9), activations not counted:

- ``state``: its blocks of the params and the optimizer state, laid out
  by the rules (``runtime.steps.make_train_state_specs``);
- ``grads``: its blocks of the grads (the params' dtype, or
  ``cfg.accum_dtype`` above one microbatch);
- ``gathered``: the leaves the step gathers whole as the loss starts
  (embeddings, head, final norm; every leaf of the SSM and hybrid
  families), with their whole grads, plus three copies of the largest
  layer's gathered weights (the forward's, the backward's recomputed, and
  their grads), each where the step uses it (``compute_placements``: the
  experts, heads and MLP hidden units stay split over ``model``);
- ``update``: a non-elementwise optimizer's largest leaf gathered whole
  (parameter, grad and state);
- ``init``: the whole params, which every rank makes before cutting its
  blocks (``init_sharded_state``), and the largest leaf's optimizer state;
- ``peak``: the larger of ``init`` and the sum of the others.
"""
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))
import torch  # noqa: E402

from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.launch.mesh import axis_sizes, make_abstract_mesh  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.optim import get_optimizer  # noqa: E402
from repro_torch.runtime.sharding import ShardingRules, placements  # noqa: E402
from repro_torch.runtime.steps import (  # noqa: E402
    _nest,
    _opt_param_path,
    compute_placements,
    make_train_state_specs,
)
from repro_torch.utils.dtypes import torch_dtype  # noqa: E402
from repro_torch.utils.tree import flatten_with_paths  # noqa: E402

MESHES = (((4,), ("data",)), ((2, 2), ("data", "model")))
CARD_GB = 80.0


def _block(numel: int, pls: tuple, sizes: tuple) -> int:
    return numel // math.prod(n for p, n in zip(pls, sizes) if p.is_shard())


def rank_bytes(arch: str, shape: tuple, axes: tuple) -> dict:
    cfg = get_config(arch)
    params = flatten_with_paths(build(cfg).init(torch.Generator(), "meta"))[0]
    optimizer = get_optimizer(cfg.optimizer, 1e-3)
    opt = flatten_with_paths(optimizer.init(
        build(cfg).init(torch.Generator(), "meta")))[0]
    mesh = make_abstract_mesh(shape, axes)
    rules, sizes = ShardingRules(cfg, mesh), tuple(axis_sizes(mesh).values())
    specs = make_train_state_specs(_nest(params), _nest(opt), rules)
    grad_size = (torch.tensor([], dtype=torch_dtype(cfg.accum_dtype)).element_size()
                 if cfg.microbatches > 1 else None)
    M = dict(zip(axes, shape)).get("model", 1)
    ep = cfg.family == "moe" and M > 1 and cfg.moe_experts % M == 0
    layered = cfg.family in ("dense", "moe")
    state = grads = whole_leaves = layer = 0
    for path, t in params.items():
        size = t.element_size()
        pl = placements(mesh, specs[f"params/{path}"])
        state += _block(t.numel(), pl, sizes) * size
        grads += _block(t.numel(), pl, sizes) * (grad_size or size)
        used = _block(t.numel(), compute_placements(rules, path, t.dim(), ep), sizes) * size
        if layered and path.startswith("blocks/"):
            layer += used // t.shape[0]
        else:
            whole_leaves += 2 * used
    for path, t in opt.items():
        state += _block(t.numel(), placements(mesh, specs[f"opt/{path}"]), sizes) * t.element_size()
    per_leaf = {p: sum(o.numel() * o.element_size() for q, o in opt.items()
                       if _opt_param_path(q) == p) for p in params}
    update = 0 if optimizer.elementwise else max(
        2 * t.numel() * t.element_size() + per_leaf[p] for p, t in params.items())
    init = sum(t.numel() * t.element_size() for t in params.values()) + max(per_leaf.values())
    gathered = whole_leaves + 3 * layer
    return {"params_b": sum(t.numel() for t in params.values()) / 1e9,
            "optimizer": cfg.optimizer, "state": state, "grads": grads,
            "gathered": gathered, "update": update, "init": init,
            "peak": max(init, state + grads + gathered + update)}


def main() -> int:
    print("| config | optimizer | params (B) | mesh | state | grads | gathered | update "
          "| init | peak | fits 80 GB |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- | --- |")
    for arch in list_archs():
        for shape, axes in MESHES:
            r = rank_bytes(arch, shape, axes)
            gb = {k: r[k] / 1e9 for k in ("state", "grads", "gathered", "update", "init", "peak")}
            mesh = ", ".join(f"{a}={n}" for a, n in zip(axes, shape))
            print(f"| {arch} | {r['optimizer']} | {r['params_b']:.2f} | ({mesh}) | "
                  + " | ".join(f"{gb[k]:.1f}" for k in ("state", "grads", "gathered", "update",
                                                        "init", "peak"))
                  + f" | {'yes' if gb['peak'] < CARD_GB else 'no'} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
