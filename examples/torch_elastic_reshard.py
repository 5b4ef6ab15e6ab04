"""Elastic restart, PyTorch port: checkpoint on a (4, 2) mesh, restore onto
an (8,) mesh.

The twin of ``examples/elastic_reshard.py``: 8 ranks over gloo on the CPU
stand in for two cluster shapes. On mesh A = (data=4, model=2) the state
is sharded by the sharding rules and trained 3 steps; every rank persists
the blocks it owns and one image commits. On mesh B = (data=8,) each rank
restores only its own blocks of that image and trains 2 more steps. No
device state is in the image, so the same checkpoint restores onto any
topology.

    PYTHONPATH=src python examples/torch_elastic_reshard.py

``--init-params FILE.npz`` starts from given params ({path: array}, the
reference example's ``model.init(jax.random.key(0))`` for a parity
check) instead of the port's own seeded init; ``--json`` adds a line with
the losses unrounded.
"""
import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import torch


def rank_main(args) -> None:
    import torch.distributed as dist

    from repro_torch.checkpoint import ChunkStore
    from repro_torch.checkpoint.sharded import ShardTarget
    from repro_torch.core import ForkedCheckpointer, RestoreManager
    from repro_torch.core.trainer import commit_ranks, owned_view
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.models import ModelConfig, build
    from repro_torch.models.convert import state_from_numpy
    from repro_torch.optim import get_optimizer
    from repro_torch.runtime.sharding import ShardingRules, placements
    from repro_torch.runtime.steps import (
        init_sharded_state,
        make_train_state_specs,
        make_train_step,
    )
    from repro_torch.utils.tree import unflatten_from_paths, flatten_with_paths

    init_distributed("gloo")
    rank = dist.get_rank()
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = ModelConfig(
        name="elastic-demo", family="dense", num_layers=2, d_model=128,
        vocab_size=512, num_heads=8, num_kv_heads=8, head_dim=16, d_ff=256,
        param_dtype="float32", compute_dtype="float32",
    )
    model = build(cfg)
    opt = get_optimizer("adamw", 1e-3)
    rngb = np.random.default_rng(0)
    batch = {
        "inputs": torch.from_numpy(rngb.integers(0, 512, (8, 32)).astype(np.int32)),
        "targets": torch.from_numpy(rngb.integers(0, 512, (8, 32)).astype(np.int32)),
    }
    if args.init_params:
        with np.load(args.init_params) as z:
            flat = {k: z[k] for k in z.files}
        params = state_from_numpy(unflatten_from_paths(
            flatten_with_paths(model.init(torch.Generator(), "meta"))[1], flat))
    else:
        params = model.init(torch.Generator().manual_seed(0))
    losses = {}

    # ---- phase 1: train 3 steps on mesh A = (data=4, model=2), checkpoint ----
    mesh_a = make_mesh((4, 2), ("data", "model"))
    rules_a = ShardingRules(cfg, mesh_a)
    step_a = make_train_step(model, opt, rules=rules_a)
    state = init_sharded_state(params, opt, rules_a)
    for _ in range(3):
        state, m = step_a(state, batch)
    losses[3] = float(m["loss"])
    say(f"[mesh A 4x2] step 3 loss={losses[3]:.4f}")
    tmp = [tempfile.mkdtemp() if rank == 0 else None]
    dist.broadcast_object_list(tmp)
    ck = ForkedCheckpointer(ChunkStore(tmp[0]), chunk_bytes=1 << 18, host=rank,
                            external_commit=True)
    r = ck.save_async(3, owned_view({"device": state}, rank))
    commit_ranks(ck, [r])
    ck.close()

    # ---- phase 2: restore onto mesh B = (data=8,) and continue ----
    mesh_b = make_mesh((8,), ("data",))
    rules_b = ShardingRules(cfg, mesh_b)
    step_b = make_train_step(model, opt, rules=rules_b)
    specs = make_train_state_specs(params, opt.init(params), rules_b)

    def sharding_for(path, shape):
        spec = specs.get(path[len("device/"):])
        return "cpu" if spec is None else ShardTarget(mesh_b, placements(mesh_b, spec), "cpu")

    restored, manifest = RestoreManager(ChunkStore(tmp[0])).restore(
        device_for=sharding_for, verify=True)
    state_b = restored["device"]
    for _ in range(2):
        state_b, m = step_b(state_b, batch)
    losses[5] = float(m["loss"])
    say(f"[mesh B 8x1] resumed from step {manifest.step}, step 5 loss={losses[5]:.4f}")
    say("elastic reshard OK: same checkpoint, different topology")
    if args.json:
        say(json.dumps({"loss": losses}))
    dist.barrier()
    if rank == 0:
        shutil.rmtree(tmp[0], ignore_errors=True)
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--init-params", default=None)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()
    if "RANK" in os.environ:
        rank_main(args)
        return 0
    from repro_torch.launch.mesh import launch

    procs = launch([sys.executable, os.path.abspath(__file__), *sys.argv[1:]], 8,
                   timeout=600)
    return max(p.returncode for p in procs)


if __name__ == "__main__":
    sys.exit(main())
