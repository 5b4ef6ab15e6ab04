"""PyTorch port: DTensor placements, the sharded train step and the
expert-parallel MoE on gloo ranks on the CPU, held to the port at world
size 1 and to the reference under the same mesh.

The reference runs in one subprocess with 4 forced host devices (as
``tests/checkpoint/test_elastic.py`` runs it); the port in groups of
spawned gloo ranks (``launch.mesh.launch``), each group under its own
time limit. Inputs come from seeds with numpy; the port starts from the
reference's initial parameters, carried across by ``models/convert.py``.

- Placements: on a 4-rank (2, 2) mesh each rank's block of a tensor laid
  out by the port's placements equals the reference's ``addressable_shards``
  block for the same spec, axis groups included.
- The sharded step, f32, 3 steps of warmup_cosine(3e-4, 10, 100), batch
  8 x 16: a small dense GQA config (granite-8b's smoke config with 2 kv
  heads of 4, so that each rank of a 2-way ``model`` axis runs 2 q heads
  over 1 kv head; it has no qkv bias: a bias of k has an exact zero gradient, softmax being
  shift-invariant, and Adam turns its rounding noise into whole steps) and
  moonshot's smoke config (2 microbatches) on (2, 2), (4,) and (1, 2);
  arctic's (adafactor, dense residual) and granite's with q8adam on
  (2, 2). Losses within 1e-5 relative; every parameter within 1e-5 of its
  leaf's largest magnitude (plus 1e-8 absolute: the zero-initialised norm
  weights' largest magnitude is the Adam steps' own size; q8adam 1e-4 and
  1e-6 absolute, its int8 moment codes moving a whole step where a
  rounding tie falls the other way), against world size 1 and against the reference. (The smoke MoE's capacity factor 4 drops no slot, so the
  expert-parallel formulation gives the single-device one's result.)
- On (2, 2) the step gathers the stacked layer weights one layer at a
  time, kept split over ``model`` where the model runs them split (the
  dense MLP's hidden units, the attention heads, the MoE's experts).
- The expert-parallel MoE: ``moe_apply`` under (2, 2) and (1, 2) on
  moonshot's smoke config at capacity factor 1 (so that slots drop)
  takes ``_moe_expert_parallel`` on both sides: each rank's
  kept-slot mask equals the reference's rule evaluated on that rank's
  tokens exactly; the output, the aux and the gradients of
  ``sum(out * cot) + aux`` within 1e-5 (abs and rel, f32 with two
  frameworks' sum orders).
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import launch
from repro_torch.models import build
from repro_torch.optim import get_optimizer, warmup_cosine
from repro_torch.runtime.steps import make_train_step
from repro_torch.utils.tree import flatten_with_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, STEPS, SCHED = 8, 16, 3, (3e-4, 10, 100)
# name -> (arch, optimizer, microbatches, meshes)
CASES = {
    "dense": ("granite-8b", "adamw", 1, [(2, 2), (4,), (1, 2)]),
    "moe": ("moonshot-v1-16b-a3b", "adamw", 2, [(2, 2), (4,), (1, 2)]),
    "adafactor": ("arctic-480b", "adafactor", 1, [(2, 2)]),
    "q8adam": ("granite-8b", "q8adam", 1, [(2, 2)]),
}
SPECS = [("data", "model"), (("data", "model"), None), (None, ("data", "model")),
         ("model", "data"), (None, None), ("model",)]
EP_MESHES = [(2, 2), (1, 2)]
TOL = 1e-5
# the zero-initialised norm weights' largest magnitude is the Adam steps'
# own size (9e-5 after these 3): f32 rounding there is ~1e-9 absolute
NORM_ATOL = 1e-8
# q8adam's int8 moments move a whole code step where a rounding tie of the
# quantiser falls the other way under another sum order: 1e-4 of a leaf's
# largest magnitude, 1e-6 absolute (1% of the 3 steps' size) for the norms
Q8_TOL, Q8_ATOL = 1e-4, 1e-6


def _axes(shape):
    return ("data", "model") if len(shape) == 2 else ("data",)


def _batches(cfg, seed):
    rng = np.random.default_rng(seed)
    return [{"inputs": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
            for _ in range(STEPS)]


def _f32(cfg):
    return cfg.with_overrides(param_dtype="float32", compute_dtype="float32")


def _case_cfg(get_config, name):
    """The case's smoke config in f32; the dense cases with 2 kv heads of
    4 (the smoke config has as many as q heads), so that the dense case
    is GQA."""
    cfg = _f32(get_config(CASES[name][0], smoke=True))
    return cfg.with_overrides(num_kv_heads=2) if cfg.family == "dense" else cfg


REF_SCRIPT = textwrap.dedent('''
    import os, sys, json, pickle
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    sys.path.insert(0, "tests")
    import test_torch_mesh_step as T
    from repro.configs import get_config
    from repro.launch.mesh import make_mesh, use_mesh
    from repro.models import build
    from repro.models.moe import moe_apply
    from repro.optim import get_optimizer, warmup_cosine
    from repro.runtime.sharding import ShardingRules
    from repro.runtime.steps import make_train_step
    from repro.utils.tree import flatten_with_paths

    out = {"placements": {}, "steps": {}, "init": {}, "ep": {}}
    mesh = make_mesh((2, 2), ("data", "model"))
    x = np.arange(8 * 12, dtype=np.float32).reshape(8, 12)
    coord = {d: (i, j) for i, row in enumerate(mesh.devices) for j, d in enumerate(row)}
    for k, spec in enumerate(T.SPECS):
        arr = jax.device_put(x, NamedSharding(mesh, P(*spec)))
        out["placements"][k] = {coord[s.device]: np.asarray(s.data)
                                for s in arr.addressable_shards}
    for name, (arch, opt_name, mb, meshes) in T.CASES.items():
        cfg = T._case_cfg(get_config, name)
        model = build(cfg)
        params = model.init(jax.random.key(0))
        out["init"][name] = {p: np.asarray(v) for p, v in flatten_with_paths(params)[0].items()}
        for shape in meshes:
            m = make_mesh(shape, T._axes(shape))
            opt = get_optimizer(opt_name, warmup_cosine(*T.SCHED))
            with use_mesh(m):
                step, sh, _ = make_train_step(model, ShardingRules(cfg=cfg, mesh=m), opt,
                                              microbatches=mb, donate=False)
                state = jax.device_put({"params": params, "opt": opt.init(params),
                                        "step": jnp.zeros((), jnp.int32)}, sh)
                losses, norms = [], []
                for b in T._batches(cfg, 1):
                    state, met = step(state, jax.tree.map(jnp.asarray, b))
                    losses.append(float(met["loss"]))
                    norms.append(float(met["grad_norm"]))
            out["steps"][(name, shape)] = {
                "loss": losses, "grad_norm": norms,
                "params": {p: np.asarray(v) for p, v
                           in flatten_with_paths(state["params"])[0].items()}}
    # the expert-parallel MoE, capacity factor 1 (slots drop)
    cfg = T._f32(get_config("moonshot-v1-16b-a3b", smoke=True)).with_overrides(
        moe_capacity_factor=1.0)
    p = jax.tree.map(lambda a: a[0], build(cfg).init(jax.random.key(1))["blocks"]["moe"])
    rng = np.random.default_rng(2)
    xm = rng.standard_normal((4, 32, cfg.d_model)).astype(np.float32)
    cot = rng.standard_normal(xm.shape).astype(np.float32)
    out["ep_inputs"] = {"p": {k: np.asarray(v) for k, v in flatten_with_paths(p)[0].items()},
                        "x": xm, "cot": cot}
    E, K = cfg.moe_experts, cfg.moe_top_k
    for shape in T.EP_MESHES:
        m = make_mesh(shape, ("data", "model"))
        with use_mesh(m):
            def f(p, x):
                y, aux = moe_apply(cfg, p, x)
                return jnp.sum(y * cot) + aux, (y, aux)
            (_, (y, aux)), g = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
                p, jnp.asarray(xm))
        # the reference's rule on each rank's tokens (tokens over data, then model)
        n = shape[0] * shape[1]
        xt = xm.reshape(-1, cfg.d_model)
        T_loc = xt.shape[0] // n
        C = max(1, int(np.ceil(T_loc * K / E * cfg.moe_capacity_factor)))
        keep = {}
        for i in range(shape[0]):
            for j in range(shape[1]):
                xl = jnp.asarray(xt[(i * shape[1] + j) * T_loc:(i * shape[1] + j + 1) * T_loc])
                probs = jax.nn.softmax(xl @ p["router"], axis=-1)
                _, ids = jax.lax.top_k(probs, K)
                ids = ids.reshape(-1)
                oh = jax.nn.one_hot(ids, E, dtype=jnp.int32)
                pos = (jnp.cumsum(oh, axis=0) - oh)[jnp.arange(ids.shape[0]), ids]
                keep[(i, j)] = np.asarray(pos < C)
        out["ep"][shape] = {"y": np.asarray(y), "aux": float(aux), "keep": keep,
                            "gp": {k: np.asarray(v) for k, v in flatten_with_paths(g[0])[0].items()},
                            "gx": np.asarray(g[1])}
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
''')

RANK_SCRIPT = textwrap.dedent('''
    import os, sys, json, pickle
    import torch, numpy as np
    import torch.distributed as dist
    from torch.distributed.tensor import Partial, Replicate, Shard
    sys.path.insert(0, "tests")
    import test_torch_mesh_step as T
    from repro_torch.checkpoint.sharded import local_window
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as M
    from repro_torch.models import build, moe
    from repro_torch.optim import get_optimizer, warmup_cosine
    from repro_torch.runtime.sharding import ShardingRules, placements
    from repro_torch.runtime.steps import (shard_leaf, relayout, init_sharded_state,
                                           make_train_step)
    from repro_torch.utils.tree import flatten_with_paths, unflatten_from_paths

    args = json.loads(sys.argv[1])
    with open(args["ref"], "rb") as f:
        ref = pickle.load(f)
    M.init_distributed("gloo")
    rank, world = dist.get_rank(), dist.get_world_size()
    out = {"placements": {}, "steps": {}, "ep": {}}

    def whole(t):
        return relayout(t.to_local(), t.device_mesh, t.placements,
                             (Replicate(),) * t.device_mesh.ndim)

    if world == 4:
        mesh = M.make_mesh((2, 2), ("data", "model"))
        x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
        for k, spec in enumerate(T.SPECS):
            d = shard_leaf(x, mesh, placements(mesh, spec))
            out["placements"][k] = (tuple(mesh.get_coordinate()), d.to_local().numpy())
    # every layer weight the sharded step gathers, by (case, mesh)
    from repro_torch.models import transformer as tfm
    gathered, case = {}, [None]
    layers = tfm.gathered_layers

    def logging_layers(gather):
        def logged(path, block):
            w = gather(path, block)
            gathered.setdefault(case[0], []).append((path, tuple(w.shape)))
            return w
        return layers(logged)

    tfm.gathered_layers = logging_layers
    for name, (arch, opt_name, mb, meshes) in T.CASES.items():
        cfg = T._case_cfg(get_config, name)
        model = build(cfg)
        for shape in meshes:
            if int(np.prod(shape)) != world:
                continue
            mesh = M.make_mesh(shape, T._axes(shape))
            opt = get_optimizer(opt_name, warmup_cosine(*T.SCHED))
            rules = ShardingRules(cfg, mesh)
            params = unflatten_from_paths(
                flatten_with_paths(model.init(torch.Generator(), "meta"))[1],
                {p: torch.from_numpy(np.array(v)) for p, v in ref["init"][name].items()})
            state = init_sharded_state(params, opt, rules)
            step = make_train_step(model, opt, microbatches=mb, rules=rules)
            case[0] = (name, shape)
            losses, norms, a2a = [], [], moe.all_to_all_calls
            for b in T._batches(cfg, 1):
                state, met = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
                losses.append(float(met["loss"]))
                norms.append(float(met["grad_norm"]))
            out["steps"][(name, shape)] = {
                "loss": losses, "grad_norm": norms, "all_to_all": moe.all_to_all_calls - a2a,
                "gathered": gathered.get((name, shape), []),
                "params": {p: whole(v).numpy() for p, v
                           in flatten_with_paths(state["params"])[0].items()}}
    # the expert-parallel MoE
    cfg = T._f32(get_config("moonshot-v1-16b-a3b", smoke=True)).with_overrides(
        moe_capacity_factor=1.0)
    ins = ref["ep_inputs"]
    for shape in T.EP_MESHES:
        if int(np.prod(shape)) != world:
            continue
        mesh = M.make_mesh(shape, ("data", "model"))
        Mm, n_dp = shape[1], shape[0]
        d, m = mesh.get_coordinate()
        rows = ins["x"].shape[0] // n_dp
        x = torch.from_numpy(ins["x"][d * rows:(d + 1) * rows]).requires_grad_(True)
        cot = torch.from_numpy(ins["cot"][d * rows:(d + 1) * rows])
        p = {}
        for k, v in ins["p"].items():
            t = torch.from_numpy(v)
            if k in ("wi", "wg", "wo"):
                t = t.chunk(Mm, 0)[m].contiguous()
            p[k] = t.requires_grad_(True)
        a0 = moe.all_to_all_calls
        with M.use_mesh(mesh), moe.routing_log() as log:
            y, aux = moe.moe_apply(cfg, p, x)
            loss = (y * cot).sum() + aux / n_dp
            loss.backward()
        grads = {}
        for k, t in p.items():
            expert = k in ("wi", "wg", "wo")
            src = (Partial(), Shard(0) if expert else Replicate())
            grads[k] = relayout(t.grad, mesh, src, (Replicate(), Replicate()))
        gx = M.all_gather(x.grad, mesh, "data", 0)
        yy = M.all_gather(y.detach(), mesh, "data", 0)
        keep = [None] * world
        dist.all_gather_object(keep, ((d, m), log[0].keep.reshape(-1).numpy()))
        out["ep"][shape] = {"y": yy.numpy(), "aux": float(aux), "gp": {k: g.numpy() for k, g in grads.items()},
                            "gx": gx.numpy(), "keep": dict(keep),
                            "all_to_all": moe.all_to_all_calls - a0}
    if rank == 0:
        with open(args["out"], "wb") as f:
            pickle.dump(out, f)
    dist.barrier()
''')


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = "src"
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_step")
    ref_path = str(tmp / "ref.pkl")
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT, ref_path], capture_output=True,
                       text=True, env=_env(), cwd=ROOT, timeout=400)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    port = {"placements": {}, "steps": {}, "ep": {}}
    for world in (4, 2):
        path = str(tmp / f"port{world}.pkl")
        procs = launch([sys.executable, "-c", RANK_SCRIPT,
                        json.dumps({"ref": ref_path, "out": path})], world,
                       timeout=240, env=_env(), cwd=ROOT, capture=True)
        assert all(p.returncode == 0 for p in procs), [
            (p.returncode, (p.stderr or "")[-2000:]) for p in procs]
        with open(path, "rb") as f:
            got = pickle.load(f)
        for key in ("placements", "steps", "ep"):
            port[key].update(got[key])
    return ref, port


def test_placements_blocks_equal_reference_shards(runs):
    ref, port = runs
    gathered = {}
    # rank 0's own blocks were pickled; every rank's are checked through
    # the windows: the port distributes the same tensor on each rank
    from repro_torch.checkpoint.sharded import local_window
    from repro_torch.launch.mesh import make_abstract_mesh
    from repro_torch.runtime.sharding import placements

    x = np.arange(8 * 12, dtype=np.float32).reshape(8, 12)
    mesh = make_abstract_mesh((2, 2), ("data", "model"))
    for k, spec in enumerate(SPECS):
        coord, block = port["placements"][k]
        np.testing.assert_array_equal(block, ref["placements"][k][coord])
        pl = placements(mesh, spec)
        for c, want in ref["placements"][k].items():
            start, stop = local_window((8, 12), _AtCoord(mesh, c), pl)
            gathered[(k, c)] = x[tuple(slice(a, b) for a, b in zip(start, stop))]
            np.testing.assert_array_equal(gathered[(k, c)], want, err_msg=f"{spec} at {c}")


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_layers_gathered_one_at_a_time(runs, name):
    """On (2, 2) the stacked layer weights reach the model one layer at a
    time (FSDP inside the layer's remat), and only they: each gather is one
    layer's slice, gathered over ``data`` and kept split over ``model``
    where the model runs it split (the dense MLP's hidden units and the
    attention heads, the MoE's experts); every layer's weights are gathered
    alike, in each microbatch of each step."""
    _, port = runs
    arch, _opt, mb, _meshes = CASES[name]
    cfg = _case_cfg(get_config, name)
    gathered = port["steps"][(name, (2, 2))]["gathered"]
    by_path: dict = {}
    for path, shape in gathered:
        by_path.setdefault(path, set()).add(shape)
    stacked = {p: tuple(t.shape) for p, t in flatten_with_paths(
        build(cfg).init(torch.Generator(), "meta"))[0].items() if p.startswith("blocks/")}
    assert set(by_path) == set(stacked)
    D, Q, KV, F, E = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff, cfg.moe_experts
    want = {"blocks/ln1": (D,), "blocks/attn/wq": (D, Q // 2), "blocks/attn/wk": (D, KV // 2),
            "blocks/attn/wo": (Q // 2, D)}
    if name == "dense":
        want.update({"blocks/mlp/wi": (D, F // 2), "blocks/mlp/wo": (F // 2, D)})
    else:
        want.update({"blocks/moe/wi": (E // 2, D, F), "blocks/moe/wo": (E // 2, F, D)})
    for path, shape in want.items():
        assert by_path[path] == {shape}, (path, by_path[path])
    counts = {p: sum(1 for q, _ in gathered if q == p) for p in by_path}
    assert len(set(counts.values())) == 1, counts
    assert next(iter(counts.values())) % (cfg.num_layers * mb * STEPS) == 0, counts


class _AtCoord:
    """An abstract mesh seen from one coordinate (what ``local_window``
    reads of a DeviceMesh)."""

    def __init__(self, mesh, coord):
        self.shape, self.mesh_dim_names, self._coord = mesh.shape, mesh.mesh_dim_names, coord

    def get_coordinate(self):
        return list(self._coord)


def _world1(name):
    arch, opt_name, mb, _ = CASES[name]
    return _case_cfg(get_config, name), opt_name, mb


@pytest.fixture(scope="module")
def world1(runs):
    ref, _ = runs
    out = {}
    for name in CASES:
        cfg, opt_name, mb = _world1(name)
        model, opt = build(cfg), get_optimizer(opt_name, warmup_cosine(*SCHED))
        flat = {p: torch.from_numpy(np.array(v)) for p, v in ref["init"][name].items()}
        from repro_torch.utils.tree import unflatten_from_paths

        params = unflatten_from_paths(
            flatten_with_paths(model.init(torch.Generator(), "meta"))[1], flat)
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32)}
        step = make_train_step(model, opt, microbatches=mb)
        losses = []
        for b in _batches(cfg, 1):
            state, met = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
            losses.append(float(met["loss"]))
        out[name] = {"loss": losses, "params": {p: v.numpy() for p, v
                                                in flatten_with_paths(state["params"])[0].items()}}
    return out


def _hold(got: dict, want: dict, what: str, tol: float, atol: float) -> None:
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=TOL, atol=0, err_msg=what)
    assert sorted(got["params"]) == sorted(want["params"])
    for path, w in want["params"].items():
        err = np.abs(got["params"][path] - w).max()
        bound = tol * np.abs(w).max() + atol
        assert err <= bound, f"{what} {path}: {err} > {bound}"


STEP_CASES = [(name, shape) for name, (_, _, _, meshes) in CASES.items() for shape in meshes]


@pytest.mark.parametrize("name,shape", STEP_CASES, ids=[f"{n}-{'x'.join(map(str, s))}"
                                                         for n, s in STEP_CASES])
def test_sharded_step_matches_reference_and_world1(runs, world1, name, shape):
    ref, port = runs
    got = port["steps"][(name, shape)]
    tol = (Q8_TOL, Q8_ATOL) if CASES[name][1] == "q8adam" else (TOL, NORM_ATOL)
    _hold(got, ref["steps"][(name, shape)], f"{name} {shape} vs the reference", *tol)
    np.testing.assert_allclose(got["grad_norm"], ref["steps"][(name, shape)]["grad_norm"],
                               rtol=1e-4)
    _hold(got, world1[name], f"{name} {shape} vs world size 1", *tol)
    ep = get_config(CASES[name][0]).family == "moe" and len(shape) == 2
    assert (got["all_to_all"] > 0) == ep  # the expert-parallel path, where the rules take it


@pytest.mark.parametrize("shape", EP_MESHES, ids=lambda s: "x".join(map(str, s)))
def test_expert_parallel_moe_matches_reference(runs, shape):
    ref, port = runs
    got, want = port["ep"][shape], ref["ep"][shape]
    assert got["all_to_all"] == 4  # dispatch and return, forward and backward
    assert sorted(got["keep"]) == sorted(want["keep"])
    dropped = 0
    for c, k in want["keep"].items():
        np.testing.assert_array_equal(got["keep"][c], k, err_msg=str(c))
        dropped += int((~k).sum())
    assert dropped > 0  # the check sees drops
    np.testing.assert_allclose(got["y"], want["y"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["aux"], want["aux"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["gx"], want["gx"], rtol=TOL, atol=TOL)
    for k, g in want["gp"].items():
        np.testing.assert_allclose(got["gp"][k], g, rtol=TOL, atol=TOL, err_msg=k)
