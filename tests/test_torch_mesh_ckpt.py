"""PyTorch port: checkpoints of sharded state, and the train CLI over ranks.

The port's ranks are spawned gloo processes on the CPU (4 for a (2, 2)
mesh, 8 for (4, 2) and (8,)); the reference runs in subprocesses with
forced host devices, as ``tests/checkpoint/test_elastic.py`` runs it.

- Each rank persists only the blocks it owns: a replicated leaf is
  written once, and the merged manifest's leaf records (shapes, dtypes,
  shard ranges, chunk digests) equal the reference's for the same state
  on the same mesh.
- Restore onto another mesh is bitwise, and each rank reads only the
  chunks that hold its window's bytes.
- A store written by the reference on (4, 2) restores through the port on
  (8,) and at world size 1; the port's stores restore through the
  reference.
- The twin of ``tests/checkpoint/test_elastic.py``'s
  ``test_elastic_reshard_across_meshes``.
- The train CLI: ``--production-mesh`` at world size 1 names the 256 ranks
  it needs; on 2 gloo ranks it checkpoints and resumes onto 1 and onto 4.
- A sharded trainer's image commits as soon as every rank's persist has
  landed, without waiting for a later checkpoint or ``finish``: a rank
  killed after that restarts from it.
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro_torch.checkpoint import ChunkStore
from repro_torch.checkpoint.manifest import load_manifest
from repro_torch.checkpoint.sharded import restore_pytree
from repro_torch.launch.mesh import launch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 256
# leaf -> (spec on the (2, 2) mesh ("data", "model"), dtype)
LEAVES = {"w": (("data", "model"), "float32"), "r": ((), "float32"),
          "b": ((None, "model"), "bfloat16"), "g": ((("data", "model"), None), "float32")}
SHAPES = {"w": (64, 16), "r": (8,), "b": (16, 8), "g": (8, 6)}


def _values() -> dict:
    """The state's leaves, from a seed, as float32 numpy (b is rounded to
    bfloat16 where it is made)."""
    rng = np.random.default_rng(0)
    return {k: rng.standard_normal(SHAPES[k]).astype(np.float32) for k in LEAVES}


def _env():
    env = dict(os.environ, PYTHONPATH="src")
    env.pop("XLA_FLAGS", None)
    return env


REF_SAVE = textwrap.dedent('''
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    sys.path.insert(0, "tests")
    import test_torch_mesh_ckpt as T
    from repro.checkpoint import ChunkStore, save_pytree

    vals = T._values()
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    state = {k: jax.device_put(jnp.asarray(vals[k], jnp.dtype(dt)),
                               NamedSharding(mesh, P(*spec)))
             for k, (spec, dt) in T.LEAVES.items()}
    state["host"] = np.int64(5)
    save_pytree(state, ChunkStore(sys.argv[1]), 1, chunk_bytes=T.CHUNK)
    # the elastic test's state on (4, 2)
    mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("x", "y"))
    w = jnp.arange(64 * 16, dtype=jnp.float32).reshape(64, 16)
    save_pytree({"w": jax.device_put(w, NamedSharding(mesh, P("x", "y"))),
                 "r": jax.device_put(jnp.arange(8.0), NamedSharding(mesh, P())),
                 "host": np.int64(5)}, ChunkStore(sys.argv[2]), 1, chunk_bytes=T.CHUNK)
''')

REF_RESTORE = textwrap.dedent('''
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    sys.path.insert(0, "tests")
    import test_torch_mesh_ckpt as T
    from repro.checkpoint import ChunkStore, restore_pytree

    vals = T._values()
    mesh = Mesh(np.array(jax.devices()).reshape(8,), ("z",))
    ok = {}
    sh = {"w": NamedSharding(mesh, P(None, "z")), "r": NamedSharding(mesh, P()),
          "b": NamedSharding(mesh, P("z")), "g": NamedSharding(mesh, P("z")), "host": None}
    got, _ = restore_pytree(ChunkStore(sys.argv[1]), 1, sh, verify_digests=True)
    for k, (spec, dt) in T.LEAVES.items():
        want = np.asarray(jnp.asarray(vals[k], jnp.dtype(dt)))
        ok[k] = bool(np.array_equal(np.asarray(got[k]), want))
    ok["host"] = int(got["host"]) == 5
    got, _ = restore_pytree(ChunkStore(sys.argv[2]), 1, sh, verify_digests=True)
    ok["elastic_w"] = bool(np.array_equal(np.asarray(got["w"]), np.arange(64 * 16.0).reshape(64, 16)))
    ok["elastic_r"] = bool(np.array_equal(np.asarray(got["r"]), np.arange(8.0)))
    print(json.dumps(ok))
''')

RANKS = textwrap.dedent('''
    import os, sys, json, pickle
    import numpy as np, torch
    import torch.distributed as dist
    sys.path.insert(0, "tests")
    import test_torch_mesh_ckpt as T
    from repro_torch.checkpoint import ChunkStore
    from repro_torch.checkpoint.sharded import ShardTarget, local_window, restore_pytree
    from repro_torch.core import ForkedCheckpointer
    from repro_torch.core.trainer import commit_ranks, owned_view
    from repro_torch.launch import mesh as M
    from repro_torch.runtime.sharding import placements
    from repro_torch.runtime.steps import shard_leaf
    from repro_torch.utils.dtypes import torch_dtype

    args = json.loads(sys.argv[1])
    M.init_distributed("gloo")
    rank, world = dist.get_rank(), dist.get_world_size()
    vals = T._values()
    out = {}

    def save(state, root):
        ck = ForkedCheckpointer(ChunkStore(root), chunk_bytes=T.CHUNK, host=rank,
                                external_commit=True)
        commit_ranks(ck, [ck.save_async(1, owned_view(state, rank))])
        ck.close()

    class Reads(ChunkStore):
        """The chunks this rank read, by (shard start, chunk index)."""
        log = []
        def read_chunk(self, rec):
            Reads.log.append(rec)
            return super().read_chunk(rec)

    def restore_on(root, mesh, specs):
        Reads.log = []
        targets = {k: ShardTarget(mesh, placements(mesh, s), "cpu") for k, s in specs.items()}
        got, m = restore_pytree(Reads(root), 1, device=targets)
        return got, m, list(Reads.log)

    if world == 4:
        mesh = M.make_mesh((2, 2), ("data", "model"))
        state = {k: shard_leaf(torch.from_numpy(vals[k]).to(torch_dtype(dt)), mesh,
                                     placements(mesh, spec))
                 for k, (spec, dt) in T.LEAVES.items()}
        state["host"] = np.int64(5)
        save(state, args["port22"])
        # onto (data=4,): rows of w and g, columns of b, r replicated
        mesh4 = M.make_mesh((4,), ("data",))
        specs = {"w": ("data",), "r": (), "b": (None, "data"), "g": ("data",)}
        got, m, reads = restore_on(args["port22"], mesh4, specs)
        res = {}
        for k, (spec, dt) in T.LEAVES.items():
            a, b = local_window(T.SHAPES[k], mesh4, got[k].placements)
            want = torch.from_numpy(vals[k]).to(torch_dtype(dt))[tuple(slice(x, y) for x, y in zip(a, b))]
            res[k] = {"bitwise": bool(torch.equal(got[k].to_local(), want)),
                      "window": [a, b], "placements": str(got[k].placements)}
        out = {"restore4": res, "read_keys": [(r.file, r.file_offset) for r in reads]}
    if world == 8:
        # the elastic test's twin: save on (x=4, y=2), restore on (z=8,)
        mesh = M.make_mesh((4, 2), ("x", "y"))
        w = torch.arange(64 * 16, dtype=torch.float32).reshape(64, 16)
        state = {"w": shard_leaf(w, mesh, placements(mesh, ("x", "y"))),
                 "r": shard_leaf(torch.arange(8.0), mesh, placements(mesh, ())),
                 "host": np.int64(5)}
        save(state, args["port42"])
        mesh8 = M.make_mesh((8,), ("z",))
        res = {}
        for name in ("port42", "ref42"):
            got, m, _ = restore_on(args[name], mesh8, {"w": (None, "z"), "r": ("z",)})
            a, b = local_window((64, 16), mesh8, got["w"].placements)
            c, d = local_window((8,), mesh8, got["r"].placements)
            res[name] = {"w": bool(torch.equal(got["w"].to_local(), w[:, a[1]:b[1]])),
                         "r": bool(torch.equal(got["r"].to_local(), torch.arange(8.0)[c[0]:d[0]])),
                         "host": int(got["host"]) == 5,
                         "w_placements": str(got["w"].placements)}
        out = {"restore8": res}
    with open(os.path.join(args["out"], f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
''')


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_ckpt")
    paths = {k: str(tmp / k) for k in ("ref22", "ref42", "port22", "port42")}
    r = subprocess.run([sys.executable, "-c", REF_SAVE, paths["ref22"], paths["ref42"]],
                       capture_output=True, text=True, env=_env(), cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    ranks = {}
    for world in (4, 8):
        out = tmp / f"w{world}"
        out.mkdir()
        procs = launch([sys.executable, "-c", RANKS, json.dumps(dict(paths, out=str(out)))],
                       world, timeout=240, env=_env(), cwd=ROOT, capture=True)
        assert all(p.returncode == 0 for p in procs), [
            (p.returncode, (p.stderr or "")[-2000:]) for p in procs]
        for k in range(world):
            with open(out / f"rank{k}.pkl", "rb") as f:
                ranks[(world, k)] = pickle.load(f)
    return paths, ranks


def _records(root: str) -> dict:
    m = load_manifest(root, 1)
    return {p: (list(lv.shape), lv.dtype, sorted(
        (tuple(s.start), tuple(s.stop), tuple((c.index, c.digest, c.raw_len) for c in s.chunks))
        for s in lv.shards)) for p, lv in m.leaves.items()}


def test_manifest_equals_reference_and_replicated_leaf_written_once(stores):
    paths, _ = stores
    port, ref = _records(paths["port22"]), _records(paths["ref22"])
    assert port == ref
    assert len(port["r"][2]) == 1 and len(port["host"][2]) == 1
    assert len(port["w"][2]) == 4 and len(port["b"][2]) == 2 and len(port["g"][2]) == 4


def test_restore_onto_another_mesh_reads_only_its_window(stores):
    paths, ranks = stores
    m = load_manifest(paths["port22"], 1)
    for k in range(4):
        got = ranks[(4, k)]
        for leaf, res in got["restore4"].items():
            assert res["bitwise"], (k, leaf, res)
        # every chunk read lies within the bytes of the rank's windows (the
        # host value is read whole by every rank)
        allowed = {(c.file, c.file_offset) for s in m.leaves["host"].shards for c in s.chunks}
        for leaf, res in got["restore4"].items():
            (a, b) = res["window"]
            lv = m.leaves[leaf]
            isz = 2 if lv.dtype == "bfloat16" else 4
            for s in lv.shards:
                lo = [max(x, y) for x, y in zip(a, s.start)]
                hi = [min(x, y) for x, y in zip(b, s.stop)]
                if any(x >= y for x, y in zip(lo, hi)):
                    continue
                shp = [y - x for x, y in zip(s.start, s.stop)]
                st = [int(np.prod(shp[d + 1:])) for d in range(len(shp))]
                first = sum((x - s0) * t for x, s0, t in zip(lo, s.start, st)) * isz
                last = (sum((x - 1 - s0) * t for x, s0, t in zip(hi, s.start, st)) + 1) * isz
                off = 0
                for c in s.chunks:
                    if off < last and off + c.raw_len > first:
                        allowed.add((c.file, c.file_offset))
                    off += c.raw_len
        assert set(map(tuple, got["read_keys"])) <= allowed, k
        whole = sum(len(s.chunks) for lv in m.leaves.values() for s in lv.shards)
        assert len(set(map(tuple, got["read_keys"]))) < whole


def test_reference_store_restores_through_port(stores):
    paths, ranks = stores
    for k in range(8):
        res = ranks[(8, k)]["restore8"]["ref42"]
        assert res["w"] and res["r"] and res["host"], (k, res)
    full, _ = restore_pytree(ChunkStore(paths["ref42"]), 1, verify_digests=True)
    np.testing.assert_array_equal(full["w"], np.arange(64 * 16.0).reshape(64, 16))
    np.testing.assert_array_equal(full["r"], np.arange(8.0))
    assert int(full["host"]) == 5


def test_port_stores_restore_through_reference(stores):
    paths, _ = stores
    r = subprocess.run([sys.executable, "-c", REF_RESTORE, paths["port22"], paths["port42"]],
                       capture_output=True, text=True, env=_env(), cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    ok = json.loads(r.stdout.strip().splitlines()[-1])
    assert all(ok.values()), ok


def test_elastic_reshard_across_meshes(stores):
    """The twin of the reference's: (4, 2) -> (8,) with another layout,
    digests verified, and a host-only restore."""
    paths, ranks = stores
    for k in range(8):
        res = ranks[(8, k)]["restore8"]["port42"]
        assert res["w"] and res["r"] and res["host"], (k, res)
        assert res["w_placements"] == "(Shard(dim=1),)"
    full, _ = restore_pytree(ChunkStore(paths["port42"]), 1, verify_digests=True)
    np.testing.assert_array_equal(full["w"], np.arange(64 * 16, dtype=np.float32).reshape(64, 16))
    assert int(full["host"]) == 5


# -- the train CLI over ranks -----------------------------------------------------------

def test_production_mesh_names_its_world_size():
    from repro_torch.launch import train

    with pytest.raises(ValueError, match="256"):
        train.train(["--arch", "qwen2-0.5b", "--smoke", "--production-mesh",
                     "--device", "cpu", "--steps", "1"])


def _cli(nproc: int, steps: int, root: str) -> list[str]:
    argv = [sys.executable, "-W", "ignore", "-m", "repro_torch.launch.train", "--arch",
            "qwen2-0.5b", "--smoke", "--steps", str(steps), "--batch", "4", "--seq", "32",
            "--ckpt-every", "2", "--device", "cpu", "--log-every", "1", "--ckpt-dir", root]
    if nproc > 1:
        argv += ["--dist-backend", "gloo"]
    procs = launch(argv, nproc, timeout=180, env=_env(), cwd=ROOT, capture=True)
    assert all(p.returncode == 0 for p in procs), [(p.returncode, p.stderr[-2000:])
                                                    for p in procs]
    return [ln for ln in procs[0].stdout.splitlines() if ln.startswith("[train] step=")]


def test_cli_checkpoints_on_2_ranks_and_resumes_on_1_and_4(tmp_path):
    import shutil

    alone = _cli(1, 6, str(tmp_path / "one"))
    two = str(tmp_path / "two")
    first = _cli(2, 4, two)
    assert first == alone[:4]
    shutil.copytree(two, str(tmp_path / "four"))
    assert _cli(1, 6, two) == alone[4:]
    assert _cli(4, 6, str(tmp_path / "four")) == alone[4:]


COMMIT_RANKS = textwrap.dedent('''
    import json, sys, time
    import numpy as np, torch
    import torch.distributed as dist
    from repro_torch.checkpoint.manifest import is_committed
    from repro_torch.core.trainer import CheckpointedTrainer
    from repro_torch.launch import mesh as M
    from repro_torch.runtime.sharding import placements
    from repro_torch.runtime.steps import shard_leaf

    args = json.loads(sys.argv[1])
    M.init_distributed("gloo")
    rank = dist.get_rank()
    mesh = M.make_mesh((2,), ("data",))
    w = torch.arange(64 * 16, dtype=torch.float32).reshape(64, 16)
    state = {"device": {"w": shard_leaf(w, mesh, placements(mesh, ("data",)))},
             "host": {"step": np.int64(2)}}
    trainer = CheckpointedTrainer(lambda s, b: (s, {}), store_root=args["root"], mesh=mesh,
                                  device="cpu")
    r = trainer.checkpoint_now(2, state)
    r.done.wait()
    t0 = time.perf_counter()
    # the COMMIT file lands before the committer thread records the step
    while not (is_committed(args["root"], 2) and 2 in trainer.committer.committed) \
            and time.perf_counter() - t0 < 30:
        time.sleep(0.01)
    seen = {"committed": is_committed(args["root"], 2), "wait_s": time.perf_counter() - t0,
            "by_committer": list(trainer.committer.committed)}
    dist.barrier()
    trainer.finish()
    with open(args["root"] + f"-rank{rank}.json", "w") as f:
        json.dump(seen, f)
''')


def test_sharded_image_commits_when_its_persists_land(tmp_path):
    root = str(tmp_path / "ck")
    procs = launch([sys.executable, "-c", COMMIT_RANKS, json.dumps({"root": root})], 2,
                   timeout=120, env=_env(), cwd=ROOT, capture=True)
    assert all(p.returncode == 0 for p in procs), [(p.returncode, (p.stderr or "")[-2000:])
                                                    for p in procs]
    for rank in range(2):
        with open(f"{root}-rank{rank}.json") as f:
            seen = json.load(f)
        assert seen["committed"] and seen["by_committer"] == [2], seen
    got, _ = restore_pytree(ChunkStore(root), 2)
    np.testing.assert_array_equal(np.asarray(got["device"]["w"]),
                                  np.arange(64 * 16, dtype=np.float32).reshape(64, 16))
