"""The port's cluster against the reference's, on the CPU.

Cluster images cross packages in both directions: a port cluster's
committed image (numpy loop, 2 and 3 ranks) restores through the
reference's ``RestoreManager.restore`` and ``restore_elastic``, and a
reference cluster's through the port's. The two packages' numpy clusters
with the same seed commit MANIFESTs with equal chunk digests per leaf and
finish with equal state digests, and a 2-rank ``torch_tiny`` cluster ends
on the state of the same program run inline. Every comparison is bitwise.
Marked ``integration`` (each test spawns rank processes).
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manifest import committed_steps, load_manifest
from repro_torch.checkpoint.store import ChunkStore
from repro_torch.coord.supervisor import run_cluster
from repro_torch.coord.worker import WorkerConfig, _program_spec, state_digest
from repro_torch.core.restore import RestoreManager
from repro_torch.proxy.programs import make_program
from repro_torch.utils.tree import flatten_with_paths, leaf_bytes

pytestmark = pytest.mark.integration


def _ref_cluster(root, n_hosts, **kw):
    from repro.coord.supervisor import run_cluster as ref_run

    return ref_run(root=root, n_hosts=n_hosts, backend="thread", loop="numpy",
                   deadline_s=300.0, **kw)


def _port_cluster(root, n_hosts, **kw):
    return run_cluster(root=root, n_hosts=n_hosts, backend="thread", loop="numpy",
                       device="cpu", deadline_s=300.0, **kw)


def _leaf_bytes(tree) -> dict[str, bytes]:
    return {p: bytes(leaf_bytes(np.asarray(v) if not isinstance(v, torch.Tensor) else v))
            for p, v in flatten_with_paths(tree)[0].items()}


def _inline(spec: dict, steps: int):
    """The step program run in this process: {"device", "host"} state."""
    prog = make_program(spec)
    d = prog.on_restore(prog.init_state())
    for s in range(1, steps + 1):
        d, _ = prog.step(d, s)
    return {"device": d, "host": {"step": np.int64(steps)}}


def _spec(n_hosts: int, loop: str = "numpy", **kw) -> dict:
    return _program_spec(WorkerConfig(
        host=0, n_hosts=n_hosts, coord_host="", coord_port=0, root="",
        total_steps=0, ckpt_every=0, loop=loop, device="cpu", **kw))


def _windows_equal(a, b):
    fa, _ = flatten_with_paths(a)
    fb, _ = flatten_with_paths(b)
    assert fa.keys() == fb.keys()
    for p in fa:
        assert (fa[p].data is None) == (fb[p].data is None), p
        if fa[p].data is not None:
            assert bytes(leaf_bytes(np.asarray(fa[p].data))) == \
                bytes(leaf_bytes(fb[p].data)), p
            assert (fa[p].start, fa[p].stop) == (fb[p].start, fb[p].stop), p


@pytest.mark.parametrize("n_hosts", [2, 3])
def test_port_cluster_image_restores_through_the_reference(tmp_path, n_hosts):
    from repro.checkpoint.store import ChunkStore as RefStore
    from repro.core.restore import RestoreManager as RefRestore

    root = str(tmp_path / "port")
    report = _port_cluster(root, n_hosts, total_steps=4, ckpt_every=2,
                           kill_host=n_hosts - 1, kill_at_step=4)
    assert report.lockstep() and committed_steps(root) == [2, 4]
    want = _inline(_spec(n_hosts), 4)
    assert set(report.final_digests.values()) == {state_digest(want["device"])}
    ref = RefRestore(RefStore(root))
    full, m = ref.restore(step=4)
    assert m.step == 4 and _leaf_bytes(full) == _leaf_bytes(want)
    mine = RestoreManager(ChunkStore(root))
    for n_new in (1, n_hosts + 1):
        full, _ = ref.restore_elastic(n_hosts=n_new)
        assert _leaf_bytes(full) == _leaf_bytes(want)
        for h in range(n_new):
            _windows_equal(ref.restore_elastic(n_hosts=n_new, host=h, step=4)[0],
                           mine.restore_elastic(n_hosts=n_new, host=h, step=4)[0])


def test_reference_cluster_image_restores_through_the_port(tmp_path):
    root = str(tmp_path / "ref")
    report = _ref_cluster(root, 3, total_steps=4, ckpt_every=2)
    assert report.lockstep() and report.latest_committed == 4
    want = _inline(_spec(3), 4)
    rm = RestoreManager(ChunkStore(root))
    full, _ = rm.restore(step=4)
    assert _leaf_bytes(full) == _leaf_bytes(want)
    full, _ = rm.restore_elastic(n_hosts=2)
    assert _leaf_bytes(full) == _leaf_bytes(want)
    got = {}
    for h in range(2):
        for p, v in flatten_with_paths(rm.restore_elastic(n_hosts=2, host=h)[0])[0].items():
            if v.data is not None:
                got.setdefault(p, []).append((v.start, bytes(leaf_bytes(v.data))))
    assert {p: b"".join(b for _, b in sorted(parts)) for p, parts in got.items()} \
        == _leaf_bytes(want)


def test_both_packages_commit_the_same_images(tmp_path):
    from repro.checkpoint.manifest import load_manifest as ref_load

    kw = dict(total_steps=6, ckpt_every=2, kill_host=1, kill_at_step=4)
    port = _port_cluster(str(tmp_path / "port"), 2, **kw)
    ref = _ref_cluster(str(tmp_path / "ref"), 2, **kw)
    assert [r.step for r in port.committed] == [r.step for r in ref.committed] == [2, 4, 6]
    assert [(r.step, r.status) for r in port.rounds] == \
        [(r.step, r.status) for r in ref.rounds]
    assert port.final_digests == ref.final_digests
    for step in (2, 4, 6):
        a = load_manifest(str(tmp_path / "port"), step)
        b = ref_load(str(tmp_path / "ref"), step)
        assert a.leaves.keys() == b.leaves.keys()
        for path in a.leaves:
            la, lb = a.leaves[path], b.leaves[path]
            assert (la.shape, la.dtype) == (lb.shape, lb.dtype)
            assert [(s.start, s.stop, [c.digest for c in s.chunks]) for s in la.shards] \
                == [(s.start, s.stop, [c.digest for c in s.chunks]) for s in lb.shards]


def test_torch_cluster_equals_the_inline_program(tmp_path):
    """Two ranks train torch_tiny with a killed rank respawned from step
    2; both finish on the inline run's bits, the committed step-4 image
    is those bits, and each boundary's provenance table is the port's
    digest of the replica."""
    from repro_torch.kernels.ops import tree_chunk_digests

    root = str(tmp_path / "torch")
    report = run_cluster(root=root, n_hosts=2, total_steps=4, ckpt_every=2,
                         backend="fork", loop="torch", device="cpu",
                         chunk_bytes=1 << 12, deadline_s=300.0,
                         kill_host=1, kill_at_step=4)
    assert report.lockstep() and report.restarts[1] == 1
    assert [r.step for r in report.committed] == [2, 4]
    spec = _spec(2, "torch")
    want = _inline(spec, 4)
    assert set(report.final_digests.values()) == {state_digest(want["device"])}
    full, _ = RestoreManager(ChunkStore(root)).restore(step=4)
    assert _leaf_bytes(full) == _leaf_bytes(want)
    step2 = _inline(spec, 2)["device"]
    acks2, acks4 = report.acks
    for h in (0, 1):
        assert acks2[h]["chunk_digests"] == tree_chunk_digests(step2, 1 << 12)
        assert acks4[h]["chunk_digests"] == tree_chunk_digests(want["device"], 1 << 12)
