"""Elastic reshard and the sharded tree I/O of the port, against the reference.

The reference's ``tests/checkpoint/test_elastic_reshard.py`` on
``repro_torch`` (numpy states and tensor states, bfloat16 included), then
the two packages on the same inputs: ``host_slice_plan`` over drawn shapes
and rank counts, and committed N-rank images written by one package and
re-sliced onto M ranks by the other. Every comparison is bitwise.
"""
import os

import numpy as np
import pytest
import torch

from repro.utils.testing import given, settings, st
from repro_torch.checkpoint.manifest import commit_manifest, merge_hostmetas
from repro_torch.checkpoint.sharded import (
    host_slice_plan,
    restore_pytree,
    restore_pytree_elastic,
    save_pytree,
)
from repro_torch.checkpoint.store import ChunkStore
from repro_torch.coord.worker import shard_tree_for_host, state_digest
from repro_torch.core.forked import ForkedCheckpointer
from repro_torch.core.policy import CheckpointPolicy
from repro_torch.core.restore import RestoreManager
from repro_torch.core.shadow import HostShardView
from repro_torch.utils.dtypes import byte_view
from repro_torch.utils.tree import flatten_with_paths, leaf_bytes


def _state(seed=0, rows=12, cols=16):
    rng = np.random.default_rng(seed)
    return {
        "device": {
            "w": rng.standard_normal((rows, cols)).astype(np.float32),
            "b": rng.standard_normal((cols,)).astype(np.float32),
            "scale": np.float32(1.25),
        },
        "host": {"step": np.int64(7)},
    }


def _tensor_state(seed=0, rows=13, cols=16):
    """The same layout as tensors: f32, a bf16 matrix and a 0-d int."""
    s = _state(seed, rows, cols)
    d = s["device"]
    return {
        "device": {
            "w": torch.from_numpy(d["w"]),
            "e": torch.from_numpy(d["w"] * 3).to(torch.bfloat16),
            "b": torch.from_numpy(d["b"]),
            "step": torch.tensor(7, dtype=torch.int32),
        },
        "host": {"step": np.int64(7)},
    }


def _commit_over_hosts(root, state, step, n_hosts, *, cks=None,
                       incremental=False, backend="thread"):
    """Persist + merge + commit one image across n_hosts."""
    cks = cks if cks is not None else {}
    for h in range(n_hosts):
        ck = cks.get(h)
        if ck is None:
            ck = cks[h] = ForkedCheckpointer(
                ChunkStore(root), chunk_bytes=1 << 7, host=h,
                backend=backend, external_commit=True, incremental=incremental,
            )
        ck.save_async(step, shard_tree_for_host(state, h, n_hosts)).wait(60)
    commit_manifest(root, merge_hostmetas(root, step))
    for ck in cks.values():
        ck.commit_confirmed(step)
    return cks


def _bytes(x) -> bytes:
    return bytes(leaf_bytes(x))


def _reassemble(shard_trees):
    """Combine per-rank HostShardView trees back into global byte arrays
    (tensor windows and numpy windows alike), keyed by path."""
    out = {}
    for tree in shard_trees:
        flat, _ = flatten_with_paths(tree)
        for path, view in flat.items():
            assert isinstance(view, HostShardView), path
            if view.data is None:
                out.setdefault(path, None)
                continue
            data = view.data
            arr = (byte_view(data).numpy() if isinstance(data, torch.Tensor)
                   else np.ascontiguousarray(data).reshape(-1).view(np.uint8))
            rows = view.shape[0] if len(view.shape) else 1
            if out.get(path) is None:
                out[path] = np.zeros(
                    (rows, -(-_nbytes(view) // max(rows, 1))), np.uint8)
            if len(view.shape):
                out[path][view.start[0]:view.stop[0]] = arr.reshape(
                    view.stop[0] - view.start[0], -1)
            else:
                out[path][0] = arr
    return {p: a.reshape(-1).tobytes() for p, a in out.items()}


def _nbytes(view) -> int:
    itemsize = (torch.empty(0, dtype=view.dtype).element_size()
                if isinstance(view.dtype, torch.dtype) else view.dtype.itemsize)
    return int(np.prod(view.shape, dtype=np.int64)) * itemsize


def _assert_covers(merged, state):
    flat, _ = flatten_with_paths(state)
    assert set(merged) == set(flat)
    for path, leaf in flat.items():
        assert merged[path] == _bytes(leaf), path


# -- the ownership rule itself ---------------------------------------------------

def test_host_slice_plan_partitions_exactly():
    """For ANY (n0, n_hosts): dim-0 windows tile [0, n0) without gaps or
    overlaps, and every small leaf has exactly one owner."""
    for n0 in (1, 5, 12, 13):
        for n in (1, 2, 3, 5, 8):
            if n0 >= n:
                edges = []
                for h in range(n):
                    plan = host_slice_plan("p", (n0, 4), h, n)
                    assert plan is not None
                    edges.append((plan[0][0], plan[1][0]))
                assert edges[0][0] == 0 and edges[-1][1] == n0
                for (a, b), (c, d) in zip(edges, edges[1:]):
                    assert b == c  # contiguous, no gap/overlap
            owners = [
                h for h in range(n)
                if host_slice_plan("tiny", (), h, n) is not None
            ]
            assert len(owners) == 1


@settings(max_examples=200, deadline=None)
@given(
    path=st.text(min_size=0, max_size=24),
    shape=st.lists(st.integers(0, 40), min_size=0, max_size=4),
    n_hosts=st.integers(1, 9),
)
def test_host_slice_plan_equals_the_reference(path, shape, n_hosts):
    from repro.checkpoint.sharded import host_slice_plan as ref_plan

    for h in range(n_hosts):
        assert host_slice_plan(path, tuple(shape), h, n_hosts) == \
            ref_plan(path, tuple(shape), h, n_hosts)


@pytest.mark.parametrize("make", [_state, _tensor_state], ids=["numpy", "tensor"])
def test_host_slice_plan_matches_live_sharding(make):
    """restore_elastic's plan == what shard_tree_for_host persists; a
    tensor's window is a view of the tensor (no copy)."""
    state = make()
    flat, _ = flatten_with_paths(state)
    for n in (1, 2, 3, 5):
        for h in range(n):
            live, _ = flatten_with_paths(shard_tree_for_host(state, h, n))
            for path, view in live.items():
                plan = host_slice_plan(path, tuple(np.shape(flat[path])), h, n)
                if view.data is None:
                    assert plan is None, (path, h, n)
                    continue
                assert plan == (view.start, view.stop), (path, h, n)
                if isinstance(flat[path], torch.Tensor):
                    assert view.data.data_ptr() == (
                        flat[path].data_ptr()
                        + view.start[0] * flat[path].stride(0)
                        * flat[path].element_size() if view.start else
                        flat[path].data_ptr())


# -- reshard restores -------------------------------------------------------------

@pytest.mark.parametrize("make", [_state, _tensor_state], ids=["numpy", "tensor"])
@pytest.mark.parametrize("n_old,n_new", [
    (4, 3),   # neither divides the other
    (3, 5),   # grow, non-divisible
    (4, 6),   # a 4-rank image onto 6
    (4, 1),   # single-rank collapse
    (5, 2),
])
def test_reshard_bit_identical(tmp_path, n_old, n_new, make):
    root = str(tmp_path / "ck")
    state = make(rows=13) if make is _state else make()
    cks = _commit_over_hosts(root, state, 5, n_old)
    rm = RestoreManager(ChunkStore(root))

    # full-state restore is rank-count independent
    full, m = rm.restore_elastic(n_hosts=n_new)
    assert m.step == 5
    assert state_digest(full) == state_digest(state)

    # per-rank slices under the NEW topology cover the image exactly
    trees = [rm.restore_elastic(n_hosts=n_new, host=h)[0] for h in range(n_new)]
    _assert_covers(_reassemble(trees), state)

    # and the slices are exactly what n_new live writers would persist —
    # a restarted cluster can immediately checkpoint under the new count
    for h in range(n_new):
        live, _ = flatten_with_paths(shard_tree_for_host(state, h, n_new))
        got, _ = flatten_with_paths(trees[h])
        for path in live:
            if live[path].data is None:
                assert got[path].data is None
            else:
                assert _bytes(got[path].data) == _bytes(live[path].data)
                assert got[path].start == live[path].start
                assert got[path].stop == live[path].stop
                assert got[path].dtype_name == live[path].dtype_name
    for ck in cks.values():
        ck.close()


def test_reshard_after_gc_of_delta_chain(tmp_path):
    """An incremental (delta) manifest re-slices correctly after GC has
    run: chunk references chase into the base step's files, which the
    reference closure keeps alive."""
    root = str(tmp_path / "ck")
    store = ChunkStore(root)
    state = _state(rows=12)
    cks = _commit_over_hosts(root, state, 1, 2, incremental=True)

    state2 = {
        "device": dict(state["device"]), "host": {"step": np.int64(8)},
    }
    w2 = state2["device"]["w"].copy()
    w2[3] += 1.0
    state2["device"]["w"] = w2
    _commit_over_hosts(root, state2, 2, 2, cks=cks, incremental=True)
    # the delta really referenced step 1's payloads
    assert sum(ck._prev_manifest.meta["chunks_reused"] for ck in cks.values()) > 0

    CheckpointPolicy(keep_last=1).run_gc(store)
    rm = RestoreManager(store)
    assert rm.available_steps()[-1] == 2

    trees = [rm.restore_elastic(n_hosts=3, host=h, step=2)[0] for h in range(3)]
    _assert_covers(_reassemble(trees), state2)
    for ck in cks.values():
        ck.close()


def test_restore_elastic_unknown_step_raises(tmp_path):
    root = str(tmp_path / "ck")
    os.makedirs(root)
    with pytest.raises(FileNotFoundError):
        RestoreManager(ChunkStore(root)).restore_elastic(n_hosts=2, host=0)


def test_restore_elastic_places_windows_on_the_device(tmp_path):
    root = str(tmp_path / "ck")
    state = _tensor_state()
    _commit_over_hosts(root, state, 5, 2)
    rm = RestoreManager(ChunkStore(root))
    tree, _ = rm.restore_elastic(n_hosts=3, host=1, device="cpu")
    flat, _ = flatten_with_paths(tree)
    owned = [v for v in flat.values() if v.data is not None]
    assert owned and all(isinstance(v.data, torch.Tensor) for v in owned)
    assert flat["device/e"].dtype == torch.bfloat16


# -- across packages ----------------------------------------------------------------

def _ref_commit_over_hosts(root, state, step, n_hosts):
    from repro.checkpoint.manifest import commit_manifest as ref_commit
    from repro.checkpoint.manifest import merge_hostmetas as ref_merge
    from repro.checkpoint.store import ChunkStore as RefStore
    from repro.coord.worker import shard_tree_for_host as ref_shard
    from repro.core.forked import ForkedCheckpointer as RefCk

    for h in range(n_hosts):
        ck = RefCk(RefStore(root), chunk_bytes=1 << 7, host=h, backend="thread",
                   external_commit=True, digest_on_device=False)
        ck.save_async(step, ref_shard(state, h, n_hosts)).wait(60)
        ck.close()
    ref_commit(root, ref_merge(root, step))


@pytest.mark.parametrize("n_old,n_new", [(2, 3), (3, 2), (4, 1)])
def test_port_images_reslice_through_the_reference(tmp_path, n_old, n_new):
    from repro.checkpoint.store import ChunkStore as RefStore
    from repro.core.restore import RestoreManager as RefRestore

    root = str(tmp_path / "ck")
    state = _state(rows=13)
    for ck in _commit_over_hosts(root, state, 5, n_old).values():
        ck.close()
    rm = RefRestore(RefStore(root))
    full, _ = rm.restore(step=5)
    _assert_covers({p: _bytes(v) for p, v in flatten_with_paths(full)[0].items()}, state)
    mine = RestoreManager(ChunkStore(root))
    for h in range(n_new):
        ref_tree, _ = rm.restore_elastic(n_hosts=n_new, host=h)
        port_tree, _ = mine.restore_elastic(n_hosts=n_new, host=h)
        rf, _ = flatten_with_paths(ref_tree)
        pf, _ = flatten_with_paths(port_tree)
        assert rf.keys() == pf.keys()
        for p in rf:
            assert (rf[p].data is None) == (pf[p].data is None), p
            if rf[p].data is not None:
                assert _bytes(rf[p].data) == _bytes(pf[p].data), p
                assert (rf[p].start, rf[p].stop) == (pf[p].start, pf[p].stop)


@pytest.mark.parametrize("n_old,n_new", [(2, 3), (3, 5)])
def test_reference_images_reslice_through_the_port(tmp_path, n_old, n_new):
    root = str(tmp_path / "ck")
    state = _state(rows=13)
    _ref_commit_over_hosts(root, state, 5, n_old)
    rm = RestoreManager(ChunkStore(root))
    full, _ = rm.restore(step=5)
    _assert_covers({p: _bytes(v) for p, v in flatten_with_paths(full)[0].items()}, state)
    trees = [rm.restore_elastic(n_hosts=n_new, host=h)[0] for h in range(n_new)]
    _assert_covers(_reassemble(trees), state)


# -- save_pytree / restore_pytree on tensors ------------------------------------------

def test_save_pytree_tensors_restore_in_both_packages(tmp_path):
    """The port's save_pytree writes a tensor tree (bf16 included) whose
    image the reference restores bit for bit, and restore_pytree /
    restore_pytree_elastic place it where asked."""
    from repro.checkpoint.sharded import restore_pytree as ref_restore
    from repro.checkpoint.store import ChunkStore as RefStore

    root = str(tmp_path / "ck")
    state = _tensor_state()
    m1 = save_pytree(state, ChunkStore(root), 1, chunk_bytes=1 << 7)
    state["device"]["w"][0, 0] += 1.0
    m2 = save_pytree(state, ChunkStore(root), 2, chunk_bytes=1 << 7,
                     prev_manifest=m1)
    assert m2.meta["chunks_reused"] > 0 and m2.meta["chunks_written"] >= 1
    want = {p: _bytes(v) for p, v in flatten_with_paths(state)[0].items()}
    ref, _ = ref_restore(RefStore(root), 2)
    assert {p: _bytes(np.asarray(v)) for p, v in flatten_with_paths(ref)[0].items()} == want
    got, _ = restore_pytree(ChunkStore(root), 2, verify_digests=True)
    assert {p: _bytes(v) for p, v in flatten_with_paths(got)[0].items()} == want
    placed, _ = restore_pytree(ChunkStore(root), 2, "cpu")
    assert all(isinstance(v, torch.Tensor) for v in flatten_with_paths(placed)[0].values())
    per_leaf, _ = restore_pytree_elastic(
        ChunkStore(root), 2, lambda p, s: "cpu" if p.startswith("device/") else None)
    assert isinstance(per_leaf["device"]["w"], torch.Tensor)
    assert isinstance(per_leaf["host"]["step"], np.ndarray)


def test_save_pytree_windows_merge_into_one_image(tmp_path):
    """Each rank's save_pytree of its windows (commit=False, written as a
    hostmeta) merges into the image the reference restores."""
    from repro.checkpoint.sharded import restore_pytree as ref_restore
    from repro.checkpoint.store import ChunkStore as RefStore
    from repro_torch.checkpoint.manifest import write_hostmeta

    root = str(tmp_path / "ck")
    state = _tensor_state()
    for h in range(3):
        m = save_pytree(shard_tree_for_host(state, h, 3), ChunkStore(root), 4,
                        chunk_bytes=1 << 7, host=h, commit=False)
        write_hostmeta(root, 4, h, m)
    commit_manifest(root, merge_hostmetas(root, 4))
    ref, _ = ref_restore(RefStore(root), 4)
    want = {p: _bytes(v) for p, v in flatten_with_paths(state)[0].items()}
    assert {p: _bytes(np.asarray(v)) for p, v in flatten_with_paths(ref)[0].items()} == want
