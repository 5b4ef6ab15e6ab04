"""External-commit mode + hostmeta merge on the port, against the reference.

The reference's ``tests/coord/test_external_commit.py`` on ``repro_torch``:
each rank persists only its HostShardView slices (either persist backend);
nothing is visible until the coordinator-side merge writes MANIFEST +
COMMIT; the merged image restores bit-identically. Then the port's own
cases: windows that are tensor views (digested through the grouped path,
patched in place by ``upload``), ``kill_pending`` on a live fork child,
and staged images equal to the reference's byte for byte. Every
comparison is bitwise.
"""
import os

import numpy as np
import pytest

from repro_torch.checkpoint.manifest import (
    committed_steps,
    hostmeta_path,
    list_hostmetas,
    load_hostmeta,
    merge_hostmetas,
    commit_manifest,
    step_dir,
)
from repro_torch.checkpoint.store import ChunkStore
from repro_torch.core.forked import ForkedCheckpointer
from repro_torch.core.restore import RestoreManager
from repro_torch.coord.worker import shard_tree_for_host, state_digest

BACKENDS = ["thread"] + (["fork"] if hasattr(os, "fork") else [])


def _state(seed=0, rows=8, cols=16):
    rng = np.random.default_rng(seed)
    return {
        "device": {
            "w": rng.standard_normal((rows, cols)).astype(np.float32),
            "b": rng.standard_normal((cols,)).astype(np.float32),
        },
        "host": {"step": np.int64(5)},
    }


def _persist_all_hosts(root, state, step, n_hosts, backend, prev_confirm=None):
    cks = []
    for h in range(n_hosts):
        ck = ForkedCheckpointer(
            ChunkStore(root), chunk_bytes=1 << 8, host=h,
            backend=backend, external_commit=True,
        )
        if prev_confirm is not None:
            ck.commit_confirmed(prev_confirm)
        shard = shard_tree_for_host(state, h, n_hosts)
        ck.save_async(step, shard).wait(60)
        cks.append(ck)
    return cks


@pytest.mark.parametrize("backend", BACKENDS)
def test_external_commit_writes_hostmeta_not_commit(tmp_path, backend):
    root = str(tmp_path / "ck")
    state = _state()
    cks = _persist_all_hosts(root, state, 5, 2, backend)
    d = step_dir(root, 5)
    # staged, not committed: hostmetas + payloads only
    assert sorted(list_hostmetas(root, 5)) == [0, 1]
    assert not os.path.exists(os.path.join(d, "COMMIT"))
    assert not os.path.exists(os.path.join(d, "MANIFEST.msgpack"))
    assert committed_steps(root) == []
    # each hostmeta holds only its host's shards, global shapes throughout
    hm0 = load_hostmeta(root, 5, 0)
    assert hm0.leaves["device/w"].shape == [8, 16]
    (s0,) = hm0.leaves["device/w"].shards
    assert (s0.start, s0.stop) == ([0, 0], [4, 16])
    for ck in cks:
        ck.close()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n_hosts", [1, 2, 3])
def test_merge_commit_restore_roundtrip(tmp_path, backend, n_hosts):
    root = str(tmp_path / "ck")
    state = _state(rows=9)  # uneven split across 3 hosts
    cks = _persist_all_hosts(root, state, 5, n_hosts, backend)
    manifest = merge_hostmetas(root, 5)
    commit_manifest(root, manifest)
    assert committed_steps(root) == [5]

    restored, m = RestoreManager(ChunkStore(root)).restore()
    assert m.step == 5
    np.testing.assert_array_equal(restored["device"]["w"], state["device"]["w"])
    np.testing.assert_array_equal(restored["device"]["b"], state["device"]["b"])
    assert int(restored["host"]["step"]) == 5
    assert state_digest(restored) == state_digest(state)
    # merged meta reports cluster-wide totals, not one host's identity
    assert "host" not in m.meta
    assert sorted(m.meta["hosts"]) == list(range(n_hosts))
    assert m.meta["chunks_written"] == sum(
        v["chunks_written"] for v in m.meta["hosts"].values()
    )
    assert m.meta["chunks_written"] > 0
    for ck in cks:
        ck.close()


def test_merge_rejects_shape_disagreement(tmp_path):
    root = str(tmp_path / "ck")
    a, b = _state(rows=8), _state(rows=12)
    ck0 = _persist_all_hosts(root, a, 1, 2, "thread")[0]
    # host 1 checkpoints a different-shaped state: merging must refuse
    ck1 = ForkedCheckpointer(
        ChunkStore(root), chunk_bytes=1 << 8, host=1,
        backend="thread", external_commit=True,
    )
    ck1.save_async(1, shard_tree_for_host(b, 1, 2)).wait(60)
    with pytest.raises(ValueError, match="disagrees"):
        merge_hostmetas(root, 1)
    ck0.close()
    ck1.close()


def test_merge_missing_hostmetas_raises(tmp_path):
    root = str(tmp_path / "ck")
    os.makedirs(root)
    with pytest.raises(FileNotFoundError):
        merge_hostmetas(root, 7)


@pytest.mark.parametrize("backend", BACKENDS)
def test_confirmed_commit_enables_delta_but_abort_does_not(tmp_path, backend):
    """Incremental deltas may only base on cluster-committed rounds."""
    root = str(tmp_path / "ck")
    state = _state()
    ck = ForkedCheckpointer(
        ChunkStore(root), chunk_bytes=1 << 8, host=0, backend=backend,
        external_commit=True, incremental=True,
    )
    shard = shard_tree_for_host(state, 0, 1)

    r1 = ck.save_async(1, shard)
    r1.wait(60)
    assert r1.chunks_reused == 0
    # round aborted: staged manifest must NOT become the delta base
    ck.commit_aborted(1)
    r2 = ck.save_async(2, shard)
    r2.wait(60)
    assert r2.chunks_reused == 0

    # round committed: now identical chunks are reused as delta references
    commit_manifest(root, merge_hostmetas(root, 2))
    ck.commit_confirmed(2)
    r3 = ck.save_async(3, shard)
    r3.wait(60)
    assert r3.chunks_reused > 0
    assert r3.chunks_written == 0
    ck.close()


def test_unowned_leaf_persists_nothing_but_merges_whole(tmp_path):
    """Scalar/small leaves are whole-owned by one host; the merge still
    reconstructs the full tree for every restore target."""
    root = str(tmp_path / "ck")
    state = {"w": np.arange(8, dtype=np.float32), "s": np.float32(3.5)}
    cks = _persist_all_hosts(root, state, 2, 2, "thread")
    # exactly one hostmeta carries the scalar
    carriers = [
        h for h in (0, 1)
        if load_hostmeta(root, 2, h).leaves["s"].shards
    ]
    assert len(carriers) == 1
    commit_manifest(root, merge_hostmetas(root, 2))
    restored, _ = RestoreManager(ChunkStore(root)).restore()
    np.testing.assert_array_equal(restored["w"], state["w"])
    assert float(restored["s"]) == 3.5
    for ck in cks:
        ck.close()


def test_hostmeta_path_layout(tmp_path):
    assert hostmeta_path(str(tmp_path), 42, 7).endswith(
        os.path.join("step_00000042", "hostmeta-h0007.msgpack")
    )


# -- tensor windows, kill_pending, and the reference's bytes --------------------------

import torch  # noqa: E402

from repro_torch.checkpoint.chunking import chunk_digest_np  # noqa: E402
from repro_torch.core.shadow import ShadowStateManager  # noqa: E402
from repro_torch.utils.dtypes import byte_view  # noqa: E402


def _tensor_state(rows=9, cols=16):
    s = _state(rows=rows, cols=cols)
    return {
        "device": {
            "w": torch.from_numpy(s["device"]["w"]),
            "e": torch.from_numpy(s["device"]["w"]).to(torch.bfloat16),
            "b": torch.from_numpy(s["device"]["b"]),
        },
        "host": {"step": np.int64(5)},
    }


@pytest.mark.parametrize("backend", BACKENDS)
def test_tensor_windows_persist_and_restore(tmp_path, backend):
    root = str(tmp_path / "ck")
    state = _tensor_state()
    cks = _persist_all_hosts(root, state, 5, 3, backend)
    commit_manifest(root, merge_hostmetas(root, 5))
    restored, _ = RestoreManager(ChunkStore(root)).restore(
        device_for=lambda p, s: "cpu" if p.startswith("device/") else None)
    assert state_digest(restored) == state_digest(state)
    for ck in cks:
        ck.close()


def test_shadow_sync_of_tensor_windows_digests_and_fetches_only_changes():
    """A window is a view of the live tensor: the sync's digests are the
    window's own chunks (chunk_digest_np over its bytes), a step that
    changes one row of one rank's window fetches only that chunk, and
    ``upload`` writes shadow bytes back through the view into the leaf."""
    cb = 64
    w = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)
    view = shard_tree_for_host({"w": w}, 1, 2)
    sh = ShadowStateManager(chunk_bytes=cb)
    st = sh.sync(view)
    raw = byte_view(w[4:8]).numpy()
    want = [chunk_digest_np(raw[i:i + cb]) for i in range(0, raw.nbytes, cb)]
    assert sh.snapshot()[("w", 0)]["digests"] == want
    assert st.chunks_fetched == len(want) and st.bytes_total == raw.nbytes
    w[5, 0] += 1.0  # inside rank 1's window: its chunk 1 (bytes 64..127)
    w[0, 0] += 1.0  # outside it: never seen by this rank
    sh.mark_device_step()
    st = sh.sync(view)
    assert st.changed == {("w", 0): [1]} and st.chunks_fetched == 1
    assert bytes(sh.snapshot()[("w", 0)]["data"]) == bytes(byte_view(w[4:8]).numpy())
    # write-back: a host mutation of the shadow lands in the live leaf
    buf = sh.snapshot()[("w", 0)]["data"]
    buf[:4] = np.frombuffer(np.float32(-7.0).tobytes(), np.uint8)
    sh.mark_host_chunks("w", [0])
    out, ust = sh.upload(view)
    assert ust.chunks_uploaded == 1 and out["w"] is view["w"]
    assert float(w[4, 0]) == -7.0
    assert sh.snapshot()[("w", 0)]["digests"][0] == chunk_digest_np(
        byte_view(w[4:8]).numpy()[:cb])


def test_sync_epochs_ride_the_stats():
    sh = ShadowStateManager(chunk_bytes=64)
    state = {"w": torch.zeros(4, 4)}
    assert sh.sync(state).epoch == 0
    e = sh.begin_sync_epoch()
    assert e == 1 and sh.begin_sync_epoch() == 2
    sh.mark_device_step()
    assert sh.sync(state, epoch=e).epoch == 1
    assert sh.sync(state).epoch == 2


@pytest.mark.skipif(not hasattr(os, "fork"), reason="needs os.fork")
def test_kill_pending_stops_a_live_fork_child(tmp_path, monkeypatch):
    """A hung persist child is SIGKILLed by kill_pending(); its result
    reports the death instead of hanging, and the backend frees its slot."""
    import time

    import repro_torch.core.forked as forked

    real = forked._persist_image

    def slow(*a, **k):
        time.sleep(60)
        return real(*a, **k)

    monkeypatch.setattr(forked, "_persist_image", slow)
    ck = ForkedCheckpointer(ChunkStore(str(tmp_path / "ck")), chunk_bytes=1 << 8,
                            backend="fork", external_commit=True)
    r = ck.save_async(1, shard_tree_for_host(_state(), 0, 1))
    with pytest.raises(TimeoutError):
        r.wait(0.5)
    t0 = time.monotonic()
    ck.backend.kill_pending()
    with pytest.raises(RuntimeError, match="died before reporting"):
        r.wait(30)
    assert time.monotonic() - t0 < 30
    ck.backend.kill_pending()  # nothing live: a no-op
    ck.close()


def test_thread_backend_kill_pending_is_a_noop(tmp_path):
    ck = ForkedCheckpointer(ChunkStore(str(tmp_path / "ck")), backend="thread",
                            external_commit=True)
    ck.backend.kill_pending()
    ck.close()


@pytest.mark.parametrize("n_hosts", [2, 3])
def test_staged_images_equal_the_reference_bytes(tmp_path, n_hosts):
    """The same state staged by each package's ranks gives the same
    payload files and hostmeta bytes, and the merged MANIFESTs agree."""
    from repro.checkpoint.manifest import merge_hostmetas as ref_merge
    from repro.checkpoint.store import ChunkStore as RefStore
    from repro.coord.worker import shard_tree_for_host as ref_shard
    from repro.core.forked import ForkedCheckpointer as RefCk

    state = _state(rows=9)
    mine, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    for ck in _persist_all_hosts(mine, state, 5, n_hosts, "thread"):
        ck.close()
    for h in range(n_hosts):
        ck = RefCk(RefStore(ref), chunk_bytes=1 << 8, host=h, backend="thread",
                   external_commit=True, digest_on_device=False)
        ck.save_async(5, ref_shard(state, h, n_hosts)).wait(60)
        ck.close()
    for name in sorted(os.listdir(step_dir(ref, 5))):
        with open(os.path.join(step_dir(ref, 5), name), "rb") as f:
            want = f.read()
        with open(os.path.join(step_dir(mine, 5), name), "rb") as f:
            assert f.read() == want, name
    assert merge_hostmetas(mine, 5).to_bytes() == ref_merge(ref, 5).to_bytes()
