"""PyTorch port: checkpoint format parity with the JAX reference.

The port writes manifests with its own MessagePack encoder and maps dtype
names through its own table; both must produce what the reference reads,
and read what the reference writes, byte for byte.
"""
import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

import repro.checkpoint as rck
import repro.core as rcore
from repro_torch.checkpoint import ChunkStore, Manifest
from repro_torch.checkpoint import msgpack_lite
from repro_torch.core import ForkedCheckpointer, RestoreManager
from repro_torch.models.convert import array_to_tensor


def _np_state(rng):
    """bf16, f32, 0-d int32 device leaves and a host int64 leaf."""
    return {
        "device": {
            "w": rng.standard_normal((33, 17)).astype(ml_dtypes.bfloat16),
            "f": rng.standard_normal(1000).astype(np.float32),
            "s": np.asarray(7, np.int32),
        },
        "host": {"step": np.int64(5)},
    }


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.uint16)
        return x.cpu().numpy().tobytes()
    a = np.asarray(x)
    if a.dtype == np.dtype(ml_dtypes.bfloat16):
        a = a.view(np.uint16)
    return a.tobytes()


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return np.asarray(x).dtype.name


def _assert_same_state(a, b):
    for group in ("device", "host"):
        assert a[group].keys() == b[group].keys()
        for k in a[group]:
            x, y = a[group][k], b[group][k]
            assert list(np.shape(y)) == list(np.shape(x)), k
            assert _dtype_name(x) == _dtype_name(y), k
            assert _bytes(x) == _bytes(y), k


# -- msgpack ------------------------------------------------------------------

@pytest.mark.parametrize("value", [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63 - 1,
    2**63, 2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
    -2**31 - 1, -2**63, 1.5, -0.0, 1e300, "", "x" * 31, "x" * 32,
    "x" * 255, "x" * 256, "x" * 70000, "päth/ü", b"", b"\x00" * 300,
    b"\x01" * 70000, None, True, False, [], list(range(15)),
    list(range(16)), list(range(70000)), {}, {i: [i] for i in range(15)},
    {str(i): i for i in range(16)}, {3: {"hosts": {0: 1}}}, (1, (2, 3)),
])
def test_msgpack_encoder_is_byte_equal(value):
    want = msgpack.packb(value, use_bin_type=True)
    assert msgpack_lite.packb(value) == want
    assert msgpack_lite.unpackb(want) == msgpack.unpackb(
        want, raw=False, strict_map_key=False
    )


def test_manifest_bytes_equal_reference_with_u64_digests():
    rec = dict(index=0, raw_len=256, digest=2**64 - 1, codec="pgzip",
               file="step_00000003/data-h0000.bin", file_offset=0, comp_len=99)
    big = [2**63, 2**63 + 12345, 2**64 - 2]
    skeleton = {"device": {"w": "device/w", "t": ("device/t/0", None)}}

    def build(mod):
        m = mod.Manifest(step=3, skeleton=skeleton,
                         meta={"wall": 1.25, "hosts": {0: {"chunks_written": 2}}})
        chunks = [mod.ChunkRecord(**rec)] + [
            mod.ChunkRecord(**{**rec, "index": i + 1, "digest": d})
            for i, d in enumerate(big)
        ]
        m.leaves["device/w"] = mod.LeafRecord(
            path="device/w", shape=[33, 17], dtype="bfloat16",
            shards=[mod.ShardRecord(start=[0, 0], stop=[33, 17], chunks=chunks)],
        )
        return m

    import repro.checkpoint.manifest as rmanifest
    import repro_torch.checkpoint.manifest as tmanifest

    ref_bytes = build(rmanifest).to_bytes()
    assert build(tmanifest).to_bytes() == ref_bytes
    back = Manifest.from_bytes(ref_bytes)
    assert [c.digest for c in back.leaves["device/w"].shards[0].chunks] == \
        [2**64 - 1] + big
    assert back.to_bytes() == ref_bytes
    assert back.skeleton == skeleton


def test_real_manifest_roundtrips_byte_equal(tmp_path, rng):
    state = _np_state(rng)
    jstate = {"device": {k: jnp.asarray(v) for k, v in state["device"].items()},
              "host": state["host"]}
    store = rck.ChunkStore(str(tmp_path / "ref"))
    ck = rcore.ForkedCheckpointer(store, chunk_bytes=256)
    ck.save_async(3, jstate).wait()
    ck.close()
    raw = open(tmp_path / "ref" / "step_00000003" / "MANIFEST.msgpack", "rb").read()
    assert Manifest.from_bytes(raw).to_bytes() == raw
    assert msgpack_lite.packb(msgpack.unpackb(raw, raw=False, strict_map_key=False)) == raw


# -- cross-package restore ------------------------------------------------------

@pytest.mark.parametrize("backend", ["thread", "fork"])
def test_port_store_restores_through_reference(tmp_path, rng, backend):
    state = _np_state(rng)
    tstate = {"device": {k: array_to_tensor(v) for k, v in state["device"].items()},
              "host": state["host"]}
    ck = ForkedCheckpointer(ChunkStore(str(tmp_path / "ck")), chunk_bytes=256,
                            backend=backend)
    ck.save_async(4, tstate).wait()
    ck.close()
    got, manifest = rcore.RestoreManager(rck.ChunkStore(str(tmp_path / "ck"))).restore()
    assert manifest.step == 4
    assert manifest.leaves["device/w"].dtype == "bfloat16"
    _assert_same_state(tstate, got)
    rck.sharded.verify_manifest(rck.ChunkStore(str(tmp_path / "ck")), manifest)


def test_reference_store_restores_through_port(tmp_path, rng):
    state = _np_state(rng)
    jstate = {"device": {k: jnp.asarray(v) for k, v in state["device"].items()},
              "host": state["host"]}
    store = rck.ChunkStore(str(tmp_path / "ck"))
    ck = rcore.ForkedCheckpointer(store, chunk_bytes=256)
    ck.save_async(6, jstate).wait()
    ck.close()
    rm = RestoreManager(ChunkStore(str(tmp_path / "ck")))
    got, manifest = rm.restore(
        device_for=lambda p, s: "cpu" if p.startswith("device/") else None,
        verify=True,
    )
    assert manifest.step == 6
    assert all(isinstance(t, torch.Tensor) for t in got["device"].values())
    assert isinstance(got["host"]["step"], np.ndarray)
    _assert_same_state(state, got)


def test_host_restore_keeps_numpy_and_bf16_tensors(tmp_path, rng):
    state = _np_state(rng)
    tstate = {"device": {k: array_to_tensor(v) for k, v in state["device"].items()},
              "host": state["host"]}
    ck = ForkedCheckpointer(ChunkStore(str(tmp_path / "ck")), chunk_bytes=256)
    ck.save_async(1, tstate).wait()
    ck.close()
    got, _ = RestoreManager(ChunkStore(str(tmp_path / "ck"))).restore()
    assert isinstance(got["device"]["f"], np.ndarray)
    assert got["device"]["s"].shape == ()
    # numpy has no bfloat16 without ml_dtypes: such leaves stay CPU tensors
    assert got["device"]["w"].dtype == torch.bfloat16
    _assert_same_state(tstate, got)


# -- incremental deltas -----------------------------------------------------------

def test_incremental_delta_reuses_unchanged_chunks(tmp_path, rng):
    f = torch.from_numpy(rng.standard_normal(1024).astype(np.float32))  # 16 chunks
    state = {"device": {"f": f, "s": torch.zeros((), dtype=torch.int32)},
             "host": {"step": np.int64(1)}}
    ck = ForkedCheckpointer(ChunkStore(str(tmp_path / "ck")), chunk_bytes=256)
    r1 = ck.save_async(1, state).wait()
    assert r1.chunks_written == 18 and r1.chunks_reused == 0
    f[70] += 1.0  # chunk 1 of device/f (64 floats per chunk)
    state["host"]["step"] = np.int64(2)
    r2 = ck.save_async(2, state).wait()
    assert r2.chunks_written == 2  # f chunk 1 and host/step
    assert r2.chunks_reused == 16
    ck.close()
    got, m = RestoreManager(ChunkStore(str(tmp_path / "ck"))).restore(
        device_for=lambda p, s: "cpu" if p.startswith("device/") else None)
    assert torch.equal(got["device"]["f"], f)
    assert rck.manifest.referenced_steps(rck.load_manifest(str(tmp_path / "ck"), 2)) == {1, 2}


# -- tree paths and sharded stores ------------------------------------------------

def test_tree_paths_match_reference_path_str(rng):
    from repro.utils.tree import flatten_with_paths as ref_flatten
    from repro_torch.utils.tree import flatten_with_paths, tree_digest, tree_equal

    tree = {"z": [np.float32(1.0), (np.zeros(3, np.int8), None)],
            "a": {"y": np.ones(2), "b": np.asarray(4, np.int64)}, "n": None}
    want = list(ref_flatten(tree)[0])
    assert list(flatten_with_paths(tree)[0]) == want
    reordered = {"n": None, "a": {"b": tree["a"]["b"], "y": tree["a"]["y"]},
                 "z": tree["z"]}
    assert tree_digest(reordered) == tree_digest(tree)
    assert tree_equal(reordered, tree)
    changed = {**tree, "a": {**tree["a"], "y": np.asarray([1.0, 2.0])}}
    assert tree_digest(changed) != tree_digest(tree)
    assert not tree_equal(changed, tree)


def test_reference_cluster_store_restores_through_port(tmp_path, rng):
    """Two reference hosts each persist their row slice of every leaf; the
    port assembles whole leaves from the two stored shards."""
    from repro.checkpoint.manifest import commit_manifest, merge_hostmetas
    from repro.coord.worker import shard_tree_for_host

    state = {"device": {
        "w": rng.standard_normal((9, 5)).astype(np.float32),
        "e": rng.standard_normal((4, 6)).astype(ml_dtypes.bfloat16),
    }}
    root = str(tmp_path / "ck")
    for host in range(2):
        ck = rcore.ForkedCheckpointer(rck.ChunkStore(root), chunk_bytes=64,
                                      host=host, external_commit=True)
        ck.save_async(2, shard_tree_for_host(state, host, 2)).wait()
        ck.close()
    commit_manifest(root, merge_hostmetas(root, 2))
    got, m = RestoreManager(ChunkStore(root)).restore(
        device_for=lambda p, s: "cpu", verify=True)
    assert [len(lv.shards) for lv in m.leaves.values()] == [2, 2]
    _assert_same_state({"device": state["device"], "host": {}},
                       {"device": got["device"], "host": {}})


# -- the synchronous baseline and the persist-backend plugin point ----------------

@pytest.mark.parametrize("backend", ["thread", "fork"])
def test_save_sync_commits_and_restores_through_reference(tmp_path, rng, backend):
    """``save_sync`` (the paper's naive strategy) returns with the image
    committed and charges the whole persist to the application."""
    state = _np_state(rng)
    tstate = {"device": {k: array_to_tensor(v) for k, v in state["device"].items()},
              "host": state["host"]}
    ck = ForkedCheckpointer(ChunkStore(str(tmp_path / "ck")), chunk_bytes=256,
                            backend=backend)
    r = ck.save_sync(3, tstate)
    assert r.done.is_set() and r.error is None
    assert r.blocking_s >= r.persist_s > 0
    assert RestoreManager(ChunkStore(str(tmp_path / "ck"))).available_steps() == [3]
    ck.close()
    got, manifest = rcore.RestoreManager(rck.ChunkStore(str(tmp_path / "ck"))).restore()
    assert manifest.step == 3
    _assert_same_state(tstate, got)


def test_register_persist_backend_refuses_twice_unless_replaced(tmp_path, rng):
    from repro_torch.core import register_persist_backend
    from repro_torch.core.forked import (
        _PERSIST_BACKENDS,
        ThreadPersistBackend,
        list_persist_backends,
    )

    made = []

    class Counting(ThreadPersistBackend):
        def __init__(self, checkpointer):
            made.append(self)
            super().__init__(checkpointer)

    try:
        register_persist_backend("counting", Counting)
        assert "counting" in list_persist_backends()
        with pytest.raises(ValueError, match="already registered"):
            register_persist_backend("counting", ThreadPersistBackend)
        register_persist_backend("counting", ThreadPersistBackend, replace=True)
        ck = ForkedCheckpointer(ChunkStore(str(tmp_path / "ck")), backend="counting")
        assert type(ck.backend) is ThreadPersistBackend and not made
        ck.close()
        register_persist_backend("counting", Counting, replace=True)
        ck = ForkedCheckpointer(ChunkStore(str(tmp_path / "ck")), backend="counting")
        assert made == [ck.backend]
        ck.close()
    finally:
        _PERSIST_BACKENDS.pop("counting", None)


def test_fork_child_runs_no_destructor_it_inherited(tmp_path, rng, monkeypatch):
    """The fork persist child inherits the parent's uncollected garbage,
    such as a finished managed space, whose host backing is mapped
    ``MADV_DONTFORK`` and so absent in the child. Were a collection in the
    child to free it, its munmap would take pages the child has since
    mapped for itself, and the child would die of SIGSEGV touching them.
    Here the child maps such pages, collects and touches them from its
    chunk loop; it must finalize nothing it inherited and commit, and the
    parent's own collection still frees the garbage."""
    import gc
    import mmap
    import os

    from repro_torch.core import forked
    from repro_torch.uvm.space import _host_buffer

    parent, marks = os.getpid(), tmp_path / "finalized"

    class Cyclic:
        def __init__(self):
            self.me, self.backing = self, _host_buffer(16 << 20)

        def __del__(self):
            with open(marks, "a") as f:
                f.write(f"{os.getpid()}\n")

    digest, mapped = forked.chunk_digest_np, []

    def collecting(raw):
        if os.getpid() != parent and not mapped:
            mapped.extend(mmap.mmap(-1, 16 << 20) for _ in range(4))
            gc.collect()
            for m in mapped:
                m[:1] = b"x"
        return digest(raw)

    monkeypatch.setattr(forked, "chunk_digest_np", collecting)
    state = _np_state(rng)
    tstate = {"device": {k: array_to_tensor(v) for k, v in state["device"].items()},
              "host": state["host"]}
    enabled = gc.isenabled()
    gc.disable()
    try:
        Cyclic()  # garbage until the next collection
        ck = ForkedCheckpointer(ChunkStore(str(tmp_path / "ck")), chunk_bytes=256,
                                backend="fork")
        r = ck.save_sync(3, tstate)
        ck.close()
        assert r.error is None and not marks.exists()
    finally:
        if enabled:
            gc.enable()
    gc.collect()
    assert marks.read_text().split() == [str(parent)]
    assert RestoreManager(ChunkStore(str(tmp_path / "ck"))).available_steps() == [3]
