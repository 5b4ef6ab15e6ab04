"""The port's device proxy under oversubscription, and chunk-delta UPLOADs.

The twins of the reference's ``tests/uvm/test_paged_proxy.py``: a proxy
hosting a state at 2x its device budget (a ``ManagedSpace`` in the proxy,
frames on the CPU here) survives a SIGKILL by replay bit for bit; a
chunk-delta push puts bytes on the data plane in step with the dirty
chunks, splices only them into the paged state, and falls back to a full
upload where a delta would be unsafe. The reference's paged runner is the
oracle for the mirror bytes and the paging counters; an inline managed
trainer of the same program is the oracle for the proxied managed images.
Each proxy spawn imports torch (about 2 s here).
"""
import numpy as np
import pytest

from repro.proxy import ProxyRunner as RefProxyRunner
from repro_torch.checkpoint import ChunkStore
from repro_torch.core import CheckpointedTrainer, CheckpointPolicy, RestoreManager
from repro_torch.proxy import ProxyRunner, make_program
from repro_torch.utils.tree import flatten_with_paths, leaf_bytes, tree_digest, tree_equal

SPEC = {"name": "numpy_sgd", "rows": 64, "width": 128, "seed": 0}
TINY = {"name": "torch_tiny", "width": 32, "batch": 2, "seq": 16, "device": "cpu"}
CHUNK = 4096
TIMEOUTS = {"op_timeout_s": 30.0, "sync_timeout_s": 30.0}


def _runner(spec=SPEC, **kw):
    return ProxyRunner(spec, chunk_bytes=CHUNK, **TIMEOUTS, **kw)


def _state_bytes(state) -> int:
    return sum(leaf_bytes(v).nbytes for v in flatten_with_paths(state)[0].values())


def _cap(spec=SPEC) -> int:
    return max(8192, make_program(spec).state_nbytes() // 2)


def _bytes_equal(a, b) -> bool:
    fa, fb = flatten_with_paths(a)[0], flatten_with_paths(b)[0]
    return fa.keys() == fb.keys() and all(
        np.array_equal(leaf_bytes(fa[p]), leaf_bytes(fb[p])) for p in fa)


def test_paged_proxy_kill_replay_bit_identical():
    """A proxy hosting a state at 2x its device budget is SIGKILLed
    mid-run; replay must land bit-identically on the uninterrupted run."""
    ref = _runner()
    ref.start()
    for s in range(1, 7):
        ref.step(s)
    ref_state, ref_info = ref.sync_state()
    ref.close()

    cap = _cap()
    r = _runner(device_capacity_bytes=cap, page_bytes=4096)
    r.start()
    for s in range(1, 4):
        r.step(s)
    r.sync_state()
    r.kill()
    for s in range(4, 7):
        r.step(s)  # transport death detected here -> respawn + replay
    state, info = r.sync_state()
    r.close()
    assert r.restarts == 1
    assert info["digest"] == ref_info["digest"]
    assert tree_digest(state) == tree_digest(ref_state)
    # the SYNCED frame carries the proxy-side paging counters
    assert info["paging"]["faults"] > 0 and info["paging"]["evictions"] > 0
    assert info["paging"]["device_capacity_bytes"] == cap
    assert info["paging"]["resident_high_water"] <= cap


def test_paged_proxy_matches_the_reference_paged_proxy():
    """The same paged run through the reference's runner and the port's:
    the same mirror bytes, SYNCED digest, chunks synced and paging
    counters at every sync."""
    cap = _cap()
    runs = []
    for cls in (RefProxyRunner, ProxyRunner):
        r = cls(SPEC, chunk_bytes=CHUNK, device_capacity_bytes=cap, page_bytes=4096,
                eviction_policy="clock", **TIMEOUTS)
        r.start()
        seen = []
        for s in range(1, 6):
            r.step(s)
            if s % 2:
                state, info = r.sync_state()
                seen.append((state, info))
        r.close()
        runs.append(seen)
    for (ref_state, ref_info), (state, info) in zip(*runs):
        assert _bytes_equal(ref_state, state)
        assert info["digest"] == ref_info["digest"]
        assert info["chunks_synced"] == ref_info["chunks_synced"]
        assert info["paging"] == ref_info["paging"]


def test_delta_upload_bytes_on_wire_scale_with_dirty_chunks():
    """Push states differing by k chunks: the data-plane bytes and the
    proxy's UPLOAD ack scale with k, not with the state size."""
    r = _runner()
    r.start()
    for s in range(1, 3):
        r.step(s)
    state, _ = r.sync_state()
    total = _state_bytes(state)
    key = max(state, key=lambda k: np.asarray(state[k]).nbytes)

    wire = []
    for k_chunks in (1, 3):
        new = {k: np.array(v) for k, v in state.items()}
        flat = new[key].reshape(-1).view(np.uint8)
        for c in range(k_chunks):
            flat[c * CHUNK] ^= 0xFF  # one byte per target chunk
        seg_before = r.segments.bytes_written
        ack = r.push(new)
        seg_bytes = r.segments.bytes_written - seg_before
        wire.append((k_chunks, seg_bytes, ack))
        assert ack["chunks_uploaded"] == k_chunks
        assert ack["bytes_uploaded"] <= k_chunks * CHUNK
        assert seg_bytes <= k_chunks * CHUNK
        assert seg_bytes < total // 4, "delta must not rewrite the state"
        state = new

    (_, b1, _), (_, b3, _) = wire
    assert b3 == 3 * b1, "bytes-on-wire must scale linearly with dirty chunks"
    _, info = r.sync_state()
    assert info["digest"] == tree_digest(state)
    r.close()


def test_delta_upload_into_paged_proxy():
    """A partial push into an oversubscribed proxy lands in the managed
    space coherently AND does not dirty the untouched pages (the next
    page-delta SYNC stays small)."""
    r = _runner(device_capacity_bytes=_cap(), page_bytes=4096)
    r.start()
    r.step(1)
    state, _ = r.sync_state()
    new = {k: np.array(v) for k, v in state.items()}
    key = max(new, key=lambda k: np.asarray(new[k]).nbytes)
    new[key].reshape(-1)[:8] += 1.5
    ack = r.push(new)
    assert ack["chunks_uploaded"] == 1
    _, info = r.sync_state()
    assert info["digest"] == tree_digest(new)
    # a 1-chunk delta must not make the whole state look dirty: this sync
    # re-fetched at most the spliced chunk's pages (chunk == page here)
    assert info["chunks_synced"] <= 1, f"delta upload dirtied {info['chunks_synced']} chunks"
    r.close()


@pytest.mark.parametrize("managed", [False, True], ids=["plain", "paged"])
def test_push_after_unsynced_steps_falls_back_to_full_upload(managed):
    """A delta diffed against a stale mirror would under-upload: with STEP
    frames outstanding past the last sync, push() must rewrite fully so
    the device provably lands on the pushed state."""
    kw = {"device_capacity_bytes": _cap(), "page_bytes": 4096} if managed else {}
    r = _runner(**kw)
    r.start()
    r.step(1)
    state, _ = r.sync_state()  # mirror = S1
    r.step(2)
    r.step(3)                  # device is past the mirror now
    total = _state_bytes(state)
    seg_before = r.segments.bytes_written
    ack = r.push({k: np.array(v) for k, v in state.items()})  # roll back to S1
    assert r.segments.bytes_written - seg_before == total, "must be a full rewrite"
    assert ack["bytes_uploaded"] == total
    _, info = r.sync_state()
    assert info["digest"] == tree_digest(state), "device must be AT the pushed state"
    r.close()


def test_full_push_when_no_mirror_compatible():
    """Without a mirror to diff against, a push rewrites the segments whole."""
    r = _runner(device_capacity_bytes=_cap(), page_bytes=4096)
    r.start()
    state, _ = r.sync_state()
    r._last_state = None  # scrub the mirror: "no mirror"
    seg_before = r.segments.bytes_written
    r.push({k: np.array(v) for k, v in state.items()})
    assert r.segments.bytes_written - seg_before == _state_bytes(state)
    _, info = r.sync_state()
    assert info["digest"] == tree_digest(state)
    r.close()


def _inline_managed(root, cap, n_steps):
    """The same torch program trained inline through a managed trainer:
    the batch of step n is the program's own (``prog.step(state, n)``)."""
    prog = make_program(TINY)
    tr = CheckpointedTrainer(
        lambda d, n: prog.step(d, n), store_root=str(root),
        policy=CheckpointPolicy(interval_steps=2, keep_last=2), chunk_bytes=CHUNK,
        device_capacity_bytes=cap, page_bytes=4096, device="cpu",
    )
    state = {"device": prog.init_state(), "host": {"step": np.int64(0)}}
    state = tr.run(state, iter(range(1, n_steps + 1)), num_steps=n_steps)
    tr.finish()
    return state


@pytest.mark.parametrize("fused", [False, True], ids=["scan", "fused"])
def test_trainer_paged_proxy_survives_kill_and_matches_inline_managed(tmp_path, fused):
    """``CheckpointedTrainer(device_runner="proxy", device_capacity_bytes=)``
    with a SIGKILL after step 3 is issued: one restart, and the step-4
    image equals an inline managed run's bit for bit."""
    cap = _cap(TINY)
    tr = CheckpointedTrainer(
        None, store_root=str(tmp_path / "proxy"),
        policy=CheckpointPolicy(interval_steps=2, keep_last=2), chunk_bytes=CHUNK,
        device_runner="proxy", program=TINY, device_capacity_bytes=cap,
        page_bytes=4096, proxy_opts={"fused_digests": fused, **TIMEOUTS},
    )
    infos = []
    finish = tr.runner._finish_sync

    def recording(epoch, msg, *, stall_us):
        out = finish(epoch, msg, stall_us=stall_us)
        infos.append(out[1])
        return out

    tr.runner._finish_sync = recording
    state, start = tr.resume_or(lambda: {"device": None, "host": {"step": np.int64(0)}})
    killed = []

    def stop():
        if int(state["host"]["step"]) == 3 and not killed:
            killed.append(tr.runner.kill())
        return False

    state = tr.run(state, num_steps=4, start_step=start, stop=stop)
    tr.finish()
    assert tr.runner.restarts == 1
    assert infos and all("paging" in i for i in infos)
    assert all(i["paging"]["resident_high_water"] <= cap for i in infos)
    # fused digests compose with the page marks: the marked chunks are
    # compared against the step's digests, never scanned at the boundary
    prehashed = [i["phase_us"]["prehashed_chunks"] for i in infos]
    assert all(n > 0 for n in prehashed) if fused else not any(prehashed)
    assert not any(i["phase_us"]["digest"] for i in infos)
    want = _inline_managed(tmp_path / "inline", cap, 4)
    got, _ = RestoreManager(ChunkStore(str(tmp_path / "proxy"))).restore(step=4)
    assert tree_equal(got["device"], want["device"])
    mine, _ = RestoreManager(ChunkStore(str(tmp_path / "inline"))).restore(step=4)
    assert tree_equal(mine["device"], got["device"])


def test_train_cli_proxy_with_device_capacity(tmp_path, capsys):
    from repro_torch.launch import train

    argv = ["--arch", "qwen2-0.5b", "--smoke", "--batch", "2", "--seq", "16",
            "--ckpt-every", "2", "--device-runner", "proxy", "--device", "cpu",
            "--ckpt-dir", str(tmp_path / "ck"), "--backend", "thread",
            "--device-capacity", "50%", "--page-bytes", "4096", "--steps", "4"]
    out = train.train(argv)
    text = capsys.readouterr().out
    assert "[uvm] proxy device_capacity=" in text
    assert out["final_step"] == 4 and [r.step for r in out["results"]] == [2, 4]
    plain = train.train(argv[:-6] + ["--steps", "4", "--ckpt-dir", str(tmp_path / "p")])
    assert tree_equal(out["state"]["device"], plain["state"]["device"])
    assert np.isfinite(out["metrics"]["loss"])
