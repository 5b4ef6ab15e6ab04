"""PyTorch port: the device proxy, against the JAX reference.

Compute runs in a spawned proxy process that owns the device state; the
application keeps a host mirror, an API log and a restart budget. Here the
proxy runs on the CPU (``device="cpu"`` in the torch programs' specs; on a
card the same code runs on ``cuda``). The reference's proxy tests
(``tests/proxy/test_{api_log,runner,kill_replay,epoch_sync}.py``) run
again on the port, and the reference is the oracle for what crosses
packages: API logs replay through either package to the same plan, a
kill schedule gives the same mirror bytes and SYNCED fields in both
runners, images written by either package's proxied trainer continue in
the other's proxy to the reference's bits, ``upload`` reports the
reference's ``UploadStats``, and ``train_arch``'s step matches the
reference's ``TrainArch.step_fn`` within ``tests/test_torch_model.py``'s
tolerances (1e-5 for the loss and gradient-derived moments, 1e-6 for the
params). Every other comparison is exact.

Each runner gets short operation and sync timeouts, so a hung proxy fails
its test instead of the run; nothing waits on a sleep.
"""
import os
import signal
import socket
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.shadow import ShadowStateManager as RefShadow
from repro.proxy import ApiLog as RefApiLog
from repro.proxy import ProxyRunner as RefProxyRunner
from repro.proxy import make_program as ref_make_program
from repro_torch.checkpoint.chunking import chunk_digest_np
from repro_torch.core import (
    CheckpointedTrainer,
    CheckpointPolicy,
    ForkedCheckpointer,
    RestoreManager,
    ShadowStateManager,
)
from repro_torch.models.convert import array_to_tensor, state_from_numpy
from repro_torch.proxy import ApiLog, ProxyRunner, iter_records, make_program
from repro_torch.utils.tree import flatten_with_paths, leaf_bytes, tree_digest, tree_equal

BACKENDS = ["thread"] + (["fork"] if hasattr(os, "fork") else [])
SPEC = {"name": "numpy_sgd", "rows": 8, "width": 32, "seed": 0}
TINY = {"name": "torch_tiny", "width": 32, "batch": 2, "seq": 16, "device": "cpu"}
ARCH = {"name": "train_arch", "arch": "qwen2-0.5b", "smoke": True, "batch": 2,
        "seq": 16, "lr": 3e-4, "total_steps": 20, "device": "cpu"}
TIMEOUTS = {"op_timeout_s": 30.0, "sync_timeout_s": 30.0}


def _runner(spec=SPEC, **kw):
    return ProxyRunner(spec, chunk_bytes=kw.pop("chunk_bytes", 1 << 10),
                       **TIMEOUTS, **kw)


def _inline_run(n_steps, spec=SPEC, start=None, first=1):
    prog = make_program(spec)
    s = prog.init_state() if start is None else start
    for step in range(first, n_steps + 1):
        s, _ = prog.step(s, step)
    return s


def _bytes_equal(a, b) -> bool:
    """Leaf bytes equal under the same paths (host mirrors hold numpy and
    CPU tensors, the reference's hold numpy and ml_dtypes arrays)."""
    fa, fb = flatten_with_paths(a)[0], flatten_with_paths(b)[0]
    return fa.keys() == fb.keys() and all(
        np.array_equal(leaf_bytes(fa[p]), leaf_bytes(fb[p])) for p in fa)


# -- API log (tests/proxy/test_api_log.py, on the port) -------------------------

def test_append_read_roundtrip(tmp_path):
    p = str(tmp_path / "log.bin")
    log = ApiLog(p, truncate=True)
    recs = [
        {"call": "program", "spec": {"name": "numpy_sgd", "width": 8}},
        {"call": "register", "workdir": "/x", "layout": {"w": {"nbytes": 4}},
         "chunk_bytes": 1024},
        {"call": "upload", "step": 0, "paths": None},
        {"call": "step", "step": 1},
        {"call": "step", "step": 2},
        {"call": "sync", "step": 2, "digest": "abc"},
        {"call": "step", "step": 3},
    ]
    for r in recs:
        log.append(r)
    log.close()
    assert list(iter_records(p)) == recs


def test_replay_plan_selects_steps_after_last_sync(tmp_path):
    p = str(tmp_path / "log.bin")
    log = ApiLog(p, truncate=True)
    log.append({"call": "program", "spec": {"name": "numpy_sgd"}})
    log.append({"call": "register", "workdir": "/x", "layout": {}, "chunk_bytes": 1024})
    for s in (1, 2, 3):
        log.append({"call": "step", "step": s})
    log.append({"call": "sync", "step": 3, "digest": "d3"})
    for s in (4, 5):
        log.append({"call": "step", "step": s})
    program, register, steps = log.replay_plan()
    assert program == {"name": "numpy_sgd"}
    assert register["chunk_bytes"] == 1024
    assert steps == [4, 5]
    assert log.last_synced_step() == 3
    log.close()


def test_replay_plan_upload_supersedes_earlier_steps(tmp_path):
    p = str(tmp_path / "log.bin")
    log = ApiLog(p, truncate=True)
    log.append({"call": "program", "spec": {"name": "numpy_sgd"}})
    log.append({"call": "register", "workdir": "/x", "layout": {}, "chunk_bytes": 1024})
    log.append({"call": "upload", "step": 0, "paths": None})
    for s in (1, 2):
        log.append({"call": "step", "step": s})
    log.append({"call": "upload", "step": 7, "paths": None})  # restore push
    log.append({"call": "step", "step": 8})
    _, _, steps = log.replay_plan()
    assert steps == [8]
    log.close()


def test_truncate_vs_append_mode(tmp_path):
    p = str(tmp_path / "log.bin")
    log = ApiLog(p, truncate=True)
    log.append({"call": "step", "step": 1})
    log.close()
    log2 = ApiLog(p)
    log2.append({"call": "step", "step": 2})
    log2.close()
    assert [r["step"] for r in iter_records(p)] == [1, 2]
    log3 = ApiLog(p, truncate=True)
    log3.append({"call": "step", "step": 9})
    log3.close()
    assert [r["step"] for r in iter_records(p)] == [9]


def test_torn_tail_is_dropped_cleanly(tmp_path):
    p = str(tmp_path / "log.bin")
    log = ApiLog(p, truncate=True)
    log.append({"call": "step", "step": 1})
    log.append({"call": "step", "step": 2})
    log.close()
    size = os.path.getsize(p)
    with open(p, "r+b") as f:  # crash mid-append: half a record at the tail
        f.truncate(size - 3)
    assert [r["step"] for r in iter_records(p)] == [1]


def test_empty_and_missing_logs(tmp_path):
    assert list(iter_records(str(tmp_path / "nope.bin"))) == []
    p = str(tmp_path / "empty.bin")
    ApiLog(p, truncate=True).close()
    assert list(iter_records(p)) == []
    assert ApiLog(p).last_synced_step() == 0


LOG = [
    {"call": "program", "spec": {"name": "numpy_sgd", "rows": 8}},
    {"call": "register", "workdir": "/w", "layout": {"w": {"nbytes": 1 << 20}},
     "chunk_bytes": 4096, "fused_digests": True, "device_capacity_bytes": None},
    {"call": "upload", "step": 0, "paths": None},
    {"call": "step", "step": 1}, {"call": "step", "step": 2},
    {"call": "sync_begin", "epoch": 1, "step": 2},
    {"call": "step", "step": 3},
    {"call": "sync", "step": 2, "digest": "d" * 16, "epoch": 1},
    {"call": "step", "step": 4},
    {"call": "sync_begin", "epoch": 2, "step": 4},
    {"call": "step", "step": 5},
    {"call": "upload", "step": 2, "paths": None, "chunks": {"w": [0, 3]}},
    {"call": "step", "step": 6},
    {"call": "sync_begin", "epoch": 3, "step": 6},
    {"call": "step", "step": 7},
]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_api_logs_replay_through_either_package(tmp_path, writer):
    """A log written by one package reads back in the other record for
    record, byte for byte, and replays to the same plan and actions."""
    paths = {w: str(tmp_path / f"{w}.bin") for w in ("port", "reference")}
    for w, cls in (("port", ApiLog), ("reference", RefApiLog)):
        log = cls(paths[w], truncate=True)
        for rec in LOG:
            log.append(rec)
        log.close()
    with open(paths["port"], "rb") as f, open(paths["reference"], "rb") as g:
        assert f.read() == g.read()
    src = paths[writer]
    port, ref = ApiLog(src), RefApiLog(src)
    assert port.records() == ref.records() == LOG
    assert port.replay_actions() == ref.replay_actions()
    assert port.replay_plan() == ref.replay_plan()
    assert port.replay_actions()[2] == [("step", 6), ("sync", 3, 6), ("step", 7)]
    assert port.last_synced_step() == ref.last_synced_step() == 2


# -- the runner (tests/proxy/test_runner.py, on the port) -----------------------

@pytest.mark.parametrize("transport", ["segment", "stream"])
def test_proxied_run_bit_identical_to_inline(transport):
    ref = _inline_run(12)
    r = _runner(transport=transport)
    r.start()
    try:
        for s in range(1, 13):
            r.step(s)
        state, info = r.sync_state()
        assert info["step"] == 12
        assert tree_equal(state, ref)
        assert info["digest"] == tree_digest(ref)
        assert info["bytes_synced"] > 0
        # streamed: the payload rode the connection, as chunk frames
        moved = info["transport"]["raw_rx"]
        assert moved == (info["bytes_synced"] if transport == "stream" else 0)
    finally:
        r.close()


def test_pipeline_auto_flush_watermark():
    r = _runner(max_pipeline=4)
    r.start()
    try:
        for s in range(1, 10):
            r.step(s)
            assert r.proxy.inflight < 4  # watermark flushes keep it bounded
        state, info = r.sync_state()
        assert info["step"] == 9
        assert tree_equal(state, _inline_run(9))
    finally:
        r.close()


def test_sync_midway_then_continue():
    r = _runner()
    r.start()
    try:
        for s in range(1, 6):
            r.step(s)
        mid, _ = r.sync_state()
        assert tree_equal(mid, _inline_run(5))
        for s in range(6, 11):
            r.step(s)
        end, info = r.sync_state()
        assert tree_equal(end, _inline_run(10))
        assert info["chunks_synced"] > 0
    finally:
        r.close()


def test_push_overwrites_proxy_state():
    r = _runner()
    r.start()
    try:
        for s in range(1, 4):
            r.step(s)
        r.sync_state()
        target = _inline_run(7)  # pretend this was restored from a checkpoint
        r.push(target)
        state, _ = r.sync_state()
        assert tree_equal(state, target)
        r.step(8)
        state, _ = r.sync_state()
        assert tree_equal(state, _inline_run(8))
    finally:
        r.close()


def test_restore_into_proxy_replays_checkpoint(tmp_path):
    from repro_torch.checkpoint import ChunkStore

    store = ChunkStore(str(tmp_path / "ckpt"))
    mid = _inline_run(6)
    ck = ForkedCheckpointer(store, chunk_bytes=1 << 10)
    ck.save_async(6, {"device": mid, "host": {"step": np.int64(6)}}).wait()
    ck.close()

    r = _runner()
    try:
        state, manifest = RestoreManager(store).restore_into_proxy(r)
        assert manifest.step == 6
        assert r.started
        assert tree_equal(state["device"], mid)
        for s in range(7, 11):
            r.step(s)
        end, _ = r.sync_state()
        assert tree_equal(end, _inline_run(10))
    finally:
        r.close()


# -- kill and replay (tests/proxy/test_kill_replay.py, on the port) --------------

@pytest.mark.parametrize("transport", ["segment", "stream"])
def test_sigkill_mid_training_replays_bit_identical(transport):
    ref = _inline_run(20)
    r = _runner(max_restarts=2, transport=transport)
    r.start()
    try:
        for s in range(1, 9):
            r.step(s)
        _, info = r.sync_state()
        assert info["step"] == 8
        assert r.kill() is not None  # SIGKILL with steps about to be in flight
        for s in range(9, 21):
            r.step(s)  # death detected here -> respawn + replay
        state, info = r.sync_state()
        assert r.restarts == 1
        assert r.recoveries and r.recoveries[0]["resumed_from_step"] == 8
        assert info["step"] == 20
        assert tree_equal(state, ref)
        assert info["digest"] == tree_digest(ref)
    finally:
        r.close()


def test_sigkill_detected_at_sync_replays_bit_identical():
    ref = _inline_run(10)
    r = _runner(max_restarts=2)
    r.start()
    try:
        for s in range(1, 11):
            r.step(s)
        r.proxy.flush()  # everything executed; now kill before SYNC
        os.kill(r.proxy.pid, signal.SIGKILL)
        state, info = r.sync_state()
        assert r.restarts == 1
        assert info["step"] == 10
        assert tree_equal(state, ref)
    finally:
        r.close()


def test_restart_budget_exhaustion_surfaces():
    r = _runner(max_restarts=0)
    r.start()
    try:
        r.step(1)
        r.sync_state()
        r.kill()
        with pytest.raises(RuntimeError, match="giving up"):
            for s in range(2, 6):
                r.step(s)
            r.sync_state()
    finally:
        r.close()


def _init_none():
    return {"device": None, "host": {"step": np.int64(0)}}


@pytest.mark.parametrize("backend", BACKENDS)
def test_trainer_proxy_checkpoints_restore_through_backend(tmp_path, backend):
    root = str(tmp_path / f"ckpt-{backend}")
    ref = _inline_run(12)

    def trainer():
        return CheckpointedTrainer(
            None, store_root=root, policy=CheckpointPolicy(interval_steps=4),
            chunk_bytes=1 << 10, backend=backend, device_runner="proxy",
            program=SPEC, proxy_opts=TIMEOUTS,
        )

    t1 = trainer()
    state, start = t1.resume_or(_init_none)
    assert start == 0
    state = t1.run(state, num_steps=8, start_step=0)
    t1.finish()
    assert [r.step for r in t1.results] == [4, 8]
    assert all(r.error is None for r in t1.results)

    t2 = trainer()  # restart: restores step 8 and pushes it into a new proxy
    state2, start2 = t2.resume_or(_init_none)
    assert start2 == 8
    assert tree_equal(state2["device"], _inline_run(8))
    state2 = t2.run(state2, num_steps=4, start_step=8)
    t2.finish()
    assert tree_equal(state2["device"], ref)
    restored, manifest = RestoreManager(t2.store).restore()
    assert manifest.step == 12
    assert tree_equal(restored["device"], ref)


def test_trainer_survives_proxy_kill_mid_run(tmp_path):
    ref = _inline_run(10)
    trainer = CheckpointedTrainer(
        None, store_root=str(tmp_path / "ckpt"),
        policy=CheckpointPolicy(interval_steps=5), chunk_bytes=1 << 10,
        device_runner="proxy", program=SPEC, proxy_opts=TIMEOUTS,
    )
    state, _ = trainer.resume_or(_init_none)
    state = trainer.run(state, num_steps=6, start_step=0)
    trainer.runner.kill()
    state = trainer.run(state, num_steps=4, start_step=6)
    trainer.finish()
    assert all(r.error is None for r in trainer.results)
    assert trainer.runner.restarts == 1
    assert tree_equal(state["device"], ref)


# -- epoch syncs (tests/proxy/test_epoch_sync.py, on the port) -------------------

def test_epoch_sync_captures_boundary_while_app_runs_ahead():
    r = _runner()
    r.start()
    try:
        for s in range(1, 6):
            r.step(s)
        epoch = r.sync_begin()
        for s in range(6, 11):
            r.step(s)
        state, info = r.sync_collect(epoch)
        assert info["epoch"] == epoch and info["step"] == 5
        assert "stall_us" in info
        assert tree_equal(state, _inline_run(5))
        state, info = r.sync_state()
        assert info["step"] == 10
        assert tree_equal(state, _inline_run(10))
    finally:
        r.close()


def test_epoch_sync_poll_is_nonblocking_and_eventually_lands():
    r = _runner()
    r.start()
    try:
        for s in range(1, 4):
            r.step(s)
        epoch = r.sync_begin()
        res = None
        for _ in range(20000):
            res = r.sync_poll(epoch)
            if res is not None:
                break
        assert res is not None, "SYNCED never arrived via poll"
        state, info = res
        assert info["step"] == 3
        assert info["stall_us"] == 0.0
        assert tree_equal(state, _inline_run(3))
    finally:
        r.close()


def test_kill_with_inflight_epoch_sync_replays_bit_identical():
    r = _runner(max_restarts=2)
    r.start()
    try:
        for s in range(1, 6):
            r.step(s)
        epoch = r.sync_begin()
        for s in range(6, 9):
            r.step(s)
        os.kill(r.proxy.pid, signal.SIGKILL)
        for s in range(9, 11):
            r.step(s)
        state, info = r.sync_collect(epoch)
        assert r.restarts == 1
        assert info["step"] == 5
        assert tree_equal(state, _inline_run(5))
        final, info = r.sync_state()
        assert info["step"] == 10
        assert tree_equal(final, _inline_run(10))
        assert info["digest"] == tree_digest(_inline_run(10))
    finally:
        r.close()


def test_serialized_epochs_one_inflight_at_a_time():
    r = _runner()
    r.start()
    try:
        r.step(1)
        e1 = r.sync_begin()
        r.step(2)
        e2 = r.sync_begin()
        assert e2 == e1 + 1
        assert list(r._pending_epochs) == [e2]  # e1 was drained
        state, info = r.sync_collect(e2)
        assert info["step"] == 2
        assert tree_equal(state, _inline_run(2))
        assert r.last_synced_step == 2
    finally:
        r.close()


def _host_table(state, cb):
    return {p: [chunk_digest_np(raw[i:i + cb]) for i in range(0, max(raw.nbytes, 1), cb)]
            for p, raw in ((p, leaf_bytes(leaf))
                           for p, leaf in flatten_with_paths(state)[0].items())}


@pytest.mark.parametrize("spec", [SPEC, TINY], ids=["numpy_sgd", "torch_tiny"])
def test_fused_digests_skip_boundary_scan(spec):
    """fused_digests=True: the step program digests its output, the SYNC
    boundary consumes those digests (no scan), and the ack's per-chunk
    table equals the host oracle over the acknowledged mirror."""
    cb = 1 << 10
    r = _runner(spec, chunk_bytes=cb, fused_digests=True)
    r.start()
    try:
        for s in range(1, 6):
            r.step(s)
        state, info = r.sync_state()
        assert tree_equal(state, _inline_run(5, spec))
        phase = info["phase_us"]
        assert phase["prehashed_chunks"] > 0
        assert phase["digest"] == 0.0
        assert phase["steps"] == 5 and phase["digest_launches"] == 0  # no card
        assert len(phase["step_each"]) == 5 and phase["warm_up"]  # the first step
        assert info["chunk_digests"] == _host_table(state, cb)
        for s in range(6, 11):
            r.step(s)
        state, info = r.sync_state()
        assert tree_equal(state, _inline_run(10, spec))
        assert info["phase_us"]["digest"] == 0.0
        assert len(info["phase_us"]["step_each"]) == 5 and not info["phase_us"]["warm_up"]
        assert info["chunk_digests"] == _host_table(state, cb)
    finally:
        r.close()


def test_fused_digests_survive_kill_replay():
    ref = _inline_run(10)
    r = _runner(max_restarts=2, fused_digests=True)
    r.start()
    try:
        for s in range(1, 6):
            r.step(s)
        r.sync_state()
        r.kill()
        for s in range(6, 11):
            r.step(s)
        state, info = r.sync_state()
        assert r.restarts == 1
        assert info["step"] == 10
        assert tree_equal(state, ref)
        assert info["digest"] == tree_digest(ref)
    finally:
        r.close()


# -- torch programs in the proxy ----------------------------------------------------

def test_torch_program_proxied_with_kill_is_bit_identical_to_inline():
    """torch_tiny: an AdamW step on tensors in the proxy process, killed
    mid-run and replayed, equals the same steps run inline, bit for bit."""
    ref = _inline_run(6, TINY)
    r = _runner(TINY, max_restarts=2, fused_digests=True)
    mirror = r.start()
    try:
        assert tree_equal(mirror, make_program(TINY).init_state())
        for s in range(1, 4):
            r.step(s)
        r.sync_state()
        r.kill()
        for s in range(4, 7):
            r.step(s)
        state, info = r.sync_state()
        assert r.restarts == 1 and r.recoveries[0]["replayed_steps"] >= 1
        assert tree_equal(state, ref)
        assert info["digest"] == tree_digest(ref)
        assert np.isfinite(info["metrics"]["loss"])
    finally:
        r.close()


def test_torch_programs_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    for spec in (dict(TINY, device="cuda"), {k: v for k, v in ARCH.items() if k != "device"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_program(spec)


def test_train_arch_state_matches_reference_layout():
    """Same paths, shapes and dtype names as the reference's TrainArch; the
    proxy's empty state and ``state_nbytes`` have that structure without
    drawing an init; the batch is a pure function of (seed, step)."""
    prog = make_program(ARCH)
    ref = ref_make_program({k: v for k, v in ARCH.items() if k != "device"})
    want = flatten_with_paths(jax.tree.map(np.asarray, ref.init_state()))[0]
    for state in (prog.init_state(), prog.empty_state()):
        got = flatten_with_paths(state)[0]
        assert list(got) == list(want)
        for p, t in got.items():
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
            assert tuple(t.shape) == want[p].shape, p
            assert str(t.dtype).removeprefix("torch.") == want[p].dtype.name, p
    assert prog.state_nbytes() == ref.state_nbytes() == sum(
        a.nbytes for a in want.values())
    b1, b2 = prog.batch_at(3), make_program(ARCH).batch_at(3)
    assert np.array_equal(b1["inputs"], b2["inputs"]) and b1["inputs"] is b1["targets"]
    assert b1["inputs"].shape == (ARCH["batch"], ARCH["seq"])
    assert not np.array_equal(b1["inputs"], prog.batch_at(4)["inputs"])


def test_train_arch_depth_cut_keeps_the_widths():
    """``num_layers`` cuts only the layer axis of the stacked block leaves:
    the same paths, and every other dimension as the full config's."""
    full = flatten_with_paths(make_program(ARCH).meta_state())[0]
    cut = flatten_with_paths(make_program(dict(ARCH, num_layers=1)).meta_state())[0]
    assert list(cut) == list(full)
    deeper = 0
    for p, t in cut.items():
        f = full[p]
        if tuple(t.shape) != tuple(f.shape):
            assert (t.shape[0], f.shape[0]) == (1, 2) and t.shape[1:] == f.shape[1:], p
            deeper += 1
    assert deeper > 0
    assert make_program(dict(ARCH, num_layers=1)).state_nbytes() < make_program(ARCH).state_nbytes()


def test_train_arch_step_matches_reference_step_fn():
    """Two steps of train_arch on the reference's init (carried over by
    ``models/convert.py``) and the port's batches, against the reference's
    jitted ``TrainArch.step_fn`` on the same batches."""
    prog = make_program(ARCH)
    ref = ref_make_program({k: v for k, v in ARCH.items() if k != "device"})
    rstate = ref.init_state()
    state = state_from_numpy(jax.tree.map(np.asarray, rstate))
    for step in (1, 2):
        batch = prog.batch_at(step)
        rstate, rloss = ref.step_fn(rstate, jax.tree.map(jnp.asarray, batch))
        state, metrics = prog.step(state, step)
        np.testing.assert_allclose(metrics["loss"], float(rloss), atol=1e-5, rtol=1e-5)
    want = flatten_with_paths(jax.tree.map(np.asarray, rstate))[0]
    for p, t in flatten_with_paths(state)[0].items():
        tol = 1e-6 if p.startswith("params/") or p == "step" else 1e-5
        np.testing.assert_allclose(t.numpy(), want[p], atol=tol, rtol=tol, err_msg=p)


# -- across packages ---------------------------------------------------------------

def _stopped(pid: int, timeout: float = 30.0) -> None:
    """Wait until ``pid`` is stopped (state T in /proc/<pid>/stat)."""
    deadline = time.monotonic() + timeout
    while True:
        with open(f"/proc/{pid}/stat") as f:
            if f.read().rsplit(")", 1)[1].split()[0] in ("T", "t"):
                return
        assert time.monotonic() < deadline, f"proxy {pid} did not stop"
        time.sleep(0.001)


def _parked(proxy, epoch: int, timeout: float = 60.0) -> None:
    """Read the proxy's frames until SYNCED{epoch} is parked in the client
    (left there for ``sync_collect``)."""
    deadline = time.monotonic() + timeout
    while epoch not in proxy._synced:
        assert time.monotonic() < deadline, f"no SYNCED({epoch})"
        try:
            msg = proxy.conn.recv()
        except (socket.timeout, TimeoutError):
            continue
        assert msg is not None, "proxy EOF before its SYNCED"
        proxy._absorb(msg)


def _schedule(cls, fused, order="kill_first"):
    """A kill schedule: epoch and barrier syncs, a SIGKILL with steps in
    flight, an in-flight epoch sync across a second kill.

    Whether the second kill lands before or after the proxy handles that
    sync is the scheduler's to decide, and both are legitimate: the sync
    then comes from the replay, just after the mirror's upload (no step has
    run there, so nothing is prehashed), or from the killed incarnation,
    after its steps (every chunk prehashed with fused digests). ``order``
    forces one: ``"kill_first"`` stops the proxy before the sync is sent
    and kills it stopped; ``"sync_first"`` waits until the sync's ack has
    arrived, kills, and collects the ack before the next step (whose send
    may or may not be the first to see the death)."""
    kw = dict(TIMEOUTS) if cls is ProxyRunner else {"op_timeout_s": 60.0,
                                                   "sync_timeout_s": 60.0}
    r = cls(SPEC, chunk_bytes=256, max_restarts=3, fused_digests=fused, **kw)
    out = []
    r.start()
    try:
        for s in range(1, 6):
            r.step(s)
        out.append(r.sync_state())
        for s in range(6, 9):
            r.step(s)
        r.kill()
        for s in range(9, 11):
            r.step(s)
        out.append(r.sync_state())
        if order == "kill_first":
            os.kill(r.proxy.pid, signal.SIGSTOP)
            _stopped(r.proxy.pid)
        epoch = r.sync_begin()
        r.step(11)
        if order == "sync_first":
            _parked(r.proxy, epoch)
            r.kill()
            out.append(r.sync_collect(epoch))
            r.step(12)
        else:
            r.kill()
            r.step(12)
            out.append(r.sync_collect(epoch))
        out.append(r.sync_state())
        out.append((None, {"restarts": r.restarts}))
    finally:
        r.close()
    return out


def _same_schedule(ref, port, prehashed):
    assert port[-1][1] == ref[-1][1] == {"restarts": 2}
    for (p_state, p_info), (r_state, r_info) in zip(port[:-1], ref[:-1]):
        assert _bytes_equal(p_state, r_state)
        for key in ("step", "digest", "chunks_synced", "bytes_synced", "chunk_digests"):
            assert p_info[key] == r_info[key], key
        assert p_info["phase_us"]["prehashed_chunks"] == r_info["phase_us"]["prehashed_chunks"]
    assert [info["phase_us"]["prehashed_chunks"] for _, info in port[:-1]] == prehashed


@pytest.mark.parametrize("fused", [False, True], ids=["scan", "fused"])
def test_kill_schedule_matches_the_reference_runner(fused):
    """The second kill lands before the proxy handles the in-flight sync."""
    ref, port = _schedule(RefProxyRunner, fused), _schedule(ProxyRunner, fused)
    _same_schedule(ref, port, [8, 8, 0, 8] if fused else [0, 0, 0, 0])


@pytest.mark.parametrize("fused", [False, True], ids=["scan", "fused"])
def test_kill_schedule_after_the_sync_matches_the_reference_runner(fused):
    """The second kill lands after the proxy has handled the in-flight sync."""
    ref = _schedule(RefProxyRunner, fused, "sync_first")
    port = _schedule(ProxyRunner, fused, "sync_first")
    _same_schedule(ref, port, [8, 8, 8, 8] if fused else [0, 0, 0, 0])


def test_reference_image_continues_in_the_port_proxy_and_back(tmp_path):
    """An image written by the reference's proxied trainer restores into the
    port's proxy and trains on to the reference's bits; the port's image
    restores into the reference's proxy the same way."""
    from repro.checkpoint import ChunkStore as RefChunkStore
    from repro.core import CheckpointedTrainer as RefTrainer
    from repro.core import RestoreManager as RefRestore
    from repro_torch.checkpoint import ChunkStore

    ref_prog = ref_make_program(SPEC)
    want = ref_prog.init_state()
    for s in range(1, 13):
        want, _ = ref_prog.step(want, s)

    def run(cls, root, steps, start, **kw):
        t = cls(None, store_root=root, policy=CheckpointPolicy(interval_steps=4),
                chunk_bytes=1 << 10, device_runner="proxy", program=SPEC, **kw)
        state, got_start = t.resume_or(_init_none)
        assert got_start == start
        state = t.run(state, num_steps=steps, start_step=start)
        t.finish()
        return state

    port_kw = {"proxy_opts": TIMEOUTS}
    ref_root, port_root = str(tmp_path / "ref"), str(tmp_path / "port")
    run(RefTrainer, ref_root, 8, 0)
    state = run(CheckpointedTrainer, ref_root, 4, 8, **port_kw)  # port continues
    assert _bytes_equal(state["device"], want)
    run(CheckpointedTrainer, port_root, 8, 0, **port_kw)
    state = run(RefTrainer, port_root, 4, 8)  # reference continues
    assert _bytes_equal(state["device"], want)
    for root in (ref_root, port_root):
        restored, manifest = RefRestore(RefChunkStore(root)).restore()
        assert manifest.step == 12 and _bytes_equal(restored["device"], want)
        restored, manifest = RestoreManager(ChunkStore(root)).restore()
        assert manifest.step == 12 and _bytes_equal(restored["device"], want)


def _upload_states(rng, n, cb):
    """A seeded state and n host dirtyings of it: whole leaves, single
    chunks, chunk lists, nothing at all."""
    state = {
        "w": rng.standard_normal((40, 9)).astype(np.float32),
        "b": rng.standard_normal((7, 5)).astype(np.float32).astype(ml_dtypes.bfloat16),
        "s": np.asarray(3, np.int32),
        "e": np.zeros((0,), np.float32),
        "i": rng.integers(0, 100, (1000,)).astype(np.int8),
    }
    plans = []
    for _ in range(n):
        marks = {}
        for path, leaf in state.items():
            nc = max(1, -(-leaf.nbytes // cb))
            pick = rng.random()
            if pick < 0.25:
                marks[path] = "all"
            elif pick < 0.7:
                marks[path] = sorted(set(rng.integers(0, nc, rng.integers(1, 4)).tolist()))
        plans.append(marks)
    return state, plans


def test_upload_stats_match_the_reference(rng):
    """``upload`` over a seeded sequence of host dirtyings, partial uploads
    included: the port's UploadStats and uploaded bytes are the reference's,
    and the next sync finds every uploaded chunk clean."""
    cb = 64
    state, plans = _upload_states(rng, 6, cb)
    ref_m = RefShadow(chunk_bytes=cb, digest_on_device=False)
    port_m = ShadowStateManager(chunk_bytes=cb)
    ref_state = state
    port_state = {k: (array_to_tensor(v) if v.dtype == ml_dtypes.bfloat16 else v)
                  for k, v in state.items()}
    ref_m.sync(ref_state)
    port_m.sync(port_state)
    for marks in plans:
        # the host writes new bytes into the marked chunks of the shadows
        for path, idx in marks.items():
            nc = ref_m._streams[(path, 0)].n_chunks
            chunks = range(nc) if idx == "all" else idx
            for i in chunks:
                for m in (ref_m, port_m):
                    buf = m._streams[(path, 0)].buffer
                    buf[i * cb: (i + 1) * cb] ^= np.uint8(0x5A)
            for m in (ref_m, port_m):
                if idx == "all":
                    m.mark_host_write(path)
                else:
                    m.mark_host_chunks(path, idx)
        ref_state, want = ref_m.upload(ref_state)
        port_state, got = port_m.upload(port_state)
        assert (got.chunks_uploaded, got.bytes_uploaded, got.leaves_touched,
                got.per_stream) == (want.chunks_uploaded, want.bytes_uploaded,
                                    want.leaves_touched, want.per_stream)
        assert _bytes_equal(port_state, ref_state)
        for key, stream in ref_m._streams.items():
            assert port_m._streams[key].digests == stream.digests, key
        ref_m.mark_device_step()
        port_m.mark_device_step()
        assert port_m.sync(port_state).chunks_fetched == ref_m.sync(ref_state).chunks_fetched == 0


def test_upload_writes_tensors_in_place_and_rebuilds_whole_leaves():
    cb = 16
    t = torch.arange(40, dtype=torch.float32)
    m = ShadowStateManager(chunk_bytes=cb)
    m.sync({"t": t})
    m._streams[("t", 0)].buffer[16:32] = 0
    m.mark_host_chunks("t", [1])
    out, stats = m.upload({"t": t})
    assert out["t"] is t and stats.chunks_uploaded == 1  # patched in place
    assert torch.equal(t[4:8], torch.zeros(4)) and t[8] == 8
    m.mark_host_write("t")
    out, stats = m.upload({"t": t})
    assert out["t"] is not t and torch.equal(out["t"], t)  # rebuilt, same bytes
    assert stats.chunks_uploaded == 10 and stats.bytes_uploaded == 160


def test_register_with_device_capacity_is_refused():
    """A managed budget below one page is refused before any proxy runs
    (managed memory itself is served: tests/test_torch_uvm_proxy.py)."""
    with pytest.raises(ValueError, match="smaller than one page"):
        _runner(device_capacity_bytes=1 << 10, page_bytes=1 << 12)


def test_service_refuses_a_register_frame_with_device_capacity():
    """A REGISTER from elsewhere (the reference's runner sends the field)
    whose budget is below one page is refused by the service itself."""
    from repro_torch.proxy.client import DeviceProxy

    proxy = DeviceProxy(op_timeout_s=TIMEOUTS["op_timeout_s"]).start()
    try:
        proxy.send_program(SPEC)
        with pytest.raises(RuntimeError, match="smaller than one page"):
            proxy.register(layout={}, chunk_bytes=1 << 10,
                           device_capacity_bytes=1 << 10, page_bytes=1 << 12)
    finally:
        proxy.close(graceful=False)


def test_train_cli_proxy_resumes_on_a_second_run(tmp_path, capsys):
    from repro_torch.launch import train

    argv = ["--arch", "qwen2-0.5b", "--smoke", "--batch", "2", "--seq", "16",
            "--ckpt-every", "2", "--device-runner", "proxy", "--device", "cpu",
            "--ckpt-dir", str(tmp_path / "ck"), "--backend", "thread"]
    first = train.train(argv + ["--steps", "4"])
    assert first["final_step"] == 4 and [r.step for r in first["results"]] == [2, 4]
    assert "device_runner=proxy start_step=0" in capsys.readouterr().out
    second = train.train(argv + ["--steps", "6"])
    assert "device_runner=proxy start_step=4" in capsys.readouterr().out
    assert second["final_step"] == 6 and [r.step for r in second["results"]] == [6]
    want = _inline_run(6, ARCH | {"total_steps": 6, "batch": 2, "seq": 16})
    assert tree_equal(second["state"]["device"], want)
    assert np.isfinite(second["metrics"]["loss"])
