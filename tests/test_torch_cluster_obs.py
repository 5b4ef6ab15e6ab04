"""The port's coordinator live plane and round records.

The reference's ``tests/coord/test_heartbeat_metrics.py`` (HEARTBEAT
metrics piggyback vs a live Coordinator: torn frames, oversized frames,
idempotent redelivery, end-to-end ingestion) and
``tests/coord/test_round_sync_stats.py`` (per-round incremental sync stats
in CLUSTER_LOG.jsonl) on ``repro_torch``, then the per-rank phase times,
digest launches and lockstep-witness time that ride each PERSIST_DONE.
"""
import json
import queue
import socket
import struct
import threading
import time

import pytest

from repro_torch.coord import protocol
from repro_torch.coord.coordinator import Coordinator
from repro_torch.coord.supervisor import run_cluster


@pytest.fixture
def coord(tmp_path):
    c = Coordinator(str(tmp_path / "root"), n_hosts=1).start()
    stop = threading.Event()

    def pump():
        while not stop.is_set():
            try:
                kind, conn, frame = c._inbox.get(timeout=0.05)
            except queue.Empty:
                continue
            if kind == "eof":
                c._on_eof(conn)
            else:
                c._dispatch(conn, frame)

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    try:
        yield c
    finally:
        stop.set()
        t.join(timeout=5)
        c.close()


def _join(coord, host=0):
    conn = protocol.connect(coord.address, timeout=5)
    conn.settimeout(5)
    conn.send(protocol.MSG_JOIN, host=host, pid=1234, restored_from=None)
    welcome = conn.recv()
    assert welcome["type"] == protocol.MSG_WELCOME
    return conn


def _wait(cond, timeout=5.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if cond():
            return True
        time.sleep(0.01)
    return False


def _beat(conn, host, step, payload):
    conn.send(protocol.MSG_HEARTBEAT, host=host, step=step,
              metrics=payload)


def test_piggyback_lands_in_store_end_to_end(coord):
    conn = _join(coord)
    _beat(conn, 0, 1, {"seq": 1, "counters": {"proxy_syncs_total": 2},
                       "gauges": {"uvm_faults": 7}})
    assert _wait(lambda: coord.live.store.latest(0, "proxy_syncs_total")
                 == 2.0)
    assert coord.live.store.latest(0, "uvm_faults") == 7.0
    # second delta accumulates into the running total
    _beat(conn, 0, 2, {"seq": 2, "counters": {"proxy_syncs_total": 3},
                       "gauges": {}})
    assert _wait(lambda: coord.live.store.latest(0, "proxy_syncs_total")
                 == 5.0)
    conn.close()


def test_redelivered_delta_is_idempotent(coord):
    """The retry path: one delta delivered twice must count once."""
    conn = _join(coord)
    payload = {"seq": 1, "counters": {"x": 5}, "gauges": {}}
    _beat(conn, 0, 1, payload)
    _beat(conn, 0, 1, payload)  # redelivery (same seq, same content)
    assert _wait(lambda: coord.live.store.latest(0, "x") == 5.0)
    time.sleep(0.1)  # let the duplicate drain through the pump
    assert coord.live.store.latest(0, "x") == 5.0
    assert len(coord.live.store.series(0, "x")) == 1
    assert coord.live.dropped >= 1
    conn.close()


def test_rejoin_resets_seq_tracking(coord):
    conn = _join(coord)
    _beat(conn, 0, 1, {"seq": 7, "counters": {"x": 5}, "gauges": {}})
    assert _wait(lambda: coord.live.store.latest(0, "x") == 5.0)
    conn.close()
    # a respawned incarnation starts its piggyback back at seq 1
    conn2 = _join(coord)
    _beat(conn2, 0, 1, {"seq": 1, "counters": {"x": 2}, "gauges": {}})
    assert _wait(lambda: coord.live.store.latest(0, "x") == 2.0)
    conn2.close()


def test_torn_frame_is_eof_not_poison(coord):
    """A worker SIGKILLed mid-send leaves a partial frame; the
    length-prefixed reader turns it into EOF, never a parsed frame."""
    good = _join(coord)
    _beat(good, 0, 1, {"seq": 1, "counters": {"a": 1}, "gauges": {}})
    assert _wait(lambda: coord.live.store.latest(0, "a") == 1.0)

    raw = socket.create_connection(coord.address, timeout=5)
    raw.sendall(struct.pack("<I", 100) + b"\x93\x01")  # 100 promised, 2 sent
    raw.close()

    # the coordinator shrugged: the good connection still ingests
    _beat(good, 0, 2, {"seq": 2, "counters": {"a": 1}, "gauges": {}})
    assert _wait(lambda: coord.live.store.latest(0, "a") == 2.0)
    assert coord.live.ingested == 2
    good.close()


def test_oversized_frame_is_rejected_not_buffered(coord):
    """A corrupt/hostile length header must not make the coordinator
    allocate or stall — the reader raises and the connection dies."""
    good = _join(coord)
    raw = socket.create_connection(coord.address, timeout=5)
    raw.sendall(struct.pack("<I", protocol.MAX_FRAME + 1) + b"x" * 64)
    # reader thread hits ValueError -> eof; peer sees the close
    raw.settimeout(5)
    assert raw.recv(1) == b""  # coordinator closed it
    raw.close()

    _beat(good, 0, 1, {"seq": 1, "counters": {"b": 3}, "gauges": {}})
    assert _wait(lambda: coord.live.store.latest(0, "b") == 3.0)
    good.close()


def test_garbage_metrics_payload_never_kills_dispatch(coord):
    conn = _join(coord)
    for step, payload in enumerate(
        ("nonsense", {"seq": "x"}, {"seq": -1}, [1, 2], 9.5), start=1
    ):
        _beat(conn, 0, step, payload)
    _beat(conn, 0, 9, {"seq": 1, "counters": {"ok": 1}, "gauges": {}})
    assert _wait(lambda: coord.live.store.latest(0, "ok") == 1.0)
    assert coord.live.dropped >= 4
    conn.close()


def test_heartbeat_without_metrics_still_beats(coord):
    """Bare heartbeats (nothing new to report) stay valid liveness."""
    conn = _join(coord)
    conn.send(protocol.MSG_HEARTBEAT, host=0, step=3)
    _beat(conn, 0, 4, {"seq": 1, "counters": {}, "gauges": {}})
    assert _wait(lambda: coord.live.ingested == 1)
    assert 0 not in coord.monitor.dead_hosts()
    conn.close()


def _round_records(log_path):
    with open(log_path) as f:
        return [json.loads(line) for line in f
                if json.loads(line).get("event") == "round"]


@pytest.mark.integration
def test_round_records_carry_incremental_sync_stats(tmp_path):
    root = str(tmp_path / "cluster")
    report = run_cluster(
        root=root, n_hosts=2, total_steps=4, ckpt_every=2,
        backend="thread", loop="numpy", device="cpu", deadline_s=180.0,
    )
    assert [r.step for r in report.committed] == [2, 4]
    rounds = _round_records(report.log_path)
    committed = [r for r in rounds if r["status"] == "committed"]
    assert len(committed) == 2
    for rec in committed:
        # the new fields are present and aggregated over both hosts
        assert {"chunks_synced", "chunks_clean", "bytes_skipped"} <= set(rec)
        assert rec["chunks_synced"] > 0  # something moved each round
    first, second = committed
    # round 2's sync diffs against round 1's shadow: with a numpy_sgd
    # state where every chunk changes each step the clean count may be 0,
    # but the accounting identity must hold per round
    for rec in committed:
        assert rec["chunks_synced"] >= 0 and rec["chunks_clean"] >= 0
        assert rec["bytes_skipped"] >= 0
    # in-memory RoundRecord mirrors the journal
    assert report.committed[0].chunks_synced == first["chunks_synced"]
    assert report.committed[1].bytes_skipped == second["bytes_skipped"]


@pytest.mark.integration
def test_acks_carry_per_rank_phases_launches_and_witness(tmp_path):
    """Each committed round keeps every rank's PERSIST_DONE: phase-1 and
    persist times, the rank's kernel launches over the window's steps, for
    the provenance table and in the shadow sync (all 0 here: CPU tensors
    take the host oracle), the lockstep witness and its time; the
    journal's round record sums the ranks'."""
    report = run_cluster(
        root=str(tmp_path / "cluster"), n_hosts=2, total_steps=4, ckpt_every=2,
        backend="fork", loop="torch", device="cpu", deadline_s=180.0,
    )
    assert len(report.acks) == 2
    rounds = _round_records(report.log_path)
    for acks, rec in zip(report.acks, [r for r in rounds if r["status"] == "committed"]):
        assert sorted(acks) == [0, 1]
        for a in acks.values():
            assert a["blocking_s"] > 0 and a["persist_s"] > 0
            assert a["step_launches"] == {"chunk_digest": 0, "flash_attention": 0}
            assert a["provenance_launches"] == 0 and a["sync_launches"] == 0
            assert a["state_digest_s"] >= 0 and len(a["state_digest"]) == 16
        assert rec["chunks_synced"] == sum(a["chunks_synced"] for a in acks.values())
        assert rec["bytes_written"] == sum(a["bytes_written"] for a in acks.values())
        assert len({a["state_digest"] for a in acks.values()}) == 1
