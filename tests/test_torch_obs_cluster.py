"""The port's observability and placement modules against the reference.

The first half is the reference's ``tests/obs/test_{journal,watch,live,
leakcheck}.py`` run on ``repro_torch.obs``; the second holds the two
packages to each other on the same inputs: journals written by one parse
in the other, the watchdogs raise the same alerts (the divergence alert
names the same chunk and culprit), the live aggregators keep the same
series, the placement maps make the same assignments, and the coordinator
frames are the same bytes. Everything here is exact: no tolerance.
"""
import json
import os

import numpy as np
import pytest

from repro_torch.obs import journal
from repro_torch.obs import journal as j
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.leakcheck import LeakCheck, ResourceSnapshot
from repro_torch.obs.live import (
    DEFAULT_RING,
    MAX_METRICS_PER_HOST,
    HeartbeatPiggyback,
    LiveAggregator,
    SeriesStore,
    read_snapshot,
)
from repro_torch.obs.watch import (
    ALERT_SCHEMA,
    SEV_CRITICAL,
    SEV_WARNING,
    Alert,
    WatchConfig,
    Watchdog,
)


@pytest.fixture(autouse=True)
def _port_obs_hygiene():
    """The port's tracer and registry are process-global: reset per test."""
    from repro_torch.obs import trace
    from repro_torch.obs.metrics import REGISTRY

    yield
    trace.disable()
    REGISTRY.reset()


# -- the reference's tests/obs/test_journal.py, on the port --------------------

def _roundtrip(tmp_path, event, **fields):
    path = str(tmp_path / "CLUSTER_LOG.jsonl")
    w = j.JournalWriter(path)
    w.write(event, **fields)
    w.close()
    recs = j.read_journal(path)
    assert len(recs) == 1
    return recs[0]


def test_round_roundtrip(tmp_path):
    rec = _roundtrip(
        tmp_path, "round", step=6, status="committed", reason="",
        participants=[0, 1], acked=[0, 1], stragglers=[], commit_s=0.02,
        round_s=0.5, persist_s_max=0.3, bytes_written=4096,
        chunks_synced=4, chunks_clean=12, bytes_skipped=12288,
        sync_us=800.0, digest_us=0.0, fetch_us=120.0, stall_us=40.0,
    )
    assert isinstance(rec, j.RoundLine)
    assert rec.schema == j.JOURNAL_SCHEMA
    assert rec.committed and rec.step == 6 and rec.acked == [0, 1]
    assert rec.bytes_written == 4096 and rec.extra == {}
    assert rec.t > 0


def test_all_other_kinds_roundtrip(tmp_path):
    cases = {
        "join": dict(host=1, pid=4242, restored_from=3, latest_committed=3),
        "death": dict(host=2, reason="heartbeat", latest_committed=3),
        "finished": dict(host=0, step=9, digest="abc123"),
        "shutdown": dict(finished=[0, 1, 2]),
        "proxy_endpoint": dict(name="ph0", addr="127.0.0.1", port=7070),
        "proxy_placement": dict(worker=1, name="ph0", rescheduled=True),
        "proxy_host_death": dict(name="ph0", worker=1),
    }
    path = str(tmp_path / "CLUSTER_LOG.jsonl")
    w = j.JournalWriter(path)
    for event, fields in cases.items():
        w.write(event, **fields)
    w.close()
    recs = j.read_journal(path)
    assert [r.event for r in recs] == list(cases)
    for rec, (event, fields) in zip(recs, cases.items()):
        assert type(rec) is j.RECORD_TYPES[event]
        for k, v in fields.items():
            assert getattr(rec, k) == v, (event, k)
        assert rec.extra == {}


def test_unknown_event_and_fields_are_tolerated(tmp_path):
    path = str(tmp_path / "log.jsonl")
    w = j.JournalWriter(path)
    w.write("someday_event", payload=1)
    w.write("join", host=0, brand_new_field="v1.1")
    w.close()
    generic, join = j.read_journal(path)
    assert type(generic) is j.JournalRecord
    assert generic.extra["payload"] == 1
    assert isinstance(join, j.JoinLine) and join.host == 0
    assert join.extra == {"brand_new_field": "v1.1"}  # reader survives writer v1.1


def test_legacy_schemaless_and_torn_lines(tmp_path):
    path = str(tmp_path / "log.jsonl")
    with open(path, "w") as f:
        # pre-versioning line: no schema, no t
        f.write(json.dumps({"event": "death", "host": 1, "reason": "old"}) + "\n")
        f.write('{"event": "round", "step": 3, "stat')  # SIGKILL tail
    recs = j.read_journal(path)
    assert len(recs) == 1
    assert isinstance(recs[0], j.DeathLine)
    assert recs[0].schema == j.JOURNAL_SCHEMA  # legacy defaults to v1
    assert recs[0].reason == "old"


def test_rounds_helper(tmp_path):
    path = str(tmp_path / "log.jsonl")
    w = j.JournalWriter(path)
    w.write("join", host=0)
    w.write("round", step=2, status="committed")
    w.write("round", step=4, status="aborted", reason="death")
    w.close()
    rs = j.rounds(path)
    assert [r.step for r in rs] == [2, 4]
    assert [r.committed for r in rs] == [True, False]


def test_writer_never_raises_after_close(tmp_path):
    w = j.JournalWriter(str(tmp_path / "log.jsonl"))
    w.close()
    w.write("round", step=1)  # EBADF swallowed
    w.close()                 # idempotent


# -- the reference's tests/obs/test_watch.py, on the port --------------------

def _round(step, status="committed", **kw):
    rec = {"step": step, "status": status, "round_s": 1.0, "stall_us": 0.0,
           "stragglers": [], "reason": ""}
    rec.update(kw)
    return rec


# -- rule by rule ------------------------------------------------------------

def test_happy_path_is_alert_free():
    wd = Watchdog(sampler=lambda: {"supported": True, "fd": 10, "shm": 2})
    for step in (3, 6, 9):
        for h in (0, 1):
            wd.on_heartbeat(h, step)
            wd.on_persist_done(h, step, "digest-same")
        wd.on_round(_round(step))
    for t in range(20):
        wd.tick(now=float(t * 10))
    assert wd.alerts == []
    assert wd.kinds() == set()


def test_stall_ratio_rule():
    wd = Watchdog(WatchConfig(stall_ratio_max=0.5))
    wd.on_round(_round(3, round_s=1.0, stall_us=600_000.0))
    [a] = wd.alerts
    assert a.kind == "stall_ratio" and a.severity == SEV_WARNING
    assert a.value == pytest.approx(0.6)
    assert a.limit == 0.5


def test_round_abort_then_abort_rate_critical():
    wd = Watchdog(WatchConfig(abort_rate_window=3))
    for i in range(3):
        wd.on_round(_round(3, status="aborted", reason=f"boom {i}"))
    kinds = [a.kind for a in wd.alerts]
    assert kinds.count("round_abort") == 3
    assert kinds.count("abort_rate") == 1
    assert wd.critical[0].kind == "abort_rate"
    # a commit resets the streak AND re-arms the critical
    wd.on_round(_round(6))
    wd.on_round(_round(9, status="aborted"))
    assert [a.kind for a in wd.alerts].count("abort_rate") == 1
    for _ in range(2):
        wd.on_round(_round(9, status="aborted"))
    assert [a.kind for a in wd.alerts].count("abort_rate") == 2


def test_straggler_rule():
    wd = Watchdog()
    wd.on_round(_round(3, stragglers=[2]))
    [a] = wd.alerts
    assert a.kind == "straggler" and a.host == 2 and a.step == 3


def test_heartbeat_skew_disabled_by_default():
    wd = Watchdog()
    wd.on_heartbeat(0, 100)
    wd.on_heartbeat(1, 1)
    assert wd.alerts == []


def test_heartbeat_skew_rule_with_rearm():
    wd = Watchdog(WatchConfig(max_step_skew=2))
    wd.on_heartbeat(0, 10)
    wd.on_heartbeat(1, 3)
    [a] = wd.alerts
    assert a.kind == "heartbeat_skew" and a.host == 1 and a.value == 7.0
    wd.on_heartbeat(1, 4)          # still lagging: no duplicate alert
    assert len(wd.alerts) == 1
    wd.on_heartbeat(1, 10)         # caught up: re-armed
    wd.on_heartbeat(0, 20)
    wd.on_heartbeat(1, 10)
    assert len(wd.alerts) == 2


def test_fault_rate_rule():
    wd = Watchdog(WatchConfig(fault_rate_max=100.0))
    wd.on_metric_point(0, "uvm_faults", 1.0, 0.0)
    wd.on_metric_point(0, "uvm_faults", 2.0, 50.0)    # 50/s: fine
    assert wd.alerts == []
    wd.on_metric_point(0, "uvm_faults", 3.0, 1000.0)  # 950/s: spike
    [a] = wd.alerts
    assert a.kind == "fault_rate" and a.host == 0
    # metrics outside the configured set never fire
    wd.on_metric_point(0, "proxy_syncs_total", 4.0, 1e9)
    assert len(wd.alerts) == 1


def test_leak_trend_rule_monotonic_only():
    feed = []
    wd = Watchdog(
        WatchConfig(leak_sample_every_s=0.0, leak_window=3,
                    fd_leak_allowance=2, shm_leak_allowance=1),
        sampler=lambda: feed.pop(0),
    )
    # transient burst that is reclaimed: NOT a leak
    for s in ({"supported": True, "fd": 10, "shm": 0},
              {"supported": True, "fd": 50, "shm": 0},
              {"supported": True, "fd": 10, "shm": 0}):
        feed.append(s)
        wd.tick(now=None)
    assert wd.alerts == []
    # steady climb past the allowance: the leak signature
    for i, s in enumerate(({"supported": True, "fd": 10, "shm": 0},
                           {"supported": True, "fd": 14, "shm": 0},
                           {"supported": True, "fd": 20, "shm": 0})):
        feed.append(s)
        wd.tick(now=None)
    assert "fd_leak_trend" in wd.kinds()


def test_digest_divergence_rule():
    wd = Watchdog()
    wd.on_persist_done(0, 3, "aaaa")
    assert wd.alerts == []            # one host can't diverge
    wd.on_persist_done(1, 3, "bbbb")
    [a] = wd.alerts
    assert a.kind == "digest_divergence" and a.severity == SEV_CRITICAL
    assert a.step == 3
    wd.on_persist_done(2, 3, "cccc")  # same step: alerted once
    assert len(wd.alerts) == 1
    # a missing digest (old worker, inline loop without one) is ignored
    wd.on_persist_done(0, 6, None)
    wd.on_persist_done(1, 6, "")
    assert len(wd.alerts) == 1


def test_digest_state_cleared_at_commit():
    wd = Watchdog()
    wd.on_persist_done(0, 3, "aaaa")
    wd.on_round(_round(3))            # commit settles the round
    wd.on_persist_done(1, 3, "bbbb")  # late/stale ack: fresh bookkeeping
    assert wd.alerts == []


def test_death_rules():
    wd = Watchdog()
    wd.on_heartbeat(0, 5)
    wd.on_death(0, "connection lost (worker death)")
    wd.on_proxy_host_death("ph0", worker=1)
    assert [a.kind for a in wd.alerts] == ["worker_death",
                                           "proxy_host_death"]
    assert all(a.severity == SEV_WARNING for a in wd.alerts)


# -- plumbing ----------------------------------------------------------------

def test_on_alert_callback_and_as_dict():
    got = []
    wd = Watchdog(on_alert=got.append)
    wd.on_death(2, "boom")
    assert got == wd.alerts
    d = got[0].as_dict()
    assert d["kind"] == "worker_death" and d["alert_schema"] == ALERT_SCHEMA
    assert "step" not in d  # Nones dropped from the wire/journal shape


def test_alert_journal_roundtrip(tmp_path):
    path = os.path.join(str(tmp_path), "CLUSTER_LOG.jsonl")
    w = journal.JournalWriter(path)
    alert = Alert("stall_ratio", SEV_WARNING, step=3, value=0.7, limit=0.5,
                  message="sync stall 0.7s vs round 1.0s")
    w.write("alert", **alert.as_dict())
    w.close()
    [line] = journal.alerts(path)
    assert isinstance(line, journal.AlertLine)
    assert line.kind == "stall_ratio" and line.severity == SEV_WARNING
    assert line.step == 3 and line.value == 0.7 and line.limit == 0.5
    assert line.alert_schema == ALERT_SCHEMA
    # typed reader filters alert lines out of a mixed journal
    w2 = journal.JournalWriter(path)
    w2.write("round", step=3, status="committed")
    w2.close()
    assert len(journal.alerts(path)) == 1
    assert len(journal.read_journal(path)) == 2


# -- divergence provenance ---------------------------------------------------

def test_divergence_names_first_forked_chunk_via_baseline():
    wd = Watchdog()
    good = {"b": [333], "w": [111, 222]}
    # a clean committed round records the per-chunk baseline
    wd.on_persist_done(0, 3, "same", chunk_digests=good)
    wd.on_persist_done(1, 3, "same", chunk_digests=good)
    wd.on_round(_round(3))
    assert wd.alerts == []
    # host 1 forks chunk w[1] at the next round
    wd.on_persist_done(0, 6, "aaaa", chunk_digests=good)
    wd.on_persist_done(1, 6, "bbbb",
                       chunk_digests={"b": [333], "w": [111, 999]})
    [a] = wd.alerts
    assert a.kind == "digest_divergence" and a.severity == SEV_CRITICAL
    assert a.chunk == "w" and a.chunk_index == 1
    assert a.host == 1  # named exactly: its digest left the baseline
    assert "first divergent chunk w[1] forked at step 6 on host 1" \
        in a.message


def test_divergence_minority_culprit_without_baseline():
    wd = Watchdog()
    wd.on_persist_done(0, 3, "aaaa", chunk_digests={"w": [1, 2]})
    wd.on_persist_done(1, 3, "aaaa", chunk_digests={"w": [1, 2]})
    wd.on_persist_done(2, 3, "cccc", chunk_digests={"w": [1, 7]})
    [a] = wd.alerts
    assert a.chunk == "w" and a.chunk_index == 1
    assert a.host == 2  # outvoted 2:1 even with no committed baseline


def test_divergence_two_hosts_no_baseline_names_chunk_only():
    wd = Watchdog()
    wd.on_persist_done(0, 3, "aaaa", chunk_digests={"w": [1]})
    wd.on_persist_done(1, 3, "bbbb", chunk_digests={"w": [9]})
    # a 1-vs-1 split is held back in case a further ack breaks the tie;
    # the round decision flushes it with the culprit unresolved
    assert wd.alerts == []
    wd.on_round(_round(3))
    [a] = wd.alerts
    assert a.kind == "digest_divergence"
    assert a.chunk == "w" and a.chunk_index == 0
    assert a.host is None  # 1v1 with no baseline: no culprit to name
    assert "an unidentified host" in a.message


def test_deferred_divergence_resolves_on_late_ack():
    wd = Watchdog()
    wd.on_persist_done(0, 3, "aaaa", chunk_digests={"w": [1]})
    wd.on_persist_done(1, 3, "bbbb", chunk_digests={"w": [9]})
    assert wd.alerts == []  # held: culprit ambiguous at 1v1
    wd.on_persist_done(2, 3, "aaaa", chunk_digests={"w": [1]})
    [a] = wd.alerts  # the third ack outvotes host 1
    assert a.host == 1 and a.chunk == "w"


def test_divergence_without_chunk_tables_keeps_legacy_message():
    wd = Watchdog()
    wd.on_persist_done(0, 3, "aaaa")
    wd.on_persist_done(1, 3, "bbbb")
    [a] = wd.alerts
    assert a.chunk is None and a.chunk_index is None
    assert "hosts disagree on state at step 3" in a.message
    d = a.as_dict()
    assert "chunk" not in d and "chunk_index" not in d  # Nones dropped


def test_chunk_state_popped_at_commit():
    wd = Watchdog()
    wd.on_persist_done(0, 3, "same", chunk_digests={"w": [1]})
    wd.on_persist_done(1, 3, "same", chunk_digests={"w": [1]})
    wd.on_round(_round(3))
    assert wd._chunks == {}
    assert wd._chunk_baseline == {("w", 0): 1}


def test_chunk_alert_journal_roundtrip(tmp_path):
    path = os.path.join(str(tmp_path), "CLUSTER_LOG.jsonl")
    w = journal.JournalWriter(path)
    alert = Alert("digest_divergence", SEV_CRITICAL, host=1, step=6,
                  chunk="w", chunk_index=3, message="forked")
    w.write("alert", **alert.as_dict())
    w.close()
    [line] = journal.alerts(path)
    assert line.chunk == "w" and line.chunk_index == 3 and line.host == 1


def test_default_sampler_excludes_obs_fds():
    from repro_torch.obs import leakcheck

    wd = Watchdog()
    assert wd._sampler is leakcheck.watchdog_sample


def test_clock_skew_rule_rearms():
    """A skewed heartbeat wall clock alerts once, recovers, re-arms."""
    import time as _time

    wd = Watchdog(WatchConfig(max_clock_skew_s=5.0))
    wd.on_heartbeat(0, 1, wt=_time.time() + 60.0)
    [a] = wd.alerts
    assert a.kind == "clock_skew" and a.host == 0
    assert a.value > 5.0 and a.limit == 5.0
    # still skewed: no duplicate while the alert is armed
    wd.on_heartbeat(0, 2, wt=_time.time() + 60.0)
    assert len(wd.alerts) == 1
    # recovered: the rule re-arms…
    wd.on_heartbeat(0, 3, wt=_time.time())
    assert len(wd.alerts) == 1
    # …so a second skew window alerts again
    wd.on_heartbeat(0, 4, wt=_time.time() - 60.0)  # |skew| counts both ways
    assert [x.kind for x in wd.alerts] == ["clock_skew", "clock_skew"]


def test_clock_skew_disabled_by_default():
    import time as _time

    wd = Watchdog()
    wd.on_heartbeat(0, 1, wt=_time.time() + 1e6)
    wd.on_heartbeat(0, 2)  # wt-less heartbeats always fine
    assert wd.alerts == []


def test_tick_returns_the_leak_sample():
    seen = {"n": 0}

    def sampler():
        seen["n"] += 1
        return {"supported": True, "fd": 10 + seen["n"], "shm": 2}

    wd = Watchdog(WatchConfig(leak_sample_every_s=10.0), sampler=sampler)
    s = wd.tick(now=0.0)
    assert s == {"supported": True, "fd": 11, "shm": 2}
    assert wd.tick(now=1.0) is None  # inside the sampling interval
    assert wd.tick(now=20.0)["fd"] == 12


# -- the reference's tests/obs/test_live.py, on the port --------------------

def test_ring_buffer_is_bounded():
    st = SeriesStore(ring=4)
    for i in range(100):
        st.append(0, "m", float(i), float(i))
    pts = st.series(0, "m")
    assert len(pts) == 4
    assert [v for _, v in pts] == [96.0, 97.0, 98.0, 99.0]
    assert st.latest(0, "m") == 99.0


def test_per_host_metric_budget():
    st = SeriesStore(ring=4)
    for i in range(MAX_METRICS_PER_HOST):
        assert st.append(0, f"m{i}", 0.0, 1.0)
    assert not st.append(0, "one_too_many", 0.0, 1.0)
    # other hosts have their own budget
    assert st.append(1, "m0", 0.0, 1.0)
    st.drop_host(0)
    assert st.append(0, "fresh_after_drop", 0.0, 1.0)


def test_snapshot_shape_is_json_ready():
    st = SeriesStore()
    st.append(0, "a", 1.5, 2.0)
    st.append(3, "b", 2.5, 4.0)
    snap = st.snapshot()
    json.dumps(snap)  # must not raise
    assert snap["0"]["a"] == [[1.5, 2.0]]
    assert st.hosts() == [0, 3]
    assert st.metrics(0) == ["a"]


# -- HeartbeatPiggyback ------------------------------------------------------

def test_piggyback_delta_and_seq():
    reg = obs_metrics.Registry()
    pb = HeartbeatPiggyback(reg)
    reg.inc("x", 5)
    p1 = pb.collect()
    assert p1["seq"] == 1 and p1["counters"] == {"x": 5}
    reg.inc("x", 2)
    p2 = pb.collect()
    assert p2["seq"] == 2 and p2["counters"] == {"x": 2}
    # nothing new -> the heartbeat rides bare
    assert pb.collect() is None
    reg.set("g", 7.0)
    p3 = pb.collect()
    assert p3["seq"] == 3 and p3["gauges"] == {"g": 7.0}


def test_piggyback_first_collect_never_none():
    """An idle worker's first beat still announces itself (seq 1)."""
    pb = HeartbeatPiggyback(obs_metrics.Registry())
    p = pb.collect()
    assert p is not None and p["seq"] == 1


def test_piggyback_overflow_defers_not_drops():
    reg = obs_metrics.Registry()
    pb = HeartbeatPiggyback(reg, max_keys=3)
    for i in range(5):
        reg.inc(f"k{i}", i + 1)
    p1 = pb.collect()
    assert len(p1["counters"]) == 3
    p2 = pb.collect()
    # the two deferred keys ride the next beat with their FULL value
    assert set(p1["counters"]) | set(p2["counters"]) == {
        f"k{i}" for i in range(5)
    }
    merged = dict(p1["counters"])
    merged.update(p2["counters"])
    assert merged == {f"k{i}": i + 1 for i in range(5)}


def test_piggyback_rides_in_one_frame():
    """The syscall budget: metrics ride INSIDE the heartbeat's
    framed sendall — one send_frame call, not a second message."""
    import socket

    from repro_torch.coord.protocol import Connection, recv_frame

    class CountingSock:
        def __init__(self, sock):
            self._sock = sock
            self.sends = []

        def sendall(self, data):
            self.sends.append(bytes(data))
            return self._sock.sendall(data)

        def __getattr__(self, name):
            return getattr(self._sock, name)

    a, b = socket.socketpair()
    reg = obs_metrics.Registry()
    reg.inc("x", 3)
    payload = HeartbeatPiggyback(reg).collect()

    wrapped = CountingSock(a)
    conn = Connection(wrapped)
    conn.send("HEARTBEAT", host=0, step=1, metrics=payload)
    assert len(wrapped.sends) == 1  # header + msgpack body in ONE syscall

    got = recv_frame(b)
    assert got["metrics"]["counters"] == {"x": 3}
    a.close(), b.close()


# -- LiveAggregator ----------------------------------------------------------

def test_ingest_accumulates_counter_totals():
    agg = LiveAggregator()
    assert agg.ingest(0, {"seq": 1, "counters": {"x": 5}, "gauges": {}}, t=1.0)
    assert agg.ingest(0, {"seq": 2, "counters": {"x": 2}, "gauges": {}}, t=2.0)
    assert agg.store.latest(0, "x") == 7.0  # running total, not the delta
    assert agg.ingested == 2


def test_ingest_is_idempotent_on_redelivery():
    """The heartbeat-retry path: the same delta applied twice must count
    once — seq dedup, not value heuristics."""
    agg = LiveAggregator()
    payload = {"seq": 1, "counters": {"x": 5}, "gauges": {"g": 1.0}}
    assert agg.ingest(0, payload, t=1.0)
    assert not agg.ingest(0, payload, t=1.1)  # redelivered: dropped
    assert not agg.ingest(0, dict(payload), t=1.2)  # copy too
    assert agg.store.latest(0, "x") == 5.0
    assert len(agg.store.series(0, "x")) == 1
    assert agg.dropped == 2


def test_ingest_reset_host_restarts_seq():
    agg = LiveAggregator()
    agg.ingest(0, {"seq": 5, "counters": {"x": 5}, "gauges": {}}, t=1.0)
    assert not agg.ingest(0, {"seq": 1, "counters": {"x": 1}, "gauges": {}},
                          t=2.0)
    agg.reset_host(0)  # re-JOIN: fresh incarnation restarts at seq 1
    assert agg.ingest(0, {"seq": 1, "counters": {"x": 1}, "gauges": {}},
                      t=3.0)
    # totals restart with the process: 1, not 6
    assert agg.store.latest(0, "x") == 1.0


def test_ingest_survives_garbage():
    agg = LiveAggregator()
    for garbage in (
        None,
        "nope",
        42,
        [],
        {},                                   # no seq
        {"seq": "one"},                       # wrong type
        {"seq": 0},                           # out of range
        {"seq": 1, "counters": "xx", "gauges": 3},
        {"seq": 2, "counters": {1: 2, "ok": "bad", "b": True}},
    ):
        agg.ingest(0, garbage, t=1.0)
    # seq 1 and 2 were consumed by the shape-valid frames; their junk
    # keys were all skipped
    assert agg.store.metrics(0) == []
    assert agg.ingested == 2  # the two with a valid seq applied (empty)
    assert agg.dropped == 6   # None is "no payload", not a drop


def test_snapshot_roundtrip(tmp_path):
    path = str(tmp_path / "live_metrics.json")
    agg = LiveAggregator(snapshot_path=path, snapshot_every_s=0.0)
    agg.ingest(0, {"seq": 1, "counters": {"x": 5}, "gauges": {}}, t=1.0)
    agg.observe(-1, "round_s", 0.5, t=2.0)
    assert agg.write_snapshot() == path
    doc = read_snapshot(path)
    assert doc["schema"] == "crum-live-metrics/1"
    assert doc["series"]["0"]["x"] == [[1.0, 5.0]]
    assert doc["series"]["-1"]["round_s"] == [[2.0, 0.5]]
    assert doc["hosts"] == [-1, 0]

    # torn/corrupt snapshot reads as None, not an exception
    with open(path, "w") as f:
        f.write('{"schema": "crum-li')
    assert read_snapshot(path) is None
    assert read_snapshot(str(tmp_path / "absent.json")) is None


def test_maybe_snapshot_rate_limited(tmp_path):
    path = str(tmp_path / "live.json")
    agg = LiveAggregator(snapshot_path=path, snapshot_every_s=3600.0)
    assert agg.maybe_snapshot(now=100.0) == path
    os.remove(path)
    assert agg.maybe_snapshot(now=101.0) is None  # inside the interval
    assert not os.path.exists(path)
    assert agg.maybe_snapshot(now=4000.0) == path


def test_default_ring_is_sane():
    assert DEFAULT_RING >= 60  # a few minutes at heartbeat cadence


# -- tiered rollups ----------------------------------------------------------

def test_rollup_buckets_fold_and_close():
    s = SeriesStore(ring=8, rollups=(10.0,))
    for i, v in enumerate([1.0, 5.0, 3.0]):
        s.append(0, "fd", 100.0 + i, v)     # all inside bucket 100
    s.append(0, "fd", 112.0, 9.0)           # bucket 110 opens, 100 closes
    pts = s.rollup(0, "fd", 10.0)
    # closed bucket: [t, last, min, max, n]; open bucket rides along
    assert pts == [[100.0, 3.0, 1.0, 5.0, 3], [110.0, 9.0, 9.0, 9.0, 1]]


def test_rollup_open_bucket_is_provisional():
    s = SeriesStore(rollups=(60.0,))
    s.append(1, "x", 30.0, 2.0)
    assert s.rollup(1, "x", 60.0) == [[0.0, 2.0, 2.0, 2.0, 1]]
    s.append(1, "x", 40.0, 7.0)
    assert s.rollup(1, "x", 60.0) == [[0.0, 7.0, 2.0, 7.0, 2]]


def test_rollup_outlives_the_raw_ring():
    """The whole point: a spike the wrapped raw ring forgot is still in
    the rollup's min/max envelope."""
    s = SeriesStore(ring=4, rollups=(10.0,))
    s.append(0, "fd", 100.0, 99.0)          # the spike
    for i in range(8):
        s.append(0, "fd", 111.0 + i, 1.0)   # wraps the 4-point raw ring
    raw = s.series(0, "fd")
    assert len(raw) == 4 and all(v == 1.0 for _, v in raw)
    [closed, _open] = s.rollup(0, "fd", 10.0)
    assert closed[3] == 99.0                # max survived the wrap


def test_rollup_ring_is_bounded():
    s = SeriesStore(rollups=(1.0,), rollup_ring=3)
    for i in range(10):
        s.append(0, "x", float(i), float(i))
    pts = s.rollup(0, "x", 1.0)
    assert len(pts) == 4  # 3 closed (ring) + 1 open
    assert pts[0][0] == 6.0


def test_aggregator_snapshot_carries_rollups():
    agg = LiveAggregator()
    agg.observe(-1, "coord_fd", 10.0, t=5.0)
    agg.observe(-1, "coord_fd", 12.0, t=25.0)
    doc = agg.snapshot()
    pts = doc["rollups"]["10"]["-1"]["coord_fd"]
    assert pts == [[0.0, 10.0, 10.0, 10.0, 1], [20.0, 12.0, 12.0, 12.0, 1]]
    # 60s tier folds both into one (still-open) bucket
    assert doc["rollups"]["60"]["-1"]["coord_fd"] == \
        [[0.0, 12.0, 10.0, 12.0, 2]]


def test_drop_host_drops_rollups():
    s = SeriesStore(rollups=(10.0,))
    s.append(3, "x", 5.0, 1.0)
    s.append(3, "x", 15.0, 2.0)
    s.drop_host(3)
    assert s.rollup(3, "x", 10.0) == []


# -- the reference's tests/obs/test_leakcheck.py, on the port --------------------

needs_proc = pytest.mark.skipif(
    not os.path.isdir("/proc/self/fd"), reason="needs /proc (Linux)"
)


@needs_proc
def test_clean_region_passes(tmp_path):
    with LeakCheck():
        with open(tmp_path / "f", "w") as f:
            f.write("x")  # opened AND closed inside: no growth


@needs_proc
def test_fd_leak_detected_and_named(tmp_path):
    lc = LeakCheck().start()
    leaked = open(tmp_path / "leaky", "w")  # noqa: SIM115
    try:
        with pytest.raises(AssertionError, match="leaky"):
            lc.assert_no_growth("unit")
        d = lc.diff()
        assert d["fd_growth"] >= 1
        assert any("leaky" in s for s in d["new_fds"])
    finally:
        leaked.close()


@needs_proc
def test_tolerance_allows_jitter(tmp_path):
    lc = LeakCheck(tolerance=1).start()
    leaked = open(tmp_path / "one", "w")  # noqa: SIM115
    try:
        lc.stop()
        lc.assert_no_growth()  # 1 fd <= tolerance 1
    finally:
        leaked.close()


@needs_proc
def test_exception_passthrough_skips_assert():
    # a failing drill must surface ITS error, not a secondary leak report
    with pytest.raises(RuntimeError, match="drill failed"):
        with LeakCheck():
            f = open("/dev/null")  # noqa: SIM115
            try:
                raise RuntimeError("drill failed")
            finally:
                f.close()


def test_unsupported_platform_degrades_to_noop(monkeypatch):
    import repro_torch.obs.leakcheck as lk

    monkeypatch.setattr(lk, "_FD_DIR", "/nonexistent-proc/fd")
    monkeypatch.setattr(lk, "_SHM_DIR", "/nonexistent-shm")
    snap = ResourceSnapshot.capture()
    assert not snap.supported
    with LeakCheck():
        pass  # no false failure without /proc


# -- obs-owned fd exclusion (the watchdog's trend sampler) -------------------

def test_is_obs_fd_patterns():
    from repro_torch.obs.leakcheck import _is_obs_fd

    assert _is_obs_fd("/run/obs/trace-worker-123.jsonl")
    assert _is_obs_fd("/run/obs/metrics-app-9.json")
    assert _is_obs_fd("/run/CLUSTER_LOG.jsonl")
    assert _is_obs_fd("/run/obs/live_metrics.json.tmp")
    assert _is_obs_fd("/run/obs/merged.trace.json")
    assert _is_obs_fd("/run/obs/trace-app-1.jsonl (deleted)")
    assert not _is_obs_fd("/ckpt/step-3/data-h0000.bin")
    assert not _is_obs_fd("socket:[123456]")
    assert not _is_obs_fd("/dev/shm/crum-arena-1")


@needs_proc
def test_sample_exclude_obs_counts_and_excludes(tmp_path):
    from repro_torch.obs.leakcheck import sample, watchdog_sample

    held = open(tmp_path / "trace-app-4242.jsonl", "w")  # noqa: SIM115
    data = open(tmp_path / "data-h0000.bin", "w")  # noqa: SIM115
    try:
        s = sample(exclude_obs=True)
        assert s["supported"] and s["fd_obs"] >= 1
        # the obs fd is excluded from the trend-facing count
        assert s["fd"] >= 1
        w = watchdog_sample()
        assert "fd_obs" in w  # the watchdog default is the excluding one
    finally:
        held.close()
        data.close()
    # plain sample() keeps the legacy shape: no fd_obs key
    assert "fd_obs" not in sample()


# -- the two packages on the same inputs ----------------------------------------


def _strip_t(rec):
    d = dict(vars(rec))
    d.pop("t")
    return d


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_journal_lines_parse_the_same_in_both_packages(tmp_path, writer):
    import importlib

    from repro.obs import journal as ref_journal

    w_mod = importlib.import_module(f"{writer}.obs.journal")
    path = str(tmp_path / "CLUSTER_LOG.jsonl")
    w = w_mod.JournalWriter(path)
    w.write("join", host=1, pid=42, restored_from=2, latest_committed=2)
    w.write("round", step=4, status="aborted", reason="host 1 lost",
            participants=[0, 1], acked=[0], sync_us=12.5, extra_field=7)
    w.write("alert", kind="digest_divergence", severity="critical", host=1,
            step=4, chunk="device/w", chunk_index=3, alert_schema="crum-alert/1")
    w.write("finished", host=0, step=6, digest="abc")
    w.write("mystery", payload=[1, 2])
    w.close()
    mine = journal.read_journal(path)
    ref = ref_journal.read_journal(path)
    assert [type(r).__name__ for r in mine] == [type(r).__name__ for r in ref]
    assert [_strip_t(r) for r in mine] == [_strip_t(r) for r in ref]


def _watch_feed(mod):
    """One fixed sequence of coordinator signals through a package's
    watchdog; returns its alerts as dicts."""
    w = mod.Watchdog(mod.WatchConfig(max_step_skew=2, max_clock_skew_s=5.0,
                                     abort_rate_window=2),
                     sampler=lambda: {"supported": False, "fd": 0, "shm": 0})
    w.on_heartbeat(0, 5, wt=None)
    w.on_heartbeat(1, 1, wt=None)
    w.on_round({"step": 2, "status": "committed", "round_s": 1.0,
                "stall_us": 900000.0, "stragglers": [1]})
    w.on_death(1, "heartbeat timeout (worker stalled)")
    w.on_round({"step": 4, "status": "aborted", "reason": "host 1 lost",
                "round_s": 0.5, "stall_us": 0.0, "stragglers": []})
    w.on_round({"step": 4, "status": "aborted", "reason": "host 1 lost",
                "round_s": 0.5, "stall_us": 0.0, "stragglers": []})
    chunks = {"device/b": [1, 2], "device/w": [5, 6, 7, 8]}
    forked = {"device/b": [1, 2], "device/w": [5, 6, 70, 80]}
    w.on_persist_done(0, 6, "aaaa", chunk_digests=chunks)
    w.on_persist_done(1, 6, "bbbb", chunk_digests=forked)
    w.on_persist_done(2, 6, "aaaa", chunk_digests=chunks)
    return [a.as_dict() for a in w.alerts]


def test_watchdogs_raise_the_same_alerts():
    from repro.obs import watch as ref_watch
    from repro_torch.obs import watch as port_watch

    mine, ref = _watch_feed(port_watch), _watch_feed(ref_watch)
    assert mine == ref
    div = [a for a in mine if a["kind"] == "digest_divergence"]
    assert div and div[0]["chunk"] == "device/w" and div[0]["chunk_index"] == 2
    assert div[0]["host"] == 1  # the culprit: the minority copy


def test_live_aggregators_keep_the_same_series(tmp_path):
    from repro.obs import live as ref_live
    from repro_torch.obs import live as port_live

    payloads = [
        (0, {"seq": 1, "counters": {"x": 5}, "gauges": {"g": 1.5}}, 1.0),
        (0, {"seq": 1, "counters": {"x": 5}, "gauges": {"g": 1.5}}, 1.5),
        (1, {"seq": 1, "counters": {"x": 2, "y": 1}, "gauges": {}}, 2.0),
        (0, {"seq": 2, "counters": {"x": 1}, "gauges": {"g": -3.0}}, 12.0),
        (1, {"seq": "bad", "counters": {"x": 2}}, 13.0),
        (1, {"seq": 2, "counters": {"x": float("nan")}, "gauges": {}}, 14.0),
    ]
    snaps = []
    for mod in (port_live, ref_live):
        agg = mod.LiveAggregator()
        accepted = [agg.ingest(h, p, t=t) for h, p, t in payloads]
        snap = agg.snapshot()
        snap.pop("t", None)
        snaps.append((accepted, json.loads(json.dumps(snap, default=str))))
    assert snaps[0] == snaps[1]


def test_leak_samplers_agree_on_obs_fds_and_trends():
    from repro.obs import leakcheck as ref_lk
    from repro_torch.obs import leakcheck as port_lk

    names = ["/run/x/CLUSTER_LOG.jsonl", "/t/trace-worker0.json",
             "/t/metrics-launcher.json", "/t/live_metrics.json.tmp",
             "socket:[123]", "/dev/shm/seg-1", "/t/data-h0000.bin (deleted)"]
    assert [port_lk._is_obs_fd(n) for n in names] == [ref_lk._is_obs_fd(n) for n in names]
    seq = [3, 4, 4, 6, 9, 9, 8, 10]
    out = []
    for mod in (port_lk, ref_lk):
        it = iter(seq)
        audit = mod.PeriodicAudit(interval_s=1.0, window=4, sampler=lambda: {
            "supported": True, "fd": next(it), "shm": 0})
        trends = []
        for t in range(len(seq)):
            audit.maybe_sample(now=float(t))
            trends.append(audit.trend("fd"))
        out.append(trends)
    assert out[0] == out[1]


def test_placement_maps_make_the_same_assignments():
    from repro.remote import placement as ref_pl
    from repro_torch.remote import placement as port_pl

    def drive(mod):
        pm = mod.PlacementMap()
        for i in range(3):
            pm.register(f"ph{i}", "127.0.0.1", 7000 + i)
        got = [pm.assign(w).name for w in range(5)]
        pm.report_dead("ph1")
        got += [pm.assign(w).name for w in range(5)]
        got.append(pm.assign(9, exclude=("ph0",)).name)
        return got, list(pm.history)

    assert drive(port_pl) == drive(ref_pl)


def test_coordinator_frames_are_the_reference_bytes():
    import socket

    from repro.coord import protocol as ref_proto
    from repro_torch.coord import protocol as port_proto

    names = [n for n in dir(ref_proto) if n.startswith("MSG_")]
    assert len(names) == 13
    assert {n: getattr(port_proto, n) for n in names} == \
        {n: getattr(ref_proto, n) for n in names}
    fields = dict(host=1, step=4, hostmeta="hostmeta-h0001.msgpack",
                  persist_s=0.25, blocking_s=0.125, bytes_written=1 << 33,
                  state_digest="f8502988d9d4765a",
                  chunk_digests={"device/w": [2**64 - 1, 0, 12345]},
                  ctx={"trace": "round:4", "span": 99, "parent": 7})
    wire = []
    for proto in (port_proto, ref_proto):
        a, b = socket.socketpair()
        proto.Connection(a).send(proto.MSG_PERSIST_DONE, **fields)
        a.close()
        data = b""
        while chunk := b.recv(1 << 16):
            data += chunk
        b.close()
        wire.append(data)
    assert wire[0] == wire[1]
    a, b = socket.socketpair()
    a.sendall(wire[1])
    assert port_proto.recv_frame(b) == {"type": "PERSIST_DONE", **fields}
    a.close(), b.close()


def test_round_span_ids_agree():
    from repro.obs import trace as ref_trace
    from repro_torch.obs import trace as port_trace

    for step in (0, 2, 4, 1 << 40):
        tid = port_trace.round_trace_id(step)
        assert tid == ref_trace.round_trace_id(step)
        assert port_trace.root_span_id(tid) == ref_trace.root_span_id(tid)
    assert np.all([port_trace.root_span_id(f"round:{s}") & 1 for s in range(64)])
