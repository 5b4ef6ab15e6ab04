"""PyTorch port: the run-dir reporter and the critical-path analysis.

Twins of ``tests/obs/test_report.py`` and ``tests/obs/test_critpath.py``.
``repro_torch.obs.{report,critpath}`` are framework-free copies that read
the shards, journals and metric dumps both packages write, so each twin
runs the reference's function on the same run dir as its oracle and holds
the port's result equal to it, beside the reference test's own checks. The
cluster cases run the port's ranks (torch processes) on the CPU.
"""
import json
import os

import pytest

from repro.obs import critpath as rcritpath
from repro.obs import report as rreport
from repro_torch.obs import critpath, report, trace
from repro_torch.obs.journal import JournalWriter
from repro_torch.obs.trace import root_span_id


@pytest.fixture(autouse=True)
def _obs_hygiene():
    """The port's tracer and registry are process-global: reset per test."""
    from repro_torch.obs.metrics import REGISTRY

    yield
    trace.disable()
    REGISTRY.reset()


def _same_analysis(run, **kw):
    """The port's critpath document, held equal to the reference's."""
    doc = critpath.analyze(run, **kw)
    assert doc == rcritpath.analyze(run, **kw)
    assert critpath.check(doc) == rcritpath.check(doc)
    return doc


# -- the reporter ---------------------------------------------------------------


def _write_shard(run_dir, process, pid, events, torn_tail=False):
    path = os.path.join(run_dir, f"trace-{process}-{pid}.jsonl")
    with open(path, "w") as f:
        f.write(json.dumps({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "ts": 0, "args": {"name": f"{process}:{pid}"},
        }) + "\n")
        for ev in events:
            f.write(json.dumps({"pid": pid, "tid": 1, **ev}) + "\n")
        if torn_tail:
            f.write('{"name": "torn", "ph": "i", "ts"')  # SIGKILL mid-write
    return path


def _mk_run(tmp_path):
    run_dir = str(tmp_path / "obs")
    os.makedirs(run_dir)
    _write_shard(run_dir, "app", 100, [
        {"name": "app.step", "ph": "X", "ts": 1000, "dur": 500,
         "args": {"step": 1}},
        {"name": "app.step", "ph": "X", "ts": 2000, "dur": 700,
         "args": {"step": 2}},
        {"name": "app.sync_stall", "ph": "X", "ts": 2800, "dur": 300,
         "args": {"epoch": 1}},
    ], torn_tail=True)
    _write_shard(run_dir, "proxy", 200, [
        {"name": "proxy.step", "ph": "X", "ts": 1100, "dur": 400,
         "args": {"step": 1, "inc": 0}},
        {"name": "proxy.respawn", "ph": "B", "ts": 3000, "args": {}},
        {"name": "proxy.respawn", "ph": "E", "ts": 3900},
    ])
    with open(os.path.join(run_dir, "metrics-app-100.json"), "w") as f:
        json.dump({"process": "app", "counters": {"proxy_restarts": 1},
                   "gauges": {"uvm_faults": 6}}, f)
    with open(os.path.join(run_dir, "metrics-proxy-200.json"), "w") as f:
        json.dump({"process": "proxy", "counters": {"proxy_restarts": 0},
                   "gauges": {"uvm_faults": 4}}, f)
    w = JournalWriter(os.path.join(run_dir, "CLUSTER_LOG.jsonl"))
    w.write("round", step=2, status="committed", bytes_written=99)
    w.close()
    return run_dir


def test_merge_produces_perfetto_doc(tmp_path):
    run_dir = _mk_run(tmp_path)
    out, events, metrics = report.merge(run_dir)
    with open(out) as f:
        doc = json.load(f)
    ref_out, ref_events, ref_metrics = rreport.merge(
        run_dir, out=os.path.join(run_dir, "ref.trace.json"))
    with open(ref_out) as f:
        assert json.load(f) == doc
    assert doc["displayTimeUnit"] == "ms"
    assert doc["otherData"]["schema"] == "crum-trace/1"
    assert len(doc["otherData"]["shards"]) == 2
    names = [e["name"] for e in doc["traceEvents"]]
    assert "app.step" in names and "proxy.step" in names
    # journal became instants on the synthetic track
    jevs = [e for e in doc["traceEvents"] if e["name"] == "journal.round"]
    assert jevs and jevs[0]["pid"] == report.JOURNAL_PID
    assert jevs[0]["args"]["bytes_written"] == 99
    # no leftover internal keys; events sorted by ts
    assert all("_shard" not in e for e in doc["traceEvents"])
    ts = [e["ts"] for e in doc["traceEvents"]]
    assert ts == sorted(ts)
    # torn tail skipped, no "torn" event
    assert "torn" not in names


def test_metrics_merged_across_processes(tmp_path):
    run_dir = _mk_run(tmp_path)
    m = report.merge_metrics(run_dir)
    assert m == rreport.merge_metrics(run_dir)
    assert m["counters"]["proxy_restarts"] == 1
    assert m["gauges"]["uvm_faults"] == 10  # summed per process
    assert sorted(m["processes"]) == ["app", "proxy"]


_VALIDATE_CASES = {
    "valid": ([
        {"name": "a", "ph": "B", "ts": 1, "pid": 1, "tid": 1},
        {"name": "a", "ph": "E", "ts": 2, "pid": 1, "tid": 1},
        {"name": "x", "ph": "X", "ts": 1, "dur": 5, "pid": 1, "tid": 1},
    ], None),
    "orphan_e": ([{"name": "a", "ph": "E", "ts": 2, "pid": 1, "tid": 1}],
                 "orphaned E"),
    "unclosed_b": ([{"name": "a", "ph": "B", "ts": 1, "pid": 1, "tid": 1}],
                   "unclosed B"),
    "no_dur": ([{"name": "x", "ph": "X", "ts": 1, "pid": 1, "tid": 1}],
               "without numeric dur"),
    "bad_ph": ([{"name": "x", "ph": "Z", "ts": 1, "pid": 1, "tid": 1}],
               "unknown phase"),
    # nesting is PER (pid, tid): interleaved tracks don't false-positive
    "two_tracks": ([
        {"name": "a", "ph": "B", "ts": 1, "pid": 1, "tid": 1},
        {"name": "b", "ph": "B", "ts": 2, "pid": 2, "tid": 1},
        {"name": "a", "ph": "E", "ts": 3, "pid": 1, "tid": 1},
        {"name": "b", "ph": "E", "ts": 4, "pid": 2, "tid": 1},
    ], None),
}


def test_validate_catches_orphans_and_malformed():
    for events, problem in _VALIDATE_CASES.values():
        got = report.validate_events(events)
        assert got == rreport.validate_events(events)
        if problem is None:
            assert got == []
        else:
            assert any(problem in p for p in got), got


def test_summary_derives_ratios(tmp_path):
    run_dir = _mk_run(tmp_path)
    _, events, metrics = report.merge(run_dir)
    text = report.summarize(events, metrics)
    assert text == rreport.summarize(events, metrics)
    assert "app.step" in text and "p99_us" in text
    # stall ratio = 300 / (500 + 700)
    assert "stall_ratio" in text and "0.25" in text
    assert "uvm_faults_per_step" in text
    assert "proxy_restarts" in text


def test_missing_and_corrupt_metric_shards_named(tmp_path, capsys):
    """A SIGKILLed process leaves a trace shard but no metrics dump (or a
    torn one); the reporter proceeds and NAMES the gap instead of dying."""
    run_dir = _mk_run(tmp_path)
    # killed-rank signature: traced, but no metrics twin
    _write_shard(run_dir, "worker3", 333, [
        {"name": "app.step", "ph": "X", "ts": 100, "dur": 5, "args": {}},
    ])
    # torn metrics dump (SIGKILL mid-replace)
    with open(os.path.join(run_dir, "metrics-worker4-444.json"), "w") as f:
        f.write('{"process": "worker4", "counters": {"x"')
    m = report.merge_metrics(run_dir)
    assert m == rreport.merge_metrics(run_dir)
    assert m["missing_metrics"] == ["worker3-333"]
    assert m["corrupt_metrics"] == ["metrics-worker4-444.json"]
    # surviving shards still merged
    assert m["counters"]["proxy_restarts"] == 1
    # gaps surface in the text summary and --check still passes
    _, events, metrics = report.merge(run_dir)
    text = report.summarize(events, metrics)
    assert "MISSING metric shards" in text and "worker3-333" in text
    assert "CORRUPT metric shards" in text
    assert report.main([run_dir, "--check"]) == 0


def test_summary_json_artifact(tmp_path):
    run_dir = _mk_run(tmp_path)
    out = os.path.join(run_dir, "summary.json")
    ref = os.path.join(run_dir, "ref-summary.json")
    assert report.main([run_dir, "--summary-json", out]) == 0
    assert rreport.main([run_dir, "--summary-json", ref]) == 0
    with open(out) as f:
        doc = json.load(f)
    with open(ref) as f:
        assert json.load(f) == doc
    assert doc["schema"] == "crum-obs-summary/1"
    assert doc["spans"]["app.step"]["count"] == 2
    assert doc["derived"]["stall_ratio"] == 0.25
    # proxy.step wins the step count (1 event); faults sum to 10
    assert doc["derived"]["uvm_faults_per_step"] == 10.0
    assert doc["counters"]["proxy_restarts"] == 1
    assert doc["missing_metrics"] == [] and doc["corrupt_metrics"] == []
    # the dict and the text come from one source
    text = report.summarize(*report.merge(run_dir)[1:])
    assert "stall_ratio" in text


def test_cli_check_mode(tmp_path, capsys):
    run_dir = _mk_run(tmp_path)
    assert report.main([run_dir, "--check"]) == 0
    out = capsys.readouterr().out
    assert "trace validation OK" in out
    assert os.path.exists(os.path.join(run_dir, "merged.trace.json"))

    # an invalid shard (unclosed B) must fail --check, in both packages
    _write_shard(run_dir, "bad", 300, [
        {"name": "never.closed", "ph": "B", "ts": 1, "args": {}},
    ])
    assert report.main([run_dir, "--check"]) == 1
    assert rreport.main([run_dir, "--check"]) == 1

    assert report.main([str(tmp_path / "nope"), "--check"]) == 2


# -- critical path ----------------------------------------------------------------

T0 = 100_000_000.0  # µs wall; the journal line below says t=100.0009 s
ROOT = root_span_id("round:3")
TRACE = "round:3"


def _ev(name, ph, ts, pid=1, tid=1, **kw):
    ev = {"name": name, "ph": ph, "ts": ts, "pid": pid, "tid": tid}
    ev.update(kw)
    return ev


def _round_events():
    """One committed round: coord root, one rank subtree, commit."""
    a = dict  # arg-dict shorthand
    return [
        _ev("coord.round", "B", T0, pid=1,
            args=a(step=3, trace=TRACE, span=ROOT)),
        _ev("worker.round", "X", T0 - 20, dur=1010, pid=2,
            args=a(step=3, host=0, trace=TRACE, span=10, parent=ROOT)),
        _ev("proxy.step", "X", T0 + 10, dur=200, pid=3,
            args=a(step=3, trace=TRACE, span=11, parent=10)),
        _ev("app.sync_stall", "X", T0 + 220, dur=80, pid=2,
            args=a(trace=TRACE, span=12, parent=10)),
        _ev("ckpt.phase1", "X", T0 + 300, dur=100, pid=2,
            args=a(step=3, trace=TRACE, span=13, parent=10)),
        _ev("ckpt.persist", "X", T0 + 400, dur=400, pid=2,
            args=a(step=3, trace=TRACE, span=14, parent=13)),
        _ev("coord.commit", "X", T0 + 850, dur=100, pid=1,
            args=a(step=3, trace=TRACE, span=90, parent=ROOT)),
        _ev("coord.round", "E", T0 + 1000, pid=1),
    ]


def _write_run(tmp_path, events, journal_lines):
    run = str(tmp_path / "obs")
    os.makedirs(run, exist_ok=True)
    with open(os.path.join(run, "trace-app-1.jsonl"), "w") as f:
        for ev in events:
            f.write(json.dumps(ev) + "\n")
    with open(os.path.join(run, "CLUSTER_LOG.jsonl"), "w") as f:
        for line in journal_lines:
            f.write(json.dumps(line) + "\n")
    return run


def _journal_round(step=3, status="committed", t=100.0009, round_s=0.001):
    return {"schema": "crum-cluster-log/1", "event": "round", "t": t,
            "step": step, "status": status, "round_s": round_s}


def test_root_span_ids_match_the_reference():
    from repro.obs.trace import root_span_id as ref_root

    for step in (0, 3, 4096):
        tid = trace.round_trace_id(step)
        assert root_span_id(tid) == ref_root(tid)


def test_build_spans_closes_be_pairs_and_marks_unclosed():
    events = [
        _ev("worker.round", "B", 10.0, args={"span": 1, "trace": "t"}),
        _ev("worker.round", "E", 30.0),
        _ev("coord.round", "B", 5.0, pid=2,
            args={"span": 2, "trace": "t"}),  # SIGKILL: never closed
        _ev("ckpt.persist", "X", 12.0, dur=6.0,
            args={"span": 3, "parent": 1, "trace": "t"}),
        _ev("coord.ack", "i", 20.0, pid=2,
            args={"span": 4, "parent": 1, "trace": "t"}),
        _ev("untagged", "i", 21.0, args={}),  # no ctx: not a tree node
    ]
    spans = critpath.build_spans(events)
    assert spans == rcritpath.build_spans(events)
    by = {s["span"]: s for s in spans if s["span"] is not None}
    assert by[1]["end"] == 30.0 and not by[1]["incomplete"]
    assert by[2]["end"] is None and by[2]["incomplete"]
    assert by[3]["end"] == 18.0
    assert by[4]["ts"] == by[4]["end"] == 20.0  # instants are zero-dur
    assert len(spans) == 4  # the ctx-less instant never becomes a span


def test_committed_round_is_rooted_and_phases_sum_to_span(tmp_path):
    run = _write_run(tmp_path, _round_events(), [_journal_round()])
    doc = _same_analysis(run)
    assert doc["schema"] == critpath.CRITPATH_SCHEMA
    [r] = doc["rounds"]
    assert r["status"] == "committed" and r["rooted"]
    assert r["orphan_spans"] == 0 and r["n_spans"] == 7
    assert r["span_s"] == pytest.approx(0.001)
    ph = r["phases_us"]
    assert ph["step_compute"] == pytest.approx(200)
    assert ph["sync_stall"] == pytest.approx(80)
    assert ph["phase1"] == pytest.approx(100)
    assert ph["persist"] == pytest.approx(400)
    assert ph["commit"] == pytest.approx(100)
    assert ph["wait"] == pytest.approx(120)
    # the acceptance criterion: buckets sum to the round span exactly
    assert sum(ph.values()) == pytest.approx(r["span_s"] * 1e6)
    assert r["per_host_us"]["0"]["persist"] == pytest.approx(400)
    assert critpath.check(doc) == []


def test_critical_path_descends_into_latest_finisher(tmp_path):
    run = _write_run(tmp_path, _round_events(), [_journal_round()])
    [r] = _same_analysis(run)["rounds"]
    names = [p["name"] for p in r["critical_path"]]
    # the persist chain held the round open, not the commit fsync
    assert names == ["coord.round", "worker.round", "ckpt.phase1",
                     "ckpt.persist"]
    assert r["critical_host"] == "0"


def test_orphans_fail_check_only_without_journaled_deaths(tmp_path):
    stray = _ev("proxy.step", "X", T0 + 30, dur=10, pid=4,
                args={"trace": TRACE, "span": 20, "parent": 999})
    run = _write_run(tmp_path, _round_events() + [stray],
                     [_journal_round()])
    doc = _same_analysis(run)
    [r] = doc["rounds"]
    assert r["orphan_spans"] == 1
    assert any("orphan" in p for p in critpath.check(doc))
    # the same orphan is the *expected* residue once a death is journaled
    run2 = _write_run(
        tmp_path / "killed", _round_events() + [stray],
        [_journal_round(),
         {"event": "death", "t": 100.0002, "host": 1, "reason": "kill"}],
    )
    doc2 = _same_analysis(run2)
    assert doc2["deaths"] == 1
    assert critpath.check(doc2) == []


def test_span_vs_journal_disagreement_fails_check(tmp_path):
    # stretch the root to 0.5 s while the journal claims 1.0 s
    events = _round_events()
    events[-1]["ts"] = T0 + 500_000
    run = _write_run(tmp_path, events,
                     [_journal_round(t=100.4, round_s=1.0)])
    doc = _same_analysis(run)
    assert any("apart" in p for p in critpath.check(doc))


def test_retried_round_selects_attempt_containing_commit_time(tmp_path):
    # two attempts share the deterministic root id; the journal's commit
    # timestamp falls inside the second
    retry = [
        _ev("coord.round", "B", T0 + 5000, pid=1,
            args={"step": 3, "trace": TRACE, "span": ROOT}),
        _ev("coord.round", "E", T0 + 6000, pid=1),
    ]
    run = _write_run(
        tmp_path, _round_events() + retry,
        [_journal_round(status="aborted", t=100.0008),
         _journal_round(t=100.0055)],
    )
    doc = _same_analysis(run)
    committed = [r for r in doc["rounds"] if r["status"] == "committed"]
    [r] = committed
    assert r["span_s"] == pytest.approx(0.001)  # the 5000..6000 attempt


def test_unclaimed_trace_is_reported_as_stray(tmp_path):
    trailing = [_ev("proxy.step", "X", T0 + 9000, dur=10, pid=3,
                    args={"trace": "round:6", "span": 30, "parent": 31})]
    run = _write_run(tmp_path, _round_events() + trailing,
                     [_journal_round()])
    doc = _same_analysis(run)
    [stray] = doc["orphans"]
    assert stray["trace"] == "round:6" and stray["orphan_spans"] == 1
    assert critpath.check(doc) == []  # trailing windows are not fatal


def test_cli_check_and_json(tmp_path, capsys):
    run = _write_run(tmp_path, _round_events(), [_journal_round()])
    out = os.path.join(run, "critpath.json")
    assert critpath.main([run, "--check", "--json", out]) == 0
    with open(out) as f:
        doc = json.load(f)
    assert doc["schema"] == critpath.CRITPATH_SCHEMA
    assert "check OK" in capsys.readouterr().out


def test_flow_events_pair_resolved_edges():
    events = _round_events()
    flows = critpath.flow_events(events)
    assert flows == rcritpath.flow_events(events)
    # 6 child spans with a present parent -> 6 s/f pairs
    assert len(flows) == 12
    starts = [f for f in flows if f["ph"] == "s"]
    finishes = [f for f in flows if f["ph"] == "f"]
    assert len(starts) == len(finishes) == 6
    assert all(f["bp"] == "e" for f in finishes)
    assert {f["id"] for f in starts} == {f["id"] for f in finishes}
    # flow events are schema-valid phases for the merged-trace check
    assert report.validate_events(flows) == []


def test_merge_stitches_flow_arrows(tmp_path):
    run = _write_run(tmp_path, _round_events(), [_journal_round()])
    out, events, _ = report.merge(run)
    with open(out) as f:
        doc = json.load(f)
    assert any(ev.get("ph") == "s" for ev in doc["traceEvents"])


# -- the port's cluster and proxy, traced ---------------------------------------


def test_cluster_rounds_all_rooted_and_check_green(tmp_path):
    from repro_torch.coord.supervisor import run_cluster

    root = str(tmp_path / "ckpt")
    obs = str(tmp_path / "obs")
    rep = run_cluster(
        root=root, n_hosts=2, total_steps=4, ckpt_every=2,
        backend="thread", loop="numpy", device="cpu", deadline_s=180.0,
        obs_dir=obs,
    )
    assert rep.latest_committed == 4 and rep.alerts == []
    jpath = os.path.join(root, "CLUSTER_LOG.jsonl")
    doc = _same_analysis(obs, journal=jpath)
    committed = [r for r in doc["rounds"] if r["status"] == "committed"]
    assert {r["step"] for r in committed} == {2, 4}
    for r in committed:
        assert r["rooted"], f"round {r['step']} not rooted: {r}"
        assert r["orphan_spans"] == 0
        # decomposition sums to the span by construction, and the span
        # agrees with the journaled round duration within the tolerance
        assert sum(r["phases_us"].values()) == pytest.approx(
            r["span_s"] * 1e6, rel=1e-6)
        assert abs(r["span_s"] - r["round_s"]) <= max(
            critpath.CHECK_REL * r["round_s"], critpath.CHECK_ABS_S)
        # the root span is placed from round_s's own clock readings, so it
        # is round_s to the trace's microsecond: no thread's wait between
        # two readings (a GIL switch, a busy CPU) can push them apart
        assert abs(r["span_s"] - r["round_s"]) <= 1e-6, r
        assert r["critical_path"] and r["critical_host"] is not None
    assert critpath.check(doc) == []
    assert critpath.main([obs, "--journal", jpath, "--check"]) == 0


def test_divergence_drill_names_first_forked_chunk(tmp_path):
    from repro_torch.coord.supervisor import run_cluster

    root = str(tmp_path / "ckpt")
    rep = run_cluster(
        root=root, n_hosts=3, total_steps=4, ckpt_every=2,
        backend="thread", loop="numpy", device="cpu", deadline_s=180.0,
        corrupt_host=1, corrupt_at_step=3,
    )
    assert not rep.lockstep()  # the injection took
    named = [a for a in rep.alerts if a.get("kind") == "digest_divergence"]
    assert named, f"no divergence alert: {rep.alerts}"
    a = named[0]
    assert a.get("chunk") is not None and a.get("chunk_index") is not None
    assert a["step"] == 4
    assert f"first divergent chunk {a['chunk']}[{a['chunk_index']}]" \
        in a["message"]
    # hosts 0 and 2 still agree, so the minority vote names the culprit
    assert a.get("host") == 1


def test_kill_replay_drill_orphans_and_reattach(tmp_path):
    """SIGKILL the port's proxy mid-window: the respawned incarnation
    re-attaches to the same round tree; a window that never reaches its
    boundary is left as an orphan subtree."""
    from repro_torch.proxy import ProxyRunner

    obs = str(tmp_path / "obs")
    trace.enable(obs, "app", run_id="drill")
    spec = {"name": "numpy_sgd", "rows": 8, "width": 32, "seed": 0}
    r = ProxyRunner(spec, chunk_bytes=1 << 10, max_restarts=2)
    r.start()
    try:
        window = trace.span_context(trace.round_trace_id(4))
        r.trace_ctx = window
        for s in range(1, 3):
            r.step(s)
        r.sync_state()  # drain the pipelined steps before the SIGKILL
        r.kill()
        for s in range(3, 5):
            r.step(s)  # death detected -> respawn re-attaches, replays
        r.sync_state()
        # the boundary: the window root span materializes
        tr = trace.get()
        tr.begin("worker.round", step=4, host=0, **trace.ctx_args(window))
        tr.end("worker.round")
        # second window: steps traced, but no boundary is ever reached,
        # so its root span never lands in any shard
        r.trace_ctx = trace.span_context(trace.round_trace_id(8))
        for s in range(5, 7):
            r.step(s)
        r.sync_state()
    finally:
        r.close()
    trace.disable()

    events, _ = report.load_shards(obs)
    spans = critpath.build_spans(events)
    assert spans == rcritpath.build_spans(rreport.load_shards(obs)[0])
    per_trace = {}
    for s in spans:
        if s["trace"] is not None:
            per_trace.setdefault(s["trace"], []).append(s)

    done = per_trace["round:4"]
    ids = {s["span"] for s in done}
    parent_of = {s["span"]: s.get("parent") for s in done}
    assert all(critpath._resolves(s, parent_of, ids) for s in done)
    # the respawned incarnation's replayed + live steps joined the tree
    incs = {s["args"].get("inc") for s in done if s["name"] == "proxy.step"}
    assert incs == {0, 1}
    # ... and announced the re-attach on its REGISTER frame
    assert any(s["name"] == "proxy.register" for s in done)

    # the boundary-less window is one whole orphan subtree
    lost = per_trace["round:8"]
    ids8 = {s["span"] for s in lost}
    parent8 = {s["span"]: s.get("parent") for s in lost}
    assert lost and not any(
        critpath._resolves(s, parent8, ids8) for s in lost
    )
