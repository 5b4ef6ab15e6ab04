"""PyTorch port: per-injector cluster drills, judged by the soak verdict.

Twins of ``tests/chaos/test_injectors.py``: each drill runs the port's
cluster on the CPU with the injection engine wired through
``run_cluster(chaos=...)``, then closes the loop with the port's verdict,
and the reference's verdict reads the same run dir to the same booleans.

The reference's disk-full and clock-skew drills arm their fault as soon as
``run_cluster`` starts the ranks, for 2.5 s and 2 s; a rank is a spawned
process that imports its framework first and joins 2.4-3.4 s later on an
8-core CPU host, and it persists and beats later still, so the sentinel
has expired before any rank could see it. Their twins open the window
after the first commit, as the reference's other drills already do
(``_wait_first_commit``).
"""
import json
import os
import threading
import time

from repro.obs.soak import verdict as ref_verdict
from repro_torch.chaos.faults import CHAOS_ENV
from repro_torch.chaos.injectors import ClusterHandles, InjectionEngine
from repro_torch.chaos.schedule import PlannedInjection
from repro_torch.chaos.soak import chaos_hook
from repro_torch.coord.supervisor import run_cluster
from repro_torch.obs.soak import verdict
from repro_torch.obs.watch import WatchConfig


def _fire_hook(run_dir, chaos_dir, fire):
    """Adapter: run ``fire(engine, handles)`` on a thread once up."""

    def hook(handles):
        eng = InjectionEngine(
            handles, os.path.join(run_dir, "INJECT_LOG.jsonl"),
            chaos_dir=chaos_dir,
        )
        th = threading.Thread(target=fire, args=(eng, handles), daemon=True)
        th.start()

        class _Ctl:
            def stop(self):
                th.join(timeout=30)
                eng.stop()

        return _Ctl()

    return hook


def _wait_first_commit(handles, timeout=90.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if handles.coordinator.committed_rounds():
            return True
        if handles.coordinator.done.is_set():
            return False
        time.sleep(0.05)
    return False


def _verdict(run_dir):
    """The port's scorecard; the reference's verdict judges the same run
    dir to the same booleans."""
    doc = verdict(run_dir)
    ref = ref_verdict(run_dir)
    assert ref["checks"] == doc["checks"]
    assert ref["n_injections"] == doc["n_injections"]
    assert [a["explained_by"] for a in ref["alerts"]] == \
        [a["explained_by"] for a in doc["alerts"]]
    return doc


def _chaos_env(monkeypatch, run_dir):
    chaos_dir = os.path.join(run_dir, "chaos")
    os.makedirs(chaos_dir)
    monkeypatch.setenv(CHAOS_ENV, chaos_dir)
    return chaos_dir


def test_torn_frame_is_eof_not_poison(tmp_path):
    """A valid length prefix + partial payload + hangup must be treated
    as a dead stranger: the coordinator keeps committing rounds."""
    run_dir = str(tmp_path)
    plan = [PlannedInjection(0.0, "torn_frame", {})]
    report = run_cluster(
        root=os.path.join(run_dir, "ckpt"), n_hosts=2, total_steps=6,
        # the probe's evidence is a commit *after* it fires: keep the
        # steps slow enough that rounds are still landing post-probe
        ckpt_every=2, backend="thread", loop="numpy", device="cpu",
        step_time_s=0.2, deadline_s=180.0,
        chaos=chaos_hook(run_dir, plan, after_commits=1),
    )
    assert report.latest_committed == 6
    assert report.lockstep()
    assert report.alerts == []  # the probe must not trip anything
    doc = _verdict(run_dir)
    assert doc["n_injections"] == 1
    assert doc["checks"]["all_injections_evidenced"], doc["injections"]
    assert doc["checks"]["no_unexplained_alerts"]
    assert doc["pass"], doc["checks"]


def test_disk_full_aborts_then_commits(tmp_path, monkeypatch):
    """ENOSPC mid-persist aborts the round (abort-not-corrupt); once the
    quota window expires the retried round commits cleanly."""
    run_dir = str(tmp_path)
    chaos_dir = _chaos_env(monkeypatch, run_dir)
    plan = [PlannedInjection(0.0, "disk_full",
                             {"host": 0, "quota_bytes": 1, "duration_s": 2.5})]
    report = run_cluster(
        root=os.path.join(run_dir, "ckpt"), n_hosts=2, total_steps=6,
        ckpt_every=2, backend="thread", loop="numpy", device="cpu",
        step_time_s=0.05, deadline_s=180.0,
        chaos=chaos_hook(run_dir, plan, chaos_dir=chaos_dir, after_commits=1),
    )
    aborted = [r for r in report.aborted if "persist" in r.reason]
    assert aborted, f"no persist abort: {report.rounds}"
    assert "host 0" in aborted[0].reason
    assert report.latest_committed == 6      # the retry committed
    assert report.lockstep()
    assert report.restarts == {0: 0, 1: 0}   # a full disk kills nobody
    doc = _verdict(run_dir)
    assert doc["checks"]["all_injections_evidenced"], doc["injections"]
    assert doc["checks"]["no_unexplained_alerts"], doc["alerts"]
    assert doc["checks"]["converged"]
    assert doc["pass"], doc


def test_clock_skew_alert_fires_and_is_explained(tmp_path, monkeypatch):
    """An armed skew shim pushes the heartbeat wall clock out; the
    watchdog's clock_skew rule names the host; the verdict explains it."""
    run_dir = str(tmp_path)
    chaos_dir = _chaos_env(monkeypatch, run_dir)
    plan = [PlannedInjection(0.0, "clock_skew",
                             {"host": 1, "skew_s": 120.0, "duration_s": 2.0})]
    report = run_cluster(
        root=os.path.join(run_dir, "ckpt"), n_hosts=2, total_steps=30,
        ckpt_every=10, backend="thread", loop="numpy", device="cpu",
        step_time_s=0.1, deadline_s=180.0,
        watch_cfg=WatchConfig(max_clock_skew_s=10.0),
        chaos=chaos_hook(run_dir, plan, chaos_dir=chaos_dir, after_commits=1),
    )
    skews = [a for a in report.alerts if a["kind"] == "clock_skew"]
    assert skews and skews[0]["host"] == 1
    assert report.lockstep()
    doc = _verdict(run_dir)
    assert doc["checks"]["all_injections_evidenced"], doc["injections"]
    assert doc["checks"]["no_unexplained_alerts"], doc["alerts"]
    assert doc["pass"], doc


def test_partition_reschedules_onto_survivor(tmp_path):
    """A SIGSTOPped proxy host looks exactly like a network partition; the
    rank's op timeout detects it and the coordinator reschedules the proxy
    onto the survivor."""
    run_dir = str(tmp_path)

    def fire(eng, handles):
        assert _wait_first_commit(handles)
        # partition the daemon actually serving rank 0
        name = handles.coordinator.placement.history[0][1]
        index = next(i for i, d in enumerate(handles.daemons)
                     if d.name == name)
        eng.partition(index, window_s=30.0)

    report = run_cluster(
        root=os.path.join(run_dir, "ckpt"), n_hosts=1, total_steps=9,
        ckpt_every=3, backend="thread", loop="numpy", device="cpu",
        step_time_s=0.25, device_runner="proxy", proxy_hosts=2,
        persist_timeout_s=3.0, deadline_s=240.0,
        chaos=_fire_hook(run_dir, None, fire),
    )
    # the rank was re-placed: two placements, the second on the survivor
    assert len(report.proxy_placements) >= 2
    first, second = report.proxy_placements[0], report.proxy_placements[-1]
    assert first[0] == second[0] == 0 and first[1] != second[1]
    assert report.latest_committed == 9
    assert report.lockstep()
    doc = _verdict(run_dir)
    assert doc["checks"]["all_injections_evidenced"], doc["injections"]
    assert doc["checks"]["no_unexplained_alerts"], doc["alerts"]
    assert doc["pass"], doc


def test_inject_log_is_written_before_the_fault(tmp_path):
    """The journal-first discipline: the INJECT_LOG line (with its
    expected-evidence spec) exists even when the fault itself no-ops."""
    from repro.obs.journal import read_journal as ref_read

    class _NoProcs:
        procs: dict = {}

    eng = InjectionEngine(
        ClusterHandles(coordinator=None, supervisor=_NoProcs(),
                       daemons=[], root=str(tmp_path)),
        os.path.join(str(tmp_path), "INJECT_LOG.jsonl"),
        chaos_dir=str(tmp_path / "chaos"),
    )
    doc = eng.kill_worker(0)          # rank 0 does not exist: fault no-ops
    eng.journal.close()
    assert doc["seq"] == 1
    with open(os.path.join(str(tmp_path), "INJECT_LOG.jsonl")) as f:
        [line] = [json.loads(x) for x in f]
    assert line["schema"] == "crum-inject/1"
    assert line["event"] == "inject"
    assert line["kind"] == "kill_worker"
    assert line["expect"]["any"]
    assert "worker_death" in line["expect"]["explains"]
    # the reference's journal reader types the port's line
    [ref] = ref_read(os.path.join(str(tmp_path), "INJECT_LOG.jsonl"))
    assert type(ref).__name__ == "InjectLine" and ref.seq == 1
