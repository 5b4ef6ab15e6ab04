"""The port's cluster drills: real rank processes under the coordinator +
restart supervisor (the reference's ``tests/coord/test_cluster.py`` on
``repro_torch``, on the CPU). Marked ``integration`` (spawns N OS
processes per test; each imports torch). The crash-mid-commit and proxy
drills are in ``test_torch_cluster_drills.py``; the cross-package images
in ``test_torch_cluster_parity.py``."""
import json
import os
import signal
import threading

import pytest

from repro_torch.checkpoint.manifest import committed_steps, step_dir
from repro_torch.coord.supervisor import run_cluster

pytestmark = pytest.mark.integration

BACKENDS = ["thread"] + (["fork"] if hasattr(os, "fork") else [])


def _read_log(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_happy_path_two_hosts(tmp_path):
    from repro_torch.obs.leakcheck import LeakCheck

    root = str(tmp_path / "cluster")
    # the launcher must not accrete fds or /dev/shm segments across a
    # full coordinator round-trip (workers are separate processes; their
    # sockets, queues and sentinels all close with the run)
    with LeakCheck(tolerance=4, shm_tolerance=2) as lc:
        report = run_cluster(
            root=root, n_hosts=2, total_steps=4, ckpt_every=2,
            backend="thread", loop="numpy", device="cpu", deadline_s=180.0,
        )
    assert lc.diff()["fd_growth"] <= 4
    assert [r.step for r in report.committed] == [2, 4]
    assert report.aborted == []
    # the watchdog ran the whole time and the happy path is alert-free
    assert report.alerts == []
    assert report.latest_committed == 4
    assert report.lockstep()
    assert committed_steps(root) == [2, 4]
    # every committed step is a fully merged image: MANIFEST + COMMIT +
    # one hostmeta and one payload file per host
    for s in (2, 4):
        names = set(os.listdir(step_dir(root, s)))
        assert {"MANIFEST.msgpack", "COMMIT"} <= names
        assert {"hostmeta-h0000.msgpack", "hostmeta-h0001.msgpack"} <= names
        assert {"data-h0000.bin", "data-h0001.bin"} <= names


def test_kill_and_respawn_converges(tmp_path):
    """The acceptance drill: --hosts 4 --kill-host 2 --kill-at-step 6."""
    root = str(tmp_path / "cluster")
    report = run_cluster(
        root=root, n_hosts=4, total_steps=9, ckpt_every=3,
        backend="thread", loop="numpy", device="cpu", deadline_s=300.0,
        kill_host=2, kill_at_step=6,
    )
    # the killed worker was respawned exactly once and the cluster converged
    assert report.restarts[2] == 1
    assert report.lockstep()
    assert report.latest_committed == 9
    # the round at the kill boundary aborted, then its retry committed
    aborted = [r for r in report.aborted if r.step == 6]
    assert aborted, f"no aborted round at step 6: {report.rounds}"
    assert "host 2" in aborted[0].reason
    assert [r.step for r in report.committed] == [3, 6, 9]
    # the respawned incarnation restored from the last committed step
    joins = [e for e in _read_log(report.log_path)
             if e["event"] == "join" and e["host"] == 2
             and e.get("restored_from") is not None]
    assert joins and joins[-1]["restored_from"] == 3
    # no partial/corrupt commits anywhere
    assert committed_steps(root) == [3, 6, 9]
    # the watchdog saw the death: a worker_death alert was journaled
    # BEFORE the retried round at the kill boundary committed
    assert "worker_death" in report.alert_kinds()
    log = _read_log(report.log_path)
    alert_i = next(i for i, e in enumerate(log)
                   if e["event"] == "alert" and e["kind"] == "worker_death")
    commit6_i = next(i for i, e in enumerate(log)
                     if e["event"] == "round" and e["step"] == 6
                     and e["status"] == "committed")
    assert alert_i < commit6_i


def test_supervisor_respawns_pre_reaped_death(tmp_path):
    """Reap-race regression: a worker that is already dead — and whose exit
    status ``is_alive()`` has already collected via waitpid — before the
    watch loop's first pass must still be respawned. The old loop only
    reaped deaths whose sentinel fired inside its own ``sentinel_wait``
    call, so a death noticed by ``is_alive()`` first was dropped forever
    and the cluster hung at the barrier until the coordinator deadline
    (the order-dependent timeout seen when this file runs sequentially
    under load)."""
    from repro_torch.coord.coordinator import Coordinator
    from repro_torch.coord.supervisor import ClusterSupervisor
    from repro_torch.coord.worker import WorkerConfig

    root = str(tmp_path / "cluster")
    coord = Coordinator(root, n_hosts=1).start()
    host_addr, port = coord.address
    cfg = WorkerConfig(
        host=0, n_hosts=1, coord_host=host_addr, coord_port=port,
        root=root, total_steps=2, ckpt_every=2, backend="thread",
        loop="numpy", device="cpu", deadline_s=120.0,
    )
    sup = ClusterSupervisor([cfg])
    sup.start()
    # kill AND fully reap before watch() runs: no sentinel event is left
    # for the watch loop to observe, only the is_alive() fact
    os.kill(sup.procs[0].pid, signal.SIGKILL)
    sup.procs[0].join()
    assert not sup.procs[0].is_alive()

    coord_err = {}

    def drive():
        try:
            coord.run(deadline_s=120.0)
        except Exception as e:  # surfaced below
            coord_err["e"] = e

    coord_thread = threading.Thread(target=drive, daemon=True)
    coord_thread.start()
    try:
        sup.watch(coord.done, deadline_s=120.0)
    finally:
        sup.terminate()
    coord_thread.join(timeout=30)
    assert "e" not in coord_err, coord_err
    assert sup.restarts[0] == 1
    assert coord.latest_committed == 2


def test_straggler_flagged_but_never_blocks_commit(tmp_path):
    root = str(tmp_path / "cluster")
    report = run_cluster(
        root=root, n_hosts=3, total_steps=4, ckpt_every=2,
        backend="thread", loop="numpy", device="cpu", deadline_s=300.0,
        straggle_host=2, straggle_s=0.6,
    )
    assert report.aborted == []
    assert report.latest_committed == 4
    assert report.lockstep()
    flagged = {h for r in report.committed for h in r.stragglers}
    assert flagged == {2}
    # the slow host inflates round time, not the commit critical section
    assert all(r.round_s >= 0.6 for r in report.committed)
    assert all(r.commit_s < 0.6 for r in report.committed)
    # the watchdog names the slow host, and only as a warning
    straggler_alerts = [a for a in report.alerts if a["kind"] == "straggler"]
    assert straggler_alerts and all(a["host"] == 2 for a in straggler_alerts)
    assert all(a["severity"] == "warning" for a in report.alerts)


def test_sweep_removes_aborted_partials(tmp_path):
    root = str(tmp_path / "cluster")
    report = run_cluster(
        root=root, n_hosts=2, total_steps=4, ckpt_every=2,
        backend="thread", loop="numpy", device="cpu", deadline_s=300.0,
        kill_host=1, kill_at_step=2,
    )
    assert report.lockstep()
    # all remaining step dirs are committed ones (partials swept at the end)
    for name in os.listdir(root):
        d = os.path.join(root, name)
        if name.startswith("step_") and os.path.isdir(d):
            assert os.path.exists(os.path.join(d, "COMMIT"))
