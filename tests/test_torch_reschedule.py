"""PyTorch port: cross-endpoint drills (the twins of
``tests/remote/test_reschedule.py``'s proxy-host cases).

A proxy-host daemon SIGKILLed mid-run is survived: the runner asks for a
survivor and replays its API log there, to the unkilled bits. In the
cluster the coordinator places every rank's proxy on a daemon; killing
one daemon after the first commit reschedules its ranks onto the other,
the watchdog journals a ``proxy_host_death`` alert before a committed
round, and the final state equals a local-proxy run's. Unlike the
reference's, these run in tier-1 (not ``remote``-marked), on the CPU
(``device="cpu"``).
"""
import json

import pytest

from repro_torch.coord.supervisor import run_cluster
from repro_torch.launch import cluster as cluster_cli
from repro_torch.proxy import ProxyRunner, make_program
from repro_torch.remote.host import ProxyHostHandle
from repro_torch.utils.tree import tree_digest, tree_equal

SPEC = {"name": "numpy_sgd", "rows": 8, "width": 32, "seed": 0}
CLUSTER = dict(n_hosts=2, ckpt_every=2, backend="thread", loop="numpy",
               device="cpu", device_runner="proxy", deadline_s=300.0)


def _inline_run(n_steps, spec=SPEC):
    prog = make_program(spec)
    s = prog.init_state()
    for step in range(1, n_steps + 1):
        s, _ = prog.step(s, step)
    return s


def test_daemon_kill_reschedules_onto_survivor():
    daemons = [ProxyHostHandle(f"r-ph{i}", device="cpu").start() for i in range(2)]
    order = list(daemons)
    used = []

    def provider(failed=False):
        if failed:
            order.pop(0)
        used.append(order[0].name)
        return order[0].addr

    ref = _inline_run(12)
    r = ProxyRunner(SPEC, chunk_bytes=1 << 10, transport="stream",
                    endpoint_provider=provider, max_restarts=2,
                    op_timeout_s=30.0, sync_timeout_s=30.0)
    r.start()
    try:
        for s in range(1, 7):
            r.step(s)
        r.sync_state()
        daemons[0].kill()  # the HOST dies, not just the session
        for s in range(7, 13):
            r.step(s)
        state, info = r.sync_state()
        assert r.restarts == 1
        assert used[0] != used[-1], "never moved endpoints"
        assert r.recoveries[-1]["endpoint"] == daemons[1].addr
        assert info["step"] == 12
        assert tree_equal(state, ref)
        assert info["digest"] == tree_digest(ref)
    finally:
        r.close()
        for d in daemons:
            d.terminate()


def test_cluster_proxy_host_kill_drill(tmp_path):
    """The acceptance drill: ranks' proxies live on daemons; SIGKILL of
    one daemon is survived — the coordinator reschedules onto the
    survivor, the API log replays, and the state is bit-identical to an
    unkilled (local-proxy) run."""
    # each step sleeps, so the run is still stepping when the killer sees
    # the first commit (a bare numpy run can finish before it looks)
    report = run_cluster(root=str(tmp_path / "cluster"), total_steps=6,
                         proxy_hosts=2, kill_proxy_host=0, step_time_s=0.5,
                         **CLUSTER)
    assert report.lockstep()
    assert report.latest_committed == 6
    assert report.killed_proxy_hosts == ["ph0"]
    by_rank = {}
    for w, name in report.proxy_placements:
        by_rank.setdefault(w, []).append(name)
    moved = [w for w, names in by_rank.items() if len(set(names)) > 1]
    assert moved, f"no reschedule in {report.proxy_placements}"
    # the watchdog journaled the proxy-host death BEFORE a round that
    # committed on the rescheduled endpoint
    assert "proxy_host_death" in report.alert_kinds()
    with open(report.log_path) as f:
        log = [json.loads(line) for line in f]
    alert_i = next(i for i, e in enumerate(log) if e["event"] == "alert"
                   and e["kind"] == "proxy_host_death")
    assert [e for e in log[alert_i:] if e["event"] == "round"
            and e["status"] == "committed"], "no committed round after the alert"
    # the moved ranks' acks after the death report their proxy's restart
    restarted = {h for acks in report.acks for h, a in acks.items()
                 if a["proxy_restarts"] >= 1}
    assert restarted == set(moved)
    assert all(isinstance(a["synced_wt"], float) for acks in report.acks
               for a in acks.values())

    ref = run_cluster(root=str(tmp_path / "ref"), total_steps=6, **CLUSTER)
    assert ref.lockstep()
    assert set(ref.final_digests.values()) == set(report.final_digests.values())


def test_cluster_remote_proxies_happy_path(tmp_path, capsys):
    """No drill, through the cluster CLI: coordinator-placed remote
    proxies just work, and placement spreads the ranks across daemons."""
    rc = cluster_cli.main([
        "--hosts", "2", "--steps", "4", "--ckpt-every", "2", "--loop", "numpy",
        "--device", "cpu", "--device-runner", "proxy", "--proxy-hosts", "2",
        "--ckpt-dir", str(tmp_path / "cluster"), "--expect-no-alerts",
    ])
    out = capsys.readouterr().out
    assert rc == 0, out
    summary = json.loads(out[out.index("\n{") + 1:])
    assert summary["lockstep_converged"] and summary["latest_committed"] == 4
    assert summary["rounds_aborted"] == 0
    assert {n for _, n in summary["proxy_placements"]} == {"ph0", "ph1"}
    assert summary["killed_proxy_hosts"] == []


@pytest.mark.parametrize("kw, match", [
    (dict(proxy_hosts=2, device_runner="inline"), "needs device_runner='proxy'"),
    (dict(proxy_hosts=2, kill_proxy_host=2), r"outside \[0, 2\)"),
    (dict(proxy_hosts=1, kill_proxy_host=0), "needs a survivor"),
])
def test_run_cluster_refuses_a_bad_proxy_host_drill(tmp_path, kw, match):
    with pytest.raises(ValueError, match=match):
        run_cluster(root=str(tmp_path), total_steps=2,
                    **dict(CLUSTER, **kw))
