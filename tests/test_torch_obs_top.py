"""PyTorch port: ``obs.top``, the terminal live view, against the reference.

The twins of ``tests/obs/test_top.py`` (pure rendering, run-dir mode, the
METRICS endpoint, here against the port's coordinator), and one run dir
written by the port's coordinator rendered by both packages' ``top``: the
same text.
"""
import json
import os
import threading
import time

from repro.obs import top as ref_top
from repro_torch.obs import top
from repro_torch.obs.journal import JournalWriter
from repro_torch.obs.live import LIVE_SCHEMA


def _snapshot():
    return {
        "schema": LIVE_SCHEMA,
        "t": 0.0,
        "hosts": [-1, 0, 1],
        "ingested": 12,
        "dropped": 1,
        "series": {
            "0": {
                "proxy_syncs_total": [[1.0, 2.0], [2.0, 4.0]],
                "uvm_faults": [[1.0, 30.0]],
                "something_else": [[1.0, 1.0]],
            },
            "1": {"proxy_syncs_total": [[1.0, 3.0]]},
            "-1": {"round_s": [[2.5, 0.4]]},
        },
    }


def test_render_table_and_rates():
    text = top.render(_snapshot(), [])
    assert "hosts=[-1, 0, 1]" in text
    assert "ingested=12" in text and "dropped=1" in text
    # per-host rows with the latest value; cumulative series get a rate
    assert "h0" in text and "h1" in text and "coord" in text
    assert "4/2s" in text          # (4-2)/(2-1) = 2/s on proxy_syncs_total
    assert "alerts: none" in text
    # something_else + coord's round_s summarized, not shown as columns
    assert "2 more series" in text


def test_render_alerts_and_empty_snapshot():
    alerts = [{"kind": "straggler", "severity": "warning", "host": 2,
               "step": 6, "message": "host 2 is slow"}]
    text = top.render(_snapshot(), alerts)
    assert "alerts (1):" in text and "straggler" in text
    text2 = top.render(None, [])
    assert "no live snapshot" in text2


def test_run_dir_mode_and_once(tmp_path, capsys):
    run_dir = str(tmp_path)
    with open(os.path.join(run_dir, "live_metrics.json"), "w") as f:
        json.dump(_snapshot(), f)
    w = JournalWriter(os.path.join(run_dir, "CLUSTER_LOG.jsonl"))
    w.write("alert", kind="worker_death", severity="warning", host=1,
            message="gone")
    w.write("round", step=3, status="committed")
    w.close()

    assert top.main(["--run-dir", run_dir, "--once"]) == 0
    out = capsys.readouterr().out
    assert "h0" in out
    assert "worker_death" in out  # journal alert surfaced

    # missing snapshot: renders the placeholder and exits non-zero
    assert top.main(["--run-dir", str(tmp_path / "void"), "--once"]) == 1


def _coordinator(root):
    """The port's coordinator with one host's counters ingested and a
    worker death alerted."""
    from repro_torch.coord.coordinator import Coordinator

    coord = Coordinator(root, n_hosts=1).start()
    coord.live.ingest(0, {"seq": 1, "counters": {"proxy_syncs_total": 5}, "gauges": {}})
    coord.watchdog.on_death(0, "test kick")
    return coord


def test_endpoint_mode_against_live_coordinator(tmp_path):
    """The METRICS side channel answers any un-JOINed connection."""
    coord = _coordinator(str(tmp_path / "root"))
    try:
        host, port = coord.address

        # _on_metrics normally runs on the event loop; pump one dispatch
        def pump():
            kind, conn, frame = coord._inbox.get(timeout=5)
            assert kind == "msg"
            coord._dispatch(conn, frame)

        t = threading.Thread(target=pump, daemon=True)
        t.start()
        snap, alerts = top.fetch_endpoint(host, port, timeout=5)
        t.join(timeout=5)
        assert snap["series"]["0"]["proxy_syncs_total"][0][1] == 5.0
        assert alerts and alerts[0]["kind"] == "worker_death"
        text = top.render(snap, alerts)
        assert "worker_death" in text
    finally:
        coord.close()


def test_both_packages_render_a_port_run_dir_alike(tmp_path, monkeypatch, capsys):
    """The snapshot and journal the port's coordinator leaves in its root
    read the same in the reference's ``top`` as in the port's."""
    root = str(tmp_path / "root")
    _coordinator(root).close()  # writes the final live_metrics.json
    monkeypatch.setattr(time, "time", lambda: 2e9)  # the frame's "s ago"
    frames = []
    for mod in (top, ref_top):
        assert mod.main(["--run-dir", root, "--once"]) == 0
        frames.append(capsys.readouterr().out)
    assert frames[0] == frames[1]
    assert "worker_death" in frames[0] and "h0" in frames[0]
