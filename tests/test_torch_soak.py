"""PyTorch port: the soak verdict and the soak driver.

Twins of ``tests/obs/test_soak.py`` (less ``test_gate_soak_clean``, which
imports the reference's benchmark gate): each lays out a run dir from raw
journal lines and holds the port's ``verdict`` to the reference's on it.
Then the formats both ways: a run the port's engine and driver write is
judged by the reference's verdict, and a reference run by the port's, to
the same scorecard (``test_torch_soak_torch.py`` runs the torch loop).
"""
import json
import os
import re

from repro.obs import soak as rsoak
from repro_torch.obs.journal import JOURNAL_SCHEMA, read_journal
from repro_torch.obs.soak import (
    SOAK_SCHEMA,
    evidence_for,
    explain_alerts,
    load_inject_log,
    match_token,
    verdict,
)

T0 = 1000.0


def _write_run(tmp_path, injects, cluster_lines):
    """Lay out a minimal soak run dir from raw journal lines."""
    run_dir = str(tmp_path)
    os.makedirs(os.path.join(run_dir, "ckpt"), exist_ok=True)
    with open(os.path.join(run_dir, "INJECT_LOG.jsonl"), "w") as f:
        for doc in injects:
            f.write(json.dumps(
                {"schema": "crum-inject/1", "event": "inject", **doc}
            ) + "\n")
    with open(os.path.join(run_dir, "ckpt", "CLUSTER_LOG.jsonl"),
              "w") as f:
        for doc in cluster_lines:
            f.write(json.dumps(
                {"schema": JOURNAL_SCHEMA, **doc}) + "\n")
    return run_dir


def _inject(kind="kill_worker", t=T0, seq=1, host=0, any_=None, all_=None,
            explains=("worker_death", "round_abort"), window=30.0):
    return {"kind": kind, "target": f"host:{host}", "t": t, "seq": seq,
            "params": {"host": host},
            "expect": {"window_s": window, "host": host,
                       "any": list(any_ or []), "all": list(all_ or []),
                       "explains": list(explains)}}


def _same_verdict(run_dir, **kw):
    """The port's scorecard, equal to the reference's on the same dir."""
    doc = verdict(run_dir, **kw)
    assert doc == rsoak.verdict(run_dir, **kw)
    return doc


def _records(run_dir):
    return read_journal(os.path.join(run_dir, "ckpt", "CLUSTER_LOG.jsonl"))


def test_token_matching_and_windows(tmp_path):
    run_dir = _write_run(
        tmp_path,
        [_inject(any_=["alert:worker_death", "journal:death"])],
        [
            {"event": "death", "t": T0 + 1.0, "host": 0, "reason": "x"},
            # outside the 30s window: must not count
            {"event": "death", "t": T0 + 99.0, "host": 0, "reason": "x"},
            # wrong host for a host-pinned spec: must not count
            {"event": "alert", "t": T0 + 2.0, "kind": "worker_death",
             "severity": "warning", "host": 1, "message": ""},
        ],
    )
    [inj] = load_inject_log(run_dir)
    records = _records(run_dir)
    assert match_token("journal:death", inj, records) == \
        [f"death:host0@{T0 + 1.0:.3f}"]
    assert match_token("alert:worker_death", inj, records) == []
    assert evidence_for(inj, records)["evidenced"]  # "any" satisfied
    [rinj] = rsoak.load_inject_log(run_dir)
    assert evidence_for(inj, records) == rsoak.evidence_for(
        rinj, rsoak.read_journal(os.path.join(run_dir, "ckpt", "CLUSTER_LOG.jsonl")))


def test_all_semantics_demand_every_token(tmp_path):
    run_dir = _write_run(
        tmp_path,
        [_inject(kind="disk_full",
                 all_=["journal:round_aborted_persist",
                       "journal:round_committed"],
                 explains=["round_abort"])],
        [{"event": "round", "t": T0 + 1.0, "step": 2, "status": "aborted",
          "reason": "host 0 persist failed: ENOSPC"}],
    )
    [inj] = load_inject_log(run_dir)
    assert not evidence_for(inj, _records(run_dir))["evidenced"]  # no commit
    doc = _same_verdict(run_dir)
    assert not doc["checks"]["all_injections_evidenced"]
    assert not doc["pass"]


def test_unexplained_alert_fails_the_run(tmp_path):
    run_dir = _write_run(
        tmp_path,
        [_inject(any_=["journal:death"])],
        [
            {"event": "death", "t": T0 + 1.0, "host": 0, "reason": "x"},
            {"event": "round", "t": T0 + 2.0, "step": 2,
             "status": "committed"},
            # an alert no injection claims
            {"event": "alert", "t": T0 + 3.0, "kind": "digest_divergence",
             "severity": "critical", "host": 1, "message": "forked"},
        ],
    )
    doc = _same_verdict(run_dir)
    assert doc["checks"]["all_injections_evidenced"]
    assert not doc["checks"]["no_unexplained_alerts"]
    [a] = [x for x in doc["alerts"] if x["explained_by"] is None]
    assert a["kind"] == "digest_divergence"
    assert not doc["pass"]


def test_clean_run_passes(tmp_path):
    run_dir = _write_run(
        tmp_path,
        [_inject(any_=["journal:death"])],
        [
            {"event": "death", "t": T0 + 1.0, "host": 0, "reason": "x"},
            {"event": "alert", "t": T0 + 1.1, "kind": "worker_death",
             "severity": "warning", "host": 0, "message": "x"},
            {"event": "round", "t": T0 + 2.0, "step": 2,
             "status": "committed", "round_s": 1.0},
        ],
    )
    doc = _same_verdict(run_dir)
    assert doc["schema"] == SOAK_SCHEMA == rsoak.SOAK_SCHEMA
    assert doc["checks"] == {
        "all_injections_evidenced": True,
        "no_unexplained_alerts": True,
        "converged": True,
        "leaks_flat": True,
        "critpath_ok": True,
        "envelope_ok": True,
    }
    assert doc["pass"]


def test_explain_is_time_boxed():
    from repro_torch.obs.journal import AlertLine, InjectLine

    inj = InjectLine(event="inject", t=T0, kind="kill_worker", seq=1,
                     expect={"window_s": 10.0,
                             "explains": ["worker_death"]})
    inside = AlertLine(event="alert", t=T0 + 5.0, kind="worker_death")
    outside = AlertLine(event="alert", t=T0 + 50.0, kind="worker_death")
    rows = explain_alerts([inj], [inside, outside])
    assert rows[0]["explained_by"] == 1
    assert rows[1]["explained_by"] is None
    assert rows == rsoak.explain_alerts([inj], [inside, outside])


def test_envelope_and_leak_checks(tmp_path):
    run_dir = _write_run(
        tmp_path,
        [],
        [{"event": "round", "t": T0, "step": 2, "status": "committed",
          "round_s": 99.0}],
    )
    # a growing coord_fd rollup series (host -1) must trip leaks_flat
    obs_dir = os.path.join(run_dir, "obs")
    os.makedirs(obs_dir)
    with open(os.path.join(obs_dir, "live_metrics.json"), "w") as f:
        json.dump({
            "schema": "crum-live-metrics/1",
            "series": {},
            "rollups": {"10": {"-1": {
                "coord_fd": [[T0, 10, 10, 10, 3], [T0 + 10, 40, 10, 40, 3]],
            }}},
        }, f)
    doc = _same_verdict(run_dir, round_envelope_s=30.0, fd_allowance=8)
    assert not doc["checks"]["envelope_ok"]
    assert doc["slow_rounds"] == [{"step": 2, "round_s": 99.0}]
    assert not doc["checks"]["leaks_flat"]
    assert doc["leak_growth"]["coord_fd"] == 30.0


# -- formats both ways ------------------------------------------------------------


def _why(doc) -> str:
    """A failed scorecard's reasons, for the assertion message."""
    keep = ("checks", "leak_growth", "slow_rounds", "critpath_problems")
    return json.dumps({**{k: doc.get(k) for k in keep},
                       "unexplained": [a for a in doc["alerts"] if a["explained_by"] is None],
                       "unevidenced": [i for i in doc["injections"] if not i["evidenced"]]},
                      default=str)


# critpath's span-vs-journal rule on the reference's own run: its
# coordinator reads the round's root span and its journaled round_s from
# separate clock readings, which a thread's wait between them (a GIL
# switch, a busy CPU) pushes past the rule's 2 ms; the port reads both
# from one (tests/test_torch_obs_report.py holds them to 1 us)
_SPAN_VS_JOURNAL = re.compile(r"round \d+: span \S+s vs journal \S+s \(> 5% apart\)")


def _judge_both(run_dir):
    """Each package's verdict CLI over one run dir: the same scorecard."""
    from repro_torch.obs import soak as psoak

    rc = psoak.main([run_dir, "--check"])
    with open(os.path.join(run_dir, "soak.json")) as f:
        ours = json.load(f)
    assert rsoak.main([run_dir, "--check", "--out",
                       os.path.join(run_dir, "soak.ref.json")]) == rc
    with open(os.path.join(run_dir, "soak.ref.json")) as f:
        theirs = json.load(f)
    assert ours == theirs
    assert ours["schema"] == "crum-soak/1"
    return ours


def test_inject_log_and_scorecard_cross_package(tmp_path, monkeypatch):
    """INJECT_LOG.jsonl, soak_run.json and soak.json are shared formats: a
    torn-frame soak by the port's driver, engine and cluster and one by the
    reference's are each judged by both verdicts to the same scorecard.
    The port's run passes every check. The reference's passes every check
    but, possibly, ``leaks_flat`` and, through its watchdog's
    ``shm_leak_trend`` alert, ``no_unexplained_alerts``: its coordinator's
    /dev/shm series counts the machine's entries, which tests running
    beside it add to (the port's counts its own run's:
    ``tests/test_torch_leakcheck.py``); and ``critpath_ok`` where its only
    problems are rounds whose span and journaled duration a wait between
    two clock readings put apart (``_SPAN_VS_JOURNAL``)."""
    from repro.chaos.soak import main as ref_soak
    from repro_torch.chaos.soak import main as soak

    docs = {}
    for pkg, main in (("port", soak), ("reference", ref_soak)):
        run_dir = str(tmp_path / pkg)
        # seed 1 plans one torn frame 8.47 s in; 30 steps of 0.4 s keep
        # rounds committing after it
        argv = ["--run-dir", run_dir, "--seconds", "30", "--hosts", "2",
                "--kinds", "torn_frame", "--steps", "30", "--ckpt-every", "3",
                "--step-time", "0.4", "--seed", "1"]
        if pkg == "port":
            argv += ["--device", "cpu"]
        # each driver exports CRUM_CHAOS_DIR for its ranks: restored after
        monkeypatch.setenv("CRUM_CHAOS_DIR", "")
        assert main(argv) == 0
        docs[pkg] = _judge_both(run_dir)
        with open(os.path.join(run_dir, "INJECT_LOG.jsonl")) as f:
            lines = [json.loads(x) for x in f]
        assert lines and all(x["schema"] == "crum-inject/1" for x in lines)
        assert [x["kind"] for x in lines] == ["torn_frame"]
        with open(os.path.join(run_dir, "soak_run.json")) as f:
            assert json.load(f)["schema"] == "crum-soak-run/1"
    port = docs["port"]
    assert port["pass"] and all(port["checks"].values()), _why(port)
    ref = docs["reference"]
    machine_shm = [a for a in ref["alerts"]
                   if a["explained_by"] is None and a["kind"] == "shm_leak_trend"]
    ref_checks = dict(ref["checks"], leaks_flat=True, no_unexplained_alerts=all(
        a["explained_by"] is not None for a in ref["alerts"] if a not in machine_shm),
        critpath_ok=all(_SPAN_VS_JOURNAL.fullmatch(p) for p in ref["critpath_problems"]))
    assert all(ref_checks.values()), _why(dict(ref, checks=ref_checks))
    assert docs["port"]["n_injections"] == docs["reference"]["n_injections"] == 1
