"""The port's cluster drills on the CPU: crash mid-commit over both
persist backends (the reference's ``tests/coord/test_cluster.py`` drill on
``repro_torch``), the divergence drill through the launcher on tensor
state, and the stalled rank. Ranks that host device proxies are in
``test_torch_cluster_proxy.py``. Marked ``integration`` (each test spawns
rank processes that import torch)."""
import json
import os

import pytest

from repro_torch.checkpoint.manifest import committed_steps
from repro_torch.coord.supervisor import run_cluster

pytestmark = pytest.mark.integration

BACKENDS = ["thread"] + (["fork"] if hasattr(os, "fork") else [])


def _read_log(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("backend", BACKENDS)
def test_crash_mid_commit_aborts_and_restores_previous(tmp_path, backend):
    """Kill a worker after its hostmeta is written but before the ack:
    the round must abort with no MANIFEST/COMMIT, and the respawned worker
    must restore from the *previous* committed step. Over both persist
    backends."""
    root = str(tmp_path / f"cluster-{backend}")
    report = run_cluster(
        root=root, n_hosts=2, total_steps=6, ckpt_every=2,
        backend=backend, loop="numpy", device="cpu", deadline_s=300.0,
        die_after_persist_host=1, die_after_persist_step=4,
        sweep=False,  # keep the aborted round's partial files visible
    )
    # the round at step 4 aborted first, then committed on retry
    step4 = [r for r in report.rounds if r.step == 4]
    assert [r.status for r in step4] == ["aborted", "committed"]
    # mid-commit death: the dying host HAD persisted (hostmeta on disk)
    # yet the decision never appeared until every participant acked
    assert report.restarts[1] == 1
    assert report.lockstep()
    assert report.latest_committed == 6
    assert committed_steps(root) == [2, 4, 6]
    # the respawned worker restored from the previous committed step (2),
    # not from the aborted round's staged image
    joins = [e for e in _read_log(report.log_path)
             if e["event"] == "join" and e["host"] == 1
             and e.get("restored_from") is not None]
    assert joins and joins[-1]["restored_from"] == 2
    # the death event was journaled while step 2 was still the restore target
    deaths = [e for e in _read_log(report.log_path) if e["event"] == "death"]
    assert deaths and deaths[0]["latest_committed"] == 2


def test_corrupt_drill_names_the_forked_chunk_on_tensor_state(tmp_path, capsys):
    """The launcher's divergence drill on torch state: a byte of rank 1's
    first tensor flips after step 2, the watchdog's digest_divergence
    alert names that leaf's first chunk and (three ranks: a majority) the
    culprit, and the CLI exits 0."""
    from repro_torch.launch import cluster
    from repro_torch.proxy.programs import make_program
    from repro_torch.utils.tree import flatten_with_paths

    flat, _ = flatten_with_paths(
        make_program({"name": "torch_tiny", "device": "cpu"}).init_state())
    first = sorted(p for p, t in flat.items() if t.numel())[0]
    rc = cluster.main(["--hosts", "3", "--steps", "4", "--ckpt-every", "2",
                       "--loop", "torch", "--device", "cpu",
                       "--corrupt-host", "1", "--corrupt-at-step", "2",
                       "--ckpt-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "divergence provenance OK" in out
    line = next(l for l in out.splitlines() if "divergence provenance OK" in l)
    assert line.endswith(f"chunk={first!r} index=0 host=1"), line


def test_stalled_rank_is_kicked_respawned_and_converges(tmp_path):
    report = run_cluster(
        root=str(tmp_path / "cluster"), n_hosts=2, total_steps=4, ckpt_every=2,
        backend="thread", loop="numpy", device="cpu", deadline_s=300.0,
        heartbeat_timeout_s=1.0, stall_host=1, stall_s=4.0, stall_at_step=3,
    )
    assert report.restarts[1] == 1
    assert report.lockstep()
    assert [r.step for r in report.committed] == [2, 4]
    deaths = [e for e in _read_log(report.log_path) if e["event"] == "death"]
    assert deaths and "heartbeat timeout" in deaths[0]["reason"]
    assert "worker_death" in report.alert_kinds()


def test_cuda_rank_without_a_card_raises():
    import torch

    from repro_torch.coord.worker import WorkerConfig, _setup_device

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    cfg = WorkerConfig(host=0, n_hosts=1, coord_host="", coord_port=0, root="",
                       total_steps=1, ckpt_every=1, loop="torch")
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _setup_device(cfg)
