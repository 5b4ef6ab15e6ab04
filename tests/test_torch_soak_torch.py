"""PyTorch port: a chaos soak of the torch loop on the CPU.

``python -m repro_torch.chaos.soak --loop torch --device cpu`` (the CLI's
``main``): two ranks of the 2-layer transformer, narrow, under a seeded
schedule, judged by both packages' verdicts to the same passing scorecard.
Its own file so the scheduler can run it beside the verdict twins.
"""
import json
import os

from repro.obs import soak as rsoak
from repro_torch.obs import soak


def _judge_both(run_dir):
    """Each package's verdict CLI over the run dir: the same scorecard."""
    assert soak.main([run_dir, "--check"]) == 0
    assert rsoak.main([run_dir, "--check", "--out",
                       os.path.join(run_dir, "soak.ref.json")]) == 0
    with open(os.path.join(run_dir, "soak.json")) as f:
        ours = json.load(f)
    with open(os.path.join(run_dir, "soak.ref.json")) as f:
        assert json.load(f) == ours
    assert ours["schema"] == "crum-soak/1" and ours["pass"]
    return ours


def test_torch_loop_soak_converges_with_a_passing_verdict(tmp_path, monkeypatch):
    """``python -m repro_torch.chaos.soak --loop torch --device cpu``: two
    ranks of the 2-layer transformer (width 32) under a seeded schedule
    (seed 1: rank 1 killed 8.47 s in; 32 steps of at least 0.3 s keep the
    run going past it) finish in bitwise lockstep with a committed image,
    the killed rank respawned once, and the verdict passes with every
    check true."""
    from repro_torch.chaos.soak import main as soak_main

    run_dir = str(tmp_path / "soak")
    # the driver exports CRUM_CHAOS_DIR for its ranks: restored after
    monkeypatch.setenv("CRUM_CHAOS_DIR", "")
    assert soak_main(["--run-dir", run_dir, "--seconds", "30", "--hosts", "2",
                      "--loop", "torch", "--device", "cpu", "--width", "32",
                      "--kinds", "kill_worker", "--seed", "1", "--steps", "32",
                      "--ckpt-every", "4", "--step-time", "0.3"]) == 0
    with open(os.path.join(run_dir, "soak_run.json")) as f:
        run = json.load(f)
    assert run["plan"] == [{"offset_s": 8.47, "kind": "kill_worker",
                            "params": {"host": 1}}]
    assert run["lockstep"] and run["latest_committed"] == 32
    assert run["restarts"] == {"0": 0, "1": 1}
    assert len(set(run["final_digests"].values())) == 1
    doc = _judge_both(run_dir)
    assert doc["n_injections"] == len(run["plan"])
    assert all(doc["checks"].values()), doc["checks"]
