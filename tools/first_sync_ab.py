#!/usr/bin/env python3
"""Same-call A/B of first-sync blocking: ``[main]`` and ``[train:long]`` of
two trees' ``chip_smoke.py``, in the order A, B, B, A.

    python3 tools/first_sync_ab.py A_TREE B_TREE

Each tree is a checkout (its own ``src/`` and ``build/``; unpack the other
commit with ``git archive`` into a git-ignored directory). Each leg is a
fresh process that builds the tree's kernels (``[card]``), runs its train
CLI phase (``[main]``: 6 steps, fork checkpoints at 2, 4 and 6) and its
``[train:long]`` (seq 8192, checkpoints at 2 and 4), and prints their
``[ckpt]`` lines: the blocking of each checkpoint, the first two of each
phase being their shadow buffers' first syncs.
"""
import os
import subprocess
import sys
import tempfile
import time

KEEP = ("[leg]", "[ckpt]", "[main]", "[train] step", "[train:long]", "NVIDIA",
        "Traceback", "Error", "SystemExit")


def leg(tree: str) -> int:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import chip_smoke as cs  # puts the tree's src/ first
    import repro_torch
    import torch

    if not (cs.__file__.startswith(tree) and repro_torch.__file__.startswith(tree)):
        raise SystemExit(f"{cs.__file__} / {repro_torch.__file__} not from {tree}")
    print(f"[leg] tree={tree}", flush=True)
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    card = cs.phase_card()
    with tempfile.TemporaryDirectory(prefix="first-sync-ab-") as tmp:
        with cs._clock("main"):
            cs.phase_main_path(os.path.join(tmp, "ckpt"), "none")
    with cs._clock("train:long"):
        cs.phase_train_long(card)
    print(f"[leg] tree={tree} wall_s={time.perf_counter() - t0:.1f}", flush=True)
    return 0


def main(argv) -> int:
    if argv[:1] == ["--leg"]:
        return leg(argv[1])
    a, b = argv
    rc = 0
    for tree in (a, b, b, a):
        proc = subprocess.run([sys.executable, __file__, "--leg", tree],
                              capture_output=True, text=True)
        for line in (proc.stdout + proc.stderr).splitlines():
            if line.startswith(KEEP) or any(k in line for k in KEEP[-3:]):
                print(line, flush=True)
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
