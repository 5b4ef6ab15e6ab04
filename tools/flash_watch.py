"""pytest plugin: the f32 flash case's error after every test file.

    PYTHONPATH=src:tools python -m pytest -p flash_watch ...

After the last test of each file it runs
``tests/test_torch_flash.py::test_matches_jax_kernel_f32``'s first case
(1, 1, 1, 128, 128, 64) in the same process, the port's plain version
against the reference's interpret-mode kernel, and appends one JSON line
to ``$FLASH_WATCH_DIR/flash_watch.<xdist worker>.jsonl`` (the current
directory by default): the file just run, the case's worst ratio to its
2e-5 limit, each side's worst error against a float64 softmax, torch's
thread count and fp32 matmul precision. A process-global setting that an
earlier file leaves changed shows as a jump after that file.
"""
import json
import os
import time

import numpy as np


def _measure() -> dict:
    import jax.numpy as jnp
    import torch

    from repro.kernels import ops as rops
    from repro_torch.kernels import ops

    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((1, 1, 128, 64)).astype(np.float32) for _ in range(3))
    ours = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True).numpy()
    theirs = np.asarray(rops.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                                             use_pallas="interpret"), np.float32)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k.astype(np.float64)) / 8.0
    s = np.where(np.tril(np.ones((128, 128), bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    truth = np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), v)
    rec = {"ratio": float((np.abs(ours - theirs) / (2e-5 + 2e-5 * np.abs(theirs))).max()),
           "ours_err": float(np.abs(ours - truth).max()),
           "jax_err": float(np.abs(theirs - truth).max()),
           "threads": torch.get_num_threads(),
           "matmul_precision": torch.get_float32_matmul_precision()}
    if rec["ratio"] > 0.1:
        # moved: which rows, and does the same call, repeated at once or on
        # one thread, move again?
        for side, got in (("ours", ours), ("jax", theirs)):
            rows = np.abs(got - truth).max(axis=-1)[0, 0]
            rec[f"{side}_rows_off"] = np.flatnonzero(rows > 1e-5).tolist()
        again = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True).numpy()
        rec["ours_again_err"] = float(np.abs(again - truth).max())
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            one = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True).numpy()
        finally:
            torch.set_num_threads(n)
        rec["ours_one_thread_err"] = float(np.abs(one - truth).max())
    return rec


def pytest_runtest_teardown(item, nextitem):
    if nextitem is not None and nextitem.path == item.path:
        return
    try:
        rec = _measure()
    except Exception as e:  # the watch must not fail the suite
        rec = {"error": repr(e)}
    rec.update(file=str(item.path), t=time.time())
    worker = os.environ.get("PYTEST_XDIST_WORKER", "main")
    out = os.path.join(os.environ.get("FLASH_WATCH_DIR", "."),
                       f"flash_watch.{worker}.jsonl")
    with open(out, "a") as f:
        f.write(json.dumps(rec) + "\n")
