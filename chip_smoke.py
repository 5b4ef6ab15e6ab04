#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--codec none|gzip|pgzip]

Phases, each printing its own lines; any failure raises and exits nonzero
(nothing is caught, nothing falls back):

1. the card: ``nvidia-smi`` name and power limit, device count, and the
   build of every hand-written kernel from the sources in this checkout;
2. the ``chunk_digest`` CUDA kernel against its plain PyTorch version on the
   card over a sweep of dtypes, sizes (empty, 0-d, ``nbytes % 4 != 0``,
   partial last chunks, one leaf over 2**31 bytes) and chunk sizes, and
   against the host oracle ``chunk_digest_np`` on a subset;
3. the main path through ``repro_torch.launch.train``: qwen2-0.5b at full
   width and depth, batch 4, seq 512, 6 steps, a checkpoint every 2 steps
   with the fork persist backend. The codec is ``none`` by default, not the
   CLI's ``pgzip``, on purpose: it measures the card's path and leaves out
   host compression, which at ``pgzip`` compresses 4.94 GB per checkpoint
   on the host and takes most of the time limit (``--codec pgzip`` runs the
   CLI default). The kernel's launch count is zeroed just before and read
   just after, and must be > 0;
4. restart: restore step 4 onto the card, run steps 5 and 6, and require
   the state to equal the stored step-6 image bit for bit (that image is
   restored with ``verify``, which re-digests every chunk on the host);
5. the kernel's time on the card at the main path's shapes (the 43 leaves
   of the train state, 1 MiB chunks), its bound, and the plain version's
   time, printed as one ``{"kernels": [...]}`` JSON line;
6. the last line: ``{"ok": true, "device": {...}}``.

It exits nonzero without a result when no CUDA device is available.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# cuBLAS reads this when it initialises: set before the first CUDA call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate, and 32-bit operations
# outside the tensor cores
MEM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
ARCH = "qwen2-0.5b"
STEPS, BATCH, SEQ, LR = 6, 4, 512, 3e-4


def phase_card() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[card] torch={torch.__version__} cuda={torch.version.cuda} "
          f"name={torch.cuda.get_device_name(0)} "
          f"count={torch.cuda.device_count()}", flush=True)
    from repro_torch.kernels import chunk_digest

    t0 = time.perf_counter()
    lib = chunk_digest.build()
    print(f"[build] {lib.name} in {time.perf_counter() - t0:.1f}s", flush=True)


def _random_tensor(numel_shape, dtype, gen) -> torch.Tensor:
    numel = math.prod(numel_shape)
    nbytes = numel * torch.empty((), dtype=dtype).element_size()
    raw = torch.randint(0, 256, (nbytes,), dtype=torch.uint8, device="cuda",
                        generator=gen)
    if nbytes == 0:
        return torch.empty(numel_shape, dtype=dtype, device="cuda")
    return raw.view(dtype).reshape(numel_shape)


def _host_digests(x: torch.Tensor, cb: int) -> np.ndarray:
    from repro_torch.checkpoint.chunking import chunk_digest_np, num_chunks
    from repro_torch.utils.tree import leaf_bytes

    raw = leaf_bytes(x)
    out = []
    for i in range(num_chunks(raw.nbytes, cb)):
        d = chunk_digest_np(raw[i * cb : min(raw.nbytes, (i + 1) * cb)])
        out.append([d >> 32, d & 0xFFFFFFFF])
    return np.asarray(out, dtype=np.int64)


def phase_sweep() -> None:
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    dtypes = [torch.float32, torch.bfloat16, torch.float16, torch.int32,
              torch.int8, torch.uint8]
    shapes = [(0,), (), (1,), (3,), (7, 5), (1023,), (257, 33), (4096, 257),
              (1 << 20,), ((3 << 20) + 7,)]
    chunks = [64, 4096, 1 << 20, 4 << 20]
    cases = mismatches = host_checked = 0
    for dtype in dtypes:
        for shape in shapes:
            x = _random_tensor(shape, dtype, gen)
            for cb in chunks:
                k = ops.chunk_digests(x, cb)
                p = ref.chunk_digests_plain(x, cb)
                cases += 1
                mismatches += int(not torch.equal(k, p))
                if k.shape[0] <= 2048:
                    host_checked += 1
                    mismatches += int(not np.array_equal(
                        k.cpu().numpy(), _host_digests(x, cb)))
    # one leaf over 2**31 bytes: 64-bit offsets, > 65,535 chunks on grid x
    big = _random_tensor(((1 << 31) + 4099,), torch.int8, gen)
    for cb in (64, 4 << 20):
        k = ops.chunk_digests(big, cb)
        p = ref.chunk_digests_plain(big, cb)
        cases += 1
        mismatches += int(not torch.equal(k, p))
    del big, k, p
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"[sweep] cases={cases} host_checked={host_checked} "
          f"mismatches={mismatches} (tolerance: exact, integer digests)",
          flush=True)
    if mismatches:
        raise SystemExit(f"chunk_digest: {mismatches} mismatches")


def phase_main_path(store: str, codec: str):
    from repro_torch.kernels import chunk_digest
    from repro_torch.launch import train

    argv = ["--arch", ARCH, "--steps", str(STEPS), "--batch", str(BATCH),
            "--seq", str(SEQ), "--lr", str(LR), "--ckpt-every", "2", "--backend", "fork",
            "--codec", codec, "--log-every", "1", "--ckpt-dir", store]
    chunk_digest.chunk_digests.launches = 0
    t0 = time.perf_counter()
    out = train.train(argv)
    wall = time.perf_counter() - t0
    launches = chunk_digest.chunk_digests.launches
    for r in out["results"]:
        print(f"[ckpt] step={r.step} blocking_ms={r.blocking_s * 1e3:.1f} "
              f"persist_ms={r.persist_s * 1e3:.1f} digest_ms="
              f"{r.digest_us / 1e3:.1f} synced={r.chunks_synced} "
              f"written={r.chunks_written} reused={r.chunks_reused}")
    m = out["metrics"]
    print(f"[main] arch={ARCH} codec={codec} steps={out['final_step']} wall_s={wall:.1f} "
          f"loss={m['loss']:.4f} grad_norm={m['grad_norm']:.4f} "
          f"chunk_digest_launches={launches}", flush=True)
    if out["final_step"] != STEPS or not all(map(math.isfinite, m.values())):
        raise SystemExit(f"main path did not finish cleanly: {out['final_step']} {m}")
    if launches <= 0:
        raise SystemExit("main path never launched the chunk_digest kernel")
    return out["state"], launches


def phase_restart(store: str, final_state) -> dict:
    from repro_torch.checkpoint import ChunkStore
    from repro_torch.configs import get_config
    from repro_torch.core import RestoreManager
    from repro_torch.data import SyntheticBatches
    from repro_torch.launch.train import build_training
    from repro_torch.runtime.steps import batch_to_device
    from repro_torch.utils.tree import tree_equal

    cfg = get_config(ARCH)
    run = build_training(cfg, batch=BATCH, seq=SEQ, lr=LR,
                         total_steps=STEPS, device=torch.device("cuda"))
    rm = RestoreManager(ChunkStore(store))
    t0 = time.perf_counter()
    s6, _ = rm.restore(step=6, device_for=run.device_for, verify=True)
    t_restore = time.perf_counter() - t0
    if not tree_equal(final_state, s6):
        raise SystemExit("stored step-6 image differs from the trained state")
    del final_state
    state, _ = rm.restore(step=4, device_for=run.device_for)
    data = SyntheticBatches.from_state(cfg, batch=BATCH, seq_len=SEQ,
                                       state=state["host"]["data"])
    for step in (5, 6):
        state["device"], _ = run.step_fn(state["device"],
                                         batch_to_device(next(data), "cuda"))
        state["host"]["step"] = np.int64(step)
        state["host"]["data"] = data.state()
    torch.cuda.synchronize()
    same = tree_equal(state, s6)
    print(f"[restart] restored step 4, ran 5..6: bitwise_equal={same} "
          f"restore_verify_s={t_restore:.1f}", flush=True)
    if not same:
        raise SystemExit("restart diverged from the step-6 image")
    return s6["device"]


def _time_ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_timing(device_state, main_launches: int) -> dict:
    from repro_torch.kernels import chunk_digest, ref
    from repro_torch.utils.tree import flatten_with_paths

    leaves = [t for t in flatten_with_paths(device_state)[0].values()
              if isinstance(t, torch.Tensor)]
    cb = 1 << 20  # the CLI's chunk size
    kernel = chunk_digest.chunk_digests

    def kernel_pass():
        return [kernel(t, cb) for t in leaves]

    def plain_pass():
        return [ref.chunk_digests_plain(t, cb) for t in leaves]

    before = kernel.launches
    got = kernel_pass()  # warm-up, and the comparison
    per_sync = kernel.launches - before
    want = plain_pass()
    err = max(int((a - b).abs().max()) for a, b in zip(got, want))
    del got, want
    ms = _time_ms(kernel_pass, 20)
    plain_ms = _time_ms(plain_pass, 2)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    words = sum(-(-t.numel() * t.element_size() // 4) for t in leaves)
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    ops_ms = words * 6 / OPS_PER_S * 1e3  # xor, mul, add per mix
    row = {
        "name": "chunk_digest", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/chunk_digest.cu",
        "replaces": "src/repro/kernels/chunk_digest.py:38",
        "launches": main_launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }
    print(f"[timing] leaves={len(leaves)} bytes={nbytes} launches_per_sync="
          f"{per_sync} kernel_ms={ms:.3f} plain_ms={plain_ms:.1f} "
          f"bound_ms={row['bound_ms']:.3f} GB/s={nbytes / ms / 1e6:.0f} "
          f"max_abs_err={err} (tolerance: exact)",
          flush=True)
    if err:
        raise SystemExit(f"chunk_digest disagrees with plain at main-path shapes: {err}")
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--codec", default="none",
                    help="checkpoint codec of the main path (default: none)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import repro_torch.kernels  # noqa: F401  (fails first outside a checkout)

    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_card()
    phase_sweep()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as tmp:
        store = os.path.join(tmp, "ckpt")
        final_state, launches = phase_main_path(store, args.codec)
        device_state = phase_restart(store, final_state)
    row = phase_timing(device_state, launches)
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
