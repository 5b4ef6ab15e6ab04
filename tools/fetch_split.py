#!/usr/bin/env python3
"""Split a shadow buffer's first-sync fetch on the card into allocation,
page-fault and copy time.

    python3 tools/fetch_split.py

Builds qwen2-0.5b's full train state on the card (43 leaves, 4.94 GB) and
copies every leaf's bytes into fresh anonymous ``MAP_SHARED`` mmaps, as a
forked checkpointer's first sync does, several ways, each twice:

* ``current``: a pageable device-to-host ``copy_`` into never-touched pages
  (what ``core/shadow.py`` did before its pre-fault);
* ``touch`` / ``zero``: every page faulted first, on one thread (a write per
  4 KiB page) or on torch's intra-op threads (``zero_``), then the copy;
* ``populate``: the mmaps made with ``MAP_POPULATE`` (the kernel faults
  them in), one after another or eight at a time, then the copy;
* ``pinned``: the copy into one pinned buffer (the link's own rate);
* ``memcpy``: host-to-host from a pinned buffer into fresh pages, on
  torch's threads and on numpy's one;
* ``bounce``: the copy staged through two pinned halves ping-ponged on a
  side stream, each drained into the pages by a host copy (torch's threads
  or numpy's one).

Prints the card's name and power limit first, then one ``[fetch-split]``
line per run.
"""
import gc
import mmap
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.train import build_training  # noqa: E402
from repro_torch.utils.dtypes import byte_view  # noqa: E402
from repro_torch.utils.tree import flatten_with_paths  # noqa: E402


def _alloc(n, populate=False):
    # anonymous + MAP_SHARED, as the shadow's
    flags = mmap.MAP_SHARED | mmap.MAP_ANONYMOUS | (mmap.MAP_POPULATE if populate else 0)
    mm = mmap.mmap(-1, n, flags=flags)
    return mm, np.frombuffer(mm, dtype=np.uint8, count=n)


def main() -> int:
    if not torch.cuda.is_available():
        print("fetch_split: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    run = build_training(get_config("qwen2-0.5b"), batch=4, seq=512, lr=1e-4,
                         total_steps=6, device=dev)
    flat, _ = flatten_with_paths(run.init_state()["device"])
    leaves = [byte_view(t) for t in flat.values()
              if isinstance(t, torch.Tensor) and t.is_cuda]
    total = sum(x.numel() for x in leaves)
    pinned = torch.empty(max(x.numel() for x in leaves), dtype=torch.uint8,
                         pin_memory=True)
    torch.cuda.synchronize()
    print(f"[fetch-split] leaves={len(leaves)} bytes={total} "
          f"torch_threads={torch.get_num_threads()}", flush=True)

    def current(bufs):
        split = {"alloc_s": 0.0, "copy_s": 0.0}
        for x in leaves:
            t = time.perf_counter()
            mm, b = _alloc(x.numel())
            bufs.append((mm, b))
            split["alloc_s"] += time.perf_counter() - t
            t = time.perf_counter()
            torch.from_numpy(b).copy_(x)
            split["copy_s"] += time.perf_counter() - t
        return split

    def faulted(bufs, how):
        split = {"alloc_s": 0.0, "fault_s": 0.0, "copy_s": 0.0}
        for x in leaves:
            t = time.perf_counter()
            mm, b = _alloc(x.numel())
            bufs.append((mm, b))
            split["alloc_s"] += time.perf_counter() - t
            t = time.perf_counter()
            if how == "touch":
                b[::4096] = 0
            else:
                torch.from_numpy(b).zero_()
            split["fault_s"] += time.perf_counter() - t
        for (_, b), x in zip(bufs, leaves):
            t = time.perf_counter()
            torch.from_numpy(b).copy_(x)
            split["copy_s"] += time.perf_counter() - t
        return split

    def populated(bufs, workers):
        from concurrent.futures import ThreadPoolExecutor

        split = {"alloc_s": 0.0, "copy_s": 0.0}
        t = time.perf_counter()
        with ThreadPoolExecutor(workers) as pool:
            bufs += pool.map(lambda x: _alloc(x.numel(), populate=True), leaves)
        split["alloc_s"] = time.perf_counter() - t
        for (_, b), x in zip(bufs, leaves):
            t = time.perf_counter()
            torch.from_numpy(b).copy_(x)
            split["copy_s"] += time.perf_counter() - t
        return split

    def pinned_only(bufs):
        t = time.perf_counter()
        for x in leaves:
            pinned[: x.numel()].copy_(x)
        return {"copy_s": time.perf_counter() - t}

    def memcpy(bufs, threads):
        split = {"copy_s": 0.0}
        for x in leaves:
            mm, b = _alloc(x.numel())
            bufs.append((mm, b))
            t = time.perf_counter()
            if threads:
                torch.from_numpy(b).copy_(pinned[: x.numel()])
            else:
                np.copyto(b, pinned[: x.numel()].numpy())
            split["copy_s"] += time.perf_counter() - t
        return split

    def bounce(bufs, threads, half=32 << 20):
        stream = torch.cuda.Stream()
        pin = torch.empty(2 * half, dtype=torch.uint8, pin_memory=True)
        halves, events = [pin[:half], pin[half:]], [torch.cuda.Event(), torch.cuda.Event()]
        split = {"wait_s": 0.0, "host_copy_s": 0.0}
        pieces = []
        for x in leaves:
            mm, b = _alloc(x.numel())
            bufs.append((mm, b))
            dst = torch.from_numpy(b)
            pieces += [(x, dst, lo, min(x.numel(), lo + half))
                       for lo in range(0, x.numel(), half)]
        stream.wait_stream(torch.cuda.current_stream())

        def drain(k):
            _, dst, lo, hi = pieces[k]
            t = time.perf_counter()
            events[k % 2].synchronize()
            split["wait_s"] += time.perf_counter() - t
            t = time.perf_counter()
            if threads:
                dst[lo:hi].copy_(halves[k % 2][: hi - lo])
            else:
                np.copyto(dst[lo:hi].numpy(), halves[k % 2][: hi - lo].numpy())
            split["host_copy_s"] += time.perf_counter() - t

        for k, (x, _, lo, hi) in enumerate(pieces):
            with torch.cuda.stream(stream):
                halves[k % 2][: hi - lo].copy_(x[lo:hi], non_blocking=True)
                events[k % 2].record(stream)
            if k:
                drain(k - 1)
        drain(len(pieces) - 1)
        return split

    variants = [
        ("current", current),
        ("touch then copy", lambda b: faulted(b, "touch")),
        ("zero then copy", lambda b: faulted(b, "zero")),
        ("populate then copy", lambda b: populated(b, 1)),
        ("populate x8 then copy", lambda b: populated(b, 8)),
        ("pinned", pinned_only),
        ("memcpy threads", lambda b: memcpy(b, True)),
        ("memcpy numpy", lambda b: memcpy(b, False)),
        ("bounce threads", lambda b: bounce(b, True)),
        ("bounce numpy", lambda b: bounce(b, False)),
    ]
    for name, fn in variants:
        for rep in range(2):
            bufs = []
            t0 = time.perf_counter()
            split = fn(bufs)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            print(f"[fetch-split] {name} rep={rep} total_s={dt:.3f} "
                  f"GB/s={total / dt / 1e9:.2f} "
                  + " ".join(f"{k}={v:.3f}" for k, v in split.items()), flush=True)
            bufs.clear()
            gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
