#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--codec none|gzip|pgzip]

Phases, each printing its own lines; any failure raises and exits nonzero
(nothing is caught, nothing falls back):

1. the card: ``nvidia-smi`` name and power limit, device count, and the
   build of every hand-written kernel from the sources in this checkout
   (one ``nvcc`` per source, all started together);
2. the ``chunk_digest`` CUDA kernel against its plain PyTorch version on the
   card over a sweep of dtypes, sizes (empty, 0-d, ``nbytes % 4 != 0``,
   partial last chunks, one leaf over 2**31 bytes) and chunk sizes, and
   against the host oracle ``chunk_digest_np`` on a subset; then grouped
   calls (one launch per ``chunk_digest.CAPACITY`` non-empty leaves, which
   the phase checks): all those leaves in one call, views whose starts are
   off the 16-byte grid, chunk sizes that are multiples of 4 but not of 16,
   more leaves than one launch takes, and the 2**31-byte leaf in a group;
   the ``flash_attention`` CUDA kernel against ``flash_attention_plain``
   over the reference test's shapes (causal and not), f32 (the CUDA-core
   route) and bf16/f16 (the tensor-core route), head dims 32/64/128, a
   ``scale`` override, rows with no key (Sq > Sk), a group of 7 with ragged
   tiles and the serve path's own shapes, with a stated tolerance per dtype
   that must catch a dropped key tile (and the reading of a P rounded once
   to bf16, which is why the kernel splits P in two);
3. the training path through ``repro_torch.launch.train``: qwen2-0.5b at full
   width and depth, batch 4, seq 512, 6 steps, a checkpoint every 2 steps
   with the fork persist backend. The codec is ``none`` by default, not the
   CLI's ``pgzip``, on purpose: it measures the card's path and leaves out
   host compression, which at ``pgzip`` compresses 4.94 GB per checkpoint
   on the host and takes most of the time limit (``--codec pgzip`` runs the
   CLI default). Every kernel's launch count is zeroed just before and
   read just after; ``chunk_digest``'s must be > 0, and every shadow sync
   that digests must make at most ceil(tensor leaves / capacity) launches
   (1 for the 43 leaves of this state);
4. restart: restore step 4 onto the card, run steps 5 and 6, and require
   the state to equal the stored step-6 image bit for bit (that image is
   restored with ``verify``, which re-digests every chunk on the host);
5. the serving path through ``repro_torch.launch.serve``: lazy restore of
   the step-6 params onto the card, prefill of 2 x 8192 tokens (every
   layer's attention is one flash launch on the tensor-core route: 24 per
   prefill, zeroed just before and read just after), 32 greedy tokens; an eager serve must give
   the same bits, and the 32 served logits must lie no further from the
   f32 model's than one bf16 forward over prompt + 31 served tokens (the
   dense lowering) does (teacher forcing);
6. each kernel's time on the card at its path's shapes (``chunk_digest``:
   one grouped call over the 43 leaves of the train state in 1 MiB chunks,
   the table's allocation included, as a sync makes it, beside the same
   kernel called once per leaf, ``per_leaf_ms``; ``flash_attention``: one
   layer of the prefill), its bound, the plain version's time and, for
   attention, ``scaled_dot_product_attention``'s (the kernel's ratio to it
   and its share of the bound on the ``[timing] flash`` line), printed as
   one ``{"kernels": [...]}`` JSON line;
7. the proxy path (``[proxy]``): qwen2-0.5b at full width and 4 of its
   24 layers (a cut for the script's time), batch 4, seq 512, 6 steps, a
   checkpoint every 2 steps, fork backend,
   codec ``none``, 1 MiB chunks, the segment transport and fused digests,
   trained by ``CheckpointedTrainer(device_runner="proxy")``: a child
   Python process that never creates a CUDA context drives a proxy process
   that owns the card. The killed run SIGKILLs its proxy once, after step 5
   is issued, and must recover by replaying the API log (one restart, at
   least one replayed step), writing images at steps 2, 4 and 6; the
   restored run resumes from the step-4 image through
   ``RestoreManager.restore_into_proxy`` into a fresh proxy and runs steps
   5 and 6. This process builds the same program on the card from the same
   host-built init and runs 6 steps inline: the killed run's step-6 image,
   the restored run's step-6 state and the inline state must be equal bit
   for bit. Every SYNCED after a run's first must carry ``prehashed_chunks``
   equal to the state's chunks and one ``chunk_digest`` launch per
   step of its window (the fused digest, in the proxy), and one ack's
   per-chunk digest table must equal ``chunk_digest_np`` over the mirror.
   This process watches each application from outside while it runs: the
   application must never map ``/dev/nvidia-uvm`` (every CUDA context
   does), and its proxy must be seen to. Its lines give the warm steps
   one by one, proxied against inline (the first step of each process or
   proxy incarnation left out), the
   boundary stall, the proxy's phase times, checkpoint blocking and
   persist, the recovery, ``restore_into_proxy``'s time and the segment
   directory (``/dev/shm`` when it holds 1.25x the state, else a directory
   under the temp dir), each beside the card's name and power limit;
8. managed memory (``[uvm]``): the train CLI as in 3, full size, with
   ``--device-capacity 50%`` (frames for 2.47 GB of the 4.94 GB state),
   64 KiB pages and LRU: per step its wall, page-in and page-out ms,
   faults, evictions, write-backs and H2D/D2H bytes; per checkpoint
   blocking, the peek before it, chunks synced and ``chunk_digest``
   launches (0: page marks replace the digest). It must evict, keep its
   resident high water within the budget and its page tables clean, and
   end bitwise equal to 3's unmanaged step 6; the managed step-4 image,
   run to step 6 under the budget, must equal that too. Table 2 on the
   managed state: a managed trainer resumed from step 6 checkpoints step 8
   forked and step 10 through ``save_sync`` (each the first sync of its
   buffer): ``forked_blocking_ms``, ``sync_ms``, ``speedup_vs_naive``.
   ``[uvm:paged]``: the full-depth proxy program with the same budget in
   a proxy process, 4 steps, checkpoints at 2 and 4, SIGKILLed once after
   step 3 is issued: one restart, ``paging`` in every SYNCED, one digest
   launch per step, no ``/dev/nvidia-uvm`` in the application, and its
   step-4 image bitwise equal to the same program run 4 steps inline
   through a managed trainer;
9. the last line: ``{"ok": true, "device": {...}}``.

It exits nonzero without a result when no CUDA device is available.
"""
from __future__ import annotations

import argparse
import contextlib
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

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate, 32-bit operations outside
# the tensor cores, and dense BF16 tensor-core operations (f32 accumulate)
MEM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12
ARCH = "qwen2-0.5b"
STEPS, BATCH, SEQ, LR = 6, 4, 512, 3e-4
SERVE_BATCH, PROMPT, GEN = 2, 8192, 32
# flash kernel vs plain version, (atol, rtol) in |got - want| <= atol +
# rtol |want|: f32 within two sum orders (the reference test's 2e-5); bf16
# and f16 round two f32 values that differ by a sum order to the output's
# type, so one ulp of the output (rtol 2**-7, 2**-10) plus 1e-4 for the sum
# order over up to 8192 keys where the output is near 0
FLASH_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-4, 2.0 ** -7),
             torch.float16: (1e-4, 2.0 ** -10)}
# teacher forcing: the served logits (prefill through the kernel, then
# decode) may lie no further from the f32 model's logits than one bf16
# forward (dense lowering) of the same tokens does (PERF.md says why), and
# every position whose top two forward logits lie more than twice the
# served-vs-forward difference apart must pick the same token


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[card] torch={torch.__version__} cuda={torch.version.cuda} "
          f"name={torch.cuda.get_device_name(0)} "
          f"count={torch.cuda.device_count()}", flush=True)
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import chunk_digest, flash_attention

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:  # one nvcc per source
        libs = list(pool.map(lambda k: k.build(), (chunk_digest, flash_attention)))
    print(f"[build] {' '.join(lib.name for lib in libs)} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return smi


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
    from repro_torch.kernels import chunk_digest, ops, ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    dtypes = [torch.float32, torch.bfloat16, torch.float16, torch.int32,
              torch.int8, torch.uint8]
    shapes = [(0,), (), (1,), (3,), (7, 5), (1023,), (257, 33), (4096, 257),
              (1 << 20,), ((3 << 20) + 7,)]
    chunks = [64, 4096, 1 << 20, 4 << 20]
    cases = mismatches = host_checked = 0
    leaves, plain = [], {cb: [] for cb in chunks}
    for dtype in dtypes:
        for shape in shapes:
            x = _random_tensor(shape, dtype, gen)
            leaves.append(x)
            for cb in chunks:
                k = ops.chunk_digests(x, cb)
                p = ref.chunk_digests_plain(x, cb)
                plain[cb].append(p)
                cases += 1
                mismatches += int(not torch.equal(k, p))
                if k.shape[0] <= 2048:
                    host_checked += 1
                    mismatches += int(not np.array_equal(
                        k.cpu().numpy(), _host_digests(x, cb)))

    cap = chunk_digest.CAPACITY
    bad_launches = []

    def grouped(xs, cb, want) -> None:
        """One grouped call: exact against ``want``, ceil(n / capacity) launches."""
        nonlocal cases, mismatches
        before = chunk_digest.chunk_digests.launches
        table, b = ops.chunk_digest_table(xs, cb)
        launches = chunk_digest.chunk_digests.launches - before
        busy = sum(1 for x in xs if x.numel())
        if launches != -(-busy // cap):
            bad_launches.append((len(xs), cb, launches))
        cases += 1
        mismatches += sum(int(not torch.equal(table[b[k] : b[k + 1]], w))
                          for k, w in enumerate(want))

    # every dtype x shape case in one call: empty and 0-d leaves mid-group
    for cb in chunks:
        grouped(leaves, cb, plain[cb])
    # starts off the 16-byte grid: views at word offsets 1, 2, 3, and chunk
    # sizes that are multiples of 4 but not of 16
    words = _random_tensor(((1 << 16) + 5,), torch.int32, gen)
    odd = [words[o:] for o in (1, 2, 3)] + [words[o : o + 1001] for o in (1, 2, 3)]
    odd += [x for x in leaves if 0 < x.numel() * x.element_size() <= 1 << 20]
    for cb in (4, 12, 20, 1028, 64, 4096):
        grouped(odd, cb, [ref.chunk_digests_plain(x, cb) for x in odd])
    # more leaves than one launch takes: three launches
    many = [_random_tensor((int(n),), torch.uint8, gen)
            for n in torch.randint(0, 5000, (2 * cap + 5,), generator=gen,
                                   device="cuda").tolist()]
    grouped(many, 4096, [ref.chunk_digests_plain(x, 4096) for x in many])
    # one leaf over 2**31 bytes: 64-bit offsets, > 65,535 chunks; alone
    # and inside a group
    big = _random_tensor(((1 << 31) + 4099,), torch.int8, gen)
    group = [odd[0], big, odd[4]]
    for cb in (64, 4 << 20):
        k = ops.chunk_digests(big, cb)
        p = ref.chunk_digests_plain(big, cb)
        cases += 1
        mismatches += int(not torch.equal(k, p))
        del k
        grouped(group, cb, [ref.chunk_digests_plain(group[0], cb), p,
                            ref.chunk_digests_plain(group[2], cb)])
    del big, group, p, leaves, plain, odd, many
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"[sweep] cases={cases} host_checked={host_checked} "
          f"mismatches={mismatches} wrong_launch_counts={bad_launches} "
          f"(tolerance: exact, integer digests; {cap} leaves per launch)", flush=True)
    if mismatches:
        raise SystemExit(f"chunk_digest: {mismatches} mismatches")
    if bad_launches:
        raise SystemExit(f"chunk_digest: grouped calls with the wrong launch count "
                         f"(leaves, chunk_bytes, launches): {bad_launches}")


def _flash_inputs(B, Hq, Hkv, Sq, Sk, D, dtype, gen):
    """q, k contiguous; v the model's view: (B, Sk, Hkv, D) transposed."""
    q = torch.randn((B, Hq, Sq, D), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, Hkv, Sk, D), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, Sk, Hkv, D), generator=gen, device="cuda").to(dtype)
    return q, k, v.transpose(1, 2)


def _plain_block(n: int) -> int:
    """The plain version's block: the largest divisor of n up to 128."""
    return max(b for b in range(1, min(n, 128) + 1) if n % b == 0)


def _plain(q, k, v, *, causal=True, scale=None) -> torch.Tensor:
    from repro_torch.kernels import ref

    return ref.flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     block_q=_plain_block(q.shape[2]),
                                     block_k=_plain_block(k.shape[2]))


def _tol_ratio(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / (atol + rtol |want|): above 1 is a breach."""
    atol, rtol = FLASH_TOL[want.dtype]
    want = want.float()
    return float(((got.float() - want).abs() / (atol + rtol * want.abs())).max())


def _flash_vs_plain(q, k, v, *, causal=True, scale=None):
    """The kernel against the plain version: (max abs error, plain output)."""
    from repro_torch.kernels import flash_attention

    got = flash_attention.flash_attention(q, k, v, causal=causal, scale=scale)
    want = _plain(q, k, v, causal=causal, scale=scale)
    if got.dtype != q.dtype or got.shape != q.shape:
        raise SystemExit(f"flash_attention: got {got.dtype} {tuple(got.shape)}")
    atol, rtol = FLASH_TOL[q.dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    Sq, Sk = q.shape[2], k.shape[2]
    if causal and Sq > Sk:  # rows with no key: the mean of v over all Sk
        mean = v.float().mean(dim=2).repeat_interleave(q.shape[1] // k.shape[1], dim=1)
        torch.testing.assert_close(
            got[:, :, : Sq - Sk].float(),
            mean[:, :, None].expand(-1, -1, Sq - Sk, -1), atol=atol, rtol=rtol)
    return float((got.float() - want.float()).abs().max()), want


def _plain_p_rounded_once(q, k, v) -> torch.Tensor:
    """The plain version (causal, 128 x 128 blocks) with P rounded once to
    q's dtype before P V: what a kernel that skips the P_hi + P_lo split
    computes, up to the sum order. l stays the sum of the f32 P."""
    masked = -1e30  # the plain version's masked logit
    B, Hq, S, D = q.shape
    g = Hq // k.shape[1]
    scale = 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    for q0 in range(0, S, 128):
        qi = q[:, :, q0 : q0 + 128].float()
        acc = torch.zeros((B, Hq, 128, D), device=q.device)
        m = torch.full((B, Hq, 128, 1), masked, device=q.device)
        l = torch.zeros((B, Hq, 128, 1), device=q.device)
        for k0 in range(0, q0 + 128, 128):
            kj = k[:, :, k0 : k0 + 128].float().repeat_interleave(g, dim=1)
            vj = v[:, :, k0 : k0 + 128].float().repeat_interleave(g, dim=1)
            s = torch.einsum("bhqd,bhkd->bhqk", qi, kj) * scale
            rows = torch.arange(q0, q0 + 128, device=q.device)[:, None]
            cols = torch.arange(k0, k0 + 128, device=q.device)[None, :]
            s = torch.where(cols <= rows, s, masked)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            pr = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + pr.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", pr.to(q.dtype).float(), vj)
            m = m_new
        out[:, :, q0 : q0 + 128] = (acc / l).to(q.dtype)
    return out


def phase_flash_sweep() -> None:
    from repro_torch.kernels import flash_attention

    by_route = flash_attention.flash_attention.launches_by_route
    before = dict(by_route)
    gen = torch.Generator(device="cuda").manual_seed(1)
    shapes = [  # (B, Hq, Hkv, Sq, Sk, D)
        (1, 1, 1, 128, 128, 64), (2, 4, 2, 256, 256, 64), (1, 8, 1, 128, 128, 128),
        (1, 4, 4, 128, 512, 64), (2, 2, 2, 384, 384, 32),   # the reference test's
        (1, 2, 1, 256, 128, 64),                            # Sq > Sk: rows with no key
        (1, 14, 2, 200, 200, 64), (1, 14, 2, 120, 200, 64),  # group of 7, ragged tiles
    ]
    worst = {}
    cases = 0
    for dtype in FLASH_TOL:
        for shape in shapes:
            for causal in (True, False):
                err, _ = _flash_vs_plain(*_flash_inputs(*shape, dtype, gen), causal=causal)
                worst[dtype] = max(worst.get(dtype, 0.0), err)
                cases += 1
        err, _ = _flash_vs_plain(*_flash_inputs(1, 1, 1, 128, 128, 64, dtype, gen),
                                 scale=0.5)
        worst[dtype] = max(worst[dtype], err)
        cases += 1
    # the serve path's prefill, one layer: qwen2-0.5b heads at 8192 tokens
    q, k, v = _flash_inputs(SERVE_BATCH, 14, 2, PROMPT, PROMPT, 64, torch.bfloat16, gen)
    serve, want = _flash_vs_plain(q, k, v)
    cases += 1
    # why the kernel splits P in two: what one rounding of P would read
    once_ratio = _tol_ratio(_plain_p_rounded_once(q, k, v), want)
    # what the tolerance reads for a wrong kernel: the last 128 rows (the
    # longest, where one key tile weighs least) with their first key tile
    # dropped; the right-aligned mask keeps every other key of those rows
    T = 128
    want = want[:, :, -T:]
    dropped = _plain(q[:, :, -T:], k[:, :, T:], v[:, :, T:])
    drop_err = float((dropped.float() - want.float()).abs().max())
    drop_ratio = _tol_ratio(dropped, want)
    del q, k, v, want, dropped
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    routes = {r: n - before[r] for r, n in by_route.items()}
    print(f"[flash-sweep] cases={cases} routes={routes} " + " ".join(
        f"{str(d).replace('torch.', '')}_max_abs_err={e:.3g} (atol {FLASH_TOL[d][0]:g} "
        f"rtol {FLASH_TOL[d][1]:g})" for d, e in worst.items())
        + f" serve_shape_max_abs_err={serve:.3g}: within tolerance; one key tile "
        f"dropped reads max_abs_err={drop_err:.3g}, {drop_ratio:.3g}x the limit; "
        f"one rounding of P (no split) reads {once_ratio:.3g}x it", flush=True)
    if drop_ratio <= 1:
        raise SystemExit("the bf16 tolerance does not see a dropped key tile")


def _zero_counts() -> None:
    from repro_torch.kernels import chunk_digest, flash_attention

    chunk_digest.chunk_digests.launches = 0
    flash_attention.flash_attention.launches = 0
    for route in flash_attention.flash_attention.launches_by_route:
        flash_attention.flash_attention.launches_by_route[route] = 0


def _counts() -> dict:
    from repro_torch.kernels import chunk_digest, flash_attention

    return {"chunk_digest": chunk_digest.chunk_digests.launches,
            "flash_attention": flash_attention.flash_attention.launches,
            "flash_attention_by_route": dict(flash_attention.flash_attention.launches_by_route)}


def phase_main_path(store: str, codec: str):
    from repro_torch.core.shadow import ShadowStateManager
    from repro_torch.kernels import chunk_digest
    from repro_torch.launch import train
    from repro_torch.utils.tree import flatten_with_paths

    argv = ["--arch", ARCH, "--steps", str(STEPS), "--batch", str(BATCH),
            "--seq", str(SEQ), "--lr", str(LR), "--ckpt-every", "2", "--backend", "fork",
            "--codec", codec, "--log-every", "1", "--ckpt-dir", store]
    # each shadow sync's kernel launches, beside the tensor leaves it saw
    syncs = []
    sync = ShadowStateManager.sync

    def counted_sync(self, state):
        before = chunk_digest.chunk_digests.launches
        stats = sync(self, state)
        tensors = sum(isinstance(leaf, torch.Tensor)
                      for leaf in flatten_with_paths(state)[0].values())
        syncs.append((chunk_digest.chunk_digests.launches - before, tensors))
        return stats

    ShadowStateManager.sync = counted_sync
    try:
        _zero_counts()
        t0 = time.perf_counter()
        out = train.train(argv)
        wall = time.perf_counter() - t0
        counts = _counts()
    finally:
        ShadowStateManager.sync = sync
    launches = counts["chunk_digest"]
    for r in out["results"]:
        print(f"[ckpt] step={r.step} blocking_ms={r.blocking_s * 1e3:.1f} "
              f"persist_ms={r.persist_s * 1e3:.1f} digest_ms="
              f"{r.digest_us / 1e3:.1f} synced={r.chunks_synced} "
              f"written={r.chunks_written} reused={r.chunks_reused}")
    digesting = [(n, leaves) for n, leaves in syncs if n]
    allowed = {leaves: -(-leaves // chunk_digest.CAPACITY) for _, leaves in syncs}
    m = out["metrics"]
    print(f"[main] arch={ARCH} codec={codec} steps={out['final_step']} wall_s={wall:.1f} "
          f"loss={m['loss']:.4f} grad_norm={m['grad_norm']:.4f} "
          f"chunk_digest_launches={launches} syncs={len(syncs)} "
          f"digesting_syncs={len(digesting)} launches_per_digesting_sync="
          f"{[n for n, _ in digesting]} (at most {sorted(set(allowed.values()))} for "
          f"{sorted(allowed)} tensor leaves) "
          f"flash_attention_launches={counts['flash_attention']}", flush=True)
    if out["final_step"] != STEPS or not all(map(math.isfinite, m.values())):
        raise SystemExit(f"main path did not finish cleanly: {out['final_step']} {m}")
    if launches <= 0:
        raise SystemExit("main path never launched the chunk_digest kernel")
    if any(n > allowed[leaves] for n, leaves in digesting):
        raise SystemExit(f"a sync made more chunk_digest launches than one per "
                         f"{chunk_digest.CAPACITY} leaves: {digesting}")
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


def _served_position_logits(cfg, params, seq: torch.Tensor) -> torch.Tensor:
    """The model's forward over ``seq``; f32 logits only at the positions
    whose next token was served (full-vocab logits everywhere would add
    10 GB)."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import logits_from_embed

    with torch.device("meta"):
        module = tfm.Transformer(cfg)
    with torch.no_grad():
        h = torch.func.functional_call(module, tfm.module_params(params), (seq,))
        return logits_from_embed(tfm.lm_table(cfg, params), h[:, PROMPT - 1 :])


def phase_serve(store: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.utils.tree import flatten_with_paths, unflatten_from_paths

    cfg = get_config(ARCH)
    argv = ["--arch", ARCH, "--ckpt-dir", store, "--batch", str(SERVE_BATCH),
            "--prompt-len", str(PROMPT), "--gen", str(GEN)]
    _zero_counts()
    out = serve.serve(argv + ["--lazy"])
    counts = _counts()
    launches = counts["flash_attention"]
    print(f"[serve] lazy restore_s={out['restore_s']:.3f} ttft_s={out['ttft_s']:.3f} "
          f"decode_tok_s={out['decode_tok_s']:.1f} step={out['step']} "
          f"flash_attention_launches={launches} "
          f"by_route={counts['flash_attention_by_route']} "
          f"chunk_digest_launches={counts['chunk_digest']}", flush=True)
    if out["step"] != STEPS:
        raise SystemExit(f"serve restored step {out['step']}, not {STEPS}")
    if launches != cfg.num_layers:
        raise SystemExit(f"prefill made {launches} flash launches, not one per "
                         f"layer ({cfg.num_layers})")
    if counts["flash_attention_by_route"]["wgmma"] != launches:
        raise SystemExit(f"prefill launches did not all take the tensor-core route: "
                         f"{counts['flash_attention_by_route']}")
    logits = out["logits"]
    if logits.shape != (SERVE_BATCH, GEN, cfg.vocab_size) or not bool(
            logits.isfinite().all()):
        raise SystemExit(f"served logits: {tuple(logits.shape)}, finite="
                         f"{bool(logits.isfinite().all())}")

    eager = serve.serve(argv)  # same image, eager restore: the same bits
    same = bool(np.array_equal(eager["tokens"], out["tokens"])
                and torch.equal(eager["logits"], logits))
    print(f"[serve] eager restore_s={eager['restore_s']:.3f} "
          f"ttft_s={eager['ttft_s']:.3f} decode_tok_s={eager['decode_tok_s']:.1f} "
          f"bitwise_equal_to_lazy={same}", flush=True)
    if not same:
        raise SystemExit("eager and lazy serving disagree")
    del eager

    # teacher forcing: one forward over the prompt and the first GEN - 1
    # served tokens, in the bf16 model and in its f32 upcast
    seq = torch.cat([out["prompt"], torch.from_numpy(out["tokens"][:, :-1]).to(
        out["prompt"].device, torch.int32)], dim=1)
    params = out["params"]
    want = _served_position_logits(cfg, params, seq)
    flat, treedef = flatten_with_paths(params)
    truth = _served_position_logits(
        cfg, unflatten_from_paths(treedef, {p: t.float() for p, t in flat.items()}), seq)
    err = float((logits - want).abs().max())
    # the served path must be at least as accurate as the dense forward:
    # no further from the f32 model's logits than the bf16 forward is
    tol = float((want - truth).abs().max())
    served_vs_f32 = float((logits - truth).abs().max())
    top2 = want.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * err
    agree = torch.from_numpy(out["tokens"]).to(want.device) == want.argmax(dim=-1)
    print(f"[serve] teacher_forced seq={seq.shape[1]} served_vs_f32={served_vs_f32:.4g} "
          f"(tol {tol:.4g} = dense-vs-f32) served_vs_dense={err:.4g} "
          f"max_abs_logit={float(want.abs().max()):.4g} "
          f"greedy_agree={int(agree.sum())}/{agree.numel()} "
          f"decided_agree={int((agree & decided).sum())}/{int(decided.sum())}",
          flush=True)
    if not served_vs_f32 <= tol or not bool(agree[decided].all()):
        raise SystemExit("served logits disagree with the teacher-forced forward")
    del want, truth
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"launches": launches}


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

    def grouped_pass():  # as a sync makes it: one table, one grouped call
        return chunk_digest.chunk_digest_table(leaves, cb)[0]

    def per_leaf_pass():  # the same kernel, one call per leaf
        return [kernel(t, cb) for t in leaves]

    def plain_pass():
        return [ref.chunk_digests_plain(t, cb) for t in leaves]

    before = kernel.launches
    got = grouped_pass()  # warm-up, and the comparison
    per_sync = kernel.launches - before
    want = torch.cat(plain_pass())
    err = max(int((got - want).abs().max()),
              int((torch.cat(per_leaf_pass()) - want).abs().max()))
    del got, want
    # the state is ~100x the 50 MB L2: back-to-back passes read cold memory
    ms = _time_ms(grouped_pass, 20)
    per_leaf_ms = _time_ms(per_leaf_pass, 20)
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
          f"{per_sync} kernel_ms={ms:.3f} per_leaf_ms={per_leaf_ms:.3f} "
          f"plain_ms={plain_ms:.1f} bound_ms={row['bound_ms']:.3f} "
          f"GB/s={nbytes / ms / 1e6:.0f} bound/kernel={row['bound_ms'] / ms:.3f} "
          f"max_abs_err={err} (tolerance: exact)", flush=True)
    if err:
        raise SystemExit(f"chunk_digest disagrees with plain at main-path shapes: {err}")
    if per_sync != -(-len(leaves) // chunk_digest.CAPACITY):
        raise SystemExit(f"the grouped digest took {per_sync} launches")
    return row


def phase_flash_timing(serve_launches: int) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, ref

    B, Hq, Hkv, S, D = SERVE_BATCH, 14, 2, PROMPT, 64  # one prefill layer
    q, k, v = _flash_inputs(B, Hq, Hkv, S, S, D, torch.bfloat16,
                            torch.Generator(device="cuda").manual_seed(2))
    kernel = flash_attention.flash_attention
    got = kernel(q, k, v)  # warm-up, and the comparison
    want = ref.flash_attention_plain(q, k, v)
    err = float((got.float() - want.float()).abs().max())
    ratio = _tol_ratio(got, want)
    del got, want
    ms = _time_ms(lambda: kernel(q, k, v), 10)
    plain_ms = _time_ms(lambda: ref.flash_attention_plain(q, k, v), 2)
    # the library's fused attention at Sq == Sk, where its top-left causal
    # mask is the right-aligned one, on the same values with v contiguous
    # (on the model's transposed view it leaves its fused path); timed
    # only, never on the path
    vc = v.contiguous()

    def library():
        return F.scaled_dot_product_attention(q, k, vc, is_causal=True, enable_gqa=True)

    # timed with this run's deterministic algorithms (its pick then) and
    # without them, where it may pick a faster backend; the faster is the
    # yardstick
    library()  # warm-up: its first call picks and loads a backend
    library_det_ms = _time_ms(library, 10)
    torch.use_deterministic_algorithms(False)
    library()
    library_free_ms = _time_ms(library, 10)
    torch.use_deterministic_algorithms(True)
    library_ms = min(library_det_ms, library_free_ms)
    del vc
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))  # out = q's
    flops = 4 * B * Hq * D * S * (S + 1) / 2  # q.k and p.v over causal pairs
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_TC_OPS_PER_S * 1e3
    row = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:33",
        "launches": serve_launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }
    print(f"[timing] flash q={tuple(q.shape)} k=v={tuple(k.shape)} bf16 causal "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.1f} library_ms={library_ms:.4f} "
          f"(deterministic {library_det_ms:.4f}, not {library_free_ms:.4f}) "
          f"kernel/library={ms / library_ms:.3f} bound_ms={row['bound_ms']:.4f} "
          f"bound/kernel={row['bound_ms'] / ms:.3f} TFLOP/s={flops / ms / 1e9:.1f} "
          f"max_abs_err={err:.3g} ({ratio:.3g}x the bf16 limit)", flush=True)
    if not ratio <= 1:
        raise SystemExit(f"flash_attention disagrees with plain at serve shapes: {err}")
    return row


# [uvm:paged] trains this at full depth; [proxy] at PROXY_LAYERS of its 24
# layers (full width), a cut for the script's time (PERF.md §4)
UVM_SPEC = {"name": "train_arch", "arch": ARCH, "smoke": False, "batch": BATCH,
            "seq": SEQ, "lr": LR, "total_steps": STEPS, "device": "cuda"}
PROXY_LAYERS = 4
PROXY_SPEC = dict(UVM_SPEC, num_layers=PROXY_LAYERS)
PROXY_CHUNK = 1 << 20


def proxy_child(cfg: dict) -> int:
    """One proxied run, in a process that must never create a CUDA context:
    ``killed`` trains steps 1-6 and SIGKILLs the proxy after step 5 is
    issued; ``restored`` resumes from the killed run's step-4 image;
    ``paged`` trains steps 1-4 in a proxy whose device state is a managed
    space under ``cfg["capacity"]`` bytes and SIGKILLs it after step 3 is
    issued. The program spec, chunk size and kill step come in ``cfg``.
    Writes what it saw to ``cfg["out"]`` as JSON."""
    from repro_torch.checkpoint import ChunkStore
    from repro_torch.checkpoint.chunking import chunk_digest_np
    from repro_torch.core import CheckpointedTrainer, CheckpointPolicy, RestoreManager
    from repro_torch.utils.tree import flatten_with_paths, leaf_bytes, tree_digest

    tag = f"[{cfg.get('tag', 'proxy')}:{cfg['role']}]"
    cb, n_steps = cfg["chunk"], cfg.get("steps", cfg["spec"]["total_steps"])
    trainer = CheckpointedTrainer(
        None, store_root=cfg["store"],
        policy=CheckpointPolicy(interval_steps=2, keep_last=2),
        codec="none", chunk_bytes=cb, backend="fork",
        device_runner="proxy", program=cfg["spec"],
        proxy_opts={"fused_digests": True, "transport": "segment",
                    "workdir": cfg["workdir"]},
        device_capacity_bytes=cfg.get("capacity"), page_bytes=cfg.get("page_bytes"),
        eviction_policy=cfg.get("policy", "lru"),
    )
    runner = trainer.runner
    syncs, oracle = [], {}
    finish_sync = runner._finish_sync

    def recording(epoch, msg, *, stall_us):
        state, info = finish_sync(epoch, msg, stall_us=stall_us)
        syncs.append({k: info.get(k) for k in ("step", "chunks_synced", "stall_us",
                                               "phase_us", "paging")})
        if cfg["role"] == "killed" and not oracle and info.get("chunk_digests"):
            # the proxy's table (the CUDA kernel's digests of the step's
            # output) against the host oracle over the acknowledged mirror
            t0 = time.perf_counter()
            bad = total = 0
            for path, leaf in flatten_with_paths(state)[0].items():
                raw, got = leaf_bytes(leaf), info["chunk_digests"][path]
                want = [chunk_digest_np(raw[i : i + cb])
                        for i in range(0, max(raw.nbytes, 1), cb)]
                total += len(want)
                bad += sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))
            oracle.update(step=info["step"], chunks=total, mismatches=bad,
                          seconds=time.perf_counter() - t0)
        return state, info

    runner._finish_sync = recording
    step_calls = []  # the application's time per STEP call (pipelined)
    send_step = runner.step

    def timed_step(step: int) -> None:
        t = time.perf_counter()
        send_step(step)
        step_calls.append((time.perf_counter() - t) * 1e3)

    runner.step = timed_step
    t0 = time.perf_counter()
    if cfg["role"] != "restored":
        state, start = trainer.resume_or(
            lambda: {"device": None, "host": {"step": np.int64(0)}})
        startup_s = time.perf_counter() - t0
        killed = []

        def stop() -> bool:  # after the kill step is issued: SIGKILL the proxy once
            if int(state["host"]["step"]) == cfg["kill_after"] and not killed:
                killed.append(runner.kill())
            return False

        first, steps = 0, n_steps
    else:
        src = RestoreManager(ChunkStore(cfg["src_store"]))
        state, manifest = src.restore_into_proxy(runner, step=4)
        startup_s = time.perf_counter() - t0
        start, killed, stop = int(manifest.step), [], None
        first, steps = start, n_steps - start
    segment_dir = runner.segments.workdir
    what = "init on the host" if first == 0 else "restore_into_proxy: restore"
    print(f"{tag} segment_dir={segment_dir} start_step={start} "
          f"startup_s={startup_s:.1f} ({what} + spawn + upload)", flush=True)
    t1 = time.perf_counter()
    state = trainer.run(state, num_steps=steps, start_step=first, stop=stop)
    run_s = time.perf_counter() - t1
    results = trainer.finish()
    out = {
        "role": cfg["role"], "startup_s": startup_s, "run_s": run_s,
        "segment_dir": segment_dir,
        "final_step": int(state["host"]["step"]), "syncs": syncs, "oracle": oracle,
        "killed_pid": killed[0] if killed else None, "restarts": runner.restarts,
        "recoveries": [{k: r[k] for k in ("recovery_s", "replayed_steps", "resumed_from_step")}
                       for r in runner.recoveries],
        "app_step_ms": step_calls,
        "ckpts": [{"step": r.step, "blocking_ms": r.blocking_s * 1e3,
                   "persist_ms": r.persist_s * 1e3, "stall_ms": r.stall_us / 1e3,
                   "synced": r.chunks_synced, "error": r.error} for r in results],
        "digest": tree_digest(state["device"]),
        "cuda_initialized": torch.cuda.is_initialized(),
    }
    with open(cfg["out"], "w") as f:
        json.dump(out, f)
    return 0


def _uvm_mapped(pid: int) -> bool:
    """Whether a process maps ``/dev/nvidia-uvm``: every CUDA context does,
    a process that only asked the CUDA driver for its device count does not
    (False once the process is gone)."""
    try:
        with open(f"/proc/{pid}/maps") as f:
            return any("/dev/nvidia-uvm" in line for line in f)
    except OSError:
        return False


def _descendants(pid: int) -> list[int]:
    children: dict[int, list[int]] = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        children.setdefault(ppid, []).append(int(d))
    out, todo = [], [pid]
    while todo:
        kids = children.get(todo.pop(), [])
        out += kids
        todo += kids
    return out


def _card_contexts() -> int:
    """The contexts ``nvidia-smi`` lists on the card, this process's included."""
    r = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    return sum(bool(line.strip()) for line in r.stdout.splitlines())


def _run_proxy_child(cfg: dict, timeout: float) -> dict:
    """One proxied application, watched from this process while it runs:
    every half second, whether the application maps ``/dev/nvidia-uvm``
    (it must never), whether one of its descendants does (the proxy: this
    shows the check sees a context), and every few seconds how many
    contexts ``nvidia-smi`` lists (its PIDs are not this machine's, so the
    count is printed, not matched to a process)."""
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                             "--proxy-child", json.dumps(cfg)])
    watch = {"samples": 0, "app_contexts": 0, "proxy_contexts": 0, "smi_max": 0}
    deadline, smi_at = time.monotonic() + timeout, 0.0
    try:
        while proc.poll() is None:
            if time.monotonic() > deadline:
                raise SystemExit(f"proxied {cfg['role']} run passed {timeout:.0f} s")
            app = _uvm_mapped(proc.pid)
            proxy = any(_uvm_mapped(k) for k in _descendants(proc.pid))
            if proc.poll() is None:  # both reads saw the live application
                watch["samples"] += 1
                watch["app_contexts"] += app
                watch["proxy_contexts"] += proxy
            if time.monotonic() - smi_at > 2.0:
                watch["smi_max"] = max(watch["smi_max"], _card_contexts())
                smi_at = time.monotonic()
            time.sleep(0.5)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise SystemExit(f"proxied {cfg['role']} run failed ({proc.returncode})")
    with open(cfg["out"]) as f:
        return dict(json.load(f), watch=watch)


def phase_proxy(card: str) -> dict:
    from repro_torch.checkpoint import ChunkStore
    from repro_torch.core import RestoreManager
    from repro_torch.proxy import make_program
    from repro_torch.utils.tree import flatten_with_paths, tree_digest, tree_equal

    prog = make_program(PROXY_SPEC)
    meta = flatten_with_paths(prog.meta_state())[0]
    n_chunks = sum(-(-(t.numel() * t.element_size()) // PROXY_CHUNK) for t in meta.values())
    nbytes = prog.state_nbytes()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-proxy-") as tmp:
        shm = os.statvfs("/dev/shm") if os.path.isdir("/dev/shm") else None
        free = shm.f_bavail * shm.f_frsize if shm else 0
        workdir = None
        if free < 1.25 * nbytes:  # tmpfs is sparse: a full one is a SIGBUS
            workdir = os.path.join(tmp, "segments")
            os.makedirs(workdir)
        print(f"[proxy] {card} state_bytes={nbytes} chunks={n_chunks} "
              f"/dev/shm_free={free} -> segments in "
              f"{'/dev/shm' if workdir is None else workdir}", flush=True)
        base = {"workdir": workdir, "spec": PROXY_SPEC, "chunk": PROXY_CHUNK}
        killed = _run_proxy_child(dict(base, role="killed", kill_after=5,
                                       store=os.path.join(tmp, "a"),
                                       out=os.path.join(tmp, "a.json")), 600)
        restored = _run_proxy_child(dict(base, role="restored", store=os.path.join(tmp, "b"),
                                         src_store=os.path.join(tmp, "a"),
                                         out=os.path.join(tmp, "b.json")), 400)

        # the same program on the card, from the same host-built init, inline
        state = prog.on_restore(prog.init_state())
        torch.cuda.synchronize()
        step_ms = []
        for step in range(1, STEPS + 1):
            t0 = time.perf_counter()
            state, metrics = prog.step(state, step)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        # the fused digest alone, as a proxied step ends with it
        from repro_torch.kernels import ops

        fused_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            ops.tree_chunk_digests(state, PROXY_CHUNK)
            fused_ms.append((time.perf_counter() - t0) * 1e3)
        inline_digest = tree_digest(state)
        same = {}
        for name, root in (("killed_image", "a"), ("restored_image", "b")):
            store = ChunkStore(os.path.join(tmp, root))
            image, _ = RestoreManager(store).restore(step=6)
            same[name] = tree_equal(image["device"], state)
            del image
        same["restored_state"] = restored["digest"] == inline_digest
        same["killed_state"] = killed["digest"] == inline_digest
        # committed images of the killed run: 2 was collected (keep_last=2)
        kept = RestoreManager(ChunkStore(os.path.join(tmp, "a"))).available_steps()
        del state
        torch.cuda.empty_cache()

    runs = (killed, restored)
    for run in runs:
        tag = f"[proxy:{run['role']}]"
        for c in run["ckpts"]:
            print(f"{tag} {card} ckpt step={c['step']} blocking_ms={c['blocking_ms']:.1f} "
                  f"persist_ms={c['persist_ms']:.1f} stall_ms={c['stall_ms']:.1f} "
                  f"synced={c['synced']}", flush=True)
        for i, sy in enumerate(run["syncs"]):
            ph = sy["phase_us"]
            print(f"{tag} {card} synced step={sy['step']} chunks_synced={sy['chunks_synced']} "
                  f"prehashed={ph.get('prehashed_chunks')} steps={ph.get('steps')} "
                  f"digest_launches={ph.get('digest_launches')} "
                  f"proxy_step_ms={ph.get('step', 0) / 1e3 / max(ph.get('steps', 0), 1):.1f} "
                  f"phase_ms digest={ph.get('digest', 0) / 1e3:.1f} "
                  f"fetch={ph.get('fetch', 0) / 1e3:.1f} sync={ph.get('sync', 0) / 1e3:.1f} "
                  f"state_digest={ph.get('state_digest', 0) / 1e3:.1f} "
                  f"stall_ms={sy['stall_us'] / 1e3:.1f}", flush=True)
        for r in run["recoveries"]:
            print(f"{tag} {card} recovery_s={r['recovery_s']:.2f} "
                  f"replayed_steps={r['replayed_steps']} "
                  f"resumed_from_step={r['resumed_from_step']}", flush=True)
        w = run["watch"]
        print(f"{tag} {card} startup_s={run['startup_s']:.1f} run_s={run['run_s']:.1f} "
              f"restarts={run['restarts']} app_step_ms="
              f"{' '.join(f'{t:.3f}' for t in run['app_step_ms'])} "
              f"segment_dir={run['segment_dir']} "
              f"cuda_initialized_in_app={run['cuda_initialized']} "
              f"watched {w['samples']} times: app_with_context={w['app_contexts']} "
              f"proxy_with_context={w['proxy_contexts']} "
              f"nvidia_smi_contexts_max={w['smi_max']} (this process's included)", flush=True)
    # warm steps only: the first step of a process (inline) or of a proxy
    # incarnation carries its warm-up
    proxied = [t / 1e3 for run in runs for sy in run["syncs"]
               for t in sy["phase_us"]["step_each"][1 if sy["phase_us"]["warm_up"] else 0:]]
    inline = step_ms[1:]

    def summary(ts):
        return (f"n={len(ts)} mean={sum(ts) / len(ts):.1f} min={min(ts):.1f} "
                f"max={max(ts):.1f} [{' '.join(f'{t:.1f}' for t in ts)}]")

    o = killed["oracle"]
    print(f"[proxy] {card} warm step_ms inline {summary(inline)}; proxied (fused "
          f"digest included) {summary(proxied)}; first steps inline={step_ms[0]:.1f} "
          f"fused_digest_ms={' '.join(f'{t:.1f}' for t in fused_ms)} "
          f"restore_into_proxy_s={restored['startup_s']:.1f} "
          f"kernel_vs_host_oracle step={o.get('step')} chunks={o.get('chunks')} "
          f"mismatches={o.get('mismatches')} ({o.get('seconds', 0):.1f}s on the host) "
          f"bitwise={same}", flush=True)

    launches = steps = 0
    for run in runs:
        w = run["watch"]
        if run["cuda_initialized"] or w["app_contexts"]:
            raise SystemExit(f"the {run['role']} application created a CUDA context: "
                             f"{run['cuda_initialized']} {w}")
        if not w["proxy_contexts"]:
            raise SystemExit(f"{run['role']}: the watch never saw the proxy's context: {w}")
        if any(c["error"] for c in run["ckpts"]):
            raise SystemExit(f"{run['role']}: a checkpoint failed: {run['ckpts']}")
        if run["final_step"] != STEPS:
            raise SystemExit(f"{run['role']} stopped at step {run['final_step']}")
        for sy in run["syncs"][1:]:
            ph = sy["phase_us"]
            if ph.get("prehashed_chunks") != n_chunks:
                raise SystemExit(f"{run['role']}: SYNCED at step {sy['step']} prehashed "
                                 f"{ph.get('prehashed_chunks')} of {n_chunks} chunks")
        for sy in run["syncs"]:
            ph = sy["phase_us"]
            if ph.get("digest_launches") != ph.get("steps"):
                raise SystemExit(f"{run['role']}: {ph.get('digest_launches')} digest "
                                 f"launches for {ph.get('steps')} steps")
            launches += ph.get("digest_launches", 0)
            steps += ph.get("steps", 0)
    if killed["restarts"] != 1 or not killed["recoveries"] or \
            killed["recoveries"][0]["replayed_steps"] < 1 or killed["killed_pid"] is None:
        raise SystemExit(f"killed run: restarts={killed['restarts']} "
                         f"recoveries={killed['recoveries']}")
    if [c["step"] for c in killed["ckpts"]] != [2, 4, 6] or kept != [4, 6]:
        raise SystemExit(f"killed run wrote images at {[c['step'] for c in killed['ckpts']]}")
    if restored["restarts"] != 0 or [c["step"] for c in restored["ckpts"]] != [6]:
        raise SystemExit(f"restored run: {restored['restarts']} restarts, "
                         f"images {[c['step'] for c in restored['ckpts']]}")
    if not o or o["mismatches"] or o["chunks"] != n_chunks:
        raise SystemExit(f"the proxy's chunk digests disagree with the host oracle: {o}")
    if not all(same.values()):
        raise SystemExit(f"proxied runs and the inline run differ: {same}")
    if launches <= 0:
        raise SystemExit("the proxy path never launched the chunk_digest kernel")
    return {"launches": launches, "steps": steps}


UVM_CAPACITY, UVM_PAGE = "50%", 64 << 10
_UVM_COUNTERS = ("faults", "evictions", "writebacks", "h2d_bytes", "d2h_bytes")


@contextlib.contextmanager
def _watch_uvm():
    """Times every managed-space device read, write and peek (each between
    two synchronizes) with the paging counters it moved, and every
    checkpoint's phase 1 with the chunk_digest launches its sync made —
    from outside the code: the methods are wrapped, nothing in the port
    measures for this."""
    from repro_torch.core.forked import ForkedCheckpointer
    from repro_torch.kernels import chunk_digest
    from repro_torch.uvm import ManagedSpace

    log = {"read_state": [], "write_state": [], "peek_state": [], "ckpt": [], "spaces": []}
    saved = {name: getattr(ManagedSpace, name) for name in log if name.endswith("state")}
    save_async = ForkedCheckpointer.save_async

    def wrap(name):
        fn = saved[name]

        def timed(self, *args, **kwargs):
            if not any(sp is self for sp in log["spaces"]):
                log["spaces"].append(self)
            torch.cuda.synchronize()
            before = self.stats.as_dict()
            t0 = time.perf_counter()
            out = fn(self, *args, **kwargs)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            after = self.stats.as_dict()
            log[name].append(dict(t0=t0, t1=t1, ms=(t1 - t0) * 1e3,
                                  **{k: after[k] - before[k] for k in _UVM_COUNTERS}))
            return out
        return timed

    def counted_save(self, step, state, **kwargs):
        before = chunk_digest.chunk_digests.launches
        t0 = time.perf_counter()
        r = save_async(self, step, state, **kwargs)
        log["ckpt"].append(dict(step=step, t0=t0, t1=time.perf_counter(), result=r,
                                launches=chunk_digest.chunk_digests.launches - before))
        return r

    for name in saved:
        setattr(ManagedSpace, name, wrap(name))
    ForkedCheckpointer.save_async = counted_save
    try:
        yield log
    finally:
        for name, fn in saved.items():
            setattr(ManagedSpace, name, fn)
        ForkedCheckpointer.save_async = save_async


def _uvm_steps(log, card: str, first_step: int) -> list[dict]:
    """One row per managed step of a watched run: wall (from its page-in
    to the next step's, the last to its checkpoint's end), page-in,
    page-out, the counters they moved, and its checkpoint's phase 1 with
    the peek that preceded it."""
    reads, writes = log["read_state"], log["write_state"]
    events = reads + writes + log["peek_state"] + log["ckpt"]
    rows = []
    for i, (rd, wr) in enumerate(zip(reads, writes)):
        end = reads[i + 1]["t0"] if i + 1 < len(reads) else max(
            e["t1"] for e in events if e["t0"] >= rd["t0"])
        row = {"step": first_step + i + 1, "wall_ms": (end - rd["t0"]) * 1e3,
               "page_in_ms": rd["ms"], "page_out_ms": wr["ms"],
               **{k: rd[k] + wr[k] for k in _UVM_COUNTERS}}
        ck = [c for c in log["ckpt"] if wr["t1"] <= c["t0"] <= end]
        if ck:
            c = ck[0]
            peek = [p for p in log["peek_state"] if wr["t1"] <= p["t0"] <= c["t0"]]
            row.update(ckpt=True, blocking_ms=c["result"].blocking_s * 1e3,
                       synced=c["result"].chunks_synced, digest_launches=c["launches"],
                       peek_ms=sum(p["ms"] for p in peek),
                       peek_d2h_bytes=sum(p["d2h_bytes"] for p in peek))
        rows.append(row)
    body = [r["wall_ms"] for r in rows if "ckpt" not in r]
    for r in rows:
        line = (f"[uvm] {card} step={r['step']} wall_ms={r['wall_ms']:.1f} "
                f"page_in_ms={r['page_in_ms']:.1f} page_out_ms={r['page_out_ms']:.1f} "
                f"faults={r['faults']} evictions={r['evictions']} "
                f"writebacks={r['writebacks']} h2d_bytes={r['h2d_bytes']} "
                f"d2h_bytes={r['d2h_bytes']}")
        if "ckpt" in r:
            rest = r["wall_ms"] - (sum(body) / len(body) if body else 0.0) - r["blocking_ms"]
            line += (f" | ckpt blocking_ms={r['blocking_ms']:.1f} peek_ms={r['peek_ms']:.1f} "
                     f"(wall - mean plain step - blocking = {rest:.1f}) "
                     f"chunks_synced={r['synced']} digest_launches={r['digest_launches']}")
        print(line, flush=True)
    return rows


def _cpu_tree(tree):
    from repro_torch.utils.tree import flatten_with_paths, unflatten_from_paths

    flat, treedef = flatten_with_paths(tree)
    return unflatten_from_paths(treedef, {
        p: v.cpu() if isinstance(v, torch.Tensor) else v for p, v in flat.items()})


def phase_uvm(card: str, unmanaged6) -> dict:
    """Managed memory (``[uvm]``): the train CLI with ``--device-capacity
    50%`` (64 KiB pages, LRU), the restart from its step-4 image, Table 2
    (forked phase 1 against ``save_sync``) on the managed state, and the
    same budget inside a proxy that is SIGKILLed once."""
    import gc

    from repro_torch.checkpoint import ChunkStore
    from repro_torch.configs import get_config
    from repro_torch.core import (CheckpointedTrainer, CheckpointPolicy,
                                  ForkedCheckpointer, RestoreManager)
    from repro_torch.data import SyntheticBatches
    from repro_torch.launch import train
    from repro_torch.launch.train import build_training
    from repro_torch.proxy import make_program
    from repro_torch.runtime.steps import batch_to_device
    from repro_torch.utils.tree import tree_equal

    cuda = torch.device("cuda", torch.cuda.current_device())
    cfg = get_config(ARCH)
    run = build_training(cfg, batch=BATCH, seq=SEQ, lr=LR, total_steps=STEPS, device=cuda)
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-uvm-") as tmp:
        store = os.path.join(tmp, "ckpt")
        argv = ["--arch", ARCH, "--steps", str(STEPS), "--batch", str(BATCH),
                "--seq", str(SEQ), "--lr", str(LR), "--ckpt-every", "2", "--backend", "fork",
                "--codec", "none", "--log-every", "1", "--ckpt-dir", store,
                "--device-capacity", UVM_CAPACITY, "--page-bytes", str(UVM_PAGE),
                "--eviction-policy", "lru"]
        _zero_counts()
        t0 = time.perf_counter()
        with _watch_uvm() as log:
            res = train.train(argv)
        wall = time.perf_counter() - t0
        counts = _counts()
        space = log["spaces"][0]
        paging = res["paging"]
        cap = paging["device_capacity_bytes"]
        rows = _uvm_steps(log, card, 0)
        for r in res["results"]:
            print(f"[uvm] {card} ckpt step={r.step} blocking_ms={r.blocking_s * 1e3:.1f} "
                  f"persist_ms={r.persist_s * 1e3:.1f} synced={r.chunks_synced} "
                  f"written={r.chunks_written} digest_ms={r.digest_us / 1e3:.1f}", flush=True)
        space.check_invariants()
        managed6 = res["state"]["device"]
        same6 = tree_equal(managed6, unmanaged6)
        print(f"[uvm] {card} cli wall_s={wall:.1f} loss={res['metrics']['loss']:.4f} "
              f"capacity={cap} state={paging['total_bytes']} "
              f"resident_high_water={paging['resident_high_water']} "
              f"faults={paging['faults']} evictions={paging['evictions']} "
              f"writebacks={paging['writebacks']} h2d_bytes={paging['h2d_bytes']} "
              f"d2h_bytes={paging['d2h_bytes']} chunk_digest_launches={counts['chunk_digest']} "
              f"flash_attention_launches={counts['flash_attention']} invariants=clean "
              f"step6_bitwise_equal_to_unmanaged={same6}", flush=True)
        if paging["evictions"] <= 0 or paging["resident_high_water"] > cap:
            raise SystemExit(f"managed run did not page under its budget: {paging}")
        if counts["chunk_digest"]:
            raise SystemExit(f"a page-delta sync launched chunk_digest "
                             f"{counts['chunk_digest']} times")
        if not same6:
            raise SystemExit("managed step-6 state differs from the unmanaged one")
        del space, log, res
        gc.collect()
        torch.cuda.empty_cache()

        # restart: the managed step-4 image, run to step 6 under the budget
        def managed_trainer(root, interval, **kw):
            return CheckpointedTrainer(
                run.step_fn, store_root=root,
                policy=CheckpointPolicy(interval_steps=interval, keep_last=2),
                codec="none", chunk_bytes=1 << 20, backend="fork",
                device_capacity_bytes=cap, page_bytes=UVM_PAGE, eviction_policy="lru",
                device=cuda, **kw)

        def batches(state):
            data = SyntheticBatches.from_state(cfg, batch=BATCH, seq_len=SEQ,
                                               state=state["host"]["data"])
            while True:
                batch = batch_to_device(next(data), cuda)
                state["host"]["data"] = data.state()
                yield batch

        state, _ = RestoreManager(ChunkStore(store)).restore(
            step=4, device_for=lambda p, s: "cpu" if p.startswith("device/") else None)
        tr = managed_trainer(os.path.join(tmp, "restart"), 1000)
        state = tr.run(state, batches(state), num_steps=2, start_step=4)
        tr.finish()
        same_restart = tree_equal(state["device"], managed6)
        print(f"[uvm] {card} restored step 4, ran 5..6 managed: "
              f"bitwise_equal={same_restart}", flush=True)
        if not same_restart:
            raise SystemExit("managed restart diverged from the managed step-6 state")
        del tr, state
        gc.collect()
        torch.cuda.empty_cache()

        # the inline (unmanaged) step on the card, in this call: the same
        # step-4 image placed on the card, steps 5 and 6 synchronised
        state, _ = RestoreManager(ChunkStore(store)).restore(step=4, device_for=run.device_for)
        inline_ms = []
        feed = batches(state)
        for _ in range(2):
            batch = next(feed)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state["device"], _ = run.step_fn(state["device"], batch)
            torch.cuda.synchronize()
            inline_ms.append((time.perf_counter() - t0) * 1e3)
        same_inline = tree_equal(state["device"], managed6)
        plain = {r["step"]: r["wall_ms"] for r in rows if "ckpt" not in r and r["step"] > 1}
        ratio = (sum(plain.values()) / len(plain)) / (sum(inline_ms) / len(inline_ms))
        print(f"[uvm] {card} step_ms managed (warm, no checkpoint: steps {list(plain)}) "
              f"{' '.join(f'{t:.1f}' for t in plain.values())}; inline on the card "
              f"(steps 5, 6 from the step-4 image) {' '.join(f'{t:.1f}' for t in inline_ms)}; "
              f"managed/inline={ratio:.1f} inline_step6_bitwise_equal={same_inline}", flush=True)
        if not same_inline:
            raise SystemExit("the managed step-4 image stepped inline differs at step 6")
        del state, feed, managed6
        gc.collect()
        torch.cuda.empty_cache()

        # Table 2 on the managed state: forked phase 1 at step 8 against the
        # naive synchronous save at step 10, each the first sync of its buffer
        tr = managed_trainer(store, 2)
        state, start = tr.resume_or(run.init_state)
        if start != STEPS:
            raise SystemExit(f"Table 2 resumed from step {start}, not {STEPS}")
        state = tr.run(state, batches(state), num_steps=2, start_step=start)
        forked = tr.results[-1]
        tr.checkpointer.wait_all()  # its persist does not share the disk with the next
        tr.policy.interval_steps = 1000
        state = tr.run(state, batches(state), num_steps=2, start_step=start + 2)
        tr.materialize(state)
        naive = ForkedCheckpointer(ChunkStore(store), codec="none", chunk_bytes=1 << 20,
                                   backend="fork",
                                   dirty_source=tr.space.as_dirty_source("device/"))
        sync = naive.save_sync(start + 4, state)
        naive.close()
        tr.finish()
        if forked.step != start + 2 or forked.error or sync.error:
            raise SystemExit(f"Table 2 checkpoints failed: {forked.step} {forked.error} "
                             f"{sync.error}")
        out["table2"] = {"forked_blocking_ms": forked.blocking_s * 1e3,
                         "forked_persist_ms": forked.persist_s * 1e3,
                         "sync_ms": sync.blocking_s * 1e3}
        t2 = out["table2"]
        t2["speedup_vs_naive"] = t2["sync_ms"] / t2["forked_blocking_ms"]
        print(f"[uvm:table2] {card} forked_blocking_ms={t2['forked_blocking_ms']:.1f} "
              f"(step {forked.step}, persist_ms={t2['forked_persist_ms']:.1f}) "
              f"sync_ms={t2['sync_ms']:.1f} (save_sync step {sync.step}: phase 1 + "
              f"persist) speedup_vs_naive={t2['speedup_vs_naive']:.2f}", flush=True)
        del tr, state, naive
        gc.collect()
        torch.cuda.empty_cache()

        # the same budget inside a proxy, killed once after step 3 is issued,
        # held against an inline managed run of the same program
        prog = make_program(UVM_SPEC)
        pcap = train._resolve_capacity(UVM_CAPACITY, prog.state_nbytes())
        shm = os.statvfs("/dev/shm") if os.path.isdir("/dev/shm") else None
        workdir = None
        if (shm.f_bavail * shm.f_frsize if shm else 0) < 1.25 * prog.state_nbytes():
            workdir = os.path.join(tmp, "segments")
            os.makedirs(workdir)
        paged = _run_proxy_child({
            "workdir": workdir, "spec": UVM_SPEC, "chunk": PROXY_CHUNK, "tag": "uvm",
            "role": "paged", "kill_after": 3, "steps": 4, "capacity": pcap,
            "page_bytes": UVM_PAGE, "policy": "lru", "store": os.path.join(tmp, "paged"),
            "out": os.path.join(tmp, "paged.json")}, 900)
        _zero_counts()
        tr = CheckpointedTrainer(
            lambda d, n: prog.step(d, n), store_root=os.path.join(tmp, "inline"),
            policy=CheckpointPolicy(interval_steps=1000), device_capacity_bytes=pcap,
            page_bytes=UVM_PAGE, eviction_policy="lru", device=cuda)
        t0 = time.perf_counter()
        state = {"device": prog.init_state(), "host": {"step": np.int64(0)}}
        state = tr.run(state, iter(range(1, 5)), num_steps=4)
        tr.finish()
        inline_s = time.perf_counter() - t0
        inline_counts = _counts()
        image, _ = RestoreManager(ChunkStore(os.path.join(tmp, "paged"))).restore(step=4)
        same_paged = tree_equal(image["device"], state["device"])
        del tr, state, image
    for sy in paged["syncs"]:
        ph, pg = sy["phase_us"], sy.get("paging") or {}
        print(f"[uvm:paged] {card} synced step={sy['step']} chunks_synced={sy['chunks_synced']} "
              f"prehashed={ph.get('prehashed_chunks')} steps={ph.get('steps')} "
              f"digest_launches={ph.get('digest_launches')} "
              f"flash_launches={ph.get('flash_launches')} "
              f"proxy_step_ms={ph.get('step', 0) / 1e3 / max(ph.get('steps', 0), 1):.1f} "
              f"page_in_ms={ph.get('page_in', 0) / 1e3:.1f} "
              f"page_out_ms={ph.get('page_out', 0) / 1e3:.1f} "
              f"peek_ms={ph.get('peek', 0) / 1e3:.1f} sync_ms={ph.get('sync', 0) / 1e3:.1f} "
              f"faults={pg.get('faults')} evictions={pg.get('evictions')} "
              f"h2d_bytes={pg.get('h2d_bytes')} d2h_bytes={pg.get('d2h_bytes')}", flush=True)
    for c in paged["ckpts"]:
        print(f"[uvm:paged] {card} ckpt step={c['step']} blocking_ms={c['blocking_ms']:.1f} "
              f"persist_ms={c['persist_ms']:.1f} stall_ms={c['stall_ms']:.1f} "
              f"synced={c['synced']}", flush=True)
    w = paged["watch"]
    print(f"[uvm:paged] {card} capacity={pcap} startup_s={paged['startup_s']:.1f} "
          f"run_s={paged['run_s']:.1f} restarts={paged['restarts']} "
          f"recoveries={paged['recoveries']} inline_managed_s={inline_s:.1f} "
          f"(launches there: {inline_counts['chunk_digest']} chunk_digest, "
          f"{inline_counts['flash_attention']} flash_attention) "
          f"watched {w['samples']} times: app_with_context={w['app_contexts']} "
          f"proxy_with_context={w['proxy_contexts']} "
          f"step4_image_bitwise_equal_to_inline_managed={same_paged}", flush=True)
    launches = sum(sy["phase_us"].get("digest_launches", 0) for sy in paged["syncs"])
    flash = sum(sy["phase_us"].get("flash_launches", 0) for sy in paged["syncs"])
    if paged["restarts"] != 1 or not paged["recoveries"] or paged["killed_pid"] is None:
        raise SystemExit(f"paged proxy: restarts={paged['restarts']} "
                         f"recoveries={paged['recoveries']}")
    if paged["cuda_initialized"] or w["app_contexts"] or not w["proxy_contexts"]:
        raise SystemExit(f"paged proxy: the application's CUDA context watch failed: "
                         f"{paged['cuda_initialized']} {w}")
    if [c["step"] for c in paged["ckpts"]] != [2, 4] or any(c["error"] for c in paged["ckpts"]):
        raise SystemExit(f"paged proxy checkpoints: {paged['ckpts']}")
    for sy in paged["syncs"]:
        ph = sy["phase_us"]
        if not sy.get("paging") or sy["paging"]["resident_high_water"] > pcap:
            raise SystemExit(f"paged proxy SYNCED at step {sy['step']}: {sy.get('paging')}")
        if ph.get("digest_launches") != ph.get("steps"):
            raise SystemExit(f"paged proxy: {ph.get('digest_launches')} digest launches "
                             f"for {ph.get('steps')} steps")
    if not same_paged:
        raise SystemExit("the paged proxy's step-4 image differs from the inline managed one")
    return dict(out, launches_inline={"chunk_digest": counts["chunk_digest"],
                                      "flash_attention": counts["flash_attention"]},
                launches_proxy={"chunk_digest": launches, "flash_attention": flash})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--codec", default="none",
                    help="checkpoint codec of the main path (default: none)")
    ap.add_argument("--proxy-child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.proxy_child is not None:
        return proxy_child(json.loads(args.proxy_child))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import repro_torch.kernels  # noqa: F401  (fails first outside a checkout)

    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = phase_card()
    phase_sweep()
    phase_flash_sweep()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as tmp:
        store = os.path.join(tmp, "ckpt")
        final_state, launches = phase_main_path(store, args.codec)
        device_state = phase_restart(store, final_state)
        del final_state
        served = phase_serve(store)
    rows = [phase_timing(device_state, launches)]
    unmanaged6 = _cpu_tree(device_state)  # the [uvm] phase's reference
    del device_state
    rows.append(phase_flash_timing(served["launches"]))
    proxied = phase_proxy(card)
    # the proxy path's own count: the fused digest's launches in the proxy
    # processes, from their SYNCED frames (one per proxied step)
    rows[0]["launches_proxy"] = proxied["launches"]
    uvm = phase_uvm(card, unmanaged6)
    for row in rows:  # each kernel's launches on the managed paths
        row["launches_uvm_inline"] = uvm["launches_inline"][row["name"]]
        row["launches_uvm_proxy"] = uvm["launches_proxy"][row["name"]]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
