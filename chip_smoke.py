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
   route) and bf16/f16 (the tensor-core route), head dims 32/64/128/256, a
   ``scale`` override, rows with no key (Sq > Sk), a group of 7 with ragged
   tiles, the prefix-LM mask (``prefix_len`` inside one key tile, across
   tiles, with rows that have no causal key, at and past Sk, at head dims
   64/128/256) and the serve path's own shapes, with a stated tolerance per dtype
   that must catch a dropped key tile (and the reading of a P rounded once
   to bf16, which is why the kernel splits P in two); ``[flash-bwd-sweep]``:
   the forward's row statistics m and l against
   ``flash_attention_plain(return_stats=True)`` (and its output with them
   bitwise the one without), and the backward kernels (tensor cores for
   bf16/f16: dq, dk and dv per q head, the sum over each group; CUDA cores
   for f32: dq, then dk and dv) on the forward kernel's output and
   statistics against ``flash_attention_bwd_plain`` on the plain forward's,
   over the same kinds of shapes, causal and not, groups of 1, 4, 7 and
   12, rows with no key (m -1e30, dq exactly 0), head dims 32/64/128/256
   (gemma-2b's heads: 8 q, 1 kv), the prefix-LM mask (a prefix of 1, of
   16 and longer than a tile, with ragged Sq and Sk, at head dims 64, 128
   and 256), the model's transposed v and both training shapes
   (qwen2-0.5b's, and paligemma-3b's ``hd256p`` with the image a prefix;
   run to run bitwise), with
   stated tolerances that must read a dk missing one head of the group, a
   dq missing one key tile and m in log base 2 more than 10x over, and a
   limit scaled per 64-row tile that must hold everywhere and read the
   last rows' dq without a key tile, and the last key tile's dk without
   one head's partial, over it; ``[build]`` prints each backward kernel's
   registers and spills (``-Xptxas -v``), and both kernels' at head dim
   256 on both routes, and fails on a spill;
3. the training path through ``repro_torch.launch.train``: qwen2-0.5b at full
   width and depth, batch 4, seq 512, 6 steps, a checkpoint every 2 steps
   with the fork persist backend. The codec is ``none`` by default, not the
   CLI's ``pgzip``, on purpose: it measures the card's path and leaves out
   host compression, which at ``pgzip`` compresses 4.94 GB per checkpoint
   on the host and takes most of the time limit (``--codec pgzip`` runs the
   CLI default). Every kernel's launch count is zeroed just before and
   read just after; ``chunk_digest``'s must be > 0, and every shadow sync
   that digests must make at most ceil(tensor leaves / capacity) launches
   (1 for the 43 leaves of this state); each ``[ckpt]`` line splits its
   phase-1 fetch into allocation, page faults (a buffer's first sync
   faults its pages in on torch's threads) and copy;
4. restart: restore step 4 onto the card, run steps 5 and 6, and require
   the state to equal the stored step-6 image bit for bit (that image is
   restored with ``verify``, which re-digests every chunk on the host);
5. the serving path through ``repro_torch.launch.serve``: lazy restore of
   the step-6 params onto the card, prefill of 2 x 8192 tokens (every
   layer's attention is one flash launch on the tensor-core route: 24 per
   prefill, zeroed just before and read just after), 32 greedy tokens; an eager serve must give
   the same bits, and the 32 served logits must lie no further from the
   f32 model's than one bf16 forward over prompt + 31 served tokens (the
   dense lowering) does (teacher forcing). ``[serve:proxy]``: the serve CLI
   with ``--device-runner proxy`` on the step-6 params cut to their first
   2 of 24 layers (full width; a cut for the script's time), written by a
   ``save_sync`` as an image of their own (the CLI serves an image at its
   depth) (lazy restore onto
   the CPU, batch 2, prompt 144, 32 generated tokens: 175 proxied
   ``decode_arch`` steps; the greedy tokens must not be all one token, so a
   misplaced or dropped token write shows), in a child process that
   must never create a CUDA context: once with a local proxy (segment
   transport) SIGKILLed after step 80 is issued, which must restart once
   and replay, once against a ``repro_torch.remote.host`` daemon on the
   card (stream transport; raw frames where ``zstandard`` is missing). Both
   runs' tokens and synced cache must equal ``decode_arch`` stepped inline
   in this process from the same params bit for bit, each proxied step
   must make one fused ``chunk_digest`` launch (counted in its session) and
   no flash launch, and the final SYNC must move no params chunk. Printed
   per run: push s, decode tok/s, recovery s, the proxy's step ms, the
   sync's chunks and bytes and the wire bytes;
6. each kernel's time on the card at its path's shapes (``chunk_digest``:
   one grouped call over the 43 leaves of the train state in 1 MiB chunks,
   the table's allocation included, as a sync makes it, beside the same
   kernel called once per leaf, ``per_leaf_ms``; ``flash_attention``: one
   layer of the prefill), its bound, the plain version's time and, for
   attention, ``scaled_dot_product_attention``'s (the kernel's ratio to it
   and its share of the bound on the ``[timing] flash`` line; a second
   line times one layer of ``[moe]``'s prefill, q = k = v (2, 16, 8192,
   128), the row's ``hd128``, a third one application of ``[hybrid]``'s
   shared block, q = k = v (2, 32, 8192, 64), the row's ``mha64``, a
   fourth one layer of ``[multimodal]``'s paligemma prefill, q (2, 8,
   8192, 256), k = v (2, 1, 8192, 256) with the image's 256 patches a
   prefix, the row's ``hd256p``, against the library with the boolean
   prefix-or-causal mask (the backend that ran named) and, for reference,
   ``is_causal``),
   printed as
   one ``{"kernels": [...]}`` JSON line, printed at the end with each
   kernel's launches on every later path too (``launches_train_long``,
   ``launches_proxy``, ``_uvm_inline``, ``_uvm_proxy``, ``_serve_proxy``,
   ``_cluster``, ``_cluster_proxy``, ``_cluster_remote``, ``_moe``,
   ``_multimodal_long``, ``_hybrid``, ``_multimodal``: counted where
   they ran; the backward's are null on paths counted in other processes,
   which report the digest and the forward only, at seq 512);
   ``[train:long]``: the train CLI on qwen2-0.5b at full width and depth,
   batch 2, seq 8192 (above ``attn_chunked_threshold``), ``remat="dots"``
   as configured, 4 steps, fork checkpoints at 2 and 4, codec none: per
   step its ms, peak card memory and exactly 48 forward launches (24, and
   24 that remat recomputes in the backward), 24 backward calls (each
   launching its three kernels) and no digest launch, all of them counted
   for the step's thread too; no digest launch at either sync (each its
   buffer's first); the step-4 image's chunk digests those of the run's
   state, and the step-2 image run to step 4 bitwise equal to that state;
   from it, one step under ``remat="none"`` bitwise equal to ``"dots"``
   (both peaks printed), ``microbatches=2``'s loss and grads bitwise the
   mean of its halves', each leaf's grads within the stated limits of
   mb=1's in bf16 and, with the weights upcast, in f32, the step within
   the limits of mb=1's (loss, grad norm, updated params) and two mb=2
   steps bitwise equal.
   ``[timing] flash-bwd``: the backward at one layer of that shape, each
   of its kernels' device time (the profiler must trace each once a call,
   and gives the row's ``kernels_per_launch``), its scratch, its bound
   (five products), its plain version and the library's fused attention
   backward (forward + backward minus forward, with and without
   deterministic algorithms), the ``flash_attention_bwd`` row of the JSON;
   a second line at one layer of paligemma-3b at batch 2, q (2, 8, 8192,
   256), k = v (2, 1, 8192, 256), the image's 256 patches a prefix, the
   row's ``hd256p`` (the library with the boolean prefix-or-causal mask
   and with ``is_causal``);
7. the proxy path (``[proxy]``): qwen2-0.5b at full width and 2 of its
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
   ``[uvm:paged]``: the proxy program cut to 2 of its 24 layers (full
   width; a cut for the script's time) with the same budget in
   a proxy process, 4 steps, checkpoints at 2 and 4, SIGKILLed once after
   step 3 is issued: one restart, ``paging`` in every SYNCED, one digest
   launch per step, no ``/dev/nvidia-uvm`` in the application, and its
   step-4 image bitwise equal to the same program run 4 steps inline
   through a managed trainer. ``[moe]``: the MoE family on moonshot-v1-
   16b-a3b at full width (d_model 2048, 16 heads x 128, 64 experts top-6,
   d_ff 1408, vocab 163,840, capacity 1.25, bf16 with the f32 router), cut
   to 1 of its 48 layers for the script's time (9.06 GB of state under
   AdamW): the train CLI at batch 4, seq 512, the config's 2 microbatches
   and ``remat="dots"``, 6 steps, fork checkpoints at 2, 4 and 6, codec
   none (per step its ms, peak GB, loss, aux, CE and dropped-slot share;
   per checkpoint blocking, persist, digest ms and ``chunk_digest``
   launches: 0 at the two first syncs, one grouped launch at 6; no
   attention kernel at seq 512); the step-6 image's digests the run's
   state's, the grouped digest over the whole state bitwise equal to
   ``chunk_digests_plain`` leaf by leaf, the step-4 image run to 6 bitwise
   equal to it; the serve CLI
   on the step-6 image at its depth (lazy, batch 2, 8,192-token prompt,
   32 greedy tokens; one ``wgmma`` flash launch per layer at head dim 128;
   eager the same bits). A forward drops slots over capacity and a decode
   step never does, so the served logits are held, not to a teacher-forced
   forward, but to the same prefill and decode in the f32 upcast of the
   params, within the bf16 forward's distance from the f32 forward over
   the prompt; the prefill's last logits must equal the forward over the
   prompt (the same routing groups) bit for bit, and the forward's dropped
   slots are printed. Its two images (18 GB) go when it ends.
   ``[multimodal:long]``: paligemma-3b at full width and 2 of its 18
   layers (as ``[multimodal]`` cuts it) trained by the train CLI at batch
   1 over 256 patches + 7,936 text tokens (8,192 positions: the chunked
   lowering, the flash forward and backward at head dim 256 with
   ``prefix_len`` 256), ``remat="dots"``, 4 steps, one fork checkpoint
   at step 2, codec none: per step exactly 2 x 2 forward launches and 2
   backward calls on the tensor-core routes, counted for the step's
   thread too, finite loss and gradient norm, its ms and peak GB; the
   step-2 image run to step 4 bitwise equal to the run;
9. the cluster (``[cluster]``): ``repro_torch.coord.run_cluster`` with 2
   ranks on the card, each a spawned process holding a full replica of
   qwen2-0.5b at full width and 2 of its 24 layers (the train program of
   3, cut for the script's time), 6 steps,
   checkpoints at 2/4/6, fork, codec ``none``, 1 MiB chunks; each rank
   persists only its windows (views of its card tensors, digested on the
   card) and the coordinator two-phase-commits the merged image. Rank 1 is
   killed at step 4 after READY: round 4 must abort naming host 1, its
   retry commit, the respawned rank restore step 2 (once), a
   ``worker_death`` alert be journaled, and the ranks finish in lockstep.
   This process runs the same program inline on the card from the same
   host init: each round's provenance table (one rank's ack) must equal
   ``chunk_digest_np`` over that step's replica, and the committed step-6
   image (whole), its 3-rank elastic re-slice (stitched) and both ranks'
   final digests must equal the inline state bit for bit. Each rank
   counts its own kernel launches and sends them in its acks: exactly one
   ``chunk_digest`` launch per boundary for its provenance table, one per
   shadow sync but a rank process's first (whose digests the persist child
   backfills), and none of either kernel while it steps (seq 512 stays
   below the flash threshold). Printed per round and rank: blocking,
   persist, sync/digest/fetch us, chunks synced, bytes written, the
   launches, the lockstep witness (SHA-256 of the replica) ms; once: rank
   1's recovery (death to re-JOIN), card memory before and at its lowest,
   the wall. ``[cluster:proxy]``: 2 ranks, each with a local proxy
   (segment transport, fused digests), the program cut to 2 of its 24
   layers (full width), 4 steps, checkpoints at 2/4, no kill: lockstep,
   images at 2 and 4, the inline run's bits, each rank's proxy one fused
   digest launch per step (from its SYNCED, in the acks), and each round's
   provenance table (one rank's ack) equal to ``chunk_digest_np`` over the
   inline replica. ``[cluster:remote]``: the same run with each rank's
   proxy a session on one of 2 proxy-host daemons on the card that the
   coordinator places it on (stream transport), traced into an obs dir,
   under ``repro_torch.chaos``'s injection engine: once the first round
   has committed it journals (``INJECT_LOG.jsonl``) and then fires a
   heartbeat clock skew on rank 1, a SIGKILL of daemon ph0 and a torn
   frame at the coordinator: at least one rank must be rescheduled onto
   ph1, a ``proxy_host_death`` alert journaled before a committed round,
   images at 2 and 4 and the final digests equal to ``[cluster:proxy]``'s
   inline run, every ack's provenance table equal to ``chunk_digest_np``,
   and every ack must count exactly one digest launch per proxied step,
   though ph1 then hosts both sessions; ``repro_torch.obs.soak.verdict``
   over the run dir must pass with all six booleans true (every injection
   evidenced, every alert explained, converged, leaks flat, critical path
   checked, no committed round over ``CHAOS_ROUND_ENVELOPE_S``) over the
   3 journaled injections, printed on a ``[chaos]`` line. Printed: the
   placements, the moved ranks and the reschedule latency (death reported
   to the moved rank's first SYNCED on the survivor);
10. the SSM and hybrid families (``[hybrid]``): zamba2-1.2b at full width
   (d_model 2048, 64 SSD heads x 64, state 64, chunk 256, the shared block
   32 x 64 MHA with d_ff 8192, vocab 32,000, bf16 with the f32 ``A_log``,
   ``D``, ``dt_bias``), cut to 12 of its 38 layers for the script's time
   (the shared block after layers 6 and 12; 4.40 GB of state under
   AdamW): the train CLI at batch 4, seq 512, 4 microbatches,
   ``remat="dots"``, 6 steps, fork checkpoints at 2, 4 and 6, codec none
   (per step its ms, peak GB, loss, whether every gradient leaf is finite
   and the largest decay exponent summed over a chunk, |A| * sum(dt);
   digest launches per checkpoint [0, 0, 1]; no attention kernel at seq
   512); the step-6 image's digests the run's state's, the grouped digest
   over the whole state bitwise equal to ``chunk_digests_plain`` leaf by
   leaf, the step-4 image run to 6 bitwise equal; the serve CLI on the
   step-6 image (lazy, batch 2, 8,192-token prompt, 32 greedy tokens; one
   ``wgmma`` flash launch per application of the shared block, 2; eager
   the same bits), the prefill's last logits equal to a forward over the
   prompt bit for bit, the served logits no further from the f32
   upcast's forward over prompt + 31 served tokens than the bf16 forward
   lies from it over the prompt; then the serve CLI on mamba2-130m at full
   size (24 layers, state 128) from a fresh init: no flash launch, the
   same checks. Lane 2, after the cluster phases;
11. the multimodal family (``[multimodal]``): paligemma-3b at full width
   (d_model 2048, 8 q heads and 1 kv head x 256, GeGLU d_ff 16,384, vocab
   257,216 tied and scaled, ``vision_proj``, 256 patches), cut to 2 of its
   18 layers for the script's time (7.51 GB of state under AdamW): the
   train CLI at batch 4, 256 patches + 512 text tokens (768 positions: the
   dense lowering, no attention kernel), ``remat="dots"``, 6 steps, fork
   checkpoints at 2, 4 and 6, codec none (per step its ms, peak GB and
   loss; digest launches per checkpoint [0, 0, 1]); the step-6 image's
   digests the run's state's, the grouped digest bitwise the plain
   version's, the step-4 image run to 6 bitwise equal; the serve CLI on
   the step-6 image (lazy, batch 2, 256 patches + 7,936 text tokens, 32
   greedy tokens; one ``wgmma`` flash launch per layer at head dim 256
   with ``prefix_len`` 256, 2; eager the same bits), the prefill's last
   logits equal to a forward over the image and the prompt bit for bit,
   the served logits held to the f32 upcast's forward over the image, the
   prompt and 31 served tokens; then the serve CLI on musicgen-medium at
   full size (48 layers, 4 codebooks of 2,048) from a fresh init, 1,500
   frames, 64 greedy frames (the dense lowering, no flash launch), the
   same checks per codebook. Lane 2, after ``[hybrid]``;
12. the sharding layer (``[mesh]``, :func:`phase_mesh`): 4 ranks on the
   card over gloo, mesh (data=2, model=2), moonshot-v1-16b-a3b at full
   width cut to 1 of 48 layers: the attention of the sharded step's
   heads-split layer at a flash length, the train CLI sharded (FSDP layer
   by layer, the expert-parallel MoE, per-rank checkpoints committed as
   their persists land), the step-4 image restored onto (data=4,) and at
   world size 1. Lane 1, after ``[multimodal:long]``;
13. the last line: ``{"ok": true, "device": {...}}``.

Order and overlap: 1 to 4, 5's ``[serve]``, 6 and ``[train:long]`` run one
after another with the card to themselves, so the kernels' times are
taken alone. Then 7, 9, 10 and 11 run in a second process of this script
(``--lane``, its output printed when it ends) while this one runs
``[serve:proxy]``, 8, ``[moe]``, ``[multimodal:long]`` and 12: the two lanes
share no state, each path counts
its launches in its own processes, and their wall times and step times
are taken beside the other lane's work. The lane must end with 0 within
``SCRIPT_BUDGET_S`` of the script's start; on any failure it is stopped,
with every process it started.

Every phase ends with a ``[<phase>] wall_s=...`` line with its CPU seconds
and I/O bytes, each lane with a ``[lane:N]`` total, and a phase's start and
end also go to standard error with the time of day. It exits nonzero
without a result when no CUDA device is available.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import shutil
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
LOGIT_CHUNK = 512  # positions per logits block in the served-vs-f32 checks
# flash kernel vs plain version, (atol, rtol) in |got - want| <= atol +
# rtol |want|: f32 within two sum orders (the reference test's 2e-5); bf16
# and f16 round two f32 values that differ by a sum order to the output's
# type, so one ulp of the output (rtol 2**-7, 2**-10) plus 1e-4 for the sum
# order over up to 8192 keys where the output is near 0
FLASH_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-4, 2.0 ** -7),
             torch.float16: (1e-4, 2.0 ** -10)}
# flash backward vs its plain version, per gradient tensor, (a, r) in
# |got - want| <= a max|want| + r |want|: the kernel rounds P and dS once to
# the input type before their products (as FlashAttention-2 does), so an
# element is off by up to the unit roundoff u (2**-8 bf16, 2**-11 f16) times
# the sum of its terms' magnitudes, which dS's cancellations (each row of dS
# sums to 0) leave above the element itself: a = 2u of the tensor's largest
# element, plus one ulp of the rounded output, r = 2u. f32 keeps every
# product in f32: the forward's 2e-5, of the largest element
FLASH_BWD_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2.0 ** -7, 2.0 ** -7),
                 torch.float16: (2.0 ** -10, 2.0 ** -10)}
# the same limit with max|want| taken per tile of 64 rows (keys, for dk and
# dv) of each (batch, head), so that a tile whose gradient is small is held
# to its own scale: the whole-tensor limit misses a key tile dropped from
# the last rows' dq, and one q head's partial missing from the last 128
# keys' dk (the dk/dv kernel's smallest CTAs). Set from the kernel's
# readings: every shape of the sweep and the training shape reads below 1
FLASH_BWD_TILE_ROWS, FLASH_BWD_TILE_LIMIT = 64, 1.0
# the kernels one backward call launches on its 16-bit route, in order, by
# the names [timing] flash-bwd prints them under
BWD_KERNELS = {"dq": "flash_bwd_dq_tc", "dkdv": "flash_bwd_dkdv_tc",
               "reduce": "flash_bwd_reduce_dkdv"}
# the forward's row statistics vs the plain version's, every dtype (both
# are f32 over the same products): |dm| <= 1e-4 (1 + |m|), |dl| <= 1e-4 l.
# Two tilings of up to 8192 keys order their f32 sums and rescalings
# differently, which stays far below this; a wrong statistic (log base 2
# for e, a missed key tile, l == 0 not set to 1) moves m or l by O(1)
FLASH_STATS_TOL = 1e-4
# [train:long]: the train CLI at a sequence length that takes the chunked
# attention lowering (qwen2-0.5b's attn_chunked_threshold is 4096)
LONG_STEPS, LONG_BATCH, LONG_SEQ = 4, 2, 8192
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
    mem = {}
    with contextlib.suppress(OSError), open("/proc/meminfo") as f:
        mem = {k: int(v.split()[0]) * 1024 for k, v in (line.split(":", 1) for line in f)}
    print(f"[card] host cpus={os.cpu_count()} mem_total={mem.get('MemTotal')} "
          f"mem_available={mem.get('MemAvailable')} tmp={tempfile.gettempdir()} "
          f"tmp_free={shutil.disk_usage(tempfile.gettempdir()).free}", flush=True)
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import chunk_digest, flash_attention

    t0 = time.perf_counter()
    builds = (chunk_digest.build, flash_attention.build, flash_attention.build_bwd)
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:  # one nvcc per source
        libs = list(pool.map(lambda build: build(), builds))
    print(f"[build] {' '.join(lib.name for lib in libs)} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    from repro_torch.kernels import _build

    report = [r for r in _build.ptxas_report(libs[2]) if r["kernel"].endswith(("_tc", "_dkdv"))
              and r["dtype"] is not None]
    print("[build] backward, 16-bit route, -Xptxas -v: " + " ".join(
        f"{r['kernel']}<{r['dtype']},{r['d']}>:regs={r['registers']},"
        f"spill={r['spill_stores']}/{r['spill_loads']}" for r in report), flush=True)
    if len(report) != 18 or any(r["spill_stores"] or r["spill_loads"] for r in report):
        raise SystemExit(f"the backward's 16-bit kernels: {len(report)} of 18 reported, or "
                         f"a spill: {report}")
    # the backward at head dim 256, both routes: dq alone is 128 f32
    # registers a thread on the tensor cores, dk and dv split by columns
    bwd_wide = [r for r in _build.ptxas_report(libs[2]) if r["d"] == 256]
    print("[build] backward at head dim 256, -Xptxas -v: " + " ".join(
        f"{r['kernel']}<{r['dtype'] or 'f32'},{r['d']}>:regs={r['registers']},"
        f"spill={r['spill_stores']}/{r['spill_loads']}" for r in bwd_wide), flush=True)
    if len(bwd_wide) != 6 or any(r["spill_stores"] or r["spill_loads"] for r in bwd_wide):
        raise SystemExit(f"the backward at head dim 256: {len(bwd_wide)} of 6 kernels "
                         f"reported, or a spill: {bwd_wide}")
    # the forward at paligemma's head dim 256: the O accumulator alone is
    # 128 f32 registers a thread on the tensor-core route
    wide = [r for r in _build.ptxas_report(libs[1]) if r["d"] == 256]
    print("[build] forward at head dim 256, -Xptxas -v: " + " ".join(
        f"{r['kernel']}<{r['dtype'] or 'f32'},{r['d']}>:regs={r['registers']},"
        f"spill={r['spill_stores']}/{r['spill_loads']}" for r in wide), flush=True)
    if len(wide) != 3 or any(r["spill_stores"] or r["spill_loads"] for r in wide):
        raise SystemExit(f"the forward at head dim 256: {len(wide)} of 3 kernels reported, "
                         f"or a spill: {wide}")
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


def _plain(q, k, v, *, causal=True, scale=None, prefix_len=0) -> torch.Tensor:
    from repro_torch.kernels import ref

    return ref.flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     block_q=_plain_block(q.shape[2]),
                                     block_k=_plain_block(k.shape[2]), prefix_len=prefix_len)


def _tol_ratio(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / (atol + rtol |want|): above 1 is a breach."""
    atol, rtol = FLASH_TOL[want.dtype]
    want = want.float()
    return float(((got.float() - want).abs() / (atol + rtol * want.abs())).max())


def _flash_vs_plain(q, k, v, *, causal=True, scale=None, prefix_len=0):
    """The kernel against the plain version: (max abs error, plain output)."""
    from repro_torch.kernels import flash_attention

    got = flash_attention.flash_attention(q, k, v, causal=causal, scale=scale,
                                          prefix_len=prefix_len)
    want = _plain(q, k, v, causal=causal, scale=scale, prefix_len=prefix_len)
    if got.dtype != q.dtype or got.shape != q.shape:
        raise SystemExit(f"flash_attention: got {got.dtype} {tuple(got.shape)}")
    atol, rtol = FLASH_TOL[q.dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    Sq, Sk = q.shape[2], k.shape[2]
    if causal and Sq > Sk and not prefix_len:  # rows with no key: the mean of v over all Sk
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
    # the prefix-LM mask (PaliGemma's image) and head dim 256, both routes:
    # (B, Hq, Hkv, Sq, Sk, D, prefix_len) inside one key tile, across tiles,
    # with rows that have no causal key, ragged tiles, at or past Sk
    prefixed = [
        (1, 4, 2, 256, 256, 64, 16), (1, 14, 2, 200, 200, 64, 130),
        (1, 2, 1, 256, 128, 64, 40), (1, 8, 1, 320, 320, 128, 96),
        (1, 2, 1, 200, 120, 128, 200), (1, 8, 1, 256, 256, 256, 64),
        (2, 8, 1, 384, 384, 256, 256), (1, 4, 2, 200, 200, 256, 70),
        (1, 2, 1, 256, 128, 256, 5), (1, 8, 1, 256, 256, 256, 0),
    ]
    worst = {}
    cases = 0
    for dtype in FLASH_TOL:
        for shape in shapes:
            for causal in (True, False):
                err, _ = _flash_vs_plain(*_flash_inputs(*shape, dtype, gen), causal=causal)
                worst[dtype] = max(worst.get(dtype, 0.0), err)
                cases += 1
        for *shape, prefix in prefixed:
            err, _ = _flash_vs_plain(*_flash_inputs(*shape, dtype, gen), prefix_len=prefix)
            worst[dtype] = max(worst[dtype], err)
            cases += 1
        err, _ = _flash_vs_plain(*_flash_inputs(1, 2, 1, 256, 256, 256, dtype, gen),
                                 causal=False)
        worst[dtype] = max(worst[dtype], err)
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


def _bwd_tol_ratio(got: torch.Tensor, want: torch.Tensor, scale: float | None = None) -> float:
    """max |got - want| / (a max|want| + r |want|) (``FLASH_BWD_TOL``;
    ``scale``: max|want| of the whole tensor when ``want`` is a part)."""
    a, r = FLASH_BWD_TOL[want.dtype]
    want = want.float()
    top = float(want.abs().max()) if scale is None else scale
    return float(((got.float() - want).abs() / (a * top + r * want.abs())).max())


def _bwd_tile_ratio(got: torch.Tensor, want: torch.Tensor,
                    rows: int = FLASH_BWD_TILE_ROWS) -> float:
    """max |got - want| / (a max|want over its tile| + r |want|), tiles of
    ``rows`` rows of each (batch, head) (``FLASH_BWD_TOL``'s a and r); an
    element with no error reads 0, one with an error where its tile is all
    0 reads inf."""
    a, r = FLASH_BWD_TOL[want.dtype]
    B, H, S, D = want.shape
    n = -(-S // rows)

    def tiles(x):
        return torch.nn.functional.pad(x.float(), (0, 0, 0, n * rows - S)).view(B, H, n, rows, D)

    w = tiles(want)
    top = w.abs().amax(dim=(3, 4), keepdim=True)
    err = (tiles(got) - w).abs()
    ratio = torch.where(err == 0, 0.0, err / (a * top + r * w.abs()))
    return float(ratio.max())


def _flash_bwd_inputs(B, Hq, Hkv, Sq, Sk, D, dtype, gen, causal=True, prefix_len=0):
    """The kernel forward's output and statistics on ``_flash_inputs``, and
    a dO: what a backward gets."""
    from repro_torch.kernels import flash_attention

    q, k, v = _flash_inputs(B, Hq, Hkv, Sq, Sk, D, dtype, gen)
    do = torch.randn((B, Hq, Sq, D), generator=gen, device="cuda").to(dtype)
    o, m, l = flash_attention.flash_attention(q, k, v, causal=causal, stats=True,
                                              prefix_len=prefix_len)
    return q, k, v, o, m, l, do


def _stats_ratio(m, l, pm, pl) -> float:
    """The kernel's row statistics against the plain version's, as a
    fraction of ``FLASH_STATS_TOL``: above 1 is a breach."""
    dm = ((m - pm).abs() / (FLASH_STATS_TOL * (1 + pm.abs()))).max()
    dl = ((l - pl).abs() / (FLASH_STATS_TOL * pl)).max()
    return float(torch.maximum(dm, dl))


def _flash_bwd_vs_plain(ins, *, causal=True, blocks=None, prefix_len=0):
    """The forward's statistics and the backward kernel, each against its
    plain version: the kernel's backward takes the kernel forward's o, m
    and l, the plain backward the plain forward's, on the same q, k, v and
    dO. Returns (worst gradient tolerance ratio, max abs error, statistics
    ratio, output with statistics bitwise equal to output without, kernel
    grads, plain grads, the plain forward's (o, m, l))."""
    from repro_torch.kernels import flash_attention, ref

    q, k, v, o, m, l, do = ins
    bq, bk = blocks or (_plain_block(q.shape[2]), _plain_block(k.shape[2]))
    po, pm, pl = ref.flash_attention_plain(q, k, v, causal=causal, block_q=bq, block_k=bk,
                                           return_stats=True, prefix_len=prefix_len)
    stats_ratio = _stats_ratio(m, l, pm, pl)
    same_out = torch.equal(o, flash_attention.flash_attention(q, k, v, causal=causal,
                                                              prefix_len=prefix_len))
    got = flash_attention.flash_attention_bwd(*ins, causal=causal, prefix_len=prefix_len)
    want = ref.flash_attention_bwd_plain(q, k, v, po, pm, pl, do, causal=causal,
                                         block_q=bq, block_k=bk, prefix_len=prefix_len)
    for g, w, t in zip(got, want, ins[:3]):
        if g.dtype != t.dtype or g.shape != t.shape or not g.is_contiguous():
            raise SystemExit(f"flash_attention_bwd: got {g.dtype} {tuple(g.shape)}")
    ratio = max(_bwd_tol_ratio(g, w) for g, w in zip(got, want))
    err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    return ratio, err, stats_ratio, same_out, got, want, (po, pm, pl)


def phase_flash_bwd_sweep() -> None:
    """The forward's row statistics and the backward kernel (both routes)
    against their plain versions, the plain backward on the plain forward's
    output and statistics: the forward sweep's shapes, causal and not, head
    dims 32/64/128/256, groups of 1 and 7, rows with no key (Sq > Sk), the
    prefix-LM mask (a prefix of 1, of 16 and longer than a tile, ragged Sq
    and Sk, at head dims 64/128/256), gemma-2b's heads at 256, the model's
    transposed v, and both training shapes (qwen2-0.5b's and paligemma-3b's
    ``hd256p``), with broken controls that the tolerance must see."""
    from repro_torch.kernels import flash_attention, ref

    bwd = flash_attention.flash_attention_bwd
    before = dict(bwd.launches_by_route)
    gen = torch.Generator(device="cuda").manual_seed(4)
    shapes = [  # (B, Hq, Hkv, Sq, Sk, D)
        (1, 1, 1, 128, 128, 64), (2, 4, 2, 256, 256, 64), (1, 8, 1, 128, 128, 128),
        (1, 4, 4, 128, 512, 64), (2, 2, 2, 384, 384, 32),   # the forward sweep's
        (1, 2, 1, 256, 128, 64), (1, 7, 1, 200, 72, 32),    # Sq > Sk: rows with no key
        (1, 14, 2, 200, 200, 64), (1, 14, 2, 120, 200, 128),  # group of 7, ragged tiles
        (1, 8, 2, 333, 200, 128), (1, 12, 1, 300, 200, 64),   # groups of 4 and 12, Sq > Sk
        (1, 8, 1, 256, 256, 256), (1, 8, 1, 200, 200, 256),   # gemma-2b's heads at 256
        (1, 8, 1, 300, 200, 256),                             # ... with rows with no key
    ]
    # the prefix-LM mask, causal: (B, Hq, Hkv, Sq, Sk, D, prefix_len) a
    # prefix of 1, of 16 and longer than a tile (64 keys; 32 in the dq
    # kernel at D = 256), rows with no causal key, ragged tiles, past Sk.
    # A prefix of 1 runs where Sq <= Sk: rows without a causal key would
    # see key 0 alone, whose exact dq is 0, and a 64-row tile of them holds
    # rounding noise only, on which the per-tile limit reads noise over
    # noise (the plain version in f32 against f64 reads far past it there)
    prefixed = [
        (1, 4, 2, 256, 256, 64, 1), (1, 14, 2, 200, 200, 64, 16),
        (1, 2, 1, 256, 128, 64, 40), (1, 7, 1, 200, 72, 64, 100),
        (1, 8, 1, 320, 320, 128, 96), (1, 8, 2, 333, 200, 128, 16),
        (1, 8, 2, 200, 264, 128, 1), (1, 2, 1, 200, 120, 128, 16),
        (1, 8, 1, 256, 256, 256, 1), (1, 8, 1, 136, 200, 256, 1),
        (1, 8, 1, 264, 264, 256, 16), (1, 4, 2, 200, 200, 256, 70),
        (1, 2, 1, 256, 128, 256, 5), (2, 8, 1, 384, 384, 256, 256),
    ]
    worst, stats_worst, cases, nokey_dq, nokey_m, stats_same = {}, 0.0, 0, 0.0, True, True
    tile_worst = {}
    for dtype in FLASH_BWD_TOL:
        for shape, causal, prefix in [(s, c, 0) for s in shapes for c in (True, False)] + [
                (s[:6], True, s[6]) for s in prefixed]:
            ins = _flash_bwd_inputs(*shape, dtype, gen, causal=causal, prefix_len=prefix)
            ratio, _, st_ratio, same_out, got, want, _ = _flash_bwd_vs_plain(
                ins, causal=causal, prefix_len=prefix)
            worst[dtype] = max(worst.get(dtype, 0.0), ratio)
            tile_worst[dtype] = max(tile_worst.get(dtype, 0.0), *(
                _bwd_tile_ratio(g, w) for g, w in zip(got, want)))
            stats_worst = max(stats_worst, st_ratio)
            stats_same = stats_same and same_out
            cases += 1
            Sq, Sk = shape[3], shape[4]
            if causal and Sq > Sk and not prefix:  # rows with no key: dS is 0 there, m -1e30
                nokey_dq = max(nokey_dq, float(got[0][:, :, : Sq - Sk].abs().max()))
                nokey_m = nokey_m and bool((ins[4][:, :, : Sq - Sk] == -1e30).all())
    # the training shape, one layer: qwen2-0.5b's heads at 8192 tokens
    ins = _flash_bwd_inputs(LONG_BATCH, 14, 2, LONG_SEQ, LONG_SEQ, 64, torch.bfloat16, gen)
    train_ratio, train_err, train_stats, same_out, got, want, plain_fwd = \
        _flash_bwd_vs_plain(ins, blocks=(1024, 1024))
    stats_same = stats_same and same_out
    cases += 1
    train_tile = max(_bwd_tile_ratio(g, w) for g, w in zip(got, want))
    same = all(torch.equal(a, b) for a, b in zip(got, flash_attention.flash_attention_bwd(*ins)))
    # paligemma-3b's training shape, one layer (hd256p): the image's 256
    # patches a prefix, the plain version at the model's blocks
    vlm = _flash_bwd_inputs(1, 8, 1, LONG_SEQ, LONG_SEQ, 256, torch.bfloat16, gen,
                            prefix_len=MM_PATCHES)
    vlm_ratio, vlm_err, vlm_stats, vlm_same_out, vgot, vwant, _ = _flash_bwd_vs_plain(
        vlm, blocks=(512, 1024), prefix_len=MM_PATCHES)
    vlm_tile = max(_bwd_tile_ratio(g, w) for g, w in zip(vgot, vwant))
    same = same and all(torch.equal(a, b) for a, b in zip(vgot, flash_attention.flash_attention_bwd(
        *vlm, prefix_len=MM_PATCHES)))
    stats_same = stats_same and vlm_same_out
    cases += 1
    del vlm, vgot, vwant
    # what the tolerance reads for a wrong kernel: (1) dk without the first
    # q head of each kv head's group of 7; (2) 128 rows' dq without their
    # first key tile (64 keys, which every one of them sees): rows 64..191,
    # gated, and the last 128 rows (the longest, whose dq is far below the
    # tensor's largest element), which the whole-tensor limit misses and the
    # per-tile limit must see; (3) the statistics with m in log base 2,
    # gated; (4) the last key tile's dk (128 keys, which only the last 128
    # rows see) without the partial of q head 0, which the per-tile limit
    # must see
    q, k, v, _, m, _, do = ins
    o, pm, pl = plain_fwd
    heads = [0, 7]  # the first q head of each kv head
    part = ref.flash_attention_bwd_plain(q[:, heads], k, v, o[:, heads],
                                         pm[:, heads].contiguous(), pl[:, heads].contiguous(),
                                         do[:, heads], block_q=1024, block_k=1024)
    head_ratio = _bwd_tol_ratio(want[1].float() - part[1].float(), want[1])
    T, top = 128, float(want[0].float().abs().max())

    def without_first_tile(r0):
        rows = slice(r0, r0 + T)
        tile = ref.flash_attention_bwd_plain(
            q[:, :, rows], k[:, :, :64], v[:, :, :64], o[:, :, rows],
            pm[:, :, rows].contiguous(), pl[:, :, rows].contiguous(), do[:, :, rows],
            causal=False, block_q=T, block_k=64)
        wrong = want[0][:, :, rows].float() - tile[0].float()
        return (_bwd_tol_ratio(wrong, want[0][:, :, rows], scale=top),
                _bwd_tile_ratio(wrong, want[0][:, :, rows]))

    (tile_ratio, _), (last_ratio, last_tile) = without_first_tile(64), \
        without_first_tile(LONG_SEQ - T)
    last = slice(LONG_SEQ - T, LONG_SEQ)
    head0 = ref.flash_attention_bwd_plain(
        q[:, :1, last], k[:, :1, last], v[:, :1, last], o[:, :1, last],
        pm[:, :1, last].contiguous(), pl[:, :1, last].contiguous(), do[:, :1, last],
        block_q=T, block_k=T)
    no_head0 = want[1].float().clone()
    no_head0[:, :1, last] -= head0[1].float()
    part_whole, part_tile = _bwd_tol_ratio(no_head0, want[1]), _bwd_tile_ratio(no_head0, want[1])
    log2_ratio = _stats_ratio(m / math.log(2), ins[5], pm, pl)
    del ins, q, k, v, o, m, pm, pl, do, got, want, part, plain_fwd, head0, no_head0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    routes = {r: n - before[r] for r, n in bwd.launches_by_route.items()}
    print(f"[flash-bwd-sweep] cases={cases} routes={routes} " + " ".join(
        f"{str(d).replace('torch.', '')}_worst={e:.3g}x (a {FLASH_BWD_TOL[d][0]:g} max|want| "
        f"+ r {FLASH_BWD_TOL[d][1]:g} |want|)" for d, e in worst.items())
        + f" stats_worst={stats_worst:.3g}x (|dm| <= {FLASH_STATS_TOL:g} (1 + |m|), "
        f"|dl| <= {FLASH_STATS_TOL:g} l) train_shape_stats={train_stats:.3g}x "
        f"out_with_stats_bitwise={stats_same} no_key_rows: m=-1e30 {nokey_m}, "
        f"max_abs_dq={nokey_dq:g} train_shape={train_ratio:.3g}x "
        f"(max_abs_err={train_err:.3g}) run_to_run_equal={same}: one head of the group "
        f"missing from dk reads {head_ratio:.3g}x the limit, one key tile missing from "
        f"rows 64..191's dS reads {tile_ratio:.3g}x (from the last {T} rows' "
        f"{last_ratio:.3g}x), m in log base 2 reads {log2_ratio:.3g}x; per "
        f"{FLASH_BWD_TILE_ROWS}-row tile (limit {FLASH_BWD_TILE_LIMIT:g}): " + " ".join(
            f"{str(d).replace('torch.', '')}_worst={e:.3g}x" for d, e in tile_worst.items())
        + f" train_shape={train_tile:.3g}x hd256p (1, 8, {LONG_SEQ}, 256) prefix {MM_PATCHES}: "
        f"{vlm_ratio:.3g}x (max_abs_err={vlm_err:.3g}, per tile {vlm_tile:.3g}x, stats "
        f"{vlm_stats:.3g}x); the last {T} rows' dS without a key tile reads "
        f"{last_tile:.3g}x, the last key tile's dk without q head 0's partial "
        f"{part_tile:.3g}x (whole-tensor limit: {part_whole:.3g}x)", flush=True)
    if max(max(worst.values()), train_ratio, vlm_ratio) > 1:
        raise SystemExit(f"flash_attention_bwd outside its tolerance: {worst} "
                         f"train shape {train_ratio} hd256p {vlm_ratio}")
    if max(stats_worst, train_stats, vlm_stats) > 1 or not stats_same or not nokey_m:
        raise SystemExit(f"flash_attention statistics: {stats_worst}x, train shape "
                         f"{train_stats}x, hd256p {vlm_stats}x, output unchanged {stats_same}, "
                         f"no-key m {nokey_m}")
    if nokey_dq != 0 or not same:
        raise SystemExit(f"flash_attention_bwd: rows with no key got dq {nokey_dq}, "
                         f"run to run equal {same}")
    if min(head_ratio, tile_ratio, log2_ratio) <= 10:
        raise SystemExit("the bf16 backward or statistics tolerance does not see a missing "
                         "head, a missing key tile or m in log base 2 by a wide factor")
    if max(*tile_worst.values(), train_tile, vlm_tile) > FLASH_BWD_TILE_LIMIT:
        raise SystemExit(f"flash_attention_bwd outside its per-tile limit: {tile_worst}, "
                         f"train shape {train_tile}, hd256p {vlm_tile}")
    if min(last_tile, part_tile) <= FLASH_BWD_TILE_LIMIT:
        raise SystemExit(f"the per-tile limit does not see the last rows' missing key tile "
                         f"({last_tile}) or the last key tile's missing head ({part_tile})")


def _zero_counts() -> None:
    from repro_torch.kernels import chunk_digest, flash_attention

    chunk_digest.chunk_digests.launches = 0
    fwd, bwd = flash_attention.flash_attention, flash_attention.flash_attention_bwd
    fwd.launches = bwd.launches = 0
    for counter in (fwd.launches_by_route, bwd.launches_by_route):
        for key in counter:
            counter[key] = 0


def _counts() -> dict:
    from repro_torch.kernels import chunk_digest, flash_attention

    fwd, bwd = flash_attention.flash_attention, flash_attention.flash_attention_bwd
    return {"chunk_digest": chunk_digest.chunk_digests.launches,
            "flash_attention": fwd.launches,
            "flash_attention_by_route": dict(fwd.launches_by_route),
            "flash_attention_bwd": bwd.launches,
            "flash_attention_bwd_by_route": dict(bwd.launches_by_route)}


def _fetch_split(r) -> str:
    """A checkpoint's phase-1 sync and its fetch: allocation, page faults
    (a first sync's, or its wait for the leaves' buffers made ahead on the
    checkpointer's background thread, ``ahead`` of them), the copy."""
    copy_us = r.fetch_us - r.alloc_us - r.prefault_us
    return (f"sync_ms={r.sync_us / 1e3:.1f} fetch_ms={r.fetch_us / 1e3:.1f} "
            f"(alloc_ms={r.alloc_us / 1e3:.1f} prefault_ms={r.prefault_us / 1e3:.1f} "
            f"copy_ms={copy_us / 1e3:.1f} ahead={r.buffers_ahead})")


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
              f"{r.digest_us / 1e3:.1f} {_fetch_split(r)} synced={r.chunks_synced} "
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


def _hidden(cfg, params, tokens: torch.Tensor) -> torch.Tensor:
    """The model's final hidden states over ``tokens`` (no logits: the
    full-vocab logits of 2 x 8192 positions would take 10 GB)."""
    from repro_torch.models import transformer as tfm

    with torch.device("meta"):
        module = tfm.Transformer(cfg)
    with torch.no_grad():
        return torch.func.functional_call(module, tfm.module_params(params), (tokens,))


def _served_position_logits(cfg, params, seq: torch.Tensor) -> torch.Tensor:
    """The model's forward over ``seq``; f32 logits only at the positions
    whose next token was served."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import logits_from_embed

    h = _hidden(cfg, params, seq)
    with torch.no_grad():
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


# [serve:proxy]: the serve CLI's decode_arch at full width on the step-6
# params cut to their first 2 of 24 layers (a cut for the script's time),
# written as an image of their own and restored lazily; each step is one
# proxied decode step. The prompt must decode to more than one token (the
# buffer starts at token 0, so a dropped write would not show otherwise)
SERVE_PROXY_PROMPT, SERVE_PROXY_KILL_AFTER, SERVE_PROXY_LAYERS = 144, 80, 2
SERVE_PROXY_SPEC = {"name": "decode_arch", "arch": ARCH, "smoke": False,
                    "batch": SERVE_BATCH, "prompt_len": SERVE_PROXY_PROMPT,
                    "gen": GEN, "device": "cuda", "num_layers": SERVE_PROXY_LAYERS}


def _first_layers(store: str, n: int) -> dict:
    """The step-6 image's params on the CPU (read lazily: the optimizer
    state stays on disk), each stacked block leaf cut to its first ``n``
    layers."""
    from repro_torch.checkpoint import ChunkStore
    from repro_torch.core import RestoreManager

    prefix = "device/params/"
    cpu = torch.device("cpu")
    lazy, _ = RestoreManager(ChunkStore(store)).restore(
        step=STEPS, lazy=True, device_for=lambda p, s: cpu if p.startswith(prefix) else None)
    params: dict = {}
    try:
        for path in lazy.keys():
            if not path.startswith(prefix):
                continue
            *parents, name = path[len(prefix):].split("/")
            node = params
            for p in parents:
                node = node.setdefault(p, {})
            leaf = lazy[path]
            node[name] = (leaf[:n] if parents[:1] == ["blocks"] else leaf).clone()
    finally:
        lazy.close()
    return params


def serve_child(cfg: dict) -> int:
    """``repro_torch.launch.serve`` with ``--device-runner proxy`` (argv in
    ``cfg["argv"]``) in a process that must never create a CUDA context;
    with ``cfg["kill_after"]`` the proxy is SIGKILLed once after that step
    is issued. Writes what it saw to ``cfg["out"]`` as JSON."""
    from repro_torch.launch import serve
    from repro_torch.proxy import ProxyRunner
    from repro_torch.remote import transport
    from repro_torch.utils.tree import tree_digest

    killed, recoveries = [], []
    step, close = ProxyRunner.step, ProxyRunner.close

    def killing_step(self, n):
        step(self, n)
        if n == cfg.get("kill_after") and not killed:
            killed.append(self.kill())

    def recording_close(self):
        recoveries.extend(self.recoveries)
        close(self)

    ProxyRunner.step, ProxyRunner.close = killing_step, recording_close
    out = serve.serve(cfg["argv"])
    info = out["info"]
    res = {
        "role": cfg["role"], "tokens": out["tokens"].tolist(),
        "decoded_digest": tree_digest({"cache": out["cache"],
                                       "toks": np.asarray(out["tokens"])}),
        "restarts": out["restarts"], "push_s": out["push_s"],
        "decode_s": out["decode_s"], "decode_tok_s": out["decode_tok_s"],
        "chunks_synced": info["chunks_synced"], "bytes_synced": info["bytes_synced"],
        "phase_us": info["phase_us"], "transport": info["transport"],
        "killed_pid": killed[0] if killed else None,
        "recoveries": [{k: r[k] for k in ("recovery_s", "replayed_steps")}
                       for r in recoveries],
        "zstd": transport._zstd() is not None,
        "cuda_initialized": torch.cuda.is_initialized(),
    }
    with open(cfg["out"], "w") as f:
        json.dump(res, f)
    return 0


def _serve_image(store: str, cut_store: str) -> dict:
    """``[serve:proxy]``'s image: the step-6 params cut to their first
    ``SERVE_PROXY_LAYERS`` layers, written to ``cut_store`` by a
    ``save_sync``; returns those params (on the CPU)."""
    from repro_torch.checkpoint import ChunkStore
    from repro_torch.core import ForkedCheckpointer

    params = _first_layers(store, SERVE_PROXY_LAYERS)
    ckpt = ForkedCheckpointer(ChunkStore(cut_store), codec="none", chunk_bytes=1 << 20,
                              backend="thread")
    ckpt.save_sync(STEPS, {"device": {"params": params}})
    ckpt.close()
    return params


def phase_serve_proxy(cut_store: str, params: dict, card: str) -> dict:
    """The serve CLI through a device proxy (``[serve:proxy]``) on the image
    ``_serve_image`` wrote: a local segment proxy SIGKILLed once mid-decode,
    then a proxy-host daemon on the card over the stream transport, each
    held bit for bit against the same ``decode_arch`` stepped inline in this
    process from the same params."""
    from repro_torch.proxy import make_program
    from repro_torch.remote.host import ProxyHostHandle
    from repro_torch.utils.dtypes import leaf_nbytes
    from repro_torch.utils.tree import flatten_with_paths, tree_digest

    prog = make_program(SERVE_PROXY_SPEC)
    P, steps = SERVE_PROXY_PROMPT, SERVE_PROXY_PROMPT + GEN - 1
    meta = flatten_with_paths(prog.meta_state())[0]
    clean = {p: t for p, t in meta.items() if not p.startswith("params/")}
    clean_bytes = sum(leaf_nbytes(t) for t in clean.values())
    clean_chunks = sum(-(-leaf_nbytes(t) // (1 << 20)) for t in clean.values())
    tmp_dir = tempfile.TemporaryDirectory(prefix="chip-smoke-sproxy-")
    tmp = tmp_dir.name
    dstate = prog.on_restore(prog.init_state(params))
    del params
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for n in range(1, steps + 1):
        dstate, _ = prog.step(dstate, n)
    torch.cuda.synchronize()
    inline_s = time.perf_counter() - t0
    want = dstate["toks"][:, P:].cpu().numpy().tolist()
    want_digest = tree_digest({"cache": dstate["cache"],
                               "toks": dstate["toks"][:, P:].cpu().numpy()})
    pos = int(dstate["cache"]["pos"])
    distinct = len({t for row in want for t in row})
    del dstate
    torch.cuda.empty_cache()
    print(f"[serve:proxy] {card} layers={SERVE_PROXY_LAYERS} of 24 (the step-6 image's first, "
          f"written as an image of their own) state_bytes={prog.state_nbytes()} "
          f"clean_bytes={clean_bytes} (cache + toks) steps={steps} inline_decode_s="
          f"{inline_s:.3f} inline_tok_s={steps * SERVE_BATCH / inline_s:.1f} "
          f"inline_pos={pos} distinct_tokens={distinct}", flush=True)
    if distinct < 2:
        raise SystemExit("the inline decode gave one token throughout: the token "
                         "check could not see a misplaced or dropped write")

    argv = ["--arch", ARCH, "--ckpt-dir", cut_store,
            "--lazy", "--batch", str(SERVE_BATCH), "--prompt-len", str(P), "--gen", str(GEN),
            "--device-runner", "proxy"]
    with tmp_dir:
        local = _run_proxy_child({"role": "local", "argv": argv,
                                  "kill_after": SERVE_PROXY_KILL_AFTER,
                                  "out": os.path.join(tmp, "local.json")}, 600,
                                 flag="--serve-child")
        daemon = ProxyHostHandle("serve-ph").start()  # on the card
        try:
            remote = _run_proxy_child(
                {"role": "daemon", "argv": argv + ["--proxy-endpoint", "%s:%d" % daemon.addr],
                 "out": os.path.join(tmp, "daemon.json")}, 600, flag="--serve-child")
            daemon_context = _uvm_mapped(daemon.pid)
        finally:
            daemon.terminate()

    launches = flash = 0
    for run in (local, remote):
        ph, tr, w = run["phase_us"], run["transport"], run["watch"]
        rec = run["recoveries"]
        rec_s = " ".join(f"{r['recovery_s']:.2f}" for r in rec) or "-"
        print(f"[serve:proxy] {card} {run['role']} transport={tr['transport']} "
              f"push_s={run['push_s']:.3f} (spawn or connect + upload) decode_s="
              f"{run['decode_s']:.3f} decode_tok_s={run['decode_tok_s']:.1f} "
              f"restarts={run['restarts']} recovery_s={rec_s} "
              f"replayed_steps={[r['replayed_steps'] for r in rec]} "
              f"proxy_step_ms={ph['step'] / 1e3 / max(ph['steps'], 1):.2f} "
              f"steps={ph['steps']} digest_launches={ph['digest_launches']} "
              f"flash_launches={ph['flash_launches']} chunks_synced={run['chunks_synced']} "
              f"bytes_synced={run['bytes_synced']} wire_tx={tr['wire_tx']} "
              f"raw_tx={tr['raw_tx']} wire_rx={tr['wire_rx']} raw_rx={tr['raw_rx']} "
              f"zstd={'on' if run['zstd'] else 'absent: the stream runs raw'} "
              f"tokens_equal_inline={run['tokens'] == want} cache_and_tokens_bitwise="
              f"{run['decoded_digest'] == want_digest} watched {w['samples']} times: "
              f"app_with_context={w['app_contexts']} "
              f"proxy_with_context={w['proxy_contexts'] if run is local else daemon_context}",
              flush=True)
        if run["tokens"] != want or run["decoded_digest"] != want_digest:
            raise SystemExit(f"{run['role']}: proxied tokens or cache differ from the "
                             f"inline decode")
        if run["cuda_initialized"] or w["app_contexts"]:
            raise SystemExit(f"{run['role']}: the serving application created a CUDA "
                             f"context: {run['cuda_initialized']} {w}")
        if ph["steps"] != steps or ph["digest_launches"] != steps or ph["flash_launches"]:
            raise SystemExit(f"{run['role']}: {ph['digest_launches']} digest and "
                             f"{ph['flash_launches']} flash launches for {ph['steps']} "
                             f"steps, want {steps}, {steps} and 0")
        if run["chunks_synced"] > clean_chunks or not 0 < run["bytes_synced"] <= clean_bytes:
            raise SystemExit(f"{run['role']}: the final sync moved {run['chunks_synced']} "
                             f"chunks, {run['bytes_synced']} bytes: more than the cache "
                             f"and toks ({clean_chunks}, {clean_bytes})")
        launches += ph["digest_launches"]
        flash += ph["flash_launches"]
    if local["restarts"] != 1 or local["killed_pid"] is None or len(local["recoveries"]) != 1:
        raise SystemExit(f"local proxy: restarts={local['restarts']} "
                         f"recoveries={local['recoveries']}")
    if not local["watch"]["proxy_contexts"]:
        raise SystemExit("local proxy: the watch never saw the proxy's context")
    if remote["restarts"] != 0 or remote["transport"]["transport"] != "stream":
        raise SystemExit(f"daemon run: restarts={remote['restarts']} "
                         f"transport={remote['transport']['transport']}")
    if not daemon_context:
        raise SystemExit("the proxy-host daemon holds no CUDA context")
    if pos != steps:
        raise SystemExit(f"the inline decode's cache/pos is {pos}, not {steps}")
    return {"launches": {"chunk_digest": launches, "flash_attention": flash}}


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


def _causal_pairs(S: int, prefix: int = 0) -> int:
    """The (row, key) pairs a causal call over S positions computes, with
    the first ``prefix`` keys open to every row: P^2 + (S(S+1) - P(P+1))/2."""
    P = min(prefix, S)
    return P * P + (S * (S + 1) - P * (P + 1)) // 2


def _sdpa_backend(fn) -> str:
    """The backend of the library's fused attention that one call of ``fn``
    ran, from its kernels' names in the profiler's trace, and the name of
    its longest kernel."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.key_averages() if e.device_time_total > 0),
                     key=lambda e: -e.device_time_total)
    names = " ".join(e.key for e in kernels).lower()
    backend = next((b for tag, b in (("cudnn", "cudnn"), ("fmha", "efficient"),
                                     ("flash", "flash")) if tag in names), "math")
    return f"{backend} ({kernels[0].key[:48] if kernels else 'no kernel traced'})"


def _flash_timed(B, Hq, Hkv, S, D, reps: int, plain_reps: int, prefix: int = 0) -> dict:
    """The forward kernel at one prefill layer's shape (bf16, causal, the
    first ``prefix`` keys open to every row): its ms, the plain version's,
    the library's fused attention with and without deterministic
    algorithms, the bound and the error against plain. With a prefix the
    library runs the same function through a boolean mask (and the
    backend that ran is named), and, for reference only, ``is_causal``."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, ref

    q, k, v = _flash_inputs(B, Hq, Hkv, S, S, D, torch.bfloat16,
                            torch.Generator(device="cuda").manual_seed(2))
    kernel = flash_attention.flash_attention
    got = kernel(q, k, v, prefix_len=prefix)  # warm-up, and the comparison
    want = ref.flash_attention_plain(q, k, v, prefix_len=prefix)
    err = float((got.float() - want.float()).abs().max())
    ratio = _tol_ratio(got, want)
    del got, want
    ms = _time_ms(lambda: kernel(q, k, v, prefix_len=prefix), reps)
    plain_ms = _time_ms(lambda: ref.flash_attention_plain(q, k, v, prefix_len=prefix),
                        plain_reps)
    # the library's fused attention at Sq == Sk, where its top-left causal
    # mask is the right-aligned one, on the same values with v contiguous
    # (on the model's transposed view it leaves its fused path); timed
    # only, never on the path
    vc = v.contiguous()

    def causal():
        return F.scaled_dot_product_attention(q, k, vc, is_causal=True, enable_gqa=True)

    rows = torch.arange(S, device=q.device)[:, None]
    cols = torch.arange(S, device=q.device)[None, :]
    mask = (cols <= rows) | (cols < prefix) if prefix else None

    def masked():
        return F.scaled_dot_product_attention(q, k, vc, attn_mask=mask, enable_gqa=True)

    library = masked if prefix else causal

    def timed(fn):
        """ms with this run's deterministic algorithms (its pick then) and
        without them, where it may pick a faster backend; the faster is
        the yardstick"""
        fn()  # warm-up: its first call picks and loads a backend
        det = _time_ms(fn, reps)
        torch.use_deterministic_algorithms(False)
        fn()
        free = _time_ms(fn, reps)
        backend = _sdpa_backend(fn) if prefix else None
        torch.use_deterministic_algorithms(True)
        return det, free, backend

    library_det_ms, library_free_ms, backend = timed(library)
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))  # out = q's
    flops = 4 * B * Hq * D * _causal_pairs(S, prefix)  # q.k and p.v over unmasked pairs
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_TC_OPS_PER_S * 1e3
    out = {"q": tuple(q.shape), "kv": tuple(k.shape), "prefix": prefix, "ms": ms,
           "plain_ms": plain_ms, "library_ms": min(library_det_ms, library_free_ms),
           "library_det_ms": library_det_ms, "library_free_ms": library_free_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "max_abs_err": err, "tol_ratio": ratio, "flops": flops}
    if prefix:
        det, free, _ = timed(causal)
        out.update(library_backend=backend, library_causal_ms=min(det, free),
                   library_causal_det_ms=det, library_causal_free_ms=free)
    return out


def _flash_line(t: dict) -> str:
    line = (f"[timing] flash q={t['q']} k=v={t['kv']} bf16 causal prefix_len={t['prefix']} "
            f"kernel_ms={t['ms']:.4f} plain_ms={t['plain_ms']:.1f} "
            f"library_ms={t['library_ms']:.4f} (deterministic {t['library_det_ms']:.4f}, "
            f"not {t['library_free_ms']:.4f}) kernel/library={t['ms'] / t['library_ms']:.3f} "
            f"bound_ms={t['bound_ms']:.4f} bound/kernel={t['bound_ms'] / t['ms']:.3f} "
            f"TFLOP/s={t['flops'] / t['ms'] / 1e9:.1f} max_abs_err={t['max_abs_err']:.3g} "
            f"({t['tol_ratio']:.3g}x the bf16 limit)")
    if t["prefix"]:
        line += (f" library: masked, backend {t['library_backend']}; is_causal (0.1% less "
                 f"work, not the same function) {t['library_causal_ms']:.4f} (deterministic "
                 f"{t['library_causal_det_ms']:.4f}, not {t['library_causal_free_ms']:.4f})")
    return line


def phase_flash_timing(serve_launches: int) -> dict:
    """The forward kernel at one layer of ``[serve]``'s prefill (q (2, 14,
    8192, 64), k = v (2, 2, 8192, 64)), the row of the JSON line, at one
    layer of ``[moe]``'s (q = k = v (2, 16, 8192, 128)), the row's
    ``hd128``, at one application of ``[hybrid]``'s shared block (q = k = v
    (2, 32, 8192, 64), MHA), the row's ``mha64``, and at one layer of
    ``[multimodal]``'s paligemma prefill (q (2, 8, 8192, 256), k = v (2, 1,
    8192, 256), the image's 256 patches a bidirectional prefix), the row's
    ``hd256p``."""
    t = _flash_timed(SERVE_BATCH, 14, 2, PROMPT, 64, reps=10, plain_reps=2)
    print(_flash_line(t), flush=True)
    row = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:33",
        "launches": serve_launches, "max_abs_err": t["max_abs_err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
    }
    wide = _flash_timed(SERVE_BATCH, 16, 16, PROMPT, 128, reps=10, plain_reps=1)
    print(_flash_line(wide), flush=True)
    mha = _flash_timed(SERVE_BATCH, 32, 32, PROMPT, 64, reps=10, plain_reps=1)
    print(_flash_line(mha), flush=True)
    vlm = _flash_timed(SERVE_BATCH, 8, 1, PROMPT, 256, reps=10, plain_reps=1,
                       prefix=MM_PATCHES)
    print(_flash_line(vlm), flush=True)
    keys = ("q", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_det_ms",
            "library_free_ms", "max_abs_err")
    row["hd128"] = {k: wide[k] for k in keys}
    row["mha64"] = {k: mha[k] for k in keys}
    row["hd256p"] = {k: vlm[k] for k in (*keys, "prefix", "library_backend",
                                         "library_causal_ms", "library_causal_det_ms",
                                         "library_causal_free_ms")}
    timed = (t, wide, mha, vlm)
    if not all(x["tol_ratio"] <= 1 for x in timed):
        raise SystemExit(f"flash_attention disagrees with plain at serve shapes: "
                         f"{[x['max_abs_err'] for x in timed]}")
    return row


def _flash_bwd_timed(B, Hq, Hkv, S, D, prefix: int, plain_reps: int) -> dict:
    """The backward kernel at one training layer's shape (bf16, causal, the
    first ``prefix`` keys open to every row, v the model's transposed
    view): its ms, each of its kernels' device time from the profiler, its
    scratch, its bound (five products over the unmasked pairs), its plain
    version at the model's attention blocks (512 x 1024) and the library's
    fused attention backward (SDPA forward + backward, minus its forward),
    with ``is_causal`` and, with a prefix, with the boolean
    prefix-or-causal mask (the same function), each with and without
    deterministic algorithms; printed as one ``[timing] flash-bwd``
    line."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, ref

    gen = torch.Generator(device="cuda").manual_seed(5)
    ins = _flash_bwd_inputs(B, Hq, Hkv, S, S, D, torch.bfloat16, gen, prefix_len=prefix)
    kernel = flash_attention.flash_attention_bwd
    ratio, err = _flash_bwd_vs_plain(ins, blocks=(512, 1024), prefix_len=prefix)[:2]  # warm-up
    ms = _time_ms(lambda: kernel(*ins, prefix_len=prefix), 10)
    scratch = sum(math.prod(shape) * torch.empty((), dtype=dt).element_size() for shape, dt in
                  flash_attention.bwd_scratch(torch.bfloat16, B, Hq, Hkv, S, S, D).values())
    # the kernels each call launches and each one's device time, from the
    # profiler's trace of a few calls
    calls = 3
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            kernel(*ins, prefix_len=prefix)
        torch.cuda.synchronize()
    traced = [e for e in prof.key_averages() if "flash_bwd_" in e.key and e.count]
    split = {name: e.device_time_total / e.count / 1e3 for e in traced
             for name, full in BWD_KERNELS.items() if full in e.key}
    per_call = sum(e.count for e in traced) / calls
    plain_ms = _time_ms(lambda: ref.flash_attention_bwd_plain(
        *ins, block_q=512, block_k=1024, prefix_len=prefix), plain_reps)
    q, k, v, _, _, _, do = ins
    qg, kg, vg = (t.detach().clone().contiguous().requires_grad_(True) for t in (q, k, v))
    rows = torch.arange(S, device=q.device)[:, None]
    cols = torch.arange(S, device=q.device)[None, :]
    mask = ((cols <= rows) | (cols < prefix)) if prefix else None

    def library_fwd(masked):
        if masked:
            return F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask, enable_gqa=True)
        return F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)

    # with this run's deterministic algorithms and without them; the
    # library may refuse its backward under determinism
    library = {}
    for masked in (False, True) if prefix else (False,):
        for det in (True, False):
            torch.use_deterministic_algorithms(det)
            try:
                torch.autograd.grad(library_fwd(masked), (qg, kg, vg), do)  # warm-up: its
                with torch.no_grad():  # first calls pick a backend, with and without a
                    library_fwd(masked)  # gradient
                    fwd_ms = _time_ms(lambda: library_fwd(masked), 10)
                library[masked, det] = _time_ms(lambda: torch.autograd.grad(
                    library_fwd(masked), (qg, kg, vg), do), 10) - fwd_ms
            except RuntimeError as exc:  # refused: printed, not timed
                library[masked, det] = f"refused ({str(exc).splitlines()[0][:120]})"
    torch.use_deterministic_algorithms(True)
    # the same function: with a prefix the masked call, else is_causal
    timed = [x for (masked, _), x in library.items()
             if isinstance(x, float) and masked == bool(prefix)]
    library_ms = min(timed) if timed else None
    del ins, q, k, v, do, qg, kg, vg, mask
    torch.cuda.empty_cache()
    nbytes = (4 * B * Hq * S * D * 2 + 4 * B * Hkv * S * D * 2  # q, o, dO, dq; k, v, dk, dv
              + 2 * B * Hq * S * 4)                             # m, l
    flops = 10 * B * Hq * D * _causal_pairs(S, prefix)  # 5 products over unmasked pairs
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_TC_OPS_PER_S * 1e3
    out = {"q": (B, Hq, S, D), "prefix": prefix, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": library_ms, "max_abs_err": err, "kernels_per_launch": int(per_call),
           "split_ms": split, "scratch_bytes": scratch,
           "library": {f"{'masked' if masked else 'is_causal'}_"
                       f"{'deterministic' if det else 'not'}": x
                       for (masked, det), x in library.items()}}
    lib = " ".join(f"{'masked' if masked else 'is_causal'}/"
                   f"{'deterministic' if d else 'not'}="
                   f"{x if isinstance(x, str) else format(x, '.4f')}"
                   for (masked, d), x in library.items())
    factor = " ".join(f"{'masked' if masked else 'is_causal'}/"
                      f"{'deterministic' if d else 'not'}={ms / x:.3f}"
                      for (masked, d), x in library.items() if isinstance(x, float))
    print(f"[timing] flash-bwd q={(B, Hq, S, D)} k=v={(B, Hkv, S, D)} bf16 causal "
          f"prefix_len={prefix} kernel_ms={ms:.4f} (profiler: {per_call:g} kernels a call, "
          f"per kernel {' '.join(f'{k}={v:.4f}' for k, v in split.items()) or 'none traced'}; "
          f"scratch_bytes={scratch}) plain_ms={plain_ms:.1f} "
          f"library_ms={library_ms if library_ms is None else format(library_ms, '.4f')} "
          f"({lib}; kernel/library {factor}) bound_ms={out['bound_ms']:.4f} "
          f"({out['bound_by']}: {flops:.4g} flop, {nbytes} bytes) "
          f"bound/kernel={out['bound_ms'] / ms:.3f} "
          f"TFLOP/s={flops / ms / 1e9:.1f} max_abs_err={err:.3g} ({ratio:.3g}x the bf16 "
          f"limit)", flush=True)
    if not ratio <= 1:
        raise SystemExit(f"flash_attention_bwd disagrees with plain at {out['q']}: {err}")
    if (per_call != len(BWD_KERNELS) or len(traced) != len(BWD_KERNELS)
            or len(split) != len(BWD_KERNELS) or not all(t > 0 for t in split.values())):
        raise SystemExit(f"the profiler did not trace each of {list(BWD_KERNELS.values())} "
                         f"once a call, with its device time: {per_call:g} a call, "
                         f"{[e.key[:80] for e in traced]}")
    return out


def phase_flash_bwd_timing(train_long_launches: int) -> dict:
    """The backward kernel at one layer of [train:long]'s shape: q (2, 14,
    8192, 64), k = v (2, 2, 8192, 64), the JSON row, and at one layer of
    paligemma-3b's at batch 2: q (2, 8, 8192, 256), k = v (2, 1, 8192, 256),
    the image's 256 patches a prefix, the row's ``hd256p``
    (:func:`_flash_bwd_timed`)."""
    t = _flash_bwd_timed(LONG_BATCH, 14, 2, LONG_SEQ, 64, 0, plain_reps=2)
    vlm = _flash_bwd_timed(2, 8, 1, LONG_SEQ, 256, MM_PATCHES, plain_reps=1)
    row = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "none: the reference differentiates src/repro/models/layers.py:136 "
                    "(_chunked_attention) in plain JAX; no Pallas backward",
        "launches": train_long_launches, "kernels_per_launch": t["kernels_per_launch"],
        "max_abs_err": t["max_abs_err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
        "hd256p": {k: vlm[k] for k in ("q", "prefix", "ms", "split_ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms", "library", "max_abs_err")},
    }
    return row


def _clone(tree):
    from repro_torch.utils.tree import flatten_with_paths, unflatten_from_paths

    flat, treedef = flatten_with_paths(tree)
    return unflatten_from_paths(treedef, {p: t.clone() if isinstance(t, torch.Tensor) else t
                                          for p, t in flat.items()})


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


def phase_train_long(card: str) -> dict:
    """The train CLI at seq 8192 ([train:long]): qwen2-0.5b at full width and
    depth, batch 2, ``remat="dots"`` as configured, 4 steps, fork
    checkpoints at 2 and 4, codec none. Every layer's attention is the flash
    kernel and its gradient the backward kernel: per step exactly 24 + 24
    forward launches (remat recomputes each layer's attention in the
    backward) and 24 of each backward kernel, no digest launch inside a
    step, none at either sync (each the first of its shadow buffer, whose
    digests the persist child backfills); the step's thread counts every
    one of them, the recomputed and backward ones autograd runs on its own
    thread included. The step-4 image's chunk digests must be the run's
    final state's, and the step-2 image, run to step 4, that state bit for
    bit. Then from the step-4 state and the next batch: one step under
    ``remat="none"`` bitwise equal to one under ``"dots"`` (both peaks
    printed), and ``microbatches=2`` against 1 (a step, and its grads in
    bf16 and in f32) within the stated limits, mb=2's grads exactly the
    mean of its halves', its step's loss and grad norm theirs, and two
    mb=2 steps equal, bit for bit."""
    from repro_torch.checkpoint import ChunkStore
    from repro_torch.checkpoint.manifest import load_manifest
    from repro_torch.configs import get_config
    from repro_torch.core import RestoreManager
    from repro_torch.core.shadow import ShadowStateManager
    from repro_torch.data import SyntheticBatches
    from repro_torch.kernels import chunk_digest, flash_attention, ops
    from repro_torch.launch import train
    from repro_torch.launch.train import build_training
    from repro_torch.models import build
    from repro_torch.optim import get_optimizer, global_norm, warmup_cosine
    from repro_torch.runtime import steps as steps_mod
    from repro_torch.runtime.steps import batch_to_device
    from repro_torch.utils.tree import flatten_with_paths, tree_equal, unflatten_from_paths

    cfg = get_config(ARCH)
    L = cfg.num_layers
    want_step = {"flash_attention": 2 * L, "flash_attention_bwd": L, "chunk_digest": 0,
                 "thread": (2 * L, L)}
    steps, syncs = [], []
    make, sync = train.make_train_step, ShadowStateManager.sync

    def counting_make(model, optimizer, **kw):
        fn = make(model, optimizer, **kw)

        def step(state, batch):
            torch.cuda.synchronize()
            c0 = _counts()
            t_fwd, t_bwd = flash_attention.thread_launches(), flash_attention.thread_bwd_launches()
            held = torch.cuda.memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = fn(state, batch)
            torch.cuda.synchronize()
            c1 = _counts()
            steps.append({
                "ms": (time.perf_counter() - t0) * 1e3,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "held_gb": held,
                **{key: c1[key] - c0[key] for key in
                   ("flash_attention", "flash_attention_bwd", "chunk_digest")},
                "thread": (flash_attention.thread_launches() - t_fwd,
                           flash_attention.thread_bwd_launches() - t_bwd),
                "routes": (c1["flash_attention_by_route"]["wgmma"]
                           - c0["flash_attention_by_route"]["wgmma"],
                           c1["flash_attention_bwd_by_route"]["mma"]
                           - c0["flash_attention_bwd_by_route"]["mma"])})
            return out

        return step

    def counted_sync(self, state):
        before = chunk_digest.chunk_digests.launches
        stats = sync(self, state)
        syncs.append(chunk_digest.chunk_digests.launches - before)
        return stats

    argv = ["--arch", ARCH, "--steps", str(LONG_STEPS), "--batch", str(LONG_BATCH),
            "--seq", str(LONG_SEQ), "--ckpt-every", "2", "--backend", "fork", "--codec",
            "none", "--log-every", "1"]
    with tempfile.TemporaryDirectory(prefix="chip-smoke-long-") as tmp:
        store = os.path.join(tmp, "ckpt")
        train.make_train_step, ShadowStateManager.sync = counting_make, counted_sync
        try:
            _zero_counts()
            t0 = time.perf_counter()
            out = train.train(argv + ["--ckpt-dir", store])
            wall = time.perf_counter() - t0
            counts = _counts()
        finally:
            train.make_train_step, ShadowStateManager.sync = make, sync
        for i, st in enumerate(steps, 1):
            print(f"[train:long] {card} step={i} step_ms={st['ms']:.1f} peak_gb="
                  f"{st['peak_gb']:.2f} (held before {st['held_gb']:.2f}) flash_fwd="
                  f"{st['flash_attention']} flash_bwd_calls={st['flash_attention_bwd']} "
                  f"digest={st['chunk_digest']} (wgmma, mma)={st['routes']} "
                  f"this_thread(fwd, bwd)={st['thread']}", flush=True)
        for r in out["results"]:
            print(f"[train:long] ckpt step={r.step} blocking_ms={r.blocking_s * 1e3:.1f} "
                  f"persist_ms={r.persist_s * 1e3:.1f} {_fetch_split(r)} "
                  f"synced={r.chunks_synced} written={r.chunks_written}", flush=True)
        m = out["metrics"]
        print(f"[train:long] arch={ARCH} layers={L} batch={LONG_BATCH} seq={LONG_SEQ} "
              f"remat={cfg.remat} steps={out['final_step']} wall_s={wall:.1f} "
              f"loss={m['loss']:.4f} grad_norm={m['grad_norm']:.4f} digest_launches_per_sync="
              f"{syncs} launches={ {k: counts[k] for k in ('flash_attention', 'flash_attention_bwd', 'chunk_digest')} }",
              flush=True)
        if out["final_step"] != LONG_STEPS or not all(map(math.isfinite, m.values())):
            raise SystemExit(f"[train:long] did not finish cleanly: {out['final_step']} {m}")
        if [r.step for r in out["results"]] != [2, 4]:
            raise SystemExit(f"[train:long] images: {[r.step for r in out['results']]}")
        bad = [st for st in steps if {k: st[k] for k in want_step} != want_step
               or st["routes"] != (2 * L, L)]
        if len(steps) != LONG_STEPS or bad:
            raise SystemExit(f"[train:long] launches per step, want {want_step} on the "
                             f"tensor-core routes: {bad or len(steps)}")
        if syncs != [0, 0]:
            raise SystemExit(f"[train:long] digest launches per sync {syncs}, want [0, 0]")

        # the step-4 image is the run's final state: every chunk's digest
        # in its manifest is the one of the live state's bytes
        manifest = load_manifest(store, 4)
        stored = {path: [c.digest for sh in lv.shards for c in sh.chunks]
                  for path, lv in manifest.leaves.items()}
        cb = max(c.raw_len for lv in manifest.leaves.values() for sh in lv.shards
                 for c in sh.chunks)
        image_same = ops.tree_chunk_digests(out["state"], cb) == stored
        run = build_training(cfg, batch=LONG_BATCH, seq=LONG_SEQ, lr=3e-4,
                             total_steps=LONG_STEPS, device=torch.device("cuda"))
        t_restore = time.perf_counter()
        state, _ = RestoreManager(ChunkStore(store)).restore(step=2, device_for=run.device_for)
        t_restore = time.perf_counter() - t_restore
        data = SyntheticBatches.from_state(cfg, batch=LONG_BATCH, seq_len=LONG_SEQ,
                                           state=state["host"]["data"])
        for step in (3, 4):
            state["device"], _ = run.step_fn(state["device"], batch_to_device(next(data), "cuda"))
            state["host"]["step"] = np.int64(step)
            state["host"]["data"] = data.state()
        torch.cuda.synchronize()
        same = tree_equal(state, out["state"])
        print(f"[train:long] step-4 image digests equal the run's state: {image_same} "
              f"({sum(map(len, stored.values()))} chunks of up to {cb} bytes); restored step 2 "
              f"in {t_restore:.1f} s, ran 3..4: bitwise_equal to the run's step-4 state={same}",
              flush=True)
        if not image_same:
            raise SystemExit("[train:long] the stored step-4 image differs from the run")
        if not same:
            raise SystemExit("[train:long] the restart diverged from the step-4 image")
        del state
    base = out["state"]["device"]
    batch = batch_to_device(next(data), "cuda")
    del out
    torch.cuda.empty_cache()

    optimizer = get_optimizer(cfg.optimizer, warmup_cosine(3e-4, 10, LONG_STEPS))  # the CLI's

    def one_step(remat: str, mb: int = 1):
        """One step from a copy of ``base``: (state, metrics, ms, peak GB,
        GB held before the step: ``base`` and the states kept for checks)."""
        model = build(cfg.with_overrides(remat=remat))
        fn = steps_mod.make_train_step(model, optimizer, microbatches=mb)
        state = _clone(base)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        new, metrics = fn(state, batch)
        torch.cuda.synchronize()
        return new, metrics, (time.perf_counter() - t0) * 1e3, \
            torch.cuda.max_memory_allocated() / 1e9, held

    # microbatches. Exact: mb = 2's loss and grads are the mean of the two
    # halves' (each half a batch of its own), accumulated in f32 from zeros,
    # bit for bit; the step's loss and grad norm are those bits, and a
    # second step gives the same state. Against mb = 1 on the same state
    # and batch:
    # - each leaf's grads within relative L2 GRAD_REL_F32 in f32, where
    #   the two batch shapes differ only by f32 sum orders (a wrong split,
    #   weight or accumulation moves a leaf by O(1)); and within
    #   GRAD_REL_BF16 in the model's bf16, where those orders round bf16
    #   activations differently through 24 layers (the embedding reads
    #   0.038 on an NVIDIA H100);
    # - loss and grad norm within 1e-2 relative, and the updated params no
    #   further from mb=1's than mb=1's step moved them plus one bf16 ulp
    #   each side (2**-7 |p|: Adam normalises each element, so near-zero
    #   grads may flip its update)
    GRAD_REL_F32, GRAD_REL_BF16 = 1e-4, 2.0 ** -4

    def grads_mb1_mb2(model, params, halves=True):
        """Per leaf relative L2 of mb=2's grads to mb=1's, mb=2's loss and
        grads, and (``halves``) whether mb=2 is exactly the mean of its
        halves."""
        loss2, _, grads2 = steps_mod.loss_and_grads(model, params, batch, 2)
        g2 = flatten_with_paths(grads2)[0]
        exact = None
        if halves:
            parts = [steps_mod.loss_and_grads(model, params,
                                              {k: v[i : i + 1] for k, v in batch.items()}, 1)
                     for i in range(2)]
            h0, h1 = (flatten_with_paths(h[2])[0] for h in parts)
            exact = bool(torch.equal(loss2, (parts[0][0] + parts[1][0]) / 2)) and all(
                torch.equal(g2[p], (torch.zeros_like(g2[p]) + h0[p].float() + h1[p].float()) / 2)
                for p in g2)
            del parts, h0, h1
        loss1, _, grads1 = steps_mod.loss_and_grads(model, params, batch, 1)
        rel = {p: _rel_l2(g2[p], g) for p, g in flatten_with_paths(grads1)[0].items()}
        return rel, loss1, loss2, grads2, exact

    # f32 first, while little else is held: the same weights, upcast (the
    # flash kernels' CUDA-core route)
    flat, treedef = flatten_with_paths(base["params"])
    params32 = unflatten_from_paths(treedef, {k: v.float() for k, v in flat.items()})
    t0 = time.perf_counter()
    rel32, loss1_32, loss2_32, _, _ = grads_mb1_mb2(
        build(cfg.with_overrides(param_dtype="float32", compute_dtype="float32")), params32,
        halves=False)
    f32_s = time.perf_counter() - t0
    del flat, params32
    torch.cuda.empty_cache()

    dots, dots_metrics, dots_ms, dots_peak, dots_held = one_step("dots")
    none, none_metrics, none_ms, none_peak, none_held = one_step("none")
    remat_same = tree_equal(dots, none) and all(
        torch.equal(dots_metrics[k], none_metrics[k]) for k in dots_metrics)
    del none
    print(f"[train:long] remat none vs dots: bitwise_equal={remat_same} step_ms "
          f"{none_ms:.1f} / {dots_ms:.1f} peak_gb {none_peak:.2f} / {dots_peak:.2f} "
          f"(held before the step {none_held:.2f} / {dots_held:.2f})", flush=True)
    if not remat_same:
        raise SystemExit("[train:long] remat='none' and 'dots' steps differ")

    model = build(cfg)
    rel, loss1, loss2, grads2, exact = grads_mb1_mb2(model, base["params"])
    norm2 = global_norm(grads2)
    accum = {str(g.dtype).replace("torch.", "")
             for g in flatten_with_paths(grads2)[0].values()}
    del grads2
    loss_rel = abs(float(loss2) / float(loss1) - 1)
    mb2, mb2_metrics, mb2_ms, mb2_peak, _ = one_step(cfg.remat, 2)
    again, again_metrics, _, _, _ = one_step(cfg.remat, 2)
    mb_same = bool(torch.equal(mb2_metrics["loss"], loss2)
                   and torch.equal(mb2_metrics["grad_norm"], norm2)) and tree_equal(
        mb2, again) and all(torch.equal(mb2_metrics[k], again_metrics[k]) for k in mb2_metrics)
    del again
    p0 = flatten_with_paths(base["params"])[0]
    p1 = flatten_with_paths(dots["params"])[0]
    p2 = flatten_with_paths(mb2["params"])[0]
    moved = max(float((p1[p].float() - p0[p].float()).abs().max()) for p in p0)
    param_ratio = max(float(((p2[p].float() - p1[p].float()).abs()
                             / (moved + 2.0 ** -7 * p1[p].float().abs())).max()) for p in p0)
    norm_rel = abs(float(mb2_metrics["grad_norm"]) / float(dots_metrics["grad_norm"]) - 1)
    del mb2, dots, base, p0, p1, p2
    torch.cuda.empty_cache()

    def leaves(r):
        worst = max(r, key=r.get)
        return (f"median={float(np.median(list(r.values()))):.3g} max={r[worst]:.3g} "
                f"({worst})")

    print(f"[train:long] microbatches 2: the halves' mean bitwise={exact} "
          f"accum_dtype={sorted(accum)} two_mb2_steps_bitwise_equal_and_equal_to_the_"
          f"grads={mb_same}; "
          f"vs 1: grad_rel_l2 per leaf f32 {leaves(rel32)} (limit {GRAD_REL_F32:g}; "
          f"loss_rel={abs(float(loss2_32) / float(loss1_32) - 1):.3g}; {f32_s:.1f} s) bf16 "
          f"{leaves(rel)} (limit {GRAD_REL_BF16:g}) loss_rel={loss_rel:.3g} (limit 1e-2) "
          f"grad_norm_rel={norm_rel:.3g} (limit 1e-2) params {param_ratio:.3g}x the limit "
          f"(the mb=1 step moved params by up to {moved:.3g}); mb2_step_ms={mb2_ms:.1f} "
          f"mb2_peak_gb={mb2_peak:.2f}", flush=True)
    if not (exact and mb_same and accum == {cfg.accum_dtype}):
        raise SystemExit("[train:long] the microbatch step is not exact where it must be")
    if not (max(rel32.values()) <= GRAD_REL_F32 and max(rel.values()) <= GRAD_REL_BF16
            and loss_rel <= 1e-2 and norm_rel <= 1e-2 and param_ratio <= 1):
        raise SystemExit("[train:long] the microbatch step is outside its limits")
    return {"launches": counts}


# the full train program; [proxy] trains PROXY_LAYERS of its 24 layers and
# [uvm:paged] PAGED_LAYERS (full width), cuts for the script's time
# (PERF.md §4)
UVM_SPEC = {"name": "train_arch", "arch": ARCH, "smoke": False, "batch": BATCH,
            "seq": SEQ, "lr": LR, "total_steps": STEPS, "device": "cuda"}
PROXY_LAYERS, PAGED_LAYERS = 2, 2
PROXY_SPEC = dict(UVM_SPEC, num_layers=PROXY_LAYERS)
PAGED_SPEC = dict(UVM_SPEC, num_layers=PAGED_LAYERS)
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


def _run_proxy_child(cfg: dict, timeout: float, flag: str = "--proxy-child") -> dict:
    """One proxied application (``proxy_child``, or ``serve_child`` with
    ``flag="--serve-child"``), watched from this process while it runs:
    every half second, whether the application maps ``/dev/nvidia-uvm``
    (it must never), whether one of its descendants does (the proxy: this
    shows the check sees a context), and every few seconds how many
    contexts ``nvidia-smi`` lists (its PIDs are not this machine's, so the
    count is printed, not matched to a process)."""
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                             flag, json.dumps(cfg)])
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
    t_sub = time.perf_counter()
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

        print(f"[uvm:cli] wall_s={time.perf_counter() - t_sub:.1f} (the CLI run, its "
              f"restart and the inline steps)", flush=True)
        # Table 2 on the managed state: forked phase 1 at step 8 against the
        # naive synchronous save at step 10, each the first sync of its buffer
        t_sub = time.perf_counter()
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
        print(f"[uvm:table2] wall_s={time.perf_counter() - t_sub:.1f}", flush=True)
        t_sub = time.perf_counter()
        del tr, state, naive
        gc.collect()
        torch.cuda.empty_cache()

        # the same budget inside a proxy, killed once after step 3 is issued,
        # held against an inline managed run of the same program
        prog = make_program(PAGED_SPEC)
        pcap = train._resolve_capacity(UVM_CAPACITY, prog.state_nbytes())
        shm = os.statvfs("/dev/shm") if os.path.isdir("/dev/shm") else None
        workdir = None
        if (shm.f_bavail * shm.f_frsize if shm else 0) < 1.25 * prog.state_nbytes():
            workdir = os.path.join(tmp, "segments")
            os.makedirs(workdir)
        paged = _run_proxy_child({
            "workdir": workdir, "spec": PAGED_SPEC, "chunk": PROXY_CHUNK, "tag": "uvm",
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
    print(f"[uvm:paged] {card} layers={PAGED_LAYERS} capacity={pcap} "
          f"startup_s={paged['startup_s']:.1f} "
          f"run_s={paged['run_s']:.1f} restarts={paged['restarts']} "
          f"recoveries={paged['recoveries']} inline_managed_s={inline_s:.1f} "
          f"(launches there: {inline_counts['chunk_digest']} chunk_digest, "
          f"{inline_counts['flash_attention']} flash_attention) "
          f"watched {w['samples']} times: app_with_context={w['app_contexts']} "
          f"proxy_with_context={w['proxy_contexts']} "
          f"step4_image_bitwise_equal_to_inline_managed={same_paged}", flush=True)
    print(f"[uvm:paged] wall_s={time.perf_counter() - t_sub:.1f}", flush=True)
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
                                      "flash_attention": counts["flash_attention"],
                                      "flash_attention_bwd": counts["flash_attention_bwd"]},
                launches_proxy={"chunk_digest": launches, "flash_attention": flash})


# [moe]: moonshot-v1-16b-a3b at full width, cut to MOE_LAYERS of its 48
# layers for the script's time (PERF.md §4), through the train CLI and the
# serve CLI (which serves an image at its own depth). Six steps, so that
# checkpoint 6 digests on the card: 2 and 4 are their buffers' first syncs
MOE_ARCH, MOE_LAYERS, MOE_STEPS = "moonshot-v1-16b-a3b", 1, 6
MOE_LOGIT_CHUNK = 512  # prompt positions per logits block in the f32 check


def _dropped(log) -> tuple[int, int]:
    """(dropped slots, slots) over a ``moe.routing_log``."""
    return int(sum(int((~r.keep).sum()) for r in log)), sum(r.keep.numel() for r in log)


def _same_routes(a, b, top_k: int, ordered: bool = False) -> torch.Tensor:
    """Per token of a call (bool, in the call's batch-major order): the same
    experts, each kept or dropped alike, in each of its logged layers in
    both runs (``a`` and ``b``: the call's entries of two ``routing_log``s).
    A token's slot order among its experts changes no slot's position in
    its expert, only the order of its sum; ``ordered`` compares it too."""
    same = None
    for ra, rb in zip(a, b, strict=True):
        ka, kb = ((r.ids.reshape(-1, top_k) * 2 + r.keep.reshape(-1, top_k)) for r in (ra, rb))
        if not ordered:
            ka, kb = ka.sort(dim=1).values, kb.sort(dim=1).values
        eq = (ka == kb).all(1)
        same = eq if same is None else same & eq
    return same


def phase_moe(card: str) -> dict:
    """The MoE family on the card (``[moe]``): moonshot-v1-16b-a3b at full
    width (d_model 2048, 16 heads x 128, 64 experts top-6, d_ff 1408,
    vocab 163,840, capacity 1.25, bf16, the f32 router), 1 of its 48 layers.

    The train CLI: batch 4, seq 512, the config's 2 microbatches and
    ``remat="dots"``, 6 steps, fork checkpoints at 2, 4 and 6 (2 and 4 each
    their buffer's first sync: no digest; 6 one grouped ``chunk_digest``
    launch, counted between the step's end and the run's), codec none,
    1 MiB chunks; per step its ms, peak GB, loss, and from a forward per
    microbatch at the step's params its aux, CE and the share of dropped
    slots; the step-6 image's digests those of the run's state, and the
    kernel's digests of that state bitwise those of the plain version;
    step 4 restored and run to 6 bitwise equal to it. The serve CLI
    on the step-6 image: lazy restore, batch 2, an 8,192-token prompt (one
    flash launch per layer, on ``wgmma`` at head dim 128), 32 greedy
    tokens; eager restore the same bits. A forward over a sequence routes
    its groups with capacity drops, a decode step routes B tokens and never
    drops, so the served logits are not held to a teacher-forced forward:
    the prefill's last position must equal the forward over the prompt
    (the same groups) bit for bit, and the served logits are held to the
    same prefill and decode in the f32 upcast of the params. A router
    near-tie may route a token otherwise in bf16 than in f32 and move its
    logits a long way; at this depth a token's logits depend on its own
    routing alone, so the check holds the positions that route alike in
    both (the same experts, kept or dropped alike, in any order; at least
    half of them must): no further from the f32 ones than
    the bf16 forward over the prompt lies from the f32 forward at any
    prompt token routed alike, and every such position whose top two f32
    logits lie more than twice that difference apart picks the same token.
    The others are counted, with the f32 router's gap between its K-th and
    (K+1)-th logit: each must lie below twice the served router's shift
    from the f32 one there (a near-tie)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve, train
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import logits_from_embed
    from repro_torch.utils.tree import flatten_with_paths, unflatten_from_paths

    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_LAYERS)
    cuda = torch.device("cuda", torch.cuda.current_device())
    steps = []
    make, cli_config = train.make_train_step, train.get_config

    def counting_make(model, optimizer, **kw):
        fn = make(model, optimizer, **kw)
        mb = kw.get("microbatches") or model.cfg.microbatches

        def step(state, batch):
            n = batch["inputs"].shape[0] // mb
            with torch.no_grad(), moe.routing_log() as log:
                ms = [model.loss(state["params"], {k: v[i * n:(i + 1) * n]
                                                   for k, v in batch.items()})[1]
                      for i in range(mb)]
            seen = {"aux": float(sum(m["aux"] for m in ms)) / mb,
                    "ce": float(sum(m["ce"] for m in ms)) / mb}
            seen["dropped"], seen["slots"] = _dropped(log)
            del log
            torch.cuda.synchronize()
            c0 = _counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = fn(state, batch)
            torch.cuda.synchronize()
            c1 = _counts()
            steps.append(dict(seen, ms=(time.perf_counter() - t0) * 1e3,
                              peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                              loss=float(out[1]["loss"]),
                              digests_at=(c0["chunk_digest"], c1["chunk_digest"]),
                              **{k: c1[k] - c0[k] for k in
                                 ("chunk_digest", "flash_attention", "flash_attention_bwd")}))
            return out

        return step

    argv = ["--arch", MOE_ARCH, "--steps", str(MOE_STEPS), "--batch", str(BATCH),
            "--seq", str(SEQ), "--lr", str(LR), "--ckpt-every", "2", "--backend", "fork",
            "--codec", "none", "--log-every", "1"]
    with tempfile.TemporaryDirectory(prefix="chip-smoke-moe-") as tmp:
        store = os.path.join(tmp, "ckpt")
        train.make_train_step = counting_make
        train.get_config = lambda name, smoke=False: cfg  # the CLI at 1 of 48 layers
        try:
            _zero_counts()
            t0 = time.perf_counter()
            out = train.train(argv + ["--ckpt-dir", store])
            wall = time.perf_counter() - t0
            counts = _counts()
        finally:
            train.make_train_step = make
            train.get_config = cli_config
        after = _digests_after_steps(steps, counts)
        syncs = after[1::2]
        state_bytes = sum(t.numel() * t.element_size()
                          for t in flatten_with_paths(out["state"]["device"])[0].values())
        leaves = len(flatten_with_paths(out["state"]["device"])[0])
        for i, st in enumerate(steps, 1):
            print(f"[moe] {card} step={i} step_ms={st['ms']:.1f} peak_gb={st['peak_gb']:.2f} "
                  f"loss={st['loss']:.4f} ce={st['ce']:.4f} aux={st['aux']:.4f} "
                  f"dropped_slots={st['dropped']}/{st['slots']} "
                  f"({st['dropped'] / st['slots']:.4f}) launches: digest={st['chunk_digest']} "
                  f"flash={st['flash_attention']} flash_bwd={st['flash_attention_bwd']}",
                  flush=True)
        for r, n in zip(out["results"], syncs):
            print(f"[moe] {card} ckpt step={r.step} blocking_ms={r.blocking_s * 1e3:.1f} "
                  f"persist_ms={r.persist_s * 1e3:.1f} digest_ms={r.digest_us / 1e3:.1f} "
                  f"digest_launches={n} {_fetch_split(r)} synced={r.chunks_synced} "
                  f"written={r.chunks_written}", flush=True)
        m = out["metrics"]
        print(f"[moe] arch={MOE_ARCH} layers={cfg.num_layers} of 48 d_model={cfg.d_model} "
              f"experts={cfg.moe_experts} top_k={cfg.moe_top_k} capacity={cfg.moe_capacity_factor} "
              f"microbatches={cfg.microbatches} remat={cfg.remat} state_bytes={state_bytes} "
              f"({leaves} leaves) steps={out['final_step']} wall_s={wall:.1f} "
              f"loss={m['loss']:.4f} grad_norm={m['grad_norm']:.4f} digest_launches_per_sync="
              f"{syncs} launches={ {k: counts[k] for k in ('chunk_digest', 'flash_attention', 'flash_attention_bwd')} }",
              flush=True)
        if out["final_step"] != MOE_STEPS or not all(map(math.isfinite, m.values())) or not all(
                math.isfinite(st[k]) for st in steps for k in ("loss", "aux", "ce")):
            raise SystemExit(f"[moe] did not train cleanly: {out['final_step']} {m}")
        _check_train_run("moe", card, cfg, store, out, steps, after, MOE_STEPS)
        del out
        gc.collect()
        torch.cuda.empty_cache()

        # serving the step-6 image at its depth
        argv = ["--arch", MOE_ARCH, "--ckpt-dir", store, "--batch", str(SERVE_BATCH),
                "--prompt-len", str(PROMPT), "--gen", str(GEN)]
        _zero_counts()
        with moe.routing_log() as served_log:
            srv = serve.serve(argv + ["--lazy"])
        scounts = _counts()
        flash = scounts["flash_attention"]
        print(f"[moe] {card} serve lazy restore_s={srv['restore_s']:.3f} "
              f"ttft_s={srv['ttft_s']:.3f} decode_tok_s={srv['decode_tok_s']:.1f} "
              f"step={srv['step']} flash_attention_launches={flash} "
              f"by_route={scounts['flash_attention_by_route']} "
              f"chunk_digest_launches={scounts['chunk_digest']}", flush=True)
        logits = srv["logits"]
        if srv["step"] != MOE_STEPS or flash != cfg.num_layers or \
                scounts["flash_attention_by_route"]["wgmma"] != flash:
            raise SystemExit(f"[moe] serve: step {srv['step']}, flash launches {scounts}")
        if logits.shape != (SERVE_BATCH, GEN, cfg.vocab_size) or not bool(
                logits.isfinite().all()):
            raise SystemExit(f"[moe] served logits: {tuple(logits.shape)}")
        eager = serve.serve(argv)
        eager_same = bool(np.array_equal(eager["tokens"], srv["tokens"])
                          and torch.equal(eager["logits"], logits))
        print(f"[moe] {card} serve eager restore_s={eager['restore_s']:.3f} "
              f"ttft_s={eager['ttft_s']:.3f} decode_tok_s={eager['decode_tok_s']:.1f} "
              f"bitwise_equal_to_lazy={eager_same}", flush=True)
        del eager
        if not eager_same:
            raise SystemExit("[moe] eager and lazy serving disagree")

    # a token's logits depend on its own routing at this depth (1 layer):
    # a near-tie in the router may pick another expert in bf16 than in f32
    # and move that token a long way, so both checks hold the tokens that
    # route alike in the two, and count (and show the router's gap at) the
    # ones that do not
    L, K, B = cfg.num_layers, cfg.moe_top_k, SERVE_BATCH
    params, prompt = srv["params"], srv["prompt"]
    flat, treedef = flatten_with_paths(params)
    params32 = unflatten_from_paths(treedef, {p: t.float() for p, t in flat.items()})
    table, table32 = tfm.lm_table(cfg, params), tfm.lm_table(cfg, params32)
    with moe.routing_log() as fwd_log:
        h16 = _hidden(cfg, params, prompt)
    with moe.routing_log() as fwd32_log:
        h32 = _hidden(cfg, params32, prompt)
    fwd_dropped, fwd_slots = _dropped(fwd_log)
    fwd_same = _same_routes(fwd_log, fwd32_log, K).reshape(B, PROMPT)
    with torch.no_grad():
        prefill_same = torch.equal(logits_from_embed(table, h16[:, -1:])[:, 0], logits[:, 0])
        tol = 0.0
        for s0 in range(0, PROMPT, MOE_LOGIT_CHUNK):
            s1 = s0 + MOE_LOGIT_CHUNK
            d = (logits_from_embed(table, h16[:, s0:s1])
                 - logits_from_embed(table32, h32[:, s0:s1])).abs().amax(-1)
            tol = max(tol, float(d.masked_fill(~fwd_same[:, s0:s1], 0).max()))
    del h16, h32
    with torch.device("meta"):
        module = tfm.Transformer(cfg)
    served = torch.from_numpy(srv["tokens"]).to(cuda, torch.int32)
    with torch.no_grad(), moe.routing_log() as f32_log:
        lg, cache = tfm.prefill(module, params32, prompt, PROMPT + GEN)
        truth = [lg[:, 0]]
        for t in range(GEN - 1):
            lg, cache = tfm.decode_step(module, params32, cache, served[:, t])
            truth.append(lg)
    truth = torch.stack(truth, dim=1)
    # served position 0 is the prefill's last token, t > 0 decode step t
    same, ordered = (torch.stack(
        [_same_routes(served_log[:L], f32_log[:L], K, o).reshape(B, PROMPT)[:, -1]]
        + [_same_routes(served_log[L * t:L * (t + 1)], f32_log[L * t:L * (t + 1)], K, o)
           for t in range(1, GEN)], dim=1) for o in (False, True))
    dec_dropped = _dropped(f32_log[L:])[0] + _dropped(served_log[L:])[0]
    # per decoded token and layer: the f32 router's K-th minus (K+1)-th
    # logit, and the largest difference of the served router's logits from
    # the f32 ones; a shift of d in each logit can swap two that lie less
    # than 2 d apart, so a token routed otherwise is a near-tie when, in a
    # layer, its gap lies below twice its shift
    near, shift = [], []
    for t in range(1, GEN):
        for rs, rf in zip(served_log[L * t:L * (t + 1)], f32_log[L * t:L * (t + 1)]):
            top = rf.logits.reshape(B, -1).topk(K + 1, dim=-1).values
            d = (rs.logits - rf.logits).reshape(B, -1).abs().amax(-1)
            near.append((top[:, K - 1] - top[:, K]) < 2 * d)
            shift.append(d)
    near = torch.stack(near).reshape(GEN - 1, L, B).any(1).T      # (B, GEN - 1)
    shift = torch.stack(shift)
    diff = (logits - truth).abs().amax(-1)                        # (B, GEN)
    err = float(diff.masked_fill(~same, 0).max())
    top2 = truth.topk(2, dim=-1).values
    decided = same & ((top2[..., 0] - top2[..., 1]) > 2 * err)
    agree = served == truth.argmax(dim=-1)
    flipped = ~same[:, 1:]
    print(f"[moe] {card} prefill_last_logits_bitwise_equal_to_forward_over_prompt="
          f"{prefill_same} (the forward over the prompt dropped {fwd_dropped}/{fwd_slots} "
          f"slots at capacity {cfg.moe_capacity_factor}; decode dropped {dec_dropped}) "
          f"served_vs_f32_decode={err:.4g} over the {int(same.sum())}/{same.numel()} "
          f"positions routed alike (tol {tol:.4g} = bf16-vs-f32 forward over the "
          f"{int(fwd_same.sum())}/{fwd_same.numel()} prompt tokens routed alike; "
          f"all positions {float(diff.max()):.4g}) max_abs_logit="
          f"{float(truth.abs().max()):.4g} decode positions routed otherwise: "
          f"{int(flipped.sum())}, near-ties {int((flipped & near).sum())}; with the "
          f"same experts in another order {int((same & ~ordered).sum())} (router logits "
          f"served vs f32: median shift {float(shift.median()):.3g}, max "
          f"{float(shift.max()):.3g}) "
          f"greedy_agree={int(agree.sum())}/{agree.numel()} "
          f"decided_agree={int((agree & decided).sum())}/{int(decided.sum())}", flush=True)
    if not prefill_same:
        raise SystemExit("[moe] the prefill's last logits differ from the forward's")
    if not (err <= tol and bool(agree[decided].all()) and not dec_dropped
            and float(same.float().mean()) >= 0.5 and bool(near[flipped].all())):
        raise SystemExit("[moe] served logits disagree with the f32 prefill and decode")
    del params, params32, truth, cache, srv, served_log, f32_log, fwd_log, fwd32_log
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": {"chunk_digest": counts["chunk_digest"],
                         "flash_attention": flash,
                         "flash_attention_bwd": counts["flash_attention_bwd"]}}


def _usage() -> dict:
    """This process's CPU seconds, user and system, its own and its waited-
    for children's (``getrusage``), and its I/O bytes (``/proc/self/io``:
    ``read_bytes``/``write_bytes`` reached the storage layer, ``rchar``/
    ``wchar`` passed through read and write calls, page cache included)."""
    import resource

    me, kids = resource.getrusage(resource.RUSAGE_SELF), resource.getrusage(
        resource.RUSAGE_CHILDREN)
    out = {"cpu_user_s": me.ru_utime + kids.ru_utime, "cpu_sys_s": me.ru_stime + kids.ru_stime}
    with contextlib.suppress(OSError), open("/proc/self/io") as f:
        for line in f:
            key, value = line.split(":")
            if key in ("read_bytes", "write_bytes", "rchar", "wchar"):
                out[key] = int(value)
    return out


def _usage_fields(before: dict, after: dict) -> str:
    return " ".join(f"{k}={after[k] - before.get(k, 0):.1f}" if k.endswith("_s")
                    else f"{k}={after[k] - before.get(k, 0)}" for k in after)


@contextlib.contextmanager
def _clock(tag: str):
    """The phase's wall-clock line, printed when it ends, with the phase's
    CPU seconds and I/O bytes (:func:`_usage`); its start and end also go
    to standard error with the time of day, so that a run cut off from
    outside still shows which phase it was in."""
    t0, u0 = time.perf_counter(), _usage()
    print(f"{time.strftime('%H:%M:%S')} pid={os.getpid()} [{tag}] started",
          file=sys.stderr, flush=True)
    yield
    line = f"[{tag}] wall_s={time.perf_counter() - t0:.1f} {_usage_fields(u0, _usage())}"
    print(line, flush=True)
    print(f"{time.strftime('%H:%M:%S')} pid={os.getpid()} {line}", file=sys.stderr, flush=True)


# [hybrid]: zamba2-1.2b at full width, cut to HYBRID_LAYERS of its 38 (two
# applications of the shared block, after layers 6 and 12; 4.40 GB of
# state under AdamW: a cut for lane 2's time, PERF.md §4); then
# mamba2-130m served at full size from a fresh init
HYBRID_ARCH, HYBRID_LAYERS, HYBRID_STEPS = "zamba2-1.2b", 12, 6
SSM_ARCH = "mamba2-130m"


def _digests_after_steps(steps: list[dict], counts: dict) -> list[int]:
    """Digest launches after each step of a train CLI run (``steps``' own
    ``digests_at`` counts), up to the next step's start or the run's end
    (``counts``): that step's checkpoint sync, where it has one."""
    return [b - a[1] for a, b in zip(
        [st["digests_at"] for st in steps],
        [st["digests_at"][0] for st in steps[1:]] + [counts["chunk_digest"]])]


def _check_train_run(tag: str, card: str, cfg, store: str, out: dict, steps: list[dict],
                     after: list[int], n_steps: int) -> None:
    """A train CLI run's images and restart, as ``[moe]``, ``[hybrid]`` and
    ``[multimodal]`` hold them: images at 2, 4 and 6; digest launches 0
    after every step but the last (2 and 4 are first syncs), one grouped
    call after it, no kernel launch inside a step; the step-``n_steps``
    image's digests those of the run's state, the grouped digest over the
    state bitwise that of the plain version leaf by leaf; step 4 restored
    and run to ``n_steps`` bitwise equal to the run's state."""
    from repro_torch.checkpoint import ChunkStore
    from repro_torch.checkpoint.manifest import load_manifest
    from repro_torch.core import RestoreManager
    from repro_torch.data import SyntheticBatches
    from repro_torch.kernels import chunk_digest, ops, ref
    from repro_torch.launch.train import build_training
    from repro_torch.runtime.steps import batch_to_device
    from repro_torch.utils.tree import flatten_with_paths, tree_equal

    flat = flatten_with_paths(out["state"]["device"])[0]
    if [r.step for r in out["results"]] != [2, 4, 6]:
        raise SystemExit(f"[{tag}] images: {[r.step for r in out['results']]}")
    if after != [0] * (n_steps - 1) + [-(-len(flat) // chunk_digest.CAPACITY)] or any(
            st[k] for st in steps
            for k in ("chunk_digest", "flash_attention", "flash_attention_bwd")):
        raise SystemExit(f"[{tag}] launches: after each step {after}, per step {steps}")
    manifest = load_manifest(store, n_steps)
    stored = {path: [c.digest for sh in lv.shards for c in sh.chunks]
              for path, lv in manifest.leaves.items()}
    image_same = ops.tree_chunk_digests(out["state"], 1 << 20) == stored
    tensors = list(flat.values())
    state_bytes = sum(t.numel() * t.element_size() for t in tensors)
    digest_ms = _time_ms(lambda: chunk_digest.chunk_digest_table(tensors, 1 << 20)[0], 5)
    table = chunk_digest.chunk_digest_table(tensors, 1 << 20)[0]
    plain = torch.cat([ref.chunk_digests_plain(t, 1 << 20) for t in tensors])
    digest_equal = torch.equal(table, plain)
    print(f"[{tag}] {card} digest over the state: kernel_ms={digest_ms:.3f} "
          f"bound_ms={state_bytes / MEM_BYTES_PER_S * 1e3:.3f} (bytes) "
          f"rows={table.shape[0]} bitwise_equal_to_plain={digest_equal}", flush=True)
    del tensors, table, plain, flat
    torch.cuda.empty_cache()
    if not digest_equal:
        raise SystemExit(f"[{tag}] the digest kernel disagrees with its plain version")
    device = out["state"]["device"]["step"].device  # the card the run trained on
    run = build_training(cfg, batch=BATCH, seq=SEQ, lr=LR, total_steps=n_steps,
                         device=device)
    t_restore = time.perf_counter()
    state, _ = RestoreManager(ChunkStore(store)).restore(step=4, device_for=run.device_for)
    t_restore = time.perf_counter() - t_restore
    data = SyntheticBatches.from_state(cfg, batch=BATCH, seq_len=SEQ,
                                       state=state["host"]["data"])
    for step in range(5, n_steps + 1):
        state["device"], _ = run.step_fn(state["device"], batch_to_device(next(data), device))
        state["host"]["step"] = np.int64(step)
        state["host"]["data"] = data.state()
    torch.cuda.synchronize()
    same = tree_equal(state, out["state"])
    print(f"[{tag}] step-{n_steps} image digests equal the run's state: {image_same}; "
          f"restored step 4 in {t_restore:.1f} s, ran 5..{n_steps}: bitwise_equal to the "
          f"run's step-{n_steps} state={same}", flush=True)
    if not image_same:
        raise SystemExit(f"[{tag}] the stored step-{n_steps} image differs from the run")
    if not same:
        raise SystemExit(f"[{tag}] the restart diverged from the step-{n_steps} state")


def _served_vs_f32(tag: str, card: str, logits, served, hidden, head, n_prompt: int,
                   what: str) -> None:
    """Served logits (the prefill's, then decode's; (B, G, ..., V)) against
    the f32 upcast's teacher-forced forward: ``hidden(f32)`` gives the
    positions' final hidden of the bf16 (False) or the f32 (True) model over
    the prompt and the served tokens, ``head(h, f32)`` their logits. No
    further from it than the bf16 forward lies from the f32 one at any
    prompt position, and every served token whose top two f32 logits lie
    more than twice that difference apart is the f32 argmax."""
    G = logits.shape[1]
    with torch.no_grad():
        h16, h32 = hidden(False), hidden(True)
        tol = 0.0
        for s0 in range(0, n_prompt, LOGIT_CHUNK):
            s1 = min(s0 + LOGIT_CHUNK, n_prompt)
            tol = max(tol, float((head(h16[:, s0:s1], False)
                                  - head(h32[:, s0:s1], True)).abs().max()))
        want = head(h16[:, n_prompt - 1 : n_prompt - 1 + G], False)
        truth = head(h32[:, n_prompt - 1 : n_prompt - 1 + G], True)
    del h16, h32
    err = float((logits - truth).abs().max())
    top2 = truth.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * err
    agree = served == truth.argmax(dim=-1)
    print(f"[{tag}] {card} {what} teacher_forced (prompt + {G - 1} served) served_vs_f32="
          f"{err:.4g} (tol {tol:.4g} = bf16-vs-f32 forward over the prompt) "
          f"served_vs_bf16_forward={float((logits - want).abs().max()):.4g} "
          f"max_abs_logit={float(truth.abs().max()):.4g} "
          f"greedy_agree={int(agree.sum())}/{agree.numel()} "
          f"decided_agree={int((agree & decided).sum())}/{int(decided.sum())}", flush=True)
    if not (err <= tol and bool(agree[decided].all())):
        raise SystemExit(f"[{tag}] {what}: served logits disagree with the teacher-forced "
                         f"forward")


def _f32_config(cfg):
    return cfg.with_overrides(param_dtype="float32", compute_dtype="float32")


def _f32(params):
    from repro_torch.utils.tree import flatten_with_paths, unflatten_from_paths

    flat, treedef = flatten_with_paths(params)
    return unflatten_from_paths(treedef, {p: t.float() for p, t in flat.items()})


def _ssm_served_check(tag: str, card: str, cfg, srv) -> None:
    """The serve CLI's result ``srv`` on an SSM or hybrid model, held to
    forwards over the same tokens. The prefill's last logits must equal a
    forward over the prompt at its last position bit for bit. The served
    logits (the prefill's, then 31 decode steps') are held to the f32
    upcast's forward over the prompt and the first 31 served tokens
    (teacher forcing), zero-padded after them to a length the SSD's chunks
    and the flash blocks divide (every layer is causal: the padding moves
    no earlier position), by :func:`_served_vs_f32`."""
    from repro_torch.models import hybrid as hyb
    from repro_torch.models.layers import logits_from_embed

    params, prompt, logits = srv["params"], srv["prompt"], srv["logits"]
    B = prompt.shape[0]
    with torch.device("meta"):
        module = hyb.Hybrid(cfg)
    n = PROMPT + GEN - 1
    unit = (math.lcm(cfg.ssm_chunk, cfg.attn_block_q, cfg.attn_block_k) if cfg.attn_every
            else cfg.ssm_chunk)
    served = torch.from_numpy(srv["tokens"]).to(prompt.device, torch.int32)
    seq = torch.cat([prompt, served[:, :-1],
                     prompt.new_zeros((B, -(-n // unit) * unit - n))], dim=1)
    params32 = _f32(params)
    with torch.no_grad():
        h = hyb.hidden_forward(module, params, prompt)[0]
        prefill_same = torch.equal(logits_from_embed(params["embed"], h[:, -1:])[:, 0],
                                   logits[:, 0])
        del h
    print(f"[{tag}] {card} prefill_last_logits_bitwise_equal_to_forward_over_prompt="
          f"{prefill_same} teacher_forced seq={seq.shape[1]} (padded)", flush=True)
    if not prefill_same:
        raise SystemExit(f"[{tag}] the prefill's last logits differ from the forward's")
    _served_vs_f32(
        tag, card, logits, served,
        lambda f32: hyb.hidden_forward(module, params32 if f32 else params, seq)[0],
        lambda h, f32: logits_from_embed((params32 if f32 else params)["embed"], h),
        PROMPT, cfg.name)


def phase_hybrid(card: str) -> dict:
    """The SSM and hybrid families on the card (``[hybrid]``): zamba2-1.2b
    at full width (d_model 2048, 64 SSD heads x 64, state 64, conv 4, chunk
    256; the shared block 32 x 64 MHA with a SwiGLU d_ff 8192; vocab
    32,000, bf16 with the f32 ``A_log``, ``D`` and ``dt_bias``), 12 of its
    38 layers, the shared block after layers 6 and 12.

    The train CLI: batch 4, seq 512, the config's 4 microbatches and
    ``remat="dots"`` (each mamba layer and shared-block application
    recomputed whole, as the reference's), 6 steps, fork checkpoints at 2,
    4 and 6 (2 and 4 each their buffer's first sync: no digest; 6 one
    grouped ``chunk_digest`` launch), codec none, 1 MiB chunks; per step
    its ms, peak GB, loss, whether every gradient leaf is finite (read
    before the optimizer) and the largest decay exponent summed over a
    chunk, max over heads, chunks and layers of |A| * sum(dt) (the
    reference's gradient overflows past about 88); the step-6 image's
    digests those of the run's state, the grouped digest over the state
    bitwise that of the plain version leaf by leaf; step 4 restored and run
    to 6 bitwise equal to it. The serve CLI on the step-6 image: lazy
    restore, batch 2, an 8,192-token prompt (one flash launch per
    application of the shared block: 2, on ``wgmma`` at head dim 64), 32
    greedy tokens; eager restore the same bits; the prefill and decode
    held to forwards (:func:`_ssm_served_check`). Then the serve CLI on
    mamba2-130m at full size (24 layers, state 128) from a fresh init,
    the same prompt and tokens: no flash launch, the same checks."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve, train
    from repro_torch.models import hybrid as hyb
    from repro_torch.models import mamba2
    from repro_torch.optim.optimizers import Optimizer
    from repro_torch.utils.tree import flatten_with_paths

    cfg = dataclasses.replace(get_config(HYBRID_ARCH), num_layers=HYBRID_LAYERS)
    apps = hyb.n_shared_apps(cfg)
    steps = []
    make, cli_config = train.make_train_step, train.get_config

    def counting_make(model, optimizer, **kw):
        finite = []

        def update(grads, *args):  # every gradient leaf finite, before the step uses it
            finite.append(torch.stack([g.isfinite().all()
                                       for g in flatten_with_paths(grads)[0].values()]).all())
            return optimizer.update(grads, *args)

        fn = make(model, Optimizer(init=optimizer.init, update=update), **kw)

        def step(state, batch):
            torch.cuda.synchronize()
            c0 = _counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with mamba2.decay_log() as log:
                out = fn(state, batch)
                torch.cuda.synchronize()
            c1 = _counts()
            steps.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                              peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                              loss=float(out[1]["loss"]), finite=bool(finite[-1]),
                              decay=float(torch.stack(log).max()), calls=len(log),
                              digests_at=(c0["chunk_digest"], c1["chunk_digest"]),
                              **{k: c1[k] - c0[k] for k in
                                 ("chunk_digest", "flash_attention", "flash_attention_bwd")}))
            return out

        return step

    argv = ["--arch", HYBRID_ARCH, "--steps", str(HYBRID_STEPS), "--batch", str(BATCH),
            "--seq", str(SEQ), "--lr", str(LR), "--ckpt-every", "2", "--backend", "fork",
            "--codec", "none", "--log-every", "1"]
    with tempfile.TemporaryDirectory(prefix="chip-smoke-hybrid-") as tmp:
        store = os.path.join(tmp, "ckpt")
        train.make_train_step = counting_make
        train.get_config = lambda name, smoke=False: cfg  # the CLI at 12 of 38 layers
        try:
            _zero_counts()
            t0 = time.perf_counter()
            out = train.train(argv + ["--ckpt-dir", store])
            wall = time.perf_counter() - t0
            counts = _counts()
        finally:
            train.make_train_step = make
            train.get_config = cli_config
        after = _digests_after_steps(steps, counts)
        syncs = after[1::2]
        flat = flatten_with_paths(out["state"]["device"])[0]
        state_bytes = sum(t.numel() * t.element_size() for t in flat.values())
        n_params = sum(t.numel() for p, t in flat.items() if p.startswith("params/"))
        for i, st in enumerate(steps, 1):
            print(f"[hybrid] {card} step={i} step_ms={st['ms']:.1f} peak_gb={st['peak_gb']:.2f} "
                  f"loss={st['loss']:.4f} grads_finite={st['finite']} max_chunk_decay_exponent="
                  f"{st['decay']:.3f} (over {st['calls']} SSD calls) launches: "
                  f"digest={st['chunk_digest']} flash={st['flash_attention']} "
                  f"flash_bwd={st['flash_attention_bwd']}", flush=True)
        for r, n in zip(out["results"], syncs):
            print(f"[hybrid] {card} ckpt step={r.step} blocking_ms={r.blocking_s * 1e3:.1f} "
                  f"persist_ms={r.persist_s * 1e3:.1f} digest_ms={r.digest_us / 1e3:.1f} "
                  f"digest_launches={n} {_fetch_split(r)} synced={r.chunks_synced} "
                  f"written={r.chunks_written}", flush=True)
        m = out["metrics"]
        print(f"[hybrid] arch={HYBRID_ARCH} layers={cfg.num_layers} of 38 d_model={cfg.d_model} "
              f"ssd_heads={cfg.ssm_heads}x{cfg.ssm_head_dim} state={cfg.ssm_state} "
              f"chunk={cfg.ssm_chunk} shared_block_apps={apps} microbatches={cfg.microbatches} "
              f"remat={cfg.remat} params={n_params} state_bytes={state_bytes} "
              f"({len(flat)} leaves) steps={out['final_step']} wall_s={wall:.1f} "
              f"loss={m['loss']:.4f} grad_norm={m['grad_norm']:.4f} digest_launches_per_sync="
              f"{syncs} launches={ {k: counts[k] for k in ('chunk_digest', 'flash_attention', 'flash_attention_bwd')} }",
              flush=True)
        if out["final_step"] != HYBRID_STEPS or not all(map(math.isfinite, m.values())) or not all(
                math.isfinite(st["loss"]) and st["finite"] for st in steps):
            raise SystemExit(f"[hybrid] did not train cleanly: {out['final_step']} {m} {steps}")
        del flat  # the state's tensors go with out
        _check_train_run("hybrid", card, cfg, store, out, steps, after, HYBRID_STEPS)
        del out
        gc.collect()
        torch.cuda.empty_cache()

        # serving the step-6 image at its depth
        argv = ["--arch", HYBRID_ARCH, "--ckpt-dir", store, "--batch", str(SERVE_BATCH),
                "--prompt-len", str(PROMPT), "--gen", str(GEN)]
        _zero_counts()
        with mamba2.decay_log() as log:
            srv = serve.serve(argv + ["--lazy"])
        scounts = _counts()
        flash = scounts["flash_attention"]
        print(f"[hybrid] {card} serve lazy restore_s={srv['restore_s']:.3f} "
              f"ttft_s={srv['ttft_s']:.3f} decode_tok_s={srv['decode_tok_s']:.1f} "
              f"step={srv['step']} flash_attention_launches={flash} "
              f"by_route={scounts['flash_attention_by_route']} "
              f"chunk_digest_launches={scounts['chunk_digest']} prefill_max_chunk_decay_"
              f"exponent={float(torch.stack(log).max()):.3f}", flush=True)
        del log
        logits = srv["logits"]
        if srv["step"] != HYBRID_STEPS or flash != apps or \
                scounts["flash_attention_by_route"]["wgmma"] != flash:
            raise SystemExit(f"[hybrid] serve: step {srv['step']}, flash launches {scounts}")
        if logits.shape != (SERVE_BATCH, GEN, cfg.vocab_size) or not bool(
                logits.isfinite().all()):
            raise SystemExit(f"[hybrid] served logits: {tuple(logits.shape)}")
        eager = serve.serve(argv)
        eager_same = bool(np.array_equal(eager["tokens"], srv["tokens"])
                          and torch.equal(eager["logits"], logits))
        print(f"[hybrid] {card} serve eager restore_s={eager['restore_s']:.3f} "
              f"ttft_s={eager['ttft_s']:.3f} decode_tok_s={eager['decode_tok_s']:.1f} "
              f"bitwise_equal_to_lazy={eager_same}", flush=True)
        del eager
        if not eager_same:
            raise SystemExit("[hybrid] eager and lazy serving disagree")
    _ssm_served_check("hybrid", card, cfg, srv)
    del srv, logits
    gc.collect()
    torch.cuda.empty_cache()

    # the attention-free path: mamba2-130m at full size, a fresh init
    ssm_cfg = get_config(SSM_ARCH)
    _zero_counts()
    srv = serve.serve(["--arch", SSM_ARCH, "--batch", str(SERVE_BATCH),
                       "--prompt-len", str(PROMPT), "--gen", str(GEN)])
    ssm_counts = _counts()
    n_ssm = sum(t.numel() for t in flatten_with_paths(srv["params"])[0].values())
    print(f"[hybrid] {card} {SSM_ARCH} layers={ssm_cfg.num_layers} d_model={ssm_cfg.d_model} "
          f"state={ssm_cfg.ssm_state} params={n_ssm} serve fresh init_s={srv['restore_s']:.3f} "
          f"ttft_s={srv['ttft_s']:.3f} decode_tok_s={srv['decode_tok_s']:.1f} "
          f"flash_attention_launches={ssm_counts['flash_attention']}", flush=True)
    if ssm_counts["flash_attention"] or srv["logits"].shape != (
            SERVE_BATCH, GEN, ssm_cfg.vocab_size) or not bool(srv["logits"].isfinite().all()):
        raise SystemExit(f"[hybrid] {SSM_ARCH} serve: {ssm_counts}, "
                         f"{tuple(srv['logits'].shape)}")
    _ssm_served_check("hybrid", card, ssm_cfg, srv)
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": {"chunk_digest": counts["chunk_digest"], "flash_attention": flash,
                         "flash_attention_bwd": counts["flash_attention_bwd"]}}


# [multimodal]: paligemma-3b at full width, cut to MM_LAYERS of its 18 (7.51
# GB of state under AdamW: a cut for lane 2's time, PERF.md §4), its image
# of MM_PATCHES patches a bidirectional prefix; then musicgen-medium served
# at full size from a fresh init, AUDIO_PROMPT frames (30 s of audio at
# EnCodec's 50 Hz) of its 4 codebooks and AUDIO_GEN greedy frames
MM_ARCH, MM_LAYERS, MM_STEPS, MM_PATCHES = "paligemma-3b", 2, 6, 256
AUDIO_ARCH, AUDIO_PROMPT, AUDIO_GEN = "musicgen-medium", 1500, 64


class _FlashCalls:
    """``ops``' view of the forward kernel's module, recording each launch's
    head dim, ``prefix_len`` and dtype before it goes to the kernel."""

    def __init__(self, module):
        self.module, self.calls = module, []

    def __getattr__(self, name):
        return getattr(self.module, name)

    def flash_attention(self, q, k, v, **kw):
        self.calls.append((q.shape[-1], kw.get("prefix_len", 0), str(q.dtype)))
        return self.module.flash_attention(q, k, v, **kw)


def phase_multimodal(card: str) -> dict:
    """The multimodal family on the card (``[multimodal]``): paligemma-3b at
    full width (d_model 2048, 8 q heads and 1 kv head x 256, GeGLU d_ff
    16,384, vocab 257,216 tied and scaled by sqrt(d_model), ``vision_proj``
    2048 x 2048, 256 patches), 2 of its 18 layers.

    The train CLI: batch 4, 256 patches + 512 text tokens (768 positions:
    the dense lowering, no flash launch), ``remat="dots"``, 6 steps, fork
    checkpoints at 2, 4 and 6 (2 and 4 each their buffer's first sync: no
    digest; 6 one grouped ``chunk_digest`` launch), codec none, 1 MiB
    chunks; per step its ms, peak GB and loss; the step-6 image's digests
    those of the run's state, the grouped digest over the state bitwise
    that of the plain version leaf by leaf; step 4 restored and run to 6
    bitwise equal to it. The serve CLI on the step-6 image: lazy restore,
    batch 2, 256 patches + 7,936 text tokens (8,192 positions: the chunked
    lowering, one flash launch a layer on ``wgmma`` at head dim 256 with
    ``prefix_len`` 256), 32 greedy tokens; eager restore the same bits; the
    prefill's last logits those of the forward over the prompt bit for
    bit; the served logits held to the f32 upcast's teacher-forced forward
    (:func:`_served_vs_f32`). Then the serve CLI on musicgen-medium at full
    size (48 layers, 24 x 64 MHA, GELU d_ff 6,144, 4 codebooks of 2,048)
    from a fresh init: batch 2, 1,500 frames, 64 greedy frames (the dense
    lowering, no flash launch), the same checks per codebook."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve, train
    from repro_torch.models import multimodal as mm
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import logits_from_embed
    from repro_torch.utils.tree import flatten_with_paths

    cfg = dataclasses.replace(get_config(MM_ARCH), num_layers=MM_LAYERS)
    if cfg.num_patches != MM_PATCHES:
        raise SystemExit(f"[multimodal] {MM_ARCH} has {cfg.num_patches} patches")
    kernels = ("chunk_digest", "flash_attention", "flash_attention_bwd")
    steps = []
    make, cli_config = train.make_train_step, train.get_config

    def counting_make(model, optimizer, **kw):
        fn = make(model, optimizer, **kw)

        def step(state, batch):
            torch.cuda.synchronize()
            c0 = _counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = fn(state, batch)
            torch.cuda.synchronize()
            c1 = _counts()
            steps.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                              peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                              loss=float(out[1]["loss"]),
                              digests_at=(c0["chunk_digest"], c1["chunk_digest"]),
                              **{k: c1[k] - c0[k] for k in kernels}))
            return out

        return step

    argv = ["--arch", MM_ARCH, "--steps", str(MM_STEPS), "--batch", str(BATCH),
            "--seq", str(SEQ), "--lr", str(LR), "--ckpt-every", "2", "--backend", "fork",
            "--codec", "none", "--log-every", "1"]
    with tempfile.TemporaryDirectory(prefix="chip-smoke-multimodal-") as tmp:
        store = os.path.join(tmp, "ckpt")
        train.make_train_step = counting_make
        train.get_config = lambda name, smoke=False: cfg  # the CLI at 2 of 18 layers
        try:
            _zero_counts()
            t0 = time.perf_counter()
            out = train.train(argv + ["--ckpt-dir", store])
            wall = time.perf_counter() - t0
            counts = _counts()
        finally:
            train.make_train_step = make
            train.get_config = cli_config
        after = _digests_after_steps(steps, counts)
        syncs = after[1::2]
        flat = flatten_with_paths(out["state"]["device"])[0]
        state_bytes = sum(t.numel() * t.element_size() for t in flat.values())
        n_params = sum(t.numel() for p, t in flat.items() if p.startswith("params/"))
        for i, st in enumerate(steps, 1):
            print(f"[multimodal] {card} step={i} step_ms={st['ms']:.1f} "
                  f"peak_gb={st['peak_gb']:.2f} loss={st['loss']:.4f} launches: "
                  f"digest={st['chunk_digest']} flash={st['flash_attention']} "
                  f"flash_bwd={st['flash_attention_bwd']}", flush=True)
        for r, n in zip(out["results"], syncs):
            print(f"[multimodal] {card} ckpt step={r.step} blocking_ms={r.blocking_s * 1e3:.1f} "
                  f"persist_ms={r.persist_s * 1e3:.1f} digest_ms={r.digest_us / 1e3:.1f} "
                  f"digest_launches={n} {_fetch_split(r)} synced={r.chunks_synced} "
                  f"written={r.chunks_written}", flush=True)
        m = out["metrics"]
        print(f"[multimodal] arch={MM_ARCH} layers={cfg.num_layers} of 18 d_model={cfg.d_model} "
              f"heads={cfg.num_heads}/{cfg.num_kv_heads}x{cfg.head_dim} d_ff={cfg.d_ff} "
              f"vocab={cfg.vocab_size} patches={cfg.num_patches} positions="
              f"{cfg.num_patches + SEQ} remat={cfg.remat} params={n_params} "
              f"state_bytes={state_bytes} ({len(flat)} leaves) steps={out['final_step']} "
              f"wall_s={wall:.1f} loss={m['loss']:.4f} grad_norm={m['grad_norm']:.4f} "
              f"digest_launches_per_sync={syncs} launches="
              f"{ {k: counts[k] for k in kernels} }", flush=True)
        if out["final_step"] != MM_STEPS or not all(map(math.isfinite, m.values())) or not all(
                math.isfinite(st["loss"]) for st in steps):
            raise SystemExit(f"[multimodal] did not train cleanly: {out['final_step']} {m} "
                             f"{steps}")
        del flat  # the state's tensors go with out
        _check_train_run("multimodal", card, cfg, store, out, steps, after, MM_STEPS)
        del out
        gc.collect()
        torch.cuda.empty_cache()

        # serving the step-6 image at its depth: the image and the text fill
        # the flash lowering's 8,192 positions
        text = PROMPT - cfg.num_patches
        argv = ["--arch", MM_ARCH, "--ckpt-dir", store, "--batch", str(SERVE_BATCH),
                "--prompt-len", str(text), "--gen", str(GEN)]
        recorder = _FlashCalls(ops._flash)
        ops._flash = recorder
        try:
            _zero_counts()
            srv = serve.serve(argv + ["--lazy"])
            scounts = _counts()
        finally:
            ops._flash = recorder.module
        flash = scounts["flash_attention"]
        print(f"[multimodal] {card} serve lazy restore_s={srv['restore_s']:.3f} "
              f"ttft_s={srv['ttft_s']:.3f} (the prefill of {cfg.num_patches} patches + {text} "
              f"tokens) decode_tok_s={srv['decode_tok_s']:.1f} step={srv['step']} "
              f"flash_attention_launches={flash} by_route={scounts['flash_attention_by_route']} "
              f"(head dim, prefix_len, dtype)={sorted(set(recorder.calls))} "
              f"chunk_digest_launches={scounts['chunk_digest']}", flush=True)
        logits = srv["logits"]
        if srv["step"] != MM_STEPS or flash != MM_LAYERS or \
                scounts["flash_attention_by_route"]["wgmma"] != flash or \
                recorder.calls != [(256, MM_PATCHES, "torch.bfloat16")] * MM_LAYERS:
            raise SystemExit(f"[multimodal] serve: step {srv['step']}, flash launches {scounts}, "
                             f"calls {recorder.calls}")
        if logits.shape != (SERVE_BATCH, GEN, cfg.vocab_size) or not bool(
                logits.isfinite().all()):
            raise SystemExit(f"[multimodal] served logits: {tuple(logits.shape)}")
        eager = serve.serve(argv)
        eager_same = bool(np.array_equal(eager["tokens"], srv["tokens"])
                          and torch.equal(eager["logits"], logits))
        print(f"[multimodal] {card} serve eager restore_s={eager['restore_s']:.3f} "
              f"ttft_s={eager['ttft_s']:.3f} decode_tok_s={eager['decode_tok_s']:.1f} "
              f"bitwise_equal_to_lazy={eager_same}", flush=True)
        del eager
        if not eager_same:
            raise SystemExit("[multimodal] eager and lazy serving disagree")

    # the prefill against the forward over the image and the prompt, and the
    # served logits against the f32 upcast's forward over the image, the
    # prompt and the served tokens, zero-padded to a length the flash
    # blocks divide (the text is causal: the padding moves no earlier
    # position)
    params, patches, prompt = srv["params"], srv["patches"], srv["prompt"]
    with torch.device("meta"):  # the f32 upcast casts the patches to f32
        module, module32 = tfm.Transformer(cfg), tfm.Transformer(_f32_config(cfg))
    served = torch.from_numpy(srv["tokens"]).to(prompt.device, torch.int32)
    n = cfg.num_patches + text + GEN - 1
    unit = math.lcm(cfg.attn_block_q, cfg.attn_block_k)
    seq = torch.cat([prompt, served[:, :-1], prompt.new_zeros(
        (SERVE_BATCH, -(-n // unit) * unit - n))], dim=1)
    params32 = _f32(params)
    with torch.no_grad():
        h = mm.vlm_hidden(module, params, patches, prompt)[0]
        prefill_same = torch.equal(logits_from_embed(params["embed"], h[:, -1:])[:, 0],
                                   logits[:, 0])
        del h
    print(f"[multimodal] {card} {MM_ARCH} prefill_last_logits_bitwise_equal_to_forward_over_"
          f"prompt={prefill_same} teacher_forced positions={cfg.num_patches + seq.shape[1]} "
          f"(padded)", flush=True)
    if not prefill_same:
        raise SystemExit("[multimodal] the prefill's last logits differ from the forward's")
    _served_vs_f32(
        "multimodal", card, logits, served,
        lambda f32: mm.vlm_hidden(module32 if f32 else module, params32 if f32 else params,
                                  patches, seq)[0],
        lambda h, f32: logits_from_embed((params32 if f32 else params)["embed"], h),
        text, MM_ARCH)
    del srv, logits, params, params32, patches
    gc.collect()
    torch.cuda.empty_cache()

    # musicgen-medium at full size, a fresh init: 4 codebooks a frame
    acfg = get_config(AUDIO_ARCH)
    _zero_counts()
    srv = serve.serve(["--arch", AUDIO_ARCH, "--batch", str(SERVE_BATCH),
                       "--prompt-len", str(AUDIO_PROMPT), "--gen", str(AUDIO_GEN)])
    acounts = _counts()
    params, prompt, logits = srv["params"], srv["prompt"], srv["logits"]
    n_audio = sum(t.numel() for t in flatten_with_paths(params)[0].values())
    K = acfg.audio_codebooks
    print(f"[multimodal] {card} {AUDIO_ARCH} layers={acfg.num_layers} d_model={acfg.d_model} "
          f"heads={acfg.num_heads}x{acfg.head_dim} codebooks={K}x{acfg.vocab_size} "
          f"params={n_audio} serve fresh init_s={srv['restore_s']:.3f} prompt_frames="
          f"{AUDIO_PROMPT} ttft_s={srv['ttft_s']:.3f} decode_frames_per_s="
          f"{srv['decode_tok_s'] / SERVE_BATCH:.1f} (x{K} codebooks x{SERVE_BATCH} batch) "
          f"flash_attention_launches={acounts['flash_attention']}", flush=True)
    if acounts["flash_attention"] or logits.shape != (
            SERVE_BATCH, AUDIO_GEN, K, acfg.vocab_size) or not bool(logits.isfinite().all()):
        raise SystemExit(f"[multimodal] {AUDIO_ARCH} serve: {acounts}, {tuple(logits.shape)}")
    with torch.device("meta"):
        module = tfm.Transformer(acfg)
    served = torch.from_numpy(srv["tokens"]).to(prompt.device, torch.int32)
    seq = torch.cat([prompt, served[:, :-1]], dim=1)
    params32 = _f32(params)
    with torch.no_grad():
        h = mm.audio_hidden(module, params, prompt)[0]
        prefill_same = torch.equal(mm._audio_logits(acfg, params, h[:, -1:])[:, 0],
                                   logits[:, 0])
        del h
    print(f"[multimodal] {card} {AUDIO_ARCH} prefill_last_logits_bitwise_equal_to_forward_"
          f"over_prompt={prefill_same}", flush=True)
    if not prefill_same:
        raise SystemExit(f"[multimodal] {AUDIO_ARCH}: the prefill's last logits differ from "
                         f"the forward's")
    _served_vs_f32(
        "multimodal", card, logits, served,
        lambda f32: mm.audio_hidden(module, params32 if f32 else params, seq)[0],
        lambda h, f32: mm._audio_logits(acfg, params32 if f32 else params, h),
        AUDIO_PROMPT, AUDIO_ARCH)
    del srv, logits, params, params32
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": {"chunk_digest": counts["chunk_digest"], "flash_attention": flash,
                         "flash_attention_bwd": counts["flash_attention_bwd"]}}


# [multimodal:long]: paligemma-3b at full width, MM_LAYERS of its 18, trained
# by the train CLI at batch 1 over MM_PATCHES patches + MM_LONG_TEXT text
# tokens (8,192 positions: the chunked lowering, the flash kernels at head
# dim 256 with the image a prefix), MM_LONG_STEPS steps, one checkpoint at
# MM_LONG_CKPT
MM_LONG_TEXT, MM_LONG_STEPS, MM_LONG_CKPT = LONG_SEQ - MM_PATCHES, 4, 2


def phase_multimodal_long(card: str) -> dict:
    """paligemma-3b trained at 8,192 positions on the card
    (``[multimodal:long]``): full width, 2 of its 18 layers (as
    ``[multimodal]`` cuts it), the train CLI at batch 1, 256 patches +
    7,936 text tokens, ``remat="dots"``, 4 steps, one fork checkpoint at
    step 2, codec none. Every layer's attention is the flash forward at
    head dim 256 with ``prefix_len`` 256 and its gradient the backward
    kernel: per step exactly 2 x 2 forward launches (remat recomputes each
    layer's attention in the backward) and 2 backward calls, all on the
    tensor-core routes, no digest launch, all of them counted for the
    step's thread too; every step's loss and gradient norm finite (a
    non-finite gradient leaf makes the norm so); per step its ms and peak
    GB. The step-2 image restored and run to step 4 must equal the run's
    step-4 state bit for bit."""
    import dataclasses

    from repro_torch.checkpoint import ChunkStore
    from repro_torch.configs import get_config
    from repro_torch.core import CheckpointPolicy, RestoreManager
    from repro_torch.data import SyntheticBatches
    from repro_torch.kernels import flash_attention
    from repro_torch.launch import train
    from repro_torch.launch.train import build_training
    from repro_torch.runtime.steps import batch_to_device
    from repro_torch.utils.tree import tree_equal

    cfg = dataclasses.replace(get_config(MM_ARCH), num_layers=MM_LAYERS)
    if cfg.num_patches + MM_LONG_TEXT < cfg.attn_chunked_threshold:
        raise SystemExit(f"[multimodal:long] {cfg.num_patches + MM_LONG_TEXT} positions take "
                         f"the dense lowering")
    L = cfg.num_layers
    want_step = {"flash_attention": 2 * L, "flash_attention_bwd": L, "chunk_digest": 0,
                 "thread": (2 * L, L), "routes": (2 * L, L)}
    steps = []
    make, cli_config, cli_policy = train.make_train_step, train.get_config, train.CheckpointPolicy

    def counting_make(model, optimizer, **kw):
        fn = make(model, optimizer, **kw)

        def step(state, batch):
            torch.cuda.synchronize()
            c0 = _counts()
            t_fwd, t_bwd = flash_attention.thread_launches(), flash_attention.thread_bwd_launches()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = fn(state, batch)
            torch.cuda.synchronize()
            c1 = _counts()
            steps.append({
                "ms": (time.perf_counter() - t0) * 1e3,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "loss": float(out[1]["loss"]), "grad_norm": float(out[1]["grad_norm"]),
                **{key: c1[key] - c0[key] for key in
                   ("flash_attention", "flash_attention_bwd", "chunk_digest")},
                "thread": (flash_attention.thread_launches() - t_fwd,
                           flash_attention.thread_bwd_launches() - t_bwd),
                "routes": (c1["flash_attention_by_route"]["wgmma"]
                           - c0["flash_attention_by_route"]["wgmma"],
                           c1["flash_attention_bwd_by_route"]["mma"]
                           - c0["flash_attention_bwd_by_route"]["mma"])})
            return out

        return step

    class AtStep(CheckpointPolicy):  # the CLI's policy, one checkpoint only
        def should_checkpoint(self, step: int) -> bool:
            return step == MM_LONG_CKPT or self._preempt

    argv = ["--arch", MM_ARCH, "--steps", str(MM_LONG_STEPS), "--batch", "1",
            "--seq", str(MM_LONG_TEXT), "--lr", str(LR), "--ckpt-every", str(MM_LONG_CKPT),
            "--backend", "fork", "--codec", "none", "--log-every", "1"]
    with tempfile.TemporaryDirectory(prefix="chip-smoke-multimodal-long-") as tmp:
        store = os.path.join(tmp, "ckpt")
        train.make_train_step, train.CheckpointPolicy = counting_make, AtStep
        train.get_config = lambda name, smoke=False: cfg  # the CLI at 2 of 18 layers
        try:
            _zero_counts()
            t0 = time.perf_counter()
            out = train.train(argv + ["--ckpt-dir", store])
            wall = time.perf_counter() - t0
            counts = _counts()
        finally:
            train.make_train_step, train.get_config = make, cli_config
            train.CheckpointPolicy = cli_policy
        for i, st in enumerate(steps, 1):
            print(f"[multimodal:long] {card} step={i} step_ms={st['ms']:.1f} "
                  f"peak_gb={st['peak_gb']:.2f} loss={st['loss']:.4f} "
                  f"grad_norm={st['grad_norm']:.4f} flash_fwd={st['flash_attention']} "
                  f"flash_bwd_calls={st['flash_attention_bwd']} digest={st['chunk_digest']} "
                  f"(wgmma, mma)={st['routes']} this_thread(fwd, bwd)={st['thread']}",
                  flush=True)
        for r in out["results"]:
            print(f"[multimodal:long] ckpt step={r.step} blocking_ms={r.blocking_s * 1e3:.1f} "
                  f"persist_ms={r.persist_s * 1e3:.1f} {_fetch_split(r)} "
                  f"synced={r.chunks_synced} written={r.chunks_written}", flush=True)
        warm = [st["ms"] for st in steps[1:]]
        print(f"[multimodal:long] arch={MM_ARCH} layers={L} of 18 heads={cfg.num_heads}/"
              f"{cfg.num_kv_heads}x{cfg.head_dim} batch=1 positions={cfg.num_patches} patches "
              f"+ {MM_LONG_TEXT} text remat={cfg.remat} steps={out['final_step']} "
              f"wall_s={wall:.1f} warm_step_ms={min(warm):.1f} (steps 2..{MM_LONG_STEPS}: "
              f"{' '.join(f'{x:.1f}' for x in warm)}) peak_gb="
              f"{max(st['peak_gb'] for st in steps):.2f} launches="
              f"{ {k: counts[k] for k in ('flash_attention', 'flash_attention_bwd', 'chunk_digest')} }",
              flush=True)
        finite = all(math.isfinite(st[k]) for st in steps for k in ("loss", "grad_norm"))
        if out["final_step"] != MM_LONG_STEPS or not finite:
            raise SystemExit(f"[multimodal:long] did not train cleanly: {out['final_step']} "
                             f"{steps}")
        if [r.step for r in out["results"]] != [MM_LONG_CKPT]:
            raise SystemExit(f"[multimodal:long] images: {[r.step for r in out['results']]}")
        bad = [st for st in steps if {k: st[k] for k in want_step} != want_step]
        if len(steps) != MM_LONG_STEPS or bad:
            raise SystemExit(f"[multimodal:long] launches per step, want {want_step} on the "
                             f"tensor-core routes: {bad or len(steps)}")
        run = build_training(cfg, batch=1, seq=MM_LONG_TEXT, lr=LR, total_steps=MM_LONG_STEPS,
                             device=out["state"]["device"]["step"].device)
        t_restore = time.perf_counter()
        state, _ = RestoreManager(ChunkStore(store)).restore(step=MM_LONG_CKPT,
                                                             device_for=run.device_for)
        t_restore = time.perf_counter() - t_restore
        data = SyntheticBatches.from_state(cfg, batch=1, seq_len=MM_LONG_TEXT,
                                           state=state["host"]["data"])
        for step in range(MM_LONG_CKPT + 1, MM_LONG_STEPS + 1):
            state["device"], _ = run.step_fn(state["device"],
                                             batch_to_device(next(data), run.device))
            state["host"]["step"] = np.int64(step)
            state["host"]["data"] = data.state()
        torch.cuda.synchronize()
        same = tree_equal(state, out["state"])
        print(f"[multimodal:long] restored step {MM_LONG_CKPT} in {t_restore:.1f} s, ran "
              f"{MM_LONG_CKPT + 1}..{MM_LONG_STEPS}: bitwise_equal to the run's "
              f"step-{MM_LONG_STEPS} state={same}", flush=True)
        if not same:
            raise SystemExit("[multimodal:long] the restart diverged from the straight run")
        del state, out, run
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": {k: counts[k] for k in
                         ("chunk_digest", "flash_attention", "flash_attention_bwd")}}


# [cluster] and [cluster:proxy] train 2 of the train program's 24 layers
# (full width), cuts for the script's time (PERF.md §4)
CLUSTER_SPEC = dict(UVM_SPEC, num_layers=2)
CLUSTER_PROXY_SPEC = dict(UVM_SPEC, num_layers=2)
CLUSTER_CHUNK = 1 << 20
# [cluster:remote]'s faults, fired by the injection engine once the first
# round has committed, in this order: rank 1's heartbeat clock 120 s ahead
# for 10 s (the watchdog alerts beyond 30 s), daemon ph0 SIGKILLed, a torn
# frame at the coordinator
CHAOS_PLAN = [
    ("clock_skew", {"host": 1, "skew_s": 120.0, "duration_s": 10.0}),
    ("kill_proxy_host", {"index": 0}),
    ("torn_frame", {}),
]
CHAOS_MAX_SKEW_S = 30.0
# the soak verdict's limit on a committed round's seconds, from this phase's
# own recorded rounds (PERF.md §5): round 2 read 5.10-6.90 s, round 4, which
# holds ph0's reschedule, 10.86-12.86 s; about twice the longest, for a
# slower host
CHAOS_ROUND_ENVELOPE_S = 25.0


def _host_chunk_table(state, cb: int) -> dict:
    """``chunk_digest_np`` over every leaf's bytes, on the host (8 threads)."""
    import concurrent.futures as cf

    from repro_torch.checkpoint.chunking import chunk_digest_np
    from repro_torch.utils.tree import flatten_with_paths, leaf_bytes

    out = {}
    with cf.ThreadPoolExecutor(8) as pool:
        for path, leaf in flatten_with_paths(state)[0].items():
            raw = leaf_bytes(leaf)
            out[path] = list(pool.map(lambda i: chunk_digest_np(raw[i : i + cb]),
                                      range(0, max(raw.nbytes, 1), cb)))
    return out


class _MemWatch:
    """The card's free memory, sampled every half second while the block runs."""

    def __init__(self):
        import threading

        self.free0, self.total = torch.cuda.mem_get_info()
        self.low = self.free0
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.wait(0.5):
            self.low = min(self.low, torch.cuda.mem_get_info()[0])

    def __enter__(self):
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join()
        self.free1 = torch.cuda.mem_get_info()[0]


def _cluster_rounds(tag: str, card: str, report) -> None:
    acks = iter(report.acks)
    for r in report.rounds:
        if r.status != "committed":
            print(f"{tag} {card} round step={r.step} {r.status} reason={r.reason!r} "
                  f"round_ms={r.round_s * 1e3:.1f}", flush=True)
            continue
        print(f"{tag} {card} round step={r.step} committed round_ms={r.round_s * 1e3:.1f} "
              f"commit_ms={r.commit_s * 1e3:.1f} bytes_written={r.bytes_written}", flush=True)
        for h, a in sorted(next(acks).items()):
            print(f"{tag} {card}   rank={h} blocking_ms={a['blocking_s'] * 1e3:.1f} "
                  f"persist_ms={a['persist_s'] * 1e3:.1f} sync_us={a['sync_us']:.0f} "
                  f"digest_us={a['digest_us']:.0f} fetch_us={a['fetch_us']:.0f} "
                  f"chunks_synced={a['chunks_synced']} bytes_written={a['bytes_written']} "
                  f"step_launches={a['step_launches']} "
                  f"provenance_launches={a['provenance_launches']} "
                  f"sync_launches={a['sync_launches']} "
                  f"witness_ms={a.get('state_digest_s', 0) * 1e3:.1f}", flush=True)


def phase_cluster(card: str) -> dict:
    """The cluster path with inline ranks (``[cluster]``); returns each
    kernel's launches in the ranks."""
    from repro_torch.checkpoint import ChunkStore
    from repro_torch.checkpoint.manifest import committed_steps
    from repro_torch.coord import run_cluster
    from repro_torch.core import RestoreManager
    from repro_torch.obs.journal import read_journal
    from repro_torch.proxy import make_program
    from repro_torch.utils.dtypes import byte_view
    from repro_torch.utils.tree import flatten_with_paths, tree_digest, tree_equal

    import gc

    tag = "[cluster]"
    gc.collect()
    torch.cuda.empty_cache()  # the earlier phases' cached blocks
    cuda = torch.device("cuda", torch.cuda.current_device())
    on_card = lambda p, s: cuda if p.startswith("device/") else None  # noqa: E731
    prog = make_program(CLUSTER_SPEC)
    nbytes = prog.state_nbytes()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-cluster-") as tmp:
        root = os.path.join(tmp, "ckpt")
        mem = _MemWatch()
        print(f"{tag} {card} state_bytes={nbytes} ranks=2 card_free_before={mem.free0} "
              f"card_total={mem.total}", flush=True)
        t0 = time.perf_counter()
        with mem:
            report = run_cluster(
                root=root, n_hosts=2, total_steps=STEPS, ckpt_every=2, backend="fork",
                codec="none", chunk_bytes=CLUSTER_CHUNK, program=CLUSTER_SPEC,
                device="cuda", kill_host=1, kill_at_step=4, deadline_s=900.0,
                round_timeout_s=300.0)
        wall = time.perf_counter() - t0
        _cluster_rounds(tag, card, report)
        log = read_journal(report.log_path)
        death = next(e.t for e in log if e.event == "death" and e.host == 1)
        rejoin = next(e for e in log if e.event == "join" and e.host == 1
                      and e.restored_from is not None)
        print(f"{tag} {card} cluster wall_s={wall:.1f} restarts={report.restarts} "
              f"host1_recovery_s={rejoin.t - death:.2f} (death to re-JOIN, restored "
              f"from step {rejoin.restored_from}) card_free_lowest={mem.low} "
              f"card_free_after={mem.free1} alerts={sorted(report.alert_kinds())}",
              flush=True)

        # the same program inline on the card, from the same host init
        state = prog.on_restore(prog.init_state())
        by_step = dict(zip([r.step for r in report.committed], report.acks))
        oracle = {}
        for step in range(1, STEPS + 1):
            state, _ = prog.step(state, step)
            if step % 2 == 0:
                t1 = time.perf_counter()
                table = _host_chunk_table(state, CLUSTER_CHUNK)
                acked = by_step[step][0].get("chunk_digests")
                oracle[step] = (acked == table, sum(map(len, table.values())),
                                time.perf_counter() - t1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        inline_digest = tree_digest(state)
        witness_s = time.perf_counter() - t1
        rm = RestoreManager(ChunkStore(root))
        t1 = time.perf_counter()
        image, _ = rm.restore(step=STEPS, device_for=on_card)
        restore_s = time.perf_counter() - t1
        same = {"image": tree_equal(image["device"], state)
                and int(image["host"]["step"]) == STEPS}
        del image
        same["final_digests"] = set(report.final_digests.values()) == {inline_digest}
        flat = flatten_with_paths(state)[0]
        rows = {p: 0 for p in flat}
        elastic_ok = True
        t1 = time.perf_counter()
        for h in range(3):
            tree, _ = rm.restore_elastic(n_hosts=3, host=h, step=STEPS, device=cuda)
            for p, v in flatten_with_paths(tree["device"])[0].items():
                if v.data is None:
                    continue
                leaf = flat[p]
                window = leaf[v.start[0]:v.stop[0]] if leaf.dim() else leaf
                elastic_ok &= torch.equal(byte_view(v.data), byte_view(window))
                rows[p] += (v.stop[0] - v.start[0]) if leaf.dim() else 1
            del tree
        elastic_s = time.perf_counter() - t1
        same["elastic_3"] = elastic_ok and all(
            n == (flat[p].shape[0] if flat[p].dim() else 1) for p, n in rows.items())
        print(f"{tag} {card} inline: provenance vs chunk_digest_np "
              f"{ {s: (ok, n, round(t, 1)) for s, (ok, n, t) in oracle.items()} } "
              f"inline_witness_ms={witness_s * 1e3:.1f} restore_step6_s={restore_s:.1f} "
              f"elastic_3_s={elastic_s:.1f} bitwise={same}", flush=True)
        steps = committed_steps(root)
        del state
        torch.cuda.empty_cache()

    # each rank's launches per committed ack, counted in its own process:
    # (window steps' digest and flash, provenance table, shadow sync); a
    # rank process's first sync (step 2; step 4 for the respawned rank 1)
    # leaves its digests to the persist child
    first = {(0, 2), (1, 2), (1, rejoin.restored_from + 2)}
    launches = {(h, r.step): (a["step_launches"]["chunk_digest"],
                              a["step_launches"]["flash_attention"],
                              a["provenance_launches"], a["sync_launches"])
                for r, acks in zip(report.committed, report.acks) for h, a in acks.items()}
    want = {k: (0, 0, 1, 0 if k in first else 1) for k in launches}
    step4 = [r for r in report.rounds if r.step == 4]
    if [r.step for r in report.committed] != [2, 4, 6] or steps != [2, 4, 6]:
        raise SystemExit(f"cluster committed {[r.step for r in report.committed]} ({steps})")
    if [r.status for r in step4] != ["aborted", "committed"] or "host 1" not in step4[0].reason:
        raise SystemExit(f"round 4: {[(r.status, r.reason) for r in step4]}")
    if report.restarts != {0: 0, 1: 1} or rejoin.restored_from != 2:
        raise SystemExit(f"restarts {report.restarts}, restored from {rejoin.restored_from}")
    if "worker_death" not in report.alert_kinds() or not report.lockstep():
        raise SystemExit(f"alerts {report.alert_kinds()}, lockstep {report.lockstep()}")
    if not all(ok for ok, _, _ in oracle.values()) or sorted(oracle) != [2, 4, 6]:
        raise SystemExit(f"a round's chunk digests disagree with chunk_digest_np: {oracle}")
    if not all(same.values()):
        raise SystemExit(f"the cluster's states differ from the inline run: {same}")
    if launches != want:
        raise SystemExit(f"kernel launches per (rank, step), (step digest, step flash, "
                         f"provenance, sync): {launches}, want {want}")
    return {"chunk_digest": sum(d + p + y for d, _, p, y in launches.values()),
            "flash_attention": sum(f for _, f, _, _ in launches.values())}


def phase_cluster_proxy(card: str) -> dict:
    """Proxied ranks (``[cluster:proxy]``: local proxies; ``[cluster:remote]``:
    sessions on proxy-host daemons, one SIGKILLed), held against one
    inline run of their program in this process."""
    from repro_torch.checkpoint import ChunkStore
    from repro_torch.checkpoint.manifest import committed_steps
    from repro_torch.coord import run_cluster
    from repro_torch.core import RestoreManager
    from repro_torch.obs.journal import read_journal
    from repro_torch.proxy import make_program
    from repro_torch.utils.tree import tree_digest, tree_equal

    cuda = torch.device("cuda", torch.cuda.current_device())
    on_card = lambda p, s: cuda if p.startswith("device/") else None  # noqa: E731

    # [cluster:proxy]: each rank hosts a local proxy that owns the card
    tag = "[cluster:proxy]"
    with _clock("cluster:proxy"), tempfile.TemporaryDirectory(prefix="chip-smoke-cproxy-") as tmp:
        root = os.path.join(tmp, "ckpt")
        t0 = time.perf_counter()
        prox = run_cluster(
            root=root, n_hosts=2, total_steps=4, ckpt_every=2, backend="fork",
            codec="none", chunk_bytes=CLUSTER_CHUNK, program=CLUSTER_PROXY_SPEC,
            device="cuda", device_runner="proxy",
            deadline_s=600.0, round_timeout_s=300.0)
        pwall = time.perf_counter() - t0
        _cluster_rounds(tag, card, prox)
        pprog = make_program(CLUSTER_PROXY_SPEC)
        pstate = pprog.on_restore(pprog.init_state())
        pby_step = dict(zip([r.step for r in prox.committed], prox.acks))
        poracle, ptables = {}, {}
        for step in range(1, 5):
            pstate, _ = pprog.step(pstate, step)
            if step % 2 == 0:
                ptables[step] = _host_chunk_table(pstate, CLUSTER_CHUNK)
                acked = pby_step[step][0].get("chunk_digests")
                poracle[step] = acked == ptables[step]
        pdigest = tree_digest(pstate)
        image, _ = RestoreManager(ChunkStore(root)).restore(step=4, device_for=on_card)
        psame = {"final_digests": set(prox.final_digests.values()) == {pdigest},
                 "image": tree_equal(image["device"], pstate)}
        psteps = committed_steps(root)
        print(f"{tag} {card} cluster wall_s={pwall:.1f} state_bytes={pprog.state_nbytes()} "
              f"committed={psteps} lockstep={prox.lockstep()} bitwise={psame} "
              f"provenance vs chunk_digest_np {poracle}", flush=True)
        del image
        torch.cuda.empty_cache()
    if not prox.lockstep() or psteps != [2, 4] or \
            [r.step for r in prox.committed] != [2, 4] or not all(psame.values()):
        raise SystemExit(f"proxied cluster: lockstep {prox.lockstep()} images {psteps} "
                         f"bitwise {psame}")
    if sorted(poracle) != [2, 4] or not all(poracle.values()):
        raise SystemExit(f"a proxied round's chunk digests disagree with chunk_digest_np: "
                         f"{poracle}")
    # each proxy: one fused digest launch per step of the 2-step window, no
    # flash; the rank itself (a host mirror) launches nothing
    plaunches = {(h, r.step): (a["step_launches"]["chunk_digest"],
                               a["step_launches"]["flash_attention"],
                               a["provenance_launches"], a["sync_launches"])
                 for r, acks in zip(prox.committed, prox.acks) for h, a in acks.items()}
    if plaunches != {k: (2, 0, 0, 0) for k in plaunches} or len(plaunches) != 4:
        raise SystemExit(f"proxied kernel launches per (rank, step), (step digest, step "
                         f"flash, provenance, sync): {plaunches}")

    # [cluster:remote]: the same run with each rank's proxy a session on one
    # of two proxy-host daemons on the card (stream transport); after the
    # first commit the injection engine journals and fires a clock skew on
    # rank 1, a SIGKILL of daemon ph0 and a torn frame at the coordinator,
    # and the soak verdict judges the run; held against [cluster:proxy]'s
    # inline run
    from repro_torch.chaos.faults import CHAOS_ENV
    from repro_torch.chaos.schedule import PlannedInjection
    from repro_torch.chaos.soak import chaos_hook
    from repro_torch.obs import trace as obs_trace
    from repro_torch.obs.journal import InjectLine
    from repro_torch.obs.soak import verdict
    from repro_torch.obs.watch import WatchConfig

    tag = "[cluster:remote]"
    with _clock("cluster:remote"), \
            tempfile.TemporaryDirectory(prefix="chip-smoke-cremote-") as tmp:
        root = os.path.join(tmp, "ckpt")
        # the ranks inherit the sentinel dir the heartbeat's skew shim reads
        os.environ[CHAOS_ENV] = os.path.join(tmp, "chaos")
        t0 = time.perf_counter()
        try:
            rem = run_cluster(
                root=root, n_hosts=2, total_steps=4, ckpt_every=2, backend="fork",
                codec="none", chunk_bytes=CLUSTER_CHUNK, program=CLUSTER_PROXY_SPEC,
                device="cuda", device_runner="proxy", proxy_hosts=2,
                deadline_s=600.0, round_timeout_s=300.0,
                obs_dir=os.path.join(tmp, "obs"),
                watch_cfg=WatchConfig(max_clock_skew_s=CHAOS_MAX_SKEW_S),
                chaos=chaos_hook(tmp, [PlannedInjection(0.0, kind, params)
                                       for kind, params in CHAOS_PLAN],
                                 chaos_dir=os.environ[CHAOS_ENV], after_commits=1))
        finally:
            del os.environ[CHAOS_ENV]
            obs_trace.disable()  # the run's tracing ends with its run dir
        rwall = time.perf_counter() - t0
        _cluster_rounds(tag, card, rem)
        image, _ = RestoreManager(ChunkStore(root)).restore(step=4, device_for=on_card)
        rsame = {"final_digests": set(rem.final_digests.values()) == {pdigest},
                 "image": tree_equal(image["device"], pstate)}
        del image
        rsteps = committed_steps(root)
        log = read_journal(rem.log_path)
        # the verdict reads convergence from the driver's summary
        with open(os.path.join(tmp, "soak_run.json"), "w") as f:
            json.dump({"lockstep": rem.lockstep(),
                       "latest_committed": rem.latest_committed}, f)
        t_verdict = time.perf_counter()
        card_verdict = verdict(tmp, round_envelope_s=CHAOS_ROUND_ENVELOPE_S)
        verdict_s = time.perf_counter() - t_verdict
        injected = [r for r in read_journal(os.path.join(tmp, "INJECT_LOG.jsonl"))
                    if isinstance(r, InjectLine)]
    del pstate
    torch.cuda.empty_cache()
    placed: dict[int, list[str]] = {}
    for h, name in rem.proxy_placements:
        placed.setdefault(h, []).append(name)
    moved = sorted(h for h, names in placed.items() if len(set(names)) > 1)
    reported = [e for e in log if e.event == "proxy_host_death"]
    alert_i = next((i for i, e in enumerate(log)
                    if e.event == "alert" and e.kind == "proxy_host_death"), None)
    after = [] if alert_i is None else [
        e.step for e in log[alert_i:] if e.event == "round" and e.status == "committed"]
    # daemon death (first reported by a rank) to the first SYNCED of a
    # moved rank's proxy on the survivor (its ack's wall clock)
    first_commit_t = min(e.t for e in log if e.event == "round" and e.committed)
    killed = [i.params["name"] for i in injected if i.kind == "kill_proxy_host"]
    death_t = min(e.t for e in reported) if reported else None
    synced = [a["synced_wt"] for acks in rem.acks for h, a in acks.items()
              if h in moved and death_t is not None and a["synced_wt"] > death_t]
    reschedule_s = min(synced) - death_t if synced else None
    rby_step = dict(zip([r.step for r in rem.committed], rem.acks))
    roracle = {step: all(a.get("chunk_digests") == ptables[step] for a in acks.values())
               for step, acks in rby_step.items()}
    rlaunches = {(h, r.step): (a["step_launches"]["chunk_digest"],
                               a["step_launches"]["flash_attention"],
                               a["provenance_launches"], a["sync_launches"])
                 for r, acks in zip(rem.committed, rem.acks) for h, a in acks.items()}
    restarts = {(h, r.step): a["proxy_restarts"]
                for r, acks in zip(rem.committed, rem.acks) for h, a in acks.items()}
    print(f"{tag} {card} cluster wall_s={rwall:.1f} committed={rsteps} "
          f"killed={killed} placements={rem.proxy_placements} moved={moved} "
          f"proxy_restarts per (rank, step)={restarts} death_reported_by="
          f"{[(e.worker, e.name) for e in reported]} reschedule_s="
          f"{'-' if reschedule_s is None else f'{reschedule_s:.2f}'} (death reported "
          f"-> first SYNCED on the survivor) alerts={sorted(rem.alert_kinds())} "
          f"committed_after_alert={after} lockstep={rem.lockstep()} bitwise={rsame} "
          f"provenance vs chunk_digest_np {roracle}", flush=True)
    checks = card_verdict["checks"]
    print(f"[chaos] {card} verdict={'pass' if card_verdict['pass'] else 'FAIL'} "
          + " ".join(f"{k}={v}" for k, v in checks.items())
          + f" injections={[(i.seq, i.kind, i.target) for i in injected]} journaled_s_after_"
          f"first_commit_line={[round(i.t - first_commit_t, 3) for i in injected]} "
          f"evidence={[(r['kind'], r['evidenced'], sum(map(len, r['matched'].values()))) for r in card_verdict['injections']]} "
          f"alerts={[(a['kind'], a['host'], a['explained_by']) for a in card_verdict['alerts']]} "
          f"round_envelope_s={CHAOS_ROUND_ENVELOPE_S} rounds_s="
          f"{[(r.step, round(r.round_s, 2)) for r in rem.committed]} "
          f"leak_growth={card_verdict['leak_growth']} critpath_problems="
          f"{card_verdict['critpath_problems']} verdict_s={verdict_s:.1f}", flush=True)
    if not card_verdict["pass"] or len(checks) != 6 or not all(checks.values()):
        raise SystemExit(f"the chaos-driven remote cluster failed its soak verdict: {checks}")
    if [i.kind for i in injected] != [kind for kind, _ in CHAOS_PLAN] or \
            card_verdict["n_injections"] != len(CHAOS_PLAN):
        raise SystemExit(f"injections journaled {[(i.kind, i.t) for i in injected]}: not "
                         f"the plan's {[kind for kind, _ in CHAOS_PLAN]}")
    if killed != ["ph0"] or not moved:
        raise SystemExit(f"remote cluster: killed {killed}, placements "
                         f"{rem.proxy_placements}: no rank moved to the survivor")
    if "proxy_host_death" not in rem.alert_kinds() or not after:
        raise SystemExit(f"remote cluster: alerts {rem.alert_kinds()}, rounds committed "
                         f"after the proxy_host_death alert: {after}")
    if not rem.lockstep() or rsteps != [2, 4] or not all(rsame.values()):
        raise SystemExit(f"remote cluster: lockstep {rem.lockstep()} images {rsteps} "
                         f"bitwise {rsame}")
    if sorted(roracle) != [2, 4] or not all(roracle.values()):
        raise SystemExit(f"a remote round's chunk digests disagree with chunk_digest_np: "
                         f"{roracle}")
    # one fused digest launch per proxied step in every ack, counted per
    # session: exact though ph1 hosts both ranks' sessions after the kill
    if rlaunches != {k: (2, 0, 0, 0) for k in rlaunches} or len(rlaunches) != 4:
        raise SystemExit(f"remote kernel launches per (rank, step), (step digest, step "
                         f"flash, provenance, sync): {rlaunches}")
    if reschedule_s is None:
        raise SystemExit("no moved rank's SYNCED came after the proxy-host death")
    return {"launches_proxy": {
        "chunk_digest": sum(d for d, _, _, _ in plaunches.values()),
        "flash_attention": sum(f for _, f, _, _ in plaunches.values())},
        "launches_remote": {
        "chunk_digest": sum(d for d, _, _, _ in rlaunches.values()),
        "flash_attention": sum(f for _, f, _, _ in rlaunches.values())}}


# [mesh]: moonshot-v1-16b-a3b at full width, 1 of its 48 layers, sharded
# over 4 ranks on the one card (gloo: NCCL refuses two ranks on a device)
MESH_SHAPE, MESH_AXES, MESH_STEPS = (2, 2), ("data", "model"), 4
MESH_ATTN = (2, 16, 8192, 128)  # moonshot's heads at 8,192 positions, bf16
MESH_TIMEOUT_S = 240.0
# step 5's loss at world size 1 against (data=4,)'s: within this many times
# the bf16 loss's distance from its f32 upcast's on the same batch
MESH_LOSS_HEADROOM = 2.0


def _mesh_attention(rules) -> dict:
    """The attention of one moonshot layer as the sharded step runs it on
    this rank (``models.transformer.attend`` under the rank's config from
    ``runtime.steps.split_config``: its 8 of 16 heads, its batch row),
    forward and backward at 8,192 positions, where the flash kernels run,
    held bitwise per head to the same function on the whole tensors in
    this process (heads are independent, and with kv heads = heads the
    backward's group sum is one head)."""
    from repro_torch.launch import mesh as _mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.steps import split_config

    cfg, mesh = rules.cfg, rules.mesh
    rank_cfg, heads, _mlp = split_config(cfg, rules)
    B, H, S, D = MESH_ATTN
    if not heads or (rank_cfg.num_heads, cfg.num_heads, cfg.head_dim) != (H // 2, H, D):
        raise SystemExit(f"[mesh] the step does not split moonshot's {cfg.num_heads} heads "
                         f"over model: {rank_cfg.num_heads} a rank")
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, do = (torch.randn(MESH_ATTN, generator=gen, device="cuda", dtype=torch.bfloat16)
                   for _ in range(4))
    pos = torch.arange(S, device="cuda")
    whole = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out, _k = tfm.attend(cfg, *whole, pos)
    out.backward(do)
    rows = slice(_mesh.coordinate(mesh, "data"), _mesh.coordinate(mesh, "data") + 1)
    m = _mesh.coordinate(mesh, "model")
    mine = slice(m * rank_cfg.num_heads, (m + 1) * rank_cfg.num_heads)
    part = [t[rows, mine].clone().requires_grad_(True) for t in (q, k, v)]
    torch.cuda.synchronize()
    _zero_counts()
    got, _k = tfm.attend(rank_cfg, *part, pos)
    got.backward(do[rows, mine])
    torch.cuda.synchronize()
    c = _counts()
    pairs = [(got.detach(), out.detach()[rows, mine])] + [
        (p.grad, w.grad[rows, mine]) for p, w in zip(part, whole)]
    bitwise = [all(torch.equal(a[:, h], b[:, h]) for a, b in pairs)
               for h in range(rank_cfg.num_heads)]
    return {"heads": [mine.start, mine.stop], "rows": [rows.start, rows.stop],
            "bitwise_heads": sum(bitwise), "local_heads": len(bitwise),
            "fwd": c["flash_attention"], "bwd": c["flash_attention_bwd"]}


def _window_digests(ts: list[torch.Tensor]) -> list[list[int]]:
    """Each tensor's 1 MiB chunk digests, on its device (one grouped
    launch on the card), outside any counted window."""
    from repro_torch.kernels.ops import host_chunk_digests

    return host_chunk_digests([t.detach().contiguous() for t in ts], 1 << 20)


def mesh_rank(cfg: dict) -> int:
    """One rank of ``[mesh]`` (``chip_smoke.py --mesh-rank``): the attention
    check, then the train CLI on the (2, 2) mesh, then the step-4 image
    restored onto (data=4,) over the same 4 ranks and step 5's loss there
    (the sharded step's forward at one microbatch). Writes what it saw to ``cfg["out"]/rank<r>.json``."""
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import ChunkStore
    from repro_torch.checkpoint.manifest import load_hostmeta
    from repro_torch.checkpoint.sharded import local_window, owns_replica
    from repro_torch.configs import get_config
    from repro_torch.core import RestoreManager
    from repro_torch.data import SyntheticBatches
    from repro_torch.launch import mesh as _mesh
    from repro_torch.launch import train
    from torch.distributed.tensor import Replicate

    from repro_torch.models import build, moe
    from repro_torch.runtime.sharding import ShardingRules
    from repro_torch.runtime.steps import batch_to_device, local_batch, relayout
    from repro_torch.utils.tree import flatten_with_paths, unflatten_from_paths

    _mesh.init_distributed("gloo")
    rank = dist.get_rank()
    mesh = _mesh.make_mesh(MESH_SHAPE, MESH_AXES, device_type="cuda")
    mcfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_LAYERS)
    out: dict = {"rank": rank, "attention": _mesh_attention(ShardingRules(mcfg, mesh))}

    steps, syncs, commits, live4 = [], [], [], {}
    make, cli_config, host_mesh = train.make_train_step, train.get_config, _mesh.make_host_mesh
    base = train.CheckpointedTrainer

    def counting_make(model, optimizer, **kw):
        fn = make(model, optimizer, **kw)

        def step(state, batch):
            torch.cuda.synchronize()
            a0, t0, c0 = moe.all_to_all_calls, time.perf_counter(), _mesh.collective_s
            b0 = _mesh.buffer_s
            res = fn(state, batch)
            torch.cuda.synchronize()
            steps.append({"ms": (time.perf_counter() - t0) * 1e3,
                          "collective_ms": (_mesh.collective_s - c0) * 1e3,
                          "buffer_ms": (_mesh.buffer_s - b0) * 1e3,
                          "loss": float(res[1]["loss"]),
                          "all_to_all": moe.all_to_all_calls - a0})
            return res

        return step

    class CountingTrainer(base):
        def checkpoint_now(self, step, state):
            if self.results:
                # the last image commits as its persists land, with no
                # later checkpoint: wait for that here, outside the
                # trainer (and its blocking time), so that this sync takes
                # that image's buffer again (a delta sync: one digest launch)
                prev, t0 = self.results[-1], time.perf_counter()
                prev.done.wait()
                t1 = time.perf_counter()
                while prev.step not in self.committer.committed \
                        and time.perf_counter() - t1 < 60:
                    time.sleep(0.005)
                commits.append({"step": prev.step, "persist_wait_s": t1 - t0,
                                "commit_after_persist_s": time.perf_counter() - t1,
                                "committed": prev.step in self.committer.committed})
            c0 = _counts()["chunk_digest"]
            r = super().checkpoint_now(step, state)
            syncs.append({"step": step, "digest_launches": _counts()["chunk_digest"] - c0,
                          "blocking_s": r.blocking_s})
            if step == 4:
                owned = {p: leaf for p, leaf in flatten_with_paths(state["device"])[0].items()
                         if isinstance(leaf, DTensor)
                         and owns_replica(leaf.device_mesh, leaf.placements)}
                digests = _window_digests([leaf.to_local() for leaf in owned.values()])
                for (path, leaf), d in zip(owned.items(), digests):
                    a, b = local_window(tuple(leaf.shape), leaf.device_mesh, leaf.placements)
                    live4["device/" + path] = [a, b, d]
            return r

    argv = ["--arch", MOE_ARCH, "--steps", str(MESH_STEPS), "--batch", str(BATCH),
            "--seq", str(SEQ), "--lr", str(LR), "--ckpt-every", "2", "--backend", "fork",
            "--codec", "none", "--log-every", "1", "--dist-backend", "gloo",
            "--ckpt-dir", cfg["store"]]
    train.make_train_step, train.CheckpointedTrainer = counting_make, CountingTrainer
    train.get_config = lambda name, smoke=False: mcfg
    _mesh.make_host_mesh = lambda *a, **k: mesh
    try:
        t0 = time.perf_counter()
        res = train.train(argv)
        out["train_s"] = time.perf_counter() - t0
    finally:
        train.make_train_step, train.CheckpointedTrainer = make, base
        train.get_config, _mesh.make_host_mesh = cli_config, host_mesh
    del res
    gc.collect()
    torch.cuda.empty_cache()
    hm = load_hostmeta(cfg["store"], 4, rank)
    written = {p: sorted([list(s.start), list(s.stop)] for s in lv.shards)
               for p, lv in hm.leaves.items() if lv.shards}
    owned = {p: [[a, b]] for p, (a, b, _d) in live4.items()}
    # rank 0 also writes the leaves that are not DTensors: the step and the host's
    others = {p for p in hm.leaves if p == "device/step" or p.startswith("host/")}
    out.update(steps=steps, syncs=syncs, commits=commits, live4=live4,
               staged_bytes=_mesh.staged_bytes,
               collective_s=_mesh.collective_s,
               persisted_only_owned=written == dict(
                   owned, **({p: written.get(p) for p in others} if rank == 0 else {})))

    # the step-4 image onto (data=4,) over the same ranks, step 5's loss there
    t0 = time.perf_counter()
    mesh4 = _mesh.make_mesh((4,), ("data",), device_type="cuda")
    run4 = train.build_training(mcfg, batch=BATCH, seq=SEQ, lr=LR, total_steps=MESH_STEPS,
                                device=torch.device("cuda", torch.cuda.current_device()),
                                rules=ShardingRules(mcfg, mesh4))
    state, _m = RestoreManager(ChunkStore(cfg["store"])).restore(step=4,
                                                                 device_for=run4.device_for)
    blocks = {p: leaf for p, leaf in flatten_with_paths(state["device"])[0].items()
              if isinstance(leaf, DTensor)}
    restored4 = {}
    for (path, leaf), d in zip(blocks.items(),
                               _window_digests([b.to_local() for b in blocks.values()])):
        a, b = local_window(tuple(leaf.shape), mesh4, leaf.placements)
        restored4["device/" + path] = [a, b, d]
    out["restore4_read_s"] = time.perf_counter() - t0
    data = SyntheticBatches.from_state(mcfg, batch=BATCH, seq_len=SEQ,
                                       state=state["host"]["data"])
    # step 5's loss, as the sharded step computes it before its update: the
    # params gathered, each rank's rows, the mean over the ranks (no
    # backward: the check is the loss)
    t4, c4 = time.perf_counter(), _mesh.collective_s
    flat, treedef = flatten_with_paths(state["device"]["params"])
    params = unflatten_from_paths(treedef, {
        p: relayout(t.to_local(), mesh4, t.placements, (Replicate(),)) for p, t in flat.items()})
    rows = local_batch(batch_to_device(next(data), "cuda"), ShardingRules(mcfg, mesh4))
    with torch.no_grad(), _mesh.use_mesh(mesh4):
        loss = build(mcfg).loss(params, rows)[0]  # with the MoE aux, as a step's
    loss4 = float(_mesh.all_reduce(loss, mesh4, "data")) / 4
    del params
    out.update(restored4=restored4, step5_data4=loss4,
               step5_data4_ms=(time.perf_counter() - t4) * 1e3,
               step5_data4_collective_ms=(_mesh.collective_s - c4) * 1e3,
               restore4_s=time.perf_counter() - t0)
    with open(os.path.join(cfg["out"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_mesh(card: str) -> dict:
    """The sharding layer on the card (``[mesh]``): 4 ranks on the one H100
    over gloo with CUDA tensors (every collective staged through the host
    by ``launch.mesh.host_staged``, its bytes and seconds counted), mesh
    (data=2, model=2), moonshot-v1-16b-a3b at full width cut to 1 of 48
    layers.

    Each rank: one moonshot layer's attention (16 heads x 128, 8,192
    positions, bf16) forward and backward as the sharded step runs it on
    the rank's heads (``_mesh_attention``): its flash kernels run on 8
    heads of 1 batch row, bitwise per head equal to the same function on
    the whole tensors; then the train CLI (batch 4, seq 512, 2
    microbatches, remat dots, 4 steps, fork checkpoints at 2 and 4; the
    layer weights gathered one layer at a time): the expert-parallel MoE's
    all-to-alls every step, the step-2 image committed once its persists
    landed with no later checkpoint (the script waits for that before step
    4's, outside the trainer), each rank's digest launches per sync ([0,
    1]: a buffer's first sync defers its digests to the persist, and step
    4's takes step 2's buffer again), and each rank's step-4 hostmeta
    holding its owned blocks and nothing else; then
    the step-4 image restored onto (data=4,) over the same ranks and step
    5's loss there (the sharded step's forward, one microbatch: 4 rows do
    not split into 2 over 4 ranks).
    Here: the step-4 image restored at world size 1 bitwise equal to the
    run's state (every rank's owned windows, and the (data=4,) windows, by
    their chunk digests), and one step from it at one microbatch, whose
    loss must lie within the bf16 tolerance of the (data=4,) loss (the
    same MoE formulation: without a model axis both route groups of the
    whole batch); the tolerance is ``MESH_LOSS_HEADROOM`` times the bf16
    loss's distance from its f32 upcast's there (the loss with the MoE aux,
    as a step reports it)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import RestoreManager
    from repro_torch.checkpoint import ChunkStore
    from repro_torch.data import SyntheticBatches
    from repro_torch.launch import mesh as _mesh
    from repro_torch.launch.train import build_training
    from repro_torch.models import build
    from repro_torch.optim import get_optimizer
    from repro_torch.runtime.steps import batch_to_device, make_train_step
    from repro_torch.utils.tree import flatten_with_paths

    mcfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_LAYERS)
    cuda = torch.device("cuda", torch.cuda.current_device())
    free, _total = torch.cuda.mem_get_info()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-mesh-") as tmp:
        store = os.path.join(tmp, "ckpt")
        arg = json.dumps({"store": store, "out": tmp})
        t0 = time.perf_counter()
        procs = _mesh.launch([sys.executable, str(Path(__file__).resolve()), "--mesh-rank", arg],
                             4, timeout=MESH_TIMEOUT_S, capture=True)
        ranks_s = time.perf_counter() - t0
        for p in procs[:1]:
            sys.stdout.write("".join(f"[mesh:rank0] {ln}\n" for ln in p.stdout.splitlines()
                                     if ln.startswith("[")))
        bad = [(r, p.returncode, (p.stderr or "")[-3000:]) for r, p in enumerate(procs)
               if p.returncode != 0]
        if bad:
            raise SystemExit(f"[mesh] ranks failed (rank, code, stderr tail): {bad}")
        ranks = [json.load(open(os.path.join(tmp, f"rank{r}.json"))) for r in range(4)]
        for r in ranks:
            a = r["attention"]
            print(f"[mesh] rank={r['rank']} attention rows={a['rows']} heads={a['heads']} "
                  f"bitwise_heads={a['bitwise_heads']}/{a['local_heads']} fwd={a['fwd']} "
                  f"bwd={a['bwd']} train_s={r['train_s']:.1f} restore4_s={r['restore4_s']:.1f} "
                  f"restore4_read_s={r['restore4_read_s']:.1f} "
                  f"data4_loss_ms={r['step5_data4_ms']:.1f} "
                  f"data4_collective_ms={r['step5_data4_collective_ms']:.1f} "
                  f"staged_bytes={r['staged_bytes']} collective_s={r['collective_s']:.1f} "
                  f"digest_launches={[x['digest_launches'] for x in r['syncs']]} "
                  f"blocking_ms={[round(x['blocking_s'] * 1e3, 1) for x in r['syncs']]} "
                  f"persist_wait_s={[round(x['persist_wait_s'], 2) for x in r['commits']]} "
                  f"commit_after_persist_ms="
                  f"{[round(x['commit_after_persist_s'] * 1e3, 1) for x in r['commits']]} "
                  f"persisted_only_owned={r['persisted_only_owned']}", flush=True)
        for i, s in enumerate(ranks[0]["steps"]):
            print(f"[mesh] step={i + 1} ms={[round(r['steps'][i]['ms'], 1) for r in ranks]} "
                  f"collective_ms={[round(r['steps'][i]['collective_ms'], 1) for r in ranks]} "
                  f"buffer_ms={[round(r['steps'][i]['buffer_ms'], 1) for r in ranks]} "
                  f"loss={s['loss']:.6f} all_to_all={[r['steps'][i]['all_to_all'] for r in ranks]}",
                  flush=True)
        for r in ranks:
            a = r["attention"]
            if a["bitwise_heads"] != a["local_heads"] or a["local_heads"] != 8 \
                    or (a["fwd"], a["bwd"]) != (1, 1):
                raise SystemExit(f"[mesh] rank {r['rank']} attention not bitwise per head "
                                 f"on 8 heads with one forward and one backward: {a}")
            if [x["digest_launches"] for x in r["syncs"]] != [0, 1]:
                raise SystemExit(f"[mesh] rank {r['rank']} digest launches per sync "
                                 f"{r['syncs']}, want [0, 1]")
            if [(x["step"], x["committed"]) for x in r["commits"]] != [(2, True)]:
                raise SystemExit(f"[mesh] rank {r['rank']}: the step-2 image did not commit "
                                 f"once its persists landed: {r['commits']}")
            if not r["persisted_only_owned"]:
                raise SystemExit(f"[mesh] rank {r['rank']} persisted other than its owned blocks")
            if len(r["steps"]) != MESH_STEPS or any(s["all_to_all"] <= 0 for s in r["steps"]):
                raise SystemExit(f"[mesh] rank {r['rank']} steps without the expert-parallel "
                                 f"all-to-all: {r['steps']}")

        # the step-4 image at world size 1
        t1 = time.perf_counter()
        run = build_training(mcfg, batch=BATCH, seq=SEQ, lr=LR, total_steps=MESH_STEPS,
                             device=cuda)
        state, _m = RestoreManager(ChunkStore(store)).restore(step=4, device_for=run.device_for)
        flat = flatten_with_paths(state)[0]
        restore1_s = time.perf_counter() - t1
        windows = mismatched = 0
        for r in ranks:
            for key in ("live4", "restored4"):
                wins = r[key]
                got = _window_digests([flat[p][tuple(slice(x, y) for x, y in zip(a, b))]
                                       for p, (a, b, _d) in wins.items()])
                windows += len(wins)
                mismatched += sum(g != w[2] for g, w in zip(got, wins.values()))
        covered = sum(math.prod(y - x for x, y in zip(a, b))
                      for r in ranks for a, b, _d in r["live4"].values())
        whole = sum(t.numel() for p, t in flat.items()
                    if p.startswith("device/") and p != "device/step")
        data = SyntheticBatches.from_state(mcfg, batch=BATCH, seq_len=SEQ,
                                           state=state["host"]["data"])
        batch = batch_to_device(next(data), cuda)
        with torch.no_grad():
            loss32 = float(build(_f32_config(mcfg)).loss(_f32(state["device"]["params"]),
                                                       batch)[0])
        step1 = make_train_step(build(mcfg), get_optimizer(mcfg.optimizer, LR), microbatches=1)
        _dev, metrics = step1(state["device"], batch)
        loss1 = float(metrics["loss"])
        world1_s = time.perf_counter() - t1
    loss4 = ranks[0]["step5_data4"]
    tol = MESH_LOSS_HEADROOM * abs(loss32 - loss1)
    print(f"[mesh] {card} ranks_s={ranks_s:.1f} world1_s={world1_s:.1f} "
          f"restore1_s={restore1_s:.1f} "
          f"free_gb_before={free / 1e9:.1f} windows={windows} mismatched={mismatched} "
          f"covered={covered} state_elems={whole} step5 world1={loss1:.6f} "
          f"data4={loss4:.6f} f32={loss32:.6f} tol={tol:.6f}", flush=True)
    if mismatched or covered != whole:
        raise SystemExit(f"[mesh] the world-1 restore differs from the sharded state in "
                         f"{mismatched} of {windows} windows (owned blocks cover {covered} "
                         f"of {whole} elements)")
    if abs(loss1 - loss4) > tol:
        raise SystemExit(f"[mesh] step 5 from the world-1 restore {loss1} vs (data=4,) "
                         f"{loss4}: beyond {tol}")
    return {"launches": {
        "chunk_digest": [sum(x["digest_launches"] for x in r["syncs"]) for r in ranks],
        "flash_attention": [r["attention"]["fwd"] for r in ranks],
        "flash_attention_bwd": [r["attention"]["bwd"] for r in ranks]},
        "staged_bytes": [r["staged_bytes"] for r in ranks]}


def lane_child(cfg: dict) -> int:
    """``[proxy]``, the cluster phases, ``[hybrid]`` and ``[multimodal]``, in
    a process of their own that the script runs beside its
    ``[serve:proxy]``, ``[uvm]``, ``[moe]``, ``[multimodal:long]`` and
    ``[mesh]``: each path
    counts its launches where it runs (this process, its proxies, its
    ranks), none shares state with the other lane, and the card holds
    both. Writes each path's launches to ``cfg["out"]`` as JSON."""
    import signal

    # SIGTERM from the script unwinds this process, so that each phase's
    # ``finally`` stops the processes it started
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    card = cfg["card"]
    with _clock("proxy"):
        proxied = phase_proxy(card)
    with _clock("cluster"):
        clustered = {"launches": phase_cluster(card)}
        clustered.update(phase_cluster_proxy(card))
    gc.collect()
    torch.cuda.empty_cache()
    with _clock("hybrid"):
        hybrided = phase_hybrid(card)
    gc.collect()
    torch.cuda.empty_cache()
    with _clock("multimodal"):
        multimodal = phase_multimodal(card)
    print(f"[lane:2] {_usage_fields({}, _usage())}", flush=True)
    with open(cfg["out"], "w") as f:
        json.dump({"proxy": proxied["launches"], "cluster": clustered["launches"],
                   "cluster_proxy": clustered["launches_proxy"],
                   "cluster_remote": clustered["launches_remote"],
                   "hybrid": hybrided["launches"], "multimodal": multimodal["launches"]}, f)
    return 0


# the script's own limit on its run, inside the 1,200 s it is given: the
# lane's wait ends here
SCRIPT_BUDGET_S = 1150.0


def _lane_result(lane, log_path: str, out_path: str, t_script: float) -> dict:
    """Waits for the lane (until ``SCRIPT_BUDGET_S`` into the script),
    prints its standard output, and fails unless it ended with 0."""
    try:
        lane.wait(timeout=max(SCRIPT_BUDGET_S - (time.perf_counter() - t_script), 1.0))
    except subprocess.TimeoutExpired:
        pass
    with open(log_path) as f:
        sys.stdout.write(f.read())
    sys.stdout.flush()
    if lane.returncode is None:
        raise SystemExit(f"the [proxy]/[cluster]/[hybrid]/[multimodal] lane passed "
                         f"{SCRIPT_BUDGET_S:.0f} s "
                         f"into the script")
    if lane.returncode != 0:
        raise SystemExit(f"the [proxy]/[cluster]/[hybrid]/[multimodal] lane failed "
                         f"({lane.returncode})")
    with open(out_path) as f:
        return json.load(f)


def _stop_lane(lane) -> None:
    """Ends the lane and everything it started (its own process group):
    SIGTERM first, so that its phases stop their processes, then SIGKILL."""
    import signal

    if lane.poll() is None:
        lane.terminate()
        try:
            lane.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass
    with contextlib.suppress(ProcessLookupError):
        os.killpg(lane.pid, signal.SIGKILL)
    lane.wait()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--codec", default="none",
                    help="checkpoint codec of the main path (default: none)")
    ap.add_argument("--proxy-child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--serve-child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--lane", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-rank", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.proxy_child is not None:
        return proxy_child(json.loads(args.proxy_child))
    if args.serve_child is not None:
        return serve_child(json.loads(args.serve_child))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import repro_torch.kernels  # noqa: F401  (fails first outside a checkout)

    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.lane is not None:
        return lane_child(json.loads(args.lane))
    if args.mesh_rank is not None:
        return mesh_rank(json.loads(args.mesh_rank))
    t_script = time.perf_counter()
    with _clock("card"):
        card = phase_card()
    with _clock("sweep"):
        phase_sweep()
    with _clock("flash-sweep"):
        phase_flash_sweep()
    with _clock("flash-bwd-sweep"):
        phase_flash_bwd_sweep()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as tmp:
        store = os.path.join(tmp, "ckpt")
        with _clock("main"):
            final_state, launches = phase_main_path(store, args.codec)
        with _clock("restart"):
            device_state = phase_restart(store, final_state)
        del final_state
        with _clock("serve"):
            served = phase_serve(store)
        cut_store = os.path.join(tmp, "serve-cut")
        with _clock("serve:proxy image"):
            serve_params = _serve_image(store, cut_store)
        shutil.rmtree(store)  # 3 images of 4.94 GB; the cut image stays
        with _clock("timing"):
            rows = [phase_timing(device_state, launches)]
        unmanaged6 = _cpu_tree(device_state)  # the [uvm] phase's reference
        del device_state
        with _clock("timing flash"):
            rows.append(phase_flash_timing(served["launches"]))
        with _clock("train:long"):
            long_run = phase_train_long(card)
        with _clock("timing flash-bwd"):
            rows.append(phase_flash_bwd_timing(long_run["launches"]["flash_attention_bwd"]))
        for row in rows:  # each kernel's launches in the [train:long] CLI run
            row["launches_train_long"] = long_run["launches"][row["name"]]
        gc.collect()
        torch.cuda.empty_cache()  # the card's memory for both lanes
        # [proxy], the cluster phases, [hybrid] and [multimodal] run in a
        # second process of this script (its output printed when it ends),
        # [serve:proxy], [uvm], [moe], [multimodal:long] and [mesh] here:
        # the kernels' times above ran with the card to themselves
        lane_out, lane_log = os.path.join(tmp, "lane.json"), os.path.join(tmp, "lane.log")
        with open(lane_log, "w") as log:
            lane = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--lane",
                 json.dumps({"card": card, "out": lane_out})],
                stdout=log, start_new_session=True)
        try:
            with _clock("serve:proxy"):
                served_proxy = phase_serve_proxy(cut_store, serve_params, card)
            del serve_params
            with _clock("uvm"):
                uvm = phase_uvm(card, unmanaged6)
            del unmanaged6
            with _clock("moe"):
                moed = phase_moe(card)
            gc.collect()
            torch.cuda.empty_cache()
            with _clock("multimodal:long"):
                mm_long = phase_multimodal_long(card)
            gc.collect()
            torch.cuda.empty_cache()
            with _clock("mesh"):
                meshed = phase_mesh(card)
            print(f"[lane:1] {_usage_fields({}, _usage())}", flush=True)
            laned = _lane_result(lane, lane_log, lane_out, t_script)
        finally:
            _stop_lane(lane)
    # the proxy path's own count: the fused digest's launches in the proxy
    # processes, from their SYNCED frames (one per proxied step)
    rows[0]["launches_proxy"] = laned["proxy"]
    # each kernel's launches on the managed paths; a path counted in other
    # processes (proxies, ranks) reports the digest and the forward only, and
    # runs seq 512, below the attention kernels' threshold: null there
    for row in rows:
        row["launches_uvm_inline"] = uvm["launches_inline"][row["name"]]
        row["launches_uvm_proxy"] = uvm["launches_proxy"].get(row["name"])
    # the cluster paths' own counts: the ranks' (and their proxies')
    # launches, counted in their processes and sent in their acks
    for row in rows:
        row["launches_serve_proxy"] = served_proxy["launches"].get(row["name"])
        row["launches_cluster"] = laned["cluster"].get(row["name"])
        row["launches_cluster_proxy"] = laned["cluster_proxy"].get(row["name"])
        row["launches_cluster_remote"] = laned["cluster_remote"].get(row["name"])
        row["launches_moe"] = moed["launches"][row["name"]]
        row["launches_multimodal_long"] = mm_long["launches"][row["name"]]
        # per rank: the digest's over the run's syncs, the attention check's
        row["launches_mesh"] = meshed["launches"][row["name"]]
        row["launches_hybrid"] = laned["hybrid"][row["name"]]
        row["launches_multimodal"] = laned["multimodal"][row["name"]]
    print(f"[script] wall_s={time.perf_counter() - t_script:.1f}", flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
