"""The per-rank worker: train, barrier, persist own shards, obey commits.

One worker process is one CRUM rank (plus, with ``device_runner="proxy"``,
its device proxy). It holds the full replicated training state
(data-parallel lockstep: every rank computes the same deterministic
updates) but **persists only its assigned global index range** of each
leaf, wrapped in :class:`~repro_torch.core.shadow.HostShardView`. On the
inline loop the windows are views of the card tensors, so the rank's
shadow sync digests them on the card in the same grouped ``chunk_digest``
launch as every other leaf and fetches only their changed chunks. The
local ForkedCheckpointer runs in *external-commit* mode: either persist
backend (thread pool or copy-on-write fork child) writes ``data-h*.bin`` +
``hostmeta-h*.msgpack``, and the *coordinator* — never the worker — writes
MANIFEST + COMMIT.

Failure injection (for drills and tests), as in the reference:

  kill_at_step            exit hard at that train step (after READY when
                          the step is a checkpoint boundary, so the death
                          lands mid-round and aborts it)
  die_after_persist_step  the crash-mid-commit drill: hostmeta is on disk,
                          PERSIST_DONE never sent
  straggle_s[/at_step]    sleep before acking (slow storage)
  stall_at_step/stall_s   stop heartbeating and freeze (hung rank)
  corrupt_at_step         divergence drill: flip one byte of the device
                          state after that step, so the watchdog's
                          digest_divergence rule fires at the next
                          boundary and its alert names the forked chunk
"""
from __future__ import annotations

import os
import socket
import threading
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint.codecs import DEFAULT_CODEC
from repro_torch.checkpoint.store import ChunkStore
from repro_torch.coord.protocol import (
    MSG_ABORT,
    MSG_COMMIT,
    MSG_DRAIN,
    MSG_FINISHED,
    MSG_HEARTBEAT,
    MSG_JOIN,
    MSG_PERSIST_DONE,
    MSG_PERSIST_FAIL,
    MSG_READY,
    MSG_SHUTDOWN,
    MSG_WELCOME,
    Connection,
    connect,
)
from repro_torch.core.forked import ForkedCheckpointer
from repro_torch.core.restore import RestoreManager
from repro_torch.core.shadow import HostShardView
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.live import HeartbeatPiggyback
from repro_torch.utils.dtypes import byte_view
from repro_torch.utils.tree import flatten_with_paths, tree_digest, unflatten_from_paths

EXIT_KILLED = 9          # kill_at_step drill
EXIT_MID_COMMIT = 23     # die_after_persist_step drill
EXIT_WATCHDOG = 3        # local persist hung past persist_timeout_s


@dataclass
class WorkerConfig:
    host: int
    n_hosts: int
    coord_host: str
    coord_port: int
    root: str
    total_steps: int
    ckpt_every: int
    backend: str = "thread"
    codec: str = DEFAULT_CODEC
    chunk_bytes: int = 1 << 16
    incremental: bool = True
    # "numpy" (fast, tests) | "torch" (torch_tiny) | "arch:<name>" (a
    # repro_torch.configs architecture, smoke-sized)
    loop: str = "numpy"
    device_runner: str = "inline"  # "inline" | "proxy" (per-rank proxy process)
    proxy_transport: str = "segment"   # "segment" (shared) | "stream" (remote)
    proxy_placement: str = "local"     # "local" spawn | "coord" (PROXY_ENDPOINT)
    width: int = 64                # numpy state width / torch_tiny d_model
    rows: int | None = None        # numpy state rows; None = n_hosts-derived
    #                                (pin it for elastic restarts: the state
    #                                shape must not change with rank count)
    step_time_s: float = 0.0       # simulated compute per train step
    # the card the torch programs compute on ("cuda" by default; the tests
    # pass "cpu"). A rank whose inline loop asks for the card and finds
    # none raises; a proxied rank leaves the card to its proxy.
    device: str = "cuda"
    # an explicit step-program spec that overrides the loop's default one
    # (chip_smoke.py trains qwen2-0.5b at full width through it; the CLI
    # does not expose it). Torch programs get ``device`` unless it names one.
    program: dict | None = None
    # proxy UVM budget: bytes ("1048576") or a percentage of the program
    # state ("50%" = oversubscription x2); None = unmanaged
    device_capacity: str | None = None
    heartbeat_s: float = 0.5
    sock_timeout_s: float = 1.0
    deadline_s: float = 600.0
    persist_timeout_s: float = 120.0
    seed: int = 0
    restored: bool = False         # this incarnation is a supervisor respawn
    kill_at_step: int | None = None
    die_after_persist_step: int | None = None
    straggle_s: float = 0.0
    straggle_at_step: int | None = None
    stall_at_step: int | None = None
    stall_s: float = 0.0
    corrupt_at_step: int | None = None  # divergence drill (inline loop)
    # attach per-chunk digests of the full replicated state to PERSIST_DONE
    # so a digest_divergence alert can name the first forked chunk. Free in
    # proxy mode (the fused table rides SYNC info); the inline loop digests
    # the replica in one grouped kernel launch per boundary.
    chunk_provenance: bool = True


# -- shard ownership -----------------------------------------------------------

def shard_tree_for_host(state: Any, host: int, n_hosts: int) -> Any:
    """Wrap every leaf in the HostShardView this rank persists.

    Ownership is :func:`repro_torch.checkpoint.sharded.host_slice_plan` —
    ONE definition shared with ``RestoreManager.restore_elastic`` (and with
    the reference), so a committed image's shards re-slice bit-identically
    onto any other rank count. A tensor's window is a view of the tensor
    (on its device; a dim-0 window of a contiguous leaf is contiguous), a
    host value's a numpy slice.
    """
    from repro_torch.checkpoint.sharded import host_slice_plan

    flat, treedef = flatten_with_paths(state)
    out = {}
    for path, leaf in flat.items():
        if not isinstance(leaf, torch.Tensor):
            leaf = np.asarray(leaf)
        shape = tuple(leaf.shape)
        plan = host_slice_plan(path, shape, host, n_hosts)
        if plan is None:
            out[path] = HostShardView(None, global_shape=shape, dtype=leaf.dtype)
            continue
        start, stop = plan
        window = tuple(slice(a, b) for a, b in zip(start, stop))
        out[path] = HostShardView(
            leaf[window] if len(shape) else leaf,
            start=start, stop=stop, global_shape=shape, dtype=leaf.dtype,
        )
    return unflatten_from_paths(treedef, out)


def state_digest(state: Any) -> str:
    """Order-stable content hash for lockstep-convergence assertions (the
    reference's: SHA-256 over every leaf's bytes, card tensors copied to
    the host)."""
    return tree_digest(state)


def _corrupt_state(state: Any) -> None:
    """Divergence drill: flip one byte of the first device leaf, in place.

    A silent-corruption stand-in (bad DIMM, miscompiled kernel): the rank
    keeps training on the perturbed weights, so every later digest forks
    too — the watchdog must name *this* chunk at the first boundary, not
    just "ranks disagree". Inline state only: the leaves are the live
    tensors or arrays, so the flip lands in the math.
    """
    flat, _ = flatten_with_paths(state["device"])
    for path in sorted(flat):
        leaf = flat[path]
        if isinstance(leaf, torch.Tensor):
            if leaf.numel() and leaf.is_contiguous():
                byte_view(leaf)[:1].bitwise_xor_(0xFF)
                return
            continue
        arr = np.asarray(leaf)
        if arr.nbytes and arr.flags.c_contiguous and arr.flags.writeable:
            arr.reshape(-1).view(np.uint8)[0] ^= 0xFF
            return


def _kernel_launches() -> dict[str, int]:
    """Each kernel's launches in this process so far."""
    from repro_torch.kernels.chunk_digest import chunk_digests
    from repro_torch.kernels.flash_attention import flash_attention

    return {"chunk_digest": int(chunk_digests.launches),
            "flash_attention": int(flash_attention.launches)}


# -- training loops ------------------------------------------------------------
#
# Device math lives in repro_torch.proxy.programs (one definition of "a
# step", shared by inline ranks, proxied ranks and the train CLI); the loop
# classes only adapt a program to the worker's {"device", "host"} state
# layout and its restore/materialize hooks.

def _program_spec(cfg: WorkerConfig) -> dict:
    if cfg.program is not None:
        spec = dict(cfg.program)
    elif cfg.loop == "numpy":
        spec = {
            "name": "numpy_sgd",
            "rows": cfg.rows or max(cfg.n_hosts, 2) * 8,
            "width": cfg.width,
            "seed": cfg.seed,
            "step_time_s": cfg.step_time_s,
        }
    elif cfg.loop == "torch":
        spec = {"name": "torch_tiny", "width": cfg.width, "seed": cfg.seed}
    elif cfg.loop.startswith("arch:"):
        # a real repro_torch.configs architecture in smoke shape — the same
        # program launch/train.py --device-runner proxy ships
        spec = {
            "name": "train_arch",
            "arch": cfg.loop.split(":", 1)[1],
            "smoke": True,
            "seed": cfg.seed,
        }
    else:
        raise ValueError(f"unknown worker loop {cfg.loop!r}")
    if spec.get("name") != "numpy_sgd":
        spec.setdefault("device", cfg.device)
    return spec


def _resolve_capacity(spec: str, spec_dict: dict) -> int:
    """``"50%"`` of the program's state bytes, or absolute bytes."""
    s = spec.strip()
    if s.endswith("%"):
        from repro_torch.proxy.programs import host_program

        nbytes = host_program(spec_dict).state_nbytes()
        return max(1, int(nbytes * float(s[:-1]) / 100.0))
    return int(s)


class _InlineLoop:
    """Run the step program in-process, its state on the program's device."""

    def __init__(self, cfg: WorkerConfig):
        from repro_torch.proxy.programs import make_program

        self.cfg = cfg
        self.program = make_program(_program_spec(cfg))
        self._window = dict.fromkeys(_kernel_launches(), 0)

    def init(self):
        # torch programs build their init on the host from a seeded
        # generator; on_restore places it on the program's device
        return {
            "device": self.program.on_restore(self.program.init_state()),
            "host": {"step": np.int64(0)},
        }

    def step(self, state, step: int):
        before = _kernel_launches()
        state["device"], _ = self.program.step(state["device"], step)
        for k, n in _kernel_launches().items():
            self._window[k] += n - before[k]
        return state

    def on_restore(self, state):
        state["device"] = self.program.on_restore(state["device"])
        return state

    def materialize(self, state):
        """Inline state is always current; nothing to pull."""
        return state

    def window_launches(self) -> dict[str, int]:
        """Each kernel's launches in the steps since the previous call."""
        out, self._window = self._window, dict.fromkeys(self._window, 0)
        return out

    def ack_fields(self) -> dict:
        """Extra PERSIST_DONE fields of this loop (none inline)."""
        return {}

    def digest(self, state) -> str:
        return state_digest(state["device"])

    def set_ctx(self, ctx: dict | None) -> None:
        self.ctx = ctx  # inline steps emit no spans; kept for symmetry

    def chunk_digests(self, state) -> dict[str, list[int]] | None:
        """Full-replica per-chunk digests for divergence provenance: one
        grouped kernel launch over the card tensors."""
        if not self.cfg.chunk_provenance:
            return None
        from repro_torch.kernels.ops import tree_chunk_digests

        return tree_chunk_digests(state["device"], self.cfg.chunk_bytes)

    def close(self):
        pass


class _ProxyLoop:
    """Host the step program in a supervised device-proxy process: spawned
    locally (``proxy_placement="local"``) or a session on the proxy-host
    daemon the coordinator places this rank on (``"coord"``).

    The rank stays device-clean: ``state["device"]`` is a host mirror
    refreshed by ``materialize()`` at persist boundaries and FINISHED; the
    proxy is respawned + replayed transparently if it dies mid-round. The
    proxy digests each step's output (fused digests: one ``chunk_digest``
    launch per step on the card), so the boundary's provenance table and
    state digest ride the SYNCED ack.
    """

    def __init__(self, cfg: WorkerConfig):
        from repro_torch.proxy import ProxyRunner

        self.cfg = cfg
        self.spec = _program_spec(cfg)
        self.last_digest: str | None = None
        self.last_chunk_digests: dict[str, list[int]] | None = None
        self.last_phase: dict = {}
        self.synced_wt: float | None = None
        # segments/API log live under the cluster root: a drill that
        # hard-exits this rank (os._exit) skips close(), and files under the
        # root are reclaimed with it — a respawned incarnation reuses the
        # same directory instead of leaking RAM-backed segments
        workdir = os.path.join(cfg.root, f"proxy-h{cfg.host:04d}")
        os.makedirs(workdir, exist_ok=True)
        provider = None
        if cfg.proxy_placement == "coord":
            # remote proxies: the coordinator assigns a proxy host (and a
            # survivor after a proxy-host death) via the PROXY_ENDPOINT
            # side channel — never this rank's barrier connection
            from repro_torch.remote.placement import CoordEndpointProvider

            provider = CoordEndpointProvider(
                (cfg.coord_host, cfg.coord_port), cfg.host,
                timeout_s=cfg.deadline_s,
            )
        elif cfg.proxy_placement != "local":
            raise ValueError(
                f"unknown proxy_placement {cfg.proxy_placement!r}"
            )
        extra = {}
        if cfg.device_capacity is not None:
            extra["device_capacity_bytes"] = _resolve_capacity(
                cfg.device_capacity, self.spec
            )
        self.runner = ProxyRunner(
            self.spec,
            workdir=workdir,
            chunk_bytes=cfg.chunk_bytes,
            sync_timeout_s=cfg.persist_timeout_s,
            op_timeout_s=cfg.persist_timeout_s,
            transport=cfg.proxy_transport,
            fused_digests=True,
            endpoint_provider=provider,
            **extra,
        )

    def init(self):
        dstate = self.runner.start()
        return {"device": dstate, "host": {"step": np.int64(0)}}

    def step(self, state, step: int):
        self.runner.step(step)
        return state  # mirror is stale until the next materialize()

    def on_restore(self, state):
        self.runner.start(
            device_state=state["device"],
            base_step=int(np.asarray(state["host"]["step"])),
        )
        return state

    def materialize(self, state):
        state["device"], info = self.runner.sync_state()
        self.synced_wt = time.time()
        # the proxy already digested the state during sync — keep it so
        # the persist ack's divergence check costs nothing extra here
        self.last_digest = info.get("digest")
        self.last_chunk_digests = info.get("chunk_digests")
        self.last_phase = info.get("phase_us", {})
        return state

    def window_launches(self) -> dict[str, int]:
        """Each kernel's launches in the proxy over the window the last
        ``materialize()`` synced (its SYNCED ``phase_us``)."""
        return {"chunk_digest": int(self.last_phase.get("digest_launches", 0)),
                "flash_attention": int(self.last_phase.get("flash_launches", 0))}

    def ack_fields(self) -> dict:
        """When the boundary's SYNCED arrived (wall clock) and the proxy's
        restarts so far: a reschedule's latency is read from them."""
        return {"synced_wt": self.synced_wt, "proxy_restarts": self.runner.restarts}

    def digest(self, state) -> str:
        return self.last_digest or state_digest(state["device"])

    def set_ctx(self, ctx: dict | None) -> None:
        # the runner mints a child context per STEP/SYNC/UPLOAD frame under
        # whatever is installed here (None = frames ride bare)
        self.runner.trace_ctx = ctx

    def chunk_digests(self, state) -> dict[str, list[int]] | None:
        """Per-chunk digests the proxy's SYNC already produced (free)."""
        if not self.cfg.chunk_provenance:
            return None
        return self.last_chunk_digests

    def close(self):
        self.runner.close()


def _make_loop(cfg: WorkerConfig):
    if cfg.device_runner == "proxy":
        return _ProxyLoop(cfg)
    if cfg.device_runner != "inline":
        raise ValueError(f"unknown device_runner {cfg.device_runner!r}")
    return _InlineLoop(cfg)


def _setup_device(cfg: WorkerConfig) -> None:
    """The rank's device settings (the reference's JAX_PLATFORMS default).

    A CUDA rank takes the train CLI's determinism settings — the ranks,
    and any inline run they are held against, must compute the same bits —
    and an inline one raises when it finds no card. A proxied rank leaves
    the card to its proxy, which sets the same."""
    if torch.device(cfg.device).type != "cuda":
        return
    from repro_torch.proxy.service import deterministic_torch

    deterministic_torch()
    if cfg.device_runner == "inline" and not torch.cuda.is_available():
        raise RuntimeError(
            f"rank {cfg.host} asked for device {cfg.device!r} but no CUDA "
            "device is available (pass device='cpu' to run on the CPU)"
        )


# -- the worker process --------------------------------------------------------

class _Heartbeat(threading.Thread):
    def __init__(self, conn: Connection, cfg: WorkerConfig):
        super().__init__(name=f"worker-{cfg.host}-heartbeat", daemon=True)
        self.conn, self.cfg = conn, cfg
        self.step = 0
        self.paused = threading.Event()
        self.stop = threading.Event()
        # causal context of the checkpoint window in flight (main thread
        # writes, this thread reads — a torn read just rides the next beat)
        self.ctx: dict | None = None
        # live telemetry: the registry delta since the last beat rides
        # inside the same framed sendall — zero extra syscalls per beat
        self.piggyback = HeartbeatPiggyback()

    def run(self) -> None:
        while not self.stop.wait(self.cfg.heartbeat_s):
            if self.paused.is_set():
                continue
            payload = self.piggyback.collect()
            extra = {}
            if payload is not None:
                extra["metrics"] = payload
            if self.ctx is not None:
                extra["ctx"] = self.ctx
            try:
                # wall-clock witness for the watchdog's clock_skew rule
                self.conn.send(MSG_HEARTBEAT, host=self.cfg.host,
                               step=self.step, wt=time.time(), **extra)
            except OSError:
                # coordinator kicked us (or died): this incarnation is over
                os._exit(1)


def _recv(conn: Connection, deadline: float) -> dict:
    while True:
        if time.monotonic() > deadline:
            raise TimeoutError("worker gave up waiting for the coordinator")
        try:
            msg = conn.recv()
        except (socket.timeout, TimeoutError):
            continue
        if msg is None:
            raise ConnectionError("coordinator closed the connection")
        return msg


def worker_entry(cfg: WorkerConfig) -> int:
    """Process entry point (multiprocessing spawn target)."""
    _setup_device(cfg)
    obs_trace.enable_from_env(f"worker{cfg.host}")
    deadline = time.monotonic() + cfg.deadline_s
    conn = connect((cfg.coord_host, cfg.coord_port), timeout=cfg.deadline_s)
    conn.settimeout(cfg.sock_timeout_s)

    loop = _make_loop(cfg)
    store = ChunkStore(cfg.root)
    restorer = RestoreManager(store)
    ck = ForkedCheckpointer(
        store,
        codec=cfg.codec,
        chunk_bytes=cfg.chunk_bytes,
        incremental=cfg.incremental,
        host=cfg.host,
        backend=cfg.backend,
        external_commit=True,
        # PERSIST_DONE is this rank's promise that its payload bytes are on
        # stable storage; the coordinator's durable commit is meaningless if
        # data-h*.bin still lives in the page cache
        fsync=True,
    )

    # -- join + restore ------------------------------------------------------
    conn.send(MSG_JOIN, host=cfg.host, pid=os.getpid(), restored_from=None)
    welcome = _recv(conn, deadline)
    assert welcome["type"] == MSG_WELCOME, welcome
    # heartbeats must start *before* restore: a respawned rank restoring a
    # large image for longer than the heartbeat timeout would otherwise be
    # kicked as dead and crash-loop through its restart budget
    hb = _Heartbeat(conn, cfg)
    hb.start()
    latest = welcome.get("latest_committed")
    if latest is not None:
        state, _ = restorer.restore(step=latest)
        state = loop.on_restore(state)
        start = int(np.asarray(state["host"]["step"]))
        # tell the coordinator (and the round log) where we came back from
        conn.send(MSG_JOIN, host=cfg.host, pid=os.getpid(),
                  restored_from=latest)
        _recv(conn, deadline)  # the re-JOIN's WELCOME
    else:
        state = loop.init()
        start = int(np.asarray(state["host"]["step"]))
    hb.step = start

    step = start
    tr = obs_trace.get()
    window_ctx: dict | None = None
    try:
        while step < cfg.total_steps:
            step += 1
            if tr is not None and cfg.ckpt_every > 0:
                # the boundary this step marches toward names the round
                # trace; its window context is installed *before* the step
                # so proxy STEP frames issued mid-window join the round tree,
                # parented to the deterministic round root
                b = -(-step // cfg.ckpt_every) * cfg.ckpt_every
                trace_id = obs_trace.round_trace_id(b)
                if window_ctx is None or window_ctx["trace"] != trace_id:
                    window_ctx = obs_trace.span_context(
                        trace_id, parent=obs_trace.root_span_id(trace_id)
                    )
                    loop.set_ctx(window_ctx)
                    hb.ctx = window_ctx
            state = loop.step(state, step)
            state["host"]["step"] = np.int64(step)
            hb.step = step
            if cfg.corrupt_at_step == step and not cfg.restored:
                _corrupt_state(state)
            boundary = cfg.ckpt_every > 0 and step % cfg.ckpt_every == 0

            if cfg.stall_at_step == step and not cfg.restored:
                hb.paused.set()          # heartbeat miss -> coordinator kicks
                time.sleep(cfg.stall_s)
                hb.paused.clear()
            if cfg.kill_at_step == step and not cfg.restored:
                if boundary:
                    conn.send(MSG_READY, host=cfg.host, step=step)
                    time.sleep(0.05)     # let READY land: death is mid-round
                os._exit(EXIT_KILLED)

            if boundary:
                # proxy runner: pull the device mirror current before the
                # barrier — the persisted shards must reflect this step
                state = loop.materialize(state)
                launches = {"step_launches": loop.window_launches(),
                            **loop.ack_fields()}
                t0 = time.perf_counter()
                digest = loop.digest(state)
                digest_s = time.perf_counter() - t0
                before = _kernel_launches()["chunk_digest"]
                chunk_digests = loop.chunk_digests(state)
                launches["provenance_launches"] = (
                    _kernel_launches()["chunk_digest"] - before)
                _checkpoint_round(conn, cfg, ck, state, step, deadline, launches,
                                  digest=digest,
                                  chunk_digests=chunk_digests,
                                  ctx=window_ctx, digest_s=digest_s)

        loop.set_ctx(None)  # the final sync belongs to no round
        hb.ctx = None
        state = loop.materialize(state)
        digest = state_digest(state["device"])
        conn.send(MSG_FINISHED, host=cfg.host, step=step, digest=digest)
        while True:
            msg = _recv(conn, deadline)
            if msg["type"] == MSG_SHUTDOWN:
                break
    finally:
        hb.stop.set()
        ck.close()
        loop.close()
        conn.close()
        for name, n in _kernel_launches().items():
            obs_metrics.REGISTRY.set(f"{name}_launches", n)
        obs_metrics.dump_if_enabled(f"worker{cfg.host}")
    return 0


def _checkpoint_round(
    conn: Connection,
    cfg: WorkerConfig,
    ck: ForkedCheckpointer,
    state,
    step: int,
    deadline: float,
    launches: dict,
    digest: str | None = None,
    chunk_digests: dict | None = None,
    ctx: dict | None = None,
    digest_s: float = 0.0,
) -> None:
    """Barrier at a boundary; persist on DRAIN; retry the round on ABORT."""
    tr = obs_trace.get()
    if tr is not None:
        # the span *is* the window context: mid-window proxy frames already
        # parented to ctx["span"], and this B/E (covering every retry of
        # the round) resolves them to the deterministic round root
        tr.begin("worker.round", step=step, host=cfg.host,
                 **obs_trace.ctx_args(ctx))
    try:
        conn.send(MSG_READY, host=cfg.host, step=step)
        while True:
            msg = _recv(conn, deadline)
            mtype, mstep = msg["type"], int(msg.get("step", -1))
            if mstep != step and mtype != MSG_SHUTDOWN:
                continue  # stale frame from a previous (aborted) round
            if mtype == MSG_DRAIN:
                _persist_shards(conn, cfg, ck, state, step, launches, digest,
                                chunk_digests, ctx, digest_s)
            elif mtype == MSG_COMMIT:
                ck.commit_confirmed(step)
                return
            elif mtype == MSG_ABORT:
                ck.commit_aborted(step)
                conn.send(MSG_READY, host=cfg.host, step=step)
            elif mtype == MSG_SHUTDOWN:
                # coordinator is tearing the cluster down mid-round
                raise SystemExit(0)
    finally:
        if tr is not None:
            tr.end("worker.round")


def _persist_shards(conn, cfg: WorkerConfig, ck, state, step: int,
                    launches: dict,
                    digest: str | None = None,
                    chunk_digests: dict | None = None,
                    ctx: dict | None = None,
                    digest_s: float = 0.0) -> None:
    shard = shard_tree_for_host(state, cfg.host, cfg.n_hosts)
    before = _kernel_launches()["chunk_digest"]
    try:
        r = ck.save_async(
            step, shard, meta={"host": cfg.host, "n_hosts": cfg.n_hosts},
            trace_ctx=ctx,
        )
        try:
            r.wait(cfg.persist_timeout_s)
        except TimeoutError:
            # hung persist: die loudly, get respawned. Kill any forked
            # persist child first — an orphan holding an fd on data-h*.bin
            # could otherwise interleave writes with the respawned
            # incarnation's retry of the same file.
            ck.backend.kill_pending()
            os._exit(EXIT_WATCHDOG)
    except Exception as e:
        conn.send(MSG_PERSIST_FAIL, host=cfg.host, step=step, error=str(e))
        return
    # the shadow sync's own launches (the persist child launches none)
    sync_launches = _kernel_launches()["chunk_digest"] - before
    if cfg.die_after_persist_step == step and not cfg.restored:
        os._exit(EXIT_MID_COMMIT)  # hostmeta is durable, ack never sent
    if cfg.straggle_s and cfg.straggle_at_step in (None, step):
        time.sleep(cfg.straggle_s)  # heartbeats continue: slow, not dead
    extra = {}
    if ctx is not None:
        # echo the round context so the coordinator's quorum instant
        # (coord.ack) parents under this rank's round span
        extra["ctx"] = ctx
    if chunk_digests and sum(map(len, chunk_digests.values())) <= 65536:
        # divergence provenance: per-chunk digests of the full replicated
        # state (size-capped — a pathological chunk count must not blow
        # the 16 MiB control-frame limit)
        extra["chunk_digests"] = chunk_digests
    # kernel launches on this rank's device path: the window's steps (per
    # kernel; a proxied rank's from its proxy's SYNCED), this boundary's
    # provenance table and this attempt's shadow sync (and a proxied rank's
    # SYNCED wall time and proxy restarts, ``ack_fields``)
    extra.update(launches, sync_launches=sync_launches)
    conn.send(
        MSG_PERSIST_DONE,
        host=cfg.host,
        step=step,
        **extra,
        hostmeta=f"hostmeta-h{cfg.host:04d}.msgpack",
        persist_s=r.persist_s,
        blocking_s=r.blocking_s,
        bytes_written=r.bytes_written,
        chunks_written=r.chunks_written,
        chunks_reused=r.chunks_reused,
        # incremental sync economy: what the digest gate spared this rank
        # in phase 1 — the coordinator sums these into the round record
        chunks_synced=r.chunks_synced,
        chunks_clean=r.chunks_clean,
        bytes_skipped=r.bytes_skipped,
        # phase-1 breakdown: where the blocking microseconds went
        sync_us=r.sync_us,
        digest_us=r.digest_us,
        fetch_us=r.fetch_us,
        stall_us=r.stall_us,
        # lockstep witness for the watchdog's divergence rule, and the
        # seconds this rank spent computing it
        state_digest=digest,
        state_digest_s=digest_s,
    )
