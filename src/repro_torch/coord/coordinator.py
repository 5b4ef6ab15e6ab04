"""The cluster coordinator: heartbeat-gated two-phase checkpoint commit.

DMTCP-style: one coordinator process owns cluster state; workers (CRUM's
per-rank proxies) connect, heartbeat, and block at checkpoint boundaries.
A checkpoint round is a two-phase commit over the shared checkpoint root:

  phase 1 (prepare)  every worker READY at step S -> coordinator sends
                     DRAIN -> each worker persists *its own shards* via its
                     local ForkedCheckpointer in external-commit mode
                     (data-h*.bin + hostmeta-h*.msgpack) and acks
                     PERSIST_DONE.
  phase 2 (decide)   only when every live participant has acked *and* the
                     HeartbeatMonitor sees the full membership alive does
                     the coordinator merge the hostmetas into
                     MANIFEST.msgpack and write the COMMIT marker (fsynced
                     with the step directory). Any death, stall or persist
                     failure mid-round ABORTs: no MANIFEST, no COMMIT, the
                     previous committed image stays the restore target.

Rounds, joins, deaths and commits are journaled to CLUSTER_LOG.jsonl under
the checkpoint root (the auditable "manifest chain" of the cluster).

The coordinator touches no tensor: it is the reference's
``repro.coord.coordinator``, copied onto the port's own modules, and its
journal, merged manifests and wire frames are the reference's bytes.
"""
from __future__ import annotations

import os
import queue
import socket
import threading
import time
from dataclasses import dataclass, field, asdict

from repro_torch.checkpoint.manifest import (
    commit_manifest,
    latest_committed_step,
    merge_hostmetas,
)
from repro_torch.checkpoint.store import ChunkStore
from repro_torch.core.failure import HeartbeatMonitor, StragglerPolicy
from repro_torch.core.policy import CheckpointPolicy
from repro_torch.coord.protocol import (
    MSG_ABORT,
    MSG_COMMIT,
    MSG_DRAIN,
    MSG_FINISHED,
    MSG_HEARTBEAT,
    MSG_JOIN,
    MSG_METRICS,
    MSG_PERSIST_DONE,
    MSG_PERSIST_FAIL,
    MSG_PROXY_ENDPOINT,
    MSG_READY,
    MSG_SHUTDOWN,
    MSG_WELCOME,
    Connection,
)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.journal import JournalWriter
from repro_torch.obs.live import LiveAggregator
from repro_torch.obs.watch import SEV_CRITICAL, Alert, WatchConfig, Watchdog

# NOTE: repro_torch.remote.placement is imported lazily in __init__ — that module
# (and the rest of repro_torch.remote) builds on the proxy package, whose import
# chain passes back through repro_torch.coord.protocol.


@dataclass
class RoundRecord:
    """One checkpoint round attempt (committed or aborted)."""

    step: int
    status: str = "open"          # open -> committed | aborted
    reason: str = ""              # abort cause
    participants: list[int] = field(default_factory=list)
    acked: list[int] = field(default_factory=list)
    stragglers: list[int] = field(default_factory=list)
    commit_s: float = 0.0         # merge + fsync + COMMIT marker
    round_s: float = 0.0          # first READY -> decision
    persist_s_max: float = 0.0    # slowest host's persist time
    bytes_written: int = 0
    # incremental sync economy, summed over participants: how much of the
    # cluster state the digest gate / page dirty bits proved unchanged
    chunks_synced: int = 0        # chunks fetched device->host this round
    chunks_clean: int = 0         # chunks proven (or known) unchanged
    bytes_skipped: int = 0        # bytes the clean chunks did not move
    # phase-1 breakdown summed over participants (microseconds): how the
    # blocking window split between shadow sync, digesting (0 when fused
    # digests covered the boundary), fetching, and pipelined-sync stall
    sync_us: float = 0.0
    digest_us: float = 0.0
    fetch_us: float = 0.0
    stall_us: float = 0.0


@dataclass
class _Round:
    step: int
    opened_at: float
    drained_at: float | None = None
    acks: dict[int, dict] = field(default_factory=dict)
    record: RoundRecord | None = None
    # causal root context for the round's trace (None when tracing is off);
    # DRAIN/COMMIT/ABORT broadcasts carry it so receivers parent to the root
    ctx: dict | None = None


class Coordinator:
    """Owns membership, the round state machine, and the commit decision."""

    def __init__(
        self,
        root: str,
        *,
        n_hosts: int,
        heartbeat_timeout_s: float = 15.0,
        round_timeout_s: float = 120.0,
        keep_last: int = 0,
        tick_s: float = 0.25,
        watch_cfg: WatchConfig | None = None,
        abort_on_critical: bool = False,
        live_snapshot_every_s: float = 5.0,
        obs_dir: str | None = None,
    ):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.n_hosts = int(n_hosts)
        self.round_timeout_s = round_timeout_s
        self.tick_s = tick_s
        self.keep_last = int(keep_last)
        self.monitor = HeartbeatMonitor([], timeout_s=heartbeat_timeout_s)
        self.stragglers = StragglerPolicy()
        self.rounds: list[RoundRecord] = []
        # per committed round, in order: {host: its PERSIST_DONE frame}
        self.committed_acks: list[dict[int, dict]] = []
        self.done = threading.Event()
        self.latest_committed: int | None = latest_committed_step(root)
        self._inbox: "queue.Queue[tuple[str, Connection, dict | None]]" = queue.Queue()
        self._conns: dict[int, Connection] = {}       # host -> connection
        self._conn_host: dict[Connection, int] = {}
        self._finished: dict[int, str] = {}           # host -> state digest
        self._restored_from: dict[int, int | None] = {}
        self._round: _Round | None = None
        self._listener: socket.socket | None = None
        self._journal = JournalWriter(
            os.path.join(root, "CLUSTER_LOG.jsonl")
        )
        # live telemetry plane: HEARTBEAT-piggybacked registry deltas land
        # in a bounded time-series store, snapshotted to the obs/run dir
        # (falling back to the checkpoint root) and served over this same
        # listener (METRICS frames -> obs.top)
        self.live = LiveAggregator(
            snapshot_path=os.path.join(obs_dir or root, "live_metrics.json"),
            snapshot_every_s=live_snapshot_every_s,
        )
        # SLO watchdog: rules over every signal the event loop already
        # sees; alerts fan out to journal + trace + metrics via _on_alert
        self.abort_on_critical = bool(abort_on_critical)
        self.watchdog = Watchdog(watch_cfg, on_alert=self._on_alert)
        # proxy placement (remote device proxies): endpoint registry +
        # worker assignments, mutated only on the event-loop thread
        from repro_torch.remote.placement import PlacementMap

        self.placement = PlacementMap()

    # -- lifecycle -----------------------------------------------------------
    @property
    def address(self) -> tuple[str, int]:
        assert self._listener is not None, "call start() first"
        return self._listener.getsockname()[:2]

    def start(self) -> "Coordinator":
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(self.n_hosts * 2)
        threading.Thread(
            target=self._accept_loop, name="coord-accept", daemon=True
        ).start()
        return self

    def _accept_loop(self) -> None:
        while True:
            try:
                sock, _ = self._listener.accept()
            except OSError:  # listener closed at shutdown
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = Connection(sock)
            # daemon readers die with their connection's EOF; holding on to
            # them would leak one Thread per worker incarnation forever
            threading.Thread(
                target=self._reader_loop, args=(conn,),
                name="coord-reader", daemon=True,
            ).start()

    def _reader_loop(self, conn: Connection) -> None:
        try:
            while True:
                frame = conn.recv()
                if frame is None:
                    break
                self._inbox.put(("msg", conn, frame))
        except (OSError, ValueError):
            pass
        self._inbox.put(("eof", conn, None))

    def close(self) -> None:
        self.live.write_snapshot()  # final state for post-run obs.top
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        for c in list(self._conns.values()):
            c.close()
        self._conns.clear()
        self._conn_host.clear()
        self._journal.close()

    # -- journal ---------------------------------------------------------------
    def _log(self, event: str, **fields) -> None:
        self._journal.write(event, **fields)

    # -- alerts (SLO watchdog fan-out) ----------------------------------------
    def _on_alert(self, alert: Alert) -> None:
        """Every alert crosses every observability channel at once: the
        versioned journal line, a trace instant, the metrics registry —
        and, under the abort-on-critical policy, the open round."""
        self._log("alert", **alert.as_dict())
        obs_trace.instant(f"watch.{alert.kind}", severity=alert.severity,
                          host=alert.host, step=alert.step)
        obs_metrics.REGISTRY.inc("watch_alerts_total")
        obs_metrics.REGISTRY.inc(f"watch_alerts_{alert.severity}")
        self.live.observe(-1, f"alert_{alert.kind}", 1.0)
        if self.abort_on_critical and alert.severity == SEV_CRITICAL:
            self._abort_round(
                f"critical alert: {alert.kind} ({alert.message})"
            )

    @property
    def alerts(self) -> list[Alert]:
        return list(self.watchdog.alerts)

    # -- the event loop --------------------------------------------------------
    def run(self, *, deadline_s: float = 600.0) -> list[RoundRecord]:
        """Drive rounds until every host reports FINISHED (or deadline)."""
        deadline = time.monotonic() + deadline_s
        try:
            while True:
                if len(self._finished) == self.n_hosts:
                    self._broadcast(MSG_SHUTDOWN)
                    self._log("shutdown", finished=sorted(self._finished))
                    return self.rounds
                if time.monotonic() > deadline:
                    self._abort_round("coordinator deadline exceeded")
                    self._broadcast(MSG_SHUTDOWN)
                    raise TimeoutError(
                        f"cluster did not finish within {deadline_s}s "
                        f"(finished={sorted(self._finished)}, "
                        f"members={sorted(self._conns)})"
                    )
                try:
                    kind, conn, frame = self._inbox.get(timeout=self.tick_s)
                except queue.Empty:
                    self._check_liveness()
                    continue
                if kind == "eof":
                    self._on_eof(conn)
                else:
                    self._dispatch(conn, frame)
                self._check_liveness()
        finally:
            self.done.set()
            self.close()

    # -- message handling -------------------------------------------------------
    def _dispatch(self, conn: Connection, msg: dict) -> None:
        mtype = msg.get("type")
        host = msg.get("host")
        if mtype == MSG_JOIN:
            self._on_join(conn, msg)
            return
        if mtype == MSG_PROXY_ENDPOINT:
            # side channel: daemons/launchers register, workers acquire —
            # these connections never JOIN, so handle before the host gate
            self._on_proxy_endpoint(conn, msg)
            return
        if mtype == MSG_METRICS:
            # live-telemetry readout (obs.top): any connection, no JOIN
            self._on_metrics(conn, msg)
            return
        if self._conn_host.get(conn) != host:
            return  # frame from a connection we already kicked
        self.monitor.beat(host)
        if mtype == MSG_HEARTBEAT:
            self._on_heartbeat(host, msg)
            return
        if mtype == MSG_READY:
            self._on_ready(host, int(msg["step"]))
        elif mtype == MSG_PERSIST_DONE:
            self._on_persist_done(host, msg)
        elif mtype == MSG_PERSIST_FAIL:
            self._abort_round(
                f"host {host} persist failed: {msg.get('error', '?')}"
            )
        elif mtype == MSG_FINISHED:
            self._finished[host] = msg.get("digest", "")
            self._log("finished", host=host, step=msg.get("step"),
                      digest=msg.get("digest", ""))

    def _on_heartbeat(self, host: int, msg: dict) -> None:
        step = int(msg.get("step") or 0)
        wt = msg.get("wt")
        self.watchdog.on_heartbeat(
            host, step, wt=float(wt) if wt is not None else None
        )
        if self.live.ingest(host, msg.get("metrics")):
            # feed the spike rules exactly the points that just landed
            now = time.time()
            for metric in self.watchdog.cfg.fault_metrics:
                v = self.live.store.latest(host, metric)
                if v is not None:
                    self.watchdog.on_metric_point(host, metric, now, v)

    def _on_metrics(self, conn: Connection, msg: dict) -> None:
        try:
            conn.send(
                MSG_METRICS,
                snapshot=self.live.snapshot(),
                alerts=[a.as_dict() for a in self.watchdog.alerts[-100:]],
                latest_committed=self.latest_committed,
                n_hosts=self.n_hosts,
            )
        except OSError:
            pass  # readout peer vanished: nothing to unwind

    def _on_join(self, conn: Connection, msg: dict) -> None:
        host = int(msg["host"])
        self.live.reset_host(host)  # fresh incarnation: seq restarts at 1
        old = self._conns.pop(host, None)
        if old is not None and old is not conn:
            # stale connection from a previous incarnation of this host
            # (a re-JOIN on the *same* connection just updates metadata)
            self._conn_host.pop(old, None)
            old.close()
        self._conns[host] = conn
        self._conn_host[conn] = host
        self.monitor.add_host(host)
        self._restored_from[host] = msg.get("restored_from")
        self._log(
            "join", host=host, pid=msg.get("pid"),
            restored_from=msg.get("restored_from"),
            latest_committed=self.latest_committed,
        )
        obs_trace.instant("coord.join", host=host,
                          restored_from=msg.get("restored_from"))
        conn.send(
            MSG_WELCOME, host=host, n_hosts=self.n_hosts,
            latest_committed=self.latest_committed,
        )

    # -- proxy placement (remote device proxies) --------------------------------
    def register_proxy_endpoint(self, name: str, addr: str, port: int) -> None:
        """Launcher-side registration (same-process convenience); daemons
        on other machines use the PROXY_ENDPOINT register frame instead."""
        self.placement.register(name, addr, port)
        self._log("proxy_endpoint", name=name, addr=addr, port=int(port))

    def _on_proxy_endpoint(self, conn: Connection, msg: dict) -> None:
        # the side channel is open to any un-JOINed connection: a
        # malformed frame must be answered with an error, never allowed to
        # crash the event loop (and with it the whole cluster)
        try:
            op = msg.get("op")
            if op == "register":
                self.placement.register(msg["name"], msg["addr"], msg["port"])
                self._log("proxy_endpoint", name=msg["name"],
                          addr=msg["addr"], port=int(msg["port"]))
                conn.send(MSG_PROXY_ENDPOINT, op="registered",
                          name=msg["name"])
                return
            if op == "acquire":
                worker = int(msg["worker"])
                failed = msg.get("failed")
                if failed:
                    self.placement.report_dead(failed)
                    self._log("proxy_host_death", name=failed, worker=worker)
                    # alert *before* the reassignment answer goes out — the
                    # journal must show the death ahead of any round that
                    # commits on the rescheduled proxy
                    self.watchdog.on_proxy_host_death(failed, worker)
                ep = self.placement.assign(
                    worker, exclude=tuple(msg.get("exclude") or ())
                )
                if ep is None:
                    conn.send(MSG_PROXY_ENDPOINT,
                              error="no live proxy endpoints")
                    return
                self._log("proxy_placement", worker=worker, name=ep.name,
                          rescheduled=bool(failed))
                conn.send(MSG_PROXY_ENDPOINT, name=ep.name, addr=ep.addr,
                          port=ep.port)
                return
            conn.send(MSG_PROXY_ENDPOINT, error=f"unknown op {op!r}")
        except OSError:
            pass  # side-channel peer vanished mid-reply: nothing to unwind
        except Exception as e:
            try:
                conn.send(MSG_PROXY_ENDPOINT,
                          error=f"bad frame: {type(e).__name__}: {e}")
            except OSError:
                pass

    def _on_ready(self, host: int, step: int) -> None:
        if self.latest_committed is not None and step <= self.latest_committed:
            return  # stale barrier from before a restore
        r = self._round
        if r is None:
            r = self._round = _Round(step=step, opened_at=time.monotonic())
            r.record = RoundRecord(step=step)
            self.rounds.append(r.record)
            tr = obs_trace.get()
            if tr is not None:
                # the round root span: its id is derived from the trace id
                # alone (root_span_id), so workers that reached the boundary
                # before this READY arrived already parented to it
                trace_id = obs_trace.round_trace_id(step)
                r.ctx = obs_trace.span_context(
                    trace_id, span=obs_trace.root_span_id(trace_id)
                )
                tr.begin("coord.round", step=step, **obs_trace.ctx_args(r.ctx))
        if step != r.step:
            # a worker at a different boundary than the open round means the
            # cluster lost lockstep — abort, then re-open at the incoming
            # boundary (survivors re-READY on ABORT, so the barrier re-forms)
            self._abort_round(
                f"host {host} ready at step {step} during round {r.step}"
            )
            self._on_ready(host, step)
            return
        if host not in r.record.participants:
            r.record.participants.append(host)
        if (
            len(self._conns) == self.n_hosts
            and all(h in r.record.participants for h in range(self.n_hosts))
            and r.drained_at is None
        ):
            r.drained_at = time.monotonic()
            # ctx rides only when tracing: the off-path frame is byte-identical
            extra = {"ctx": r.ctx} if r.ctx is not None else {}
            self._broadcast(MSG_DRAIN, step=step, **extra)

    def _on_persist_done(self, host: int, msg: dict) -> None:
        r = self._round
        if r is None or int(msg["step"]) != r.step or r.drained_at is None:
            return  # late ack for an aborted round
        r.acks[host] = msg
        r.record.acked = sorted(r.acks)
        # cross-worker divergence rule: every acking host must hold the
        # same lockstep state at this boundary (digest rides the ack);
        # per-chunk digests, when they flowed, let a divergence alert name
        # the exact chunk and the host whose copy forked
        self.watchdog.on_persist_done(
            host, r.step, msg.get("state_digest"),
            chunk_digests=msg.get("chunk_digests"),
        )
        tr = obs_trace.get()
        if tr is not None:
            # quorum instant: child of the worker's round span (the ack
            # frame echoes the worker's ctx), so commit-quorum spread is
            # attributable per host in the causal tree
            tr.instant(
                "coord.ack", host=host, step=r.step,
                **obs_trace.ctx_args(obs_trace.child_span(msg.get("ctx"))),
            )
        # straggler accounting uses the duration the *coordinator* observed
        # (DRAIN -> ack), not the worker's self-reported persist time: a
        # host whose storage or network stalls the ack is exactly the host
        # that stalls the commit, whatever its local clock claims.
        self.stragglers.record(host, time.monotonic() - r.drained_at)
        if len(r.acks) < self.n_hosts:
            return
        # phase 2: the decision. Gate on liveness — an ack from a host that
        # died right after sending it must not produce a commit no one can
        # heartbeat for.
        dead = set(self.monitor.dead_hosts()) & set(self._conns)
        if dead or len(self._conns) < self.n_hosts:
            self._abort_round(f"dead hosts at commit gate: {sorted(dead)}")
            return
        self._commit_round()

    # -- round transitions --------------------------------------------------------
    def _commit_round(self) -> None:
        r = self._round
        t0 = time.perf_counter()
        try:
            manifest = merge_hostmetas(self.root, r.step, hosts=sorted(r.acks))
            manifest.meta["coordinator"] = {
                "participants": sorted(r.acks),
                "previous_committed": self.latest_committed,
            }
            commit_manifest(self.root, manifest, durable=True)
        except Exception as e:
            self._abort_round(f"commit failed: {type(e).__name__}: {e}")
            return
        rec = r.record
        rec.commit_s = time.perf_counter() - t0
        rec.round_s = time.monotonic() - r.opened_at
        rec.persist_s_max = max(
            (float(m.get("persist_s", 0.0)) for m in r.acks.values()), default=0.0
        )
        rec.bytes_written = sum(
            int(m.get("bytes_written", 0)) for m in r.acks.values()
        )
        rec.chunks_synced = sum(
            int(m.get("chunks_synced", 0)) for m in r.acks.values()
        )
        rec.chunks_clean = sum(
            int(m.get("chunks_clean", 0)) for m in r.acks.values()
        )
        rec.bytes_skipped = sum(
            int(m.get("bytes_skipped", 0)) for m in r.acks.values()
        )
        for phase in ("sync_us", "digest_us", "fetch_us", "stall_us"):
            setattr(rec, phase, round(sum(
                float(m.get(phase, 0.0)) for m in r.acks.values()
            ), 1))
        rec.stragglers = self.stragglers.stragglers()
        rec.status = "committed"
        self.committed_acks.append(dict(r.acks))
        self.latest_committed = r.step
        rctx = r.ctx
        self._round = None
        tr = obs_trace.get()
        if tr is not None:
            # the decision phase as a real span (merge + fsync + marker),
            # child of the round root — the reference critpath's commit bucket. The
            # round root closes HERE, at the decision, so its extent
            # matches the journaled round_s (first READY -> decision) and
            # critpath --check can hold the two within tolerance; the
            # broadcast/journal/watchdog work below is post-round.
            tr.complete("coord.commit", t0, step=rec.step,
                        bytes_written=rec.bytes_written,
                        **obs_trace.ctx_args(obs_trace.child_span(rctx)))
            tr.end("coord.round")
        extra = {"ctx": rctx} if rctx is not None else {}
        self._broadcast(MSG_COMMIT, step=rec.step, **extra)
        self._log("round", **asdict(rec))
        obs_metrics.absorb_round(asdict(rec))
        self.watchdog.on_round(asdict(rec))
        self.live.observe(-1, "round_s", rec.round_s)
        self.live.observe(-1, "commit_s", rec.commit_s)
        self._gc()

    def _abort_round(self, reason: str) -> None:
        r = self._round
        if r is None:
            return
        rec = r.record
        rec.status = "aborted"
        rec.reason = reason
        rec.round_s = time.monotonic() - r.opened_at
        rctx = r.ctx
        self._round = None
        tr = obs_trace.get()
        if tr is not None:
            tr.instant("coord.abort", step=rec.step, reason=reason)
            tr.end("coord.round")
        extra = {"ctx": rctx} if rctx is not None else {}
        self._broadcast(MSG_ABORT, step=rec.step, reason=reason, **extra)
        self._log("round", **asdict(rec))
        obs_metrics.absorb_round(asdict(rec))
        # safe even when an abort_rate alert goes critical here: _round is
        # already None, so a nested abort-on-critical _abort_round no-ops
        self.watchdog.on_round(asdict(rec))
        # Partial files (data-h*/hostmeta-h*) stay in the uncommitted step
        # dir — invisible to restore, truncated/overwritten by the retry.
        # Deleting here would race a straggler still writing into the dir.

    def _gc(self) -> None:
        if self.keep_last <= 0:
            return
        CheckpointPolicy(keep_last=self.keep_last).run_gc(ChunkStore(self.root))

    # -- liveness ------------------------------------------------------------------
    def _on_eof(self, conn: Connection) -> None:
        host = self._conn_host.pop(conn, None)
        conn.close()
        if host is None or self._conns.get(host) is not conn:
            return  # already replaced by a rejoin
        self._kick(host, "connection lost (worker death)")

    def _check_liveness(self) -> None:
        s = self.watchdog.tick()      # leak-trend sampling (rate-limited)
        if s and s.get("supported"):
            # publish the raw counts as coordinator-local series (-1):
            # the soak verdict's leaks_flat check reads these, so a flat
            # trend is provable from live_metrics.json, not just from
            # the absence of a leak alert
            self.live.observe(-1, "coord_fd", float(s["fd"]))
            self.live.observe(-1, "coord_shm", float(s["shm"]))
        self.live.maybe_snapshot()    # run-dir live_metrics.json refresh
        for host in set(self.monitor.dead_hosts()) & set(self._conns):
            self._kick(host, "heartbeat timeout (worker stalled)")
        r = self._round
        if (
            r is not None
            and r.drained_at is not None
            and time.monotonic() - r.drained_at > self.round_timeout_s
        ):
            missing = sorted(set(range(self.n_hosts)) - set(r.acks))
            self._abort_round(f"round timeout; missing acks from {missing}")
            for host in missing:
                self._kick(host, "no persist ack within round timeout")

    def _kick(self, host: int, reason: str) -> None:
        conn = self._conns.pop(host, None)
        if conn is not None:
            self._conn_host.pop(conn, None)
            conn.close()
        self.monitor.remove_host(host)
        self._finished.pop(host, None)
        self._log("death", host=host, reason=reason,
                  latest_committed=self.latest_committed)
        obs_trace.instant("coord.death", host=host, reason=reason)
        self.watchdog.on_death(host, reason)
        r = self._round
        if r is not None and host in r.record.participants:
            self._abort_round(f"host {host} lost mid-round: {reason}")

    def _broadcast(self, msg_type: str, **fields) -> None:
        for host, conn in list(self._conns.items()):
            try:
                conn.send(msg_type, **fields)
            except OSError:
                self._inbox.put(("eof", conn, None))

    # -- introspection --------------------------------------------------------------
    @property
    def final_digests(self) -> dict[int, str]:
        """{host: state digest at FINISHED} — lockstep-convergence evidence."""
        return dict(self._finished)

    @property
    def log_path(self) -> str:
        return self._journal.path

    def aborted_rounds(self) -> list[RoundRecord]:
        return [r for r in self.rounds if r.status == "aborted"]

    def committed_rounds(self) -> list[RoundRecord]:
        return [r for r in self.rounds if r.status == "committed"]

    def sweep_uncommitted(self) -> list[int]:
        """Remove uncommitted (aborted/partial) step dirs. Only safe once all
        workers have exited — a live straggler may still be writing."""
        removed = []
        try:
            names = os.listdir(self.root)
        except FileNotFoundError:
            return removed
        for name in names:
            d = os.path.join(self.root, name)
            if not (name.startswith("step_") and os.path.isdir(d)):
                continue
            if os.path.exists(os.path.join(d, "COMMIT")):
                continue
            for f in os.listdir(d):
                os.remove(os.path.join(d, f))
            os.rmdir(d)
            removed.append(name)
        return removed
