"""Restart supervision: spawn ranks, reap deaths, respawn into restore.

The supervisor is the process-level half of fault tolerance (the
coordinator is the protocol-level half). It spawns one OS process per
rank (``multiprocessing`` *spawn* context: CUDA forbids forking a process
that holds a context, and the launcher may hold one), then blocks on the
process sentinels (``multiprocessing.connection.wait`` — the portable SIGCHLD).
A worker exiting non-zero is a death: the supervisor respawns it with
``restored=True`` and every failure injection cleared, and the new
incarnation restores from ``latest_committed_step`` via the coordinator's
WELCOME — driving the cluster back to lockstep. A zero exit is a worker
that finished; it is never respawned.
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import threading
import time
from dataclasses import dataclass, field
from multiprocessing.connection import wait as sentinel_wait

from repro_torch.coord.coordinator import Coordinator, RoundRecord
from repro_torch.coord.worker import WorkerConfig, worker_entry
from repro_torch.core.failure import RestartBudget
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


@dataclass
class ClusterReport:
    """What a cluster run produced — the CLI and tests assert on this."""

    n_hosts: int
    rounds: list[RoundRecord]
    restarts: dict[int, int]                # host -> respawn count
    final_digests: dict[int, str]           # host -> state digest at FINISHED
    latest_committed: int | None
    log_path: str
    swept_dirs: list[str] = field(default_factory=list)
    # remote proxies: every worker->endpoint assignment in order (repeats
    # for a worker = it was rescheduled onto a survivor)
    proxy_placements: list[tuple[int, str]] = field(default_factory=list)
    killed_proxy_hosts: list[str] = field(default_factory=list)
    # SLO watchdog output (Alert.as_dict() shapes, in emission order) —
    # drills assert on the kinds, launch.cluster prints/serializes them
    alerts: list[dict] = field(default_factory=list)
    # per committed round, in order: {host: its PERSIST_DONE fields} — the
    # per-rank phase-1 times, persist, digests and kernel launches
    acks: list[dict[int, dict]] = field(default_factory=list)

    def alert_kinds(self) -> set[str]:
        return {a.get("kind", "") for a in self.alerts}

    @property
    def committed(self) -> list[RoundRecord]:
        return [r for r in self.rounds if r.status == "committed"]

    @property
    def aborted(self) -> list[RoundRecord]:
        return [r for r in self.rounds if r.status == "aborted"]

    def lockstep(self) -> bool:
        """All hosts finished with bit-identical state."""
        return (
            len(self.final_digests) == self.n_hosts
            and len(set(self.final_digests.values())) == 1
        )


class ClusterSupervisor:
    def __init__(
        self,
        cfgs: list[WorkerConfig],
        *,
        max_restarts: int = 3,
        mp_context: str = "spawn",
    ):
        self.cfgs = {c.host: c for c in cfgs}
        self.max_restarts = max_restarts
        self.ctx = mp.get_context(mp_context)
        self.procs: dict[int, mp.Process] = {}
        self.budgets: dict[int, RestartBudget] = {
            h: RestartBudget(max_restarts, what=f"host {h}") for h in self.cfgs
        }
        self.exited_clean: set[int] = set()

    @property
    def restarts(self) -> dict[int, int]:
        return {h: b.count for h, b in self.budgets.items()}

    def _spawn(self, cfg: WorkerConfig) -> None:
        p = self.ctx.Process(
            target=worker_entry, args=(cfg,), name=f"crum-worker-{cfg.host}"
        )
        p.start()
        self.procs[cfg.host] = p

    def start(self) -> None:
        for cfg in self.cfgs.values():
            self._spawn(cfg)

    @staticmethod
    def respawn_cfg(cfg: WorkerConfig) -> WorkerConfig:
        """The next incarnation: restore-on-join, no replayed injections."""
        return dataclasses.replace(
            cfg,
            restored=True,
            kill_at_step=None,
            die_after_persist_step=None,
            stall_at_step=None,
            corrupt_at_step=None,
        )

    def watch(self, done: threading.Event, *, deadline_s: float = 600.0) -> None:
        """Reap deaths and respawn until ``done`` (coordinator finished).

        Every pass reaps ANY dead-and-unprocessed process, however the
        death was first noticed. Gating the reap on "its sentinel was in
        this pass's ``sentinel_wait`` result" is a liveness race: a death
        landing between passes is reaped by the next ``is_alive()`` call
        (``waitpid``), which then excludes the process from the waited
        set — it would never be respawned and the cluster would hang at
        the barrier until the coordinator deadline.
        """
        deadline = time.monotonic() + deadline_s
        while not done.is_set():
            if time.monotonic() > deadline:
                raise TimeoutError("supervisor deadline exceeded")
            for host, p in list(self.procs.items()):
                if host in self.exited_clean or p.is_alive():
                    continue
                p.join()
                if p.exitcode == 0:
                    self.exited_clean.add(host)
                    continue
                self.budgets[host].spend(f"last exit code {p.exitcode}")
                cfg = self.respawn_cfg(self.cfgs[host])
                self.cfgs[host] = cfg
                self._spawn(cfg)
            live = [
                p.sentinel for h, p in self.procs.items()
                if h not in self.exited_clean and p.is_alive()
            ]
            if live:
                # nap until a sentinel fires (portable SIGCHLD) or 0.25s
                sentinel_wait(live, timeout=0.25)
            else:
                # every worker exited; wait on the coordinator to notice
                done.wait(timeout=0.25)

    def terminate(self) -> None:
        for p in self.procs.values():
            if p.is_alive():
                p.terminate()
        for p in self.procs.values():
            p.join(timeout=10)


def run_cluster(
    *,
    root: str,
    n_hosts: int,
    total_steps: int,
    ckpt_every: int,
    backend: str = "thread",
    loop: str = "numpy",
    device_runner: str = "inline",
    device: str = "cuda",
    program: dict | None = None,
    codec: str | None = None,
    chunk_bytes: int = 1 << 16,
    width: int = 64,
    rows: int | None = None,
    step_time_s: float = 0.0,
    keep_last: int = 0,
    heartbeat_timeout_s: float = 10.0,
    round_timeout_s: float = 120.0,
    deadline_s: float = 600.0,
    max_restarts: int = 3,
    kill_host: int | None = None,
    kill_at_step: int | None = None,
    die_after_persist_host: int | None = None,
    die_after_persist_step: int | None = None,
    straggle_host: int | None = None,
    straggle_s: float = 0.0,
    stall_host: int | None = None,
    stall_s: float = 0.0,
    stall_at_step: int | None = None,
    corrupt_host: int | None = None,
    corrupt_at_step: int | None = None,
    proxy_hosts: int = 0,
    proxy_transport: str = "stream",
    kill_proxy_host: int | None = None,
    kill_proxy_after_commits: int = 1,
    sweep: bool = True,
    obs_dir: str | None = None,
    watch_cfg=None,
    abort_on_critical: bool = False,
    device_capacity: str | None = None,
    persist_timeout_s: float | None = None,
) -> ClusterReport:
    """One coordinated run: coordinator + N supervised rank processes.

    Every rank computes on ``device`` (the card unless the caller asks for
    the CPU) the step program of its ``loop``, or ``program`` — an explicit
    step-program spec that overrides it.

    With ``proxy_hosts > 0`` (requires ``device_runner="proxy"``) the
    launcher also spawns that many proxy-host daemons
    (``repro_torch.remote.host``, on ``device``), registers their endpoints
    with the coordinator, and every rank's device proxy is *placed* on one
    of them over ``proxy_transport`` instead of being spawned locally.
    ``kill_proxy_host`` SIGKILLs daemon #i once ``kill_proxy_after_commits``
    rounds have committed — the cross-host failure drill: affected ranks
    are rescheduled onto a survivor and their API logs replayed there.

    Blocks until every rank reports FINISHED (ranks killed by injections
    are respawned and restored along the way) and returns the report.
    """
    if proxy_hosts and device_runner != "proxy":
        raise ValueError("proxy_hosts needs device_runner='proxy'")
    if kill_proxy_host is not None and not (
        0 <= kill_proxy_host < proxy_hosts
    ):
        raise ValueError(
            f"kill_proxy_host {kill_proxy_host} outside [0, {proxy_hosts})"
        )
    if kill_proxy_host is not None and proxy_hosts < 2:
        raise ValueError("the proxy-host kill drill needs a survivor (>= 2)")
    if obs_dir:
        # the launcher hosts the coordinator thread; ranks and proxy-host
        # daemons inherit the obs dir through the exported environment
        obs_trace.enable(obs_dir, "launcher")

    coord = Coordinator(
        root,
        n_hosts=n_hosts,
        heartbeat_timeout_s=heartbeat_timeout_s,
        round_timeout_s=round_timeout_s,
        keep_last=keep_last,
        watch_cfg=watch_cfg,
        abort_on_critical=abort_on_critical,
        obs_dir=obs_dir,
    ).start()
    host_addr, port = coord.address

    def cfg_for(h: int) -> WorkerConfig:
        kw = dict(
            host=h, n_hosts=n_hosts, coord_host=host_addr, coord_port=port,
            root=root, total_steps=total_steps, ckpt_every=ckpt_every,
            backend=backend, loop=loop, device_runner=device_runner,
            device=device, program=program,
            chunk_bytes=chunk_bytes, width=width, rows=rows,
            step_time_s=step_time_s, deadline_s=deadline_s,
        )
        if proxy_hosts:
            kw.update(proxy_placement="coord", proxy_transport=proxy_transport)
        if codec is not None:
            kw["codec"] = codec
        if device_capacity is not None:
            kw["device_capacity"] = device_capacity
        if persist_timeout_s is not None:
            kw["persist_timeout_s"] = persist_timeout_s
        if h == kill_host and kill_at_step is not None:
            kw["kill_at_step"] = kill_at_step
        if h == die_after_persist_host and die_after_persist_step is not None:
            kw["die_after_persist_step"] = die_after_persist_step
        if h == straggle_host and straggle_s:
            kw["straggle_s"] = straggle_s
        if h == stall_host and stall_s:
            kw.update(stall_s=stall_s, stall_at_step=stall_at_step)
        if h == corrupt_host and corrupt_at_step is not None:
            kw["corrupt_at_step"] = corrupt_at_step
        return WorkerConfig(**kw)

    sup = ClusterSupervisor(
        [cfg_for(h) for h in range(n_hosts)], max_restarts=max_restarts
    )

    coord_result: dict = {}
    daemons: list = []
    killed_proxy_hosts: list[str] = []

    def drive() -> None:
        try:
            coord.run(deadline_s=deadline_s)
        except Exception as e:  # surfaced after the watch loop unblocks
            coord_result["error"] = e

    def proxy_killer() -> None:
        # the cross-host drill: wait for real progress (committed rounds
        # prove proxies are serving traffic), then SIGKILL one daemon
        while not coord.done.is_set():
            if len(coord.committed_rounds()) >= kill_proxy_after_commits:
                d = daemons[kill_proxy_host]
                d.kill()
                killed_proxy_hosts.append(d.name)
                return
            time.sleep(0.05)

    coord_thread = threading.Thread(target=drive, name="coordinator", daemon=True)
    try:
        if proxy_hosts:
            from repro_torch.remote.host import ProxyHostHandle

            for i in range(proxy_hosts):
                d = ProxyHostHandle(f"ph{i}", device=device)
                daemons.append(d)
                d.start()
                coord.register_proxy_endpoint(d.name, *d.addr)
        coord_thread.start()
        if kill_proxy_host is not None:
            threading.Thread(
                target=proxy_killer, name="proxy-killer", daemon=True
            ).start()
        sup.start()
        sup.watch(coord.done, deadline_s=deadline_s)
    finally:
        sup.terminate()
        for d in daemons:
            d.terminate()
    coord_thread.join(timeout=30)
    if "error" in coord_result:
        raise coord_result["error"]

    swept = coord.sweep_uncommitted() if sweep else []
    obs_metrics.dump_if_enabled("launcher")
    return ClusterReport(
        n_hosts=n_hosts,
        rounds=coord.rounds,
        restarts=dict(sup.restarts),
        final_digests=coord.final_digests,
        latest_committed=coord.latest_committed,
        log_path=coord.log_path,
        swept_dirs=swept,
        proxy_placements=list(coord.placement.history),
        killed_proxy_hosts=killed_proxy_hosts,
        alerts=[a.as_dict() for a in coord.alerts],
        acks=list(coord.committed_acks),
    )
