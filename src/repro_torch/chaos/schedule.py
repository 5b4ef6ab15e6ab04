"""Seeded, reproducible chaos schedules.

The reference's ``repro.chaos.schedule``, framework-free, copied: the formats it reads
and writes are the reference's.

A soak run's fault sequence must be *replayable*: the same seed (and the
same cluster shape) produces exactly the same planned injections, at the
same offsets, with the same parameters — so a failing scorecard can be
re-run and the same faults land in the same order. Everything random
flows through one ``random.Random(seed)``; nothing reads the clock.

The builder enforces the structural safety limits the cluster needs to
*converge* under chaos (the soak's whole point is that it does):

* worker SIGKILLs per host stay within the restart budget,
* proxy-host kills always leave a survivor to reschedule onto,
* a SIGSTOPped (partitioned) daemon is never also killed,
* the tail of the run is fault-free so the final rounds commit and the
  bit-identical convergence check has something to check.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field

__all__ = ["PlannedInjection", "build_schedule"]

#: kinds that need no proxy-host daemons
_WORKER_KINDS = ("kill_worker", "torn_frame", "disk_full", "clock_skew")
_PROXY_KINDS = ("kill_proxy_host", "partition")


@dataclass(frozen=True)
class PlannedInjection:
    offset_s: float          # seconds after the cluster came up
    kind: str
    params: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {"offset_s": self.offset_s, "kind": self.kind,
                "params": dict(self.params)}


def build_schedule(
    *,
    seed: int,
    duration_s: float,
    n_hosts: int,
    n_proxy_hosts: int = 0,
    kinds: tuple | list | None = None,
    warmup_s: float = 8.0,
    spacing_s: float = 7.0,
    tail_s: float | None = None,
    max_worker_kills_per_host: int = 1,
    partition_window_s: float = 20.0,
) -> list[PlannedInjection]:
    """Plan a deterministic injection sequence for one soak run.

    ``kinds`` restricts the menu (default: everything the cluster shape
    supports — proxy-host faults need >= 2 daemons so a survivor
    exists). Offsets land on a jittered ``spacing_s`` grid between
    ``warmup_s`` and ``duration_s - tail_s``.
    """
    rng = random.Random(int(seed))
    duration_s = float(duration_s)
    if tail_s is None:
        # fault-free convergence window: a third of the run, at least
        # one full round of recovery
        tail_s = max(20.0, duration_s / 3.0)
    menu = list(kinds) if kinds else list(_WORKER_KINDS) + (
        list(_PROXY_KINDS) if n_proxy_hosts >= 2 else []
    )
    for k in menu:
        if k in _PROXY_KINDS and n_proxy_hosts < 2:
            raise ValueError(
                f"{k!r} needs >= 2 proxy hosts (a survivor to "
                f"reschedule onto); got {n_proxy_hosts}"
            )
    worker_kills = {h: 0 for h in range(n_hosts)}
    ph_killed: set[int] = set()
    plan: list[PlannedInjection] = []
    t = float(warmup_s)
    while t < duration_s - tail_s:
        offset = round(t + rng.uniform(0.0, spacing_s / 2.0), 3)
        for _ in range(8):  # bounded retries against exhausted caps
            kind = rng.choice(menu)
            if kind == "kill_worker":
                host = rng.randrange(n_hosts)
                if worker_kills[host] >= max_worker_kills_per_host:
                    continue
                worker_kills[host] += 1
                plan.append(PlannedInjection(offset, kind, {"host": host}))
            elif kind == "kill_proxy_host":
                alive = [i for i in range(n_proxy_hosts)
                         if i not in ph_killed]
                if len(alive) < 2:  # always leave a survivor
                    continue
                idx = rng.choice(alive)
                ph_killed.add(idx)
                plan.append(PlannedInjection(offset, kind, {"index": idx}))
            elif kind == "partition":
                alive = [i for i in range(n_proxy_hosts)
                         if i not in ph_killed]
                if len(alive) < 2:
                    continue
                idx = rng.choice(alive)
                plan.append(PlannedInjection(
                    offset, kind,
                    {"index": idx, "window_s": float(partition_window_s)},
                ))
            elif kind == "disk_full":
                host = rng.randrange(n_hosts)
                plan.append(PlannedInjection(
                    offset, kind,
                    {"host": host, "quota_bytes": 1,
                     "duration_s": round(rng.uniform(4.0, 8.0), 3)},
                ))
            elif kind == "clock_skew":
                host = rng.randrange(n_hosts)
                plan.append(PlannedInjection(
                    offset, kind,
                    {"host": host,
                     "skew_s": round(rng.uniform(60.0, 300.0), 3),
                     "duration_s": round(rng.uniform(4.0, 8.0), 3)},
                ))
            else:  # torn_frame
                plan.append(PlannedInjection(offset, kind, {}))
            break
        t += spacing_s
    return plan
