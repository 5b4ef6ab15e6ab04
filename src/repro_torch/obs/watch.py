"""SLO watchdog — live health rules evaluated per heartbeat / per round.

CRUM's value proposition is that checkpointing overhead stays inside a
small envelope *while the run is under way*; this module is the rule
engine that notices, live, when it does not. The coordinator feeds it
every signal it already has (heartbeats + piggybacked metric deltas,
round records, deaths, persist acks) plus a periodic
:func:`repro_torch.obs.leakcheck.sample`, and each rule emits a versioned
:class:`Alert` record:

    ======================  ==========  ==================================
    kind                    severity    fires when
    ======================  ==========  ==================================
    stall_ratio             warning     round stall_us over the ceiling
                                        relative to the round duration
    heartbeat_skew          warning     a host's reported step lags the
                                        front-runner by > max_step_skew
    clock_skew              warning     a host's heartbeat wall clock is
                                        > max_clock_skew_s off the
                                        coordinator's (re-arms when the
                                        clock recovers)
    round_abort             warning     a checkpoint round aborted
    abort_rate              critical    >= abort_rate_window aborts with
                                        no commit in between
    straggler               warning     the straggler policy flagged hosts
                                        at a committed round
    worker_death            warning     a worker was kicked (EOF/timeout)
    proxy_host_death        warning     a worker reported its proxy
                                        endpoint dead (reschedule path)
    fault_rate              warning     uvm fault counter rate spiked
                                        above fault_rate_max per second
    fd_leak_trend           warning     fd count grew monotonically over
                                        the sampled window
    shm_leak_trend          warning     /dev/shm entries grew over window
    digest_divergence       critical    two hosts acked the same round
                                        with different state digests;
                                        when per-chunk digests flowed,
                                        the alert names the first chunk
                                        that forked and the culprit host
    ======================  ==========  ==================================

Alerts flow through every observability channel at once: the journal
(``alert`` lines in CLUSTER_LOG.jsonl, typed as
:class:`repro_torch.obs.journal.AlertLine`), a trace instant, the metrics
registry (``watch_alerts_total``), and an optional ``on_alert`` callback
— the coordinator uses the callback for the abort-on-critical policy.

The watchdog is pure bookkeeping over numbers already in hand: no I/O of
its own beyond the (rate-limited) leakcheck sample, so it is safe to run
on the coordinator event-loop thread every tick.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, asdict
from typing import Callable

from repro_torch.obs import leakcheck

ALERT_SCHEMA = "crum-alert/1"

SEV_INFO = "info"
SEV_WARNING = "warning"
SEV_CRITICAL = "critical"

__all__ = [
    "ALERT_SCHEMA",
    "Alert",
    "WatchConfig",
    "Watchdog",
]


@dataclass
class Alert:
    """One rule violation — the versioned record every channel carries."""

    kind: str
    severity: str = SEV_WARNING
    host: int | None = None
    step: int | None = None
    value: float | None = None
    limit: float | None = None
    message: str = ""
    # divergence provenance: the first chunk (tree path + chunk index)
    # whose per-host digests forked — only digest_divergence sets these
    chunk: str | None = None
    chunk_index: int | None = None
    alert_schema: str = ALERT_SCHEMA

    def as_dict(self) -> dict:
        return {k: v for k, v in asdict(self).items() if v is not None}


@dataclass
class WatchConfig:
    """Rule thresholds. Defaults are intentionally lenient — the happy
    path of every existing drill must stay alert-free; drills that
    *inject* a failure are what should trip them."""

    # round rules
    stall_ratio_max: float = 0.5        # sum(stall_us)/1e6 vs round_s
    abort_rate_window: int = 3          # consecutive aborts => critical
    # heartbeat rules
    max_step_skew: int = 0              # 0 = disabled (lockstep barriers
    #                                     make persistent skew visible as
    #                                     stalls; enable for async loops)
    # wall-clock skew rule: a host's heartbeat ``wt`` vs the coordinator's
    # own clock at receipt (0 = disabled). Re-arming: recovers when the
    # host's clock comes back inside the limit.
    max_clock_skew_s: float = 0.0
    # uvm fault/eviction spike rule (per-second rate over the heartbeat
    # series; 0 disables — oversubscribed runs set their own budget)
    fault_rate_max: float = 0.0
    fault_metrics: tuple = ("uvm_faults", "uvm_evictions")
    # leak-trend rule: sample every interval, alert when the count grew
    # monotonically across the whole window by more than the allowance
    leak_sample_every_s: float = 2.0
    leak_window: int = 5
    fd_leak_allowance: int = 8
    shm_leak_allowance: int = 4
    # digest divergence needs at least this many reporting hosts
    divergence_min_hosts: int = 2


class Watchdog:
    """Evaluates :class:`WatchConfig` rules over the coordinator's feed."""

    def __init__(
        self,
        cfg: WatchConfig | None = None,
        *,
        on_alert: Callable[[Alert], None] | None = None,
        sampler: Callable[[], dict] | None = None,
    ):
        self.cfg = cfg or WatchConfig()
        self.on_alert = on_alert
        # default sampler excludes obs-owned fds (trace shards, journal):
        # a traced run must not trip the fd-leak rule just by tracing
        self._sampler = sampler or leakcheck.watchdog_sample
        self.alerts: list[Alert] = []
        self._steps: dict[int, int] = {}         # host -> last heartbeat step
        self._skew_alerted: set[int] = set()
        self._clock_alerted: set[int] = set()
        self._consecutive_aborts = 0
        self._abort_rate_alerted = False
        self._fault_last: dict[tuple[int, str], tuple[float, float]] = {}
        self._leak = leakcheck.PeriodicAudit(
            interval_s=self.cfg.leak_sample_every_s,
            window=self.cfg.leak_window,
            sampler=self._sampler,
        )
        self._leak_alerted: set[str] = set()
        self._digests: dict[int, dict[int, str]] = {}  # step -> host -> digest
        self._diverged_steps: set[int] = set()
        # divergences detected but held back for a determinable culprit
        self._pending_divergence: set[int] = set()
        # per-chunk provenance: step -> host -> {path: [chunk digests]}
        self._chunks: dict[int, dict[int, dict[str, list[int]]]] = {}
        # last unanimously-agreed digest per (path, chunk index), recorded
        # at committed rounds — lets the divergence alert name the culprit
        # host exactly instead of guessing by minority vote
        self._chunk_baseline: dict[tuple[str, int], int] = {}

    # -- emission ----------------------------------------------------------

    def _emit(self, alert: Alert) -> Alert:
        self.alerts.append(alert)
        if self.on_alert is not None:
            self.on_alert(alert)
        return alert

    @property
    def critical(self) -> list[Alert]:
        return [a for a in self.alerts if a.severity == SEV_CRITICAL]

    def kinds(self) -> set[str]:
        return {a.kind for a in self.alerts}

    # -- heartbeat-path rules ---------------------------------------------

    def on_heartbeat(self, host: int, step: int,
                     wt: float | None = None) -> None:
        self._steps[int(host)] = int(step)
        if self.cfg.max_clock_skew_s > 0 and wt is not None:
            h = int(host)
            skew = abs(float(wt) - time.time())
            if skew > self.cfg.max_clock_skew_s:
                if h not in self._clock_alerted:
                    self._clock_alerted.add(h)
                    self._emit(Alert(
                        "clock_skew", SEV_WARNING, host=h, step=int(step),
                        value=round(skew, 3),
                        limit=self.cfg.max_clock_skew_s,
                        message=f"host {h} heartbeat wall clock is "
                                f"{skew:.1f}s off the coordinator's",
                    ))
            else:
                self._clock_alerted.discard(h)  # re-arm once back in sync
        if self.cfg.max_step_skew <= 0 or len(self._steps) < 2:
            return
        front = max(self._steps.values())
        for h, s in self._steps.items():
            lag = front - s
            if lag > self.cfg.max_step_skew and h not in self._skew_alerted:
                self._skew_alerted.add(h)
                self._emit(Alert(
                    "heartbeat_skew", SEV_WARNING, host=h, step=s,
                    value=float(lag), limit=float(self.cfg.max_step_skew),
                    message=f"host {h} at step {s} lags front-runner "
                            f"at {front}",
                ))
            elif lag <= self.cfg.max_step_skew:
                self._skew_alerted.discard(h)  # re-arm once caught up

    def on_metric_point(self, host: int, metric: str, t: float,
                        value: float) -> None:
        """Rate rules over piggybacked series (uvm faults/evictions)."""
        if self.cfg.fault_rate_max <= 0:
            return
        if metric not in self.cfg.fault_metrics:
            return
        key = (int(host), metric)
        prev = self._fault_last.get(key)
        self._fault_last[key] = (t, value)
        if prev is None:
            return
        dt = t - prev[0]
        if dt <= 0:
            return
        rate = (value - prev[1]) / dt
        if rate > self.cfg.fault_rate_max:
            self._emit(Alert(
                "fault_rate", SEV_WARNING, host=int(host),
                value=round(rate, 1), limit=self.cfg.fault_rate_max,
                message=f"{metric} rate {rate:.0f}/s on host {host}",
            ))

    def tick(self, now: float | None = None) -> dict | None:
        """Periodic (coordinator event-loop tick): leak-trend sampling.

        Returns the leakcheck sample taken this tick (None when the
        interval has not elapsed) so the caller can publish the raw
        fd//dev/shm counts as live metric series — the soak verdict's
        leak-trend check reads those series, not just the alerts.
        """
        s = self._leak.maybe_sample(now)
        if s is None:
            return None
        for kind, count_key, allowance in (
            ("fd_leak_trend", "fd", self.cfg.fd_leak_allowance),
            ("shm_leak_trend", "shm", self.cfg.shm_leak_allowance),
        ):
            growth = self._leak.trend(count_key)
            if growth is None:
                continue
            if growth > allowance and kind not in self._leak_alerted:
                self._leak_alerted.add(kind)
                self._emit(Alert(
                    kind, SEV_WARNING, value=float(growth),
                    limit=float(allowance),
                    message=f"{count_key} count grew by {growth} over "
                            f"{self._leak.window} samples",
                ))
            elif growth is not None and growth <= allowance:
                self._leak_alerted.discard(kind)  # re-arm after recovery
        return s

    # -- round-path rules --------------------------------------------------

    def on_persist_done(self, host: int, step: int,
                        state_digest: str | None,
                        chunk_digests: dict[str, list[int]] | None = None,
                        ) -> None:
        """Cross-worker divergence: every host acking the same round must
        hold the same (replicated, lockstep) state.

        When the ack also carries per-chunk ``chunk_digests`` (full-state
        fused digests, comparable across hosts), a divergence alert names
        the first chunk that forked and the culprit host instead of just
        reporting that the whole-state digests differ."""
        if not state_digest:
            return
        step = int(step)
        if chunk_digests:
            self._chunks.setdefault(step, {})[int(host)] = chunk_digests
        per_round = self._digests.setdefault(step, {})
        per_round[int(host)] = state_digest
        if (
            len(per_round) >= self.cfg.divergence_min_hosts
            and len(set(per_round.values())) > 1
            and step not in self._diverged_steps
        ):
            chunk, index, culprit = self._first_divergent_chunk(step)
            if (chunk is not None and culprit is None
                    and step not in self._pending_divergence):
                # provenance is flowing but the culprit is still ambiguous
                # (e.g. a 1-vs-1 split with more acks on the way): hold the
                # alert until a later ack breaks the tie or the round
                # settles — divergence itself is already certain, only the
                # attribution improves by waiting
                self._pending_divergence.add(step)
                return
            self._pending_divergence.discard(step)
            self._emit_divergence(step)

    def _emit_divergence(self, step: int) -> None:
        per_round = self._digests.get(step) or {}
        self._diverged_steps.add(step)
        chunk, index, culprit = self._first_divergent_chunk(step)
        msg = (f"hosts disagree on state at step {step}: "
               f"{sorted(set(per_round.values()))}")
        if chunk is not None:
            who = (f"host {culprit}" if culprit is not None
                   else "an unidentified host")
            msg = (f"hosts disagree on state at step {step}: first "
                   f"divergent chunk {chunk}[{index}] forked at step "
                   f"{step} on {who}")
        self._emit(Alert(
            "digest_divergence", SEV_CRITICAL, step=step,
            host=culprit,
            value=float(len(set(per_round.values()))),
            chunk=chunk, chunk_index=index,
            message=msg,
        ))

    def _first_divergent_chunk(
        self, step: int,
    ) -> tuple[str | None, int | None, int | None]:
        """First (sorted path, lowest index) chunk whose digests differ
        across the hosts that reported tables for ``step``, plus the
        culprit host: the one off the committed baseline when one exists,
        else the minority digest's host (None on an unbreakable tie)."""
        tables = self._chunks.get(step) or {}
        if len(tables) < 2:
            return None, None, None
        paths = sorted(set().union(*(t.keys() for t in tables.values())))
        for path in paths:
            per_host = {h: t[path] for h, t in tables.items() if path in t}
            if len(per_host) < 2:
                continue
            n = min(len(v) for v in per_host.values())
            for i in range(n):
                vals = {h: v[i] for h, v in per_host.items()}
                if len(set(vals.values())) <= 1:
                    continue
                base = self._chunk_baseline.get((path, i))
                if base is not None:
                    # trust the baseline only when exactly one host left
                    # it: training legitimately moves every live chunk
                    # off the last committed digest, so "off baseline"
                    # alone cannot separate culprit from victim
                    off = sorted(h for h, d in vals.items() if d != base)
                    if len(off) == 1:
                        return path, i, off[0]
                # blame the minority digest, if there is one
                counts: dict[int, list[int]] = {}
                for h, d in vals.items():
                    counts.setdefault(d, []).append(h)
                minority = sorted(counts.values(), key=len)
                if len(minority) > 1 and len(minority[0]) < len(minority[1]):
                    return path, i, sorted(minority[0])[0]
                return path, i, None
        return None, None, None

    def on_round(self, rec: dict) -> None:
        """One round record (RoundRecord.as_dict() shape), at decision."""
        step = rec.get("step")
        if step is not None and int(step) in self._pending_divergence:
            # the round settled with the culprit still ambiguous: emit the
            # held divergence now, with whatever provenance arrived
            self._pending_divergence.discard(int(step))
            self._emit_divergence(int(step))
        if rec.get("status") == "aborted":
            self._consecutive_aborts += 1
            self._emit(Alert(
                "round_abort", SEV_WARNING, step=step,
                message=str(rec.get("reason", "")),
            ))
            if (
                self._consecutive_aborts >= self.cfg.abort_rate_window
                and not self._abort_rate_alerted
            ):
                self._abort_rate_alerted = True
                self._emit(Alert(
                    "abort_rate", SEV_CRITICAL, step=step,
                    value=float(self._consecutive_aborts),
                    limit=float(self.cfg.abort_rate_window),
                    message=f"{self._consecutive_aborts} consecutive "
                            f"aborted rounds",
                ))
            return
        self._consecutive_aborts = 0
        self._abort_rate_alerted = False
        if step is not None:  # committed: the round's digest set is settled
            self._digests.pop(int(step), None)
            tables = self._chunks.pop(int(step), None)
            if tables and int(step) not in self._diverged_steps:
                # all hosts agreed this round: their chunk digests become
                # the baseline future divergences are judged against
                for path in set().union(*(t.keys() for t in tables.values())):
                    cols = [t[path] for t in tables.values() if path in t]
                    for i, d in enumerate(cols[0]):
                        if all(len(c) > i and c[i] == d for c in cols):
                            self._chunk_baseline[(path, i)] = d
        round_s = float(rec.get("round_s") or 0.0)
        stall_s = float(rec.get("stall_us") or 0.0) / 1e6
        if round_s > 0 and stall_s / round_s > self.cfg.stall_ratio_max:
            self._emit(Alert(
                "stall_ratio", SEV_WARNING, step=step,
                value=round(stall_s / round_s, 3),
                limit=self.cfg.stall_ratio_max,
                message=f"sync stall {stall_s:.3f}s vs round "
                        f"{round_s:.3f}s",
            ))
        stragglers = rec.get("stragglers") or []
        for h in stragglers:
            self._emit(Alert(
                "straggler", SEV_WARNING, host=int(h), step=step,
                message=f"host {h} persist duration is an outlier",
            ))

    # -- membership rules --------------------------------------------------

    def on_death(self, host: int, reason: str) -> None:
        self._steps.pop(int(host), None)
        self._emit(Alert(
            "worker_death", SEV_WARNING, host=int(host),
            message=reason,
        ))

    def on_proxy_host_death(self, name: str, worker: int) -> None:
        self._emit(Alert(
            "proxy_host_death", SEV_WARNING, host=int(worker),
            message=f"proxy endpoint {name!r} reported dead by worker "
                    f"{worker}",
        ))
