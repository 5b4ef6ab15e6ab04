"""Cross-process tracing — Chrome ``trace_event`` JSONL shards.

Every process in the stack (app, proxy, proxy-host daemon, cluster
worker, coordinator, fork-persist child) appends events to its own
``trace-<process>-<pid>.jsonl`` shard inside one shared *obs dir*.
``repro.obs.report`` (the reference package; the shard format is shared) later merges the shards into a single
Perfetto-loadable ``.trace.json``.

Design constraints, in order:

1. **Disabled is free.** The module-global ``TRACER`` is ``None`` until
   :func:`enable` runs. Hot paths hoist ``tr = trace.get()`` and guard
   with ``if tr is not None`` — the disabled path is one global load and
   one identity test, no allocation, no call. ``benchmarks/obs_overhead``
   pins this.
2. **SIGKILL-tolerant.** Each event is one line written with a single
   ``os.write`` on an ``O_APPEND`` fd: lines from concurrent writers
   never interleave, and a kill mid-write tears at most the final line
   (the reader skips lines that fail to parse).
3. **Fork-safe.** The fork-persist child inherits the tracer; the first
   emit in the child notices the pid change and reopens a shard of its
   own, so every shard stays single-writer.
4. **One clock.** ``ts`` is ``time.time_ns() // 1000`` — the shared wall
   clock in microseconds — so shards from different processes (and
   different hosts sharing NTP) line up on one Perfetto timeline.
   Durations are measured with ``perf_counter`` and back-dated onto the
   wall clock (``X`` events), keeping span widths monotonic-accurate.

Correlation IDs ride as event ``args``: ``step`` (training step),
``epoch`` (SYNC epoch), ``inc`` (proxy incarnation = restarts spent),
``run`` (run id). They are threaded through the existing control frames
(REGISTER ``obs`` field), never through new side channels.

Causal contexts — ``{"trace", "span", "parent"}`` — name the span a frame's
receiver emits (:func:`span_context`, :func:`child_span`), so a merged
trace links the application's spans to the proxy work they caused. A frame
carries one only while tracing is on: untraced frames stay byte-identical.
:func:`root_span_id` derives a checkpoint round's root span id from its
trace id alone, so the coordinator and every rank agree on the root with
no exchange.
"""
from __future__ import annotations

import hashlib
import json
import os
import random
import threading
import time

ENV_DIR = "CRUM_OBS_DIR"
ENV_RUN = "CRUM_OBS_RUN"

__all__ = [
    "Tracer",
    "enable",
    "enable_from_env",
    "disable",
    "get",
    "ENV_DIR",
    "ENV_RUN",
    "root_span_id",
    "new_span_id",
    "round_trace_id",
    "span_context",
    "child_span",
    "ctx_args",
]


# -- causal trace contexts -------------------------------------------------


def new_span_id() -> int:
    """A fresh 63-bit span id (non-zero, msgpack/JSON-safe positive int)."""
    return random.getrandbits(63) | 1


def round_trace_id(step: int) -> str:
    """The trace id naming checkpoint round ``step``'s causal tree."""
    return f"round:{int(step)}"


def root_span_id(trace_id: str) -> int:
    """Deterministic root span id for a trace (the reference's, copied).

    Ranks reach a round boundary (and their proxies STEP toward it)
    *before* the coordinator opens the round, so the root id cannot be
    handed out over the wire — instead every process derives the same
    63-bit id from the trace id alone and parents its top-level spans to
    it with zero coordination.
    """
    h = hashlib.blake2s(trace_id.encode("utf-8"), digest_size=8).digest()
    return (int.from_bytes(h, "big") & ((1 << 63) - 1)) | 1


def span_context(
    trace_id: str, *, parent: int | None = None, span: int | None = None
) -> dict:
    """Build a context naming span ``span`` (fresh id if None) in a trace."""
    ctx: dict = {
        "trace": trace_id,
        "span": int(span) if span is not None else new_span_id(),
    }
    if parent is not None:
        ctx["parent"] = int(parent)
    return ctx


def child_span(ctx: dict | None) -> dict | None:
    """A fresh child context under ``ctx`` (None stays None — no-op path)."""
    if not ctx:
        return None
    return {"trace": ctx["trace"], "span": new_span_id(), "parent": ctx["span"]}


def ctx_args(ctx: dict | None) -> dict:
    """Flatten a context into span ``args`` keys ({} when no context)."""
    if not ctx or "span" not in ctx:
        return {}
    out = {"trace": ctx.get("trace"), "span": ctx["span"]}
    if ctx.get("parent") is not None:
        out["parent"] = ctx["parent"]
    return out


class _Span:
    """B/E pair as a context manager — for structural (non-hot) spans."""

    __slots__ = ("_tr", "_name", "_args")

    def __init__(self, tr: "Tracer", name: str, args: dict):
        self._tr = tr
        self._name = name
        self._args = args

    def __enter__(self) -> "_Span":
        self._tr.begin(self._name, **self._args)
        return self

    def __exit__(self, *exc) -> bool:
        self._tr.end(self._name)
        return False


class Tracer:
    def __init__(self, obs_dir: str, process: str, run_id: str | None = None):
        self.obs_dir = os.path.abspath(obs_dir)
        self.process = process
        self.run_id = run_id
        self._reopen_lock = threading.Lock()
        self._fd = -1
        self._pid = -1
        self._open_shard()

    # -- shard management --------------------------------------------------

    def _open_shard(self) -> None:
        os.makedirs(self.obs_dir, exist_ok=True)
        pid = os.getpid()
        self.path = os.path.join(
            self.obs_dir, f"trace-{self.process}-{pid}.jsonl"
        )
        self._fd = os.open(
            self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644
        )
        self._pid = pid
        # Perfetto process label; run id rides along for the reporter.
        self._write(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "ts": 0,
                "args": {"name": f"{self.process}:{pid}", "run": self.run_id},
            }
        )

    def _write(self, ev: dict) -> None:
        line = json.dumps(ev, separators=(",", ":"), default=str) + "\n"
        try:
            os.write(self._fd, line.encode("utf-8"))
        except OSError:
            pass  # tracing must never take the traced process down

    def _emit(self, ev: dict) -> None:
        if ev["pid"] != self._pid:
            # Forked child: inherited fd points at the parent's shard and
            # the inherited lock state is garbage — rebuild both. Only the
            # (single) surviving thread runs here, so this is race-free.
            self._reopen_lock = threading.Lock()
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._open_shard()
        self._write(ev)

    # -- event API ---------------------------------------------------------

    def instant(self, name: str, **args) -> None:
        self._emit(
            {
                "name": name,
                "ph": "i",
                "s": "p",
                "pid": os.getpid(),
                "tid": threading.get_native_id(),
                "ts": time.time_ns() // 1000,
                "args": args,
            }
        )

    def complete(self, name: str, t0: float, **args) -> None:
        """``X`` event ending now; ``t0`` is a ``perf_counter()`` at start.

        Built for hot paths that already measured ``t0`` for their own
        stats — the span costs one dict + one write, no extra clock reads
        at the start of the measured region.
        """
        dur = int((time.perf_counter() - t0) * 1e6)
        self._emit(
            {
                "name": name,
                "ph": "X",
                "pid": os.getpid(),
                "tid": threading.get_native_id(),
                "ts": time.time_ns() // 1000 - dur,
                "dur": dur,
                "args": args,
            }
        )

    def begin(self, name: str, *, ts_us: int | None = None, **args) -> None:
        """``B`` event at ``ts_us`` (wall-clock microseconds), or now."""
        self._emit(
            {
                "name": name,
                "ph": "B",
                "pid": os.getpid(),
                "tid": threading.get_native_id(),
                "ts": time.time_ns() // 1000 if ts_us is None else int(ts_us),
                "args": args,
            }
        )

    def end(self, name: str, *, ts_us: int | None = None, **args) -> None:
        """``E`` event at ``ts_us`` (wall-clock microseconds), or now."""
        ev = {
            "name": name,
            "ph": "E",
            "pid": os.getpid(),
            "tid": threading.get_native_id(),
            "ts": time.time_ns() // 1000 if ts_us is None else int(ts_us),
        }
        if args:
            ev["args"] = args
        self._emit(ev)

    def span(self, name: str, **args) -> _Span:
        return _Span(self, name, args)

    def counter(self, name: str, **values) -> None:
        self._emit(
            {
                "name": name,
                "ph": "C",
                "pid": os.getpid(),
                "tid": threading.get_native_id(),
                "ts": time.time_ns() // 1000,
                "args": values,
            }
        )


# -- module-global switch --------------------------------------------------

TRACER: Tracer | None = None


def get() -> Tracer | None:
    """The enabled tracer, or None. Hot paths hoist this and null-check."""
    return TRACER


def enable(
    obs_dir: str,
    process: str,
    run_id: str | None = None,
    *,
    set_env: bool = True,
) -> Tracer:
    """Turn tracing on for this process (idempotent; first enable wins).

    With ``set_env`` (the default for launcher processes), exports
    ``CRUM_OBS_DIR``/``CRUM_OBS_RUN`` so spawned children — workers,
    proxies, proxy-host daemons — pick the same obs dir up via
    :func:`enable_from_env`.
    """
    global TRACER
    if TRACER is not None:
        return TRACER
    run_id = (
        run_id
        or os.environ.get(ENV_RUN)
        or f"run-{os.getpid()}-{time.time_ns() // 1_000_000_000}"
    )
    TRACER = Tracer(obs_dir, process, run_id)
    if set_env:
        os.environ[ENV_DIR] = TRACER.obs_dir
        os.environ[ENV_RUN] = run_id
    return TRACER


def enable_from_env(process: str) -> Tracer | None:
    """Child-process hook: enable iff the launcher exported an obs dir."""
    d = os.environ.get(ENV_DIR)
    if d and TRACER is None:
        return enable(
            d, process, run_id=os.environ.get(ENV_RUN), set_env=False
        )
    return TRACER


def disable() -> None:
    """Turn tracing off (tests); drops the env propagation too."""
    global TRACER
    t, TRACER = TRACER, None
    if t is not None:
        try:
            os.close(t._fd)
        except OSError:
            pass
    os.environ.pop(ENV_DIR, None)
    os.environ.pop(ENV_RUN, None)


def instant(name: str, **args) -> None:
    t = TRACER
    if t is not None:
        t.instant(name, **args)


def counter(name: str, **values) -> None:
    t = TRACER
    if t is not None:
        t.counter(name, **values)
