"""Proxy placement: which proxy host serves which worker.

The cluster coordinator owns a :class:`PlacementMap`. Proxy-host daemons
(or the launcher on their behalf) *register* endpoints; workers *acquire*
an assignment over a short-lived side-channel connection speaking the
coordinator's PROXY_ENDPOINT handshake:

    -> {type: PROXY_ENDPOINT, op: "register", name, addr, port}
    <- {type: PROXY_ENDPOINT, op: "registered", name}

    -> {type: PROXY_ENDPOINT, op: "acquire", worker, failed?, exclude?}
    <- {type: PROXY_ENDPOINT, name, addr, port}         # assignment
    <- {type: PROXY_ENDPOINT, error: "no live proxy endpoints"}

``failed`` names an endpoint the worker just watched die: the coordinator
marks it dead (every other worker on it will be reassigned too) and
answers with a survivor — the reschedule half of CRAC's restart protocol.
The side channel is deliberately NOT the worker's main coordinator
connection: a reassignment mid-round must never steal DRAIN/COMMIT frames
from the barrier loop.

Assignment is sticky + least-loaded: a worker keeps its endpoint while it
lives; fresh or rescheduled workers land on the live endpoint currently
serving the fewest workers.
"""
from __future__ import annotations

import socket
import time
from collections import Counter
from dataclasses import dataclass, field

from repro_torch.coord.protocol import MSG_PROXY_ENDPOINT, connect

# NOTE: repro_torch.proxy.protocol is imported lazily inside CoordEndpointProvider
# — this module sits on the coordinator's import path, and proxy.protocol
# re-exports the coord framing (importing it here would be circular).


@dataclass
class ProxyEndpoint:
    name: str
    addr: str
    port: int
    alive: bool = True


@dataclass
class PlacementMap:
    """Endpoint registry + worker->endpoint assignment (coordinator-owned)."""

    endpoints: dict[str, ProxyEndpoint] = field(default_factory=dict)
    assignment: dict[int, str] = field(default_factory=dict)
    #: every assignment ever made, in order — the audit trail tests and the
    #: cluster report consume ("did the reschedule actually happen?")
    history: list[tuple[int, str]] = field(default_factory=list)

    def register(self, name: str, addr: str, port: int) -> ProxyEndpoint:
        ep = ProxyEndpoint(str(name), str(addr), int(port))
        self.endpoints[ep.name] = ep
        return ep

    def report_dead(self, name: str) -> None:
        ep = self.endpoints.get(name)
        if ep is not None:
            ep.alive = False

    def live(self) -> list[ProxyEndpoint]:
        return [e for e in self.endpoints.values() if e.alive]

    def loads(self) -> Counter:
        """{endpoint name: workers currently assigned to it}."""
        return Counter(
            n for n in self.assignment.values()
            if n in self.endpoints and self.endpoints[n].alive
        )

    def assign(
        self, worker: int, *, exclude: tuple[str, ...] = ()
    ) -> ProxyEndpoint | None:
        """Sticky assignment; falls over to the least-loaded live survivor.

        When NO live endpoint remains outside ``exclude``, dead-marked ones
        are offered as a last resort: "dead" can be a transient verdict (a
        sync timeout under load reports a healthy daemon dead), and trying
        a possibly-alive endpoint beats failing the worker outright — the
        runner's restart budget bounds the retries either way. Returns
        None only when every registered endpoint is excluded.
        """
        worker = int(worker)
        cur = self.endpoints.get(self.assignment.get(worker, ""))
        if cur is not None and cur.alive and cur.name not in exclude:
            return cur
        loads = self.loads()
        candidates = [e for e in self.live() if e.name not in exclude]
        if not candidates:
            candidates = [
                e for e in self.endpoints.values() if e.name not in exclude
            ]
        if not candidates:
            return None
        ep = min(candidates, key=lambda e: (loads[e.name], e.name))
        self.assignment[worker] = ep.name
        self.history.append((worker, ep.name))
        return ep


# -- the worker-side handshake --------------------------------------------------

def _exchange(
    coord_addr: tuple[str, int], timeout_s: float, **fields
) -> dict:
    """One PROXY_ENDPOINT request/reply over a fresh side-channel
    connection (shared by acquire and register — the timeout/EOF/match
    semantics must never drift between them)."""
    conn = connect(coord_addr, timeout=timeout_s)
    try:
        conn.settimeout(1.0)
        conn.send(MSG_PROXY_ENDPOINT, **fields)
        deadline = time.monotonic() + timeout_s
        while True:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"coordinator did not answer PROXY_ENDPOINT "
                    f"{fields.get('op')}"
                )
            try:
                msg = conn.recv()
            except (socket.timeout, TimeoutError):
                continue
            if msg is None:
                raise ConnectionError(
                    "coordinator closed the PROXY_ENDPOINT side channel"
                )
            if msg.get("type") == MSG_PROXY_ENDPOINT:
                return msg
    finally:
        conn.close()


def request_proxy_endpoint(
    coord_addr: tuple[str, int],
    *,
    worker: int,
    failed: str | None = None,
    exclude: tuple[str, ...] = (),
    timeout_s: float = 30.0,
) -> dict | None:
    """Acquire (or re-acquire after a death) a proxy endpoint assignment.

    Returns the assignment dict ({name, addr, port}) or None when the
    coordinator has no endpoint to offer.
    """
    msg = _exchange(
        coord_addr, timeout_s,
        op="acquire", worker=int(worker), failed=failed,
        exclude=list(exclude),
    )
    if msg.get("error") or not msg.get("addr"):
        return None
    return {"name": msg["name"], "addr": msg["addr"], "port": int(msg["port"])}


def register_proxy_endpoint(
    coord_addr: tuple[str, int],
    *,
    name: str,
    addr: str,
    port: int,
    timeout_s: float = 30.0,
) -> None:
    """Announce one proxy-host endpoint to the coordinator (the daemon- or
    launcher-side half of the handshake)."""
    _exchange(
        coord_addr, timeout_s,
        op="register", name=name, addr=addr, port=int(port),
    )


class CoordEndpointProvider:
    """``ProxyRunner.endpoint_provider`` backed by the coordinator.

    ``provider(failed=False)`` acquires this worker's assignment;
    ``provider(failed=True)`` reports the current endpoint dead, excludes
    it, and acquires a survivor — the runner then replays the API log
    against the new host. Only the *most recently failed* endpoint is
    excluded (not every endpoint that ever failed): a "death" can be a
    transient verdict, and with the coordinator's last-resort fallback a
    flagged-but-healthy daemon stays reachable instead of being shut out
    of the pool forever. Raises :class:`ProxyDiedError` when the
    coordinator has nothing to offer (the runner's restart budget turns
    that into a surfaced failure instead of a hang).
    """

    def __init__(
        self,
        coord_addr: tuple[str, int],
        worker: int,
        *,
        timeout_s: float = 30.0,
    ):
        self.coord_addr = tuple(coord_addr)
        self.worker = int(worker)
        self.timeout_s = timeout_s
        self.current: str | None = None
        self.last_failed: str | None = None

    def __call__(self, *, failed: bool = False) -> tuple[str, int]:
        from repro_torch.proxy.protocol import ProxyDiedError

        report = None
        if failed and self.current is not None:
            report = self.last_failed = self.current
            self.current = None
        exclude = (self.last_failed,) if self.last_failed else ()
        try:
            got = request_proxy_endpoint(
                self.coord_addr,
                worker=self.worker,
                failed=report,
                exclude=exclude,
                timeout_s=self.timeout_s,
            )
        except (OSError, TimeoutError, ConnectionError) as e:
            raise ProxyDiedError(
                f"coordinator unreachable for proxy placement: {e}"
            ) from e
        if got is None:
            raise ProxyDiedError(
                f"no proxy endpoint available (excluded {exclude})"
            )
        self.current = got["name"]
        return got["addr"], got["port"]
