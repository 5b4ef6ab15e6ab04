"""The proxy-host daemon: serves device-proxy sessions over TCP.

One daemon process per (simulated) machine. It listens on a port and, for
every accepted connection, runs a full :class:`~repro_torch.proxy.service.
ProxyService` session on a thread — the same service class a locally
spawned proxy runs, now reachable from any host. Applications connect via
``DeviceProxy(endpoint=(addr, port))``; which application lands on which
daemon is the placement layer's decision (``repro_torch.remote.placement``).

The daemon computes on the card (``device="cuda"``) unless asked for the
CPU; with ``"cuda"`` and no card it raises before it binds, so no endpoint
is ever advertised that cannot serve. Sessions share the process: the
determinism settings are applied once, before the first CUDA call, and each
session counts the kernel launches of its own thread.

Killing the daemon (SIGKILL — the cross-host failure drill) severs every
session it hosts at once: each affected rank sees ProxyDiedError, asks
the coordinator for a survivor, and replays its API log there.

Standalone use (e.g. for ``launch/serve.py --proxy-endpoint``)::

    PYTHONPATH=src python -m repro_torch.remote.host --port 7070
    PYTHONPATH=src python -m repro_torch.remote.host --device cpu --port 7070
"""
from __future__ import annotations

import argparse
import multiprocessing as mp
import queue
import socket
import sys
import threading
import time
from dataclasses import dataclass

DEVICES = ("cuda", "cpu")
SESSION_TIMEOUT_S = 1.0  # a session socket's timeout, as a local proxy's
START_TIMEOUT_S = 120.0  # spawn, torch import and CUDA init, to the bound port


@dataclass
class ProxyHostConfig:
    bind: str = "127.0.0.1"
    port: int = 0                       # 0: OS-assigned (reported via queue)
    device: str = "cuda"                # "cuda" | "cpu"


def _check_device(device: str) -> None:
    """Raise unless the daemon can compute on ``device``."""
    import torch

    if device not in DEVICES:
        raise ValueError(f"proxy host device must be one of {DEVICES}, got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "proxy host asked for device 'cuda' but no CUDA device is "
            "available (pass device='cpu' to serve on the CPU)"
        )


def serve_forever(cfg: ProxyHostConfig, port_q=None, on_bound=None) -> None:
    """Bind, report the chosen port, serve sessions until killed.

    ``on_bound(port)`` runs after the listener exists — registration with
    a coordinator belongs there, never before the bind (an endpoint must
    not be advertised while nothing is accepting on it).
    """
    from repro_torch.coord.protocol import Connection
    from repro_torch.obs import trace as obs_trace
    from repro_torch.proxy.service import ProxyService, deterministic_torch

    _check_device(cfg.device)
    # process-wide, before any session's first CUDA call: every session
    # must compute the bits an inline run of its program computes
    deterministic_torch()
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    listener.bind((cfg.bind, cfg.port))
    listener.listen(64)
    port = listener.getsockname()[1]
    obs_trace.enable_from_env(f"proxyhost-{port}")
    if port_q is not None:
        port_q.put(port)
    else:
        print(f"[proxy-host] serving on {cfg.bind}:{port} (device={cfg.device})",
              flush=True)
    if on_bound is not None:
        on_bound(port)

    def session(sock: socket.socket) -> None:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn = Connection(sock)
        conn.settimeout(SESSION_TIMEOUT_S)
        obs_trace.instant("host.session_open", port=port)
        try:
            ProxyService(conn).serve()
        finally:
            conn.close()
            obs_trace.instant("host.session_close", port=port)

    while True:
        try:
            sock, _ = listener.accept()
        except OSError:
            return
        threading.Thread(
            target=session, args=(sock,), name="proxy-session", daemon=True
        ).start()


def proxy_host_entry(cfg: ProxyHostConfig, port_q) -> int:
    """multiprocessing spawn target: a start-up failure is reported on the
    queue (``("error", message)``) so the launcher raises it at once."""
    try:
        serve_forever(cfg, port_q)
    except Exception as e:
        port_q.put(("error", f"{type(e).__name__}: {e}"))
        raise
    return 0


class ProxyHostHandle:
    """Launcher-side handle on one daemon process (``spawn`` context: a
    launcher that holds a CUDA context cannot fork)."""

    def __init__(
        self,
        name: str,
        *,
        bind: str = "127.0.0.1",
        device: str = "cuda",
    ):
        self.name = name
        self.cfg = ProxyHostConfig(bind=bind, device=device)
        self.ctx = mp.get_context("spawn")
        self.proc: mp.Process | None = None
        self.port: int | None = None

    def start(self) -> "ProxyHostHandle":
        q = self.ctx.Queue()
        self.proc = self.ctx.Process(
            target=proxy_host_entry, args=(self.cfg, q),
            name=f"crum-proxy-host-{self.name}", daemon=True,
        )
        self.proc.start()
        deadline = time.monotonic() + START_TIMEOUT_S
        got = None
        while got is None:
            try:
                got = q.get(timeout=0.25)
            except queue.Empty:
                if not self.proc.is_alive() or time.monotonic() > deadline:
                    why = (f"exited with code {self.proc.exitcode}"
                           if not self.proc.is_alive() else
                           f"did not report a port within {START_TIMEOUT_S}s")
                    self.terminate()
                    raise RuntimeError(f"proxy host {self.name} {why}") from None
        if isinstance(got, tuple):
            self.terminate()
            raise RuntimeError(f"proxy host {self.name} failed to start: {got[1]}")
        self.port = int(got)
        return self

    @property
    def addr(self) -> tuple[str, int]:
        if self.port is None:
            raise RuntimeError("call start() first")
        return self.cfg.bind, self.port

    @property
    def pid(self) -> int | None:
        return self.proc.pid if self.proc is not None else None

    def alive(self) -> bool:
        return self.proc is not None and self.proc.is_alive()

    def kill(self) -> None:
        """SIGKILL — the proxy-host failure drill. Every session dies."""
        if self.proc is not None and self.proc.is_alive():
            self.proc.kill()
            self.proc.join(timeout=10)

    def terminate(self) -> None:
        if self.proc is not None:
            if self.proc.is_alive():
                self.proc.terminate()
            self.proc.join(timeout=10)
            if self.proc.is_alive():
                self.proc.kill()
                self.proc.join(timeout=10)
            self.proc = None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--bind", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="listen port (0 = OS-assigned, printed at startup)")
    ap.add_argument("--coord", default=None, metavar="HOST:PORT",
                    help="register this endpoint with a cluster coordinator")
    ap.add_argument("--name", default=None,
                    help="endpoint name for registration (default host:port)")
    ap.add_argument("--device", choices=DEVICES, default="cuda",
                    help="compute on the card (default) or the CPU")
    args = ap.parse_args(argv)

    cfg = ProxyHostConfig(bind=args.bind, port=args.port, device=args.device)
    on_bound = None
    if args.coord:
        from repro_torch.remote.placement import register_proxy_endpoint
        from repro_torch.remote.transport import endpoint_arg

        coord_addr = endpoint_arg(args.coord)

        def on_bound(port: int) -> None:
            # register only once the listener is live: advertising an
            # endpoint nothing accepts on would hand ranks a
            # connection-refused assignment
            name = args.name or f"{cfg.bind}:{port}"
            register_proxy_endpoint(
                coord_addr, name=name, addr=cfg.bind, port=port
            )
            print(f"[proxy-host] registered as {name!r}", flush=True)

    serve_forever(cfg, on_bound=on_bound)
    return 0


if __name__ == "__main__":
    sys.exit(main())
