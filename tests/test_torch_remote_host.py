"""PyTorch port: the proxy-host daemon, against the reference.

A daemon (``repro_torch.remote.host``) serves device-proxy sessions over
TCP; here it computes on the CPU (``device="cpu"``), and asking it for the
card where there is none raises before it binds. The cross-package cases
drive a reference ``ProxyRunner`` (streamed transport) against a port
daemon and a port runner against a reference daemon, on ``numpy_sgd``:
state and ``tree_digest`` equal the inline run. The daemon-session case
is the twin of ``tests/remote/test_stream_runner.py``'s, asserting what
holds with or without zstd (the reference's asserts the compressed wire
bytes cover the raw state, which zstd makes false). The backoff-jitter
case is a twin of ``tests/remote/test_fd_hygiene.py``'s (its kill/respawn
cycles are in ``tests/test_torch_fd_hygiene.py``).
"""
import socket

import pytest
import torch

from repro.proxy import ProxyRunner as RefProxyRunner
from repro.remote.host import ProxyHostHandle as RefProxyHostHandle
from repro_torch.proxy import ProxyRunner, make_program
from repro_torch.remote import host
from repro_torch.remote.host import ProxyHostConfig, ProxyHostHandle, serve_forever
from repro_torch.utils.tree import tree_digest, tree_equal

SPEC = {"name": "numpy_sgd", "rows": 8, "width": 32, "seed": 0}
TIMEOUTS = {"op_timeout_s": 30.0, "sync_timeout_s": 30.0}


def _inline_run(n_steps, spec=SPEC):
    prog = make_program(spec)
    s = prog.init_state()
    for step in range(1, n_steps + 1):
        s, _ = prog.step(s, step)
    return s


@pytest.fixture
def daemon():
    d = ProxyHostHandle("t-ph0", device="cpu").start()
    yield d
    d.terminate()


# -- the daemon process ------------------------------------------------------------

def test_handle_start_kill_terminate():
    d = ProxyHostHandle("t-life", device="cpu").start()
    try:
        assert d.alive() and d.pid and d.addr[1] > 0
        with socket.create_connection(d.addr, timeout=10):
            pass  # the listener accepts
        d.kill()
        assert not d.alive()
        with pytest.raises(OSError):
            socket.create_connection(d.addr, timeout=10).close()
    finally:
        d.terminate()
    assert d.proc is None and not d.alive()


class _Bound(Exception):
    pass


@pytest.fixture
def keeps_torch_settings():
    """``serve_forever`` applies the determinism settings process-wide;
    put them back for the tests that follow in this process."""
    flags = (torch.are_deterministic_algorithms_enabled(),
             torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    yield
    torch.use_deterministic_algorithms(flags[0])
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags[1:]


def test_on_bound_runs_once_the_listener_accepts(keeps_torch_settings):
    """Registration belongs after the bind: when ``on_bound`` runs, a
    connection to the reported port already succeeds, and the determinism
    settings are already in force."""
    seen = []

    def on_bound(port):
        with socket.create_connection(("127.0.0.1", port), timeout=10):
            seen.append(torch.are_deterministic_algorithms_enabled())
        raise _Bound

    with pytest.raises(_Bound):
        serve_forever(ProxyHostConfig(device="cpu"), on_bound=on_bound)
    assert seen == [True]


def test_cuda_daemon_without_a_card_raises_before_it_binds(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    monkeypatch.setattr(host.socket, "socket", lambda *a, **k: pytest.fail("bound"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_forever(ProxyHostConfig(device="cuda"))
    with pytest.raises(ValueError, match="device must be one of"):
        serve_forever(ProxyHostConfig(device="tpu"))


def test_cuda_daemon_without_a_card_fails_its_start_clearly():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    d = ProxyHostHandle("t-nocard")  # device="cuda"
    with pytest.raises(RuntimeError, match="failed to start: RuntimeError: .*no CUDA device"):
        d.start()
    assert d.proc is None


# -- sessions across packages --------------------------------------------------------

def _drive(runner, n_steps=5):
    runner.start()
    try:
        for s in range(1, n_steps + 1):
            runner.step(s)
        state, info = runner.sync_state()
        assert info["step"] == n_steps
        return state, info
    finally:
        runner.close()


def test_reference_runner_against_a_port_daemon(daemon):
    r = RefProxyRunner(SPEC, chunk_bytes=1 << 10, transport="stream",
                       endpoint_provider=lambda failed=False: daemon.addr)
    state, info = _drive(r)
    ref = _inline_run(5)
    assert tree_equal(state, ref) and info["digest"] == tree_digest(ref)


def test_port_runner_against_a_reference_daemon():
    d = RefProxyHostHandle("t-refph").start()
    try:
        r = ProxyRunner(SPEC, chunk_bytes=1 << 10, transport="stream",
                        endpoint_provider=lambda failed=False: d.addr, **TIMEOUTS)
        state, info = _drive(r)
    finally:
        d.terminate()
    ref = _inline_run(5)
    assert tree_equal(state, ref) and info["digest"] == tree_digest(ref)


def test_endpoint_daemon_session_and_steady_state_delta(daemon):
    """A daemon-hosted session: the full state rides the wire once at
    start, then a SYNC with no step in between moves nothing."""
    r = ProxyRunner(SPEC, chunk_bytes=1 << 8, transport="stream",
                    endpoint_provider=lambda failed=False: daemon.addr, **TIMEOUTS)
    try:
        r.start()
        state_bytes = r.transport.table.total_bytes()
        assert r.transport.raw_tx >= state_bytes  # the initial full push
        assert 0 < r.transport.wire_tx <= r.transport.raw_tx
        for s in range(1, 4):
            r.step(s)
        _, info1 = r.sync_state()
        assert info1["chunks_synced"] > 0
        rx1 = r.transport.wire_rx
        _, info2 = r.sync_state()
        assert r.transport.wire_rx == rx1
        assert info2["chunks_synced"] == 0 and info2["bytes_synced"] == 0
        assert tree_equal(r.transport.read_state(), _inline_run(3))
    finally:
        r.close()


def test_two_sessions_of_one_daemon_keep_their_own_state(daemon):
    """Two sessions stepping at once in one daemon: each SYNCED counts its
    own steps, and each state equals the inline run of its own steps."""
    runners = [ProxyRunner(SPEC, chunk_bytes=1 << 10, transport="stream",
                           fused_digests=True,
                           endpoint_provider=lambda failed=False: daemon.addr, **TIMEOUTS)
               for _ in range(2)]
    try:
        for r in runners:
            r.start()
        steps = (3, 5)
        for s in range(1, max(steps) + 1):
            for r, n in zip(runners, steps):
                if s <= n:
                    r.step(s)
        for r, n in zip(runners, steps):
            state, info = r.sync_state()
            assert info["phase_us"]["steps"] == n
            assert tree_equal(state, _inline_run(n))
    finally:
        for r in runners:
            r.close()


def test_each_session_counts_only_its_own_thread_launches(monkeypatch):
    """Sessions of one process step on their own threads: each SYNCED
    counts the digest launches its own steps made, exactly, while the
    other session launches at the same time. A fused step here stands in
    for a kernel launch by counting one through the wrapper's own counter
    (``chunk_digest._count``, what ``chunk_digest_table`` calls after its
    launch), then sleeps so the other session's launch lands inside its
    window."""
    import threading
    import time

    from repro_torch.coord.protocol import Connection
    from repro_torch.kernels import chunk_digest
    from repro_torch.proxy import programs
    from repro_torch.proxy.service import ProxyService

    def step_with_digests(self, state, step, chunk_bytes):
        out = programs.StepProgram.step_with_digests(self, state, step, chunk_bytes)
        chunk_digest._count(1)
        time.sleep(0.02)
        return out

    monkeypatch.setattr(programs.NumpySGD, "step_with_digests", step_with_digests,
                        raising=False)
    listener = socket.create_server(("127.0.0.1", 0))

    def accept_two():
        for _ in range(2):
            sock, _ = listener.accept()
            threading.Thread(target=ProxyService(Connection(sock)).serve,
                             daemon=True).start()

    acceptor = threading.Thread(target=accept_two, daemon=True)
    acceptor.start()
    addr = listener.getsockname()
    runners = [ProxyRunner(SPEC, chunk_bytes=1 << 10, transport="stream",
                           fused_digests=True, endpoint_provider=lambda failed=False: addr,
                           **TIMEOUTS) for _ in range(2)]
    try:
        for r in runners:
            r.start()
        acceptor.join(timeout=30)
        steps = (3, 7)
        for s in range(1, max(steps) + 1):
            for r, n in zip(runners, steps):
                if s <= n:
                    r.step(s)
        for r, n in zip(runners, steps):
            state, info = r.sync_state()
            assert info["phase_us"]["steps"] == n
            assert info["phase_us"]["digest_launches"] == n
            assert tree_equal(state, _inline_run(n))
    finally:
        for r in runners:
            r.close()
        listener.close()


def test_endpoint_unreachable_surfaces_quickly():
    from repro_torch.proxy.protocol import ProxyDiedError

    r = ProxyRunner(SPEC, chunk_bytes=1 << 10, max_restarts=0, transport="stream",
                    endpoint_provider=lambda failed=False: ("127.0.0.1", 1))
    with pytest.raises((ProxyDiedError, RuntimeError)):
        r.start()


def test_a_program_that_cannot_build_fails_its_session(daemon):
    """A session whose program cannot build ends; the app sees
    ProxyDiedError, and the daemon goes on serving."""
    from repro_torch.proxy.protocol import ProxyDiedError

    bad = ProxyRunner({"name": "no_such_program"}, chunk_bytes=1 << 10,
                      transport="stream", max_restarts=0,
                      endpoint_provider=lambda failed=False: daemon.addr, **TIMEOUTS)
    with pytest.raises(ProxyDiedError):
        bad.start(device_state=make_program(SPEC).init_state())
    bad.close()
    good = ProxyRunner(SPEC, chunk_bytes=1 << 10, transport="stream",
                       endpoint_provider=lambda failed=False: daemon.addr, **TIMEOUTS)
    state, _ = _drive(good, 2)
    assert tree_equal(state, _inline_run(2))


# -- the reconnect path (tests/remote/test_fd_hygiene.py) ------------------------------

def test_recover_backoff_is_jittered(monkeypatch):
    """A respawn attempt that itself fails is retried after a *random*,
    exponentially widening backoff — never a fixed hammer interval."""
    import repro_torch.proxy.supervisor as sup_mod

    windows = []
    monkeypatch.setattr(sup_mod.random, "uniform",
                        lambda a, b: windows.append((a, b)) or 0.0)
    daemons = [ProxyHostHandle(f"b-ph{i}", device="cpu").start() for i in range(2)]
    # after the first death: two DEAD endpoints, then the live survivor —
    # recovery attempts 1 and 2 fail, attempt 3 lands
    replacements = [("127.0.0.1", 1), ("127.0.0.1", 1), daemons[1].addr]
    current = [daemons[0].addr]

    def provider(failed=False):
        if failed:
            current[0] = replacements.pop(0)
        return current[0]

    r = ProxyRunner(SPEC, chunk_bytes=1 << 10, transport="stream", max_restarts=6,
                    endpoint_provider=provider, **TIMEOUTS)
    r.start()
    try:
        r.step(1)
        r.sync_state()
        daemons[0].kill()
        r.step(2)       # death detected -> recover through the dead pair
        state, info = r.sync_state()
        assert info["step"] == 2 and tree_equal(state, _inline_run(2))
        assert r.restarts == 3  # one per attempt (two dead + the landing)
        assert len(windows) == 2  # attempt 0 never sleeps
        assert all(a == 0.0 for a, _ in windows)
        caps = [b for _, b in windows]
        assert caps == sorted(caps) and caps[0] < caps[-1]
    finally:
        r.close()
        for d in daemons:
            d.terminate()
