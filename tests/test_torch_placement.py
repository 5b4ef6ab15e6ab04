"""PyTorch port: proxy placement, against the reference.

The cases of ``tests/remote/test_placement.py`` run again on the port's
``remote.placement`` and coordinator: the map's sticky, least-loaded
assignment, the PROXY_ENDPOINT handshake (register, acquire, death report,
exhaustion, a malformed frame), and the proxy-host daemon's CLI
registering only once its listener accepts. The side channel speaks the
reference's frames: each package's client is served by the other's
coordinator.
"""
import json
import os
import socket
import subprocess
import sys
import threading

import pytest

from repro.coord.coordinator import Coordinator as RefCoordinator
from repro.coord.protocol import MSG_FINISHED as REF_FINISHED
from repro.coord.protocol import MSG_JOIN as REF_JOIN
from repro.coord.protocol import MSG_WELCOME as REF_WELCOME
from repro.coord.protocol import connect as ref_connect
from repro.remote import placement as ref_placement
from repro_torch.coord.coordinator import Coordinator
from repro_torch.coord.protocol import (
    MSG_FINISHED,
    MSG_JOIN,
    MSG_PROXY_ENDPOINT,
    MSG_WELCOME,
    connect,
)
from repro_torch.remote.placement import (
    PlacementMap,
    register_proxy_endpoint,
    request_proxy_endpoint,
)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
PACKAGES = {
    "port": (Coordinator, connect, (MSG_JOIN, MSG_WELCOME, MSG_FINISHED)),
    "reference": (RefCoordinator, ref_connect, (REF_JOIN, REF_WELCOME, REF_FINISHED)),
}


# -- PlacementMap ---------------------------------------------------------------

def test_assign_sticky_and_least_loaded():
    pm = PlacementMap()
    pm.register("a", "127.0.0.1", 1)
    pm.register("b", "127.0.0.1", 2)
    e0 = pm.assign(0)
    e1 = pm.assign(1)
    assert {e0.name, e1.name} == {"a", "b"}  # spread, not piled
    assert pm.assign(0).name == e0.name      # sticky
    e2 = pm.assign(2)
    assert pm.loads()[e2.name] <= 2


def test_dead_endpoint_reassigns_to_survivor():
    pm = PlacementMap()
    pm.register("a", "127.0.0.1", 1)
    pm.register("b", "127.0.0.1", 2)
    first = pm.assign(0)
    pm.report_dead(first.name)
    second = pm.assign(0)
    assert second.name != first.name
    assert [w for w, _ in pm.history] == [0, 0]  # the audit trail


def test_exclude_and_exhaustion():
    pm = PlacementMap()
    pm.register("a", "127.0.0.1", 1)
    assert pm.assign(0, exclude=("a",)) is None
    # dead-marked endpoints are offered as a last resort; None only when
    # everything is excluded
    pm.report_dead("a")
    assert pm.assign(1).name == "a"
    assert pm.assign(1, exclude=("a",)) is None


def test_dead_endpoint_revivable_by_reregistration():
    pm = PlacementMap()
    pm.register("a", "127.0.0.1", 1)
    pm.report_dead("a")
    pm.register("a", "127.0.0.1", 1)  # daemon came back
    assert pm.endpoints["a"].alive


@pytest.mark.parametrize("seed", range(4))
def test_assignment_matches_the_reference(seed):
    """The same register/assign/death sequence gives the same placements
    and audit trail in both packages' maps."""
    import random

    rnd = random.Random(seed)
    maps = (PlacementMap(), ref_placement.PlacementMap())
    for _ in range(40):
        op = rnd.choice(("register", "assign", "dead", "assign"))
        name, worker = rnd.choice("abc"), rnd.randrange(5)
        excl = tuple(rnd.sample("abc", rnd.randrange(3)))
        got = []
        for pm in maps:
            if op == "register":
                pm.register(name, "127.0.0.1", ord(name))
            elif op == "dead":
                pm.report_dead(name)
            else:
                ep = pm.assign(worker, exclude=excl)
                got.append(None if ep is None else ep.name)
        assert len(set(got)) <= 1, (op, got)
    assert maps[0].history == maps[1].history
    assert maps[0].assignment == maps[1].assignment


# -- the coordinator handshake ---------------------------------------------------

def _live(package, root):
    """A coordinator of ``package`` with its event loop running (n_hosts=1)
    and a function that ends it by joining as that host and finishing."""
    coord_cls, conn_fn, (join, welcome, finished) = PACKAGES[package]
    coord = coord_cls(root, n_hosts=1).start()
    err = []

    def drive():
        try:
            coord.run(deadline_s=60.0)
        except Exception as e:
            err.append(e)

    t = threading.Thread(target=drive, daemon=True)
    t.start()

    def stop():
        conn = conn_fn(coord.address)
        conn.settimeout(1.0)
        conn.send(join, host=0, pid=1, restored_from=None)
        while True:
            try:
                msg = conn.recv()
            except (socket.timeout, TimeoutError):
                continue
            if msg and msg.get("type") == welcome:
                break
        conn.send(finished, host=0, step=0, digest="x")
        t.join(timeout=30)
        conn.close()
        assert not t.is_alive() and not err, err

    return coord, stop


@pytest.fixture
def live_coordinator(tmp_path):
    coord, stop = _live("port", str(tmp_path / "root"))
    yield coord
    stop()


def _read_log(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("client", ["port", "reference"])
@pytest.mark.parametrize("server", ["port", "reference"])
def test_register_acquire_dead_handshake(tmp_path, client, server):
    register, request = {
        "port": (register_proxy_endpoint, request_proxy_endpoint),
        "reference": (ref_placement.register_proxy_endpoint,
                      ref_placement.request_proxy_endpoint),
    }[client]
    coord, stop = _live(server, str(tmp_path / "root"))
    try:
        register(coord.address, name="ph0", addr="127.0.0.1", port=7001)
        register(coord.address, name="ph1", addr="127.0.0.1", port=7002)
        got = request(coord.address, worker=0)
        assert got is not None and got["name"] in ("ph0", "ph1")
        # sticky across re-acquire
        assert request(coord.address, worker=0)["name"] == got["name"]
        # a death report reschedules onto the survivor
        moved = request(coord.address, worker=0, failed=got["name"],
                        exclude=(got["name"],))
        assert moved is not None and moved["name"] != got["name"]
        # all dead -> None (the rank surfaces budget exhaustion, not a hang)
        assert request(coord.address, worker=0, failed=moved["name"],
                       exclude=(got["name"], moved["name"])) is None
    finally:
        stop()
    events = [e["event"] for e in _read_log(coord.log_path)]
    assert {"proxy_endpoint", "proxy_placement", "proxy_host_death"} <= set(events)


def test_malformed_side_channel_frame_never_kills_the_cluster(live_coordinator):
    """The side channel accepts arbitrary un-JOINed peers: a bad frame
    gets an error reply; the event loop (and the cluster) survives."""
    coord = live_coordinator
    conn = connect(coord.address)
    conn.settimeout(1.0)
    try:
        conn.send(MSG_PROXY_ENDPOINT, op="register", name="ghost")  # no port
        while True:
            try:
                msg = conn.recv()
                break
            except (socket.timeout, TimeoutError):
                continue
        assert msg["type"] == MSG_PROXY_ENDPOINT
        assert "bad frame" in msg.get("error", "")
    finally:
        conn.close()
    register_proxy_endpoint(coord.address, name="ok", addr="127.0.0.1", port=7009)
    got = request_proxy_endpoint(coord.address, worker=5)
    assert got is not None and got["name"] == "ok"


def test_daemon_cli_registers_once_its_listener_accepts(live_coordinator):
    """``python -m repro_torch.remote.host --coord``: the endpoint the
    coordinator hands out accepts connections the moment it is handed out."""
    coord = live_coordinator
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.remote.host", "--device", "cpu",
         "--coord", "%s:%d" % coord.address, "--name", "cli-ph"],
        stdout=subprocess.PIPE, text=True, env=dict(os.environ, PYTHONPATH=SRC),
    )
    try:
        lines = [proc.stdout.readline(), proc.stdout.readline()]
        assert lines[0].startswith("[proxy-host] serving on 127.0.0.1:"), lines
        assert "(device=cpu)" in lines[0] and "registered as 'cli-ph'" in lines[1]
        got = request_proxy_endpoint(coord.address, worker=0)
        assert got["name"] == "cli-ph"
        assert lines[0].split()[3] == f"{got['addr']}:{got['port']}"
        with socket.create_connection((got["addr"], got["port"]), timeout=10):
            pass
    finally:
        proc.kill()
        proc.wait(timeout=30)
        proc.stdout.close()
