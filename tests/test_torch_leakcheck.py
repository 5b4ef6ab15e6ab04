"""PyTorch port: ``obs.leakcheck`` counts its own run's ``/dev/shm``.

The reference's leak audit counts every entry of the machine's ``/dev/shm``,
so another process writing there at the same time (another test's proxy
segments, another run's semaphores) reads as this run's leak. The port's
counts only the entries its run made: those this process or a live
descendant maps or holds open, and those whose ``crum-<kind>-<pid>-`` name
carries such a pid or one of its ancestors. Another process's entry does
not count; the run's own leaked entry still does, also after the process
that made it was killed.
"""
import os
import shutil
import signal
import subprocess
import sys
import tempfile

import pytest

from repro_torch.obs import leakcheck
from repro_torch.obs.leakcheck import LeakCheck
from repro_torch.proxy.segments import default_segment_dir

SHM = "/dev/shm"

pytestmark = pytest.mark.skipif(
    not (os.path.isdir("/proc/self/fd") and os.path.isdir(SHM)
         and os.access(SHM, os.W_OK)),
    reason="needs /proc and a writable /dev/shm (Linux)")


def _foreign_pid() -> int:
    """A live pid outside this process's tree: the nearest ancestor."""
    pid = os.getppid()
    assert pid not in leakcheck.run_pids()
    return pid


def test_port_names_carry_the_creating_pid():
    d = default_segment_dir()
    try:
        name = os.path.basename(d)
        assert name.startswith(f"crum-proxy-{os.getpid()}-")
        lineage = leakcheck.shm_entry_lineage(name)
        assert lineage[0] == os.getpid()
        assert os.getppid() <= 1 or lineage[1] == os.getppid()
    finally:
        shutil.rmtree(d)
    assert leakcheck.shm_entry_lineage("crum-proxy-log-42-x") == (42,)
    assert leakcheck.shm_entry_lineage("crum-proxy-7-6.5-x") == (7, 6, 5)
    assert leakcheck.shm_entry_lineage("crum-proxy-abcdef") == ()
    assert leakcheck.shm_entry_lineage("sem.mp-1234") == ()


def test_another_process_entries_do_not_count():
    """Entries that another process made while the check ran — one named
    with its pid, one unnamed and held by nobody of this run — are not this
    run's growth, though the machine's /dev/shm grew by two."""
    foreign = os.path.join(SHM, f"crum-proxy-{_foreign_pid()}-leakcheck")
    unnamed = os.path.join(SHM, f"sem.mp-leakcheck-{os.getpid()}")
    machine_before = len(os.listdir(SHM))
    lc = LeakCheck().start()
    try:
        os.mkdir(foreign)
        with open(unnamed, "wb"):
            pass  # closed: nobody of this run holds it
        assert len(os.listdir(SHM)) >= machine_before + 2
        d = lc.diff()
        assert d["shm_growth"] == 0 and d["new_shm"] == [], d
        lc.assert_no_growth("foreign entries")
        assert os.path.basename(foreign) not in leakcheck.run_shm_entries()
    finally:
        os.rmdir(foreign)
        os.remove(unnamed)


def test_the_runs_own_leaked_entries_still_count():
    """A segment dir this process made and left behind (named with its pid)
    and an unnamed entry it still holds open are both this run's leak."""
    lc = LeakCheck(tolerance=1, shm_tolerance=1).start()  # the held fd is 1
    leaked_dir = default_segment_dir()
    held = tempfile.NamedTemporaryFile(dir=SHM, prefix="leakcheck-held-")  # noqa: SIM115
    try:
        d = lc.diff()
        assert d["shm_growth"] == 2, d
        assert sorted(d["new_shm"]) == sorted(
            [os.path.basename(leaked_dir), os.path.basename(held.name)])
        with pytest.raises(AssertionError, match="/dev/shm grew by 2"):
            lc.assert_no_growth("own leak")
        assert leakcheck.sample()["shm"] >= 2
    finally:
        held.close()
        shutil.rmtree(leaked_dir)


def test_a_live_descendants_held_entry_counts():
    """An unnamed entry a child process holds open is the run's while the
    child lives (the coordinator's ranks, daemons and proxies are its
    descendants)."""
    code = (
        "import sys, tempfile\n"
        "f = tempfile.NamedTemporaryFile(dir='/dev/shm', prefix='leakcheck-child-')\n"
        "print(f.name, flush=True)\n"
        "sys.stdin.read()\n"
    )
    child = subprocess.Popen([sys.executable, "-c", code], stdin=subprocess.PIPE,
                             stdout=subprocess.PIPE, text=True)
    try:
        name = os.path.basename(child.stdout.readline().strip())
        assert child.pid in leakcheck.run_pids()
        assert name in leakcheck.run_shm_entries()
        # the same entry, seen from outside the child's tree, is not counted
        assert name not in leakcheck.run_shm_entries({os.getpid()})
    finally:
        child.stdin.close()
        child.wait(timeout=30)
    assert name not in os.listdir(SHM)


# a child that makes one /dev/shm entry, prints its name and waits to be killed
_KILLED_CHILD = {
    # named by the port, with its ancestors: no capture sees the child alive
    "named": "from repro_torch.proxy.segments import default_segment_dir\n"
             "name = default_segment_dir()\n",
    # named with the child's pid only: a capture sees the child alive
    "seen": "import os\n"
            "name = f'/dev/shm/crum-proxy-{os.getpid()}-x'\n"
            "os.mkdir(name)\n",
    # unnamed, as a semaphore's file, held open when a capture runs
    "held": "import tempfile\n"
            "f = tempfile.NamedTemporaryFile(dir='/dev/shm', prefix='sem.mp-leakcheck-', delete=False)\n"
            "name = f.name\n",
}


@pytest.mark.parametrize("case", sorted(_KILLED_CHILD))
def test_a_killed_processes_entry_still_counts(case):
    """A rank or proxy SIGKILLed mid-run leaves its entry behind, and its
    pid is no longer live: the entry is still the run's growth."""
    code = _KILLED_CHILD[case] + "print(name, flush=True)\nimport sys\nsys.stdin.read()\n"
    src = os.path.dirname(os.path.dirname(os.path.dirname(leakcheck.__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    lc = LeakCheck(tolerance=2).start()  # the child's two pipes
    child = subprocess.Popen([sys.executable, "-c", code], stdin=subprocess.PIPE,
                             stdout=subprocess.PIPE, text=True, env=env)
    name = None
    try:
        name = os.path.basename(child.stdout.readline().strip())
        assert name
        if case != "named":
            assert name in leakcheck.run_shm_entries()  # the watchdog's tick
        os.kill(child.pid, signal.SIGKILL)
        child.wait(timeout=30)
        assert child.pid not in leakcheck.run_pids()
        assert name in os.listdir(SHM)
        d = lc.diff()
        assert d["shm_growth"] == 1 and d["new_shm"] == [name], d
        with pytest.raises(AssertionError, match="/dev/shm grew by 1"):
            lc.assert_no_growth("killed child")
        # with no memory of the child, only the port name's ancestors
        # (this process) still tie the entry to the run
        assert (name in leakcheck.run_shm_entries({os.getpid()})) == (case == "named")
    finally:
        child.kill()
        child.wait(timeout=30)
        child.stdin.close()
        child.stdout.close()
        path = os.path.join(SHM, name) if name else None
        if path and os.path.isdir(path):
            shutil.rmtree(path)
        elif path and os.path.exists(path):
            os.remove(path)
