"""PyTorch port: fault arming and seeded schedules against the reference.

Twins of ``tests/chaos/test_faults.py`` and ``tests/chaos/test_schedule.py``.
``repro_torch.chaos.{faults,schedule}`` are framework-free copies, so every
twin also runs the reference's function on the same inputs: a sentinel the
port arms is read by the reference's ``active`` (and back), and the same
seed gives the same plan in both packages.
"""
import errno
import json
import os
import time

import pytest

from repro.chaos import faults as rfaults
from repro.chaos.schedule import build_schedule as rbuild
from repro_torch.chaos import faults
from repro_torch.chaos.schedule import PlannedInjection, build_schedule


def _plan(plan):
    return [p.as_dict() for p in plan]


def _both(**kw):
    """The port's plan, held equal to the reference's for the same inputs."""
    ours = build_schedule(**kw)
    assert _plan(ours) == _plan(rbuild(**kw))
    return ours


# -- faults -------------------------------------------------------------------


def test_disabled_without_env(monkeypatch, tmp_path):
    monkeypatch.delenv(faults.CHAOS_ENV, raising=False)
    assert faults.CHAOS_ENV == rfaults.CHAOS_ENV == "CRUM_CHAOS_DIR"
    assert faults.chaos_dir() is None
    assert faults.active("disk_full") is None
    with pytest.raises(RuntimeError):
        faults.arm("disk_full", quota_bytes=1)
    # the shim is a no-op: no env, no exception, no file access
    faults.check_disk_quota(0, 10**9, 10**9)


def test_arm_active_disarm(tmp_path):
    d = str(tmp_path)
    path = faults.arm("clock_skew", directory=d, host=1, skew_s=60.0)
    assert os.path.exists(path)
    assert faults.active("clock_skew", directory=d) == \
        {"host": 1, "skew_s": 60.0}
    # the reference reads the port's sentinel the same way
    assert rfaults.active("clock_skew", directory=d) == \
        {"host": 1, "skew_s": 60.0}
    # host filter: a host-targeted sentinel matches only that host
    assert faults.active("clock_skew", host=1, directory=d) is not None
    assert faults.active("clock_skew", host=0, directory=d) is None
    faults.disarm("clock_skew", directory=d)
    assert faults.active("clock_skew", directory=d) is None
    faults.disarm("clock_skew", directory=d)  # idempotent


def test_self_expiry(tmp_path):
    d = str(tmp_path)
    faults.arm("disk_full", directory=d, duration_s=0.05, quota_bytes=1)
    assert faults.active("disk_full", directory=d) is not None
    time.sleep(0.08)
    assert faults.active("disk_full", directory=d) is None
    assert rfaults.active("disk_full", directory=d) is None


def test_torn_sentinel_is_inactive(tmp_path):
    d = str(tmp_path)
    with open(os.path.join(d, "disk_full.json"), "w") as f:
        f.write('{"kind": "disk_full", "par')  # torn mid-write
    assert faults.active("disk_full", directory=d) is None


def test_disk_quota_shim(monkeypatch, tmp_path):
    d = str(tmp_path)
    monkeypatch.setenv(faults.CHAOS_ENV, d)
    # armed by the reference, enforced by the port's shim
    rfaults.arm("disk_full", directory=d, host=0, quota_bytes=100)
    faults.check_disk_quota(0, 50, 50)  # exactly at quota: fine
    with pytest.raises(OSError) as ei:
        faults.check_disk_quota(0, 51, 50)
    assert ei.value.errno == errno.ENOSPC
    # another host is unaffected by a host-targeted quota
    faults.check_disk_quota(1, 10**9, 0)


def test_store_writer_hits_quota(monkeypatch, tmp_path):
    """End to end through the port's write path: ``ChunkStore.Writer.append``
    raises ENOSPC mid-stream while the fault is armed, and the same append
    succeeds after disarm; the reference's store reads the retried chunk."""
    from repro.checkpoint.store import ChunkStore as RefStore
    from repro_torch.checkpoint.store import ChunkStore

    d = str(tmp_path / "chaos")
    os.makedirs(d)
    monkeypatch.setenv(faults.CHAOS_ENV, d)
    store = ChunkStore(str(tmp_path / "ckpt"))
    faults.arm("disk_full", directory=d, host=0, quota_bytes=1)
    w = store.writer(2, 0)
    with pytest.raises(OSError) as ei:
        w.append(b"x" * 4096, "none", index=0, digest=1)
    assert ei.value.errno == errno.ENOSPC
    w.close(fsync=False)
    faults.disarm("disk_full", directory=d)
    w2 = store.writer(2, 0)
    rec = w2.append(b"x" * 4096, "none", index=0, digest=1)
    w2.close(fsync=False)
    assert store.read_chunk(rec) == b"x" * 4096
    assert RefStore(str(tmp_path / "ckpt")).read_chunk(rec) == b"x" * 4096


def test_arm_is_atomic_replace(tmp_path):
    d = str(tmp_path)
    faults.arm("disk_full", directory=d, quota_bytes=1)
    faults.arm("disk_full", directory=d, quota_bytes=2)
    with open(os.path.join(d, "disk_full.json")) as f:
        doc = json.load(f)
    assert doc["params"]["quota_bytes"] == 2
    assert not [n for n in os.listdir(d) if ".tmp." in n]


# -- schedules ----------------------------------------------------------------


def test_same_seed_same_plan():
    kw = dict(duration_s=120.0, n_hosts=3, n_proxy_hosts=3)
    a = _both(seed=42, **kw)
    b = _both(seed=42, **kw)
    assert a == b
    assert a, "a two-minute soak must plan at least one injection"
    assert all(isinstance(p, PlannedInjection) for p in a)


def test_different_seed_different_plan():
    kw = dict(duration_s=120.0, n_hosts=3, n_proxy_hosts=3)
    plans = {tuple((p.kind, p.offset_s) for p in
             _both(seed=s, **kw)) for s in range(6)}
    assert len(plans) > 1


def test_worker_kill_cap_respected():
    plan = _both(seed=1, duration_s=600.0, n_hosts=2,
                 kinds=("kill_worker",), max_worker_kills_per_host=1)
    kills: dict[int, int] = {}
    for p in plan:
        kills[p.params["host"]] = kills.get(p.params["host"], 0) + 1
    assert kills and max(kills.values()) <= 1


def test_proxy_host_kills_leave_a_survivor():
    plan = _both(seed=3, duration_s=600.0, n_hosts=2, n_proxy_hosts=3,
                 kinds=("kill_proxy_host", "partition"))
    killed = {p.params["index"] for p in plan
              if p.kind == "kill_proxy_host"}
    assert len(killed) <= 2  # of 3: always one survivor
    # a partitioned daemon is never one already killed earlier
    dead: set[int] = set()
    for p in plan:
        if p.kind == "partition":
            assert p.params["index"] not in dead
        elif p.kind == "kill_proxy_host":
            dead.add(p.params["index"])


def test_proxy_kinds_need_daemons():
    for build in (build_schedule, rbuild):
        with pytest.raises(ValueError):
            build(seed=0, duration_s=60.0, n_hosts=2,
                  n_proxy_hosts=0, kinds=("partition",))


def test_tail_is_fault_free():
    plan = _both(seed=5, duration_s=90.0, n_hosts=2, n_proxy_hosts=2)
    assert plan
    # the last third of the run is reserved for convergence
    assert max(p.offset_s for p in plan) < 90.0 - 20.0
