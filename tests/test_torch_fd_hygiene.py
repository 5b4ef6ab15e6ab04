"""PyTorch port: resource hygiene on the proxy's reconnect path.

The twin of ``tests/remote/test_fd_hygiene.py``'s kill/respawn case: every
ProxyDiedError branch closes its socket, so repeated SIGKILL/respawn cycles
of a port ``ProxyRunner`` leak no file descriptors or segment files in the
application, over both transports. The fds are audited through
``repro_torch.obs.leakcheck`` so a failure names them. The segments are
audited in the runner's own segment directory (under ``/dev/shm`` where it
can, as the runner's default): the reference audits all of ``/dev/shm``,
which other tests' proxies running at the same time also write to.
"""
import os
import shutil

import pytest

from repro_torch.obs.leakcheck import LeakCheck
from repro_torch.proxy import ProxyRunner
from repro_torch.proxy.segments import default_segment_dir

TIMEOUTS = {"op_timeout_s": 30.0, "sync_timeout_s": 30.0}

# each local respawn imports torch (~2-4 s here): 8 cycles per transport
# instead of the reference's 22, with the leak tolerance scaled down so a
# cycle may leak no more than the reference allows (4 fds in 22 cycles)
CYCLES = 8
FD_TOLERANCE = 1


@pytest.mark.skipif(not os.path.isdir("/proc/self/fd"), reason="needs /proc (Linux)")
@pytest.mark.parametrize("transport", ["segment", "stream"])
def test_no_fd_leak_across_kill_respawn_cycles(transport):
    assert FD_TOLERANCE / CYCLES <= 4 / 22
    workdir = default_segment_dir("crum-fd-hygiene-")
    r = ProxyRunner({"name": "numpy_sgd", "rows": 4, "width": 16, "seed": 0},
                    chunk_bytes=1 << 10, transport=transport, workdir=workdir,
                    max_restarts=CYCLES + 2, **TIMEOUTS)
    r.start()
    try:
        step = 0
        for _ in range(3):  # settle allocations (mp plumbing, buffers)
            step += 1
            r.step(step)
        r.sync_state()
        segments = sorted(os.listdir(workdir))
        lc = LeakCheck(tolerance=FD_TOLERANCE).start()
        for _ in range(CYCLES):
            r.kill()
            step += 1
            r.step(step)      # detects death -> respawn + replay
            r.sync_state()
        assert r.restarts == CYCLES
        d = lc.diff()
        assert d["fd_growth"] <= FD_TOLERANCE, (
            f"{CYCLES} kill/respawn cycles ({transport}): fd count grew by "
            f"{d['fd_growth']}; new fds: {d['new_fds']}")
        assert sorted(os.listdir(workdir)) == segments
    finally:
        r.close()
        shutil.rmtree(workdir, ignore_errors=True)
