"""The port's ranks that host device proxies, on the CPU: the reference's
``tests/coord/test_cluster.py`` proxy drill on ``repro_torch`` (numpy
program, killed rank), torch_tiny through a proxy per rank against inline
ranks and the program run in-process, and paged proxies (``device_capacity``)
against unmanaged ones. Digests are compared exactly. Marked
``integration`` (each test spawns rank and proxy processes)."""
import pytest

from repro_torch.coord.supervisor import run_cluster

pytestmark = pytest.mark.integration


def test_proxy_device_runner_lockstep_and_kill(tmp_path):
    """Each worker hosts its own device-proxy process; digests still
    converge, and a killed worker (whose proxy dies with it) respawns,
    restores, re-pushes into a fresh proxy and reconverges."""
    root = str(tmp_path / "cluster")
    report = run_cluster(
        root=root, n_hosts=2, total_steps=6, ckpt_every=2,
        backend="thread", loop="numpy", device="cpu", device_runner="proxy",
        deadline_s=300.0, kill_host=1, kill_at_step=4,
    )
    assert report.restarts[1] == 1
    assert report.lockstep()
    assert report.latest_committed == 6
    # proxied and inline execution are the same math: an inline cluster
    # over the same config lands on the same digest
    inline = run_cluster(
        root=str(tmp_path / "cluster-inline"), n_hosts=2, total_steps=6,
        ckpt_every=2, backend="thread", loop="numpy", device="cpu", deadline_s=300.0,
    )
    assert inline.lockstep()
    assert (set(report.final_digests.values())
            == set(inline.final_digests.values()))


def test_proxied_torch_ranks_equal_inline_ranks(tmp_path):
    """torch_tiny through a proxy per rank (killed rank included) lands on
    the same digest as inline ranks and as the program run in-process."""
    from repro_torch.coord.worker import _program_spec, state_digest, WorkerConfig
    from repro_torch.proxy.programs import make_program

    kw = dict(n_hosts=2, total_steps=4, ckpt_every=2, backend="thread",
              loop="torch", device="cpu", deadline_s=300.0)
    proxied = run_cluster(root=str(tmp_path / "proxied"), device_runner="proxy",
                          kill_host=0, kill_at_step=4, **kw)
    inline = run_cluster(root=str(tmp_path / "inline"), **kw)
    assert proxied.restarts[0] == 1
    assert proxied.lockstep() and inline.lockstep()
    assert [r.step for r in proxied.committed] == [2, 4]
    spec = _program_spec(WorkerConfig(host=0, n_hosts=2, coord_host="", coord_port=0,
                                      root="", total_steps=4, ckpt_every=2,
                                      loop="torch", device="cpu"))
    prog = make_program(spec)
    d = prog.on_restore(prog.init_state())
    for s in range(1, 5):
        d, _ = prog.step(d, s)
    want = state_digest(d)
    assert set(proxied.final_digests.values()) == {want}
    assert set(inline.final_digests.values()) == {want}
    # the proxied ranks' acks carried the proxy's fused digest tables, equal
    # to the inline ranks' provenance tables of the same round, and the
    # proxy's launches over the window (none without a card)
    for packs, iacks in zip(proxied.acks, inline.acks):
        for h, a in packs.items():
            assert a["chunk_digests"] == iacks[h]["chunk_digests"]
            assert a["step_launches"] == {"chunk_digest": 0, "flash_attention": 0}
            assert a["provenance_launches"] == 0 and a["sync_launches"] == 0


def test_paged_proxy_ranks_converge_on_the_unmanaged_bits(tmp_path):
    """``device_capacity``: each rank's proxy holds its torch_tiny state
    in a managed space at half its bytes; the ranks still commit both
    rounds and finish on the same digest as unmanaged proxied ranks."""
    kw = dict(n_hosts=2, total_steps=4, ckpt_every=2, backend="thread",
              loop="torch", device="cpu", device_runner="proxy", deadline_s=300.0)
    paged = run_cluster(root=str(tmp_path / "paged"), device_capacity="50%", **kw)
    plain = run_cluster(root=str(tmp_path / "plain"), **kw)
    assert paged.lockstep() and plain.lockstep()
    assert [r.step for r in paged.committed] == [2, 4]
    assert paged.final_digests == plain.final_digests
