"""PyTorch port: serving through a (remote) device proxy, against the reference.

``decode_arch`` is greedy batched decode as a replayable step program: its
state is the reference's tree leaf for leaf (``cache/pos`` a 0-d int32
tensor), and stepping both packages' programs on the smoke config with
carried-over weights gives equal tokens, with logits and caches within
1e-5 (abs and rel, as ``tests/test_torch_serve.py``). The serve CLI's
``--device-runner proxy --device cpu`` decodes in a local proxy (segment
transport, SIGKILLed once mid-decode) and in a proxy-host daemon (stream
transport): its tokens equal the inline ``decode_arch`` run's, and the
final SYNC moves no params chunk. Images written by either package's
train CLI serve through the port's proxy to the reference's tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ChunkStore as RefStore
from repro.core import RestoreManager as RefRestoreManager
from repro.launch import train as ref_train_cli
from repro.proxy import make_program as ref_make_program
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models.convert import state_from_numpy
from repro_torch.proxy import ProxyRunner, make_program
from repro_torch.remote.host import ProxyHostHandle
from repro_torch.utils.dtypes import leaf_nbytes
from repro_torch.utils.tree import flatten_with_paths, tree_equal

ARCH = "qwen2-0.5b"
B, P, G = 2, 12, 6
SPEC = {"name": "decode_arch", "arch": ARCH, "smoke": True, "batch": B,
        "prompt_len": P, "gen": G}
TOL = 1e-5
SERVE = ["--arch", ARCH, "--smoke", "--device", "cpu", "--device-runner", "proxy",
         "--batch", str(B), "--prompt-len", str(P), "--gen", str(G)]


def _port_spec(**kw):
    return dict(SPEC, device="cpu", **kw)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               atol=TOL, rtol=TOL)


# -- the program ----------------------------------------------------------------

def test_decode_arch_state_matches_reference_layout():
    """Same paths, shapes and dtype names as the reference's DecodeArch,
    in the init, the proxy's empty state and the meta structure; the same
    prompt; ``state_nbytes`` without drawing an init."""
    prog = make_program(_port_spec())
    ref = ref_make_program(SPEC)
    ref_state = jax.tree.map(np.asarray, ref.init_state())
    want = flatten_with_paths(ref_state)[0]
    for state in (prog.init_state(), prog.empty_state(), prog.meta_state()):
        got = flatten_with_paths(state)[0]
        assert list(got) == list(want)
        for p, t in got.items():
            assert isinstance(t, torch.Tensor)
            assert tuple(t.shape) == want[p].shape, p
            assert str(t.dtype).removeprefix("torch.") == want[p].dtype.name, p
    pos = prog.init_state()["cache"]["pos"]
    assert pos.shape == () and pos.dtype == torch.int32 and int(pos) == 0
    assert np.array_equal(prog.init_state()["toks"].numpy(), want["toks"])
    assert np.array_equal(prog.prompt(), want["toks"][:, :P])
    assert prog.state_nbytes() == ref.state_nbytes() == sum(a.nbytes for a in want.values())


def test_decode_arch_depth_cut_keeps_the_widths():
    full = flatten_with_paths(make_program(_port_spec()).meta_state())[0]
    cut = flatten_with_paths(make_program(_port_spec(num_layers=1)).meta_state())[0]
    assert list(cut) == list(full)
    for p, t in cut.items():
        if p.startswith(("params/blocks/", "cache/k", "cache/v")):
            assert t.shape[0] == 1 and t.shape[1:] == full[p].shape[1:], p
        else:
            assert t.shape == full[p].shape, p


def test_decode_arch_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_program(SPEC)


def test_decode_arch_steps_match_the_reference():
    """Carried-over weights: the same tokens at every step, logits and
    caches within 1e-5, ``cache/pos`` equal to the reference's."""
    prog = make_program(_port_spec())
    ref = ref_make_program(SPEC)
    rs = ref.init_state()
    ts = prog.on_restore(state_from_numpy(jax.tree.map(np.asarray, rs)))
    for n in range(1, P + G):
        tok = rs["toks"][:, n - 1]
        want_logits, _ = ref.model.decode(rs["params"], rs["cache"], tok)
        cache = {"k": ts["cache"]["k"].clone(), "v": ts["cache"]["v"].clone(), "pos": n - 1}
        got_logits, _ = prog.model.decode(ts["params"], cache, ts["toks"][:, n - 1])
        _close(got_logits, want_logits)
        rs, rm = ref.step(rs, n)
        ts, tm = prog.step(ts, n)
        assert int(ts["cache"]["pos"]) == int(rs["cache"]["pos"]) == n
        assert np.array_equal(ts["toks"].numpy(), np.asarray(rs["toks"])), n
        assert float(tm["tok0"]) == float(rm["tok0"])
        _close(ts["cache"]["k"], rs["cache"]["k"])
        _close(ts["cache"]["v"], rs["cache"]["v"])
    assert not np.array_equal(ts["toks"][:, P:].numpy(), np.zeros((B, G)))


def _inline():
    """The port's decode_arch stepped in this process from a fresh init:
    its final state."""
    prog = make_program(_port_spec())
    state = prog.on_restore(prog.init_state())
    for n in range(1, P + G):
        state, _ = prog.step(state, n)
    return state


def _check_decoded(out):
    """Tokens and the synced cache bit for bit as the inline run's."""
    want = _inline()
    np.testing.assert_array_equal(out["tokens"], want["toks"][:, P:].numpy())
    assert tree_equal(out["cache"], want["cache"])
    assert int(out["cache"]["pos"]) == P + G - 1


def _clean_bound():
    """Bytes a SYNC may move when the params stay clean: cache and toks."""
    flat = flatten_with_paths(make_program(_port_spec()).meta_state())[0]
    return sum(leaf_nbytes(t) for p, t in flat.items() if not p.startswith("params/"))


def _check_sync(out):
    info = out["info"]
    assert info["phase_us"]["steps"] == P + G - 1
    assert 0 < info["bytes_synced"] <= _clean_bound()
    assert info["chunks_synced"] <= 4  # cache/k, cache/v, cache/pos, toks


# -- the serve CLI through a proxy -------------------------------------------------

def test_serve_proxy_local_killed_mid_decode(monkeypatch, capsys):
    """A local segment proxy SIGKILLed once after step 9 is issued: the
    API log replays and the tokens equal the inline run's."""
    step, killed = ProxyRunner.step, []

    def killing_step(self, n):
        step(self, n)
        if n == 9 and not killed:
            killed.append(self.kill())

    monkeypatch.setattr(ProxyRunner, "step", killing_step)
    out = serve_cli.serve(SERVE)
    printed = capsys.readouterr().out
    assert killed and killed[0] is not None
    assert out["restarts"] == 1 and "restarts=1" in printed
    assert "proxy=local transport=segment device=cpu" in printed
    assert out["step"] is None and out["push_s"] > 0 and out["decode_tok_s"] > 0
    _check_decoded(out)
    assert np.array_equal(out["prompt"], make_program(_port_spec()).prompt())
    _check_sync(out)


def test_serve_proxy_against_a_daemon(capsys):
    d = ProxyHostHandle("serve-ph", device="cpu").start()
    try:
        out = serve_cli.serve(SERVE + ["--proxy-endpoint", "%s:%d" % d.addr])
    finally:
        d.terminate()
    printed = capsys.readouterr().out
    assert f"proxy={d.cfg.bind}:{d.port} transport=stream" in printed
    assert out["restarts"] == 0
    _check_decoded(out)
    _check_sync(out)
    wire = out["info"]["transport"]
    # the params rode the wire once, at the push; the sync brought back
    # only what decode dirtied
    assert wire["raw_tx"] >= make_program(_port_spec()).state_nbytes()
    assert 0 < wire["raw_rx"] <= _clean_bound()


def test_serve_proxy_ships_a_cuda_program_from_a_machine_without_a_card(monkeypatch):
    """The application checks no device of its own for a remote proxy: an
    application that sees no card serves a ``cuda`` spec through a daemon.
    The stub daemon serves real sessions on threads of this process, records
    each PROGRAM's spec and computes it on the CPU."""
    import socket
    import threading

    from repro_torch.coord.protocol import Connection
    from repro_torch.proxy.service import ProxyService

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seen, on_program = [], ProxyService._on_program

    def cpu_program(self, msg):
        seen.append(msg["spec"])
        on_program(self, dict(msg, spec=dict(msg["spec"], device="cpu")))

    monkeypatch.setattr(ProxyService, "_on_program", cpu_program)
    listener = socket.create_server(("127.0.0.1", 0))

    def accept():
        while True:
            try:
                sock, _ = listener.accept()
            except OSError:
                return
            threading.Thread(target=ProxyService(Connection(sock)).serve,
                             daemon=True).start()

    threading.Thread(target=accept, daemon=True).start()
    argv = [a for a in SERVE if a not in ("--device", "cpu")]
    try:
        out = serve_cli.serve(argv + ["--proxy-endpoint",
                                      "%s:%d" % listener.getsockname()])
    finally:
        listener.close()
    assert [s["device"] for s in seen] == ["cuda"]
    assert out["restarts"] == 0
    _check_decoded(out)
    _check_sync(out)


def test_serve_proxy_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.serve([a for a in SERVE if a not in ("--device", "cpu")])


# -- images of either package ------------------------------------------------------

def _train_argv(store):
    return ["--arch", ARCH, "--smoke", "--steps", "2", "--batch", "2", "--seq", "16",
            "--ckpt-every", "2", "--log-every", "1", "--ckpt-dir", store]


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """A step-2 image written by each package's train CLI."""
    jax_store = str(tmp_path_factory.mktemp("jax") / "ckpt")
    port_store = str(tmp_path_factory.mktemp("port") / "ckpt")
    assert ref_train_cli.main(_train_argv(jax_store)) == 0
    assert train_cli.main(_train_argv(port_store) + ["--device", "cpu"]) == 0
    return {"jax": jax_store, "port": port_store}


def _reference_tokens(store):
    """The reference's decode_arch on the params the reference restores."""
    state, _ = RefRestoreManager(RefStore(store)).restore()
    ref = ref_make_program(SPEC)
    d = ref.init_state()
    d["params"] = jax.tree.map(jnp.asarray, state["device"]["params"])
    for n in range(1, P + G):
        d, _ = ref.step(d, n)
    return np.asarray(d["toks"])[:, P:]


@pytest.mark.parametrize("lazy", [False, True], ids=["eager", "lazy"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_serve_proxy_serves_either_packages_image(stores, writer, lazy, capsys):
    out = serve_cli.serve(SERVE + ["--ckpt-dir", stores[writer]]
                          + (["--lazy"] if lazy else []))
    assert "restored step 2 in" in capsys.readouterr().out
    assert out["step"] == 2
    np.testing.assert_array_equal(out["tokens"], _reference_tokens(stores[writer]))
    _check_sync(out)
