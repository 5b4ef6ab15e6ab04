"""PyTorch port: serving (prefill, decode, lazy restore, the serve CLI).

On the smoke config (f32, ``attn_chunked_threshold`` 64, blocks 32) a
prompt of 128 tokens takes the long-S lowering, which on the CPU is the
flash kernel's plain version; 16 tokens take the dense one. Parity is by
weight transfer from the JAX reference, 1e-5 (abs and rel) on logits and
caches. The serve CLI restores stores written by either package's train
CLI, eagerly and lazily, and must emit the JAX model's greedy tokens.
The lazy-restore tests are twins of ``tests/core/test_lazy_readahead.py``
and of the lazy tests of ``tests/core/test_restore_failure.py``.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as rmodels
from repro.checkpoint import ChunkStore as RefStore
from repro.checkpoint import save_pytree
from repro.configs import get_config as ref_get_config
from repro.core import RestoreManager as RefRestoreManager
from repro.launch import train as ref_train_cli
from repro_torch.checkpoint import ChunkStore
from repro_torch.checkpoint.manifest import load_manifest
from repro_torch.configs import get_config
from repro_torch.core import LazyLeaves, RestoreManager
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import build
from repro_torch.models.convert import state_from_numpy
from repro_torch.utils.tree import tree_equal

B = 2
ARCH = "qwen2-0.5b"
TOL = 1e-5


@pytest.fixture(scope="module")
def ref_cfg():
    return ref_get_config(ARCH, smoke=True)


@pytest.fixture(scope="module")
def cfg():
    c = get_config(ARCH, smoke=True)
    assert c.attn_chunked_threshold == 64 and c.attn_block_q == c.attn_block_k == 32
    return c


@pytest.fixture(scope="module")
def ref_params(ref_cfg):
    return rmodels.build(ref_cfg).init(jax.random.key(0))


@pytest.fixture(scope="module")
def tparams(ref_params):
    return state_from_numpy(jax.tree.map(np.asarray, ref_params))


def _tokens(cfg, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol, rtol=tol)


# -- prefill / decode against the reference ------------------------------------

@pytest.mark.parametrize("S", [16, 128], ids=["dense", "long_S"])
def test_prefill_matches_jax(cfg, ref_cfg, ref_params, tparams, S):
    toks = _tokens(cfg, S)
    with torch.no_grad():
        logits, cache = build(cfg).prefill(tparams, {"inputs": torch.from_numpy(toks)}, S + 8)
    rlogits, rcache = rmodels.build(ref_cfg).prefill(ref_params, {"inputs": jnp.asarray(toks)},
                                                     S + 8)
    assert logits.shape == (B, 1, cfg.vocab_size) and logits.dtype == torch.float32
    assert cache["k"].shape == (cfg.num_layers, B, cfg.num_kv_heads, S + 8, cfg.head_dim)
    assert cache["pos"] == int(rcache["pos"]) == S
    _close(logits, rlogits)
    _close(cache["k"], rcache["k"])
    _close(cache["v"], rcache["v"])
    assert not cache["k"][:, :, :, S:].any()  # zero-padded past the prompt


@pytest.mark.parametrize("S", [16, 128], ids=["dense", "long_S"])
def test_decode_steps_match_jax(cfg, ref_cfg, ref_params, tparams, S):
    toks = _tokens(cfg, S + 3)
    model, rmodel = build(cfg), rmodels.build(ref_cfg)
    with torch.no_grad():
        _, cache = model.prefill(tparams, {"inputs": torch.from_numpy(toks[:, :S])}, S + 3)
        _, rcache = rmodel.prefill(ref_params, {"inputs": jnp.asarray(toks[:, :S])}, S + 3)
        for t in range(S, S + 3):
            logits, cache = model.decode(tparams, cache, torch.from_numpy(toks[:, t]))
            rlogits, rcache = rmodel.decode(ref_params, rcache, jnp.asarray(toks[:, t]))
            assert logits.shape == (B, cfg.vocab_size) and cache["pos"] == t + 1
            _close(logits, rlogits)
    _close(cache["k"], rcache["k"])
    _close(cache["v"], rcache["v"])


def test_teacher_forced_decode_matches_forward(cfg, tparams):
    """Twin of tests/models/test_arch_smoke.py::test_decode_matches_forward,
    from an empty cache; the reference allows 2e-2, f32 here holds 1e-4."""
    toks = _tokens(cfg, 16, seed=2)
    model = build(cfg)
    with torch.no_grad():
        full = model.forward(tparams, {"inputs": torch.from_numpy(toks)})
        cache = model.init_cache(B, 16, device="cpu")
        for t in range(16):
            lg, cache = model.decode(tparams, cache, torch.from_numpy(toks[:, t]))
            _close(lg, full[:, t], 1e-4)


def test_long_prefill_then_decode_matches_forward(cfg, tparams):
    """The serve path's own check at smoke size: prefill 128 tokens through
    the long-S lowering, decode 8 teacher-forced tokens, and compare with
    one forward over all 136 (which takes the dense lowering: 136 % 32)."""
    S, G = 128, 8
    toks = _tokens(cfg, S + G, seed=3)
    model = build(cfg)
    with torch.no_grad():
        full = model.forward(tparams, {"inputs": torch.from_numpy(toks)})
        lg, cache = model.prefill(tparams, {"inputs": torch.from_numpy(toks[:, :S])}, S + G)
        got = [lg[:, 0]]
        for t in range(S, S + G - 1):
            lg, cache = model.decode(tparams, cache, torch.from_numpy(toks[:, t]))
            got.append(lg)
    _close(torch.stack(got, dim=1), full[:, S - 1 : S + G - 1], 1e-4)


# -- the serve CLI ---------------------------------------------------------------

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


def _jax_greedy(ref_cfg, store, prompt, gen):
    """The reference model's prefill/decode tokens on the stored params."""
    state, _ = RefRestoreManager(RefStore(store)).restore()
    params = jax.tree.map(jnp.asarray, state["device"]["params"])
    rmodel = rmodels.build(ref_cfg)
    logits, cache = rmodel.prefill(params, {"inputs": jnp.asarray(prompt)},
                                   prompt.shape[1] + gen)
    toks, lgs = [jnp.argmax(logits[:, -1], -1).astype(jnp.int32)], [logits[:, -1]]
    for _ in range(gen - 1):
        logits, cache = rmodel.decode(params, cache, toks[-1])
        toks.append(jnp.argmax(logits, -1).astype(jnp.int32))
        lgs.append(logits)
    return np.stack([np.asarray(t) for t in toks], 1), np.stack([np.asarray(x) for x in lgs], 1)


@pytest.mark.parametrize("lazy", [False, True], ids=["eager", "lazy"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_serve_cpu_emits_the_jax_models_tokens(ref_cfg, stores, writer, lazy, capsys):
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--ckpt-dir", stores[writer],
            "--prompt-len", "128", "--gen", "4"] + (["--lazy"] if lazy else [])
    out = serve_cli.serve(argv)
    printed = capsys.readouterr().out
    assert "restored step 2 in" in printed and f"(lazy={lazy})" in printed
    assert "prefill(128 tokens) -> first logits in" in printed
    assert out["step"] == 2 and out["tokens"].shape == (B, 4)
    assert out["restore_s"] > 0 and out["ttft_s"] > 0 and out["decode_tok_s"] > 0
    want_toks, want_logits = _jax_greedy(ref_cfg, stores[writer], out["prompt"].numpy(), 4)
    np.testing.assert_array_equal(out["tokens"], want_toks)
    _close(out["logits"], want_logits)


def test_serve_fresh_init_without_checkpoint(capsys):
    out = serve_cli.serve(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--prompt-len", "16", "--gen", "3"])
    assert "fresh init in" in capsys.readouterr().out
    assert out["step"] is None and out["tokens"].shape == (B, 3)
    assert bool(out["logits"].isfinite().all())


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--arch", ARCH, "--smoke"])


@pytest.mark.parametrize("extra", [["--device-runner", "proxy"],
                                   ["--proxy-endpoint", "127.0.0.1:7070"],
                                   ["--transport", "stream"]])
def test_serve_proxy_runner_is_not_ported(extra):
    """The proxy runner is ported (``tests/test_torch_serve_proxy.py``): it
    decodes on the card unless asked for the CPU, and its flags without
    ``--device-runner proxy`` are refused, not ignored."""
    if extra[0] == "--device-runner":
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present: the default device is usable")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve_cli.serve(["--arch", ARCH, "--smoke"] + extra)
        return
    with pytest.raises(ValueError, match="need --device-runner proxy"):
        serve_cli.serve(["--arch", ARCH, "--smoke", "--device", "cpu"] + extra)


# -- lazy restore ----------------------------------------------------------------

def _big_state(n_leaves):
    return {f"p{i:02d}": jnp.full((256,), i, jnp.float32) for i in range(n_leaves)}


def _lazy(tmp_store, n_leaves, **kw):
    save_pytree(_big_state(n_leaves), tmp_store, 1)
    return RestoreManager(ChunkStore(tmp_store.root)).restore(lazy=True, **kw)[0]


def test_window_grows_exponentially_1_2_4(tmp_store):
    lazy = _lazy(tmp_store, 32)
    assert lazy._window == 1          # paper: first fault reads one page
    observed = []
    for k in lazy.keys()[:4]:
        lazy[k]
        observed.append(lazy._window)
    assert observed == [2, 4, 8, 16]  # doubles on each forward access
    lazy.close()


def test_window_clamped_at_max_readahead(tmp_store):
    save_pytree(_big_state(32), tmp_store, 1)
    store = ChunkStore(tmp_store.root)
    lazy = LazyLeaves(store, load_manifest(store.root, 1), None, max_readahead=4)
    for k in lazy.keys()[:8]:
        lazy[k]
        assert lazy._window <= 4
    assert lazy._window == 4
    lazy.close()


def test_backward_jump_resets_then_regrows(tmp_store):
    lazy = _lazy(tmp_store, 32)
    keys = lazy.keys()
    lazy[keys[10]]
    lazy[keys[11]]
    assert lazy._window == 4
    lazy[keys[2]]                 # backward jump: new region
    assert lazy._window == 1
    lazy[keys[3]]
    assert lazy._window == 2      # regrows from the reset stride
    lazy.close()


def test_concurrent_first_access_materializes_once(tmp_store):
    lazy = _lazy(tmp_store, 4)
    path = lazy.keys()[0]
    results, errs = [], []
    barrier = threading.Barrier(8)

    def hit():
        try:
            barrier.wait(timeout=10)
            results.append(lazy[path])
        except Exception as e:  # pragma: no cover - failure path
            errs.append(e)

    threads = [threading.Thread(target=hit) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs and len(results) == 8
    assert all(r is results[0] for r in results)  # one materialization
    assert np.array_equal(np.asarray(results[0]), np.full((256,), 0, np.float32))
    assert lazy.loads <= len(lazy.keys())
    lazy.close()


def test_lazy_restore_returns_correct_leaves(tmp_store):
    lazy = _lazy(tmp_store, 12)
    assert np.array_equal(np.asarray(lazy["p03"]), np.full((256,), 3, np.float32))
    want = {f"p{i:02d}": np.full((256,), i, np.float32) for i in range(12)}
    assert tree_equal(want, lazy.as_tree())
    lazy.close()


def test_lazy_readahead_window_grows(tmp_store):
    lazy = _lazy(tmp_store, 16)
    keys = lazy.keys()
    lazy[keys[0]]
    w1 = lazy._window
    lazy[keys[1]]
    assert lazy._window >= w1  # sequential access grows the window
    lazy2 = RestoreManager(ChunkStore(tmp_store.root)).restore(lazy=True)[0]
    lazy2[lazy2.keys()[8]]
    assert lazy2._window > 1
    lazy2[lazy2.keys()[2]]    # backward jump to an uncached leaf
    assert lazy2._window == 1
    lazy.close()
    lazy2.close()


def test_lazy_prefetch_reduces_sync_loads(tmp_store):
    lazy = _lazy(tmp_store, 16)
    for k in lazy.keys():
        lazy[k]
        time.sleep(0.01)  # let prefetchers land
    assert lazy.loads <= len(lazy.keys()) + 2
    lazy.close()


def test_lazy_read_failure_is_retried_not_cached(tmp_store, monkeypatch):
    lazy = _lazy(tmp_store, 4)
    real = lazy._materialize
    calls = []

    def flaky(path):
        calls.append(path)
        if len(calls) == 1:
            raise OSError("transient read failure")
        return real(path)

    monkeypatch.setattr(lazy, "_materialize", flaky)
    with pytest.raises(OSError, match="transient"):
        lazy["p00"]
    assert np.array_equal(np.asarray(lazy["p00"]), np.zeros(256, np.float32))
    assert calls[:2] == ["p00", "p00"]
    lazy.close()


def test_lazy_places_leaves_where_device_for_says(tmp_store):
    """device_for names the device per leaf; None keeps the leaf on the host."""
    lazy = _lazy(tmp_store, 4, device_for=lambda p, s: "cpu" if p == "p01" else None)
    assert isinstance(lazy["p01"], torch.Tensor)
    assert isinstance(lazy["p02"], np.ndarray)
    lazy.close()


def test_lazy_equals_eager_on_a_jax_written_store(stores):
    rm = RestoreManager(ChunkStore(stores["jax"]))
    eager, _ = rm.restore(device_for=lambda p, s: "cpu")
    lazy, manifest = rm.restore(lazy=True, device_for=lambda p, s: "cpu")
    assert manifest.step == 2
    assert tree_equal(eager, lazy.as_tree())
    lazy.close()
