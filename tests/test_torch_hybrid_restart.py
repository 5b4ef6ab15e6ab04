"""PyTorch port: hybrid train states across packages and restarts, and the
hybrid's serving program, on the CPU.

A reduced zamba2-1.2b state (bf16 params beside the f32 ``A_log``, ``D``
and ``dt_bias``, AdamW) written by the reference restores in the port bit
for bit with the reference's chunk digests, and the port's state after a
step, written by the port, restores in the reference bit for bit with the
port's chunk digests. The port's train CLI on the reduced zamba2 resumes
from its newest image bitwise equal to an uninterrupted run on both
persist backends, and its serve CLI serves that image (eager and lazy the
same bits). The port's ``decode_arch`` on the hybrid, stepped in this
process, carries the whole cache tree (SSM states, the shared block's
k/v, ``pos``) in the reference's layout and decodes the reference's
``decode_arch`` tokens, caches within 1e-5 (abs and rel).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as rck
import repro.core as rcore
import repro.models as rmodels
import repro.optim as roptim
from repro.configs import get_config as ref_get_config
from repro.kernels.ops import tree_chunk_digests as ref_tree_chunk_digests
from repro.proxy import make_program as ref_make_program
from repro_torch.checkpoint import ChunkStore
from repro_torch.checkpoint.manifest import committed_steps, load_manifest
from repro_torch.configs import get_config
from repro_torch.core import ForkedCheckpointer, RestoreManager
from repro_torch.kernels.ops import tree_chunk_digests
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import build, hybrid
from repro_torch.models.convert import state_from_numpy
from repro_torch.models.layers import logits_from_embed
from repro_torch.optim import get_optimizer
from repro_torch.proxy import make_program
from repro_torch.runtime.steps import make_train_step
from repro_torch.utils.tree import flatten_with_paths, tree_equal

ARCH = "zamba2-1.2b"
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
BACKENDS = ["thread"] + (["fork"] if hasattr(os, "fork") else [])
CB = 1 << 12
TOL = 1e-5


def _bits(x) -> tuple:
    """(dtype name, shape, bytes) of a tensor or a (possibly bf16) array."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).replace("torch.", "")
        if x.dtype == torch.bfloat16:
            x = x.view(torch.uint16)
        a = x.numpy()
    else:
        a = np.asarray(x)
        name = a.dtype.name
        if name == "bfloat16":
            a = a.view(np.uint16)
    return name, a.shape, a.tobytes()


def _same(a, b) -> None:
    fa, fb = flatten_with_paths(a)[0], flatten_with_paths(b)[0]
    assert list(fa) == list(fb)
    for path in fa:
        assert _bits(fa[path]) == _bits(fb[path]), path


def _stored_digests(store: str, step: int) -> dict:
    manifest = load_manifest(store, step)
    return {path: [c.digest for sh in lv.shards for c in sh.chunks]
            for path, lv in manifest.leaves.items()}


def test_train_state_crosses_packages_bitwise_both_ways(tmp_path):
    rcfg = ref_get_config(ARCH, smoke=True).with_overrides(**BF16)
    cfg = get_config(ARCH, smoke=True).with_overrides(**BF16)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 33)).astype(np.int32)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}

    # the reference writes its init (bf16 params, f32 SSM leaves, AdamW)
    params = jax.jit(rmodels.build(rcfg).init)(jax.random.key(0))
    rstate = {"params": params, "opt": roptim.get_optimizer("adamw", 1e-3).init(params),
              "step": jnp.asarray(0, jnp.int32)}
    rdev = jax.tree.map(np.asarray, rstate)
    assert rdev["params"]["blocks"]["ssm"]["A_log"].dtype == np.float32
    assert rdev["params"]["shared"]["attn"]["wq"].dtype.name == "bfloat16"
    ck = rcore.ForkedCheckpointer(rck.ChunkStore(str(tmp_path / "jax")), chunk_bytes=CB)
    ck.save_async(1, {"device": rstate, "host": {"step": np.int64(1)}}).wait()
    ck.close()

    # the port restores it bitwise, with the reference's chunk digests ...
    got, _ = RestoreManager(ChunkStore(str(tmp_path / "jax"))).restore(
        device_for=lambda p, s: "cpu" if p.startswith("device/") else None, verify=True)
    _same(got["device"], rdev)
    assert tree_chunk_digests(got, CB) == _stored_digests(str(tmp_path / "jax"), 1)
    # ... steps once, and writes step 2
    step = make_train_step(build(cfg), get_optimizer("adamw", 1e-3))
    dev, metrics = step(got["device"], {k: torch.from_numpy(v) for k, v in batch.items()})
    assert int(dev["step"]) == 1 and np.isfinite(float(metrics["loss"]))
    ck = ForkedCheckpointer(ChunkStore(str(tmp_path / "port")), chunk_bytes=CB)
    ck.save_async(2, {"device": dev, "host": {"step": np.int64(2)}}).wait()
    ck.close()

    # ... which the reference restores bitwise, with the port's digests
    back, manifest = rcore.RestoreManager(rck.ChunkStore(str(tmp_path / "port"))).restore()
    assert manifest.step == 2
    _same(jax.tree.map(np.asarray, back["device"]), dev)
    assert ref_tree_chunk_digests(back, CB) == _stored_digests(str(tmp_path / "port"), 2)


def _argv(store, steps, backend):
    return ["--arch", ARCH, "--smoke", "--steps", str(steps), "--batch", "2", "--seq", "32",
            "--ckpt-every", "2", "--log-every", "1", "--device", "cpu",
            "--backend", backend, "--ckpt-dir", store]


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """4 steps in one run: (the CLI's result, its store)."""
    store = str(tmp_path_factory.mktemp("whole") / "ck")
    return train_cli.train(_argv(store, 4, "thread")), store


@pytest.mark.parametrize("backend", BACKENDS)
def test_train_cli_resumes_bitwise(tmp_path, uninterrupted, backend, capsys):
    store = str(tmp_path / "ck")
    first = train_cli.train(_argv(store, 2, backend))
    assert first["final_step"] == 2
    resumed = train_cli.train(_argv(store, 4, backend))
    assert "start_step=2" in capsys.readouterr().out
    assert resumed["final_step"] == 4 and committed_steps(store) == [2, 4]
    assert tree_equal(resumed["state"], uninterrupted[0]["state"])
    assert np.isfinite(resumed["metrics"]["loss"])


def test_serve_cli_serves_the_hybrid_image_lazy_as_eager(uninterrupted):
    """The CLI serves the step-4 image at a 64-token prompt (the smoke
    chunked-attention threshold: the shared block's prefill takes the flash
    lowering), lazily and eagerly to the same bits; the prefill's logits
    equal the forward's at the last prompt position bit for bit."""
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--ckpt-dir", uninterrupted[1],
            "--prompt-len", "64", "--gen", "4"]
    lazy = serve_cli.serve(argv + ["--lazy"])
    eager = serve_cli.serve(argv)
    assert lazy["step"] == 4 and lazy["tokens"].shape == (2, 4)
    assert np.array_equal(lazy["tokens"], eager["tokens"])
    assert torch.equal(lazy["logits"], eager["logits"])
    with torch.device("meta"):
        module = hybrid.Hybrid(get_config(ARCH, smoke=True))
    params = lazy["params"]
    with torch.no_grad():
        h, _ = hybrid.hidden_forward(module, params, lazy["prompt"])
    assert torch.equal(logits_from_embed(params["embed"], h[:, -1:])[:, 0],
                       lazy["logits"][:, 0])


SPEC = {"name": "decode_arch", "arch": ARCH, "smoke": True, "batch": 2,
        "prompt_len": 32, "gen": 6}


def test_decode_arch_carries_the_hybrid_cache_and_decodes_the_reference_tokens():
    prog = make_program(dict(SPEC, device="cpu"))
    ref = ref_make_program(SPEC)
    rs = ref.init_state()
    want = flatten_with_paths(jax.tree.map(np.asarray, rs))[0]
    for state in (prog.init_state(), prog.meta_state()):
        got = flatten_with_paths(state)[0]
        assert list(got) == list(want)
        for p, t in got.items():
            assert tuple(t.shape) == want[p].shape, p
            assert str(t.dtype).removeprefix("torch.") == want[p].dtype.name, p
    assert {"cache/ssm/h", "cache/ssm/conv", "cache/k", "cache/v", "cache/pos"} <= set(want)
    ts = prog.on_restore(state_from_numpy(jax.tree.map(np.asarray, rs)))
    for n in range(1, SPEC["prompt_len"] + SPEC["gen"]):
        rs, rm = ref.step(rs, n)
        ts, tm = prog.step(ts, n)
        assert int(ts["cache"]["pos"]) == int(rs["cache"]["pos"]) == n
        assert np.array_equal(ts["toks"].numpy(), np.asarray(rs["toks"])), n
        assert float(tm["tok0"]) == float(rm["tok0"])
    cache = flatten_with_paths(ts["cache"])[0]
    ref_cache = flatten_with_paths(jax.tree.map(np.asarray, rs["cache"]))[0]
    for path, t in cache.items():
        np.testing.assert_allclose(t.numpy(), ref_cache[path], atol=TOL, rtol=TOL,
                                   err_msg=path)
    assert not np.array_equal(ts["toks"][:, SPEC["prompt_len"]:].numpy(),
                              np.zeros((2, SPEC["gen"])))
