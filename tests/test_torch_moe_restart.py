"""PyTorch port: MoE train states across packages and restarts, on the CPU.

A reduced moonshot-v1-16b-a3b state (AdamW, and q8adam's int8 codes) and
a reduced arctic-480b state (adafactor, 2 microbatches, bf16
accumulation), all with bf16 params and the f32 router, written after a
step of the reference restore
in the port bit for bit, and written after a step of the port restore in
the reference bit for bit. The port's train CLI on the reduced moonshot
resumes from its newest image bitwise equal to an uninterrupted run, on
both persist backends, and its serve CLI serves that image with the
reference model's tokens.
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
from repro.launch.mesh import make_host_mesh, use_mesh
from repro.runtime.sharding import ShardingRules
from repro.runtime.steps import make_train_step as ref_make_train_step
from repro.utils.tree import flatten_with_paths as ref_flatten
from repro_torch.checkpoint import ChunkStore
from repro_torch.checkpoint.manifest import committed_steps
from repro_torch.configs import get_config
from repro_torch.core import ForkedCheckpointer, RestoreManager
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import build
from repro_torch.optim import get_optimizer
from repro_torch.runtime.steps import make_train_step
from repro_torch.utils.tree import flatten_with_paths, tree_equal

BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
STATES = {"moonshot-adamw": ("moonshot-v1-16b-a3b", dict(microbatches=1)),
          "arctic-adafactor": ("arctic-480b", dict(microbatches=2, accum_dtype="bfloat16")),
          "moonshot-q8adam": ("moonshot-v1-16b-a3b", dict(optimizer="q8adam"))}
BACKENDS = ["thread"] + (["fork"] if hasattr(os, "fork") else [])


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


@pytest.mark.parametrize("case", list(STATES))
def test_train_state_crosses_packages_bitwise_both_ways(tmp_path, case):
    name, over = STATES[case]
    over = dict(BF16, **over)
    rcfg = ref_get_config(name, smoke=True).with_overrides(**over)
    cfg = get_config(name, smoke=True).with_overrides(**over)
    assert cfg.optimizer == case.split("-")[1]
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (4, 17)).astype(np.int32)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}

    # the reference: one step, then its checkpointer writes step 1
    rmodel = rmodels.build(rcfg)
    ropt = roptim.get_optimizer(rcfg.optimizer, 1e-3)
    params = rmodel.init(jax.random.key(0))
    mesh = make_host_mesh((1,), ("data",))
    with use_mesh(mesh):
        rstep, _, _ = ref_make_train_step(rmodel, ShardingRules(cfg=rcfg, mesh=mesh), ropt,
                                          donate=False)
        rstate, _ = rstep({"params": params, "opt": ropt.init(params),
                           "step": jnp.asarray(0, jnp.int32)},
                          jax.tree.map(jnp.asarray, batch))
    rdev = jax.tree.map(np.asarray, rstate)
    assert ref_flatten(rdev)[0]["params/blocks/moe/router"].dtype == np.float32
    ck = rcore.ForkedCheckpointer(rck.ChunkStore(str(tmp_path / "jax")), chunk_bytes=1 << 12)
    ck.save_async(1, {"device": rstate, "host": {"step": np.int64(1)}}).wait()
    ck.close()

    # the port restores it bitwise, steps once, and writes step 2
    got, _ = RestoreManager(ChunkStore(str(tmp_path / "jax"))).restore(
        device_for=lambda p, s: "cpu" if p.startswith("device/") else None, verify=True)
    _same(got["device"], rdev)
    step = make_train_step(build(cfg), get_optimizer(cfg.optimizer, 1e-3))
    dev, metrics = step(got["device"], {k: torch.from_numpy(v) for k, v in batch.items()})
    assert int(dev["step"]) == 2 and np.isfinite(float(metrics["loss"]))
    ck = ForkedCheckpointer(ChunkStore(str(tmp_path / "port")), chunk_bytes=1 << 12)
    ck.save_async(2, {"device": dev, "host": {"step": np.int64(2)}}).wait()
    ck.close()

    # ... which the reference restores bitwise
    back, manifest = rcore.RestoreManager(rck.ChunkStore(str(tmp_path / "port"))).restore()
    assert manifest.step == 2
    _same(jax.tree.map(np.asarray, back["device"]), dev)


ARCH = "moonshot-v1-16b-a3b"


def _argv(store, steps, backend):
    return ["--arch", ARCH, "--smoke", "--steps", str(steps), "--batch", "2", "--seq", "16",
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


@pytest.mark.parametrize("lazy", [False, True], ids=["eager", "lazy"])
def test_serve_cli_serves_the_moe_image(uninterrupted, lazy):
    """The CLI serves the step-4 image; the reference restores the same
    image and its prefill and greedy decode give the same tokens."""
    store = uninterrupted[1]
    out = serve_cli.serve(["--arch", ARCH, "--smoke", "--device", "cpu", "--ckpt-dir", store,
                           "--prompt-len", "16", "--gen", "4"] + (["--lazy"] if lazy else []))
    assert out["step"] == 4 and out["tokens"].shape == (2, 4)
    state, _ = rcore.RestoreManager(rck.ChunkStore(store)).restore()
    params = jax.tree.map(jnp.asarray, state["device"]["params"])
    rmodel = rmodels.build(ref_get_config(ARCH, smoke=True))
    logits, cache = rmodel.prefill(params, {"inputs": jnp.asarray(out["prompt"].numpy())}, 20)
    toks = [jnp.argmax(logits[:, -1], -1).astype(jnp.int32)]
    rdecode = jax.jit(rmodel.decode)
    for _ in range(3):
        logits, cache = rdecode(params, cache, toks[-1])
        toks.append(jnp.argmax(logits, -1).astype(jnp.int32))
    np.testing.assert_array_equal(out["tokens"], np.stack([np.asarray(t) for t in toks], 1))
