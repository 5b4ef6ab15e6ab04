"""PyTorch port: multimodal train states across packages and restarts, and
serving both multimodal archs from an image, on the CPU.

A reduced paligemma-3b and a reduced musicgen-medium state (bf16 params,
AdamW; paligemma's tied ``embed`` and ``vision_proj``, musicgen's codebook
tables and no ``embed``) written by the reference restore in the port bit
for bit with the reference's chunk digests; the port's state after a step
on the same batch, written by the port, restores in the reference bit for
bit with the port's chunk digests. The port's train CLI on the reduced
paligemma (16 patches + 48 text tokens: the chunked lowering with a
prefix) resumes from its newest image bitwise equal to an uninterrupted
run on both persist backends, and its serve CLI serves that image and a
musicgen image (eager and lazy the same bits, the prefill's last logits
those of the forward). The proxied decode program refuses both, as the
reference's does.
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
from repro_torch.models import build, multimodal
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import logits_from_embed
from repro_torch.optim import get_optimizer
from repro_torch.proxy import make_program
from repro_torch.runtime.steps import make_train_step
from repro_torch.utils.tree import flatten_with_paths, tree_equal

ARCHS = ["paligemma-3b", "musicgen-medium"]
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
BACKENDS = ["thread"] + (["fork"] if hasattr(os, "fork") else [])
CB = 1 << 12


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


def _batch(cfg, S=32, seed=0):
    rng = np.random.default_rng(seed)
    K = (cfg.audio_codebooks,) if cfg.frontend == "audio" else ()
    toks = rng.integers(0, cfg.vocab_size, (2, S + 1, *K)).astype(np.int32)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.frontend == "vision":
        batch["patches"] = rng.standard_normal((2, cfg.num_patches, cfg.d_model)).astype(
            np.float32)
    return batch


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_crosses_packages_bitwise_both_ways(tmp_path, arch):
    rcfg = ref_get_config(arch, smoke=True).with_overrides(**BF16)
    cfg = get_config(arch, smoke=True).with_overrides(**BF16)
    batch = _batch(cfg)

    # the reference writes its init (bf16 params, AdamW)
    params = jax.jit(rmodels.build(rcfg).init)(jax.random.key(0))
    rstate = {"params": params, "opt": roptim.get_optimizer("adamw", 1e-3).init(params),
              "step": jnp.asarray(0, jnp.int32)}
    rdev = jax.tree.map(np.asarray, rstate)
    leaves = set(rdev["params"])
    if arch == "paligemma-3b":
        assert {"embed", "vision_proj"} <= leaves and "lm_head" not in leaves
    else:
        assert {"codebook_embed", "codebook_head"} <= leaves and "embed" not in leaves
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


def _argv(arch, store, steps, backend, seq):
    return ["--arch", arch, "--smoke", "--steps", str(steps), "--batch", "2", "--seq",
            str(seq), "--ckpt-every", "2", "--log-every", "1", "--device", "cpu",
            "--backend", backend, "--ckpt-dir", store]


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """paligemma, 4 steps in one run at 16 patches + 48 text tokens: (the
    CLI's result, its store)."""
    store = str(tmp_path_factory.mktemp("whole") / "ck")
    return train_cli.train(_argv(ARCHS[0], store, 4, "thread", 48)), store


@pytest.mark.parametrize("backend", BACKENDS)
def test_train_cli_resumes_bitwise(tmp_path, uninterrupted, backend, capsys):
    store = str(tmp_path / "ck")
    first = train_cli.train(_argv(ARCHS[0], store, 2, backend, 48))
    assert first["final_step"] == 2
    resumed = train_cli.train(_argv(ARCHS[0], store, 4, backend, 48))
    assert "start_step=2" in capsys.readouterr().out
    assert resumed["final_step"] == 4 and committed_steps(store) == [2, 4]
    assert tree_equal(resumed["state"], uninterrupted[0]["state"])
    assert np.isfinite(resumed["metrics"]["loss"])
    assert "vision_proj" in resumed["state"]["device"]["params"]


def _serve_both_ways(argv):
    lazy = serve_cli.serve(argv + ["--lazy"])
    eager = serve_cli.serve(argv)
    assert np.array_equal(lazy["tokens"], eager["tokens"])
    assert torch.equal(lazy["logits"], eager["logits"])
    return lazy


def test_serve_cli_serves_the_vlm_image_lazy_as_eager(uninterrupted):
    """The step-4 image at 16 patches + 48 text tokens (64 positions: the
    chunked lowering with the image as its prefix); the prefill's logits
    equal the forward's at the last text position bit for bit."""
    cfg = get_config(ARCHS[0], smoke=True)
    srv = _serve_both_ways(["--arch", ARCHS[0], "--smoke", "--device", "cpu",
                            "--ckpt-dir", uninterrupted[1], "--prompt-len", "48",
                            "--gen", "4"])
    assert srv["step"] == 4 and srv["tokens"].shape == (2, 4)
    assert srv["logits"].shape == (2, 4, cfg.vocab_size)
    assert srv["patches"].shape == (2, cfg.num_patches, cfg.d_model)
    assert srv["patches"].dtype == torch.bfloat16
    with torch.device("meta"):
        module = tfm.Transformer(cfg)
    params = srv["params"]
    with torch.no_grad():
        h, _ = multimodal.vlm_hidden(module, params, srv["patches"], srv["prompt"])
    assert torch.equal(logits_from_embed(params["embed"], h[:, -1:])[:, 0],
                       srv["logits"][:, 0])


def test_serve_cli_serves_the_audio_image_lazy_as_eager(tmp_path):
    """musicgen: 2 training steps, then the image served at 64 frames x 4
    codebooks (the chunked lowering), greedy per codebook."""
    arch = ARCHS[1]
    cfg = get_config(arch, smoke=True)
    store = str(tmp_path / "ck")
    assert train_cli.train(_argv(arch, store, 2, "thread", 32))["final_step"] == 2
    srv = _serve_both_ways(["--arch", arch, "--smoke", "--device", "cpu", "--ckpt-dir", store,
                            "--prompt-len", "64", "--gen", "4"])
    K = cfg.audio_codebooks
    assert srv["step"] == 2 and srv["tokens"].shape == (2, 4, K)
    assert srv["logits"].shape == (2, 4, K, cfg.vocab_size)
    assert srv["prompt"].shape == (2, 64, K) and srv["patches"] is None
    assert np.array_equal(srv["tokens"], srv["logits"].argmax(-1).numpy())
    with torch.device("meta"):
        module = tfm.Transformer(cfg)
    params = srv["params"]
    with torch.no_grad():
        h, _ = multimodal.audio_hidden(module, params, srv["prompt"])
    assert torch.equal(multimodal._audio_logits(cfg, params, h[:, -1:])[:, 0],
                       srv["logits"][:, 0])


@pytest.mark.parametrize("arch", ARCHS)
def test_proxied_decode_refuses_the_frontends_as_the_reference(arch):
    spec = {"name": "decode_arch", "arch": arch, "smoke": True, "batch": 2,
            "prompt_len": 8, "gen": 2}
    with pytest.raises(ValueError, match="frontend"):
        ref_make_program(spec)
    with pytest.raises(ValueError, match="frontend"):
        make_program(dict(spec, device="cpu"))
