"""PyTorch port: the twins of the reference's examples, on the CPU.

``examples/torch_quickstart.py`` killed by SIGKILL once its step-20
checkpoint has committed, then rerun, ends at step 30 the same bits as a
run that was never killed, on both persist backends (and on the card:
``gpu`` marker, ``python -m pytest -q -m gpu tests/test_torch_examples.py``);
``examples/torch_serve_lazy_restore.py`` runs to its end (eager and lazy
restore give the same first logits); ``examples/torch_train_100m_restart.py``'s
launcher kills and restarts a worker cut to 1 layer of width 24 (at 100M
params a CPU step takes seconds: the full size runs on the card);
``examples/torch_elastic_reshard.py`` (8 gloo ranks) trains on a (4, 2)
mesh, checkpoints, restores onto (8,) and trains on, its losses the
reference example's from the same initial params.
"""
import importlib.util
import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manifest import committed_steps
from repro_torch.utils.tree import tree_equal

REPO = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"
BACKENDS = ["thread"] + (["fork"] if hasattr(os, "fork") else [])

# the killed run: the example itself, with every step after step 20 slowed
# down, so that the kill lands after step 20's commit and before step 30's
_SLOW_AFTER_20 = """
import runpy, sys, time
import repro_torch.runtime.steps as steps
make = steps.make_train_step
def slow(*a, **kw):
    fn = make(*a, **kw)
    def step(state, batch):
        out = fn(state, batch)
        if int(out[0]["step"]) > 20:
            time.sleep(0.5)
        return out
    return step
steps.make_train_step = slow
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""


def _example(name):
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
@pytest.mark.parametrize("backend", BACKENDS)
def test_quickstart_resumes_bitwise_after_a_sigkill(tmp_path, backend, device, capsys):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    qs = _example("torch_quickstart")
    args = ["--device", device, "--backend", backend]
    killed = str(tmp_path / "killed")
    proc = subprocess.Popen(
        [sys.executable, "-c", _SLOW_AFTER_20, str(EXAMPLES / "torch_quickstart.py"),
         *args, "--store-root", killed],
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")), cwd=str(REPO),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 240
        while 20 not in committed_steps(killed):
            assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
            assert time.monotonic() < deadline, "no step-20 commit"
            time.sleep(0.02)
        proc.send_signal(signal.SIGKILL)
    finally:
        proc.kill()
        proc.wait()
    assert committed_steps(killed) == [10, 20]

    resumed = qs.main([*args, "--store-root", killed])
    assert "starting from step 20" in capsys.readouterr().out
    straight = qs.main([*args, "--store-root", str(tmp_path / "straight")])
    assert int(resumed["host"]["step"]) == int(straight["host"]["step"]) == 30
    assert tree_equal(resumed, straight)
    assert 30 in committed_steps(killed) and 30 in committed_steps(str(tmp_path / "straight"))


def test_serve_lazy_restore_runs_to_its_end(capsys):
    out = _example("torch_serve_lazy_restore").main(["--device", "cpu"])
    assert out["eager_s"] > 0 and out["lazy_s"] > 0
    assert out["logits"].shape[-1] == 32000 and bool(out["logits"].isfinite().all())
    text = capsys.readouterr().out
    assert "eager restore -> first logits" in text and "lazy  restore" in text


def test_train_100m_launcher_kills_and_resumes(tmp_path, capsys):
    resumed = _example("torch_train_100m_restart").main(
        ["--device", "cpu", "--steps", "60", "--kill-after", "0", "--layers", "1",
         "--d-model", "24", "--ckpt-dir", str(tmp_path / "ckpt")])
    out = capsys.readouterr().out
    assert resumed in (25, 50)
    assert "[launcher] SIGKILL" in out and "[worker] DONE step=60" in out


# the reference's elastic example, recording its initial params and every
# step's loss unrounded
_REF_ELASTIC = """
import dataclasses, json, runpy, sys
import jax
import numpy as np
import repro.models as rm
import repro.runtime.steps as rs
from repro.utils.tree import flatten_with_paths
build, make, losses = rm.build, rs.make_train_step, []
def build_(cfg):
    model = build(cfg)
    def init(key):
        params = model.init(key)
        if not isinstance(jax.tree.leaves(params)[0], jax.core.Tracer):  # not eval_shape's
            np.savez(sys.argv[1], **{k: np.asarray(v)
                                     for k, v in flatten_with_paths(params)[0].items()})
        return params
    return dataclasses.replace(model, init=init)
def make_(*a, **kw):
    fn, sh, bsh = make(*a, **kw)
    def step(state, batch):
        out = fn(state, batch)
        losses.append(float(out[1]["loss"]))
        return out
    return step, sh, bsh
rm.build, rs.make_train_step = build_, make_
runpy.run_path("examples/elastic_reshard.py", run_name="__main__")
print(json.dumps(losses))
"""


def test_elastic_reshard_twin_matches_the_reference_example(tmp_path):
    """``examples/torch_elastic_reshard.py`` (8 gloo ranks: (4, 2) -> (8,))
    runs to its end importing only ``repro_torch``, and from the reference
    example's initial params its step-3 and step-5 losses are the
    reference's within 1e-5 (f32, two frameworks' sum orders)."""
    env = dict(os.environ, PYTHONPATH="src")
    env.pop("XLA_FLAGS", None)
    init = tmp_path / "init.npz"
    ref = subprocess.run([sys.executable, "-c", _REF_ELASTIC, str(init)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr[-3000:]
    want = json.loads(ref.stdout.strip().splitlines()[-1])
    assert "step 5 loss=5.1596" in ref.stdout and len(want) == 5
    import ast

    tree = ast.parse((EXAMPLES / "torch_elastic_reshard.py").read_text())
    imported = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
    imported |= {n.module.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom)}
    assert not imported & {"repro", "jax", "jaxlib"} and "repro_torch" in imported
    out = subprocess.run([sys.executable, "-W", "ignore", str(EXAMPLES / "torch_elastic_reshard.py"),
                          "--init-params", str(init), "--json"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("[mesh A 4x2] step 3 loss=")
    assert lines[1].startswith("[mesh B 8x1] resumed from step 3, step 5 loss=")
    assert lines[2] == "elastic reshard OK: same checkpoint, different topology"
    got = json.loads(lines[3])["loss"]
    np.testing.assert_allclose([got["3"], got["5"]], [want[2], want[4]], rtol=1e-5)
