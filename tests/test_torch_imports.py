"""PyTorch port: the package stands alone — no JAX, no reference package.

``repro_torch`` may import ``torch`` but never ``jax``, ``jaxlib``,
anything of ``repro``, ``msgpack`` or ``ml_dtypes`` (the card's machine has
neither of the last two): it keeps its own copies of what it needs. Its entry
points run on the card unless the CPU is asked for.
"""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

PKG = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
MODULES = sorted(
    ".".join(("repro_torch",) + p.relative_to(PKG).with_suffix("").parts)
    .removesuffix(".__init__")
    for p in PKG.rglob("*.py")
)


def test_every_module_imports_without_jax_or_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro',\n"
        "                                    'msgpack', 'ml_dtypes'))\n"
        "print(len(sys.modules), bad)\n"
        "assert not bad, bad\n"
    )
    src = str(PKG.parent)
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={"PYTHONPATH": src, "PATH": "/usr/bin:/bin"}, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|repro|ml_dtypes|msgpack)\b"
    r"|from\s+(jax|jaxlib|repro|ml_dtypes|msgpack)(\.|\s))",
    re.M,
)


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: p.name)
def test_source_never_imports_jax_or_reference(path):
    hits = _FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path}: {hits}"


def test_train_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from repro_torch.launch import train

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "qwen2-0.5b", "--smoke", "--steps", "1"])


def test_uvm_package_imports_alone():
    """``repro_torch.uvm`` keeps its own copies of the reference's
    framework-free modules: importing it loads no JAX, no reference, no
    ``msgpack`` and no ``ml_dtypes``."""
    code = (
        "import sys\n"
        "import repro_torch.uvm as u\n"
        "assert u.ManagedSpace and u.PageTable and u.PrefetchStream\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro',\n"
        "                                    'msgpack', 'ml_dtypes'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={"PYTHONPATH": str(PKG.parent), "PATH": "/usr/bin:/bin"}, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


_BLOCKER = '''
import sys

class _Block:
    """Refuse the reference, JAX and the packages the card's machine lacks."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack", "ml_dtypes"):
            raise ImportError(f"forbidden import in a port process: {name}")
        return None

sys.meta_path.insert(0, _Block())
'''


def test_cluster_processes_never_import_jax_or_reference(tmp_path):
    """The cluster CLI with every forbidden package blocked in every
    process it starts (launcher, spawned ranks, their proxies, fork
    persist children): a 2-rank cluster with a killed, restored rank and
    proxied ranks on torch_tiny still converges."""
    (tmp_path / "sitecustomize.py").write_text(_BLOCKER)
    env = {"PYTHONPATH": f"{tmp_path}:{PKG.parent}", "PATH": "/usr/bin:/bin"}
    for runner in ("inline", "proxy"):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.cluster", "--hosts", "2",
             "--steps", "4", "--ckpt-every", "2", "--loop", "torch",
             "--device", "cpu", "--backend", "fork", "--device-runner", runner,
             "--kill-host", "1", "--kill-at-step", "4",
             "--ckpt-dir", str(tmp_path / runner)],
            capture_output=True, text=True, env=env, timeout=240,
        )
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
        assert '"lockstep_converged": true' in proc.stdout
        assert "forbidden import" not in proc.stderr


def test_daemon_and_proxy_serve_never_import_jax_or_reference(tmp_path):
    """The proxy-host daemon CLI and the serve CLI's ``decode_arch`` proxy
    mode, every forbidden package blocked in both processes (and in the
    daemon's session): the served tokens come back."""
    (tmp_path / "sitecustomize.py").write_text(_BLOCKER)
    env = {"PYTHONPATH": f"{tmp_path}:{PKG.parent}", "PATH": "/usr/bin:/bin"}
    daemon = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.remote.host", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
    )
    try:
        line = daemon.stdout.readline()
        assert line.startswith("[proxy-host] serving on "), line + daemon.stderr.read()
        endpoint = line.split()[3]
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen2-0.5b",
             "--smoke", "--device", "cpu", "--device-runner", "proxy",
             "--proxy-endpoint", endpoint, "--prompt-len", "8", "--gen", "3"],
            capture_output=True, text=True, env=env, timeout=240,
        )
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
        assert "transport=stream" in proc.stdout and "sample tokens: [" in proc.stdout
    finally:
        daemon.kill()
        _, err = daemon.communicate(timeout=30)
    assert "forbidden import" not in proc.stderr + err
