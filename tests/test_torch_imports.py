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
