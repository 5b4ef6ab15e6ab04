"""Build a hand-written CUDA kernel's shared library with ``nvcc``.

Each kernel source under ``csrc/`` has a plain C interface and is compiled
on first use (never at import: a machine without a card imports the
kernels package too) into ``build/repro_torch/`` at the repository root,
under a name that carries a hash of the source and the flags, so an
edited source is rebuilt and a stale library is never loaded.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]


def _nvcc(source: Path) -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError(f"nvcc not found (PATH, CUDA_HOME): {source.name} "
                       "cannot be built")


def build(source: Path) -> Path:
    """Compile ``source`` into a shared library (once per source/flags hash)."""
    src = source.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"lib{source.stem}-{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.tmp.{os.getpid()}")
    cmd = [_nvcc(source), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {source.name}:\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a torn file
    return lib
