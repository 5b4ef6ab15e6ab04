"""Build a hand-written CUDA kernel's shared library with ``nvcc``.

Each kernel source under ``csrc/`` has a plain C interface and is compiled
on first use (never at import: a machine without a card imports the
kernels package too) into ``build/repro_torch/`` at the repository root,
under a name that carries a hash of the source and the flags, so an
edited source is rebuilt and a stale library is never loaded. The
assembler's report (``-Xptxas -v``: each kernel's registers, stack and
spills) is kept beside the library, and :func:`ptxas_report` reads it.
"""
from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a torn file
    return lib


def ptxas_report(lib: Path) -> list[dict]:
    """Each kernel of a built library as the assembler reported it:
    ``{"kernel", "dtype", "d", "registers", "stack", "spill_stores",
    "spill_loads"}`` (``dtype``, ``d``: the template arguments, or None)."""
    out, cur = [], None
    for line in lib.with_suffix(".log").read_text().splitlines():
        if found := re.search(r"Compiling entry function '(\w+)'", line):
            cur = {"kernel": found.group(1), "dtype": None, "d": None}
            # _ZN <length><name>...: the anonymous namespace's name, then the kernel's
            rest = cur["kernel"].removeprefix("_ZN")
            while (n := re.match(r"\d+", rest)) is not None:
                end = n.end() + int(n.group())
                name, rest = rest[n.end():end], rest[end:]
                if not name.startswith("_GLOBAL__N"):
                    cur["kernel"] = name
                    break
            cur["dtype"] = ("bf16" if "__nv_bfloat16" in rest
                            else "f16" if "__half" in rest else None)
            if (d := re.search(r"Li(\d+)E", rest)) is not None:
                cur["d"] = int(d.group(1))
            out.append(cur)
        elif cur is not None and (found := re.search(
                r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                line)):
            cur.update(stack=int(found.group(1)), spill_stores=int(found.group(2)),
                       spill_loads=int(found.group(3)))
        elif cur is not None and (found := re.search(r"Used (\d+) registers", line)):
            cur["registers"] = int(found.group(1))
    return out
