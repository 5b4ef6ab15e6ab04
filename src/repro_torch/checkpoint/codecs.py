"""Checkpoint compression codecs.

Reproduces the paper's Table 2/3 strategy axis:

  - ``none``   — the naive strategy (raw bytes straight to disk).
  - ``gzip``   — zlib level 1 (the paper uses gzip -1).
  - ``pgzip``  — the same zlib stream, but chunk-parallel across a thread
                 pool (paper: "parallel gzip ... as many threads as cores").
  - ``zstd1``  — zstandard level 1: the LZ4-class fast codec available in
                 this environment (paper uses LZ4; zstd-1 occupies the same
                 design point: ~GB/s compression, modest ratio). Optional:
                 registered only when the ``zstandard`` package is installed.
  - ``zstd9``  — high-ratio point for the ratio/CPU trade-off curve
                 (optional, same dependency).

All codecs release the GIL inside compress/decompress, which is what makes
the forked-checkpointing writer pool overlap with the train loop.

``zstandard`` is an *optional* dependency (the ``[zstd]`` extra): when it is
absent the zstd codecs are simply not registered, and asking for one raises
an error naming the missing package instead of breaking import of this
module (and with it every consumer of the checkpoint substrate).
"""
from __future__ import annotations

import concurrent.futures as cf
import os
import struct
import zlib
from dataclasses import dataclass
from typing import Callable

try:
    import zstandard
except ImportError:  # optional dependency — zstd codecs not registered
    zstandard = None


@dataclass(frozen=True)
class Codec:
    name: str
    compress: Callable[[bytes], bytes]
    decompress: Callable[[bytes], bytes]


def _zstd_c(level: int) -> Callable[[bytes], bytes]:
    def fn(data: bytes) -> bytes:
        return zstandard.ZstdCompressor(level=level).compress(data)

    return fn


def _zstd_d(data: bytes) -> bytes:
    return zstandard.ZstdDecompressor().decompress(data)


_PGZIP_BLOCK = 1 << 20  # 1 MiB sub-blocks, one per worker task
_PGZIP_MAGIC = b"PGZ1"


def _pgzip_compress(data: bytes) -> bytes:
    """Chunk-parallel zlib: independent sub-blocks compressed concurrently.

    Framed as: MAGIC | n_blocks u32 | (raw_len u32, comp_len u32)* | blocks.
    """
    blocks = [data[i : i + _PGZIP_BLOCK] for i in range(0, len(data), _PGZIP_BLOCK)] or [b""]
    workers = min(len(blocks), os.cpu_count() or 1)
    if workers > 1:
        with cf.ThreadPoolExecutor(max_workers=workers) as pool:
            comp = list(pool.map(lambda b: zlib.compress(b, 1), blocks))
    else:
        comp = [zlib.compress(b, 1) for b in blocks]
    header = [_PGZIP_MAGIC, struct.pack("<I", len(blocks))]
    for raw, c in zip(blocks, comp):
        header.append(struct.pack("<II", len(raw), len(c)))
    return b"".join(header) + b"".join(comp)


def _pgzip_decompress(data: bytes) -> bytes:
    if data[:4] != _PGZIP_MAGIC:
        raise ValueError("not a pgzip frame")
    (n,) = struct.unpack_from("<I", data, 4)
    offs = 8
    sizes = []
    for _ in range(n):
        raw_len, comp_len = struct.unpack_from("<II", data, offs)
        sizes.append((raw_len, comp_len))
        offs += 8
    out, pos = [], offs
    blobs = []
    for raw_len, comp_len in sizes:
        blobs.append(data[pos : pos + comp_len])
        pos += comp_len
    workers = min(len(blobs), os.cpu_count() or 1)
    if workers > 1:
        with cf.ThreadPoolExecutor(max_workers=workers) as pool:
            out = list(pool.map(zlib.decompress, blobs))
    else:
        out = [zlib.decompress(b) for b in blobs]
    return b"".join(out)


DEFAULT_CODEC = "pgzip"  # fastest codec with no optional dependency

_CODECS: dict[str, Codec] = {
    "none": Codec("none", lambda b: b, lambda b: b),
    "gzip": Codec("gzip", lambda b: zlib.compress(b, 1), zlib.decompress),
    "pgzip": Codec("pgzip", _pgzip_compress, _pgzip_decompress),
}

# codec name -> (pip package, extra) for codecs whose dependency is missing
_MISSING: dict[str, tuple[str, str]] = {}

if zstandard is not None:
    _CODECS["zstd1"] = Codec("zstd1", _zstd_c(1), _zstd_d)
    _CODECS["zstd9"] = Codec("zstd9", _zstd_c(9), _zstd_d)
else:
    _MISSING["zstd1"] = ("zstandard", "zstd")
    _MISSING["zstd9"] = ("zstandard", "zstd")


def register_codec(codec: Codec, *, replace: bool = False) -> None:
    """Register a codec under ``codec.name`` (plugin point; used by tests)."""
    if codec.name in _CODECS and not replace:
        raise ValueError(f"codec {codec.name!r} already registered")
    _CODECS[codec.name] = codec


def unregister_codec(name: str) -> None:
    """Remove a codec registered via :func:`register_codec`."""
    _CODECS.pop(name, None)


def get_codec(name: str) -> Codec:
    try:
        return _CODECS[name]
    except KeyError:
        if name in _MISSING:
            pkg, extra = _MISSING[name]
            raise ModuleNotFoundError(
                f"codec {name!r} requires the optional dependency {pkg!r} "
                f"which is not installed (pip install {pkg!r}, or the "
                f"[{extra}] extra of this package)"
            ) from None
        raise KeyError(f"unknown codec {name!r}; have {sorted(_CODECS)}") from None


def has_codec(name: str) -> bool:
    return name in _CODECS


def list_codecs() -> list[str]:
    return sorted(_CODECS)
