"""Checkpoint manifests + atomic commit protocol.

Layout of a checkpoint directory (one per step)::

    <root>/step_00000042/
        data-h0000.bin            per-host chunk payload files
        hostmeta-h0000.msgpack    per-host leaf/chunk records
        MANIFEST.msgpack          merged manifest (written by coordinator)
        COMMIT                    commit marker (last thing written)

A checkpoint exists iff COMMIT exists; everything before that is invisible
to restore. This mirrors CRUM's requirement that a crash mid-checkpoint must
leave the previous image restorable (the forked child writing the image can
die without corrupting anything).

The manifest is *topology-independent*: leaves are keyed by path and chunk
data is keyed by global index ranges (shard domains), so restore can target
any mesh — the analogue of CRUM's "checkpoint on one CUDA version, restart
on another".

Delta (incremental) manifests: a chunk record may carry a ``file`` that
lives in an earlier step's directory. Restore chases these references, so an
incremental checkpoint only persists digest-dirty chunks.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass, field, asdict
from typing import Any

from repro_torch.checkpoint import msgpack_lite as msgpack

FORMAT_VERSION = 2
_STEP_RE = re.compile(r"^step_(\d{8})$")


@dataclass
class ChunkRecord:
    index: int          # chunk ordinal within its shard
    raw_len: int        # uncompressed byte length
    digest: int         # u64 content digest (chunking.chunk_digest_np)
    codec: str          # codec name used on disk
    file: str           # path relative to checkpoint ROOT (enables deltas)
    file_offset: int
    comp_len: int


@dataclass
class ShardRecord:
    start: list[int]    # global index-range start (per dim)
    stop: list[int]     # global index-range stop (per dim)
    chunks: list[ChunkRecord] = field(default_factory=list)


@dataclass
class LeafRecord:
    path: str
    shape: list[int]
    dtype: str
    shards: list[ShardRecord] = field(default_factory=list)


@dataclass
class Manifest:
    step: int
    format_version: int = FORMAT_VERSION
    leaves: dict[str, LeafRecord] = field(default_factory=dict)
    skeleton: Any = None       # nested dict/list/tuple structure w/ leaf paths
    meta: dict = field(default_factory=dict)  # free-form (mesh, config, ...)

    # -- (de)serialization -------------------------------------------------
    def to_bytes(self) -> bytes:
        payload = {
            "step": self.step,
            "format_version": self.format_version,
            "leaves": {k: asdict(v) for k, v in self.leaves.items()},
            "skeleton": _encode_skeleton(self.skeleton),
            "meta": self.meta,
        }
        return msgpack.packb(payload)

    @staticmethod
    def from_bytes(data: bytes) -> "Manifest":
        p = msgpack.unpackb(data)
        if p["format_version"] > FORMAT_VERSION:
            raise ValueError(
                f"manifest format {p['format_version']} newer than supported "
                f"{FORMAT_VERSION}"
            )
        leaves = {}
        for k, lv in p["leaves"].items():
            shards = [
                ShardRecord(
                    start=s["start"],
                    stop=s["stop"],
                    chunks=[ChunkRecord(**c) for c in s["chunks"]],
                )
                for s in lv["shards"]
            ]
            leaves[k] = LeafRecord(lv["path"], lv["shape"], lv["dtype"], shards)
        return Manifest(
            step=p["step"],
            format_version=p["format_version"],
            leaves=leaves,
            skeleton=_decode_skeleton(p["skeleton"]),
            meta=p.get("meta", {}),
        )

    def total_bytes(self, *, compressed: bool = True) -> int:
        return sum(
            (c.comp_len if compressed else c.raw_len)
            for lv in self.leaves.values()
            for s in lv.shards
            for c in s.chunks
        )


# -- tree skeleton -----------------------------------------------------------
# Checkpointable state must be a pytree of dict / list / tuple containers
# with array leaves. The skeleton encodes the container structure with leaf
# paths at the leaf positions, so restore is pickle-free and version-robust.

def _encode_skeleton(node: Any) -> Any:
    if isinstance(node, dict):
        return {"t": "d", "k": list(node.keys()),
                "v": [_encode_skeleton(v) for v in node.values()]}
    if isinstance(node, tuple):
        return {"t": "t", "v": [_encode_skeleton(v) for v in node]}
    if isinstance(node, list):
        return {"t": "l", "v": [_encode_skeleton(v) for v in node]}
    if node is None:
        return {"t": "n"}
    if isinstance(node, str):  # leaf path reference
        return {"t": "p", "v": node}
    raise TypeError(f"unsupported skeleton node {type(node)}")


def _decode_skeleton(enc: Any) -> Any:
    if enc is None:
        return None
    t = enc["t"]
    if t == "d":
        return {k: _decode_skeleton(v) for k, v in zip(enc["k"], enc["v"])}
    if t == "t":
        return tuple(_decode_skeleton(v) for v in enc["v"])
    if t == "l":
        return [_decode_skeleton(v) for v in enc["v"]]
    if t == "n":
        return None
    if t == "p":
        return enc["v"]
    raise TypeError(f"bad skeleton tag {t}")


def build_skeleton(tree: Any, prefix: str = "") -> Any:
    """Replace every leaf of a dict/list/tuple pytree with its path string."""
    if isinstance(tree, dict):
        return {k: build_skeleton(v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        seq = [build_skeleton(v, f"{prefix}{i}/") for i, v in enumerate(tree)]
        return tuple(seq) if isinstance(tree, tuple) else seq
    if tree is None:
        return None
    return prefix[:-1]  # strip trailing '/'


def skeleton_fill(skeleton: Any, leaves: dict[str, Any]) -> Any:
    """Rebuild the original pytree from a skeleton + {path: leaf} map."""
    if isinstance(skeleton, dict):
        return {k: skeleton_fill(v, leaves) for k, v in skeleton.items()}
    if isinstance(skeleton, tuple):
        return tuple(skeleton_fill(v, leaves) for v in skeleton)
    if isinstance(skeleton, list):
        return [skeleton_fill(v, leaves) for v in skeleton]
    if skeleton is None:
        return None
    return leaves[skeleton]


def skeleton_paths(skeleton: Any) -> list[str]:
    out: list[str] = []

    def rec(node: Any) -> None:
        if isinstance(node, dict):
            for v in node.values():
                rec(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                rec(v)
        elif isinstance(node, str):
            out.append(node)

    rec(skeleton)
    return out


# -- atomic filesystem protocol ----------------------------------------------

def atomic_write(path: str, data: bytes) -> None:
    """tmp + fsync + rename: the write is all-or-nothing."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def fsync_dir(path: str) -> None:
    """Flush a directory's entry table to stable storage.

    ``atomic_write`` fsyncs file *contents*; the rename that makes the file
    visible lives in the directory, which has its own cache. Without this, a
    power failure after commit can leave a COMMIT marker whose payload files
    were never durably linked — exactly the torn image the commit protocol
    exists to prevent.
    """
    try:
        fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    except OSError:  # platform without directory fds (or dir just GC'd)
        return
    try:
        os.fsync(fd)
    except OSError:  # some filesystems refuse fsync on directories
        pass
    finally:
        os.close(fd)


def step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:08d}")


def commit_manifest(root: str, manifest: Manifest, *, durable: bool = True) -> str:
    """Write MANIFEST then the COMMIT marker (the commit point).

    With ``durable`` (default) the step directory and the checkpoint root are
    fsynced after the marker lands, so the committed image survives power
    loss: payload files, hostmetas, MANIFEST and COMMIT are all durably
    linked before the commit is observable.
    """
    d = step_dir(root, manifest.step)
    os.makedirs(d, exist_ok=True)
    atomic_write(os.path.join(d, "MANIFEST.msgpack"), manifest.to_bytes())
    atomic_write(os.path.join(d, "COMMIT"), b"ok")
    if durable:
        fsync_dir(d)
        fsync_dir(root)
    return d


def is_committed(root: str, step: int) -> bool:
    return os.path.exists(os.path.join(step_dir(root, step), "COMMIT"))


def committed_steps(root: str) -> list[int]:
    """Committed step numbers under ``root``, tolerant of concurrent GC.

    A step directory may vanish between ``listdir`` and the COMMIT probe
    (GC on another thread/process); such steps are simply not reported.
    """
    try:
        names = os.listdir(root)
    except (FileNotFoundError, NotADirectoryError):
        return []
    steps = []
    for name in names:
        m = _STEP_RE.match(name)
        # os.path.exists returns False (never raises) for a dir GC'd
        # between the listdir and this probe
        if m and os.path.exists(os.path.join(root, name, "COMMIT")):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_committed_step(root: str) -> int | None:
    steps = committed_steps(root)
    return steps[-1] if steps else None


_STEP_FILE_RE = re.compile(r"^step_(\d{8})/")


def referenced_steps(manifest: Manifest) -> set[int]:
    """Steps whose payload files this (possibly delta) manifest references.

    An incremental manifest's chunk records point into *earlier* steps'
    ``data-h*.bin`` files; collecting one of those steps strands the delta.
    GC planners (policy.gc_keep), the store-level GC safety net and the
    checkpointer's in-flight-base pinning all consume this.
    """
    out: set[int] = set()
    for lv in manifest.leaves.values():
        for s in lv.shards:
            for c in s.chunks:
                m = _STEP_FILE_RE.match(c.file.replace("\\", "/"))
                if m:
                    out.add(int(m.group(1)))
    return out


def load_manifest(root: str, step: int) -> Manifest:
    if not is_committed(root, step):
        raise FileNotFoundError(f"step {step} not committed under {root}")
    with open(os.path.join(step_dir(root, step), "MANIFEST.msgpack"), "rb") as f:
        return Manifest.from_bytes(f.read())


def load_manifest_if_committed(root: str, step: int) -> Manifest | None:
    """Like :func:`load_manifest` but returns None if the step is gone.

    The committed/read pair is not atomic against GC: a step can be listed
    as committed and then disappear before the manifest read. Callers that
    scan (GC planners, restore pickers) use this to tolerate the race.
    """
    try:
        return load_manifest(root, step)
    except (FileNotFoundError, NotADirectoryError):
        return None


# -- per-host metadata + coordinator merge ------------------------------------
# In the cluster protocol each host persists its own shards and writes a
# *hostmeta* — a Manifest holding only that host's ShardRecords — into the
# step directory. The coordinator merges all hostmetas into the single
# MANIFEST.msgpack and only then writes COMMIT (two-phase commit: hostmetas
# are the prepare records, COMMIT is the decision).

_HOSTMETA_RE = re.compile(r"^hostmeta-h(\d{4})\.msgpack$")


def hostmeta_path(root: str, step: int, host: int) -> str:
    return os.path.join(step_dir(root, step), f"hostmeta-h{host:04d}.msgpack")


def write_hostmeta(root: str, step: int, host: int, manifest: Manifest) -> str:
    """Atomically write one host's manifest fragment; returns its path."""
    d = step_dir(root, step)
    os.makedirs(d, exist_ok=True)
    path = hostmeta_path(root, step, host)
    atomic_write(path, manifest.to_bytes())
    return path


def list_hostmetas(root: str, step: int) -> dict[int, str]:
    """{host: hostmeta path} present in a step directory."""
    d = step_dir(root, step)
    try:
        names = os.listdir(d)
    except (FileNotFoundError, NotADirectoryError):
        return {}
    out = {}
    for name in names:
        m = _HOSTMETA_RE.match(name)
        if m:
            out[int(m.group(1))] = os.path.join(d, name)
    return out


def load_hostmeta(root: str, step: int, host: int) -> Manifest:
    with open(hostmeta_path(root, step, host), "rb") as f:
        return Manifest.from_bytes(f.read())


def merge_hostmetas(
    root: str, step: int, hosts: list[int] | None = None
) -> Manifest:
    """Merge per-host manifest fragments into the cluster manifest.

    Every host reports the same global leaf set (paths, shapes, dtypes,
    skeleton) but only its own ShardRecords; the merge unions the shard
    lists per leaf. Disagreement on shape/dtype/step is a protocol error —
    it means two hosts checkpointed different states, which must abort the
    round rather than commit a chimera.
    """
    if hosts is None:
        hosts = sorted(list_hostmetas(root, step))
    if not hosts:
        raise FileNotFoundError(f"no hostmetas for step {step} under {root}")
    merged: Manifest | None = None
    for h in sorted(hosts):
        hm = load_hostmeta(root, step, h)
        if hm.step != step:
            raise ValueError(
                f"hostmeta h{h} is for step {hm.step}, expected {step}"
            )
        if merged is None:
            # seed meta from the first host but drop its per-host fields —
            # the cluster manifest must not claim one host's identity or
            # report one host's chunk counters as cluster totals
            base_meta = {
                k: v for k, v in hm.meta.items()
                if k not in ("host", "chunks_written", "chunks_reused")
            }
            merged = Manifest(
                step=step,
                format_version=hm.format_version,
                skeleton=hm.skeleton,
                meta=base_meta,
            )
            merged.meta["hosts"] = {}
        for path, lv in hm.leaves.items():
            have = merged.leaves.get(path)
            if have is None:
                merged.leaves[path] = LeafRecord(
                    path=lv.path, shape=lv.shape, dtype=lv.dtype,
                    shards=list(lv.shards),
                )
            else:
                if list(have.shape) != list(lv.shape) or have.dtype != lv.dtype:
                    raise ValueError(
                        f"hostmeta h{h} disagrees on leaf {path!r}: "
                        f"{lv.shape}/{lv.dtype} vs {have.shape}/{have.dtype}"
                    )
                have.shards.extend(lv.shards)
        merged.meta["hosts"][h] = {
            "chunks_written": hm.meta.get("chunks_written", 0),
            "chunks_reused": hm.meta.get("chunks_reused", 0),
        }
    merged.meta["chunks_written"] = sum(
        v["chunks_written"] for v in merged.meta["hosts"].values()
    )
    merged.meta["chunks_reused"] = sum(
        v["chunks_reused"] for v in merged.meta["hosts"].values()
    )
    # deterministic shard order: by global start range
    for lv in merged.leaves.values():
        lv.shards.sort(key=lambda s: (tuple(s.start), tuple(s.stop)))
    return merged
