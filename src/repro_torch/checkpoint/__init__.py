from repro_torch.checkpoint.codecs import (
    Codec,
    DEFAULT_CODEC,
    get_codec,
    has_codec,
    list_codecs,
    register_codec,
    unregister_codec,
)
from repro_torch.checkpoint.chunking import (
    ChunkKey,
    chunk_digest_np,
    iter_chunks,
    join_chunks,
    split_into_chunks,
    DEFAULT_CHUNK_BYTES,
)
from repro_torch.checkpoint.manifest import (
    ChunkRecord,
    LeafRecord,
    Manifest,
    atomic_write,
    commit_manifest,
    latest_committed_step,
    load_manifest,
)
from repro_torch.checkpoint.store import ChunkStore
from repro_torch.checkpoint.sharded import restore_leaf, verify_manifest

__all__ = [
    "Codec",
    "DEFAULT_CODEC",
    "get_codec",
    "has_codec",
    "list_codecs",
    "register_codec",
    "unregister_codec",
    "ChunkKey",
    "chunk_digest_np",
    "iter_chunks",
    "join_chunks",
    "split_into_chunks",
    "DEFAULT_CHUNK_BYTES",
    "ChunkRecord",
    "LeafRecord",
    "Manifest",
    "atomic_write",
    "commit_manifest",
    "latest_committed_step",
    "load_manifest",
    "ChunkStore",
    "restore_leaf",
    "verify_manifest",
]
