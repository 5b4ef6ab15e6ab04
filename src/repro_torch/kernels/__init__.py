from repro_torch.kernels.ops import chunk_digests, digests_to_u64, tree_chunk_digests

__all__ = ["chunk_digests", "digests_to_u64", "tree_chunk_digests"]
