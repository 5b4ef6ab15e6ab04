"""CRUM checkpoint/restart in PyTorch for one NVIDIA H100.

The PyTorch port of the JAX reference package ``repro``: the same chunk
digests, the same on-disk checkpoint format and the same restored state,
with the on-device chunk digest done by a hand-written CUDA kernel
(``kernels/csrc/chunk_digest.cu``). Entry points default to the ``cuda``
device and raise when there is no card; the CPU runs only when asked for.
"""
