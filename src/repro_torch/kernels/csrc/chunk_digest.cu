// Per-chunk content digests of a device buffer, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/chunk_digest.py::_digest_kernel
// (launched by digest_words, dispatched by ops.chunk_digests). It is the
// checkpoint hot path: ShadowStateManager.sync digests every leaf on the
// device and fetches only chunks whose digest changed, so only an
// (n_chunks, 2) digest table crosses to the host before any data does.
//
// What it computes, per chunk of `chunk_bytes` bytes, with the chunk's bytes
// read as little-endian u32 words w_i and a 1-based word index i within the
// chunk (a last partial word is zero-filled):
//
//     hi = SEED ^ xor_i(w_i * ((i << 1) | 1))     (mod 2^32)
//     lo = sum_i(w_i ^ (i * PRIME))               (mod 2^32)
//
// bit for bit what checkpoint/chunking.py::chunk_digest_np computes on the host.
//
// What bounds it: memory. Each word costs a few integer operations, so the
// kernel's floor is reading the leaf once at the card's memory rate.
//
// Design:
//   - every word is read once, straight from the leaf's own memory: no padded
//     copy (the TPU path pads the leaf to (n_chunks, row) first);
//   - chunks go on grid x (a large leaf cut into small chunks has more chunks
//     than grid y's 65,535), several blocks of one chunk on grid y;
//   - each thread accumulates lo (add) and hi (xor) over strided, coalesced
//     u32 loads; a warp reduces with __shfl_xor_sync, the block through
//     shared memory, and one thread per block folds the block's part into
//     the output with one atomicAdd and one atomicXor. Both mixes are
//     associative and commutative, so the result is exact and independent of
//     the order in which blocks land;
//   - byte offsets are 64-bit; words past a chunk's real length are never read;
//   - the output is (n_chunks, 2) int64 [hi, lo], zeroed by the caller; block
//     y == 0 of each chunk folds SEED into its hi part (xor is associative,
//     so where it enters does not matter), which keeps this to one kernel
//     launch per call. The atomics act on the low 32 bits of each 64-bit
//     slot (little-endian), so the high halves stay 0 and the table needs
//     no conversion afterwards.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr uint32_t kSeed = 2166136261u;
constexpr uint32_t kPrime = 16777619u;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// words each thread reads per chunk, which sets the blocks per chunk
constexpr int64_t kWordsPerThread = 16;

__global__ void __launch_bounds__(kThreads)
digest_chunks(const uint8_t* __restrict__ data, int64_t nbytes,
              int64_t chunk_bytes, uint64_t* __restrict__ out) {
  const int64_t c = blockIdx.x;
  const int64_t start = c * chunk_bytes;
  const int64_t rest = nbytes - start;
  const int64_t len = rest < chunk_bytes ? rest : chunk_bytes;
  const int64_t full = len >> 2;          // whole words in this chunk
  const int64_t words = (len + 3) >> 2;   // plus a zero-filled partial one
  const uint32_t* w32 = reinterpret_cast<const uint32_t*>(data + start);

  uint32_t lo = 0, hi = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.y) * kThreads;
  for (int64_t k = static_cast<int64_t>(blockIdx.y) * kThreads + threadIdx.x;
       k < words; k += stride) {
    uint32_t w;
    if (k < full) {
      w = __ldg(w32 + k);
    } else {
      w = 0;
      const uint8_t* p = data + start + 4 * k;
      for (int b = 0; b < static_cast<int>(len - 4 * k); ++b) {
        w |= static_cast<uint32_t>(p[b]) << (8 * b);
      }
    }
    const uint32_t i = static_cast<uint32_t>(k + 1);
    lo += w ^ (i * kPrime);
    hi ^= w * ((i << 1) | 1u);
  }

  for (int off = 16; off > 0; off >>= 1) {
    lo += __shfl_xor_sync(0xffffffffu, lo, off);
    hi ^= __shfl_xor_sync(0xffffffffu, hi, off);
  }
  __shared__ uint32_t s_lo[kWarps];
  __shared__ uint32_t s_hi[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    lo = lane < kWarps ? s_lo[lane] : 0u;
    hi = lane < kWarps ? s_hi[lane] : 0u;
    for (int off = kWarps / 2; off > 0; off >>= 1) {
      lo += __shfl_xor_sync(0xffffffffu, lo, off);
      hi ^= __shfl_xor_sync(0xffffffffu, hi, off);
    }
    if (lane == 0) {
      if (blockIdx.y == 0) {
        hi ^= kSeed;
      }
      uint32_t* slot = reinterpret_cast<uint32_t*>(out + 2 * c);
      atomicXor(slot, hi);      // low half of out[c][0]
      atomicAdd(slot + 2, lo);  // low half of out[c][1]
    }
  }
}

}  // namespace

// data: the leaf's bytes on the device, 4-byte aligned; nbytes > 0.
// out: (ceil(nbytes / chunk_bytes), 2) int64 on the same device, all zero.
// The caller makes the tensors' device current. The one kernel goes on
// `stream`; nothing is synchronised or allocated here.
extern "C" cudaError_t chunk_digest_launch(const void* data, int64_t nbytes,
                                           int64_t chunk_bytes, void* out,
                                           cudaStream_t stream) {
  if (data == nullptr || out == nullptr || nbytes <= 0 || chunk_bytes <= 0 ||
      chunk_bytes % 4 != 0 || reinterpret_cast<uintptr_t>(data) % 4 != 0) {
    return cudaErrorInvalidValue;
  }
  const int64_t n_chunks = (nbytes + chunk_bytes - 1) / chunk_bytes;
  if (n_chunks > INT32_MAX) {
    return cudaErrorInvalidValue;
  }
  const int64_t chunk_words = ((nbytes < chunk_bytes ? nbytes : chunk_bytes) + 3) / 4;
  int64_t per_chunk = (chunk_words + kThreads * kWordsPerThread - 1) /
                      (kThreads * kWordsPerThread);
  per_chunk = per_chunk < 1 ? 1 : (per_chunk > 65535 ? 65535 : per_chunk);

  const dim3 grid(static_cast<unsigned>(n_chunks),
                  static_cast<unsigned>(per_chunk));
  digest_chunks<<<grid, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(data), nbytes, chunk_bytes,
      static_cast<uint64_t*>(out));
  return cudaGetLastError();
}

extern "C" const char* chunk_digest_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
