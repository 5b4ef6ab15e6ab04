// Per-chunk content digests of many device buffers in one launch, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/chunk_digest.py::_digest_kernel
// (launched by digest_words, dispatched by ops.chunk_digests and
// ops.tree_chunk_digests). It is the checkpoint hot path:
// ShadowStateManager.sync digests every dirty leaf on the device and fetches
// only chunks whose digest changed, so only a digest table crosses to the
// host before any data does.
//
// What it computes, per chunk of `chunk_bytes` bytes of each leaf, with the
// chunk's bytes read as little-endian u32 words w_i and a 1-based word index
// i counted from the chunk's start (a last partial word is zero-filled):
//
//     hi = SEED ^ xor_i(w_i * ((i << 1) | 1))     (mod 2^32)
//     lo = sum_i(w_i ^ (i * PRIME))               (mod 2^32)
//
// bit for bit what checkpoint/chunking.py::chunk_digest_np computes on the
// host. An empty leaf keeps its one [0, 0] row.
//
// What bounds it: memory. Each word costs six integer operations, so the
// floor is reading every leaf once at the card's memory rate (4.94 GB of
// train state: 1.475 ms at 3.35 TB/s).
//
// Design, against that bound:
//   - one launch digests up to kCapacity leaves: each leaf's pointer, byte
//     count and first row of one shared (rows, 2) int64 output table travel
//     in a parameter struct passed by value (__grid_constant__, under the
//     classic 4 KB parameter limit), so a sync of the whole train state is
//     one launch and one zeroing of one table;
//   - the work is cut into units of (leaf, chunk, segment): a segment is
//     kUnitBytes (64 KiB) of one chunk, and a chunk's last segment may be
//     shorter. 16 to 256 KiB units measured the same on the train state
//     (PERF.md); 64 KiB keeps the last wave short on small states. A grid
//     of about one full wave of resident blocks walks the units in a
//     grid-stride loop, so a block lives for many segments; a unit finds
//     its leaf by walking the struct's cumulative unit counts forward from
//     the block's previous unit;
//   - a unit's 16-byte-aligned body is streamed with 16-byte read-only
//     loads (ld.global.nc.v4), kUnroll of them in flight per thread,
//     neighbouring threads on neighbouring addresses. The up to three
//     words before the first 16-byte boundary and the up to three words
//     (plus a zero-filled partial word) after the last are read as
//     scalars. A chunk's start is 16-byte aligned only when chunk_bytes
//     and the leaf's address allow it, so the word index i always counts
//     from the chunk's start, never from the unit's or the load's;
//   - each thread folds lo (add) and hi (xor); a warp reduces with
//     __shfl_xor_sync, the block through shared memory (double-buffered by
//     unit parity, so one __syncthreads per unit), and one thread folds the
//     block's part into the table with one atomicXor and one atomicAdd.
//     Segment 0 of each chunk folds in SEED. Both mixes are associative and
//     commutative, so the result is exact in any order in which blocks land.
//     The atomics act on the low 32 bits of each zeroed int64 slot
//     (little-endian), so the high halves stay 0;
//   - byte offsets and unit counts are 64-bit: leaves over 2^31 bytes and
//     more than 65,535 chunks need nothing special.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr uint32_t kSeed = 2166136261u;
constexpr uint32_t kPrime = 16777619u;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;      // 16-byte loads in flight per thread
constexpr int kCapacity = 120;  // leaves per launch: keeps Group under 4 KB
constexpr int64_t kUnitBytes = 64 << 10;  // bytes of one chunk per unit
static_assert(kUnitBytes % 16 == 0, "a unit's body is read in 16-byte loads");

struct Group {
  int32_t n;                // leaves in this launch
  int64_t chunk_bytes;      // a multiple of 4
  int64_t units_per_chunk;  // ceil(chunk_bytes / kUnitBytes)
  const uint8_t* data[kCapacity];
  int64_t nbytes[kCapacity];
  int64_t row0[kCapacity];      // the leaf's first row in the table
  int64_t unit_end[kCapacity];  // units of leaves 0..k together
};
static_assert(sizeof(Group) <= 4096, "Group must fit the 4 KB parameter limit");

__device__ __forceinline__ void mix(uint32_t w, uint32_t i, uint32_t& lo,
                                    uint32_t& hi) {
  lo += w ^ (i * kPrime);
  hi ^= w * ((i << 1) | 1u);
}

__device__ __forceinline__ void mix4(const uint4& v, uint32_t i, uint32_t& lo,
                                     uint32_t& hi) {
  mix(v.x, i, lo, hi);
  mix(v.y, i + 1, lo, hi);
  mix(v.z, i + 2, lo, hi);
  mix(v.w, i + 3, lo, hi);
}

__global__ void __launch_bounds__(kThreads)
digest_units(const __grid_constant__ Group g, uint64_t* __restrict__ out) {
  __shared__ uint32_t s_lo[2][kWarps];
  __shared__ uint32_t s_hi[2][kWarps];
  const int t = static_cast<int>(threadIdx.x);
  const int lane = t & 31;
  const int warp = t >> 5;
  const int64_t total = g.unit_end[g.n - 1];
  int leaf = 0;
  int parity = 0;
  for (int64_t u = blockIdx.x; u < total; u += gridDim.x, parity ^= 1) {
    while (g.unit_end[leaf] <= u) {
      ++leaf;
    }
    const int64_t lu = u - (leaf > 0 ? g.unit_end[leaf - 1] : 0);
    const int64_t c = lu / g.units_per_chunk;
    const int64_t s = lu - c * g.units_per_chunk;
    const int64_t cs = c * g.chunk_bytes;  // the chunk's first byte
    const int64_t lo_b = cs + s * kUnitBytes;
    const int64_t nb = g.nbytes[leaf];
    const int64_t ce = cs + g.chunk_bytes < nb ? cs + g.chunk_bytes : nb;
    const int64_t hi_b = lo_b + kUnitBytes < ce ? lo_b + kUnitBytes : ce;
    const uint8_t* p = g.data[leaf] + lo_b;

    // words of this unit: head scalars, 16-byte body, tail scalars
    const int64_t full = (hi_b - lo_b) >> 2;
    const int partial = static_cast<int>((hi_b - lo_b) & 3);
    const int64_t to16 = ((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) >> 2;
    const int64_t head = to16 < full ? to16 : full;
    const int64_t nvec = (full - head) >> 2;
    const int64_t tail_at = head + 4 * nvec;  // first tail word
    const int ntail = static_cast<int>(full - tail_at) + (partial ? 1 : 0);
    // 1-based word index, from the chunk's start, of the unit's first word
    const uint32_t i0 = static_cast<uint32_t>((lo_b - cs) >> 2) + 1u;

    uint32_t lo = 0, hi = 0;
    const uint32_t* w32 = reinterpret_cast<const uint32_t*>(p);
    if (t < head) {
      mix(__ldg(w32 + t), i0 + static_cast<uint32_t>(t), lo, hi);
    }
    if (t < ntail) {
      const int64_t k = tail_at + t;
      uint32_t w = 0;
      if (k < full) {
        w = __ldg(w32 + k);
      } else {  // the leaf's last bytes: a zero-filled partial word
        for (int b = 0; b < partial; ++b) {
          w |= static_cast<uint32_t>(p[4 * k + b]) << (8 * b);
        }
      }
      mix(w, i0 + static_cast<uint32_t>(k), lo, hi);
    }
    const uint4* body = reinterpret_cast<const uint4*>(w32 + head);
    const uint32_t ib = i0 + static_cast<uint32_t>(head);
    for (int64_t v = t; v < nvec; v += kUnroll * kThreads) {
      uint4 r[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int64_t vv = v + k * kThreads;
        r[k] = vv < nvec ? __ldg(body + vv) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int64_t vv = v + k * kThreads;
        if (vv < nvec) {
          mix4(r[k], ib + 4u * static_cast<uint32_t>(vv), lo, hi);
        }
      }
    }

    for (int off = 16; off > 0; off >>= 1) {
      lo += __shfl_xor_sync(0xffffffffu, lo, off);
      hi ^= __shfl_xor_sync(0xffffffffu, hi, off);
    }
    if (lane == 0) {
      s_lo[parity][warp] = lo;
      s_hi[parity][warp] = hi;
    }
    __syncthreads();
    if (warp == 0) {
      lo = lane < kWarps ? s_lo[parity][lane] : 0u;
      hi = lane < kWarps ? s_hi[parity][lane] : 0u;
      for (int off = kWarps / 2; off > 0; off >>= 1) {
        lo += __shfl_xor_sync(0xffffffffu, lo, off);
        hi ^= __shfl_xor_sync(0xffffffffu, hi, off);
      }
      if (lane == 0) {
        if (s == 0) {
          hi ^= kSeed;
        }
        uint32_t* slot = reinterpret_cast<uint32_t*>(out + 2 * (g.row0[leaf] + c));
        atomicXor(slot, hi);      // low half of out[row][0]
        atomicAdd(slot + 2, lo);  // low half of out[row][1]
      }
    }
  }
}

int resident_blocks() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) {
    return 0;
  }
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, digest_units, kThreads, 0) !=
            cudaSuccess) {
      return 0;
    }
    cached[dev] = sms * per_sm;
  }
  return cached[dev];
}

}  // namespace

extern "C" int chunk_digest_capacity() { return kCapacity; }

extern "C" int64_t chunk_digest_unit_bytes() { return kUnitBytes; }

// One launch over n leaves (0 < n <= kCapacity, at least one byte in all).
// data[k]: leaf k's bytes on the device, 4-byte aligned (null only when
// nbytes[k] == 0); row0[k]: its first row in `out`, an (n_rows, 2) int64
// table on the same device, all zero, in which leaf k owns
// ceil(nbytes[k] / chunk_bytes) rows (one when empty). The caller makes
// the table's device current. The one kernel goes on `stream`; nothing is
// synchronised or allocated here.
extern "C" cudaError_t chunk_digest_launch(int32_t n, const uint64_t* data,
                                           const int64_t* nbytes, const int64_t* row0,
                                           int64_t n_rows, int64_t chunk_bytes, void* out,
                                           cudaStream_t stream) {
  if (n <= 0 || n > kCapacity || data == nullptr || nbytes == nullptr ||
      row0 == nullptr || out == nullptr || chunk_bytes <= 0 || chunk_bytes % 4 != 0) {
    return cudaErrorInvalidValue;
  }
  Group g = {};
  g.n = n;
  g.chunk_bytes = chunk_bytes;
  g.units_per_chunk = (chunk_bytes + kUnitBytes - 1) / kUnitBytes;
  int64_t units = 0;
  for (int k = 0; k < n; ++k) {
    const int64_t nb = nbytes[k];
    if (nb < 0 || (nb > 0 && (data[k] == 0 || data[k] % 4 != 0))) {
      return cudaErrorInvalidValue;
    }
    const int64_t chunks = nb == 0 ? 1 : (nb + chunk_bytes - 1) / chunk_bytes;
    if (row0[k] < 0 || row0[k] > n_rows - chunks) {
      return cudaErrorInvalidValue;
    }
    if (nb > 0) {
      const int64_t last = nb - (chunks - 1) * chunk_bytes;
      units += (chunks - 1) * g.units_per_chunk + (last + kUnitBytes - 1) / kUnitBytes;
    }
    g.data[k] = reinterpret_cast<const uint8_t*>(data[k]);
    g.nbytes[k] = nb;
    g.row0[k] = row0[k];
    g.unit_end[k] = units;
  }
  if (units == 0) {
    return cudaErrorInvalidValue;
  }
  const int wave = resident_blocks();
  if (wave <= 0) {
    return cudaErrorInvalidDevice;
  }
  const unsigned blocks = static_cast<unsigned>(units < wave ? units : wave);
  digest_units<<<blocks, kThreads, 0, stream>>>(g, static_cast<uint64_t*>(out));
  return cudaGetLastError();
}

extern "C" const char* chunk_digest_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
