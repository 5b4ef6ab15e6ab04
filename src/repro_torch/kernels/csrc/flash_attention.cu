// Forward causal GQA flash attention for Hopper (sm_90a): bf16 and f16 on
// the tensor cores (wgmma, fed by TMA), f32 on the CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (launched by flash_attention_pallas, dispatched by ops.flash_attention) and
// its pure-JAX twin models/layers.py::_chunked_attention, which the model
// takes for S >= attn_chunked_threshold: in the port, every layer's attention
// in a long-prompt prefill runs here.
//
// What it computes, for q (B, Hq, Sq, D) and k, v (B, Hkv, Sk, D), with the
// kv head of query head h being h / (Hq / Hkv):
//
//     s    = (q . k) * scale                           (f32 dot, then scale)
//     s    = -1e30 where causal and col > row + Sk - Sq and col >= prefix_len
//            (the right-aligned mask; prefix_len > 0 opens the first keys
//            to every row: the prefix-LM mask of _chunked_attention)
//     out  = online softmax over key tiles: m, l and the accumulator in f32,
//            l == 0 -> 1, out = acc / l, rounded to q's dtype (RNE)
//
// Masked logits are -1e30, never -inf, as in the TPU kernel. So a row with no
// valid key (Sq > Sk, row < Sq - Sk, no prefix) sees exp(s - m) = exp(0) = 1
// for every key and comes out as the mean of v over all Sk keys, not 0 and
// not NaN. With prefix_len >= 1 every row sees key 0, so no row lacks a key.
//
// Row statistics, for the backward (flash_attention_bwd.cu): given non-null
// m and l pointers, both routes also store each row's max m (natural-log
// domain, -1e30 exactly for a row with no key) and its l (after l == 0 ->
// 1) into (B, Hq, Sq) f32 arrays; a null pointer stores nothing and leaves
// the kernel as it was. m and l stay apart because -1e30 + log(Sk) rounds
// back to -1e30 in f32 (a backward from lse would weigh each key of a row
// with no key by 1, not 1 / Sk).
//
// What bounds it: operations. At the serve path's prefill shapes (q
// (2, 14, 8192, 64), k/v (2, 2, 8192, 64), bf16) the causal work is
// 4 B Hq D S (S + 1) / 2 = 2.41e11 flop per launch against ~67 MB of inputs
// and output: 0.243 ms at the tensor cores' 989 TFLOP/s dense bf16 rate,
// 0.020 ms at the memory rate. A kernel on the CUDA cores' 67 TFLOP/s f32
// rate cannot go under 3.6 ms, so the 16-bit route runs both products on
// the tensor cores. With P split in two (below) the tensor cores do 1.5x
// that work, so this design's own floor is 0.365 ms.
//
// The route is fixed by dtype (the wrapper, kernels/flash_attention.py,
// chooses it and refuses a layout the route cannot read):
//
// bf16 / f16: flash_fwd_tc, tensor cores.
//   - one CTA of 2 warpgroups (256 threads) per (128-row q tile, q head,
//     batch); warpgroup w owns rows 64w..64w+63. q tiles are grid z, longest
//     first, so every head's long causal rows start before any short ones;
//     at D <= 64 a thread keeps to 128 registers, so 2 CTAs share an SM and
//     one's softmax runs beside the other's wgmma;
//   - TMA loads q once and k, v in 64-key tiles into a ring of swizzled
//     shared memory, each stage completed on its own mbarrier; one thread
//     issues the loads, and a stage is refilled as soon as both warpgroups
//     are done with it. The ring has 3 stages (two tiles ahead of their
//     use) up to D = 128 and 2 at D = 256, where q is 64 KB and one k or v
//     tile 32 KB: 3 stages would need 256 KB of the 227 KB a block may
//     have, 2 take 192 KB. At D = 256 the O accumulator alone is 128 f32
//     registers a thread: one CTA per SM, and the two products of a tile
//     step run one after the other (below);
//   - every operand has its own 4-D tensor map over (D, then S, H, B in
//     order of stride), built from the tensor's own byte strides, so the
//     model's transposed v view goes in as it is, with no copy; D = 64 is one
//     128-byte-swizzled panel, D = 128 two of them, D = 256 four, D = 32 one
//     64-byte-swizzled panel. TMA fills reads past Sq or Sk with zeros;
//   - S = q k^T is wgmma m64n64k16 with q and k from shared memory (both
//     K-major), f32 accumulators. Up to D = 128 tile t's q k^T is issued
//     together with tile t - 1's P V, and the softmax of tile t runs while
//     P V is on the tensor cores; at D = 256 S, P and O would not fit in
//     the registers together, so P V completes before q k^T is issued;
//   - softmax in registers: each row of a warpgroup's accumulator lies in the
//     4 threads of a quad, so row max and row sum take two __shfl_xor_sync
//     (the butterfly gives all 4 the same bits). Exponentials are exp2 of
//     logits in the log2 domain, scale * log2(e) folded into one multiply
//     (on a tile with no mask: one fma on the raw score, after the max of the
//     raw scores). That rounds the logit once more in f32, a relative 2^-24,
//     far under the 16-bit output's ulp; the f32 route keeps expf. The
//     accumulator's rescale is skipped when no row of a warp changed its max;
//   - O += P V is wgmma m64nDk16 with P from registers: the f32 accumulator
//     fragment of S is, pair by pair, the A fragment of the next product
//     once packed to bf16x2 / half2, so P never touches shared memory. V is
//     the B operand in its natural (keys x D) layout through the
//     descriptor's transpose mode. wgmma's n is at most 256 and CUTLASS-free
//     operand lists stay short, so D = 256 issues two m64n128k16 per k16
//     step, one per half of the accumulator (panels 0-1 and 2-3 of v);
//   - the precision of P: P is split as P = P_hi + P_lo, each rounded to the
//     input type, and P V is two wgmma (1.5x the tensor-core work of one
//     rounding). At the serve shape one bf16 rounding of P reads 12.3x the
//     unchanged bf16 limit of the sweep (chip_smoke.py, the plain version
//     with P rounded once) and the split 0.944x, on an NVIDIA H100 80GB HBM3
//     at 700 W;
//   - causal: a tile whose first row has a key (or any tile, with a prefix)
//     stops at the key tile holding max(last row + Sk - Sq, prefix_len - 1),
//     the last key its last row may see; a tile that holds a row with no key
//     walks all key tiles, because that row's output is the mean of all of
//     v. A key tile inside the prefix, or below every row's diagonal, has no
//     mask and takes the one-fma softmax. Keys past Sk get -inf (weight
//     exactly 0); rows past Sq are computed on zeros and never stored.
//
// f32: flash_fwd_simt, CUDA cores (wgmma has no f32 inputs, and TF32's 10-bit
// mantissa would not meet the f32 limit of 2e-5).
//   - one CTA of 256 threads per (q tile of 64 rows, q head, batch), q tiles
//     in reverse order on grid x;
//   - the q tile is staged once in shared memory, transposed ([D][64]); the
//     loop walks 64-key tiles of k (transposed) and v (row-major) staged in
//     shared memory;
//   - thread (ty, tx) of a 16 x 16 grid owns rows ty*4..ty*4+3 of the tile:
//     4 x 4 scores (keys tx*4..tx*4+3) and 4 rows x D/16 columns of the
//     accumulator. Row max and row sum are reduced across the 16 threads of
//     a row with __shfl_xor_sync;
//   - p goes through shared memory ([64][68], float4 rows) for p @ v;
//   - the same causal tile-skip rule, prefix mask and -inf for keys past Sk;
//   - D = 256 takes 217 KB of shared memory: one CTA per SM;
//   - q, k, v and out are read through (b, h, s) strides with unit stride
//     in D.
//
// Neither route uses atomics or splits one row's keys across CTAs: each
// output element is written once by one thread, and the result is the same
// bits from run to run.
#include <cuda.h>  // CUtensorMap and its enums only: no -lcuda
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kBlockQ = 64;    // query rows per CTA
constexpr int kBlockK = 64;    // keys per tile
constexpr int kThreads = 256;  // 16 x 16 thread grid
constexpr int kLd = 68;        // row pitch of q^T, k^T and p: float4-aligned, spreads banks
constexpr float kMasked = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_sb, q_sh, q_ss;  // element strides of (b, h, s); d stride is 1
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int sq, sk, group;
  float scale;
  int causal;
  int prefix_len;  // keys every row may see (the prefix-LM mask); 0: none
  float* m;        // (b, hq, sq) row statistics, or null
  float* l;
};

// The number of key tiles of `tile` keys that a causal q tile whose first
// row is `q0` and last row `last_row` reads (of `n_tiles`): up to the tile
// holding max(last row + offset, prefix_len - 1). A tile with a row that
// has no key (no prefix and q0 + offset < 0) reads them all.
__device__ __forceinline__ int causal_tiles(int n_tiles, int q0, int last_row, int offset,
                                            int prefix_len, int tile) {
  if (q0 + offset < 0 && prefix_len < 1) {
    return n_tiles;
  }
  return min(n_tiles, max(last_row + offset, prefix_len - 1) / tile + 1);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * D * kLd + kBlockK * D + kBlockQ * kLd);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_simt(const Params p) {
  constexpr int kVec = D >= 64 ? 4 : 2;      // accumulator columns per vector
  constexpr int kGroups = D / (16 * kVec);   // vectors per row per thread
  constexpr int kCols = kVec * kGroups;      // = D / 16
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [D][kLd]       q tile, transposed
  float* kt = qt + D * kLd;                     // [D][kLd]       k tile, transposed
  float* vs = kt + D * kLd;                     // [kBlockK][D]   v tile
  float* ps = vs + kBlockK * D;                 // [kBlockQ][kLd] probabilities

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int nq = (p.sq + kBlockQ - 1) / kBlockQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.group;
  const int offset = p.sk - p.sq;
  const int64_t stat0 = (static_cast<int64_t>(b) * gridDim.y + h) * p.sq;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int e = tid; e < kBlockQ * D; e += kThreads) {
    const int r = e / D;
    const int d = e % D;
    const int row = q0 + r;
    qt[d * kLd + r] = row < p.sq ? to_f32(q[row * p.q_ss + d]) : 0.f;
  }

  float acc[4][kCols];
  float m[4];
  float l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (p.sk + kBlockK - 1) / kBlockK;
  if (p.causal) {
    n_tiles = causal_tiles(n_tiles, q0, min(q0 + kBlockQ, p.sq) - 1, offset, p.prefix_len,
                           kBlockK);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the q tile is stored; the last tile's k, v, p are read
    for (int e = tid; e < kBlockK * D; e += kThreads) {
      const int c = e / D;
      const int d = e % D;
      const int col = k0 + c;
      float kv = 0.f;
      float vv = 0.f;
      if (col < p.sk) {
        kv = to_f32(k[col * p.k_ss + d]);
        vv = to_f32(v[col * p.v_ss + d]);
      }
      kt[d * kLd + c] = kv;
      vs[c * D + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a4 = *reinterpret_cast<const float4*>(qt + d * kLd + ty * 4);
      const float4 b4 = *reinterpret_cast<const float4*>(kt + d * kLd + tx * 4);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bk[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        float x = s[i][j] * p.scale;
        if (col >= p.sk) {
          x = -INFINITY;  // not a key: weight exactly 0 for every row
        } else if (p.causal && col > row + offset && col >= p.prefix_len) {
          x = kMasked;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      }
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
      *reinterpret_cast<float4*>(ps + (ty * 4 + i) * kLd + tx * 4) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kBlockK; kk += 4) {
      float pr[4][4];  // [row i][key kk + u]
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(ps + (ty * 4 + i) * kLd + kk);
        pr[i][0] = x.x;
        pr[i][1] = x.y;
        pr[i][2] = x.z;
        pr[i][3] = x.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = vs + (kk + u) * D + tx * kVec;
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          float vv[kVec];
          if constexpr (kVec == 4) {
            const float4 x = *reinterpret_cast<const float4*>(vrow + g * 16 * kVec);
            vv[0] = x.x;
            vv[1] = x.y;
            vv[2] = x.z;
            vv[3] = x.w;
          } else {
            const float2 x = *reinterpret_cast<const float2*>(vrow + g * 16 * kVec);
            vv[0] = x.x;
            vv[1] = x.y;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int e = 0; e < kVec; ++e) {
              acc[i][g * kVec + e] = fmaf(pr[i][u], vv[e], acc[i][g * kVec + e]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
    if (p.m != nullptr && tx == 0) {  // the 16 threads of a row hold the same m, l
      p.m[stat0 + row] = m[i];
      p.l[stat0 + row] = li;
    }
    T* orow = o + row * p.o_ss;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        orow[g * 16 * kVec + tx * kVec + e] = from_f32<T>(acc[i][g * kVec + e] / li);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch_typed(const Params& p, int b, int hq, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_simt<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    return err;
  }
  const dim3 grid(static_cast<unsigned>((p.sq + kBlockQ - 1) / kBlockQ),
                  static_cast<unsigned>(hq), static_cast<unsigned>(b));
  flash_fwd_simt<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(const Params& p, int b, int hq, int d, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch_typed<T, 32>(p, b, hq, stream);
    case 64:
      return launch_typed<T, 64>(p, b, hq, stream);
    case 128:
      return launch_typed<T, 128>(p, b, hq, stream);
    case 256:
      return launch_typed<T, 256>(p, b, hq, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16 / f16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcBlockQ = 128;  // q rows per CTA: 2 warpgroups x 64
constexpr int kTcBlockK = 64;   // keys per tile
constexpr int kTcThreads = 256;

struct TcParams {
  void* o;
  int64_t o_sb, o_sh, o_ss;  // element strides of out's (b, h, s); d stride is 1
  int sq, sk, group;
  float scale_log2;          // scale * log2(e)
  int causal;
  int prefix_len;            // keys every row may see (the prefix-LM mask); 0: none
  int slots[3];              // q, k, v: the map slot (1..3) of S | of H << 2
  float* m;                  // (b, hq, sq) row statistics, or null
  float* l;
};

// Shared-memory layout of one head dim: rows of one panel (kPanel elements
// of 16 bits, 128 or 64 bytes), panels one after the other; kStages k/v
// tiles in the ring (2 at D = 256: 3 would pass the 227 KB a block may have).
template <int D>
struct TcShape {
  static constexpr int kStages = D >= 256 ? 2 : 3;
  static constexpr int kPanel = D < 64 ? D : 64;
  static constexpr int kPanels = D / kPanel;
  static constexpr uint32_t kRowBytes = kPanel * 2;
  static constexpr int kSwizzle = kRowBytes == 128 ? 1 : 2;  // descriptor: 128B / 64B
  static constexpr uint32_t kQBytes = kTcBlockQ * D * 2;
  static constexpr uint32_t kKvBytes = kTcBlockK * D * 2;    // one k or v tile
  static constexpr size_t kSmem = kQBytes + 2 * kStages * kKvBytes + 1024;  // + alignment
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of `map` into shared memory at `dst`: column d0 of D, then the s,
// h and b coordinates placed in the map's slots (`slots`: S | H << 2; B takes
// the slot left over).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int d0, int s, int h, int b, int slots) {
  const int ss = slots & 3;
  const int hs = (slots >> 2) & 3;
  const int c1 = ss == 1 ? s : hs == 1 ? h : b;
  const int c2 = ss == 2 ? s : hs == 2 ? h : b;
  const int c3 = ss == 3 ? s : hs == 3 ? h : b;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle mode.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(swizzle) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>  // until at most N committed groups are still running
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers that an asynchronous wgmma reads or writes, so the compiler
// moves no access to them across the fence / wait around it.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 values as one 32-bit register of two 16-bit values (x0 in the low
// half, the first column), rounded to nearest even; `rest` gets what the
// rounding left out.
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16*, float x0, float x1, float* rest) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
  rest[0] = x0 - __low2float(v);
  rest[1] = x1 - __high2float(v);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack2(__half*, float x0, float x1, float* rest) {
  const __half2 v = __floats2half2_rn(x0, x1);
  rest[0] = x0 - __low2float(v);
  rest[1] = x1 - __high2float(v);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// S (64 x 64 per warpgroup) += A (64 x 16, shared) . B (64 x 16, shared)^T;
// scale_d == 0 overwrites S.
template <typename T>
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t a, uint64_t b, int scale_d);
// O (64 x D per warpgroup) += A (64 x 16, registers) . B (16 x D, shared,
// D contiguous: the transpose mode).
template <typename T, int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t b);
// O (64 x 256) += A . B as two m64n128k16, one per half of the accumulator:
// registers 0-63 hold columns 0-127 and 64-127 columns 128-255 (an n = 256
// fragment's j-th group of 8 columns is registers 4j..4j+3), and the second
// half of B starts two 64-column panels on (`half_bytes`, the panel stride
// times 2).
template <typename T>
__device__ __forceinline__ void wgmma_pv256(float (&d)[128], const uint32_t (&a)[4], uint64_t b,
                                            uint32_t half_bytes) {
  wgmma_pv<T, 128>(*reinterpret_cast<float(*)[64]>(&d[0]), a, b);
  wgmma_pv<T, 128>(*reinterpret_cast<float(*)[64]>(&d[64]), a,
                   b + static_cast<uint64_t>((half_bytes & 0x3FFFF) >> 4));
}

template <>
__device__ __forceinline__ void wgmma_qk<__nv_bfloat16>(float (&d)[32], uint64_t a, uint64_t b,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_pv<__nv_bfloat16, 32>(float (&d)[16], const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<__nv_bfloat16, 64>(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<__nv_bfloat16, 128>(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_qk<__half>(float (&d)[32], uint64_t a, uint64_t b,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_pv<__half, 32>(float (&d)[16], const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<__half, 64>(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<__half, 128>(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// 2 CTAs per SM where the registers allow (D <= 64: at most 128 a thread):
// one CTA's softmax then runs beside the other's wgmma
template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads, D <= 64 ? 2 : 1)
    flash_fwd_tc(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const TcParams p) {
  using L = TcShape<D>;
  constexpr int kSteps = D / 16;           // k16 steps of q . k
  constexpr int kPSteps = kTcBlockK / 16;  // k16 steps of p . v
  constexpr uint32_t kSbo = 8 * L::kRowBytes;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[1 + kStages];  // q, then one per k/v stage
  const uint32_t q_smem = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms
  const uint32_t k_smem = q_smem + L::kQBytes;
  const uint32_t v_smem = k_smem + kStages * L::kKvBytes;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int nq = (p.sq + kTcBlockQ - 1) / kTcBlockQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.z)) * kTcBlockQ;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int hk = h / p.group;
  const int offset = p.sk - p.sq;

  int n_tiles = (p.sk + kTcBlockK - 1) / kTcBlockK;
  if (p.causal) {
    n_tiles = causal_tiles(n_tiles, q0, min(q0 + kTcBlockQ, p.sq) - 1, offset, p.prefix_len,
                           kTcBlockK);
  }

  auto load_kv = [&](int t, int stage) {
    const uint32_t bar = smem_u32(&bars[1 + stage]);
    mbar_expect_tx(bar, 2 * L::kKvBytes);
#pragma unroll
    for (int panel = 0; panel < L::kPanels; ++panel) {
      const uint32_t off = stage * L::kKvBytes + panel * kTcBlockK * L::kRowBytes;
      tma_load(k_smem + off, &tk, bar, panel * L::kPanel, t * kTcBlockK, hk, b, p.slots[1]);
      tma_load(v_smem + off, &tv, bar, panel * L::kPanel, t * kTcBlockK, hk, b, p.slots[2]);
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 1 + kStages; ++i) mbar_init(smem_u32(&bars[i]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    const uint32_t bar = smem_u32(&bars[0]);
    mbar_expect_tx(bar, L::kQBytes);
#pragma unroll
    for (int panel = 0; panel < L::kPanels; ++panel) {
      tma_load(q_smem + panel * kTcBlockQ * L::kRowBytes, &tq, bar, panel * L::kPanel, q0, h, b,
               p.slots[0]);
    }
    for (int t = 0; t < min(kStages, n_tiles); ++t) load_kv(t, t);
  }

  // this thread's accumulator rows: r and r + 8 of its warpgroup's 64
  const int wg_row0 = q0 + wg * 64;
  const int row0 = wg_row0 + warp * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  float o[D / 2];
  float s[kTcBlockK / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kTcBlockK / 2; ++i) s[i] = 0.f;
  float m[2] = {kMasked, kMasked};
  float l[2] = {0.f, 0.f};
  // P as two A fragments, P = ph + pl, each rounded to T; k16 step kk of
  // p . v takes S registers 8kk..8kk+7 in pairs
  uint32_t ph[kPSteps][4];
  uint32_t pl[kPSteps][4];

  auto issue_qk = [&](int stage) {
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const int panel = kk * 16 / L::kPanel;
      const uint32_t col = (kk * 16 % L::kPanel) * 2;
      const uint64_t da = smem_desc(
          q_smem + panel * kTcBlockQ * L::kRowBytes + wg * 64 * L::kRowBytes + col, 16, kSbo,
          L::kSwizzle);
      const uint64_t db = smem_desc(
          k_smem + stage * L::kKvBytes + panel * kTcBlockK * L::kRowBytes + col, 16, kSbo,
          L::kSwizzle);
      wgmma_qk<T>(s, da, db, kk > 0);
    }
  };

  auto issue_pv = [&](int stage) {
#pragma unroll
    for (int kk = 0; kk < kPSteps; ++kk) {
      const uint64_t dv = smem_desc(v_smem + stage * L::kKvBytes + kk * 16 * L::kRowBytes,
                                    kTcBlockK * L::kRowBytes, kSbo, L::kSwizzle);
      if constexpr (D == 256) {
        wgmma_pv256<T>(o, ph[kk], dv, 2 * kTcBlockK * L::kRowBytes);
        wgmma_pv256<T>(o, pl[kk], dv, 2 * kTcBlockK * L::kRowBytes);
      } else {
        wgmma_pv<T, D>(o, ph[kk], dv);
        wgmma_pv<T, D>(o, pl[kk], dv);
      }
    }
  };

  // Tile t's scores in s -> probabilities, with the row max and row sum
  // carried in m and l; alpha gets the factor the accumulator's rows take.
  // A tile with no mask (kFold) keeps the raw scores, takes their max and
  // scales inside exp2's argument with one fma; a tile on the causal
  // diagonal (and not inside the prefix) or past Sk scales first and masks.
  auto softmax = [&](int t, float (&alpha)[2]) {
    const int k0 = t * kTcBlockK;
    const bool edge = k0 + kTcBlockK > p.sk ||
                      (p.causal && k0 + kTcBlockK - 1 > wg_row0 + offset &&
                       k0 + kTcBlockK > p.prefix_len);
    auto rows = [&](auto fold) {
      constexpr bool kFold = decltype(fold)::value;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 8 * i;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kTcBlockK / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float x = s[4 * j + 2 * i + c];
            if constexpr (!kFold) {
              x *= p.scale_log2;
              const int key = k0 + 8 * j + col0 + c;
              if (key >= p.sk) {
                x = -INFINITY;  // not a key: weight exactly 0 for every row
              } else if (p.causal && key > row + offset && key >= p.prefix_len) {
                x = kMasked;
              }
              s[4 * j + 2 * i + c] = x;
            }
            mx = fmaxf(mx, x);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], kFold ? mx * p.scale_log2 : mx);
        alpha[i] = ex2(m[i] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < kTcBlockK / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float x = s[4 * j + 2 * i + c];
            const float e = ex2(kFold ? fmaf(x, p.scale_log2, -m_new) : x - m_new);
            s[4 * j + 2 * i + c] = e;
            rs += e;
          }
        }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        l[i] = l[i] * alpha[i] + rs;
        m[i] = m_new;
      }
    };
    // the max of the raw scores is the max of the logits only for scale > 0
    if (!edge && p.scale_log2 > 0.f) {
      rows(std::true_type{});
    } else {
      rows(std::false_type{});
    }
  };

  // The accumulator's rows times alpha (skipped when no row of the warp
  // changed its max: a multiply by 1), and s packed into ph + pl.
  auto rescale_pack = [&](const float (&alpha)[2]) {
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          o[4 * j + 2 * i] *= alpha[i];
          o[4 * j + 2 * i + 1] *= alpha[i];
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < kPSteps; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float rest[2];
        float unused[2];
        ph[kk][r] = pack2(static_cast<T*>(nullptr), s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], rest);
        pl[kk][r] = pack2(static_cast<T*>(nullptr), rest[0], rest[1], unused);
      }
    }
  };

  // Tile t's q . k runs on the tensor cores beside tile t - 1's p . v; the
  // softmax of tile t waits for the first only, the accumulator's rescale
  // for both. Both warpgroups then give tile t - 1's stage back, and tile
  // t - 1 + kStages is asked for.
  float alpha[2];
  mbar_wait(smem_u32(&bars[0]), 0);
  mbar_wait(smem_u32(&bars[1]), 0);
  pin(s);
  wgmma_fence();
  issue_qk(0);
  wgmma_commit();
  wgmma_wait<0>();
  pin(s);
  softmax(0, alpha);
  rescale_pack(alpha);
  for (int t = 1; t < n_tiles; ++t) {
    const int stage = t % kStages;
    if constexpr (D < 256) {
      mbar_wait(smem_u32(&bars[1 + stage]), (t / kStages) & 1);
      pin(s);
      pin(o);
      pin(ph);
      pin(pl);
      wgmma_fence();
      issue_qk(stage);
      wgmma_commit();
      issue_pv((t - 1) % kStages);
      wgmma_commit();
      wgmma_wait<1>();
      pin(s);
      softmax(t, alpha);
      wgmma_wait<0>();
      pin(o);
      pin(ph);
      pin(pl);
      __syncthreads();  // both warpgroups are done with tile t - 1's stage
      if (tid == 0 && t - 1 + kStages < n_tiles) load_kv(t - 1 + kStages, (t - 1) % kStages);
      rescale_pack(alpha);
    } else {
      // D = 256: S, P and O live together while both products run would
      // take 192 of a thread's 255 registers before the softmax's own, and
      // spill; so tile t - 1's p . v runs first, then tile t's q . k (whose
      // wait the next stage's load overlaps)
      pin(o);
      pin(ph);
      pin(pl);
      wgmma_fence();
      issue_pv((t - 1) % kStages);
      wgmma_commit();
      wgmma_wait<0>();
      pin(o);
      pin(ph);
      pin(pl);
      __syncthreads();  // both warpgroups are done with tile t - 1's stage
      if (tid == 0 && t - 1 + kStages < n_tiles) load_kv(t - 1 + kStages, (t - 1) % kStages);
      mbar_wait(smem_u32(&bars[1 + stage]), (t / kStages) & 1);
      pin(s);
      wgmma_fence();
      issue_qk(stage);
      wgmma_commit();
      wgmma_wait<0>();
      pin(s);
      softmax(t, alpha);
      rescale_pack(alpha);
    }
  }
  pin(o);
  pin(ph);
  pin(pl);
  wgmma_fence();
  issue_pv((n_tiles - 1) % kStages);
  wgmma_commit();
  wgmma_wait<0>();
  pin(o);

  T* out = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int64_t stat0 = (static_cast<int64_t>(b) * gridDim.x + h) * p.sq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= p.sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
    if (p.m != nullptr && col0 == 0) {  // the quad's 4 threads hold the same m, l
      // m is in the log2 domain here; a row with no key keeps -1e30 exactly
      p.m[stat0 + row] = m[i] == kMasked ? kMasked : m[i] * 0.6931471805599453f;
      p.l[stat0 + row] = li;
    }
    T* orow = out + row * p.o_ss + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      float rest[2];
      *reinterpret_cast<uint32_t*>(orow + 8 * j) = pack2(
          static_cast<T*>(nullptr), o[4 * j + 2 * i] / li, o[4 * j + 2 * i + 1] / li, rest);
    }
  }
}

// cuTensorMapEncodeTiled, looked up in the driver through the runtime, so
// the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      ptr = nullptr;
    }
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

constexpr int kErrNoEncode = 10000;  // cuTensorMapEncodeTiled not found
constexpr int kErrEncode = 10001;    // cuTensorMapEncodeTiled refused a map

// One operand's map: `desc` holds dims[4] (D first), byte strides[3] of dims
// 1..3 and the slots (S | H << 2); the box is one panel of D by `rows` along S.
int encode_map(CUtensorMap* map, const void* ptr, const int64_t* desc, int rows, int panel,
               CUtensorMapDataType type) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) {
    return kErrNoEncode;
  }
  cuuint64_t dims[4];
  cuuint64_t strides[3];
  cuuint32_t box[4] = {static_cast<cuuint32_t>(panel), 1, 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) dims[i] = static_cast<cuuint64_t>(desc[i]);
  for (int i = 0; i < 3; ++i) strides[i] = static_cast<cuuint64_t>(desc[4 + i]);
  box[desc[7] & 3] = static_cast<cuuint32_t>(rows);
  const CUresult r = encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box,
                            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            panel * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                             : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // out of bounds reads 0
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

template <typename T, int D>
int launch_tc(const void* q, const void* k, const void* v, const int64_t* maps, TcParams p,
              int b, int hq, CUtensorMapDataType type, cudaStream_t stream) {
  using L = TcShape<D>;
  CUtensorMap tq, tk, tv;
  int err = encode_map(&tq, q, maps, kTcBlockQ, L::kPanel, type);
  if (err == 0) err = encode_map(&tk, k, maps + 8, kTcBlockK, L::kPanel, type);
  if (err == 0) err = encode_map(&tv, v, maps + 16, kTcBlockK, L::kPanel, type);
  if (err != 0) {
    return err;
  }
  for (int i = 0; i < 3; ++i) p.slots[i] = static_cast<int>(maps[8 * i + 7]);
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_fwd_tc<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kSmem));
  if (cerr != cudaSuccess) {
    return cerr;
  }
  const int nq = (p.sq + kTcBlockQ - 1) / kTcBlockQ;
  if (nq > 65535) {
    return cudaErrorInvalidValue;
  }
  // q tiles on grid z, longest first: every head's long causal tiles start
  // before any short one
  const dim3 grid(static_cast<unsigned>(hq), static_cast<unsigned>(b), static_cast<unsigned>(nq));
  flash_fwd_tc<T, D><<<grid, kTcThreads, L::kSmem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

template <typename T>
int launch_tc_dim(const void* q, const void* k, const void* v, const int64_t* maps,
                  const TcParams& p, int b, int hq, int d, CUtensorMapDataType type,
                  cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch_tc<T, 32>(q, k, v, maps, p, b, hq, type, stream);
    case 64:
      return launch_tc<T, 64>(q, k, v, maps, p, b, hq, type, stream);
    case 128:
      return launch_tc<T, 128>(q, k, v, maps, p, b, hq, type, stream);
    case 256:
      return launch_tc<T, 256>(q, k, v, maps, p, b, hq, type, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: device pointers of float32; shapes q/o (b, hq, sq, d) and
// k/v (b, hkv, sk, d). strides: 12 element strides, (b, h, s) for q, k, v, o
// in that order; every d stride is 1. prefix_len: keys every row may see
// under the causal mask (0: none). m, l: null, or (b, hq, sq) f32 arrays
// for the row statistics. The caller makes the tensors' device current. The
// one kernel goes on `stream`; nothing is synchronised or allocated here.
extern "C" int flash_attention_simt_launch(const void* q, const void* k, const void* v, void* o,
                                           const int64_t* strides, int b, int hq, int hkv,
                                           int sq, int sk, int d, float scale, int causal,
                                           int prefix_len, float* m, float* l,
                                           cudaStream_t stream) {
  if (q == nullptr || k == nullptr || v == nullptr || o == nullptr || strides == nullptr ||
      b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0 || sk <= 0 || b > 65535 ||
      hq > 65535 || prefix_len < 0) {
    return cudaErrorInvalidValue;
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_sb = strides[0];
  p.q_sh = strides[1];
  p.q_ss = strides[2];
  p.k_sb = strides[3];
  p.k_sh = strides[4];
  p.k_ss = strides[5];
  p.v_sb = strides[6];
  p.v_sh = strides[7];
  p.v_ss = strides[8];
  p.o_sb = strides[9];
  p.o_sh = strides[10];
  p.o_ss = strides[11];
  p.sq = sq;
  p.sk = sk;
  p.group = hq / hkv;
  p.scale = scale;
  p.causal = causal;
  p.prefix_len = prefix_len;
  p.m = m;
  p.l = l;
  return launch_dim<float>(p, b, hq, d, stream);
}

// q, k, v: device pointers of `dtype` (1 bfloat16, 2 float16), 16-byte
// aligned. maps: for q, k, v in turn, 8 values: the 4-D tensor map's dims
// (D first, then S, H, B in the order of their strides), the byte strides of
// dims 1..3 (multiples of 16) and the slots of S and H (S | H << 2).
// o: (b, hq, sq, d) of `dtype` with element strides o_strides (b, h, s) and
// unit stride in d. prefix_len: keys every row may see under the causal mask
// (0: none). m, l: null, or (b, hq, sq) f32 arrays for the row
// statistics. The caller makes the tensors' device current. The one kernel
// goes on `stream`; nothing is synchronised or allocated here.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k, const void* v, void* o,
                                            const int64_t* maps, const int64_t* o_strides, int b,
                                            int hq, int hkv, int sq, int sk, int d, int dtype,
                                            float scale, int causal, int prefix_len, float* m,
                                            float* l, cudaStream_t stream) {
  if (q == nullptr || k == nullptr || v == nullptr || o == nullptr || maps == nullptr ||
      o_strides == nullptr || b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0 ||
      sk <= 0 || b > 65535 || hq > 65535 || prefix_len < 0) {
    return cudaErrorInvalidValue;
  }
  TcParams p;
  p.o = o;
  p.o_sb = o_strides[0];
  p.o_sh = o_strides[1];
  p.o_ss = o_strides[2];
  p.sq = sq;
  p.sk = sk;
  p.group = hq / hkv;
  p.scale_log2 = scale * 1.4426950408889634f;
  p.causal = causal;
  p.prefix_len = prefix_len;
  p.m = m;
  p.l = l;
  switch (dtype) {
    case 1:
      return launch_tc_dim<__nv_bfloat16>(q, k, v, maps, p, b, hq, d,
                                          CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, stream);
    case 2:
      return launch_tc_dim<__half>(q, k, v, maps, p, b, hq, d, CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                                   stream);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_error_string(int err) {
  if (err == kErrNoEncode) {
    return "cuTensorMapEncodeTiled not found in the driver";
  }
  if (err == kErrEncode) {
    return "cuTensorMapEncodeTiled refused a tensor map";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
