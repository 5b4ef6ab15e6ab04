// Backward of causal GQA flash attention for Hopper (sm_90a): dq, dk and dv
// of flash_attention.cu's forward. bf16 and f16 on the tensor cores
// (mma.sync), f32 on the CUDA cores.
//
// Replaces no TPU kernel: the reference has no Pallas backward and trains at
// S >= attn_chunked_threshold by differentiating its pure-JAX
// models/layers.py::_chunked_attention. The port's forward on the card is its
// own kernel, so the gradient that pairs with it is this one; without it the
// port could not train at long sequence lengths on the card.
//
// What it computes, for q (B, Hq, Sq, D), k, v (B, Hkv, Sk, D), the forward's
// output o and row statistics m, l (B, Hq, Sq) (m: the row max of the scaled,
// masked logits in the natural-log domain; l: the softmax denominator after
// the forward's l == 0 -> 1), and the output's gradient dO; kv head of query
// head h is h / (Hq / Hkv):
//
//     Delta = rowsum(dO * O)                                (f32)
//     s     = (q . k) * scale; masked where causal and col > row + Sk - Sq
//     P     = exp(s - m) / l, a masked logit counting as -1e30
//     dP    = dO . v
//     dS    = P * (dP - Delta), 0 at masked positions
//     dq    = scale * dS . k;  dk = scale * dS^T . q (summed over the group's
//             q heads);  dv = P^T . dO (summed likewise)
//
// A masked logit is -1e30, so exp(-1e30 - m) is 0 for a row that has a key
// and 1 for a row with no valid key (Sq > Sk, row < Sq - Sk: m = -1e30). m
// and l are kept apart for that reason: in f32 -1e30 + log(Sk) rounds back
// to -1e30, so P = exp(s - lse) would be 1 at every key of such a row, not
// 1 / Sk. Such a row spreads dO over every key of dv, and its dS is 0
// everywhere (the plain version's torch.where passes no gradient to a masked
// logit), so its dq is 0.
//
// What bounds it: operations. Five products of the forward's size (q k^T, dO
// v^T, dS k, dS^T q, P^T dO) at the training shape (q (2, 14, 8192, 64), k, v
// (2, 2, 8192, 64), bf16, causal): 6.0e11 flop, 0.61 ms at the tensor cores'
// 989 TFLOP/s dense bf16 rate; its 136 MB of inputs and outputs take 0.041
// ms at 3.35 TB/s.
//
// Design: two kernels, so that no float is ever added atomically and the
// result is the same bits from run to run (training restarts bit for bit).
//   1. flash_bwd_dq: one CTA per (q tile, q head, batch), q tiles longest
//      first. It computes Delta for its rows (kept in a (B, Hq, Sq) f32
//      scratch for kernel 2), then walks the key tiles that its rows may
//      see, recomputes s, P and dP, and accumulates dq over them in order.
//   2. flash_bwd_dkdv: one CTA per (key tile, kv head, batch). It walks the
//      group's q heads in order and, per head, the q tiles that weigh its
//      keys (causally admitted rows, and the rows with no key, which weigh
//      every key), recomputes s^T, P^T and dP^T, and accumulates dk and dv
//      over them in that fixed order. The sum over the group's heads, where
//      an atomic version would drift from run to run, is a loop.
//   Kernel 2 runs after kernel 1 on the same stream and reads its Delta.
//   Both recompute s and dP, so the design does 7 products where 5 would
//   do: its own floor is 0.85 ms at the training shape.
//
// bf16 / f16 (flash_bwd_*_mma): 4 warps, 16 rows (kernel 1) or 16 keys
// (kernel 2) each; tiles of 64 rows and 64 keys (32 rows in kernel 2 at D =
// 128, for registers). Tiles go from global memory to shared memory with
// 16-byte loads (rows past Sq or Sk as zeros), row pitch D + 8 elements so
// fragment loads spread over the banks. Every product is mma.sync
// m16n8k16 with f32 accumulators; an operand whose contraction dim is not
// contiguous in shared memory (k in dS k, q in dS^T q and dO in P^T dO) is
// gathered two 16-bit values at a time. P and dS go from the f32 fragments
// of one product to the A fragments of the next, rounded once to the input
// type, never through shared memory. exp is ex2 of the logit in the log2
// domain, as in the forward.
//
// f32 (flash_bwd_*_simt): the same two kernels on the CUDA cores (mma has no
// f32 inputs; TF32 would not meet the f32 limit), 256 threads, 32-row and
// 32-key tiles in shared memory, P and dS through shared memory, expf.
//
// Strides: q, k, v, o and dO are read through their (b, h, s) element
// strides with unit stride in D (the model's transposed v view needs no
// copy); dq, dk and dv are written contiguous, in their inputs' types.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* m;  // (b, hq, sq) row max, natural-log domain
  const float* l;  // (b, hq, sq) softmax denominator
  float* delta;    // (b, hq, sq) scratch: rowsum(dO * O), written by kernel 1
  void* dq;        // (b, hq, sq, d) contiguous
  void* dk;        // (b, hkv, sk, d) contiguous
  void* dv;
  int64_t q_sb, q_sh, q_ss;  // element strides of (b, h, s); d stride is 1
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int64_t do_sb, do_sh, do_ss;
  int hq, hkv, sq, sk, group;
  float scale;
  int causal;
};

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f32<__half>(__half x) { return __half2float(x); }

// Where a (row, key) pair stands: outside the tensors (weight 0, no
// gradient), masked by causality, or a plain logit.
struct Pair {
  bool valid;
  bool masked;
};

__device__ __forceinline__ Pair pair_at(const Params& p, int row, int key) {
  const bool valid = row < p.sq && key < p.sk;
  return {valid, valid && p.causal && key > row + p.sk - p.sq};
}

// Causal: the number of key tiles of `bk` keys that rows [q0, last_row]
// may see (kernel 1: a row with no key needs none).
__device__ __forceinline__ int key_tiles(const Params& p, int last_row, int bk) {
  const int all = (p.sk + bk - 1) / bk;
  if (!p.causal) {
    return all;
  }
  const int last_key = last_row + p.sk - p.sq;
  return last_key < 0 ? 0 : min(all, last_key / bk + 1);
}

// Causal: whether q tile [q0, q0 + bq) holds a row that weighs a key of
// [k0, ...): a row that sees k0, or a row with no key (it weighs every key).
__device__ __forceinline__ bool q_tile_weighs(const Params& p, int q0, int bq, int k0) {
  if (!p.causal) {
    return true;
  }
  const int offset = p.sk - p.sq;
  const int last_row = min(q0 + bq, p.sq) - 1;
  return last_row + offset >= k0 || q0 + offset < 0;
}

// ---------------------------------------------------------------------------
// bf16 / f16: tensor cores (mma.sync m16n8k16, f32 accumulate)
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// D (16 x 8, f32) += A (16 x 16, row) . B (16 x 8, col)
template <typename T>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// Two f32 values as one register of two 16-bit values (x0 in the low half),
// rounded to nearest even.
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16*, float x0, float x1) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack2(__half*, float x0, float x1) {
  const __half2 v = __floats2half2_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Shared-memory tile of 16-bit values, rows of `kLd` elements.
template <typename T, int kLd>
struct Tile {
  T* base;
  // elements (row, col) and (row, col + 1): the contraction dim is the row
  __device__ __forceinline__ uint32_t pair(int row, int col) const {
    return *reinterpret_cast<const uint32_t*>(base + row * kLd + col);
  }
  // elements (row, col) and (row + 1, col): the contraction dim is the column
  __device__ __forceinline__ uint32_t pair_down(int row, int col) const {
    const uint16_t* raw = reinterpret_cast<const uint16_t*>(base);
    return static_cast<uint32_t>(raw[row * kLd + col]) |
           (static_cast<uint32_t>(raw[(row + 1) * kLd + col]) << 16);
  }
  // A fragment of rows r0..r0+15, columns c0..c0+15
  __device__ __forceinline__ void a_frag(uint32_t (&a)[4], int r0, int c0, int lane) const {
    const int g = lane >> 2;
    const int t = 2 * (lane & 3);
    a[0] = pair(r0 + g, c0 + t);
    a[1] = pair(r0 + g + 8, c0 + t);
    a[2] = pair(r0 + g, c0 + t + 8);
    a[3] = pair(r0 + g + 8, c0 + t + 8);
  }
};

// Rows [row0, row0 + rows) of a (s, d) operand with row stride `ss` into a
// shared tile, rows at or past `n` as zeros; 16-byte loads (the wrapper
// checks the alignment).
template <typename T, int D, int kLd>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int64_t ss, int row0, int rows,
                                          int n) {
  constexpr int kVecs = D / 8;
  for (int e = threadIdx.x; e < rows * kVecs; e += blockDim.x) {
    const int r = e / kVecs;
    const int c = (e % kVecs) * 8;
    const int row = row0 + r;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row < n) {
      x = *reinterpret_cast<const uint4*>(src + row * ss + c);
    }
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = x;
  }
}

template <int D>
constexpr size_t dq_mma_smem(int itemsize) {
  return static_cast<size_t>(4 * 64 * (D + 8)) * itemsize;
}

// Kernel 1, tensor cores: Delta and dq of one 64-row q tile.
template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads) flash_bwd_dq_mma(const Params p) {
  constexpr int kBq = 64;
  constexpr int kBk = 64;
  constexpr int kLd = D + 8;
  extern __shared__ uint4 smem_dq[];
  T* qs = reinterpret_cast<T*>(smem_dq);
  T* dos = qs + kBq * kLd;
  T* ks = dos + kBq * kLd;
  T* vs = ks + kBk * kLd;
  const Tile<T, kLd> tq{qs}, tdo{dos}, tk{ks}, tv{vs};

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = 2 * (lane & 3);
  const int nq = (p.sq + kBq - 1) / kBq;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kBq;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.group;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* o = static_cast<const T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const int64_t stat0 = (static_cast<int64_t>(b) * p.hq + h) * p.sq;

  load_rows<T, D, kLd>(qs, q, p.q_ss, q0, kBq, p.sq);
  load_rows<T, D, kLd>(dos, dout, p.do_ss, q0, kBq, p.sq);
  __syncthreads();

  // this thread's rows, r = warp * 16 + g and r + 8: their statistics, and
  // Delta, summed over D by the four threads of the row's quad
  float m_log2[2];
  float inv_l[2];
  float dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
    const int row = q0 + r;
    const bool in = row < p.sq;
    m_log2[i] = in ? p.m[stat0 + row] * kLog2e : 0.f;
    inv_l[i] = in ? 1.f / p.l[stat0 + row] : 0.f;
    float acc = 0.f;
    if (in) {
      const T* orow = o + row * p.o_ss;
      for (int d = lane & 3; d < D; d += 4) {
        acc = fmaf(to_f32(dos[r * kLd + d]), to_f32(orow[d]), acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dl[i] = acc;
    if (in && (lane & 3) == 0) {
      p.delta[stat0 + row] = acc;
    }
  }
  const float scale_log2 = p.scale * kLog2e;

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  }

  const int n_tiles = key_tiles(p, min(q0 + kBq, p.sq) - 1, kBk);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBk;
    __syncthreads();  // the last tile's k and v are read
    load_rows<T, D, kLd>(ks, k, p.k_ss, k0, kBk, p.sk);
    load_rows<T, D, kLd>(vs, v, p.v_ss, k0, kBk, p.sk);
    __syncthreads();

    float s[kBk / 8][4];
    float dp[kBk / 8][4];
#pragma unroll
    for (int j = 0; j < kBk / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = 0.f;
        dp[j][e] = 0.f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4];
      uint32_t ado[4];
      tq.a_frag(aq, warp * 16, kk * 16, lane);
      tdo.a_frag(ado, warp * 16, kk * 16, lane);
#pragma unroll
      for (int j = 0; j < kBk / 8; ++j) {
        mma<T>(s[j], aq, tk.pair(8 * j + g, kk * 16 + t), tk.pair(8 * j + g, kk * 16 + t + 8));
        mma<T>(dp[j], ado, tv.pair(8 * j + g, kk * 16 + t), tv.pair(8 * j + g, kk * 16 + t + 8));
      }
    }

    // s -> dS, in place
#pragma unroll
    for (int j = 0; j < kBk / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2;
        const Pair pr = pair_at(p, q0 + warp * 16 + g + 8 * i, k0 + 8 * j + t + (e & 1));
        float ds = 0.f;
        if (pr.valid && !pr.masked) {
          const float pv = ex2(fmaf(s[j][e], scale_log2, -m_log2[i])) * inv_l[i];
          ds = pv * (dp[j][e] - dl[i]);
        }
        s[j][e] = ds;
      }
    }

    // dq += dS . k
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack2(static_cast<T*>(nullptr), s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack2(static_cast<T*>(nullptr), s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack2(static_cast<T*>(nullptr), s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack2(static_cast<T*>(nullptr), s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        mma<T>(dq[n], a, tk.pair_down(kk * 16 + t, 8 * n + g),
               tk.pair_down(kk * 16 + t + 8, 8 * n + g));
      }
    }
  }

  T* out = static_cast<T*>(p.dq) + (static_cast<int64_t>(b) * p.hq + h) * p.sq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + 8 * i;
    if (row >= p.sq) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(out + static_cast<int64_t>(row) * D + 8 * n + t) =
          pack2(static_cast<T*>(nullptr), dq[n][2 * i] * p.scale, dq[n][2 * i + 1] * p.scale);
    }
  }
}

template <int D>
constexpr int kDkdvBq = D == 128 ? 32 : 64;  // q rows per tile of kernel 2

template <int D>
constexpr size_t dkdv_mma_smem(int itemsize) {
  return static_cast<size_t>((2 * 64 + 2 * kDkdvBq<D>) * (D + 8)) * itemsize +
         3 * sizeof(float) * kDkdvBq<D>;
}

// Kernel 2, tensor cores: dk and dv of one 64-key tile.
template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads) flash_bwd_dkdv_mma(const Params p) {
  constexpr int kBk = 64;
  constexpr int kBq = kDkdvBq<D>;
  constexpr int kLd = D + 8;
  extern __shared__ uint4 smem_dkdv[];
  T* ks = reinterpret_cast<T*>(smem_dkdv);
  T* vs = ks + kBk * kLd;
  T* qs = vs + kBk * kLd;
  T* dos = qs + kBq * kLd;
  float* ms = reinterpret_cast<float*>(dos + kBq * kLd);  // m in the log2 domain
  float* ils = ms + kBq;                                  // 1 / l
  float* dls = ils + kBq;                                 // Delta
  const Tile<T, kLd> tq{qs}, tdo{dos}, tk{ks}, tv{vs};

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = 2 * (lane & 3);
  const int k0 = static_cast<int>(blockIdx.x) * kBk;  // the most q rows first
  const int hk = blockIdx.y;
  const int b = blockIdx.z;

  load_rows<T, D, kLd>(ks, static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh, p.k_ss, k0,
                       kBk, p.sk);
  load_rows<T, D, kLd>(vs, static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh, p.v_ss, k0,
                       kBk, p.sk);
  const float scale_log2 = p.scale * kLog2e;

  float dk[D / 8][4];
  float dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[n][e] = 0.f;
      dv[n][e] = 0.f;
    }
  }

  const int nq = (p.sq + kBq - 1) / kBq;
  for (int h = hk * p.group; h < (hk + 1) * p.group; ++h) {
    const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
    const int64_t stat0 = (static_cast<int64_t>(b) * p.hq + h) * p.sq;
    for (int iq = 0; iq < nq; ++iq) {
      const int q0 = iq * kBq;
      if (!q_tile_weighs(p, q0, kBq, k0)) continue;
      __syncthreads();  // the last tile's q, dO and statistics are read
      load_rows<T, D, kLd>(qs, q, p.q_ss, q0, kBq, p.sq);
      load_rows<T, D, kLd>(dos, dout, p.do_ss, q0, kBq, p.sq);
      for (int r = tid; r < kBq; r += kMmaThreads) {
        const int row = q0 + r;
        const bool in = row < p.sq;
        const float mi = in ? p.m[stat0 + row] : 0.f;
        // a row with no key keeps -1e30 exactly (the masked test below)
        ms[r] = mi == kMasked ? kMasked : mi * kLog2e;
        ils[r] = in ? 1.f / p.l[stat0 + row] : 0.f;
        dls[r] = in ? p.delta[stat0 + row] : 0.f;
      }
      __syncthreads();

      float st[kBq / 8][4];  // s^T, then P^T
      float dpt[kBq / 8][4];  // dP^T, then dS^T
#pragma unroll
      for (int j = 0; j < kBq / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          st[j][e] = 0.f;
          dpt[j][e] = 0.f;
        }
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4];
        uint32_t av[4];
        tk.a_frag(ak, warp * 16, kk * 16, lane);
        tv.a_frag(av, warp * 16, kk * 16, lane);
#pragma unroll
        for (int j = 0; j < kBq / 8; ++j) {
          mma<T>(st[j], ak, tq.pair(8 * j + g, kk * 16 + t), tq.pair(8 * j + g, kk * 16 + t + 8));
          mma<T>(dpt[j], av, tdo.pair(8 * j + g, kk * 16 + t),
                 tdo.pair(8 * j + g, kk * 16 + t + 8));
        }
      }

      // element e of n-block j: key k0 + warp * 16 + g + 8 (e / 2), row
      // q0 + 8 j + t + (e & 1)
#pragma unroll
      for (int j = 0; j < kBq / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 8 * j + t + (e & 1);
          const Pair pr = pair_at(p, q0 + r, k0 + warp * 16 + g + 8 * (e / 2));
          float pv = 0.f;
          float ds = 0.f;
          if (pr.valid) {
            if (pr.masked) {
              pv = ms[r] == kMasked ? ils[r] : 0.f;  // exp(-1e30 - m) / l
            } else {
              pv = ex2(fmaf(st[j][e], scale_log2, -ms[r])) * ils[r];
              ds = pv * (dpt[j][e] - dls[r]);
            }
          }
          st[j][e] = pv;
          dpt[j][e] = ds;
        }
      }

      // dv += P^T . dO and dk += dS^T . q
#pragma unroll
      for (int kk = 0; kk < kBq / 16; ++kk) {
        uint32_t ap[4];
        uint32_t ads[4];
        ap[0] = pack2(static_cast<T*>(nullptr), st[2 * kk][0], st[2 * kk][1]);
        ap[1] = pack2(static_cast<T*>(nullptr), st[2 * kk][2], st[2 * kk][3]);
        ap[2] = pack2(static_cast<T*>(nullptr), st[2 * kk + 1][0], st[2 * kk + 1][1]);
        ap[3] = pack2(static_cast<T*>(nullptr), st[2 * kk + 1][2], st[2 * kk + 1][3]);
        ads[0] = pack2(static_cast<T*>(nullptr), dpt[2 * kk][0], dpt[2 * kk][1]);
        ads[1] = pack2(static_cast<T*>(nullptr), dpt[2 * kk][2], dpt[2 * kk][3]);
        ads[2] = pack2(static_cast<T*>(nullptr), dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
        ads[3] = pack2(static_cast<T*>(nullptr), dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          mma<T>(dv[n], ap, tdo.pair_down(kk * 16 + t, 8 * n + g),
                 tdo.pair_down(kk * 16 + t + 8, 8 * n + g));
          mma<T>(dk[n], ads, tq.pair_down(kk * 16 + t, 8 * n + g),
                 tq.pair_down(kk * 16 + t + 8, 8 * n + g));
        }
      }
    }
  }

  const int64_t base = (static_cast<int64_t>(b) * p.hkv + hk) * p.sk * D;
  T* out_k = static_cast<T*>(p.dk) + base;
  T* out_v = static_cast<T*>(p.dv) + base;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + warp * 16 + g + 8 * i;
    if (key >= p.sk) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int64_t at = static_cast<int64_t>(key) * D + 8 * n + t;
      *reinterpret_cast<uint32_t*>(out_k + at) = pack2(
          static_cast<T*>(nullptr), dk[n][2 * i] * p.scale, dk[n][2 * i + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(out_v + at) =
          pack2(static_cast<T*>(nullptr), dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kSimtThreads = 256;
constexpr int kSimtTile = 32;  // rows and keys per tile

template <int D>
constexpr size_t simt_smem() {
  // four (32, D + 1) operand tiles, two (32, 33) P / dS tiles, 3 x 32 stats
  return sizeof(float) *
         (4 * kSimtTile * (D + 1) + 2 * kSimtTile * (kSimtTile + 1) + 3 * kSimtTile);
}

// Rows [row0, row0 + 32) of a (s, d) operand into a (32, D + 1) f32 tile.
template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, int64_t ss,
                                              int row0, int n) {
  for (int e = threadIdx.x; e < kSimtTile * D; e += kSimtThreads) {
    const int r = e / D;
    const int d = e % D;
    const int row = row0 + r;
    dst[r * (D + 1) + d] = row < n ? src[row * ss + d] : 0.f;
  }
}

// Kernel 1, CUDA cores: Delta and dq of one 32-row q tile.
template <int D>
__global__ void __launch_bounds__(kSimtThreads) flash_bwd_dq_simt(const Params p) {
  constexpr int kT = kSimtTile;
  constexpr int kLd = D + 1;
  constexpr int kPer = kT * D / kSimtThreads;  // dq elements per thread
  extern __shared__ float smem_f[];
  float* qs = smem_f;
  float* dos = qs + kT * kLd;
  float* ks = dos + kT * kLd;
  float* vs = ks + kT * kLd;
  float* dss = vs + kT * kLd;           // (32, 33) dS
  float* ms = dss + 2 * kT * (kT + 1);  // m
  float* ls = ms + kT;                  // l
  float* dls = ls + kT;                 // Delta

  const int tid = threadIdx.x;
  const int nq = (p.sq + kT - 1) / kT;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.group;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* o = static_cast<const float*>(p.o) + b * p.o_sb + h * p.o_sh;
  const float* dout = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const int64_t stat0 = (static_cast<int64_t>(b) * p.hq + h) * p.sq;

  load_rows_f32<D>(qs, q, p.q_ss, q0, p.sq);
  load_rows_f32<D>(dos, dout, p.do_ss, q0, p.sq);
  __syncthreads();
  // Delta: one warp per 4 rows, a row's D products summed over its 8 lanes
  {
    const int r = tid / 8;
    const int row = q0 + r;
    float acc = 0.f;
    if (row < p.sq) {
      for (int d = tid % 8; d < D; d += 8) {
        acc = fmaf(dos[r * kLd + d], o[row * p.o_ss + d], acc);
      }
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (tid % 8 == 0) {
      dls[r] = acc;
      ms[r] = row < p.sq ? p.m[stat0 + row] : 0.f;
      ls[r] = row < p.sq ? p.l[stat0 + row] : 1.f;
      if (row < p.sq) {
        p.delta[stat0 + row] = acc;
      }
    }
  }

  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;

  const int n_tiles = key_tiles(p, min(q0 + kT, p.sq) - 1, kT);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kT;
    __syncthreads();  // the last tile's k, v and dS are read
    load_rows_f32<D>(ks, k, p.k_ss, k0, p.sk);
    load_rows_f32<D>(vs, v, p.v_ss, k0, p.sk);
    __syncthreads();
    for (int e = tid; e < kT * kT; e += kSimtThreads) {
      const int r = e / kT;
      const int c = e % kT;
      const Pair pr = pair_at(p, q0 + r, k0 + c);
      float ds = 0.f;
      if (pr.valid && !pr.masked) {
        float s = 0.f;
        float dp = 0.f;
        for (int d = 0; d < D; ++d) {
          s = fmaf(qs[r * kLd + d], ks[c * kLd + d], s);
          dp = fmaf(dos[r * kLd + d], vs[c * kLd + d], dp);
        }
        const float pv = expf(s * p.scale - ms[r]) / ls[r];
        ds = pv * (dp - dls[r]);
      }
      dss[r * (kT + 1) + c] = ds;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kSimtThreads;
      const int r = e / D;
      const int d = e % D;
      float x = acc[i];
      for (int c = 0; c < kT; ++c) x = fmaf(dss[r * (kT + 1) + c], ks[c * kLd + d], x);
      acc[i] = x;
    }
  }

  float* out = static_cast<float*>(p.dq) + (static_cast<int64_t>(b) * p.hq + h) * p.sq * D;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = tid + i * kSimtThreads;
    const int row = q0 + e / D;
    if (row < p.sq) {
      out[static_cast<int64_t>(row) * D + e % D] = acc[i] * p.scale;
    }
  }
}

// Kernel 2, CUDA cores: dk and dv of one 32-key tile.
template <int D>
__global__ void __launch_bounds__(kSimtThreads) flash_bwd_dkdv_simt(const Params p) {
  constexpr int kT = kSimtTile;
  constexpr int kLd = D + 1;
  constexpr int kPer = kT * D / kSimtThreads;
  extern __shared__ float smem_f[];
  float* ks = smem_f;
  float* vs = ks + kT * kLd;
  float* qs = vs + kT * kLd;
  float* dos = qs + kT * kLd;
  float* pts = dos + kT * kLd;        // (32 keys, 33) P^T
  float* dsts = pts + kT * (kT + 1);  // (32 keys, 33) dS^T
  float* ms = dsts + kT * (kT + 1);
  float* ls = ms + kT;
  float* dls = ls + kT;

  const int tid = threadIdx.x;
  const int k0 = static_cast<int>(blockIdx.x) * kT;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  load_rows_f32<D>(ks, static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh, p.k_ss, k0,
                   p.sk);
  load_rows_f32<D>(vs, static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh, p.v_ss, k0,
                   p.sk);

  float dk[kPer];
  float dv[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }

  const int nq = (p.sq + kT - 1) / kT;
  for (int h = hk * p.group; h < (hk + 1) * p.group; ++h) {
    const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const float* dout = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
    const int64_t stat0 = (static_cast<int64_t>(b) * p.hq + h) * p.sq;
    for (int iq = 0; iq < nq; ++iq) {
      const int q0 = iq * kT;
      if (!q_tile_weighs(p, q0, kT, k0)) continue;
      __syncthreads();  // the last tile's q, dO, P^T and dS^T are read
      load_rows_f32<D>(qs, q, p.q_ss, q0, p.sq);
      load_rows_f32<D>(dos, dout, p.do_ss, q0, p.sq);
      for (int r = tid; r < kT; r += kSimtThreads) {
        const int row = q0 + r;
        const bool in = row < p.sq;
        ms[r] = in ? p.m[stat0 + row] : 0.f;
        ls[r] = in ? p.l[stat0 + row] : 1.f;
        dls[r] = in ? p.delta[stat0 + row] : 0.f;
      }
      __syncthreads();
      for (int e = tid; e < kT * kT; e += kSimtThreads) {
        const int c = e / kT;  // key
        const int r = e % kT;  // row
        const Pair pr = pair_at(p, q0 + r, k0 + c);
        float pv = 0.f;
        float ds = 0.f;
        if (pr.valid) {
          if (pr.masked) {
            pv = expf(kMasked - ms[r]) / ls[r];  // 1 / l for a row with no key, else 0
          } else {
            float s = 0.f;
            float dp = 0.f;
            for (int d = 0; d < D; ++d) {
              s = fmaf(qs[r * kLd + d], ks[c * kLd + d], s);
              dp = fmaf(dos[r * kLd + d], vs[c * kLd + d], dp);
            }
            pv = expf(s * p.scale - ms[r]) / ls[r];
            ds = pv * (dp - dls[r]);
          }
        }
        pts[c * (kT + 1) + r] = pv;
        dsts[c * (kT + 1) + r] = ds;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int e = tid + i * kSimtThreads;
        const int c = e / D;
        const int d = e % D;
        float xk = dk[i];
        float xv = dv[i];
        for (int r = 0; r < kT; ++r) {
          xv = fmaf(pts[c * (kT + 1) + r], dos[r * kLd + d], xv);
          xk = fmaf(dsts[c * (kT + 1) + r], qs[r * kLd + d], xk);
        }
        dk[i] = xk;
        dv[i] = xv;
      }
    }
  }

  const int64_t base = (static_cast<int64_t>(b) * p.hkv + hk) * p.sk * D;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = tid + i * kSimtThreads;
    const int key = k0 + e / D;
    if (key < p.sk) {
      static_cast<float*>(p.dk)[base + static_cast<int64_t>(key) * D + e % D] = dk[i] * p.scale;
      static_cast<float*>(p.dv)[base + static_cast<int64_t>(key) * D + e % D] = dv[i];
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t launch(K kernel, dim3 grid, int threads, size_t smem, const Params& p,
                   cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) {
    return err;
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_mma(const Params& p, int b, cudaStream_t stream) {
  const dim3 grid_dq(static_cast<unsigned>((p.sq + 63) / 64), static_cast<unsigned>(p.hq),
                     static_cast<unsigned>(b));
  cudaError_t err = launch(flash_bwd_dq_mma<T, D>, grid_dq, kMmaThreads,
                           dq_mma_smem<D>(sizeof(T)), p, stream);
  if (err != cudaSuccess) {
    return err;
  }
  const dim3 grid_kv(static_cast<unsigned>((p.sk + 63) / 64), static_cast<unsigned>(p.hkv),
                     static_cast<unsigned>(b));
  return launch(flash_bwd_dkdv_mma<T, D>, grid_kv, kMmaThreads, dkdv_mma_smem<D>(sizeof(T)), p,
                stream);
}

template <int D>
cudaError_t launch_simt(const Params& p, int b, cudaStream_t stream) {
  const dim3 grid_dq(static_cast<unsigned>((p.sq + kSimtTile - 1) / kSimtTile),
                     static_cast<unsigned>(p.hq), static_cast<unsigned>(b));
  cudaError_t err =
      launch(flash_bwd_dq_simt<D>, grid_dq, kSimtThreads, simt_smem<D>(), p, stream);
  if (err != cudaSuccess) {
    return err;
  }
  const dim3 grid_kv(static_cast<unsigned>((p.sk + kSimtTile - 1) / kSimtTile),
                     static_cast<unsigned>(p.hkv), static_cast<unsigned>(b));
  return launch(flash_bwd_dkdv_simt<D>, grid_kv, kSimtThreads, simt_smem<D>(), p, stream);
}

template <typename T>
cudaError_t launch_mma_dim(const Params& p, int b, int d, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch_mma<T, 32>(p, b, stream);
    case 64:
      return launch_mma<T, 64>(p, b, stream);
    case 128:
      return launch_mma<T, 128>(p, b, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t launch_simt_dim(const Params& p, int b, int d, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch_simt<32>(p, b, stream);
    case 64:
      return launch_simt<64>(p, b, stream);
    case 128:
      return launch_simt<128>(p, b, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o, dout: device pointers of `dtype` (0 float32, 1 bfloat16, 2
// float16); q, o, dout (b, hq, sq, d), k, v (b, hkv, sk, d), read through
// `strides`: 15 element strides, (b, h, s) of q, k, v, o, dout in that order,
// every d stride 1 (16-bit types: rows 16-byte aligned). m, l: the forward's
// (b, hq, sq) f32 row statistics. delta: (b, hq, sq) f32 scratch. dq (b, hq,
// sq, d), dk, dv (b, hkv, sk, d): contiguous outputs of `dtype`. The caller
// makes the tensors' device current. Two kernels go on `stream` in order (dq
// and Delta, then dk and dv); nothing is synchronised or allocated here.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const float* m,
                                          const float* l, float* delta, void* dq, void* dk,
                                          void* dv, const int64_t* strides, int b, int hq,
                                          int hkv, int sq, int sk, int d, int dtype,
                                          float scale, int causal, cudaStream_t stream) {
  if (q == nullptr || k == nullptr || v == nullptr || o == nullptr || dout == nullptr ||
      m == nullptr || l == nullptr || delta == nullptr || dq == nullptr || dk == nullptr ||
      dv == nullptr || strides == nullptr || b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 ||
      sq <= 0 || sk <= 0 || b > 65535 || hq > 65535) {
    return cudaErrorInvalidValue;
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.m = m;
  p.l = l;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  int64_t* fields[15] = {&p.q_sb, &p.q_sh, &p.q_ss, &p.k_sb, &p.k_sh, &p.k_ss, &p.v_sb, &p.v_sh,
                         &p.v_ss, &p.o_sb, &p.o_sh, &p.o_ss, &p.do_sb, &p.do_sh, &p.do_ss};
  for (int i = 0; i < 15; ++i) *fields[i] = strides[i];
  p.hq = hq;
  p.hkv = hkv;
  p.sq = sq;
  p.sk = sk;
  p.group = hq / hkv;
  p.scale = scale;
  p.causal = causal;
  switch (dtype) {
    case 0:
      return launch_simt_dim(p, b, d, stream);
    case 1:
      return launch_mma_dim<__nv_bfloat16>(p, b, d, stream);
    case 2:
      return launch_mma_dim<__half>(p, b, d, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
