// Forward causal GQA flash attention for Hopper (sm_90a), f32 FMA.
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
//     s    = -1e30 where causal and col > row + Sk - Sq (right-aligned mask)
//     out  = online softmax over key tiles: m, l and the accumulator in f32,
//            l == 0 -> 1, out = acc / l, rounded to q's dtype (RNE)
//
// Masked logits are -1e30, never -inf, as in the TPU kernel. So a row with no
// valid key (Sq > Sk, row < Sq - Sk) sees exp(s - m) = exp(0) = 1 for every
// key and comes out as the mean of v over all Sk keys, not 0 and not NaN.
//
// What bounds it: operations. At the serve path's prefill shapes (q
// (2, 14, 8192, 64), k/v (2, 2, 8192, 64), bf16) the causal work is
// 4 B Hq D S (S + 1) / 2 ~ 2.4e11 flop per launch against ~67 MB of
// inputs and output: far above the card's bytes-per-flop line. The card's
// floor is the tensor cores' bf16 rate; this first version uses f32 FMA on
// the CUDA cores (no wgmma, no TMA), so it sits well above that floor.
//
// Design:
//   - one CTA of 256 threads per (q tile of 64 rows, q head, batch); q tiles
//     go in reverse order on grid x, so the long causal rows start first;
//   - the q tile is staged once in shared memory, transposed ([D][64]); the
//     loop walks 64-key tiles of k (transposed) and v (row-major) staged in
//     shared memory, widened to f32 on load;
//   - thread (ty, tx) of a 16 x 16 grid owns rows ty*4..ty*4+3 of the tile:
//     4 x 4 scores (keys tx*4..tx*4+3) and 4 rows x D/16 columns of the
//     accumulator. Row max and row sum are reduced across the 16 threads of
//     a row with __shfl_xor_sync; the butterfly gives every lane the same
//     bits, so m and l agree across the row's threads;
//   - p goes through shared memory ([64][68], float4 rows) for p @ v;
//   - causal: a tile whose first row has a key stops at the last key its
//     last row may see. Key tiles past that are masked for every row of the
//     tile, and for a row that already has a key a masked tile is an exact
//     no-op (alpha = 1, p = 0). A tile that holds a row with no key walks
//     all key tiles, because that row's output is the mean of all of v;
//   - keys past Sk (a ragged last tile) get -inf, so exp gives exactly 0 for
//     every row; rows past Sq are computed on zeros and never stored;
//   - q, k, v and out are read through (b, h, s) strides with unit stride
//     in D, so v reaches the kernel as the model's transposed view, no copy;
//   - no atomics: each output element is written once by one thread, and
//     the result is the same bits from run to run.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

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
template <>
__device__ __forceinline__ float to_f32<__half>(__half x) { return __half2float(x); }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * D * kLd + kBlockK * D + kBlockQ * kLd);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd(const Params p) {
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
  if (p.causal && q0 + offset >= 0) {
    const int last_row = min(q0 + kBlockQ, p.sq) - 1;
    n_tiles = min(n_tiles, (last_row + offset) / kBlockK + 1);
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
        } else if (p.causal && col > row + offset) {
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
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    return err;
  }
  const dim3 grid(static_cast<unsigned>((p.sq + kBlockQ - 1) / kBlockQ),
                  static_cast<unsigned>(hq), static_cast<unsigned>(b));
  flash_fwd<T, D><<<grid, kThreads, smem, stream>>>(p);
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
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: device pointers of `dtype` (0 float32, 1 bfloat16, 2 float16),
// shapes q/o (b, hq, sq, d) and k/v (b, hkv, sk, d). strides: 12 element
// strides, (b, h, s) for q, k, v, o in that order; every d stride is 1.
// The caller makes the tensors' device current. The one kernel goes on
// `stream`; nothing is synchronised or allocated here.
extern "C" cudaError_t flash_attention_launch(const void* q, const void* k, const void* v,
                                              void* o, const int64_t* strides, int b, int hq,
                                              int hkv, int sq, int sk, int d, int dtype,
                                              float scale, int causal, cudaStream_t stream) {
  if (q == nullptr || k == nullptr || v == nullptr || o == nullptr || strides == nullptr ||
      b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0 || sk <= 0 || b > 65535 ||
      hq > 65535) {
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
  switch (dtype) {
    case 0:
      return launch_dim<float>(p, b, hq, d, stream);
    case 1:
      return launch_dim<__nv_bfloat16>(p, b, hq, d, stream);
    case 2:
      return launch_dim<__half>(p, b, hq, d, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
