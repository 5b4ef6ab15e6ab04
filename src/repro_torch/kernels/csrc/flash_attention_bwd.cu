// Backward of causal GQA flash attention for Hopper (sm_90a): dq, dk and dv
// of flash_attention.cu's forward. bf16 and f16 on the tensor cores
// (wgmma), f32 on the CUDA cores.
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
// head h is h / (Hq / Hkv); head dims 32, 64, 128 and 256, the forward's:
//
//     Delta = rowsum(dO * O)                                (f32)
//     s     = (q . k) * scale; masked where causal and col > row + Sk - Sq
//             and col >= prefix_len (prefix_len > 0 opens the first keys to
//             every row: the prefix-LM mask of _chunked_attention)
//     P     = exp(s - m) / l, a masked logit counting as -1e30
//     dP    = dO . v
//     dS    = P * (dP - Delta), 0 at masked positions
//     dq    = scale * dS . k;  dk = scale * dS^T . q (summed over the group's
//             q heads);  dv = P^T . dO (summed likewise)
//
// A masked logit is -1e30, so exp(-1e30 - m) is 0 for a row that has a key
// and 1 for a row with no valid key (Sq > Sk, row < Sq - Sk, no prefix: m =
// -1e30). m and l are kept apart for that reason: in f32 -1e30 + log(Sk)
// rounds back to -1e30, so P = exp(s - lse) would be 1 at every key of such
// a row, not 1 / Sk. Such a row spreads dO over every key of dv, and its dS
// is 0 everywhere (the plain version's torch.where passes no gradient to a
// masked logit), so its dq is 0. With prefix_len >= 1 every row sees key 0,
// so no row lacks a key and those branches are never taken.
//
// What bounds it: operations. Five products of the forward's size (q k^T, dO
// v^T, dS k, dS^T q, P^T dO) at the training shape (q (2, 14, 8192, 64), k, v
// (2, 2, 8192, 64), bf16, causal): 6.0e11 flop, 0.61 ms at the tensor cores'
// 989 TFLOP/s dense bf16 rate; its 136 MB of inputs and outputs take 0.041
// ms at 3.35 TB/s. At paligemma's training shape (q (2, 8, 8192, 256), k, v
// (2, 1, 8192, 256), prefix 256): 1.38e12 flop, 1.39 ms.
//
// Design: no float is ever added atomically, and every sum runs in a fixed
// order, so the result is the same bits from run to run (training restarts
// bit for bit).
//
// bf16 / f16: three launches on one stream, in order.
//   1. flash_bwd_dq_tc: one CTA (one warpgroup, 128 threads) per (q head,
//      batch, 64-row q tile), the tiles longest first (grid z, the slowest
//      dimension, so every head's long causal rows start before any short
//      ones). It computes Delta, m in the log2 domain and 1 / l for its
//      rows into a (3, B, Hq, Sq rounded up to 4) f32 scratch that kernel 2
//      reads, then walks the key tiles that its rows may see (64 keys; 32
//      at D = 256), recomputes s, P and dP, and accumulates dq over them in
//      order.
//   2. flash_bwd_dkdv_tc: one CTA (one warpgroup) per (q head, batch,
//      64-key tile, column half at D = 256), the key tiles that the most
//      rows weigh first. It walks the q tiles that weigh its keys (causally
//      admitted rows, every row for a key tile that starts inside the
//      prefix, and the rows with no key, which weigh every key) in order,
//      recomputes s^T, P^T and dP^T, and accumulates this head's dk and dv;
//      it writes them unscaled as f32 partials to a (B, Hq, Sk, D) scratch
//      each. One CTA per q head, not per kv head, so no CTA walks the whole
//      group: at the training shape the heaviest walks 128 q tiles where
//      one CTA per kv head walked 896.
//   3. flash_bwd_reduce_dkdv: for each kv head, sums the group's partials
//      in head order (hk * group, ..., hk * group + group - 1), scales dk,
//      and rounds each once to the input type (reads 2 x 58.7 MB, writes
//      2 x 4.2 MB at the training shape).
//   Products: wgmma, f32 accumulators, as in the forward. q k^T and dO v^T
//   (kernel 2: k q^T and v dO^T) read both operands from shared memory;
//   dS k (kernel 2: P^T dO and dS^T q) takes P or dS from registers (the
//   accumulator fragment of one product is the A fragment of the next,
//   rounded once to the input type) and k, dO or q from shared memory in
//   the descriptor's transpose mode, so no operand is copied transposed.
//   Kernel 2's q tiles hold 64 rows (32 at D >= 128, for registers).
//   Head dim 256: dq (64 x 256 f32) alone is 128 registers a thread, so
//   kernel 1's key tiles hold 32 keys (s and dP 16 registers each) and dS k
//   is two m64n128k16 a k16 step, one per half of dq, the second B
//   descriptor two 64-column panels on (the forward's P V at D = 256).
//   dk and dv of 64 keys x 256 would be 256 registers a thread: kernel 2
//   splits D's columns between two CTAs of one warpgroup each, and each
//   computes s^T and dP^T over the whole D itself (two of kernel 2's four
//   products done twice; no exchange through shared memory, no second
//   warpgroup to synchronise), then its half's dk and dv (64 + 64
//   registers, D = 128's register picture). Chosen for being the least
//   change to a kernel that is right: the other splits (two warpgroups
//   sharing s and dP through shared memory, dk and dv in different
//   warpgroups) save tensor-core work and are later work.
//   Loads: cp.async, 16 bytes a thread, into the 128-byte swizzle wgmma
//   reads (64-byte at D = 32), in a ring of three stages: while a tile is
//   computed the next two are in flight (kernel 1: k and v of the next key
//   tiles; kernel 2: q, dO and the rows' statistics of the next admitted q
//   tiles), and one __syncthreads a tile both publishes a tile and frees
//   the stage refilled next. Rows past Sq or Sk arrive as zeros. At D = 256
//   the halved tiles keep three stages within 166 KB of shared memory.
//   Latency: a warpgroup runs its tile's products, waits, then its softmax
//   gradient, so three CTAs share an SM (registers capped at 170 a thread;
//   D = 128: one CTA of kernel 1, two of kernel 2; D = 256: one of each, by
//   shared memory) and one's products run beside another's softmax. Inside
//   the causal triangle (every row in the tensor and seeing every key,
//   causally or as a prefix key) the softmax gradient is a loop of its own
//   without a test or a branch; on the diagonal, at the prefix's edge and
//   at ragged edges each pair is tested. exp is ex2 of the logit in the
//   log2 domain, as in the forward.
//   Kernel 1 recomputes s and dP that kernel 2 computes too, so the design
//   does 7 products where 5 would do (9 at D = 256): its own floor is 0.85
//   ms at the training shape and 2.5 ms at paligemma's.
//
// f32 (flash_bwd_*_simt): two kernels on the CUDA cores (mma has no f32
// inputs; TF32 would not meet the f32 limit), 256 threads, 32-row and 32-key
// tiles in shared memory, P and dS through shared memory, expf. dq and Delta
// per q tile, then dk and dv per (key tile, kv head), the group's heads
// summed in a loop. D = 256 takes 137 KB of shared memory.
//
// Strides: q, k, v, o and dO are read through their (b, h, s) element
// strides with unit stride in D (the model's transposed v view needs no
// copy); dq, dk and dv are written contiguous, in their inputs' types.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

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
  // scratch written by kernel 1: f32 route (b, hq, sq) Delta; 16-bit route
  // (3, b, hq, sq_pad) m in the log2 domain (-1e30 kept), 1 / l, Delta
  float* delta;
  void* dq;        // (b, hq, sq, d) contiguous
  void* dk;        // (b, hkv, sk, d) contiguous
  void* dv;
  float* dk_part;  // 16-bit route: (b, hq, sk, d) f32 per-q-head partials
  float* dv_part;
  int64_t q_sb, q_sh, q_ss;  // element strides of (b, h, s); d stride is 1
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int64_t do_sb, do_sh, do_ss;
  int batch, hq, hkv, sq, sk, d, group, sq_pad;
  float scale;
  int causal;
  int prefix_len;  // keys every row may see (the prefix-LM mask); 0: none
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
// gradient), masked (causally, and not a prefix key), or a plain logit.
struct Pair {
  bool valid;
  bool masked;
};

__device__ __forceinline__ Pair pair_at(const Params& p, int row, int key) {
  const bool valid = row < p.sq && key < p.sk;
  return {valid, valid && p.causal && key > row + p.sk - p.sq && key >= p.prefix_len};
}

// Causal: the number of key tiles of `bk` keys that rows [q0, last_row]
// may see, up to the tile holding max(last_row + Sk - Sq, prefix_len - 1)
// (kernel 1: a row with no key needs none).
__device__ __forceinline__ int key_tiles(const Params& p, int last_row, int bk) {
  const int all = (p.sk + bk - 1) / bk;
  if (!p.causal) {
    return all;
  }
  const int last_key = max(last_row + p.sk - p.sq, p.prefix_len - 1);
  return last_key < 0 ? 0 : min(all, last_key / bk + 1);
}

// Causal: whether q tile [q0, q0 + bq) holds a row that weighs a key of
// [k0, ...): a row that sees k0, every row where k0 is a prefix key, or a
// row with no key (it weighs every key; none with a prefix).
__device__ __forceinline__ bool q_tile_weighs(const Params& p, int q0, int bq, int k0) {
  if (!p.causal) {
    return true;
  }
  const int offset = p.sk - p.sq;
  const int last_row = min(q0 + bq, p.sq) - 1;
  return last_row + offset >= k0 || k0 < p.prefix_len ||
         (p.prefix_len == 0 && q0 + offset < 0);
}

// The first q tile of `bq` rows from tile `iq` on that weighs a key of
// [k0, ...), or `nq` if none does.
__device__ __forceinline__ int next_q_tile(const Params& p, int iq, int nq, int bq, int k0) {
  while (iq < nq && !q_tile_weighs(p, iq * bq, bq, k0)) {
    ++iq;
  }
  return iq;
}

// ---------------------------------------------------------------------------
// bf16 / f16: tensor cores (wgmma, f32 accumulate)
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // one warpgroup
constexpr int kTile = 64;         // rows of a kernel-1 CTA, keys of a kernel-2 CTA
constexpr int kStages = 3;        // cp.async ring: the tile in use and the next two in flight
template <int D>
constexpr int kDqBk = D == 256 ? 32 : 64;  // keys per tile of kernel 1 (registers)
template <int D>
constexpr int kDkdvBq = D >= 128 ? 32 : 64;  // q rows per tile of kernel 2 (registers)
template <int D>
constexpr int kDkdvN = D == 256 ? 128 : D;  // dk and dv columns per kernel-2 CTA
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes from global to shared memory, asynchronously; with src_bytes 0
// nothing is read and the 16 bytes are zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight,
// then hand what arrived to the async proxy that wgmma reads through (the
// caller's __syncthreads then makes every thread's copies visible).
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// The shared-memory layout wgmma reads: a tile of `rows` rows of D 16-bit
// values as panels of 64 columns (D = 32: one of 32), each panel's rows of
// 128 (64) bytes with the 128-byte (64-byte) swizzle: 16-byte chunk c of
// row r lies at chunk c ^ (r % 8) (c ^ (r / 2 % 4)). Tiles start on
// 1024-byte boundaries.
template <int D>
struct Swz {
  static constexpr int kPanel = D < 64 ? D : 64;
  static constexpr int kRowBytes = kPanel * 2;
  static constexpr int kChunks = kRowBytes / 16;
  static constexpr int kSwizzle = kRowBytes == 128 ? 1 : 2;  // the descriptor's mode
  static constexpr uint32_t kSbo = 8 * kRowBytes;            // 8-row core matrices
  // byte offset of 16-byte chunk c (of D / 8) of row r
  static __device__ __forceinline__ uint32_t at(int r, int c, int rows) {
    const int sw = kRowBytes == 128 ? (r & 7) : ((r >> 1) & 3);
    return static_cast<uint32_t>((c / kChunks) * rows * kRowBytes + r * kRowBytes +
                                 (((c % kChunks) ^ sw) << 4));
  }
};

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle mode.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(swizzle) << 62);
}

// An operand whose contraction dim runs along the tile's rows (K-major):
// rows r0.. of a tile of `rows` rows, at k16 step kk.
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int r0, int kk) {
  using S = Swz<D>;
  const uint32_t panel = kk * 16 / S::kPanel;
  const uint32_t col = (kk * 16 % S::kPanel) * 2;
  return smem_desc(tile + panel * rows * S::kRowBytes + r0 * S::kRowBytes + col, 16, S::kSbo,
                   S::kSwizzle);
}

// A B operand whose contraction dim runs down the tile's rows (the
// transpose mode): rows 16 kk..16 kk + 15 of a tile of `rows` rows.
template <int D>
__device__ __forceinline__ uint64_t desc_t(uint32_t tile, int rows, int kk) {
  using S = Swz<D>;
  return smem_desc(tile + kk * 16 * S::kRowBytes, rows * S::kRowBytes, S::kSbo, S::kSwizzle);
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

// C (64 x N per warpgroup) = (scale_d ? C : 0) + A (64 x 16) . B (N x 16)^T,
// both K-major in shared memory.
template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d);
// C (64 x N per warpgroup) += A (64 x 16, registers) . B (16 x N, shared,
// N contiguous: the transpose mode).
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss<__nv_bfloat16, 32>(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<__nv_bfloat16, 64>(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
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
__device__ __forceinline__ void wgmma_rs<__nv_bfloat16, 32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
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
__device__ __forceinline__ void wgmma_rs<__nv_bfloat16, 64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
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
__device__ __forceinline__ void wgmma_rs<__nv_bfloat16, 128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
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
__device__ __forceinline__ void wgmma_ss<__half, 32>(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<__half, 64>(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
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
__device__ __forceinline__ void wgmma_rs<__half, 32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
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
__device__ __forceinline__ void wgmma_rs<__half, 64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
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
__device__ __forceinline__ void wgmma_rs<__half, 128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
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

// The A fragments (one per k16 step) of a warpgroup's f32 accumulator of N
// columns: element 4 j + 2 i + c of the accumulator is row r + 8 i, column
// 8 j + 2 (lane % 4) + c, and k16 step kk takes elements 8 kk..8 kk + 7 in
// pairs, rounded once to T.
template <typename T, int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4], const float (&acc)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a[kk][r] = pack2(static_cast<T*>(nullptr), acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1]);
    }
  }
}

// C (64 x N) += A (64 x 16, registers) . B, B the N columns from column c0
// of rows 16 kk..16 kk + 15 of a tile of `rows` rows (the transpose mode).
// N = 256 is two m64n128k16, one per half of the accumulator: registers
// 0-63 hold columns 0-127 and 64-127 columns 128-255 (an n = 256
// fragment's j-th group of 8 columns is registers 4j..4j+3), the second
// half of B two 64-column panels on.
template <typename T, int D, int N>
__device__ __forceinline__ void wgmma_rs_t(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint32_t tile, int rows, int c0, int kk) {
  using S = Swz<D>;
  const uint32_t at = tile + (c0 / S::kPanel) * rows * S::kRowBytes;
  if constexpr (N == 256) {
    wgmma_rs<T, 128>(*reinterpret_cast<float(*)[64]>(&d[0]), a, desc_t<D>(at, rows, kk));
    wgmma_rs<T, 128>(*reinterpret_cast<float(*)[64]>(&d[64]), a,
                     desc_t<D>(at + 2 * rows * S::kRowBytes, rows, kk));
  } else {
    wgmma_rs<T, N>(d, a, desc_t<D>(at, rows, kk));
  }
}

// Rows [row0, row0 + kRows) of a (s, d) operand with row stride `ss` into a
// swizzled shared tile at `dst`, asynchronously; rows at or past `n` as
// zeros (the wrapper checks that 16-byte copies can read the rows).
template <typename T, int D, int kRows>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const T* src, int64_t ss, int row0,
                                                int n) {
  constexpr int kVecs = D / 8;
  constexpr int kPer = (kRows * kVecs + kMmaThreads - 1) / kMmaThreads;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = static_cast<int>(threadIdx.x) + i * kMmaThreads;
    if (e < kRows * kVecs) {
      const int r = e / kVecs;
      const int c = e % kVecs;
      const bool in = row0 + r < n;
      cp_async16(dst + Swz<D>::at(r, c, kRows), src + (in ? row0 + r : 0) * ss + c * 8,
                 in ? 16 : 0);
    }
  }
}

// One q tile's row statistics (m log2, 1 / l, Delta; kBq each) from the
// (3, b, hq, sq_pad) scratch, asynchronously; rows past sq_pad as zeros.
template <int kBq>
__device__ __forceinline__ void load_stats_async(uint32_t dst, const float* rows, int64_t plane,
                                                 int q0, int sq_pad) {
  constexpr int kVecs = kBq / 4;
  const int e = static_cast<int>(threadIdx.x);
  if (e < 3 * kVecs) {
    const int i = (e % kVecs) * 4;
    const bool in = q0 + i < sq_pad;
    cp_async16(dst + ((e / kVecs) * kBq + i) * 4, rows + (e / kVecs) * plane + (in ? q0 + i : 0),
               in ? 16 : 0);
  }
}

template <int D>
constexpr size_t dq_tc_smem() {
  // q and dO (kTile rows), k and v (kDqBk rows, kStages each), 3 x kTile
  // statistics, and the room to align the tiles to 1024 bytes
  return 1024 + static_cast<size_t>(2 * kTile + 2 * kStages * kDqBk<D>) * D * 2 +
         3 * sizeof(float) * kTile;
}

// Kernel 1, tensor cores: Delta, the rows' statistics and dq of one 64-row
// q tile. Three CTAs share an SM at D = 32 and 64, one at D = 128 and 256.
template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads, D >= 128 ? 1 : 3) flash_bwd_dq_tc(const Params p) {
  using S = Swz<D>;
  constexpr int kBq = kTile;
  constexpr int kBk = kDqBk<D>;
  constexpr uint32_t kQBytes = kBq * D * 2;
  constexpr uint32_t kKBytes = kBk * D * 2;
  extern __shared__ uint8_t smem_dq[];
  const uint32_t raw = smem_u32(smem_dq);
  const uint32_t q_s = (raw + 1023u) & ~1023u;
  const uint32_t do_s = q_s + kQBytes;
  const uint32_t k_s = do_s + kQBytes;             // kStages tiles
  const uint32_t v_s = k_s + kStages * kKBytes;    // kStages tiles
  float* m2s = reinterpret_cast<float*>(smem_dq + (v_s + kStages * kKBytes - raw));
  float* ils = m2s + kBq;
  float* dls = ils + kBq;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int col0 = 2 * (lane % 4);
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int nq = (p.sq + kBq - 1) / kBq;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.z)) * kBq;  // longest first
  const int hk = h / p.group;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* o = static_cast<const T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const int64_t stat0 = (static_cast<int64_t>(b) * p.hq + h) * p.sq;

  load_tile_async<T, D, kBq>(q_s, q, p.q_ss, q0, p.sq);
  load_tile_async<T, D, kBq>(do_s, dout, p.do_ss, q0, p.sq);
  cp_async_commit();
  const int n_tiles = key_tiles(p, min(q0 + kBq, p.sq) - 1, kBk);
#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) {  // the first tiles, one group each
    if (it < n_tiles) {
      load_tile_async<T, D, kBk>(k_s + it * kKBytes, k, p.k_ss, it * kBk, p.sk);
      load_tile_async<T, D, kBk>(v_s + it * kKBytes, v, p.v_ss, it * kBk, p.sk);
    }
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();  // q and dO
  __syncthreads();

  // Delta = rowsum(dO * O), two threads a row, D / 2 columns each, and the
  // row's statistics: to shared memory for this CTA, to the scratch for
  // kernel 2 (rows past Sq up to sq_pad as zeros)
  {
    const int r = tid / 2;
    const int row = q0 + r;
    const int c0 = (tid & 1) * (D / 16);  // in 16-byte chunks
    float acc = 0.f;
    if (row < p.sq) {
      const T* orow = o + row * p.o_ss;
#pragma unroll
      for (int c = c0; c < c0 + D / 16; ++c) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + 8 * c);
        const uint4 dv = *reinterpret_cast<const uint4*>(smem_dq + (do_s - raw) +
                                                         S::at(r, c, kBq));
        const T* oe = reinterpret_cast<const T*>(&ov);
        const T* de = reinterpret_cast<const T*>(&dv);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc = fmaf(to_f32(de[i]), to_f32(oe[i]), acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((tid & 1) == 0) {
      float m2 = 0.f;
      float il = 0.f;
      if (row < p.sq) {
        const float mi = p.m[stat0 + row];
        // a row with no key keeps -1e30 exactly (kernel 2's masked test)
        m2 = mi == kMasked ? kMasked : mi * kLog2e;
        il = 1.f / p.l[stat0 + row];
      }
      m2s[r] = m2;
      ils[r] = il;
      dls[r] = acc;
      if (row < p.sq_pad) {
        const int64_t plane = static_cast<int64_t>(p.batch) * p.hq * p.sq_pad;
        float* out = p.delta + (static_cast<int64_t>(b) * p.hq + h) * p.sq_pad + row;
        out[0] = m2;
        out[plane] = il;
        out[2 * plane] = acc;
      }
    }
  }
  __syncthreads();

  // this thread's rows: r0 and r0 + 8 of the tile
  const int r0 = 16 * warp + lane / 4;
  float m_log2[2];
  float inv_l[2];
  float dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m_log2[i] = m2s[r0 + 8 * i];
    inv_l[i] = ils[r0 + 8 * i];
    dl[i] = dls[r0 + 8 * i];
  }
  const float scale_log2 = p.scale * kLog2e;
  const int offset = p.sk - p.sq;
  const int w0 = q0 + 16 * warp;  // the warp's first row

  float dq[D / 2];
  float s[kBk / 2];
  float dp[kBk / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBk / 2; ++i) {
    s[i] = 0.f;
    dp[i] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();  // this tile's copies, then every thread's, and every
    __syncthreads();               // warp is done with the stage refilled next
    if (it + kStages - 1 < n_tiles) {
      const int at = (it + kStages - 1) % kStages;
      const int k1 = (it + kStages - 1) * kBk;
      load_tile_async<T, D, kBk>(k_s + at * kKBytes, k, p.k_ss, k1, p.sk);
      load_tile_async<T, D, kBk>(v_s + at * kKBytes, v, p.v_ss, k1, p.sk);
    }
    cp_async_commit();
    const int k0 = it * kBk;
    const uint32_t kt = k_s + (it % kStages) * kKBytes;
    const uint32_t vt = v_s + (it % kStages) * kKBytes;

    pin(s);
    pin(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<T, kBk>(s, desc_k<D>(q_s, kBq, 0, kk), desc_k<D>(kt, kBk, 0, kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<T, kBk>(dp, desc_k<D>(do_s, kBq, 0, kk), desc_k<D>(vt, kBk, 0, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin(s);
    pin(dp);

    // s -> dS, in place; element 4 j + 2 i + c: row q0 + r0 + 8 i, key k0 +
    // 8 j + col0 + c. Inside (every row of the warp in the tensor and seeing
    // every key of the tile) no pair needs a test: a loop of its own,
    // without branches.
    auto ds_of = [&](int e, int i) {
      const float pv = ex2(fmaf(s[e], scale_log2, -m_log2[i])) * inv_l[i];
      return pv * (dp[e] - dl[i]);
    };
    if (w0 + 15 < p.sq && k0 + kBk <= p.sk &&
        (!p.causal || k0 + kBk - 1 <= w0 + offset || k0 + kBk <= p.prefix_len)) {
#pragma unroll
      for (int e = 0; e < kBk / 2; ++e) s[e] = ds_of(e, (e / 2) % 2);
    } else {
#pragma unroll
      for (int e = 0; e < kBk / 2; ++e) {
        const int i = (e / 2) % 2;
        const Pair pr = pair_at(p, q0 + r0 + 8 * i, k0 + 8 * (e / 4) + col0 + e % 2);
        s[e] = pr.valid && !pr.masked ? ds_of(e, i) : 0.f;
      }
    }

    // dq += dS . k
    uint32_t a[kBk / 16][4];
    pack_a<T, kBk>(a, s);
    pin(dq);
    pin(a);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
      wgmma_rs_t<T, D, D>(dq, a[kk], kt, kBk, 0, kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin(dq);
    pin(a);
  }
  cp_async_wait<0>();

  T* out = static_cast<T*>(p.dq) + (static_cast<int64_t>(b) * p.hq + h) * p.sq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    if (row >= p.sq) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(out + static_cast<int64_t>(row) * D + 8 * j + col0) =
          pack2(static_cast<T*>(nullptr), dq[4 * j + 2 * i] * p.scale,
                dq[4 * j + 2 * i + 1] * p.scale);
    }
  }
}

template <int D>
constexpr size_t dkdv_tc_smem() {
  // k and v (kTile rows), q and dO (kDkdvBq rows, kStages each), kStages x
  // 3 x kDkdvBq statistics, and the room to align the tiles to 1024 bytes
  // (the whole D: s^T and dP^T contract over it)
  return 1024 + static_cast<size_t>(2 * kTile + 2 * kStages * kDkdvBq<D>) * D * 2 +
         kStages * 3 * sizeof(float) * kDkdvBq<D>;
}

// Kernel 2, tensor cores: one q head's dk and dv partials of one 64-key
// tile (at D = 256, of one half of its columns). Three CTAs share an SM at
// D = 32 and 64, two at D = 128, one at D = 256 (shared memory).
template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads, D >= 128 ? 2 : 3) flash_bwd_dkdv_tc(const Params p) {
  constexpr int kBk = kTile;
  constexpr int kBq = kDkdvBq<D>;
  constexpr int kN = kDkdvN<D>;  // this CTA's columns of dk and dv
  constexpr uint32_t kKBytes = kBk * D * 2;
  constexpr uint32_t kQBytes = kBq * D * 2;
  extern __shared__ uint8_t smem_dkdv[];
  const uint32_t raw = smem_u32(smem_dkdv);
  const uint32_t k_s = (raw + 1023u) & ~1023u;
  const uint32_t v_s = k_s + kKBytes;
  const uint32_t q_s = v_s + kKBytes;            // kStages tiles
  const uint32_t do_s = q_s + kStages * kQBytes;  // kStages tiles
  const uint32_t st_s = do_s + kStages * kQBytes;  // kStages x (m log2, 1 / l, Delta) x kBq
  const float* sts = reinterpret_cast<const float*>(smem_dkdv + (st_s - raw));

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int col0 = 2 * (lane % 4);
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = static_cast<int>(blockIdx.z) / (D / kN) * kBk;  // the most q rows first
  const int c0 = static_cast<int>(blockIdx.z) % (D / kN) * kN;    // first column
  const int hk = h / p.group;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* stats = p.delta + (static_cast<int64_t>(b) * p.hq + h) * p.sq_pad;
  const int64_t plane = static_cast<int64_t>(p.batch) * p.hq * p.sq_pad;

  load_tile_async<T, D, kBk>(k_s, static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh,
                             p.k_ss, k0, p.sk);
  load_tile_async<T, D, kBk>(v_s, static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh,
                             p.v_ss, k0, p.sk);
  // the admitted q tiles in order: cur (in stage `stage`), then nxt
  const int nq = (p.sq + kBq - 1) / kBq;
  int cur = next_q_tile(p, 0, nq, kBq, k0);
  int nxt = cur < nq ? next_q_tile(p, cur + 1, nq, kBq, k0) : nq;
  auto load_q_tile = [&](int iq, int at) {
    load_tile_async<T, D, kBq>(q_s + at * kQBytes, q, p.q_ss, iq * kBq, p.sq);
    load_tile_async<T, D, kBq>(do_s + at * kQBytes, dout, p.do_ss, iq * kBq, p.sq);
    load_stats_async<kBq>(st_s + at * 3 * kBq * 4, stats, plane, iq * kBq, p.sq_pad);
  };
  if (cur < nq) {
    load_q_tile(cur, 0);
  }
  cp_async_commit();  // with k and v
  if (nxt < nq) {
    load_q_tile(nxt, 1);
  }
  cp_async_commit();

  const float scale_log2 = p.scale * kLog2e;
  const int kw = k0 + 16 * warp;      // the warp's first key
  const int key0 = kw + lane / 4;     // this thread's keys: key0, key0 + 8

  float dk[kN / 2];
  float dv[kN / 2];
  float st[kBq / 2];   // s^T, then P^T
  float dpt[kBq / 2];  // dP^T, then dS^T
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kBq / 2; ++i) {
    st[i] = 0.f;
    dpt[i] = 0.f;
  }

  for (int stage = 0; cur < nq; stage = stage == kStages - 1 ? 0 : stage + 1) {
    const int q0 = cur * kBq;
    const int after = nxt < nq ? next_q_tile(p, nxt + 1, nq, kBq, k0) : nq;
    cp_async_wait<kStages - 2>();  // this tile's copies (the first time with k and v), then
    __syncthreads();               // every thread's, and every warp is done with the stage
    if (after < nq) {              // refilled here
      load_q_tile(after, stage == 0 ? kStages - 1 : stage - 1);
    }
    cp_async_commit();
    cur = nxt;
    nxt = after;

    const uint32_t qt = q_s + stage * kQBytes;
    const uint32_t dot = do_s + stage * kQBytes;
    const float* st_m = sts + stage * 3 * kBq;  // m log2, then 1 / l, then Delta
    const float* st_il = st_m + kBq;
    const float* st_dl = st_il + kBq;

    pin(st);
    pin(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<T, kBq>(st, desc_k<D>(k_s, kBk, 0, kk), desc_k<D>(qt, kBq, 0, kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<T, kBq>(dpt, desc_k<D>(v_s, kBk, 0, kk), desc_k<D>(dot, kBq, 0, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin(st);
    pin(dpt);

    // element 4 j + 2 i + c: key key0 + 8 i, row q0 + 8 j + col0 + c.
    // Inside (every row of the tile in the tensor and seeing every key of
    // the warp, causally or as prefix keys) no pair needs a test: a loop of
    // its own, without branches.
    const bool inside = q0 + kBq <= p.sq && kw + 16 <= p.sk &&
                        (!p.causal || kw + 15 <= q0 + p.sk - p.sq || kw + 16 <= p.prefix_len);
#pragma unroll
    for (int j = 0; j < kBq / 8; ++j) {
      const int r = 8 * j + col0;
      const float2 m2 = *reinterpret_cast<const float2*>(st_m + r);
      const float2 il = *reinterpret_cast<const float2*>(st_il + r);
      const float2 dl = *reinterpret_cast<const float2*>(st_dl + r);
      const float mr[2] = {m2.x, m2.y};
      const float ilr[2] = {il.x, il.y};
      const float dlr[2] = {dl.x, dl.y};
      if (inside) {
#pragma unroll
        for (int e = 4 * j; e < 4 * j + 4; ++e) {
          const int c = e % 2;
          st[e] = ex2(fmaf(st[e], scale_log2, -mr[c])) * ilr[c];
          dpt[e] = st[e] * (dpt[e] - dlr[c]);
        }
      } else {
#pragma unroll
        for (int e = 4 * j; e < 4 * j + 4; ++e) {
          const int c = e % 2;
          const Pair pr = pair_at(p, q0 + r + c, key0 + 8 * ((e / 2) % 2));
          const float pv = ex2(fmaf(st[e], scale_log2, -mr[c])) * ilr[c];
          const float ds = pv * (dpt[e] - dlr[c]);
          // a masked pair: exp(-1e30 - m) / l, 1 / l on a row with no key
          // (none with a prefix)
          const bool no_key = p.prefix_len == 0 && mr[c] == kMasked;
          st[e] = !pr.valid ? 0.f : pr.masked ? (no_key ? ilr[c] : 0.f) : pv;
          dpt[e] = pr.valid && !pr.masked ? ds : 0.f;
        }
      }
    }

    // dv += P^T . dO and dk += dS^T . q
    uint32_t ap[kBq / 16][4];
    uint32_t ads[kBq / 16][4];
    pack_a<T, kBq>(ap, st);
    pack_a<T, kBq>(ads, dpt);
    pin(dk);
    pin(dv);
    pin(ap);
    pin(ads);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBq / 16; ++kk) {
      wgmma_rs_t<T, D, kN>(dv, ap[kk], dot, kBq, c0, kk);
      wgmma_rs_t<T, D, kN>(dk, ads[kk], qt, kBq, c0, kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin(dk);
    pin(dv);
    pin(ap);
    pin(ads);
  }
  cp_async_wait<0>();

  // this head's partials, f32, dk unscaled
  const int64_t base = (static_cast<int64_t>(b) * p.hq + h) * p.sk * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= p.sk) continue;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const int64_t at = base + static_cast<int64_t>(key) * D + c0 + 8 * j + col0;
      *reinterpret_cast<float2*>(p.dk_part + at) =
          make_float2(dk[4 * j + 2 * i], dk[4 * j + 2 * i + 1]);
      *reinterpret_cast<float2*>(p.dv_part + at) =
          make_float2(dv[4 * j + 2 * i], dv[4 * j + 2 * i + 1]);
    }
  }
}

// Kernel 3: dk and dv of each kv head, the sums of its group's partials in
// head order, four elements a thread; dk scaled, both rounded once to T.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads) flash_bwd_reduce_dkdv(const Params p) {
  const int64_t per_head = static_cast<int64_t>(p.sk) * p.d;
  const int64_t n4 = static_cast<int64_t>(p.batch) * p.hkv * per_head / 4;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kReduceThreads + threadIdx.x;
  if (i >= n4) {
    return;
  }
  const int64_t e = 4 * i;
  const int64_t bh = e / per_head;  // b * hkv + hk; its first q head is bh * group
  const int64_t src = bh * p.group * per_head + (e - bh * per_head);
  float4 sk = *reinterpret_cast<const float4*>(p.dk_part + src);
  float4 sv = *reinterpret_cast<const float4*>(p.dv_part + src);
  for (int j = 1; j < p.group; ++j) {
    const float4 xk = *reinterpret_cast<const float4*>(p.dk_part + src + j * per_head);
    const float4 xv = *reinterpret_cast<const float4*>(p.dv_part + src + j * per_head);
    sk.x += xk.x;
    sk.y += xk.y;
    sk.z += xk.z;
    sk.w += xk.w;
    sv.x += xv.x;
    sv.y += xv.y;
    sv.z += xv.z;
    sv.w += xv.w;
  }
  const uint2 ok = make_uint2(pack2(static_cast<T*>(nullptr), sk.x * p.scale, sk.y * p.scale),
                              pack2(static_cast<T*>(nullptr), sk.z * p.scale, sk.w * p.scale));
  const uint2 ov = make_uint2(pack2(static_cast<T*>(nullptr), sv.x, sv.y),
                              pack2(static_cast<T*>(nullptr), sv.z, sv.w));
  *reinterpret_cast<uint2*>(static_cast<T*>(p.dk) + e) = ok;
  *reinterpret_cast<uint2*>(static_cast<T*>(p.dv) + e) = ov;
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
cudaError_t launch_tc(const Params& p, int b, cudaStream_t stream) {
  const int64_t nq = (p.sq + kTile - 1) / kTile;
  const int64_t nk = (p.sk + kTile - 1) / kTile * (D / kDkdvN<D>);  // kernel 2's CTAs a head
  const int64_t blocks =
      (static_cast<int64_t>(b) * p.hkv * p.sk * D / 4 + kReduceThreads - 1) / kReduceThreads;
  if (p.dk_part == nullptr || p.dv_part == nullptr || nq > 65535 || nk > 65535 ||
      blocks > INT_MAX) {
    return cudaErrorInvalidValue;
  }
  const unsigned hq = static_cast<unsigned>(p.hq);
  const unsigned bu = static_cast<unsigned>(b);
  cudaError_t err = launch(flash_bwd_dq_tc<T, D>, dim3(hq, bu, static_cast<unsigned>(nq)),
                           kMmaThreads, dq_tc_smem<D>(), p, stream);
  if (err != cudaSuccess) {
    return err;
  }
  err = launch(flash_bwd_dkdv_tc<T, D>, dim3(hq, bu, static_cast<unsigned>(nk)), kMmaThreads,
               dkdv_tc_smem<D>(), p, stream);
  if (err != cudaSuccess) {
    return err;
  }
  return launch(flash_bwd_reduce_dkdv<T>, dim3(static_cast<unsigned>(blocks)), kReduceThreads,
                0, p, stream);
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
cudaError_t launch_tc_dim(const Params& p, int b, int d, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch_tc<T, 32>(p, b, stream);
    case 64:
      return launch_tc<T, 64>(p, b, stream);
    case 128:
      return launch_tc<T, 128>(p, b, stream);
    case 256:
      return launch_tc<T, 256>(p, b, stream);
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
    case 256:
      return launch_simt<256>(p, b, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The sizes and flags of one call; false where they are out of range.
bool shape_params(Params& p, int b, int hq, int hkv, int sq, int sk, int d, float scale,
                  int causal, int prefix_len) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0 || sk <= 0 || b > 65535 ||
      hq > 65535 || sq > INT_MAX - 3 || prefix_len < 0) {
    return false;
  }
  p.batch = b;
  p.hq = hq;
  p.hkv = hkv;
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.group = hq / hkv;
  p.sq_pad = (sq + 3) / 4 * 4;
  p.scale = scale;
  p.causal = causal;
  p.prefix_len = causal ? prefix_len : 0;  // the mask widens the causal one
  return true;
}

}  // namespace

// q, k, v, o, dout: device pointers of `dtype` (0 float32, 1 bfloat16, 2
// float16); q, o, dout (b, hq, sq, d), k, v (b, hkv, sk, d), read through
// `strides`: 15 element strides, (b, h, s) of q, k, v, o, dout in that order,
// every d stride 1 (16-bit types: rows 16-byte aligned). m, l: the forward's
// (b, hq, sq) f32 row statistics. delta: f32 scratch, (b, hq, sq) for
// float32, (3, b, hq, sq rounded up to 4) for the 16-bit types. dk_part,
// dv_part: (b, hq, sk, d) f32 scratch each for the 16-bit types (unused,
// may be null, for float32). dq (b, hq, sq, d), dk, dv (b, hkv, sk, d):
// contiguous outputs of `dtype`. prefix_len >= 0: keys every row may see
// (the prefix-LM mask; causal calls only). The caller makes the tensors' device
// current. The kernels go on `stream` in order (16-bit: dq and the rows'
// statistics, dk and dv per q head, the sum over each group; float32: dq
// and Delta, then dk and dv); nothing is synchronised or allocated here.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const float* m,
                                          const float* l, float* delta, void* dq, void* dk,
                                          void* dv, float* dk_part, float* dv_part,
                                          const int64_t* strides, int b, int hq, int hkv,
                                          int sq, int sk, int d, int dtype, float scale,
                                          int causal, int prefix_len, cudaStream_t stream) {
  Params p;
  if (q == nullptr || k == nullptr || v == nullptr || o == nullptr || dout == nullptr ||
      m == nullptr || l == nullptr || delta == nullptr || dq == nullptr || dk == nullptr ||
      dv == nullptr || strides == nullptr ||
      !shape_params(p, b, hq, hkv, sq, sk, d, scale, causal, prefix_len)) {
    return cudaErrorInvalidValue;
  }
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
  p.dk_part = dk_part;
  p.dv_part = dv_part;
  int64_t* fields[15] = {&p.q_sb, &p.q_sh, &p.q_ss, &p.k_sb, &p.k_sh, &p.k_ss, &p.v_sb, &p.v_sh,
                         &p.v_ss, &p.o_sb, &p.o_sh, &p.o_ss, &p.do_sb, &p.do_sh, &p.do_ss};
  for (int i = 0; i < 15; ++i) *fields[i] = strides[i];
  switch (dtype) {
    case 0:
      return launch_simt_dim(p, b, d, stream);
    case 1:
      return launch_tc_dim<__nv_bfloat16>(p, b, d, stream);
    case 2:
      return launch_tc_dim<__half>(p, b, d, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
