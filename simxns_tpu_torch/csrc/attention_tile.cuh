// Device functions of the attention kernels: the views, row loads and
// stores (In, Out, load_rows, load_a, store_rows, zero, prepare) serve K5-K8
// (group_attention.cu, bh_attention.cu); the products below serve K5, the
// first cut (K3, K7, K6 and K8 run attention_ring.cuh's).
//
// A warp owns 16 rows of one side (queries, or keys in a backward key
// pass) and walks the other side in chunks of 32 through shared memory.
// Every product runs on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate):
// - mma_rows: a 16 x 32 tile of A (bf16 fragments) times the transpose of
//   32 shared-memory rows (q k^T, dO v^T): exact products;
// - mma_cols: an f32 16 x 32 tile (p or dS, in accumulator layout) times
//   32 shared-memory rows (p v, dS k, ...). The f32 operand is split into
//   hi = bf16(x) and lo = bf16(x - hi), two products into one f32
//   accumulator: about 16 bits of the f32 value, where TF32 (10 bits)
//   would be too coarse for dS, whose dP - rowsum(dP p) cancels.
// Key flags: 1 = real key, 0 = masked (score -1e9, the TPU kernels' bias),
// -1 = padding past S (score -inf, so it adds exactly 0).
#pragma once

#include "tile_gemm.cuh"

namespace sx {
namespace attn {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 32;           // keys (or queries) per inner step
constexpr int kTiles = kChunk / 8;   // n8 accumulator tiles per step

struct In {               // a [B, heads, S, D] bf16 view, D contiguous
  const __nv_bfloat16* p;
  long long sb, sh, ss;   // element strides
  __device__ const __nv_bfloat16* row(int b, int h, int i) const {
    return p + b * sb + h * sh + static_cast<long long>(i) * ss;
  }
};

struct Out {
  __nv_bfloat16* p;
  long long sb, sh, ss;
  __device__ __nv_bfloat16* row(int b, int h, int i) const {
    return p + b * sb + h * sh + static_cast<long long>(i) * ss;
  }
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 values as one mma operand register, `lo` in the low half
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ float masked(float s, int flag) {
  return flag > 0 ? s : (flag == 0 ? -1e9f : -INFINITY);
}

// rows r0 .. r0 + n - 1 of a view into shared memory [n][D + 8]; zeros for
// rows at or past S
template <int D>
__device__ void load_rows(__nv_bfloat16* dst, const In& x, int b, int h,
                          int r0, int n, int S) {
  for (int idx = threadIdx.x; idx < n * (D / 8); idx += kThreads) {
    const int j = idx / (D / 8), c = (idx % (D / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + j < S)
      val = *reinterpret_cast<const uint4*>(x.row(b, h, r0 + j) + c);
    *reinterpret_cast<uint4*>(dst + j * (D + 8) + c) = val;
  }
}

// the flags of keys r0 .. r0 + n - 1 of batch row b (mask [B, S] int32)
__device__ __forceinline__ int key_flag(const int* mask, int b, int key,
                                        int S) {
  return key >= S ? -1
                  : (mask[static_cast<long long>(b) * S + key] > 0 ? 1 : 0);
}

__device__ void load_flags(int* flag, const int* mask, int b, int r0, int n,
                           int S) {
  for (int j = threadIdx.x; j < n; j += kThreads)
    flag[j] = key_flag(mask, b, r0 + j, S);
}

// A fragments of rows r0 .. r0 + 15 of a view, straight from memory
template <int D>
__device__ void load_a(uint32_t (&a)[D / 16][4], const In& x, int b, int h,
                       int r0, int S) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ra = r0 + g, rb = r0 + g + 8;
  const __nv_bfloat16* pa = x.row(b, h, ra < S ? ra : 0);
  const __nv_bfloat16* pb = x.row(b, h, rb < S ? rb : 0);
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    const int c = kd * 16 + 2 * t;
    a[kd][0] = ra < S ? ld32(pa + c) : 0u;
    a[kd][1] = rb < S ? ld32(pb + c) : 0u;
    a[kd][2] = ra < S ? ld32(pa + c + 8) : 0u;
    a[kd][3] = rb < S ? ld32(pb + c + 8) : 0u;
  }
}

// acc[nt][e] = sum_c A[row][c] * rows[n0 + nt * 8 + col][c]: a 16 x 32 tile
// of A times the transpose of shared-memory rows n0 .. n0 + 31. Element e
// is row (e < 2 ? g : g + 8), column nt * 8 + 2t + (e & 1).
template <int D>
__device__ void mma_rows(float (&acc)[kTiles][4], const uint32_t (&a)[D / 16][4],
                         const __nv_bfloat16* rows, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kTiles; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
    const __nv_bfloat16* r = rows + (n0 + nt * 8 + g) * (D + 8) + 2 * t;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      const uint32_t bf[2] = {ld32(r + kd * 16), ld32(r + kd * 16 + 8)};
      sx::MmaBf16::mma(acc[nt], a[kd], bf);
    }
  }
}

// out[nd][e] += sum_m x[row][m] * rows[m0 + m][nd * 8 + col]: an f32 16 x 32
// tile (accumulator layout, as hi + lo bf16 A fragments) times shared-memory
// rows m0 .. m0 + 31.
template <int D>
__device__ void mma_cols(float (&out)[D / 8][4], const float (&x)[kTiles][4],
                         const __nv_bfloat16* rows, int m0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  constexpr int kRow = D + 8;
#pragma unroll
  for (int kk = 0; kk < kChunk / 16; ++kk) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // A fragment register r: tile 2kk + (r >> 1), rows g / g + 8 by r & 1
      const float* src = x[2 * kk + (r >> 1)] + 2 * (r & 1);
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(src[0], src[1]);
      const float2 hf = __bfloat1622float2(h2);
      const __nv_bfloat162 l2 =
          __floats2bfloat162_rn(src[0] - hf.x, src[1] - hf.y);
      hi[r] = *reinterpret_cast<const uint32_t*>(&h2);
      lo[r] = *reinterpret_cast<const uint32_t*>(&l2);
    }
    const __nv_bfloat16* base = rows + (m0 + kk * 16 + 2 * t) * kRow + g;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const __nv_bfloat16* c = base + nd * 8;
      const uint32_t bf[2] = {pack2(c[0], c[kRow]),
                              pack2(c[8 * kRow], c[9 * kRow])};
      sx::MmaBf16::mma(out[nd], hi, bf);
      sx::MmaBf16::mma(out[nd], lo, bf);
    }
  }
}

template <int D>
__device__ __forceinline__ void zero(float (&acc)[D / 8][4]) {
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.0f;
}

// a per-row value summed over the four threads that share the row
__device__ __forceinline__ void quad_sum(float (&x)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    x[r] += __shfl_xor_sync(0xffffffffu, x[r], 1);
    x[r] += __shfl_xor_sync(0xffffffffu, x[r], 2);
  }
}

// Each row's max and sum of exp(s - max), folded chunk by chunk (the sum
// rescaled when the max grows): stats_begin, stats_add over the columns
// [c0, c1) of any number of tiles, then stats_end.
__device__ __forceinline__ void stats_begin(float (&mx)[2], float (&sum)[2]) {
  mx[0] = mx[1] = -INFINITY;
  sum[0] = sum[1] = 0.0f;
}

template <class Scores>
__device__ void stats_add(Scores scores, int c0, int c1, float (&mx)[2],
                          float (&sum)[2]) {
  for (int c = c0; c < c1; c += kChunk) {
    float sc[kTiles][4];
    scores(c, sc);
    float cm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) cm[e >> 1] = fmaxf(cm[e >> 1], sc[nt][e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      cm[r] = fmaxf(cm[r], __shfl_xor_sync(0xffffffffu, cm[r], 1));
      cm[r] = fmaxf(cm[r], __shfl_xor_sync(0xffffffffu, cm[r], 2));
      const float m_new = fmaxf(mx[r], cm[r]);
      sum[r] = mx[r] == -INFINITY ? 0.0f : sum[r] * expf(mx[r] - m_new);
      mx[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[e >> 1] += expf(sc[nt][e] - mx[e >> 1]);
  }
}

__device__ __forceinline__ void stats_end(float (&sum)[2]) { quad_sum(sum); }

// rows r0 + g and r0 + g + 8 of a [16][D] accumulator, as bf16
template <int D>
__device__ void store_rows(const Out& o, int b, int h, int r0, int S,
                           const float (&acc)[D / 8][4], float mul) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ra = r0 + g, rb = r0 + g + 8;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (ra < S)
      *reinterpret_cast<__nv_bfloat162*>(o.row(b, h, ra) + c) =
          __floats2bfloat162_rn(acc[nd][0] * mul, acc[nd][1] * mul);
    if (rb < S)
      *reinterpret_cast<__nv_bfloat162*>(o.row(b, h, rb) + c) =
          __floats2bfloat162_rn(acc[nd][2] * mul, acc[nd][3] * mul);
  }
}

template <class Kernel>
cudaError_t prepare(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace attn
}  // namespace sx
