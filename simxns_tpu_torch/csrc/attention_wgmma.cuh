// Device functions of the attention kernels on Hopper's warpgroup MMA
// (wgmma): K3 small_s_attention (small_s_attention.cu), the forward
// (attention_fwd_wgmma.cu: K5, K7, and the f32 instance of both) and the
// backward (attention_bwd_wgmma.cu: K6, K8, and the f32 instance of both).
//
// bf16 operands land in their tiles as they are. f32 operands are split
// inside the kernel into hi = bf16(x) and lo = bf16(x - hi) (x - hi is
// exact in f32); every product of two f32 operands is hi hi + hi lo + lo
// hi, three bf16 wgmma products into one f32 accumulator (lo lo, under
// 2^-16 of the product, is dropped). SPLIT = true is the f32 case.
//
// The pieces, in the order a kernel uses them:
// - HeadIn<T> / HeadOut<T>: [B, heads, S, d] views of T, d contiguous
//   (F32In / F32Out for f32);
// - Tile<DP, R>: R rows of DP bf16 values as wgmma reads them (the 32-, 64-
//   or 128-byte swizzle), read K-major (k_desc) or MN-major (mn_desc);
// - land_tile: rows of a bf16 operand straight into a Tile by cp.async
//   (zeros past S and d); land: rows of an f32 operand into a [R][DP] f32
//   landing buffer by cp.async; split_tile: a landed tile into its hi and
//   lo tiles by all the block's threads; split_rows: a warpgroup's 64
//   resident rows, read from device memory and split once;
// - issue_scores / issue_score: SS products a b^T of a resident 64-row
//   tile and a streamed one, both K-major, into the accumulator layout
//   ([N / 8][4] of a warp's 16 rows, which is mma.sync's); wait_scores;
// - fragments: an f32 accumulator as the hi and lo register A fragments of
//   a product, which issue_times multiplies by a streamed tile read
//   MN-major through the transpose bit (WgmmaBf16Rs): no transposed copy;
//   stmatrix_x4 stores such fragments to a tile;
//   bf16_fragments / issue_times_bf16: the same with one bf16 fragment;
// - before_scores / after_scores: two warpgroups in ping-pong on one tile;
// - store_rows: a warp's 16 rows of an accumulator to a view;
// - key_fills: each key's fill and each key tile's all-real flag; prepare:
//   a kernel's shared memory limit (host).
//
// At global scope, in the unnamed namespace of the including .cu: one copy
// in each library (see wgmma_gemm.cuh on templates shared across the
// loaded libraries).
#pragma once

#include "attention_bwd.cuh"
#include "wgmma_ring.cuh"

namespace {

namespace wg = sx::wg;
namespace ring = sx::ring;
namespace bwd = sx::bwd;

constexpr int kMaxS = 1024;
constexpr int kRows = 64;       // a warpgroup's resident rows: wgmma's M

template <class T>
struct HeadIn {           // a [B, heads, S, d] view of T, d contiguous
  const T* p;
  long long sb, sh, ss;   // element strides
  __device__ const T* row(int b, int h, int i) const {
    return p + b * sb + h * sh + static_cast<long long>(i) * ss;
  }
};

template <class T>
struct HeadOut {
  T* p;
  long long sb, sh, ss;
  __device__ T* row(int b, int h, int i) const {
    return p + b * sb + h * sh + static_cast<long long>(i) * ss;
  }
};

using F32In = HeadIn<float>;
using F32Out = HeadOut<float>;

// R rows of DP bf16 values as wgmma reads them: rows of W bytes in column
// blocks of R * W bytes, each 16-byte chunk XORed with its address bits 7
// and up (the W-byte swizzle; tiles 1024-byte aligned)
template <int DP, int R>
struct Tile {
  static constexpr int kW = DP * 2 < 128 ? DP * 2 : 128;
  static constexpr int kBlock = R * kW;
  static constexpr int kBytes = R * DP * 2;
  __device__ static int offset(int r, int c) {     // byte of (r, c)
    const int off = r * kW + (c * 2) % kW;
    return (c * 2 / kW) * kBlock + (off ^ (((off >> 7) & (kW / 16 - 1)) << 4));
  }
  // the tile K-major (its rows M or N, its columns K): k16 step ks
  __device__ static uint64_t k_desc(const uint8_t* t, int ks) {
    return wg::desc_sw<kW>(t + (ks * 32 / kW) * kBlock + (ks * 32) % kW, 16);
  }
  // the tile MN-major (its rows K, its columns N): k16 step kk
  __device__ static uint64_t mn_desc(const uint8_t* t, int kk) {
    return wg::desc_sw<kW>(t + kk * 16 * kW, kBlock);
  }
};

// rows r0 .. r0 + R - 1 of a bf16 operand into the tile dst by cp.async
// from T threads, 16 bytes a copy; zeros at rows >= S and columns >= d
// (nothing read; d on the 8 grid)
template <int DP, int R, int T, class Row>
__device__ __forceinline__ void land_tile(uint8_t* dst, Row row, int r0,
                                          int S, int d, int tid) {
  constexpr int kChunks = DP / 8, kIters = (R * kChunks + T - 1) / T;
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int idx = tid + i * T;
    if (kIters * T != R * kChunks && idx >= R * kChunks) break;
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    const bool ok = r0 + r < S && c < d;
    wg::cp_async16(dst + Tile<DP, R>::offset(r, c),
                   row(ok ? r0 + r : 0) + (ok ? c : 0), ok ? 16 : 0);
  }
}

// rows r0 .. r0 + R - 1 of an f32 operand into dst [R][DP] by cp.async
// from T threads, 16 bytes a copy; zeros at rows >= S and columns >= d
// (nothing read)
template <int DP, int R, int T, class Row>
__device__ __forceinline__ void land(float* dst, Row row, int r0, int S,
                                     int d, int tid) {
  constexpr int kChunks = DP / 4, kIters = (R * kChunks + T - 1) / T;
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int idx = tid + i * T;
    if (kIters * T != R * kChunks && idx >= R * kChunks) break;
    const int r = idx / kChunks, c = (idx % kChunks) * 4;
    const bool ok = r0 + r < S && c < d;
    wg::cp_async16(dst + r * DP + c, row(ok ? r0 + r : 0) + (ok ? c : 0),
                   ok ? 16 : 0);
  }
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// 4 f32 values as hi = bf16(x) and lo = bf16(x - hi) (x - hi exact)
__device__ __forceinline__ void split4(const float4& x, uint2& hi, uint2& lo) {
  const __nv_bfloat162 h0 = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(x.z, x.w);
  const float2 f0 = __bfloat1622float2(h0), f1 = __bfloat1622float2(h1);
  hi = make_uint2(bits(h0), bits(h1));
  lo = make_uint2(bits(__floats2bfloat162_rn(x.x - f0.x, x.y - f0.y)),
                  bits(__floats2bfloat162_rn(x.z - f1.x, x.w - f1.y)));
}

// a landed [R][DP] f32 tile into its hi and lo tiles, by T threads
template <int DP, int R, int T>
__device__ __forceinline__ void split_tile(uint8_t* hi, uint8_t* lo,
                                           const float* src, int tid) {
  constexpr int kChunks = DP / 4, kIters = (R * kChunks + T - 1) / T;
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int idx = tid + i * T;
    if (kIters * T != R * kChunks && idx >= R * kChunks) break;
    const int r = idx / kChunks, c = (idx % kChunks) * 4;
    uint2 h, l;
    split4(*reinterpret_cast<const float4*>(src + r * DP + c), h, l);
    const int off = Tile<DP, R>::offset(r, c);
    *reinterpret_cast<uint2*>(hi + off) = h;
    *reinterpret_cast<uint2*>(lo + off) = l;
  }
}

// rows r0 .. r0 + 63 of two f32 operands, read from device memory by the
// 128 threads of one warpgroup (wtid its thread; every load in flight
// before the first split), into that warpgroup's resident hi and lo tiles
// (zeros past S and d)
template <int DP, class RowA, class RowB>
__device__ __forceinline__ void split_rows(uint8_t* ah, uint8_t* al,
                                           RowA row_a, uint8_t* bh,
                                           uint8_t* bl, RowB row_b, int r0,
                                           int S, int d, int wtid) {
  constexpr int kChunks = DP / 4, kN = kRows * kChunks / 128;
  float4 x[2][kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int idx = wtid + i * 128;
    const int r = idx / kChunks, c = (idx % kChunks) * 4;
    const bool ok = r0 + r < S && c < d;
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    x[0][i] = ok ? *reinterpret_cast<const float4*>(row_a(r0 + r) + c) : zero;
    x[1][i] = ok ? *reinterpret_cast<const float4*>(row_b(r0 + r) + c) : zero;
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int idx = wtid + i * 128;
    const int r = idx / kChunks, c = (idx % kChunks) * 4;
    const int off = Tile<DP, kRows>::offset(r, c);
    uint2 h, l;
    split4(x[0][i], h, l);
    *reinterpret_cast<uint2*>(ah + off) = h;
    *reinterpret_cast<uint2*>(al + off) = l;
    split4(x[1][i], h, l);
    *reinterpret_cast<uint2*>(bh + off) = h;
    *reinterpret_cast<uint2*>(bl + off) = l;
  }
}

// the same for one operand
template <int DP, class Row>
__device__ __forceinline__ void split_rows(uint8_t* ah, uint8_t* al, Row row,
                                           int r0, int S, int d, int wtid) {
  constexpr int kChunks = DP / 4, kN = kRows * kChunks / 128;
  float4 x[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int idx = wtid + i * 128;
    const int r = idx / kChunks, c = (idx % kChunks) * 4;
    const bool ok = r0 + r < S && c < d;
    x[i] = ok ? *reinterpret_cast<const float4*>(row(r0 + r) + c)
              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int idx = wtid + i * 128;
    const int r = idx / kChunks, c = (idx % kChunks) * 4;
    const int off = Tile<DP, kRows>::offset(r, c);
    uint2 h, l;
    split4(x[i], h, l);
    *reinterpret_cast<uint2*>(ah + off) = h;
    *reinterpret_cast<uint2*>(al + off) = l;
  }
}

template <int N>
__device__ __forceinline__ float (&flat(float (&x)[N / 8][4]))[N / 2] {
  return reinterpret_cast<float(&)[N / 2]>(x);
}

template <int K>
__device__ __forceinline__ void fence_fragments(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i) wg::fence_operands(a[i]);
}

// xf += a b^T over the DP columns (a the warpgroup's resident 64-row
// tile, b a streamed N-row tile, both K-major): of two split pairs
// (SPLIT), else of the bf16 tiles ah and bh (al, bl unused)
template <int DP, int N, bool SPLIT = true>
__device__ __forceinline__ void mma_split(float (&xf)[N / 2],
                                          const uint8_t* ah,
                                          const uint8_t* al,
                                          const uint8_t* bh,
                                          const uint8_t* bl) {
  using A = Tile<DP, kRows>;
  using B = Tile<DP, N>;
  using Mma = wg::WgmmaBf16<N>;
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    if constexpr (SPLIT) {
      Mma::mma(xf, A::k_desc(al, ks), B::k_desc(bh, ks), 1);
      Mma::mma(xf, A::k_desc(ah, ks), B::k_desc(bl, ks), 1);
    }
    Mma::mma(xf, A::k_desc(ah, ks), B::k_desc(bh, ks), 1);
  }
}

// issue x = a b^T and y = c e^T over the DP columns of four split pairs
// (a, c the warpgroup's resident 64-row tiles, b, e streamed N-row tiles,
// all K-major; bf16 tiles a, b, c, e when !SPLIT) into x and y, zeroed
// first, in the accumulator layout (attention_ring.cuh's [N / 8][4] of a
// warp's 16 rows); committed, not waited for (wait_scores)
template <int DP, int N, bool SPLIT = true>
__device__ __forceinline__ void issue_scores(
    float (&x)[N / 8][4], float (&y)[N / 8][4], const uint8_t* ah,
    const uint8_t* al, const uint8_t* bh, const uint8_t* bl,
    const uint8_t* ch, const uint8_t* cl, const uint8_t* eh,
    const uint8_t* el) {
  float(&xf)[N / 2] = flat<N>(x);
  float(&yf)[N / 2] = flat<N>(y);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) xf[i] = yf[i] = 0.0f;
  wg::fence_operands(xf);
  wg::fence_operands(yf);
  wg::wgmma_fence();
  mma_split<DP, N, SPLIT>(xf, ah, al, bh, bl);
  mma_split<DP, N, SPLIT>(yf, ch, cl, eh, el);
  wg::wgmma_commit();
}

// issue x = a b^T alone (as issue_scores)
template <int DP, int N, bool SPLIT = true>
__device__ __forceinline__ void issue_score(float (&x)[N / 8][4],
                                            const uint8_t* ah,
                                            const uint8_t* al,
                                            const uint8_t* bh,
                                            const uint8_t* bl) {
  float(&xf)[N / 2] = flat<N>(x);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) xf[i] = 0.0f;
  wg::fence_operands(xf);
  wg::wgmma_fence();
  mma_split<DP, N, SPLIT>(xf, ah, al, bh, bl);
  wg::wgmma_commit();
}

// Ping-pong of two warpgroups: the second issues its score products only
// once the first has issued its own, so the tensor cores take the first's
// whole batch before the second's, and the first's softmax algebra runs
// under the second's products (named barrier 1).
template <int WG>
__device__ __forceinline__ void before_scores() {
  if (WG == 2 && threadIdx.x >= 128) wg::named_sync(1, 256);
}

template <int WG>
__device__ __forceinline__ void after_scores() {
  if (WG == 2 && threadIdx.x < 128) wg::named_arrive(1, 256);
}

template <int N>
__device__ __forceinline__ void wait_scores(float (&x)[N / 8][4],
                                            float (&y)[N / 8][4]) {
  wg::wgmma_wait<0>();
  wg::fence_operands(flat<N>(x));
  wg::fence_operands(flat<N>(y));
}

template <int N>
__device__ __forceinline__ void wait_score(float (&x)[N / 8][4]) {
  wg::wgmma_wait<0>();
  wg::fence_operands(flat<N>(x));
}

// acc += x b over the N rows of the split tile b (read MN-major), x as
// its hi and lo A fragments (of the bf16 tile bh alone when !SPLIT: two
// products); issued, not waited for. HI_FIRST (bf16 only): each k16
// step's hi product before its lo one, the order of the mma.sync
// forward that K5 and K7 replaced (their o is that kernel's bit for bit)
template <int DP, int N, bool SPLIT = true, bool HI_FIRST = false>
__device__ __forceinline__ void issue_times(float (&acc)[DP / 2],
                                            const uint32_t (&xh)[N / 16][4],
                                            const uint32_t (&xl)[N / 16][4],
                                            const uint8_t* bh,
                                            const uint8_t* bl) {
  static_assert(!(SPLIT && HI_FIRST), "the split products keep one order");
  using B = Tile<DP, N>;
  using Mma = wg::WgmmaBf16Rs<DP, true>;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    if constexpr (HI_FIRST) Mma::mma(acc, xh[kk], B::mn_desc(bh, kk), 1);
    Mma::mma(acc, xl[kk], B::mn_desc(bh, kk), 1);
    if constexpr (SPLIT) Mma::mma(acc, xh[kk], B::mn_desc(bl, kk), 1);
    if constexpr (!HI_FIRST) Mma::mma(acc, xh[kk], B::mn_desc(bh, kk), 1);
  }
}

// acc += x b with x one bf16 A fragment a k16 step (x already rounded to
// bf16): one product a step; issued, not waited for
template <int DP, int N>
__device__ __forceinline__ void issue_times_bf16(
    float (&acc)[DP / 2], const uint32_t (&x)[N / 16][4], const uint8_t* b) {
  using B = Tile<DP, N>;
  using Mma = wg::WgmmaBf16Rs<DP, true>;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    Mma::mma(acc, x[kk], B::mn_desc(b, kk), 1);
}

template <int N>
__device__ __forceinline__ void fragments(uint32_t (&hi)[N / 16][4],
                                          uint32_t (&lo)[N / 16][4],
                                          const float (&x)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    ring::a_fragments_split(hi[kk], lo[kk], x, kk);
}

// x rounded to bf16 as the register A fragments of a product
template <int N>
__device__ __forceinline__ void bf16_fragments(uint32_t (&a)[N / 16][4],
                                               const float (&x)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) ring::a_fragment(a[kk], x, kk);
}

// four 8 x 8 matrices of bf16 pairs to shared memory: lane l gives the
// address of row l % 8 of matrix l / 8 (16 bytes); register i of a thread
// holds row g, columns 2t and 2t + 1 of matrix i, which is the A fragment
// layout (a_fragment: rows g and g + 8, then columns 8 further)
__device__ __forceinline__ void stmatrix_x4(uint8_t* row,
                                            const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
          "r"(wg::smem_u32(row)),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

// rows r0 + g and r0 + g + 8 of a [16][DP] accumulator, columns below d,
// stored as the view's type (bf16 rounded)
template <int DP, class Out>
__device__ __forceinline__ void store_rows(const Out& o, int b, int h,
                                           int r0, int S, int d,
                                           const float (&acc)[DP / 8][4],
                                           float mul) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ra = r0 + g, rb = r0 + g + 8;
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (c >= d) continue;
    if (ra < S)
      sx::store2(o.row(b, h, ra) + c, acc[nd][0] * mul, acc[nd][1] * mul);
    if (rb < S)
      sx::store2(o.row(b, h, rb) + c, acc[nd][2] * mul, acc[nd][3] * mul);
  }
}

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024 - (wg::smem_u32(raw) & 1023)) & 1023);
}

// a kernel's dynamic shared memory limit, before its launch
template <class Kernel>
cudaError_t prepare(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// each key's fill (bwd::key_fill) of a batch row into fill[0 .. n_tiles *
// N), and for each key tile whether every key of it is real (real[j]);
// every thread of the block calls it (all_masked is a barrier)
template <int N, int T>
__device__ __forceinline__ void key_fills(float* fill, int* real,
                                          const int* mask, int b, int S,
                                          int n_tiles, int tid) {
  const bool none_real = bwd::all_masked(mask, b, S);
  for (int j = tid; j < n_tiles * N; j += T)
    fill[j] = bwd::key_fill(mask, b, j, S, none_real);
  __syncthreads();
  const int lane = tid & 31;
  for (int j = tid >> 5; j < n_tiles; j += T / 32) {
    bool all = true;
    for (int i = lane; i < N; i += 32) all &= fill[j * N + i] == bwd::kRealKey;
    all = __all_sync(0xffffffffu, all);
    if (lane == 0) real[j] = all;
  }
}

}  // namespace
