// K13 int8_dense and K14 int8_ffn: the encode path's int8 projections
// (BertConfig proj_impl="int8") and int8 feed-forward block
// (ffn_impl="int8").
//
// They replace the two Pallas kernels of simxns_tpu/ops/fused_ffn.py:
//   K13 int8_dense_fwd  _dense_int8_kernel (:222)
//       y = (f32(q(x) W8^T) * xs) * ws + b
//   K14 int8_ffn_fwd    _ffn_int8_kernel   (:160)
//       h = (f32(q(x) W1_8^T) * xs) * s1 + b1,   g = gelu(h)
//       y = (f32(q(g) W2_8^T) * gs) * s2 + b2
// with their arithmetic: q() is the per-row symmetric int8 of the TPU
// kernels (s = max(max|row| / 127, 1e-12), codes rint(v / s) clipped to
// +-127; both quotients correctly rounded), weights come quantized per
// output channel (ws, s1, s2), products accumulate exactly in int32, the
// dequantization is f32 in the TPU's order (no FMA: the build passes
// --fmad=false), GELU is the Abramowitz-Stegun erf on the UNROUNDED f32 h,
// and y is rounded to bf16 once, at the end. Both equal their plain
// versions bit for bit.
//
// Both run on the persistent wgmma GEMM of wgmma_gemm.cuh, and share its
// instances in this library. K13 is two launches of one call:
// 1. quantize_x: the codes of x and their scales xs (one warp a row: max|x|,
//    then the codes; a row of up to 1024 values stays in registers between
//    the two passes, a longer one is read again) into device memory;
// 2. the GEMM codes x W8 (kDequant, bf16 out): (acc * xs) * ws + b, the
//    instance that K14's GEMM 2 runs.
// Bound on the card: bytes at the encode path's shapes (131,072 x 768 ->
// 2304: 201 MB in, 604 MB out, 0.241 ms, against 0.234 ms of int8
// operations). The codes of x make a round trip through device memory (100
// MB each way at the chunk): a GEMM block of 128 rows at I = 768 cannot
// keep its codes resident beside 4 TMA stages of 256 x 128 bytes, and
// coding inside the GEMM's consumers lost 2x for K14's g (below). The first
// cut quantized a block's rows into shared memory and fed mma.sync from a
// cp.async ring of weight tiles (1.66 ms at the chunk's q, k, v on an H100).
//
// K14 is four launches of one call:
// 1. quantize_x, as K13's;
// 2. GEMM 1, codes x W1 (kDequant with GELU, f32 out): g [M, F] in f32, and
//    each row's max |g| over each column tile, [M, F / BN];
// 3. quantize_g: a row's maxima -> gs, then the codes of g (the quotient by
//    the correctly rounded 1 / gs and one residual FMA, no branch), one
//    streaming pass over g;
// 4. GEMM 2, codes(g) x W2 (kDequant, bf16 out): (acc * gs) * s2 + b2.
// Bound on the card: operations, 4 M H F = 1.24e12 int8 at the encode chunk
// (131,072 x 768 x 3072), 0.625 ms (its inputs and output move 0.4 GB).
// Why g goes through device memory: a fused kernel streams both weights
// from L2 once per row block, at 2 BM int8 operations a byte, so keeping L2
// under the ~7.7 TB/s it gave K1 at the int8 peak (1979 TOP/s) takes BM >=
// ~128 rows; the exact gs needs all of F before the first code, and 128
// rows of f32 g at F = 3072 are 1.57 MB, seven SMs' shared memory. The
// first cut kept 32 rows and made two passes over the first product
// instead (1.5x the products, 402M GELUs twice, 7 MB of weights from L2 a
// block: 13.8 ms at the chunk on an H100). Writing g, reading it back and
// the codes of g move 4 GB, ~1.2 ms at 3.35 TB/s. Coding g inside GEMM 2 (its
// consumers loading f32 slabs straight into the swizzled stage, three times
// at H = 768) took 2.33 ms for that GEMM on the card against ~1.1 for this
// pass and a plain GEMM (H100, scripts/torch_kernel_bench.py, in turns).
#include "wgmma_gemm.cuh"

extern "C" const char* sx_error_string(int code) {
  return sx::gemm::error_string(code);
}

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRegRow = 1024;   // values of a row a warp holds at once
constexpr int kThreads = 256;   // the quantizers' blocks
constexpr int kWarps = kThreads / 32;
// rows of x a block codes, one a warp (H100: a request's 256 rows 0.0026
// ms against 0.0072 at 32 a block, the encode chunk's 131,072 0.116 against
// 0.121; scripts/torch_kernel_bench.py, in turns)
constexpr int kQuantRows = 8;

__device__ __forceinline__ int quantize(float v, float s) {
  float q = rintf(__fdiv_rn(v, s));
  return static_cast<int>(fminf(fmaxf(q, -127.0f), 127.0f));
}

__device__ __forceinline__ float row_scale(float amax) {
  return fmaxf(__fdiv_rn(amax, 127.0f), 1e-12f);
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (a & 0xff) | ((b & 0xff) << 8) | ((c & 0xff) << 16) |
         (static_cast<uint32_t>(d & 0xff) << 24);
}

// The int8 code of v with the row scale s and r = 1 / s rounded to nearest:
// rint(v / s) clipped to +-127, the quotient correctly rounded without the
// branch of a true division: q0 = v r, the residual e = v - q0 s exact by
// FMA, q = q0 + e r (the correctly rounded reciprocal makes q the rounded
// quotient wherever nothing under- or overflows).
__device__ __forceinline__ int code_of(float v, float s, float r) {
  const float q0 = v * r;
  const float e = fmaf(-q0, s, v);
  const float q = rintf(fmaf(e, r, q0));
  return static_cast<int>(fminf(fmaxf(q, -127.0f), 127.0f));
}

// g [M, F] f32 (F % 128 == 0) and its per-tile row maxima parts [M,
// n_parts] -> gs [M] and the codes of g [M, F]; one warp a row, 8 rows a
// block, a lane 8 loads of 16 bytes in flight
__global__ void __launch_bounds__(kThreads)
    quantize_g_kernel(const float* __restrict__ g,
                      const float* __restrict__ parts, int n_parts,
                      uint8_t* __restrict__ codes, float* __restrict__ gs,
                      int M, int F) {
  const int lane = threadIdx.x % 32;
  const long long m = blockIdx.x * kWarps + threadIdx.x / 32;
  if (m >= M) return;
  float amax = 0.0f;
  for (int p = lane; p < n_parts; p += 32)
    amax = fmaxf(amax, parts[m * n_parts + p]);
#pragma unroll
  for (int o = 16; o; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = row_scale(amax), r = __frcp_rn(s);
  if (lane == 0) gs[m] = s;
  const float4* row = reinterpret_cast<const float4*>(g + m * F);
  uint32_t* dst = reinterpret_cast<uint32_t*>(codes + m * F);
  const int n4 = F / 4;
  for (int c0 = lane; c0 < n4; c0 += 32 * 8) {
    float4 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = c0 + 32 * i < n4 ? __ldcs(row + c0 + 32 * i)
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (c0 + 32 * i >= n4) break;
      dst[c0 + 32 * i] = pack4(code_of(v[i].x, s, r), code_of(v[i].y, s, r),
                               code_of(v[i].z, s, r), code_of(v[i].w, s, r));
    }
  }
}

// x [M, K] bf16 -> codes [M, K] int8 and xs [M] f32 (K % 8 == 0); one warp
// a row, which it walks in chunks of kRegRow values (a lane four 16-byte
// pieces of each): max|x| over the chunks, then the codes. A row of one
// chunk stays in the lanes' registers between the two passes; a longer
// row is read again (from L1 / L2).
__global__ void __launch_bounds__(kThreads)
    quantize_x_kernel(const bf16* __restrict__ x, uint8_t* __restrict__ codes,
                      float* __restrict__ xs, int M, int K) {
  constexpr int kPieces = kRegRow / 256;   // 16-byte pieces a lane a chunk
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunks = K / 8;                // 16-byte pieces of the row
  const int m0 = blockIdx.x * kQuantRows, rows = min(kQuantRows, M - m0);
  for (int r = warp; r < rows; r += kWarps) {
    const long m = m0 + r;
    uint4 v[kPieces];
    float amax = 0.0f;
    for (int base = 0; base < chunks; base += 32 * kPieces) {
#pragma unroll
      for (int j = 0; j < kPieces; ++j) {
        const int c = base + lane + 32 * j;
        v[j] = make_uint4(0, 0, 0, 0);
        if (c < chunks)
          v[j] = *reinterpret_cast<const uint4*>(x + m * K + c * 8);
        const __nv_bfloat162* e =
            reinterpret_cast<const __nv_bfloat162*>(&v[j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(e[i]);
          amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
        }
      }
    }
#pragma unroll
    for (int o = 16; o; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float s = row_scale(amax);
    const bool held = chunks <= 32 * kPieces;   // v is the whole row
    for (int base = 0; base < chunks; base += 32 * kPieces) {
#pragma unroll
      for (int j = 0; j < kPieces; ++j) {
        const int c = base + lane + 32 * j;
        if (c >= chunks) continue;
        if (!held) v[j] = *reinterpret_cast<const uint4*>(x + m * K + c * 8);
        const __nv_bfloat162* e =
            reinterpret_cast<const __nv_bfloat162*>(&v[j]);
        int q[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(e[i]);
          q[2 * i] = quantize(f.x, s);
          q[2 * i + 1] = quantize(f.y, s);
        }
        *reinterpret_cast<uint2*>(codes + m * K + c * 8) = make_uint2(
            pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]));
      }
    }
    if (lane == 0) xs[m] = s;
  }
}

// quantize_x_kernel's launch; -> cudaGetLastError()
int quantize_x(const void* x, void* codes, float* xs, int M, int K,
               cudaStream_t s) {
  quantize_x_kernel<<<(M + kQuantRows - 1) / kQuantRows, kThreads, 0,
                      s>>>(static_cast<const bf16*>(x),
                           static_cast<uint8_t*>(codes), xs, M, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K13; see the note at the head of this file. x [M, K] bf16; W [N, K]
// int8; ws, b [N] f32; out [M, N] bf16; the workspaces codes [M, K] int8
// and xs [M] f32; the GEMM's tile (bm, bn) over [M, N]
// (ops/_native.py:wgmma_tile). K and N multiples of 128, any M >= 1
// (checked by the Python wrapper; cudaErrorInvalidValue otherwise).
// Returns 0, a CUDA error code, or one of wgmma_gemm.cuh's.
extern "C" int sx_int8_dense(const void* x, const void* W, const float* ws,
                             const float* b, void* out, void* codes,
                             float* xs, int M, int K, int N, int bm, int bn,
                             void* stream) {
  namespace gm = sx::gemm;
  if (M < 1 || K < 128 || K % 128 || N < 128 || N % 128)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = quantize_x(x, codes, xs, M, K, s);
  if (err != 0) return err;
  gm::Args args;
  args.xs = xs;
  args.ws = ws;
  args.bias = b;
  args.out = out;
  return gm::run<gm::kDequant, false, true, false>(bm, bn, codes, W, args, M,
                                                   N, K, s);
}

// K14; see the note at the head of this file. x [M, H] bf16; W1 [F, H],
// W2 [H, F] int8; s1, b1 [F], s2, b2 [H] f32; out [M, H] bf16; the
// workspaces codes [M, H] int8, xs [M], g [M, F] f32, parts [M, ceil(F /
// bn1)] f32, gcodes [M, F] int8 and gs [M] f32; the GEMMs' tiles (bm1,
// bn1) over [M, F] and (bm2, bn2) over [M, H] (ops/_native.py:wgmma_tile).
// H and F multiples of 128, any M >= 1 (checked by the Python wrapper;
// cudaErrorInvalidValue otherwise). Returns 0, a CUDA error code, or one of
// wgmma_gemm.cuh's.
extern "C" int sx_int8_ffn(const void* x, const void* W1, const float* s1,
                           const float* b1, const void* W2, const float* s2,
                           const float* b2, void* out, void* codes, float* xs,
                           float* g, float* parts, void* gcodes, float* gs,
                           int M, int H, int F, int bm1, int bn1, int bm2,
                           int bn2, void* stream) {
  namespace gm = sx::gemm;
  if (M < 1 || H < 128 || H % 128 || F < 128 || F % 128)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = quantize_x(x, codes, xs, M, H, s);
  if (err != 0) return err;
  gm::Args first;
  first.xs = xs;
  first.ws = s1;
  first.bias = b1;
  first.out = g;
  first.row_max = parts;
  err = gm::run<gm::kDequant, true, false, true>(bm1, bn1, codes, W1, first,
                                                 M, F, H, s);
  if (err != 0) return err;
  quantize_g_kernel<<<(M + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      g, parts, (F + bn1 - 1) / bn1, static_cast<uint8_t*>(gcodes), gs, M, F);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  gm::Args second;
  second.xs = gs;
  second.ws = s2;
  second.bias = b2;
  second.out = out;
  return gm::run<gm::kDequant, false, true, false>(bm2, bn2, gcodes, W2,
                                                   second, M, H, F, s);
}
