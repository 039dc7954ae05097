// K13 int8_dense and K14 int8_ffn: the encode path's int8 projections
// (BertConfig proj_impl="int8") and int8 feed-forward block
// (ffn_impl="int8"), in one launch each.
//
// They replace the two Pallas kernels of simxns_tpu/ops/fused_ffn.py:
//   K13 int8_dense_fwd  _dense_int8_kernel (:222)
//       y = (f32(q(x) W8^T) * xs) * ws + b
//   K14 int8_ffn_fwd    _ffn_int8_kernel   (:160)
//       h = (f32(q(x) W1_8^T) * xs) * s1 + b1,   g = gelu(h)
//       y = (f32(q(g) W2_8^T) * gs) * s2 + b2
// with their arithmetic: q() is the per-row symmetric int8 of the TPU
// kernels (s = max(max|row| / 127, 1e-12), codes rint(v / s) clipped to
// +-127; both divisions correctly rounded), weights come quantized per
// output channel (ws, s1, s2), products accumulate exactly in int32, the
// dequantization is f32 in the TPU's order (no FMA: the build passes
// --fmad=false), GELU is the Abramowitz-Stegun erf on the UNROUNDED f32 h,
// and y is rounded to bf16 once, at the end.
//
// Both kernels quantize their block's rows of x themselves (one warp a
// row, the row in registers: max|x|, then the codes) into shared memory,
// where the codes stay as the resident A operand while the int8 weight
// tiles, [128 rows][128 bytes of K], stream through one cp.async ring.
// No int8 copy of x, h or g goes through device memory.
//
// K13. A block owns BM = 32, 64 or 128 rows and walks a run of 128-column
// output tiles (all of O when the row blocks alone fill the card, so x is
// read once; at small M the columns are split over blocks, which then read
// their rows again from L2). Bound on the card: bytes at the encode
// path's shapes (131,072 x 768 -> 2304: 201 MB in, 604 MB out, 0.241 ms,
// against 0.234 ms of int8 operations).
//
// K14. The per-row scale of g, max_f |gelu(h[m, f])| / 127, needs all of
// F before the first code of g exists, and a block cannot hold g: 32 rows
// x 3072 x 4 bytes is 384 KB against 227 KB of shared memory. Of the three
// exact designs (keep g of 16 rows in shared memory; two launches; two
// passes over the first product) this is the third: pass 1 walks F in
// chunks of 128 (first product, dequantize, GELU) and keeps only each
// row's running max |g|; pass 2 walks F again with the same instructions
// on the same inputs, so h and g come out bit for bit as in pass 1, codes
// each chunk's [32, 128] g with the now known gs into shared memory and
// adds its second product to the block's [32, H] int32 sum, held in
// registers (16 H / 128 a thread: 96 at H = 768). gs is constant along a
// row, so the int32 sum over all chunks is the TPU's, dequantized once at
// the end. The cost: 1.5x the TPU kernel's products and W1 streamed twice.
// A block owns 32 rows, so every block streams 3 F H bytes of weights from
// L2 (7 MB at BERT-base); that traffic, not the tensor cores, bounds this
// first cut (bound on the card: operations, 4 M H F = 1.24e12 at the
// encode chunk, 0.625 ms). wgmma, TMA and a row block shared by a cluster
// are later work.
#include "tile_gemm.cuh"

SX_DEFINE_ERROR_STRING

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTileK = 128;               // bytes of K in a weight tile
constexpr int kPitch = kTileK + 16;       // 144 B: 8 rows -> 32 banks
constexpr int kTile = 128 * kPitch;       // one [128 rows][128 B] tile
constexpr int kMaxRow = 1024;             // widest row a warp quantizes
constexpr int kWarps = sx::kThreads / 32;

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

// Rows m0 .. m0 + rows - 1 of x [M, K] bf16 (K % 128 == 0, K <= kMaxRow)
// -> codes at sQ (rows `pitch` bytes apart) and scales at sS. One warp a
// row; a lane holds at most four 16-byte chunks of it. Rows past M get
// codes 0.
__device__ void quantize_rows(const bf16* __restrict__ x, int M, int K,
                              int m0, int rows, uint8_t* sQ, int pitch,
                              float* sS) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunks = K / 8;
  for (int r = warp; r < rows; r += kWarps) {
    const bool live = m0 + r < M;
    uint4 v[kMaxRow / 256];
    float amax = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxRow / 256; ++j) {
      const int c = lane + 32 * j;
      v[j] = make_uint4(0, 0, 0, 0);
      if (live && c < chunks)
        v[j] = *reinterpret_cast<const uint4*>(
            x + static_cast<long>(m0 + r) * K + c * 8);
      const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&v[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(e[i]);
        amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
      }
    }
#pragma unroll
    for (int o = 16; o; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float s = row_scale(amax);
#pragma unroll
    for (int j = 0; j < kMaxRow / 256; ++j) {
      const int c = lane + 32 * j;
      if (c >= chunks) continue;
      const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&v[j]);
      int q[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(e[i]);
        q[2 * i] = quantize(f.x, s);
        q[2 * i + 1] = quantize(f.y, s);
      }
      *reinterpret_cast<uint2*>(sQ + r * pitch + c * 8) = make_uint2(
          pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]));
    }
    if (lane == 0) sS[r] = s;
  }
}

// The loads of one weight tile: rows n0 .. n0 + 127 of W (ld bytes apart),
// bytes k0 .. k0 + 127 of each, into `slot`.
__device__ __forceinline__ void load_tile(uint8_t* slot, const int8_t* W,
                                          long ld, int n0, int k0) {
  const int8_t* src = W + static_cast<long>(n0) * ld + k0;
  for (int c = threadIdx.x; c < 128 * (kTileK / 16); c += sx::kThreads) {
    const int r = c / (kTileK / 16), ch = c % (kTileK / 16);
    sx::cp_async16(slot + r * kPitch + ch * 16, src + r * ld + ch * 16, true);
  }
}

// The m16n8k32 fragments of the 2 (M) x 4 (N) warp layout of
// sx::TileGemm<MmaS8, MF> over one [BM, 128] x [128, 128 B] step: A from
// resident codes (rows `pitch` apart, from byte `k0`), B from a ring slot.
template <int MF>
__device__ __forceinline__ void mma_tile(int (&acc)[MF][4][4],
                                         const uint8_t* sA, int pitch, int k0,
                                         const uint8_t* b) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int kc = 0; kc < kTileK; kc += 32) {
    uint32_t af[MF][4], bfr[4][2];
#pragma unroll
    for (int mi = 0; mi < MF; ++mi) {
      const uint8_t* p =
          sA + (wm * MF * 16 + mi * 16 + g) * pitch + k0 + kc + t * 4;
      af[mi][0] = *reinterpret_cast<const uint32_t*>(p);
      af[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * pitch);
      af[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
      af[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * pitch + 16);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const uint8_t* q = b + (wn * 32 + ni * 8 + g) * kPitch + kc + t * 4;
      bfr[ni][0] = *reinterpret_cast<const uint32_t*>(q);
      bfr[ni][1] = *reinterpret_cast<const uint32_t*>(q + 16);
    }
#pragma unroll
    for (int mi = 0; mi < MF; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        sx::MmaS8::mma(acc[mi][ni], af[mi], bfr[ni]);
  }
}

template <int MF>
__device__ __forceinline__ void zero(int (&acc)[MF][4][4]) {
#pragma unroll
  for (int mi = 0; mi < MF; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
}

// --- K13 -------------------------------------------------------------------

constexpr int kDenseSlots = 4;

template <int MF>
constexpr int dense_smem(int K) {
  return kDenseSlots * kTile + 2 * MF * 16 * (K + 16) + 2 * MF * 16 * 4;
}

// x [M, K] bf16, W [N, K] int8, ws [N], bias [N] f32 -> out [M, N] bf16.
// Block (bx, by) owns rows bx * BM .. and the output tiles by * per ..
// (128 columns each). The ring runs over (tile, slab of 128 bytes of K) in
// order, kDenseSlots - 1 tiles ahead; one barrier a weight tile.
template <int MF>
__global__ void __launch_bounds__(sx::kThreads)
    int8_dense_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ W,
                      const float* __restrict__ ws,
                      const float* __restrict__ bias, bf16* __restrict__ out,
                      int M, int K, int N, int per) {
  using G = sx::TileGemm<sx::MmaS8, MF>;
  constexpr int BM = G::BM;
  extern __shared__ __align__(16) uint8_t smem[];
  const int pitch = K + 16;
  uint8_t* sRing = smem;
  uint8_t* sA = smem + kDenseSlots * kTile;
  float* sXs = reinterpret_cast<float*>(sA + BM * pitch);
  const int m0 = blockIdx.x * BM;
  const int first = blockIdx.y * per;
  const int tiles = min(per, N / 128 - first);
  const int slabs = K / kTileK;
  const int total = tiles * slabs;

  auto fetch = [&](int T) {
    if (T < total)
      load_tile(sRing + (T % kDenseSlots) * kTile, W, K,
                (first + T / slabs) * 128, (T % slabs) * kTileK);
    sx::cp_async_commit();
  };
  for (int T = 0; T < kDenseSlots - 1; ++T) fetch(T);
  quantize_rows(x, M, K, m0, BM, sA, pitch, sXs);   // seen after a barrier

  int acc[MF][4][4];
  for (int T = 0; T < total; ++T) {
    const int slab = T % slabs;
    if (slab == 0) zero(acc);
    sx::cp_async_wait<kDenseSlots - 2>();
    __syncthreads();
    fetch(T + kDenseSlots - 1);
    mma_tile(acc, sA, pitch, slab * kTileK,
             sRing + (T % kDenseSlots) * kTile);
    if (slab != slabs - 1) continue;
    const int n0 = (first + T / slabs) * 128;
#pragma unroll
    for (int mi = 0; mi < MF; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = G::row(mi, 2 * half), n = n0 + G::col(ni, 2 * half);
          if (m0 + r >= M) continue;
          const float xs = sXs[r];
          float y0 = static_cast<float>(acc[mi][ni][2 * half]) * xs;
          float y1 = static_cast<float>(acc[mi][ni][2 * half + 1]) * xs;
          y0 = y0 * ws[n] + bias[n];
          y1 = y1 * ws[n + 1] + bias[n + 1];
          *reinterpret_cast<__nv_bfloat162*>(
              out + static_cast<long>(m0 + r) * N + n) =
              __floats2bfloat162_rn(y0, y1);
        }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

template <int MF>
cudaError_t launch_dense(const bf16* x, const int8_t* W, const float* ws,
                         const float* b, bf16* out, int M, int K, int N,
                         cudaStream_t stream) {
  constexpr int BM = 2 * MF * 16;
  const int row_blocks = (M + BM - 1) / BM;
  const int col_tiles = N / 128;
  // every column tile of its rows to one block, unless that leaves the
  // card's SMs short of two blocks each: then the columns are split
  int groups = (2 * sm_count() + row_blocks - 1) / row_blocks;
  groups = groups < 1 ? 1 : (groups > col_tiles ? col_tiles : groups);
  const int per = (col_tiles + groups - 1) / groups;
  groups = (col_tiles + per - 1) / per;
  const int smem = dense_smem<MF>(K);
  auto kernel = int8_dense_kernel<MF>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(row_blocks, groups), sx::kThreads, smem, stream>>>(
      x, W, ws, b, out, M, K, N, per);
  return cudaGetLastError();
}

// --- K14 -------------------------------------------------------------------

constexpr int kFfnSlots = 8;

template <int NT>
struct Ffn {
  static constexpr int BM = 32;
  static constexpr int H = 128 * NT;
  static constexpr int kAPitch = H + 16;
  static constexpr int kOffA = kFfnSlots * kTile;
  static constexpr int kOffG = kOffA + BM * kAPitch;      // codes of g
  static constexpr int kOffXs = kOffG + BM * kPitch;      // x's scales
  static constexpr int kOffMax = kOffXs + BM * 4;         // [4][BM] max|g|
  static constexpr int kOffGs = kOffMax + 4 * BM * 4;     // g's scales
  static constexpr int kSmem = kOffGs + BM * 4;           // 177,920 at NT 6
};

// x [M, H] bf16; W1 [F, H], W2 [H, F] int8; s1, b1 [F], s2, b2 [H] f32
// -> out [M, H] bf16. F % 128 == 0; any M. The ring of weight tiles runs
// over pass 1 (per chunk of 128 columns of F: the NT tiles of W1's rows
// f0 .. f0 + 127, K = H in slabs of 128 bytes) and pass 2 (per chunk: the
// same NT tiles of W1, then NT tiles of W2: rows 128 j .. 128 j + 127,
// bytes f0 .. f0 + 127), kFfnSlots - 1 tiles ahead, one barrier a tile. The
// first product lies 2 x 4 warps over the [32, 128] chunk; in the second,
// warp w owns rows 16 w .. 16 w + 15 of each tile of W2, that is the
// columns 128 j + 16 w + (0 .. 15) of the block's [32, H] sum.
template <int NT>
__global__ void __launch_bounds__(sx::kThreads, 1)
    int8_ffn_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ W1,
                    const float* __restrict__ s1, const float* __restrict__ b1,
                    const int8_t* __restrict__ W2,
                    const float* __restrict__ s2, const float* __restrict__ b2,
                    bf16* __restrict__ out, int M, int F) {
  using C = Ffn<NT>;
  using G = sx::TileGemm<sx::MmaS8, 1>;   // the first product's layout
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* sRing = smem;
  uint8_t* sA = smem + C::kOffA;
  uint8_t* sG = smem + C::kOffG;
  float* sXs = reinterpret_cast<float*>(smem + C::kOffXs);
  float* sMax = reinterpret_cast<float*>(smem + C::kOffMax);
  float* sGs = reinterpret_cast<float*>(smem + C::kOffGs);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.x * C::BM;
  const int chunks = F / 128;
  const int pass1 = chunks * NT;
  const int total = 3 * pass1;

  auto fetch = [&](int T) {
    if (T < total) {
      uint8_t* slot = sRing + (T % kFfnSlots) * kTile;
      const int u = T < pass1 ? T : T - pass1;
      const int per = T < pass1 ? NT : 2 * NT;
      const int chunk = u / per, r = u % per;
      if (r < NT)
        load_tile(slot, W1, C::H, chunk * 128, r * kTileK);
      else
        load_tile(slot, W2, F, (r - NT) * 128, chunk * kTileK);
    }
    sx::cp_async_commit();
  };
  auto next_tile = [&](int T) -> const uint8_t* {
    sx::cp_async_wait<kFfnSlots - 2>();
    __syncthreads();
    fetch(T + kFfnSlots - 1);
    return sRing + (T % kFfnSlots) * kTile;
  };
  // the first product of chunk f0, from tile T on
  auto first_product = [&](int (&acc)[1][4][4], int& T) {
    zero(acc);
    for (int k = 0; k < NT; ++k, ++T)
      mma_tile(acc, sA, C::kAPitch, k * kTileK, next_tile(T));
  };
  // g of accumulator element (ni, e) of chunk f0
  auto gelu_at = [&](const int (&acc)[1][4][4], int ni, int e, int f0) {
    const int r = G::row(0, e), c = f0 + G::col(ni, e);
    const float h = static_cast<float>(acc[0][ni][e]) * sXs[r];
    return sx::gelu_exact(h * s1[c] + b1[c]);
  };

  for (int T = 0; T < kFfnSlots - 1; ++T) fetch(T);
  quantize_rows(x, M, C::H, m0, C::BM, sA, C::kAPitch, sXs);

  // pass 1: each row's max |g| over all of F
  int T = 0;
  float rmax[2] = {0.0f, 0.0f};   // rows wm * 16 + g and + 8
  for (int f0 = 0; f0 < F; f0 += 128) {
    int acc[1][4][4];
    first_product(acc, T);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        rmax[e >> 1] = fmaxf(rmax[e >> 1], fabsf(gelu_at(acc, ni, e, f0)));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int o = 1; o < 4; o <<= 1)
      rmax[i] = fmaxf(rmax[i], __shfl_xor_sync(0xffffffffu, rmax[i], o));
  if (t == 0) {
    sMax[wn * C::BM + wm * 16 + g] = rmax[0];
    sMax[wn * C::BM + wm * 16 + g + 8] = rmax[1];
  }
  __syncthreads();
  if (threadIdx.x < C::BM) {
    float amax = sMax[threadIdx.x];
#pragma unroll
    for (int w = 1; w < 4; ++w)
      amax = fmaxf(amax, sMax[w * C::BM + threadIdx.x]);
    sGs[threadIdx.x] = row_scale(amax);
  }
  __syncthreads();

  // pass 2: the same g, coded with gs, into the second product
  int acc2[2][2 * NT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2 * NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[mi][ni][e] = 0;

  for (int f0 = 0; f0 < F; f0 += 128) {
    int acc[1][4][4];
    first_product(acc, T);
    // every warp has left the last chunk's second product: the barriers
    // of this chunk's first product lie between, so sG may be written
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = G::row(0, 2 * half), c = G::col(ni, 2 * half);
        const float gs = sGs[r];
        const int q0 = quantize(gelu_at(acc, ni, 2 * half, f0), gs);
        const int q1 = quantize(gelu_at(acc, ni, 2 * half + 1, f0), gs);
        *reinterpret_cast<uint16_t*>(sG + r * kPitch + c) =
            static_cast<uint16_t>((q0 & 0xff) | ((q1 & 0xff) << 8));
      }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NT; ++j, ++T) {
      const uint8_t* b = next_tile(T);
#pragma unroll
      for (int kc = 0; kc < kTileK; kc += 32) {
        uint32_t af[2][4], bfr[2][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const uint8_t* p = sG + (mi * 16 + g) * kPitch + kc + t * 4;
          af[mi][0] = *reinterpret_cast<const uint32_t*>(p);
          af[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kPitch);
          af[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
          af[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kPitch + 16);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const uint8_t* q = b + (warp * 16 + n * 8 + g) * kPitch + kc + t * 4;
          bfr[n][0] = *reinterpret_cast<const uint32_t*>(q);
          bfr[n][1] = *reinterpret_cast<const uint32_t*>(q + 16);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          sx::MmaS8::mma(acc2[0][2 * j + n], af[0], bfr[n]);
          sx::MmaS8::mma(acc2[1][2 * j + n], af[1], bfr[n]);
        }
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2 * NT; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = mi * 16 + g + half * 8;
        const int c = (ni >> 1) * 128 + warp * 16 + (ni & 1) * 8 + 2 * t;
        if (m0 + r >= M) continue;
        const float gs = sGs[r];
        float y0 = static_cast<float>(acc2[mi][ni][2 * half]) * gs;
        float y1 = static_cast<float>(acc2[mi][ni][2 * half + 1]) * gs;
        y0 = y0 * s2[c] + b2[c];
        y1 = y1 * s2[c + 1] + b2[c + 1];
        *reinterpret_cast<__nv_bfloat162*>(
            out + static_cast<long>(m0 + r) * C::H + c) =
            __floats2bfloat162_rn(y0, y1);
      }
}

template <int NT>
cudaError_t launch_ffn(const bf16* x, const int8_t* W1, const float* s1,
                       const float* b1, const int8_t* W2, const float* s2,
                       const float* b2, bf16* out, int M, int F,
                       cudaStream_t stream) {
  using C = Ffn<NT>;
  auto kernel = int8_ffn_kernel<NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<(M + C::BM - 1) / C::BM, sx::kThreads, C::kSmem, stream>>>(
      x, W1, s1, b1, W2, s2, b2, out, M, F);
  return cudaGetLastError();
}

}  // namespace

// K13; see int8_dense_kernel. K % 128 == 0 with 128 <= K <= 1024, N % 128
// == 0, any M >= 1 (checked by the Python wrapper; cudaErrorInvalidValue
// otherwise). Row blocks of 128, or 64 and 32 where the larger ones leave
// the card's SMs idle. Returns cudaGetLastError() after the launch.
extern "C" int sx_int8_dense(const void* x, const void* W, const float* ws,
                             const float* b, void* out, int M, int K, int N,
                             void* stream) {
  if (M < 1 || K < 128 || K > kMaxRow || K % 128 || N < 128 || N % 128)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const int8_t* w = static_cast<const int8_t*>(W);
  bf16* o = static_cast<bf16*>(out);
  const int tiles = N / 128;
  if (static_cast<long>((M + 127) / 128) * tiles >= sm_count())
    return launch_dense<4>(xb, w, ws, b, o, M, K, N, s);
  if (static_cast<long>((M + 63) / 64) * tiles >= sm_count())
    return launch_dense<2>(xb, w, ws, b, o, M, K, N, s);
  return launch_dense<1>(xb, w, ws, b, o, M, K, N, s);
}

// K14; see int8_ffn_kernel. H in 256 (the small width of the card tests),
// 768 and 1024 (the models' widths), F % 128 == 0, any M >= 1 (checked by
// the Python wrapper; cudaErrorInvalidValue otherwise). Returns
// cudaGetLastError() after the launch.
extern "C" int sx_int8_ffn(const void* x, const void* W1, const float* s1,
                           const float* b1, const void* W2, const float* s2,
                           const float* b2, void* out, int M, int H, int F,
                           void* stream) {
  if (M < 1 || F < 128 || F % 128) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SX_FFN(NT)                                                          \
  return launch_ffn<NT>(static_cast<const bf16*>(x),                        \
                        static_cast<const int8_t*>(W1), s1, b1,             \
                        static_cast<const int8_t*>(W2), s2, b2,             \
                        static_cast<bf16*>(out), M, F, s);
  switch (H) {
    case 256: SX_FFN(2)
    case 768: SX_FFN(6)
    case 1024: SX_FFN(8)
  }
#undef SX_FFN
  return cudaErrorInvalidValue;
}
