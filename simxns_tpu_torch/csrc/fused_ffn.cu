// K10 and K11: the backward of the BERT feed-forward block
// y = gelu(x W1^T + b1) W2^T + b2, in bf16 with f32 accumulation, from hb =
// bf16(x W1^T) + b1, the one residual its forward (K9, ffn_fwd.cu) keeps.
//
// They replace two Pallas kernels of simxns_tpu/ops/fused_ffn.py:
//   K10 ffn_bwd_dx     _ffn_bwd_dx_kernel    (:348)  -> (dx, dh)
//   K11 ffn_bwd_dw     _ffn_bwd_dw_kernel    (:374)  -> (dW1, db1, dW2)
// with their arithmetic: each product accumulated in f32; GELU and its
// derivative in f32 from the rounded pre-activation hb, with the
// Abramowitz-Stegun erf; dh rounded to bf16 before its second product; dW1,
// db1, dW2 in f32.
//
// K10 is a "chained" kernel: a first product dY W2 over H into a [32, 128]
// tile, dh = . * gelu'(hb) on it, and a second product dh W1 that adds the
// tile's contribution to the block's [32, H] result dx. Both contract over
// the weights' rows: the tiles land in shared memory as they lie in device
// memory and ldmatrix...trans transposes the fragments, so no weight is
// transposed in device memory. K10 reads hb once and writes dh once. The
// TPU kernel carries its [256, H] f32 sum in VMEM across sequential grid
// steps; here nothing carries between blocks, so one block owns 32 rows,
// keeps them in shared memory, and holds their whole [32, H] sum in
// registers (2 x H/64 x 4 floats a thread, 128 at H = 1024) while it loops
// over F in chunks of 128. Weights are read again by every block and stay
// in the 50 MB L2; they come through one ring of equal tiles that runs
// across both products and from chunk to chunk, up to seven tiles ahead of
// the one being multiplied.
//
// K11 contracts over M, the row index of all four activations: the tiles
// land in shared memory as they lie in device memory and ldmatrix...trans
// transposes the fragments (sx::TileGemmT). One block owns one [128, 128]
// tile of dW1 or of dW2 and loops over all of M: no atomics, no second
// pass, the same bits every run. gelu(hb) is applied to the tile in shared
// memory after it lands; db1 rides with the dW1 blocks of the first column
// of tiles.
//
// Bound on the card: operations (4 M H F flop per kernel against
// O(M (H + F)) bytes; 343.6 GFLOP at the CE-large step's M = 20,480, H =
// 1024, F = 4096). This cut runs mma.sync m16n8k16 fed by cp.async, and at
// 32 rows a block K10 is limited by the weight traffic from L2 (about 32
// flop per byte) and by the shared-memory reads of its fragments. K9 and
// K12 left this design for the pair of wgmma GEMMs of ffn_fwd.cu.
#include "tile_gemm.cuh"

SX_DEFINE_ERROR_STRING

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float2 ld_bf162(const void* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void st_bf162(void* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Shared memory of the chained kernel for H = 64 NT. Both products read
// their weights as one sequence of equal tiles, [128 outputs] x [64
// elements of K] (16 KB), through a ring of kSlots slots: per chunk of 128
// columns of F first the NT tiles of the first product (outputs f0 .. f0 +
// 127, K = H in slabs of 64), then the NT tiles of the second (128 of its H
// outputs, one half of the chunk's 128 K elements). A tile is 64 weight
// rows (of K) of 128 outputs, kTransPitch apart, in a slot of 128 rows of
// kTilePitch. The block's 32 rows of A stay resident.
template <int NT>
struct Chain {
  static constexpr int BM = 32;
  static constexpr int BF = 128;
  static constexpr int H = 64 * NT;
  static constexpr int kTileK = 128;                 // bytes of K per tile
  static constexpr int kTilePitch = kTileK + 16;     // 8 rows -> 32 banks
  static constexpr int kTile = 128 * kTilePitch;
  static constexpr int kTransPitch = 256 + 16;       // 8 rows -> 32 banks
  static_assert(64 * kTransPitch <= kTile, "a transposed tile fits a slot");
  static constexpr int kTilesPerChunk = 2 * NT;
  static constexpr int kSlots = 2 * NT < 8 ? 2 * NT : 8;   // a power of 2
  static constexpr int kAPitch = H * 2 + 16;
  static constexpr int kMidPitch = BF * 2 + 16;
  static constexpr int kMid = BM * kMidPitch;
  static constexpr int kOffMid = BM * kAPitch;
  static constexpr int kOffRes = kOffMid + kMid;
  static constexpr int kOffRing = kOffRes + kMid;
  static constexpr int kSmem = kOffRing + kSlots * kTile;   // 230,912 at NT 16
};

// A = dY [M, H], B1 = W2 [H, F], B2 = W1 [F, H] (contracted over their
// rows), res_in = hb [M, F]; out = dx [M, H], res_out = dh [M, F].
// F % 128 == 0; any M.
//
// One barrier a tile: tile T is waited for, the block meets, the load of
// tile T + kSlots - 1 goes into the slot tile T - 1 has just left, and
// every warp multiplies its part of tile T (16 mma each). In the first
// product the warps lie 2 x 4 over the [32, 128] tile; in the second, warp
// w owns rows 16 w .. 16 w + 15 of each 128-row tile of B2, that is the
// columns 128 j + 16 w + (0 .. 15) of the block's [32, H] result.
template <int NT>
__global__ void __launch_bounds__(sx::kThreads, 1)
    ffn_chain_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B1,
                     const bf16* __restrict__ B2,
                     const bf16* __restrict__ res_in, bf16* __restrict__ out,
                     bf16* __restrict__ res_out, int M, int F) {
  using C = Chain<NT>;
  using G = sx::TileGemm<sx::MmaBf16, 1>;   // the first product's layout
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* sA = smem;
  uint8_t* sMid = smem + C::kOffMid;   // dh: the second product's A
  uint8_t* sRes = smem + C::kOffRes;   // hb, on its way in
  uint8_t* sRing = smem + C::kOffRing;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  // the ldmatrix row of this lane within a [16 k][16 outputs] patch (the B
  // fragments of sx::TileGemmT)
  const int tb = ((lane & 7) + ((lane >> 3) & 1) * 8) * C::kTransPitch +
                 ((lane >> 4) & 1) * 16;
  const int m0 = blockIdx.x * C::BM;
  const int chunks = F / C::BF;
  const int total = chunks * C::kTilesPerChunk;

  auto load_res = [&](int chunk) {   // hb[m0 : m0 + 32, chunk's 128 columns]
    for (int c = threadIdx.x; c < C::BM * (C::BF / 8); c += sx::kThreads) {
      int r = c / (C::BF / 8), ch = c % (C::BF / 8);
      bool ok = m0 + r < M;
      const bf16* src = ok ? res_in + static_cast<long>(m0 + r) * F +
                                 chunk * C::BF + ch * 8
                           : res_in;
      sx::cp_async16(sRes + r * C::kMidPitch + ch * 16, src, ok);
    }
  };
  // the loads of tile T, one cp.async group (an empty one past the end)
  auto fetch = [&](int T) {
    if (T < total) {
      const int chunk = T / C::kTilesPerChunk, r = T % C::kTilesPerChunk;
      const int f0 = chunk * C::BF;
      const int h0 = ((r - NT) >> 1) * 128, k0 = ((r - NT) & 1) * 64;
      // 64 rows of K, 128 outputs along each
      const bf16* src = r < NT ? B1 + static_cast<long>(r * 64) * F + f0
                               : B2 + static_cast<long>(f0 + k0) * C::H + h0;
      const long ld = r < NT ? F : C::H;
      uint8_t* slot = sRing + (T % C::kSlots) * C::kTile;
      for (int c = threadIdx.x; c < 1024; c += sx::kThreads) {
        int row = c / 16, ch = c % 16;   // 16-byte chunks a row
        sx::cp_async16(slot + row * C::kTransPitch + ch * 16,
                       src + row * ld + ch * 8, true);
      }
    }
    sx::cp_async_commit();
  };
  // Tile T, landed and seen by the whole block. `res_chunk` >= 0 (at the
  // first tile of a second product, after the barrier behind which this
  // chunk's hb was read) also loads hb of that chunk; it has landed
  // kSlots - 1 <= 2 NT - 1 tiles later, before it is read.
  auto next_tile = [&](int T, int res_chunk) -> const uint8_t* {
    sx::cp_async_wait<C::kSlots - 2>();
    __syncthreads();
    if (res_chunk >= 0 && res_chunk < chunks) load_res(res_chunk);
    fetch(T + C::kSlots - 1);
    return sRing + (T % C::kSlots) * C::kTile;
  };

  for (int c = threadIdx.x; c < C::BM * (C::H / 8); c += sx::kThreads) {
    int r = c / (C::H / 8), ch = c % (C::H / 8);
    bool ok = m0 + r < M;
    const bf16* src = ok ? A + static_cast<long>(m0 + r) * C::H + ch * 8 : A;
    sx::cp_async16(sA + r * C::kAPitch + ch * 16, src, ok);
  }
  load_res(0);
  for (int T = 0; T < C::kSlots - 1; ++T) fetch(T);   // A and hb: group 0

  float acc2[2][NT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[mi][ni][e] = 0.0f;

  int T = 0;
  for (int f0 = 0; f0 < F; f0 += C::BF) {
    float acc1[4][4];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc1[ni][e] = 0.0f;
    for (int k = 0; k < NT; ++k, ++T) {
      const uint8_t* b = next_tile(T, -1);
      const uint8_t* a = sA + (wm * 16 + g) * C::kAPitch + k * C::kTileK;
#pragma unroll
      for (int kc = 0; kc < C::kTileK; kc += 32) {
        const uint8_t* p = a + kc + t * 4;
        const uint32_t af[4] = {
            *reinterpret_cast<const uint32_t*>(p),
            *reinterpret_cast<const uint32_t*>(p + 8 * C::kAPitch),
            *reinterpret_cast<const uint32_t*>(p + 16),
            *reinterpret_cast<const uint32_t*>(p + 8 * C::kAPitch + 16)};
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          uint32_t r[4];
          sx::ldmatrix_x4_trans(r, b + (kc / 2) * C::kTransPitch +
                                       (wn * 32 + nj * 16) * 2 + tb);
          const uint32_t lo[2] = {r[0], r[1]}, hi[2] = {r[2], r[3]};
          sx::MmaBf16::mma(acc1[2 * nj], af, lo);
          sx::MmaBf16::mma(acc1[2 * nj + 1], af, hi);
        }
      }
    }

#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = G::row(0, 2 * half), c = G::col(ni, 2 * half);
        const float v0 = acc1[ni][2 * half], v1 = acc1[ni][2 * half + 1];
        const float2 h = ld_bf162(sRes + r * C::kMidPitch + c * 2);
        st_bf162(sMid + r * C::kMidPitch + c * 2, v0 * sx::gelu_grad(h.x),
                 v1 * sx::gelu_grad(h.y));
      }
    __syncthreads();

    // dh to device memory, coalesced
    for (int c = threadIdx.x; c < C::BM * (C::BF / 8); c += sx::kThreads) {
      int r = c / (C::BF / 8), ch = c % (C::BF / 8);
      if (m0 + r < M)
        *reinterpret_cast<uint4*>(res_out + static_cast<long>(m0 + r) * F +
                                  f0 + ch * 8) =
            *reinterpret_cast<const uint4*>(sMid + r * C::kMidPitch + ch * 16);
    }

    // second product: acc2 += dh[32, 128] * B2[:, f0 : f0 + 128]^T
#pragma unroll
    for (int r2 = 0; r2 < NT; ++r2, ++T) {
      const uint8_t* b = next_tile(T, r2 == 0 ? f0 / C::BF + 1 : -1);
#pragma unroll
      for (int kc = 0; kc < C::kTileK; kc += 32) {
        uint32_t af[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const uint8_t* p = sMid + (mi * 16 + g) * C::kMidPitch +
                             (r2 & 1) * C::kTileK + kc + t * 4;
          af[mi][0] = *reinterpret_cast<const uint32_t*>(p);
          af[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * C::kMidPitch);
          af[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
          af[mi][3] =
              *reinterpret_cast<const uint32_t*>(p + 8 * C::kMidPitch + 16);
        }
        uint32_t bfr[2][2];
        {
          uint32_t r[4];
          sx::ldmatrix_x4_trans(
              r, b + (kc / 2) * C::kTransPitch + warp * 16 * 2 + tb);
          bfr[0][0] = r[0], bfr[0][1] = r[1];
          bfr[1][0] = r[2], bfr[1][1] = r[3];
        }
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          sx::MmaBf16::mma(acc2[0][(r2 >> 1) * 2 + n], af[0], bfr[n]);
          sx::MmaBf16::mma(acc2[1][(r2 >> 1) * 2 + n], af[1], bfr[n]);
        }
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + mi * 16 + g + half * 8;
        const int c = (ni >> 1) * 128 + warp * 16 + (ni & 1) * 8 + 2 * t;
        if (r >= M) continue;
        st_bf162(out + static_cast<long>(r) * C::H + c,
                 acc2[mi][ni][2 * half], acc2[mi][ni][2 * half + 1]);
      }
}

template <int NT>
cudaError_t launch_chain(const bf16* A, const bf16* B1, const bf16* B2,
                         const bf16* res_in, bf16* out, bf16* res_out, int M,
                         int F, cudaStream_t stream) {
  using C = Chain<NT>;
  auto kernel = ffn_chain_kernel<NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<(M + C::BM - 1) / C::BM, sx::kThreads, C::kSmem, stream>>>(
      A, B1, B2, res_in, out, res_out, M, F);
  return cudaGetLastError();
}

// --- K11 ---------------------------------------------------------------------

struct ColumnSums {   // db1: the column sums of the P tile (dh), in f32
  static constexpr bool kWrites = false;
  float sum;
  bool on;
  __device__ void operator()(uint8_t* sP, uint8_t*) {
    if (!on || threadIdx.x >= sx::TileGemmT::BT) return;
    for (int r = 0; r < sx::TileGemmT::BK; ++r)
      sum += __bfloat162float(*reinterpret_cast<const bf16*>(
          sP + r * sx::TileGemmT::kPitch + threadIdx.x * 2));
  }
};

struct GeluOfQ {   // the Q tile (hb) becomes g = bf16(gelu(f32(hb))) in place
  static constexpr bool kWrites = true;
  __device__ void operator()(uint8_t*, uint8_t* sQ) {
    using T = sx::TileGemmT;
    for (int c = threadIdx.x; c < T::BK * (T::BT / 8); c += sx::kThreads) {
      uint8_t* p = sQ + (c / (T::BT / 8)) * T::kPitch + (c % (T::BT / 8)) * 16;
      uint4 v = *reinterpret_cast<const uint4*>(p);
      __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 h = __bfloat1622float2(e[i]);
        e[i] = __floats2bfloat162_rn(sx::gelu_exact(h.x), sx::gelu_exact(h.y));
      }
      *reinterpret_cast<uint4*>(p) = v;
    }
  }
};

__device__ void store_tile(const float (&acc)[4][4][4], float* out, long ld,
                           int r0, int c0) {
  using T = sx::TileGemmT;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + T::row(mi, 2 * half), c = c0 + T::col(ni, 2 * half);
        *reinterpret_cast<float2*>(out + static_cast<long>(r) * ld + c) =
            make_float2(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
      }
}

// x, dy [M, H]; hb, dh [M, F]; dw1 [F, H], db1 [F], dw2 [H, F] f32.
// H % 128 == 0, F % 128 == 0, any M. Even blocks take a tile of dW1, odd
// blocks a tile of dW2, so both kinds share each SM.
__global__ void __launch_bounds__(sx::kThreads, 2)
    ffn_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                  const bf16* __restrict__ hb, const bf16* __restrict__ dh,
                  float* __restrict__ dw1, float* __restrict__ db1,
                  float* __restrict__ dw2, int M, int H, int F) {
  using T = sx::TileGemmT;
  extern __shared__ __align__(16) uint8_t smem[];
  const int idx = blockIdx.x >> 1;
  const int th = H / T::BT, tf = F / T::BT;
  float acc[4][4][4];
  if ((blockIdx.x & 1) == 0) {
    // dW1[f, h] = sum_m dh[m, f] x[m, h]
    const int rt = idx / th, ct = idx % th;
    ColumnSums hook{0.0f, ct == 0};
    T::run(acc, smem, dh, F, rt * T::BT, x, H, ct * T::BT, M, hook);
    store_tile(acc, dw1, H, rt * T::BT, ct * T::BT);
    if (ct == 0 && threadIdx.x < T::BT)
      db1[rt * T::BT + threadIdx.x] = hook.sum;
  } else {
    // dW2[h, f] = sum_m dy[m, h] g[m, f]
    const int rt = idx / tf, ct = idx % tf;
    GeluOfQ hook;
    T::run(acc, smem, dy, H, rt * T::BT, hb, F, ct * T::BT, M, hook);
    store_tile(acc, dw2, F, rt * T::BT, ct * T::BT);
  }
}

}  // namespace

// K10; see ffn_chain_kernel. dy [M, H], W1 [F, H], W2 [H, F], hb [M, F]
// bf16 -> dx [M, H], dh [M, F] bf16. H in 256 (the small width of the card
// tests), 768 and 1024 (the models' widths) and F % 128 == 0 (checked by
// the Python wrapper; cudaErrorInvalidValue otherwise). Returns
// cudaGetLastError() after the launch.
extern "C" int sx_ffn_bwd_dx(const void* dy, const void* W1, const void* W2,
                             const void* hb, void* dx, void* dh, int M, int H,
                             int F, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || F % 128 || F < 128) return cudaErrorInvalidValue;
#define SX_CHAIN(NT)                                                         \
    return launch_chain<NT>(                                                 \
        static_cast<const bf16*>(dy), static_cast<const bf16*>(W2),          \
        static_cast<const bf16*>(W1), static_cast<const bf16*>(hb),          \
        static_cast<bf16*>(dx), static_cast<bf16*>(dh), M, F, s);
  switch (H) {
    case 256: SX_CHAIN(4)
    case 768: SX_CHAIN(12)
    case 1024: SX_CHAIN(16)
  }
#undef SX_CHAIN
  return cudaErrorInvalidValue;
}

// K11; see ffn_dw_kernel.
extern "C" int sx_ffn_bwd_dw(const void* x, const void* dy, const void* hb,
                             const void* dh, float* dw1, float* db1,
                             float* dw2, int M, int H, int F, void* stream) {
  using T = sx::TileGemmT;
  if (M < 1 || H % 128 || H < 128 || F % 128 || F < 128)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ffn_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  const int blocks = 2 * (H / T::BT) * (F / T::BT);
  ffn_dw_kernel<<<blocks, sx::kThreads, T::kSmem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
      static_cast<const bf16*>(hb), static_cast<const bf16*>(dh), dw1, db1,
      dw2, M, H, F);
  return cudaGetLastError();
}
