// The persistent Hopper GEMM that K1 (int8_linear.cu), K9 and K12
// (ffn_fwd.cu), K13 and K14 (int8_ffn.cu) run on:
//   out[M, N] = epilogue(A[M, K] W[N, K]^T)
// with A and W K-major (the nn.Linear layout), int8 with exact s32 sums or
// bf16 with f32 sums, on the pieces of wgmma_ring.cuh:
// - a block owns BM x BN output tiles: 128 x 256 (two consumer warpgroups of
//   64 rows, 128 accumulators a thread) where that gives two waves of tiles
//   on the card's SMs, else 64 x 128 where that fills the SMs, else 64 x 64
//   (one consumer warpgroup). The caller chooses (ops/_native.py:
//   wgmma_tile);
// - one producer thread (its warpgroup hands registers to the consumers by
//   setmaxnreg) keeps a ring of 4 stages of 128 bytes of K full with TMA
//   copies (128-byte swizzle; rows and K past the edges land as zeros);
// - a persistent grid (one block an SM) walks the tiles with N fastest, so
//   the blocks in flight share A's row blocks in L2 and the producer loads
//   the next tile while the consumers store this one;
// - the epilogue stages column slices of each warpgroup's 64 rows in shared
//   memory and writes them as 16-byte row pieces (masked at the edges); its
//   per-column vectors land in shared memory (cp.async) during the
//   products. It is operation for operation the plain PyTorch version's
//   under --fmad=false.
//
// The epilogues (Epilogue below):
// - kDequant: (f32(acc) * xs[m]) * ws[n] + b[n], then GELU if asked, f32 or
//   bf16 (K1; K13; K14's two GEMMs, the first also writing each row's max
//   |g| over its tile, ROWMAX);
// - kBias: hb = bf16(bf16(acc) + b[n]) with bf16 b (K9, K12), then GELU if
//   asked: the first GEMM of K9 and K12 stores g = bf16(gelu(hb)), and K9's
//   (PRE) also stores hb, its residual for the backward (already a bf16
//   value: no second rounding), straight from the accumulator fragments,
//   4 bytes a lane (H100, K9 at the CE-large step: its GEMM 1 0.55 ms, 0.95
//   with hb staged beside g in the same slices, 1.09-1.10 in a pass of its
//   own before the GELU pass; scripts/torch_kernel_bench.py, in turns).
#pragma once

#include <cuda_bf16.h>
#include <stdio.h>

#include "tile_gemm.cuh"     // gelu_exact, the port's one GELU
#include "wgmma_ring.cuh"

namespace sx {
namespace gemm {
// Internal linkage: each library (int8_linear, int8_ffn, ffn_fwd) keeps
// its own instances. Shared template instances would bind across the
// loaded libraries, and one library would launch a kernel whose shared
// memory limit only the other had set (cudaErrorInvalidValue).
namespace {

namespace wg = sx::wg;
using bf16 = __nv_bfloat16;

constexpr int kBK = wg::kSwizzleBytes;   // K bytes a stage
constexpr int kStages = 4;
// The epilogue stages a slice of each output row at a time: 128 bytes, or
// 32 under GELU, whose ~35 operations an element run faster in narrower
// slices (H100, the chunk's ffn_in: 2.30 ms at 256 bytes, 1.84 at 128, 1.40
// at 64, 1.37 at 32; the GEMMs without GELU 5-7% slower at 64 than at 128).
// A staged row is padded so that the rows of a warp's fragment stores (8
// bytes a lane for f32, 4 for bf16) fall on distinct banks or, for 32-byte
// f32 slices, on at most two.
constexpr int kSliceLinear = 128, kSliceGelu = 32;
__host__ __device__ constexpr int staged_pitch(int slice, bool bf16) {
  return slice + (bf16 || slice < 64 ? 16 : 32);
}
// registers a thread: a 384-thread block is launched with 168 (65,536 /
// 384, rounded down to 8); setmaxnreg moves them from the producer's
// warpgroup to the two consumers'
constexpr int kLaunchRegs = 168, kProducerRegs = 40, kConsumerRegs = 232;
static_assert(kProducerRegs * 128 + kConsumerRegs * 256 == kLaunchRegs * 384,
              "setmaxnreg must move registers, not create them");

// errors beyond the CUDA runtime's codes
constexpr int kNoEncoder = -1;            // no cuTensorMapEncodeTiled
constexpr int kRegisterBudget = -2;       // launch registers != kLaunchRegs
constexpr int kBadTile = -3;              // a tile this library has not built
constexpr int kEncodeFailed = -1000;      // - CUresult of the encode

inline const char* error_string(int code) {
  static char msg[160];
  if (code == kNoEncoder)
    return "cuTensorMapEncodeTiled not found through the driver entry point";
  if (code == kRegisterBudget)
    return "the kernel was not built with 168 registers a thread at launch "
           "(setmaxnreg needs them)";
  if (code == kBadTile)
    return "no kernel for this tile (128 x 256, 64 x 128 and 64 x 64 exist)";
  if (code <= kEncodeFailed) {
    snprintf(msg, sizeof(msg), "cuTensorMapEncodeTiled failed (CUresult %d)",
             kEncodeFailed - code);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

enum Epilogue { kDequant = 0, kBias = 1 };

struct Args {
  const float* xs = nullptr;     // kDequant: [M] row scales of A's codes
  const float* ws = nullptr;     // kDequant: [N] column scales
  const void* bias = nullptr;    // [N] f32 (bf16 for kBias)
  void* out = nullptr;           // [M, N] f32 or bf16
  float* row_max = nullptr;      // ROWMAX: [M, tiles_n] max |out| a tile
  void* pre = nullptr;           // PRE: [M, N] bf16 (N even), kBias's value
                                 // before GELU
};

template <int WGS, int BN>
struct Cfg {   // WGS consumer warpgroups of 64 rows, BN columns a tile
  static constexpr int BM = 64 * WGS;
  // two consumers take registers from a whole producer warpgroup; one
  // needs no more than a launch gives it, and a producer warp suffices
  static constexpr int kThreads = WGS == 2 ? 384 : 160;
  static constexpr int kStageA = BM * kBK, kStageB = BN * kBK;
  // a consumer's staged output rows, then its copy of the tile's column
  // vectors
  static constexpr int kStaging =
      64 * staged_pitch(kSliceLinear, false) + 2 * BN * 4;
  static constexpr int kSmem = 1024 + kStages * (kStageA + kStageB) +
                               WGS * kStaging + 2 * kStages * 8;
};

template <bool BF16, int BN>
struct Mma;

template <int BN>
struct Mma<false, BN> {
  using Acc = int;
  __device__ __forceinline__ static void mma(int (&d)[BN / 2], uint64_t a,
                                             uint64_t b) {
    wg::WgmmaS8<BN>::mma(d, a, b, 1);
  }
};

template <int BN>
struct Mma<true, BN> {
  using Acc = float;
  __device__ __forceinline__ static void mma(float (&d)[BN / 2], uint64_t a,
                                             uint64_t b) {
    wg::WgmmaBf16<BN>::mma(d, a, b, 1);
  }
};

// f32 -> bf16 -> f32: the rounding of a product before its bias
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int WGS, int BN, int EPI, bool GELU, bool OUT_BF16, bool ROWMAX,
          bool PRE>
__global__ void __launch_bounds__(Cfg<WGS, BN>::kThreads, 1)
    gemm_kernel(__grid_constant__ const CUtensorMap map_a,
                __grid_constant__ const CUtensorMap map_w, const Args args,
                int M, int N, int K, int tiles_n, int n_tiles) {
  using C = Cfg<WGS, BN>;
  using Op = Mma<EPI == kBias, BN>;
  using Acc = typename Op::Acc;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: stages start on that
  uint8_t* smem = smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sa = smem;                             // [kStages][BM][128]
  uint8_t* sb = sa + kStages * C::kStageA;        // [kStages][BN][128]
  uint8_t* staging = sb + kStages * C::kStageB;   // [WGS][kStaging]
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + WGS * C::kStaging);
  uint64_t* empty = full + kStages;
  const int role = threadIdx.x / 128;   // < WGS: consumer; WGS: producer
  const int nk = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(full + s, 1);
      wg::mbar_init(empty + s, WGS);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (role == WGS) {
    // producer: one thread keeps the ring full
    if (WGS == 2) wg::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == WGS * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * C::BM, n0 = (tile % tiles_n) * BN;
        for (int kt = 0; kt < nk; ++kt) {
          wg::mbar_wait(empty + stage, phase ^ 1);
          wg::mbar_arrive_expect_tx(full + stage, C::kStageA + C::kStageB);
          wg::tma_load_2d(sa + stage * C::kStageA, &map_a, full + stage,
                          kt * kBK, m0);
          wg::tma_load_2d(sb + stage * C::kStageB, &map_w, full + stage,
                          kt * kBK, n0);
          if (++stage == kStages) stage = 0, phase ^= 1;
        }
      }
    }
    return;
  }

  // consumer warpgroup `role`: rows 64 role .. + 63 of every tile
  if (WGS == 2) wg::setmaxnreg_inc<kConsumerRegs>();
  constexpr int kElt = OUT_BF16 ? 2 : 4;
  constexpr int kSlice = GELU ? kSliceGelu : kSliceLinear;
  // columns of a staged slice, and its 16-byte pieces a row
  constexpr int kCols = kSlice / kElt < BN ? kSlice / kElt : BN;
  constexpr int kPieces = kCols * kElt / 16;
  constexpr int kPitch = staged_pitch(kCols * kElt, OUT_BF16);
  static_assert(!PRE || (EPI == kBias && GELU && OUT_BF16),
                "PRE stores kBias's bf16 value before its GELU");
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  uint8_t* stg = staging + role * C::kStaging;
  float* tile_ws = reinterpret_cast<float*>(
      stg + 64 * staged_pitch(kSliceLinear, false));   // [BN]
  float* tile_b = tile_ws + BN;           // [BN] f32, or bf16 (kBias)
  const bool rows_16b = (static_cast<long long>(N) * kElt) % 16 == 0;
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = (tile / tiles_n) * C::BM + role * 64;
    const int tn = tile % tiles_n, n0 = tn * BN;
    // the epilogue's column vectors, in flight during the products (16
    // bytes a copy, zeros past N)
    if (EPI == kBias) {
      if (tid < BN / 8) {
        const int c = tid * 8, n_real = N - n0 - c;
        wg::cp_async16(reinterpret_cast<bf16*>(tile_b) + c,
                       static_cast<const bf16*>(args.bias) + n0 +
                           (n_real > 0 ? c : 0),
                       n_real >= 8 ? 16 : (n_real > 0 ? 2 * n_real : 0));
      }
    } else if (tid < BN / 2) {
      const int c = (tid % (BN / 4)) * 4;
      const int n_real = N - n0 - c;   // of these 4 columns
      const float* src =
          tid < BN / 4 ? args.ws : static_cast<const float*>(args.bias);
      wg::cp_async16((tid < BN / 4 ? tile_ws : tile_b) + c,
                     src + n0 + (n_real > 0 ? c : 0),
                     n_real >= 4 ? 16 : (n_real > 0 ? 4 * n_real : 0));
    }
    wg::cp_async_commit();
    const int ra = m0 + warp * 16 + g, rb = ra + 8;
    const float xa = EPI == kDequant && ra < M ? args.xs[ra] : 0.0f;
    const float xb = EPI == kDequant && rb < M ? args.xs[rb] : 0.0f;
    Acc acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = Acc(0);
    wg::fence_operands(acc);
    int prev = -1;
    for (int kt = 0; kt < nk; ++kt) {
      wg::mbar_wait(full + stage, phase);
      wg::wgmma_fence();
      const uint64_t da = wg::desc_k128(sa + stage * C::kStageA + role * 64 * kBK);
      const uint64_t db = wg::desc_k128(sb + stage * C::kStageB);
#pragma unroll
      for (int j = 0; j < kBK / 32; ++j) Op::mma(acc, da + 2 * j, db + 2 * j);
      wg::wgmma_commit();
      // the previous stage's products are done: hand it back
      wg::wgmma_wait<1>();
      if (prev >= 0 && tid == 0) wg::mbar_arrive(empty + prev);
      prev = stage;
      if (++stage == kStages) stage = 0, phase ^= 1;
    }
    wg::wgmma_wait<0>();
    wg::fence_operands(acc);
    if (prev >= 0 && tid == 0) wg::mbar_arrive(empty + prev);

    // epilogue in slices of kCols columns through this warpgroup's
    // staging rows
    wg::cp_async_wait_all();
    wg::named_sync(1 + role, 128);
    float max_a = 0.0f, max_b = 0.0f;   // ROWMAX: rows ra and rb
#pragma unroll
    for (int c0 = 0; c0 < BN; c0 += kCols) {
#pragma unroll
      for (int cc = 0; cc < kCols / 8; ++cc) {
        const int c = c0 / 8 + cc;   // n8 column block of the tile
        float y[4], pre[4];
        if (EPI == kBias) {
          const float2 b2 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  reinterpret_cast<const bf16*>(tile_b) + c * 8 + 2 * t));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            y[e] = round_bf16(round_bf16(static_cast<float>(acc[4 * c + e])) +
                              (e & 1 ? b2.y : b2.x));
            if (PRE) pre[e] = y[e];
            if (GELU) y[e] = gelu_exact(y[e]);
          }
        } else {
          const float2 w2 = *reinterpret_cast<const float2*>(tile_ws + c * 8 + 2 * t);
          const float2 b2 = *reinterpret_cast<const float2*>(tile_b + c * 8 + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            y[e] = static_cast<float>(acc[4 * c + e]) * (e < 2 ? xa : xb);
            y[e] = y[e] * (e & 1 ? w2.y : w2.x) + (e & 1 ? b2.y : b2.x);
            if (GELU) y[e] = gelu_exact(y[e]);
          }
        }
        if (ROWMAX) {
          max_a = fmaxf(max_a, fmaxf(fabsf(y[0]), fabsf(y[1])));
          max_b = fmaxf(max_b, fmaxf(fabsf(y[2]), fabsf(y[3])));
        }
        uint8_t* pa = stg + (warp * 16 + g) * kPitch + (cc * 8 + 2 * t) * kElt;
        uint8_t* pb = pa + 8 * kPitch;
        if (OUT_BF16) {
          *reinterpret_cast<__nv_bfloat162*>(pa) = __floats2bfloat162_rn(y[0], y[1]);
          *reinterpret_cast<__nv_bfloat162*>(pb) = __floats2bfloat162_rn(y[2], y[3]);
        } else {
          *reinterpret_cast<float2*>(pa) = make_float2(y[0], y[1]);
          *reinterpret_cast<float2*>(pb) = make_float2(y[2], y[3]);
        }
        if (PRE) {   // hb from the fragment: rows ra, rb; N is even
          const int n = n0 + c * 8 + 2 * t;
          bf16* hb = static_cast<bf16*>(args.pre);
          if (n < N && ra < M)
            *reinterpret_cast<__nv_bfloat162*>(
                hb + static_cast<long long>(ra) * N + n) =
                __floats2bfloat162_rn(pre[0], pre[1]);
          if (n < N && rb < M)
            *reinterpret_cast<__nv_bfloat162*>(
                hb + static_cast<long long>(rb) * N + n) =
                __floats2bfloat162_rn(pre[2], pre[3]);
        }
      }
      wg::named_sync(1 + role, 128);
      // 64 rows x kPieces pieces of 16 bytes
#pragma unroll
      for (int i = 0; i < 64 * kPieces / 128; ++i) {
        const int p = tid + 128 * i, r = p / kPieces, q = p % kPieces;
        const long long m = m0 + r;
        const int n = n0 + c0 + q * (16 / kElt);
        if (m >= M || n >= N) continue;
        const uint4 v = *reinterpret_cast<const uint4*>(stg + r * kPitch + q * 16);
        uint8_t* dst = static_cast<uint8_t*>(args.out) + (m * N + n) * kElt;
        if (rows_16b && n + 16 / kElt <= N) {
          *reinterpret_cast<uint4*>(dst) = v;
        } else {
          const uint8_t* src = reinterpret_cast<const uint8_t*>(&v);
          for (int e = 0; e < 16 / kElt && n + e < N; ++e)
            for (int byte = 0; byte < kElt; ++byte)
              dst[e * kElt + byte] = src[e * kElt + byte];
        }
      }
      wg::named_sync(1 + role, 128);
    }
    if (ROWMAX) {
      // a row's columns of the tile lie in the 4 lanes of its quad
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        max_a = fmaxf(max_a, __shfl_xor_sync(0xffffffffu, max_a, o));
        max_b = fmaxf(max_b, __shfl_xor_sync(0xffffffffu, max_b, o));
      }
      if (t == 0 && ra < M)
        args.row_max[static_cast<long long>(ra) * tiles_n + tn] = max_a;
      if (t == 0 && rb < M)
        args.row_max[static_cast<long long>(rb) * tiles_n + tn] = max_b;
    }
  }
}

inline int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  return n;
}

// Set a kernel's shared memory and read its occupancy once. A kernel that
// moves registers with setmaxnreg must be launched with kLaunchRegs a
// thread: with fewer, setmaxnreg.inc would wait forever, so that launch is
// refused instead.
template <class Kernel>
int prepare(Kernel kernel, int smem, int threads, bool moves_registers,
            int* blocks_per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (moves_registers) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (attr.numRegs != kLaunchRegs) return kRegisterBudget;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                      threads, smem);
  return static_cast<int>(err);
}

// One launch; K in bytes of a row of A and W (2 x the elements for bf16;
// % 16 == 0, 16-byte aligned A and W).
template <int WGS, int BN, int EPI, bool GELU, bool OUT_BF16, bool ROWMAX,
          bool PRE>
int launch(const void* A, const void* W, const Args& args, int M, int N,
           int K, cudaStream_t stream) {
  using C = Cfg<WGS, BN>;
  auto kernel = gemm_kernel<WGS, BN, EPI, GELU, OUT_BF16, ROWMAX, PRE>;
  static int blocks_per_sm = 0;
  static const int prepared =
      prepare(kernel, C::kSmem, C::kThreads, WGS == 2, &blocks_per_sm);
  if (prepared != 0) return prepared;
  wg::EncodeTiled encode = wg::encode_tiled();
  if (encode == nullptr) return kNoEncoder;
  CUtensorMap map_a, map_w;
  CUresult res = wg::map_2d(&map_a, encode, A, M, K, C::BM);
  if (res == CUDA_SUCCESS) res = wg::map_2d(&map_w, encode, W, N, K, BN);
  if (res != CUDA_SUCCESS) return kEncodeFailed - static_cast<int>(res);
  const int tiles_n = (N + BN - 1) / BN;
  const long long n_tiles =
      static_cast<long long>((M + C::BM - 1) / C::BM) * tiles_n;
  if (n_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // persistent: at most one wave of resident blocks walks the tiles
  const long long wave = static_cast<long long>(sm_count()) * blocks_per_sm;
  const int grid = static_cast<int>(n_tiles < wave ? n_tiles : wave);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(
      map_a, map_w, args, M, N, K, tiles_n, static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

// The launch for tile (bm, bn): 128 x 256, 64 x 128 or 64 x 64.
template <int EPI, bool GELU, bool OUT_BF16, bool ROWMAX, bool PRE = false>
int run(int bm, int bn, const void* A, const void* W, const Args& args,
        int M, int N, int K, cudaStream_t s) {
  if (bm == 128 && bn == 256)
    return launch<2, 256, EPI, GELU, OUT_BF16, ROWMAX, PRE>(A, W, args, M, N,
                                                            K, s);
  if (bm == 64 && bn == 128)
    return launch<1, 128, EPI, GELU, OUT_BF16, ROWMAX, PRE>(A, W, args, M, N,
                                                            K, s);
  if (bm == 64 && bn == 64)
    return launch<1, 64, EPI, GELU, OUT_BF16, ROWMAX, PRE>(A, W, args, M, N,
                                                           K, s);
  return kBadTile;
}

}  // namespace
}  // namespace gemm
}  // namespace sx
