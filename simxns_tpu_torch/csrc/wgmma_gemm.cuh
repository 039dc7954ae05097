// The persistent Hopper GEMM that K1 (int8_linear.cu), K4
// (mips_candidates.cu), K9 and K12 (ffn_fwd.cu), K10 and K11 (fused_ffn.cu),
// K13 and K14 (int8_ffn.cu) run on:
//   out[M, N] = epilogue(A W^T) over K,
// int8 with exact s32 sums or bf16 with f32 sums, on the pieces of
// wgmma_ring.cuh:
// - operands K-major ([M][K], [N][K]: the nn.Linear layout), or for bf16
//   MN-major, each a template flag (A_MN, B_MN): stored [K][M] / [K][N],
//   landed by TMA as atoms of 64 values along MN x 64 rows of K and read by
//   wgmma with its transpose immediates, so nothing is transposed in device
//   memory (K10 contracts over the weights' rows, K11 over the activations'
//   rows);
// - a block owns BM x BN output tiles: 128 x 256 (two consumer warpgroups of
//   64 rows, 128 accumulators a thread), 64 x 128 or 64 x 64 (one consumer
//   warpgroup). The caller chooses
//   (ops/_native.py: wgmma_tile, dw_tile for K11's long K, mips_tile);
// - one producer thread (its warpgroup hands registers to the consumers by
//   setmaxnreg) keeps a ring of 4 stages of 128 bytes of K full with TMA
//   copies (128-byte swizzle; rows and K past the edges land as zeros);
// - a persistent grid (one block an SM) walks the tiles with N fastest, so
//   the blocks in flight share A's row blocks in L2 and the producer loads
//   the next tile while the consumers store this one. One launch may walk
//   the tiles of two products (K11's dW1 and dW2) and cut K into splits,
//   each writing its own partial output (row_sums_kernel adds them in
//   order: the same bits every run). That walk is the MULTI flag: with it
//   in every instance, K1 and K14 ran 2-3% slower at the encode chunk
//   (H100, scripts/torch_kernel_bench.py, in turns), so a single
//   product's walk is compiled without it. K4's bucket epilogues walk with
//   M fastest instead (also compiled in, not a runtime branch): the blocks
//   in flight take every query tile of one corpus tile back to back, so the
//   corpus comes from device memory once and from L2 for the other query
//   tiles;
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
//   own before the GELU pass; scripts/torch_kernel_bench.py, in turns);
// - kPlain: f32(acc), stored f32 or rounded to bf16 (K10's GEMM 2, K11);
// - kGeluBwd (K10's GEMM 1, gelu_bwd_epilogue): stages each 32-column
//   slice of f32 sums, then one compact pass reads hb [M, N], stores dh =
//   bf16(acc * gelu'(hb)) and g = bf16(gelu(hb)) (K11 reads it) as 16-byte
//   row pieces, and each warpgroup's column sums of its 64 rows of bf16 dh
//   (the parts of db1). Fragment by fragment, fully unrolled like the GELU
//   of kBias, it ran at a third of this speed (H100, K10's GEMM 1 at the
//   CE-large step: 1.55-1.63 ms, 0.49-0.51 staged; the staged kernel has
//   2,120 SASS instructions, K9's and K12's unrolled GELU kernels over
//   4,096);
// - kBucket + B and kBucketSmall (K4, bucket_epilogue, small_bucket_epilogue):
//   the score of each element (int8 operands: (f32(acc) * xs[m]) * ws[n];
//   bf16: f32(acc)), -1e30 from column valid_n on, and every aligned bucket
//   of columns reduced to (max, first column reaching it) in registers; only
//   the [M, n_cover / bucket] candidates reach device memory. The tiles cover
//   n_cover >= N columns (the corpus padded to a block multiple; its map has
//   N rows and a tile wholly past N runs no products).
#pragma once

#include <cuda_bf16.h>
#include <stdio.h>

#include "tile_gemm.cuh"     // gelu_exact, the port's one GELU
#include "wgmma_ring.cuh"

namespace sx {
namespace gemm {
// Internal linkage: each library (int8_linear, int8_ffn, ffn_fwd,
// fused_ffn) keeps its own instances. Shared template instances would bind
// across the loaded libraries, and one library would launch a kernel whose
// shared memory limit only the other had set (cudaErrorInvalidValue).
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

// devices one process may launch on (each gets its own launch setup)
constexpr int kMaxDevices = 64;

inline const char* error_string(int code) {
  static char msg[160];
  if (code == kNoEncoder)
    return "cuTensorMapEncodeTiled not found through the driver entry point";
  if (code == kRegisterBudget)
    return "the kernel was not built with 168 registers a thread at launch "
           "(setmaxnreg needs them)";
  if (code == kBadTile)
    return "no kernel for this tile in this library (128 x 256, 64 x 128 and "
           "64 x 64; K4 128 x 256 and 64 x 128)";
  if (code <= kEncodeFailed) {
    snprintf(msg, sizeof(msg), "cuTensorMapEncodeTiled failed (CUresult %d)",
             kEncodeFailed - code);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

enum Epilogue {
  kDequant = 0,
  kBias = 1,
  kPlain = 2,
  kGeluBwd = 3,
  kBucketSmall = 4,   // buckets of 1, 2 or 4 columns (a runtime size)
  kBucket = 256,      // kBucket + B: buckets of B = 8 .. 128 columns
};

__host__ __device__ constexpr bool is_bucket(int epi) {
  return epi == kBucketSmall || (epi > kBucket && epi <= kBucket + 128);
}

constexpr float kMaskedScore = -1e30f;   // the JAX kernel's _NEG

struct Args {
  const float* xs = nullptr;     // kDequant: [M] row scales of A's codes
  const float* ws = nullptr;     // kDequant: [N] column scales
  const void* bias = nullptr;    // [N] f32 (bf16 for kBias)
  void* out = nullptr;           // [M, N] f32 or bf16; split s of a launch
                                 // writes [M, N] at out + s M N
  float* row_max = nullptr;      // ROWMAX: [M, tiles_n] max |out| a tile
  void* pre = nullptr;           // PRE: [M, N] bf16 (N even), kBias's value
                                 // before GELU
  const void* hb = nullptr;      // kGeluBwd: [M, N] bf16 pre-activation
  void* g = nullptr;             // kGeluBwd: [M, N] bf16 gelu(hb) (N even)
  float* col_sums = nullptr;     // kGeluBwd: [ceil(M / 64), N] f32, the
                                 // column sums of bf16 out over 64 rows
  // the bucket epilogues: out holds [M, out_cols] f32 scores, ids the first
  // column reaching each; columns >= valid_n score kMaskedScore; the tiles
  // cover n_cover columns (>= N; bucket divides n_cover)
  int* ids = nullptr;
  int bucket = 0;
  int valid_n = 0;
  int n_cover = 0;
  long long out_cols = 0;        // n_cover / bucket
};

// One product of a launch: out[M, N] = A W^T over K; K in bytes of K
// (bf16: 2 x its elements).
struct Problem {
  Args args;
  int M, N, K;
  int tiles_n, tiles;   // column tiles; output tiles (of one split)
};

template <int WGS, int BN>
struct Cfg {   // WGS consumer warpgroups of 64 rows, BN columns a tile
  static constexpr int BM = 64 * WGS;
  // two consumers take registers from a whole producer warpgroup; one
  // needs no more than a launch gives it, and a producer warp suffices
  static constexpr int kThreads = WGS == 2 ? 384 : 160;
  static constexpr int kStageA = BM * kBK, kStageB = BN * kBK;
  // an MN-major operand lands as atoms of 64 values along MN x 64 rows of K
  static constexpr int kAtom = 64 * kBK;
  // a consumer's staged output rows, then its copy of the tile's column
  // vectors
  static constexpr int kStaging =
      64 * staged_pitch(kSliceLinear, false) + 2 * BN * 4;
  static constexpr int kSmem = 1024 + kStages * (kStageA + kStageB) +
                               WGS * kStaging + 2 * kStages * 8;
};

template <bool BF16, int BN, bool A_MN, bool B_MN>
struct Mma;

template <int BN>
struct Mma<false, BN, false, false> {
  using Acc = int;
  __device__ __forceinline__ static void mma(int (&d)[BN / 2], uint64_t a,
                                             uint64_t b) {
    wg::WgmmaS8<BN>::mma(d, a, b, 1);
  }
};

template <int BN, bool A_MN, bool B_MN>
struct Mma<true, BN, A_MN, B_MN> {
  using Acc = float;
  __device__ __forceinline__ static void mma(float (&d)[BN / 2], uint64_t a,
                                             uint64_t b) {
    wg::WgmmaBf16<BN, A_MN, B_MN>::mma(d, a, b, 1);
  }
};

// f32 -> bf16 -> f32: the rounding of a product before its bias
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Tile `tile` of a launch: its product (q), split and place. The products'
// tiles come one after another, each product's splits one after another,
// N fastest inside a split. Without MULTI a launch has one product and
// one split, and the walk is the plain one (known at compile time), with
// N fastest or, under M_FAST, M fastest.
struct Work {
  int q, split, m0, tn, kt0, kt1;
};

template <int BM, bool MULTI, bool M_FAST>
__device__ __forceinline__ Work decode(int tile, const Problem& p0,
                                       const Problem& p1, int splits) {
  Work w;
  if (!MULTI) {
    w.q = w.split = w.kt0 = 0;
    if (M_FAST) {
      const int tiles_m = p0.tiles / p0.tiles_n;
      w.m0 = (tile % tiles_m) * BM;
      w.tn = tile / tiles_m;
    } else {
      w.m0 = (tile / p0.tiles_n) * BM;
      w.tn = tile % p0.tiles_n;
    }
    w.kt1 = (p0.K + kBK - 1) / kBK;
    return w;
  }
  w.q = tile >= p0.tiles * splits;
  if (w.q) tile -= p0.tiles * splits;
  const int tiles = w.q ? p1.tiles : p0.tiles;
  const int tiles_n = w.q ? p1.tiles_n : p0.tiles_n;
  const int nk = ((w.q ? p1.K : p0.K) + kBK - 1) / kBK;
  w.split = tile / tiles;
  const int r = tile % tiles;
  w.m0 = (r / tiles_n) * BM;
  w.tn = r % tiles_n;
  w.kt0 = static_cast<int>(static_cast<long long>(w.split) * nk / splits);
  w.kt1 = static_cast<int>(static_cast<long long>(w.split + 1) * nk / splits);
  return w;
}

// The loads of one stage: A's rows m0 .. m0 + BM - 1 and W's n0 .. n0 + BN
// - 1 over the k-tile kt. A K-major operand is one box (128 bytes of K x
// its rows); an MN-major one a box per 64 values along MN (128 bytes of
// them x 64 rows of K), atoms kAtom bytes apart, of which only the
// a_atoms / b_atoms that start before the edge are loaded (the others
// feed only output rows or columns past it, which are not stored).
template <int WGS, int BN, bool A_MN, bool B_MN>
__device__ __forceinline__ void load_stage(uint8_t* sa, uint8_t* sb,
                                           const CUtensorMap* ma,
                                           const CUtensorMap* mw,
                                           uint64_t* bar, int m0, int n0,
                                           int a_atoms, int b_atoms,
                                           int kt) {
  using C = Cfg<WGS, BN>;
  constexpr int kRowsK = kBK / 2;   // rows of K a stage (bf16)
  if (A_MN) {
    for (int i = 0; i < a_atoms; ++i)
      wg::tma_load_2d(sa + i * C::kAtom, ma, bar, (m0 + 64 * i) * 2,
                      kt * kRowsK);
  } else {
    wg::tma_load_2d(sa, ma, bar, kt * kBK, m0);
  }
  if (B_MN) {
    for (int i = 0; i < b_atoms; ++i)
      wg::tma_load_2d(sb + i * C::kAtom, mw, bar, (n0 + 64 * i) * 2,
                      kt * kRowsK);
  } else {
    wg::tma_load_2d(sb, mw, bar, kt * kBK, n0);
  }
}

// kGeluBwd's epilogue for one consumer warpgroup's 64 rows (m0 ..) of a
// tile (columns n0 ..), in slices of 32 columns: the slice's f32 sums go
// to the staged rows (the one unrolled part: the accumulator stays in
// registers), then one compact pass over them, a thread 8 columns of two
// rows, reads hb, stores dh and g as 16-byte row pieces and adds the bf16
// dh of its column over its rows; a shuffle over the warp's 8 row groups
// and a sum over the 4 warps in order give the warpgroup's column sums.
// The same operations a fragment-wise epilogue would do, in far less code
// (unrolled over fragments, the GELU and its derivative of 128 values a
// thread ran at a third of this speed on an H100).
template <int BN>
__device__ __forceinline__ void gelu_bwd_epilogue(
    const float (&acc)[BN / 2], uint8_t* stg, const Args& args, int M,
    int N, int m0, int n0, int tid) {
  constexpr int kW = kSliceLinear / 4;              // 32 f32 columns a slice
  constexpr int kP = staged_pitch(kSliceLinear, false);
  constexpr int kSlices = BN / kW;
  static_assert(BN % kW == 0, "whole slices");
  constexpr int kPieces = kW / 8;                   // 8-column pieces a row
  constexpr int kRowsPass = 128 / kPieces;          // rows a pass of 128
  // the 4 warps' column sums of a slice, where the column vectors of the
  // other epilogues lie (Cfg::kStaging)
  static_assert(4 * kW * 4 <= 2 * BN * 4, "the column sums fit");
  float* col_part = reinterpret_cast<float*>(stg + 64 * kP);   // [4][kW]
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int q = tid % kPieces, r0 = tid / kPieces;
  const bf16* hb = static_cast<const bf16*>(args.hb);
  bf16* dh = static_cast<bf16*>(args.out);
  bf16* gout = static_cast<bf16*>(args.g);
  // hb of a slice for this thread's rows, loaded a slice ahead
  auto load_hb = [&](uint4 (&h)[64 / kRowsPass], int sl) {
#pragma unroll
    for (int j = 0; j < 64 / kRowsPass; ++j) {
      const int m = m0 + r0 + j * kRowsPass, n = n0 + sl * kW + q * 8;
      h[j] = m < M && n < N
                 ? __ldg(reinterpret_cast<const uint4*>(
                       hb + static_cast<long long>(m) * N + n))
                 : make_uint4(0, 0, 0, 0);
    }
  };
  uint4 next[64 / kRowsPass];
  load_hb(next, 0);
#pragma unroll 1
  for (int sl = 0; sl < kSlices; ++sl) {
    uint4 h[64 / kRowsPass];
#pragma unroll
    for (int j = 0; j < 64 / kRowsPass; ++j) h[j] = next[j];
    if (sl + 1 < kSlices) load_hb(next, sl + 1);
    // the slice's sums into the staged rows (fragment layout)
#pragma unroll
    for (int k = 0; k < kSlices; ++k) {
      if (k != sl) continue;
#pragma unroll
      for (int cc = 0; cc < kW / 8; ++cc) {
        const int c = k * (kW / 8) + cc;
        uint8_t* pa = stg + (warp * 16 + g) * kP + (cc * 8 + 2 * t) * 4;
        *reinterpret_cast<float2*>(pa) = make_float2(acc[4 * c], acc[4 * c + 1]);
        *reinterpret_cast<float2*>(pa + 8 * kP) =
            make_float2(acc[4 * c + 2], acc[4 * c + 3]);
      }
    }
    wg::named_sync(1 + threadIdx.x / 128, 128);
    float colsum[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) colsum[e] = 0.0f;
#pragma unroll
    for (int j = 0; j < 64 / kRowsPass; ++j) {
      const int r = r0 + j * kRowsPass;
      const long long m = m0 + r;
      const int n = n0 + sl * kW + q * 8;
      const float4 a0 = *reinterpret_cast<const float4*>(stg + r * kP + q * 32);
      const float4 a1 =
          *reinterpret_cast<const float4*>(stg + r * kP + q * 32 + 16);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const uint32_t hw[4] = {h[j].x, h[j].y, h[j].z, h[j].w};
      uint32_t dw[4], gw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 hf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&hw[i]));
        float g0, g1, d0, d1;
        gelu_and_grad(hf.x, g0, d0);
        gelu_and_grad(hf.y, g1, d1);
        const __nv_bfloat162 dv =
            __floats2bfloat162_rn(a[2 * i] * d0, a[2 * i + 1] * d1);
        const __nv_bfloat162 gv = __floats2bfloat162_rn(g0, g1);
        dw[i] = *reinterpret_cast<const uint32_t*>(&dv);
        gw[i] = *reinterpret_cast<const uint32_t*>(&gv);
        const float2 df = __bfloat1622float2(dv);
        colsum[2 * i] += df.x;   // rows past M: acc and hb are 0, dh 0
        colsum[2 * i + 1] += df.y;
      }
      if (m < M && n < N) {
        *reinterpret_cast<uint4*>(dh + m * N + n) =
            make_uint4(dw[0], dw[1], dw[2], dw[3]);
        *reinterpret_cast<uint4*>(gout + m * N + n) =
            make_uint4(gw[0], gw[1], gw[2], gw[3]);
      }
    }
    // over the warp's row groups (lanes with the same q), then the warps
#pragma unroll
    for (int o = kPieces; o < 32; o <<= 1)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        colsum[e] += __shfl_xor_sync(0xffffffffu, colsum[e], o);
    if (lane < kPieces)
#pragma unroll
      for (int e = 0; e < 8; ++e) col_part[warp * kW + q * 8 + e] = colsum[e];
    wg::named_sync(1 + threadIdx.x / 128, 128);
    if (tid < kW && m0 < M && n0 + sl * kW + tid < N)
      args.col_sums[static_cast<long long>(m0 / 64) * N + n0 + sl * kW +
                    tid] = ((col_part[tid] + col_part[kW + tid]) +
                            col_part[2 * kW + tid]) + col_part[3 * kW + tid];
  }
}

// The bucket epilogues read each element's score from the accumulator: in
// register 4c + 2h + e a thread holds row 16 w + g + 8 h, tile column
// 8c + 2t + e (w = warp of the warpgroup, g = lane / 4, t = lane % 4).
// int8 (S8): (f32(acc) * x) * cs[col], the plain version's two products in
// its order; bf16: f32(acc). Under MASK columns n0 + col >= valid_n score
// kMaskedScore: col < lim with lim = valid_n - n0 - 2t.
template <bool S8, bool MASK, class Acc>
__device__ __forceinline__ float bucket_score(Acc a, float x, float cs,
                                              int col_less_2t, int lim) {
  float v = static_cast<float>(a);
  if (S8) v = (v * x) * cs;
  return !MASK || col_less_2t < lim ? v : kMaskedScore;
}

// (v, col) of this lane or of lane ^ o, whichever is larger, the lower
// column on a tie: the first maximum of both lanes' columns
__device__ __forceinline__ void pick_lane(float& v, int& col, int o) {
  const float pv = __shfl_xor_sync(0xffffffffu, v, o);
  const int pc = __shfl_xor_sync(0xffffffffu, col, o);
  if (pv > v || (pv == v && pc < col)) v = pv, col = pc;
}

// kBucket + B (K4, buckets of B = 8 to 128 columns, a power of two known at
// compile time) for one consumer warpgroup's 64 rows (m0 ..) of a tile
// (columns n0 ..). All in registers: each pair of a thread's columns (2t,
// 2t + 1 of an n8 block) to its first maximum; then the B / 8 n8 blocks of
// a bucket in a tree, in column order (the earlier block wins a tie); then
// the four lanes of a quad, which hold interleaved columns, by shuffles
// that break ties by column. Each warp then writes its 16 rows by slices of
// 128 columns (128 / B buckets a row), staged in its own shared memory so
// that a row's candidates of the slice leave as one contiguous piece of
// consecutive words. MASK (the tile holds column valid_n) applies the
// -1e30; every other tile skips that test. A warp whose rows all lie past
// M does nothing; the caller syncs the warpgroup after (tile_ws). The size
// and the mask are compile-time: decided at run time, the guarded code for
// every possible bucket took the 128 x 256 kernels past 4,096 SASS
// instructions and the epilogue to 10 of the 19.5 ms of the int8 search at
// 1024 queries over 8.8M rows (H100, against a stub storing one value a
// tile); compile-time, 2.8 of 11.7.
constexpr int kBucketPitch = 17;   // words a staged row: 16 buckets + 1
constexpr int kBucketStage = 2 * 16 * kBucketPitch * 4;   // a warp's bytes

template <int BN, bool S8, int B, bool MASK, class Acc>
__device__ __forceinline__ void bucket_epilogue(const Acc (&acc)[BN / 2],
                                                uint8_t* stg,
                                                const float* tile_ws,
                                                const Args& args, int M,
                                                int m0, int n0, float xa,
                                                float xb, int tid) {
  static_assert(B >= 8 && B <= 128 && (B & (B - 1)) == 0 && BN % 128 == 0,
                "a bucket of 8 to 128 columns lies in one tile");
  static_assert(4 * kBucketStage <= 64 * staged_pitch(kSliceLinear, false),
                "the staged buckets fit before the tile's column vectors");
  constexpr int kBlocks = B / 8;          // n8 blocks a bucket
  constexpr int kPerRow = 128 / B;        // buckets a row of a slice
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int rw = m0 + warp * 16;
  if (rw >= M) return;
  const int lim = MASK ? args.valid_n - n0 - 2 * t : 0;
  float v[2][BN / 8];
  int col[2][BN / 8];
#pragma unroll
  for (int c = 0; c < BN / 8; ++c) {
    const float2 cs = S8 ? *reinterpret_cast<const float2*>(tile_ws + 8 * c +
                                                            2 * t)
                         : make_float2(0.0f, 0.0f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float x = h ? xb : xa;
      const float s0 =
          bucket_score<S8, MASK>(acc[4 * c + 2 * h], x, cs.x, 8 * c, lim);
      const float s1 =
          bucket_score<S8, MASK>(acc[4 * c + 2 * h + 1], x, cs.y, 8 * c + 1, lim);
      const bool second = s1 > s0;
      v[h][c] = second ? s1 : s0;
      col[h][c] = 8 * c + 2 * t + (second ? 1 : 0);
    }
  }
#pragma unroll
  for (int d = 1; d < kBlocks; d *= 2)
#pragma unroll
    for (int c = 0; c < BN / 8; c += 2 * d)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (v[h][c + d] > v[h][c]) v[h][c] = v[h][c + d], col[h][c] = col[h][c + d];
#pragma unroll
  for (int c = 0; c < BN / 8; c += kBlocks)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      pick_lane(v[h][c], col[h][c], 1);
      pick_lane(v[h][c], col[h][c], 2);
    }
  float* st_s = reinterpret_cast<float*>(stg + warp * kBucketStage);
  int* st_i = reinterpret_cast<int*>(st_s + 16 * kBucketPitch);
  const int width = args.n_cover - n0;
  float* out_s = static_cast<float*>(args.out);
#pragma unroll
  for (int sl = 0; sl < BN / 128; ++sl) {
    if (t == 0)
#pragma unroll
      for (int j = 0; j < kPerRow; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 16 * sl + j * kBlocks;
          st_s[(g + 8 * h) * kBucketPitch + j] = v[h][c];
          st_i[(g + 8 * h) * kBucketPitch + j] = n0 + col[h][c];
        }
    __syncwarp();
#pragma unroll
    for (int w0 = 0; w0 < 2 * 16 * kPerRow; w0 += 32) {
      const int w = w0 + lane;
      const bool ids = w >= 16 * kPerRow;
      const int x = ids ? w - 16 * kPerRow : w;
      const int r = x / kPerRow, j = x % kPerRow;
      const long long m = rw + r;
      const int first = 128 * sl + j * B;   // the bucket's tile column
      if (w < 2 * 16 * kPerRow && m < M && first < width) {
        const long long o = m * args.out_cols + (n0 + first) / B;
        if (ids)
          args.ids[o] = st_i[r * kBucketPitch + j];
        else
          out_s[o] = st_s[r * kBucketPitch + j];
      }
    }
    __syncwarp();
  }
}

// kBucketSmall (K4, buckets of b = 1, 2 or 4 columns): the same scores, each
// pair of a thread's columns to its first maximum (b = 2), then the pair of
// lanes t, t ^ 1 (b = 4); written straight from the registers, 4 bytes a
// store (b = 1 writes every score: the score matrix itself, twice its
// bytes with the ids).
template <int BN, bool S8, class Acc>
__device__ __forceinline__ void small_bucket_epilogue(
    const Acc (&acc)[BN / 2], const float* tile_ws, const Args& args, int M,
    int m0, int n0, float xa, float xb, int tid) {
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  if (m0 + warp * 16 >= M) return;
  const int b = args.bucket, lb = __ffs(b) - 1;
  const int lim = args.valid_n - n0 - 2 * t;
  const int width = args.n_cover - n0;
  float* out_s = static_cast<float*>(args.out);
  auto store = [&](long long m, int col, float v, int id) {
    if (m < M && col < width) {
      const long long o = m * args.out_cols + ((n0 + col) >> lb);
      out_s[o] = v;
      args.ids[o] = id;
    }
  };
#pragma unroll
  for (int c = 0; c < BN / 8; ++c) {
    const float2 cs = S8 ? *reinterpret_cast<const float2*>(tile_ws + 8 * c +
                                                            2 * t)
                         : make_float2(0.0f, 0.0f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + warp * 16 + g + 8 * h;
      const float x = h ? xb : xa;
      const int c0 = 8 * c + 2 * t;
      const float s0 =
          bucket_score<S8, true>(acc[4 * c + 2 * h], x, cs.x, 8 * c, lim);
      const float s1 =
          bucket_score<S8, true>(acc[4 * c + 2 * h + 1], x, cs.y, 8 * c + 1, lim);
      if (b == 1) {
        store(m, c0, s0, n0 + c0);
        store(m, c0 + 1, s1, n0 + c0 + 1);
        continue;
      }
      float v = s1 > s0 ? s1 : s0;
      int col = s1 > s0 ? c0 + 1 : c0;
      if (b == 4) {
        pick_lane(v, col, 1);
        if (t & 1) continue;
      }
      store(m, c0, v, n0 + col);
    }
  }
}

// S8: int8 operands (kDequant; K4's int8 template), else bf16
template <int WGS, int BN, int EPI, bool GELU, bool OUT_BF16, bool ROWMAX,
          bool PRE, bool A_MN, bool B_MN, bool MULTI, bool S8>
__global__ void __launch_bounds__(Cfg<WGS, BN>::kThreads, 1)
    gemm_kernel(__grid_constant__ const CUtensorMap map_a,
                __grid_constant__ const CUtensorMap map_w,
                __grid_constant__ const CUtensorMap map_a1,
                __grid_constant__ const CUtensorMap map_w1,
                __grid_constant__ const Problem p0,
                __grid_constant__ const Problem p1, int splits, int n_tiles) {
  using C = Cfg<WGS, BN>;
  using Op = Mma<!S8, BN, A_MN, B_MN>;
  using Acc = typename Op::Acc;
  static_assert(!(A_MN || B_MN) || !S8,
                "MN-major operands are bf16 (int8 wgmma is K-major only)");
  static_assert(!is_bucket(EPI) || !MULTI, "K4 walks one product");
  // K4: the query tiles of a corpus tile back to back; a tile wholly past
  // the corpus's N rows (the padding to n_cover) runs no products
  constexpr bool kMFast = is_bucket(EPI);
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: stages start on that
  uint8_t* smem = smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sa = smem;                             // [kStages][BM][128]
  uint8_t* sb = sa + kStages * C::kStageA;        // [kStages][BN][128]
  uint8_t* staging = sb + kStages * C::kStageB;   // [WGS][kStaging]
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + WGS * C::kStaging);
  uint64_t* empty = full + kStages;
  const int role = threadIdx.x / 128;   // < WGS: consumer; WGS: producer

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
        Work w = decode<C::BM, MULTI, kMFast>(tile, p0, p1, splits);
        if (kMFast && w.tn * BN >= p0.N) w.kt1 = w.kt0;
        const CUtensorMap* ma = w.q ? &map_a1 : &map_a;
        const CUtensorMap* mw = w.q ? &map_w1 : &map_w;
        const int n0 = w.tn * BN;
        const int left_m = (w.q ? p1.M : p0.M) - w.m0;
        const int left_n = (w.q ? p1.N : p0.N) - n0;
        const int a_atoms = min(C::BM / 64, (left_m + 63) / 64);
        const int b_atoms = min(BN / 64, (left_n + 63) / 64);
        const uint32_t bytes = (A_MN ? a_atoms * C::kAtom : C::kStageA) +
                               (B_MN ? b_atoms * C::kAtom : C::kStageB);
        for (int kt = w.kt0; kt < w.kt1; ++kt) {
          wg::mbar_wait(empty + stage, phase ^ 1);
          wg::mbar_arrive_expect_tx(full + stage, bytes);
          load_stage<WGS, BN, A_MN, B_MN>(sa + stage * C::kStageA,
                                          sb + stage * C::kStageB, ma, mw,
                                          full + stage, w.m0, n0, a_atoms,
                                          b_atoms, kt);
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
  static_assert(EPI != kGeluBwd || (OUT_BF16 && !GELU && !ROWMAX && !PRE),
                "kGeluBwd stores bf16 dh");
  // A and W advance by one k16 step: 32 bytes along a K-major row, 16 rows
  // of an MN-major atom
  constexpr int kStepA = A_MN ? (16 * kBK) >> 4 : 2;
  constexpr int kStepB = B_MN ? (16 * kBK) >> 4 : 2;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  uint8_t* stg = staging + role * C::kStaging;
  float* tile_ws = reinterpret_cast<float*>(
      stg + 64 * staged_pitch(kSliceLinear, false));   // [BN]
  float* tile_b = tile_ws + BN;           // [BN] f32, or bf16 (kBias)
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    Work w = decode<C::BM, MULTI, kMFast>(tile, p0, p1, splits);
    if (kMFast && w.tn * BN >= p0.N) w.kt1 = w.kt0;
    const Args& args = w.q ? p1.args : p0.args;
    const int M = w.q ? p1.M : p0.M, N = w.q ? p1.N : p0.N;
    const int tiles_n = w.q ? p1.tiles_n : p0.tiles_n;
    const bool rows_16b = (static_cast<long long>(N) * kElt) % 16 == 0;
    const int m0 = w.m0 + role * 64;
    const int tn = w.tn, n0 = tn * BN;
    uint8_t* out = static_cast<uint8_t*>(args.out) +
                   static_cast<long long>(w.split) * M * N * kElt;
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
    } else if ((EPI == kDequant && tid < BN / 2) ||
               (is_bucket(EPI) && S8 && tid < BN / 4)) {
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
    const float xa = S8 && ra < M ? args.xs[ra] : 0.0f;
    const float xb = S8 && rb < M ? args.xs[rb] : 0.0f;
    Acc acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = Acc(0);
    wg::fence_operands(acc);
    int prev = -1;
    for (int kt = w.kt0; kt < w.kt1; ++kt) {
      wg::mbar_wait(full + stage, phase);
      wg::wgmma_fence();
      uint8_t* ta = sa + stage * C::kStageA + role * 64 * kBK;
      uint8_t* tb = sb + stage * C::kStageB;
      const uint64_t da =
          A_MN ? wg::desc_mn128(ta, C::kAtom) : wg::desc_k128(ta);
      const uint64_t db =
          B_MN ? wg::desc_mn128(tb, C::kAtom) : wg::desc_k128(tb);
#pragma unroll
      for (int j = 0; j < kBK / 32; ++j)
        Op::mma(acc, da + kStepA * j, db + kStepB * j);
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
    if constexpr (EPI == kGeluBwd) {
      gelu_bwd_epilogue<BN>(acc, stg, args, M, N, m0, n0, tid);
      continue;
    } else if constexpr (is_bucket(EPI)) {
      if constexpr (EPI == kBucketSmall)
        small_bucket_epilogue<BN, S8>(acc, tile_ws, args, M, m0, n0, xa, xb,
                                      tid);
      else if (n0 + BN > args.valid_n)   // the tile holds column valid_n
        bucket_epilogue<BN, S8, EPI - kBucket, true>(acc, stg, tile_ws, args,
                                                     M, m0, n0, xa, xb, tid);
      else
        bucket_epilogue<BN, S8, EPI - kBucket, false>(acc, stg, tile_ws, args,
                                                      M, m0, n0, xa, xb, tid);
      wg::named_sync(1 + role, 128);   // tile_ws is read: the next tile's
      continue;                        // cp.async may overwrite it
    }
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
        } else if (EPI == kDequant) {
          const float2 w2 = *reinterpret_cast<const float2*>(tile_ws + c * 8 + 2 * t);
          const float2 b2 = *reinterpret_cast<const float2*>(tile_b + c * 8 + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            y[e] = static_cast<float>(acc[4 * c + e]) * (e < 2 ? xa : xb);
            y[e] = y[e] * (e & 1 ? w2.y : w2.x) + (e & 1 ? b2.y : b2.x);
            if (GELU) y[e] = gelu_exact(y[e]);
          }
        } else {   // kPlain
#pragma unroll
          for (int e = 0; e < 4; ++e) y[e] = static_cast<float>(acc[4 * c + e]);
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
        uint8_t* dst = out + (m * N + n) * kElt;
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
        args.row_max[static_cast<long long>(ra) * tiles_n + tn] =
            max_a;
      if (t == 0 && rb < M)
        args.row_max[static_cast<long long>(rb) * tiles_n + tn] =
            max_b;
    }
  }
}

// The sums of the rows of f32 matrices, in the order of the rows (the same
// bits every run): dst[c] = sum over r < rows of src[r * cols + c], for up
// to three jobs in one launch. K11 takes db1 from K10's column parts
// ([ceil(M / 64), F]) and, when it splits K, dW1 and dW2 from the splits'
// partial products ([splits, H F] each). A block sums 128 columns, 32 lanes
// of 4 columns each; its 8 warps take the rows r = w mod 8, then warp 0
// adds the 8 in order. cols % 4 == 0, 16-byte aligned.
struct SumJob {
  const float* src;
  float* dst;
  int rows;
  long long cols;
};

struct SumJobs {
  SumJob job[3];
  int blocks[3];   // ceil(cols / 128) of each job, 0 past the last
};

__global__ void __launch_bounds__(256)
    row_sums_kernel(__grid_constant__ const SumJobs jobs) {
  __shared__ float4 part[8][32];
  int b = blockIdx.x, i = 0;
  while (i < 2 && b >= jobs.blocks[i]) b -= jobs.blocks[i++];
  const SumJob& j = jobs.job[i];
  const long long c4 = static_cast<long long>(b) * 32 + threadIdx.x % 32;
  const int w = threadIdx.x / 32;
  const bool live = c4 * 4 < j.cols;
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (live) {
    const float4* src = reinterpret_cast<const float4*>(j.src);
    const long long cols4 = j.cols / 4;
    for (int r = w; r < j.rows; r += 8) {
      const float4 v = __ldcs(src + r * cols4 + c4);
      s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
    }
  }
  part[w][threadIdx.x % 32] = s;
  __syncthreads();
  if (w == 0 && live) {
    float4 t = part[0][threadIdx.x];
#pragma unroll
    for (int k = 1; k < 8; ++k) {
      const float4 v = part[k][threadIdx.x];
      t.x += v.x, t.y += v.y, t.z += v.z, t.w += v.w;
    }
    reinterpret_cast<float4*>(j.dst)[c4] = t;
  }
}

// row_sums_kernel over `count` (1 to 3) jobs; -> cudaGetLastError()
inline int row_sums(const SumJob* job, int count, cudaStream_t stream) {
  SumJobs jobs{};
  long long blocks = 0;
  for (int i = 0; i < count; ++i) {
    jobs.job[i] = job[i];
    jobs.blocks[i] = static_cast<int>((job[i].cols + 127) / 128);
    blocks += jobs.blocks[i];
  }
  if (count < 1 || count > 3 || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  row_sums_kernel<<<static_cast<int>(blocks), 256, 0, stream>>>(jobs);
  return static_cast<int>(cudaGetLastError());
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

// One product for launch(): out[M, N] = A W^T. K in bytes of K (2 x its
// elements for bf16). A K-major A is [M][K] and a K-major W [N][K]; an
// MN-major A is [K / 2][M] and an MN-major W [K / 2][N] (bf16, rows of K).
// Rows % 16 bytes == 0, 16-byte aligned.
struct Product {
  const void* A;
  const void* W;
  Args args;
  int M, N, K;
};

// One launch over the output tiles of `count` (1 or 2) products, each with
// K cut into `splits` parts (split s writes args.out + s M N; MULTI builds
// the walk over more than one product or split). Returns 0, a CUDA error
// code, or one of the codes above.
template <int WGS, int BN, int EPI, bool GELU, bool OUT_BF16, bool ROWMAX,
          bool PRE, bool A_MN, bool B_MN, bool MULTI, bool S8>
int launch(const Product* prods, int count, int splits, cudaStream_t stream) {
  using C = Cfg<WGS, BN>;
  auto kernel = gemm_kernel<WGS, BN, EPI, GELU, OUT_BF16, ROWMAX, PRE, A_MN,
                            B_MN, MULTI, S8>;
  // the shared memory limit is set per device: once for each device a
  // process launches on
  int dev = 0;
  cudaError_t dev_err = cudaGetDevice(&dev);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  static int blocks_per_sm_of[kMaxDevices] = {};
  static int prepared_of[kMaxDevices] = {};
  static bool done_of[kMaxDevices] = {};
  if (!done_of[dev]) {
    prepared_of[dev] = prepare(kernel, C::kSmem, C::kThreads, WGS == 2,
                               &blocks_per_sm_of[dev]);
    done_of[dev] = true;
  }
  if (prepared_of[dev] != 0) return prepared_of[dev];
  const int blocks_per_sm = blocks_per_sm_of[dev];
  if (count < 1 || count > 2 || splits < 1 ||
      (!MULTI && (count != 1 || splits != 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  wg::EncodeTiled encode = wg::encode_tiled();
  if (encode == nullptr) return kNoEncoder;
  CUtensorMap maps[2][2];
  Problem probs[2];
  long long n_tiles = 0;
  for (int i = 0; i < 2; ++i) {
    const Product& p = prods[i < count ? i : 0];
    CUresult res =
        A_MN ? wg::map_2d(&maps[i][0], encode, p.A, p.K / 2, 2LL * p.M, 64)
             : wg::map_2d(&maps[i][0], encode, p.A, p.M, p.K, C::BM);
    if (res == CUDA_SUCCESS)
      res = B_MN ? wg::map_2d(&maps[i][1], encode, p.W, p.K / 2, 2LL * p.N, 64)
                 : wg::map_2d(&maps[i][1], encode, p.W, p.N, p.K, BN);
    if (res != CUDA_SUCCESS) return kEncodeFailed - static_cast<int>(res);
    Problem& q = probs[i];
    q.args = p.args;
    q.M = p.M, q.N = p.N, q.K = p.K;
    // K4's tiles cover the padded corpus (n_cover >= N columns)
    const int cover =
        is_bucket(EPI) && p.args.n_cover > p.N ? p.args.n_cover : p.N;
    q.tiles_n = (cover + BN - 1) / BN;
    const long long tiles =
        i < count ? static_cast<long long>((p.M + C::BM - 1) / C::BM) * q.tiles_n
                  : 0;
    if (tiles * splits > 0x3fffffffLL)
      return static_cast<int>(cudaErrorInvalidValue);
    q.tiles = static_cast<int>(tiles);
    n_tiles += tiles * splits;
  }
  // persistent: at most one wave of resident blocks walks the tiles
  const long long wave = static_cast<long long>(sm_count()) * blocks_per_sm;
  const int grid = static_cast<int>(n_tiles < wave ? n_tiles : wave);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(
      maps[0][0], maps[0][1], maps[1][0], maps[1][1], probs[0], probs[1],
      splits, static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

// The launch for tile (bm, bn): 128 x 256, 64 x 128 or 64 x 64; for K4's
// kBucket + B 128 x 256 or 64 x 128 (a bucket of 128 columns lies in one
// tile), for kBucketSmall 64 x 128 only.
template <int EPI, bool GELU, bool OUT_BF16, bool ROWMAX, bool PRE = false,
          bool A_MN = false, bool B_MN = false, bool MULTI = false,
          bool S8 = EPI == kDequant>
int run_products(int bm, int bn, const Product* prods, int count, int splits,
                 cudaStream_t s) {
  if constexpr (EPI == kBucketSmall) {
    if (bm == 64 && bn == 128)
      return launch<1, 128, EPI, false, false, false, false, false, false,
                    false, S8>(prods, count, splits, s);
    return kBadTile;
  } else if constexpr (is_bucket(EPI)) {
    if (bm == 128 && bn == 256)
      return launch<2, 256, EPI, false, false, false, false, false, false,
                    false, S8>(prods, count, splits, s);
    if (bm == 64 && bn == 128)
      return launch<1, 128, EPI, false, false, false, false, false, false,
                    false, S8>(prods, count, splits, s);
    return kBadTile;
  } else {
    if (bm == 128 && bn == 256)
      return launch<2, 256, EPI, GELU, OUT_BF16, ROWMAX, PRE, A_MN, B_MN,
                    MULTI, S8>(prods, count, splits, s);
    if (bm == 64 && bn == 128)
      return launch<1, 128, EPI, GELU, OUT_BF16, ROWMAX, PRE, A_MN, B_MN,
                    MULTI, S8>(prods, count, splits, s);
    if (bm == 64 && bn == 64)
      return launch<1, 64, EPI, GELU, OUT_BF16, ROWMAX, PRE, A_MN, B_MN,
                    MULTI, S8>(prods, count, splits, s);
    return kBadTile;
  }
}

// One product, K-major A and W, whole K (K1, K4, K9, K12-K14).
template <int EPI, bool GELU, bool OUT_BF16, bool ROWMAX, bool PRE = false,
          bool S8 = EPI == kDequant>
int run(int bm, int bn, const void* A, const void* W, const Args& args,
        int M, int N, int K, cudaStream_t s) {
  const Product p{A, W, args, M, N, K};
  return run_products<EPI, GELU, OUT_BF16, ROWMAX, PRE, false, false, false,
                      S8>(bm, bn, &p, 1, 1, s);
}

}  // namespace
}  // namespace gemm
}  // namespace sx
