// The f32 instance of K6 group_attention_bwd and K8 bh_attention_bwd
// (sx_attention_bwd_f32): the attention backward on f32 q, k, v and dO, on
// Hopper's warpgroup MMA (wgmma), with the split into bf16 halves inside the
// kernel.
//
// Replaces, for f32 inputs, the backward Pallas kernels of the JAX package:
// simxns_tpu/ops/flash_attention.py:_fused_bwd (kernel _bwd_kernel, :80;
// 256 <= S <= 1024) and _fused_group_bwd (kernel _bwd_kernel_group, :125;
// S < 256). Both cast q, k, v and dO to f32 inside, so the function is
// theirs (attention_bwd.cuh):
//   s  = where(mask[key] > 0, q k^T * scale, -1e9),  p = softmax(s)
//   dV = p^T dO, dP = dO v^T, dS = p (dP - rowsum(dP p)),
//   dQ = dS k * scale, dK = dS^T q * scale,
// a batch row with every key masked getting the uniform p, keys past S
// weight 0. Every operand enters the tensor cores as hi = bf16(x) and lo =
// bf16(x - hi), every product is hi hi + hi lo + lo hi (three bf16 wgmma
// products into one f32 accumulator; lo lo, under 2^-16 of the product, is
// dropped), and the results are stored in f32.
//
// Two launches, K8's passes: no atomics and no partial sums, so two calls
// agree bit for bit.
// - query pass, a block per (64 WG query rows, head, batch): each
//   warpgroup splits its q and dO rows once, from device memory, into
//   resident hi and lo tiles. Tiles of N keys of k and v land as f32 by
//   cp.async (the next tile in flight while this one's products run) and
//   each landed tile is split once, by all the block's threads, into the hi
//   and lo tiles the products read. Walk 1 folds each row's max, sum and
//   rowsum(dP p) from q k^T and dO v^T; walk 2 computes dS = p (dP -
//   rowsum(dP p)) with p = 2^(s - lse) and dQ += dS k. lse and rowsum(dP
//   p) go to the f32 scratch [2, B, heads, S].
// - key pass, a block per (64 WG key rows, head, batch): k and v resident,
//   tiles of N queries of q and dO streamed as above with their two
//   statistics; k q^T and v dO^T give p^T and dS^T, then dV += p^T dO and
//   dK += dS^T q.
// q k^T, dO v^T, k q^T and v dO^T are SS products: both operands K-major in
// shared memory (WgmmaBf16). dS k, p^T dO and dS^T q take A from registers,
// straight from the f32 accumulator as hi and lo fragments (mma.sync's A
// layout, which is the accumulator's), and B from the streamed tile that
// the first products read K-major, now MN-major through the transpose bit
// (WgmmaBf16Rs): no transposed copy.
//
// Tiles are rows of DP bf16 values (DP = 16, 32, 64 or 128, d rounded up;
// columns past d land as zeros, which add exact zeros) with the 32-, 64-
// or 128-byte swizzle of wgmma (two 128-byte column blocks at DP = 128).
// Shapes (by_length, measured on an H100 with scripts/torch_kernel_bench.py
// and chip_smoke.py's timers): from S = 256 two warpgroups a block (WG =
// 2) share every landed and split tile, which halves the bytes streamed
// and the split work a row, and run in ping-pong (the second issues its
// score products after the first, whose softmax algebra then runs under
// them); below 256, K6's route, one warpgroup a block and tiles of 32 (S =
// 160 is five tiles of 32 keys, where 64-key tiles would pad it to 192).
// What did not pay (measured the same way): a producer warpgroup
// splitting into a ring of stages (ptxas kept the consumers at the 168
// launch registers and spilled), q and dO held as register fragments,
// double-buffered split tiles, starting each exponential before the
// second score product was done, and launching the key pass as a
// programmatic dependent of the query pass.
//
// Bound on the card: operations. At [16, 8, 512, 64] the model's 5
// products of 2 S^2 d per head are 21.5 GFLOP, 0.043 ms at TF32's 495
// TFLOP/s; this design runs 9 products (q k^T and dO v^T in both walks of
// the query pass and again, transposed, in the key pass), 27 bf16 wgmma
// products of 4.29 GFLOP, 0.117 ms at the bf16 peak. The time goes to the
// work beside the products: the split of every streamed tile, the softmax
// algebra, the landing and the barriers.
#include "attention_bwd.cuh"
#include "wgmma_ring.cuh"

SX_DEFINE_ERROR_STRING

namespace {

namespace wg = sx::wg;
namespace ring = sx::ring;
namespace bwd = sx::bwd;

constexpr int kMaxS = 1024;
constexpr int kRows = 64;       // a warpgroup's resident rows: wgmma's M

struct F32In {            // a [B, heads, S, d] f32 view, d contiguous
  const float* p;
  long long sb, sh, ss;   // element strides
  __device__ const float* row(int b, int h, int i) const {
    return p + b * sb + h * sh + static_cast<long long>(i) * ss;
  }
};

struct F32Out {
  float* p;
  long long sb, sh, ss;
  __device__ float* row(int b, int h, int i) const {
    return p + b * sb + h * sh + static_cast<long long>(i) * ss;
  }
};

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

// A pass's shape: DP columns, N rows a streamed tile, WG warpgroups of 64
// resident rows each (two share each streamed tile). Shared memory: WG x 4
// resident tiles (hi and lo of two operands), 4 streamed tiles, the f32
// landing of two streamed operands, then the key fills and key tiles'
// flags (query pass) or two stages of statistics (key pass).
template <int DP_, int N_, int WG_>
struct Pass {
  static constexpr int DP = DP_, N = N_, WG = WG_;
  static constexpr int kThreads = 128 * WG;
  using Res = Tile<DP, kRows>;
  using Str = Tile<DP, N>;
  static constexpr int kResident = WG * 4 * Res::kBytes;
  static constexpr int kStreamed = 4 * Str::kBytes;
  static constexpr int kLanding = 2 * N * DP * 4;
  static constexpr int smem(int extra) {
    return 1024 + kResident + kStreamed + kLanding + extra;
  }
  static constexpr int kQuerySmem = smem(kMaxS * 4 + kMaxS / 32 * 4);
  static constexpr int kKeySmem = smem(2 * 2 * N * 4);
};

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

template <int N>
__device__ __forceinline__ float (&flat(float (&x)[N / 8][4]))[N / 2] {
  return reinterpret_cast<float(&)[N / 2]>(x);
}

template <int K>
__device__ __forceinline__ void fence_fragments(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i) wg::fence_operands(a[i]);
}

// issue x = a b^T and y = c e^T over the DP columns of four split pairs
// (a, c the warpgroup's resident 64-row tiles, b, e streamed N-row tiles,
// all K-major) into x and y, zeroed first, in the accumulator layout
// (attention_ring.cuh's [N / 8][4] of a warp's 16 rows); committed, not
// waited for (wait_scores)
template <int DP, int N>
__device__ __forceinline__ void issue_scores(
    float (&x)[N / 8][4], float (&y)[N / 8][4], const uint8_t* ah,
    const uint8_t* al, const uint8_t* bh, const uint8_t* bl,
    const uint8_t* ch, const uint8_t* cl, const uint8_t* eh,
    const uint8_t* el) {
  using A = Tile<DP, kRows>;
  using B = Tile<DP, N>;
  using Mma = wg::WgmmaBf16<N>;
  float(&xf)[N / 2] = flat<N>(x);
  float(&yf)[N / 2] = flat<N>(y);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) xf[i] = yf[i] = 0.0f;
  wg::fence_operands(xf);
  wg::fence_operands(yf);
  wg::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    Mma::mma(xf, A::k_desc(al, ks), B::k_desc(bh, ks), 1);
    Mma::mma(xf, A::k_desc(ah, ks), B::k_desc(bl, ks), 1);
    Mma::mma(xf, A::k_desc(ah, ks), B::k_desc(bh, ks), 1);
  }
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    Mma::mma(yf, A::k_desc(cl, ks), B::k_desc(eh, ks), 1);
    Mma::mma(yf, A::k_desc(ch, ks), B::k_desc(el, ks), 1);
    Mma::mma(yf, A::k_desc(ch, ks), B::k_desc(eh, ks), 1);
  }
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

// acc += x b over the N rows of the split tile b (read MN-major), x as
// its hi and lo A fragments; issued, not waited for
template <int DP, int N>
__device__ __forceinline__ void issue_times(float (&acc)[DP / 2],
                                            const uint32_t (&xh)[N / 16][4],
                                            const uint32_t (&xl)[N / 16][4],
                                            const uint8_t* bh,
                                            const uint8_t* bl) {
  using B = Tile<DP, N>;
  using Mma = wg::WgmmaBf16Rs<DP, true>;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    Mma::mma(acc, xl[kk], B::mn_desc(bh, kk), 1);
    Mma::mma(acc, xh[kk], B::mn_desc(bl, kk), 1);
    Mma::mma(acc, xh[kk], B::mn_desc(bh, kk), 1);
  }
}

template <int N>
__device__ __forceinline__ void fragments(uint32_t (&hi)[N / 16][4],
                                          uint32_t (&lo)[N / 16][4],
                                          const float (&x)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    ring::a_fragments_split(hi[kk], lo[kk], x, kk);
}

// rows r0 + g and r0 + g + 8 of a [16][DP] accumulator, columns below d
template <int DP>
__device__ __forceinline__ void store_rows(const F32Out& o, int b, int h,
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

// the blocks an SM the launch bounds ask for: three of one warpgroup up
// to DP = 64 (K6's route; the key pass fits 168 registers a thread, and
// ran 11% faster than at two blocks), else one
template <class P>
constexpr int min_blocks() {
  return P::WG == 1 && P::DP <= 64 ? 3 : 1;
}

// Launch 1: per 64 WG query rows, the row statistics (lse, rowsum(dP p))
// and dQ. Steps 0 .. n - 1 walk the key tiles for the statistics, steps
// n .. 2n - 1 again for dQ.
template <class P>
__global__ void __launch_bounds__(P::kThreads, min_blocks<P>())
    query_pass(F32In q, F32In k, F32In v, F32In dout,
               const int* __restrict__ mask, F32Out dq,
               float* __restrict__ stats, int S, int d, float scale,
               float scale2) {
  constexpr int DP = P::DP, N = P::N, T = P::kThreads;
  using R = typename P::Res;
  using Str = typename P::Str;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = aligned_smem(smem_raw);
  const int tid = threadIdx.x, wtid = tid & 127;
  uint8_t* qh = base + (tid >> 7) * 4 * R::kBytes;   // this warpgroup's
  uint8_t* ql = qh + R::kBytes;
  uint8_t* dh = ql + R::kBytes;
  uint8_t* dl = dh + R::kBytes;
  uint8_t* kh = base + P::kResident;                 // the key tile's
  uint8_t* kl = kh + Str::kBytes;
  uint8_t* vh = kl + Str::kBytes;
  uint8_t* vl = vh + Str::kBytes;
  float* land_k = reinterpret_cast<float*>(vl + Str::kBytes);
  float* land_v = land_k + N * DP;
  float* fill = land_v + N * DP;
  int* real = reinterpret_cast<int*>(fill + kMaxS);  // a key tile all real
  const int h = blockIdx.y, b = blockIdx.z;
  const int qw = blockIdx.x * T / 2 + (tid >> 7) * kRows;   // its rows
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int n_tiles = (S + N - 1) / N, steps = 2 * n_tiles;
  auto issue = [&](int step) {
    const int j0 = step % n_tiles * N;
    land<DP, N, T>(land_k, [&](int i) { return k.row(b, h, i); }, j0, S, d,
                   tid);
    land<DP, N, T>(land_v, [&](int i) { return v.row(b, h, i); }, j0, S, d,
                   tid);
    wg::cp_async_commit();
  };
  // the key tile of `step` split and visible to wgmma; the next step's
  // tile landing behind it
  auto prepare = [&](int step) {
    wg::cp_async_wait_all();
    __syncthreads();
    split_tile<DP, N, T>(kh, kl, land_k, tid);
    split_tile<DP, N, T>(vh, vl, land_v, tid);
    wg::fence_proxy_async();
    __syncthreads();
    if (step + 1 < steps) issue(step + 1);
  };
  issue(0);
  split_rows<DP>(qh, ql, [&](int i) { return q.row(b, h, i); }, dh, dl,
                 [&](int i) { return dout.row(b, h, i); }, qw, S, d, wtid);
  const bool none_real = bwd::all_masked(mask, b, S);
  for (int j = tid; j < n_tiles * N; j += T)
    fill[j] = bwd::key_fill(mask, b, j, S, none_real);
  __syncthreads();
  for (int j = tid >> 5; j < n_tiles; j += T / 32) {
    bool all = true;
    for (int i = lane; i < N; i += 32) all &= fill[j * N + i] == bwd::kRealKey;
    all = __all_sync(0xffffffffu, all);
    if (lane == 0) real[j] = all;
  }
  prepare(0);   // its fence and barriers publish the flags and the tiles

  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
  float dotu[2] = {0.0f, 0.0f}, lse[2], dot[2];
  float acc[DP / 8][4];
  float(&accf)[DP / 2] = flat<DP>(acc);
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) accf[i] = 0.0f;
  for (int step = 0; step < steps; ++step) {
    const int tile = step < n_tiles ? step : step - n_tiles;
    const float* f = fill + tile * N;
    float sc[N / 8][4], dp[N / 8][4];
    before_scores<P::WG>();
    issue_scores<DP, N>(sc, dp, qh, ql, kh, kl, dh, dl, vh, vl);
    after_scores<P::WG>();
    wait_scores<N>(sc, dp);
    if (step < n_tiles) {
      if (real[tile])
        bwd::fold_stats<true>(sc, dp, f, scale2, mx, sum, dotu);
      else
        bwd::fold_stats(sc, dp, f, scale2, mx, sum, dotu);
      if (step == n_tiles - 1) bwd::finish_stats(mx, sum, dotu, lse, dot);
    } else {
      if (real[tile])
        bwd::ds_rows<true>(sc, dp, f, scale2, lse, dot);
      else
        bwd::ds_rows(sc, dp, f, scale2, lse, dot);
      uint32_t xh[N / 16][4], xl[N / 16][4];
      fragments<N>(xh, xl, sc);
      wg::fence_operands(accf);
      wg::wgmma_fence();
      issue_times<DP, N>(accf, xh, xl, kh, kl);
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::fence_operands(accf);
      fence_fragments(xh);
      fence_fragments(xl);
    }
    if (step + 1 < steps) prepare(step + 1);
  }
  const int r0 = qw + ((tid >> 5) & 3) * 16;
  store_rows<DP>(dq, b, h, r0, S, d, acc, scale);
  if (t == 0) {
    const long long n = static_cast<long long>(gridDim.z) * gridDim.y * S;
    const long long at = (static_cast<long long>(b) * gridDim.y + h) * S;
    const int ra = r0 + g, rb = r0 + g + 8;
    if (ra < S) stats[at + ra] = lse[0], stats[n + at + ra] = dot[0];
    if (rb < S) stats[at + rb] = lse[1], stats[n + at + rb] = dot[1];
  }
}

// Launch 2: per 64 WG key rows, dV = p^T dO and dK = dS^T q * scale summed
// over every query tile. Query rows past S land as zeros with zero
// statistics: their p (1 or 0) meets a zero dO row and their dS is 0, so
// they add 0.
template <class P>
__global__ void __launch_bounds__(P::kThreads, min_blocks<P>())
    key_pass(F32In q, F32In k, F32In v, F32In dout,
             const int* __restrict__ mask, F32Out dk, F32Out dv,
             const float* __restrict__ stats, int S, int d, float scale,
             float scale2) {
  constexpr int DP = P::DP, N = P::N, T = P::kThreads;
  using R = typename P::Res;
  using Str = typename P::Str;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = aligned_smem(smem_raw);
  const int tid = threadIdx.x, wtid = tid & 127;
  uint8_t* kh = base + (tid >> 7) * 4 * R::kBytes;   // this warpgroup's
  uint8_t* kl = kh + R::kBytes;
  uint8_t* vh = kl + R::kBytes;
  uint8_t* vl = vh + R::kBytes;
  uint8_t* qh = base + P::kResident;                 // the query tile's
  uint8_t* ql = qh + Str::kBytes;
  uint8_t* dh = ql + Str::kBytes;
  uint8_t* dl = dh + Str::kBytes;
  float* land_q = reinterpret_cast<float*>(dl + Str::kBytes);
  float* land_d = land_q + N * DP;
  float* rl = land_d + N * DP;   // [2][N] lse by tile % 2
  float* rd = rl + 2 * N;        // [2][N] rowsum(dP p)
  const int h = blockIdx.y, b = blockIdx.z;
  const int kw = blockIdx.x * T / 2 + (tid >> 7) * kRows;   // its rows
  const int g = (tid & 31) >> 2;
  const int n_tiles = (S + N - 1) / N;
  const long long n = static_cast<long long>(gridDim.z) * gridDim.y * S;
  const long long at = (static_cast<long long>(b) * gridDim.y + h) * S;
  // query tile `tile`: q, dO, and each row's lse (threads 0 .. N - 1) and
  // rowsum(dP p) (threads N .. 2N - 1) into stage tile % 2
  auto issue = [&](int tile) {
    const int i0 = tile * N;
    land<DP, N, T>(land_q, [&](int i) { return q.row(b, h, i); }, i0, S, d,
                   tid);
    land<DP, N, T>(land_d, [&](int i) { return dout.row(b, h, i); }, i0, S,
                   d, tid);
    if (tid < 2 * N) {
      const int i = tid % N;
      const bool second = tid >= N, ok = i0 + i < S;
      bwd::cp_async4((second ? rd : rl) + (tile & 1) * N + i,
                     stats + (second ? n : 0) + at + (ok ? i0 + i : 0), ok);
    }
    wg::cp_async_commit();
  };
  auto prepare = [&](int tile) {
    wg::cp_async_wait_all();
    __syncthreads();
    split_tile<DP, N, T>(qh, ql, land_q, tid);
    split_tile<DP, N, T>(dh, dl, land_d, tid);
    wg::fence_proxy_async();
    __syncthreads();
    if (tile + 1 < n_tiles) issue(tile + 1);
  };
  issue(0);
  split_rows<DP>(kh, kl, [&](int i) { return k.row(b, h, i); }, vh, vl,
                 [&](int i) { return v.row(b, h, i); }, kw, S, d, wtid);
  const bool none_real = bwd::all_masked(mask, b, S);
  const int jw = kw + ((tid >> 5) & 3) * 16;
  const float fill[2] = {bwd::key_fill(mask, b, jw + g, S, none_real),
                         bwd::key_fill(mask, b, jw + g + 8, S, none_real)};
  const bool all_real = fill[0] == bwd::kRealKey && fill[1] == bwd::kRealKey;
  prepare(0);

  float dka[DP / 8][4], dva[DP / 8][4];
  float(&dkf)[DP / 2] = flat<DP>(dka);
  float(&dvf)[DP / 2] = flat<DP>(dva);
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dkf[i] = dvf[i] = 0.0f;
  for (int tile = 0; tile < n_tiles; ++tile) {
    float pt[N / 8][4], dst[N / 8][4];
    before_scores<P::WG>();
    issue_scores<DP, N>(pt, dst, kh, kl, qh, ql, vh, vl, dh, dl);
    after_scores<P::WG>();
    wait_scores<N>(pt, dst);
    const float* lse = rl + (tile & 1) * N;
    const float* dot = rd + (tile & 1) * N;
    if (all_real)
      bwd::p_ds_cols<true>(pt, dst, fill, lse, dot, scale2);
    else
      bwd::p_ds_cols(pt, dst, fill, lse, dot, scale2);
    uint32_t ph[N / 16][4], pl[N / 16][4], sh[N / 16][4], sl[N / 16][4];
    fragments<N>(ph, pl, pt);
    fragments<N>(sh, sl, dst);
    wg::fence_operands(dvf);
    wg::fence_operands(dkf);
    wg::wgmma_fence();
    issue_times<DP, N>(dvf, ph, pl, dh, dl);
    issue_times<DP, N>(dkf, sh, sl, qh, ql);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_operands(dvf);
    wg::fence_operands(dkf);
    fence_fragments(ph);
    fence_fragments(pl);
    fence_fragments(sh);
    fence_fragments(sl);
    if (tile + 1 < n_tiles) prepare(tile + 1);
  }
  store_rows<DP>(dk, b, h, jw, S, d, dka, scale);
  store_rows<DP>(dv, b, h, jw, S, d, dva, 1.0f);
}

template <class Kernel>
cudaError_t prepare(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

struct Args {
  F32In q, k, v, dout;
  const int* mask;
  F32Out dq, dk, dv;
  float* stats;
  int B, heads, S, d;
  float scale;
  cudaStream_t st;
};

// the two launches: the query pass of shape Q, the key pass of shape K
template <class Q, class K>
cudaError_t launch(const Args& a) {
  const float scale2 = a.scale * ring::kLog2e;
  cudaError_t err = prepare(query_pass<Q>, Q::kQuerySmem);
  if (err == cudaSuccess) err = prepare(key_pass<K>, K::kKeySmem);
  if (err != cudaSuccess) return err;
  const int qrows = 64 * Q::WG, krows = 64 * K::WG;
  query_pass<Q><<<dim3((a.S + qrows - 1) / qrows, a.heads, a.B),
                  Q::kThreads, Q::kQuerySmem, a.st>>>(
      a.q, a.k, a.v, a.dout, a.mask, a.dq, a.stats, a.S, a.d, a.scale,
      scale2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  key_pass<K><<<dim3((a.S + krows - 1) / krows, a.heads, a.B), K::kThreads,
                K::kKeySmem, a.st>>>(a.q, a.k, a.v, a.dout, a.mask, a.dk,
                                     a.dv, a.stats, a.S, a.d, a.scale,
                                     scale2);
  return cudaGetLastError();
}

// The shapes by length and width. Below S = 256 (K6's route): one
// warpgroup a block (64-row tiles pad S = 160 to 192, 128-row ones would
// pad it to 256) and streamed tiles of 32 (S = 160 is five of them). From
// 256: two warpgroups a block share each landed and split tile (half the
// bytes streamed and the split a row) in ping-pong; the query pass streams
// 128 keys a tile at DP = 32 and 64 (half the steps), 64 at DP = 16 and 32
// at DP = 128 (shared memory); the key pass 64 queries, 32 at DP = 128
// (registers).
template <int DP>
cudaError_t by_length(const Args& a) {
  if (a.S < 256) return launch<Pass<DP, 32, 1>, Pass<DP, 32, 1>>(a);
  if constexpr (DP == 128)
    return launch<Pass<DP, 32, 2>, Pass<DP, 32, 2>>(a);
  else if constexpr (DP == 16)
    return launch<Pass<DP, 64, 2>, Pass<DP, 64, 2>>(a);
  else
    return launch<Pass<DP, 128, 2>, Pass<DP, 64, 2>>(a);
}

static_assert(Pass<128, 32, 2>::kQuerySmem <= 232448 &&
                  Pass<128, 32, 2>::kKeySmem <= 232448 &&
                  Pass<64, 128, 2>::kQuerySmem <= 232448,
              "a block of two warpgroups fits an SM");
static_assert(3 * Pass<64, 32, 1>::kQuerySmem <= 233472,
              "three blocks of K6's route fit an SM at DP = 64");

}  // namespace

// q, k, v: [B, heads, S, d] f32 views sharing the element strides (sb, sh,
// ss), d contiguous; dout an f32 view with strides (db, dh, ds); mask [B,
// S] int32 (1 = real key); dq, dk, dv f32 views sharing the strides (gb,
// gh, gs); stats an f32 scratch of 2 * B * heads * S values (lse, then
// rowsum(dP p): written by the first launch, read by the second). Every row
// start 16-byte aligned (the wrapper checks); d on the 16 grid up to 128,
// 1 <= S <= 1024, heads and B at most 65535. Returns cudaGetLastError()
// after the launches. The arguments of sx_bh_attention_bwd, in f32.
extern "C" int sx_attention_bwd_f32(
    const void* q, const void* k, const void* v, long long sb, long long sh,
    long long ss, const void* dout, long long db, long long dh, long long ds,
    const int* mask, void* dq, void* dk, void* dv, long long gb, long long gh,
    long long gs, float* stats, int B, int heads, int S, int d, float scale,
    void* stream) {
  if (S < 1 || S > kMaxS || d < 16 || d > 128 || d % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto in = [&](const void* p, long long b_, long long h_,
                      long long s_) {
    return F32In{static_cast<const float*>(p), b_, h_, s_};
  };
  const auto out = [&](void* p) {
    return F32Out{static_cast<float*>(p), gb, gh, gs};
  };
  const Args a{in(q, sb, sh, ss), in(k, sb, sh, ss), in(v, sb, sh, ss),
               in(dout, db, dh, ds), mask, out(dq), out(dk), out(dv), stats,
               B, heads, S, d, scale, static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (d <= 16)
    err = by_length<16>(a);
  else if (d <= 32)
    err = by_length<32>(a);
  else if (d <= 64)
    err = by_length<64>(a);
  else
    err = by_length<128>(a);
  return static_cast<int>(err);
}
