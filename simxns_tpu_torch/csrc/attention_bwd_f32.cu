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
#include "attention_f32.cuh"

SX_DEFINE_ERROR_STRING

namespace {

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
  const int g = (tid & 31) >> 2, t = tid & 3;
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
  key_fills<N, T>(fill, real, mask, b, S, n_tiles, tid);
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
