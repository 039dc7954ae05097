// K8 bh_attention_bwd and the f32 instance of K6 group_attention_bwd and
// K8 (sx_bh_attention_bwd, sx_attention_bwd_f32): the attention backward
// on Hopper's warpgroup MMA (wgmma), one source with two instances by the
// input type E: bf16 (K8) and f32 (K6's and K8's f32 instance).
//
// Replaces the backward Pallas kernels of the JAX package:
// simxns_tpu/ops/flash_attention.py:_fused_bwd (kernel _bwd_kernel, :80;
// 256 <= S <= 1024) and, for f32 inputs, _fused_group_bwd (kernel
// _bwd_kernel_group, :125; S < 256). Both cast q, k, v and dO to f32
// inside, so the function is theirs, in f32 (attention_bwd.cuh):
//   s  = where(mask[key] > 0, q k^T * scale, -1e9),  p = softmax(s)
//   dV = p^T dO, dP = dO v^T, dS = p (dP - rowsum(dP p)),
//   dQ = dS k * scale, dK = dS^T q * scale,
// a batch row with every key masked getting the uniform p, keys past S
// weight 0, the results stored in E. bf16 q, k, v and dO enter the tensor
// cores as they are: q k^T, dO v^T, k q^T and v dO^T are one bf16 product
// each. f32 ones are split into hi = bf16(x) and lo = bf16(x - hi), and
// their every product is hi hi + hi lo + lo hi (three bf16 wgmma products
// into one f32 accumulator; lo lo, under 2^-16 of the product, is
// dropped). p and dS are f32 in both: they enter dS k, p^T dO and dS^T q
// as hi and lo register fragments (two products with a bf16 tile, three
// with a split one).
//
// Two launches: no atomics and no partial sums, so two calls agree bit
// for bit.
// - query pass, a block per (64 WG query rows, head, batch): each
//   warpgroup holds its q and dO rows in resident tiles (bf16: landed by
//   cp.async as they are; f32: read from device memory and split once into
//   hi and lo tiles). Tiles of N keys of k and v stream behind the products
//   of the tile before (bf16: landed by cp.async into two stages of
//   tiles; f32: landed as f32 and each split once, by all the block's
//   threads, into the hi and lo tiles the products read). Walk 1 folds
//   each row's max, sum and rowsum(dP p) from q k^T and dO v^T; walk 2
//   computes dS = p (dP - rowsum(dP p)) with p = 2^(s - lse) and dQ += dS
//   k. lse and rowsum(dP p) go to the f32 scratch [2, B, heads, S].
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
// Tiles are rows of DP bf16 values (DP = 16, 32, 64 or 128: d rounded up
// to the next of these, so d = 48 runs at 64 and d = 80, 96, 112 at 128;
// columns past d land as zeros, which add exact zeros) with the 32-, 64-
// or 128-byte swizzle of wgmma (two 128-byte column blocks at DP = 128).
// Shapes (by_length, measured on an H100 with scripts/torch_kernel_bench.py,
// chip_smoke.py's timers and scripts/torch_attention_shapes.py): for the
// f32 instance from S = 256 two warpgroups a block (WG = 2) share every
// landed and split tile, which halves the bytes streamed and the split
// work a row, and run in ping-pong (the second issues its score products
// after the first, whose softmax algebra then runs under them); the bf16
// instance, with no split to share, runs one warpgroup a block at d <= 64,
// three blocks an SM; below 256, K6's route, one warpgroup a block and
// tiles of 32 (S = 160 is five tiles of 32 keys, where 64-key tiles would
// pad it to 192). What did not
// pay for the f32 instance (measured the same way): a producer warpgroup
// splitting into a ring of stages (ptxas kept the consumers at the 168
// launch registers and spilled), q and dO held as register fragments,
// double-buffered split tiles, starting each exponential before the
// second score product was done, and launching the key pass as a
// programmatic dependent of the query pass.
//
// Bound on the card: operations. The model's backward is 5 products of 2
// S^2 d per head; this design runs 9 score-sized products (q k^T and dO
// v^T in both walks of the query pass and again, transposed, in the key
// pass), as 12 bf16 wgmma products in the bf16 instance (the three with p
// or dS two each) and 27 in the f32 one. At the msdoc reranker's shape
// ([128, 12, 512, 64] bf16) the model's products are 258 GFLOP (0.261 ms
// at the bf16 peak) and the bf16 instance's 619 GFLOP (0.63 ms); at [16,
// 8, 512, 64] f32 the model's 21.5 GFLOP take 0.043 ms at TF32's 495
// TFLOP/s, the f32 instance's 116 GFLOP 0.117 ms at the bf16 peak. The
// time beside the products: the softmax algebra, the landing (and the
// split, in f32) and the barriers.
#include <type_traits>

#include "attention_wgmma.cuh"

SX_DEFINE_ERROR_STRING

namespace {

using bf16 = __nv_bfloat16;

// A pass's shape: DP columns, N rows a streamed tile, WG warpgroups of 64
// resident rows each (two share each streamed tile), inputs of type E.
// Shared memory: WG x 2 resident operands (hi and lo tiles each when
// split), 4 streamed tiles (f32: hi and lo of two operands; bf16: two
// operands in two stages), the f32 landing of two streamed operands (f32
// only), then the key fills and key tiles' flags (query pass) or two
// stages of statistics (key pass).
template <int DP_, int N_, int WG_, class E_>
struct Pass {
  static constexpr int DP = DP_, N = N_, WG = WG_;
  using E = E_;
  static constexpr bool kSplit = std::is_same<E, float>::value;
  static constexpr int kOps = kSplit ? 2 : 1;   // tiles of an operand
  static constexpr int kThreads = 128 * WG;
  using Res = Tile<DP, kRows>;
  using Str = Tile<DP, N>;
  static constexpr int kResident = WG * 2 * kOps * Res::kBytes;
  static constexpr int kStreamed = 4 * Str::kBytes;
  static constexpr int kLanding = kSplit ? 2 * N * DP * 4 : 0;
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

// The streamed tiles of step `step` (t0 the first): the first operand's
// hi and lo, the second's. Split: one stage, hi and lo of each. bf16: the
// two operands' tiles of stage step % 2 (lo = hi, unused).
template <class P>
struct Streamed {
  uint8_t *ah, *al, *bh, *bl;
  __device__ Streamed(uint8_t* t0, int step) {
    constexpr int B = P::Str::kBytes;
    if constexpr (P::kSplit) {
      ah = t0, al = t0 + B, bh = t0 + 2 * B, bl = t0 + 3 * B;
    } else {
      ah = al = t0 + (step & 1) * 2 * B;
      bh = bl = ah + B;
    }
  }
};

// The resident tiles of this thread's warpgroup (x0 the block's first):
// two operands, hi and lo each (lo = hi in bf16)
template <class P>
struct Resident {
  uint8_t *ah, *al, *bh, *bl;
  __device__ explicit Resident(uint8_t* x0) {
    constexpr int B = P::Res::kBytes;
    ah = x0 + (threadIdx.x >> 7) * 2 * P::kOps * B;
    al = P::kSplit ? ah + B : ah;
    bh = ah + P::kOps * B;
    bl = P::kSplit ? bh + B : bh;
  }
};

// rows r0 .. r0 + 63 of two operands into the warpgroup's resident tiles
// (wtid its thread): split from device memory (f32), or landed by
// cp.async as one more committed group (bf16)
template <class P, class RowA, class RowB>
__device__ __forceinline__ void load_resident(const Resident<P>& r,
                                              RowA row_a, RowB row_b, int r0,
                                              int S, int d, int wtid) {
  if constexpr (P::kSplit) {
    split_rows<P::DP>(r.ah, r.al, row_a, r.bh, r.bl, row_b, r0, S, d, wtid);
  } else {
    land_tile<P::DP, kRows, 128>(r.ah, row_a, r0, S, d, wtid);
    land_tile<P::DP, kRows, 128>(r.bh, row_b, r0, S, d, wtid);
    wg::cp_async_commit();
  }
}

// rows r0 .. r0 + N - 1 of two operands on their way to the tiles of
// `step`: landed as f32 into `landing` [2][N][DP] (split later by
// publish), or straight into the step's bf16 tiles
template <class P, class RowA, class RowB>
__device__ __forceinline__ void stream(uint8_t* t0, float* landing, int step,
                                       RowA row_a, RowB row_b, int r0, int S,
                                       int d) {
  constexpr int DP = P::DP, N = P::N, T = P::kThreads;
  if constexpr (P::kSplit) {
    land<DP, N, T>(landing, row_a, r0, S, d, threadIdx.x);
    land<DP, N, T>(landing + N * DP, row_b, r0, S, d, threadIdx.x);
  } else {
    const Streamed<P> t(t0, step);
    land_tile<DP, N, T>(t.ah, row_a, r0, S, d, threadIdx.x);
    land_tile<DP, N, T>(t.bh, row_b, r0, S, d, threadIdx.x);
  }
}

// the tiles of `step` landed (and split), and visible to wgmma
template <class P>
__device__ __forceinline__ void publish(uint8_t* t0, const float* landing,
                                        int step) {
  constexpr int DP = P::DP, N = P::N, T = P::kThreads;
  wg::cp_async_wait_all();
  if constexpr (P::kSplit) {
    __syncthreads();
    const Streamed<P> t(t0, step);
    split_tile<DP, N, T>(t.ah, t.al, landing, threadIdx.x);
    split_tile<DP, N, T>(t.bh, t.bl, landing + N * DP, threadIdx.x);
  }
  wg::fence_proxy_async();
  __syncthreads();
}

// Launch 1: per 64 WG query rows, the row statistics (lse, rowsum(dP p))
// and dQ. Steps 0 .. n - 1 walk the key tiles for the statistics, steps
// n .. 2n - 1 again for dQ.
template <class P>
__global__ void __launch_bounds__(P::kThreads, min_blocks<P>())
    bh_attention_bwd_query_kernel(HeadIn<typename P::E> q,
                                  HeadIn<typename P::E> k,
                                  HeadIn<typename P::E> v,
                                  HeadIn<typename P::E> dout,
                                  const int* __restrict__ mask,
                                  HeadOut<typename P::E> dq,
                                  float* __restrict__ stats, int S, int d,
                                  float scale, float scale2) {
  constexpr int DP = P::DP, N = P::N, T = P::kThreads;
  constexpr bool kSplit = P::kSplit;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = aligned_smem(smem_raw);
  const int tid = threadIdx.x, wtid = tid & 127;
  const Resident<P> res(base);                     // q and dO
  uint8_t* t0 = base + P::kResident;               // the key tiles
  float* landing = reinterpret_cast<float*>(t0 + P::kStreamed);
  float* fill = reinterpret_cast<float*>(t0 + P::kStreamed + P::kLanding);
  int* real = reinterpret_cast<int*>(fill + kMaxS);  // a key tile all real
  const int h = blockIdx.y, b = blockIdx.z;
  const int qw = blockIdx.x * T / 2 + (tid >> 7) * kRows;   // its rows
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int n_tiles = (S + N - 1) / N, steps = 2 * n_tiles;
  auto issue = [&](int step) {
    stream<P>(t0, landing, step, [&](int i) { return k.row(b, h, i); },
              [&](int i) { return v.row(b, h, i); }, step % n_tiles * N, S,
              d);
    wg::cp_async_commit();
  };
  issue(0);
  load_resident<P>(res, [&](int i) { return q.row(b, h, i); },
                   [&](int i) { return dout.row(b, h, i); }, qw, S, d, wtid);
  key_fills<N, T>(fill, real, mask, b, S, n_tiles, tid);
  publish<P>(t0, landing, 0);   // its barriers publish the flags too

  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
  float dotu[2] = {0.0f, 0.0f}, lse[2], dot[2];
  float acc[DP / 8][4];
  float(&accf)[DP / 2] = flat<DP>(acc);
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) accf[i] = 0.0f;
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) issue(step + 1);   // behind this step's products
    const Streamed<P> kv(t0, step);
    const int tile = step < n_tiles ? step : step - n_tiles;
    const float* f = fill + tile * N;
    float sc[N / 8][4], dp[N / 8][4];
    before_scores<P::WG>();
    issue_scores<DP, N, kSplit>(sc, dp, res.ah, res.al, kv.ah, kv.al, res.bh,
                                res.bl, kv.bh, kv.bl);
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
      issue_times<DP, N, kSplit>(accf, xh, xl, kv.ah, kv.al);
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::fence_operands(accf);
      fence_fragments(xh);
      fence_fragments(xl);
    }
    if (step + 1 < steps) publish<P>(t0, landing, step + 1);
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
    bh_attention_bwd_key_kernel(HeadIn<typename P::E> q,
                                HeadIn<typename P::E> k,
                                HeadIn<typename P::E> v,
                                HeadIn<typename P::E> dout,
                                const int* __restrict__ mask,
                                HeadOut<typename P::E> dk,
                                HeadOut<typename P::E> dv,
                                const float* __restrict__ stats, int S, int d,
                                float scale, float scale2) {
  constexpr int DP = P::DP, N = P::N;
  constexpr bool kSplit = P::kSplit;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = aligned_smem(smem_raw);
  const int tid = threadIdx.x, wtid = tid & 127;
  const Resident<P> res(base);                     // k and v
  uint8_t* t0 = base + P::kResident;               // the query tiles
  float* landing = reinterpret_cast<float*>(t0 + P::kStreamed);
  float* rl = reinterpret_cast<float*>(t0 + P::kStreamed + P::kLanding);
  float* rd = rl + 2 * N;        // [2][N] rowsum(dP p); rl [2][N] lse
  const int h = blockIdx.y, b = blockIdx.z;
  const int kw = blockIdx.x * P::kThreads / 2 + (tid >> 7) * kRows;
  const int g = (tid & 31) >> 2;
  const int n_tiles = (S + N - 1) / N;
  const long long n = static_cast<long long>(gridDim.z) * gridDim.y * S;
  const long long at = (static_cast<long long>(b) * gridDim.y + h) * S;
  // query tile `tile`: q, dO, and each row's lse (threads 0 .. N - 1) and
  // rowsum(dP p) (threads N .. 2N - 1) into stage tile % 2
  auto issue = [&](int tile) {
    const int i0 = tile * N;
    stream<P>(t0, landing, tile, [&](int i) { return q.row(b, h, i); },
              [&](int i) { return dout.row(b, h, i); }, i0, S, d);
    if (tid < 2 * N) {
      const int i = tid % N;
      const bool second = tid >= N, ok = i0 + i < S;
      bwd::cp_async4((second ? rd : rl) + (tile & 1) * N + i,
                     stats + (second ? n : 0) + at + (ok ? i0 + i : 0), ok);
    }
    wg::cp_async_commit();
  };
  issue(0);
  load_resident<P>(res, [&](int i) { return k.row(b, h, i); },
                   [&](int i) { return v.row(b, h, i); }, kw, S, d, wtid);
  const bool none_real = bwd::all_masked(mask, b, S);
  const int jw = kw + ((tid >> 5) & 3) * 16;
  const float fill[2] = {bwd::key_fill(mask, b, jw + g, S, none_real),
                         bwd::key_fill(mask, b, jw + g + 8, S, none_real)};
  const bool all_real = fill[0] == bwd::kRealKey && fill[1] == bwd::kRealKey;
  publish<P>(t0, landing, 0);

  float dka[DP / 8][4], dva[DP / 8][4];
  float(&dkf)[DP / 2] = flat<DP>(dka);
  float(&dvf)[DP / 2] = flat<DP>(dva);
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dkf[i] = dvf[i] = 0.0f;
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) issue(tile + 1);   // behind this tile's products
    const Streamed<P> qd(t0, tile);
    float pt[N / 8][4], dst[N / 8][4];
    before_scores<P::WG>();
    issue_scores<DP, N, kSplit>(pt, dst, res.ah, res.al, qd.ah, qd.al,
                                res.bh, res.bl, qd.bh, qd.bl);
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
    issue_times<DP, N, kSplit>(dvf, ph, pl, qd.bh, qd.bl);
    issue_times<DP, N, kSplit>(dkf, sh, sl, qd.ah, qd.al);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_operands(dvf);
    wg::fence_operands(dkf);
    fence_fragments(ph);
    fence_fragments(pl);
    fence_fragments(sh);
    fence_fragments(sl);
    if (tile + 1 < n_tiles) publish<P>(t0, landing, tile + 1);
  }
  store_rows<DP>(dk, b, h, jw, S, d, dka, scale);
  store_rows<DP>(dv, b, h, jw, S, d, dva, 1.0f);
}

// K6's shape: DP columns, R warpgroups, R 64-row tiles of each of q, k,
// v and dO, all resident. Shared memory: the operands' tiles, then each
// warpgroup's four 64 x 64 tiles of p and dS (hi and lo; its dQ partial
// after its products have read them), two rounds of row statistics and the
// key fills.
template <int DP_, int R_>
struct Group {
  static constexpr int DP = DP_, R = R_;
  static constexpr int kThreads = 128 * R;
  using Op = Tile<DP, kRows>;      // 64 rows of q, k, v or dO
  using Sq = Tile<kRows, kRows>;   // p or dS (hi or lo): 64 queries x 64 keys
  static constexpr int kOperands = 4 * R * Op::kBytes;
  static constexpr int kPrivate = 4 * Sq::kBytes;
  static_assert(kRows * DP * 4 <= kPrivate,
                "a warpgroup's dQ partial fits its p and dS tiles");
  static constexpr int kSmem =
      1024 + kOperands + R * kPrivate + 2 * R * kRows * 16 + R * kRows * 4;
};

// K6 (bf16, S <= 64 R): one block per (head, batch) of R warpgroups;
// warpgroup w owns key rows 64 w .. 64 w + 63 (its dK and dV accumulators)
// and walks the query tiles r = 0 .. R - 1, the block in step:
// - s = q_r k_w^T and dP = dO_r v_w^T (SS); each row's max m over the
//   warpgroup's 64 keys, l = sum 2^(s - m) and u = sum 2^(s - m) dP go to
//   shared memory; one block barrier; every warpgroup folds the R partials
//   of its rows in a fixed order: M = max m, L = sum l 2^(m - M), lse =
//   M + log2(L), rowsum(dP p) = (sum u 2^(m - M)) / L, and p = 2^(s - m)
//   2^(m - M) / L (one ex2 a score);
// - dS = p (dP - rowsum(dP p)); p and dS go to the warpgroup's own tiles
//   as bf16 hi and lo (f32 as hi + lo; stmatrix from the accumulators),
//   read back MN-major as p^T and dS^T: dV_w += p^T dO_r and dK_w += dS^T
//   q_r, and K-major for dQ_r's partial dS k_w (SS, k_w MN-major);
// - the last warpgroup sums the other partials (each staged in its owner's
//   tiles) and its own in warpgroup order and stores dQ_r: no atomics, so
//   two calls agree bit for bit.
// 8 score-sized products (4 with p or dS, two each) against K8's 12, and
// no statistics through device memory. Query rows past S are zero, so
// their dP and dS are 0 and they add nothing; keys past S take -inf.
template <class P>
__global__ void __launch_bounds__(P::kThreads, 1)
    group_attention_bwd_kernel(HeadIn<bf16> q, HeadIn<bf16> k,
                               HeadIn<bf16> v, HeadIn<bf16> dout,
                               const int* __restrict__ mask,
                               HeadOut<bf16> dq, HeadOut<bf16> dk,
                               HeadOut<bf16> dv, int S, int d, float scale,
                               float scale2) {
  constexpr int DP = P::DP, R = P::R, T = P::kThreads;
  using Op = typename P::Op;
  using Sq = typename P::Sq;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = aligned_smem(smem_raw);
  const int tid = threadIdx.x, wtid = tid & 127, w = tid >> 7;
  const int h = blockIdx.x, b = blockIdx.y;
  const int t = tid & 3, row = ((tid >> 5) & 3) * 16 + ((tid & 31) >> 2);
  // the row and column of this lane's stmatrix address in a 64 x 64 tile
  const int mrow = ((tid >> 5) & 3) * 16 + ((tid >> 3) & 1) * 8 + (tid & 7);
  const int mcol = ((tid >> 4) & 1) * 8;
  // tile i of operand `which` (0 q, 1 k, 2 v, 3 dO)
  auto op = [&](int which, int i) {
    return base + (which * R + i) * Op::kBytes;
  };
  uint8_t* own = base + P::kOperands + w * P::kPrivate;
  uint8_t *ph = own, *pl = ph + Sq::kBytes;
  uint8_t *sh = pl + Sq::kBytes, *sl = sh + Sq::kBytes;
  float4* stats =
      reinterpret_cast<float4*>(base + P::kOperands + R * P::kPrivate);
  float* fill = reinterpret_cast<float*>(stats + 2 * R * kRows);
  auto land_rows = [&](int which, const HeadIn<bf16>& x, int i) {
    land_tile<DP, kRows, T>(op(which, i),
                            [&](int j) { return x.row(b, h, j); }, i * kRows,
                            S, d, tid);
  };
  // k, v and the first query tile, then the other query tiles
  for (int i = 0; i < R; ++i) land_rows(1, k, i), land_rows(2, v, i);
  land_rows(0, q, 0);
  land_rows(3, dout, 0);
  wg::cp_async_commit();
  for (int i = 1; i < R; ++i) land_rows(0, q, i), land_rows(3, dout, i);
  wg::cp_async_commit();
  const bool none_real = bwd::all_masked(mask, b, S);
  for (int j = tid; j < R * kRows; j += T)
    fill[j] = bwd::key_fill(mask, b, j, S, none_real);

  const uint8_t* kt = op(1, w);
  const uint8_t* vt = op(2, w);
  const float* f = fill + w * kRows;
  float dka[DP / 8][4], dva[DP / 8][4];
  float(&dkf)[DP / 2] = flat<DP>(dka);
  float(&dvf)[DP / 2] = flat<DP>(dva);
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dkf[i] = dvf[i] = 0.0f;
  for (int r = 0; r < R; ++r) {
    if (r < 2) {   // query tile r landed (at r = 0 also k, v, the fills)
      if (r == 0)
        wg::cp_async_wait<1>();
      else
        wg::cp_async_wait_all();
      wg::fence_proxy_async();
      __syncthreads();
    }
    const uint8_t* qt = op(0, r);
    const uint8_t* dt = op(3, r);
    float sc[kRows / 8][4], dp[kRows / 8][4];
    issue_scores<DP, kRows, false>(sc, dp, qt, qt, kt, kt, dt, dt, vt, vt);
    wait_scores<kRows>(sc, dp);
    // this warpgroup's part of each row: m, l, u
    float cm[2], l[2] = {0.0f, 0.0f}, u[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < kRows / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[nt][e] = bwd::score(sc[nt][e], f[nt * 8 + 2 * t + (e & 1)], scale2);
    ring::tile_max(sc, cm);
#pragma unroll
    for (int nt = 0; nt < kRows / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = ring::ex2(sc[nt][e] - cm[e >> 1]);
        sc[nt][e] = x;
        l[e >> 1] += x;
        u[e >> 1] += x * dp[nt][e];
      }
    float4* st = stats + (r & 1) * R * kRows;   // two rounds: no overwrite
#pragma unroll                                  // before every read
    for (int i = 0; i < 2; ++i) {
      l[i] = ring::quad<1>(l[i]);
      u[i] = ring::quad<1>(u[i]);
      if (t == 0)
        st[w * kRows + row + 8 * i] = make_float4(cm[i], l[i], u[i], 0.0f);
    }
    __syncthreads();
    float c[2], dot[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float4* x = st + row + 8 * i;   // [j * kRows]: warpgroup j's
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < R; ++j) mx = fmaxf(mx, x[j * kRows].x);
      float sum = 0.0f, dotu = 0.0f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float4 y = x[j * kRows];
        const float a = ring::ex2(y.x - mx);
        sum += y.y * a;
        dotu += y.z * a;
      }
      c[i] = ring::ex2(cm[i] - mx) / sum;
      dot[i] = dotu / sum;
    }
    // p and dS to this warpgroup's tiles as hi and lo, by stmatrix (the
    // accumulators' layout is the A fragments')
#pragma unroll
    for (int nt = 0; nt < kRows / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[nt][e] *= c[e >> 1];
        dp[nt][e] = sc[nt][e] * (dp[nt][e] - dot[e >> 1]);
      }
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      uint32_t hi[4], lo[4];
      const int off = Sq::offset(mrow, kk * 16 + mcol);
      ring::a_fragments_split(hi, lo, sc, kk);
      stmatrix_x4(ph + off, hi);
      stmatrix_x4(pl + off, lo);
      ring::a_fragments_split(hi, lo, dp, kk);
      stmatrix_x4(sh + off, hi);
      stmatrix_x4(sl + off, lo);
    }
    wg::fence_proxy_async();
    wg::named_sync(2 + w, 128);
    float dqa[DP / 8][4];
    float(&dqf)[DP / 2] = flat<DP>(dqa);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dqf[i] = 0.0f;
    using Mt = wg::WgmmaBf16<DP, true, true>;    // p^T, dS^T; dO, q
    using Mk = wg::WgmmaBf16<DP, false, true>;   // dS; k
    wg::fence_operands(dvf);
    wg::fence_operands(dkf);
    wg::fence_operands(dqf);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      Mt::mma(dvf, Sq::mn_desc(pl, kk), Op::mn_desc(dt, kk), 1);
      Mt::mma(dvf, Sq::mn_desc(ph, kk), Op::mn_desc(dt, kk), 1);
      Mt::mma(dkf, Sq::mn_desc(sl, kk), Op::mn_desc(qt, kk), 1);
      Mt::mma(dkf, Sq::mn_desc(sh, kk), Op::mn_desc(qt, kk), 1);
      Mk::mma(dqf, Sq::k_desc(sl, kk), Op::mn_desc(kt, kk), 1);
      Mk::mma(dqf, Sq::k_desc(sh, kk), Op::mn_desc(kt, kk), 1);
    }
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_operands(dvf);
    wg::fence_operands(dkf);
    wg::fence_operands(dqf);
    // dQ_r: the partials staged in their owners' tiles (read before the
    // next round's barrier), summed by the last warpgroup in warpgroup
    // order
    if (w != R - 1) {
      float4* part = reinterpret_cast<float4*>(own);
#pragma unroll
      for (int i = 0; i < DP / 8; ++i)
        part[i * 128 + wtid] = make_float4(dqf[4 * i], dqf[4 * i + 1],
                                           dqf[4 * i + 2], dqf[4 * i + 3]);
      wg::named_arrive(1, T);
    } else {
      wg::named_sync(1, T);
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int j = 0; j < R - 1; ++j) {
          const float4 y = reinterpret_cast<const float4*>(
              base + P::kOperands + j * P::kPrivate)[i * 128 + wtid];
          x.x += y.x, x.y += y.y, x.z += y.z, x.w += y.w;
        }
        dqf[4 * i] += x.x, dqf[4 * i + 1] += x.y;
        dqf[4 * i + 2] += x.z, dqf[4 * i + 3] += x.w;
      }
      store_rows<DP>(dq, b, h, r * kRows + row - row % 16, S, d, dqa, scale);
    }
  }
  const int jw = w * kRows + row - row % 16;
  store_rows<DP>(dk, b, h, jw, S, d, dka, scale);
  store_rows<DP>(dv, b, h, jw, S, d, dva, 1.0f);
}

template <class E>
struct Args {
  HeadIn<E> q, k, v, dout;
  const int* mask;
  HeadOut<E> dq, dk, dv;
  float* stats;
  int B, heads, S, d;
  float scale;
  cudaStream_t st;
};

// the two launches: the query pass of shape Q, the key pass of shape K
template <class Q, class K>
cudaError_t launch(const Args<typename Q::E>& a) {
  const float scale2 = a.scale * ring::kLog2e;
  cudaError_t err = prepare(bh_attention_bwd_query_kernel<Q>, Q::kQuerySmem);
  if (err == cudaSuccess)
    err = prepare(bh_attention_bwd_key_kernel<K>, K::kKeySmem);
  if (err != cudaSuccess) return err;
  const int qrows = 64 * Q::WG, krows = 64 * K::WG;
  bh_attention_bwd_query_kernel<Q>
      <<<dim3((a.S + qrows - 1) / qrows, a.heads, a.B), Q::kThreads,
         Q::kQuerySmem, a.st>>>(a.q, a.k, a.v, a.dout, a.mask, a.dq,
                                a.stats, a.S, a.d, a.scale, scale2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bh_attention_bwd_key_kernel<K>
      <<<dim3((a.S + krows - 1) / krows, a.heads, a.B), K::kThreads,
         K::kKeySmem, a.st>>>(a.q, a.k, a.v, a.dout, a.mask, a.dk, a.dv,
                              a.stats, a.S, a.d, a.scale, scale2);
  return cudaGetLastError();
}

// The shapes by length and width. Below S = 256 (K6's route): one
// warpgroup a block (64-row tiles pad S = 160 to 192, 128-row ones would
// pad it to 256) and streamed tiles of 32 (S = 160 is five of them). From
// 256: two warpgroups a block share each landed tile (half the bytes
// streamed, and the split, a row) in ping-pong; the query pass streams 128
// keys a tile at DP = 32 and 64 (half the steps), 64 at DP = 16 and 32 at
// DP = 128 (shared memory); the key pass 64 queries, 32 at DP = 128
// (registers). The bf16 instance, with no split to share, runs one
// warpgroup a block and 64-row tiles in both passes at DP = 32 and 64:
// three blocks an SM (measured on an H100 with
// scripts/torch_attention_shapes.py --kernel k8).
template <int DP, class E>
cudaError_t by_length(const Args<E>& a) {
  if (a.S < 256) return launch<Pass<DP, 32, 1, E>, Pass<DP, 32, 1, E>>(a);
  if constexpr (DP == 128)
    return launch<Pass<DP, 32, 2, E>, Pass<DP, 32, 2, E>>(a);
  else if constexpr (DP == 16)
    return launch<Pass<DP, 64, 2, E>, Pass<DP, 64, 2, E>>(a);
  else if constexpr (Pass<DP, 32, 1, E>::kSplit)
    return launch<Pass<DP, 128, 2, E>, Pass<DP, 64, 2, E>>(a);
  else
    return launch<Pass<DP, 64, 1, E>, Pass<DP, 64, 1, E>>(a);
}

template <class P>
cudaError_t launch_group(const Args<bf16>& a) {
  const cudaError_t err = prepare(group_attention_bwd_kernel<P>, P::kSmem);
  if (err != cudaSuccess) return err;
  group_attention_bwd_kernel<P><<<dim3(a.heads, a.B), P::kThreads, P::kSmem,
                                  a.st>>>(
      a.q, a.k, a.v, a.dout, a.mask, a.dq, a.dk, a.dv, a.S, a.d, a.scale,
      a.scale * ring::kLog2e);
  return cudaGetLastError();
}

// K6's shapes by length and width: one warpgroup a 64 rows of S up to S =
// 192 at DP <= 64 (three warpgroups, 168 registers a thread); longer heads
// and DP = 128 take K8's two passes at its S < 256 shape (the statistics
// through the scratch)
template <int DP>
cudaError_t group_by_length(const Args<bf16>& a) {
  if constexpr (DP <= 64) {
    if (a.S <= 64) return launch_group<Group<DP, 1>>(a);
    if (a.S <= 128) return launch_group<Group<DP, 2>>(a);
    if (a.S <= 192) return launch_group<Group<DP, 3>>(a);
  }
  return launch<Pass<DP, 32, 1, bf16>, Pass<DP, 32, 1, bf16>>(a);
}

static_assert(Group<64, 3>::kSmem <= 232448, "K6's block fits an SM");
static_assert(Pass<128, 32, 2, float>::kQuerySmem <= 232448 &&
                  Pass<128, 32, 2, float>::kKeySmem <= 232448 &&
                  Pass<64, 128, 2, float>::kQuerySmem <= 232448,
              "a block of two warpgroups fits an SM");
static_assert(3 * Pass<64, 32, 1, float>::kQuerySmem <= 233472,
              "three blocks of K6's route fit an SM at DP = 64");

// q, k, v: [B, heads, S, d] views of E sharing the element strides (sb,
// sh, ss), d contiguous; dout a view with strides (db, dh, ds); dq, dk, dv
// views of E sharing the strides (gb, gh, gs); stats an f32 scratch of 2 *
// B * heads * S values (unused by K6 at the shapes it runs in one launch);
// GROUP: K6's rule (bf16), else K8's
template <class E, bool GROUP = false>
int run(const void* q, const void* k, const void* v, long long sb,
        long long sh, long long ss, const void* dout, long long db,
        long long dh, long long ds, const int* mask, void* dq, void* dk,
        void* dv, long long gb, long long gh, long long gs, float* stats,
        int B, int heads, int S, int d, float scale, void* stream) {
  if (S < 1 || S > kMaxS || d < 16 || d > 128 || d % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto in = [&](const void* p, long long b_, long long h_,
                      long long s_) {
    return HeadIn<E>{static_cast<const E*>(p), b_, h_, s_};
  };
  const auto out = [&](void* p) {
    return HeadOut<E>{static_cast<E*>(p), gb, gh, gs};
  };
  const Args<E> a{in(q, sb, sh, ss), in(k, sb, sh, ss), in(v, sb, sh, ss),
                  in(dout, db, dh, ds), mask, out(dq), out(dk), out(dv),
                  stats, B, heads, S, d, scale,
                  static_cast<cudaStream_t>(stream)};
  const auto rule = [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    if constexpr (GROUP)
      return group_by_length<DP>(a);
    else
      return by_length<DP>(a);
  };
  cudaError_t err;
  if (d <= 16)
    err = rule(std::integral_constant<int, 16>());
  else if (d <= 32)
    err = rule(std::integral_constant<int, 32>());
  else if (d <= 64)
    err = rule(std::integral_constant<int, 64>());
  else
    err = rule(std::integral_constant<int, 128>());
  return static_cast<int>(err);
}

}  // namespace

// The arguments of all three: q, k, v, dout as in run(); mask [B, S]
// int32 (1 = real key); stats written by the first launch, read by the
// second (lse, then rowsum(dP p)). Every row start 16-byte aligned (the
// wrapper checks); d on the 16 grid up to 128, 1 <= S <= 1024, heads and B
// at most 65535. Return cudaGetLastError() after the launches.
extern "C" int sx_bh_attention_bwd(
    const void* q, const void* k, const void* v, long long sb, long long sh,
    long long ss, const void* dout, long long db, long long dh, long long ds,
    const int* mask, void* dq, void* dk, void* dv, long long gb, long long gh,
    long long gs, float* stats, int B, int heads, int S, int d, float scale,
    void* stream) {
  return run<bf16>(q, k, v, sb, sh, ss, dout, db, dh, ds, mask, dq, dk, dv,
                   gb, gh, gs, stats, B, heads, S, d, scale, stream);
}

// K6 (bf16): S <= 255
extern "C" int sx_group_attention_bwd(
    const void* q, const void* k, const void* v, long long sb, long long sh,
    long long ss, const void* dout, long long db, long long dh, long long ds,
    const int* mask, void* dq, void* dk, void* dv, long long gb, long long gh,
    long long gs, float* stats, int B, int heads, int S, int d, float scale,
    void* stream) {
  if (S > 255) return static_cast<int>(cudaErrorInvalidValue);
  return run<bf16, true>(q, k, v, sb, sh, ss, dout, db, dh, ds, mask, dq, dk,
                         dv, gb, gh, gs, stats, B, heads, S, d, scale, stream);
}

extern "C" int sx_attention_bwd_f32(
    const void* q, const void* k, const void* v, long long sb, long long sh,
    long long ss, const void* dout, long long db, long long dh, long long ds,
    const int* mask, void* dq, void* dk, void* dv, long long gb, long long gh,
    long long gs, float* stats, int B, int heads, int S, int d, float scale,
    void* stream) {
  return run<float>(q, k, v, sb, sh, ss, dout, db, dh, ds, mask, dq, dk, dv,
                    gb, gh, gs, stats, B, heads, S, d, scale, stream);
}
