// The f32 instance of K5 group_attention_fwd and K7 bh_attention_fwd
// (sx_attention_fwd_f32): the attention forward on f32 q, k, v, on
// Hopper's warpgroup MMA (wgmma), with the split into bf16 halves inside
// the kernel. One launch a call.
//
// Replaces, for f32 inputs, the forward Pallas kernels of the JAX package:
// simxns_tpu/ops/flash_attention.py:_fwd_call (kernel _fwd_kernel, :67;
// 256 <= S <= 1024) and _fwd_call_group (kernel _fwd_kernel_group, :113;
// S < 256). Both cast q, k, v to f32 inside, so the function is theirs:
//   s = where(mask[key] > 0, q k^T / sqrt(d), -1e9),  o = softmax(s) v,
// a batch row with every key masked getting the uniform softmax over its S
// keys, keys past S in the last tile weight exactly 0, o stored in f32.
// Every operand enters the tensor cores as hi = bf16(x) and lo = bf16(x -
// hi), every product is hi hi + hi lo + lo hi (three bf16 wgmma products
// into one f32 accumulator; lo lo dropped), and p is split the same way
// before p v (attention_wgmma.cuh).
//
// A block per (64 WG query rows, head, batch), in one pass over the keys:
// each warpgroup splits its 64 q rows once, from device memory, into
// resident hi and lo tiles. Tiles of N keys of k and v land as f32 by
// cp.async (the next tile in flight while this one's products run), and
// each landed tile is split once, by all the block's threads, into the hi
// and lo tiles the products read. q k^T is three SS products (k K-major);
// the log2-domain online softmax of attend_one_pass (attention_ring.cuh)
// runs on the accumulators: the masked fill -1e9 log2(e) and -inf past S,
// a running max and sum a row, the o accumulator rescaled when the max
// grows and one reciprocal a row at the end; p, split from the score
// accumulators into hi and lo register fragments, times v is three
// register-A products, v read MN-major from the same split tile through
// the transpose bit (no transposed copy). The kernel writes nothing to
// device memory but o.
//
// Shapes (by_length): from S = 256 (K7's route) two warpgroups a block
// share every landed and split tile, which halves the bytes streamed and
// the split work a row, and run in ping-pong (the second issues its score
// products after the first, whose softmax algebra then runs under them),
// two blocks an SM up to DP = 64; below 256 (K5's route) one warpgroup a
// block and tiles of 32 keys (S = 160 is five of them).
//
// Bound on the card: bytes. At [16, 8, 512, 64] q, k, v and o are 67 MB,
// 0.020 ms at 3.35 TB/s; the model's 2 products of 2 S^2 d per head are
// 8.6 GFLOP (0.017 ms at TF32's 495 TFLOP/s), and this design runs them as
// 6 bf16 products, 25.8 GFLOP, 0.026 ms at the bf16 peak. The split of
// every streamed tile (each block splits its head's k and v again), the
// softmax algebra and the barriers run beside them.
#include "attention_wgmma.cuh"

SX_DEFINE_ERROR_STRING

namespace {

// The forward's shape: DP columns, N keys a streamed tile, WG warpgroups
// of 64 query rows each (two share each streamed tile), at least MIN
// blocks an SM (launch bounds). Shared memory: WG x 2 resident tiles (q's
// hi and lo), 4 streamed tiles (k's and v's), the f32 landing of k and v,
// then the key fills and the key tiles' flags up to kMaxKeys (255 keys
// with one warpgroup, by_length's rule, else kMaxS).
template <int DP_, int N_, int WG_, int MIN_>
struct Fwd {
  static constexpr int DP = DP_, N = N_, WG = WG_, kMinBlocks = MIN_;
  static constexpr int kThreads = 128 * WG;
  static constexpr int kMaxKeys = WG == 1 ? 256 : kMaxS;
  using Res = Tile<DP, kRows>;
  using Str = Tile<DP, N>;
  static constexpr int kResident = WG * 2 * Res::kBytes;
  static constexpr int kStreamed = 4 * Str::kBytes;
  static constexpr int kLanding = 2 * N * DP * 4;
  static constexpr int kSmem = 1024 + kResident + kStreamed + kLanding +
                               kMaxKeys * 4 + kMaxKeys / N * 4;
};

// One key tile of the online softmax on the score accumulators sc (q k^T;
// fill the tile's key fills): scores in the log2 domain, the running max
// mx (quad-reduced) and the thread's partial sums grown, acc rescaled by
// 2^(max_old - max_new), sc turned into p = 2^(s - max).
template <bool REAL = false, int NT, int ND>
__device__ __forceinline__ void softmax_tile(float (&sc)[NT][4],
                                             const float* fill, float scale2,
                                             float (&mx)[2], float (&sum)[2],
                                             float (&acc)[ND][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sc[nt][e] =
          bwd::score<REAL>(sc[nt][e], fill[nt * 8 + 2 * t + (e & 1)], scale2);
  float cm[2], alpha[2];
  ring::tile_max(sc, cm);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(mx[r], cm[r]);
    alpha[r] = mx[r] == -INFINITY ? 0.0f : ring::ex2(mx[r] - m_new);
    sum[r] *= alpha[r];
    mx[r] = m_new;
  }
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] *= alpha[e >> 1];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[nt][e] = ring::ex2(sc[nt][e] - mx[e >> 1]);
      sum[e >> 1] += sc[nt][e];
    }
}

template <class P>
__global__ void __launch_bounds__(P::kThreads, P::kMinBlocks)
    attention_fwd(F32In q, F32In k, F32In v, const int* __restrict__ mask,
                  F32Out o, int S, int d, float scale2) {
  constexpr int DP = P::DP, N = P::N, T = P::kThreads;
  using R = typename P::Res;
  using Str = typename P::Str;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = aligned_smem(smem_raw);
  const int tid = threadIdx.x, wtid = tid & 127;
  uint8_t* qh = base + (tid >> 7) * 2 * R::kBytes;   // this warpgroup's
  uint8_t* ql = qh + R::kBytes;
  uint8_t* kh = base + P::kResident;                 // the key tile's
  uint8_t* kl = kh + Str::kBytes;
  uint8_t* vh = kl + Str::kBytes;
  uint8_t* vl = vh + Str::kBytes;
  float* land_k = reinterpret_cast<float*>(vl + Str::kBytes);
  float* land_v = land_k + N * DP;
  float* fill = land_v + N * DP;
  int* real = reinterpret_cast<int*>(fill + P::kMaxKeys);  // a tile all real
  const int h = blockIdx.y, b = blockIdx.z;
  const int qw = blockIdx.x * T / 2 + (tid >> 7) * kRows;   // its rows
  const int n_tiles = (S + N - 1) / N;
  auto issue = [&](int tile) {
    const int j0 = tile * N;
    land<DP, N, T>(land_k, [&](int i) { return k.row(b, h, i); }, j0, S, d,
                   tid);
    land<DP, N, T>(land_v, [&](int i) { return v.row(b, h, i); }, j0, S, d,
                   tid);
    wg::cp_async_commit();
  };
  // key tile `tile` split and visible to wgmma; the next tile landing
  // behind it
  auto prepare = [&](int tile) {
    wg::cp_async_wait_all();
    __syncthreads();
    split_tile<DP, N, T>(kh, kl, land_k, tid);
    split_tile<DP, N, T>(vh, vl, land_v, tid);
    wg::fence_proxy_async();
    __syncthreads();
    if (tile + 1 < n_tiles) issue(tile + 1);
  };
  issue(0);
  split_rows<DP>(qh, ql, [&](int i) { return q.row(b, h, i); }, qw, S, d,
                 wtid);
  key_fills<N, T>(fill, real, mask, b, S, n_tiles, tid);
  prepare(0);   // its fence and barriers publish the flags and the tiles

  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
  float acc[DP / 8][4];
  float(&accf)[DP / 2] = flat<DP>(acc);
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) accf[i] = 0.0f;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const float* f = fill + tile * N;
    float sc[N / 8][4];
    before_scores<P::WG>();
    issue_score<DP, N>(sc, qh, ql, kh, kl);
    after_scores<P::WG>();
    wait_score<N>(sc);
    if (real[tile])
      softmax_tile<true>(sc, f, scale2, mx, sum, acc);
    else
      softmax_tile(sc, f, scale2, mx, sum, acc);
    uint32_t ph[N / 16][4], pl[N / 16][4];
    fragments<N>(ph, pl, sc);
    wg::fence_operands(accf);
    wg::wgmma_fence();
    issue_times<DP, N>(accf, ph, pl, vh, vl);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_operands(accf);
    fence_fragments(ph);
    fence_fragments(pl);
    if (tile + 1 < n_tiles) prepare(tile + 1);
  }
  const float inv[2] = {1.0f / ring::quad<1>(sum[0]),
                        1.0f / ring::quad<1>(sum[1])};
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] *= inv[e >> 1];
  store_rows<DP>(o, b, h, qw + ((tid >> 5) & 3) * 16, S, d, acc, 1.0f);
}

struct Args {
  F32In q, k, v;
  const int* mask;
  F32Out o;
  int B, heads, S, d;
  float scale;
  cudaStream_t st;
};

template <class P>
cudaError_t launch(const Args& a) {
  const cudaError_t err = prepare(attention_fwd<P>, P::kSmem);
  if (err != cudaSuccess) return err;
  const int rows = 64 * P::WG;
  attention_fwd<P><<<dim3((a.S + rows - 1) / rows, a.heads, a.B),
                     P::kThreads, P::kSmem, a.st>>>(
      a.q, a.k, a.v, a.mask, a.o, a.S, a.d, a.scale * ring::kLog2e);
  return cudaGetLastError();
}

// The shapes by length and width (measured on an H100 with variants of
// this rule at phase 23's shapes). Below S = 256 (K5's route): one
// warpgroup a block (64-row tiles pad S = 160 to 192, 128-row ones would
// pad it to 256) and key tiles of 32 (S = 160 is five of them), four
// blocks an SM up to DP = 64, two at 128 (shared memory and registers);
// 64-key tiles ran 1.1-1.5x slower there. From 256 (K7's route): two
// warpgroups a block share each landed and split tile in ping-pong, key
// tiles of 64, and two blocks an SM up to DP = 64 (128 registers a
// thread, no spills), so that one block's split and softmax run under the
// other's products: 19% less time at DP = 64 than one block of 141
// registers; 128-key tiles, 32-key tiles and one warpgroup a block were
// slower. At DP = 128 one block fits an SM (197 KB of shared memory).
template <int DP>
cudaError_t by_length(const Args& a) {
  if (a.S < 256) return launch<Fwd<DP, 32, 1, DP <= 64 ? 4 : 2>>(a);
  return launch<Fwd<DP, 64, 2, DP <= 64 ? 2 : 1>>(a);
}

static_assert(Fwd<128, 64, 2, 1>::kSmem <= 232448,
              "a block of two warpgroups fits an SM at DP = 128, S = 1024");
static_assert(2 * Fwd<64, 64, 2, 2>::kSmem <= 233472 &&
                  4 * Fwd<64, 32, 1, 4>::kSmem <= 233472 &&
                  2 * Fwd<128, 32, 1, 2>::kSmem <= 233472,
              "the blocks an SM the launch bounds ask for fit its shared "
              "memory");

}  // namespace

// q, k, v: [B, heads, S, d] f32 views sharing the element strides (sb, sh,
// ss), d contiguous; mask [B, S] int32 (1 = real key); o an f32 view with
// strides (ob, oh, os). Every row start 16-byte aligned (the wrapper
// checks); d on the 16 grid up to 128, 1 <= S <= 1024, heads and B at most
// 65535. Returns cudaGetLastError() after the launch. The arguments of
// sx_bh_attention_fwd, in f32.
extern "C" int sx_attention_fwd_f32(
    const void* q, const void* k, const void* v, long long sb, long long sh,
    long long ss, const int* mask, void* o, long long ob, long long oh,
    long long os, int B, int heads, int S, int d, float scale,
    void* stream) {
  if (S < 1 || S > kMaxS || d < 16 || d > 128 || d % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto in = [&](const void* p) {
    return F32In{static_cast<const float*>(p), sb, sh, ss};
  };
  const Args a{in(q), in(k), in(v), mask,
               F32Out{static_cast<float*>(o), ob, oh, os}, B, heads, S, d,
               scale, static_cast<cudaStream_t>(stream)};
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
