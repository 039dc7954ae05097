// K5 group_attention_fwd and K7 bh_attention_fwd, both instances
// (sx_group_attention_fwd, sx_bh_attention_fwd, sx_attention_fwd_f32): the
// attention forward on Hopper's warpgroup MMA (wgmma), one source with two
// instances by the input type E: bf16 and f32 (K5's and K7's f32 instance
// is one entry point). One launch a call.
//
// Replaces the forward Pallas kernels of the JAX package:
// simxns_tpu/ops/flash_attention.py:_fwd_call_group (kernel
// _fwd_kernel_group, :113; S < 256) and _fwd_call (kernel _fwd_kernel,
// :67; 256 <= S <= 1024). Both cast q, k, v to f32 inside, so the function
// is theirs:
//   s = where(mask[key] > 0, q k^T / sqrt(d), -1e9),  o = softmax(s) v,
// a batch row with every key masked getting the uniform softmax over its S
// keys, keys past S in the last tile weight exactly 0, o stored in E
// (rounded once). bf16 q, k, v enter the tensor cores as they are: q k^T
// is one bf16 product. f32 ones are split into hi = bf16(x) and lo =
// bf16(x - hi), and their every product is hi hi + hi lo + lo hi (three
// bf16 wgmma products into one f32 accumulator; lo lo dropped). p is f32
// in both: it enters p v as hi and lo register fragments (two products
// with a bf16 tile, hi before lo in each k16 step; three with a split
// one).
//
// A block per (64 WG query rows, head, batch), in one pass over the keys.
// bf16: each warpgroup lands its 64 q rows once by cp.async straight into
// a resident swizzled tile, and tiles of N keys of k and v land the same
// way into a ring of STAGES stages (the next tiles in flight while this
// one's products run; one block barrier a tile). f32: each warpgroup
// splits its q rows once, from device memory, into resident hi and lo
// tiles; k and v tiles land as f32 by cp.async and each landed tile is
// split once, by all the block's threads, into the hi and lo tiles the
// products read. q k^T is an SS product (k K-major); a log2-domain online
// softmax runs on the
// accumulators: the masked fill -1e9 log2(e) and -inf past S, a running
// max and sum a row, the o accumulator rescaled when the max grows and
// one reciprocal a row at the end; p, split from the score accumulators
// into hi and lo register fragments, times v is register-A products, v
// read MN-major from its tile through the transpose bit (no transposed
// copy). The kernel writes nothing to device memory but o. K5's route
// (S < 256) launches the kernel under its own name,
// group_attention_fwd_kernel, so that a profile tells it from K7's.
//
// Shapes (by_length and by_length_bf16, measured on an H100 with
// scripts/torch_attention_shapes.py --kernel k5 and --kernel k7 and, for
// f32, scripts/torch_fwd_f32_shapes.py): below S = 256 (K5's route) one
// warpgroup a block and tiles of 32 keys (S = 160 is five of them), six
// blocks an SM in bf16 and four in f32 up to DP = 64; from S = 256 (K7's
// route) two warpgroups a block share every landed tile, which halves the
// bytes streamed a row (and the split, in f32), and run in ping-pong (the
// second issues its score products after the first, whose softmax
// algebra then runs under them), two blocks an SM up to DP = 64.
//
// Bound on the card: bytes. At the nq reranker's shape ([128, 16, 160,
// 64] bf16) q, k, v and o are 168 MB, 0.050 ms at 3.35 TB/s; the model's
// 2 products of 2 S^2 d a head are 13 GFLOP, which this design runs as 3
// (q k^T, and p v as hi and lo), 20 GFLOP, 0.020 ms at the bf16 peak, and
// 52 M ex2, 0.014 ms at 16 a clock an SM. At the msdoc reranker's shape
// ([128, 12, 512, 64] bf16) 403 MB, 0.120 ms; 155 GFLOP as 3 products,
// 0.156 ms; 403 M ex2, 0.109 ms. At [16, 8, 512, 64] f32, q, k, v and o
// are 67 MB, 0.020 ms; the model's 8.6 GFLOP take 0.017 ms at TF32's 495
// TFLOP/s, and this design runs them as 6 bf16 products, 25.8 GFLOP, 0.026
// ms at the bf16 peak. The softmax algebra, the landing (and the split, in
// f32) and the barriers run beside the products.
#include <type_traits>

#include "attention_wgmma.cuh"

SX_DEFINE_ERROR_STRING

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxGroupS = 255;   // K5's route: S < 256

// The forward's shape: DP columns, N keys a streamed tile, WG warpgroups
// of 64 query rows each (two share each streamed tile), at least MIN
// blocks an SM (launch bounds), inputs of type E, STAGES stages of bf16
// key tiles. Shared memory: WG resident q tiles (hi and lo each when
// split), the streamed tiles (f32: hi and lo of k and v; bf16: k and v in
// STAGES stages), the f32 landing of k and v (f32 only), then the key
// fills and the key tiles' flags up to kMaxKeys (255 keys for one
// warpgroup, which both rules run only below S = 256, else kMaxS).
template <int DP_, int N_, int WG_, int MIN_, class E_ = float,
          int STAGES_ = 2>
struct Fwd {
  static constexpr int DP = DP_, N = N_, WG = WG_, kMinBlocks = MIN_;
  static constexpr int kStages = STAGES_;
  using E = E_;
  static constexpr bool kSplit = std::is_same<E, float>::value;
  static constexpr int kThreads = 128 * WG;
  static constexpr int kMaxKeys = WG == 1 ? 256 : kMaxS;
  using Res = Tile<DP, kRows>;
  using Str = Tile<DP, N>;
  static constexpr int kResident = WG * (kSplit ? 2 : 1) * Res::kBytes;
  static constexpr int kStreamed =
      (kSplit ? 4 : 2 * kStages) * Str::kBytes;
  static constexpr int kLanding = kSplit ? 2 * N * DP * 4 : 0;
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

// the kernel body of both names below
template <class P>
__device__ __forceinline__ void attend(
    HeadIn<typename P::E> q, HeadIn<typename P::E> k, HeadIn<typename P::E> v,
    const int* __restrict__ mask, HeadOut<typename P::E> o, int S, int d,
    float scale2) {
  constexpr int DP = P::DP, N = P::N, T = P::kThreads;
  constexpr bool kSplit = P::kSplit;
  using R = typename P::Res;
  using Str = typename P::Str;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = aligned_smem(smem_raw);
  const int tid = threadIdx.x, wtid = tid & 127;
  // this warpgroup's q tiles (hi and lo when split)
  uint8_t* qh = base + (tid >> 7) * (kSplit ? 2 : 1) * R::kBytes;
  uint8_t* ql = kSplit ? qh + R::kBytes : qh;
  uint8_t* t0 = base + P::kResident;        // the key tiles
  float* land_k = reinterpret_cast<float*>(t0 + P::kStreamed);
  float* land_v = land_k + (kSplit ? N * DP : 0);
  float* fill = reinterpret_cast<float*>(t0 + P::kStreamed + P::kLanding);
  int* real = reinterpret_cast<int*>(fill + P::kMaxKeys);  // a tile all real
  const int h = blockIdx.y, b = blockIdx.z;
  const int qw = blockIdx.x * T / 2 + (tid >> 7) * kRows;   // its rows
  const int n_tiles = (S + N - 1) / N;
  // f32: the split k and v tiles (one stage); bf16: stage tile % kStages
  auto kv_tiles = [&](int tile, uint8_t*& kh, uint8_t*& kl, uint8_t*& vh,
                      uint8_t*& vl) {
    if constexpr (kSplit) {
      kh = t0, kl = t0 + Str::kBytes;
      vh = kl + Str::kBytes, vl = vh + Str::kBytes;
    } else {
      kh = kl = t0 + tile % P::kStages * 2 * Str::kBytes;
      vh = vl = kh + Str::kBytes;
    }
  };
  auto issue = [&](int tile) {
    const int j0 = tile * N;
    if constexpr (kSplit) {
      land<DP, N, T>(land_k, [&](int i) { return k.row(b, h, i); }, j0, S,
                     d, tid);
      land<DP, N, T>(land_v, [&](int i) { return v.row(b, h, i); }, j0, S,
                     d, tid);
    } else {
      uint8_t *kh, *kl, *vh, *vl;
      kv_tiles(tile, kh, kl, vh, vl);
      land_tile<DP, N, T>(kh, [&](int i) { return k.row(b, h, i); }, j0, S,
                          d, tid);
      land_tile<DP, N, T>(vh, [&](int i) { return v.row(b, h, i); }, j0, S,
                          d, tid);
    }
  };
  // f32: key tile `tile` split and visible to wgmma; the next tile landing
  // behind it
  auto publish = [&](int tile) {
    wg::cp_async_wait_all();
    __syncthreads();
    split_tile<DP, N, T>(t0, t0 + Str::kBytes, land_k, tid);
    split_tile<DP, N, T>(t0 + 2 * Str::kBytes, t0 + 3 * Str::kBytes, land_v,
                         tid);
    wg::fence_proxy_async();
    __syncthreads();
    if (tile + 1 < n_tiles) {
      issue(tile + 1);
      wg::cp_async_commit();
    }
  };
  if constexpr (kSplit) {
    issue(0);
    wg::cp_async_commit();
    split_rows<DP>(qh, ql, [&](int i) { return q.row(b, h, i); }, qw, S, d,
                   wtid);
  } else {   // q rides with the first key tile; kStages - 1 tiles ahead
    land_tile<DP, kRows, 128>(qh, [&](int i) { return q.row(b, h, i); }, qw,
                              S, d, wtid);
#pragma unroll
    for (int i = 0; i < P::kStages - 1; ++i) {
      if (i < n_tiles) issue(i);
      wg::cp_async_commit();
    }
  }
  key_fills<N, T>(fill, real, mask, b, S, n_tiles, tid);
  // f32: its fence and barriers publish the flags and the tiles; bf16: the
  // first barrier of the loop does
  if constexpr (kSplit) publish(0);

  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
  float acc[DP / 8][4];
  float(&accf)[DP / 2] = flat<DP>(acc);
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) accf[i] = 0.0f;
  for (int tile = 0; tile < n_tiles; ++tile) {
    if constexpr (!kSplit) {   // this tile landed; the stage read
      wg::cp_async_wait<P::kStages - 2>();   // before it free for a later
      wg::fence_proxy_async();               // one
      __syncthreads();
      if (tile + P::kStages - 1 < n_tiles) issue(tile + P::kStages - 1);
      wg::cp_async_commit();
    }
    uint8_t *kh, *kl, *vh, *vl;
    kv_tiles(tile, kh, kl, vh, vl);
    float sc[N / 8][4];
    before_scores<P::WG>();
    issue_score<DP, N, kSplit>(sc, qh, ql, kh, kl);
    after_scores<P::WG>();
    wait_score<N>(sc);
    const float* f = fill + tile * N;
    if (real[tile])
      softmax_tile<true>(sc, f, scale2, mx, sum, acc);
    else
      softmax_tile(sc, f, scale2, mx, sum, acc);
    uint32_t ph[N / 16][4], pl[N / 16][4];
    fragments<N>(ph, pl, sc);
    wg::fence_operands(accf);
    wg::wgmma_fence();
    issue_times<DP, N, kSplit, !kSplit>(accf, ph, pl, vh, vl);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_operands(accf);
    fence_fragments(ph);
    fence_fragments(pl);
    if constexpr (kSplit)
      if (tile + 1 < n_tiles) publish(tile + 1);
  }
  const float inv[2] = {1.0f / ring::quad<1>(sum[0]),
                        1.0f / ring::quad<1>(sum[1])};
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] *= inv[e >> 1];
  store_rows<DP>(o, b, h, qw + ((tid >> 5) & 3) * 16, S, d, acc, 1.0f);
}

template <class P>
__global__ void __launch_bounds__(P::kThreads, P::kMinBlocks)
    attention_fwd(HeadIn<typename P::E> q, HeadIn<typename P::E> k,
                  HeadIn<typename P::E> v, const int* __restrict__ mask,
                  HeadOut<typename P::E> o, int S, int d, float scale2) {
  attend<P>(q, k, v, mask, o, S, d, scale2);
}

// the same kernel under a name of its own for K5's route (S < 256)
template <class P>
__global__ void __launch_bounds__(P::kThreads, P::kMinBlocks)
    group_attention_fwd_kernel(HeadIn<typename P::E> q,
                               HeadIn<typename P::E> k,
                               HeadIn<typename P::E> v,
                               const int* __restrict__ mask,
                               HeadOut<typename P::E> o, int S, int d,
                               float scale2) {
  attend<P>(q, k, v, mask, o, S, d, scale2);
}

template <class E>
struct Args {
  HeadIn<E> q, k, v;
  const int* mask;
  HeadOut<E> o;
  int B, heads, S, d;
  float scale;
  cudaStream_t st;
};

// GROUP: launched as group_attention_fwd_kernel (K5's route)
template <class P, bool GROUP = false>
cudaError_t launch(const Args<typename P::E>& a) {
  const auto kernel = [] {
    if constexpr (GROUP)
      return group_attention_fwd_kernel<P>;
    else
      return attention_fwd<P>;
  }();
  const cudaError_t err = prepare(kernel, P::kSmem);
  if (err != cudaSuccess) return err;
  const int rows = 64 * P::WG;
  kernel<<<dim3((a.S + rows - 1) / rows, a.heads, a.B), P::kThreads,
           P::kSmem, a.st>>>(a.q, a.k, a.v, a.mask, a.o, a.S, a.d,
                             a.scale * ring::kLog2e);
  return cudaGetLastError();
}

// The f32 instance's shapes by length and width (measured on an H100 with
// variants of this rule at phase 23's shapes). Below S = 256 (K5's route):
// one warpgroup a block (64-row tiles pad S = 160 to 192, 128-row ones
// would pad it to 256) and key tiles of 32 (S = 160 is five of them), four
// blocks an SM up to DP = 64, two at 128 (shared memory and registers);
// 64-key tiles ran 1.1-1.5x slower there. From 256 (K7's route): two
// warpgroups a block share each landed and split tile in ping-pong, key
// tiles of 64, and two blocks an SM up to DP = 64 (128 registers a
// thread, no spills), so that one block's split and softmax run under the
// other's products: 19% less time at DP = 64 than one block of 141
// registers; 128-key tiles, 32-key tiles and one warpgroup a block were
// slower. At DP = 128 one block fits an SM (197 KB of shared memory).
template <int DP>
cudaError_t by_length(const Args<float>& a) {
  if (a.S < 256) return launch<Fwd<DP, 32, 1, DP <= 64 ? 4 : 2>>(a);
  return launch<Fwd<DP, 64, 2, DP <= 64 ? 2 : 1>>(a);
}

// The bf16 instance's shapes by length. Below S = 256 (K5's route): one
// warpgroup a block, 32-key tiles in two stages (its o is then the
// mma.sync kernel's that it replaced, bit for bit), six blocks an SM up to
// DP = 64 (no spills; 3-5% faster than four or five, and seven spill and
// take twice the time). 64-key tiles lost at S = 160 (it
// pads to 192 keys), three stages, 128 query rows a block (S = 160 pads to
// 256), one block a head and every key in one tile (S <= 192, exact row
// max) did not win (chosen on an H100 with
// scripts/torch_attention_shapes.py --kernel k5). From 256 (K7's route):
// two warpgroups a block in ping-pong on 64-key tiles in two stages, two
// blocks an SM up to DP = 64 (--kernel k7).
template <int DP>
cudaError_t by_length_bf16(const Args<bf16>& a) {
  if (a.S < 256)
    return launch<Fwd<DP, 32, 1, DP <= 64 ? 6 : 2, bf16, 2>, true>(a);
  return launch<Fwd<DP, 64, 2, DP <= 64 ? 2 : 1, bf16, 2>>(a);
}

static_assert(Fwd<128, 64, 2, 1>::kSmem <= 232448,
              "a block of two warpgroups fits an SM at DP = 128, S = 1024");
static_assert(2 * Fwd<64, 64, 2, 2>::kSmem <= 233472 &&
                  4 * Fwd<64, 32, 1, 4>::kSmem <= 233472 &&
                  2 * Fwd<128, 32, 1, 2>::kSmem <= 233472 &&
                  2 * Fwd<64, 64, 2, 2, bf16, 2>::kSmem <= 233472 &&
                  6 * Fwd<64, 32, 1, 6, bf16, 2>::kSmem <= 233472 &&
                  2 * Fwd<128, 32, 1, 2, bf16, 2>::kSmem <= 233472,
              "the blocks an SM the launch bounds ask for fit its shared "
              "memory");

// q, k, v: [B, heads, S, d] views of E sharing the element strides (sb,
// sh, ss), d contiguous; o a view of E with strides (ob, oh, os)
template <class E>
int run(const void* q, const void* k, const void* v, long long sb,
        long long sh, long long ss, const int* mask, void* o, long long ob,
        long long oh, long long os, int B, int heads, int S, int d,
        float scale, void* stream) {
  if (S < 1 || S > kMaxS || d < 16 || d > 128 || d % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto in = [&](const void* p) {
    return HeadIn<E>{static_cast<const E*>(p), sb, sh, ss};
  };
  const Args<E> a{in(q), in(k), in(v), mask,
                  HeadOut<E>{static_cast<E*>(o), ob, oh, os}, B, heads, S,
                  d, scale, static_cast<cudaStream_t>(stream)};
  const auto rule = [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    if constexpr (std::is_same<E, float>::value)
      return by_length<DP>(a);
    else
      return by_length_bf16<DP>(a);
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

// The arguments of every entry point: q, k, v, o as in run(); mask [B, S]
// int32 (1 = real key). Every row start 16-byte aligned (the wrapper
// checks); d on the 16 grid up to 128 (the wrapper pads other widths), 1
// <= S <= 1024 (K5: S < 256), heads and B at most 65535. Return
// cudaGetLastError() after the launch.
extern "C" int sx_group_attention_fwd(
    const void* q, const void* k, const void* v, long long sb, long long sh,
    long long ss, const int* mask, void* o, long long ob, long long oh,
    long long os, int B, int heads, int S, int d, float scale,
    void* stream) {
  if (S > kMaxGroupS) return static_cast<int>(cudaErrorInvalidValue);
  return run<bf16>(q, k, v, sb, sh, ss, mask, o, ob, oh, os, B, heads, S, d,
                   scale, stream);
}

extern "C" int sx_bh_attention_fwd(
    const void* q, const void* k, const void* v, long long sb, long long sh,
    long long ss, const int* mask, void* o, long long ob, long long oh,
    long long os, int B, int heads, int S, int d, float scale,
    void* stream) {
  return run<bf16>(q, k, v, sb, sh, ss, mask, o, ob, oh, os, B, heads, S, d,
                   scale, stream);
}

extern "C" int sx_attention_fwd_f32(
    const void* q, const void* k, const void* v, long long sb, long long sh,
    long long ss, const int* mask, void* o, long long ob, long long oh,
    long long os, int B, int heads, int S, int d, float scale,
    void* stream) {
  return run<float>(q, k, v, sb, sh, ss, mask, o, ob, oh, os, B, heads, S, d,
                    scale, stream);
}
