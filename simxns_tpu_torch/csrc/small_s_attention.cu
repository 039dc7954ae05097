// K3 small_s_attention: softmax(q k^T / sqrt(d) + bias) v for every
// (sequence, head), any S, on Hopper's warpgroup MMA (wgmma).
//
// Replaces the attention core of the TPU whole-layer kernel
// (simxns_tpu/ops/fused_layer.py:_layer_kernel :115-138): q, k, v bf16;
// scores in f32 (dot * (1/sqrt(d)), then + bias, bias = 0 or -1e9 from the
// key mask); subtract the row max, exp, normalise by the sum, all f32; p
// cast to bf16 AFTER the normalisation (the TPU kernel's rounding of p);
// p v accumulated in f32. The context is written f32 into [M, H] at column
// head * d, so the next kernel (row_quant) quantizes whole rows across all
// heads, as the TPU kernel does. Keys past S weigh exactly 0.
//
// Bound on the card: bytes at S = 128 (4 S^2 d of products per head
// against 3 S d * 2 bytes read and S d * 4 written), the tensor cores'
// rate past S ~ 300. The design (attention_wgmma.cuh): a block per (64 WG
// query rows, head, sequence); each warpgroup lands its q rows once, by
// cp.async, as they are, into a resident swizzled tile. Tiles of N keys of
// k (and v) land the same way, with the tile's N key-mask values, into two
// stages, the next tile's copy in flight under this one's work. q k^T is
// one SS bf16 wgmma product a k16 step (k K-major). The softmax has to use
// the final row max and sum before p is rounded, so there are two passes
// over the keys: pass 1 folds each row's max and sum of 2^(s - max) (the
// sum rescaled when the max grows); pass 2 recomputes the scores, forms p
// = bf16(2^(s - max) / sum) in registers, which are the register A
// fragments of p v (one bf16 product a k16 step: p is already rounded), v
// read MN-major from its tile through the transpose bit. Where the keys
// fit one tile (S <= 192) the scores of pass 1 stay in registers: one q
// k^T and one landing of k and v, v's under q k^T and the softmax. Scores
// are scaled by log2(e) / sqrt(d) and the bias by log2(e), so each
// exponential is one ex2; in a tile of real keys only (flagged once a
// block from the mask) the scale rides in the FMA that subtracts the row
// max, and the bias is not formed. Each row takes one reciprocal of its
// sum, and the quotient is corrected to the true
// division's rounding by two FMAs (a product with the reciprocal alone
// moved enough bf16 roundings of p to reorder near-ties of a 12-layer
// encode's top-10). Keys past S get a -inf bias, so they add exactly 0.
// Each key tile brings its own mask values, so nothing in shared memory
// grows with S: every S the layer's dispatch admits runs.
//
// Tiles are rows of DP bf16 values: d (on the 16 grid; the wrapper pads
// other widths with zero columns) rounded up to 16, 32, 64 or 128, so d =
// 48 runs at 64 and d = 80, 96, 112 at 128; columns past d land as zeros,
// which add exact zeros to every score, and are not stored.
#include "attention_wgmma.cuh"

SX_DEFINE_ERROR_STRING

namespace {

constexpr float kMasked = -1e9f * ring::kLog2e;   // the mask's bias, log2

// K3's shape: DP columns, N keys a streamed tile, WG warpgroups of 64
// query rows each (two share each streamed tile, in ping-pong), at least
// MIN blocks an SM (launch bounds); ONE: every key in one tile (S <= N),
// landed once with v, its scores kept from pass 1 to pass 2. Shared
// memory: WG resident q tiles, the streamed k and v tiles (two stages,
// one when ONE), each stage's N key-mask values, and a bit a key tile
// (the first 64) for a tile that is not all real keys.
template <int DP_, int N_, int WG_, int MIN_, bool ONE_>
struct Shape {
  static constexpr int DP = DP_, N = N_, WG = WG_, kMinBlocks = MIN_;
  static constexpr bool kOne = ONE_;
  static constexpr int kThreads = 128 * WG;
  static constexpr int kStages = ONE_ ? 1 : 2;
  using Res = Tile<DP, kRows>;
  using Str = Tile<DP, N>;
  static constexpr int kResident = WG * Res::kBytes;
  static constexpr int kStreamed = kStages * 2 * Str::kBytes;
  static constexpr int kSmem =
      1024 + kResident + kStreamed + kStages * N * 4 + 8;
};

template <class P>
__global__ void __launch_bounds__(P::kThreads, P::kMinBlocks)
    small_s_attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                             const int* __restrict__ mask,
                             float* __restrict__ ctx, int S, int H, int d,
                             float scale2) {
  constexpr int DP = P::DP, N = P::N, T = P::kThreads;
  using Str = typename P::Str;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = aligned_smem(smem_raw);
  const int tid = threadIdx.x, wtid = tid & 127;
  uint8_t* qt = base + (tid >> 7) * P::Res::kBytes;   // this warpgroup's q
  uint8_t* t0 = base + P::kResident;        // [stage][k, v] tiles
  int* keys = reinterpret_cast<int*>(t0 + P::kStreamed);  // [stage][N]
  auto* masked = reinterpret_cast<unsigned long long*>(keys + P::kStages * N);
  const int head = blockIdx.y, seq = blockIdx.z;
  const int qw = blockIdx.x * P::WG * kRows + (tid >> 7) * kRows;
  const int t = tid & 3;
  const long long ld = 3LL * H;
  const __nv_bfloat16* rows =
      qkv + static_cast<long long>(seq) * S * ld + head * d;
  const int* m = mask + static_cast<long long>(seq) * S;
  const int n = (S + N - 1) / N;
  // step s < n walks key tile s for pass 1, step n + j key tile j for
  // pass 2 (ONE: step 0 is both)
  const int steps = P::kOne ? 1 : 2 * n;
  auto land_v = [&](int step) {
    land_tile<DP, N, T>(t0 + (step % P::kStages * 2 + 1) * Str::kBytes,
                        [&](int i) { return rows + i * ld + 2 * H; },
                        step % n * N, S, d, tid);
  };
  auto issue = [&](int step) {   // k, the mask values (and v in pass 2)
    const int j0 = step % n * N, st = step % P::kStages;
    land_tile<DP, N, T>(t0 + st * 2 * Str::kBytes,
                        [&](int i) { return rows + i * ld + H; }, j0, S, d,
                        tid);
    if (!P::kOne && step >= n) land_v(step);
    for (int i = tid; i < N; i += T) {
      const bool ok = j0 + i < S;
      sx::bwd::cp_async4(keys + st * N + i, m + (ok ? j0 + i : 0), ok);
    }
    wg::cp_async_commit();
  };
  if (tid == 0) *masked = 0;
  __syncthreads();
  issue(0);
  land_tile<DP, kRows, 128>(qt, [&](int i) { return rows + i * ld; }, qw, S,
                            d, wtid);
  wg::cp_async_commit();
  {   // the key tiles (of the first 64) with a masked key or one past S
    unsigned long long bits = 0;
    for (int j = tid; j < (n < 64 ? n : 64) * N; j += T)
      if (j >= S || m[j] <= 0) bits |= 1ull << (j / N);
    if (bits) atomicOr(masked, bits);
  }
  auto publish = [&] {   // the copies landed and visible to wgmma
    wg::cp_async_wait_all();
    wg::fence_proxy_async();
    __syncthreads();
  };
  if constexpr (P::kOne) {   // v lands under q k^T and the softmax
    land_v(0);
    wg::cp_async_commit();
    wg::cp_async_wait<1>();
    wg::fence_proxy_async();
    __syncthreads();
  } else {
    publish();
  }
  const unsigned long long not_real = *masked;

  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f}, inv[2];
  float acc[DP / 8][4];
  float(&accf)[DP / 2] = flat<DP>(acc);
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) accf[i] = 0.0f;
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) issue(step + 1);   // behind this step's work
    const int tile = step % n, st = step % P::kStages;
    const uint8_t* kt = t0 + st * 2 * Str::kBytes;
    const int* key = keys + st * N;
    float sc[N / 8][4];
    before_scores<P::WG>();
    issue_score<DP, N, false>(sc, qt, qt, kt, kt);
    after_scores<P::WG>();
    wait_score<N>(sc);
    // f32 scores in the log2 domain: dot * scale2 + bias. A tile of real
    // keys keeps the products (its scores are dot * scale2, folded into
    // the exponent's FMA below); another gets its bias here
    const bool real = tile < 64 && !((not_real >> tile) & 1);
    if (!real) {
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + 2 * t + (e & 1);
          const float bias = tile * N + col >= S ? -INFINITY
                             : key[col] > 0      ? 0.0f
                                                 : kMasked;
          sc[nt][e] = __fmaf_rn(sc[nt][e], scale2, bias);
        }
    }
    // 2^(s - mx) of element (nt, e): s = sc * mul, one rounding with the
    // subtraction (s itself where the bias is in: mul = 1)
    const float mul = real ? scale2 : 1.0f;
    auto exp_of = [&](int nt, int e) {
      return ring::ex2(__fmaf_rn(sc[nt][e], mul, -mx[e >> 1]));
    };
    if (step < n) {   // pass 1: the running max and sum
      float cm[2];
      ring::tile_max(sc, cm);
      cm[0] *= mul, cm[1] *= mul;   // mul > 0: the max of the scores
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(mx[r], cm[r]);
        sum[r] = mx[r] == -INFINITY ? 0.0f : sum[r] * ring::ex2(mx[r] - m_new);
        mx[r] = m_new;
      }
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[e >> 1] += exp_of(nt, e);
    }
    if (P::kOne || step >= n) {   // pass 2: p, then acc += p v
      if (step == (P::kOne ? 0 : n)) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          sum[r] = ring::quad<1>(sum[r]);
          inv[r] = 1.0f / sum[r];
        }
      }
      // p = e / sum rounded as a true division: the product with the
      // rounded reciprocal, corrected once by its residual (exact by
      // FMA), is the correctly rounded quotient (Markstein)
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = exp_of(nt, e);
          const float q = x * inv[e >> 1];
          const float res = __fmaf_rn(-q, sum[e >> 1], x);
          sc[nt][e] = __fmaf_rn(res, inv[e >> 1], q);
        }
      uint32_t pa[N / 16][4];
      bf16_fragments<N>(pa, sc);
      if (P::kOne) publish();   // v
      wg::fence_operands(accf);
      wg::wgmma_fence();
      issue_times_bf16<DP, N>(accf, pa, kt + Str::kBytes);
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::fence_operands(accf);
      fence_fragments(pa);
    }
    if (step + 1 < steps) publish();
  }

  const int g = (tid & 31) >> 2;
  const int ra = qw + ((tid >> 5) & 3) * 16 + g, rb = ra + 8;
  float* out = ctx + static_cast<long long>(seq) * S * H + head * d;
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (c >= d) continue;
    if (ra < S)
      sx::store2(out + static_cast<long long>(ra) * H + c, acc[nd][0],
                 acc[nd][1]);
    if (rb < S)
      sx::store2(out + static_cast<long long>(rb) * H + c, acc[nd][2],
                 acc[nd][3]);
  }
}

struct Args {
  const __nv_bfloat16* qkv;
  const int* mask;
  float* ctx;
  int B, S, H, d;
  float scale;
  cudaStream_t st;
};

template <class P>
cudaError_t launch(const Args& a) {
  const cudaError_t err = prepare(small_s_attention_kernel<P>, P::kSmem);
  if (err != cudaSuccess) return err;
  const int rows = kRows * P::WG;
  small_s_attention_kernel<P>
      <<<dim3((a.S + rows - 1) / rows, a.H / a.d, a.B), P::kThreads,
         P::kSmem, a.st>>>(a.qkv, a.mask, a.ctx, a.S, a.H, a.d,
                           a.scale * ring::kLog2e);
  return cudaGetLastError();
}

// The shapes by length: up to S = 192 (the encode chunk and a request at
// 128 and 32, the teacher and the rerank at 160) every key in one tile of
// 128 or 192, one warpgroup a block, the scores kept from pass 1 to pass
// 2; below 256 one warpgroup a block and 64-key tiles; from 256 (msdoc, S
// = 512) two warpgroups a block share each streamed tile in ping-pong.
// Chosen on an H100 with scripts/torch_attention_shapes.py.
template <int DP>
cudaError_t by_length(const Args& a) {
  if (a.S <= 128) return launch<Shape<DP, 128, 1, DP <= 64 ? 3 : 2, true>>(a);
  if (a.S <= 192) return launch<Shape<DP, 192, 1, DP <= 64 ? 2 : 1, true>>(a);
  if (a.S < 256) return launch<Shape<DP, 64, 1, DP <= 64 ? 4 : 2, false>>(a);
  return launch<Shape<DP, 64, 2, DP <= 64 ? 2 : 1, false>>(a);
}

static_assert(2 * Shape<128, 128, 1, 2, true>::kSmem <= 233472 &&
                  3 * Shape<64, 128, 1, 3, true>::kSmem <= 233472 &&
                  2 * Shape<64, 192, 1, 2, true>::kSmem <= 233472 &&
                  Shape<128, 192, 1, 1, true>::kSmem <= 232448 &&
                  4 * Shape<64, 64, 1, 4, false>::kSmem <= 233472 &&
                  2 * Shape<64, 64, 2, 2, false>::kSmem <= 233472,
              "the blocks an SM the launch bounds ask for fit its shared "
              "memory");

}  // namespace

// qkv [B*S, 3H] bf16 (q | k | v), mask [B, S] int32 (1 = real key),
// ctx [B*S, H] f32. d = H / heads on the 16 grid up to 128 (the wrapper
// pads other widths); any S >= 1; B <= 65535. Rows of qkv and the head
// offsets must be 16-byte aligned (H % 8 == 0, checked by the wrapper).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// an unsupported d or S).
extern "C" int sx_small_s_attention(const void* qkv, const int* mask,
                                    float* ctx, int B, int S, int H, int d,
                                    float scale, void* stream) {
  if (S < 1 || d < 16 || d > 128 || d % 16 || H % d)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const __nv_bfloat16*>(qkv), mask, ctx, B, S, H, d,
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
