// K7 bh_attention_fwd and K8 bh_attention_bwd: softmax attention of every
// (batch, head) at 256 <= S <= 1024, forward and backward, in f32.
//
// Replace the per-(batch, head) Pallas pair of the JAX package:
// simxns_tpu/ops/flash_attention.py:_fwd_call (kernel _fwd_kernel, :67)
// and _fused_bwd (kernel _bwd_kernel, :80). The contract is K5/K6's
// (group_attention.cu), all in f32:
//   s  = where(mask[key] > 0, (q k^T) * scale, -1e9), scale = 1/sqrt(d)
//   p  = exp(s - rowmax) / rowsum(exp(s - rowmax)),   o = p v   (K7)
//   dV = p^T dO, dP = dO v^T, dS = p (dP - rowsum(dP p)),
//   dQ = dS k * scale, dK = dS^T q * scale                      (K8)
// A row whose keys are all masked gets the uniform softmax over its S keys
// (every score is -1e9), as on the TPU; keys past S in the last tile are
// padding and get -inf, so they weigh exactly 0.
//
// The TPU kernel holds one (b, h) -- q, k, v and the S x S scores -- in
// VMEM. A Hopper block has 227 KB of shared memory, and at S=1024, d=64, k
// and v alone are 256 KB of bf16. So both kernels stream tiles of 64 rows
// through shared memory, and each block takes 64 rows of one (b, h):
// - K7, one block per (query tile, head, batch), in ONE pass over the keys
//   (attention_ring.cuh): q lands in shared memory once; 64-key tiles of k
//   and v stream through a two-stage cp.async ring (the next tile's copy
//   overlaps the current tile's products); each row keeps a running max
//   and sum in f32, the f32 accumulator is rescaled when the max grows,
//   and the sum divides it once at the end (one reciprocal a row). Scores
//   are scaled by log2(e) / sqrt(d) (the masks' -1e9 by log2(e) too), so
//   each exponential is one ex2. p stays f32: p v takes it as hi + lo bf16
//   halves, v read in its [key][d] layout through ldmatrix...trans. The
//   result differs from the two-pass one by f32 rounding only.
// - K8, two launches on the same ring (attention_bwd.cuh). The query
//   pass, one block per (query tile, head, batch), lands q and dO once and
//   streams the k and v tiles twice: walk 1 folds each row's max, sum and
//   unnormalised rowsum(dP p) in one pass (q k^T and dO v^T), walk 2
//   computes dS = p (dP - rowsum(dP p)) with p = 2^(s - lse) and
//   accumulates dQ = dS k (q k^T, dO v^T, dS k as hi + lo: 4 products). It
//   writes lse and rowsum(dP p) to an f32 scratch [2, B, heads, S]. The
//   key pass, one block per (key tile, head, batch), holds its k and v
//   fragments and streams the q and dO tiles with their two statistics:
//   k q^T and v dO^T are p^T and dP^T in the A layout of dV += p^T dO and
//   dK += dS^T q (6 products). No atomics and no partial sums: the result
//   does not depend on the launch order, and two calls agree bit for bit.
//
// Bound on the card: operations for K8, bytes for K7 at the msdoc
// reranker's shape (128 joint rows x 12 heads x S=512 x d=64, bf16): K7
// moves 403 MB and does 103 GFLOP of model products, K8 moves 705 MB and
// does 258 GFLOP. K7 does 3 products of 2 S^2 d per head (q k^T, and p v
// twice for the hi and lo halves) against the model's 2; K8 does 12 (q k^T
// and dO v^T twice, and each product with an f32 operand twice) against
// the model's 5, and 3 ex2 a score.
#include "attention_bwd.cuh"
#include "attention_tile.cuh"

SX_DEFINE_ERROR_STRING

using namespace sx::attn;
namespace ring = sx::ring;
namespace bwd = sx::bwd;

namespace {

constexpr int kMaxS = 1024;

template <int D>
constexpr int fwd_smem() {           // K7: q tile, the k and v ring, keys
  return ring::one_pass_smem<D, ring::kKeys>(kMaxS);
}

template <int D>
constexpr int query_pass_smem() {    // K8: q, dO, the k and v ring, fills
  return (2 + 2 * ring::kStages) * ring::Layout<D>::kTile * 2 + kMaxS * 4;
}

template <int D>
constexpr int key_pass_smem() {      // k, v, the q and dO ring, statistics
  return (2 + 2 * ring::kStages) * ring::Layout<D>::kTile * 2 +
         2 * ring::kStages * ring::kRows * 4;
}

// A warp holds its A fragments of q and dO (query pass) or of k and v (key
// pass) across the walk when they fit beside the accumulators; at d = 128
// it takes them from shared memory again for every tile.
__host__ __device__ constexpr bool hold_fragments(int D) { return D <= 64; }

// K7: one block per (query tile, head, batch), one pass over the keys
// (attention_ring.cuh's attend_one_pass, 64-key tiles)
template <int D>
__global__ void __launch_bounds__(ring::kThreads, D <= 64 ? 4 : 2)
    bh_attention_fwd_kernel(In q, In k, In v, const int* __restrict__ mask,
                            Out o, int S, float scale2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  ring::attend_one_pass<D, ring::kKeys>(
      smem, [&](int i) { return q.row(b, h, i); },
      [&](int i) { return k.row(b, h, i); },
      [&](int i) { return v.row(b, h, i); },
      [&](int i) { return o.row(b, h, i); },
      mask + static_cast<long long>(b) * S, S, blockIdx.x * ring::kRows,
      scale2);
}

// K8, launch 1: per query tile, the row statistics (lse, rowsum(dP p)) and
// dQ; ring step s < n_tiles is walk 1 over key tile s, step n_tiles + j
// walk 2 over key tile j
template <int D>
__global__ void __launch_bounds__(ring::kThreads, D <= 64 ? 3 : 2)
    bh_attention_bwd_query_kernel(In q, In k, In v, In dout,
                                  const int* __restrict__ mask, Out dq,
                                  float* stats, int S, float scale,
                                  float scale2) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kT = ring::Layout<D>::kTile;
  constexpr bool kHold = hold_fragments(D);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dos = qs + kT;
  __nv_bfloat16* ks = dos + kT;                 // [kStages] tiles
  __nv_bfloat16* vs = ks + ring::kStages * kT;  // [kStages] tiles
  float* fill = reinterpret_cast<float*>(vs + ring::kStages * kT);
  const int q0 = blockIdx.x * ring::kRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = (S + ring::kKeys - 1) / ring::kKeys;

  const bool none_real = bwd::all_masked(mask, b, S);
  for (int j = threadIdx.x; j < n_tiles * ring::kKeys; j += ring::kThreads)
    fill[j] = bwd::key_fill(mask, b, j, S, none_real);
  auto k_row = [&](int i) { return k.row(b, h, i); };
  auto v_row = [&](int i) { return v.row(b, h, i); };
  auto issue = [&](int step) {
    const int tile = step % n_tiles, st = step % ring::kStages;
    ring::copy_tile<D>(ks + st * kT, k_row, tile * ring::kKeys, S);
    ring::copy_tile<D>(vs + st * kT, v_row, tile * ring::kKeys, S);
  };
  ring::copy_tile<D>(qs, [&](int i) { return q.row(b, h, i); }, q0, S);
  ring::copy_tile<D>(dos, [&](int i) { return dout.row(b, h, i); }, q0, S);
  issue(0);                                   // q and dO ride with it
  sx::cp_async_commit();
  // -> the ring stage of `step`, landed and visible to the block
  auto ring_step = [&](int step) {
    if (step + 1 < 2 * n_tiles) issue(step + 1);
    sx::cp_async_commit();
    sx::cp_async_wait<ring::kStages - 1>();
    __syncthreads();
    return step % ring::kStages;
  };

  const bool active = q0 + warp * 16 < S;   // warp-uniform; idle warps sync
  uint32_t qa[D / 16][4], da[D / 16][4];
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
  float dotu[2] = {0.0f, 0.0f};
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int st = ring_step(tile);
    if (active) {
      if (tile == 0 || !kHold) {
        ring::load_q<D>(qa, qs);
        ring::load_q<D>(da, dos);
      }
      bwd::stats_tile<D, ring::kNt>(qa, da, ks + st * kT, vs + st * kT,
                                    fill + tile * ring::kKeys, scale2, mx,
                                    sum, dotu);
    }
    __syncthreads();
  }
  float lse[2], dot[2];
  bwd::finish_stats(mx, sum, dotu, lse, dot);
  float acc[D / 8][4];
  zero<D>(acc);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int st = ring_step(n_tiles + tile);
    if (active) {
      if (!kHold) {
        ring::load_q<D>(qa, qs);
        ring::load_q<D>(da, dos);
      }
      bwd::dq_tile<D, ring::kNt>(qa, da, ks + st * kT, vs + st * kT,
                                 fill + tile * ring::kKeys, scale2, lse, dot,
                                 acc);
    }
    __syncthreads();
  }
  if (!active) return;
  const int r0 = q0 + warp * 16;
  store_rows<D>(dq, b, h, r0, S, acc, scale);
  if (t == 0) {
    const long long n = static_cast<long long>(gridDim.z) * gridDim.y * S;
    const long long base = (static_cast<long long>(b) * gridDim.y + h) * S;
    const int ra = r0 + g, rb = r0 + g + 8;
    if (ra < S) stats[base + ra] = lse[0], stats[n + base + ra] = dot[0];
    if (rb < S) stats[base + rb] = lse[1], stats[n + base + rb] = dot[1];
  }
}

// K8, launch 2: per key tile, dV = p^T dO and dK = dS^T q * scale summed
// over every query tile. Query rows past S are zero-filled, and so are
// their statistics: their p is finite (1 or 0) and multiplies a zero dO
// row, and their dS is 0, so they add exactly 0.
template <int D>
__global__ void __launch_bounds__(ring::kThreads, 2)
    bh_attention_bwd_key_kernel(In q, In k, In v, In dout,
                                const int* __restrict__ mask, Out dk, Out dv,
                                const float* __restrict__ stats, int S,
                                float scale, float scale2) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kT = ring::Layout<D>::kTile;
  constexpr bool kHold = hold_fragments(D);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + kT;
  __nv_bfloat16* qs = vs + kT;                   // [kStages] tiles
  __nv_bfloat16* dos = qs + ring::kStages * kT;  // [kStages] tiles
  float* rl = reinterpret_cast<float*>(dos + ring::kStages * kT);
  float* rd = rl + ring::kStages * ring::kRows;  // [kStages][64] each
  const int j0 = blockIdx.x * ring::kRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int n_tiles = (S + ring::kRows - 1) / ring::kRows;
  const long long n = static_cast<long long>(gridDim.z) * gridDim.y * S;
  const long long base = (static_cast<long long>(b) * gridDim.y + h) * S;

  const bool none_real = bwd::all_masked(mask, b, S);
  const int jw = j0 + warp * 16;
  const float fill[2] = {bwd::key_fill(mask, b, jw + g, S, none_real),
                         bwd::key_fill(mask, b, jw + g + 8, S, none_real)};
  auto q_row = [&](int i) { return q.row(b, h, i); };
  auto do_row = [&](int i) { return dout.row(b, h, i); };
  // query tile `tile` into its stage: q, dO, and per row lse (threads
  // 0-63) and rowsum(dP p) (threads 64-127)
  auto issue = [&](int tile) {
    const int st = tile % ring::kStages, i0 = tile * ring::kRows;
    ring::copy_tile<D>(qs + st * kT, q_row, i0, S);
    ring::copy_tile<D>(dos + st * kT, do_row, i0, S);
    const int i = threadIdx.x & (ring::kRows - 1);
    const bool second = threadIdx.x >= ring::kRows, ok = i0 + i < S;
    bwd::cp_async4((second ? rd : rl) + st * ring::kRows + i,
                   stats + (second ? n : 0) + base + (ok ? i0 + i : 0), ok);
  };
  ring::copy_tile<D>(ks, [&](int i) { return k.row(b, h, i); }, j0, S);
  ring::copy_tile<D>(vs, [&](int i) { return v.row(b, h, i); }, j0, S);
  issue(0);                                   // k and v ride with it
  sx::cp_async_commit();

  const bool active = jw < S;
  uint32_t ka[D / 16][4], va[D / 16][4];
  float dka[D / 8][4], dva[D / 8][4];
  zero<D>(dka);
  zero<D>(dva);
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) issue(tile + 1);
    sx::cp_async_commit();
    sx::cp_async_wait<ring::kStages - 1>();
    __syncthreads();
    if (active) {
      if (tile == 0 || !kHold) {
        ring::load_q<D>(ka, ks);
        ring::load_q<D>(va, vs);
      }
      const int st = tile % ring::kStages;
      bwd::dkv_tile<D, ring::kNt>(ka, va, fill, qs + st * kT, dos + st * kT,
                                  rl + st * ring::kRows,
                                  rd + st * ring::kRows, scale2, dka, dva);
    }
    __syncthreads();
  }
  if (!active) return;
  store_rows<D>(dk, b, h, jw, S, dka, scale);
  store_rows<D>(dv, b, h, jw, S, dva, 1.0f);
}

In view(const void* p, long long sb, long long sh, long long ss) {
  return In{static_cast<const __nv_bfloat16*>(p), sb, sh, ss};
}

Out out_view(void* p, long long sb, long long sh, long long ss) {
  return Out{static_cast<__nv_bfloat16*>(p), sb, sh, ss};
}

}  // namespace

static_assert(2 * key_pass_smem<128>() <= 232448 &&
                  2 * query_pass_smem<128>() <= 232448,
              "two K8 blocks fit an SM's shared memory at d = 128");

// q, k, v: [B, heads, S, d] bf16 views sharing the element strides
// (sb, sh, ss), d contiguous; mask [B, S] int32 (1 = real key); o a view
// with strides (ob, oh, os). Every row start must be 16-byte aligned (the
// wrapper checks). d in {32, 64, 128}, 1 <= S <= 1024, heads and B at most
// 65535. Returns cudaGetLastError() after the launch.
extern "C" int sx_bh_attention_fwd(
    const void* q, const void* k, const void* v, long long sb, long long sh,
    long long ss, const int* mask, void* o, long long ob, long long oh,
    long long os, int B, int heads, int S, int d, float scale, void* stream) {
  if (S < 1 || S > kMaxS) return static_cast<int>(cudaErrorInvalidValue);
  const In qv = view(q, sb, sh, ss), kv = view(k, sb, sh, ss),
           vv = view(v, sb, sh, ss);
  const Out ov = out_view(o, ob, oh, os);
  const dim3 grid((S + ring::kRows - 1) / ring::kRows, heads, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
#define SX_CASE(DD)                                                           \
  case DD:                                                                    \
    err = prepare(bh_attention_fwd_kernel<DD>, fwd_smem<DD>());               \
    if (err != cudaSuccess) return static_cast<int>(err);                     \
    bh_attention_fwd_kernel<DD><<<grid, ring::kThreads, fwd_smem<DD>(),       \
                                  st>>>(qv, kv, vv, mask, ov, S,              \
                                        scale * ring::kLog2e);                \
    return static_cast<int>(cudaGetLastError());
    SX_CASE(32)
    SX_CASE(64)
    SX_CASE(128)
#undef SX_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward: q, k, v as above; dout a view with strides (db, dh, ds);
// dq, dk, dv views sharing the strides (gb, gh, gs); stats an f32 scratch
// of 2 * B * heads * S values (lse, then rowsum(dP p): written by the
// first launch, read by the second).
extern "C" int sx_bh_attention_bwd(
    const void* q, const void* k, const void* v, long long sb, long long sh,
    long long ss, const void* dout, long long db, long long dh, long long ds,
    const int* mask, void* dq, void* dk, void* dv, long long gb, long long gh,
    long long gs, float* stats, int B, int heads, int S, int d, float scale,
    void* stream) {
  if (S < 1 || S > kMaxS) return static_cast<int>(cudaErrorInvalidValue);
  const In qv = view(q, sb, sh, ss), kv = view(k, sb, sh, ss),
           vv = view(v, sb, sh, ss), dov = view(dout, db, dh, ds);
  const Out dqv = out_view(dq, gb, gh, gs), dkv = out_view(dk, gb, gh, gs),
            dvv = out_view(dv, gb, gh, gs);
  const dim3 grid((S + ring::kRows - 1) / ring::kRows, heads, B);
  const float scale2 = scale * ring::kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
#define SX_CASE(DD)                                                           \
  case DD:                                                                    \
    err = prepare(bh_attention_bwd_query_kernel<DD>, query_pass_smem<DD>());  \
    if (err == cudaSuccess)                                                   \
      err = prepare(bh_attention_bwd_key_kernel<DD>, key_pass_smem<DD>());    \
    if (err != cudaSuccess) return static_cast<int>(err);                     \
    bh_attention_bwd_query_kernel<DD>                                         \
        <<<grid, ring::kThreads, query_pass_smem<DD>(), st>>>(                \
            qv, kv, vv, dov, mask, dqv, stats, S, scale, scale2);             \
    err = cudaGetLastError();                                                 \
    if (err != cudaSuccess) return static_cast<int>(err);                     \
    bh_attention_bwd_key_kernel<DD>                                           \
        <<<grid, ring::kThreads, key_pass_smem<DD>(), st>>>(                  \
            qv, kv, vv, dov, mask, dkv, dvv, stats, S, scale, scale2);        \
    return static_cast<int>(cudaGetLastError());
    SX_CASE(32)
    SX_CASE(64)
    SX_CASE(128)
#undef SX_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
