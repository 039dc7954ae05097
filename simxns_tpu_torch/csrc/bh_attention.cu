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
// - K8, two launches. The query pass (per query tile) folds the max and
//   sum, then rowsum(dP p) from dP and p in f32 (not from a rounded o, as
//   the TPU kernel does), then dQ; it writes the three row statistics to
//   an f32 scratch [3, B, heads, S]. The key pass (per key tile) streams
//   the query tiles with their statistics, recomputes p^T and dS^T and
//   accumulates dK and dV over all queries. No atomics and no partial
//   sums: the result does not depend on the launch order.
//
// Bound on the card: operations for K8, bytes for K7 at the msdoc
// reranker's shape (128 joint rows x 12 heads x S=512 x d=64, bf16): K7
// moves 403 MB and does 103 GFLOP of model products, K8 moves 705 MB and
// does 258 GFLOP. K7 does 3 products of 2 S^2 d per head (q k^T, and p v
// twice for the hi and lo halves) against the model's 2. K8 is the first
// cut (attention_tile.cuh, mma.sync fragments straight from memory): q k^T
// three times in its query pass and every product with an f32 operand
// twice, 13 products against the model's 5.
#include "attention_ring.cuh"
#include "attention_tile.cuh"

SX_DEFINE_ERROR_STRING

using namespace sx::attn;
namespace ring = sx::ring;

namespace {

constexpr int kMaxS = 1024;
constexpr int kRows = kWarps * 16;   // rows of a block (queries or keys)
constexpr int kTile = 64;            // rows of a streamed shared tile

template <int D>
constexpr int query_pass_smem() {    // K8: k and v tiles, key flags
  return 2 * kTile * (D + 8) * 2 + kTile * 4;
}

template <int D>
constexpr int fwd_smem() {           // K7: q tile, the k and v ring, keys
  return (1 + 2 * ring::kStages) * ring::Layout<D>::kTile * 2 + kMaxS * 4;
}

template <int D>
constexpr int key_pass_smem() {      // q and dO tiles, three row statistics
  return 2 * kTile * (D + 8) * 2 + 3 * kTile * 4;
}

struct Stats {            // per query row of each (b, h): [B, heads, S] f32
  float* mx;
  float* sum;
  float* dot;
};

// the scores of a warp's 16 query rows against 32 keys of the shared tile
// (local columns c0 .. c0 + 31), scaled and masked
template <int D>
struct Scores {
  const uint32_t (&qa)[D / 16][4];
  const __nv_bfloat16* ks;
  const int* flag;
  float scale;
  __device__ void operator()(int c0, float (&sc)[kTiles][4]) const {
    const int t = threadIdx.x & 3;
    mma_rows<D>(sc, qa, ks, c0);
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[nt][e] = masked(sc[nt][e] * scale,
                           flag[c0 + nt * 8 + 2 * t + (e & 1)]);
  }
};

// the query rows' max and sum of exp(s - max) over every key tile; k and
// the flags pass through the shared tiles `ks` and `flag`
template <int D>
__device__ void query_stats(const Scores<D>& scores, __nv_bfloat16* ks,
                            int* flag, const In& k, const int* mask, int b,
                            int h, int S, bool active, float (&mx)[2],
                            float (&sum)[2]) {
  stats_begin(mx, sum);
  for (int t0 = 0; t0 < S; t0 += kTile) {
    __syncthreads();
    load_rows<D>(ks, k, b, h, t0, kTile, S);
    load_flags(flag, mask, b, t0, kTile, S);
    __syncthreads();
    if (active) stats_add(scores, 0, kTile, mx, sum);
  }
  stats_end(sum);
}

// K7: one block per (query tile, head, batch), one pass over the keys
template <int D>
__global__ void __launch_bounds__(ring::kThreads, D <= 64 ? 4 : 2)
    bh_attention_fwd_kernel(In q, In k, In v, const int* __restrict__ mask,
                            Out o, int S, float scale2) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kT = ring::Layout<D>::kTile;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + kT;                  // [kStages] tiles
  __nv_bfloat16* vs = ks + ring::kStages * kT;  // [kStages] tiles
  float* fill = reinterpret_cast<float*>(vs + ring::kStages * kT);
  const int q0 = blockIdx.x * ring::kRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = (S + ring::kKeys - 1) / ring::kKeys;

  // a key's score: 0 = real (the scaled product), else the masked
  // constant (-1e9, in the log2 domain) or -inf past S
  for (int j = threadIdx.x; j < n_tiles * ring::kKeys; j += ring::kThreads)
    fill[j] = j >= S ? -INFINITY
                     : (mask[static_cast<long long>(b) * S + j] > 0
                            ? 0.0f : -1e9f * ring::kLog2e);
  auto q_row = [&](int i) { return q.row(b, h, i); };
  auto k_row = [&](int i) { return k.row(b, h, i); };
  auto v_row = [&](int i) { return v.row(b, h, i); };
  auto issue = [&](int tile) {
    const int st = tile % ring::kStages;
    ring::copy_tile<D>(ks + st * kT, k_row, tile * ring::kKeys, S);
    ring::copy_tile<D>(vs + st * kT, v_row, tile * ring::kKeys, S);
  };
  ring::copy_tile<D>(qs, q_row, q0, S);
#pragma unroll
  for (int i = 0; i < ring::kStages - 1; ++i) {   // q rides with the first
    if (i < n_tiles) issue(i);
    sx::cp_async_commit();
  }

  const bool active = q0 + warp * 16 < S;   // warp-uniform; idle warps sync
  uint32_t qa[D / 16][4];
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
  float acc[D / 8][4];
  zero<D>(acc);
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + ring::kStages - 1 < n_tiles) issue(tile + ring::kStages - 1);
    sx::cp_async_commit();
    sx::cp_async_wait<ring::kStages - 1>();
    __syncthreads();
    if (active) {
      if (tile == 0) ring::load_q<D>(qa, qs);
      const int st = tile % ring::kStages;
      float sc[ring::kNt][4];
      ring::q_k_tile<D>(sc, qa, ks + st * kT);
      const float* f = fill + tile * ring::kKeys + 2 * t;
#pragma unroll
      for (int nt = 0; nt < ring::kNt; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float c = f[nt * 8 + (e & 1)];
          sc[nt][e] = c == 0.0f ? sc[nt][e] * scale2 : c;
        }
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
      for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nd][e] *= alpha[e >> 1];
#pragma unroll
      for (int nt = 0; nt < ring::kNt; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[nt][e] = ring::ex2(sc[nt][e] - mx[e >> 1]);
          sum[e >> 1] += sc[nt][e];
        }
      ring::p_v_tile_split<D>(acc, sc, vs + st * kT);
    }
    __syncthreads();
  }
  if (!active) return;
  const float inv[2] = {1.0f / ring::quad<1>(sum[0]),
                        1.0f / ring::quad<1>(sum[1])};
  const int ra = q0 + warp * 16 + g, rb = ra + 8;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (ra < S)
      *reinterpret_cast<__nv_bfloat162*>(o.row(b, h, ra) + c) =
          __floats2bfloat162_rn(acc[nd][0] * inv[0], acc[nd][1] * inv[0]);
    if (rb < S)
      *reinterpret_cast<__nv_bfloat162*>(o.row(b, h, rb) + c) =
          __floats2bfloat162_rn(acc[nd][2] * inv[1], acc[nd][3] * inv[1]);
  }
}

// K8, launch 1: per query tile, the row statistics and dQ
template <int D>
__global__ void __launch_bounds__(kThreads)
    bh_attention_bwd_query_kernel(In q, In k, In v, In dout,
                                  const int* __restrict__ mask, Out dq,
                                  Stats st, int S, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + kTile * (D + 8);
  int* flag = reinterpret_cast<int*>(vs + kTile * (D + 8));
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * kRows + warp * 16;
  const bool active = r0 < S;

  uint32_t qa[D / 16][4], da[D / 16][4];
  load_a<D>(qa, q, b, h, r0, S);
  load_a<D>(da, dout, b, h, r0, S);
  const Scores<D> scores{qa, ks, flag, scale};
  float mx[2], sum[2];
  query_stats<D>(scores, ks, flag, k, mask, b, h, S, active, mx, sum);

  // rowsum(dP * p), then dQ = dS k * scale: two more passes over the keys
  float dot[2] = {0.0f, 0.0f};
  float acc[D / 8][4];
  zero<D>(acc);
  for (int pass = 0; pass < 2; ++pass) {
    for (int t0 = 0; t0 < S; t0 += kTile) {
      __syncthreads();
      load_rows<D>(ks, k, b, h, t0, kTile, S);
      load_rows<D>(vs, v, b, h, t0, kTile, S);
      load_flags(flag, mask, b, t0, kTile, S);
      __syncthreads();
      if (!active) continue;
      for (int c0 = 0; c0 < kTile; c0 += kChunk) {
        float sc[kTiles][4], dp[kTiles][4];
        scores(c0, sc);
        mma_rows<D>(dp, da, vs, c0);
#pragma unroll
        for (int nt = 0; nt < kTiles; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = expf(sc[nt][e] - mx[e >> 1]) / sum[e >> 1];
            if (pass == 0)
              dot[e >> 1] += dp[nt][e] * p;
            else
              sc[nt][e] = p * (dp[nt][e] - dot[e >> 1]);
          }
        if (pass == 1) mma_cols<D>(acc, sc, ks, c0);
      }
    }
    if (pass == 0) quad_sum(dot);
  }
  if (!active) return;
  store_rows<D>(dq, b, h, r0, S, acc, scale);
  if (t == 0) {
    const long long base =
        (static_cast<long long>(b) * gridDim.y + h) * S;
    const int ra = r0 + g, rb = r0 + g + 8;
    if (ra < S)
      st.mx[base + ra] = mx[0], st.sum[base + ra] = sum[0],
      st.dot[base + ra] = dot[0];
    if (rb < S)
      st.mx[base + rb] = mx[1], st.sum[base + rb] = sum[1],
      st.dot[base + rb] = dot[1];
  }
}

// K8, launch 2: per key tile, dV = p^T dO and dK = dS^T q * scale summed
// over every query tile
template <int D>
__global__ void __launch_bounds__(kThreads)
    bh_attention_bwd_key_kernel(In q, In k, In v, In dout,
                                const int* __restrict__ mask, Out dk, Out dv,
                                Stats st, int S, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [64][D+8]
  __nv_bfloat16* dos = qs + kTile * (D + 8);                    // [64][D+8]
  float* rmax = reinterpret_cast<float*>(dos + kTile * (D + 8));
  float* rsum = rmax + kTile;
  float* rdot = rsum + kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int j0 = blockIdx.x * kRows + warp * 16;
  const bool active = j0 < S;
  const long long base = (static_cast<long long>(b) * gridDim.y + h) * S;

  uint32_t ka[D / 16][4], va[D / 16][4];
  load_a<D>(ka, k, b, h, j0, S);
  load_a<D>(va, v, b, h, j0, S);
  const int fa = key_flag(mask, b, j0 + g, S);
  const int fb = key_flag(mask, b, j0 + g + 8, S);
  float dka[D / 8][4], dva[D / 8][4];
  zero<D>(dka);
  zero<D>(dva);
  for (int i0 = 0; i0 < S; i0 += kTile) {
    __syncthreads();
    load_rows<D>(qs, q, b, h, i0, kTile, S);
    load_rows<D>(dos, dout, b, h, i0, kTile, S);
    // queries past S: p = exp(s - inf) = 0
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const bool real = i0 + i < S;
      rmax[i] = real ? st.mx[base + i0 + i] : INFINITY;
      rsum[i] = real ? st.sum[base + i0 + i] : 1.0f;
      rdot[i] = real ? st.dot[base + i0 + i] : 0.0f;
    }
    __syncthreads();
    if (!active) continue;
    for (int c0 = 0; c0 < kTile; c0 += kChunk) {
      float pt[kTiles][4], dst[kTiles][4];
      mma_rows<D>(pt, ka, qs, c0);    // k_j . q_i
      mma_rows<D>(dst, va, dos, c0);  // v_j . dO_i = dP[i][j]
#pragma unroll
      for (int nt = 0; nt < kTiles; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = c0 + nt * 8 + 2 * t + (e & 1);
          const float s = masked(pt[nt][e] * scale, e < 2 ? fa : fb);
          const float p = expf(s - rmax[i]) / rsum[i];
          pt[nt][e] = p;
          dst[nt][e] = p * (dst[nt][e] - rdot[i]);
        }
      mma_cols<D>(dva, pt, dos, c0);
      mma_cols<D>(dka, dst, qs, c0);
    }
  }
  if (!active) return;
  store_rows<D>(dk, b, h, j0, S, dka, scale);
  store_rows<D>(dv, b, h, j0, S, dva, 1.0f);
}

In view(const void* p, long long sb, long long sh, long long ss) {
  return In{static_cast<const __nv_bfloat16*>(p), sb, sh, ss};
}

Out out_view(void* p, long long sb, long long sh, long long ss) {
  return Out{static_cast<__nv_bfloat16*>(p), sb, sh, ss};
}

}  // namespace

static_assert(key_pass_smem<128>() <= 48 * 1024 &&
                  query_pass_smem<128>() <= 48 * 1024,
              "K8 tiles fit the default shared-memory window");

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
// of 3 * B * heads * S values (written by the first launch, read by the
// second).
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
  const long long n = static_cast<long long>(B) * heads * S;
  const Stats sv{stats, stats + n, stats + 2 * n};
  const dim3 grid((S + kRows - 1) / kRows, heads, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
#define SX_CASE(DD)                                                           \
  case DD:                                                                    \
    bh_attention_bwd_query_kernel<DD><<<grid, kThreads, query_pass_smem<DD>(),\
                                        st>>>(qv, kv, vv, dov, mask, dqv, sv, \
                                              S, scale);                      \
    err = cudaGetLastError();                                                 \
    if (err != cudaSuccess) return static_cast<int>(err);                     \
    bh_attention_bwd_key_kernel<DD><<<grid, kThreads, key_pass_smem<DD>(),   \
                                      st>>>(qv, kv, vv, dov, mask, dkv, dvv,  \
                                            sv, S, scale);                    \
    return static_cast<int>(cudaGetLastError());
    SX_CASE(32)
    SX_CASE(64)
    SX_CASE(128)
#undef SX_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
