// Device functions of the attention backward: K6 group_attention_bwd
// (group_attention.cu) and K8 bh_attention_bwd (bh_attention.cu), on the
// tile products of attention_ring.cuh.
//
// The model's backward, in f32 (scale = 1/sqrt(d)):
//   s  = where(mask[key] > 0, q k^T * scale, -1e9),  p = softmax(s)
//   dV = p^T dO, dP = dO v^T, dS = p (dP - rowsum(dP p)),
//   dQ = dS k * scale, dK = dS^T q * scale.
// Scores are kept in the log2 domain: s2 = log2(e) s, so p = 2^(s2 - lse)
// with lse = log2(rowsum(2^s2)), one ex2 and no division a score. Two f32
// statistics a query row carry everything the later walks need:
// - one walk over the keys (stats_tile, then finish_stats) folds the
//   running max m, the sum of 2^(s2 - m) and the unnormalised row dot
//   sum 2^(s2 - m) dP; both sums are rescaled by 2^(m_old - m_new) when the
//   max grows. At the end lse = m + log2(sum) and dot = dot_u / sum, which
//   is rowsum(dP p), taken from dP and p in f32;
// - a query walk (dq_tile) then gets dS = p (dP - dot) and dQ += dS k; a
//   key walk (dkv_tile) gets p^T and dS^T from k q^T and v dO^T, already in
//   the A layout of dV += p^T dO and dK += dS^T q.
// p and dS enter their products as hi + lo bf16 halves (p_v_tile_split).
//
// A key's fill says how its score is made: kRealKey = the scaled product,
// else a constant: the mask's -1e9 (as -1e9 log2(e)) or -inf past S (the
// padding weighs exactly 0). A batch element whose keys are ALL masked
// takes the constant 0 for every key instead: every score of its rows is
// then equal, as in the model (where all are -1e9), so p is the same
// uniform 1/S; but lse = log2(S) is one f32 can hold, where
// -1e9 log2(e) + log2(S) rounds back to -1e9 log2(e) (its ulp is 128) and
// 2^(s2 - lse) would give 1 for every key.
#pragma once

#include "attention_ring.cuh"

namespace sx {
namespace bwd {

namespace ring = sx::ring;

constexpr float kRealKey = INFINITY;        // fill: use the product
constexpr float kMasked = -1e9f * ring::kLog2e;

// 4 bytes by cp.async; src-size 0 zero-fills
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

// true when no key of batch row b is real; a block-wide barrier (every
// thread of the block must call it)
__device__ __forceinline__ bool all_masked(const int* mask, int b, int S) {
  int real = 0;
  for (int j = threadIdx.x; j < S; j += blockDim.x)
    real |= mask[static_cast<long long>(b) * S + j] > 0;
  return !__syncthreads_or(real);
}

__device__ __forceinline__ float key_fill(const int* mask, int b, int j,
                                          int S, bool none_real) {
  if (j >= S) return -INFINITY;
  if (none_real) return 0.0f;
  return mask[static_cast<long long>(b) * S + j] > 0 ? kRealKey : kMasked;
}

__device__ __forceinline__ float score(float prod, float fill,
                                       float scale2) {
  return fill == kRealKey ? prod * scale2 : fill;
}

// One key tile of the statistics walk for the warp's 16 query rows:
// qa, da the A fragments of q and dO; ks, vs the tile's k and v rows;
// fill the tile's key fills. mx is quad-reduced (every thread of a row
// holds the row's max); sum and dotu are the thread's partial sums.
template <int D, int NT>
__device__ __forceinline__ void stats_tile(
    const uint32_t (&qa)[D / 16][4], const uint32_t (&da)[D / 16][4],
    const __nv_bfloat16* ks, const __nv_bfloat16* vs, const float* fill,
    float scale2, float (&mx)[2], float (&sum)[2], float (&dotu)[2]) {
  const int t = threadIdx.x & 3;
  float sc[NT][4], dp[NT][4];
  ring::q_k_tile<D>(sc, qa, ks);
  ring::q_k_tile<D>(dp, da, vs);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sc[nt][e] = score(sc[nt][e], fill[nt * 8 + 2 * t + (e & 1)], scale2);
  float cm[2];
  ring::tile_max(sc, cm);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(mx[r], cm[r]);
    const float alpha = mx[r] == -INFINITY ? 0.0f : ring::ex2(mx[r] - m_new);
    sum[r] *= alpha;
    dotu[r] *= alpha;
    mx[r] = m_new;
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ring::ex2(sc[nt][e] - mx[e >> 1]);
      sum[e >> 1] += p;
      dotu[e >> 1] += p * dp[nt][e];
    }
}

__device__ __forceinline__ void finish_stats(const float (&mx)[2],
                                             float (&sum)[2],
                                             float (&dotu)[2],
                                             float (&lse)[2],
                                             float (&dot)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] = ring::quad<1>(sum[r]);
    dotu[r] = ring::quad<1>(dotu[r]);
    lse[r] = mx[r] + log2f(sum[r]);
    dot[r] = dotu[r] / sum[r];
  }
}

// One key tile of the dQ walk: acc += dS k over the tile's keys.
template <int D, int NT>
__device__ __forceinline__ void dq_tile(
    const uint32_t (&qa)[D / 16][4], const uint32_t (&da)[D / 16][4],
    const __nv_bfloat16* ks, const __nv_bfloat16* vs, const float* fill,
    float scale2, const float (&lse)[2], const float (&dot)[2],
    float (&acc)[D / 8][4]) {
  const int t = threadIdx.x & 3;
  float sc[NT][4], dp[NT][4];
  ring::q_k_tile<D>(sc, qa, ks);
  ring::q_k_tile<D>(dp, da, vs);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float s =
          score(sc[nt][e], fill[nt * 8 + 2 * t + (e & 1)], scale2);
      const float p = ring::ex2(s - lse[e >> 1]);
      sc[nt][e] = p * (dp[nt][e] - dot[e >> 1]);
    }
  ring::p_v_tile_split<D>(acc, sc, ks);
}

// One query tile of the key walk for the warp's 16 keys: ka, va the A
// fragments of k and v; fill the two key rows' fills (rows g, g + 8);
// qs, dos the tile's q and dO rows; lse, dot the tile's query statistics.
// dva += p^T dO, dka += dS^T q.
template <int D, int NT>
__device__ __forceinline__ void dkv_tile(
    const uint32_t (&ka)[D / 16][4], const uint32_t (&va)[D / 16][4],
    const float (&fill)[2], const __nv_bfloat16* qs,
    const __nv_bfloat16* dos, const float* lse, const float* dot,
    float scale2, float (&dka)[D / 8][4], float (&dva)[D / 8][4]) {
  const int t = threadIdx.x & 3;
  float pt[NT][4], dst[NT][4];
  ring::q_k_tile<D>(pt, ka, qs);    // k_j . q_i
  ring::q_k_tile<D>(dst, va, dos);  // v_j . dO_i = dP[i][j]
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = nt * 8 + 2 * t + (e & 1);
      const float p =
          ring::ex2(score(pt[nt][e], fill[e >> 1], scale2) - lse[i]);
      pt[nt][e] = p;
      dst[nt][e] = p * (dst[nt][e] - dot[i]);
    }
  ring::p_v_tile_split<D>(dva, pt, dos);
  ring::p_v_tile_split<D>(dka, dst, qs);
}

}  // namespace bwd
}  // namespace sx
