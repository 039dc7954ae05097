// Device functions of the attention backward on wgmma
// (attention_bwd_wgmma.cu: K6, K8, and the f32 instance of both) and the
// key fills of the forward (attention_fwd_wgmma.cu).
//
// The model's backward, in f32 (scale = 1/sqrt(d)):
//   s  = where(mask[key] > 0, q k^T * scale, -1e9),  p = softmax(s)
//   dV = p^T dO, dP = dO v^T, dS = p (dP - rowsum(dP p)),
//   dQ = dS k * scale, dK = dS^T q * scale.
// Scores are kept in the log2 domain: s2 = log2(e) s, so p = 2^(s2 - lse)
// with lse = log2(rowsum(2^s2)), one ex2 and no division a score. Two f32
// statistics a query row carry everything K8's later walks need: one walk
// over the keys (fold_stats, then finish_stats) folds the running max m,
// the sum of 2^(s2 - m) and the unnormalised row dot sum 2^(s2 - m) dP;
// both sums are rescaled by 2^(m_old - m_new) when the max grows. At the
// end lse = m + log2(sum) and dot = dot_u / sum, which is rowsum(dP p),
// taken from dP and p in f32. A query walk then gets dS = p (dP - dot)
// (ds_rows) and dQ += dS k; a key walk gets p^T and dS^T from k q^T and v
// dO^T (p_ds_cols), already in the A layout of dV += p^T dO and dK += dS^T
// q. The accumulators' layout is mma.sync's (attention_ring.cuh's); REAL =
// true (every key of the tile real: fill kRealKey) skips the fill's
// select.
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

template <bool REAL = false>
__device__ __forceinline__ float score(float prod, float fill,
                                       float scale2) {
  return REAL || fill == kRealKey ? prod * scale2 : fill;
}

// The statistics walk's fold of one key tile's scores sc (q k^T) and dP
// (dO v^T) into the running max, sum and row dot; fill the tile's key
// fills. mx is quad-reduced (every thread of a row holds the row's max);
// sum and dotu are the thread's partial sums.
template <bool REAL = false, int NT>
__device__ __forceinline__ void fold_stats(float (&sc)[NT][4],
                                           const float (&dp)[NT][4],
                                           const float* fill, float scale2,
                                           float (&mx)[2], float (&sum)[2],
                                           float (&dotu)[2]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sc[nt][e] =
          score<REAL>(sc[nt][e], fill[nt * 8 + 2 * t + (e & 1)], scale2);
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

// dS = p (dP - rowsum(dP p)) of one key tile into sc, from its scores sc
// and dP, with p = 2^(s - lse)
template <bool REAL = false, int NT>
__device__ __forceinline__ void ds_rows(float (&sc)[NT][4],
                                        const float (&dp)[NT][4],
                                        const float* fill, float scale2,
                                        const float (&lse)[2],
                                        const float (&dot)[2]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float s =
          score<REAL>(sc[nt][e], fill[nt * 8 + 2 * t + (e & 1)], scale2);
      const float p = ring::ex2(s - lse[e >> 1]);
      sc[nt][e] = p * (dp[nt][e] - dot[e >> 1]);
    }
}

// p^T and dS^T of one query tile for the warp's 16 keys, from k q^T (pt)
// and v dO^T (dst): fill the two key rows' fills (rows g, g + 8); lse, dot
// the tile's query statistics
template <bool REAL = false, int NT>
__device__ __forceinline__ void p_ds_cols(float (&pt)[NT][4],
                                          float (&dst)[NT][4],
                                          const float (&fill)[2],
                                          const float* lse, const float* dot,
                                          float scale2) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = nt * 8 + 2 * t + (e & 1);
      const float p =
          ring::ex2(score<REAL>(pt[nt][e], fill[e >> 1], scale2) - lse[i]);
      pt[nt][e] = p;
      dst[nt][e] = p * (dst[nt][e] - dot[i]);
    }
}

}  // namespace bwd
}  // namespace sx
