// The register-level pieces of the attention kernels on Hopper's
// warpgroup MMA (attention_wgmma.cuh: K3, K5-K8 and the f32 instances):
// ex2, the row reductions of a score tile in the accumulator layout
// (quad, tile_max), and the register A fragments of a product taken from
// an f32 accumulator (a_fragment; a_fragments_split as hi + lo bf16
// halves). The accumulator layout is a warp's 16 rows as [NT][4] of n8
// tiles: element e of tile nt is row (e < 2 ? g : g + 8), column nt * 8 +
// 2t + (e & 1) (g = lane >> 2, t = lane & 3), which is mma.sync's and
// wgmma's alike. Scores are kept in the log2 domain (log2(e) folded into
// the scale and into the masks' constants), so each exponential is one
// ex2.
#pragma once

#include "tile_gemm.cuh"

namespace sx {
namespace ring {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {   // 2^x, one MUFU op
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 values rounded to a bf16 pair in one register (lo first)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of keys kk * 16 .. + 15 from two f32 values per register
// (accumulator layout), rounded to bf16.
template <int NT>
__device__ __forceinline__ void a_fragment(uint32_t (&a)[4],
                                           const float (&p)[NT][4], int kk) {
  a[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
  a[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
  a[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
  a[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
}

// The A fragments of keys kk * 16 .. + 15 of an f32 p (accumulator
// layout) as hi = bf16(p) and lo = bf16(p - hi): about 16 bits of each p.
template <int NT>
__device__ __forceinline__ void a_fragments_split(uint32_t (&hi)[4],
                                                  uint32_t (&lo)[4],
                                                  const float (&p)[NT][4],
                                                  int kk) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    // register r: tile 2kk + (r >> 1), row g / g + 8 by r & 1
    const float* src = p[2 * kk + (r >> 1)] + 2 * (r & 1);
    const __nv_bfloat162 h2 = __floats2bfloat162_rn(src[0], src[1]);
    const float2 hf = __bfloat1622float2(h2);
    hi[r] = *reinterpret_cast<const uint32_t*>(&h2);
    lo[r] = pack_bf16(src[0] - hf.x, src[1] - hf.y);
  }
}

// max (op = 0) or sum (op = 1) of a per-row value over the four threads
// that share the row
template <int kOp>
__device__ __forceinline__ float quad(float x) {
#pragma unroll
  for (int m = 1; m <= 2; m <<= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, m);
    x = kOp == 0 ? fmaxf(x, y) : x + y;
  }
  return x;
}

// the two rows' maxima of a score tile, over the whole row (quad-reduced)
template <int NT>
__device__ __forceinline__ void tile_max(const float (&sc)[NT][4],
                                         float (&cm)[2]) {
  cm[0] = cm[1] = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) cm[e >> 1] = fmaxf(cm[e >> 1], sc[nt][e]);
  cm[0] = quad<0>(cm[0]);
  cm[1] = quad<0>(cm[1]);
}

}  // namespace ring
}  // namespace sx
