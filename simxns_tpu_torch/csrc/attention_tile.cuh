// Device functions of the attention kernels: the views, row loads and
// stores (In, Out, load_rows, load_a, store_rows, zero, prepare) serve
// K5-K8 (group_attention.cu, bh_attention.cu); K6 walks its resident tiles
// in chunks of kChunk rows. The products are attention_ring.cuh's.
#pragma once

#include "tile_gemm.cuh"

namespace sx {
namespace attn {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 32;           // keys (or queries) per inner step
constexpr int kTiles = kChunk / 8;   // n8 accumulator tiles per step

struct In {               // a [B, heads, S, D] bf16 view, D contiguous
  const __nv_bfloat16* p;
  long long sb, sh, ss;   // element strides
  __device__ const __nv_bfloat16* row(int b, int h, int i) const {
    return p + b * sb + h * sh + static_cast<long long>(i) * ss;
  }
};

struct Out {
  __nv_bfloat16* p;
  long long sb, sh, ss;
  __device__ __nv_bfloat16* row(int b, int h, int i) const {
    return p + b * sb + h * sh + static_cast<long long>(i) * ss;
  }
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows r0 .. r0 + n - 1 of a view into shared memory [n][D + 8]; zeros for
// rows at or past S
template <int D>
__device__ void load_rows(__nv_bfloat16* dst, const In& x, int b, int h,
                          int r0, int n, int S) {
  for (int idx = threadIdx.x; idx < n * (D / 8); idx += kThreads) {
    const int j = idx / (D / 8), c = (idx % (D / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + j < S)
      val = *reinterpret_cast<const uint4*>(x.row(b, h, r0 + j) + c);
    *reinterpret_cast<uint4*>(dst + j * (D + 8) + c) = val;
  }
}

// A fragments of rows r0 .. r0 + 15 of a view, straight from memory
template <int D>
__device__ void load_a(uint32_t (&a)[D / 16][4], const In& x, int b, int h,
                       int r0, int S) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ra = r0 + g, rb = r0 + g + 8;
  const __nv_bfloat16* pa = x.row(b, h, ra < S ? ra : 0);
  const __nv_bfloat16* pb = x.row(b, h, rb < S ? rb : 0);
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    const int c = kd * 16 + 2 * t;
    a[kd][0] = ra < S ? ld32(pa + c) : 0u;
    a[kd][1] = rb < S ? ld32(pb + c) : 0u;
    a[kd][2] = ra < S ? ld32(pa + c + 8) : 0u;
    a[kd][3] = rb < S ? ld32(pb + c + 8) : 0u;
  }
}

template <int D>
__device__ __forceinline__ void zero(float (&acc)[D / 8][4]) {
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.0f;
}

// rows r0 + g and r0 + g + 8 of a [16][D] accumulator, as bf16
template <int D>
__device__ void store_rows(const Out& o, int b, int h, int r0, int S,
                           const float (&acc)[D / 8][4], float mul) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ra = r0 + g, rb = r0 + g + 8;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (ra < S)
      *reinterpret_cast<__nv_bfloat162*>(o.row(b, h, ra) + c) =
          __floats2bfloat162_rn(acc[nd][0] * mul, acc[nd][1] * mul);
    if (rb < S)
      *reinterpret_cast<__nv_bfloat162*>(o.row(b, h, rb) + c) =
          __floats2bfloat162_rn(acc[nd][2] * mul, acc[nd][3] * mul);
  }
}

template <class Kernel>
cudaError_t prepare(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace attn
}  // namespace sx
