// Device functions of the attention kernels: the views, row loads and
// stores (In, Out, load_rows, load_a, store_rows, zero, prepare) serve
// K5-K8 (group_attention.cu, bh_attention.cu); K6 walks its resident tiles
// in chunks of kChunk rows. The products are attention_ring.cuh's. The
// split pass (split_halves) feeds the f32 instances of K5 and K7.
#pragma once

#include <type_traits>

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

template <class T>        // a [B, heads, S, D] view of results, D contiguous
struct OutT {
  T* p;
  long long sb, sh, ss;
  __device__ T* row(int b, int h, int i) const {
    return p + b * sb + h * sh + static_cast<long long>(i) * ss;
  }
};
using Out = OutT<__nv_bfloat16>;
// the results of a bf16 instance (bf16) or of an f32 instance (f32)
template <bool F32>
using OutOf = OutT<typename std::conditional<F32, float, __nv_bfloat16>::type>;

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

// rows r0 + g and r0 + g + 8 of a [16][D] accumulator, in the view's type
template <int D, class T>
__device__ void store_rows(const OutT<T>& o, int b, int h, int r0, int S,
                           const float (&acc)[D / 8][4], float mul) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ra = r0 + g, rb = r0 + g + 8;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (ra < S)
      store2(o.row(b, h, ra) + c, acc[nd][0] * mul, acc[nd][1] * mul);
    if (rb < S)
      store2(o.row(b, h, rb) + c, acc[nd][2] * mul, acc[nd][3] * mul);
  }
}

template <class Kernel>
cudaError_t prepare(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace attn
}  // namespace sx

// At global scope, in the unnamed namespace of the including .cu (one copy in
// each library, see wgmma_gemm.cuh on templates; an unnamed namespace nested
// in sx::attn would be ambiguous beside the file's own under `using namespace
// sx::attn` in nvcc's generated stubs).
namespace {

// The split pass of the f32 instances: x, an f32 [B, heads, S, D] view
// (element strides sb, sh, ss; D contiguous, a multiple of 4, rows 16-byte
// aligned), into dst, contiguous: its hi halves bf16(x) [B, heads, S, D],
// then at dst + n (n = B heads S D) its lo halves bf16(x - hi); x - hi is
// exact in f32. Four values a thread, one 16-byte load and two 8-byte
// stores; bound by its bytes (4 read and 4 written a value).
__global__ void split_kernel(const float* __restrict__ x, long long sb,
                             long long sh, long long ss,
                             __nv_bfloat16* __restrict__ dst, int heads,
                             int S, int D, long long n) {
  const long long step = 4LL * gridDim.x * blockDim.x;
  for (long long i = 4LL * (static_cast<long long>(blockIdx.x) * blockDim.x +
                            threadIdx.x);
       i < n; i += step) {
    const int c = static_cast<int>(i % D);
    const long long r = i / D;
    const int s = static_cast<int>(r % S);
    const long long bh = r / S;
    const int h = static_cast<int>(bh % heads);
    const long long b = bh / heads;
    const float4 v =
        *reinterpret_cast<const float4*>(x + b * sb + h * sh + s * ss + c);
    const float xs[4] = {v.x, v.y, v.z, v.w};
    __align__(8) __nv_bfloat16 hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[e] = __float2bfloat16_rn(xs[e]);
      lo[e] = __float2bfloat16_rn(xs[e] - __bfloat162float(hi[e]));
    }
    *reinterpret_cast<uint2*>(dst + i) = *reinterpret_cast<const uint2*>(hi);
    *reinterpret_cast<uint2*>(dst + n + i) =
        *reinterpret_cast<const uint2*>(lo);
  }
}

cudaError_t split_halves(const void* x, long long sb, long long sh,
                         long long ss, __nv_bfloat16* dst, int B, int heads,
                         int S, int D, cudaStream_t stream) {
  const long long n = static_cast<long long>(B) * heads * S * D;
  constexpr int kSplitThreads = 256;
  long long blocks = (n / 4 + kSplitThreads - 1) / kSplitThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;   // a grid-stride loop beyond
  split_kernel<<<static_cast<int>(blocks), kSplitThreads, 0, stream>>>(
      static_cast<const float*>(x), sb, sh, ss, dst, heads, S, D, n);
  return cudaGetLastError();
}

// A split operand's hi halves as a kernel view (contiguous; its lo halves
// lie n elements on, which the kernels take as their `lo` argument)
sx::attn::In split_view(const __nv_bfloat16* hi, int heads, int S, int D) {
  const long long ss = D, sh = static_cast<long long>(S) * D;
  return sx::attn::In{hi, sh * heads, sh, ss};
}

}  // namespace
