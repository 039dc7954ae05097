// The views of K5's bf16 instance (group_attention.cu, on
// attention_ring.cuh's products) and its launch's shared memory limit (In,
// Out, prepare). The kernels on wgmma have their own views and tiles
// (attention_wgmma.cuh).
#pragma once

#include "tile_gemm.cuh"

namespace sx {
namespace attn {

struct In {               // a [B, heads, S, D] bf16 view, D contiguous
  const __nv_bfloat16* p;
  long long sb, sh, ss;   // element strides
  __device__ const __nv_bfloat16* row(int b, int h, int i) const {
    return p + b * sb + h * sh + static_cast<long long>(i) * ss;
  }
};

struct Out {              // a [B, heads, S, D] view of results, D contiguous
  __nv_bfloat16* p;
  long long sb, sh, ss;
  __device__ __nv_bfloat16* row(int b, int h, int i) const {
    return p + b * sb + h * sh + static_cast<long long>(i) * ss;
  }
};

template <class Kernel>
cudaError_t prepare(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace attn
}  // namespace sx
