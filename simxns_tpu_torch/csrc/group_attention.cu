// K5 group_attention_fwd: softmax attention of every (batch, head) at S <
// 256, the bf16 instance, in f32 (its backward, K6, and the f32 instance
// of both are attention_bwd_wgmma.cu and attention_fwd_wgmma.cu).
//
// Replaces the grouped small-S forward Pallas kernel of the JAX package:
// simxns_tpu/ops/flash_attention.py:_fwd_call_group (kernel
// _fwd_kernel_group, :113). The contract, all in f32:
//   s  = (q k^T) * scale, scale = 1/sqrt(d)
//   s  = where(mask[key] > 0, s, -1e9)
//   p  = exp(s - rowmax) / rowsum(exp(s - rowmax))
//   o  = p v                                     (o cast to q's dtype)
// A batch element whose keys are all masked gets the uniform softmax over
// its S keys. The TPU kernel's grouping of _GROUP_BB batch elements per
// program is a VMEM detail: the result does not depend on it.
//
// Bound on the card: bytes. At the CE-large path's shape (128 x 16 heads,
// S=160, d=64) K5 moves 168 MB and does 13 GFLOP of model products, far
// under the bf16 tensor-core ridge. It does not write the S x S scores to
// device memory, and every product runs on the tensor cores (mma.sync
// m16n8k16, bf16 in, f32 accumulate); p enters p v as hi = bf16(p) and lo
// = bf16(p - hi), two products into one f32 accumulator: about 16 bits of
// the f32 value. The design (attention_ring.cuh's attend_one_pass): one
// block per (query tile of 64 rows, head, batch) lands its q tile once and
// streams kGroupKeys-key tiles of k and v through a two-stage cp.async
// ring, in ONE pass: log2-domain scores and ex2, a running max and sum a
// row with rescaling, one reciprocal a row at the end; v read by
// ldmatrix...trans. 3 products of 2 S^2 d per head (q k^T, p v as hi and
// lo) over the keys padded to the tile. Keys past S (the pad to a tile)
// get -inf, so they add exactly 0.
// Tensors are [B, heads, S, d] views with d contiguous and any strides that
// keep 16-byte rows: the port passes q, k, v as head views of the [B, S, H]
// projections and writes outputs in the same layout, so no transposes.
#include "attention_ring.cuh"
#include "attention_tile.cuh"

SX_DEFINE_ERROR_STRING

using namespace sx::attn;
namespace ring = sx::ring;

namespace {

constexpr int kMaxS = 255;
// K5's key tiles: 32 keys take S = 160 whole (64 pad it to 192); at the
// reranker's shape they run 8% faster than 64-key tiles
constexpr int kGroupKeys = 32;

template <int D>
constexpr int fwd_smem() {   // K5: q tile, the k and v ring, keys
  return ring::one_pass_smem<D, kGroupKeys>(kMaxS);
}

// K5: one block per (query tile, head, batch), one pass over the keys
// (attention_ring.cuh's attend_one_pass, kGroupKeys-key tiles)
template <int D>
__global__ void __launch_bounds__(ring::kThreads, D <= 64 ? 4 : 2)
    group_attention_fwd_kernel(In q, In k, In v, const int* __restrict__ mask,
                               Out o, int S, float scale2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  ring::attend_one_pass<D, kGroupKeys>(
      smem, [&](int i) { return q.row(b, h, i); },
      [&](int i) { return k.row(b, h, i); },
      [&](int i) { return v.row(b, h, i); },
      [&](int i) { return o.row(b, h, i); },
      mask + static_cast<long long>(b) * S, S, blockIdx.x * ring::kRows,
      scale2);
}

// K5 on views
int fwd(In qv, In kv, In vv, const int* mask, Out ov, int B, int heads,
        int S, int d, float scale, cudaStream_t st) {
  const dim3 grid((S + ring::kRows - 1) / ring::kRows, heads, B);
  cudaError_t err = cudaErrorInvalidValue;
  switch (d) {
#define SX_CASE(DD)                                                           \
  case DD:                                                                    \
    err = prepare(group_attention_fwd_kernel<DD>, fwd_smem<DD>());            \
    if (err != cudaSuccess) return static_cast<int>(err);                     \
    group_attention_fwd_kernel<DD>                                            \
        <<<grid, ring::kThreads, fwd_smem<DD>(), st>>>(                       \
            qv, kv, vv, mask, ov, S, scale * ring::kLog2e);                   \
    return static_cast<int>(cudaGetLastError());
    SX_CASE(16) SX_CASE(32) SX_CASE(48) SX_CASE(64)
    SX_CASE(80) SX_CASE(96) SX_CASE(112) SX_CASE(128)
#undef SX_CASE
  }
  return static_cast<int>(err);
}

}  // namespace

// q, k, v: [B, heads, S, d] bf16 views sharing the element strides
// (sb, sh, ss), d contiguous; mask [B, S] int32 (1 = real key); o a view
// with strides (ob, oh, os). Every row start must be 16-byte aligned (the
// wrapper checks). d on the 16 grid up to 128 (the wrapper pads
// other widths), 1 <= S <= 255. Returns
// cudaGetLastError() after the launch.
extern "C" int sx_group_attention_fwd(
    const void* q, const void* k, const void* v, long long sb, long long sh,
    long long ss, const int* mask, void* o, long long ob, long long oh,
    long long os, int B, int heads, int S, int d, float scale, void* stream) {
  if (S < 1 || S > kMaxS) return static_cast<int>(cudaErrorInvalidValue);
  using bf = __nv_bfloat16;
  const In qv{static_cast<const bf*>(q), sb, sh, ss};
  const In kv{static_cast<const bf*>(k), sb, sh, ss};
  const In vv{static_cast<const bf*>(v), sb, sh, ss};
  const Out ov{static_cast<bf*>(o), ob, oh, os};
  return fwd(qv, kv, vv, mask, ov, B, heads, S, d, scale,
             static_cast<cudaStream_t>(stream));
}
