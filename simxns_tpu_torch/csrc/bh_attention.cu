// K7 bh_attention_fwd: softmax attention of every (batch, head) at 256 <=
// S <= 1024, the bf16 instance (its backward, K8, is
// attention_bwd_wgmma.cu).
//
// Replaces the per-(batch, head) forward Pallas kernel of the JAX package:
// simxns_tpu/ops/flash_attention.py:_fwd_call (kernel _fwd_kernel, :67).
// The contract is K5's (group_attention.cu), all in f32:
//   s  = where(mask[key] > 0, (q k^T) * scale, -1e9), scale = 1/sqrt(d)
//   p  = exp(s - rowmax) / rowsum(exp(s - rowmax)),   o = p v
// A row whose keys are all masked gets the uniform softmax over its S keys
// (every score is -1e9), as on the TPU; keys past S in the last tile are
// padding and get -inf, so they weigh exactly 0.
//
// The TPU kernel holds one (b, h) -- q, k, v and the S x S scores -- in
// VMEM. A Hopper block has 227 KB of shared memory, and at S=1024, d=64, k
// and v alone are 256 KB of bf16. So the kernel streams tiles of 64 rows
// through shared memory, one block per (query tile, head, batch), in ONE
// pass over the keys (attention_ring.cuh): q lands in shared memory once;
// 64-key tiles of k and v stream through a two-stage cp.async ring (the
// next tile's copy overlaps the current tile's products); each row keeps a
// running max and sum in f32, the f32 accumulator is rescaled when the max
// grows, and the sum divides it once at the end (one reciprocal a row).
// Scores are scaled by log2(e) / sqrt(d) (the masks' -1e9 by log2(e) too),
// so each exponential is one ex2. p stays f32: p v takes it as hi + lo bf16
// halves, v read in its [key][d] layout through ldmatrix...trans. The
// result differs from the two-pass one by f32 rounding only.
//
// Bound on the card: bytes at the msdoc reranker's shape (128 joint rows x
// 12 heads x S=512 x d=64, bf16): it moves 403 MB and does 103 GFLOP of
// model products, as 3 products of 2 S^2 d per head (q k^T, and p v twice
// for the hi and lo halves) against the model's 2.
//
// The f32 instance, which takes f32 q, k, v as the JAX kernel does and
// splits each operand into hi and lo bf16 halves inside the kernel, runs
// on wgmma (attention_fwd_f32.cu, K5's f32 instance too).
#include "attention_ring.cuh"
#include "attention_tile.cuh"

SX_DEFINE_ERROR_STRING

using namespace sx::attn;
namespace ring = sx::ring;

namespace {

constexpr int kMaxS = 1024;

template <int D>
constexpr int fwd_smem() {           // K7: q tile, the k and v ring, keys
  return ring::one_pass_smem<D, ring::kKeys>(kMaxS);
}

// K7: one block per (query tile, head, batch), one pass over the keys
// (attention_ring.cuh's attend_one_pass, 64-key tiles).
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

In view(const void* p, long long sb, long long sh, long long ss) {
  return In{static_cast<const __nv_bfloat16*>(p), sb, sh, ss};
}

Out out_view(void* p, long long sb, long long sh, long long ss) {
  return Out{static_cast<__nv_bfloat16*>(p), sb, sh, ss};
}

// K7 on views
int fwd(In qv, In kv, In vv, const int* mask, Out ov, int B, int heads,
        int S, int d, float scale, cudaStream_t st) {
  const dim3 grid((S + ring::kRows - 1) / ring::kRows, heads, B);
  cudaError_t err;
  switch (d) {
#define SX_CASE(DD)                                                           \
  case DD:                                                                    \
    err = prepare(bh_attention_fwd_kernel<DD>, fwd_smem<DD>());               \
    if (err != cudaSuccess) return static_cast<int>(err);                     \
    bh_attention_fwd_kernel<DD>                                               \
        <<<grid, ring::kThreads, fwd_smem<DD>(), st>>>(                       \
            qv, kv, vv, mask, ov, S, scale * ring::kLog2e);                   \
    return static_cast<int>(cudaGetLastError());
    SX_CASE(16) SX_CASE(32) SX_CASE(48) SX_CASE(64)
    SX_CASE(80) SX_CASE(96) SX_CASE(112) SX_CASE(128)
#undef SX_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v: [B, heads, S, d] bf16 views sharing the element strides
// (sb, sh, ss), d contiguous; mask [B, S] int32 (1 = real key); o a view
// with strides (ob, oh, os). Every row start must be 16-byte aligned (the
// wrapper checks). d on the 16 grid up to 128 (the wrapper pads
// other widths), 1 <= S <= 1024, heads and B at most
// 65535. Returns cudaGetLastError() after the launch.
extern "C" int sx_bh_attention_fwd(
    const void* q, const void* k, const void* v, long long sb, long long sh,
    long long ss, const int* mask, void* o, long long ob, long long oh,
    long long os, int B, int heads, int S, int d, float scale, void* stream) {
  if (S < 1 || S > kMaxS) return static_cast<int>(cudaErrorInvalidValue);
  return fwd(view(q, sb, sh, ss), view(k, sb, sh, ss), view(v, sb, sh, ss),
             mask, out_view(o, ob, oh, os), B, heads, S, d, scale,
             static_cast<cudaStream_t>(stream));
}
