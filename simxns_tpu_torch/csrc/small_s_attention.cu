// K3 small_s_attention: softmax(q k^T / sqrt(d) + bias) v for every
// (sequence, head), S <= 1024, one block per 64 query rows.
//
// Replaces the attention core of the TPU whole-layer kernel
// (simxns_tpu/ops/fused_layer.py:_layer_kernel :115-138): q, k, v bf16;
// scores in f32 (dot * (1/sqrt(d)), then + bias, bias = 0 or -1e9 from the
// key mask); subtract the row max, exp, normalise by the sum, all f32; p
// cast to bf16 AFTER the normalisation (the TPU kernel's rounding of p);
// p v accumulated in f32. The context is written f32 into [M, H] at column
// head * d, so the next kernel (row_quant) quantizes whole rows across all
// heads, as the TPU kernel does.
//
// Bound on the card: bytes at S=128 (4 S^2 d of products per head against
// 3 S d * 2 bytes read and S d * 4 written), the tensor cores' rate past
// S ~ 300. The design (attention_ring.cuh): the grid is (query tiles of 64,
// heads, sequences), so a block's shared memory does not grow with S (49
// KB at d=64: four blocks an SM at every S) and the S/64 blocks of one head
// run side by side, reading its k and v from L2. A block lands its q tile
// once and streams 64-key tiles of k, then of k and v, through a two-stage
// cp.async ring: pass 1 folds each row's max and sum of exp(s - max) over
// the k tiles (the sum rescaled when the max grows), pass 2 recomputes the
// scores, forms p = bf16(exp(s - max) / sum) in registers -- the
// score accumulators are the A fragments of p v -- and accumulates p v on
// the tensor cores, v read through ldmatrix...trans. Scores are scaled by
// log2(e) / sqrt(d) and the bias by log2(e), so each exponential is one
// ex2; each row takes one reciprocal of its sum, and the quotient is
// corrected to the true division's rounding by two FMAs (a product with the
// reciprocal alone moved enough bf16 roundings of p to reorder near-ties
// of a 12-layer encode's top-10). Keys past S (the pad to a tile) get a
// -inf bias, so they add exactly 0.
#include "attention_ring.cuh"

SX_DEFINE_ERROR_STRING

using namespace sx::ring;

namespace {

constexpr int kMaxS = 1024;   // the key bias row in shared memory

template <int D>
constexpr int smem_bytes() {
  // q tile, kStages k tiles, kStages v tiles (bf16), biases (f32)
  return (1 + 2 * kStages) * Layout<D>::kTile * 2 + kMaxS * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 4 : 2)
    small_s_attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                             const int* __restrict__ mask,
                             float* __restrict__ ctx, int S, int H,
                             float scale2) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kTile = Layout<D>::kTile;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + kTile;                 // [kStages] tiles
  __nv_bfloat16* vs = ks + kStages * kTile;       // [kStages] tiles
  float* bias = reinterpret_cast<float*>(vs + kStages * kTile);  // [kMaxS]

  const int q0 = blockIdx.x * kRows, head = blockIdx.y, seq = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long row0 = static_cast<long>(seq) * S;
  const long ld = 3L * H;
  const __nv_bfloat16* base = qkv + row0 * ld + head * D;
  auto q_row = [&](int i) { return base + i * ld; };
  auto k_row = [&](int i) { return base + i * ld + H; };
  auto v_row = [&](int i) { return base + i * ld + 2 * H; };
  const int n_tiles = (S + kKeys - 1) / kKeys;

  for (int j = threadIdx.x; j < n_tiles * kKeys; j += kThreads)
    bias[j] = j >= S ? -INFINITY
                     : (mask[row0 + j] > 0 ? 0.0f : -1e9f * kLog2e);
  // step s < n_tiles streams k tile s (pass 1), step n_tiles + j streams k
  // and v tile j (pass 2); the copies of the next kStages - 1 steps
  // overlap step s
  auto issue = [&](int s) {
    const int tile = s % n_tiles, st = s % kStages;
    copy_tile<D>(ks + st * kTile, k_row, tile * kKeys, S);
    if (s >= n_tiles) copy_tile<D>(vs + st * kTile, v_row, tile * kKeys, S);
  };
  copy_tile<D>(qs, q_row, q0, S);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {   // q rides with the first group
    if (s < 2 * n_tiles) issue(s);
    sx::cp_async_commit();
  }

  const bool active = q0 + warp * 16 < S;   // warp-uniform; idle warps sync
  uint32_t qa[D / 16][4];
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f}, inv[2];
  float o[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.0f;

  for (int s = 0; s < 2 * n_tiles; ++s) {
    if (s + kStages - 1 < 2 * n_tiles) issue(s + kStages - 1);
    sx::cp_async_commit();
    sx::cp_async_wait<kStages - 1>();
    __syncthreads();
    if (active) {
      if (s == 0) load_q<D>(qa, qs);
      const int tile = s % n_tiles, st = s % kStages;
      float sc[kNt][4];
      q_k_tile<D>(sc, qa, ks + st * kTile);
      const float* b = bias + tile * kKeys + 2 * t;
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[nt][e] = __fmaf_rn(sc[nt][e], scale2, b[nt * 8 + (e & 1)]);
      if (s < n_tiles) {
        float cm[2];
        tile_max(sc, cm);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(mx[r], cm[r]);
          sum[r] = mx[r] == -INFINITY ? 0.0f : sum[r] * ex2(mx[r] - m_new);
          mx[r] = m_new;
        }
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sum[e >> 1] += ex2(sc[nt][e] - mx[e >> 1]);
      } else {
        if (s == n_tiles) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            sum[r] = quad<1>(sum[r]);
            inv[r] = 1.0f / sum[r];
          }
        }
        // p = e / sum rounded as a true division: the product with the
        // rounded reciprocal, corrected once by its residual (exact by
        // FMA), is the correctly rounded quotient (Markstein)
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = ex2(sc[nt][e] - mx[e >> 1]);
            const float q = x * inv[e >> 1];
            const float res = __fmaf_rn(-q, sum[e >> 1], x);
            sc[nt][e] = __fmaf_rn(res, inv[e >> 1], q);
          }
        p_v_tile<D>(o, sc, vs + st * kTile);
      }
    }
    __syncthreads();
  }
  if (!active) return;

  const int ra = q0 + warp * 16 + g, rb = ra + 8;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = head * D + nd * 8 + 2 * t;
    if (ra < S)
      *reinterpret_cast<float2*>(ctx + (row0 + ra) * H + c) =
          make_float2(o[nd][0], o[nd][1]);
    if (rb < S)
      *reinterpret_cast<float2*>(ctx + (row0 + rb) * H + c) =
          make_float2(o[nd][2], o[nd][3]);
  }
}

template <int D>
cudaError_t launch(const void* qkv, const int* mask, float* ctx, int B, int S,
                   int H, float scale, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      small_s_attention_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D>());
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kRows - 1) / kRows, H / D, B);
  small_s_attention_kernel<D><<<grid, kThreads, smem_bytes<D>(), stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), mask, ctx, S, H,
      scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// qkv [B*S, 3H] bf16 (q | k | v), mask [B, S] int32 (1 = real key),
// ctx [B*S, H] f32. d = H / heads on the 16 grid up to 128 (the wrapper
// pads other widths); S <= 1024; B <= 65535.
// Rows of qkv and the head offsets must be 16-byte aligned (H % 8 == 0,
// checked by the wrapper). Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unsupported d or S).
extern "C" int sx_small_s_attention(const void* qkv, const int* mask,
                                    float* ctx, int B, int S, int H, int d,
                                    float scale, void* stream) {
  if (S < 1 || S > kMaxS) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
#define SX_CASE(DD) \
    case DD: return launch<DD>(qkv, mask, ctx, B, S, H, scale, s);
    SX_CASE(16) SX_CASE(32) SX_CASE(48) SX_CASE(64)
    SX_CASE(80) SX_CASE(96) SX_CASE(112) SX_CASE(128)
#undef SX_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
