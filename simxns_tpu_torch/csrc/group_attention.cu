// K5 group_attention_fwd and K6 group_attention_bwd: softmax attention of
// every (batch, head) at S < 256, forward and backward, in f32.
//
// Replace the grouped small-S Pallas pair of the JAX package:
// simxns_tpu/ops/flash_attention.py:_fwd_call_group (kernel
// _fwd_kernel_group, :113) and _fused_group_bwd (kernel _bwd_kernel_group,
// :125). The contract, all in f32:
//   s  = (q k^T) * scale, scale = 1/sqrt(d)
//   s  = where(mask[key] > 0, s, -1e9)
//   p  = exp(s - rowmax) / rowsum(exp(s - rowmax))
//   o  = p v                                     (K5; o cast to q's dtype)
//   dV = p^T dO, dP = dO v^T, dS = p (dP - rowsum(dP p)),
//   dQ = dS k * scale, dK = dS^T q * scale       (K6; p recomputed)
// A batch element whose keys are all masked gets the uniform softmax over
// its S keys. The TPU kernel's grouping of _GROUP_BB batch elements per
// program is a VMEM detail: the result does not depend on it.
//
// Bound on the card: bytes. At the CE-large path's shape (128 x 16 heads,
// S=160, d=64) K5 moves 168 MB and does 13 GFLOP, K6 moves 294 MB and does
// 34 GFLOP of model products -- both far under the bf16 tensor-core
// ridge. Neither writes the S x S scores to device memory, and every
// product runs on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate); a product with an f32 operand (p or dS) takes it as hi =
// bf16(x) and lo = bf16(x - hi), two products into one f32 accumulator:
// about 16 bits of the f32 value, where TF32 (10 bits) would be too coarse
// for dS, whose dP - rowsum(dP p) cancels.
// - K5 is K7's forward (attention_ring.cuh's attend_one_pass): one block
//   per (query tile of 64 rows, head, batch) lands its q tile once and
//   streams kGroupKeys-key tiles of k and v through a two-stage cp.async
//   ring, in ONE pass: log2-domain scores and ex2, a running max and sum a
//   row with rescaling, one reciprocal a row at the end; v read by
//   ldmatrix...trans. 3 products of 2 S^2 d per head (q k^T, p v as hi and
//   lo) over the keys padded to the tile.
// - K6 (attention_bwd.cuh's device functions), one block per (batch,
//   head) with the head's tiles resident, each warp owning 16 rows and
//   walking the other side in chunks of 32: phase A (rows = queries; k, v
//   in shared memory) folds each row's max, sum and rowsum(dP p) in one
//   walk and keeps lse = log2-domain log-sum-exp and rowsum(dP p) in shared
//   memory, then a second walk accumulates dQ with p = 2^(s - lse); phase
//   B (rows = keys; q, dO in shared memory) recomputes p^T and dS^T from
//   those statistics and accumulates dV and dK over all queries, so no
//   block writes a partial sum and no atomics are needed. Fragments come
//   by ldmatrix (transposed on the way for p^T dO, dS k and dS^T q); 12
//   products of 2 S^2 d per head against the model's 5, and 3 ex2 a score.
// Keys past S (the pad to a tile or chunk) get -inf, so they add exactly 0.
// These are the bf16 instances: K5's f32 instance is K7's, the wgmma
// forward of attention_fwd_f32.cu, and K6's is K8's, the wgmma backward of
// attention_bwd_wgmma.cu (K6 keeps a whole head's k and v, then q and dO, in
// shared memory, and as hi + lo halves those tiles would take 2 x 2 x 256
// x 136 x 2 bytes = 278 KB at d = 128, past the 227 KB of a block; K8's
// two passes stream them).
// Tensors are [B, heads, S, d] views with d contiguous and any strides that
// keep 16-byte rows: the port passes q, k, v as head views of the [B, S, H]
// projections and writes outputs in the same layout, so no transposes.
#include "attention_bwd.cuh"
#include "attention_tile.cuh"

SX_DEFINE_ERROR_STRING

using namespace sx::attn;
namespace bwd = sx::bwd;
namespace ring = sx::ring;

namespace {

constexpr int kMaxS = 255;
// K5's key tiles: 32 keys take S = 160 whole (64 pad it to 192); at the
// reranker's shape they run 8% faster than 64-key tiles
constexpr int kGroupKeys = 32;
// K6's phase B takes the queries 16 at a time: with dK, dV and the k, v
// fragments held, 32-query score tiles would not fit three blocks an SM
constexpr int kKeyStep = 16;

__host__ __device__ constexpr int padded_s(int S) {
  return (S + kChunk - 1) / kChunk * kChunk;
}

template <int D>
constexpr int fwd_smem() {   // K5: q tile, the k and v ring, keys
  return ring::one_pass_smem<D, kGroupKeys>(kMaxS);
}

template <int D>
constexpr int smem_bytes(int S) {
  // K6: two [Sp][D + 8] bf16 tiles, then per key a fill, and per query
  // lse and rowsum(dP p)
  return 2 * padded_s(S) * (D + 8) * 2 + 3 * padded_s(S) * 4;
}

// K5: one block per (query tile, head, batch), one pass over the keys
// (attention_ring.cuh's attend_one_pass, kGroupKeys-key tiles): K7's kernel
// at S < 256
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

// K6: one block per (batch, head), the device functions of the backward
// walks (attention_bwd.cuh) over resident tiles in chunks of kChunk = 32 rows.
// Phase A (16 query rows a warp; k and v resident): walk 1 folds each row's
// lse and rowsum(dP p), walk 2 accumulates dQ; the statistics go to shared
// memory. Phase B (16 key rows a warp; q and dO resident in k's and v's
// place): dV and dK over every query. Query rows past S are zero-filled and
// keep statistics of 0: they add exactly 0.
template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 3 : 2)
    group_attention_bwd_kernel(In q, In k, In v, In dout,
                               const int* __restrict__ mask, Out dq, Out dk,
                               Out dv, int S, float scale, float scale2) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kLd = D + 8;
  const int Sp = padded_s(S);
  __nv_bfloat16* t0 = reinterpret_cast<__nv_bfloat16*>(smem);  // k, then q
  __nv_bfloat16* t1 = t0 + Sp * kLd;                            // v, then dO
  float* fill = reinterpret_cast<float*>(t1 + Sp * kLd);
  float* lse = fill + Sp;
  float* dot = lse + Sp;
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  load_rows<D>(t0, k, b, h, 0, Sp, S);
  load_rows<D>(t1, v, b, h, 0, Sp, S);
  const bool none_real = bwd::all_masked(mask, b, S);
  for (int i = threadIdx.x; i < Sp; i += kThreads) {
    fill[i] = bwd::key_fill(mask, b, i, S, none_real);
    lse[i] = 0.0f;
    dot[i] = 0.0f;
  }
  __syncthreads();

  // phase A: 16 query rows per warp -> row statistics and dQ
  for (int r0 = warp * 16; r0 < S; r0 += kWarps * 16) {
    uint32_t qa[D / 16][4], da[D / 16][4];
    load_a<D>(qa, q, b, h, r0, S);
    load_a<D>(da, dout, b, h, r0, S);
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
    float dotu[2] = {0.0f, 0.0f};
    for (int c0 = 0; c0 < Sp; c0 += kChunk)
      bwd::stats_tile<D, kTiles>(qa, da, t0 + c0 * kLd, t1 + c0 * kLd,
                                 fill + c0, scale2, mx, sum, dotu);
    float rl[2], rd[2];
    bwd::finish_stats(mx, sum, dotu, rl, rd);
    float acc[D / 8][4];
    zero<D>(acc);
    for (int c0 = 0; c0 < Sp; c0 += kChunk)
      bwd::dq_tile<D, kTiles>(qa, da, t0 + c0 * kLd, t1 + c0 * kLd,
                              fill + c0, scale2, rl, rd, acc);
    store_rows<D>(dq, b, h, r0, S, acc, scale);
    if (t == 0) {
      const int ra = r0 + g, rb = r0 + g + 8;
      if (ra < S) lse[ra] = rl[0], dot[ra] = rd[0];
      if (rb < S) lse[rb] = rl[1], dot[rb] = rd[1];
    }
  }
  __syncthreads();
  load_rows<D>(t0, q, b, h, 0, Sp, S);
  load_rows<D>(t1, dout, b, h, 0, Sp, S);
  __syncthreads();

  // phase B: 16 key rows per warp -> dV = p^T dO, dK = dS^T q * scale
  for (int j0 = warp * 16; j0 < S; j0 += kWarps * 16) {
    uint32_t ka[D / 16][4], va[D / 16][4];
    load_a<D>(ka, k, b, h, j0, S);
    load_a<D>(va, v, b, h, j0, S);
    const float kf[2] = {fill[j0 + g], fill[j0 + g + 8]};
    float dka[D / 8][4], dva[D / 8][4];
    zero<D>(dka);
    zero<D>(dva);
    for (int i0 = 0; i0 < Sp; i0 += kKeyStep)
      bwd::dkv_tile<D, kKeyStep / 8>(ka, va, kf, t0 + i0 * kLd,
                                     t1 + i0 * kLd, lse + i0, dot + i0,
                                     scale2, dka, dva);
    store_rows<D>(dk, b, h, j0, S, dka, scale);
    store_rows<D>(dv, b, h, j0, S, dva, 1.0f);
  }
}

}  // namespace

// every S and d the wrappers take fits one block's shared memory (227 KB)
static_assert(smem_bytes<128>(kMaxS) <= 232448, "K6 shared memory");

namespace {

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

// The backward: q, k, v as above; dout a view with strides (db, dh, ds);
// dq, dk, dv views sharing the strides (gb, gh, gs).
extern "C" int sx_group_attention_bwd(
    const void* q, const void* k, const void* v, long long sb, long long sh,
    long long ss, const void* dout, long long db, long long dh, long long ds,
    const int* mask, void* dq, void* dk, void* dv, long long gb, long long gh,
    long long gs, int B, int heads, int S, int d, float scale, void* stream) {
  if (S < 1 || S > kMaxS) return static_cast<int>(cudaErrorInvalidValue);
  using bf = __nv_bfloat16;
  const In qv{static_cast<const bf*>(q), sb, sh, ss};
  const In kv{static_cast<const bf*>(k), sb, sh, ss};
  const In vv{static_cast<const bf*>(v), sb, sh, ss};
  const In dov{static_cast<const bf*>(dout), db, dh, ds};
  const Out dqv{static_cast<bf*>(dq), gb, gh, gs};
  const Out dkv{static_cast<bf*>(dk), gb, gh, gs};
  const Out dvv{static_cast<bf*>(dv), gb, gh, gs};
  const dim3 grid(heads, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (d) {
#define SX_CASE(DD)                                                           \
  case DD:                                                                    \
    err = prepare(group_attention_bwd_kernel<DD>, smem_bytes<DD>(S));         \
    if (err != cudaSuccess) return static_cast<int>(err);                     \
    group_attention_bwd_kernel<DD><<<grid, kThreads, smem_bytes<DD>(S), st>>>( \
        qv, kv, vv, dov, mask, dqv, dkv, dvv, S, scale,                       \
        scale * sx::ring::kLog2e);                                            \
    return static_cast<int>(cudaGetLastError());
    SX_CASE(16) SX_CASE(32) SX_CASE(48) SX_CASE(64)
    SX_CASE(80) SX_CASE(96) SX_CASE(112) SX_CASE(128)
#undef SX_CASE
  }
  return static_cast<int>(err);
}
