// K4 mips_bucket_candidates: fused score + bucket reduction for MIPS top-k.
//
// Replaces both TPU MIPS kernels (simxns_tpu/ops/mips_kernel.py:
// _mips_kernel :112-127, bf16 x bf16 -> f32; _mips_kernel_int8 :181-197,
// int8 x int8 -> int32 then * qs * cs) and their shared epilogue
// _bucket_reduce (:87-109). Each block computes the scores of a tile of
// queries against 128 corpus rows, sets rows >= valid_n to -1e30, and
// reduces every aligned `bucket` of rows to (max, first index reaching the
// max), the TPU kernel's tie-break. The [Q, N] score matrix never reaches
// device memory: the block writes [Q, N / bucket] candidates, laid out in
// global bucket order (the TPU kernel's [num_blocks, Q, nb] flattened the
// way its _finalize flattens it). The exact top-k over the candidates,
// the id offset and the -1 ids stay in PyTorch, as they stay in XLA there.
//
// Bound on the card: bytes at a serving batch (8 queries read the whole
// index once: 6.8 GB int8 at 8.8M x 768 rows), operations at a mining
// batch (1024 queries: 1.39e13 int8 ops). The design reads the corpus
// once per query tile, and the 1-D grid walks the query tiles of one
// corpus tile back to back, so a tile re-read for the next query tile
// comes from L2, not device memory. The query tile shrinks with the batch
// (32, 64 or 128 rows) so a small batch wastes few tensor-core rows. The
// scores go through shared memory for the bucket scan. Int8 tiles use
// mma.sync m16n8k32, bf16 tiles m16n8k16 (csrc/tile_gemm.cuh).
#include "tile_gemm.cuh"

SX_DEFINE_ERROR_STRING

namespace {

template <class Mma, int MF>
struct Cfg {
  using G = sx::TileGemm<Mma, MF>;
  static constexpr int kTile = G::BM * (G::BN + 1) * 4;
  static constexpr int kSmem = G::kSmem > kTile ? G::kSmem : kTile;
};

template <class Mma, int MF, bool SCALED>
__global__ void __launch_bounds__(sx::kThreads)
    mips_candidates_kernel(const uint8_t* __restrict__ Q,
                           const uint8_t* __restrict__ C,
                           const float* __restrict__ qs,
                           const float* __restrict__ cs, int M, int N,
                           long kb, int q_tiles, int valid_n, int bucket,
                           long nb_total, float* __restrict__ out_s,
                           int* __restrict__ out_i) {
  using G = typename Cfg<Mma, MF>::G;
  extern __shared__ __align__(16) uint8_t smem[];
  const long tile = blockIdx.x;
  const int m0 = static_cast<int>(tile % q_tiles) * G::BM;
  const int n0 = static_cast<int>(tile / q_tiles) * G::BN;

  typename G::Acc acc[MF][4][4];
  G::run(acc, smem, Q, C, m0, n0, M, N, kb);

  float* sc = reinterpret_cast<float*>(smem);  // [BM][BN + 1]
#pragma unroll
  for (int mi = 0; mi < MF; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = G::row(mi, e), c = G::col(ni, e);
        const int m = m0 + r, n = n0 + c;
        float v = static_cast<float>(acc[mi][ni][e]);
        if (SCALED) {
          v = v * (m < M ? qs[m] : 0.0f);
          v = v * (n < N ? cs[n] : 0.0f);
        }
        if (n >= valid_n) v = -1e30f;
        sc[r * (G::BN + 1) + c] = v;
      }
  __syncthreads();

  const int per_tile = G::BN / bucket;
  for (int task = threadIdx.x; task < G::BM * per_tile; task += sx::kThreads) {
    const int r = task / per_tile, b = task % per_tile;
    const int m = m0 + r;
    if (m >= M) continue;
    const float* row = sc + r * (G::BN + 1) + b * bucket;
    float best = row[0];
    int arg = 0;
    for (int j = 1; j < bucket; ++j)
      if (row[j] > best) {
        best = row[j];
        arg = j;
      }
    const long o = static_cast<long>(m) * nb_total + (n0 + b * bucket) / bucket;
    out_s[o] = best;
    out_i[o] = n0 + b * bucket + arg;
  }
}

template <class Mma, int MF, bool SCALED>
cudaError_t launch(const void* q, const void* c, const float* qs,
                   const float* cs, int M, int N, long n_pad, long kb,
                   int valid_n, int bucket, float* out_s, int* out_i,
                   cudaStream_t stream) {
  using C = Cfg<Mma, MF>;
  cudaError_t err = cudaFuncSetAttribute(
      mips_candidates_kernel<Mma, MF, SCALED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  const int q_tiles = (M + C::G::BM - 1) / C::G::BM;
  const long tiles = static_cast<long>(q_tiles) * (n_pad / C::G::BN);
  mips_candidates_kernel<Mma, MF, SCALED>
      <<<static_cast<unsigned>(tiles), sx::kThreads, C::kSmem, stream>>>(
          static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(c), qs,
          cs, M, N, kb, q_tiles, valid_n, bucket, n_pad / bucket, out_s,
          out_i);
  return cudaGetLastError();
}

template <class Mma, bool SCALED>
cudaError_t by_rows(const void* q, const void* c, const float* qs,
                    const float* cs, int M, int N, long n_pad, long kb,
                    int valid_n, int bucket, float* out_s, int* out_i,
                    cudaStream_t s) {
  if (M <= 32)
    return launch<Mma, 1, SCALED>(q, c, qs, cs, M, N, n_pad, kb, valid_n,
                                  bucket, out_s, out_i, s);
  if (M <= 64)
    return launch<Mma, 2, SCALED>(q, c, qs, cs, M, N, n_pad, kb, valid_n,
                                  bucket, out_s, out_i, s);
  return launch<Mma, 4, SCALED>(q, c, qs, cs, M, N, n_pad, kb, valid_n,
                                bucket, out_s, out_i, s);
}

}  // namespace

// queries [M, H] and corpus [N, H], both int8 (int8 != 0, with per-row
// scales qs [M] and cs [N]) or both bf16 (scales unused). The candidate
// grid covers n_pad rows (a multiple of 128; rows >= N read as zeros);
// bucket divides 128. out_s/out_i are [M, n_pad / bucket].
// Returns cudaGetLastError() after the launch.
extern "C" int sx_mips_candidates(const void* q, const void* c, const float* qs,
                                  const float* cs, int M, int N, long n_pad,
                                  int H, int int8, int valid_n, int bucket,
                                  float* out_s, int* out_i, void* stream) {
  if (bucket < 1 || sx::kBN % bucket || n_pad % sx::kBN)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int8)
    return by_rows<sx::MmaS8, true>(q, c, qs, cs, M, N, n_pad, H, valid_n,
                                    bucket, out_s, out_i, s);
  return by_rows<sx::MmaBf16, false>(q, c, qs, cs, M, N, n_pad, 2L * H,
                                     valid_n, bucket, out_s, out_i, s);
}
