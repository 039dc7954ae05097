// K4 mips_bucket_candidates: fused score + bucket reduction for MIPS top-k.
//
// Replaces both TPU MIPS kernels (simxns_tpu/ops/mips_kernel.py:
// _mips_kernel :112-127, bf16 x bf16 -> f32; _mips_kernel_int8 :181-197,
// int8 x int8 -> int32 then * qs * cs) and their shared epilogue
// _bucket_reduce (:87-109). The scores of queries [Q, H] against corpus rows
// [N, H] (columns >= valid_n at -1e30) never reach device memory: every
// aligned bucket of columns is reduced to (max, first column reaching it),
// the TPU kernel's tie-break, and only [Q, n_pad / bucket] candidates are
// written, in global bucket order (the TPU kernel's [num_blocks, Q, nb]
// flattened the way its _finalize flattens it). The exact top-k over the
// candidates, the id offset and the -1 ids stay in PyTorch, as they stay in
// XLA there.
//
// Bound on the card: bytes at a serving batch (8 queries read the whole
// index once: 6.8 GB int8 at 8.8M x 768 rows, 2.04 ms), operations at a
// mining batch (1024 queries: 1.39e13 int8 operations, 7.03 ms). So K4 is
// the persistent TMA + wgmma GEMM of wgmma_gemm.cuh (queries = A, corpus
// = W, both K-major; the s8 or the bf16 warpgroup MMA) with its bucket
// epilogue: the scores are reduced in the accumulator's registers (pairs
// of a thread's columns, then the n8 blocks of a bucket, then the lanes of
// a quad by shuffles) and each row's candidates of a tile leave as one
// contiguous piece; nothing of the [BM, BN] scores is staged. The walk is
// corpus-major: the blocks in flight take the query tiles of one corpus
// tile back to back, so the corpus is read from device memory once and
// from L2 for the other query tiles, and the producer loads the next tile
// while the consumers reduce this one. What bounds it (H100, 8.8M x 768,
// scripts/torch_kernel_bench.py): at 8 queries the index's bytes (~90% of
// the HBM rate); at 1024 the epilogue, during which the tensor cores wait:
// the products and the ring alone run at ~80% of the int8 peak at 128 x 256
// (8.9 ms against the 7.03 ms bound, the epilogue stubbed), ~2.8 ms more
// with it.
//
// The tiles cover n_pad columns (the corpus padded to a multiple of the
// caller's block; its map has N rows and a tile wholly past them runs no
// products), whatever the block: bucket divides n_pad. Buckets of 8 to 128
// columns take kBucket + bucket (one kernel each, at the tile the wrapper
// chooses: ops/_native.py:mips_tile); 1, 2 and 4 take kBucketSmall at 64 x
// 128.
#include "wgmma_gemm.cuh"

namespace {

namespace gm = sx::gemm;

template <bool S8, int B>
int run(int bm, int bn, const void* q, const void* c, const gm::Args& args,
        int M, int N, int K, cudaStream_t s) {
  return gm::run<B, false, false, false, false, S8>(bm, bn, q, c, args, M, N,
                                                    K, s);
}

// the bucket size as a template argument: 1, 2 and 4 share kBucketSmall
template <bool S8>
int candidates(int bm, int bn, const void* q, const void* c,
               const gm::Args& args, int M, int N, int K, cudaStream_t s) {
  switch (args.bucket) {
    case 128: return run<S8, gm::kBucket + 128>(bm, bn, q, c, args, M, N, K, s);
    case 64: return run<S8, gm::kBucket + 64>(bm, bn, q, c, args, M, N, K, s);
    case 32: return run<S8, gm::kBucket + 32>(bm, bn, q, c, args, M, N, K, s);
    case 16: return run<S8, gm::kBucket + 16>(bm, bn, q, c, args, M, N, K, s);
    case 8: return run<S8, gm::kBucket + 8>(bm, bn, q, c, args, M, N, K, s);
    default: return run<S8, gm::kBucketSmall>(bm, bn, q, c, args, M, N, K, s);
  }
}

}  // namespace

extern "C" const char* sx_error_string(int code) {
  return gm::error_string(code);
}

// queries [M, H] and corpus [N, H], both int8 (int8 != 0, with per-row
// scales qs [M] and cs [N]) or both bf16 (scales unused); H bytes a row a
// multiple of 16, 16-byte aligned. The candidates cover n_pad >= N columns
// (columns >= N score as zero rows would, then -1e30 as >= valid_n);
// bucket is a power of two up to 128 dividing n_pad. out_s / out_i are
// [M, n_pad / bucket]. The tile bm x bn (ops/_native.py:mips_tile).
// Returns 0, a CUDA error code, or one of wgmma_gemm.cuh's.
extern "C" int sx_mips_candidates(const void* q, const void* c, const float* qs,
                                  const float* cs, int M, int N, int n_pad,
                                  int H, int int8, int valid_n, int bucket,
                                  float* out_s, int* out_i, int bm, int bn,
                                  void* stream) {
  if (bucket < 1 || 128 % bucket || n_pad % bucket || n_pad < N || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  gm::Args args;
  args.xs = qs;
  args.ws = cs;
  args.out = out_s;
  args.ids = out_i;
  args.bucket = bucket;
  args.valid_n = valid_n;
  args.n_cover = n_pad;
  args.out_cols = n_pad / bucket;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int8 ? candidates<true>(bm, bn, q, c, args, M, N, H, s)
              : candidates<false>(bm, bn, q, c, args, M, N, 2 * H, s);
}
