// K10 and K11: the backward of the BERT feed-forward block
// y = gelu(x W1^T + b1) W2^T + b2, in bf16 with f32 accumulation, from hb =
// bf16(x W1^T) + b1, the one residual its forward (K9, ffn_fwd.cu) keeps.
//
// They replace two Pallas kernels of simxns_tpu/ops/fused_ffn.py:
//   K10 ffn_bwd_dx     _ffn_bwd_dx_kernel    (:348)  -> (dx, dh)
//   K11 ffn_bwd_dw     _ffn_bwd_dw_kernel    (:374)  -> (dW1, db1, dW2)
// with their arithmetic: each product accumulated in f32; GELU and its
// derivative in f32 from the rounded pre-activation hb, with the
// Abramowitz-Stegun erf, dh = bf16(f32 sum * gelu'(hb)); dh rounded to bf16
// before its second product; dW1, db1, dW2 in f32.
//
// Both run on the persistent wgmma GEMM of wgmma_gemm.cuh, whose operands
// may be MN-major: every product here contracts over the ROWS of one or
// both stored operands, which TMA lands as they lie and wgmma reads with
// its transpose immediates (nothing is transposed in device memory).
//
// K10 is two launches of one call:
// 1. GEMM 1, dy [M, H] W2 [H, F] (B MN-major) with the kGeluBwd epilogue:
//    reads hb, stores dh = bf16(acc * gelu'(hb)) [M, F], g = bf16(gelu(hb))
//    [M, F] for K11, and the column sums of bf16 dh over each 64 rows,
//    [ceil(M / 64), F] f32 (the parts of db1, no atomics);
// 2. GEMM 2, dh [M, F] W1 [F, H] (B MN-major), kPlain to bf16: dx [M, H].
// Why g is stored here: K11's dW2 needs g, GEMM 1's epilogue already reads
// hb and evaluates the erf for gelu', and one more bf16 store (168 MB at
// the CE-large step) costs less than each dW2 tile recomputing the GELU of
// its rows (H / BM times over).
//
// K11 is one launch of the GEMM over the output tiles of both weight
// gradients, dW1 [F, H] = dh^T x and dW2 [H, F] = dy^T g (A and B
// MN-major, kPlain to f32), then row_sums_kernel: db1 from K10's parts
// and, where K is split, dW1 and dW2 from the splits' partial products,
// each sum in a fixed order (the same bits every run). The tile and the
// split come from ops/_native.py:dw_tile: 128 x 256 tiles over K = M rows,
// cut into splits only where the tiles alone leave SMs idle (DE passages:
// 72 + 72 tiles on 132 SMs).
//
// Bound on the card: operations, 4 M H F flop per kernel (343.6 GFLOP at
// the CE-large step's M = 20,480, H = 1024, F = 4096: 0.347 ms at 989
// TFLOP/s), against K10's 0.6 GB (hb in, dh and g out, dy, dx) and K11's
// 0.4 GB. The first design was an mma.sync chained kernel for K10
// (32-row blocks that streamed both weights from L2) and an mma.sync tile
// core with ldmatrix...trans for K11: 3.53-3.58 and 2.70-2.77 ms there
// (H100).
#include "wgmma_gemm.cuh"

extern "C" const char* sx_error_string(int code) {
  return sx::gemm::error_string(code);
}

// K10; see the note at the head of this file. dy [M, H], W1 [F, H], W2
// [H, F], hb [M, F] bf16 -> dx [M, H], dh [M, F], g [M, F] bf16 and parts
// [ceil(M / 64), F] f32; the GEMMs' tiles (bm1, bn1) over [M, F] and (bm2,
// bn2) over [M, H] (ops/_native.py:wgmma_tile). H and F multiples of 64,
// any M >= 1 (the Python wrapper takes multiples of 128). Returns 0, a
// CUDA error code, or one of wgmma_gemm.cuh's.
extern "C" int sx_ffn_bwd_dx(const void* dy, const void* W1, const void* W2,
                             const void* hb, void* dx, void* dh, void* g,
                             float* parts, int M, int H, int F, int bm1,
                             int bn1, int bm2, int bn2, void* stream) {
  namespace gm = sx::gemm;
  if (M < 1 || H < 64 || H % 64 || F < 64 || F % 64)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gm::Product first{dy, W2, {}, M, F, 2 * H};
  first.args.out = dh;
  first.args.hb = hb;
  first.args.g = g;
  first.args.col_sums = parts;
  int err = gm::run_products<gm::kGeluBwd, false, true, false, false, false,
                             true>(bm1, bn1, &first, 1, 1, s);
  if (err != 0) return err;
  gm::Product second{dh, W1, {}, M, H, 2 * F};
  second.args.out = dx;
  return gm::run_products<gm::kPlain, false, true, false, false, false, true>(
      bm2, bn2, &second, 1, 1, s);
}

// K11; see the note at the head of this file. x, dy [M, H]; g, dh [M, F]
// bf16; parts [ceil(M / 64), F] f32 (K10's) -> dw1 [F, H], db1 [F], dw2
// [H, F] f32; the tile (bm, bn) and splits of K (ops/_native.py:dw_tile);
// partials [splits, 2 H F] f32 when splits > 1 (dW1's then dW2's), else
// unused. H and F multiples of 64, any M >= 1. Returns 0, a CUDA error
// code, or one of wgmma_gemm.cuh's.
extern "C" int sx_ffn_bwd_dw(const void* x, const void* dy, const void* g,
                             const void* dh, const float* parts, float* dw1,
                             float* db1, float* dw2, float* partials, int M,
                             int H, int F, int bm, int bn, int splits,
                             void* stream) {
  namespace gm = sx::gemm;
  if (M < 1 || H < 64 || H % 64 || F < 64 || F % 64 || splits < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long hf = static_cast<long long>(H) * F;
  gm::Product prods[2] = {{dh, x, {}, F, H, 2 * M}, {dy, g, {}, H, F, 2 * M}};
  prods[0].args.out = splits > 1 ? partials : dw1;
  prods[1].args.out = splits > 1 ? partials + splits * hf : dw2;
  int err = gm::run_products<gm::kPlain, false, false, false, false, true,
                             true, true>(bm, bn, prods, 2, splits, s);
  if (err != 0) return err;
  // db1 from K10's row parts; where K was split, dW1 and dW2 from their
  // splits' partials
  const gm::SumJob jobs[3] = {{parts, db1, (M + 63) / 64, F},
                              {partials, dw1, splits, hf},
                              {partials + splits * hf, dw2, splits, hf}};
  return gm::row_sums(jobs, splits > 1 ? 3 : 1, s);
}
