// K9 ffn_train_fwd and K12 ffn_fused_fwd: the training and the encode
// forward of the BERT feed-forward block,
//   hb = bf16(x W1^T) + b1        (bf16 add),
//   g  = bf16(gelu(f32(hb)))      (the Abramowitz-Stegun erf),
//   y  = bf16(g W2^T) + b2,
// with bf16 operands and f32 sums; K9 also returns hb, the one residual of
// the backward (K10 in fused_ffn.cu reads it). They replace
// _ffn_train_fwd_kernel (simxns_tpu/ops/fused_ffn.py:324, pallas_call :424)
// and _ffn_kernel (:77, pallas_call :94), which differ only by hb's store,
// with their arithmetic: each product rounded to bf16 before its bf16 bias,
// GELU in f32 from the rounded hb, g rounded before the second product.
// Only the order of the f32 sums differs from the plain version, so y and
// hb are within one bf16 step of it.
//
// Two launches of one call on the persistent wgmma GEMM of wgmma_gemm.cuh
// (kBias, bf16 m64nNk16 wgmma: a 128-byte swizzle row holds 64 bf16 values
// and a k16 step advances 32 bytes, as the int8 k32 step does):
// 1. GEMM 1, x W1^T with the epilogue round -> + b1 -> round -> GELU ->
//    round: g [M, F] bf16 into device memory; K9's instance (PRE) also
//    stores hb [M, F], the value before the GELU, from the same staged
//    slices;
// 2. GEMM 2, g W2^T with the epilogue round -> + b2 -> round: y [M, H].
// Bound on the card: operations, 4 M H F flop in bf16; at the encode chunk
// (131,072 x 768 x 3072) 1.24e12 flop, 1.25 ms (its inputs and output move
// 0.41 GB, 0.12 ms); K9 at the CE-large step (20,480 x 1024 x 4096) 3.44e11
// flop, 0.347 ms (hb adds 168 MB, 0.05 ms). Why g goes through device
// memory: the TPU kernels keep W1 and W2 in VMEM and g in scratch (on v5e
// the [M, 4H] round trip through HBM, not the MXU, bounded XLA). On this
// card a fused kernel streams both weights from L2 once per row block, at
// BM flop a byte, so keeping L2 under the ~7.7 TB/s it gave K1 at the dense
// peak (989 TFLOP/s in bf16) takes BM >= ~128 rows, whose [128, 768] f32
// sum (393 KB) outgrows an SM's 256 KB of registers. The first cut kept 32
// rows a block and streamed 9.4 MB of weights from L2 per block (13.7 ms
// at the chunk, H100; K9's 3.59 ms at CE-large). g in bf16 is what the
// plain version rounds anyway: writing and reading it moves 1.6 GB, ~0.48
// ms at 3.35 TB/s, under the GEMMs' 1.25 ms.
#include "wgmma_gemm.cuh"

extern "C" const char* sx_error_string(int code) {
  return sx::gemm::error_string(code);
}

// x [M, H], W1 [F, H], b1 [F], W2 [H, F], b2 [H] bf16; g [M, F] (the
// workspace) and out [M, H] bf16; hb [M, F] bf16 for K9, null for K12; the
// GEMMs' tiles (bm1, bn1) over [M, F] and (bm2, bn2) over [M, H]
// (ops/_native.py:wgmma_tile). H and F multiples of 64, any M >= 1 (the
// Python wrapper takes multiples of 128, the JAX kernels' grid). Returns 0,
// a CUDA error code, or one of wgmma_gemm.cuh's.
extern "C" int sx_ffn_fwd(const void* x, const void* W1, const void* b1,
                          const void* W2, const void* b2, void* g, void* hb,
                          void* out, int M, int H, int F, int bm1, int bn1,
                          int bm2, int bn2, void* stream) {
  namespace gm = sx::gemm;
  if (M < 1 || H < 64 || H % 64 || F < 64 || F % 64)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gm::Args first;
  first.bias = b1;
  first.out = g;
  first.pre = hb;
  int err = hb != nullptr
                ? gm::run<gm::kBias, true, true, false, true>(
                      bm1, bn1, x, W1, first, M, F, 2 * H, s)
                : gm::run<gm::kBias, true, true, false>(bm1, bn1, x, W1,
                                                        first, M, F, 2 * H, s);
  if (err != 0) return err;
  gm::Args second;
  second.bias = b2;
  second.out = out;
  return gm::run<gm::kBias, false, true, false>(bm2, bn2, g, W2, second, M,
                                                H, 2 * F, s);
}
