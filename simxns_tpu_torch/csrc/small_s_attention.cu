// K3 small_s_attention: softmax(q k^T / sqrt(d) + bias) v for one
// (sequence, head) per block, S <= 512.
//
// Replaces the attention core of the TPU whole-layer kernel
// (simxns_tpu/ops/fused_layer.py:_layer_kernel :115-138): q, k, v bf16;
// scores in f32 (dot * (1/sqrt(d)), then + bias, bias = 0 or -1e9 from the
// key mask); subtract the row max, exp, divide by the sum, all f32; p cast
// to bf16; p v accumulated in f32. The context is written f32 into
// [M, H] at column head * d, so the next kernel (row_quant) quantizes whole
// rows across all heads, as the TPU kernel does.
//
// Bound on the card: bytes. At S=128, d=64 a head does 4 S^2 d = 4.2 MFLOP
// against 3 S d * 2 bytes of q, k, v read and S d * 4 bytes of context
// written, well under the bf16 tensor-core ridge. The design reads each
// head's k and v once into shared memory (k as [S][d], v transposed to
// [d][S], rows padded by 16 bytes so the 32-bit fragment loads of a warp
// hit distinct banks), never writes the S x S scores to device memory, and
// runs both products on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate). Each warp owns 16 query rows and walks the keys in chunks
// of 64 twice: the first pass finds each row's max and the sum of
// exp(s - max) (the sum rescaled when the max grows), the second recomputes
// the scores, forms p = bf16(exp(s - max) / sum) in registers -- the score
// accumulators are the A fragments of p v -- and accumulates p v. Normalising
// before the bf16 cast keeps the TPU kernel's rounding of p. Keys past S
// (the pad to a chunk) get a -inf bias, so they add exactly 0.
#include "tile_gemm.cuh"

SX_DEFINE_ERROR_STRING

namespace {

constexpr int kWarps = 4;
constexpr int kMaxS = 512;
constexpr int kChunk = 64;   // keys per pass step

__host__ __device__ constexpr int padded_s(int S) {
  return (S + kChunk - 1) / kChunk * kChunk;
}

template <int D>
constexpr int smem_bytes(int S) {
  // k [Sp][D + 8] bf16, v^T [D][Sp + 8] bf16, bias [Sp] f32
  return padded_s(S) * (D + 8) * 2 + D * (padded_s(S) + 8) * 2 +
         padded_s(S) * 4;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
    small_s_attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                             const int* __restrict__ mask,
                             float* __restrict__ ctx, int S, int H,
                             float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Sp = padded_s(S);
  constexpr int kRowK = D + 8;
  const int row_v = Sp + 8;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [Sp][D+8]
  __nv_bfloat16* vt = ks + Sp * kRowK;                           // [D][Sp+8]
  float* bias = reinterpret_cast<float*>(vt + D * row_v);        // [Sp]

  const int head = blockIdx.x, seq = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long row0 = static_cast<long>(seq) * S;
  const long ld = 3L * H;
  const __nv_bfloat16* base = qkv + row0 * ld + head * D;

  // k rows and v^T columns, 8 bf16 (16 bytes) per load; zeros past S
  for (int idx = threadIdx.x; idx < Sp * (D / 8); idx += blockDim.x) {
    const int j = idx / (D / 8), c = (idx % (D / 8)) * 8;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    if (j < S) {
      kv = *reinterpret_cast<const uint4*>(base + j * ld + H + c);
      vv = *reinterpret_cast<const uint4*>(base + j * ld + 2 * H + c);
    }
    *reinterpret_cast<uint4*>(ks + j * kRowK + c) = kv;
    const __nv_bfloat16* v8 = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
    for (int u = 0; u < 8; ++u) vt[(c + u) * row_v + j] = v8[u];
  }
  for (int j = threadIdx.x; j < Sp; j += blockDim.x)
    bias[j] = j >= S ? -INFINITY : (mask[row0 + j] > 0 ? 0.0f : -1e9f);
  __syncthreads();

  for (int r0 = warp * 16; r0 < S; r0 += kWarps * 16) {
    // q rows r0 + g and r0 + g + 8 as A fragments, straight from memory
    uint32_t qa[D / 16][4];
    const int ra = r0 + g, rb = r0 + g + 8;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      const int c = kd * 16 + 2 * t;
      qa[kd][0] = ra < S ? ld32(base + ra * ld + c) : 0u;
      qa[kd][1] = rb < S ? ld32(base + rb * ld + c) : 0u;
      qa[kd][2] = ra < S ? ld32(base + ra * ld + c + 8) : 0u;
      qa[kd][3] = rb < S ? ld32(base + rb * ld + c + 8) : 0u;
    }

    // scores of this warp's 16 rows against keys [c0, c0 + 64):
    // sc[nt][e] is row (e < 2 ? g : g + 8), key c0 + nt * 8 + 2t + (e & 1)
    auto scores = [&](int c0, float (&sc)[kChunk / 8][4]) {
#pragma unroll
      for (int nt = 0; nt < kChunk / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = 0.0f;
        const __nv_bfloat16* kr = ks + (c0 + nt * 8 + g) * kRowK + 2 * t;
#pragma unroll
        for (int kd = 0; kd < D / 16; ++kd) {
          const uint32_t kb[2] = {ld32(kr + kd * 16), ld32(kr + kd * 16 + 8)};
          sx::MmaBf16::mma(sc[nt], qa[kd], kb);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float s = sc[nt][e] * scale;
          sc[nt][e] = s + bias[c0 + nt * 8 + 2 * t + (e & 1)];
        }
      }
    };

    // pass 1: row max and sum of exp(s - max), per thread, then over the
    // four threads that share a row
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
    for (int c0 = 0; c0 < Sp; c0 += kChunk) {
      float sc[kChunk / 8][4];
      scores(c0, sc);
      float cm[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < kChunk / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) cm[e >> 1] = fmaxf(cm[e >> 1], sc[nt][e]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        cm[h] = fmaxf(cm[h], __shfl_xor_sync(0xffffffffu, cm[h], 1));
        cm[h] = fmaxf(cm[h], __shfl_xor_sync(0xffffffffu, cm[h], 2));
        const float m_new = fmaxf(mx[h], cm[h]);
        sum[h] = mx[h] == -INFINITY ? 0.0f : sum[h] * expf(mx[h] - m_new);
        mx[h] = m_new;
      }
#pragma unroll
      for (int nt = 0; nt < kChunk / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[e >> 1] += expf(sc[nt][e] - mx[e >> 1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    }

    // pass 2: p = bf16(exp(s - max) / sum), context += p v
    float o[D / 8][4];
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nd][e] = 0.0f;
    for (int c0 = 0; c0 < Sp; c0 += kChunk) {
      float sc[kChunk / 8][4];
      scores(c0, sc);
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        uint32_t pa[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float* s = sc[2 * kk + half];
          pa[2 * half] = pack_bf16(expf(s[0] - mx[0]) / sum[0],
                                   expf(s[1] - mx[0]) / sum[0]);
          pa[2 * half + 1] = pack_bf16(expf(s[2] - mx[1]) / sum[1],
                                       expf(s[3] - mx[1]) / sum[1]);
        }
        const __nv_bfloat16* vr = vt + g * row_v + c0 + kk * 16 + 2 * t;
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          const __nv_bfloat16* p = vr + nd * 8 * row_v;
          const uint32_t vb[2] = {ld32(p), ld32(p + 8)};
          sx::MmaBf16::mma(o[nd], pa, vb);
        }
      }
    }

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
}

template <int D>
cudaError_t launch(const void* qkv, const int* mask, float* ctx, int B, int S,
                   int H, float scale, cudaStream_t stream) {
  const int bytes = smem_bytes<D>(S);
  cudaError_t err = cudaFuncSetAttribute(
      small_s_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(H / D, B);
  small_s_attention_kernel<D><<<grid, kWarps * 32, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), mask, ctx, S, H, scale);
  return cudaGetLastError();
}

}  // namespace

// Shared-memory bytes one block needs (the wrapper refuses > 227 KB).
extern "C" int sx_small_s_attention_smem(int d, int S) {
  switch (d) {
    case 32: return smem_bytes<32>(S);
    case 64: return smem_bytes<64>(S);
    case 128: return smem_bytes<128>(S);
  }
  return -1;
}

// qkv [B*S, 3H] bf16 (q | k | v), mask [B, S] int32 (1 = real key),
// ctx [B*S, H] f32. d = H / heads in {32, 64, 128}; S <= 512. Rows of qkv
// and the head offsets must be 16-byte aligned (H % 8 == 0, checked by the
// wrapper). Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unsupported d or S).
extern "C" int sx_small_s_attention(const void* qkv, const int* mask,
                                    float* ctx, int B, int S, int H, int d,
                                    float scale, void* stream) {
  if (S < 1 || S > kMaxS) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch<32>(qkv, mask, ctx, B, S, H, scale, s);
    case 64: return launch<64>(qkv, mask, ctx, B, S, H, scale, s);
    case 128: return launch<128>(qkv, mask, ctx, B, S, H, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
