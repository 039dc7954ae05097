// Device functions shared by the query-tiled attention kernels: K3
// small_s_attention (small_s_attention.cu), K5 group_attention_fwd
// (group_attention.cu) and K7 bh_attention_fwd (bh_attention.cu), and
// through attention_bwd.cuh the backward kernels K6 group_attention_bwd
// (group_attention.cu) and K8 bh_attention_bwd.
//
// A block of 4 warps owns 64 query rows of one (sequence, head); each warp
// owns 16 of them. The block lands its q tile in shared memory once
// (cp.async, 16 bytes a thread) and each warp takes its A fragments from
// there with ldmatrix. Keys and values stream through a ring of kStages
// tiles of 64 (or 32) rows filled by cp.async: the copy of the next tile is
// in flight while the tensor cores work on the current one. Shared rows are
// padded to D + 8 elements (an odd number of 16-byte chunks), so the eight
// row addresses of an ldmatrix hit eight distinct bank groups.
//
// Both products run on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate), over NT n8 tiles of columns (8 * NT keys: 64 or 32 in the
// ring's tiles, 32 or 16 in K6's resident chunks):
// - q_k_tile: the warp's 16 x 8NT scores, k fragments by ldmatrix; any
//   "A rows x B rows^T" product (q k^T, dO v^T, k q^T, v dO^T);
// - p_v_tile: a 16 x 8NT bf16 A operand (p in registers, in the score
//   accumulator layout) times the 8NT x D value tile, read in its natural
//   [key][d] layout through ldmatrix...trans: no transposing stores.
// Scores are kept in the log2 domain (log2(e) folded into the scale and
// into the masks' constants), so each exponential is one ex2.
// attend_one_pass is the whole one-pass forward of K5 and K7.
#pragma once

#include "tile_gemm.cuh"

namespace sx {
namespace ring {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 64;       // query rows of a block
constexpr int kKeys = 64;       // keys of a streamed tile
constexpr int kStages = 2;      // tiles in the ring
constexpr int kNt = kKeys / 8;  // n8 score tiles of a warp per key tile
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Layout {
  static constexpr int kLd = D + 8;               // padded row, elements
  static constexpr int kTile = kRows * kLd;       // elements of one tile
};

__device__ __forceinline__ float ex2(float x) {   // 2^x, one MUFU op
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Four 8 x 8 b16 matrices from shared memory as they lie: lane l gives the
// address of row (l & 7) of matrix (l >> 3); of matrix i a lane gets, in
// r[i], the elements [g][2t] and [g][2t + 1].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* smem_row) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// Rows r0 .. r0 + ROWS - 1 of a [rows][D] bf16 operand into a padded
// shared tile, 16 bytes a copy; rows at or past S are zero-filled (no
// read). `row(i)` is the device address of row i (16-byte aligned).
template <int D, int ROWS = kRows, class Row>
__device__ __forceinline__ void copy_tile(__nv_bfloat16* dst, Row row, int r0,
                                          int S) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    const bool ok = r0 + r < S;
    cp_async16(dst + r * Layout<D>::kLd + c, row(ok ? r0 + r : 0) + c, ok);
  }
}

// The warp's A fragments of q (its rows warp * 16 .. + 15 of the tile).
template <int D>
__device__ __forceinline__ void load_q(uint32_t (&qa)[D / 16][4],
                                       const __nv_bfloat16* qs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const __nv_bfloat16* p =
      qs + (warp * 16 + (lane & 15)) * Layout<D>::kLd + (lane >> 4) * 8;
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) ldmatrix_x4(qa[kd], p + kd * 16);
}

// sc[nt][e] = q[row] . k[nt * 8 + col] over the 8NT keys of the tile `ks`;
// element e is row (e < 2 ? g : g + 8), column nt * 8 + 2t + (e & 1).
template <int D, int NT>
__device__ __forceinline__ void q_k_tile(float (&sc)[NT][4],
                                         const uint32_t (&qa)[D / 16][4],
                                         const __nv_bfloat16* ks) {
  const int lane = threadIdx.x & 31, mi = lane >> 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[nt][e] = 0.0f;
  // matrix mi: keys + (mi >> 1) * 8, d + (mi & 1) * 8 -> b0, b1 of two
  // n8 tiles
  const __nv_bfloat16* p =
      ks + ((mi >> 1) * 8 + (lane & 7)) * Layout<D>::kLd + (mi & 1) * 8;
#pragma unroll
  for (int np = 0; np < NT / 2; ++np)
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      uint32_t r[4];
      ldmatrix_x4(r, p + np * 16 * Layout<D>::kLd + kd * 16);
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      MmaBf16::mma(sc[2 * np], qa[kd], b0);
      MmaBf16::mma(sc[2 * np + 1], qa[kd], b1);
    }
}

// The A fragment of keys kk * 16 .. + 15 from two f32 values per register
// (accumulator layout), rounded to bf16.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int NT>
__device__ __forceinline__ void a_fragment(uint32_t (&a)[4],
                                           const float (&p)[NT][4], int kk) {
  a[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
  a[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
  a[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
  a[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
}

// The B fragments of value rows kk * 16 .. + 15, columns of two n8 tiles
// (2 * ndp and 2 * ndp + 1), transposed by ldmatrix on the way.
template <int D>
__device__ __forceinline__ void v_fragments(uint32_t (&r)[4],
                                            const __nv_bfloat16* vs, int kk,
                                            int ndp) {
  const int lane = threadIdx.x & 31, mi = lane >> 3;
  // matrix mi: keys + (mi & 1) * 8, d + (mi >> 1) * 8
  ldmatrix_x4_trans(r, vs + (kk * 16 + (mi & 1) * 8 + (lane & 7)) *
                                Layout<D>::kLd +
                            ndp * 16 + (mi >> 1) * 8);
}

// o[nd] += p v over the 8NT keys of the tile `vs`, p rounded to bf16.
template <int D, int NT>
__device__ __forceinline__ void p_v_tile(float (&o)[D / 8][4],
                                         const float (&p)[NT][4],
                                         const __nv_bfloat16* vs) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t a[4];
    a_fragment(a, p, kk);
#pragma unroll
    for (int ndp = 0; ndp < D / 16; ++ndp) {
      uint32_t r[4];
      v_fragments<D>(r, vs, kk, ndp);
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      MmaBf16::mma(o[2 * ndp], a, b0);
      MmaBf16::mma(o[2 * ndp + 1], a, b1);
    }
  }
}

// o[nd] += p v with an f32 p: p = hi + lo, two bf16 products into one f32
// sum (about 16 bits of each p).
template <int D, int NT>
__device__ __forceinline__ void p_v_tile_split(float (&o)[D / 8][4],
                                               const float (&p)[NT][4],
                                               const __nv_bfloat16* vs) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // register r: tile 2kk + (r >> 1), row g / g + 8 by r & 1
      const float* src = p[2 * kk + (r >> 1)] + 2 * (r & 1);
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(src[0], src[1]);
      const float2 hf = __bfloat1622float2(h2);
      hi[r] = *reinterpret_cast<const uint32_t*>(&h2);
      lo[r] = pack_bf16(src[0] - hf.x, src[1] - hf.y);
    }
#pragma unroll
    for (int ndp = 0; ndp < D / 16; ++ndp) {
      uint32_t r[4];
      v_fragments<D>(r, vs, kk, ndp);
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      MmaBf16::mma(o[2 * ndp], hi, b0);
      MmaBf16::mma(o[2 * ndp], lo, b0);
      MmaBf16::mma(o[2 * ndp + 1], hi, b1);
      MmaBf16::mma(o[2 * ndp + 1], lo, b1);
    }
  }
}

// max (op = 0) or sum (op = 1) of a per-row value over the four threads
// that share the row
template <int kOp>
__device__ __forceinline__ float quad(float x) {
#pragma unroll
  for (int m = 1; m <= 2; m <<= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, m);
    x = kOp == 0 ? fmaxf(x, y) : x + y;
  }
  return x;
}

// the two rows' maxima of a score tile, over the whole row (quad-reduced)
template <int NT>
__device__ __forceinline__ void tile_max(const float (&sc)[NT][4],
                                         float (&cm)[2]) {
  cm[0] = cm[1] = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) cm[e >> 1] = fmaxf(cm[e >> 1], sc[nt][e]);
  cm[0] = quad<0>(cm[0]);
  cm[1] = quad<0>(cm[1]);
}

// Shared memory of attend_one_pass: the q tile, the k and v ring of
// KEYS-row tiles, and a fill per key up to max_s rounded to KEYS.
template <int D, int KEYS>
__host__ __device__ constexpr int one_pass_smem(int max_s) {
  return (kRows + 2 * kStages * KEYS) * Layout<D>::kLd * 2 +
         (max_s + KEYS - 1) / KEYS * KEYS * 4;
}

// The one-pass softmax attention of query rows q0 .. q0 + 63 of one
// (sequence, head): o = softmax(where(mask, q k^T * scale, -1e9)) v in f32,
// stored as bf16. `q_row(i)`, `k_row(i)`, `v_row(i)` and `o_row(i)` are
// the device addresses of row i of the head (16-byte aligned, d
// contiguous), `mask` the sequence's [S] int32 key mask, scale2 = scale *
// log2(e). q lands once; k and v tiles of KEYS rows stream through the
// ring. Each row keeps a running max and sum of 2^(s - max) in f32; the
// f32 accumulator is rescaled when the max grows, and one reciprocal of
// the sum a row normalises it at the end. p stays f32 and enters p v as hi
// + lo bf16 halves. A key's fill makes its score: 0 = real (the scaled
// product), else -1e9 log2(e) (masked) or -inf past S (padding weighs
// exactly 0). A sequence with every key masked has all its scores equal,
// so p = 1 for each before normalising: the uniform softmax over S keys.
// Query rows past S are computed on zeros and not stored.
template <int D, int KEYS, class QRow, class KRow, class VRow, class ORow>
__device__ __forceinline__ void attend_one_pass(
    unsigned char* smem, QRow q_row, KRow k_row, VRow v_row, ORow o_row,
    const int* __restrict__ mask, int S, int q0, float scale2) {
  constexpr int kLd = Layout<D>::kLd;
  constexpr int kKv = KEYS * kLd;   // elements of one k or v tile
  constexpr int kNtk = KEYS / 8;    // n8 score tiles of a warp per tile
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + kRows * kLd;       // [kStages] tiles
  __nv_bfloat16* vs = ks + kStages * kKv;     // [kStages] tiles
  float* fill = reinterpret_cast<float*>(vs + kStages * kKv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = (S + KEYS - 1) / KEYS;

  for (int j = threadIdx.x; j < n_tiles * KEYS; j += kThreads)
    fill[j] = j >= S ? -INFINITY : (mask[j] > 0 ? 0.0f : -1e9f * kLog2e);
  auto issue = [&](int tile) {
    const int st = tile % kStages;
    copy_tile<D, KEYS>(ks + st * kKv, k_row, tile * KEYS, S);
    copy_tile<D, KEYS>(vs + st * kKv, v_row, tile * KEYS, S);
  };
  copy_tile<D>(qs, q_row, q0, S);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {   // q rides with the first
    if (i < n_tiles) issue(i);
    cp_async_commit();
  }

  const bool active = q0 + warp * 16 < S;   // warp-uniform; idle warps sync
  uint32_t qa[D / 16][4];
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.0f;
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + kStages - 1 < n_tiles) issue(tile + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    if (active) {
      if (tile == 0) load_q<D>(qa, qs);
      const int st = tile % kStages;
      float sc[kNtk][4];
      q_k_tile<D>(sc, qa, ks + st * kKv);
      const float* f = fill + tile * KEYS + 2 * t;
#pragma unroll
      for (int nt = 0; nt < kNtk; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float c = f[nt * 8 + (e & 1)];
          sc[nt][e] = c == 0.0f ? sc[nt][e] * scale2 : c;
        }
      float cm[2], alpha[2];
      tile_max(sc, cm);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(mx[r], cm[r]);
        alpha[r] = mx[r] == -INFINITY ? 0.0f : ex2(mx[r] - m_new);
        sum[r] *= alpha[r];
        mx[r] = m_new;
      }
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nd][e] *= alpha[e >> 1];
#pragma unroll
      for (int nt = 0; nt < kNtk; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[nt][e] = ex2(sc[nt][e] - mx[e >> 1]);
          sum[e >> 1] += sc[nt][e];
        }
      p_v_tile_split<D>(acc, sc, vs + st * kKv);
    }
    __syncthreads();
  }
  if (!active) return;
  const float inv[2] = {1.0f / quad<1>(sum[0]), 1.0f / quad<1>(sum[1])};
  const int ra = q0 + warp * 16 + g, rb = ra + 8;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (ra < S)
      *reinterpret_cast<__nv_bfloat162*>(o_row(ra) + c) =
          __floats2bfloat162_rn(acc[nd][0] * inv[0], acc[nd][1] * inv[0]);
    if (rb < S)
      *reinterpret_cast<__nv_bfloat162*>(o_row(rb) + c) =
          __floats2bfloat162_rn(acc[nd][2] * inv[1], acc[nd][3] * inv[1]);
  }
}

}  // namespace ring
}  // namespace sx
