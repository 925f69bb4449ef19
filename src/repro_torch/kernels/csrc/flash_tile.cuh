// Warp-level tensor-core tiles of the block-sparse flash forward
// (`sparse_attention.cu`) on Hopper (sm_90a); the dense flash kernels
// (`flash_attention.cu`) run on wgmma with `hopper.cuh`'s helpers instead.
//
// Operands are staged in shared memory as rows of D bf16 with a padded
// stride (LD = D + PAD, so the fragment loads of neighbouring rows fall in
// different banks).  Each warp owns 16 rows of the left operand; products
// run through mma.sync m16n8k16 (bf16 x bf16 -> f32), and a [16 x N]
// product's C fragments are reused as the A fragments of the next product
// (the C layout of two adjacent n8 tiles is the A layout of one k16 step),
// so probabilities never leave registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ft {

using bf16 = __nv_bfloat16;

constexpr float NEG = -1e30f;      // the Pallas kernels' mask sentinel
constexpr int PAD = 8;             // shared-memory row padding (bf16)

// rows of the K/V tile a block of nw warps of q rows streams at head dim
// d: 64, or 32 where the q rows (16 warps) or the head dim (256) leave
// less room in shared memory and registers
__host__ __device__ constexpr int kv_tile(int d, int nw) {
  return nw >= 16 || d >= 256 ? 32 : 64;
}

// D[16x8] += A[16x16] * B[16x8]; fragment layouts as the PTX ISA gives
// them for mma.m16n8k16 with lane = 4 * g + t:
//   a0 (row g, cols 2t..2t+1)  a1 (row g+8, same)  a2 (row g, cols 8+2t..)
//   a3 (row g+8, cols 8+2t..); b0 (k 2t..2t+1, col g)  b1 (k 8+2t.., col g);
//   d0, d1 (row g, cols 2t, 2t+1)  d2, d3 (row g+8, same).
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two adjacent bf16 (p[0] low, p[1] high)
__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 one row apart (p[0] low, p[ld] high)
__device__ __forceinline__ uint32_t ld_pair_col(const bf16* p, int ld) {
  uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
  uint32_t hi = *reinterpret_cast<const uint16_t*>(p + ld);
  return lo | (hi << 16);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// stage `rows` rows of D bf16 (global row of local row r: rowmap(r)) into
// shared memory with a padded stride, 16 bytes a thread
template <int D, typename RowMap>
__device__ __forceinline__ void stage_bf16(bf16* dst, const bf16* src,
                                           int rows, RowMap rowmap) {
  constexpr int LD = D + PAD, VEC = D / 8;
  for (int i = threadIdx.x; i < rows * VEC; i += blockDim.x) {
    const int r = i / VEC, cv = (i % VEC) * 8;
    *reinterpret_cast<uint4*>(&dst[r * LD + cv]) =
        *reinterpret_cast<const uint4*>(&src[(size_t)rowmap(r) * D + cv]);
  }
}

// s[16 x N] = X[rows r0.., D] . Y[rows n.., D]^T for one warp; X and Y are
// row-major in shared memory with stride LD
template <int D, int N>
__device__ __forceinline__ void warp_xyt(float (&s)[N / 8][4], const bf16* x,
                                         const bf16* y, int r0) {
  constexpr int LD = D + PAD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const bf16* xa = x + (r0 + g) * LD + ks * 16 + 2 * t;
    const uint32_t a0 = ld_pair(xa), a1 = ld_pair(xa + 8 * LD);
    const uint32_t a2 = ld_pair(xa + 8), a3 = ld_pair(xa + 8 * LD + 8);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const bf16* yb = y + (j * 8 + g) * LD + ks * 16 + 2 * t;
      mma_bf16(s[j], a0, a1, a2, a3, ld_pair(yb), ld_pair(yb + 8));
    }
  }
}

// acc[16 x D] += P[16 x K] . Y[K rows, D] for one warp: P is the warp's
// own C fragments of a [16 x K] product (p[K/8][4]), reused as A
// fragments; Y is row-major in shared memory with stride LD
template <int D, int K>
__device__ __forceinline__ void warp_py(float (&acc)[D / 8][4],
                                        const float (&p)[K / 8][4],
                                        const bf16* y) {
  constexpr int LD = D + PAD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t a0 = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    const uint32_t a1 = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    const uint32_t a2 = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    const uint32_t a3 = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
    const bf16* yb = y + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd)
      mma_bf16(acc[jd], a0, a1, a2, a3, ld_pair_col(yb + jd * 8, LD),
               ld_pair_col(yb + jd * 8 + 8 * LD, LD));
  }
}

// one online-softmax step of a warp's 16 rows over a [16 x KT] score tile
// s (raw q.k products): entries whose (row, col) `live` rejects weigh
// exactly 0; m, l are the rows' running max and sum (g and g + 8), acc the
// [16 x D] output sum, rescaled; v is the tile's V rows in shared memory.
// `live(row, col)` is the caller's per-element mask.
template <int D, int KT, typename Live>
__device__ __forceinline__ void softmax_step(float (&s)[KT / 8][4],
                                             float (&acc)[D / 8][4],
                                             float& m0, float& m1, float& l0,
                                             float& l1, int row0, int row1,
                                             int c0, float scale,
                                             const bf16* v, Live live) {
  const int t = threadIdx.x & 3;
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int j = 0; j < KT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = c0 + j * 8 + 2 * t + e;
      s[j][e] = live(row0, col) ? s[j][e] * scale : NEG;
      s[j][2 + e] = live(row1, col) ? s[j][2 + e] * scale : NEG;
      mx0 = fmaxf(mx0, s[j][e]);
      mx1 = fmaxf(mx1, s[j][2 + e]);
    }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < KT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = c0 + j * 8 + 2 * t + e;
      s[j][e] = live(row0, col) ? expf(s[j][e] - mx0) : 0.f;
      s[j][2 + e] = live(row1, col) ? expf(s[j][2 + e] - mx1) : 0.f;
      rs0 += s[j][e];
      rs1 += s[j][2 + e];
    }
  const float al0 = expf(m0 - mx0), al1 = expf(m1 - mx1);
  l0 = l0 * al0 + quad_sum(rs0);
  l1 = l1 * al1 + quad_sum(rs1);
  m0 = mx0;
  m1 = mx1;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[j][0] *= al0;
    acc[j][1] *= al0;
    acc[j][2] *= al1;
    acc[j][3] *= al1;
  }
  warp_py<D, KT>(acc, s, v);
}

// write a warp's o rows (acc / l, the Pallas `l == 0` guard) and, when mo
// is given, its (m, l) residuals; o, mo, lo point at the (b, h) plane
template <int D>
__device__ __forceinline__ void store_o(float* o, float* mo, float* lo,
                                        const float (&acc)[D / 8][4],
                                        float m0, float m1, float l0,
                                        float l1, int row0, int row1) {
  const int t = threadIdx.x & 3;
  const float lg0 = l0 == 0.f ? 1.f : l0, lg1 = l1 == 0.f ? 1.f : l1;
  float* o0 = o + (size_t)row0 * D + 2 * t;
  float* o1 = o + (size_t)row1 * D + 2 * t;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<float2*>(o0 + j * 8) =
        make_float2(acc[j][0] / lg0, acc[j][1] / lg0);
    *reinterpret_cast<float2*>(o1 + j * 8) =
        make_float2(acc[j][2] / lg1, acc[j][3] / lg1);
  }
  if (mo != nullptr && t == 0) {
    mo[row0] = m0;
    mo[row1] = m1;
    lo[row0] = l0;
    lo[row1] = l1;
  }
}

}  // namespace ft
