// A blocked tensor-core GEMM tile for Hopper (sm_90a), used by the bf16 MoE
// FFN kernel (`moe_ffn.cu`, row 9) alone.
//
// One thread block (256 threads, 8 warps) owns BN = 64 output columns and
// a chunk of MR = 2 * MT * 16 rows, and walks the contraction axis in
// BK = 32 steps.  Warp w computes row tiles (w / 4) * MT .. + MT - 1
// (16 rows each) of the chunk and columns (w % 4) * 16 .. + 15, with
// mma.sync m16n8k16 (bf16 x bf16 -> f32) from shared memory.  Each step's
// global loads go to registers first, so the next step's loads are in
// flight while the current step multiplies (register double buffering);
// there is no TMA, wgmma or deeper pipeline yet.
//
// The B operand (a weight, K x N row-major) and the A rows are bf16; the
// tensor cores sum in f32.
//
// Rows.  With a combine-weight array (`comb`, the MoE), a 16-row tile
// whose rows all have weight 0 is dead: its output is exactly 0 (the
// layer zeroes those rows of x too), so it is neither staged nor
// multiplied, and a chunk with no live tile reads no weight byte at all.
// Rows past the valid count (capacity 8 in a decode step is smaller than
// one m16 tile) are zeroed in the A fragments, in registers; they are
// never staged or stored.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gt {

using bf16 = __nv_bfloat16;

constexpr int BN = 64, BK = 32, NT = 256;
constexpr int LDA = BK + 8;        // padded shared-memory row strides (bf16)
constexpr int LDB = BN + 8;

enum { EPI_SWIGLU = 0, EPI_COMB = 1 };

struct Weight {                    // one B operand, per batch item
  const void* q;                   // bf16 (K, N)
  long long q_stride;              // elements per batch item
};

struct Params {
  const void* a;                   // bf16 rows, (batch * rows, K)
  Weight w[2];
  const float* comb;               // (batch, rows) or null: every row live
  void* out;                       // (batch * rows, N) bf16 or f32
  int rows, n, k;
  int batch, degree, gapped;       // batch items (experts), coarsening
};

// D[16x8] += A[16x16] * B[16x8]; the PTX ISA fragment layouts with
// lane = 4 * g + t: a0 (row g, k 2t..2t+1), a1 (row g+8), a2 (row g,
// k 8+2t..), a3 (row g+8, k 8+2t..); b0 (k 2t..2t+1, col g), b1 (k 8+2t..);
// d0, d1 (row g, cols 2t, 2t+1), d2, d3 (row g+8).
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 one row apart (p[0] low, p[ld] high)
__device__ __forceinline__ uint32_t ld_pair_col(const bf16* p, int ld) {
  const uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
  const uint32_t hi = *reinterpret_cast<const uint16_t*>(p + ld);
  return lo | (hi << 16);
}

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

// rows of a block's chunk: the batch item's own rows m0 + r
__device__ __forceinline__ int global_row(const Params& p, int e, int m0,
                                          int r) {
  return e * p.rows + m0 + r;
}

template <int MT, int NB, int EPI>
__global__ void __launch_bounds__(NT)
gemm_kernel(const Params p) {
  constexpr int MR = 2 * MT * 16;                 // rows per chunk
  constexpr int VA = BK / 8;                      // 16-byte vectors per A row
  constexpr int RA = (MR * VA + NT - 1) / NT;     // A vectors per thread
  constexpr int VB = BK * BN / 8;
  __shared__ __align__(16) bf16 sa[MR * LDA];
  __shared__ __align__(16) bf16 sb[NB * BK * LDB];
  __shared__ int live[2 * MT];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp >> 2, wc = warp & 3;
  const int n0 = blockIdx.x * BN;

  for (int j = 0; j < p.degree; ++j) {
    const int e = p.gapped ? j * (p.batch / p.degree) + blockIdx.y
                           : blockIdx.y * p.degree + j;
    const int nchunks = (p.rows + MR - 1) / MR;
    for (int ch = 0; ch < nchunks; ++ch) {
      const int m0 = ch * MR;
      const int nvalid = min(MR, p.rows - m0);
      __syncthreads();                            // `live` is free again
      if (tid < 2 * MT) {
        int lv = 0;
        const int r0 = tid * 16;
        if (r0 < nvalid) {
          if (p.comb == nullptr) {
            lv = 1;
          } else {
            const float* cw = p.comb + (size_t)e * p.rows + m0;
            for (int r = r0; r < min(r0 + 16, nvalid); ++r)
              lv |= cw[r] != 0.f;
          }
        }
        live[tid] = lv;
      }
      __syncthreads();
      int any = 0;
#pragma unroll
      for (int i = 0; i < 2 * MT; ++i) any |= live[i];

      float acc[NB][MT][2][4];
#pragma unroll
      for (int o = 0; o < NB; ++o)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int jn = 0; jn < 2; ++jn)
#pragma unroll
            for (int x = 0; x < 4; ++x) acc[o][mt][jn][x] = 0.f;

      if (any) {
        const bf16* abf = static_cast<const bf16*>(p.a);
        uint4 ra[RA];
        uint4 rb[NB];
        // global -> registers for the step at k0 (live, valid rows only)
        auto load = [&](int k0) {
#pragma unroll
          for (int it = 0; it < RA; ++it) {
            const int i = tid + it * NT;
            const int r = i / VA, c = i % VA;
            if (i < MR * VA && r < nvalid && live[r >> 4]) {
              const size_t row = (size_t)global_row(p, e, m0, r) * p.k + k0;
              ra[it] = *reinterpret_cast<const uint4*>(abf + row + c * 8);
            }
          }
#pragma unroll
          for (int o = 0; o < NB; ++o) {
            if (tid < VB) {
              const int r = tid / (BN / 8), c = tid % (BN / 8);
              const bf16* q = static_cast<const bf16*>(p.w[o].q) +
                              (size_t)e * p.w[o].q_stride;
              rb[o] = *reinterpret_cast<const uint4*>(
                  q + (size_t)(k0 + r) * p.n + n0 + c * 8);
            }
          }
        };
        // registers -> shared memory
        auto store = [&]() {
#pragma unroll
          for (int it = 0; it < RA; ++it) {
            const int i = tid + it * NT;
            const int r = i / VA, c = i % VA;
            if (i < MR * VA && r < nvalid && live[r >> 4])
              *reinterpret_cast<uint4*>(&sa[r * LDA + c * 8]) = ra[it];
          }
#pragma unroll
          for (int o = 0; o < NB; ++o) {
            if (tid < VB) {
              bf16* sbo = sb + o * BK * LDB;
              const int r = tid / (BN / 8), c = tid % (BN / 8);
              *reinterpret_cast<uint4*>(&sbo[r * LDB + c * 8]) = rb[o];
            }
          }
        };

        load(0);
        for (int k0 = 0; k0 < p.k; k0 += BK) {
          __syncthreads();                        // previous step consumed
          store();
          __syncthreads();
          if (k0 + BK < p.k) load(k0 + BK);       // in flight meanwhile
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            uint32_t bf[NB][2][2];
#pragma unroll
            for (int o = 0; o < NB; ++o)
#pragma unroll
              for (int jn = 0; jn < 2; ++jn) {
                const bf16* b = sb + o * BK * LDB + (ks * 16 + 2 * t) * LDB +
                                wc * 16 + jn * 8 + g;
                bf[o][jn][0] = ld_pair_col(b, LDB);
                bf[o][jn][1] = ld_pair_col(b + 8 * LDB, LDB);
              }
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              const int tile = wr * MT + mt;
              if (!live[tile]) continue;          // warp-uniform
              const int r = tile * 16 + g;
              const bool ok0 = r < nvalid, ok1 = r + 8 < nvalid;
              const bf16* x = sa + r * LDA + ks * 16 + 2 * t;
              const uint32_t a0 = ok0 ? ld_pair(x) : 0u;
              const uint32_t a1 = ok1 ? ld_pair(x + 8 * LDA) : 0u;
              const uint32_t a2 = ok0 ? ld_pair(x + 8) : 0u;
              const uint32_t a3 = ok1 ? ld_pair(x + 8 * LDA + 8) : 0u;
#pragma unroll
              for (int o = 0; o < NB; ++o)
#pragma unroll
                for (int jn = 0; jn < 2; ++jn)
                  mma(acc[o][mt][jn], a0, a1, a2, a3, bf[o][jn][0],
                      bf[o][jn][1]);
            }
          }
        }
      }

      // epilogue: rows r0 = tile*16 + g and r0 + 8, columns col, col + 1
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int tile = wr * MT + mt;
        const bool lv = live[tile] != 0;
        if (!lv && EPI != EPI_COMB) continue;
#pragma unroll
        for (int jn = 0; jn < 2; ++jn) {
          const int col = n0 + wc * 16 + jn * 8 + 2 * t;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = tile * 16 + g + half * 8;
            if (r >= nvalid) continue;
            const size_t orow = (size_t)global_row(p, e, m0, r);
            const float x0 = acc[0][mt][jn][2 * half];
            const float x1 = acc[0][mt][jn][2 * half + 1];
            if (EPI == EPI_SWIGLU) {
              const float h0 = silu(x0) * acc[NB - 1][mt][jn][2 * half];
              const float h1 = silu(x1) * acc[NB - 1][mt][jn][2 * half + 1];
              *reinterpret_cast<uint32_t*>(static_cast<bf16*>(p.out) +
                                           orow * p.n + col) = pack2(h0, h1);
            } else {
              const float cw = lv ? p.comb[orow] : 0.f;
              *reinterpret_cast<float2*>(static_cast<float*>(p.out) +
                                         orow * p.n + col) =
                  lv ? make_float2(x0 * cw, x1 * cw) : make_float2(0.f, 0.f);
            }
          }
        }
      }
    }
  }
}

template <int MT, int NB, int EPI>
int launch(const Params& p, int grid_y, cudaStream_t st) {
  dim3 grid(p.n / BN, grid_y);
  gemm_kernel<MT, NB, EPI><<<grid, NT, 0, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace gt
