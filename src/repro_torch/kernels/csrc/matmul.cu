// Coarsened blocked matmul for Hopper (sm_90a): (M,K) bf16 @ (K,N) bf16 -> f32.
//
// Replaces the Pallas kernel `repro/kernels/matmul.py` `make_kernel` (its
// pl.pallas_call at :69), which the FFN's gate, up and down products run in
// prefill (`repro/models/layers.py` `ffn`).
//
// What it computes: one thread block owns C row blocks of BM = 64 rows of A
// (and of the output) and BN = 64 * vector_width output columns.  The C row
// blocks are adjacent (consecutive) or M/C rows apart (gapped: row block c
// of block i starts at c*(M/C) + i*BM), as in the Pallas kernel's A view.
// For each BK = 32 step of the contraction, the block stages its C A tiles
// and ONE (BK x BN) B tile in shared memory with 16-byte loads, and all C
// row blocks multiply against that B tile: the coarsening's point
// (`matmul.py:8-10`) is that B is fetched once per block instead of once
// per row block.  The products run on the tensor cores through WMMA
// (bf16 x bf16 -> f32, 16x16x16 fragments); 8 warps each hold C * 2 * VW
// accumulator fragments, so C * vector_width is capped at 4.
//
// Bound on this card: max(2*M*N*K / 989 TFLOP/s, bytes / 3.35 TB/s) with
// bytes = 2*M*K + 2*K*N + 4*M*N.  At the prefill FFN's M = 128 the B operand
// (the weight) dominates the bytes, so the kernel is bandwidth-bound there:
// what the design does about it is read each weight byte from device memory
// once per row-block group (once in total when C * BM covers M).  It has no
// software pipeline, TMA or wgmma yet; those are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BM = 64, BK = 32, NTHREADS = 256;

template <int C, int VW>
__global__ void __launch_bounds__(NTHREADS)
coarsened_matmul_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                        float* __restrict__ o, int m, int n, int k,
                        int gapped) {
  constexpr int BN = 64 * VW;
  constexpr int LDA = BK + 8;     // padded rows: fewer bank conflicts, and
  constexpr int LDB = BN + 8;     // every fragment pointer stays 32B-aligned
  constexpr int FC = 2 * VW;      // 16-wide fragment columns per warp
  __shared__ __align__(32) bf16 as[C * BM * LDA];
  __shared__ __align__(32) bf16 bs[BK * LDB];

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wr = warp & 3;        // fragment row inside each row block
  const int wc = warp >> 2;       // half of the BN columns
  const int n0 = blockIdx.x * BN;

  int row0[C];
#pragma unroll
  for (int c = 0; c < C; ++c)
    row0[c] = gapped ? c * (m / C) + blockIdx.y * BM : (blockIdx.y * C + c) * BM;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[C][FC];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int f = 0; f < FC; ++f) wmma::fill_fragment(acc[c][f], 0.f);

  for (int k0 = 0; k0 < k; k0 += BK) {
    // A: C tiles of (BM x BK) = 256 16-byte vectors each, one per thread
    {
      const int r = tid >> 2, cc = (tid & 3) * 8;
#pragma unroll
      for (int c = 0; c < C; ++c)
        *reinterpret_cast<uint4*>(&as[(c * BM + r) * LDA + cc]) =
            *reinterpret_cast<const uint4*>(
                &a[(size_t)(row0[c] + r) * k + k0 + cc]);
    }
    // B: one (BK x BN) tile = 256 * VW vectors, shared by all C row blocks
#pragma unroll
    for (int t = 0; t < VW; ++t) {
      const int i = tid + t * NTHREADS;
      const int r = i / (BN / 8), cc = (i % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(&bs[r * LDB + cc]) =
          *reinterpret_cast<const uint4*>(&b[(size_t)(k0 + r) * n + n0 + cc]);
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf[FC];
#pragma unroll
      for (int f = 0; f < FC; ++f)
        wmma::load_matrix_sync(bf[f], &bs[kk * LDB + (wc * FC + f) * 16], LDB);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::load_matrix_sync(af, &as[(c * BM + wr * 16) * LDA + kk], LDA);
#pragma unroll
        for (int f = 0; f < FC; ++f)
          wmma::mma_sync(acc[c][f], af, bf[f], acc[c][f]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int f = 0; f < FC; ++f)
      wmma::store_matrix_sync(
          &o[(size_t)(row0[c] + wr * 16) * n + n0 + (wc * FC + f) * 16],
          acc[c][f], n, wmma::mem_row_major);
}

template <int C, int VW>
int launch(const void* a, const void* b, void* o, int m, int n, int k,
           int gapped, cudaStream_t st) {
  dim3 grid(n / (64 * VW), m / (C * BM));
  coarsened_matmul_kernel<C, VW><<<grid, NTHREADS, 0, st>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<float*>(o), m, n, k, gapped);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int coarsened_matmul_bf16(const void* a, const void* b, void* o,
                                     int m, int n, int k, int c, int vw,
                                     int gapped, void* stream) {
  if (m % (c * BM) || n % (64 * vw) || k % BK) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (c * 10 + vw) {
    case 11: return launch<1, 1>(a, b, o, m, n, k, gapped, st);
    case 12: return launch<1, 2>(a, b, o, m, n, k, gapped, st);
    case 14: return launch<1, 4>(a, b, o, m, n, k, gapped, st);
    case 21: return launch<2, 1>(a, b, o, m, n, k, gapped, st);
    case 22: return launch<2, 2>(a, b, o, m, n, k, gapped, st);
    case 41: return launch<4, 1>(a, b, o, m, n, k, gapped, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
