// Dequant-fused coarsened matmul for Hopper (sm_90a):
// (M,K) bf16 @ packed (K,N) weight -> (M,N) f32.
//
// Replaces the Pallas kernel `repro/kernels/matmul.py` `make_qkernel`
// (:87; its pl.pallas_call at :142), which the shared-expert FFN of a
// quantized MoE model (and any quantized dense FFN) runs in prefill
// (`repro/models/layers.py` `ffn`, :646-653).
//
// The weight arrives as int8 with one f32 scale per column ((1, N)) or as
// int4 nibbles packed two to a byte along K (offset-binary, even rows in
// the low nibble) with one scale per group of `group` rows ((K/group, N)).
// The Pallas kernel dequantizes the pane in VMEM and takes an f32 product;
// here the packed values are widened to bf16 in shared memory (exact), the
// tensor cores form the exact products a * q in f32, and the scale is
// applied after the product: per column in the epilogue (int8), per group
// to the group's partial sums (int4).  See `gemm_tile.cuh`.
//
// Coarsening, as the Pallas A view (`_a_o_layout`): a block owns `degree`
// row blocks of 128 rows, adjacent (consecutive) or M/degree rows apart
// (gapped), and 64 output columns; each staged weight tile serves every
// row of all `degree` blocks, so a weight byte is read once per block
// instead of once per row block.  degree <= 2 (the accumulators of 256
// rows fill the registers).
//
// Bound on this card: max(2*M*N*K / 989 TFLOP/s, bytes / 3.35 TB/s) with
// bytes = 2*M*K + K*N*bits/8 + scales + 4*M*N.  At the prefill chunk's
// M = 128 the packed weight dominates the bytes, so it is bandwidth-bound.
#include "gemm_tile.cuh"

using namespace gt;

extern "C" int quant_matmul(const void* a, const void* bq, const void* bs,
                            void* out, int m, int n, int k, int bits,
                            int group, int degree, int gapped, void* stream) {
  if (degree < 1 || degree > 2 || m % (degree * 128) || n % BN || k % BK)
    return (int)cudaErrorInvalidValue;
  if (bits != 8 && bits != 4) return (int)cudaErrorInvalidValue;
  if (bits == 4 && (group < 16 || group % 16 || k % group))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  Params p{};
  p.a = a;
  p.w[0] = Weight{bq, static_cast<const float*>(bs), 0, 0};
  p.comb = nullptr;
  p.out = out;
  p.rows = m;
  p.n = n;
  p.k = k;
  p.group = bits == 4 ? group : 1;
  p.batch = 1;
  p.degree = degree;
  p.gapped = gapped;
  p.row_blocks = 1;
  const int grid_y = m / (degree * 128);
  if (bits == 8)
    return degree == 1
               ? launch<4, 1, false, B_INT8, EPI_STORE>(p, grid_y, st)
               : launch<8, 1, false, B_INT8, EPI_STORE>(p, grid_y, st);
  return degree == 1 ? launch<4, 1, false, B_INT4, EPI_STORE>(p, grid_y, st)
                     : launch<8, 1, false, B_INT4, EPI_STORE>(p, grid_y, st);
}
