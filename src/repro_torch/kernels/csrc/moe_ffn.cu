// Grouped-expert MoE FFN for Hopper (sm_90a), bf16 and dequant-fused.
//
// Replaces the two Pallas kernels of `repro/kernels/moe_ffn.py`:
//
//   moe_ffn_bf16   <- `make_kernel`  (:35; its pl.pallas_call at :90)
//   quant_moe_ffn  <- `make_qkernel` (:110; its pl.pallas_call at :190)
//
// What they compute, per expert e of the padded dispatch buffer:
//   y[e] = ((silu(x[e] @ w1[e]) * (x[e] @ w3[e])) @ w2[e]) * comb[e][:, None]
// with x (E, C, d) bf16, w1 / w3 (E, d, F), w2 (E, F, d), comb (E, C) f32
// and y (E, C, d) f32.  The bf16 kernel rounds the (C, F) intermediate h
// to bf16 once, as `moe_ffn.py:62` does; the dequant-fused kernel keeps h
// in f32, as its Pallas twin does (:160-167), with int8 weights (scales
// (E, 1, F) and (E, 1, d)) or int4 nibbles packed along the contraction
// axis (scales (E, d/group, F) and (E, F/group, d)).
//
// The TPU design keeps a whole expert's panes in VMEM (w1 alone is
// 2048 x 1408 bf16 = 5.8 MB at qwen2-moe's widths); a Hopper block has
// 227 KB.  So the chain is two launches of the tile in `gemm_tile.cuh`:
// pass A, per (F tile of 64 columns, expert group): h = silu(x@w1) *
// (x@w3) with both products sharing the staged x tile; pass B, per (d tile,
// expert group): y = (h @ w2) * comb.  Each block walks its experts' rows
// in chunks of 32 and owns every contraction step of its tile, so nothing
// is reduced across blocks: no atomics, and the result does not depend on
// scheduling.  h goes through device memory (E*C*F bf16 or f32).
//
// Coarsening: a block owns `degree` experts, adjacent (consecutive:
// e = i*degree + j) or E/degree apart (gapped: e = j*(E/degree) + i), as
// the Pallas views (:73-89) do, and runs them one after the other.
//
// Bound on this card: the weight bytes of the LIVE experts (an expert
// whose combine weights are all 0 has output exactly 0; its weights are
// never read) plus x, comb and y, at 3.35 TB/s.  At qwen2-moe's widths an
// expert's three bf16 panes are 17.3 MB, so a decode step (capacity 8, at
// most 32 of 64 experts live) and a prefill chunk (capacity 128) are both
// bandwidth-bound far below the tensor-core ridge.  What the design does
// about it: dead experts and dead 16-row tiles are skipped before any
// weight byte is loaded; every live weight byte is read once (16-byte
// loads, the next step's loads in flight during the current products),
// packed weights stay packed until shared memory.
#include "gemm_tile.cuh"

namespace {

using namespace gt;

// Rows go in chunks of 32 (MT = 1): at the serving path's capacities a
// live expert holds ~8.5 rows in a prefill chunk (512 assignments over 60
// experts) and at most 8 in a decode step, so one chunk covers it and the
// dead chunks read nothing; the light blocks (64-93 registers) run several
// to an SM.  Chunks of 128 rows (MT = 4, one block per SM) measured
// 1.9x (bf16), 3.0x (int8) and 2.4x (int4) slower at capacity 128 on an
// H100 80GB HBM3 at 700 W.
constexpr int MOE_MT = 1;

template <int BKIND>
int run_chain(Params pa, Params pb, int e, int degree, cudaStream_t st) {
  constexpr bool QUANT = BKIND != B_BF16;
  int rc = launch<MOE_MT, 2, false, BKIND,
                  QUANT ? EPI_SWIGLU_F32 : EPI_SWIGLU_BF16>(pa, e / degree, st);
  if (rc != 0) return rc;
  return launch<MOE_MT, 1, QUANT, BKIND, EPI_COMB>(pb, e / degree, st);
}

int check_geometry(int e, int c, int d, int f, int degree) {
  if (e < 1 || c < 1 || degree < 1 || e % degree || d % BN || f % BN ||
      d % BK || f % BK)
    return (int)cudaErrorInvalidValue;
  return 0;
}

Params base_params(const void* x, const void* comb, void* out, int e, int c,
                   int k, int n, int degree, int gapped) {
  Params p{};
  p.a = x;
  p.comb = static_cast<const float*>(comb);
  p.out = out;
  p.rows = c;
  p.n = n;
  p.k = k;
  p.group = 1;
  p.batch = e;
  p.degree = degree;
  p.gapped = gapped;
  return p;
}

}  // namespace

// xe (E,C,d) bf16, w1/w3 (E,d,F) bf16, w2 (E,F,d) bf16, comb (E,C) f32;
// h (E,C,F) bf16 scratch; out (E,C,d) f32
extern "C" int moe_ffn_bf16(const void* xe, const void* w1, const void* w3,
                            const void* w2, const void* comb, void* h,
                            void* out, int e, int c, int d, int f, int degree,
                            int gapped, void* stream) {
  if (int rc = check_geometry(e, c, d, f, degree)) return rc;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  Params pa = base_params(xe, comb, h, e, c, d, f, degree, gapped);
  pa.w[0] = Weight{w1, nullptr, (long long)d * f, 0};
  pa.w[1] = Weight{w3, nullptr, (long long)d * f, 0};
  Params pb = base_params(h, comb, out, e, c, f, d, degree, gapped);
  pb.w[0] = Weight{w2, nullptr, (long long)f * d, 0};
  return run_chain<B_BF16>(pa, pb, e, degree, st);
}

// int8: w1q/w3q (E,d,F) int8 + scales (E,1,F); w2q (E,F,d) + (E,1,d).
// int4: w1q/w3q (E,d/2,F) uint8 + scales (E,d/group,F); w2q (E,F/2,d) +
// (E,F/group,d).  h (E,C,F) f32 scratch; out (E,C,d) f32.
extern "C" int quant_moe_ffn(const void* xe, const void* w1q, const void* w1s,
                             const void* w3q, const void* w3s,
                             const void* w2q, const void* w2s,
                             const void* comb, void* h, void* out, int e,
                             int c, int d, int f, int bits, int group,
                             int degree, int gapped, void* stream) {
  if (int rc = check_geometry(e, c, d, f, degree)) return rc;
  if (bits != 8 && bits != 4) return (int)cudaErrorInvalidValue;
  if (bits == 4 && (group < 16 || group % 16 || d % group || f % group))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const long long qd = bits == 8 ? (long long)d * f : (long long)d / 2 * f;
  const long long sd = bits == 8 ? f : (long long)(d / group) * f;
  const long long qf = bits == 8 ? (long long)f * d : (long long)f / 2 * d;
  const long long sf = bits == 8 ? d : (long long)(f / group) * d;
  Params pa = base_params(xe, comb, h, e, c, d, f, degree, gapped);
  pa.group = bits == 4 ? group : 1;
  pa.w[0] = Weight{w1q, static_cast<const float*>(w1s), qd, sd};
  pa.w[1] = Weight{w3q, static_cast<const float*>(w3s), qd, sd};
  Params pb = base_params(h, comb, out, e, c, f, d, degree, gapped);
  pb.group = pa.group;
  pb.w[0] = Weight{w2q, static_cast<const float*>(w2s), qf, sf};
  return bits == 8 ? run_chain<B_INT8>(pa, pb, e, degree, st)
                   : run_chain<B_INT4>(pa, pb, e, degree, st);
}
