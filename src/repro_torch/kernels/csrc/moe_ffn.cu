// Grouped-expert MoE FFN for Hopper (sm_90a), bf16.
//
// Replaces the Pallas kernel `repro/kernels/moe_ffn.py` `make_kernel` (:35;
// its pl.pallas_call at :90); its dequant-fused twin `make_qkernel` (:110)
// is `quant_moe_ffn.cu`.
//
// What it computes, per expert e of the padded dispatch buffer:
//   y[e] = ((silu(x[e] @ w1[e]) * (x[e] @ w3[e])) @ w2[e]) * comb[e][:, None]
// with x (E, C, d) bf16, w1 / w3 (E, d, F), w2 (E, F, d), comb (E, C) f32
// and y (E, C, d) f32.  The (C, F) intermediate h is rounded to bf16 once,
// as `moe_ffn.py:62` does.
//
// The TPU design keeps a whole expert's panes in VMEM (w1 alone is
// 2048 x 1408 bf16 = 5.8 MB at qwen2-moe's widths); a Hopper block has
// 227 KB.  So the chain is two launches of the tile in `gemm_tile.cuh`:
// pass A, per (F tile of 64 columns, expert group): h = silu(x@w1) *
// (x@w3) with both products sharing the staged x tile; pass B, per (d tile,
// expert group): y = (h @ w2) * comb.  Each block walks its experts' rows
// in chunks of 32 and owns every contraction step of its tile, so nothing
// is reduced across blocks: no atomics, and the result does not depend on
// scheduling.  h goes through device memory (E*C*F bf16).
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
// loads, the next step's loads in flight during the current products).
#include "gemm_tile.cuh"

namespace {

using namespace gt;

// Rows go in chunks of 32 (MT = 1): at the serving path's capacities a
// live expert holds ~8.5 rows in a prefill chunk (512 assignments over 60
// experts) and at most 8 in a decode step, so one chunk covers it and the
// dead chunks read nothing; the light blocks (64-93 registers) run several
// to an SM.  Chunks of 128 rows (MT = 4, one block per SM) measured 1.9x
// slower at capacity 128 on an H100 80GB HBM3 at 700 W.
constexpr int MOE_MT = 1;

int run_chain(Params pa, Params pb, int e, int degree, cudaStream_t st) {
  int rc = launch<MOE_MT, 2, EPI_SWIGLU>(pa, e / degree, st);
  if (rc != 0) return rc;
  return launch<MOE_MT, 1, EPI_COMB>(pb, e / degree, st);
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
  pa.w[0] = Weight{w1, (long long)d * f};
  pa.w[1] = Weight{w3, (long long)d * f};
  Params pb = base_params(h, comb, out, e, c, f, d, degree, gapped);
  pb.w[0] = Weight{w2, (long long)f * d};
  return run_chain(pa, pb, e, degree, st);
}
