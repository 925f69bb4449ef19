// Coarsened flash attention for Hopper (sm_90a): forward, dQ and dK/dV.
//
// Replaces the three Pallas kernels of `repro/kernels/flash_attention.py`:
//
//   flash_fwd  <- `make_kernel` (:119; its pl.pallas_call at :196)
//   flash_dq   <- `make_bwd_dq_kernel` (:226; pl.pallas_call at :291)
//   flash_dkv  <- `make_bwd_dkv_kernel` (:315; pl.pallas_call at :421)
//
// Layout as the Pallas kernels: q, do (B,H,Sq,D), k, v (B,Hkv,Sk,D), q/k/v
// bf16, do f32, o/dq f32 (B,H,Sq,D), m/l/delta f32 (B,H,Sq); dK/dV are
// written per q-head, (B,H,Sk,D) f32, and reduced over the GQA group by the
// caller, as the Pallas `run` does outside its call (:445-448).
//
// What the TPU grid does that a block does itself.  The Pallas grid
// (b, h, program, sweep) carries the online-softmax state (or the dQ / dK /
// dV sums) across the sweep axis in VMEM scratch.  Here one thread block
// owns one (b, h, program) and the sweep is a loop inside it; nothing
// crosses blocks, there are no atomics, and every pass is deterministic.
//
// Programs.  The forward and dQ own C q-blocks of bq rows, adjacent
// (consecutive) or Sq/C rows apart (gapped), exactly the rows of
// `_q_axis_layout` (:60).  dK/dV owns C kv-blocks of bkv rows, adjacent or
// Sk/C apart (`col_ids`, :343).  Every staged tile of the streamed operand
// (K/V for the forward and dQ, Q/dO for dK/dV) is consumed by ALL the
// program's rows before its buffer is reused: the staged tile is shared
// by the C fused blocks, which is the coarsening's point (module
// docstring of the Pallas file, :14-16).  The whole-block skip is the
// Pallas one, block for block: `_q_axis_mask_live` (:86) for the forward
// and dQ (consecutive keeps the causal triangle pruning; gapped
// degenerates to the worst row, the paper's divergence penalty, kept on
// purpose) and :371-380 for dK/dV.  Inside a live block the causal /
// window mask is exact.
//
// The forward (`flash_fwd_ws`) is warp-specialised.  A producer warp
// issues TMA copies: the program's Q once, then the K and V tiles of its
// walk (`kernels/flash_attention.py` `fwd_walk`) into a ring of 2-4 stages
// with full / empty mbarriers.  R/64 consumer warpgroups each own 64 rows
// and multiply on wgmma: S = Q K^T (m64nKTk16, both operands from shared
// memory, K-major) and O += P V (m64nDk16, P the register operand rounded
// to bf16, V MN-major); O stays in registers for the whole sweep.  A tile
// wholly inside the mask for a warpgroup's rows skips the per-element
// mask; the online softmax runs in the exp2 domain, and (m, l) are written
// in natural-log units.  Under causal masking the programs with the most
// live kv blocks launch first.  The shared Hopper helpers are
// `hopper.cuh`'s (also used by `quant_matmul.cu`).
//
// dQ and dK/dV each warp owns 16 of the program's rows, so a program of R
// rows runs R/16 warps (R <= 256; R <= 128 at head dim 256, see `valid`),
// and every warp keeps its rows' f32 sums in registers for the whole
// sweep (at D 256 the dK/dV sums are split over two blocks by head-dim
// half, see `flash_dkv_kernel`).  They stage one tile at a time through
// registers and multiply on mma.sync m16n8k16 with the warp tiles of
// `flash_tile.cuh` (shared with the block-sparse forward,
// `sparse_attention.cu`).
//
// Arithmetic.  Q, K, V are bf16 already; the softmax probabilities p, the
// f32 cotangent dO and dS are rounded to bf16 where they enter a product,
// and every sum is f32.  The Pallas kernels take those products in f32;
// the difference is one bf16 rounding of an operand, which the card
// check's tolerance states.
//
// Bound on this card, at the train path's shapes (B 4, S 1024, H 16,
// Hkv 8, D 128, causal): max(bytes / 3.35 TB/s, flops / 989 TFLOP/s), each
// input read once and each output written once; the causal work is half
// the square.  Forward: 68 MB and 17 GFLOP (0.020 ms, bytes).  dQ: reads
// q, k, v, do, m, l, delta and writes dq, 102 MB and 26 GFLOP (0.030 ms,
// bytes).  dK/dV: the same inputs and the group-summed dk, dv, 102 MB and
// 34 GFLOP (0.035 ms, operations).
// What bounds the forward now (timing variants with one part cut out, on
// an H100 SXM at 700 W): at D 128 the memory system, not the products:
// with both products cut out it still takes 0.048 of its 0.064 ms, moving
// the f32 o (34 MB), Q, and K/V tiles re-read from L2 by every program and
// by each q head of a GQA group (151 MB at base).  At D 256 the longest
// causal program (128 programs on 132 SMs) runs at ~64% of an SM's wgmma
// rate: a warpgroup's softmax overlaps only the other warpgroup's
// products.  Launching the heaviest programs first saves 4-9%.
// dQ and dK/dV still have no software pipeline, TMA or wgmma: their loads
// and products do not overlap, and they run far above their bounds.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tile.cuh"
#include "hopper.cuh"

namespace {

using namespace ft;

struct Geo {
  int h, hkv, sq, sk;              // heads, kv heads, q rows, kv rows
  int c, bq, bkv, gapped;          // coarsening degree, blocks, kind
  int causal, window;              // window 0 = none
  float scale;
};

// the per-element causal / window mask of the Pallas kernels
__device__ __forceinline__ bool allowed(int row, int col, const Geo& g) {
  return (!g.causal || col <= row) && (g.window <= 0 || col > row - g.window);
}

// global row of local row r of a program of C blocks of `blk` rows, block
// `p` of the program axis, blocks `seg` rows apart when gapped
__device__ __forceinline__ int prog_row(int r, int p, int blk, int c,
                                        int seg, int gapped) {
  return gapped ? (r / blk) * seg + p * blk + r % blk : p * c * blk + r;
}

// -- forward: warp-specialised, TMA ring, wgmma -------------------------------

// kv rows of one stage of the forward's ring (divides bkv, a multiple of
// 64): 64, or 32 where four consumer warpgroups at head dim 128 hold O (64
// registers a thread) beside the score tile in 112 registers
__host__ __device__ constexpr int fwd_kt(int d, int nwg) {
  return nwg >= 4 && d >= 128 ? 32 : 64;
}

// A forward block: NWG consumer warpgroups of 64 program rows each (wgmma's
// M) and one producer warpgroup, whose first thread issues every TMA copy
// and whose other warps only hand their registers over.  Shared memory,
// from a 1 KB aligned base: Q (D/64 column boxes of R rows x 128 bytes,
// 128-byte swizzled), the ring (STAGES x (K tile, V tile), each D/64 boxes
// of KT rows), then the mbarriers (full and empty per stage, Q's).
template <int D, int NWG>
struct Fwd {
  static constexpr int R = NWG * 64;               // program rows
  static constexpr int KT = fwd_kt(D, NWG);
  static constexpr int CB = D / 64;                // column boxes
  static constexpr int THREADS = (NWG + 1) * 128;
  static constexpr int Q_BYTES = R * D * 2;
  static constexpr int KV_BYTES = KT * D * 2;      // one K (or V) tile
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int ROOM = (227 * 1024 - Q_BYTES - 2048) / STAGE;
  static constexpr int STAGES = ROOM > 4 ? 4 : ROOM;
  static constexpr int SMEM = Q_BYTES + STAGES * STAGE + 1024
                              + 8 * (2 * STAGES + 1);
  // setmaxnreg (NWG > 1): every warp enters with ENTRY registers (what
  // __launch_bounds__ leaves of the SM's 64 K), the producer hands some
  // back and the consumers can take no more than it handed back
  static constexpr int ENTRY = 65536 / THREADS / 8 * 8;
  static constexpr int REG_C = NWG >= 4 ? 112 : 232;
  static constexpr int REG_P = NWG >= 4 ? 24 : 40;
  static_assert(STAGES >= 2, "the ring needs two stages");
  static_assert(NWG < 2 || (REG_C - ENTRY) * NWG <= ENTRY - REG_P,
                "register budgets");
};

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One block per (q-program, head, batch), R = C*bq rows.  The kv tiles a
// program walks, and each one's class per consumer warpgroup, are the rule
// of `flash_attention.py` `fwd_walk`: the live kv blocks of the Pallas
// whole-block skip (a contiguous range), each cut into bkv/KT tiles; a
// tile is *full* for a warpgroup when every (row, col) pair of its 64 rows
// is allowed (no mask is applied) and *edge* otherwise (the exact mask).
// Under causal masking the heaviest programs launch first.
template <int D, int NWG>
__global__ void __launch_bounds__(Fwd<D, NWG>::THREADS, 1)
flash_fwd_ws(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, float* __restrict__ o,
             float* __restrict__ mo, float* __restrict__ lo, const Geo g) {
  using F = Fwd<D, NWG>;
  constexpr int R = F::R, KT = F::KT, CB = F::CB, STAGES = F::STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sq = (hop::smem_u32(smem) + 1023) & ~1023u;
  const uint32_t ring = sq + F::Q_BYTES;
  const uint32_t full = ring + STAGES * F::STAGE;  // + 8 * stage
  const uint32_t empty = full + 8 * STAGES;
  const uint32_t qbar = empty + 8 * STAGES;

  // launch position -> (q program, head, batch); causal: heaviest first
  const int nprog = g.sq / R, planes = gridDim.x / nprog;
  const int pos = blockIdx.x / planes, hb = blockIdx.x % planes;
  const int hh = hb % g.h, bb = hb / g.h;
  const int qi = g.causal ? nprog - 1 - pos : pos;
  const int kvh = hh / (g.h / g.hkv);
  const int sg = g.sq / g.c;
  const auto qrow = [&](int r) {
    return prog_row(r, qi, g.bq, g.c, sg, g.gapped);
  };
  // the live kv blocks: `_q_axis_mask_live`'s test on the program's
  // extreme rows keeps a contiguous range
  const int min_row = qrow(0), max_row = qrow(R - 1);
  int k_lo = 0, k_hi = g.sk / g.bkv - 1;
  if (g.causal) k_hi = min(k_hi, max_row / g.bkv);
  if (g.window > 0 && min_row - g.window + 1 > 0)
    k_lo = (min_row - g.window + 1) / g.bkv;
  const int ntiles = max(0, k_hi - k_lo + 1) * (g.bkv / KT);
  const int c_begin = k_lo * g.bkv;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      hop::bar_init<1>(full + 8 * st);
      hop::bar_init<NWG * 4>(empty + 8 * st);   // every consumer warp
    }
    hop::bar_init<1>(qbar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NWG) {
    // -- producer: Q once, then the K and V tiles of the walk ---------------
    if constexpr (NWG > 1) hop::regs_dec<F::REG_P>();
    if (threadIdx.x == NWG * 128) {
      const int q0 = (bb * g.h + hh) * g.sq;
      hop::bar_expect(qbar, F::Q_BYTES);
      for (int j = 0; j < g.c; ++j)            // block j at rows j*bq
        for (int cb = 0; cb < CB; ++cb)
          hop::tma_2d(sq + (cb * R + j * g.bq) * 128, &tq, cb * 64,
                      q0 + qrow(j * g.bq), qbar);
      const int kv0 = (bb * g.hkv + kvh) * g.sk + c_begin;
      for (int i = 0; i < ntiles; ++i) {
        const int st = i % STAGES;
        hop::bar_wait(empty + 8 * st, ((i / STAGES) & 1) ^ 1);
        const uint32_t sk = ring + st * F::STAGE, sv = sk + F::KV_BYTES;
        hop::bar_expect(full + 8 * st, F::STAGE);
        for (int cb = 0; cb < CB; ++cb) {
          hop::tma_2d(sk + cb * KT * 128, &tk, cb * 64, kv0 + i * KT,
                      full + 8 * st);
          hop::tma_2d(sv + cb * KT * 128, &tv, cb * 64, kv0 + i * KT,
                      full + 8 * st);
        }
      }
    }
  } else {
    // -- consumers: warpgroup wg owns program rows wg*64 .. wg*64+63 -------
    if constexpr (NWG > 1) hop::regs_inc<F::REG_C>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int gq = lane >> 2, t = lane & 3;
    const int r0 = wg * 64 + warp * 16 + gq;
    const int row0 = qrow(r0), row1 = qrow(r0 + 8);
    // the warpgroup's extreme rows (prog_row increases with r)
    const int w_lo = qrow(wg * 64), w_hi = qrow(wg * 64 + 63);
    const float sl = g.scale * 1.4426950408889634f;   // scale * log2(e)

    // O (64 x D a warpgroup, 4j + e as wgmma's accumulator), and the
    // rows' running max of s * sl (log2 units) and this thread's share of
    // their sums
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;

    const uint32_t qa = sq + wg * 64 * 128;
    hop::bar_wait(qbar, 0);
    for (int i = 0; i < ntiles; ++i) {
      const int st = i % STAGES;
      const uint32_t sk = ring + st * F::STAGE, sv = sk + F::KV_BYTES;
      hop::bar_wait(full + 8 * st, (i / STAGES) & 1);

      // S = Q K^T: k16 steps 32 bytes along a 128-byte row, then the next
      // column box
      float s[KT / 2];
      hop::wg_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        hop::wgmma_ss<KT>(
            s, hop::desc(qa + (ks / 4) * R * 128 + (ks % 4) * 32),
            hop::desc(sk + (ks / 4) * KT * 128 + (ks % 4) * 32), ks > 0);
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::wg_hold(s);

      // online softmax in the exp2 domain; an edge tile's masked pairs
      // are -inf and weigh exactly 0, and a row with nothing allowed yet
      // keeps m = NEG (alpha 1, l 0)
      const int c0 = c_begin + i * KT;
      const bool whole = (!g.causal || c0 + KT - 1 <= w_lo) &&
                         (g.window <= 0 || c0 > w_hi - g.window);
      const float ninf = __int_as_float(0xff800000);
      float mx0 = m0, mx1 = m1;
      if (whole) {
#pragma unroll
        for (int j = 0; j < KT / 2; j += 4) {
          s[j] *= sl;
          s[j + 1] *= sl;
          s[j + 2] *= sl;
          s[j + 3] *= sl;
          mx0 = fmaxf(mx0, fmaxf(s[j], s[j + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[j + 2], s[j + 3]));
        }
      } else {
#pragma unroll
        for (int j = 0; j < KT / 2; j += 4)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = c0 + 2 * j + 2 * t + e;   // 8 (j / 4) + 2t + e
            s[j + e] = allowed(row0, col, g) ? s[j + e] * sl : ninf;
            s[j + 2 + e] =
                allowed(row1, col, g) ? s[j + 2 + e] * sl : ninf;
            mx0 = fmaxf(mx0, s[j + e]);
            mx1 = fmaxf(mx1, s[j + 2 + e]);
          }
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float al0 = exp2_approx(m0 - mx0), al1 = exp2_approx(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < KT / 2; j += 4)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[j + e] = exp2_approx(s[j + e] - mx0);
          s[j + 2 + e] = exp2_approx(s[j + 2 + e] - mx1);
          rs0 += s[j + e];
          rs1 += s[j + 2 + e];
        }
      l0 = l0 * al0 + rs0;
      l1 = l1 * al1 + rs1;
#pragma unroll
      for (int j = 0; j < D / 2; j += 4) {
        acc[j] *= al0;
        acc[j + 1] *= al0;
        acc[j + 2] *= al1;
        acc[j + 3] *= al1;
      }

      // O += P V: P (bf16) is the register A operand, two n8 tiles of S
      // a k16 step; V is MN-major, k16 steps 16 rows (2 KB) apart, its
      // 64-column chunks KT rows apart
      uint32_t pa[KT / 16][4];
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
      // (O and P are written before the fence, and P stays live until the
      // wait: wgmma reads its registers asynchronously)
      hop::wg_hold(acc);
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) hop::wg_hold(pa[kk]);
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
        hop::wgmma_rs<D, 1>(acc, pa[kk],
                            hop::desc_mn(sv + kk * 2048, KT * 128), 1);
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::wg_hold(acc);
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) hop::wg_hold(pa[kk]);
      if (lane == 0) hop::bar_arrive(empty + 8 * st);  // the stage is read
    }

    // epilogue: o = O / l (l == 0 -> 1, the Pallas guard) as 16-byte
    // stores: lane pairs (t, t^1) swap halves so that an even t holds four
    // columns of row0 and an odd t the same four of row1
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const float il0 = 1.f / (l0 == 0.f ? 1.f : l0);
    const float il1 = 1.f / (l1 == 0.f ? 1.f : l1);
    const size_t qoff = (size_t)(bb * g.h + hh) * g.sq;
    const bool odd = t & 1;
    float* orow = o + (qoff + (odd ? row1 : row0)) * D + 2 * (t & 2);
#pragma unroll
    for (int j = 0; j < D / 2; j += 4) {
      const float x =
          __shfl_xor_sync(0xffffffffu, odd ? acc[j] : acc[j + 2], 1);
      const float y =
          __shfl_xor_sync(0xffffffffu, odd ? acc[j + 1] : acc[j + 3], 1);
      const float4 v =
          odd ? make_float4(x * il1, y * il1, acc[j + 2] * il1,
                            acc[j + 3] * il1)
              : make_float4(acc[j] * il0, acc[j + 1] * il0, x * il0, y * il0);
      *reinterpret_cast<float4*>(orow + 2 * j) = v;
    }
    if (mo != nullptr && t == 0) {
      // natural-log units: m = max(s * scale); a row with nothing allowed
      // keeps NEG
      constexpr float LN2 = 0.6931471805599453f;
      mo[qoff + row0] = m0 == NEG ? NEG : m0 * LN2;
      mo[qoff + row1] = m1 == NEG ? NEG : m1 * LN2;
      lo[qoff + row0] = l0;
      lo[qoff + row1] = l1;
    }
  }
}

// -- dQ -----------------------------------------------------------------------

// one block per (q-program, head, batch), the forward's rows
template <int D, int NW>
__global__ void __launch_bounds__(NW * 32)
flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ m, const float* __restrict__ l,
                const float* __restrict__ delta, float* __restrict__ dq,
                Geo g) {
  constexpr int LD = D + PAD, KT = kv_tile(D, NW), R = NW * 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);          // R x LD
  bf16* sdo = sq + R * LD;                           // R x LD
  bf16* sk = sdo + R * LD;                           // KT x LD
  bf16* sv = sk + KT * LD;                           // KT x LD

  const int qi = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int kvh = hh / (g.h / g.hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3, r0 = warp * 16;
  const int sg = g.sq / g.c;
  const size_t qoff = (size_t)(bb * g.h + hh) * g.sq;
  const size_t kvoff = (size_t)(bb * g.hkv + kvh) * g.sk * D;
  const auto qrow = [&](int r) {
    return prog_row(r, qi, g.bq, g.c, sg, g.gapped);
  };
  stage_bf16<D>(sq, q + qoff * D, R, qrow);
  stage_f32<D>(sdo, dout + qoff * D, R, qrow);

  const int row0 = qrow(r0 + gr), row1 = qrow(r0 + gr + 8);
  const float mr0 = m[qoff + row0], mr1 = m[qoff + row1];
  const float lr0 = l[qoff + row0] == 0.f ? 1.f : l[qoff + row0];
  const float lr1 = l[qoff + row1] == 0.f ? 1.f : l[qoff + row1];
  const float dl0 = delta[qoff + row0], dl1 = delta[qoff + row1];
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int min_row = g.gapped ? qi * g.bq : qi * R;
  const int max_row = g.gapped ? (g.c - 1) * sg + qi * g.bq + g.bq - 1
                               : qi * R + R - 1;
  const int nk = g.sk / g.bkv;
  for (int ki = 0; ki < nk; ++ki) {
    if (g.causal && ki * g.bkv > max_row) continue;
    if (g.window > 0 && (ki + 1) * g.bkv <= min_row - g.window + 1) continue;
    for (int c0 = ki * g.bkv; c0 < (ki + 1) * g.bkv; c0 += KT) {
      __syncthreads();
      const auto krow = [&](int r) { return c0 + r; };
      stage_bf16<D>(sk, k + kvoff, KT, krow);
      stage_bf16<D>(sv, v + kvoff, KT, krow);
      __syncthreads();

      float s[KT / 8][4], dp[KT / 8][4];
      warp_xyt<D, KT>(s, sq, sk, r0);
      warp_xyt<D, KT>(dp, sdo, sv, r0);
      // p from the saved (m, l); masked entries are exactly 0, so fully
      // masked rows (m = NEG) stay 0 (the Pallas double `where`, :275-277)
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + j * 8 + 2 * t + e;
          const float p0 =
              allowed(row0, col, g) ? expf(s[j][e] * g.scale - mr0) / lr0 : 0.f;
          const float p1 = allowed(row1, col, g)
                               ? expf(s[j][2 + e] * g.scale - mr1) / lr1
                               : 0.f;
          dp[j][e] = p0 * (dp[j][e] - dl0);
          dp[j][2 + e] = p1 * (dp[j][2 + e] - dl1);
        }
      warp_py<D, KT>(acc, dp, sk);      // dq += ds . K
    }
  }

  float* d0 = dq + (qoff + row0) * D + 2 * t;
  float* d1 = dq + (qoff + row1) * D + 2 * t;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<float2*>(d0 + j * 8) =
        make_float2(acc[j][0] * g.scale, acc[j][1] * g.scale);
    *reinterpret_cast<float2*>(d1 + j * 8) =
        make_float2(acc[j][2] * g.scale, acc[j][3] * g.scale);
  }
}

// -- dK/dV --------------------------------------------------------------------

// one block per (kv-program, q-head, batch) and head-dim part; R = C*bkv kv
// rows, 16 per warp; the q sweep stages QT rows of q, do, m, l, delta at a
// time.  SPLIT = 2 (head dim 256): dK and dV of 16 rows at D 256 would
// take 256 f32 registers a thread, over the 255 cap, so two blocks share a
// program, each keeps the dK and dV columns of one half of D, and both
// form the full-D products S^T and dP^T (the price: those two of the four
// products run twice)
template <int D, int NW, int SPLIT>
__global__ void __launch_bounds__(NW * 32)
flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ m, const float* __restrict__ l,
                 const float* __restrict__ delta, float* __restrict__ dkh,
                 float* __restrict__ dvh, Geo g) {
  constexpr int LD = D + PAD, QT = 32, R = NW * 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);          // R x LD
  bf16* sv = sk + R * LD;                            // R x LD
  bf16* sq = sv + R * LD;                            // QT x LD
  bf16* sdo = sq + QT * LD;                          // QT x LD
  float* sm = reinterpret_cast<float*>(sdo + QT * LD);
  float* sl = sm + QT;
  float* sdl = sl + QT;

  constexpr int DO = D / SPLIT;                      // output columns
  const int ki = blockIdx.x / SPLIT, c_out = (blockIdx.x % SPLIT) * DO;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int kvh = hh / (g.h / g.hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3, r0 = warp * 16;
  const int skg = g.sk / g.c;
  const size_t qoff = (size_t)(bb * g.h + hh) * g.sq;
  const size_t kvoff = (size_t)(bb * g.hkv + kvh) * g.sk * D;
  const auto kcol = [&](int r) {
    return prog_row(r, ki, g.bkv, g.c, skg, g.gapped);
  };
  stage_bf16<D>(sk, k + kvoff, R, kcol);
  stage_bf16<D>(sv, v + kvoff, R, kcol);

  const int col0 = kcol(r0 + gr), col1 = kcol(r0 + gr + 8);
  float dk[DO / 8][4], dv[DO / 8][4];
#pragma unroll
  for (int j = 0; j < DO / 8; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
  }

  // whole-block skip of :371-380: q blocks wholly before every fused kv
  // row (causal) or wholly past every fused row's window
  const int min_col = g.gapped ? ki * g.bkv : ki * R;
  const int max_col = g.gapped ? (g.c - 1) * skg + ki * g.bkv + g.bkv - 1
                               : ki * R + R - 1;
  const int nq = g.sq / g.bq;
  for (int qb = 0; qb < nq; ++qb) {
    if (g.causal && min_col > qb * g.bq + g.bq - 1) continue;
    if (g.window > 0 && max_col <= qb * g.bq - g.window) continue;
    for (int q0 = qb * g.bq; q0 < (qb + 1) * g.bq; q0 += QT) {
      __syncthreads();
      const auto qrow = [&](int r) { return q0 + r; };
      stage_bf16<D>(sq, q + qoff * D, QT, qrow);
      stage_f32<D>(sdo, dout + qoff * D, QT, qrow);
      for (int i = threadIdx.x; i < QT; i += blockDim.x) {
        const float li = l[qoff + q0 + i];
        sm[i] = m[qoff + q0 + i];
        sl[i] = li == 0.f ? 1.f : li;
        sdl[i] = delta[qoff + q0 + i];
      }
      __syncthreads();

      // transposed products: rows are this warp's kv rows, columns q rows
      float s[QT / 8][4], dp[QT / 8][4];
      warp_xyt<D, QT>(s, sk, sq, r0);   // S^T = K . Q^T
      warp_xyt<D, QT>(dp, sv, sdo, r0); // dP^T = V . dO^T
#pragma unroll
      for (int j = 0; j < QT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qr = j * 8 + 2 * t + e, row = q0 + qr;
          const float p0 = allowed(row, col0, g)
                               ? expf(s[j][e] * g.scale - sm[qr]) / sl[qr]
                               : 0.f;
          const float p1 = allowed(row, col1, g)
                               ? expf(s[j][2 + e] * g.scale - sm[qr]) / sl[qr]
                               : 0.f;
          s[j][e] = p0;
          s[j][2 + e] = p1;
          dp[j][e] = p0 * (dp[j][e] - sdl[qr]);
          dp[j][2 + e] = p1 * (dp[j][2 + e] - sdl[qr]);
        }
      warp_py<D, QT, DO>(dv, s, sdo + c_out);   // dV += P^T . dO
      warp_py<D, QT, DO>(dk, dp, sq + c_out);   // dK += dS^T . Q
    }
  }

  const size_t koff = (size_t)(bb * g.h + hh) * g.sk;   // per-q-head rows
  float* k0 = dkh + (koff + col0) * D + c_out + 2 * t;
  float* k1 = dkh + (koff + col1) * D + c_out + 2 * t;
  float* v0 = dvh + (koff + col0) * D + c_out + 2 * t;
  float* v1 = dvh + (koff + col1) * D + c_out + 2 * t;
#pragma unroll
  for (int j = 0; j < DO / 8; ++j) {
    *reinterpret_cast<float2*>(k0 + j * 8) =
        make_float2(dk[j][0] * g.scale, dk[j][1] * g.scale);
    *reinterpret_cast<float2*>(k1 + j * 8) =
        make_float2(dk[j][2] * g.scale, dk[j][3] * g.scale);
    *reinterpret_cast<float2*>(v0 + j * 8) = make_float2(dv[j][0], dv[j][1]);
    *reinterpret_cast<float2*>(v1 + j * 8) = make_float2(dv[j][2], dv[j][3]);
  }
}

// -- launchers ----------------------------------------------------------------

constexpr int dq_smem(int d, int nw) {
  return (2 * nw * 16 + 2 * kv_tile(d, nw)) * (d + PAD) * 2;
}
constexpr int dkv_smem(int d, int nw) {
  return (2 * nw * 16 + 2 * 32) * (d + PAD) * 2 + 3 * 32 * 4;
}

// the tensor maps of q (boxes of 64 columns x bq rows) and k, v (64 x KT),
// each a 2-D view of (rows of every batch and head, D), 128-byte swizzled
template <int D, int NWG>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* mo, void* lo, int b, const Geo& g, cudaStream_t st) {
  using F = Fwd<D, NWG>;
  constexpr auto BF = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr auto SW = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap tq, tk, tv;
  int rc = hop::make_map(&tq, BF, q, D, (uint64_t)b * g.h * g.sq, D * 2, 64,
                         g.bq, SW);
  if (rc == 0)
    rc = hop::make_map(&tk, BF, k, D, (uint64_t)b * g.hkv * g.sk, D * 2, 64,
                       F::KT, SW);
  if (rc == 0)
    rc = hop::make_map(&tv, BF, v, D, (uint64_t)b * g.hkv * g.sk, D * 2, 64,
                       F::KT, SW);
  if (rc != 0) return rc;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_ws<D, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      F::SMEM);
  if (e != cudaSuccess) return (int)e;
  // one-dimensional: launch position major, then (head, batch)
  flash_fwd_ws<D, NWG><<<(g.sq / F::R) * g.h * b, F::THREADS, F::SMEM, st>>>(
      tq, tk, tv, static_cast<float*>(o), static_cast<float*>(mo),
      static_cast<float*>(lo), g);
  return (int)cudaGetLastError();
}

template <int D, int NW>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* m, const void* l, const void* delta, void* dq,
              int b, const Geo& g, cudaStream_t st) {
  const int smem = dq_smem(D, NW);
  cudaFuncSetAttribute(flash_dq_kernel<D, NW>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid(g.sq / (g.c * g.bq), g.h, b);
  flash_dq_kernel<D, NW><<<grid, NW * 32, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(delta), static_cast<float*>(dq), g);
  return (int)cudaGetLastError();
}

template <int D, int NW>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* m, const void* l, const void* delta, void* dkh,
               void* dvh, int b, const Geo& g, cudaStream_t st) {
  constexpr int SPLIT = D >= 256 ? 2 : 1;
  const int smem = dkv_smem(D, NW);
  cudaFuncSetAttribute(flash_dkv_kernel<D, NW, SPLIT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid(g.sk / (g.c * g.bkv) * SPLIT, g.h, b);
  flash_dkv_kernel<D, NW, SPLIT><<<grid, NW * 32, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(delta), static_cast<float*>(dkh),
      static_cast<float*>(dvh), g);
  return (int)cudaGetLastError();
}

// the geometry the kernels take; the wrapper raises on anything else.
// q-axis programs (forward, dQ): C*bq rows, kv sub-tiles of up to 64 rows;
// kv-axis programs (dK/dV): C*bkv rows, q sub-tiles of 32 rows.  Head dim
// 256 holds programs of 64 and 128 rows only: at 256 rows dQ's shared
// memory ((512 + 64) x 264 x 2 bytes) passes the 227 KB a block may have,
// and 16 warps leave 128 registers a thread for a 128-register sum
bool valid(int d, int b, const Geo& g, bool kv_axis) {
  const int rows = g.c * (kv_axis ? g.bkv : g.bq);
  return (d == 64 || d == 128 || d == 256)
         && (rows == 64 || rows == 128 || (rows == 256 && d < 256))
         && b > 0 && g.hkv > 0 && g.h % g.hkv == 0 && g.c > 0
         && g.bq % 32 == 0 && g.bkv % (kv_axis ? 16 : 64) == 0
         && g.sq % g.bq == 0 && g.sk % g.bkv == 0
         && (kv_axis ? g.sk % (g.c * g.bkv) : g.sq % (g.c * g.bq)) == 0
         && (!(g.causal || g.window > 0) || g.sq == g.sk);
}

Geo make_geo(int h, int hkv, int sq, int sk, int c, int bq, int bkv,
             int gapped, int causal, int window, float scale) {
  return Geo{h, hkv, sq, sk, c, bq, bkv, gapped, causal, window, scale};
}

}  // namespace

// one instantiation per head dim and warp count (16 program rows a warp)
#define FLASH_DISPATCH(ROWS, D, FN)                                          \
  switch ((D) * 1000 + (ROWS)) {                                             \
    case 64064: return FN(64, 4);                                            \
    case 64128: return FN(64, 8);                                            \
    case 64256: return FN(64, 16);                                           \
    case 128064: return FN(128, 4);                                          \
    case 128128: return FN(128, 8);                                          \
    case 128256: return FN(128, 16);                                         \
    case 256064: return FN(256, 4);                                          \
    case 256128: return FN(256, 8);                                          \
    default: return (int)cudaErrorInvalidValue;                              \
  }

// o (B,H,Sq,D) f32; mo, lo (B,H,Sq) f32 or both null (no residuals)
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* mo, void* lo, int b, int h,
                              int hkv, int sq, int sk, int d, int c, int bq,
                              int bkv, int gapped, int causal, int window,
                              float scale, void* stream) {
  const Geo g = make_geo(h, hkv, sq, sk, c, bq, bkv, gapped, causal, window,
                         scale);
  if (!valid(d, b, g, false) || (mo == nullptr) != (lo == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (d * 1000 + c * bq) {        // 64 program rows a warpgroup
    case 64064: return launch_fwd<64, 1>(q, k, v, o, mo, lo, b, g, st);
    case 64128: return launch_fwd<64, 2>(q, k, v, o, mo, lo, b, g, st);
    case 64256: return launch_fwd<64, 4>(q, k, v, o, mo, lo, b, g, st);
    case 128064: return launch_fwd<128, 1>(q, k, v, o, mo, lo, b, g, st);
    case 128128: return launch_fwd<128, 2>(q, k, v, o, mo, lo, b, g, st);
    case 128256: return launch_fwd<128, 4>(q, k, v, o, mo, lo, b, g, st);
    case 256064: return launch_fwd<256, 1>(q, k, v, o, mo, lo, b, g, st);
    case 256128: return launch_fwd<256, 2>(q, k, v, o, mo, lo, b, g, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dq (B,H,Sq,D) f32 from do (B,H,Sq,D) f32 and the residuals
extern "C" int flash_dq_bf16(const void* q, const void* k, const void* v,
                             const void* dout, const void* m, const void* l,
                             const void* delta, void* dq, int b, int h,
                             int hkv, int sq, int sk, int d, int c, int bq,
                             int bkv, int gapped, int causal, int window,
                             float scale, void* stream) {
  const Geo g = make_geo(h, hkv, sq, sk, c, bq, bkv, gapped, causal, window,
                         scale);
  if (!valid(d, b, g, false)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define CALL(D_, NW_) \
  launch_dq<D_, NW_>(q, k, v, dout, m, l, delta, dq, b, g, st)
  FLASH_DISPATCH(c * bq, d, CALL)
#undef CALL
}

// per-q-head dk, dv (B,H,Sk,D) f32 (the caller reduces the GQA group)
extern "C" int flash_dkv_bf16(const void* q, const void* k, const void* v,
                              const void* dout, const void* m, const void* l,
                              const void* delta, void* dkh, void* dvh, int b,
                              int h, int hkv, int sq, int sk, int d, int c,
                              int bq, int bkv, int gapped, int causal,
                              int window, float scale, void* stream) {
  const Geo g = make_geo(h, hkv, sq, sk, c, bq, bkv, gapped, causal, window,
                         scale);
  if (!valid(d, b, g, true)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define CALL(D_, NW_) \
  launch_dkv<D_, NW_>(q, k, v, dout, m, l, delta, dkh, dvh, b, g, st)
  FLASH_DISPATCH(c * bkv, d, CALL)
#undef CALL
}
