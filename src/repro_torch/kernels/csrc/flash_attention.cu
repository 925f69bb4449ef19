// Coarsened flash attention for Hopper (sm_90a): forward, dQ and dK/dV,
// and the backward's preprocessing pass.
//
// Replaces the three Pallas kernels of `repro/kernels/flash_attention.py`:
//
//   flash_fwd  <- `make_kernel` (:119; its pl.pallas_call at :196)
//   flash_dq   <- `make_bwd_dq_kernel` (:226; pl.pallas_call at :291)
//   flash_dkv  <- `make_bwd_dkv_kernel` (:315; pl.pallas_call at :421)
//
// and computes what the reference computes outside them:
//
//   flash_prep <- delta = sum(g * o) (`repro/kernels/ops.py:235`), with the
//                 f32 cotangent g rounded once to the bf16 dO both backward
//                 kernels read
//
// Layout as the Pallas kernels: q, do (B,H,Sq,D), k, v (B,Hkv,Sk,D), q/k/v
// and do bf16, o/dq f32 (B,H,Sq,D), m/l/delta f32 (B,H,Sq); dK/dV f32
// (B,Hkv,Sk,D), summed over each GQA group inside the kernel (the Pallas
// `run` sums outside its call, :445-448).
//
// What the TPU grid does that a block does itself.  The Pallas grid
// (b, h, program, sweep) carries the online-softmax state (or the dQ / dK /
// dV sums) across the sweep axis in VMEM scratch.  Here one thread block
// owns one (b, h, program) (or one part of a program, below) and the sweep
// is a loop inside it; no atomics, and every pass is deterministic.
//
// Programs.  The forward and dQ own C q-blocks of bq rows, adjacent
// (consecutive) or Sq/C rows apart (gapped), exactly the rows of
// `_q_axis_layout` (:60).  dK/dV owns C kv-blocks of bkv rows, adjacent or
// Sk/C apart (`col_ids`, :343).  Every staged tile of the streamed operand
// (K/V for the forward and dQ, Q/dO for dK/dV) is consumed by all the
// block's rows before its buffer is reused: the staged tile is shared by
// the C fused blocks, which is the coarsening's point (module docstring of
// the Pallas file, :14-16).  The whole-block skip is the Pallas one, block
// for block: `_q_axis_mask_live` (:86) for the forward and dQ (consecutive
// keeps the causal triangle pruning; gapped degenerates to the worst row,
// the paper's divergence penalty, kept on purpose) and :371-380 for dK/dV.
// Inside a live block the causal / window mask is exact; a tile wholly
// inside the mask for a warpgroup's rows skips the per-element test.  The
// walks are stated in Python beside the wrappers
// (`kernels/flash_attention.py` `fwd_walk`, `dkv_walk`).
//
// All three passes are warp-specialised.  A producer warp issues TMA
// copies into a ring of stages with full / empty mbarriers; consumer
// warpgroups of 64 rows (wgmma's M) multiply on wgmma and keep their sums
// in registers for the whole sweep (`setmaxnreg` moves registers from the
// producer warpgroup to them).  The shared Hopper helpers are
// `hopper.cuh`'s (also used by `quant_matmul.cu`).
//
// * Forward (`flash_fwd_ws`): Q once, then the K and V tiles of the walk;
//   S = Q K^T (both operands from shared memory, K-major) and O += P V (P
//   the register operand, V MN-major); the online softmax runs in the exp2
//   domain, and (m, l) are written in natural-log units.
// * dQ (`flash_dq_ws`), the forward's skeleton: Q and dO once, then the
//   K/V tiles of the same walk; S = Q K^T and dP = dO V^T (SS), p from the
//   saved (m, l) as exp2(s scale log2 e - m log2 e - log2 l), dS = p (dP -
//   delta) rounded to bf16 in registers, dQ += dS K (RS, K MN-major).
// * dK/dV (`flash_dkv_ws`), its mirror: K and V of the block's kv rows once,
//   then Q, dO and the rows' m, l, delta (a 1-D bulk copy each) tile by
//   tile; S^T = K Q^T and dP^T = V dO^T (SS), dV += P^T dO and dK += dS^T Q
//   (P^T, dS^T the register operand, dO and Q MN-major).  At head dim 256
//   the dK and dV sums of 64 rows would take 256 registers a thread: two
//   warpgroups share the block's 64 kv rows, each forms S^T / dP^T for
//   half of the tile's q rows, they exchange P^T and dS^T as bf16 through
//   shared memory behind a named barrier, and each sums dK and dV for one
//   half of D over the whole tile (SS).  The q heads of one GQA group are
//   one thread-block cluster: after the sweep each block leaves its
//   partials in its shared memory (the ring's), and rank r sums its share
//   of the rows over the cluster's blocks in rank order through
//   distributed shared memory and writes them once.  A cluster holds up to
//   16 blocks: for a group of more, it takes the largest divisor of the
//   group up to 16 and the wrapper sums the group's clusters.
// * Programs taller than a block's registers allow run as consecutive
//   blocks of the same program, each walking the whole program's live
//   range (so the whole-block skip is the program's): dQ programs of 256
//   rows as two blocks of 128, dK/dV programs of 256 rows (D <= 128) as
//   two of 128, and of 128 rows at D 256 as two of 64.  Those blocks load
//   the streamed tiles separately; no multicast.
//
// Arithmetic.  Q, K, V are bf16 already; the cotangent is rounded to bf16
// once (by flash_prep), the probabilities p and dS are rounded to bf16
// where they enter a product, and every sum is f32.  The Pallas kernels
// take those products in f32; the difference is one bf16 rounding of an
// operand, which the card check's tolerance states.
//
// Bound on this card, at the train path's shapes (B 4, S 1024, H 16,
// Hkv 8, D 128, causal): max(bytes / 3.35 TB/s, flops / 989 TFLOP/s), each
// input read once and each output written once; the causal work is half
// the square.  Forward: 68 MB and 17 GFLOP (0.020 ms, bytes).  Prep:
// reads the f32 cotangent and o and writes bf16 dO and delta, 84 MB
// (0.025 ms, bytes).  dQ: reads q, k, v, prep's bf16 dO, m, l, delta and
// writes dq, 85 MB and 26 GFLOP (0.026 ms, operations).  dK/dV: the same
// inputs and the group-summed dk, dv, 85 MB and 34 GFLOP (0.035 ms,
// operations).  The design keeps the backward near those bounds by moving
// no byte through device memory that it need not: dO is read as bf16
// (half the f32 bytes) and by TMA, each block loads its resident operand
// once and streams the other through the ring while the tensor cores work
// on the stage before, and the GQA partials never leave the chip.  What
// still costs above them (chip_smoke.py on an H100 SXM at 700 W: dQ
// about 3x and dK/dV about 4x their bounds at D 128; PERF.md has the
// times): at D 128 the data movement, as timing copies of the source
// with parts cut out showed: the streamed tiles are re-read from L2 by
// every program and by each q head of a group; at D 256 the products.
// Issuing the next tile's products behind the current tile's last ones,
// before waiting, made both kernels slower and was not kept.
// What bounds the forward (timing variants with one part cut out, on an
// H100 SXM at 700 W): at D 128 the memory system, not the products: with
// both products cut out it still takes 0.048 of its 0.064 ms, moving the
// f32 o (34 MB), Q, and K/V tiles re-read from L2 by every program and by
// each q head of a GQA group (151 MB at base).  At D 256 the longest causal
// program (128 programs on 132 SMs) runs at ~64% of an SM's wgmma rate: a
// warpgroup's softmax overlaps only the other warpgroup's products.
// Launching the heaviest programs first saves 4-9%.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr float NEG = -1e30f;                 // the Pallas mask sentinel
constexpr float LOG2E = 1.4426950408889634f;

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// a row's residuals (m in natural-log units, l) -> m log2 e + log2 l, so
// that the backward's p = exp(s scale - m) / l is exp2(s scale log2 e -
// that); l == 0 counts as 1 (the Pallas guard)
__device__ __forceinline__ float log2_norm(float m, float l) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(l == 0.f ? 1.f : l));
  return m * LOG2E + y;
}

// every cluster block arrives, then waits (orders shared-memory accesses
// across the cluster: release / acquire)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
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
    const float sl = g.scale * LOG2E;                 // scale * log2(e)

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

// -- dQ: the forward's skeleton -----------------------------------------------

// kv rows of one stage of dQ's ring (divides bkv, a multiple of 64): 64, or
// 32 at head dim 256, where the dQ sum takes 128 registers a thread beside
// S and dP
__host__ __device__ constexpr int dq_kt(int d) { return d >= 256 ? 32 : 64; }

// A dQ block: NWG consumer warpgroups of 64 rows and one producer
// warpgroup.  Shared memory from a 1 KB aligned base: Q and dO (D/64
// column boxes of R rows x 128 bytes each, 128-byte swizzled), the ring
// (STAGES x (K tile, V tile) of KT rows), the mbarriers.
template <int D, int NWG>
struct Dq {
  static constexpr int R = NWG * 64;               // rows of a block
  static constexpr int KT = dq_kt(D);
  static constexpr int CB = D / 64;                // column boxes
  static constexpr int THREADS = (NWG + 1) * 128;
  static constexpr int Q_BYTES = R * D * 2;        // Q, and dO
  static constexpr int KV_BYTES = KT * D * 2;      // one K (or V) tile
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int ROOM = (227 * 1024 - 2 * Q_BYTES - 2048) / STAGE;
  static constexpr int STAGES = ROOM > 4 ? 4 : ROOM;
  static constexpr int SMEM = 2 * Q_BYTES + STAGES * STAGE + 1024
                              + 8 * (2 * STAGES + 1);
  static constexpr int ENTRY = 65536 / THREADS / 8 * 8;
  static constexpr int REG_C = 232, REG_P = 40;
  static_assert(STAGES >= 2, "the ring needs two stages");
  static_assert(NWG < 2 || (REG_C - ENTRY) * NWG <= ENTRY - REG_P,
                "register budgets");
};

// One block per (q program, part, head, batch): a program of C*bq rows runs
// as (C*bq)/R consecutive blocks, each walking the whole program's kv tiles
// (`fwd_walk` with KT-row tiles), heaviest programs first under causal
// masking, as the forward.
template <int D, int NWG>
__global__ void __launch_bounds__(Dq<D, NWG>::THREADS, 1)
flash_dq_ws(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tdo,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const float* __restrict__ m, const float* __restrict__ l,
            const float* __restrict__ delta, float* __restrict__ dq,
            const Geo g) {
  using F = Dq<D, NWG>;
  constexpr int R = F::R, KT = F::KT, CB = F::CB, STAGES = F::STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sq = (hop::smem_u32(smem) + 1023) & ~1023u;
  const uint32_t sdo = sq + F::Q_BYTES;
  const uint32_t ring = sdo + F::Q_BYTES;
  const uint32_t full = ring + STAGES * F::STAGE;  // + 8 * stage
  const uint32_t empty = full + 8 * STAGES;
  const uint32_t qbar = empty + 8 * STAGES;

  // launch position -> (q program, part, head, batch)
  const int rp = g.c * g.bq;                       // rows of a program
  const int nprog = g.sq / rp, parts = rp / R;
  const int planes = gridDim.x / (nprog * parts);
  const int unit = blockIdx.x / planes, hb = blockIdx.x % planes;
  const int pos = unit / parts, r_base = (unit % parts) * R;
  const int hh = hb % g.h, bb = hb / g.h;
  const int qi = g.causal ? nprog - 1 - pos : pos;
  const int kvh = hh / (g.h / g.hkv);
  const int sg = g.sq / g.c;
  const auto qrow = [&](int r) {                   // r: a program row
    return prog_row(r, qi, g.bq, g.c, sg, g.gapped);
  };
  // the program's live kv blocks: a contiguous range, as the forward
  const int min_row = qrow(0), max_row = qrow(rp - 1);
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
    // -- producer: Q and dO once, then the K and V tiles of the walk --------
    if constexpr (NWG > 1) hop::regs_dec<F::REG_P>();
    if (threadIdx.x == NWG * 128) {
      const int q0 = (bb * g.h + hh) * g.sq;
      const int br = min(g.bq, 64);              // rows of a Q / dO box
      hop::bar_expect(qbar, 2 * F::Q_BYTES);
      for (int r = 0; r < R; r += br)
        for (int cb = 0; cb < CB; ++cb) {
          const int row = q0 + qrow(r_base + r);
          hop::tma_2d(sq + (cb * R + r) * 128, &tq, cb * 64, row, qbar);
          hop::tma_2d(sdo + (cb * R + r) * 128, &tdo, cb * 64, row, qbar);
        }
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
    // -- consumers: warpgroup wg owns block rows wg*64 .. wg*64+63 ---------
    if constexpr (NWG > 1) hop::regs_inc<F::REG_C>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int gq = lane >> 2, t = lane & 3;
    const int r0 = r_base + wg * 64 + warp * 16 + gq;
    const int row0 = qrow(r0), row1 = qrow(r0 + 8);
    // the warpgroup's extreme rows (prog_row increases with r)
    const int w_lo = qrow(r_base + wg * 64), w_hi = qrow(r_base + wg * 64 + 63);
    const float sl = g.scale * LOG2E;
    const size_t qoff = (size_t)(bb * g.h + hh) * g.sq;
    const float ml0 = log2_norm(m[qoff + row0], l[qoff + row0]);
    const float ml1 = log2_norm(m[qoff + row1], l[qoff + row1]);
    const float dl0 = delta[qoff + row0], dl1 = delta[qoff + row1];

    // dQ (64 x D a warpgroup, 4j + e as wgmma's accumulator)
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    const uint32_t qa = sq + wg * 64 * 128, oa = sdo + wg * 64 * 128;
    hop::bar_wait(qbar, 0);
    for (int i = 0; i < ntiles; ++i) {
      const int st = i % STAGES;
      const uint32_t sk = ring + st * F::STAGE, sv = sk + F::KV_BYTES;
      hop::bar_wait(full + 8 * st, (i / STAGES) & 1);

      // S = Q K^T and dP = dO V^T: k16 steps 32 bytes along a 128-byte
      // row, then the next column box
      float s[KT / 2], dp[KT / 2];
      hop::wg_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        hop::wgmma_ss<KT>(
            s, hop::desc(qa + (ks / 4) * R * 128 + (ks % 4) * 32),
            hop::desc(sk + (ks / 4) * KT * 128 + (ks % 4) * 32), ks > 0);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        hop::wgmma_ss<KT>(
            dp, hop::desc(oa + (ks / 4) * R * 128 + (ks % 4) * 32),
            hop::desc(sv + (ks / 4) * KT * 128 + (ks % 4) * 32), ks > 0);
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::wg_hold(s);
      hop::wg_hold(dp);

      // dS = p (dP - delta), p from the saved (m, l); on an edge tile the
      // masked pairs weigh exactly 0 (so do fully masked rows, m = NEG)
      const int c0 = c_begin + i * KT;
      const bool whole = (!g.causal || c0 + KT - 1 <= w_lo) &&
                         (g.window <= 0 || c0 > w_hi - g.window);
#pragma unroll
      for (int j = 0; j < KT / 2; j += 4)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p0 = exp2_approx(s[j + e] * sl - ml0);
          float p1 = exp2_approx(s[j + 2 + e] * sl - ml1);
          if (!whole) {
            const int col = c0 + 2 * j + 2 * t + e;   // 8 (j / 4) + 2t + e
            p0 = allowed(row0, col, g) ? p0 : 0.f;
            p1 = allowed(row1, col, g) ? p1 : 0.f;
          }
          dp[j + e] = p0 * (dp[j + e] - dl0);
          dp[j + 2 + e] = p1 * (dp[j + 2 + e] - dl1);
        }

      // dQ += dS K: dS (bf16) is the register A operand, two n8 tiles a
      // k16 step; K is MN-major, k16 steps 16 rows (2 KB) apart, its
      // 64-column chunks KT rows apart
      uint32_t da[KT / 16][4];
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        da[kk][0] = pack_bf16(dp[8 * kk], dp[8 * kk + 1]);
        da[kk][1] = pack_bf16(dp[8 * kk + 2], dp[8 * kk + 3]);
        da[kk][2] = pack_bf16(dp[8 * kk + 4], dp[8 * kk + 5]);
        da[kk][3] = pack_bf16(dp[8 * kk + 6], dp[8 * kk + 7]);
      }
      hop::wg_hold(acc);
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) hop::wg_hold(da[kk]);
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
        hop::wgmma_rs<D, 1>(acc, da[kk],
                            hop::desc_mn(sk + kk * 2048, KT * 128), 1);
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::wg_hold(acc);
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) hop::wg_hold(da[kk]);
      if (lane == 0) hop::bar_arrive(empty + 8 * st);  // the stage is read
    }

    // epilogue: dq = dQ * scale as 16-byte stores (lane pairs swap halves,
    // as the forward's epilogue)
    const bool odd = t & 1;
    float* orow = dq + (qoff + (odd ? row1 : row0)) * D + 2 * (t & 2);
#pragma unroll
    for (int j = 0; j < D / 2; j += 4) {
      const float x =
          __shfl_xor_sync(0xffffffffu, odd ? acc[j] : acc[j + 2], 1);
      const float y =
          __shfl_xor_sync(0xffffffffu, odd ? acc[j + 1] : acc[j + 3], 1);
      const float sc = g.scale;
      const float4 v =
          odd ? make_float4(x * sc, y * sc, acc[j + 2] * sc, acc[j + 3] * sc)
              : make_float4(acc[j] * sc, acc[j + 1] * sc, x * sc, y * sc);
      *reinterpret_cast<float4*>(orow + 2 * j) = v;
    }
  }
}

// -- dK/dV: the mirror, GQA partials summed in a cluster ----------------------

// q rows of one stage of dK/dV's ring: 64 where the q blocks tile by 64,
// else 32 (a stage never straddles a live and a dead q block)
__host__ __device__ constexpr int dkv_qt(int bq) { return bq % 64 ? 32 : 64; }

// A dK/dV block.  At D <= 128, NWG consumer warpgroups each own 64 kv rows
// and all of D; at D 256 two warpgroups share 64 kv rows, each with half
// of D (SPLIT).  Shared memory from a 1 KB aligned base: K and V of the
// block's RB rows (D/64 column boxes of RB rows x 128 bytes), at D 256
// the P^T and dS^T exchange tiles (64 rows x 128 bytes, 128-byte swizzled,
// K-major), the ring (STAGES x (Q tile, dO tile of QT rows, then m, l,
// delta of those rows)), the mbarriers.  After the sweep the same memory
// holds the block's dK and dV partials (RB rows of D f32, padded) for the
// cluster's sum.
template <int D, int NWG, int QT>
struct Dkv {
  static constexpr bool SPLIT = D > 128;
  static constexpr int NCW = SPLIT ? 2 : NWG;        // consumer warpgroups
  static constexpr int RB = SPLIT ? 64 : 64 * NWG;   // kv rows of a block
  static constexpr int DC = SPLIT ? D / 2 : D;       // dK, dV columns a wg
  static constexpr int QC = SPLIT ? QT / 2 : QT;     // S^T columns a wg
  static constexpr int CB = D / 64;
  static constexpr int THREADS = (NCW + 1) * 128;
  static constexpr int KV_BYTES = RB * D * 2;        // K, and V
  static constexpr int T_BYTES = QT * D * 2;         // a Q (or dO) tile
  static constexpr int STAGE = 2 * T_BYTES + 1024;   // + m, l, delta
  static constexpr int X_BYTES = SPLIT ? 64 * 128 : 0;   // P^T, and dS^T
  static constexpr int FIXED = 2 * KV_BYTES + 2 * X_BYTES;
  static constexpr int ROOM = (227 * 1024 - FIXED - 2048) / STAGE;
  static constexpr int STAGES = ROOM > 4 ? 4 : ROOM;
  static constexpr int LDR = D + 4;                  // floats a partial row
  static constexpr int RED = 2 * RB * LDR * 4;       // dK and dV partials
  static constexpr int MAIN = FIXED + STAGES * STAGE;
  static constexpr int BODY = MAIN > RED ? MAIN : RED;
  static constexpr int SMEM = BODY + 1024 + 8 * (2 * STAGES + 1);
  static constexpr int ENTRY = 65536 / THREADS / 8 * 8;
  // at D 256 the producer issues 2 D/64 + 3 copies a stage: 40 registers
  // spill there, and the consumers need less than 232
  static constexpr int REG_C = SPLIT ? 224 : 232, REG_P = SPLIT ? 56 : 40;
  static_assert(STAGES >= 2, "the ring needs two stages");
  static_assert(SMEM <= 227 * 1024, "shared memory");
  static_assert(3 * QT * 4 <= 1024, "a stage's m, l, delta");
  static_assert(NCW < 2 || (REG_C - ENTRY) * NCW <= ENTRY - REG_P,
                "register budgets");
};

// One block per (kv program, part, batch, kv head, cluster, rank); the
// cluster's ranks are consecutive q heads of one GQA group.  A program of
// C*bkv kv rows runs as (C*bkv)/RB consecutive blocks, each walking the
// whole program's live q tiles (`dkv_walk`).  Under causal masking the
// first programs have the most live q blocks, so the plain order launches
// them first.
template <int D, int NWG, int QT>
__global__ void __launch_bounds__(Dkv<D, NWG, QT>::THREADS, 1)
flash_dkv_ws(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tdo,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const float* __restrict__ m, const float* __restrict__ l,
             const float* __restrict__ delta, float* __restrict__ dk,
             float* __restrict__ dv, const Geo g, const int cl) {
  using F = Dkv<D, NWG, QT>;
  constexpr int RB = F::RB, DC = F::DC, QC = F::QC, CB = F::CB;
  constexpr int NCW = F::NCW, STAGES = F::STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = (hop::smem_u32(smem) + 1023) & ~1023u;
  const uint32_t skv = base, svv = base + F::KV_BYTES;
  const uint32_t xp = base + 2 * F::KV_BYTES, xd = xp + F::X_BYTES;
  const uint32_t ring = base + F::FIXED;
  const uint32_t full = base + F::BODY;              // + 8 * stage
  const uint32_t empty = full + 8 * STAGES;
  const uint32_t kvbar = empty + 8 * STAGES;

  // launch position -> (kv program, part, batch, kv head, cluster, rank)
  const int rp = g.c * g.bkv;                        // kv rows of a program
  const int nprog = g.sk / rp, parts = rp / RB;
  const int grp = g.h / g.hkv, ng = grp / cl;
  const int rank = blockIdx.x % cl;
  const int planes = gridDim.x / cl / (nprog * parts);
  const int unit = blockIdx.x / cl / planes, plane = blockIdx.x / cl % planes;
  const int ki = unit / parts, r_base = (unit % parts) * RB;
  const int gi = plane % ng, kvh = plane / ng % g.hkv, bb = plane / ng / g.hkv;
  const int hh = kvh * grp + gi * cl + rank;
  const int skg = g.sk / g.c;
  const auto kcol = [&](int r) {                     // r: a program row
    return prog_row(r, ki, g.bkv, g.c, skg, g.gapped);
  };
  // the program's live q blocks (:371-380): a contiguous range
  const int min_col = kcol(0), max_col = kcol(rp - 1);
  const int nq = g.sq / g.bq;
  int qb_lo = 0, qb_hi = nq;
  if (g.causal) qb_lo = min_col / g.bq;
  if (g.window > 0) qb_hi = min(nq, (max_col + g.window - 1) / g.bq + 1);
  const int ntiles = max(0, qb_hi - qb_lo) * (g.bq / QT);
  const int q_begin = qb_lo * g.bq;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      hop::bar_init<1>(full + 8 * st);
      hop::bar_init<NCW * 4>(empty + 8 * st);   // every consumer warp
    }
    hop::bar_init<1>(kvbar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NCW) {
    // -- producer: K and V once, then the Q, dO, m, l, delta tiles ----------
    if constexpr (NCW > 1) hop::regs_dec<F::REG_P>();
    if (threadIdx.x == NCW * 128) {
      const int kv0 = (bb * g.hkv + kvh) * g.sk;
      const int bk = min(g.bkv, 64);             // rows of a K / V box
      hop::bar_expect(kvbar, 2 * F::KV_BYTES);
      for (int r = 0; r < RB; r += bk)
        for (int cb = 0; cb < CB; ++cb) {
          const int row = kv0 + kcol(r_base + r);
          hop::tma_2d(skv + (cb * RB + r) * 128, &tk, cb * 64, row, kvbar);
          hop::tma_2d(svv + (cb * RB + r) * 128, &tv, cb * 64, row, kvbar);
        }
      const int q0 = (bb * g.h + hh) * g.sq + q_begin;
      for (int i = 0; i < ntiles; ++i) {
        const int st = i % STAGES;
        hop::bar_wait(empty + 8 * st, ((i / STAGES) & 1) ^ 1);
        const uint32_t tq_ = ring + st * F::STAGE, to_ = tq_ + F::T_BYTES;
        const uint32_t ts = to_ + F::T_BYTES;
        const int row = q0 + i * QT;
        hop::bar_expect(full + 8 * st, 2 * F::T_BYTES + 3 * QT * 4);
        for (int cb = 0; cb < CB; ++cb) {
          hop::tma_2d(tq_ + cb * QT * 128, &tq, cb * 64, row, full + 8 * st);
          hop::tma_2d(to_ + cb * QT * 128, &tdo, cb * 64, row, full + 8 * st);
        }
        hop::bulk_1d(ts, m + row, QT * 4, full + 8 * st);
        hop::bulk_1d(ts + QT * 4, l + row, QT * 4, full + 8 * st);
        hop::bulk_1d(ts + 2 * QT * 4, delta + row, QT * 4, full + 8 * st);
      }
    }
  } else {
    // -- consumers ----------------------------------------------------------
    if constexpr (NCW > 1) hop::regs_inc<F::REG_C>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int gq = lane >> 2, t = lane & 3;
    // the warpgroup's 64 kv rows (block rows kb .. kb+63; both warpgroups'
    // at D 256), this thread's two of them, and their extremes
    const int kb = F::SPLIT ? 0 : wg * 64;
    const int lr = kb + warp * 16 + gq;
    const int col0 = kcol(r_base + lr), col1 = kcol(r_base + lr + 8);
    const int w_lo = kcol(r_base + kb), w_hi = kcol(r_base + kb + 63);
    // the warpgroup's q columns of a tile (at D 256 half of them each)
    const int qc0 = F::SPLIT ? wg * QC : 0;
    const float sl = g.scale * LOG2E;

    // dK and dV: 64 x DC a warpgroup (columns wg*DC.. at D 256), 4j + e as
    // wgmma's accumulator
    float dka[DC / 2], dva[DC / 2];
#pragma unroll
    for (int i = 0; i < DC / 2; ++i) dka[i] = dva[i] = 0.f;

    const uint32_t ka = skv + kb * 128, va = svv + kb * 128;
    const float* stat = reinterpret_cast<const float*>(
        smem + (ring - hop::smem_u32(smem)));
    hop::bar_wait(kvbar, 0);
    for (int i = 0; i < ntiles; ++i) {
      const int st = i % STAGES;
      const uint32_t tq_ = ring + st * F::STAGE, to_ = tq_ + F::T_BYTES;
      const float* sm_ = stat + (st * F::STAGE + 2 * F::T_BYTES) / 4;
      hop::bar_wait(full + 8 * st, (i / STAGES) & 1);

      // S^T = K Q^T and dP^T = V dO^T over the warpgroup's QC q rows
      float s[QC / 2], dp[QC / 2];
      hop::wg_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        hop::wgmma_ss<QC>(
            s, hop::desc(ka + (ks / 4) * RB * 128 + (ks % 4) * 32),
            hop::desc(tq_ + (ks / 4) * QT * 128 + qc0 * 128 + (ks % 4) * 32),
            ks > 0);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        hop::wgmma_ss<QC>(
            dp, hop::desc(va + (ks / 4) * RB * 128 + (ks % 4) * 32),
            hop::desc(to_ + (ks / 4) * QT * 128 + qc0 * 128 + (ks % 4) * 32),
            ks > 0);
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::wg_hold(s);
      hop::wg_hold(dp);

      // P^T from the saved (m, l) of each q row, dS^T = P^T (dP^T - delta);
      // a tile is full for the warpgroup when every (q row, kv row) pair of
      // the tile and its 64 kv rows is allowed
      const int q0 = q_begin + i * QT;
      const bool whole = (!g.causal || w_hi <= q0) &&
                         (g.window <= 0 || w_lo > q0 + QT - 1 - g.window);
#pragma unroll
      for (int j = 0; j < QC / 2; j += 4)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qc = qc0 + 2 * j + 2 * t + e;     // the tile's q row
          const float ml = log2_norm(sm_[qc], sm_[QT + qc]);
          const float dl = sm_[2 * QT + qc];
          float p0 = exp2_approx(s[j + e] * sl - ml);
          float p1 = exp2_approx(s[j + 2 + e] * sl - ml);
          if (!whole) {
            p0 = allowed(q0 + qc, col0, g) ? p0 : 0.f;
            p1 = allowed(q0 + qc, col1, g) ? p1 : 0.f;
          }
          s[j + e] = p0;
          s[j + 2 + e] = p1;
          dp[j + e] = p0 * (dp[j + e] - dl);
          dp[j + 2 + e] = p1 * (dp[j + 2 + e] - dl);
        }

      if constexpr (!F::SPLIT) {
        // dV += P^T dO and dK += dS^T Q: P^T, dS^T (bf16) the register A
        // operands; dO and Q MN-major, k16 steps 16 rows (2 KB) apart,
        // 64-column chunks QT rows apart
        uint32_t pa[QT / 16][4], da[QT / 16][4];
#pragma unroll
        for (int kk = 0; kk < QT / 16; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            pa[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
            da[kk][x] = pack_bf16(dp[8 * kk + 2 * x], dp[8 * kk + 2 * x + 1]);
          }
        hop::wg_hold(dka);
        hop::wg_hold(dva);
#pragma unroll
        for (int kk = 0; kk < QT / 16; ++kk) {
          hop::wg_hold(pa[kk]);
          hop::wg_hold(da[kk]);
        }
        hop::wg_fence();
#pragma unroll
        for (int kk = 0; kk < QT / 16; ++kk)
          hop::wgmma_rs<D, 1>(dva, pa[kk],
                              hop::desc_mn(to_ + kk * 2048, QT * 128), 1);
#pragma unroll
        for (int kk = 0; kk < QT / 16; ++kk)
          hop::wgmma_rs<D, 1>(dka, da[kk],
                              hop::desc_mn(tq_ + kk * 2048, QT * 128), 1);
        hop::wg_commit();
        hop::wg_wait<0>();
        hop::wg_hold(dka);
        hop::wg_hold(dva);
#pragma unroll
        for (int kk = 0; kk < QT / 16; ++kk) {
          hop::wg_hold(pa[kk]);
          hop::wg_hold(da[kk]);
        }
      } else {
        // the exchange: each warpgroup writes its q columns of P^T and
        // dS^T (bf16, K-major, the 128-byte swizzle: 16-byte chunk c of
        // row r at c ^ (r & 7)) once both are done with the last tile's
        hop::bar_named(1, 256);
#pragma unroll
        for (int j = 0; j < QC / 8; ++j) {
          const int c = (qc0 / 8 + j) ^ (lr & 7);   // lr + 8: the same & 7
          const uint32_t o0 = lr * 128 + c * 16 + 4 * t;
          const uint32_t o1 = o0 + 8 * 128;
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(xp + o0),
                       "r"(pack_bf16(s[4 * j], s[4 * j + 1])) : "memory");
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(xp + o1),
                       "r"(pack_bf16(s[4 * j + 2], s[4 * j + 3])) : "memory");
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(xd + o0),
                       "r"(pack_bf16(dp[4 * j], dp[4 * j + 1])) : "memory");
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(xd + o1),
                       "r"(pack_bf16(dp[4 * j + 2], dp[4 * j + 3])) : "memory");
        }
        hop::fence_async_smem();
        hop::bar_named(2, 256);
        // dV += P^T dO and dK += dS^T Q over the whole tile (depth QT), for
        // this warpgroup's half of D: both operands from shared memory
        const uint32_t half = 2 * wg * QT * 128;    // column boxes 2wg, 2wg+1
        hop::wg_hold(dka);
        hop::wg_hold(dva);
        hop::wg_fence();
#pragma unroll
        for (int kk = 0; kk < QT / 16; ++kk)
          hop::wgmma_ss<DC, 1>(dva, hop::desc(xp + kk * 32),
                               hop::desc_mn(to_ + half + kk * 2048, QT * 128),
                               1);
#pragma unroll
        for (int kk = 0; kk < QT / 16; ++kk)
          hop::wgmma_ss<DC, 1>(dka, hop::desc(xd + kk * 32),
                               hop::desc_mn(tq_ + half + kk * 2048, QT * 128),
                               1);
        hop::wg_commit();
        hop::wg_wait<0>();
        hop::wg_hold(dka);
        hop::wg_hold(dva);
      }
      if (lane == 0) hop::bar_arrive(empty + 8 * st);  // the stage is read
    }

    // every consumer is done with the ring: the block's partials (dK
    // scaled) over it, rows of LDR floats
    hop::bar_named(3, NCW * 128);
    float* red = reinterpret_cast<float*>(smem + (base - hop::smem_u32(smem)));
    const int c_base = F::SPLIT ? wg * DC : 0;
#pragma unroll
    for (int j = 0; j < DC / 8; ++j) {
      const int c = c_base + 8 * j + 2 * t;
      float* k0 = red + lr * F::LDR + c;
      float* v0 = red + (RB + lr) * F::LDR + c;
      *reinterpret_cast<float2*>(k0) =
          make_float2(dka[4 * j] * g.scale, dka[4 * j + 1] * g.scale);
      *reinterpret_cast<float2*>(k0 + 8 * F::LDR) =
          make_float2(dka[4 * j + 2] * g.scale, dka[4 * j + 3] * g.scale);
      *reinterpret_cast<float2*>(v0) = make_float2(dva[4 * j], dva[4 * j + 1]);
      *reinterpret_cast<float2*>(v0 + 8 * F::LDR) =
          make_float2(dva[4 * j + 2], dva[4 * j + 3]);
    }
  }

  cluster_sync();                      // every rank's partials are whole
  if (wg < NCW) {
    // rank `rank` sums its share of the rows over the cluster's blocks in
    // rank order and writes them once
    const float* red = reinterpret_cast<const float*>(
        smem + (base - hop::smem_u32(smem)));
    cg::cluster_group cluster = cg::this_cluster();
    const int r0 = rank * RB / cl, r1 = (rank + 1) * RB / cl;
    constexpr int C4 = D / 4;
    const int n = (r1 - r0) * C4;
    const size_t obase = ((size_t)(bb * g.hkv + kvh) * ng + gi) * g.sk;
    for (int idx = threadIdx.x; idx < 2 * n; idx += NCW * 128) {
      const int which = idx >= n, x = idx - which * n;
      const int r = r0 + x / C4, c = (x % C4) * 4;
      const float* src = red + (which * RB + r) * F::LDR + c;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int q = 0; q < cl; ++q) {
        const float4 y = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(src, q));
        v.x += y.x;
        v.y += y.y;
        v.z += y.z;
        v.w += y.w;
      }
      float* out = (which ? dv : dk) + (obase + kcol(r_base + r)) * D + c;
      *reinterpret_cast<float4*>(out) = v;
    }
  }
  cluster_sync();                      // no block leaves while it is read
}

// -- the backward's preprocessing ---------------------------------------------

// one warp per row: delta = sum(g * o) (f32) and dO = g rounded to bf16
__global__ void __launch_bounds__(256)
flash_prep_kernel(const float* __restrict__ o, const float* __restrict__ gr,
                  bf16* __restrict__ dout, float* __restrict__ delta,
                  int rows, int d) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float4* o4 = reinterpret_cast<const float4*>(o + (size_t)row * d);
  const float4* g4 = reinterpret_cast<const float4*>(gr + (size_t)row * d);
  uint2* d2 = reinterpret_cast<uint2*>(dout + (size_t)row * d);
  float acc = 0.f;
  for (int c = lane; c < d / 4; c += 32) {
    const float4 x = g4[c], y = o4[c];
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
    d2[c] = make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// -- launchers ----------------------------------------------------------------

constexpr auto BF16_MAP = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
constexpr auto SWIZZLE = CU_TENSOR_MAP_SWIZZLE_128B;

// a 2-D view (rows of every batch and head, D) of a bf16 tensor, boxes of
// 64 columns x `box` rows, 128-byte swizzled
int map_rows(CUtensorMap* mp, const void* ptr, int d, uint64_t rows, int box) {
  return hop::make_map(mp, BF16_MAP, ptr, d, rows, (uint64_t)d * 2, 64, box,
                       SWIZZLE);
}

// the tensor maps of q (boxes of bq rows) and k, v (KT rows)
template <int D, int NWG>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* mo, void* lo, int b, const Geo& g, cudaStream_t st) {
  using F = Fwd<D, NWG>;
  CUtensorMap tq, tk, tv;
  int rc = map_rows(&tq, q, D, (uint64_t)b * g.h * g.sq, g.bq);
  if (rc == 0) rc = map_rows(&tk, k, D, (uint64_t)b * g.hkv * g.sk, F::KT);
  if (rc == 0) rc = map_rows(&tv, v, D, (uint64_t)b * g.hkv * g.sk, F::KT);
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

// q and dO in boxes of min(bq, 64) rows, k and v of KT rows
template <int D, int NWG>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* m, const void* l, const void* delta, void* dq,
              int b, const Geo& g, cudaStream_t st) {
  using F = Dq<D, NWG>;
  const uint64_t qrows = (uint64_t)b * g.h * g.sq;
  const uint64_t kvrows = (uint64_t)b * g.hkv * g.sk;
  CUtensorMap tq, tdo, tk, tv;
  int rc = map_rows(&tq, q, D, qrows, min(g.bq, 64));
  if (rc == 0) rc = map_rows(&tdo, dout, D, qrows, min(g.bq, 64));
  if (rc == 0) rc = map_rows(&tk, k, D, kvrows, F::KT);
  if (rc == 0) rc = map_rows(&tv, v, D, kvrows, F::KT);
  if (rc != 0) return rc;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_dq_ws<D, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      F::SMEM);
  if (e != cudaSuccess) return (int)e;
  // launch position major, then part, then (head, batch)
  flash_dq_ws<D, NWG><<<(g.sq / F::R) * g.h * b, F::THREADS, F::SMEM, st>>>(
      tq, tdo, tk, tv, static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<const float*>(delta),
      static_cast<float*>(dq), g);
  return (int)cudaGetLastError();
}

// the launch of a dK/dV grid in clusters of `cl` blocks (q heads of one
// GQA group): launch position major, then part, batch, kv head, cluster,
// rank.  max_clusters: how many such clusters the card holds at once
// (cudaOccupancyMaxActiveClusters), or launch when null.
template <int D, int NWG, int QT>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* m, const void* l, const void* delta, void* dk,
               void* dv, int b, const Geo& g, int cl, cudaStream_t st,
               int* max_clusters) {
  using F = Dkv<D, NWG, QT>;
  auto kern = flash_dkv_ws<D, NWG, QT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, F::SMEM);
  if (e == cudaSuccess && cl > 8)
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((g.sk / F::RB) * b * g.h);
  cfg.blockDim = dim3(F::THREADS);
  cfg.dynamicSmemBytes = F::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr)
    return (int)cudaOccupancyMaxActiveClusters(max_clusters, kern, &cfg);
  const uint64_t qrows = (uint64_t)b * g.h * g.sq;
  const uint64_t kvrows = (uint64_t)b * g.hkv * g.sk;
  CUtensorMap tq, tdo, tk, tv;
  int rc = map_rows(&tq, q, D, qrows, QT);
  if (rc == 0) rc = map_rows(&tdo, dout, D, qrows, QT);
  if (rc == 0) rc = map_rows(&tk, k, D, kvrows, min(g.bkv, 64));
  if (rc == 0) rc = map_rows(&tv, v, D, kvrows, min(g.bkv, 64));
  if (rc != 0) return rc;
  e = cudaLaunchKernelEx(&cfg, kern, tq, tdo, tk, tv,
                         static_cast<const float*>(m),
                         static_cast<const float*>(l),
                         static_cast<const float*>(delta),
                         static_cast<float*>(dk), static_cast<float*>(dv), g,
                         cl);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the geometry the kernels take; the wrapper raises on anything else.
// q-axis programs (forward, dQ): C*bq rows, kv tiles of 32 or 64 rows;
// kv-axis programs (dK/dV): C*bkv rows, q tiles of 32 or 64 rows.  Head
// dim 256 holds programs of 64 and 128 rows only (the blocks' shared
// memory and registers at 256 rows: `Fwd`, `Dq`, `Dkv`)
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

// dK/dV: the instance for head dim d, programs of `rows` kv rows and q
// tiles of qt rows (consumer warpgroups: one per 64 rows up to 128 at D
// <= 128; two sharing 64 rows at D 256)
int dkv_dispatch(int d, int rows, int qt, const void* q, const void* k,
                 const void* v, const void* dout, const void* m,
                 const void* l, const void* delta, void* dk, void* dv,
                 int b, const Geo& g, int cl, cudaStream_t st, int* mc) {
#define DKV(D_, NWG_, QT_)                                                  \
  launch_dkv<D_, NWG_, QT_>(q, k, v, dout, m, l, delta, dk, dv, b, g, cl, \
                            st, mc)
  const int nwg = d >= 256 ? 1 : (rows >= 128 ? 2 : 1);
  switch (d * 100 + nwg * 10 + qt / 32) {
    case 6412: return DKV(64, 1, 64);
    case 6411: return DKV(64, 1, 32);
    case 6422: return DKV(64, 2, 64);
    case 6421: return DKV(64, 2, 32);
    case 12812: return DKV(128, 1, 64);
    case 12811: return DKV(128, 1, 32);
    case 12822: return DKV(128, 2, 64);
    case 12821: return DKV(128, 2, 32);
    case 25612: return DKV(256, 1, 64);
    case 25611: return DKV(256, 1, 32);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DKV
}

// every dQ and dK/dV instance that `flash_dq_bf16` / `dkv_dispatch` can
// launch, for `flash_bwd_instance`
struct BwdInstance {
  const char* name;
  const void* fn;
};
#define DQI(D_, NWG_) \
  {"flash_dq_ws<" #D_ ", " #NWG_ ">", (const void*)flash_dq_ws<D_, NWG_>}
#define DKVI(D_, NWG_, QT_)                            \
  {"flash_dkv_ws<" #D_ ", " #NWG_ ", " #QT_ ">",       \
   (const void*)flash_dkv_ws<D_, NWG_, QT_>}
const BwdInstance kBwdInstances[] = {
    DQI(64, 1), DQI(64, 2), DQI(128, 1), DQI(128, 2), DQI(256, 1),
    DQI(256, 2), DKVI(64, 1, 64), DKVI(64, 1, 32), DKVI(64, 2, 64),
    DKVI(64, 2, 32), DKVI(128, 1, 64), DKVI(128, 1, 32), DKVI(128, 2, 64),
    DKVI(128, 2, 32), DKVI(256, 1, 64), DKVI(256, 1, 32)};
#undef DQI
#undef DKVI

}  // namespace

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

// dq (B,H,Sq,D) f32 from dout (B,H,Sq,D) bf16 and the residuals; a program
// of 256 rows runs as two blocks of 128
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
  const bool two = c * bq >= 128;     // two consumer warpgroups a block
#define DQ(D_, NWG_) launch_dq<D_, NWG_>(q, k, v, dout, m, l, delta, dq, b, g, st)
  switch (d) {
    case 64: return two ? DQ(64, 2) : DQ(64, 1);
    case 128: return two ? DQ(128, 2) : DQ(128, 1);
    case 256: return two ? DQ(256, 2) : DQ(256, 1);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DQ
}

// dk, dv (B,Hkv,G/cl,Sk,D) f32 from dout (B,H,Sq,D) bf16 and the
// residuals, each summed over the cluster's cl q heads (cl divides the
// group G = H/Hkv, at most 16; the wrapper sums the G/cl clusters)
extern "C" int flash_dkv_bf16(const void* q, const void* k, const void* v,
                              const void* dout, const void* m, const void* l,
                              const void* delta, void* dk, void* dv, int b,
                              int h, int hkv, int sq, int sk, int d, int c,
                              int bq, int bkv, int gapped, int causal,
                              int window, float scale, int cl, void* stream) {
  const Geo g = make_geo(h, hkv, sq, sk, c, bq, bkv, gapped, causal, window,
                         scale);
  if (!valid(d, b, g, true) || cl < 1 || cl > 16 || (h / hkv) % cl)
    return (int)cudaErrorInvalidValue;
  return dkv_dispatch(d, c * bkv, dkv_qt(bq), q, k, v, dout, m, l, delta,
                      dk, dv, b, g, cl, reinterpret_cast<cudaStream_t>(stream),
                      nullptr);
}

// how many clusters of `cl` dK/dV blocks the card holds at once for that
// geometry (cudaOccupancyMaxActiveClusters; 0: the launch would fail), or
// -1 on an error
extern "C" int flash_dkv_clusters(int d, int rows, int bq, int bkv, int h,
                                  int hkv, int cl) {
  const int s = 4096;
  const Geo g = make_geo(h, hkv, s, s, rows / bkv, bq, bkv, 0, 1, 0, 1.f);
  if (!valid(d, 1, g, true) || cl < 1 || cl > 16 || (h / hkv) % cl)
    return -1;
  int n = 0;
  const int rc = dkv_dispatch(d, rows, dkv_qt(bq), nullptr, nullptr, nullptr,
                              nullptr, nullptr, nullptr, nullptr, nullptr,
                              nullptr, 1, g, cl, nullptr, &n);
  return rc == 0 ? n : -1;
}

// backward instance i: its name (cut to `cap` bytes with the NUL), the
// local memory a thread takes (spills and stack frame) and its registers,
// as the loaded module reports them (cudaFuncGetAttributes); -1 past the
// last instance, else a CUDA error code
extern "C" int flash_bwd_instance(int i, char* name, int cap,
                                  int* local_bytes, int* regs) {
  if (i < 0 || i >= (int)(sizeof(kBwdInstances) / sizeof(kBwdInstances[0])))
    return -1;
  snprintf(name, cap, "%s", kBwdInstances[i].name);
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kBwdInstances[i].fn);
  if (e != cudaSuccess) return (int)e;
  *local_bytes = (int)a.localSizeBytes;
  *regs = a.numRegs;
  return 0;
}

// dout (rows, d) bf16 = g rounded; delta (rows,) = sum(g * o), f32
extern "C" int flash_bwd_prep(const void* o, const void* g, void* dout,
                              void* delta, int rows, int d, void* stream) {
  if (rows < 1 || d < 4 || d % 4) return (int)cudaErrorInvalidValue;
  flash_prep_kernel<<<(rows + 7) / 8, 256, 0,
                      reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(g),
      static_cast<bf16*>(dout), static_cast<float*>(delta), rows, d);
  return (int)cudaGetLastError();
}
