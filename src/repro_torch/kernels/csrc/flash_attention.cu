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
// Sk/C apart (`col_ids`, :343).  Each warp owns 16 of the program's rows, so
// a program of R rows runs R/16 warps (R <= 256; R <= 128 at head dim 256,
// see `valid`), and every warp keeps its rows' f32 sums in registers for
// the whole sweep (at D 256 the dK/dV sums are split over two blocks by
// head-dim half, see `flash_dkv_kernel`).  The sweep stages one
// tile of the streamed operand (K/V for the forward and dQ, Q/dO for dK/dV)
// in shared memory at a time, and ALL the program's rows consume it before
// the next is loaded: the staged tile is shared by the C fused blocks,
// which is the coarsening's point (module docstring of the Pallas file,
// :14-16).  The whole-block skip is the Pallas one, block for block:
// `_q_axis_mask_live` (:86) for the forward and dQ (consecutive keeps the
// causal triangle pruning; gapped degenerates to the worst row, the
// paper's divergence penalty, kept on purpose) and :371-380 for dK/dV.
// Inside a live block the per-element causal / window mask is exact.
//
// Arithmetic.  Products run on the tensor cores through mma.sync
// m16n8k16 (bf16 x bf16 -> f32), with the warp tiles of `flash_tile.cuh`
// (shared with the block-sparse forward, `sparse_attention.cu`).  Q, K,
// V are bf16 already; the softmax probabilities p, the f32 cotangent dO
// and dS are rounded to bf16 where they enter a product, and every sum is
// f32.  The Pallas kernels take
// those products in f32; the difference is one bf16 rounding of an
// operand, which the card check's tolerance states.
//
// Bound on this card, at the train path's shapes (B 4, S 1024, H 16,
// Hkv 8, D 128, causal): max(bytes / 3.35 TB/s, flops / 989 TFLOP/s), each
// input read once and each output written once; the causal work is half
// the square.  Forward: 68 MB and 17 GFLOP (0.020 ms, bytes).  dQ: reads
// q, k, v, do, m, l, delta and writes dq, 102 MB and 26 GFLOP (0.030 ms,
// bytes).  dK/dV: the same inputs and the group-summed dk, dv, 102 MB and
// 34 GFLOP (0.035 ms, operations).
// What the design does about it: a K/V (or Q/dO) byte is staged once per
// program, not once per fused block, and dead causal blocks are skipped
// without a load.  It has no software pipeline, TMA or wgmma: the loads
// and the products of a tile do not overlap, so the kernels run well above
// the bound; making them fast is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tile.cuh"

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

// -- forward ------------------------------------------------------------------

// one block per (q-program, head, batch); R = C*bq rows, 16 per warp
template <int D, int NW>
__global__ void __launch_bounds__(NW * 32)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ mo, float* __restrict__ lo, Geo g) {
  constexpr int LD = D + PAD, KT = kv_tile(D, NW), R = NW * 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);          // R x LD
  bf16* sk = sq + R * LD;                            // KT x LD
  bf16* sv = sk + KT * LD;                           // KT x LD

  const int qi = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int kvh = hh / (g.h / g.hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, r0 = warp * 16;
  const int sg = g.sq / g.c;
  const size_t qoff = (size_t)(bb * g.h + hh) * g.sq;
  const size_t kvoff = (size_t)(bb * g.hkv + kvh) * g.sk * D;
  const auto qrow = [&](int r) {
    return prog_row(r, qi, g.bq, g.c, sg, g.gapped);
  };
  stage_bf16<D>(sq, q + qoff * D, R, qrow);

  const int row0 = qrow(r0 + gr), row1 = qrow(r0 + gr + 8);
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;

  // whole-block skip of `_q_axis_mask_live`: the program's extreme rows
  const int min_row = g.gapped ? qi * g.bq : qi * R;
  const int max_row = g.gapped ? (g.c - 1) * sg + qi * g.bq + g.bq - 1
                               : qi * R + R - 1;
  const int nk = g.sk / g.bkv;
  for (int ki = 0; ki < nk; ++ki) {
    if (g.causal && ki * g.bkv > max_row) continue;
    if (g.window > 0 && (ki + 1) * g.bkv <= min_row - g.window + 1) continue;
    for (int c0 = ki * g.bkv; c0 < (ki + 1) * g.bkv; c0 += KT) {
      __syncthreads();                  // the previous tile is consumed
      const auto krow = [&](int r) { return c0 + r; };
      stage_bf16<D>(sk, k + kvoff, KT, krow);
      stage_bf16<D>(sv, v + kvoff, KT, krow);
      __syncthreads();

      float s[KT / 8][4];
      warp_xyt<D, KT>(s, sq, sk, r0);
      softmax_step<D, KT>(s, acc, m0, m1, l0, l1, row0, row1, c0, g.scale,
                          sv, [&](int row, int col) {
                            return allowed(row, col, g);
                          });
    }
  }
  store_o<D>(o + qoff * D, mo == nullptr ? nullptr : mo + qoff,
             lo == nullptr ? nullptr : lo + qoff, acc, m0, m1, l0, l1, row0,
             row1);
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

constexpr int fwd_smem(int d, int nw) {
  return (nw * 16 + 2 * kv_tile(d, nw)) * (d + PAD) * 2;
}
constexpr int dq_smem(int d, int nw) {
  return (2 * nw * 16 + 2 * kv_tile(d, nw)) * (d + PAD) * 2;
}
constexpr int dkv_smem(int d, int nw) {
  return (2 * nw * 16 + 2 * 32) * (d + PAD) * 2 + 3 * 32 * 4;
}

template <int D, int NW>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* mo, void* lo, int b, const Geo& g, cudaStream_t st) {
  const int smem = fwd_smem(D, NW);
  cudaFuncSetAttribute(flash_fwd_kernel<D, NW>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid(g.sq / (g.c * g.bq), g.h, b);
  flash_fwd_kernel<D, NW><<<grid, NW * 32, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<float*>(o),
      static_cast<float*>(mo), static_cast<float*>(lo), g);
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
#define CALL(D_, NW_) launch_fwd<D_, NW_>(q, k, v, o, mo, lo, b, g, st)
  FLASH_DISPATCH(c * bq, d, CALL)
#undef CALL
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
