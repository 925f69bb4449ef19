// Split-KV decode attention for Hopper (sm_90a): one kernel, `rows_kernel`,
// for the three Pallas kernels of `repro/kernels/decode_attention.py`'s
// split-KV family, with the exact split combine `_combine` (:37), which
// the reference runs outside Pallas, in the same launch:
//
// * `make_paged_kernel` (:208, pallas_call at :342): one query token a
//   slot against that slot's K/V rows in a global page pool (P, ps, Hkv,
//   D) reached through a block table (B, npp) -- the paged call at T = 1;
// * `make_kernel` (:51, pallas_call at :171): decode against a contiguous
//   (B, S, Hkv, D) cache;
// * `make_verify_kernel` (:380, pallas_call at :510): T drafted query rows
//   a slot through the block table.
//
// Each owns C kv segments per (slot, kv head, split) -- kv blocks of `bkv`
// rows (contiguous: adjacent, or S/C rows apart) or pages (paged decode,
// verify: adjacent si*C + j, or npp/C apart j*(npp/C) + si) -- with the
// reference's live-split rule.  R = T*G <= 64 query rows a block (t-major:
// row r = t*G + g sits at position pos0 + t with its own causal/window
// mask), D a multiple of 32 up to 256, D/32 warps a block.  Paged decode
// is the paged call at T = 1, so a decode row and the same row of a verify
// pass take one walk and one order of every sum.
//
// int8 caches (the `kv_bits=8` branches, scale loads at :295-301): K and V
// rows are int8 with one f32 scale per (row, kv head); a score is
// (q . k_int) * s_k * scale and a V row enters the sum as (p * s_v) *
// v_int.
//
// The design:
//
// * A ring of 2-4 stages of TR = 16 or 32 kv rows (32 where they tile the
//   segment and T*G <= 32; K, V, and for int8
//   their scales), filled by cp.async 16 bytes a thread, one commit group a
//   tile: the next tiles' loads are in flight while this one is scored
//   (the ring runs on across a block's splits).
//   A consecutive split's C segments are one run of rows (one wide run of
//   a contiguous cache, C pages of a table); a gapped split's are C runs
//   nseg/C segments apart.  Only the tiles with a row inside some query
//   row's mask are staged, so no row at or past S, or past the slot's
//   pages, is read; rows of a tile past its segment are zero-filled.
// * Scores on tensor cores: mma.sync m16n8k16 bf16 -> f32, the R query
//   rows padded to MT*16 (MT = 1, 2 or 4) and staged once a block as bf16,
//   A fragments and K by ldmatrix; an int8 stage's K and V rows are
//   widened to bf16 once in shared memory for every warp (exact:
//   |x| <= 127), the scales kept beside them.  Every warp scores the
//   whole tile, so the online softmax stays in its registers: a row's max
//   and sum come from the 4 lanes that hold it (quad shuffles), with no
//   block barrier.
// * P.V in float32 on the CUDA cores, as the reference computes it: each
//   warp owns 32 output columns, a lane 2 columns of every other row; the
//   tile's probabilities (times the V scale) and each row's rescale reach
//   those lanes through the warp's own slice of shared memory.
// * The splits of a (slot, kv head) run on CL <= 16 blocks (CL divides the
//   split count), block q running splits q, q + CL, ...: it walks its live
//   splits' tiles through one ring and writes each split's partial (m, l,
//   acc).  A split wholly dead (the live rule) stages and writes nothing,
//   and a block with no live split exits at once.  The only live split of
//   a (slot, kv head) writes the output itself.  Otherwise the last of
//   its blocks to take a ticket (an atomic on a per-device counter array,
//   beside each row's running maximum, both reset by that block, so no
//   memset launch is needed) merges the live splits' partials in split
//   order, staged through shared memory by cp.async, so the result does
//   not depend on which block came last.
// * Row-independent arithmetic: a row's scores, softmax and P.V follow the
//   same tile walk and the same order of every sum in every instance, with
//   no contracted multiply-adds (explicit __fmul_rn/__fadd_rn/__fmaf_rn),
//   and an all-masked tile or split contributes exact zeros (p = 0,
//   alpha = 1): verify at T rows equals T calls at T = 1 bit for bit.
//
// Bound on this card: the live K/V bytes (and, for int8, their scales) at
// 3.35 TB/s: every K/V byte is read once, and never for rows outside the
// mask; scoring each fetched tile against T*G <= 64 rows stays far below
// the tensor-core ridge.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "hopper.cuh"

namespace {

constexpr float NEG = -1e30f;

constexpr int ROWS_MAXR = 64;     // T*G query rows a kv head
constexpr int ROWS_MAXD = 256;    // head dim (D/32 warps a block)
constexpr int ROWS_SMEM = 227 * 1024 - 128;   // dynamic shared memory a block
constexpr int ROWS_MERGE_SMEM = 48 * 1024;    // shared memory a block at least
constexpr int ROWS_TAB = 1024;    // table entries read with the positions
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

struct RowsArgs {
  const __nv_bfloat16* q;     // (B, T, Hkv*G, D)
  const void* k;              // PAGED: pools (P, seg, Hkv, D), else caches
  const void* v;              // (B, nseg*seg, Hkv, D); bf16 or int8
  const float* k_scale;       // int8: one f32 a (row, kv head), else null
  const float* v_scale;
  const int* block_table;     // (B, nseg) when paged
  const int* pos0;            // (B,)
  float* ws;                  // m, l (B, Hkv, n_splits, R), acc (.., R, D)
  unsigned* tickets;          // (B*Hkv,) then the row maxima (B*Hkv, 64):
                              // zero between launches
  __nv_bfloat16* out;         // (B, T, Hkv*G, D)
  int paged, n_pages, seg, nseg, hkv, g, t, d, c, gapped, window, nst;
  int spb;                    // splits a block
  float scale;
};

// stage 16 (4) bytes, or zeros when !full (the source is not read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(full ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// wait until at most n (0-2) commit groups are pending
__device__ __forceinline__ void cp_wait_upto(int n) {
  if (n <= 0) cp_wait<0>();
  else if (n == 1) cp_wait<1>();
  else cp_wait<2>();
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((uint32_t)__cvta_generic_to_shared(p)));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x (the softmax runs in log2 units: scores are scaled by log2 e)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// 2^(x - m), exactly 1 where x == m: a rescale by an unchanged maximum, or
// a split's weight under its own maximum, leaves its operand's bits as they
// are
__device__ __forceinline__ float ex2_diff(float x, float m) {
  return x == m ? 1.f : ex2(__fsub_rn(x, m));
}

// two int8 (the lower address in the low byte) as exact floats: each byte,
// biased by 128, is placed in the mantissa of 2^23 (full-rate byte permutes
// and adds in place of quarter-rate int-to-float conversions)
__device__ __forceinline__ float2 int8x2(uint32_t w) {
  const uint32_t u = w ^ 0x8080u;
  return make_float2(
      __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7540)) - 8388736.f,
      __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7541)) - 8388736.f);
}

// two int8 -> a bf16 pair, exactly (|x| <= 127 fits bf16's mantissa)
__device__ __forceinline__ uint32_t widen2(uint16_t w) {
  const float2 f = int8x2(w);
  const __nv_bfloat162 h = __floats2bfloat162_rn(f.x, f.y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// two consecutive bf16 values of a staged V row, packed in 32 bits, and
// as floats
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ float2 unpack(uint32_t w) {
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}

// query row r (t-major: r = t*G + g) of kv head hh of slot bb in the
// (B, T, Hkv*G, D) output
__device__ __forceinline__ __nv_bfloat16* out_row_of(const RowsArgs& a,
                                                     int bb, int hh, int r) {
  const int ti = r / a.g, gi = r - ti * a.g;
  return a.out +
         (((size_t)bb * a.t + ti) * a.hkv * a.g + hh * a.g + gi) * a.d;
}

// a float's order as an unsigned (0 below every float): the row maxima
// are taken with atomicMax
__device__ __forceinline__ unsigned order_of(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float float_of(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// Shared memory of one block: the padded query rows (bf16), the ring, each
// warp's probability tile (TR + 4 floats a row: the TR probabilities, the
// row's rescale alpha, and at the end its m and l), then the pages of the
// block's splits and its tile runs; the merge reuses all of it, and a
// launch gives a block at least ROWS_MERGE_SMEM for that.
__host__ __device__ inline int rows_smem_bytes(int quant, int mt, int tr,
                                               int d, int nst) {
  const int kvs = d * (quant ? 1 : 2) + 16;
  return mt * 16 * (2 * d + 16) + nst * (2 * tr * kvs + (quant ? 8 * tr : 0)) +
         (d / 32) * mt * 16 * (tr + 4) * 4 +
         (quant ? 2 * tr * (2 * d + 16) : 0);
}
__host__ __device__ inline int rows_launch_bytes(int quant, int mt, int tr,
                                                 int d, int nst, int c,
                                                 int spb) {
  const int b = rows_smem_bytes(quant, mt, tr, d, nst) +
                ((spb * c > ROWS_TAB ? spb * c : ROWS_TAB) + 2 * spb + 1) * 4;
  return b > ROWS_MERGE_SMEM ? (b + 15) & ~15 : ROWS_MERGE_SMEM;
}

// KV = __nv_bfloat16 or int8_t; MT m16 tiles of query rows; TR kv rows a
// stage.  Grid (CL, Hkv, B): block q of a (slot, kv head) runs splits q,
// q + CL, ..., spb of them; D threads.
template <typename KV, int MT, int TR>
__global__ void __launch_bounds__(ROWS_MAXD, 1) rows_kernel(const RowsArgs a) {
  constexpr bool QUANT = sizeof(KV) == 1;
  constexpr int RPAD = MT * 16;
  constexpr int NT = TR / 8;             // n8 score tiles a stage
  constexpr int PS = TR + 4;             // floats a probability row
  const int q = blockIdx.x, hh = blockIdx.y;
  const int cl = gridDim.x, spb = a.spb, n_splits = cl * spb;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char rsm[];
  const int d = a.d, R = a.t * a.g;
  const int kvs = d * (int)sizeof(KV) + 16;      // bytes a staged K/V row
  const int qstr = 2 * d + 16;                   // bytes a staged q row
  const int stage_bytes = 2 * TR * kvs + (QUANT ? 8 * TR : 0);
  unsigned char* qsm = rsm;
  unsigned char* ring = rsm + RPAD * qstr;
  float* pw0 = reinterpret_cast<float*>(ring + a.nst * stage_bytes);
  float* pw = pw0 + warp * RPAD * PS;
  // int8: the stage's K and V rows widened to bf16 (TR rows each)
  unsigned char* wide = reinterpret_cast<unsigned char*>(pw0 + (d / 32) *
                                                          RPAD * PS);
  const int wstr = 2 * d + 16;                   // bytes a widened row
  int* tab = reinterpret_cast<int*>(wide + (QUANT ? 2 * TR * wstr : 0));
  int* run_k = tab + max(ROWS_TAB, spb * a.c);   // a live split's first tile
  int* run_o = run_k + spb;                      // its first in the walk

  // the table entries of the block's segments (verify), for every slot
  // where they fit, read while the positions are
  const int per_slot = spb * a.c;
  const bool tab_early = a.paged && (int)gridDim.z * per_slot <= ROWS_TAB;
  auto page_of = [&](int z, int k) {
    const int j = k / a.c, jc = k - j * a.c, s = q + cl * j;
    const int pg = a.block_table[(size_t)z * a.nseg +
                                 (a.gapped ? jc * n_splits + s : s * a.c + jc)];
    return pg < 0 ? 0 : (pg >= a.n_pages ? a.n_pages - 1 : pg);
  };
  if (tab_early)
    for (int i = tid; i < (int)gridDim.z * per_slot; i += blockDim.x)
      tab[i] = page_of(i / per_slot, i % per_slot);

  // the longest slots first: blocks of z run the slot of rank z by live
  // length (ties by index), so the last blocks, and the last merges, are
  // the shortest slots'
  __shared__ int slot_z;
  for (int i = tid; i < (int)gridDim.z; i += blockDim.x) {
    const int len = min(a.pos0[i] + a.t, a.nseg * a.seg);
    int rank = 0;
    for (int j = 0; j < (int)gridDim.z; ++j) {
      const int lj = min(a.pos0[j] + a.t, a.nseg * a.seg);
      rank += lj > len || (lj == len && j < i);
    }
    if (rank == (int)blockIdx.z) slot_z = i;
  }
  __syncthreads();
  const int bb = slot_z, bh = bb * a.hkv + hh;
  if (tab_early) {
    tab += bb * per_slot;
  } else if (a.paged) {
    for (int i = tid; i < per_slot; i += blockDim.x) tab[i] = page_of(bb, i);
  }
  const int p0 = a.pos0[bb], plast = p0 + a.t - 1;

  // the live-split rule (reference :91-99, :433-443) on a split's fused
  // row extent, in closed form: first(s) <= plast and, with a window,
  // last(s) > p0 - window; both rise with s, so the live splits are one
  // run [s_lo, s_hi], and min(CL, its length) blocks have one
  const int span = a.gapped ? a.seg : a.c * a.seg;      // first(s) = s*span
  const int tail = a.gapped ? (a.c - 1) * n_splits * a.seg : 0;
  const int s_hi = plast < 0 ? -1 : min(n_splits - 1, plast / span);
  const int x = p0 - a.window + 1 - tail;   // last(s) > .. iff (s+1)*span > x
  const int s_lo = a.window <= 0 || x <= 0 ? 0 : x / span;
  const int n_live = s_hi - s_lo + 1;
  const int j_lo = s_lo <= q ? 0 : (s_lo - q + cl - 1) / cl;
  const int j_hi = s_hi < q ? -1 : min(spb - 1, (s_hi - q) / cl);
  if (j_lo > j_hi) {           // no live split: block 0 writes zeros if none
    if (q == 0 && n_live <= 0)
      for (int i = tid; i < R * d; i += blockDim.x)
        out_row_of(a, bb, hh, i / d)[i % d] = __float2bfloat16(0.f);
    return;
  }

  // the split's tiles in walk order (segment j, rows r0..): those with a
  // row inside some query row's mask are one run; the block walks its live
  // splits' runs one after another
  const int tps = (a.seg + TR - 1) / TR;         // tiles a segment
  auto tile_at = [&](int s, int k, int& jseg, int& r0) {
    jseg = k / tps;
    r0 = (k - jseg * tps) * TR;
    const int lseg = a.gapped ? jseg * n_splits + s : s * a.c + jseg;
    return lseg * a.seg + r0;
  };
  for (int j = tid; j < spb; j += blockDim.x) {
    const int s = q + cl * j;
    int k_lo = 0, n_t = 0;
    if (j_lo <= j && j <= j_hi)
      for (int k = 0; k < a.c * tps; ++k) {
        int jseg, r0;
        const int row0 = tile_at(s, k, jseg, r0);
        const int last = row0 + min(TR, a.seg - r0) - 1;
        if (row0 <= plast && (a.window <= 0 || last > p0 - a.window)) {
          if (n_t == 0) k_lo = k;
          ++n_t;
        }
      }
    run_k[j] = k_lo;
    run_o[j + 1] = n_t;                  // a count until the prefix below
  }
  __syncthreads();
  if (tid == 0) {
    run_o[0] = 0;
    for (int j = 0; j < spb; ++j) run_o[j + 1] += run_o[j];
  }
  __syncthreads();
  const int n_all = run_o[spb];

  // staging: thread tid copies 16-byte chunk tid % CH of rows tid / CH,
  // + 16 / sizeof(KV), ...
  const char* kg = static_cast<const char*>(a.k);
  const char* vg = static_cast<const char*>(a.v);
  const int ch = d * (int)sizeof(KV) / 16;       // 16-byte chunks a row
  constexpr int RSTEP = 16 / sizeof(KV);         // rows a pass of D threads
  const int l_cc = tid % ch, l_r = tid / ch;
  int jp = 0;                                    // the producer's split
  auto load_tile = [&](int t, int st) {
    while (t >= run_o[jp + 1]) ++jp;
    const int s = q + cl * jp, k = run_k[jp] + t - run_o[jp];
    int jseg, r0;
    const int row0 = tile_at(s, k, jseg, r0);
    const size_t base =
        a.paged ? (size_t)tab[jp * a.c + jseg] * a.seg + r0
                : (size_t)bb * a.nseg * a.seg + row0;
    const int rows = min(TR, a.seg - r0);
    unsigned char* ks = ring + st * stage_bytes;
    unsigned char* vs = ks + TR * kvs;
#pragma unroll
    for (int r = l_r; r < TR; r += RSTEP) {
      const bool ok = r < rows;
      const size_t off =
          ((base + (ok ? r : 0)) * a.hkv + hh) * (size_t)d * sizeof(KV) +
          l_cc * 16;
      cp16(ks + r * kvs + l_cc * 16, kg + off, ok);
      cp16(vs + r * kvs + l_cc * 16, vg + off, ok);
    }
    if (QUANT && tid < TR) {
      float* sc = reinterpret_cast<float*>(vs + TR * kvs);
      const bool ok = tid < rows;
      const size_t so = (base + (ok ? tid : 0)) * a.hkv + hh;
      cp4(sc + tid, a.k_scale + so, ok);
      cp4(sc + TR + tid, a.v_scale + so, ok);
    }
  };

  // the query rows once (rows past R zero), in the first commit group
  for (int r = tid / (d / 8); r < RPAD; r += 8) {
    const int cc = tid % (d / 8);
    const bool ok = r < R;
    const int rr = ok ? r : 0, ti = rr / a.g, gi = rr - ti * a.g;
    cp16(qsm + r * qstr + cc * 16,
         a.q + (((size_t)bb * a.t + ti) * a.hkv * a.g + hh * a.g + gi) * d +
             cc * 8,
         ok);
  }
  for (int t = 0; t < a.nst - 1; ++t) {
    if (t < n_all) load_tile(t, t);
    cp_commit();
  }

  // the partials: m, l (B, Hkv, n_splits, R4) with R4 = R rounded up to
  // 4 (16-byte rows), then acc (.., R, D); and the rows' running maxima
  // after the tickets
  const int R4 = (R + 3) & ~3;
  const size_t per = (size_t)gridDim.z * a.hkv * n_splits * R4;
  float* m0 = a.ws + (size_t)bh * n_splits * R4;  // (split, row)
  float* l0 = m0 + per;
  float* a0 = a.ws + 2 * per + (size_t)bh * n_splits * R * d;
  unsigned* mxs = a.tickets + gridDim.z * a.hkv + bh * ROWS_MAXR;
  const bool direct = n_live == 1;   // the only live split writes the output

  // a live split with no tile in any row's mask (gapped, windowed) has the
  // empty partial
  for (int j = j_lo; j <= j_hi; ++j)
    if (run_o[j + 1] == run_o[j] && !direct) {
      const int s = q + cl * j;
      for (int i = tid; i < R * d; i += blockDim.x)
        a0[(size_t)s * R * d + i] = 0.f;
      for (int r = tid; r < R; r += blockDim.x) {
        m0[s * R4 + r] = NEG;
        l0[s * R4 + r] = 0.f;
      }
    }
  if (direct && n_all == 0)
    for (int i = tid; i < R * d; i += blockDim.x)
      out_row_of(a, bb, hh, i / d)[i % d] = __float2bfloat16(0.f);

  // score layout: lane (g8, q4) holds rows g8 and g8 + 8 of each m tile,
  // kv columns 2*q4, 2*q4 + 1 of each n8 tile; per row its last visible
  // position (-2^30 past R) and the last it does not see (the window's)
  const int g8 = lane >> 2, q4 = lane & 3;
  int vis_hi[MT][2], vis_lo[MT][2];
  float m_st[MT][2], l_st[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + h * 8 + g8;
      const int rp = p0 + (r < R ? r / a.g : 0);
      vis_hi[mt][h] = r < R ? rp : -(1 << 30);
      vis_lo[mt][h] = a.window > 0 ? rp - a.window : -(1 << 30);
      m_st[mt][h] = NEG;
      l_st[mt][h] = 0.f;
    }
  const float sl2 = a.scale * LOG2E;
  // P.V layout: lane (rl, cl) holds rows rl + 2i, columns col0, col0 + 1
  const int rl = lane >> 4, col0 = warp * 32 + (lane & 15) * 2;
  const int pairs = (R + 1) >> 1;                // row pairs holding a row
  float acc[8 * MT][2];
#pragma unroll
  for (int i = 0; i < 8 * MT; ++i) acc[i][0] = acc[i][1] = 0.f;

  int jc = 0;                                    // the consumer's split
  for (int t = 0; t < n_all; ++t) {
    cp_wait_upto(a.nst - 2);
    __syncthreads();                  // tile t staged, tile t-1 consumed
    if (t + a.nst - 1 < n_all)
      load_tile(t + a.nst - 1, (t + a.nst - 1) % a.nst);
    cp_commit();
    while (t >= run_o[jc + 1]) ++jc;
    int jseg, r0;
    const int row0 =
        tile_at(q + cl * jc, run_k[jc] + t - run_o[jc], jseg, r0);
    const int rows = min(TR, a.seg - r0);
    const unsigned char* ks = ring + (t % a.nst) * stage_bytes;
    const unsigned char* vs = ks + TR * kvs;
    const float* sc = reinterpret_cast<const float*>(vs + TR * kvs);
    int kbs = kvs;                    // bytes a bf16 K / V row read below
    if constexpr (QUANT) {
      // int8 K and V rows widened to bf16 once for every warp (exact:
      // |x| <= 127); the scales stay with the stage
      const int cpr = d / 16;                    // 16-byte chunks a row
#pragma unroll 1
      for (int i = tid; i < 2 * TR * cpr; i += blockDim.x) {
        const int which = i >= TR * cpr, ii = i - which * TR * cpr;
        const int r = ii / cpr, cc = ii - r * cpr;
        const uint4 raw = *reinterpret_cast<const uint4*>(
            (which ? vs : ks) + r * kvs + cc * 16);
        uint4* dst = reinterpret_cast<uint4*>(wide + which * TR * wstr +
                                              r * wstr + cc * 32);
        dst[0] = make_uint4(widen2((uint16_t)(raw.x & 0xffffu)),
                            widen2((uint16_t)(raw.x >> 16)),
                            widen2((uint16_t)(raw.y & 0xffffu)),
                            widen2((uint16_t)(raw.y >> 16)));
        dst[1] = make_uint4(widen2((uint16_t)(raw.z & 0xffffu)),
                            widen2((uint16_t)(raw.z >> 16)),
                            widen2((uint16_t)(raw.w & 0xffffu)),
                            widen2((uint16_t)(raw.w >> 16)));
      }
      __syncthreads();
      ks = wide;
      vs = wide + TR * wstr;
      kbs = wstr;
    }

    // S = Q K^T on the tensor cores, every warp the whole tile
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        s[mt][nt][0] = s[mt][nt][1] = s[mt][nt][2] = s[mt][nt][3] = 0.f;
    for (int k0 = 0; k0 < d; k0 += 16) {
      uint32_t bf[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t r4[4];
        const int row = (nt + (lane >> 4)) * 8 + (lane & 7);
        ldsm_x4(r4, ks + row * kbs + (k0 + ((lane >> 3) & 1) * 8) * 2);
        bf[nt][0] = r4[0];
        bf[nt][1] = r4[1];
        bf[nt + 1][0] = r4[2];
        bf[nt + 1][1] = r4[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t af[4];
        ldsm_x4(af, qsm + (mt * 16 + (lane & 15)) * qstr +
                        (k0 + (lane >> 4) * 8) * 2);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma16816(s[mt][nt], af, bf[nt][0], bf[nt][1]);
      }
    }

    // the online softmax in registers, in log2 units: masks, the K scale
    // after the dot, the row max and sum over the quad, the probabilities
    // (times the V scale) and alpha into the warp's tile; a half of an m
    // tile with no query row is skipped
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (mt * 16 + h * 8 >= R) continue;
        const int r = mt * 16 + h * 8 + g8;
        const int hi = min(vis_hi[mt][h] - row0, rows - 1);
        const int lo = vis_lo[mt][h] - row0;
        float mx = NEG;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int jj = nt * 8 + 2 * q4 + e;
            float x = s[mt][nt][2 * h + e];
            if (QUANT) x = __fmul_rn(x, sc[jj]);
            x = jj <= hi && jj > lo ? __fmul_rn(x, sl2) : NEG;
            s[mt][nt][2 * h + e] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
        const float mn = fmaxf(m_st[mt][h], mx);
        const float alpha = ex2_diff(m_st[mt][h], mn);
        float ts = 0.f;
        float* prow = pw + r * PS;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float pe[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = s[mt][nt][2 * h + e];
            const float p = ex2(__fsub_rn(x, mn));
            pe[e] = x <= NEG * 0.5f ? 0.f : p;
            ts = __fadd_rn(ts, pe[e]);
            if (QUANT) pe[e] = __fmul_rn(pe[e], sc[TR + nt * 8 + 2 * q4 + e]);
          }
          *reinterpret_cast<float2*>(prow + nt * 8 + 2 * q4) =
              make_float2(pe[0], pe[1]);
        }
        ts = __fadd_rn(ts, __shfl_xor_sync(FULL, ts, 1));
        ts = __fadd_rn(ts, __shfl_xor_sync(FULL, ts, 2));
        l_st[mt][h] = __fadd_rn(__fmul_rn(l_st[mt][h], alpha), ts);
        m_st[mt][h] = mn;
        if (q4 == 0) prow[TR] = alpha;
      }
    __syncwarp();

    // O = O * alpha + P V in float32, kv rows in order: the lane's two
    // columns of the tile's V rows (held in registers at MT 1), row pair
    // by row pair
    constexpr bool VREG = MT == 1;
    uint32_t vp[VREG ? TR : 1];
    auto v_at = [&](int j) {
      return ld_pair(reinterpret_cast<const __nv_bfloat16*>(vs + j * kbs) +
                     col0);
    };
    if constexpr (VREG) {
#pragma unroll
      for (int j = 0; j < TR; ++j) vp[j] = v_at(j);
    }
#pragma unroll
    for (int i = 0; i < 8 * MT; ++i) {
      if (i >= pairs) break;
      const float* prow = pw + (rl + 2 * i) * PS;
      const float al = prow[TR];
      float o0 = __fmul_rn(acc[i][0], al), o1 = __fmul_rn(acc[i][1], al);
#pragma unroll
      for (int j = 0; j < TR; j += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(prow + j);
        const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 vv = unpack(VREG ? vp[VREG ? j + u : 0]
                                         : v_at(j + u));
          o0 = __fmaf_rn(pj[u], vv.x, o0);
          o1 = __fmaf_rn(pj[u], vv.y, o1);
        }
      }
      acc[i][0] = o0;
      acc[i][1] = o1;
    }

    if (t == run_o[jc + 1] - 1) {     // the split's last tile: its partial
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (q4 == 0) {
            float* prow = pw + (mt * 16 + h * 8 + g8) * PS;
            prow[TR + 1] = m_st[mt][h];
            prow[TR + 2] = l_st[mt][h];
          }
          m_st[mt][h] = NEG;
          l_st[mt][h] = 0.f;
        }
      __syncwarp();
      const int s = q + cl * jc;
#pragma unroll
      for (int i = 0; i < 8 * MT; ++i) {
        const int r = rl + 2 * i;
        if (r < R) {
          if (direct) {               // the combine of one split: acc / l
            float lt = pw[r * PS + TR + 2];
            lt = lt == 0.f ? 1.f : lt;
            *reinterpret_cast<__nv_bfloat162*>(out_row_of(a, bb, hh, r) +
                                               col0) =
                __floats2bfloat162_rn(__fdiv_rn(acc[i][0], lt),
                                      __fdiv_rn(acc[i][1], lt));
          } else {
            *reinterpret_cast<float2*>(a0 + ((size_t)s * R + r) * d + col0) =
                make_float2(acc[i][0], acc[i][1]);
            if (warp == 0 && (lane & 15) == 0) {
              const float mr = pw[r * PS + TR + 1];
              m0[s * R4 + r] = mr;
              l0[s * R4 + r] = pw[r * PS + TR + 2];
              atomicMax(mxs + r, order_of(mr));
            }
          }
        }
        acc[i][0] = acc[i][1] = 0.f;
      }
    }
  }
  cp_wait<0>();
  if (direct) return;

  // the ticket: the last of the min(CL, n_live) blocks with a live split
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (tid == 0)
    is_last = atomicAdd(a.tickets + bh, 1u) == (unsigned)(min(cl, n_live) - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // The last block merges the live splits in split order (reference
  // `_combine`): chunks of CH splits' partials (acc, m, l) staged by 1-D
  // bulk copies on an mbarrier (two buffers where they fit: more, smaller
  // ones were slower on the H100), each split's weights 2^(m - M) under
  // the rows' maxima M, the weighted l summed by one thread a row, the
  // weighted acc by a thread a (row group, 4 columns).
  float* fsm = reinterpret_cast<float*>(rsm);
  float* mrow = fsm;                               // (RPAD,) the maxima
  float* lts = fsm + RPAD;                         // (RPAD,) the weighted l
  uint64_t* bars = reinterpret_cast<uint64_t*>(fsm + 2 * RPAD);  // 2
  const int unit = R * d + 2 * R4;                 // floats a split
  const int avail =
      rows_launch_bytes(QUANT, MT, TR, d, a.nst, a.c, spb) / 4 - 2 * RPAD - 4;
  int nb = 2, csz = (avail - 4) / (2 * unit + RPAD);
  if (csz < 1) {
    nb = 1;
    csz = (avail - 4) / (unit + RPAD);
  }
  float* wts = fsm + 2 * RPAD + 4;                 // (CH, RPAD) the weights
  float* bufs = wts + csz * RPAD;                  // nb x (acc, m, l)
  const int stage_f = csz * unit;                  // floats a buffer
  for (int r = tid; r < R; r += blockDim.x) {
    mrow[r] = float_of(__ldcg(mxs + r));
    lts[r] = 0.f;
  }
  if (tid == 0) {
    for (int i = 0; i < nb; ++i) hop::bar_init(hop::smem_u32(bars + i));
    // the barriers, and the other blocks' partials (acquired with the
    // ticket), are the async proxy's before the bulk copies read them
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async;\n" ::: "memory");
  }
  __syncthreads();
  const int n_chunks = (n_live + csz - 1) / csz;
  auto fetch = [&](int cn) {           // thread 0
    if (cn >= n_chunks) return;
    const int sa = s_lo + cn * csz, n = min(csz, s_hi + 1 - sa);
    float* buf = bufs + (cn % nb) * stage_f;
    const uint32_t bar = hop::smem_u32(bars + cn % nb);
    hop::bar_expect(bar, (n * R * d + 2 * n * R4) * 4);
    hop::bulk_1d(hop::smem_u32(buf), a0 + (size_t)sa * R * d,
                 n * R * d * 4, bar);
    hop::bulk_1d(hop::smem_u32(buf + csz * R * d), m0 + sa * R4,
                 n * R4 * 4, bar);
    hop::bulk_1d(hop::smem_u32(buf + csz * R * d + csz * R4), l0 + sa * R4,
                 n * R4 * 4, bar);
  };
  if (tid == 0)
    for (int cn = 0; cn < nb; ++cn) fetch(cn);
  const int c4 = tid % (d / 4), rg = tid / (d / 4);    // 4 row groups
  float4 o4[RPAD / 4];
#pragma unroll
  for (int i = 0; i < RPAD / 4; ++i) o4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int cn = 0; cn < n_chunks; ++cn) {
    hop::bar_wait(hop::smem_u32(bars + cn % nb), (cn / nb) & 1);
    const int sa = s_lo + cn * csz, n = min(csz, s_hi + 1 - sa);
    const float* buf = bufs + (cn % nb) * stage_f;
    const float* bm = buf + csz * R * d;
    const float* bl = bm + csz * R4;
    for (int i = tid; i < n * R; i += blockDim.x) {
      const int sj = i / R, r = i - sj * R;
      const float m = bm[sj * R4 + r];
      wts[sj * RPAD + r] = m <= NEG * 0.5f ? 0.f : ex2_diff(m, mrow[r]);
    }
    __syncthreads();
    for (int r = tid; r < R; r += blockDim.x) {
      float lt = lts[r];
      for (int sj = 0; sj < n; ++sj)
        lt = __fadd_rn(lt, __fmul_rn(bl[sj * R4 + r], wts[sj * RPAD + r]));
      lts[r] = lt;
    }
    for (int sj = 0; sj < n; ++sj) {
#pragma unroll
      for (int i = 0; i < RPAD / 4; ++i) {
        const int r = rg + 4 * i;
        const int rc = r < R ? r : R - 1;
        const float4 v =
            *reinterpret_cast<const float4*>(buf + (sj * R + rc) * d + 4 * c4);
        const float w = r < R ? wts[sj * RPAD + r] : 0.f;
        o4[i].x = __fadd_rn(o4[i].x, __fmul_rn(v.x, w));
        o4[i].y = __fadd_rn(o4[i].y, __fmul_rn(v.y, w));
        o4[i].z = __fadd_rn(o4[i].z, __fmul_rn(v.z, w));
        o4[i].w = __fadd_rn(o4[i].w, __fmul_rn(v.w, w));
      }
    }
    __syncthreads();                  // the buffer and weights are consumed
    if (tid == 0) fetch(cn + nb);
  }
  for (int r = tid; r < R; r += blockDim.x)
    if (lts[r] == 0.f) lts[r] = 1.f;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RPAD / 4; ++i) {
    const int r = rg + 4 * i;
    if (r < R) {
      const float li = lts[r];
      const __nv_bfloat162 lo = __floats2bfloat162_rn(__fdiv_rn(o4[i].x, li),
                                                      __fdiv_rn(o4[i].y, li));
      const __nv_bfloat162 hi = __floats2bfloat162_rn(__fdiv_rn(o4[i].z, li),
                                                      __fdiv_rn(o4[i].w, li));
      uint2 pk;
      pk.x = *reinterpret_cast<const uint32_t*>(&lo);
      pk.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(out_row_of(a, bb, hh, r) + 4 * c4) = pk;
    }
  }
  for (int r = tid; r < R; r += blockDim.x) mxs[r] = 0u;
  if (tid == 0) a.tickets[bh] = 0u;
}

template <typename KV, int MT, int TR>
int launch_rows(const RowsArgs& a, int b, int cl, cudaStream_t st) {
  const int smem = rows_launch_bytes(sizeof(KV) == 1, MT, TR, a.d, a.nst, a.c,
                                     a.spb);
  if (smem > ROWS_SMEM) return (int)cudaErrorInvalidValue;
  static bool raised[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !raised[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        rows_kernel<KV, MT, TR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        ROWS_SMEM);
    if (e != cudaSuccess) return (int)e;
    raised[dev] = true;
  }
  rows_kernel<KV, MT, TR><<<dim3(cl, a.hkv, b), a.d, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename KV>
int launch_rows_kv(const RowsArgs& a, int b, int cl, cudaStream_t st) {
  // stages of 32 kv rows where they tile the segment, else 16 (and 16 for
  // more than 32 query rows, whose registers hold no more)
  const int rr = a.t * a.g;
  const bool wide = a.seg % 32 == 0;
  if (rr <= 16)
    return wide ? launch_rows<KV, 1, 32>(a, b, cl, st)
                : launch_rows<KV, 1, 16>(a, b, cl, st);
  if (rr <= 32)
    return wide ? launch_rows<KV, 2, 32>(a, b, cl, st)
                : launch_rows<KV, 2, 16>(a, b, cl, st);
  return launch_rows<KV, 4, 16>(a, b, cl, st);
}

// `split_kv_instance`
struct Instance {
  const char* name;
  const void* fn;
};
#define RKI(KV_, MT_, TR_)                                     \
  {"rows_kernel<" #KV_ ", " #MT_ ", " #TR_ ">",                \
   (const void*)rows_kernel<KV_, MT_, TR_>}
const Instance kRowsInstances[] = {
    RKI(__nv_bfloat16, 1, 16), RKI(__nv_bfloat16, 1, 32),
    RKI(__nv_bfloat16, 2, 16), RKI(__nv_bfloat16, 2, 32),
    RKI(__nv_bfloat16, 4, 16), RKI(int8_t, 1, 16),
    RKI(int8_t, 1, 32),        RKI(int8_t, 2, 16),
    RKI(int8_t, 2, 32),        RKI(int8_t, 4, 16)};
#undef RKI

}  // namespace

// The contiguous-cache decode kernel (paged = 0, T = 1, seg = bkv, nseg =
// S / bkv, block_table and n_pages unused) and the paged kernel (paged =
// 1, seg = page size, nseg = pages a slot; T = 1 for paged decode, T
// drafted rows for verify), bf16 caches or, with
// quant = 1, int8 caches with f32 scales (rows x Hkv).  pos0 is (B,).  The
// nseg / c splits of a (slot, kv head) run on cl blocks of spb splits
// each; ws holds 2*B*Hkv*n_splits*R4 floats (R4: R rounded up to 4), then
// B*Hkv*n_splits*R*D; tickets B*Hkv*(1 + 64) zeros, which the kernel
// leaves zero; nst ring stages (2-4).
extern "C" int split_kv_attention(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* block_table, const void* pos0, void* ws,
    void* tickets, void* out, int quant, int paged, int b, int hkv, int g,
    int t, int d, int n_pages, int seg, int nseg, int c, int gapped,
    int window, int nst, int cl, int spb, float scale, void* stream) {
  if (g < 1 || t < 1 || t * g > ROWS_MAXR || d % 32 || d < 32 ||
      d > ROWS_MAXD || c < 1 || seg < 1 || nseg % c || nst < 2 || nst > 4 ||
      cl < 1 || spb < 1 || cl * spb * c != nseg)
    return (int)cudaErrorInvalidValue;
  RowsArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = k;
  a.v = v;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.block_table = static_cast<const int*>(block_table);
  a.pos0 = static_cast<const int*>(pos0);
  a.ws = static_cast<float*>(ws);
  a.tickets = static_cast<unsigned*>(tickets);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.paged = paged;
  a.n_pages = n_pages;
  a.seg = seg;
  a.nseg = nseg;
  a.hkv = hkv;
  a.g = g;
  a.t = t;
  a.d = d;
  a.c = c;
  a.gapped = gapped;
  a.window = window;
  a.nst = nst;
  a.spb = spb;
  a.scale = scale;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return quant ? launch_rows_kv<int8_t>(a, b, cl, st)
               : launch_rows_kv<__nv_bfloat16>(a, b, cl, st);
}

// (name, local bytes a thread, registers) of rows kernel instance i, read
// from the loaded module; -1 past the last
extern "C" int split_kv_instance(int i, char* name, int cap,
                                 int* local_bytes, int* regs) {
  if (i < 0 || i >= (int)(sizeof(kRowsInstances) / sizeof(kRowsInstances[0])))
    return -1;
  snprintf(name, cap, "%s", kRowsInstances[i].name);
  cudaFuncAttributes at;
  const cudaError_t e = cudaFuncGetAttributes(&at, kRowsInstances[i].fn);
  if (e != cudaSuccess) return (int)e;
  *local_bytes = (int)at.localSizeBytes;
  *regs = at.numRegs;
  return 0;
}
