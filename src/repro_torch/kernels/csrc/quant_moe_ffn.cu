// Dequant-fused grouped-expert MoE FFN for Hopper (sm_90a).
//
// Replaces the Pallas kernel `repro/kernels/moe_ffn.py` `make_qkernel`
// (:110; its pl.pallas_call at :190).  Per expert e of the padded
// dispatch buffer:
//   y[e] = ((silu(x[e] @ w1[e]) * (x[e] @ w3[e])) @ w2[e]) * comb[e][:, None]
// with x (E, C, d) bf16, comb (E, C) f32, y (E, C, d) f32 and the three
// panes packed: int8 with one f32 scale a column (scales (E, 1, F) and
// (E, 1, d)), or int4 nibbles packed two to a byte along the contraction
// axis (offset-binary, even rows in the low nibble) with one scale a group
// of `group` rows (scales (E, d/group, F) and (E, F/group, d)).  h is kept
// in f32 as the Pallas kernel keeps it (:160-167).
//
// Bound on this card: the packed bytes of the LIVE experts (an expert whose
// combine weights are all 0 has y exactly 0 and reads no weight byte), the
// live rows of x, comb and the whole f32 y, at 3.35 TB/s.  At qwen2-moe's
// widths (E 64, d 2048, F 1408) an expert's three int4 panes are 4.4 MB
// (with scales) and a prefill chunk (C 128) or a decode step (C 8) holds a
// few live rows an expert: both are far below the tensor-core ridge, and
// the kernel must keep the weight streaming on every SM.
//
// Two launches, pass A: h = silu(x@w1) * (x@w3) and pass B:
// y = (h @ w2) * comb, each a persistent kernel of one block an SM (two
// consumer warpgroups at 224 registers, a producer warpgroup of which one
// warp works):
//
// * Work items.  An item is (expert group i, column tile): the block owns
//   `degree` experts of the group, adjacent (consecutive: e = i*degree+j)
//   or E/degree apart (gapped: e = j*(E/degree)+i), as the Pallas views
//   (:174-187) do, and 64 columns of F (pass A: the same 64 of w1 and w3)
//   or 128 columns of d (pass B: two 64-column halves of w2; where
//   d % 128 == 64 the last item's second half is past d and idle).  Blocks
//   take items from a counter (zeroed before each pass); every output
//   element belongs to one item and is summed in one fixed order by one
//   block: no atomics on data, the same bits on every run.
// * The transposed products C^T = W^T X^T, as the dequant-fused matmul
//   (`quant_matmul.cu`) does: a consumer warpgroup owns 64 weight columns
//   as wgmma's M side, its A operand widened in registers (exact in bf16)
//   from ldmatrix.trans of the raw int8 / int4 bytes; the expert's live
//   rows are the N side, read from shared memory by descriptor, one
//   m64n16 product a 16-row tile (m64n8 where one tile holds at most 8
//   rows, as at C 8).  The producer finds the live 16-row tiles of each
//   expert from comb on the device (no host sync; live rows need not
//   lead) and stages only those, in chunks of up to 4 tiles: the weight is
//   read once an expert up to 64 live rows.
// * A ring sized in bytes, and few copies.  On this card a TMA copy costs
//   the issuing SM about the same time whatever its size (at 64 K rows a
//   stage the copies, not the bytes, held the first version of this
//   kernel; `PERF.md`), so a stage is 128 K rows (int4's pass A: 256, so
//   that its weight boxes hold 8 KB, as int8's do) in as few boxes as the
//   layouts allow: pass A's w1 and w3 tiles (64 columns, 64-byte swizzle),
//   pass B's two halves of w2 as one 128-byte-swizzled box; each live row
//   tile one box (pass A: a 3-D view of x, its 64-column chunks; pass B: a
//   4-D view of the h planes, hi's and lo's chunks); int4's scale rows one
//   box a stream (pass B one).  One producer warp fills the ring on full /
//   empty mbarriers and writes each stage a header (expert, columns,
//   tiles) that the consumers read; the ring runs across experts and items
//   without draining.  The stage count comes from the planner
//   (`kernels/moe_ffn.py` `plan`): as many stages as 227 KB hold at the
//   stage's bytes.  At qwen2-moe's widths and C 128: int8 6 / 4 stages
//   (passes A / B), 80 / 48 KB of packed weight in flight an SM; int4 4 /
//   5, 48 / 32 KB; at C 8 (one tile a chunk) int8 10 / 9, int4 7 / 12.
// * Scales off the critical path.  int8: the column scale once, in the
//   epilogue.  int4: the products of P groups in turn go to P group
//   accumulators (four where one or two tiles leave the registers, else
//   two), then one `wgmma.wait_group 0` and P folds acc += s * acc_g, s
//   staged with its tile: a drain every P groups.  Folding one group
//   behind after `wait_group 1`, which would overlap a fold with the next
//   group's products, makes ptxas serialise every wgmma of the kernel
//   (C7514: an accumulator read inside the pipeline); measured slower
//   (`repro_torch.bench.moe_ab --cuts-this`).
// * h stays f32 in value: pass A writes it as two bf16 planes, hi = bf16(h)
//   and lo = bf16(h - hi) (2^-17 of h), and pass B multiplies both against
//   one widened weight fragment into one accumulator.
// * Dead work.  An expert or a 16-row tile whose combine weights are all 0
//   is never staged; pass B's producer writes its zeros of y.  A stage's K
//   rows run in steps of 64 with two fragment buffers taken in turn; a
//   stage's rows past K (K not a whole number of stages) add 0: its x / h
//   boxes there are TMA's zero fill.
//
// Fragment layouts (PTX ISA, lane = 4g + t), as in `quant_matmul.cu`: warp
// q of a warpgroup holds A rows 16q..16q+15 with A row g = weight column
// 16q + 2g and A row g+8 = column 16q + 2g + 1; a tile's accumulator
// register 4j+v holds (column 16q + 2g + (v >> 1), row 8j + 2t + (v & 1))
// of the tile.  TMA swizzles a weight row of RB bytes (64 or 128): 16-byte
// chunk c of the row at byte o holds chunk c ^ ((o >> 7) & (RB/16 - 1));
// the x / h chunks (128-byte rows) with wgmma's 128-byte swizzle.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "hopper.cuh"

namespace qmoe {

using namespace hop;

constexpr int HK = 64;               // K rows a step (one fragment buffer)
constexpr int WN = 64;               // weight columns a consumer warpgroup
constexpr int TILE = 16;             // rows of a staged x / h tile
constexpr int CHUNK = TILE * 64 * 2; // its 64 columns: one swizzled block
constexpr int NT_MAX = 4;            // live tiles a chunk: 64 rows
constexpr int MAX_STAGES = 32;
constexpr int THREADS = 3 * 128;     // two consumer warpgroups, a producer's
// setmaxnreg: every warp enters with ENTRY registers (what __launch_bounds__
// leaves of the SM's 64 K), the producer warpgroup hands some back and the
// consumers take no more than it handed back
constexpr int ENTRY = 65536 / THREADS / 8 * 8;
constexpr int REG_C = 224, REG_P = 56;
static_assert((REG_C - ENTRY) * 2 <= ENTRY - REG_P, "register budgets");
constexpr int XCHG = NT_MAX * TILE / 2 * 128 * 4;   // pass A: WG 1's sums
constexpr int HDR = 32;              // bytes of a stage header: expert,
                                     // columns, N code (-1: no more work),
                                     // the live tiles (16 bits each)
constexpr int SMEM_MAX = 227 * 1024;


struct Params {
  const float* comb;                 // (E, C)
  const float* s[2];                 // int8 column scales of the two streams
  void* out;                         // A: h planes (2, E*C, F) bf16; B: y
  int* counter;                      // the pass's item counter, zeroed
  int e, c, k, n;                    // experts, rows, contraction, width
  int group;                         // int4 rows a scale (0 at int8)
  int degree, gapped;
  int col_tiles, items;              // column tiles an expert group; items
  int stage_bytes, stages, srows, nt_cap;   // the planner's ring
};

__device__ __forceinline__ void ldsm4_t(uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3,
                                        uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// 4 int8 bytes r = (x0, x1, x2, x3) -> bf16 pairs (x0, x2) and (x1, x3),
// exact: 2^23 + (x + 128) is an f32 whose low byte is the offset-binary
// byte; subtracting 2^23 + 128 leaves x, whose upper half is its bf16
__device__ __forceinline__ void widen_i8(uint32_t r, uint32_t& p02,
                                         uint32_t& p13) {
  const uint32_t u = r ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)) -
           8388736.f;
  p02 = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[2]), 0x7632);
  p13 = __byte_perm(__float_as_uint(f[1]), __float_as_uint(f[3]), 0x7632);
}

// the 4 bytes of r (two offset-binary nibbles each) -> bf16 pairs (lo - 8,
// hi - 8), exact: the nibbles masked once a word; then a byte's lo to byte
// 0 and hi to byte 2 (one permute), bytes 1 and 3 set to 0x43 (one lop3:
// bf16 0x4300 | n is 128 + n), and 136 = 0x4308 subtracted from both
__device__ __forceinline__ void widen_i4(uint32_t r, uint32_t (&o)[4]) {
  const uint32_t lo = r & 0x0F0F0F0Fu, hi = (r >> 4) & 0x0F0F0F0Fu;
  const uint32_t c = 0x43084308u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t w =
        (__byte_perm(lo, hi, i | i << 4 | (4 + i) << 8 | (4 + i) << 12) &
         0x00FF00FFu) |
        0x43004300u;
    const __nv_bfloat162 d = __hsub2(
        *reinterpret_cast<const __nv_bfloat162*>(&w),
        *reinterpret_cast<const __nv_bfloat162*>(&c));
    o[i] = *reinterpret_cast<const uint32_t*>(&d);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

// a pass's stage of BK K rows (int4's pass A 256, so that its weight boxes
// are 8 KB as int8's are; else 128): both streams' packed weight tiles
// (pass A: two boxes of 64-byte rows; pass B: one box of 128-byte rows),
// then nt_cap row tiles of TB bytes (x: its BK/64 64-column chunks; h:
// hi's, then lo's), then the int4 scale rows (pass A: two boxes of
// SRB-byte rows; pass B: one)
template <int PASS, int BITS>
struct Geo {
  static constexpr int BK = PASS == 0 && BITS == 4 ? 256 : 128;
  static constexpr int STEPS = BK / HK;                   // steps a stage
  static constexpr int W_ROWS = BITS == 8 ? BK : BK / 2;  // rows a box
  static constexpr int RB = PASS == 0 ? WN : 2 * WN;      // bytes a row
  static constexpr int W_BYTES = 2 * W_ROWS * WN;         // both streams
  static constexpr int TB = (PASS == 0 ? 1 : 2) * STEPS * CHUNK;  // a tile
  static constexpr int SRB = PASS == 0 ? WN * 4 : 2 * WN * 4;
};

// shared-memory layout from a 1 KB aligned base: the ring (stages x
// stage_bytes), pass A's exchange of WG 1's sums, the stage headers, the
// full and empty mbarriers
struct Layout {
  uint32_t ring, xchg, hdr, full, empty;
  __device__ Layout(uint32_t base, const Params& p, int pass) {
    ring = base;
    xchg = ring + p.stages * p.stage_bytes;
    hdr = xchg + (pass == 0 ? XCHG : 0);
    full = hdr + p.stages * HDR;
    empty = full + 8 * p.stages;
  }
};

template <int PASS, int BITS>
__device__ __forceinline__ int s_off(const Params& p) {
  using G = Geo<PASS, BITS>;
  return G::W_BYTES + p.nt_cap * G::TB;
}

// the expert of item group i, j-th of its `degree`
__device__ __forceinline__ int expert(const Params& p, int i, int j) {
  return p.gapped ? j * (p.e / p.degree) + i : i * p.degree + j;
}

// -- the producer warp -------------------------------------------------------
// wait until stage `it % stages` is free again; returns it
__device__ __forceinline__ int acquire(const Layout& L, int stages, int it) {
  const int st = it % stages;
  bar_wait(L.empty + 8 * st, ((it / stages) & 1) ^ 1);
  return st;
}

template <int PASS, int BITS>
__device__ __forceinline__ void produce(
    const CUtensorMap* tx, const CUtensorMap* tw0, const CUtensorMap* tw1,
    const CUtensorMap* ts0, const CUtensorMap* ts1, const Params& p,
    const Layout& L, uint8_t* hdr_gen) {
  using G = Geo<PASS, BITS>;
  constexpr int BK = G::BK;
  const int lane = threadIdx.x & 31;
  const int ntiles = (p.c + TILE - 1) / TILE;
  const int kr = BITS == 8 ? p.k : p.k / 2;        // packed rows an expert
  const int kpad = (p.k + BK - 1) / BK * BK;       // K in whole stages
  int it = 0;                                      // stages filled so far
  for (;;) {
    int item = 0;
    if (lane == 0) item = atomicAdd(p.counter, 1);
    item = __shfl_sync(0xffffffffu, item, 0);
    if (item >= p.items) break;
    const int i = item / p.col_tiles, ct = item % p.col_tiles;
    const int n0 = ct * (PASS == 0 ? WN : 2 * WN);
    for (int j = 0; j < p.degree; ++j) {
      const int e = expert(p, i, j);
      const float* cw = p.comb + (size_t)e * p.c;
      uint64_t tl = 0;               // a chunk's live tiles, 16 bits each
      int nt = 0;
      for (int b0 = 0; b0 < ntiles; b0 += 32) {
        const int tile = b0 + lane;
        bool live = false;
        if (tile < ntiles) {
          const int r1 = min(p.c, TILE * tile + TILE);
          for (int r = TILE * tile; r < r1; ++r) live |= cw[r] != 0.f;
        }
        unsigned m = __ballot_sync(0xffffffffu, live);
        const bool last = b0 + 32 >= ntiles;
        if (PASS == 1) {
          // y rows of the dead tiles: zeros, 128 columns = a float4 a lane
          unsigned dead = ~m & (last && ntiles - b0 < 32
                                    ? (1u << (ntiles - b0)) - 1u
                                    : 0xffffffffu);
          while (n0 + 4 * lane < p.n && dead) {
            const int td = b0 + __ffs(dead) - 1;
            dead &= dead - 1;
            const int r1 = min(p.c, TILE * td + TILE);
            for (int r = TILE * td; r < r1; ++r)
              *reinterpret_cast<float4*>(
                  static_cast<float*>(p.out) +
                  ((size_t)e * p.c + r) * p.n + n0 + 4 * lane) =
                  make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
        for (;;) {
          while (m && nt < NT_MAX) {
            const int b = __ffs(m) - 1;
            m &= m - 1;
            tl |= (uint64_t)(b0 + b) << (16 * nt);
            ++nt;
          }
          if (nt == 0 || (nt < NT_MAX && !last)) break;
          // a chunk: every stage of its nt tiles.  Lane 0 alone waits on
          // the ring and issues (a lane spinning on an mbarrier must not
          // share a diverged warp with the issuer)
          const int t0 = (int)(tl & 0xffff);
          const int ncode = nt == 1 && p.c - TILE * t0 <= 8 ? 0 : nt;
          const int bytes = G::W_BYTES + nt * G::TB +
                            (BITS == 4 ? 2 * p.srows * WN * 4 : 0);
          for (int kk = 0; kk < kpad && lane == 0; kk += BK) {
            const int st = acquire(L, p.stages, it + kk / BK);
            int* h = reinterpret_cast<int*>(hdr_gen + st * HDR);
            h[0] = e;
            h[1] = n0;
            h[2] = ncode;
            h[3] = (int)(tl & 0xffffffffu);
            h[4] = (int)(tl >> 32);
            const uint32_t bar = L.full + 8 * st;
            const uint32_t sa = L.ring + st * p.stage_bytes;
            bar_expect(bar, bytes);
            const int wrow = e * kr + (BITS == 8 ? kk : kk / 2);
            tma_2d(sa, tw0, n0, wrow, bar);
            if (PASS == 0) tma_2d(sa + G::W_BYTES / 2, tw1, n0, wrow, bar);
            for (int q = 0; q < nt; ++q) {
              const int row =
                  e * p.c + TILE * (int)((tl >> (16 * q)) & 0xffff);
              const uint32_t dst = sa + G::W_BYTES + q * G::TB;
              if (PASS == 0) tma_3d(dst, tx, 0, row, kk / 64, bar);
              else tma_4d(dst, tx, 0, row, kk / 64, 0, bar);
            }
            if (BITS == 4) {
              const int srow = e * (p.k / p.group) + kk / p.group;
              const uint32_t ss = sa + s_off<PASS, BITS>(p);
              tma_2d(ss, ts0, n0, srow, bar);
              if (PASS == 0) tma_2d(ss + p.srows * G::SRB, ts1, n0, srow, bar);
            }
          }
          __syncwarp();
          it += kpad / BK;
          tl = 0;
          nt = 0;
        }
      }
    }
  }
  if (lane == 0) {
    const int st = acquire(L, p.stages, it);
    reinterpret_cast<int*>(hdr_gen + st * HDR)[2] = -1;
    bar_arrive(L.full + 8 * st);
  }
}

// -- the consumer warpgroups -------------------------------------------------
// acc += s * part, columns (col, col + 1) scaled by (s.x, s.y)
template <int NA>
__device__ __forceinline__ void fold(float (&acc)[NA], const float (&part)[NA],
                                     float2 s) {
#pragma unroll
  for (int j = 0; j < NA / 4; ++j) {
    acc[4 * j] += s.x * part[4 * j];
    acc[4 * j + 1] += s.x * part[4 * j + 1];
    acc[4 * j + 2] += s.y * part[4 * j + 2];
    acc[4 * j + 3] += s.y * part[4 * j + 3];
  }
}

// a consumer thread's sums over one chunk of NT tiles (NT 0: one tile of
// at most 8 rows): acc, and at int4 P group accumulators taken in turn
// with the scales of their groups (GS 0: two, and the one group awaiting
// its fold), the stage its wgmmas may still read
template <int NT, int P>
struct Sums {
  static constexpr int TILES = NT > 0 ? NT : 1;
  static constexpr int AN = NT > 0 ? 16 : 8;       // wgmma's N a tile
  float acc[TILES][AN / 2], g[P][TILES][AN / 2];
  float2 fs[P];
  int rel;                           // a stage awaiting release, or -1
  int gk, gi;                        // GS 0: row in the group, the group
  bool fpend, fsel;                  // GS 0: a group awaiting its fold, and
                                     // its accumulator (g[1] or g[0])
};

template <int NT, int P>
__device__ __forceinline__ void hold_all(Sums<NT, P>& S, bool groups) {
#pragma unroll
  for (int q = 0; q < Sums<NT, P>::TILES; ++q) {
    wg_hold(S.acc[q]);
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (groups) wg_hold(S.g[j][q]);
  }
}

// acc += s * g[j] on every tile
template <int NT, int P>
__device__ __forceinline__ void fold_group(Sums<NT, P>& S, int j, float2 s) {
#pragma unroll
  for (int q = 0; q < Sums<NT, P>::TILES; ++q) fold(S.acc[q], S.g[j][q], s);
}

// every staged tile's product of K step ks (the tiles TB bytes apart from
// xb; pass B: also lo, `steps` chunks on); keep 0 starts the sums afresh
template <int PASS, int TILES, int AN>
__device__ __forceinline__ void mma_tiles(float (&d)[TILES][AN / 2],
                                          const uint32_t (&a)[4], uint32_t xb,
                                          int tb, int steps, int ks,
                                          int keep) {
#pragma unroll
  for (int q = 0; q < TILES; ++q) {
    const uint64_t b = desc(xb + q * tb) + (uint64_t)(ks * 2);
    wgmma_rs<AN, 0>(d[q], a, b, keep);
    if (PASS == 1)
      wgmma_rs<AN, 0>(d[q], a, b + (uint64_t)((steps * CHUNK) >> 4), 1);
  }
}

// what a consumer thread needs of its place
struct Lane {
  int lane, wg, wcol, g, w_row;
};

// step HH (K rows 64 HH .. 64 HH + 63) of the stage at `sa`: widen this
// warpgroup's weight rows into `a` (the steps' two buffers alternate, so
// a widening never rewrites registers a wgmma in flight reads), multiply
// them against every staged tile.  GS: int4 groups of 16 * GS rows, GS in
// {1, 2, 4}, whose accumulator (of P, taken in turn) and ends are fixed by
// the K step's place in the stage (a stage holds whole sets of P groups),
// or 0: any group that tiles K, counted at run time (two accumulators).
template <int PASS, int BITS, int NT, int P, int GS, int HH>
__device__ __forceinline__ void step(Sums<NT, P>& S,
                                     uint32_t (&a)[HK / 16][4],
                                     uint32_t sa, int st, const Params& p,
                                     const Layout& L, const Lane& me,
                                     int& g0) {
  using G = Geo<PASS, BITS>;
  constexpr int TILES = Sums<NT, P>::TILES, AN = Sums<NT, P>::AN;
  // this lane's ldmatrix rows of the warpgroup's weight rows (k rows w_row
  // and 32 + w_row at int8), the warp's 16-byte chunk of each, swizzled
  const uint32_t sw = sa + (PASS == 0 ? me.wg * G::W_ROWS * WN : 0);
  const int cb = (PASS == 0 ? 0 : me.wg * WN) + me.wcol;
  const auto w_at = [&](int r) {
    const int o = r * G::RB + cb;
    return o ^ (((o >> 7) & (G::RB / 16 - 1)) << 4);
  };
  constexpr int R0 = HH * (BITS == 8 ? HK : HK / 2);   // the step's rows
  uint32_t wr[8];
  ldsm4_t(wr[0], wr[1], wr[2], wr[3], sw + w_at(R0 + me.w_row));
  if (BITS == 8)
    ldsm4_t(wr[4], wr[5], wr[6], wr[7], sw + w_at(R0 + 32 + me.w_row));
#pragma unroll
  for (int ks = 0; ks < HK / 16; ++ks) {
    if (BITS == 8) {
      widen_i8(wr[2 * ks], a[ks][0], a[ks][1]);
      widen_i8(wr[2 * ks + 1], a[ks][2], a[ks][3]);
    } else {
      widen_i4(wr[ks], a[ks]);
    }
  }
  // tile q's chunk of this step (pass B: hi, and lo STEPS chunks on)
  const uint32_t xb = sa + G::W_BYTES + HH * CHUNK;
  constexpr bool LAST = HH == G::STEPS - 1;        // the stage's last step
  const uint32_t ss = sa + s_off<PASS, BITS>(p) +
                      (PASS == 0 ? me.wg * p.srows * G::SRB : me.wg * WN * 4) +
                      (me.wcol + 2 * me.g) * 4;
  hold_all(S, BITS == 4);
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < HK / 16; ++ks) {
    const bool hend = ks == HK / 16 - 1;
    if constexpr (BITS == 8) {
      mma_tiles<PASS, TILES, AN>(S.acc, a[ks], xb, G::TB, G::STEPS, ks, 1);
      if (hend) {
        wg_commit();
        wg_wait<1>();                // the step before is read
        hold_all(S, false);
        if (HH == 0 && S.rel >= 0 && me.lane == 0)
          bar_arrive(L.empty + 8 * S.rel);
        S.rel = LAST ? st : -1;
      }
    } else if constexpr (GS > 0) {
      // K step q of the stage: its group, the group's accumulator of P
      // (taken in turn) and the group's ends are constants here
      const int qs = HH * (HK / 16) + ks;
      const int gj = (qs / GS) % P;
      const bool gend = (qs + 1) % GS == 0;
      mma_tiles<PASS, TILES, AN>(S.g[gj], a[ks], xb, G::TB, G::STEPS, ks,
                                 qs % GS);
      if (gend)                      // the group's scales, from its stage
        asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                     : "=f"(S.fs[gj].x), "=f"(S.fs[gj].y)
                     : "r"(ss + (qs / GS) * G::SRB));
      if (gend && gj == P - 1) {
        // P groups end: one drain, all folded (a stage holds whole sets of
        // P groups, so its last K step ends one and frees the stage)
        wg_commit();
        wg_wait<0>();
        hold_all(S, true);
#pragma unroll
        for (int jj = 0; jj < P; ++jj) fold_group(S, jj, S.fs[jj]);
        if (LAST && hend && me.lane == 0) bar_arrive(L.empty + 8 * st);
        hold_all(S, true);
        if (!hend) wg_fence();       // the fold read what wgmma rewrites
      }
    } else {
      if (S.gi & 1)
        mma_tiles<PASS, TILES, AN>(S.g[1], a[ks], xb, G::TB, G::STEPS, ks,
                                   S.gk);
      else
        mma_tiles<PASS, TILES, AN>(S.g[0], a[ks], xb, G::TB, G::STEPS, ks,
                                   S.gk);
      S.gk += 16;
      const bool gend = S.gk == p.group;
      if (gend || hend) {
        wg_commit();
        wg_wait<1>();                // all but this boundary's products
        hold_all(S, true);
        if (S.fpend) {
          if (S.fsel) fold_group(S, 1, S.fs[0]);
          else fold_group(S, 0, S.fs[0]);
          S.fpend = false;
        }
        if (S.rel >= 0 && me.lane == 0) bar_arrive(L.empty + 8 * S.rel);
        S.rel = LAST && hend ? st : -1;
        if (gend) {
          asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                       : "=f"(S.fs[0].x), "=f"(S.fs[0].y)
                       : "r"(ss + (S.gi - g0) * G::SRB));
          S.fpend = true;
          S.fsel = S.gi & 1;
          S.gk = 0;
          ++S.gi;
        }
        hold_all(S, true);
        if (!hend) wg_fence();
      }
    }
  }
}

// one chunk (an expert's live tiles) over all its stages, then its
// epilogue; `it` counts the stages consumed
template <int PASS, int BITS, int NT, int GS>
__device__ __forceinline__ void consume(const Params& p, const Layout& L,
                                        const uint8_t* hdr_gen, float* xchg,
                                        int& it) {
  using G = Geo<PASS, BITS>;
  // int4 groups of 16 * GS rows: P accumulators, four where registers
  // allow (one or two tiles), while a stage holds whole sets of P groups
  constexpr int PMAX = NT <= 2 ? 4 : 2, SET = GS > 0 ? G::STEPS * 4 / GS : 2;
  constexpr int P = GS == 0 ? 2 : (SET < PMAX ? SET : PMAX);
  constexpr int TILES = Sums<NT, P>::TILES, NA = Sums<NT, P>::AN / 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3;
  Lane me;
  me.lane = lane;
  me.wg = warp >> 2;
  me.wcol = (warp & 3) * 16;
  me.g = lane >> 2;
  me.w_row = BITS == 8 ? lane
                       : 8 * (lane >> 3) + ((lane & 7) >> 1) + 4 * (lane & 1);
  const int wg = me.wg, wcol = me.wcol, g = me.g;

  const int st0 = it % p.stages;
  bar_wait(L.full + 8 * st0, (it / p.stages) & 1);
  const int* h0 = reinterpret_cast<const int*>(hdr_gen + st0 * HDR);
  const int e = h0[0], n0 = h0[1];
  const uint64_t tl = (uint32_t)h0[3] | ((uint64_t)(uint32_t)h0[4] << 32);

  Sums<NT, P> S;
#pragma unroll
  for (int q = 0; q < TILES; ++q)
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      S.acc[q][i] = 0.f;
#pragma unroll
      for (int j = 0; j < P; ++j) S.g[j][q][i] = 0.f;
    }
#pragma unroll
  for (int j = 0; j < P; ++j) S.fs[j] = make_float2(0.f, 0.f);
  S.rel = -1;
  S.gk = S.gi = 0;
  S.fpend = S.fsel = false;

  uint32_t a0[HK / 16][4], a1[HK / 16][4];   // the steps' fragments
  for (int kk = 0; kk < p.k; kk += G::BK) {
    const int st = it % p.stages;
    bar_wait(L.full + 8 * st, (it / p.stages) & 1);
    const uint32_t sa = L.ring + st * p.stage_bytes;
    int g0 = S.gi;                   // GS 0: the stage's first scale row
    step<PASS, BITS, NT, P, GS, 0>(S, a0, sa, st, p, L, me, g0);
    step<PASS, BITS, NT, P, GS, 1>(S, a1, sa, st, p, L, me, g0);
    if constexpr (G::STEPS == 4) {
      step<PASS, BITS, NT, P, GS, 2>(S, a0, sa, st, p, L, me, g0);
      step<PASS, BITS, NT, P, GS, 3>(S, a1, sa, st, p, L, me, g0);
    }
    ++it;
  }
  wg_wait<0>();
  hold_all(S, BITS == 4);
  if constexpr (BITS == 4) {
    // GS 0: the chunk's last group (selects, not a branch)
    if (S.fpend) {
#pragma unroll
      for (int q = 0; q < TILES; ++q)
#pragma unroll
        for (int i = 0; i < NA; ++i) {
          const float x = S.fsel ? S.g[1][q][i] : S.g[0][q][i];
          S.acc[q][i] += ((i & 2) ? S.fs[0].y : S.fs[0].x) * x;
        }
    }
  }
  if (S.rel >= 0 && lane == 0) bar_arrive(L.empty + 8 * S.rel);

  // the tile's row 8j + 2t + v -> its row of the expert
  const auto row_of = [&](int q, int n) {
    return TILE * (int)((tl >> (16 * q)) & 0xffff) + n;
  };
  const int col = n0 + (PASS == 1 ? wg * WN : 0) + wcol + 2 * g;
  // pass B: where d % 128 == 64 the last item's second half lies past d
  // (its weight columns are TMA's zero fill); nothing of it is stored
  const bool cols_exist = col < p.n;
  float2 sc = make_float2(1.f, 1.f);
  if (BITS == 8 && cols_exist)               // (a select: no local copy of p)
    sc = *reinterpret_cast<const float2*>((wg ? p.s[1] : p.s[0]) +
                                          (size_t)e * p.n + col);

  if (PASS == 0) {
    // h = silu(x@w1) * (x@w3): WG 1 hands its sums (x@w3) to WG 0
    const int me_t = tid & 127;
    bar_named(1, 256);               // WG 0 has read the last chunk's
    if (wg == 1) {
#pragma unroll
      for (int q = 0; q < TILES; ++q)
#pragma unroll
        for (int i = 0; i < NA; ++i)
          xchg[(q * NA + i) * 128 + me_t] =
              S.acc[q][i] * ((i & 2) ? sc.y : sc.x);
    }
    bar_named(2, 256);
    if (wg == 0) {
      __nv_bfloat16* hi = static_cast<__nv_bfloat16*>(p.out);
      __nv_bfloat16* lo = hi + (size_t)p.e * p.c * p.n;
#pragma unroll
      for (int q = 0; q < TILES; ++q)
#pragma unroll
        for (int j = 0; j < NA / 4; ++j)
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const int r = row_of(q, 8 * j + 2 * t + v);
            const int i0 = 4 * j + v, i1 = 4 * j + 2 + v;
            const float h0 = silu(S.acc[q][i0] * sc.x) *
                             xchg[(q * NA + i0) * 128 + me_t];
            const float h1 = silu(S.acc[q][i1] * sc.y) *
                             xchg[(q * NA + i1) * 128 + me_t];
            if (r < p.c) {
              const float b0 = __bfloat162float(__float2bfloat16_rn(h0));
              const float b1 = __bfloat162float(__float2bfloat16_rn(h1));
              const size_t o = ((size_t)e * p.c + r) * p.n + col;
              *reinterpret_cast<uint32_t*>(hi + o) = pack_bf16(b0, b1);
              *reinterpret_cast<uint32_t*>(lo + o) =
                  pack_bf16(h0 - b0, h1 - b1);
            }
          }
    }
  } else {
    // y = (h@w2) * comb on the live tiles' rows
    float* y = static_cast<float*>(p.out);
#pragma unroll
    for (int q = 0; q < TILES; ++q)
#pragma unroll
      for (int j = 0; j < NA / 4; ++j)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int r = row_of(q, 8 * j + 2 * t + v);
          if (r < p.c && cols_exist) {
            const float cw = p.comb[(size_t)e * p.c + r];
            *reinterpret_cast<float2*>(y + ((size_t)e * p.c + r) * p.n +
                                       col) =
                make_float2(S.acc[q][4 * j + v] * sc.x * cw,
                            S.acc[q][4 * j + 2 + v] * sc.y * cw);
          }
        }
  }
}

// tx: pass A x as (64 columns, E*C rows, d/64 chunks) bf16, box 64 x 16 x 2;
// pass B the h planes as (64, E*C, F/64, 2 planes), box 64 x 16 x 2 x 2;
// both 128-byte swizzled.  tw0 / tw1: pass A's w1 / w3 (E*K or E*K/2 rows,
// F bytes), box 64 x (128 or 64), 64-byte swizzle; pass B's w2 in tw0, box
// 128 x (128 or 64), 128-byte swizzle.  ts0 / ts1: int4 scales (E*K/group
// rows, N) f32, box 64 x srows (pass B: 128 x srows, in ts0)
template <int PASS, int BITS, int GS>
__global__ void __launch_bounds__(THREADS, 1)
qmoe_kernel(const __grid_constant__ CUtensorMap tx,
            const __grid_constant__ CUtensorMap tw0,
            const __grid_constant__ CUtensorMap tw1,
            const __grid_constant__ CUtensorMap ts0,
            const __grid_constant__ CUtensorMap ts1, const Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  uint8_t* gen = smem + (base - smem_u32(smem));
  const Layout L(base, p, PASS);
  uint8_t* hdr_gen = gen + (L.hdr - base);
  float* xchg = reinterpret_cast<float*>(gen + (L.xchg - base));
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int st = 0; st < p.stages; ++st) {
      bar_init<1>(L.full + 8 * st);
      bar_init<8>(L.empty + 8 * st);             // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {                  // the producer warpgroup: one warp works
    regs_dec<REG_P>();
    if (tid < 288)
      produce<PASS, BITS>(&tx, &tw0, &tw1, &ts0, &ts1, p, L, hdr_gen);
    return;
  }
  regs_inc<REG_C>();
  int it = 0;
  for (;;) {
    const int st = it % p.stages;
    bar_wait(L.full + 8 * st, (it / p.stages) & 1);
    const int ncode = reinterpret_cast<const int*>(hdr_gen + st * HDR)[2];
    if (ncode < 0) break;
    switch (ncode) {
      case 0: consume<PASS, BITS, 0, GS>(p, L, hdr_gen, xchg, it); break;
      case 1: consume<PASS, BITS, 1, GS>(p, L, hdr_gen, xchg, it); break;
      case 2: consume<PASS, BITS, 2, GS>(p, L, hdr_gen, xchg, it); break;
      case 3: consume<PASS, BITS, 3, GS>(p, L, hdr_gen, xchg, it); break;
      default: consume<PASS, BITS, 4, GS>(p, L, hdr_gen, xchg, it); break;
    }
  }
}

int smem_bytes(const Params& p, int pass) {
  return 1024 + p.stages * p.stage_bytes + (pass == 0 ? XCHG : 0) +
         p.stages * (HDR + 16);
}

template <int PASS, int BITS, int GS>
int launch(const CUtensorMap& tx, const CUtensorMap& tw0,
           const CUtensorMap& tw1, const CUtensorMap& ts0,
           const CUtensorMap& ts1, const Params& p, int blocks,
           cudaStream_t st) {
  auto kern = qmoe_kernel<PASS, BITS, GS>;
  // the attribute once a device (it costs host time on every call)
  static unsigned long long set = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !(set >> dev & 1ull)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) set |= 1ull << dev;
  }
  kern<<<blocks, THREADS, smem_bytes(p, PASS), st>>>(tx, tw0, tw1, ts0, ts1,
                                                     p);
  return (int)cudaGetLastError();
}

// the scale rows a stage of K rows kk .. kk + bk - 1 overlaps, at most
int scale_rows(int k, int group, int bk) {
  int most = 0;
  for (int kk = 0; kk < k; kk += bk) {
    const int r = (kk + bk - 1) / group - kk / group + 1;
    most = r > most ? r : most;
  }
  return most;
}

// whether the planner's ring (stage_bytes, stages, srows, nt_cap) holds a
// pass's stages and fits the card
int check_plan(const Params& p, int pass, int bits, int blocks) {
  const int bk = pass == 0 && bits == 4 ? 256 : 128;   // Geo<>::BK
  const int w = bits == 8 ? bk * WN : bk / 2 * WN;
  const int need = 2 * w + (pass == 1 ? 2 : 1) * (bk / HK) * p.nt_cap * CHUNK +
                   (bits == 4 ? 2 * p.srows * WN * 4 : 0);
  const int ntiles = (p.c + TILE - 1) / TILE;
  if (p.nt_cap < 1 || p.nt_cap > NT_MAX ||
      p.nt_cap != (ntiles < NT_MAX ? ntiles : NT_MAX) ||
      p.stage_bytes < need || p.stage_bytes % 1024 || p.stages < 2 ||
      p.stages > MAX_STAGES || smem_bytes(p, pass) > SMEM_MAX ||
      blocks < 1 || (bits == 4 && p.srows < scale_rows(p.k, p.group, bk)) ||
      (bits == 8 && p.srows != 0) || ntiles > 0xffff)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// every instance `quant_moe_ffn` can launch, for `quant_moe_ffn_instance`
struct Instance {
  const char* name;
  const void* fn;
};
#define QMI(P_, B_, G_)                                   \
  {"qmoe_kernel<" #P_ ", " #B_ ", " #G_ ">",              \
   (const void*)qmoe_kernel<P_, B_, G_>}
const Instance kInstances[] = {QMI(0, 8, 0), QMI(1, 8, 0), QMI(0, 4, 1),
                               QMI(1, 4, 1), QMI(0, 4, 2), QMI(1, 4, 2),
                               QMI(0, 4, 4), QMI(1, 4, 4), QMI(0, 4, 0),
                               QMI(1, 4, 0)};
#undef QMI

}  // namespace qmoe

using namespace qmoe;

// int8: w1q/w3q (E,d,F) int8 + scales (E,1,F); w2q (E,F,d) + (E,1,d).
// int4: w1q/w3q (E,d/2,F) uint8 + scales (E,d/group,F); w2q (E,F/2,d) +
// (E,F/group,d).  scratch: the h planes (2, E*C, F) bf16 then two ints (the
// passes' item counters); out (E,C,d) f32.  plan: per pass (A, then B)
// blocks, stage bytes, stages, scale rows a stage, tiles a stage (the
// wrapper's `moe_ffn.plan`).
extern "C" int quant_moe_ffn(const void* xe, const void* w1q, const void* w1s,
                             const void* w3q, const void* w3s,
                             const void* w2q, const void* w2s,
                             const void* comb, void* scratch, void* out, int e,
                             int c, int d, int f, int bits, int group,
                             int degree, int gapped, int a_blocks,
                             int a_stage, int a_stages, int a_srows,
                             int a_nt, int b_blocks, int b_stage,
                             int b_stages, int b_srows, int b_nt,
                             void* stream) {
  if (e < 1 || c < 1 || degree < 1 || e % degree || d % WN || f % WN)
    return (int)cudaErrorInvalidValue;
  if (bits != 8 && bits != 4) return (int)cudaErrorInvalidValue;
  if (bits == 4 && (group < 16 || group % 16 || d % group || f % group))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int G = bits == 4 ? group : 0;
  int* counter = reinterpret_cast<int*>(static_cast<uint8_t*>(scratch) +
                                        (size_t)4 * e * c * f);
  Params pa{};
  pa.comb = static_cast<const float*>(comb);
  pa.s[0] = static_cast<const float*>(w1s);
  pa.s[1] = static_cast<const float*>(w3s);
  pa.out = scratch;
  pa.counter = counter;
  pa.e = e;
  pa.c = c;
  pa.k = d;
  pa.n = f;
  pa.group = G;
  pa.degree = degree;
  pa.gapped = gapped;
  pa.col_tiles = f / WN;
  pa.items = e / degree * pa.col_tiles;
  pa.stage_bytes = a_stage;
  pa.stages = a_stages;
  pa.srows = a_srows;
  pa.nt_cap = a_nt;
  Params pb = pa;
  pb.s[0] = pb.s[1] = static_cast<const float*>(w2s);
  pb.out = out;
  pb.counter = counter + 1;
  pb.k = f;
  pb.n = d;
  pb.col_tiles = (d + 2 * WN - 1) / (2 * WN);
  pb.items = e / degree * pb.col_tiles;
  pb.stage_bytes = b_stage;
  pb.stages = b_stages;
  pb.srows = b_srows;
  pb.nt_cap = b_nt;
  if (int rc = check_plan(pa, 0, bits, a_blocks)) return rc;
  if (int rc = check_plan(pb, 1, bits, b_blocks)) return rc;

  const int bka = bits == 4 ? 256 : 128;       // K rows a stage: pass A
  const int wra = bits == 8 ? bka : bka / 2;   // packed rows a stage
  const int wrb = bits == 8 ? 128 : 64;        // pass B
  const long long kd = bits == 8 ? d : d / 2, kf = bits == 8 ? f : f / 2;
  CUtensorMap xa, xb, w1, w3, w2, s1, s3, s2;
  const uint64_t ec = (uint64_t)e * c;
  int rc = 0;
  {
    const uint64_t dims[3] = {64, ec, (uint64_t)d / 64};
    const uint64_t strides[2] = {(uint64_t)d * 2, 128};
    const uint32_t box[3] = {64, TILE, (uint32_t)bka / 64};
    rc = make_map_nd(&xa, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, xe, 3, dims,
                     strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (rc == 0) {
    const uint64_t dims[4] = {64, ec, (uint64_t)f / 64, 2};
    const uint64_t strides[3] = {(uint64_t)f * 2, 128, ec * f * 2};
    const uint32_t box[4] = {64, TILE, 2, 2};
    rc = make_map_nd(&xb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, scratch, 4, dims,
                     strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (rc == 0)
    rc = make_map(&w1, CU_TENSOR_MAP_DATA_TYPE_UINT8, w1q, f, e * kd, f, WN,
                  wra, CU_TENSOR_MAP_SWIZZLE_64B);
  if (rc == 0)
    rc = make_map(&w3, CU_TENSOR_MAP_DATA_TYPE_UINT8, w3q, f, e * kd, f, WN,
                  wra, CU_TENSOR_MAP_SWIZZLE_64B);
  if (rc == 0)
    rc = make_map(&w2, CU_TENSOR_MAP_DATA_TYPE_UINT8, w2q, d, e * kf, d,
                  2 * WN, wrb, CU_TENSOR_MAP_SWIZZLE_128B);
  s1 = w1;                           // int8 reads its scales directly
  s3 = w3;
  s2 = w2;
  if (rc == 0 && bits == 4)
    rc = make_map(&s1, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, w1s, f,
                  (uint64_t)e * (d / group), (uint64_t)f * 4, WN, a_srows,
                  CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc == 0 && bits == 4)
    rc = make_map(&s3, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, w3s, f,
                  (uint64_t)e * (d / group), (uint64_t)f * 4, WN, a_srows,
                  CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc == 0 && bits == 4)
    rc = make_map(&s2, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, w2s, d,
                  (uint64_t)e * (f / group), (uint64_t)d * 4, 2 * WN, b_srows,
                  CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc != 0) return rc;

  cudaError_t err = cudaMemsetAsync(counter, 0, 2 * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  if (bits == 8) {
    rc = launch<0, 8, 0>(xa, w1, w3, s1, s3, pa, a_blocks, st);
    return rc ? rc : launch<1, 8, 0>(xb, w2, w2, s2, s2, pb, b_blocks, st);
  }
  // int4 groups of 16, 32 or 64 rows: parity fixed at compile time
  switch (group) {
    case 16:
      rc = launch<0, 4, 1>(xa, w1, w3, s1, s3, pa, a_blocks, st);
      return rc ? rc : launch<1, 4, 1>(xb, w2, w2, s2, s2, pb, b_blocks, st);
    case 32:
      rc = launch<0, 4, 2>(xa, w1, w3, s1, s3, pa, a_blocks, st);
      return rc ? rc : launch<1, 4, 2>(xb, w2, w2, s2, s2, pb, b_blocks, st);
    case 64:
      rc = launch<0, 4, 4>(xa, w1, w3, s1, s3, pa, a_blocks, st);
      return rc ? rc : launch<1, 4, 4>(xb, w2, w2, s2, s2, pb, b_blocks, st);
    default:
      rc = launch<0, 4, 0>(xa, w1, w3, s1, s3, pa, a_blocks, st);
      return rc ? rc : launch<1, 4, 0>(xb, w2, w2, s2, s2, pb, b_blocks, st);
  }
}

// instance i: its name (cut to `cap` bytes with the NUL), the local memory
// a thread takes (spills and stack frame) and its registers, as the loaded
// module reports them (cudaFuncGetAttributes); -1 past the last instance,
// else a CUDA error code
extern "C" int quant_moe_ffn_instance(int i, char* name, int cap,
                                      int* local_bytes, int* regs) {
  if (i < 0 || i >= (int)(sizeof(kInstances) / sizeof(kInstances[0])))
    return -1;
  snprintf(name, cap, "%s", kInstances[i].name);
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kInstances[i].fn);
  if (e != cudaSuccess) return (int)e;
  *local_bytes = (int)a.localSizeBytes;
  *regs = a.numRegs;
  return 0;
}
