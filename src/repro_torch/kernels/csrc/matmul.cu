// Coarsened blocked matmul for Hopper (sm_90a): (M,K) bf16 @ (K,N) bf16 -> f32.
//
// Replaces the Pallas kernel `repro/kernels/matmul.py` `make_kernel` (:44;
// its pl.pallas_call at :69), which the FFN's gate, up and down products
// run in prefill (`repro/models/layers.py` `ffn`).
//
// What it computes: one thread block owns C row blocks of BM = 64 rows of A
// (and of the output) and N = 64 * vector_width output columns, over one
// slice of K.  The C row blocks are adjacent (consecutive) or M/C rows
// apart (gapped: row block c of program i starts at c*(M/C) + i*BM), as the
// Pallas kernel's A view (`_a_o_layout`).  Every staged weight tile feeds
// all C row blocks: the coarsening's point (`matmul.py:8-10`) is that B is
// fetched once per program instead of once per row block.
//
// Bound on this card: max(2*M*N*K / 989 TFLOP/s, bytes / 3.35 TB/s) with
// bytes = 2*M*K + 2*K*N + 4*M*N.  At a prefill chunk's M = 128 the weight
// dominates the bytes and the output tiles are too few to fill 132 SMs; at
// M = 8192 the products bound it.  The design, for both:
//
// * Warp specialisation.  One producer warp (its first lane) issues TMA
//   copies into a ring of stages of KSTEP = 64 K rows with a full and an
//   empty mbarrier per stage; one consumer warpgroup multiplies on wgmma.
//   The main loop has no block-wide barrier, and one stage's products stay
//   in flight while the next stage's are issued (wgmma.wait_group 1).
//   An instance fits two blocks an SM where each keeps a ring of three
//   stages (stages of up to 32 KB), else one block with a deeper ring (the
//   40 KB stages of con4, gap4 and simd4: two stages left their TMA
//   latency exposed); the ring takes as many stages of that room as it
//   can, up to MAX_STAGES.
// * The products: wgmma m64nNk16, N = 64 * vector_width (64, 128, 256),
//   both operands from shared memory.  A is K-major (rows of 128 bytes,
//   the 128-byte swizzle); the weight (K, N) with N contiguous is wgmma's
//   MN-major B operand, staged as vector_width boxes of 64 K rows x 64
//   columns (the 128-byte swizzle limits a box row to 128 bytes), the same
//   layout the flash kernels read V in.  The accumulators of the C row
//   blocks, 32 * C * vector_width floats a thread (<= 128), stay in
//   registers over the whole slice.
// * Coarsening as TMA boxes: a consecutive program stages its C*64
//   adjacent rows as ONE box a stage (the Pallas "one wide DMA"), a
//   gapped program as C boxes of 64 rows M/C apart ("C narrow DMAs"); the
//   weight's boxes are staged once a stage for all C row blocks.  The walk
//   is stated in Python beside the wrapper (`kernels/matmul.py`
//   `mm_program`).
// * K split.  Where the output tiles leave SMs idle, K is cut into S
//   slices of whole steps, as many as keep to one block an SM (the
//   wrapper's `mm_split_plan`, the planner that row 10's `split_plan`
//   shares: on the H100 a split that puts a second block on an SM cost more
//   than it streamed, `repro_torch.bench.mm_splits`, so qwen3-0.6b's gate
//   and up products at T = 128 take none and its down product four); the
//   S blocks of an output tile form a
//   thread-block cluster, each leaves its partial tile in its shared memory
//   (the ring's), and block r sums rows r*R/S .. of all S partials through
//   distributed shared memory in rank order and stores them: no atomics,
//   the same bits on every run.  With S = 1 there is no cluster and the
//   accumulators go straight to global memory (staging the tile in shared
//   memory for TMA stores was 3-7% faster at M = 8192 for vector widths
//   >= 2 and 3% slower on the prefill chunk's products; not kept).
// * The K tail.  K % 64 may be 32: the last stage's boxes reach past K and
//   TMA fills those elements with zeros in both operands, so the tail adds
//   exact zeros; the stage's mbarrier still counts the full box bytes.
// * Ragged M and N at base (C = 1, VW = 1), for the products of the decode
//   and verify steps (`kernels/matmul.py` `step_matmul`): M need not tile
//   by 64 nor N by 64 (N % 8 == 0).  The last tiles' boxes reach past the
//   operands and TMA fills them with zeros, so every stored element is the
//   same sum a whole tile gives it; the rows and columns past M and N are
//   not stored.  A row's sum depends on its own A row alone: its bits do
//   not depend on the other rows, their count or its place in the tile.
// * A K-major weight (KB): the transpose of a contiguous (N, K) tensor (a
//   tied embedding read as the head), staged as 64 rows of 128 bytes a
//   stage like A and read as wgmma's K-major B (`desc`), base only.
// * The norm prologue (NORM, base only): rmsnorm(A) @ W in one launch, for
//   the steps' products that read a norm (ln1, a dense FFN's ln2, the
//   final norm; `kernels/matmul.py` `step_matmul` with `norm`).  While the
//   producer fills the ring, the consumer warps read the tile's rows whole
//   from global memory (L2) and compute r = rsqrt(mean(x^2) + eps) with
//   `rmsnorm.cu`'s lane walk and xor tree, so r does not depend on which
//   block computes it.  A tile of up to 8 rows (a decode step's): each
//   block computes its own, warp w rows w and w + 4, two rows and eight
//   16-byte chunks a lane in flight (one round trip at K up to 2048).  A
//   taller tile (a verify pass's) under a K split: the blocks of the
//   cluster share it out, the split's slices and, where it has fewer than
//   8, blocks of neighbouring column tiles too (`step_plan` with `norm`
//   plans the cluster and the grid): warp w of block rank q takes rows 4 q
//   + w + 32 j in a cluster of 8, one round trip; each r is written to its
//   block's shared memory, and after a cluster barrier each consumer
//   thread reads the r of its two fragment rows from the block that owns
//   them, and no block leaves before the cluster has read its r.  Rows at
//   or past M get r = 0 (their A rows are TMA's zero fill).  The producer stages
//   each stage's 64 values of the norm's scale by a 1-D bulk copy beside
//   its tiles.  In the main loop the consumer loads its A fragment of each
//   k16 step from the swizzled stage with ldmatrix, widens it, forms
//   bf16(x * r * (1 + s)) with `rmsnorm.cu`'s operations in its order and
//   multiplies it as wgmma's register operand (`wgmma_rs`) against the
//   weight in shared memory.  Without a K split a block walks column tiles
//   gridDim.y apart, a block a place on the card (the head: 2374 tiles on
//   264 blocks, the plan's grid; each block computes the statistic of the
//   tile's rows, four rows a warp and four chunks a lane in flight), so a
//   row's statistic is computed once a block rather than once a tile.  Each A element is then the row norm kernel's
//   output and the products and the K split are the plain instance's, so
//   the result equals the row norm then the product bit for bit.  A
//   stage's fragments stay live until its wgmma group has completed: two
//   register buffers are taken in turn, stage by stage.  Nothing the
//   async proxy reads is written by threads, so no proxy fence is needed.
//   The map from a thread's registers to the stage is stated in Python
//   beside the wrapper (`norm_frag_map`).
//
// Fragment layouts (PTX ISA): a wgmma accumulator of m64nN holds, in
// register 4j + e of lane 4g + t of warp w, row 16w + g (e = 0, 1) or
// 16w + g + 8 (e = 2, 3) and column 8j + 2t + (e & 1).  The mbarrier, TMA,
// descriptor and wgmma helpers are `hopper.cuh`'s (shared with rows 5-7
// and 10).
#include <atomic>

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace hop;

constexpr int BM = 64;               // rows of a row block (wgmma's M)
constexpr int BOX_N = 64;            // columns of a weight box (128 bytes)
constexpr int KSTEP = 64;            // K rows a stage (128 bytes of an A row)
constexpr int MAX_SPLITS = 16;       // a cluster's blocks (non-portable > 8)
constexpr int MAX_STAGES = 6;
constexpr int SMEM_SM = 227 * 1024;  // what one block an SM may take
constexpr int SMEM_TWO = 113 * 1024; // each of two blocks an SM

// A block: C row blocks of BM rows by N = 64 * VW columns, one consumer
// warpgroup and one producer warp.  Shared memory from a 1 KB aligned base:
// the ring (STAGES x (A tile of C*BM rows, VW weight boxes)), reused for
// the partial tile of a K split, then the mbarriers (full, empty); with
// the norm prologue, then each stage's scale values and the tile's r.
template <int C, int VW>
struct Shape {
  static constexpr int ROWS = C * BM;
  static constexpr int N = BOX_N * VW;             // wgmma's N
  static constexpr int THREADS = 128 + 32;
  static constexpr int A_BYTES = ROWS * KSTEP * 2;
  static constexpr int B_BYTES = KSTEP * N * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int LDR = N + 8;                // floats a partial row
  static constexpr int RED = ROWS * LDR * 4;
  // two blocks an SM where each keeps a ring of 3 stages, else one block
  // with a deeper ring
  static constexpr int TWO = (SMEM_TWO - 1024 - 16 * MAX_STAGES) / STAGE;
  static constexpr int ROOM =
      TWO >= 3 ? TWO : (SMEM_SM - 1024 - 16 * MAX_STAGES) / STAGE;
  static constexpr int STAGES = ROOM > MAX_STAGES ? MAX_STAGES : ROOM;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int BODY = RING > RED ? RING : RED;
  static constexpr int SMEM = BODY + 1024 + 16 * STAGES;
  // the norm prologue's: each stage's 64 scale values, the tile's r
  static constexpr int NORM_SMEM = SMEM + STAGES * KSTEP * 4 + ROWS * 4;
  static_assert(STAGES >= 3, "the ring needs three stages");
  static_assert(NORM_SMEM <= (TWO >= 3 ? SMEM_TWO : SMEM_SM),
                "shared memory");
  static_assert(STAGE % 1024 == 0 && A_BYTES % 1024 == 0,
                "swizzled tiles need 1 KB alignment");
};

struct Params {
  void* out;                         // (M, N), f32 or (bf16) bf16
  int m, n, gapped;
  int steps;                         // ceil(K / KSTEP)
  int bf16;                          // round the sums to bf16 on the store
  // the norm prologue's: A (M, K) and the norm's scale (K,) in global
  // memory, K and eps
  const __nv_bfloat16* a;
  const float* scale;
  int k;
  float eps;
};

// whether row r and column col of the output exist (the last tiles of a
// ragged M or N reach past them)
__device__ __forceinline__ bool stored(const Params& p, int r, int col) {
  return r < p.m && col < p.n;
}

// store NV (2 or 4) sums at element e of the output, f32 or rounded to
// bf16 (to nearest even, as a cast of the f32 result)
template <int NV>
__device__ __forceinline__ void store(const Params& p, size_t e,
                                      const float (&v)[NV]) {
  if (p.bf16) {
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
        static_cast<__nv_bfloat16*>(p.out) + e);
#pragma unroll
    for (int i = 0; i < NV / 2; ++i)
      o[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  } else if constexpr (NV == 2) {
    *reinterpret_cast<float2*>(static_cast<float*>(p.out) + e) =
        make_float2(v[0], v[1]);
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(p.out) + e) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

__device__ __forceinline__ void widen8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

// the norm prologue's statistic: r of the tile rows that warp gw of nw
// consumer warps owns, rows gw + nw j (j = 0, 1, ...; rows at or past M
// skipped), into rs[row] of this block's shared memory, as
// `rmsnorm_kernel` computes it: lane l sums x^2 over the 16-byte chunks at
// columns 8 (l + 32 i) in order, then the xor tree.  R rows and CH chunks
// of each in flight at once (a warp of up to 2 rows: 2 and 8, one round
// trip at K up to 2048; else 4 and 4)
template <int R, int CH>
__device__ __forceinline__ void row_stats(const Params& p, int row0, int gw,
                                          int nw, int lane, float* rs) {
  for (int j0 = gw; j0 < BM && row0 + j0 < p.m; j0 += R * nw) {
    // rows j0 + nw q, q < R
    float ss[R];
#pragma unroll
    for (int q = 0; q < R; ++q) ss[q] = 0.f;
    const auto live = [&](int q) {
      return j0 + nw * q < BM && row0 + j0 + nw * q < p.m;
    };
    for (int c0 = 8 * lane; c0 < p.k; c0 += CH * 256) {
      uint4 u[R][CH];
#pragma unroll
      for (int q = 0; q < R; ++q)
#pragma unroll
        for (int b = 0; b < CH; ++b)
          if (live(q) && c0 + 256 * b < p.k)
            u[q][b] = __ldg(reinterpret_cast<const uint4*>(
                p.a + (size_t)(row0 + j0 + nw * q) * p.k + c0 + 256 * b));
#pragma unroll
      for (int q = 0; q < R; ++q)
#pragma unroll
        for (int b = 0; b < CH; ++b)
          if (live(q) && c0 + 256 * b < p.k) {
            float f[8];
            widen8(u[q][b], f);
#pragma unroll
            for (int i = 0; i < 8; ++i)
              ss[q] = __fadd_rn(ss[q], __fmul_rn(f[i], f[i]));
          }
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ss[q] = __fadd_rn(ss[q], __shfl_xor_sync(0xffffffffu, ss[q], off));
      if (lane == 0 && live(q))
        rs[j0 + nw * q] =
            rsqrtf(__fadd_rn(__fdiv_rn(ss[q], (float)p.k), p.eps));
    }
  }
}

// rows of a tile up to which each block computes its own statistic (4
// warps, 2 rows each: one pass); past them a cluster of blocks shares it
constexpr int OWN_ROWS = 8;

// whether the blocks of this cluster share out the statistic of the tile
// at row0 (`step_plan` plans clusters of more than one block for it)
__device__ __forceinline__ bool norm_shared(const Params& p, int row0) {
  const int live = p.m - row0 < BM ? p.m - row0 : BM;
  return cg::this_cluster().num_blocks() > 1 && live > OWN_ROWS;
}

// the cluster barrier's two halves (any thread, not warp-aligned): arrive
// releases this thread's prior memory operations, wait acquires every
// arrived thread's
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// bf16(x * r * (1 + s)) of a register's two bf16 (k, k + 1), as
// `rmsnorm_kernel` forms them; s1 = (1 + s_k, 1 + s_k+1)
__device__ __forceinline__ uint32_t normed(uint32_t x, float r, float2 s1) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  const __nv_bfloat162 y = __floats2bfloat162_rn(
      __fmul_rn(__fmul_rn(f.x, r), s1.x), __fmul_rn(__fmul_rn(f.y, r), s1.y));
  return *reinterpret_cast<const uint32_t*>(&y);
}

// one stage of the norm prologue's main loop (the block's stage `it`, at
// K row kk; the stage's fragments into `cur`; `prev` holds the stage
// before, whose wgmma group completes here and which is released unless
// this is a tile's first); scl: the stages' 64 scale values each, staged
// with their tiles
template <int STAGES, int A_BYTES, int STAGE, bool KB>
__device__ __forceinline__ void norm_stage(
    const Params& p, float (&acc)[32], uint32_t (&cur)[KSTEP / 16][4],
    uint32_t (&prev)[KSTEP / 16][4], int it, int kk, bool first,
    uint32_t sbase, const float* scl, uint32_t full, uint32_t empty,
    int warp, int lane, float rlo, float rhi) {
  const int st = it % STAGES, t = lane & 3;
  const uint32_t sa = sbase + st * STAGE, sb = sa + A_BYTES;
  // lane i addresses row i % 8 of 8x8 matrix i / 8: rows 16 warp + i % 8
  // (+ 8 for matrices 1 and 3), 16-byte chunk 2 ks (+ 1 for matrices 2
  // and 3), swizzled (chunk ^ row % 8)
  const int row = 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int half = lane >> 4;
  bar_wait(full + 8 * st, (it / STAGES) & 1);
#pragma unroll
  for (int ks = 0; ks < KSTEP / 16; ++ks) {
    // 1 + s of this thread's columns, k 2t, 2t + 1 (h 0) and 8 + 2t, 9 +
    // 2t (h 1); past K (a half stage) the A elements are TMA's zeros and
    // the staged scales are not copied: 1
    float2 s1[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = 16 * ks + 8 * h + 2 * t;
      const float2 s = kk + col < p.k
          ? *reinterpret_cast<const float2*>(scl + st * KSTEP + col)
          : make_float2(0.f, 0.f);
      s1[h] = make_float2(__fadd_rn(1.f, s.x), __fadd_rn(1.f, s.y));
    }
    ldsm4(cur[ks], sa + row * 128 + (((2 * ks + half) ^ (row & 7)) << 4));
#pragma unroll
    for (int j = 0; j < 4; ++j)
      cur[ks][j] = normed(cur[ks][j], (j & 1) ? rhi : rlo, s1[j >> 1]);
  }
  wg_hold(acc);
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < KSTEP / 16; ++ks) {
    const uint64_t bd = KB ? desc(sb + ks * 32)
                           : desc_mn(sb + ks * 2048, KSTEP * 128);
    wgmma_rs<BOX_N, KB ? 0 : 1>(acc, cur[ks], bd, 1);
  }
  wg_commit();
  wg_wait<1>();                        // the stage before is read
  wg_hold(acc);
#pragma unroll
  for (int ks = 0; ks < KSTEP / 16; ++ks) wg_hold(prev[ks]);
  if (!first && lane == 0) bar_arrive(empty + 8 * ((it - 1) % STAGES));
}

// ta: the activation (M, K), box 64 x (C*64 consecutive, 64 gapped); tb:
// the weight (K, N), box 64 x 64 (KB: (N, K), box 64 x 64 along K); both
// 128-byte swizzled
template <int C, int VW, bool KB = false, bool NORM = false>
__global__ void __launch_bounds__(Shape<C, VW>::THREADS, NORM ? 2 : 1)
cmm_kernel(const __grid_constant__ CUtensorMap ta,
           const __grid_constant__ CUtensorMap tb, const Params p) {
  static_assert(!NORM || (C == 1 && VW == 1), "the norm prologue: base");
  using SH = Shape<C, VW>;
  constexpr int STAGES = SH::STAGES, N = SH::N;
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x;
  const int S = gridDim.x, slice = blockIdx.x;
  const int n0 = blockIdx.y * N;
  const int s0 = (int)((long long)slice * p.steps / S);
  const int nsteps = (int)((long long)(slice + 1) * p.steps / S) - s0;
  // global row of row block j's first row
  const auto grow = [&](int j) {
    return p.gapped ? j * (p.m / C) + blockIdx.z * BM
                    : (blockIdx.z * C + j) * BM;
  };

  const uint32_t sbase = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t full = sbase + SH::BODY, empty = full + 8 * STAGES;
  const uint32_t sscale = empty + 8 * STAGES;      // the norm prologue's
  float* const scl = reinterpret_cast<float*>(smem + (sscale -
                                                      smem_u32(smem)));
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      bar_init<1>(full + 8 * st);
      bar_init<4>(empty + 8 * st);             // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int tiles = (p.n + N - 1) / N;   // column tiles
  const bool share = NORM && norm_shared(p, blockIdx.z * BM);
  float acc[C][N / 2];
  // no split: each accumulator to its place in column tile n0t, 32 bytes a
  // row and n8 tile
  const auto store_tile = [&](int n0t) {
    if (warp < 4) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int r0 = grow(c) + warp * 16 + g;
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const int col = n0t + 8 * j + 2 * t;
          const float lo[2] = {acc[c][4 * j], acc[c][4 * j + 1]};
          const float hi[2] = {acc[c][4 * j + 2], acc[c][4 * j + 3]};
          if (stored(p, r0, col)) store(p, (size_t)r0 * p.n + col, lo);
          if (stored(p, r0 + 8, col))
            store(p, (size_t)(r0 + 8) * p.n + col, hi);
        }
      }
    }
  };
  if (warp == 4) {
    // -- producer: A box(es) and the weight's boxes of each stage ----------
    // stage `it` of the block: K step i of column tile n0t
    const auto issue = [&](int it, int i, int n0t) {
      const int st = it % STAGES, kk = (s0 + i) * KSTEP;
      bar_wait(empty + 8 * st, ((it / STAGES) & 1) ^ 1);
      const uint32_t sa = sbase + st * SH::STAGE, sb = sa + SH::A_BYTES;
      const uint32_t bar = full + 8 * st;
      // the norm's scale values of the stage's K rows (a half stage at
      // a K tail), 1-D, beside the tiles
      const int sbytes = NORM ? (p.k - kk < KSTEP ? p.k - kk : KSTEP) * 4
                              : 0;
      bar_expect(bar, SH::STAGE + sbytes);
      if (NORM)
        bulk_1d(sscale + st * KSTEP * 4, p.scale + kk, sbytes, bar);
      if (C > 1 && p.gapped) {
#pragma unroll
        for (int j = 0; j < C; ++j)
          tma_2d(sa + j * BM * 128, &ta, kk, grow(j), bar);
      } else {
        tma_2d(sa, &ta, kk, grow(0), bar);   // one box of C*64 rows
      }
#pragma unroll
      for (int v = 0; v < VW; ++v) {
        if (KB)
          tma_2d(sb + v * BOX_N * 128, &tb, kk, n0t + v * BOX_N, bar);
        else
          tma_2d(sb + v * KSTEP * 128, &tb, n0t + v * BOX_N, kk, bar);
      }
    };
    if (share) cluster_arrive();          // the r phase: nothing to publish
    if (lane == 0) {
      if constexpr (NORM) {
        // the norm prologue: the block's column tiles in turn, gridDim.y
        // apart (the ring runs on across them)
        int it = 0;
        for (int tj = blockIdx.y; tj < tiles; tj += gridDim.y)
          for (int i = 0; i < nsteps; ++i) issue(it++, i, tj * N);
      } else {
        for (int i = 0; i < nsteps; ++i) issue(i, i, n0);
      }
    }
    if (share) {
      __syncwarp();
      cluster_wait();
      cluster_arrive();                     // read no other block's r
    }
  } else if constexpr (NORM) {
    // -- consumers with the norm prologue: r of the warp's share of the
    // tile's rows (of the cluster's, where it shares them); the r of the
    // fragment's two rows from the blocks that own them; then the slice
    // with A from registers, two fragment buffers taken in turn
    float* const rs = scl + STAGES * KSTEP;
    const int row0 = blockIdx.z * BM;
    const int live = p.m - row0 < BM ? p.m - row0 : BM;
    cg::cluster_group cluster = cg::this_cluster();
    const int nw = 4 * (share ? (int)cluster.num_blocks() : 1);
    const int gw = 4 * (share ? (int)cluster.block_rank() : 0) + warp;
    if (live <= 2 * nw)
      row_stats<2, 8>(p, row0, gw, nw, lane, rs);
    else
      row_stats<4, 4>(p, row0, gw, nw, lane, rs);
    if (share) {
      cluster_arrive();                      // this block's r are written
      cluster_wait();                        // and every block's
    } else {
      bar_named(1, 128);                     // every consumer warp's r
    }
    const auto r_of = [&](int j) {           // tile row j's r, from its owner
      return row0 + j >= p.m ? 0.f
             : share ? *cluster.map_shared_rank(rs + j, (j % nw) / 4)
                     : rs[j];
    };
    const int rl = 16 * warp + g;
    const float rlo = r_of(rl), rhi = r_of(rl + 8);
    if (share) cluster_arrive();             // the owners' r are read
    uint32_t fa[KSTEP / 16][4] = {}, fb[KSTEP / 16][4] = {};
    int it = 0;
    // a block past the column tiles (the grid is whole clusters) sums
    // nothing: its partial tile is zeros
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[0][i] = 0.f;
    for (int tj = blockIdx.y; tj < tiles; tj += gridDim.y) {
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[0][i] = 0.f;
      for (int i = 0; i < nsteps; i += 2) {
        norm_stage<STAGES, SH::A_BYTES, SH::STAGE, KB>(
            p, acc[0], fa, fb, it + i, (s0 + i) * KSTEP, i == 0, sbase, scl,
            full, empty, warp, lane, rlo, rhi);
        if (i + 1 < nsteps)
          norm_stage<STAGES, SH::A_BYTES, SH::STAGE, KB>(
              p, acc[0], fb, fa, it + i + 1, (s0 + i + 1) * KSTEP, false,
              sbase, scl, full, empty, warp, lane, rlo, rhi);
      }
      wg_wait<0>();
      wg_hold(acc[0]);
#pragma unroll
      for (int ks = 0; ks < KSTEP / 16; ++ks) {
        wg_hold(fa[ks]);
        wg_hold(fb[ks]);
      }
      it += nsteps;
      if (lane == 0) bar_arrive(empty + 8 * ((it - 1) % STAGES));
      if (S == 1) store_tile(tj * N);
    }
  } else {
    // -- consumers: the C row blocks' sums over the slice ------------------
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[c][i] = 0.f;
    for (int i = 0; i < nsteps; ++i) {
      const int st = i % STAGES;
      const uint32_t sa = sbase + st * SH::STAGE, sb = sa + SH::A_BYTES;
      bar_wait(full + 8 * st, (i / STAGES) & 1);
#pragma unroll
      for (int c = 0; c < C; ++c) wg_hold(acc[c]);
      wg_fence();
      // k16 steps: 32 bytes along A's rows, 16 rows (2 KB) down the
      // weight's boxes, whose 64-column chunks lie KSTEP*128 bytes apart
      // (KB: 32 bytes along the weight's rows, as along A's)
#pragma unroll
      for (int ks = 0; ks < KSTEP / 16; ++ks) {
        const uint64_t bd = KB ? desc(sb + ks * 32)
                               : desc_mn(sb + ks * 2048, KSTEP * 128);
#pragma unroll
        for (int c = 0; c < C; ++c)
          wgmma_ss<N, KB ? 0 : 1>(acc[c], desc(sa + c * BM * 128 + ks * 32),
                                  bd, 1);
      }
      wg_commit();
      wg_wait<1>();                      // the stage before is read
#pragma unroll
      for (int c = 0; c < C; ++c) wg_hold(acc[c]);
      if (i > 0 && lane == 0) bar_arrive(empty + 8 * ((i - 1) % STAGES));
    }
    wg_wait<0>();
#pragma unroll
    for (int c = 0; c < C; ++c) wg_hold(acc[c]);
  }

  // the norm prologue: no block leaves, nor reuses its shared memory,
  // before the cluster has read its r
  if (share) cluster_wait();
  if (S == 1) {
    if (!NORM) store_tile(n0);         // the norm prologue stored its tiles
    return;
  }

  // K split: the partial tile into this block's ring (every product has
  // read it), then slice r sums its share of the rows over the slices in
  // order (the blocks of its column tile: cluster ranks q + S y, y the
  // block's column in a cluster of the norm prologue's)
  cg::cluster_group cluster = cg::this_cluster();
  const int yc = S * (int)cluster.block_index().y;
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem + (sbase - smem_u32(smem)));
  if (warp < 4) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float* r0 = red + (c * BM + warp * 16 + g) * SH::LDR + 2 * t;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        *reinterpret_cast<float2*>(r0 + 8 * j) =
            make_float2(acc[c][4 * j], acc[c][4 * j + 1]);
        *reinterpret_cast<float2*>(r0 + 8 * SH::LDR + 8 * j) =
            make_float2(acc[c][4 * j + 2], acc[c][4 * j + 3]);
      }
    }
  }
  cluster.sync();                      // every slice's partial tile is whole
  if (warp < 4) {
    // a consumer thread keeps one group of 4 columns
    constexpr int GROUPS = N / 4, STEP = 128 / GROUPS;
    const int col = (tid % GROUPS) * 4;
    const int r1 = (slice + 1) * SH::ROWS / S;
#pragma unroll 2
    for (int r = slice * SH::ROWS / S + tid / GROUPS; r < r1; r += STEP) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int q = 0; q < S; ++q) {
        const float4 x = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(red, yc + q) + r * SH::LDR + col);
        v.x += x.x;
        v.y += x.y;
        v.z += x.z;
        v.w += x.w;
      }
      const int row = grow(r / BM) + r % BM;
      if (stored(p, row, n0 + col)) {
        const float sums[4] = {v.x, v.y, v.z, v.w};
        store(p, (size_t)row * p.n + n0 + col, sums);
      }
    }
  }
  // no block leaves while it is read: the readers arrive once their loads
  // have returned (their stores used them), so the arrive needs no release
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <int C, int VW, bool KB = false, bool NORM = false>
int launch(const void* a, const void* b, void* o, int m, int n, int k,
           int gapped, int splits, int grid_y, int cluster_y, int bf16,
           const void* scale, float eps, cudaStream_t st) {
  using SH = Shape<C, VW>;
  const bool wide = C > 1 && !gapped;   // one box of the program's rows
  CUtensorMap ta, tb;
  int rc = make_map(&ta, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a, k, m,
                    (uint64_t)k * 2, KSTEP, wide ? SH::ROWS : BM,
                    CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0)
    rc = KB ? make_map(&tb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, b, k, n,
                       (uint64_t)k * 2, KSTEP, BOX_N,
                       CU_TENSOR_MAP_SWIZZLE_128B)
            : make_map(&tb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, b, n, k,
                       (uint64_t)n * 2, BOX_N, KSTEP,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  auto kern = cmm_kernel<C, VW, KB, NORM>;
  // the instance's attributes, once a device (a decode step makes ~200
  // calls: their host time counts)
  static std::atomic<unsigned> ready{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 32) return (int)cudaErrorInvalidDevice;
  constexpr int smem_bytes = NORM ? SH::NORM_SMEM : SH::SMEM;
  if (!(ready.load() >> dev & 1u)) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e == cudaSuccess)              // the ring needs most of the SM's
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    ready.fetch_or(1u << dev);
  }
  Params p{o, m, n, gapped, (k + KSTEP - 1) / KSTEP, bf16,
           static_cast<const __nv_bfloat16*>(a),
           static_cast<const float*>(scale), k, eps};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, grid_y, (m + SH::ROWS - 1) / SH::ROWS);
  cfg.blockDim = dim3(SH::THREADS);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = cluster_y;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits * cluster_y > 1 ? 1 : 0;   // one block: no cluster
  e = cudaLaunchKernelEx(&cfg, kern, ta, tb, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// every instance `coarsened_matmul_bf16` can launch, for
// `coarsened_matmul_instance`
struct Instance {
  const char* name;
  const void* fn;
};
#define CMI(C_, VW_, KB_, NORM_)                                 \
  {"cmm_kernel<" #C_ ", " #VW_ ", " #KB_ ", " #NORM_ ">",        \
   (const void*)cmm_kernel<C_, VW_, KB_, NORM_>}
const Instance kInstances[] = {
    CMI(1, 1, false, false), CMI(1, 2, false, false),
    CMI(1, 4, false, false), CMI(2, 1, false, false),
    CMI(2, 2, false, false), CMI(4, 1, false, false),
    CMI(1, 1, true, false),  CMI(1, 1, false, true),
    CMI(1, 1, true, true)};
#undef CMI

}  // namespace

// splits, grid_y, cluster_y: the wrapper's plan (`kernels/matmul.py`
// `mm_split_plan`, `step_plan`): the K split, the grid's columns and the
// cluster's; kb: the weight is the transpose of a contiguous (N, K) tensor;
// out_bf16: o is bf16, the sums rounded on the store (else f32); scale:
// the norm prologue's (K,) f32 scale with eps (null: no norm; c = vw = 1
// only).  Without the norm grid_y is the column tiles and cluster_y 1;
// with it grid_y is a multiple of cluster_y, at least the column tiles
// where K is split (fewer: each block walks tiles grid_y apart).  At c =
// vw = 1, m is any count of rows and n % 8 == 0 (the ragged tiles' TMA
// zero fill); otherwise both tile.
extern "C" int coarsened_matmul_bf16(const void* a, const void* b, void* o,
                                     const void* scale, int m, int n, int k,
                                     int c, int vw, int gapped, int kb,
                                     int out_bf16, int splits, int grid_y,
                                     int cluster_y, float eps,
                                     void* stream) {
  const bool ragged = c == 1 && vw == 1;
  if (m < 1 || n < 8 || k % 32 || k < 32 ||
      (ragged ? n % 8 : m % (c * BM) || n % (BOX_N * vw)))
    return (int)cudaErrorInvalidValue;
  if (splits < 1 || splits > MAX_SPLITS ||
      splits > (k + KSTEP - 1) / KSTEP || ((kb || scale) && !ragged))
    return (int)cudaErrorInvalidValue;
  const int tiles = (n + BOX_N * vw - 1) / (BOX_N * vw);
  if (scale ? grid_y < 1 || cluster_y < 1 || grid_y % cluster_y ||
                  splits * cluster_y > MAX_SPLITS ||
                  (splits > 1 && grid_y < tiles)
            : grid_y != tiles || cluster_y != 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int g = gapped, gy = grid_y, cy = cluster_y;
  if (scale)
    return kb ? launch<1, 1, true, true>(a, b, o, m, n, k, 0, splits, gy, cy,
                                         out_bf16, scale, eps, st)
              : launch<1, 1, false, true>(a, b, o, m, n, k, 0, splits, gy,
                                          cy, out_bf16, scale, eps, st);
  if (kb)
    return launch<1, 1, true>(a, b, o, m, n, k, 0, splits, gy, 1, out_bf16,
                              nullptr, 0.f, st);
  switch (c * 10 + vw) {
    case 11:
      return launch<1, 1>(a, b, o, m, n, k, g, splits, gy, 1, out_bf16,
                          nullptr, 0.f, st);
    case 12:
      return launch<1, 2>(a, b, o, m, n, k, g, splits, gy, 1, out_bf16,
                          nullptr, 0.f, st);
    case 14:
      return launch<1, 4>(a, b, o, m, n, k, g, splits, gy, 1, out_bf16,
                          nullptr, 0.f, st);
    case 21:
      return launch<2, 1>(a, b, o, m, n, k, g, splits, gy, 1, out_bf16,
                          nullptr, 0.f, st);
    case 22:
      return launch<2, 2>(a, b, o, m, n, k, g, splits, gy, 1, out_bf16,
                          nullptr, 0.f, st);
    case 41:
      return launch<4, 1>(a, b, o, m, n, k, g, splits, gy, 1, out_bf16,
                          nullptr, 0.f, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// instance i: its name (cut to `cap` bytes with the NUL), the local memory
// a thread takes (spills and stack frame) and its registers, as the loaded
// module reports them (cudaFuncGetAttributes); -1 past the last instance,
// else a CUDA error code
extern "C" int coarsened_matmul_instance(int i, char* name, int cap,
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
