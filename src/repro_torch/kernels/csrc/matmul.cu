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
// the partial tile of a K split, then the mbarriers (full, empty).
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
  static_assert(STAGES >= 3, "the ring needs three stages");
  static_assert(SMEM <= (TWO >= 3 ? SMEM_TWO : SMEM_SM), "shared memory");
  static_assert(STAGE % 1024 == 0 && A_BYTES % 1024 == 0,
                "swizzled tiles need 1 KB alignment");
};

struct Params {
  void* out;                         // (M, N), f32 or (bf16) bf16
  int m, n, gapped;
  int steps;                         // ceil(K / KSTEP)
  int bf16;                          // round the sums to bf16 on the store
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

// ta: the activation (M, K), box 64 x (C*64 consecutive, 64 gapped); tb:
// the weight (K, N), box 64 x 64 (KB: (N, K), box 64 x 64 along K); both
// 128-byte swizzled
template <int C, int VW, bool KB = false>
__global__ void __launch_bounds__(Shape<C, VW>::THREADS, 1)
cmm_kernel(const __grid_constant__ CUtensorMap ta,
           const __grid_constant__ CUtensorMap tb, const Params p) {
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
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      bar_init<1>(full + 8 * st);
      bar_init<4>(empty + 8 * st);             // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  float acc[C][N / 2];
  if (warp == 4) {
    // -- producer: A box(es) and the weight's boxes of each stage ----------
    if (lane == 0) {
      for (int i = 0; i < nsteps; ++i) {
        const int st = i % STAGES, kk = (s0 + i) * KSTEP;
        bar_wait(empty + 8 * st, ((i / STAGES) & 1) ^ 1);
        const uint32_t sa = sbase + st * SH::STAGE, sb = sa + SH::A_BYTES;
        const uint32_t bar = full + 8 * st;
        bar_expect(bar, SH::STAGE);
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
            tma_2d(sb + v * BOX_N * 128, &tb, kk, n0 + v * BOX_N, bar);
          else
            tma_2d(sb + v * KSTEP * 128, &tb, n0 + v * BOX_N, kk, bar);
        }
      }
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

  if (S == 1) {
    // no split: each accumulator to its place, 32 bytes a row and n8 tile
    if (warp < 4) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int r0 = grow(c) + warp * 16 + g;
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const int col = n0 + 8 * j + 2 * t;
          const float lo[2] = {acc[c][4 * j], acc[c][4 * j + 1]};
          const float hi[2] = {acc[c][4 * j + 2], acc[c][4 * j + 3]};
          if (stored(p, r0, col)) store(p, (size_t)r0 * p.n + col, lo);
          if (stored(p, r0 + 8, col))
            store(p, (size_t)(r0 + 8) * p.n + col, hi);
        }
      }
    }
    return;
  }

  // K split: the partial tile into this block's ring (every product has
  // read it), then rank r sums its share of the rows over the cluster in
  // rank order
  cg::cluster_group cluster = cg::this_cluster();
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
            cluster.map_shared_rank(red, q) + r * SH::LDR + col);
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

template <int C, int VW, bool KB = false>
int launch(const void* a, const void* b, void* o, int m, int n, int k,
           int gapped, int splits, int bf16, cudaStream_t st) {
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
  auto kern = cmm_kernel<C, VW, KB>;
  // the instance's attributes, once a device (a decode step makes ~200
  // calls: their host time counts)
  static std::atomic<unsigned> ready{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (!(ready.load() >> dev & 1u)) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SH::SMEM);
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
  Params p{o, m, n, gapped, (k + KSTEP - 1) / KSTEP, bf16};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (n + SH::N - 1) / SH::N,
                     (m + SH::ROWS - 1) / SH::ROWS);
  cfg.blockDim = dim3(SH::THREADS);
  cfg.dynamicSmemBytes = SH::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;   // S = 1: no cluster
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
#define CMI(C_, VW_, KB_)                                       \
  {"cmm_kernel<" #C_ ", " #VW_ ", " #KB_ ">",                   \
   (const void*)cmm_kernel<C_, VW_, KB_>}
const Instance kInstances[] = {
    CMI(1, 1, false), CMI(1, 2, false), CMI(1, 4, false), CMI(2, 1, false),
    CMI(2, 2, false), CMI(4, 1, false), CMI(1, 1, true)};
#undef CMI

}  // namespace

// splits: the wrapper's K split (`kernels/matmul.py` `mm_split_plan`,
// `step_plan`); kb: the weight is the transpose of a contiguous (N, K)
// tensor; out_bf16: o is bf16, the sums rounded on the store (else f32).
// At c = vw = 1, m is any count of rows and n % 8 == 0 (the ragged tiles'
// TMA zero fill); otherwise both tile.
extern "C" int coarsened_matmul_bf16(const void* a, const void* b, void* o,
                                     int m, int n, int k, int c, int vw,
                                     int gapped, int kb, int out_bf16,
                                     int splits, void* stream) {
  const bool ragged = c == 1 && vw == 1;
  if (m < 1 || n < 8 || k % 32 || k < 32 ||
      (ragged ? n % 8 : m % (c * BM) || n % (BOX_N * vw)))
    return (int)cudaErrorInvalidValue;
  if (splits < 1 || splits > MAX_SPLITS ||
      splits > (k + KSTEP - 1) / KSTEP || (kb && !ragged))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (kb)
    return launch<1, 1, true>(a, b, o, m, n, k, 0, splits, out_bf16, st);
  switch (c * 10 + vw) {
    case 11:
      return launch<1, 1>(a, b, o, m, n, k, gapped, splits, out_bf16, st);
    case 12:
      return launch<1, 2>(a, b, o, m, n, k, gapped, splits, out_bf16, st);
    case 14:
      return launch<1, 4>(a, b, o, m, n, k, gapped, splits, out_bf16, st);
    case 21:
      return launch<2, 1>(a, b, o, m, n, k, gapped, splits, out_bf16, st);
    case 22:
      return launch<2, 2>(a, b, o, m, n, k, gapped, splits, out_bf16, st);
    case 41:
      return launch<4, 1>(a, b, o, m, n, k, gapped, splits, out_bf16, st);
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
