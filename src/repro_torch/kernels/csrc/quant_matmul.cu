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
// here the packed values are widened to bf16 in registers (exact), the
// tensor cores form the exact products a * q in f32, and the scale is
// applied after the product: per column when the slices are summed
// (int8), per group to the group's partial sums (int4).
//
// Bound on this card: max(2*M*N*K / 989 TFLOP/s, bytes / 3.35 TB/s) with
// bytes = 2*M*K + K*N*bits/8 + scales + 4*M*N.  At a prefill chunk's
// M = 128 the packed weight dominates the bytes: the kernel must keep the
// whole card streaming weight bytes.  The design, for that:
//
// * K is split into S slices (the wrapper's split plan), so the grid
//   (S, N/64, M/(degree*128)) fills the 132 SMs even where N/64 is 16.
//   The S blocks of one output tile form a thread-block cluster; each
//   leaves its partial tile in its shared memory, and block r sums rows
//   r*R/S .. of all S partials through distributed shared memory in rank
//   order 0..S-1 and stores them: one launch, no workspace, no atomics,
//   the same bits on every run.  Slices are whole 64-row K steps and, for
//   int4, whole scale groups.
// * Each block streams its slice through a ring of 3 shared-memory stages
//   filled by TMA (one thread issues a stage's 2-4 tensor copies against
//   the stage's mbarrier; 2 stages in flight while one is multiplied, and
//   3 blocks an SM): the raw int8/int4 weight tile (64 K rows by the
//   block's 64 columns), its int4 group scales, and the activation tile
//   (all of the block's 128*degree rows x 64).
// * Tensor cores through wgmma on the transposed product C^T = W^T A^T: a
//   warpgroup owns the block's 64 weight columns (wgmma's M, its A operand
//   in registers, widened from ldmatrix.trans of the raw bytes) against the
//   128 rows of one row block (wgmma's N, m64n128k16, read from shared
//   memory by descriptor).  Each weight byte is loaded and widened once
//   per row block, by the one warp that owns its column.
//
// Fragment layouts (PTX ISA, lane = 4g + t): warp q of a warpgroup holds
// A rows 16q..16q+15 as mma.m16n8k16 does: regs {row g | g+8} x {k 2t,
// 2t+1 | 8+2t, 9+2t}; D n-tile j holds (row g | g+8, cols 8j+2t, +1).
// ldmatrix.trans of a stored 8x8 b16 matrix gives lane (g, t) its
// elements (2t, g) and (2t+1, g).  A weight row of 16 bytes is 8 b16
// elements, so lane (g, t) receives the bytes of columns 2g and 2g+1: A
// row g is weight column 2g, A row g+8 column 2g+1.
//   int8: matrix rows are K rows; lane (g,t) holds bytes (k 2t: col 2g,
//         2g+1; k 2t+1: col 2g, 2g+1), i.e. A regs 0 and 1 of one k8 half.
//   int4: matrix rows are packed rows (2 K rows each), fed in the order
//         0,4,1,5,2,6,3,7, so lane (g,t) holds packed rows t and 4+t: the
//         bytes ARE A regs 0..3 (low nibble k even, high nibble k odd).
// TMA swizzles both tiles as it stores them: the activation tile (128-byte
// rows) in wgmma's 128-byte-swizzle K-major layout (8-row groups 1024
// bytes apart, a k16 step 32 bytes along the row), the weight tile (64-byte
// rows) with the 64-byte swizzle, so that the 8 rows of an ldmatrix land
// in 8 different bank groups: 16-byte chunk c of the row at byte o holds
// chunk c ^ ((o >> 7) & 3).
//
// The mbarrier, TMA, descriptor and wgmma helpers are `hopper.cuh`'s
// (shared with the flash forward).
//
// Coarsening, as the Pallas A view (`_a_o_layout`): a block owns `degree`
// row blocks of 128 rows, adjacent (consecutive) or M/degree rows apart
// (gapped), and 64 output columns; each staged weight tile serves every
// row of all `degree` blocks (warpgroup j takes row block j).
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace qmm {

using namespace hop;

constexpr int BK = 64;               // K rows per stage
constexpr int WN = 64;               // output columns per block
constexpr int STAGES = 3;            // the ring (3 blocks an SM fit)
constexpr int MAX_SPLITS = 16;       // a cluster's blocks (non-portable > 8)

// A block: DEG row blocks of 128 rows by 64 columns, one warpgroup per
// row block
template <int BITS, int DEG>
struct Shape {
  static constexpr int ROWS = DEG * 128;          // rows of a block
  static constexpr int THREADS = 128 * DEG;
  static constexpr int LDR = WN + 4;              // floats a partial-tile row
  static constexpr int A_BYTES = ROWS * BK * 2;
  static constexpr int W_ROWS = BITS == 8 ? BK : BK / 2;
  static constexpr int W_BYTES = W_ROWS * WN;     // WN bytes a row
  static constexpr int S_BYTES = BITS == 4 ? (BK / 16) * WN * 4 : 0;
  static constexpr int STAGE = A_BYTES + W_BYTES + S_BYTES;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int RED = ROWS * LDR * 4;      // the partial tile
  static constexpr int BARS = RING > RED ? RING : RED;   // the mbarriers
  // + STAGES mbarriers, + 1 KB to align the ring to the 128-byte swizzle
  static constexpr int SMEM = BARS + STAGES * 8 + 1024;
  static_assert(STAGE % 1024 == 0 && A_BYTES % 1024 == 0 &&
                W_BYTES % 1024 == 0, "swizzled tiles need 1 KB alignment");
};

struct Params {
  const __nv_bfloat16* a;          // (M, K)
  const uint8_t* q;                // int8 (K, N) or packed int4 (K/2, N)
  const float* s;                  // (1, N) int8 / (K/group, N) int4
  float* out;                      // (M, N)
  int m, n, k, group, gapped;
  int unit, units;                 // K rows a slice bound respects; K/unit
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

// byte i of r (two offset-binary nibbles) -> bf16 pair (lo - 8, hi - 8),
// exact: bf16 0x4300 | n is 128 + n, and 136 = 0x4308
__device__ __forceinline__ uint32_t widen_i4(uint32_t r, int i) {
  const uint32_t b = __byte_perm(r, 0u, 0x4440 + i);
  const uint32_t w = (b & 0x0fu) | ((b << 12) & 0x000f0000u) | 0x43004300u;
  const uint32_t c = 0x43084308u;
  const __nv_bfloat162 d = __hsub2(
      *reinterpret_cast<const __nv_bfloat162*>(&w),
      *reinterpret_cast<const __nv_bfloat162*>(&c));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// ta: the activation (K, M) bf16, box 64 x 128; tw: the packed weight
// (N, K or K/2) bytes, box 64 x (64 or 32); ts (int4): the scales (N,
// K/group) f32, box 64 x max(1, 64/group)
template <int BITS, int DEG>
__global__ void __launch_bounds__(Shape<BITS, DEG>::THREADS)
qmm_kernel(const __grid_constant__ CUtensorMap ta,
           const __grid_constant__ CUtensorMap tw,
           const __grid_constant__ CUtensorMap ts, const Params p) {
  using SH = Shape<BITS, DEG>;
  constexpr int LDR = SH::LDR;
  extern __shared__ __align__(128) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // warpgroup rb: row block rb; its warp: 16 of the columns
  const int rb = warp >> 2, wcol = (warp & 3) * 16;
  const int S = gridDim.x, slice = blockIdx.x;
  const int n0 = blockIdx.y * WN;
  const int u0 = (int)((long long)slice * p.units / S);
  const int u1 = (int)((long long)(slice + 1) * p.units / S);
  const int kbeg = u0 * p.unit, nsteps = (u1 - u0) * p.unit / BK;

  // global row of the block's row r
  auto grow = [&](int r) -> int {
    if (DEG > 1 && p.gapped)
      return (r >> 7) * (p.m / DEG) + blockIdx.z * 128 + (r & 127);
    return blockIdx.z * SH::ROWS + r;
  };

  const uint32_t sbase = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t bars = sbase + SH::BARS;
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) bar_init(bars + 8 * st);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int srows = p.group < BK ? BK / p.group : 1;   // int4 scale rows
  constexpr int TX = SH::A_BYTES + SH::W_BYTES;
  // (thread 0) stage st <- the tiles of K rows kk .. kk + BK - 1
  auto load = [&](int st, int kk) {
    const uint32_t sa = sbase + st * SH::STAGE, bar = bars + 8 * st;
    bar_expect(bar, TX + (BITS == 4 ? srows * WN * 4 : 0));
#pragma unroll
    for (int j = 0; j < DEG; ++j)
      tma_2d(sa + j * 128 * BK * 2, &ta, kk, grow(j * 128), bar);
    tma_2d(sa + SH::A_BYTES, &tw, n0, BITS == 8 ? kk : kk / 2, bar);
    if (BITS == 4)
      tma_2d(sa + SH::A_BYTES + SH::W_BYTES, &ts, n0, kk / p.group, bar);
  };

  // acc (int4: the scaled sum of the groups; part: the current group's
  // sums): n-tile j = 4j .. 4j+3, (column wcol + 2g, rows 8j + 2t, +1),
  // (column wcol + 2g + 1, the same rows) of row block rb
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;

  // this lane's ldmatrix rows of the weight tile (k rows w_row and
  // 32 + w_row at int8), the warp's 16-byte chunk of each, swizzled
  const int w_row = BITS == 8 ? lane
                    : 8 * (lane >> 3) + ((lane & 7) >> 1) + 4 * (lane & 1);
  auto w_at = [&](int r) {
    const int o = r * WN + wcol;
    return o ^ (((o >> 7) & 3) << 4);
  };

  if (tid == 0)
    for (int st = 0; st < STAGES - 1 && st < nsteps; ++st)
      load(st, kbeg + st * BK);
  for (int i = 0; i < nsteps; ++i) {
    bar_wait(bars + 8 * (i % STAGES), (i / STAGES) & 1);
    __syncthreads();                 // stage i landed; stage i-1 consumed
    const int nxt = i + STAGES - 1;
    if (tid == 0 && nxt < nsteps) load(nxt % STAGES, kbeg + nxt * BK);

    const int kk = kbeg + i * BK;
    const uint32_t sa = sbase + (i % STAGES) * SH::STAGE;
    const uint32_t sw = sa + SH::A_BYTES;
    uint32_t wr[8];                  // int8: k rows 0..63; int4: steps 0..3
    ldsm4_t(wr[0], wr[1], wr[2], wr[3], sw + w_at(w_row));
    if (BITS == 8)
      ldsm4_t(wr[4], wr[5], wr[6], wr[7], sw + w_at(32 + w_row));
    uint32_t a[BK / 16][4];
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      if (BITS == 8) {
        widen_i8(wr[2 * ks], a[ks][0], a[ks][1]);
        widen_i8(wr[2 * ks + 1], a[ks][2], a[ks][3]);
      } else {
#pragma unroll
        for (int x = 0; x < 4; ++x) a[ks][x] = widen_i4(wr[ks], x);
      }
    }
    // the row block's activation tile; K step ks 32 bytes along its rows
    const uint64_t b0 = desc(sa + rb * 128 * BK * 2);
    wg_fence();
    if (BITS == 8) {
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
        wgmma_rs<128, 0>(acc, a[ks], b0 + (uint64_t)(ks * 2), 1);
    } else {
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        // the first K step of a scale group starts its sums afresh
        const int k0 = kk + ks * 16;
        wgmma_rs<128, 0>(part, a[ks], b0 + (uint64_t)(ks * 2),
                         (k0 & (p.group - 1)) != 0);
        if (((k0 + 16) & (p.group - 1)) == 0) {
          // end of a scale group: acc += scale * the group's sums
          wg_commit();
          wg_wait();
          wg_hold(part);
          const int gr = (k0 + 16) / p.group - 1 - kk / p.group;
          float2 sc;
          asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                       : "=f"(sc.x), "=f"(sc.y)
                       : "r"(sw + SH::W_BYTES + (gr * WN + wcol + 2 * g) * 4));
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            acc[4 * j] += sc.x * part[4 * j];
            acc[4 * j + 1] += sc.x * part[4 * j + 1];
            acc[4 * j + 2] += sc.y * part[4 * j + 2];
            acc[4 * j + 3] += sc.y * part[4 * j + 3];
          }
          wg_fence();                // part is read before wgmma rewrites it
        }
      }
    }
    // the stage's wgmmas read their registers and shared memory until here
    wg_commit();
    wg_wait();
    wg_hold(acc);
  }
  __syncthreads();                   // the ring is free: the partial tile

  float* red = reinterpret_cast<float*>(smem + (sbase - smem_u32(smem)));
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int r = rb * 128 + j * 8 + 2 * t, c = wcol + 2 * g;
    *reinterpret_cast<float2*>(&red[r * LDR + c]) =
        make_float2(acc[4 * j], acc[4 * j + 2]);
    *reinterpret_cast<float2*>(&red[(r + 1) * LDR + c]) =
        make_float2(acc[4 * j + 1], acc[4 * j + 3]);
  }

  // this block's share of the rows, summed over the slices in rank order;
  // a thread keeps one group of 4 columns
  const int r0 = slice * SH::ROWS / S, r1 = (slice + 1) * SH::ROWS / S;
  const int c = (tid % (WN / 4)) * 4;
  float4 sc = make_float4(1.f, 1.f, 1.f, 1.f);
  if (BITS == 8) sc = *reinterpret_cast<const float4*>(p.s + n0 + c);
  cluster.sync();                    // every slice's partial tile is whole
#pragma unroll 4
  for (int r = r0 + tid / (WN / 4); r < r1; r += SH::THREADS / (WN / 4)) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int q = 0; q < S; ++q) {
      const float4 x = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(red, q) + r * LDR + c);
      v.x += x.x;
      v.y += x.y;
      v.z += x.z;
      v.w += x.w;
    }
    v.x *= sc.x;
    v.y *= sc.y;
    v.z *= sc.z;
    v.w *= sc.w;
    *reinterpret_cast<float4*>(p.out + (size_t)grow(r) * p.n + n0 + c) = v;
  }
  // no block leaves while it is read: the readers arrive once their loads
  // have returned (their stores used them), so the arrive needs no release
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <int BITS, int DEG>
int launch(const Params& p, int splits, cudaStream_t st) {
  using SH = Shape<BITS, DEG>;
  CUtensorMap ta, tw, ts;
  int rc = make_map(&ta, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.a, p.k, p.m,
                    (uint64_t)p.k * 2, BK, 128, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0)
    rc = make_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.q, p.n,
                  BITS == 8 ? p.k : p.k / 2, p.n, WN, SH::W_ROWS,
                  CU_TENSOR_MAP_SWIZZLE_64B);
  ts = tw;                           // int8 reads its scales directly
  if (rc == 0 && BITS == 4)
    rc = make_map(&ts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, p.s, p.n,
                  p.k / p.group, (uint64_t)p.n * 4, WN,
                  p.group < BK ? BK / p.group : 1,
                  CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc != 0) return rc;
  auto kern = qmm_kernel<BITS, DEG>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SH::SMEM);
  if (e == cudaSuccess)                // three blocks an SM need all of it
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, p.n / WN, p.m / SH::ROWS);
  cfg.blockDim = dim3(SH::THREADS);
  cfg.dynamicSmemBytes = SH::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, ta, tw, ts, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace qmm

using namespace qmm;

// splits: the wrapper's split plan (`kernels/matmul.py` `split_plan`)
extern "C" int quant_matmul(const void* a, const void* bq, const void* bs,
                            void* out, int m, int n, int k, int bits,
                            int group, int degree, int gapped, int splits,
                            void* stream) {
  if (degree < 1 || degree > 2 || m % (degree * 128) || n % WN || k % BK)
    return (int)cudaErrorInvalidValue;
  if (bits != 8 && bits != 4) return (int)cudaErrorInvalidValue;
  // int4 groups: a power of two of at least 16 rows that tiles K
  if (bits == 4 && (group < 16 || (group & (group - 1)) || k % group))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.a = static_cast<const __nv_bfloat16*>(a);
  p.q = static_cast<const uint8_t*>(bq);
  p.s = static_cast<const float*>(bs);
  p.out = static_cast<float*>(out);
  p.m = m;
  p.n = n;
  p.k = k;
  p.group = bits == 4 ? group : 1;
  p.gapped = gapped;
  p.unit = bits == 4 && group > BK ? group : BK;
  p.units = k / p.unit;
  if (splits < 1 || splits > MAX_SPLITS || splits > p.units)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (bits == 8)
    return degree == 1 ? launch<8, 1>(p, splits, st)
                       : launch<8, 2>(p, splits, st);
  return degree == 1 ? launch<4, 1>(p, splits, st)
                     : launch<4, 2>(p, splits, st);
}
