// Block-sparse flash attention forward for Hopper (sm_90a).
//
// Replaces `repro/kernels/sparse_attention.py` `make_kernel` (:183; its
// pl.pallas_call at :287): the forward over a per-q-block live-KV index,
// coarsened over the live-SLOT axis.
//
// Layout as the Pallas kernel: idx (Sq/bq, max_live) int32, the kv block
// ids each q block attends, ascending, padded with NULL (-1); q (B,H,S,D),
// k, v (B,Hkv,S,D) bf16; o (B,H,S,D) f32 and, when asked for, m, l (B,H,S)
// f32, the online softmax's row max and sum (the residuals the dense dQ
// and dK/dV kernels consume).
//
// What the TPU grid does that a block does itself.  The Pallas grid is
// (b, h, q block, step), step = 0 .. max_live/C - 1, and carries (m, l,
// acc) across the step axis in VMEM scratch.  Here one thread block owns
// one (b, h, q block) and the steps are a loop inside it.  Each step
// resolves C index slots, consecutive (slot si*C + j) or gapped (slot
// j*seg + si, seg = max_live/C), exactly the Pallas slot order (:208-229),
// and loads each live slot's K/V block into shared memory in turn (KT rows
// at a time) and folds it into the online softmax before the next.  A
// NULL slot issues no load and no math, so a kv block the index does not
// list is never read: garbage (or NaN) outside the live set cannot reach
// the output.  Inside a listed block the per-element mask (causal, window,
// global-stride columns: `_element_mask`, :63) is exact.  Labels: the
// Pallas kernel reads only the degree and whether the kind is gapped
// (:202, :207), so a label with replication or a vector width runs as its
// consecutive degree here too; a degree that does not divide max_live is
// refused, as the Pallas kernel refuses it (:205-206).
//
// Arithmetic as the dense forward (`flash_attention.cu`), through the same
// warp tiles (`flash_tile.cuh`): one warp owns 16 of the q block's rows,
// S = Q K^T and P V on mma.sync m16n8k16, p rounded to bf16 where it
// enters the product, every sum f32.  With the same slots in the same
// order as the dense kernel's sweep (base, consecutive), S is the same
// product and (m, l) come out as the dense forward's.
//
// Bound on this card at the gemma3-1b train shape (B 1, H 4, Hkv 1,
// S 4096, D 256, bq = bkv = 128, window 512): max(bytes / 3.35 TB/s,
// flops / 989 TFLOP/s), each input read once and each output written once,
// the flops of the live (q, k) pairs only.  q 8 MiB, k and v 4 MiB, o 16
// MiB (f32), m, l 128 KiB: 28.1 MB, 0.0084 ms; 1.97 M live pairs a head x
// 4 heads x 4 x 256 = 8.1 GFLOP, 0.0081 ms: bound by bytes.  What the
// design does about it: the work is the live blocks' (5 of 32 per q block
// at most, where the dense causal sweep visits up to 32); a K/V tile is
// staged once for all the block's 128 rows.  No software pipeline, TMA or
// wgmma yet: loads and products of a tile do not overlap.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tile.cuh"

namespace {

using namespace ft;

struct SGeo {
  int h, hkv, s;                   // heads, kv heads, rows (Sq == Sk)
  int bq, bkv, max_live, c, gapped;
  int causal, window, gstride;     // window 0 = none, gstride 0 = none
  float scale;
};

// `_element_mask`: causal col <= row; window col > row - window, or (with
// STRIDE) a global column, col % gstride == 0, past it.  STRIDE is a
// template flag so that a pattern without global columns evaluates no
// integer modulo per element.
template <bool STRIDE>
__device__ __forceinline__ bool live_pair(int row, int col, const SGeo& g) {
  if (g.causal && col > row) return false;
  return g.window <= 0 || col > row - g.window
         || (STRIDE && col % g.gstride == 0);
}

// one block per (q block, head, batch); bq rows, 16 per warp
template <int D, int NW, bool STRIDE>
__global__ void __launch_bounds__(NW * 32)
flash_sparse_kernel(const int* __restrict__ idx, const bf16* __restrict__ q,
                    const bf16* __restrict__ k, const bf16* __restrict__ v,
                    float* __restrict__ o, float* __restrict__ mo,
                    float* __restrict__ lo, SGeo g) {
  constexpr int LD = D + PAD, KT = kv_tile(D, NW), R = NW * 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);          // R x LD
  bf16* sk = sq + R * LD;                            // KT x LD
  bf16* sv = sk + KT * LD;                           // KT x LD
  int* slots = reinterpret_cast<int*>(sv + KT * LD); // max_live

  const int qi = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int kvh = hh / (g.h / g.hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, r0 = warp * 16;
  const size_t qoff = (size_t)(bb * g.h + hh) * g.s;
  const size_t kvoff = (size_t)(bb * g.hkv + kvh) * g.s * D;
  stage_bf16<D>(sq, q + qoff * D, R, [&](int r) { return qi * R + r; });
  // the q block's index row, read once: each slot then resolves from
  // shared memory, not through a dependent global load
  for (int i = threadIdx.x; i < g.max_live; i += blockDim.x)
    slots[i] = idx[(size_t)qi * g.max_live + i];
  __syncthreads();

  const int row0 = qi * R + r0 + gr, row1 = row0 + 8;
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;

  const int n_steps = g.max_live / g.c;   // also the gapped slot stride
  for (int si = 0; si < n_steps; ++si) {
    for (int j = 0; j < g.c; ++j) {
      const int lb = slots[g.gapped ? j * n_steps + si : si * g.c + j];
      if (lb < 0) continue;             // NULL slot: no load, no math
      for (int c0 = lb * g.bkv; c0 < (lb + 1) * g.bkv; c0 += KT) {
        __syncthreads();                // the previous tile is consumed
        const auto krow = [&](int r) { return c0 + r; };
        stage_bf16<D>(sk, k + kvoff, KT, krow);
        stage_bf16<D>(sv, v + kvoff, KT, krow);
        __syncthreads();

        float s[KT / 8][4];
        warp_xyt<D, KT>(s, sq, sk, r0);
        softmax_step<D, KT>(s, acc, m0, m1, l0, l1, row0, row1, c0, g.scale,
                            sv, [&](int row, int col) {
                              return live_pair<STRIDE>(row, col, g);
                            });
      }
    }
  }
  store_o<D>(o + qoff * D, mo == nullptr ? nullptr : mo + qoff,
             lo == nullptr ? nullptr : lo + qoff, acc, m0, m1, l0, l1, row0,
             row1);
}

template <int D, int NW, bool STRIDE>
int launch(const int* idx, const void* q, const void* k, const void* v,
           void* o, void* mo, void* lo, int b, const SGeo& g,
           cudaStream_t st) {
  const int smem = (NW * 16 + 2 * kv_tile(D, NW)) * (D + PAD) * 2
                   + g.max_live * 4;
  cudaFuncSetAttribute(flash_sparse_kernel<D, NW, STRIDE>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid(g.s / g.bq, g.h, b);
  flash_sparse_kernel<D, NW, STRIDE><<<grid, NW * 32, smem, st>>>(
      idx, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<float*>(o),
      static_cast<float*>(mo), static_cast<float*>(lo), g);
  return (int)cudaGetLastError();
}

// the geometry the kernel takes (the wrapper raises on anything else):
// q blocks of 64, 128 or 256 rows (64 or 128 at head dim 256, as the
// dense forward), kv blocks a multiple of 64 rows, a degree that divides
// max_live
bool valid(int d, int b, const SGeo& g) {
  return (d == 64 || d == 128 || d == 256)
         && (g.bq == 64 || g.bq == 128 || (g.bq == 256 && d < 256))
         && g.bkv % 64 == 0 && g.s % g.bq == 0 && g.s % g.bkv == 0
         && b > 0 && g.hkv > 0 && g.h % g.hkv == 0 && g.c > 0
         && g.max_live > 0 && g.max_live % g.c == 0;
}

}  // namespace

// o (B,H,S,D) f32; mo, lo (B,H,S) f32 or both null (no residuals)
extern "C" int flash_sparse_fwd_bf16(const void* idx, const void* q,
                                     const void* k, const void* v, void* o,
                                     void* mo, void* lo, int b, int h,
                                     int hkv, int s, int d, int bq, int bkv,
                                     int max_live, int c, int gapped,
                                     int causal, int window, int gstride,
                                     float scale, void* stream) {
  const SGeo g{h, hkv, s, bq, bkv, max_live, c, gapped, causal, window,
               gstride, scale};
  if (!valid(d, b, g) || (mo == nullptr) != (lo == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
#define CALL(D_, NW_)                                                   \
  (gstride > 0 ? launch<D_, NW_, true>(ix, q, k, v, o, mo, lo, b, g, st) \
               : launch<D_, NW_, false>(ix, q, k, v, o, mo, lo, b, g, st))
  switch (d * 1000 + bq) {
    case 64064: return CALL(64, 4);
    case 64128: return CALL(64, 8);
    case 64256: return CALL(64, 16);
    case 128064: return CALL(128, 4);
    case 128128: return CALL(128, 8);
    case 128256: return CALL(128, 16);
    case 256064: return CALL(256, 4);
    case 256128: return CALL(256, 8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CALL
}
