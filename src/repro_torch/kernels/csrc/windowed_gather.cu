// Windowed gather, the paper's cached LSU (Fig. 5b / Fig. 12), f32:
//
//   out[e] = chain(tbl[idx[e]])   (`_arith_chain([vals], 2 * ai)`)
//
// Replaces `repro/kernels/windowed_gather.py` `make_kernel` (its
// pl.pallas_call at :81).  There the id stream is planned as a stream
// (`plan_stream(N, cfg, block)`: program i owns C slices of B ids, adjacent
// or G*B ids apart) and a host planner prefetches one base row per
// (program, slice); each slice DMAs rows base and base + 1 of the (T/L, L)
// table view, a 2L-wide L-aligned window that covers the slice's ids (from
// `make_indices`, each L-long run of positions draws from one L-wide
// window), and gathers from it in VMEM.
//
// Here one thread block (256 threads) is one program.  For each of its C
// slices in turn it stages that slice's window into one shared buffer of 2L
// floats with coalesced 16-byte loads (rows clamped into [0, T/L), which
// takes T == L, where the planner's base row is -1), then gathers the
// slice's ids from shared memory and applies the chain.  One buffer reused
// across slices keeps con8 at L 4096 within 32 KB.  A slice whose base row
// equals the one staged keeps the buffer, as a cache line stays while it
// hits: a program's consecutive slices inside one locality run (L / B of
// them) stage their window once; gapped slices lie G*B ids apart and
// restage.  An id's offset into the window is clamped into [0, 2L): ids
// outside their slice's window are outside the contract (they read a wrong
// value, never out of bounds).  Both loops stay rolled: unrolled, nvcc
// gave the kernel 76 registers (64 and spills under a 4-blocks-an-SM
// bound) against 26, and fewer blocks in flight.
//
// The chain (`arith_chain.cuh`) multiplies by 0.5 only and adds without
// contraction, so the kernel equals its plain version bit for bit.
//
// Bound on the H100: idx read and out written once, each touched table
// entry read once, over 3.35 TB/s (12 f32 operations an id are far below
// the peak).  Row 16's gather reads every id's value as a scattered 32-byte
// sector; here a staged window moves 8L bytes in whole coalesced lines for
// the B (base) to L (consecutive, C >= L / B) ids that read it: 32 bytes
// an id at base, B 1024, L 4096, and 8 at con4.
//
// probe = 1 stores the program's index (as float32) in place of the result.
#include <cuda_runtime.h>

#include <climits>

#include "arith_chain.cuh"

namespace {

constexpr int NT = 256;

struct Plan {
  int c, b, g, gapped;
};

__global__ void __launch_bounds__(NT)
    windowed_gather_kernel(const int* __restrict__ idx,
                           const float* __restrict__ tbl,
                           const int* __restrict__ bases,
                           float* __restrict__ out, Plan pl, int window,
                           int n_rows, int n_arith, int probe) {
  extern __shared__ float4 win4[];
  const float* win = reinterpret_cast<const float*>(win4);
  const int i = blockIdx.x, tid = threadIdx.x;
  const int quads = window / 4;
  int staged = INT_MIN;                 // the base row the buffer holds
  for (int k = 0; k < pl.c; ++k) {
    const int base = __ldg(bases + i * pl.c + k);
    if (base != staged) {               // uniform: one base a slice
      if (k) __syncthreads();           // the last slice's reads are done
      const int r0 = min(max(base, 0), n_rows - 1);
      const int r1 = min(max(base + 1, 0), n_rows - 1);
      const float4* s0 = reinterpret_cast<const float4*>(tbl) +
                         (size_t)r0 * quads;
      const float4* s1 = reinterpret_cast<const float4*>(tbl) +
                         (size_t)r1 * quads;
#pragma unroll 1
      for (int v = tid; v < quads; v += NT) {
        win4[v] = __ldg(s0 + v);
        win4[quads + v] = __ldg(s1 + v);
      }
      staged = base;
      __syncthreads();
    }
    const long long e0 = pl.gapped ? ((long long)k * pl.g + i) * pl.b
                                   : ((long long)i * pl.c + k) * pl.b;
    const long long off = (long long)base * window;
#pragma unroll 1
    for (int j = tid; j < pl.b; j += NT) {
      float v;
      if (probe) {
        v = (float)i;
      } else {
        const long long local = __ldg(idx + e0 + j) - off;
        const float r[1] = {win[min(max(local, 0LL), 2LL * window - 1)]};
        v = chain<1, 0>(r, n_arith);
      }
      out[e0 + j] = v;
    }
  }
}

}  // namespace

// idx: (n,) int32; tbl: (table,) f32, 16-byte aligned; bases: (g, degree)
// int32, the planner's window base row of each (program, slice); out: (n,)
// f32.  The plan is `plan_stream(n, cfg, block)` with block already widened
// by the vector width: n % (block * degree) == 0, block <= window,
// window % block == 0, table % window == 0.
extern "C" int windowed_gather_f32(const void* idx, const void* tbl,
                                   const void* bases, void* out, int n,
                                   int table, int window, int block,
                                   int degree, int gapped, int n_arith,
                                   int probe, void* stream) {
  if (n < 1 || window < 4 || window % 4 || table < window ||
      table % window || block < 1 || block > window || window % block ||
      degree < 1 || n % (block * degree))
    return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)window * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        windowed_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const Plan pl{degree, block, n / (block * degree), gapped};
  windowed_gather_kernel<<<pl.g, NT, smem,
                           reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(tbl),
      static_cast<const int*>(bases), static_cast<float*>(out), pl, window,
      table / window, n_arith, probe);
  return (int)cudaGetLastError();
}
