// 5-point stencil for Hopper (sm_90a), f32 (rows, cols) -> (rows, cols):
//   o = 0.5 x + 0.125 up + 0.125 down + 0.125 left + 0.125 right,
// neighbours edge-padded (clamped), summed left to right in that order.
// Replaces the Pallas kernel `repro/kernels/stencil.py` `make_kernel`
// (its pl.pallas_call at :58), the Hotspot analog of the paper's Fig. 8.
//
// Mapping: a program owns C row blocks of `block_rows` rows
// (`core/coarsening.py` `plan_rows` / `row_starts`): adjacent when
// consecutive, rows/C apart when gapped (the reference's
// reshape(c, rows/c, cols) view, `stencil.py:49-53`).  The reference gives a
// program whole rows; at 8192 columns con8 would leave 128 programs for 132
// SMs, so the columns are tiled too: grid (column tiles, programs), each
// thread block one program's rows over 256 * V columns.  Coarsening stays on
// the row axis.  Replication R splits the program axis (R, G/R) when R
// divides G (flat index blockIdx.z * (G/R) + blockIdx.y); V (simd) makes
// each thread own V adjacent columns, read and written as float2 / float4.
//
// The reference materialises the vertical halo as shifted copies of the
// whole grid; here each thread walks down its column strip of every row
// block with the rows above, at and below in registers, so each row of x is
// read once per block plus one halo row above and below it, and the
// horizontal neighbours at the strip's edges come from L1.
//
// Every product is by a power of two and the adds are __fadd_rn (never
// contracted), in the plain version's order: bit-equal to it.  PROBE
// (compile-time) stores the flat program index in place of the result.
//
// Bound on this card: 8 * rows * cols bytes (x read once, o written once)
// / 3.35 TB/s against 9 ops an element / 67 TFLOP/s: the bytes bind.
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec_io.cuh"

namespace {

constexpr int NTHREADS = 256;

template <int V, bool PROBE>
__global__ void __launch_bounds__(NTHREADS)
stencil5_kernel(const float* __restrict__ x, float* __restrict__ o, int rows,
                int cols, int block_rows, int c, int g, int gapped,
                int inner) {
  const int pid = inner ? blockIdx.z * inner + blockIdx.y : blockIdx.y;
  const int c0 = (blockIdx.x * NTHREADS + threadIdx.x) * V;
  if (c0 >= cols) return;
  for (int k = 0; k < c; ++k) {
    const int r0 = (gapped ? pid + k * g : pid * c + k) * block_rows;
    if constexpr (PROBE) {
      float s[V];
#pragma unroll
      for (int e = 0; e < V; ++e) s[e] = (float)pid;
      for (int r = r0; r < r0 + block_rows; ++r)
        vio::store<V>(o + (size_t)r * cols + c0, s);
      continue;
    }
    float up[V], mid[V], dn[V];
    vio::load<V>(x + (size_t)max(r0 - 1, 0) * cols + c0, up);
    vio::load<V>(x + (size_t)r0 * cols + c0, mid);
    for (int r = r0; r < r0 + block_rows; ++r) {
      vio::load<V>(x + (size_t)min(r + 1, rows - 1) * cols + c0, dn);
      const float* row = x + (size_t)r * cols;
      const float left = c0 > 0 ? __ldg(row + c0 - 1) : mid[0];
      const float right = c0 + V < cols ? __ldg(row + c0 + V) : mid[V - 1];
      float s[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float w = e > 0 ? mid[e - 1] : left;
        const float ea = e < V - 1 ? mid[e + 1] : right;
        float acc = __fmul_rn(0.5f, mid[e]);
        acc = __fadd_rn(acc, __fmul_rn(0.125f, up[e]));
        acc = __fadd_rn(acc, __fmul_rn(0.125f, dn[e]));
        acc = __fadd_rn(acc, __fmul_rn(0.125f, w));
        s[e] = __fadd_rn(acc, __fmul_rn(0.125f, ea));
      }
      vio::store<V>(o + (size_t)r * cols + c0, s);
#pragma unroll
      for (int e = 0; e < V; ++e) up[e] = mid[e], mid[e] = dn[e];
    }
  }
}

template <int V>
cudaError_t launch(const float* x, float* o, int rows, int cols,
                   int block_rows, int c, int g, int gapped, int r,
                   int probe, cudaStream_t st) {
  const int inner = (r > 1 && g % r == 0) ? g / r : 0;
  const unsigned tiles = (unsigned)((cols / V + NTHREADS - 1) / NTHREADS);
  const dim3 grid = inner ? dim3(tiles, inner, r) : dim3(tiles, g);
  if (probe)
    stencil5_kernel<V, true><<<grid, NTHREADS, 0, st>>>(
        x, o, rows, cols, block_rows, c, g, gapped, inner);
  else
    stencil5_kernel<V, false><<<grid, NTHREADS, 0, st>>>(
        x, o, rows, cols, block_rows, c, g, gapped, inner);
  return cudaGetLastError();
}

}  // namespace

// x, o: (rows, cols) f32, contiguous, 16-byte aligned; the plan is
// `plan_rows(rows, cfg, block_rows)`.
extern "C" int stencil5_f32(const void* x, void* o, int rows, int cols,
                            int block_rows, int degree, int gapped,
                            int replication, int vector_width, int probe,
                            void* stream) {
  if (rows < 1 || block_rows < 1 || degree < 1 || replication < 1 ||
      vector_width < 1 || cols % vector_width ||
      rows % (block_rows * degree))
    return (int)cudaErrorInvalidValue;
  const int g = rows / (block_rows * degree);
  const int inner = (replication > 1 && g % replication == 0)
                        ? g / replication : 0;
  if ((inner ? inner : g) > 65535 || replication > 65535)
    return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(o);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (vector_width) {
    case 1: return (int)launch<1>(xf, of, rows, cols, block_rows, degree, g, gapped, replication, probe, st);
    case 2: return (int)launch<2>(xf, of, rows, cols, block_rows, degree, g, gapped, replication, probe, st);
    case 4: return (int)launch<4>(xf, of, rows, cols, block_rows, degree, g, gapped, replication, probe, st);
    case 8: return (int)launch<8>(xf, of, rows, cols, block_rows, degree, g, gapped, replication, probe, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
