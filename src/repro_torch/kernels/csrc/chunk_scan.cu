// DP min-scan for Hopper (sm_90a), f32 (rows, cols) -> (rows, cols):
//   dist[0] = cost[0];  dist[t] = cost[t] + min(dist[t-1] shifted -1, 0, +1)
// with the row's edges clamped.  Replaces the Pallas kernel
// `repro/kernels/chunk_scan.py` `make_kernel` (its pl.pallas_call at :55),
// the Pathfinder analog of the paper's Fig. 8.
//
// Each row depends on the whole previous row, which thread blocks cannot
// share inside one launch without a grid-wide barrier.  The TPU kernel runs
// its grid in order and carries the row in VMEM; here the carry goes
// through device memory and a launch is the barrier: one launch per C rows
// (C = 1 for base, C for consecutive conC; gapped is refused, as the
// reference refuses it: interleaved rows break the carry).  In a launch
// each block owns a tile of W columns and loads the previous row over the
// tile plus a ghost zone of C columns on each side into shared memory, then
// computes C rows in place, the valid range shrinking by one column a side
// each row: the "pyramid" of Rodinia's Pathfinder.  Consecutive coarsening
// thus trades launches and round trips of the carry through device memory
// for 2*C*(C+1)/2 recomputed halo cells a tile a launch — the paper's
// trade.  The host loop of rows/C launches runs in this library, on the
// caller's stream.
//
// min is exact and the one add is __fadd_rn: bit-equal to the plain version.
//
// Bound on this card: 8 * rows * cols bytes (cost read once, dist written
// once) / 3.35 TB/s against 4 ops an element / 67 TFLOP/s: the bytes bind.
// At 1024 rows a base call is 1024 launches of ~12 MiB each, so launch
// latency sits beside the bytes; coarsening divides it by C.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int W = 1024;            // tile columns a block owns

__global__ void __launch_bounds__(NTHREADS)
dp_scan_kernel(const float* __restrict__ cost, float* __restrict__ out,
               int cols, int t0, int c) {
  extern __shared__ float sm[];
  const int span = W + 2 * c;
  float* a = sm;
  float* b = sm + span;
  const long long g0 = (long long)blockIdx.x * W - c;  // column of a[0]
  const float* src = t0 == 0 ? cost : out + (size_t)(t0 - 1) * cols;
  for (int p = threadIdx.x; p < span; p += NTHREADS) {
    const long long gc = g0 + p;
    a[p] = (gc >= 0 && gc < cols) ? src[gc] : 0.f;
  }
  __syncthreads();
  int k0 = 0;
  if (t0 == 0) {                   // row 0 is cost[0] itself
    for (int p = c + threadIdx.x; p < c + W; p += NTHREADS) {
      const long long gc = g0 + p;
      if (gc < cols) out[gc] = a[p];
    }
    k0 = 1;
  }
  for (int k = k0; k < c; ++k) {
    const float* crow = cost + (size_t)(t0 + k) * cols;
    float* orow = out + (size_t)(t0 + k) * cols;
    for (int p = k + 1 + threadIdx.x; p < span - 1 - k; p += NTHREADS) {
      const long long gc = g0 + p;
      if (gc < 0 || gc >= cols) continue;
      const float mid = a[p];
      const float left = gc > 0 ? a[p - 1] : mid;
      const float right = gc < cols - 1 ? a[p + 1] : mid;
      const float v = __fadd_rn(__ldg(crow + gc), fminf(mid, fminf(left, right)));
      b[p] = v;
      if (p >= c && p < c + W) orow[gc] = v;
    }
    __syncthreads();
    float* t = a;
    a = b;
    b = t;
  }
}

}  // namespace

// cost, out: (rows, cols) f32, contiguous.  Launches rows / degree kernels
// on the stream; returns the first launch error.
extern "C" int dp_scan_f32(const void* cost, void* out, int rows, int cols,
                           int degree, void* stream) {
  if (rows < 1 || cols < 1 || degree < 1 || rows % degree ||
      degree > 4096)
    return (int)cudaErrorInvalidValue;
  const float* cf = static_cast<const float*>(cost);
  float* of = static_cast<float*>(out);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const unsigned tiles = (unsigned)((cols + W - 1) / W);
  const size_t smem = 2 * (W + 2 * (size_t)degree) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dp_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  for (int t0 = 0; t0 < rows; t0 += degree) {
    dp_scan_kernel<<<tiles, NTHREADS, smem, st>>>(cf, of, cols, t0, degree);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
