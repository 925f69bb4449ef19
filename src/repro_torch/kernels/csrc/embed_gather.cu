// Coarsened embedding gather: out[i, :] = table[ids[i], :] as float32.
//
// Replaces `repro/kernels/embed_gather.py` `make_kernel` (the
// `pl.pallas_call` at :50).  There, one grid program owns C id blocks of B
// ids, scalar-prefetched (`plan_stream(N, cfg, block=B)`): adjacent blocks
// (consecutive, one wide id DMA) or blocks G*B ids apart (gapped, C narrow
// DMAs), and gathers rows from a VMEM-resident table.
//
// Here one thread block is one program of the same plan.  Its C*B ids are
// read once into shared memory as the Pallas body indexes the table: an id
// in [-V, 0) wraps to id + V, then the index clamps to [0, V-1] (an id past
// the table reads its last row, an id below -V its first).  Each warp then copies whole rows, lane by lane in
// 16-byte units: a float4 of a float32 table, or 8 bf16 values widened
// exactly to float32 (a bf16 value is the high half of its float32) and
// stored as two float4s; a bf16 row of d % 8 != 0 values moves 4 values
// (8 bytes) a unit.  The output is float32 whatever the table's type, as
// the Pallas kernel's (:58).
//
// Bound on the H100: the ids, the N gathered rows and the N float32 output
// rows, each moved once, over 3.35 TB/s.  There is no arithmetic.  The
// design's limit is the plan's: N / (C*B) blocks, so at N 8192, B 256 the
// card runs 32 blocks at base and 4 at con8; each block keeps 1024
// threads' loads in flight to make up part of that.
//
// probe = 1 writes each output row's program index (as float32) in place
// of the row, to hold the element-to-program map against the plan's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NTHREADS = 1024;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAX_STAGED = 12 * 1024;   // ids a block stages (48 KB)

struct Plan {
  int c, b, g, gapped;
};

// the stream position of row r (< C*B) of program i
__device__ __forceinline__ long long row_pos(const Plan& p, int i, int r) {
  const int k = r / p.b, j = r % p.b;
  return p.gapped ? ((long long)k * p.g + i) * p.b + j
                  : ((long long)i * p.c + k) * p.b + j;
}

__device__ __forceinline__ void widen(uint32_t w, float* v) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}

// U values of T at src (16 or 8 bytes) -> U floats
template <typename T, int U>
__device__ __forceinline__ void load_unit(const T* src, float* v);

template <>
__device__ __forceinline__ void load_unit<float, 4>(const float* src,
                                                    float* v) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(src));
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}

template <>
__device__ __forceinline__ void load_unit<__nv_bfloat16, 8>(
    const __nv_bfloat16* src, float* v) {
  const uint4 x = __ldg(reinterpret_cast<const uint4*>(src));
  widen(x.x, v), widen(x.y, v + 2), widen(x.z, v + 4), widen(x.w, v + 6);
}

template <>
__device__ __forceinline__ void load_unit<__nv_bfloat16, 4>(
    const __nv_bfloat16* src, float* v) {
  const uint2 x = __ldg(reinterpret_cast<const uint2*>(src));
  widen(x.x, v), widen(x.y, v + 2);
}

template <typename T, int U, bool PROBE>
__global__ void __launch_bounds__(NTHREADS)
    embed_gather_kernel(const int* __restrict__ ids,
                        const T* __restrict__ table, float* __restrict__ out,
                        Plan p, int vocab, int d) {
  extern __shared__ int rows[];               // the program's C*B table rows
  const int i = blockIdx.x, n_rows = p.c * p.b;
  for (int r = threadIdx.x; r < n_rows; r += NTHREADS) {
    int id = __ldg(ids + row_pos(p, i, r));
    if (id < 0) id += vocab;
    rows[r] = min(max(id, 0), vocab - 1);
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int units = d / U;
  for (int r = warp; r < n_rows; r += NWARPS) {
    float* o = out + row_pos(p, i, r) * d;
    const T* src = table + (long long)rows[r] * d;
#pragma unroll 4
    for (int u = lane; u < units; u += 32) {
      float v[U];
      if (PROBE) {
#pragma unroll
        for (int q = 0; q < U; ++q) v[q] = (float)i;
      } else {
        load_unit<T, U>(src + (long long)u * U, v);
      }
      float4* dst = reinterpret_cast<float4*>(o + (long long)u * U);
#pragma unroll
      for (int q = 0; q < U / 4; ++q)
        dst[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                             v[4 * q + 3]);
    }
  }
}

template <typename T, int U>
cudaError_t launch(const int* ids, const void* table, float* out,
                   const Plan& p, int vocab, int d, int probe,
                   cudaStream_t st) {
  const size_t smem = (size_t)p.c * p.b * sizeof(int);
  const T* t = static_cast<const T*>(table);
  if (probe)
    embed_gather_kernel<T, U, true><<<p.g, NTHREADS, smem, st>>>(
        ids, t, out, p, vocab, d);
  else
    embed_gather_kernel<T, U, false><<<p.g, NTHREADS, smem, st>>>(
        ids, t, out, p, vocab, d);
  return cudaGetLastError();
}

}  // namespace

// ids: (n,) int32; table: (vocab, d) float32 (table_bf16 = 0) or bf16, both
// contiguous and 16-byte aligned; out: (n, d) float32.  The plan is
// `plan_stream(n, cfg, block)`: n % (block * degree) == 0.
extern "C" int embed_gather(const void* ids, const void* table, void* out,
                            int n, int vocab, int d, int table_bf16,
                            int block, int degree, int gapped, int probe,
                            void* stream) {
  if (n < 1 || vocab < 1 || d < 4 || d % 4 || block < 1 || degree < 1 ||
      n % (block * degree) || (long long)block * degree > MAX_STAGED)
    return (int)cudaErrorInvalidValue;
  const Plan p{degree, block, n / (block * degree), gapped};
  const int* ix = static_cast<const int*>(ids);
  float* o = static_cast<float*>(out);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (!table_bf16)
    return (int)launch<float, 4>(ix, table, o, p, vocab, d, probe, st);
  if (d % 8 == 0)
    return (int)launch<__nv_bfloat16, 8>(ix, table, o, p, vocab, d, probe,
                                         st);
  return (int)launch<__nv_bfloat16, 4>(ix, table, o, p, vocab, d, probe, st);
}
