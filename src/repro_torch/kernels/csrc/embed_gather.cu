// Coarsened embedding gather: out[i, :] = table[ids[i], :] as float32.
//
// Replaces `repro/kernels/embed_gather.py` `make_kernel` (the
// `pl.pallas_call` at :50).  There, one grid program owns C id blocks of B
// ids, scalar-prefetched (`plan_stream(N, cfg, block=B)`): adjacent blocks
// (consecutive, one wide id DMA) or blocks G*B ids apart (gapped, C narrow
// DMAs), and gathers rows from a VMEM-resident table.
//
// Here one program of the same plan runs as S consecutive thread blocks
// (`embed_gather.split_plan` picks S on the host so that the grid holds at
// least four blocks an SM): block s of program i takes the program's rows
// [s*R, (s+1)*R), R = C*B/S, and stages only those ids in shared memory,
// read as the Pallas body indexes the table: an id in [-V, 0) wraps to
// id + V, then the index clamps to [0, V-1] (an id past the table reads its
// last row, an id below -V its first).  The block's R rows are then one
// flat list of 16-byte output units: each lane loads U units before it
// stores any (U = 8 float4s of a float32 table; U = 4 of a bf16 table,
// each 4 values, 8 bytes, widened exactly to float32: a bf16 value is the
// high half of its float32), so a warp's store instruction writes one
// contiguous 512-byte span.  Loads take the non-coherent path; the stores
// carry an evict-first hint (the output is written once and not read
// here).  The output is float32 whatever the table's type, as the Pallas
// kernel's (:58).
//
// A float32 table whose block rows fit `BULK_BYTES` moves whole rows with
// no lane touching a value (`embed_bulk_kernel`, one warp a block): each
// row is a 1-D bulk copy (TMA) from the table into shared memory,
// completing on one mbarrier, then a bulk copy from there to its output
// row.  At the qwen3-0.6b spec it is faster than the lane path and than
// `F.embedding` (`bench/gather_ab.py --cuts-this`).
//
// Bound on the H100: the ids, the N gathered rows and the N float32 output
// rows, each moved once, over 3.35 TB/s.  There is no arithmetic.  One
// block a program would run 32 blocks at N 8192, B 256 (4 at con8), a
// quarter of the SMs or less, each near one SM's load/store rate.
//
// probe = 1 writes each output row's program index (as float32) in place
// of the row, to hold the element-to-program map against the plan's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_ROWS = 1024;          // rows a block stages (4 KB of ids)
constexpr int BULK_BYTES = 64 * 1024;   // a bulk block's rows, at most

struct Plan {
  int c, b, g, gapped;
  int s, rows;                          // blocks a program, rows a block
};

// the stream position of row r (< C*B) of program i
__device__ __forceinline__ long long row_pos(const Plan& p, int i, int r) {
  const int k = r / p.b, j = r % p.b;
  return p.gapped ? ((long long)k * p.g + i) * p.b + j
                  : ((long long)i * p.c + k) * p.b + j;
}

__device__ __forceinline__ void widen(uint32_t w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

// 4 values of T at src (16 bytes of float32, 8 of bf16) -> a float4
template <typename T>
__device__ __forceinline__ float4 load_unit(const T* src);

template <>
__device__ __forceinline__ float4 load_unit<float>(const float* src) {
  return __ldg(reinterpret_cast<const float4*>(src));
}

template <>
__device__ __forceinline__ float4 load_unit<__nv_bfloat16>(
    const __nv_bfloat16* src) {
  const uint2 x = __ldg(reinterpret_cast<const uint2*>(src));
  float4 v;
  widen(x.x, v.x, v.y);
  widen(x.y, v.z, v.w);
  return v;
}

template <typename T, int U, bool PROBE>
__global__ void __launch_bounds__(NTHREADS)
    embed_gather_kernel(const int* __restrict__ ids,
                        const T* __restrict__ table, float* __restrict__ out,
                        Plan p, int vocab, int d) {
  __shared__ int rows[MAX_ROWS];        // this block's table rows
  const int i = blockIdx.x / p.s, r0 = (blockIdx.x % p.s) * p.rows;
  for (int r = threadIdx.x; r < p.rows; r += NTHREADS) {
    int id = __ldg(ids + row_pos(p, i, r0 + r));
    if (id < 0) id += vocab;
    rows[r] = min(max(id, 0), vocab - 1);
  }
  __syncthreads();
  const unsigned units = d / 4, total = (unsigned)p.rows * units;
  for (unsigned e0 = threadIdx.x; e0 < total; e0 += NTHREADS * U) {
    float4 v[U];
    long long dst[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned e = e0 + u * NTHREADS;
      if (e < total) {
        const unsigned r = e / units, c = e - r * units;
        dst[u] = row_pos(p, i, r0 + (int)r) * d + 4LL * c;
        v[u] = PROBE ? make_float4((float)i, (float)i, (float)i, (float)i)
                     : load_unit<T>(table + (long long)rows[r] * d + 4LL * c);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (e0 + u * NTHREADS < total)
        __stcs(reinterpret_cast<float4*>(out + dst[u]), v[u]);
  }
}

// `bytes` (a multiple of 16) of shared src -> global dst, in this thread's
// bulk group
__device__ __forceinline__ void bulk_store(float* dst, uint32_t src,
                                           int bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
}

template <bool PROBE>
__global__ void __launch_bounds__(32)
    embed_bulk_kernel(const int* __restrict__ ids,
                      const float* __restrict__ table,
                      float* __restrict__ out, Plan p, int vocab, int d) {
  extern __shared__ __align__(128) float buf[];   // the block's rows
  __shared__ __align__(8) uint64_t bar;
  const int i = blockIdx.x / p.s, r0 = (blockIdx.x % p.s) * p.rows;
  const int lane = threadIdx.x;
  if (PROBE) {
    for (int e = lane; e < p.rows * d; e += 32) buf[e] = (float)i;
    hop::fence_async_smem();
    __syncwarp();
  } else {
    const uint32_t b = hop::smem_u32(&bar);
    if (lane == 0) {
      hop::bar_init<1>(b);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      hop::bar_expect(b, p.rows * d * 4);
    }
    __syncwarp();
    for (int r = lane; r < p.rows; r += 32) {
      int id = __ldg(ids + row_pos(p, i, r0 + r));
      if (id < 0) id += vocab;
      id = min(max(id, 0), vocab - 1);
      hop::bulk_1d(hop::smem_u32(buf + (long long)r * d),
                   table + (long long)id * d, d * 4, b);
    }
    hop::bar_wait(b, 0);
  }
  for (int r = lane; r < p.rows; r += 32)
    bulk_store(out + row_pos(p, i, r0 + r) * d,
               hop::smem_u32(buf + (long long)r * d), d * 4);
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

cudaError_t launch_bulk(const int* ids, const float* table, float* out,
                        const Plan& p, int vocab, int d, int probe,
                        cudaStream_t st) {
  const int smem = p.rows * d * 4;
  const unsigned grid = (unsigned)p.g * p.s;
  auto kernel = probe ? embed_bulk_kernel<true> : embed_bulk_kernel<false>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, 32, smem, st>>>(ids, table, out, p, vocab, d);
  return cudaGetLastError();
}

template <typename T, int U>
cudaError_t launch(const int* ids, const void* table, float* out,
                   const Plan& p, int vocab, int d, int probe,
                   cudaStream_t st) {
  const T* t = static_cast<const T*>(table);
  const unsigned grid = (unsigned)p.g * p.s;
  if (probe)
    embed_gather_kernel<T, U, true><<<grid, NTHREADS, 0, st>>>(ids, t, out,
                                                              p, vocab, d);
  else
    embed_gather_kernel<T, U, false><<<grid, NTHREADS, 0, st>>>(ids, t, out,
                                                               p, vocab, d);
  return cudaGetLastError();
}

}  // namespace

// ids: (n,) int32; table: (vocab, d) float32 (table_bf16 = 0) or bf16, both
// contiguous and 16-byte aligned; out: (n, d) float32.  The plan is
// `plan_stream(n, cfg, block)` (n % (block * degree) == 0), each program
// run as `split` blocks of block * degree / split rows
// (`embed_gather.split_plan`).
extern "C" int embed_gather(const void* ids, const void* table, void* out,
                            int n, int vocab, int d, int table_bf16,
                            int block, int degree, int gapped, int split,
                            int probe, void* stream) {
  if (n < 1 || vocab < 1 || d < 4 || d % 4 || block < 1 || degree < 1 ||
      split < 1 || n % (block * degree) || (block * degree) % split ||
      (block * degree) / split > MAX_ROWS ||
      (long long)(block * degree / split) * (d / 4) > 0xffffffffLL ||
      (long long)(n / (block * degree)) * split > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Plan p{degree, block, n / (block * degree), gapped, split,
               block * degree / split};
  const int* ix = static_cast<const int*>(ids);
  float* o = static_cast<float*>(out);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (!table_bf16 && (long long)p.rows * d * 4 <= BULK_BYTES)
    return (int)launch_bulk(ix, static_cast<const float*>(table), o, p, vocab,
                            d, probe, st);
  if (!table_bf16)
    return (int)launch<float, 8>(ix, table, o, p, vocab, d, probe, st);
  return (int)launch<__nv_bfloat16, 4>(ix, table, o, p, vocab, d, probe,
                                       st);
}
