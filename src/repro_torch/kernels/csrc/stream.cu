// The paper's streaming microbenchmarks for Hopper (sm_90a), f32:
//
//   ew_stream_f32     — the Fig. 6 template: n_loads streams -> a chain of
//                       ai * (n_loads + 1) ops under one of seven divergence
//                       variants -> one stream.  Replaces the Pallas kernel
//                       built by `repro/core/coarsening.py` `pallas_stream_call`
//                       (its pl.pallas_call at :233) for
//                       `repro/kernels/ew_stream.py` `make_kernel` (:107).
//   gather_stream_f32 — out[i] = chain(t0[idx[i]], ..., t{L-1}[idx[i]]).
//                       Replaces `repro/kernels/gather_stream.py` `make_kernel`
//                       (pl.pallas_call at :65).
//
// Mapping: one CUDA thread block is one Pallas program.  It owns the
// (C, B) tile of the stream plan (`core/coarsening.py` `plan_stream`; B is
// the block already widened by the vector width V): row k of program i is
// elements [(i*C + k)*B, +B) when consecutive and [k*G*B + i*B, +B) when
// gapped.  Consecutive and gapped differ only in which addresses a block
// reads.  The 256 threads walk the tile in V-wide vectors (float2 / float4,
// the analog of num_simd_work_items), neighbouring threads on neighbouring
// addresses.  Replication R splits the grid (R, G/R) when R divides G; the
// flat program index is blockIdx.y * (G/R) + blockIdx.x (`flat_pid`).  On
// the GPU every block runs in parallel anyway, so R changes nothing but the
// grid's shape.
//
// The chain: `_arith_chain` of `repro/kernels/ew_stream.py:42`, in
// `arith_chain.cuh` (shared with `windowed_gather.cu`): the kernel equals
// its plain version bit for bit.
//
// Variants (template parameter): if_id / if_in branch per element and
// compute only the taken side; div2 / div4 compute only the selected path;
// for_in_if_in runs its data-bound loop for real, exiting after `bound`
// trips, where the reference runs 8 trips with a mask: a masked trip
// leaves acc unchanged, so the result is the same, and the data-bound exit
// is the behaviour the paper measures (a loop whose trip count is data).
//
// PROBE (compile-time) stores the flat program index in place of the
// result, so a caller can hold the element-to-program map against the plan.
//
// Bound on this card: bytes / 3.35 TB/s (each input read once, the output
// written once; for the gather the touched table entries once) against
// ops / 67 TFLOP/s (fp32 CUDA cores).  At the paper's AI of 1-10 the bytes
// bind; the design's answer is coalesced 4-32 byte vector loads and nothing
// staged through shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

#include "arith_chain.cuh"
#include "vec_io.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_LOADS = 8;
constexpr int FOR_CONST_TRIPS = 5, FOR_IN_MAX_TRIPS = 8;
enum Variant { BASE, IF_ID, IF_IN, FOR_CONST_IF_ID, FOR_IN_IF_IN, DIV2, DIV4 };

struct Ptrs {
  const float* p[MAX_LOADS];
};

// floor(|x| * scale) as int32 % mod (scale a power of two: exact)
__device__ __forceinline__ int bucket(float x, float scale, int mod) {
  return (int)floorf(__fmul_rn(fabsf(x), scale)) % mod;
}

// `chain([acc] + regs[1:], k)`
template <int NL>
__device__ __forceinline__ float chain_from(float acc, const float (&r)[NL],
                                            int k) {
  float r2[NL];
#pragma unroll
  for (int l = 0; l < NL; ++l) r2[l] = l == 0 ? acc : r[l];
  return chain<NL, 0>(r2, k);
}

// `_variant_compute` of `repro/kernels/ew_stream.py:63` for one element
template <int NL, int VAR>
__device__ __forceinline__ float compute(const float (&r)[NL], long long gid,
                                         int n_arith) {
  if constexpr (VAR == BASE) {
    return chain<NL, 0>(r, n_arith);
  } else if constexpr (VAR == IF_ID) {
    return gid % 2 == 0 ? chain<NL, 0>(r, n_arith) : r[0];
  } else if constexpr (VAR == IF_IN) {
    return bucket(r[NL - 1], 16.f, 2) == 0 ? chain<NL, 0>(r, n_arith) : r[0];
  } else if constexpr (VAR == FOR_CONST_IF_ID) {
    const int k = max(1, n_arith / FOR_CONST_TRIPS);
    float acc = r[0];
    for (int t = 0; t < FOR_CONST_TRIPS; ++t)
      if (gid % 2 == 0) acc = chain_from<NL>(acc, r, k);
    return acc;
  } else if constexpr (VAR == FOR_IN_IF_IN) {
    // the wrapper refuses n_loads < 2 here (the reference reads regs[-2])
    const int bound = bucket(r[NL - 1], 8.f, FOR_IN_MAX_TRIPS);
    const bool pred = bucket(r[NL >= 2 ? NL - 2 : 0], 16.f, 2) == 0;
    const int k = max(1, n_arith / FOR_IN_MAX_TRIPS);
    float acc = r[0];
    for (int t = 0; t < bound; ++t)
      if (pred) acc = chain_from<NL>(acc, r, k);
    return acc;
  } else {
    constexpr int D = VAR == DIV2 ? 2 : 4;
    const int k = max(1, n_arith);
    switch (bucket(r[NL - 1], 16.f, D)) {
      case 1: return chain<NL, 1>(r, k);
      case 2: return chain<NL, 2>(r, k);
      case 3: return chain<NL, 3>(r, k);
      default: return chain<NL, 0>(r, k);
    }
  }
}

template <int V>
__device__ __forceinline__ void load_idx(const int* p, int (&d)[V]) {
  if constexpr (V == 1) {
    d[0] = __ldg(p);
  } else if constexpr (V == 2) {
    const int2 t = __ldg(reinterpret_cast<const int2*>(p));
    d[0] = t.x, d[1] = t.y;
  } else {
#pragma unroll
    for (int h = 0; h < V / 4; ++h) {
      const int4 t = __ldg(reinterpret_cast<const int4*>(p) + h);
      d[4 * h] = t.x, d[4 * h + 1] = t.y, d[4 * h + 2] = t.z,
      d[4 * h + 3] = t.w;
    }
  }
}

struct Plan {
  int c, b, g, gapped, inner;   // inner = G/R on an (R, G/R) grid, else 0
};

__device__ __forceinline__ int program_id(const Plan& pl) {
  return pl.inner ? blockIdx.y * pl.inner + blockIdx.x : blockIdx.x;
}

// first element of vector v of program pid's (C, B) tile
template <int V>
__device__ __forceinline__ long long tile_elem(const Plan& pl, int pid, int v) {
  const int per_row = pl.b / V;
  const int k = v / per_row, j = (v % per_row) * V;
  return pl.gapped ? (long long)k * pl.g * pl.b + (long long)pid * pl.b + j
                   : ((long long)pid * pl.c + k) * pl.b + j;
}

template <int NL, int VAR, int V, bool PROBE>
__global__ void __launch_bounds__(NTHREADS)
ew_stream_kernel(Ptrs in, float* __restrict__ out, Plan pl, int n_arith) {
  const int pid = program_id(pl);
  const int tile_vecs = pl.c * (pl.b / V);
  for (int v = threadIdx.x; v < tile_vecs; v += NTHREADS) {
    const long long e0 = tile_elem<V>(pl, pid, v);
    float o[V];
    if constexpr (PROBE) {
#pragma unroll
      for (int e = 0; e < V; ++e) o[e] = (float)pid;
    } else {
      float x[NL][V];
#pragma unroll
      for (int l = 0; l < NL; ++l) vio::load<V>(in.p[l] + e0, x[l]);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float r[NL];
#pragma unroll
        for (int l = 0; l < NL; ++l) r[l] = x[l][e];
        o[e] = compute<NL, VAR>(r, e0 + e, n_arith);
      }
    }
    vio::store<V>(out + e0, o);
  }
}

template <int NL, int V, bool PROBE>
__global__ void __launch_bounds__(NTHREADS)
gather_stream_kernel(const int* __restrict__ idx, Ptrs tables,
                     float* __restrict__ out, Plan pl, int n_arith) {
  const int pid = program_id(pl);
  const int tile_vecs = pl.c * (pl.b / V);
  for (int v = threadIdx.x; v < tile_vecs; v += NTHREADS) {
    const long long e0 = tile_elem<V>(pl, pid, v);
    float o[V];
    if constexpr (PROBE) {
#pragma unroll
      for (int e = 0; e < V; ++e) o[e] = (float)pid;
    } else {
      int ix[V];
      load_idx<V>(idx + e0, ix);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float r[NL];
#pragma unroll
        for (int l = 0; l < NL; ++l) r[l] = __ldg(tables.p[l] + ix[e]);
        o[e] = chain<NL, 0>(r, n_arith);
      }
    }
    vio::store<V>(out + e0, o);
  }
}

bool make_plan(long long n, int block, int c, int gapped, int r, int vw,
               Plan* pl, dim3* grid) {
  const long long b = (long long)block * vw;
  if (c < 1 || r < 1 || b < vw || b % vw || n % (b * c)) return false;
  const long long g = n / (b * c);
  if (g > INT32_MAX || b > INT32_MAX) return false;
  pl->c = c, pl->b = (int)b, pl->g = (int)g, pl->gapped = gapped;
  if (r > 1 && g % r == 0) {
    if (r > 65535) return false;
    pl->inner = (int)(g / r);
    *grid = dim3(pl->inner, r);
  } else {
    pl->inner = 0;
    *grid = dim3((unsigned)g);
  }
  return true;
}

template <int NL, int VAR, int V>
cudaError_t launch_ew(Ptrs in, float* out, Plan pl, dim3 grid, int n_arith,
                      int probe, cudaStream_t st) {
  if (probe)
    ew_stream_kernel<NL, BASE, V, true><<<grid, NTHREADS, 0, st>>>(
        in, out, pl, n_arith);
  else
    ew_stream_kernel<NL, VAR, V, false><<<grid, NTHREADS, 0, st>>>(
        in, out, pl, n_arith);
  return cudaGetLastError();
}

template <int NL, int VAR>
cudaError_t ew_by_width(int vw, Ptrs in, float* out, Plan pl, dim3 grid,
                        int n_arith, int probe, cudaStream_t st) {
  switch (vw) {
    case 1: return launch_ew<NL, VAR, 1>(in, out, pl, grid, n_arith, probe, st);
    case 2: return launch_ew<NL, VAR, 2>(in, out, pl, grid, n_arith, probe, st);
    case 4: return launch_ew<NL, VAR, 4>(in, out, pl, grid, n_arith, probe, st);
    case 8: return launch_ew<NL, VAR, 8>(in, out, pl, grid, n_arith, probe, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int NL>
cudaError_t ew_by_variant(int variant, int vw, Ptrs in, float* out, Plan pl,
                          dim3 grid, int n_arith, int probe, cudaStream_t st) {
  switch (variant) {
    case BASE: return ew_by_width<NL, BASE>(vw, in, out, pl, grid, n_arith, probe, st);
    case IF_ID: return ew_by_width<NL, IF_ID>(vw, in, out, pl, grid, n_arith, probe, st);
    case IF_IN: return ew_by_width<NL, IF_IN>(vw, in, out, pl, grid, n_arith, probe, st);
    case FOR_CONST_IF_ID:
      return ew_by_width<NL, FOR_CONST_IF_ID>(vw, in, out, pl, grid, n_arith, probe, st);
    case FOR_IN_IF_IN:
      if (NL < 2) return cudaErrorInvalidValue;
      return ew_by_width<NL, FOR_IN_IF_IN>(vw, in, out, pl, grid, n_arith, probe, st);
    case DIV2: return ew_by_width<NL, DIV2>(vw, in, out, pl, grid, n_arith, probe, st);
    case DIV4: return ew_by_width<NL, DIV4>(vw, in, out, pl, grid, n_arith, probe, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int NL, int V>
cudaError_t launch_gather(const int* idx, Ptrs t, float* out, Plan pl,
                          dim3 grid, int n_arith, int probe, cudaStream_t st) {
  if (probe)
    gather_stream_kernel<NL, V, true><<<grid, NTHREADS, 0, st>>>(
        idx, t, out, pl, n_arith);
  else
    gather_stream_kernel<NL, V, false><<<grid, NTHREADS, 0, st>>>(
        idx, t, out, pl, n_arith);
  return cudaGetLastError();
}

template <int NL>
cudaError_t gather_by_width(int vw, const int* idx, Ptrs t, float* out,
                            Plan pl, dim3 grid, int n_arith, int probe,
                            cudaStream_t st) {
  switch (vw) {
    case 1: return launch_gather<NL, 1>(idx, t, out, pl, grid, n_arith, probe, st);
    case 2: return launch_gather<NL, 2>(idx, t, out, pl, grid, n_arith, probe, st);
    case 4: return launch_gather<NL, 4>(idx, t, out, pl, grid, n_arith, probe, st);
    case 8: return launch_gather<NL, 8>(idx, t, out, pl, grid, n_arith, probe, st);
    default: return cudaErrorInvalidValue;
  }
}

Ptrs pack(const void* const* p, int n) {
  Ptrs r{};
  for (int l = 0; l < n; ++l) r.p[l] = static_cast<const float*>(p[l]);
  return r;
}

}  // namespace

// ins: n_loads device pointers (n_loads in 1..8), each (n,) f32; out (n,).
// The plan is `plan_stream(n, cfg, block)`; variant indexes VARIANTS.
extern "C" int ew_stream_f32(const void* const* ins, int n_loads, void* out,
                             long long n, int block, int degree, int gapped,
                             int replication, int vector_width, int variant,
                             int n_arith, int probe, void* stream) {
  Plan pl;
  dim3 grid;
  if (n_loads < 1 || n_loads > MAX_LOADS ||
      !make_plan(n, block, degree, gapped, replication, vector_width, &pl,
                 &grid))
    return (int)cudaErrorInvalidValue;
  const Ptrs in = pack(ins, n_loads);
  float* o = static_cast<float*>(out);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (n_loads) {
    case 1: return (int)ew_by_variant<1>(variant, vector_width, in, o, pl, grid, n_arith, probe, st);
    case 2: return (int)ew_by_variant<2>(variant, vector_width, in, o, pl, grid, n_arith, probe, st);
    case 3: return (int)ew_by_variant<3>(variant, vector_width, in, o, pl, grid, n_arith, probe, st);
    case 4: return (int)ew_by_variant<4>(variant, vector_width, in, o, pl, grid, n_arith, probe, st);
    case 5: return (int)ew_by_variant<5>(variant, vector_width, in, o, pl, grid, n_arith, probe, st);
    case 6: return (int)ew_by_variant<6>(variant, vector_width, in, o, pl, grid, n_arith, probe, st);
    case 7: return (int)ew_by_variant<7>(variant, vector_width, in, o, pl, grid, n_arith, probe, st);
    default: return (int)ew_by_variant<8>(variant, vector_width, in, o, pl, grid, n_arith, probe, st);
  }
}

// idx (n,) int32 in [0, table); tables: n_tables pointers to (table,) f32.
extern "C" int gather_stream_f32(const void* idx, const void* const* tables,
                                 int n_tables, void* out, long long n,
                                 int block, int degree, int gapped,
                                 int replication, int vector_width,
                                 int n_arith, int probe, void* stream) {
  Plan pl;
  dim3 grid;
  if (n_tables < 1 || n_tables > MAX_LOADS ||
      !make_plan(n, block, degree, gapped, replication, vector_width, &pl,
                 &grid))
    return (int)cudaErrorInvalidValue;
  const Ptrs t = pack(tables, n_tables);
  const int* ix = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (n_tables) {
    case 1: return (int)gather_by_width<1>(vector_width, ix, t, o, pl, grid, n_arith, probe, st);
    case 2: return (int)gather_by_width<2>(vector_width, ix, t, o, pl, grid, n_arith, probe, st);
    case 3: return (int)gather_by_width<3>(vector_width, ix, t, o, pl, grid, n_arith, probe, st);
    case 4: return (int)gather_by_width<4>(vector_width, ix, t, o, pl, grid, n_arith, probe, st);
    case 5: return (int)gather_by_width<5>(vector_width, ix, t, o, pl, grid, n_arith, probe, st);
    case 6: return (int)gather_by_width<6>(vector_width, ix, t, o, pl, grid, n_arith, probe, st);
    case 7: return (int)gather_by_width<7>(vector_width, ix, t, o, pl, grid, n_arith, probe, st);
    default: return (int)gather_by_width<8>(vector_width, ix, t, o, pl, grid, n_arith, probe, st);
  }
}
