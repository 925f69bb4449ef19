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
// ew_stream: one CUDA thread block is one Pallas program.  It owns the
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
// gather_stream: the reference keeps every table resident in VMEM (its
// "in-VMEM gather", :58-61) and the paper's compiler builds a cached LSU
// for the same reason; here a window of every table is kept in shared
// memory (`gw::gather_window_kernel`, below).  Read through L1 instead, a
// warp's 32 ids random in a 4096-wide window touch ~28 lines and L1 serves
// about one line a clock; shared memory serves them in ~3.5 bank passes.
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
// bind; ew_stream's answer is coalesced 4-32 byte vector loads and nothing
// staged through shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

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

Ptrs pack(const void* const* p, int n) {
  Ptrs r{};
  for (int l = 0; l < n; ++l) r.p[l] = static_cast<const float*>(p[l]);
  return r;
}


// -- gather_stream: persistent blocks, a window of every table in shared
// memory.  About one block an SM (the wrapper's `blocks`); block x takes
// programs [G*x/P, G*(x+1)/P) in program order, within a program its C
// rows (`tile_elem`'s order) and within a row pieces of `ps` ids.  The
// block fetches the ids of a batch of pieces two batches ahead (into
// registers while the current batch is served, then into shared memory)
// and takes each piece's min and max.  Thread 0 then decides each piece of
// the batch (`decide`): inside the staged span -> served from it; else
// the union of its span with the following pieces' (up to the end of the
// next batch) while it fits the window, staged when the lookups it serves
// are at least the 32-byte sectors it moves (ids * 8 >= entries) -> STAGE;
// else DIRECT, the tables read through L1/L2 with 8 * EU lookups a thread
// in flight.  `gather_stream.walk` emulates these decisions on the host.
// A staged span moves in coalesced 16-byte copies from L2, one window for
// a 4096-run of `make_indices` at locality 4096 (4 base programs, one con4
// program); gapped rows lie G*B ids apart, so each restages or reads
// directly (the paper's F2).  Either path is right for any id in
// [0, table).  The walk's index arithmetic is 32-bit, with shifts where
// the piece is a power of two: a 64-bit division is a long software
// routine, and thread 0's decisions and every id fetch lie on the block's
// path between barriers.  The chain runs on EU * V elements in step
// (`chains`): with one block an SM, 16 warps cannot hide one element's
// chain of dependent adds.  probe 1 stores the program index, probe 2 1.0
// for an element served from the window and 0.0 for one read directly.
namespace gw {

constexpr int NT = 512;                 // threads a block
constexpr int PIECE_MAX = 1024;         // ids a piece
constexpr int BATCH_IDS = 4096;         // ids a batch
constexpr int KMAX = 16;                // pieces a batch
// the window, every table together: 4352 entries a table at 8 tables (a
// 4096-run and its 16-byte alignment).  The block then takes 171 KB of
// shared memory, and the SM's carve-out leaves 60 KB of L1, which holds
// the direct path's misses in flight: with a 192 KB window (28 KB of L1)
// the fully random cell reads ~19% slower (`bench/gather_ab.py
// --cuts-this`).
constexpr int WINDOW_BYTES = 139264;
constexpr int SLOTS = BATCH_IDS / NT;   // ids a thread fetches a batch
// the two parts `bench/gather_ab.py --cuts-this` cuts out
constexpr bool USE_WINDOW = true;
constexpr bool REUSE = true;
enum Act { DIRECT = 0, SMEM = 1, STAGE = 2 };

struct Walk {
  long long g;                          // programs
  int c, b, gapped;                     // the plan (b widened by V)
  int ps, pps, k, w, tlen;              // piece, pieces a row, pieces a
                                        // batch, window entries a table,
                                        // table length
  int ps_shift;                         // log2(ps), or -1
};

struct Shared {                         // the batches' pieces and decisions
  long long start[4][KMAX];             // batches t..t+3, by t & 3
  int pid[4][KMAX];
  int lo[2][KMAX], hi[2][KMAX];         // batches t, t+1, by t & 1
  int act[KMAX], base[KMAX], count[KMAX];
};

struct Win {                            // the staged span (thread 0's)
  int lo, hi, a, pid;
};

// x / d for d = 1 << shift when shift >= 0 (the pieces of every shipped
// label), else by division
__device__ __forceinline__ int quot(int x, int d, int shift) {
  return shift >= 0 ? x >> shift : x / d;
}

// the last KMAX threads: first stream position and program of each piece
// of batch tt (slot tt & 3), in 32-bit arithmetic but the position
__device__ __forceinline__ void plan_batch(Shared& sh, const Walk& w,
                                           long long p0, int nq, int tt) {
  const int j = (int)threadIdx.x - (NT - KMAX);
  if (j < 0 || j >= w.k) return;
  const int q = tt * w.k + j;
  long long start = 0;
  int pid = -1;
  if (q < nq) {
    const int pp = w.c * w.pps, pr = q / pp, r = q - pr * pp;
    const int k = r / w.pps, jj = r - k * w.pps;
    const long long p = p0 + pr;
    pid = (int)p;
    start = (w.gapped ? ((long long)k * w.g + p) * w.b
                      : (p * w.c + k) * w.b) + (long long)jj * w.ps;
  }
  sh.start[tt & 3][j] = start;
  sh.pid[tt & 3][j] = pid;
}

// entries of [lo & ~3, (hi | 3] + 1): the span in 16-byte copies
__device__ __forceinline__ long long aligned_span(int lo, int hi) {
  return ((long long)(hi | 3) + 1) - (lo & ~3);
}

// batch tt's ids into registers, F at a time: 16-byte loads where the
// piece tiles by 4 ids (every shipped label), else one id a load
template <int F>
__device__ __forceinline__ void fetch(const int* __restrict__ idx,
                                      const Shared& sh, const Walk& w,
                                      int nq, int tt, int (&pf)[SLOTS]) {
#pragma unroll
  for (int i = 0; i < SLOTS / F; ++i) {
    const int e = (threadIdx.x + i * NT) * F;
    const int j = quot(e, w.ps, w.ps_shift);
    if (e < w.k * w.ps && tt * w.k + j < nq) {
      int d[F];
      load_idx<F>(idx + sh.start[tt & 3][j] + (e - j * w.ps), d);
#pragma unroll
      for (int v = 0; v < F; ++v) pf[i * F + v] = d[v];
    }
  }
}

// batch tt's ids into shared memory and each piece's span (buffer tt & 1)
template <int F>
__device__ __forceinline__ void commit(Shared& sh, int* ids, const Walk& w,
                                       int nq, int tt,
                                       const int (&pf)[SLOTS]) {
  const int buf = tt & 1;
  int* bi = ids + buf * BATCH_IDS;
#pragma unroll
  for (int i = 0; i < SLOTS / F; ++i) {
    const int e = (threadIdx.x + i * NT) * F;
    if (e < w.k * w.ps && tt * w.k + quot(e, w.ps, w.ps_shift) < nq)
#pragma unroll
      for (int v = 0; v < F; ++v) bi[e + v] = pf[i * F + v];
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int j = warp; j < w.k && tt * w.k + j < nq; j += NT / 32) {
    int lo = INT_MAX, hi = INT_MIN;
    for (int e = lane; e < w.ps; e += 32) {
      const int x = bi[j * w.ps + e];
      lo = min(lo, x), hi = max(hi, x);
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (lane == 0) sh.lo[buf][j] = lo, sh.hi[buf][j] = hi;
  }
  __syncthreads();
}

__device__ __forceinline__ void fetch_ids(const int* __restrict__ idx,
                                          const Shared& sh, const Walk& w,
                                          int nq, int tt, int (&pf)[SLOTS]) {
  if (w.ps % 4 == 0)
    fetch<4>(idx, sh, w, nq, tt, pf);
  else
    fetch<1>(idx, sh, w, nq, tt, pf);
}

__device__ __forceinline__ void commit_ids(Shared& sh, int* ids,
                                           const Walk& w, int nq, int tt,
                                           const int (&pf)[SLOTS]) {
  if (w.ps % 4 == 0)
    commit<4>(sh, ids, w, nq, tt, pf);
  else
    commit<1>(sh, ids, w, nq, tt, pf);
}

// the chain of `arith_chain.cuh` on E elements in step: the same ops in
// the same order for each element (so the same bits), E independent
// dependency chains a thread, whole periods unguarded
template <int NL, int E>
__device__ __forceinline__ void chains(const float (&r)[E][NL], int n_arith,
                                       float (&acc)[E]) {
  constexpr int P = lcm3(NL);
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = r[e][0];
  int t0 = 0;
  for (; t0 + P <= n_arith; t0 += P)
#pragma unroll
    for (int j = 0; j < P; ++j)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float x = r[e][(j + 1) % NL];
        if (j % 3 == 0)
          acc[e] = __fadd_rn(acc[e], x);
        else if (j % 3 == 1)
          acc[e] = __fsub_rn(acc[e], x);
        else
          acc[e] = __fadd_rn(__fmul_rn(acc[e], 0.5f), __fmul_rn(x, 0.5f));
      }
#pragma unroll
  for (int j = 0; j < P; ++j)
    if (t0 + j < n_arith)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float x = r[e][(j + 1) % NL];
        if (j % 3 == 0)
          acc[e] = __fadd_rn(acc[e], x);
        else if (j % 3 == 1)
          acc[e] = __fsub_rn(acc[e], x);
        else
          acc[e] = __fadd_rn(__fmul_rn(acc[e], 0.5f), __fmul_rn(x, 0.5f));
      }
}

// thread 0: the action of each piece of batch t (`gather_stream.walk`);
// the union looks ahead to the end of batch t + 1
__device__ void decide(Shared& sh, const Walk& w, int nq, int t, Win& win) {
  const int kb = min(w.k, nq - t * w.k), known = min(2 * w.k, nq - t * w.k);
  const int b0 = t & 1;
  for (int j = 0; j < kb; ++j) {
    const int lo = sh.lo[b0][j], hi = sh.hi[b0][j], pid = sh.pid[t & 3][j];
    if (lo >= win.lo && hi <= win.hi && (REUSE || pid == win.pid)) {
      sh.act[j] = SMEM, sh.base[j] = win.a;
      continue;
    }
    int g_lo = lo, g_hi = hi, m = 1;
    for (int r = j + 1; r < known; ++r) {
      const bool next = r >= w.k;
      const int b2 = next ? b0 ^ 1 : b0, j2 = next ? r - w.k : r;
      if (!REUSE && sh.pid[(t + next) & 3][j2] != pid) break;
      const int nl = min(g_lo, sh.lo[b2][j2]), nh = max(g_hi, sh.hi[b2][j2]);
      if (aligned_span(nl, nh) > w.w) break;
      g_lo = nl, g_hi = nh, ++m;
    }
    const long long span = aligned_span(g_lo, g_hi);
    if (USE_WINDOW && span <= w.w && 8LL * m * w.ps >= span) {
      win = Win{g_lo, g_hi, g_lo & ~3, pid};
      sh.act[j] = STAGE, sh.base[j] = win.a;
      sh.count[j] = (int)(min((long long)w.tlen, (long long)(g_hi | 3) + 1) -
                          win.a);
    } else {
      sh.act[j] = DIRECT;
    }
  }
}

// n entries of every table from entry a (a % 4 == 0) into the window
template <int NL>
__device__ __forceinline__ void stage(const Ptrs& tp, float* win, int wlen,
                                      int a, int n) {
  const int n4 = n >> 2;
#pragma unroll 2
  for (int o = threadIdx.x; o < n4; o += NT) {
    float4 r[NL];
#pragma unroll
    for (int l = 0; l < NL; ++l)
      r[l] = __ldg(reinterpret_cast<const float4*>(tp.p[l] + a) + o);
#pragma unroll
    for (int l = 0; l < NL; ++l)
      reinterpret_cast<float4*>(win + l * wlen)[o] = r[l];
  }
  for (int o = 4 * n4 + threadIdx.x; o < n; o += NT)
#pragma unroll
    for (int l = 0; l < NL; ++l) win[l * wlen + o] = __ldg(tp.p[l] + a + o);
}

// V floats with the evict-first hint (the output is not read again)
template <int V>
__device__ __forceinline__ void store_cs(float* p, const float (&s)[V]) {
  if constexpr (V == 1) {
    __stcs(p, s[0]);
  } else if constexpr (V == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(s[0], s[1]));
  } else {
#pragma unroll
    for (int h = 0; h < V / 4; ++h)
      __stcs(reinterpret_cast<float4*>(p) + h,
             make_float4(s[4 * h], s[4 * h + 1], s[4 * h + 2], s[4 * h + 3]));
  }
}

template <int NL, int V>
__global__ void __launch_bounds__(NT, 1)
    gather_window_kernel(const int* __restrict__ idx, Ptrs tp,
                         float* __restrict__ out, Walk w, int n_arith,
                         int probe) {
  extern __shared__ float4 dyn[];
  float* win = reinterpret_cast<float*>(dyn);       // NL x w.w entries
  int* ids = reinterpret_cast<int*>(win + NL * w.w);  // 2 x BATCH_IDS
  __shared__ Shared sh;
  constexpr int EU = V >= 4 ? 1 : 4 / V;   // vectors a thread in flight
  constexpr int LV = V == 1 ? 0 : V == 2 ? 1 : V == 4 ? 2 : 3;
  const long long p0 = w.g * blockIdx.x / gridDim.x;
  const long long p1 = w.g * (blockIdx.x + 1) / gridDim.x;
  const int nq = (int)((p1 - p0) * w.c * w.pps);
  const int nb = (nq + w.k - 1) / w.k;
  const int nvec = w.ps / V, vshift = w.ps_shift >= 0 ? w.ps_shift - LV : -1;
  for (int tt = 0; tt < 3; ++tt) plan_batch(sh, w, p0, nq, tt);
  __syncthreads();
  int pf[SLOTS];
  fetch_ids(idx, sh, w, nq, 0, pf);
  commit_ids(sh, ids, w, nq, 0, pf);
  if (nb > 1) {
    fetch_ids(idx, sh, w, nq, 1, pf);
    commit_ids(sh, ids, w, nq, 1, pf);
  }
  Win cur{INT_MAX, INT_MIN, 0, -1};
  for (int t = 0; t < nb; ++t) {
    const int buf = t & 1, slot = t & 3;
    const int* bi = ids + buf * BATCH_IDS;
    if (t + 2 < nb) fetch_ids(idx, sh, w, nq, t + 2, pf);
    plan_batch(sh, w, p0, nq, t + 3);      // slot of batch t - 1, served
    if (threadIdx.x == 0) decide(sh, w, nq, t, cur);
    __syncthreads();
    const int kb = min(w.k, nq - t * w.k);
    for (int j = 0; j < kb;) {
      if (sh.act[j] == STAGE) {
        __syncthreads();
        if (probe == 0) stage<NL>(tp, win, w.w, sh.base[j], sh.count[j]);
        __syncthreads();
      }
      int je = j + 1;
      while (je < kb && sh.act[je] != STAGE) ++je;
      // pieces [j, je) read one window: their vectors in one sweep
      const int total = (je - j) * nvec;
      for (int v0 = threadIdx.x; v0 < total; v0 += NT * EU) {
        float x[EU * V][NL], o[EU * V];
        int jj[EU], ee[EU];
#pragma unroll
        for (int u = 0; u < EU; ++u) {
          const int vv = v0 + u * NT;
          jj[u] = -1, ee[u] = 0;
          if (vv < total) {
            const int jv = quot(vv, nvec, vshift);
            jj[u] = j + jv, ee[u] = (vv - jv * nvec) * V;
            if (probe == 0) {
              const bool smem = sh.act[jj[u]] != DIRECT;
              const int a = sh.base[jj[u]];
              const int* pi = bi + jj[u] * w.ps + ee[u];
#pragma unroll
              for (int e = 0; e < V; ++e) {
                const int id = pi[e];
#pragma unroll
                for (int l = 0; l < NL; ++l)
                  x[u * V + e][l] = smem ? win[l * w.w + (id - a)]
                                         : __ldg(tp.p[l] + id);
              }
            }
          }
        }
        if (probe == 0) chains<NL, EU * V>(x, n_arith, o);
#pragma unroll
        for (int u = 0; u < EU; ++u) {
          if (jj[u] < 0) continue;
          float ov[V];
#pragma unroll
          for (int e = 0; e < V; ++e)
            ov[e] = probe == 1   ? (float)sh.pid[slot][jj[u]]
                    : probe == 2 ? (sh.act[jj[u]] != DIRECT ? 1.f : 0.f)
                                 : o[u * V + e];
          store_cs<V>(out + sh.start[slot][jj[u]] + ee[u], ov);
        }
      }
      j = je;
    }
    __syncthreads();
    if (t + 2 < nb) commit_ids(sh, ids, w, nq, t + 2, pf);
  }
}

template <int NL, int V>
cudaError_t launch(const int* idx, const Ptrs& tp, float* out, const Walk& w,
                   int blocks, int n_arith, int probe, cudaStream_t st) {
  const int smem = 4 * NL * w.w + 2 * 4 * BATCH_IDS;
  const cudaError_t e = cudaFuncSetAttribute(
      gather_window_kernel<NL, V>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  gather_window_kernel<NL, V><<<blocks, NT, smem, st>>>(idx, tp, out, w,
                                                        n_arith, probe);
  return cudaGetLastError();
}

template <int NL>
cudaError_t by_width(int vw, const int* idx, const Ptrs& tp, float* out,
                     const Walk& w, int blocks, int n_arith, int probe,
                     cudaStream_t st) {
  switch (vw) {
    case 1: return launch<NL, 1>(idx, tp, out, w, blocks, n_arith, probe, st);
    case 2: return launch<NL, 2>(idx, tp, out, w, blocks, n_arith, probe, st);
    case 4: return launch<NL, 4>(idx, tp, out, w, blocks, n_arith, probe, st);
    case 8: return launch<NL, 8>(idx, tp, out, w, blocks, n_arith, probe, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace gw

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

// idx (n,) int32 in [0, table_len); tables: n_tables pointers to
// (table_len,) f32.  The plan is `plan_stream(n, cfg, block)` (replication
// does not change the walk); blocks, piece, batch and window are the
// walk's (`gather_stream.walk`).
extern "C" int gather_stream_f32(const void* idx, const void* const* tables,
                                 int n_tables, void* out, long long n,
                                 int table_len, int block, int degree,
                                 int gapped, int vector_width, int n_arith,
                                 int probe, int blocks, int piece, int batch,
                                 int window, void* stream) {
  Plan pl;
  dim3 grid;
  if (n_tables < 1 || n_tables > MAX_LOADS || table_len < 1 || probe < 0 ||
      probe > 2 ||
      !make_plan(n, block, degree, gapped, 1, vector_width, &pl, &grid))
    return (int)cudaErrorInvalidValue;
  if (piece < vector_width || piece > gw::PIECE_MAX || pl.b % piece ||
      piece % vector_width || batch < 1 || batch > gw::KMAX ||
      batch * piece > gw::BATCH_IDS || window < 4 || window % 4 ||
      4LL * n_tables * window > gw::WINDOW_BYTES || blocks < 1 ||
      blocks > pl.g)
    return (int)cudaErrorInvalidValue;
  if ((long long)(pl.g / blocks + 1) * pl.c * (pl.b / piece) + batch >
      INT32_MAX)
    return (int)cudaErrorInvalidValue;   // a block's pieces count in int
  int shift = -1;
  for (int s = 0; s <= 10; ++s)
    if (piece == 1 << s) shift = s;
  const gw::Walk w{pl.g, pl.c, pl.b, pl.gapped, piece, pl.b / piece,
                   batch, window, table_len, shift};
  const Ptrs t = pack(tables, n_tables);
  const int* ix = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (n_tables) {
    case 1: return (int)gw::by_width<1>(vector_width, ix, t, o, w, blocks, n_arith, probe, st);
    case 2: return (int)gw::by_width<2>(vector_width, ix, t, o, w, blocks, n_arith, probe, st);
    case 3: return (int)gw::by_width<3>(vector_width, ix, t, o, w, blocks, n_arith, probe, st);
    case 4: return (int)gw::by_width<4>(vector_width, ix, t, o, w, blocks, n_arith, probe, st);
    case 5: return (int)gw::by_width<5>(vector_width, ix, t, o, w, blocks, n_arith, probe, st);
    case 6: return (int)gw::by_width<6>(vector_width, ix, t, o, w, blocks, n_arith, probe, st);
    case 7: return (int)gw::by_width<7>(vector_width, ix, t, o, w, blocks, n_arith, probe, st);
    default: return (int)gw::by_width<8>(vector_width, ix, t, o, w, blocks, n_arith, probe, st);
  }
}
