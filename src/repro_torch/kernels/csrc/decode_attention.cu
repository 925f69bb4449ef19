// Paged split-KV decode attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel `repro/kernels/decode_attention.py`
// `make_paged_kernel` (its pl.pallas_call at :342) and, as a second small
// kernel, the exact split combine `_combine` (:37) that the reference runs
// outside Pallas.
//
// What it computes: one query token per slot against that slot's K/V rows,
// which live in a global page pool (P, ps, Hkv, D) reached through a block
// table (B, npp).  Grid = (n_splits, Hkv, B) with n_splits = npp / C: one
// thread block per (slot, kv head, split), owning C logical pages, either
// adjacent (consecutive: si*C + j) or npp/C apart (gapped: j*(npp/C) + si).
// Each block loads the G = H/Hkv query rows of its kv head once, resolves
// each of its pages through the table, stages the page's (ps, D) K and V
// rows in shared memory with 16-byte loads, and runs the online softmax in
// f32, writing one partial (m, l, acc) per query row.
//
// Bound on this card: the live K/V bytes, 2 * (pos+1) * Hkv * D * 2 bytes per
// slot per layer, at 3.35 TB/s; the arithmetic (2 * G * D flops per K row and
// per V row) is far below the tensor-core ridge, so this is a bandwidth
// kernel.  What the design does about it: every K/V byte is read once, with
// 16-byte vector loads, and never for rows past `pos` — a split wholly past
// `pos` (or wholly left of the window) writes the empty partial without
// touching the pool, and a page wholly outside the mask inside a live split
// is skipped too.  Rows of a partly filled page past `pos` are masked to
// zero weight, so poisoned tails and never-referenced pages cannot leak.
// The combine is a second launch over (B*H) rows, D threads each.
//
// int8 pools (the `kv_bits=8` branch of `make_paged_kernel`, scale loads at
// :295-301): K and V rows are int8 with one f32 scale per (row, kv head) in
// (P, ps, Hkv) scale pools.  The scale is pulled out of the dot: a score is
// (q . k_int) * s_k * scale, and a V row enters the sum as (p * s_v) * v_int,
// so the int8 rows are staged as they are (half the bytes of bf16) and the
// split-and-merge structure is the bf16 kernel's.  Bound: the live rows'
// int8 K/V bytes plus their scales.
//
// The contiguous-cache decode kernel and the short-q verify kernel:
// `rows_partials_kernel` replaces two more Pallas kernels of the same
// split-KV family: `make_kernel` (:51, pallas_call at :171), decode against
// a contiguous (B, S, Hkv, D) cache, and `make_verify_kernel` (:380,
// pallas_call at :510), T drafted query rows per slot through the block
// table.  Both own C kv segments per (slot, kv head, split) as above —
// kv blocks of `bkv` rows (contiguous: adjacent, or S/C rows apart) or
// pages (verify) — with the same live-split skip and exact combine.  What
// differs from the paged decode kernel:
//
// * R = T*G query rows a block (t-major: row r = t*G + g sits at cache
//   position pos0 + t and carries its own causal/window mask).  T*G
//   exceeds a handful of registers, so the online-softmax state (m, l and
//   the tile's probabilities) lives in shared memory, one thread per row
//   updates it, and each thread keeps only its output column of the R
//   accumulators in registers (MAXR = 8 or 32 of them).
// * A segment is staged in tiles of `tr` rows (a divisor of the segment
//   and at most 32): a 128-row kv block of bf16 K and V is 64 KB, a
//   32-row tile 16 KB, so the static 48 KB suffices at D = 128.  Tiles
//   wholly past the deepest row (pos0 + T - 1) or left of the window are
//   skipped, so the kernel reads only live rows' tiles, and never a row at
//   or past S: the tiles cover [0, S) and nothing else, whatever pos an
//   inactive slot carries.
//
// Bound on this card: the live K/V bytes (and, for int8, their scales) at
// 3.35 TB/s, as for the paged kernel; verify scores each fetched tile
// against T*G rows, still far below the tensor-core ridge.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int MAXG = 8;          // query heads per kv head this kernel takes

__device__ __forceinline__ float kv_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float kv_float(int8_t x) { return (float)x; }

// KV = __nv_bfloat16 (scales null) or int8_t (f32 scale pools (P, ps, Hkv))
template <typename KV>
__global__ void paged_partials_kernel(
    const __nv_bfloat16* __restrict__ q,        // (B, Hkv*G, D)
    const KV* __restrict__ k_pool,              // (P, ps, Hkv, D)
    const KV* __restrict__ v_pool,              // (P, ps, Hkv, D)
    const float* __restrict__ k_scale,          // (P, ps, Hkv) or null
    const float* __restrict__ v_scale,          // (P, ps, Hkv) or null
    const int* __restrict__ block_table,        // (B, npp)
    const int* __restrict__ pos,                // (B,)
    float* __restrict__ m_out,                  // (B, Hkv, G, n_splits)
    float* __restrict__ l_out,                  // (B, Hkv, G, n_splits)
    float* __restrict__ acc_out,                // (B, Hkv, G, n_splits, D)
    int n_pages, int ps, int hkv, int g, int d, int npp, int c, int gapped,
    int window, float scale) {
  const int si = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int n_splits = gridDim.x;
  const int seg = npp / c;
  const int tid = threadIdx.x;                  // blockDim.x == d
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  KV* ks = reinterpret_cast<KV*>(smem);                          // (ps, d)
  KV* vs = ks + ps * d;                                          // (ps, d)
  float* qs = reinterpret_cast<float*>(vs + ps * d);             // (g, d)
  float* sc = qs + g * d;                                        // (g, ps)
  float* kss = sc + g * ps;                                      // (ps,)
  float* vss = kss + ps;                                         // (ps,)
  constexpr bool QUANT = sizeof(KV) == 1;

  const int p = pos[bb];
  const size_t part0 = (size_t)(bb * hkv + hh) * g * n_splits + si;

  // length-aware skip on the split's fused logical-row extent
  int first_row, last_row;
  if (gapped) {
    first_row = si * ps;
    last_row = ((c - 1) * seg + si) * ps + ps - 1;
  } else {
    first_row = si * c * ps;
    last_row = (si * c + c - 1) * ps + ps - 1;
  }
  bool live = first_row <= p;
  if (window > 0) live = live && (last_row > p - window);
  if (!live) {
    for (int gi = 0; gi < g; ++gi) {
      const size_t o = part0 + (size_t)gi * n_splits;
      if (tid == 0) {
        m_out[o] = NEG;
        l_out[o] = 0.f;
      }
      acc_out[o * d + tid] = 0.f;
    }
    return;
  }

  for (int gi = 0; gi < g; ++gi)
    qs[gi * d + tid] =
        __bfloat162float(q[((size_t)(bb * hkv + hh) * g + gi) * d + tid]);

  float m[MAXG], l[MAXG], acc[MAXG];
#pragma unroll
  for (int gi = 0; gi < MAXG; ++gi) {
    m[gi] = NEG;
    l[gi] = 0.f;
    acc[gi] = 0.f;
  }

  const int vec_per_row = d * (int)sizeof(KV) / 16;   // 16-byte vectors
  const int n_vec = ps * vec_per_row;
  for (int j = 0; j < c; ++j) {
    const int lp = gapped ? j * seg + si : si * c + j;
    const int row0 = lp * ps;
    // a page wholly outside the mask contributes nothing: skip its loads
    if (row0 > p) continue;
    if (window > 0 && row0 + ps - 1 <= p - window) continue;
    int pp = block_table[(size_t)bb * npp + lp];
    pp = pp < 0 ? 0 : (pp >= n_pages ? n_pages - 1 : pp);

    __syncthreads();                            // previous page consumed
    for (int i = tid; i < n_vec; i += blockDim.x) {
      const int r = i / vec_per_row, cc = i - r * vec_per_row;
      const size_t off = ((size_t)(pp * ps + r) * hkv + hh) * d +
                         cc * (16 / sizeof(KV));
      reinterpret_cast<uint4*>(ks)[i] =
          *reinterpret_cast<const uint4*>(k_pool + off);
      reinterpret_cast<uint4*>(vs)[i] =
          *reinterpret_cast<const uint4*>(v_pool + off);
    }
    if (QUANT && tid < ps) {
      const size_t so = (size_t)(pp * ps + tid) * hkv + hh;
      kss[tid] = k_scale[so];
      vss[tid] = v_scale[so];
    }
    __syncthreads();

    // scores: one warp per (query row, kv row), lanes over D
    for (int idx = warp; idx < g * ps; idx += nwarps) {
      const int gi = idx / ps, r = idx - gi * ps;
      float s = 0.f;
      for (int e = lane; e < d; e += 32)
        s += qs[gi * d + e] * kv_float(ks[r * d + e]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) {
        const int col = row0 + r;
        const bool ok = col <= p && (window <= 0 || col > p - window);
        if (QUANT) s *= kss[r];                 // the K scale, after the dot
        sc[gi * ps + r] = ok ? s * scale : NEG;
      }
    }
    __syncthreads();

    // online softmax: thread tid owns output column tid of every query row
#pragma unroll
    for (int gi = 0; gi < MAXG; ++gi) {
      if (gi >= g) continue;
      float mx = m[gi];
      for (int r = 0; r < ps; ++r) mx = fmaxf(mx, sc[gi * ps + r]);
      const float alpha = expf(m[gi] - mx);
      float lsum = 0.f, a = 0.f;
      for (int r = 0; r < ps; ++r) {
        const float s = sc[gi * ps + r];
        const float pr = s <= NEG * 0.5f ? 0.f : expf(s - mx);
        lsum += pr;
        a += (QUANT ? pr * vss[r] : pr) * kv_float(vs[r * d + tid]);
      }
      l[gi] = l[gi] * alpha + lsum;
      acc[gi] = acc[gi] * alpha + a;
      m[gi] = mx;
    }
  }

#pragma unroll
  for (int gi = 0; gi < MAXG; ++gi) {
    if (gi >= g) continue;
    const size_t o = part0 + (size_t)gi * n_splits;
    if (tid == 0) {
      m_out[o] = m[gi];
      l_out[o] = l[gi];
    }
    acc_out[o * d + tid] = acc[gi];
  }
}

// Exact merge of the per-split partials (repro `_combine`): one block per
// (slot, kv head, query row) of the partials, D threads.  Partial row r of
// kv head hh is t-major (r = t*G + g) and lands at out (b, t, hh*G + g):
// with T = 1 that is row b*H + h, the decode layout.
__global__ void combine_kernel(const float* __restrict__ m,
                               const float* __restrict__ l,
                               const float* __restrict__ acc,
                               __nv_bfloat16* __restrict__ out, int n_splits,
                               int d, int t, int g, int hkv) {
  const size_t row = blockIdx.x;                // (b*Hkv + hh)*R + r
  const int tid = threadIdx.x;
  const int rr = t * g;
  const int r = (int)(row % rr), hh = (int)(row / rr % hkv);
  const size_t bb = row / rr / hkv;
  const int ti = r / g, gi = r - ti * g;
  const float* mr = m + row * n_splits;
  const float* lr = l + row * n_splits;
  float mmax = NEG;
  for (int s = 0; s < n_splits; ++s) mmax = fmaxf(mmax, mr[s]);
  float lt = 0.f, o = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float w = mr[s] <= NEG * 0.5f ? 0.f : expf(mr[s] - mmax);
    lt += lr[s] * w;
    o += acc[(row * n_splits + s) * d + tid] * w;
  }
  if (lt == 0.f) lt = 1.f;
  out[((bb * t + ti) * hkv * g + hh * g + gi) * d + tid] =
      __float2bfloat16(o / lt);
}

template <typename KV>
int launch_paged(const void* q, const void* k_pool, const void* v_pool,
                 const void* k_scale, const void* v_scale,
                 const void* block_table, const void* pos, void* m, void* l,
                 void* acc, void* out, int b, int hkv, int g, int d,
                 int n_pages, int ps, int npp, int c, int gapped, int window,
                 float scale, cudaStream_t st) {
  if (g < 1 || g > MAXG || d % 32 || d > 1024 || npp % c)
    return (int)cudaErrorInvalidValue;
  const int n_splits = npp / c;
  const size_t smem = (size_t)2 * ps * d * sizeof(KV) +
                      (size_t)g * d * sizeof(float) +
                      (size_t)g * ps * sizeof(float) +
                      (size_t)2 * ps * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_partials_kernel<KV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_partials_kernel<KV><<<dim3(n_splits, hkv, b), d, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k_pool),
      static_cast<const KV*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale),
      static_cast<const int*>(block_table), static_cast<const int*>(pos),
      static_cast<float*>(m), static_cast<float*>(l), static_cast<float*>(acc),
      n_pages, ps, hkv, g, d, npp, c, gapped, window, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  combine_kernel<<<b * hkv * g, d, 0, st>>>(
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(acc), static_cast<__nv_bfloat16*>(out),
      n_splits, d, 1, g, hkv);
  return (int)cudaGetLastError();
}

// KV = __nv_bfloat16 or int8_t (scales non-null); PAGED: K/V are pools
// (P, seg, Hkv, D) reached through block_table (B, nseg), else caches
// (B, nseg*seg, Hkv, D) with slot b's rows in order.
template <typename KV, bool PAGED, int MAXR>
__global__ void rows_partials_kernel(
    const __nv_bfloat16* __restrict__ q,        // (B, T, Hkv*G, D)
    const KV* __restrict__ k, const KV* __restrict__ v,
    const float* __restrict__ k_scale,          // rows x Hkv, or null
    const float* __restrict__ v_scale,
    const int* __restrict__ block_table,        // (B, nseg) when PAGED
    const int* __restrict__ pos0,               // (B,)
    float* __restrict__ m_out,                  // (B, Hkv, R, n_splits)
    float* __restrict__ l_out,                  // (B, Hkv, R, n_splits)
    float* __restrict__ acc_out,                // (B, Hkv, R, n_splits, D)
    int n_pages, int seg, int nseg, int hkv, int g, int t, int d, int c,
    int gapped, int window, int tr, float scale) {
  const int si = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int n_splits = gridDim.x;
  const int rr = t * g;                         // query rows of the block
  const int tid = threadIdx.x;                  // blockDim.x == d
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  constexpr bool QUANT = sizeof(KV) == 1;

  extern __shared__ __align__(16) unsigned char smem[];
  KV* ks = reinterpret_cast<KV*>(smem);                          // (tr, d)
  KV* vs = ks + tr * d;                                          // (tr, d)
  float* qs = reinterpret_cast<float*>(vs + tr * d);             // (rr, d)
  float* sc = qs + rr * d;                                       // (rr, tr)
  float* ms = sc + rr * tr;                                      // (rr,)
  float* ls = ms + rr;                                           // (rr,)
  float* al = ls + rr;                                           // (rr,)
  float* kss = al + rr;                                          // (tr,)
  float* vss = kss + tr;                                         // (tr,)

  const int p0 = pos0[bb];
  const int plast = p0 + t - 1;                 // the deepest query row
  const size_t part0 = (size_t)(bb * hkv + hh) * rr * n_splits + si;

  // live-split skip on the split's fused row extent (reference :433-443)
  int first_row, last_row;
  if (gapped) {
    first_row = si * seg;
    last_row = ((c - 1) * n_splits + si) * seg + seg - 1;
  } else {
    first_row = si * c * seg;
    last_row = (si * c + c - 1) * seg + seg - 1;
  }
  bool live = first_row <= plast;
  if (window > 0) live = live && (last_row > p0 - window);
  if (!live) {
    for (int r = 0; r < rr; ++r) {
      const size_t o = part0 + (size_t)r * n_splits;
      if (tid == 0) {
        m_out[o] = NEG;
        l_out[o] = 0.f;
      }
      acc_out[o * d + tid] = 0.f;
    }
    return;
  }

  for (int r = 0; r < rr; ++r) {
    const int ti = r / g, gi = r - ti * g;
    qs[r * d + tid] = __bfloat162float(
        q[(((size_t)bb * t + ti) * hkv * g + hh * g + gi) * d + tid]);
  }
  if (tid < rr) {
    ms[tid] = NEG;
    ls[tid] = 0.f;
  }
  float acc[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) acc[r] = 0.f;

  const int vec_per_row = d * (int)sizeof(KV) / 16;   // 16-byte vectors
  const int n_vec = tr * vec_per_row;
  for (int j = 0; j < c; ++j) {
    const int lseg = gapped ? j * n_splits + si : si * c + j;
    int pp = 0;
    if (PAGED) {
      pp = block_table[(size_t)bb * nseg + lseg];
      pp = pp < 0 ? 0 : (pp >= n_pages ? n_pages - 1 : pp);
    }
    for (int r0 = 0; r0 < seg; r0 += tr) {
      const int row0 = lseg * seg + r0;         // logical row of the tile
      if (row0 > plast) break;                  // and every later tile
      if (window > 0 && row0 + tr - 1 <= p0 - window) continue;
      const size_t rbase = PAGED ? (size_t)pp * seg + r0
                                 : (size_t)bb * nseg * seg + row0;
      __syncthreads();                          // previous tile consumed
      for (int i = tid; i < n_vec; i += blockDim.x) {
        const int r = i / vec_per_row, cc = i - r * vec_per_row;
        const size_t off = ((rbase + r) * hkv + hh) * d +
                           cc * (16 / sizeof(KV));
        reinterpret_cast<uint4*>(ks)[i] =
            *reinterpret_cast<const uint4*>(k + off);
        reinterpret_cast<uint4*>(vs)[i] =
            *reinterpret_cast<const uint4*>(v + off);
      }
      if (QUANT && tid < tr) {
        const size_t so = (rbase + tid) * hkv + hh;
        kss[tid] = k_scale[so];
        vss[tid] = v_scale[so];
      }
      __syncthreads();

      // scores: one warp per (query row, kv row), lanes over D
      for (int idx = warp; idx < rr * tr; idx += nwarps) {
        const int r = idx / tr, kr = idx - r * tr;
        float s = 0.f;
        for (int e = lane; e < d; e += 32)
          s += qs[r * d + e] * kv_float(ks[kr * d + e]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) {
          const int col = row0 + kr, rp = p0 + r / g;
          const bool ok = col <= rp && (window <= 0 || col > rp - window);
          if (QUANT) s *= kss[kr];              // the K scale, after the dot
          sc[r * tr + kr] = ok ? s * scale : NEG;
        }
      }
      __syncthreads();

      // online softmax, one thread per query row: the new max, the
      // rescale alpha, and the tile's probabilities (times the V scale)
      if (tid < rr) {
        const int r = tid;
        const float mo = ms[r];
        float mx = mo;
        for (int kr = 0; kr < tr; ++kr) mx = fmaxf(mx, sc[r * tr + kr]);
        float lsum = 0.f;
        for (int kr = 0; kr < tr; ++kr) {
          const float s = sc[r * tr + kr];
          const float pr = s <= NEG * 0.5f ? 0.f : expf(s - mx);
          lsum += pr;
          sc[r * tr + kr] = QUANT ? pr * vss[kr] : pr;
        }
        const float alpha = expf(mo - mx);
        ls[r] = ls[r] * alpha + lsum;
        ms[r] = mx;
        al[r] = alpha;
      }
      __syncthreads();

      // thread tid owns output column tid of every query row
#pragma unroll
      for (int r = 0; r < MAXR; ++r)
        if (r < rr) acc[r] *= al[r];
      for (int kr = 0; kr < tr; ++kr) {
        const float vv = kv_float(vs[kr * d + tid]);
#pragma unroll
        for (int r = 0; r < MAXR; ++r)
          if (r < rr) acc[r] += sc[r * tr + kr] * vv;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    if (r >= rr) continue;
    const size_t o = part0 + (size_t)r * n_splits;
    if (tid == 0) {
      m_out[o] = ms[r];
      l_out[o] = ls[r];
    }
    acc_out[o * d + tid] = acc[r];
  }
}

template <typename KV, bool PAGED, int MAXR>
int launch_rows(const void* q, const void* k, const void* v,
                const void* k_scale, const void* v_scale,
                const void* block_table, const void* pos0, void* m, void* l,
                void* acc, void* out, int b, int hkv, int g, int t, int d,
                int n_pages, int seg, int nseg, int c, int gapped, int window,
                int tr, float scale, cudaStream_t st) {
  const int rr = t * g;
  const int n_splits = nseg / c;
  const size_t smem = (size_t)2 * tr * d * sizeof(KV) +
                      ((size_t)rr * d + (size_t)rr * tr + 3 * rr + 2 * tr) *
                          sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rows_partials_kernel<KV, PAGED, MAXR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rows_partials_kernel<KV, PAGED, MAXR>
      <<<dim3(n_splits, hkv, b), d, smem, st>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k),
          static_cast<const KV*>(v), static_cast<const float*>(k_scale),
          static_cast<const float*>(v_scale),
          static_cast<const int*>(block_table), static_cast<const int*>(pos0),
          static_cast<float*>(m), static_cast<float*>(l),
          static_cast<float*>(acc), n_pages, seg, nseg, hkv, g, t, d, c,
          gapped, window, tr, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  combine_kernel<<<b * hkv * rr, d, 0, st>>>(
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(acc), static_cast<__nv_bfloat16*>(out),
      n_splits, d, t, g, hkv);
  return (int)cudaGetLastError();
}

template <typename KV, bool PAGED>
int launch_rows_r(const void* q, const void* k, const void* v,
                  const void* k_scale, const void* v_scale,
                  const void* block_table, const void* pos0, void* m,
                  void* l, void* acc, void* out, int b, int hkv, int g,
                  int t, int d, int n_pages, int seg, int nseg, int c,
                  int gapped, int window, int tr, float scale,
                  cudaStream_t st) {
  if (t * g <= 8)
    return launch_rows<KV, PAGED, 8>(q, k, v, k_scale, v_scale, block_table,
                                     pos0, m, l, acc, out, b, hkv, g, t, d,
                                     n_pages, seg, nseg, c, gapped, window,
                                     tr, scale, st);
  return launch_rows<KV, PAGED, 32>(q, k, v, k_scale, v_scale, block_table,
                                    pos0, m, l, acc, out, b, hkv, g, t, d,
                                    n_pages, seg, nseg, c, gapped, window,
                                    tr, scale, st);
}

}  // namespace

extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_table, const void* pos, void* m, void* l, void* acc,
    void* out, int b, int hkv, int g, int d, int n_pages, int ps, int npp,
    int c, int gapped, int window, float scale, void* stream) {
  return launch_paged<__nv_bfloat16>(
      q, k_pool, v_pool, nullptr, nullptr, block_table, pos, m, l, acc, out,
      b, hkv, g, d, n_pages, ps, npp, c, gapped, window, scale,
      reinterpret_cast<cudaStream_t>(stream));
}

// int8 pools with f32 scale pools (P, ps, Hkv)
extern "C" int paged_decode_attention_int8(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_table,
    const void* pos, void* m, void* l, void* acc, void* out, int b, int hkv,
    int g, int d, int n_pages, int ps, int npp, int c, int gapped,
    int window, float scale, void* stream) {
  return launch_paged<int8_t>(
      q, k_pool, v_pool, k_scale, v_scale, block_table, pos, m, l, acc, out,
      b, hkv, g, d, n_pages, ps, npp, c, gapped, window, scale,
      reinterpret_cast<cudaStream_t>(stream));
}

// The contiguous-cache decode kernel (paged = 0, T = 1, seg = bkv, nseg =
// S / bkv, block_table and n_pages unused) and the short-q verify kernel
// (paged = 1, seg = page size, nseg = pages a slot), bf16 caches or, with
// quant = 1, int8 caches with f32 scales (rows x Hkv).  pos0 is (B,).
extern "C" int split_kv_attention(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* block_table, const void* pos0, void* m,
    void* l, void* acc, void* out, int quant, int paged, int b, int hkv,
    int g, int t, int d, int n_pages, int seg, int nseg, int c, int gapped,
    int window, int tr, float scale, void* stream) {
  if (g < 1 || t < 1 || t * g > 32 || d % 32 || d > 1024 || c < 1 ||
      nseg % c || tr < 1 || tr > 32 || seg % tr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (quant)
    return paged ? launch_rows_r<int8_t, true>(
                       q, k, v, k_scale, v_scale, block_table, pos0, m, l,
                       acc, out, b, hkv, g, t, d, n_pages, seg, nseg, c,
                       gapped, window, tr, scale, st)
                 : launch_rows_r<int8_t, false>(
                       q, k, v, k_scale, v_scale, block_table, pos0, m, l,
                       acc, out, b, hkv, g, t, d, n_pages, seg, nseg, c,
                       gapped, window, tr, scale, st);
  return paged ? launch_rows_r<__nv_bfloat16, true>(
                     q, k, v, nullptr, nullptr, block_table, pos0, m, l, acc,
                     out, b, hkv, g, t, d, n_pages, seg, nseg, c, gapped,
                     window, tr, scale, st)
               : launch_rows_r<__nv_bfloat16, false>(
                     q, k, v, nullptr, nullptr, block_table, pos0, m, l, acc,
                     out, b, hkv, g, t, d, n_pages, seg, nseg, c, gapped,
                     window, tr, scale, st);
}
