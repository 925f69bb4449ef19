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
// (slot, query head) row, D threads.
__global__ void combine_kernel(const float* __restrict__ m,
                               const float* __restrict__ l,
                               const float* __restrict__ acc,
                               __nv_bfloat16* __restrict__ out, int n_splits,
                               int d) {
  const size_t row = blockIdx.x;                // b*H + h
  const int tid = threadIdx.x;
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
  out[row * d + tid] = __float2bfloat16(o / lt);
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
      n_splits, d);
  return (int)cudaGetLastError();
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
