// Row RMSNorm for Hopper (sm_90a): one warp a row, every row summed in one
// fixed order, for the decode and verify steps; and the steps' q/k norms
// with RoPE in one launch (`qk_norm_rope_kernel`, below).
//
// Replaces no Pallas kernel: the reference's `rmsnorm`
// (`repro/models/layers.py:87`) is plain jnp, and so is the port's plain
// version (`kernels/ref.py` `rmsnorm`).  PyTorch's reduction over the last
// dim sizes its blocks by the row count, so one row's sum of squares may
// round otherwise in a batch of 8 rows than in one of 40, and a decode
// step (B rows) and a verify pass (B*T rows) then normalise the same row
// to other bits (seen on the card at full width: `chip_smoke.py`'s
// invariance phase).  Here a row's sum of squares follows one lane walk
// and one shuffle tree whatever the row count or the row's place.
//
// What it computes: y = x * rsqrt(mean(x^2) + eps) * (1 + scale), x bf16
// (rows, D) with D % 8 == 0, statistics and products in float32, y rounded
// to bf16 (the reference's `(x * (1 + scale)).astype(dt)`).
//
// Bound on this card: the bytes, 2 * rows * D in and out plus the f32
// scale, at 3.35 TB/s; at a decode step's sizes launch latency bounds it.
// Lane l walks the chunks of 8 values at columns 8 * (l + 32 i) with
// 16-byte loads, summing x^2 in that order; the xor tree then gives every
// lane the same total (float addition is commutative), and the second
// pass reads the row again (from L1).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;             // rows a block

__device__ __forceinline__ void widen(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__global__ void __launch_bounds__(WARPS * 32)
rmsnorm_kernel(const __nv_bfloat16* __restrict__ x,
               const float* __restrict__ scale,
               __nv_bfloat16* __restrict__ out, int rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const __nv_bfloat16* xr = x + (size_t)row * d;
  __nv_bfloat16* yr = out + (size_t)row * d;

  float ss = 0.f;
  for (int c = 8 * lane; c < d; c += 256) {
    float f[8];
    widen(*reinterpret_cast<const uint4*>(xr + c), f);
#pragma unroll
    for (int i = 0; i < 8; ++i) ss = __fadd_rn(ss, __fmul_rn(f[i], f[i]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(ss, (float)d), eps));

  for (int c = 8 * lane; c < d; c += 256) {
    float f[8];
    widen(*reinterpret_cast<const uint4*>(xr + c), f);
    const float4 s0 = *reinterpret_cast<const float4*>(scale + c);
    const float4 s1 = *reinterpret_cast<const float4*>(scale + c + 4);
    const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(
          __fmul_rn(__fmul_rn(f[2 * i], r), __fadd_rn(1.f, s[2 * i])),
          __fmul_rn(__fmul_rn(f[2 * i + 1], r),
                    __fadd_rn(1.f, s[2 * i + 1])));
    *reinterpret_cast<uint4*>(yr + c) = u;
  }
}

// The q/k norms and RoPE of a decode or verify step, one warp a (row,
// head): q (rows, HQ, D) and k (rows, HK, D) bf16, D % 8 == 0 up to 256,
// so lane l holds 16-byte chunk l of its head (lanes past D / 8 none).
// With `norm` the head is normalised as `rmsnorm_kernel` normalises a row
// of D (the same lane walk: at D <= 256 one chunk a lane; the same xor
// tree; the same products) and rounded to bf16; then its interleaved
// pairs (x1, x2) = (x[2i], x[2i+1]) are rotated as `ref.rope` rotates
// them: ang = pos * freqs[i] in f32, cos and sin of it (cosf, sinf), x1 c
// - x2 s and x1 s + x2 c with every product and sum rounded on its own
// (no contraction), rounded to bf16.  freqs is the torch tensor
// `ref.rope_freqs` keeps; pos (rows,) int32 or int64.  cosf and sinf
// give torch.cos's and torch.sin's bits at every position below 2^19
// (the longest shape of the configurations) for each (D, theta) of the
// configurations (`chip_smoke.py` checks it on the card), so no cos/sin
// tables are read.  Bound: the bytes.
__global__ void __launch_bounds__(WARPS * 32)
qk_norm_rope_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const float* __restrict__ q_scale,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ freqs, const void* pos,
                    __nv_bfloat16* __restrict__ qo,
                    __nv_bfloat16* __restrict__ ko, int rows, int hq, int hk,
                    int d, int norm, int pos64, float eps) {
  const int lane = threadIdx.x & 31;
  const int heads = hq + hk;
  const long long item = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (item >= (long long)rows * heads) return;
  const int row = (int)(item / heads), h = (int)(item % heads);
  const bool isq = h < hq;
  const size_t off = ((size_t)row * (isq ? hq : hk) + (isq ? h : h - hq)) * d;
  const __nv_bfloat16* xr = (isq ? q : k) + off;
  __nv_bfloat16* yr = (isq ? qo : ko) + off;
  const float* scale = isq ? q_scale : k_scale;
  const int c = 8 * lane;
  const bool mine = c < d;

  float f[8];
  if (mine) widen(*reinterpret_cast<const uint4*>(xr + c), f);
  if (norm) {
    float ss = 0.f;
    if (mine) {
#pragma unroll
      for (int i = 0; i < 8; ++i) ss = __fadd_rn(ss, __fmul_rn(f[i], f[i]));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
    const float r = rsqrtf(__fadd_rn(__fdiv_rn(ss, (float)d), eps));
    if (mine) {
      const float4 s0 = *reinterpret_cast<const float4*>(scale + c);
      const float4 s1 = *reinterpret_cast<const float4*>(scale + c + 4);
      const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
        f[i] = __bfloat162float(__float2bfloat16_rn(
            __fmul_rn(__fmul_rn(f[i], r), __fadd_rn(1.f, s[i]))));
    }
  }
  if (!mine) return;
  const float p = pos64 ? (float)static_cast<const long long*>(pos)[row]
                        : (float)static_cast<const int*>(pos)[row];
  uint4 u;
  __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float ang = __fmul_rn(p, freqs[c / 2 + i]);
    const float cs = cosf(ang);
    const float sn = sinf(ang);
    const float x1 = f[2 * i], x2 = f[2 * i + 1];
    o2[i] = __floats2bfloat162_rn(
        __fsub_rn(__fmul_rn(x1, cs), __fmul_rn(x2, sn)),
        __fadd_rn(__fmul_rn(x1, sn), __fmul_rn(x2, cs)));
  }
  *reinterpret_cast<uint4*>(yr + c) = u;
}

}  // namespace

// x, out: (rows, d) bf16, d % 8 == 0, 16-byte aligned; scale: (d,) f32
extern "C" int rmsnorm_bf16(const void* x, const void* scale, void* out,
                            int rows, int d, float eps, void* stream) {
  if (rows < 1 || d < 8 || d % 8) return (int)cudaErrorInvalidValue;
  rmsnorm_kernel<<<(rows + WARPS - 1) / WARPS, WARPS * 32, 0,
                   reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(out), rows, d, eps);
  return (int)cudaGetLastError();
}

// q, qo: (rows, hq, d) bf16; k, ko: (rows, hk, d); d % 8 == 0, d <= 256;
// q_scale, k_scale: (d,) f32 (read only with norm); freqs: (d / 2,) f32;
// pos: (rows,) int32, or int64 with pos64; all 16-byte aligned
extern "C" int qk_norm_rope_bf16(const void* q, const void* k,
                                 const void* q_scale, const void* k_scale,
                                 const void* freqs, const void* pos, void* qo,
                                 void* ko, int rows, int hq, int hk, int d,
                                 int norm, int pos64, float eps,
                                 void* stream) {
  if (rows < 1 || hq < 1 || hk < 1 || d < 8 || d > 256 || d % 8)
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)rows * (hq + hk);
  qk_norm_rope_kernel<<<(unsigned)((items + WARPS - 1) / WARPS), WARPS * 32,
                        0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const float*>(q_scale), static_cast<const float*>(k_scale),
      static_cast<const float*>(freqs), pos,
      static_cast<__nv_bfloat16*>(qo), static_cast<__nv_bfloat16*>(ko), rows,
      hq, hk, d, norm, pos64, eps);
  return (int)cudaGetLastError();
}
