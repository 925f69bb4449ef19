// RG-LRU (RecurrentGemma) gated linear recurrence, channel-coarsened, f32:
//
//   h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (sigmoid(i_t) * x_t),
//   a_t = exp(-8 * softplus(a_param) * sigmoid(r_t)),  h_{-1} = 0.
//
// Replaces `repro/kernels/rglru.py` `make_kernel` (its pl.pallas_call at
// :77).  There the grid is (batch, channel program, time block): a program
// owns C * block_d channels, adjacent (consecutive) or C blocks of block_d
// channels D/C apart (gapped, the (b, s, C, D/C) view of :64-68), and runs
// an associative scan within each time block of block_t steps, carrying h
// across blocks in VMEM.
//
// Here one thread block is one program (blockIdx = (channel program,
// batch)) and one thread one channel: it runs the recurrence sequentially
// over all S steps with h in a register.  The scan of the Pallas kernel is
// a tiling of the same recurrence; the sequential form computes the same
// function, in the plain version's order: expf, log1pf and sqrtf, and the
// products and sums as __fmul_rn / __fadd_rn, never contracted into FMAs.
// A warp's 32 channels are adjacent in both kinds (block_d a multiple of
// 32), so each step's loads are 128 contiguous bytes.
//
// Bound on the H100: x, r, i read and h written once, a_param once:
// (4 B S D + D) * 4 bytes over 3.35 TB/s (0.200 ms at recurrentgemma-2b's
// D 2560, B 8, S 2048); ~20 f32 operations an element are far below the
// peak.  The recurrence is a chain of dependent steps per thread, so the
// design keeps loads in flight instead: the U = 8 steps ahead are loaded
// into registers while the current 8 are computed.  There are B * D /
// (C * block_d) blocks: 160 of 128 threads at base, 40 of 512 at con4.
//
// probe = 1 stores the channel program's index (as float32) in place of h.
#include <cuda_runtime.h>

namespace {

constexpr int U = 8;                  // steps loaded ahead
constexpr int MAX_THREADS = 1024;

struct Steps {
  float x[U], r[U], i[U];
};

__device__ __forceinline__ void load(Steps& d, const float* x, const float* r,
                                     const float* i, size_t o, int stride) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const size_t e = o + (size_t)u * stride;
    d.x[u] = __ldg(x + e);
    d.r[u] = __ldg(r + e);
    d.i[u] = __ldg(i + e);
  }
}

__device__ __forceinline__ float sigmoid(float v) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v)));
}

__global__ void __launch_bounds__(MAX_THREADS)
    rglru_kernel(const float* __restrict__ x, const float* __restrict__ r,
                 const float* __restrict__ i,
                 const float* __restrict__ a_param, float* __restrict__ out,
                 int s, int d, int c, int block_d, int gapped, int probe) {
  const int di = blockIdx.x, bi = blockIdx.y, j = threadIdx.x;
  const int ch = gapped ? (j / block_d) * (d / c) + di * block_d + j % block_d
                        : di * c * block_d + j;
  const float ap = __ldg(a_param + ch);
  // -8 * softplus(a_param), softplus as logaddexp(a, 0); * -8 is exact
  const float neg_c_sp =
      -8.f * __fadd_rn(fmaxf(ap, 0.f), log1pf(expf(-fabsf(ap))));
  size_t o = (size_t)bi * s * d + ch;
  Steps cur, nxt;
  load(cur, x, r, i, o, d);
  float h = 0.f;
  for (int t0 = 0; t0 < s; t0 += U) {
    if (t0 + U < s) load(nxt, x, r, i, o + (size_t)U * d, d);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float log_a = __fmul_rn(neg_c_sp, sigmoid(cur.r[u]));
      const float at = expf(log_a);
      const float mult = sqrtf(
          fmaxf(__fsub_rn(1.f, expf(__fmul_rn(2.f, log_a))), 1e-12f));
      const float gated = __fmul_rn(sigmoid(cur.i[u]), cur.x[u]);
      h = __fadd_rn(__fmul_rn(at, h), __fmul_rn(mult, gated));
      out[o + (size_t)u * d] = probe ? (float)di : h;
    }
    o += (size_t)U * d;
    cur = nxt;
  }
}

}  // namespace

// x, r, i, out: (batch, s, d) f32; a_param: (d,) f32; all contiguous.  The
// program di owns channels [di*C*block_d, +C*block_d) (consecutive) or
// {k*(d/C) + di*block_d + j} (gapped); d % (degree * block_d) == 0.
extern "C" int rglru_f32(const void* x, const void* r, const void* i,
                         const void* a_param, void* out, int batch, int s,
                         int d, int degree, int block_d, int gapped,
                         int probe, void* stream) {
  if (batch < 1 || batch > 65535 || s < U || s % U || degree < 1 ||
      block_d < 1 || degree * block_d > MAX_THREADS ||
      d % (degree * block_d))
    return (int)cudaErrorInvalidValue;
  rglru_kernel<<<dim3(d / (degree * block_d), batch), degree * block_d, 0,
                 reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(r),
      static_cast<const float*>(i), static_cast<const float*>(a_param),
      static_cast<float*>(out), s, d, degree, block_d, gapped, probe);
  return (int)cudaGetLastError();
}
