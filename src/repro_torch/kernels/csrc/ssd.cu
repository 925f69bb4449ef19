// Mamba-2 SSD (state-space duality), chunked and head-coarsened, f32.
//
// Replaces `repro/kernels/ssd.py` `make_kernel` (its pl.pallas_call at
// :100).  There the grid is (batch, head program, chunk) with the chunk
// axis sequential: each step loads one chunk's B and C tile (chunk x N)
// once for the program's C heads and carries their (C, N, P) states in VMEM
// scratch across chunks.  C heads are adjacent (consecutive: they lie in
// one group, so they share the group's B/C) or H/C apart (gapped: needs one
// group).  Per chunk and head, with cum the prefix sum of dt * A:
//
//   y[t]   = sum_{u<=t} (C[t].B[u]) e^{cum[t]-cum[u]} dt[u] x[u]
//          + e^{cum[t]} C[t] . state
//   state' = e^{cum[T-1]} state + sum_u B[u] dt[u] e^{cum[T-1]-cum[u]} x[u]
//
// Here one thread block (256 threads) is one program: blockIdx = (head
// program, batch).  It walks the chunks in order.  For each chunk it stages
// B and C in shared memory once (B in both orientations, C transposed) and
// forms C.B^T once; then, head by head, it stages dt, x and the head's state,
// takes the prefix sum of dt * A with one warp, builds W^T[u][t] (the causal
// weights, the exponent of u > t never formed) and computes
// y = W x + e^{cum} (C state) and the state update as three products over
// shared memory.  Every product is a hand-written loop: each thread owns a
// 4 x 4 output tile and reads one float4 of each operand per step of the
// contraction (all operands are stored contraction-major), with FMAs in f32;
// the intra-chunk product stops at the tile's last row (u <= t).
//
// The states: one head's (N, P) state is 32 KB at mamba2-370m's N 128, P 64,
// and B, B^T, C^T, C.B^T, W^T, x and one state already take 187 KB of the
// 227 KB a block may have, so the C states do not all fit (con4 would need
// 128 KB of state alone).  They live in a global workspace of (B, H, N, P)
// f32 (4 MB at the check's shape, resident in the 50 MB L2), one head's
// state staged in shared memory at a time: read at the chunk's start
// (zeros at chunk 0), written back updated after the chunk (not after the
// last).  So every label is taken whatever its degree, and the B/C tile is
// still fetched once for the program's C heads.
//
// Bound on the H100: x, dt, B, C read and y written once against the f32
// operations the function needs (the lower triangle of C.B^T once per
// batch, group and chunk and of W x per batch, head and chunk; the state
// read after chunk 0 and the update before the last chunk per batch and
// head) over 67 TFLOP/s: at mamba2-370m's geometry, B 4, S 2048, the
// operations bind (~9.48 GFLOP, 0.1415 ms).  The design's limits:
// B * H / C blocks (128 at base, 32 at con4 at the check's shape, on 132
// SMs), one block an SM (191 KB of shared memory), and 1 float4 load per
// 4 FMAs of a thread.
//
// probe = 1 stores the head program's index (as float32) in place of y, to
// hold the head-to-program map against the Pallas index maps.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int NT = 256;

struct Geo {
  int h, g, s, p, n, t, c, gapped, nh, rep;
};

// floats of shared memory for a chunk of t, state n x p (all rows padded by
// 4 floats, which keeps float4 alignment and spreads the transposing stores).
// `kernels/ssd.py` `smem_bytes` is the same sum: change both together.  A
// size past the block's limit fails at cudaFuncSetAttribute.
__host__ __device__ size_t smem_floats(int t, int n, int p) {
  return (size_t)t * (n + 4) + 2 * (size_t)n * (t + 4) +
         2 * (size_t)t * (t + 4) + (size_t)t * (p + 4) +
         (size_t)n * (p + 4) + 4 * (size_t)t;
}

// acc[i][j] += sum_{k < k_end} A[k][r0 + i] * Bm[k][c0 + j]: both operands
// contraction-major in shared memory, one float4 of each a step.
__device__ __forceinline__ void mma4x4(const float* A, int lda,
                                       const float* Bm, int ldb, int k_end,
                                       int r0, int c0, float (&acc)[4][4]) {
#pragma unroll 4
  for (int k = 0; k < k_end; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(A + k * lda + r0);
    const float4 b = *reinterpret_cast<const float4*>(Bm + k * ldb + c0);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__global__ void __launch_bounds__(NT)
    ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const float* __restrict__ bm,
               const float* __restrict__ cm, float* __restrict__ y,
               float* __restrict__ ws, Geo G, int probe) {
  extern __shared__ float4 smem4[];
  const int T = G.t, N = G.n, P = G.p;
  const int ldt = T + 4, ldn = N + 4, ldp = P + 4;
  float* sB = reinterpret_cast<float*>(smem4);   // [T][N]  B
  float* sBT = sB + T * ldn;                      // [N][T]  B^T
  float* sCT = sBT + N * ldt;                     // [N][T]  C^T
  float* sCBT = sCT + N * ldt;                    // [T][T]  (C.B^T)^T
  float* sWT = sCBT + T * ldt;                    // [T][T]  W^T, this head
  float* sX = sWT + T * ldt;                      // [T][P]  x, then dt-weighted
  float* sS = sX + T * ldp;                       // [N][P]  this head's state
  float* sdt = sS + N * ldp;                      // [T]
  float* scum = sdt + T;                          // [T]  prefix sum of dt*A
  float* secum = scum + T;                        // [T]  e^{cum}
  float* sw = secum + T;                          // [T]  dt e^{cum[T-1]-cum}

  const int tid = threadIdx.x, hh = blockIdx.x, bi = blockIdx.y;
  const int grp = G.gapped ? 0 : hh * G.c / G.rep;
  const int nc = G.s / T;
  const size_t bc0 = ((size_t)bi * G.g + grp) * G.s * N;
  for (int ci = 0; ci < nc; ++ci) {
    const size_t t0 = (size_t)ci * T;
    const float* bsrc = bm + bc0 + t0 * N;
    const float* csrc = cm + bc0 + t0 * N;
    for (int e = tid; e < T * N; e += NT) {
      const int t = e / N, k = e - t * N;
      const float bv = __ldg(bsrc + e), cv = __ldg(csrc + e);
      sB[t * ldn + k] = bv;
      sBT[k * ldt + t] = bv;
      sCT[k * ldt + t] = cv;
    }
    __syncthreads();
    // (C.B^T)^T[u][t] = sum_n B[u,n] C[t,n]: once for the C heads
    for (int q = tid; q < (T / 4) * (T / 4); q += NT) {
      const int r0 = q / (T / 4) * 4, c0 = q % (T / 4) * 4;
      float acc[4][4] = {};
      mma4x4(sBT, ldt, sCT, ldt, N, r0, c0, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(sCBT + (r0 + i) * ldt + c0) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    for (int k = 0; k < G.c; ++k) {
      const int head = G.gapped ? k * G.nh + hh : hh * G.c + k;
      const size_t row0 = ((size_t)bi * G.h + head) * G.s + t0;
      float* wsh = ws + ((size_t)bi * G.h + head) * N * P;
      for (int t = tid; t < T; t += NT) sdt[t] = __ldg(dt + row0 + t);
      const float* xsrc = x + row0 * P;
      for (int e = tid; e < T * P; e += NT) {
        const int t = e / P;
        sX[t * ldp + e - t * P] = __ldg(xsrc + e);
      }
      for (int e = tid; e < N * P; e += NT) {
        const int m = e / P;
        sS[m * ldp + e - m * P] = ci ? wsh[e] : 0.f;
      }
      __syncthreads();                  // also completes C.B^T
      if (tid < 32) {
        // cum = prefix sum of dt * A: lane l sums its T/32 steps, then a
        // warp scan of the lane totals
        const float ah = __ldg(a + head);
        const int e = T / 32;
        float run = 0.f;
        for (int j = 0; j < e; ++j) {
          run = __fadd_rn(run, __fmul_rn(sdt[tid * e + j], ah));
          scum[tid * e + j] = run;
        }
        float inc = run;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float v = __shfl_up_sync(0xffffffffu, inc, off);
          if (tid >= off) inc += v;
        }
        float excl = __shfl_up_sync(0xffffffffu, inc, 1);
        if (tid == 0) excl = 0.f;
        for (int j = 0; j < e; ++j) scum[tid * e + j] += excl;
        __syncwarp();
        const float total = scum[T - 1];
        for (int j = 0; j < e; ++j) {
          const int t = tid * e + j;
          secum[t] = expf(scum[t]);
          sw[t] = sdt[t] * expf(total - scum[t]);
        }
      }
      __syncthreads();
      // W^T[u][t] = (C.B^T)[t][u] e^{cum[t]-cum[u]} dt[u] for u <= t, else 0
      for (int e = tid; e < T * T; e += NT) {
        const int u = e / T, t = e - u * T;
        sWT[u * ldt + t] =
            t >= u ? sCBT[u * ldt + t] * expf(scum[t] - scum[u]) * sdt[u]
                   : 0.f;
      }
      __syncthreads();
      // y = W x + e^{cum} (C state)
      float* ydst = y + row0 * P;
      for (int q = tid; q < (T / 4) * (P / 4); q += NT) {
        const int r0 = q / (P / 4) * 4, c0 = q % (P / 4) * 4;
        float yi[4][4] = {}, ys[4][4] = {};
        mma4x4(sWT, ldt, sX, ldp, r0 + 4, r0, c0, yi);   // W^T[u][t] = 0, u > t
        mma4x4(sCT, ldt, sS, ldp, N, r0, c0, ys);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float o[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            o[j] = probe ? (float)hh : yi[i][j] + secum[r0 + i] * ys[i][j];
          *reinterpret_cast<float4*>(ydst + (size_t)(r0 + i) * P + c0) =
              make_float4(o[0], o[1], o[2], o[3]);
        }
      }
      if (ci + 1 < nc) {
        __syncthreads();
        for (int e = tid; e < T * P; e += NT) {
          const int t = e / P;
          sX[t * ldp + e - t * P] *= sw[t];
        }
        __syncthreads();
        // state' = e^{cum[T-1]} state + B^T (w x), written back to the
        // workspace for the next chunk
        const float etot = expf(scum[T - 1]);
        for (int q = tid; q < (N / 4) * (P / 4); q += NT) {
          const int r0 = q / (P / 4) * 4, c0 = q % (P / 4) * 4;
          float up[4][4] = {};
          mma4x4(sB, ldn, sX, ldp, T, r0, c0, up);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float* s0 = sS + (r0 + i) * ldp + c0;
            *reinterpret_cast<float4*>(wsh + (size_t)(r0 + i) * P + c0) =
                make_float4(etot * s0[0] + up[i][0], etot * s0[1] + up[i][1],
                            etot * s0[2] + up[i][2], etot * s0[3] + up[i][3]);
          }
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace

// x: (batch, h, s, p), dt: (batch, h, s), a: (h,), b and c: (batch, g, s, n),
// y: (batch, h, s, p), ws: (batch, h, n, p) scratch; all f32, contiguous and
// 16-byte aligned.  The head program hh owns heads [hh*degree, +degree)
// (consecutive, (h/g) % degree == 0) or {k*(h/degree) + hh} (gapped, g 1).
extern "C" int ssd_f32(const void* x, const void* dt, const void* a,
                       const void* b, const void* c, void* y, void* ws,
                       int batch, int h, int g, int s, int p, int n,
                       int chunk, int degree, int gapped, int probe,
                       void* stream) {
  if (batch < 1 || batch > 65535 || h < 1 || g < 1 || h % g || p < 4 ||
      p % 4 || n < 4 || n % 4 || chunk < 32 || chunk % 32 || s < chunk ||
      s % chunk || degree < 1 || h % degree || (gapped && g != 1) ||
      (!gapped && (h / g) % degree))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(chunk, n, p) * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const Geo geo{h, g, s, p, n, chunk, degree, gapped, h / degree, h / g};
  ssd_kernel<<<dim3(h / degree, batch), NT, smem,
               reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<float*>(y),
      static_cast<float*>(ws), geo, probe);
  return (int)cudaGetLastError();
}
