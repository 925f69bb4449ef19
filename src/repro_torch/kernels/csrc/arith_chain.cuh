// The paper's arithmetic chain (`_arith_chain` of
// `repro/kernels/ew_stream.py:42`) for one element, shared by the streaming
// kernels (`stream.cu`) and the windowed gather (`windowed_gather.cu`).
//
// Op t reads register (t+1) % NL: t % 3 == 0 adds it, 1 subtracts it, 2
// takes the mean of the accumulator and it.  The pattern repeats every
// lcm(3, NL) ops, so the loop is unrolled by that period and every register
// index is a compile-time constant.  Every product is by 0.5, so it is
// exact; the ops are __fadd_rn / __fsub_rn / __fmul_rn, which are never
// contracted into an FMA, in the reference's order: a kernel built on it
// equals its plain version bit for bit.
#pragma once

#include <cuda_runtime.h>

__host__ __device__ constexpr int lcm3(int n) { return n % 3 == 0 ? n : 3 * n; }

// `_arith_chain(regs[ROT:] + regs[:ROT], n_arith)`
template <int NL, int ROT>
__device__ __forceinline__ float chain(const float (&r)[NL], int n_arith) {
  constexpr int P = lcm3(NL);
  float acc = r[ROT % NL];
  for (int t0 = 0; t0 < n_arith; t0 += P) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (t0 + j < n_arith) {
        const float x = r[(j + 1 + ROT) % NL];
        if (j % 3 == 0)
          acc = __fadd_rn(acc, x);
        else if (j % 3 == 1)
          acc = __fsub_rn(acc, x);
        else
          acc = __fadd_rn(__fmul_rn(acc, 0.5f), __fmul_rn(x, 0.5f));
      }
    }
  }
  return acc;
}
