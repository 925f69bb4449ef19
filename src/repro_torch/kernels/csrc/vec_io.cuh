// V-wide f32 loads and stores for the streaming kernels (`stream.cu`) and
// the stencil (`stencil.cu`): V = 1 is a scalar, V = 2 one float2, V = 4
// or 8 one or two float4, so a thread's V consecutive elements move in as
// few vector transactions as their alignment allows.  Loads go through
// the read-only path (__ldg).  ``p`` must be aligned to the vector width
// (4 * V bytes, capped at 16).
#pragma once

#include <cuda_runtime.h>

namespace vio {

template <int V>
__device__ __forceinline__ void load(const float* p, float (&d)[V]) {
  if constexpr (V == 1) {
    d[0] = __ldg(p);
  } else if constexpr (V == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    d[0] = t.x, d[1] = t.y;
  } else {
#pragma unroll
    for (int h = 0; h < V / 4; ++h) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p) + h);
      d[4 * h] = t.x, d[4 * h + 1] = t.y, d[4 * h + 2] = t.z,
      d[4 * h + 3] = t.w;
    }
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&s)[V]) {
  if constexpr (V == 1) {
    p[0] = s[0];
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(s[0], s[1]);
  } else {
#pragma unroll
    for (int h = 0; h < V / 4; ++h)
      reinterpret_cast<float4*>(p)[h] =
          make_float4(s[4 * h], s[4 * h + 1], s[4 * h + 2], s[4 * h + 3]);
  }
}

}  // namespace vio
