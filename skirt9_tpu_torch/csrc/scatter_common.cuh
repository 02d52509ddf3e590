// Warp-aggregated float scatter-add, shared by scatter_add.cu and detect.cu.
#pragma once

#include <cuda_runtime.h>

namespace skirt9 {

constexpr unsigned kFull = 0xffffffffu;

// Sum of v over the warp; the total is valid in lane 0.
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

// Add one element per thread into `dst`; all 32 lanes of the warp must call.
// When every lane targets one bin (found with __match_any_sync), a shuffle
// reduction and one atomic instead of 32. Zero values issue no atomic.
__device__ __forceinline__ void warp_scatter(float* dst, int b, float v,
                                             bool valid) {
  const unsigned same = __match_any_sync(kFull, valid ? b : -1);
  if (same == kFull) {
    v = warp_sum(v);
    if ((threadIdx.x & 31) == 0 && valid && v != 0.0f) atomicAdd(dst + b, v);
  } else if (valid && v != 0.0f) {
    atomicAdd(dst + b, v);
  }
}

}  // namespace skirt9
