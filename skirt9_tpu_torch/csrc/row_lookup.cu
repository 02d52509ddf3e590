// Chained per-lane row lookups: out[s, l] = sum over i < iters of
// tab[(idx[s, l] + i) mod R, l], for tab (R, W) f32 and idx (S, W) int32
// (R = 512, W = 128, S = 64, iters = 256 at the probe's shapes).
//
// Replaces the Pallas TPU kernels of tools/bench_sublane_gather.py (driven by
// `run`): `kern_gather` (jnp.take_along_axis over axis 0, a per-lane sublane
// gather) and `kern_select` (the same values by a compare-select loop over
// all R rows). The TPU probe asked whether Mosaic's per-lane row gather beats
// an O(R) select loop; on Hopper a lane's column is fixed, so a block stages
// the column slice its threads read in shared memory and looks rows up there.
//
// What bounds them on the H100: the 256 KB table and 32 KB of indices are
// read once (well under a microsecond of HBM), so both are bound by their
// operations and latency: the gather by 2.1 M dependent shared-memory loads,
// the select loop by 1.07e9 compare-selects. Design: a block covers 32
// columns and 16 index rows; it stages tab[:, c0:c0+32] (R x 32 floats,
// 64 KB at R = 512: above the 48 KB default, opted in with
// cudaFuncSetAttribute) and each thread runs its lane's chain, adding in
// i order like the plain versions. A warp reads 32 consecutive columns of
// one row: 32 banks, no conflicts.
#include <cuda_runtime.h>

namespace skirt9 {

constexpr int kCols = 32;      // columns per block (one warp's width)
constexpr int kRowsS = 16;     // index rows per block

__device__ __forceinline__ int floor_mod(int a, int r) {
  const int m = a % r;
  return m < 0 ? m + r : m;
}

template <bool kSelect>
__global__ void row_lookup_kernel(const float* __restrict__ tab,
                                  const int* __restrict__ idx,
                                  float* __restrict__ out, int R, int W, int S,
                                  int iters) {
  extern __shared__ float slice[];          // (R, kCols)
  const int c0 = blockIdx.x * kCols;
  const int lc = threadIdx.x;               // column within the slice
  const int s = blockIdx.y * kRowsS + threadIdx.y;
  const int tid = threadIdx.y * kCols + threadIdx.x;
  for (int k = tid; k < R * kCols; k += kCols * kRowsS) {
    const int r = k / kCols, c = c0 + k % kCols;
    slice[k] = c < W ? tab[(size_t)r * W + c] : 0.0f;
  }
  __syncthreads();
  if (s >= S || c0 + lc >= W) return;
  const int base = idx[(size_t)s * W + c0 + lc];
  float acc = 0.0f;
  for (int i = 0; i < iters; ++i) {
    const int ix = floor_mod(base + i, R);
    float v;
    if (kSelect) {
      v = 0.0f;
      for (int r = 0; r < R; ++r) v += (ix == r) ? slice[r * kCols + lc] : 0.0f;
    } else {
      v = slice[ix * kCols + lc];
    }
    acc += v;
  }
  out[(size_t)s * W + c0 + lc] = acc;
}

template <bool kSelect>
int row_lookup_run(const void* tab, const void* idx, void* out, int R, int W,
                   int S, int iters, cudaStream_t stream) {
  const size_t bytes = (size_t)R * kCols * sizeof(float);
  if (R <= 0 || W <= 0 || S <= 0 || iters < 0 || bytes > 232448)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      (const void*)row_lookup_kernel<kSelect>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 blocks((W + kCols - 1) / kCols, (S + kRowsS - 1) / kRowsS);
  row_lookup_kernel<kSelect><<<blocks, dim3(kCols, kRowsS), bytes, stream>>>(
      (const float*)tab, (const int*)idx, (float*)out, R, W, S, iters);
  return (int)cudaGetLastError();
}

}  // namespace skirt9

extern "C" int row_lookup_launch(const void* tab, const void* idx, void* out,
                                 int R, int W, int S, int iters, int select,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return select ? skirt9::row_lookup_run<true>(tab, idx, out, R, W, S, iters, s)
                : skirt9::row_lookup_run<false>(tab, idx, out, R, W, S, iters,
                                                s);
}
