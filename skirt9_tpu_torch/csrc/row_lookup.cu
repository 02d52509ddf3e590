// Chained per-lane row lookups: out[s, l] = sum over i < iters of
// tab[(idx[s, l] + i) mod R, l], for tab (R, W) f32 and idx (S, W) int32
// (R = 512, W = 128, S = 64, iters = 256 at the probe's shapes), added in i
// order like the plain versions.
//
// Replaces the Pallas TPU kernels of tools/bench_sublane_gather.py (driven by
// `run`): `kern_gather` (jnp.take_along_axis over axis 0, a per-lane sublane
// gather) and `kern_select` (the same values by a compare-select loop over
// all R rows). The TPU probe asked whether Mosaic's per-lane row gather beats
// an O(R) select loop; both loops are kept as the probe ran them.
//
// What bounds them on the H100: the 256 KB table and 32 KB of indices are
// read once (well under a microsecond of HBM), so both are bound by their
// operations and latency: the gather by 2.1 M dependent shared-memory loads,
// the select loop by 1.07e9 compare-selects.
//
// Gather design: a block covers 32 columns and 16 index rows; it stages
// tab[:, c0:c0+32] (R x 32 floats, 64 KB at R = 512: above the 48 KB
// default, opted in with cudaFuncSetAttribute) and each thread runs its
// lane's chain from shared memory. A warp reads 32 consecutive columns of
// one row: 32 banks, no conflicts.
//
// Select design: a group of G threads (G = 8 for R <= 512) shares one
// (s, l) lane; thread g of the group holds rows [64 g, 64 g + 64) of column
// l in registers, loaded once, so each register serves every compare of
// the chain. Per step each thread runs 64 compare-selects (v = ix == r ? t
// : v, four independent chains) and the group adds its candidates with
// __shfl_xor_sync: one value and zeros, so the sum is exact (tab >= 0, no
// -0), and the chain adds it in i order. Four steps are in flight at a
// time. At the probe's shapes 65,536 threads make 256 blocks of 256.
#include <cuda_runtime.h>

namespace skirt9 {

constexpr int kCols = 32;       // gather: columns per block (one warp's width)
constexpr int kRowsS = 16;      // gather: index rows per block
constexpr int kSelRows = 64;    // select: rows a thread holds in registers
constexpr int kSelThreads = 256;
constexpr int kSelSteps = 4;    // select: chain steps in flight

__device__ __forceinline__ int floor_mod(int a, int r) {
  const int m = a % r;
  return m < 0 ? m + r : m;
}

__global__ void row_gather_kernel(const float* __restrict__ tab,
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
  for (int i = 0; i < iters; ++i)
    acc += slice[floor_mod(base + i, R) * kCols + lc];
  out[(size_t)s * W + c0 + lc] = acc;
}

// G: threads per lane, a power of two with G * kSelRows >= R.
__global__ void __launch_bounds__(kSelThreads)
    row_select_kernel(const float* __restrict__ tab,
                      const int* __restrict__ idx, float* __restrict__ out,
                      int R, int W, int S, int iters, int G) {
  const long long tid = (long long)blockIdx.x * kSelThreads + threadIdx.x;
  const long long item = tid / G;           // the (s, l) lane
  const int g = (int)(tid % G);
  // a group past the last lane runs the chain on lane 0 (every thread of
  // the warp takes part in the shuffles) and writes nothing
  const bool valid = item < (long long)S * W;
  const long long it = valid ? item : 0;
  const int l = (int)(it % W);
  const int r0 = g * kSelRows;
  float t[kSelRows];
#pragma unroll
  for (int k = 0; k < kSelRows; ++k)
    t[k] = r0 + k < R ? tab[(size_t)(r0 + k) * W + l] : 0.0f;
  int ix = floor_mod(idx[it], R);           // the row of step i
  float acc = 0.0f;
  for (int i0 = 0; i0 < iters; i0 += kSelSteps) {
    float v[kSelSteps];
#pragma unroll
    for (int j = 0; j < kSelSteps; ++j) {
      const int rel = ix - r0;              // relative to this thread's rows
      float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, c3 = 0.0f;
#pragma unroll
      for (int k = 0; k < kSelRows; k += 4) {
        c0 = rel == k ? t[k] : c0;
        c1 = rel == k + 1 ? t[k + 1] : c1;
        c2 = rel == k + 2 ? t[k + 2] : c2;
        c3 = rel == k + 3 ? t[k + 3] : c3;
      }
      float u = (c0 + c1) + (c2 + c3);
      for (int off = 1; off < G; off <<= 1)
        u += __shfl_xor_sync(0xffffffffu, u, off);
      v[j] = u;
      ix = ix + 1 == R ? 0 : ix + 1;
    }
#pragma unroll
    for (int j = 0; j < kSelSteps; ++j)
      if (i0 + j < iters) acc += v[j];
  }
  if (valid && g == 0) out[item] = acc;
}

int row_gather_run(const void* tab, const void* idx, void* out, int R, int W,
                   int S, int iters, cudaStream_t stream) {
  const size_t bytes = (size_t)R * kCols * sizeof(float);
  if (bytes > 232448) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      row_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 blocks((W + kCols - 1) / kCols, (S + kRowsS - 1) / kRowsS);
  row_gather_kernel<<<blocks, dim3(kCols, kRowsS), bytes, stream>>>(
      (const float*)tab, (const int*)idx, (float*)out, R, W, S, iters);
  return (int)cudaGetLastError();
}

int row_select_run(const void* tab, const void* idx, void* out, int R, int W,
                   int S, int iters, cudaStream_t stream) {
  int G = 1;
  while (G * kSelRows < R) G <<= 1;
  if (G > 32) return (int)cudaErrorInvalidValue;
  const long long threads = (long long)S * W * G;
  const unsigned blocks =
      (unsigned)((threads + kSelThreads - 1) / kSelThreads);
  row_select_kernel<<<blocks, kSelThreads, 0, stream>>>(
      (const float*)tab, (const int*)idx, (float*)out, R, W, S, iters, G);
  return (int)cudaGetLastError();
}

}  // namespace skirt9

extern "C" int row_lookup_launch(const void* tab, const void* idx, void* out,
                                 int R, int W, int S, int iters, int select,
                                 void* stream) {
  if (R <= 0 || W <= 0 || S <= 0 || iters < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return select ? skirt9::row_select_run(tab, idx, out, R, W, S, iters, s)
                : skirt9::row_gather_run(tab, idx, out, R, W, S, iters, s);
}
