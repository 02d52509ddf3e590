// Scatter-add of n float values into `size` bins: out[idx[i]] += val[i].
//
// Replaces the Pallas TPU kernel skirt9_tpu/ops/scatteradd.py `_kernel`
// (wrappers `_pallas_scatter`, `scatter_add`), which sums through a one-hot
// matmul pair on the MXU with bf16-rounded terms; here every term is an exact
// f32 add. The caller zeroes `out`; indices outside [0, size) are dropped.
//
// What bounds it on the H100: atomic throughput on contended addresses. The
// instrument accumulators of config 1 are the worst case: the SED and the
// statistics rows have ONE bin, so all 131,072 lanes of a batch add into one
// address. Design: (1) per warp, when all 32 lanes target one bin (found with
// __match_any_sync), a shuffle reduction and one atomic instead of 32;
// (2) when the bins fit in shared memory (<= 48 KB, so up to 12,288 bins,
// which covers the 64 x 64 frame) a block-private histogram takes the
// atomics in shared memory and is flushed to global memory once per block,
// skipping empty bins; larger tables take global atomics directly. Zero
// values issue no atomic. Float atomics make the sums order-dependent from
// run to run (not bit-reproducible, unlike the CPU's index_add_).
#include "scatter_common.cuh"

namespace skirt9 {

constexpr int kSmemBins = 48 * 1024 / 4;

__global__ void scatter_add_smem(const int* __restrict__ idx,
                                 const float* __restrict__ val,
                                 float* __restrict__ out, int n, int size) {
  extern __shared__ float hist[];
  for (int i = threadIdx.x; i < size; i += blockDim.x) hist[i] = 0.0f;
  __syncthreads();
  const int stride = gridDim.x * blockDim.x;
  // base is uniform across the block, so whole warps iterate together
  for (int base = blockIdx.x * blockDim.x; base < n; base += stride) {
    const int i = base + threadIdx.x;
    const int b = i < n ? idx[i] : -1;
    const float v = i < n ? val[i] : 0.0f;
    warp_scatter(hist, b, v, b >= 0 && b < size);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < size; i += blockDim.x) {
    const float h = hist[i];
    if (h != 0.0f) atomicAdd(out + i, h);
  }
}

__global__ void scatter_add_global(const int* __restrict__ idx,
                                   const float* __restrict__ val,
                                   float* __restrict__ out, int n, int size) {
  const int stride = gridDim.x * blockDim.x;
  for (int base = blockIdx.x * blockDim.x; base < n; base += stride) {
    const int i = base + threadIdx.x;
    const int b = i < n ? idx[i] : -1;
    const float v = i < n ? val[i] : 0.0f;
    warp_scatter(out, b, v, b >= 0 && b < size);
  }
}

}  // namespace skirt9

extern "C" int scatter_add_launch(const void* idx, const void* val, void* out,
                                  int n, int size, void* stream) {
  if (n < 0 || size <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  int blocks = (n + threads - 1) / threads;
  // two blocks per SM of an H100 at most; each block strides over the rest
  if (blocks > 264) blocks = 264;
  if (blocks < 1) blocks = 1;
  cudaStream_t s = (cudaStream_t)stream;
  if (size <= skirt9::kSmemBins) {
    skirt9::scatter_add_smem<<<blocks, threads, size * sizeof(float), s>>>(
        (const int*)idx, (const float*)val, (float*)out, n, size);
  } else {
    skirt9::scatter_add_global<<<blocks, threads, 0, s>>>(
        (const int*)idx, (const float*)val, (float*)out, n, size);
  }
  return (int)cudaGetLastError();
}
