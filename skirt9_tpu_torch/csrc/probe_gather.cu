// Gather and scatter-add probes against an on-chip table: out[i] = nd[idx[i]]
// and hist[idx[i]] += val[i], for an N-entry float table (N = 32,768, 128 KB)
// and B = 131,072 indices.
//
// Replaces the Pallas TPU kernels of tools/_pallas_probe.py: `gather_kernel`
// and `take_kernel` (the same function in two spellings, `nd_ref[idx]` and
// `jnp.take`; both contracts go through probe_gather_smem) and `scat_kernel`
// (`.at[idx].add` into a VMEM accumulator). The TPU probes asked whether a
// table held in VMEM can be gathered from and scattered into per lane; on
// Hopper the question is what a table in shared memory buys over reads and
// atomics through L2.
//
// What bounds them on the H100: the bytes are tiny (512 KB of indices, the
// 128 KB table); the time is set by staging the table into each block's
// shared memory, by L2 latency for the scattered reads, and by atomic
// throughput for the scatter. Designs:
//   probe_gather_smem   one block per SM (128 KB of dynamic shared memory
//                       each, above the 48 KB default: opted in with
//                       cudaFuncSetAttribute), stages the whole table with
//                       16-byte loads, then gathers grid-stride from it;
//   probe_gather_l2     one thread per index, the table read through the
//                       read-only path (__ldg), no staging;
//   probe_scatter_smem  one block per SM, a 32,768-bin shared accumulator
//                       (128 KB) taking shared atomics, flushed once per
//                       block with one global atomic per nonzero bin.
// Indices outside [0, N) gather 0 and scatter nothing.
#include <cuda_runtime.h>

namespace skirt9 {

__global__ void probe_gather_smem(const float* __restrict__ nd,
                                  const int* __restrict__ idx,
                                  float* __restrict__ out, int n, int B) {
  extern __shared__ float4 tab4[];
  float* tab = reinterpret_cast<float*>(tab4);
  const int n4 = n / 4;
  const float4* nd4 = reinterpret_cast<const float4*>(nd);
  for (int i = threadIdx.x; i < n4; i += blockDim.x) tab4[i] = nd4[i];
  for (int i = 4 * n4 + threadIdx.x; i < n; i += blockDim.x) tab[i] = nd[i];
  __syncthreads();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < B;
       i += gridDim.x * blockDim.x) {
    const int j = idx[i];
    out[i] = (j >= 0 && j < n) ? tab[j] : 0.0f;
  }
}

__global__ void probe_gather_l2(const float* __restrict__ nd,
                                const int* __restrict__ idx,
                                float* __restrict__ out, int n, int B) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int j = idx[i];
  out[i] = (j >= 0 && j < n) ? __ldg(nd + j) : 0.0f;
}

__global__ void probe_scatter_smem(const int* __restrict__ idx,
                                   const float* __restrict__ val,
                                   float* __restrict__ out, int n, int B) {
  extern __shared__ float hist[];
  for (int i = threadIdx.x; i < n; i += blockDim.x) hist[i] = 0.0f;
  __syncthreads();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < B;
       i += gridDim.x * blockDim.x) {
    const int j = idx[i];
    if (j >= 0 && j < n) atomicAdd(hist + j, val[i]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float h = hist[i];
    if (h != 0.0f) atomicAdd(out + i, h);
  }
}

// One block per SM, each with the whole n-entry table in shared memory.
int smem_launch_setup(const void* kernel, int n, int* blocks) {
  const size_t bytes = (size_t)n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(blocks, cudaDevAttrMultiProcessorCount,
                                     dev);
}

}  // namespace skirt9

extern "C" int probe_gather_launch(const void* nd, const void* idx, void* out,
                                   int n, int B, int staged, void* stream) {
  if (n <= 0 || B < 0 || (staged && (size_t)n * 4 > 232448))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 1024;
  if (staged) {
    int blocks = 0;
    const int err = skirt9::smem_launch_setup(
        (const void*)skirt9::probe_gather_smem, n, &blocks);
    if (err != 0) return err;
    skirt9::probe_gather_smem<<<blocks, threads, (size_t)n * 4, s>>>(
        (const float*)nd, (const int*)idx, (float*)out, n, B);
  } else {
    skirt9::probe_gather_l2<<<(B + threads - 1) / threads, threads, 0, s>>>(
        (const float*)nd, (const int*)idx, (float*)out, n, B);
  }
  return (int)cudaGetLastError();
}

extern "C" int probe_scatter_launch(const void* idx, const void* val,
                                    void* out, int n, int B, void* stream) {
  if (n <= 0 || B < 0 || (size_t)n * 4 > 232448)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  int blocks = 0;
  const int err = skirt9::smem_launch_setup(
      (const void*)skirt9::probe_scatter_smem, n, &blocks);
  if (err != 0) return err;
  skirt9::probe_scatter_smem<<<blocks, 1024, (size_t)n * 4,
                               (cudaStream_t)stream>>>(
      (const int*)idx, (const float*)val, (float*)out, n, B);
  return (int)cudaGetLastError();
}
