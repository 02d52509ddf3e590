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
// 128 KB table, 0.2 us of HBM); the time is set by the launch (an empty
// kernel takes 0.83 us of device time), by staging the table on chip, by
// the rate of the scattered reads and, for the scatter, of the atomics.
// Designs:
//   probe_gather_smem   the whole table in every block's shared memory, no
//                       cluster: one block of 1024 threads per SM stages it
//                       with 16-byte loads (132 copies, 16.9 MB from L2 at
//                       the probe's shapes), then gathers grid-stride from
//                       it. Measured on the H100 (perf/kernel8_variants.py),
//                       every design that shares one table over a cluster
//                       is slower: a random read through distributed shared
//                       memory runs at a fifth of a block-local one and
//                       below an L2 read, while L2 serves the per-block
//                       copies easily, and TMA multicast of the table costs
//                       more than it saves;
//   probe_gather_l2     four indices per thread (16-byte index loads and
//                       output stores), the table read through the
//                       read-only path (__ldg), a grid of at most 8 blocks
//                       of 256 per SM;
//   probe_scatter_smem  (kernel `probe_scatter_global`) at B / N = 4 a
//                       private histogram buys nothing: one global float
//                       atomic per index (four per thread, 16-byte loads),
//                       as kernel 3 does above 12,288 bins; a histogram
//                       split over a cluster measured slower still.
// The launchers read the SM count and set the staged gather's shared-memory
// limit once per process and device. Indices outside [0, N) gather 0 and
// scatter nothing.
#include <cuda_runtime.h>

#include <mutex>

namespace skirt9 {

constexpr int kStagedThreads = 1024;
constexpr int kVecThreads = 256;    // the L2 gather and the scatter
constexpr int kVecBlocksPerSm = 8;
constexpr int kMaxStaged = 232448;  // a block's shared-memory limit, bytes
constexpr int kMaxDevices = 64;

__global__ void __launch_bounds__(kStagedThreads)
    probe_gather_smem(const float* __restrict__ nd,
                      const int* __restrict__ idx, float* __restrict__ out,
                      int n, int B) {
  extern __shared__ float4 tab4[];
  float* tab = reinterpret_cast<float*>(tab4);
  const float4* nd4 = reinterpret_cast<const float4*>(nd);
  for (int i = threadIdx.x; i < n / 4; i += kStagedThreads) tab4[i] = nd4[i];
  for (int i = n / 4 * 4 + threadIdx.x; i < n; i += kStagedThreads)
    tab[i] = nd[i];
  __syncthreads();
  for (int i = blockIdx.x * kStagedThreads + threadIdx.x; i < B;
       i += gridDim.x * kStagedThreads) {
    const int j = idx[i];
    out[i] = (j >= 0 && j < n) ? tab[j] : 0.0f;
  }
}

__device__ __forceinline__ float lookup(const float* __restrict__ nd, int j,
                                        int n) {
  return (j >= 0 && j < n) ? __ldg(nd + j) : 0.0f;
}

__global__ void __launch_bounds__(kVecThreads)
    probe_gather_l2(const float* __restrict__ nd, const int* __restrict__ idx,
                    float* __restrict__ out, int n, int B) {
  const int stride = gridDim.x * kVecThreads;
  const int first = blockIdx.x * kVecThreads + threadIdx.x;
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  float4* out4 = reinterpret_cast<float4*>(out);
  for (int i = first; i < B / 4; i += stride) {
    const int4 j = idx4[i];
    out4[i] = make_float4(lookup(nd, j.x, n), lookup(nd, j.y, n),
                          lookup(nd, j.z, n), lookup(nd, j.w, n));
  }
  for (int i = B / 4 * 4 + first; i < B; i += stride)
    out[i] = lookup(nd, idx[i], n);
}

__device__ __forceinline__ void add_at(float* __restrict__ out, int j,
                                       float v, int n) {
  if (j >= 0 && j < n) atomicAdd(out + j, v);
}

__global__ void __launch_bounds__(kVecThreads)
    probe_scatter_global(const int* __restrict__ idx,
                         const float* __restrict__ val,
                         float* __restrict__ out, int n, int B) {
  const int stride = gridDim.x * kVecThreads;
  const int first = blockIdx.x * kVecThreads + threadIdx.x;
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  const float4* val4 = reinterpret_cast<const float4*>(val);
  for (int i = first; i < B / 4; i += stride) {
    const int4 j = idx4[i];
    const float4 v = val4[i];
    add_at(out, j.x, v.x, n);
    add_at(out, j.y, v.y, n);
    add_at(out, j.z, v.z, n);
    add_at(out, j.w, v.w, n);
  }
  for (int i = B / 4 * 4 + first; i < B; i += stride)
    add_at(out, idx[i], val[i], n);
}

// The SM count and the staged gather's shared-memory limit, set up once per
// process and device; the error of that set-up, if any, on every call.
struct DeviceSetup {
  int sms = 0;
  cudaError_t err = cudaSuccess;
};

int device_setup(DeviceSetup** out) {
  static std::once_flag once[kMaxDevices];
  static DeviceSetup setup[kMaxDevices];
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  std::call_once(once[dev], [dev] {
    DeviceSetup& d = setup[dev];
    d.err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (d.err == cudaSuccess)
      d.err = cudaFuncSetAttribute(
          probe_gather_smem, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kMaxStaged);
  });
  *out = &setup[dev];
  return (int)setup[dev].err;
}

// blocks of kVecThreads for B indices, four per thread, at most
// kVecBlocksPerSm per SM
unsigned vec_blocks(int B, int sms) {
  const long long want = ((long long)B / 4 + kVecThreads - 1) / kVecThreads;
  const long long most = (long long)sms * kVecBlocksPerSm;
  return (unsigned)(want < 1 ? 1 : want < most ? want : most);
}

}  // namespace skirt9

extern "C" int probe_gather_launch(const void* nd, const void* idx, void* out,
                                   int n, int B, int staged, void* stream) {
  if (n <= 0 || B < 0 || (staged && (size_t)n * 4 > skirt9::kMaxStaged))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  skirt9::DeviceSetup* dev = nullptr;
  const int err = skirt9::device_setup(&dev);
  if (err != 0) return err;
  cudaStream_t s = (cudaStream_t)stream;
  if (staged)
    skirt9::probe_gather_smem<<<dev->sms, skirt9::kStagedThreads,
                                (size_t)n * 4, s>>>(
        (const float*)nd, (const int*)idx, (float*)out, n, B);
  else
    skirt9::probe_gather_l2<<<skirt9::vec_blocks(B, dev->sms),
                              skirt9::kVecThreads, 0, s>>>(
        (const float*)nd, (const int*)idx, (float*)out, n, B);
  return (int)cudaGetLastError();
}

extern "C" int probe_scatter_launch(const void* idx, const void* val,
                                    void* out, int n, int B, void* stream) {
  if (n <= 0 || B < 0 || (size_t)n * 4 > skirt9::kMaxStaged)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  skirt9::DeviceSetup* dev = nullptr;
  const int err = skirt9::device_setup(&dev);
  if (err != 0) return err;
  skirt9::probe_scatter_global<<<skirt9::vec_blocks(B, dev->sms),
                                 skirt9::kVecThreads, 0,
                                 (cudaStream_t)stream>>>(
      (const int*)idx, (const float*)val, (float*)out, n, B);
  return (int)cudaGetLastError();
}
