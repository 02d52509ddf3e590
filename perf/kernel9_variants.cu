// Variants of kernel 9's row gather (skirt9_tpu_torch/csrc/row_lookup.cu,
// `row_gather_kernel`) that the package does not ship, for
// perf/kernel9_variants.py. Each computes out[s, l] = sum over i < iters of
// tab[(idx[s, l] + i) mod R, l], added in i order from 0.0f, bit for bit
// the plain version's:
//
//   0 old    the parent's design: a block per 32 columns and 16 index
//            rows (16 blocks at the probe's shapes), the 64 KB column slice
//            staged with 4-byte loads, a signed `%` by R at every step;
//   1 inc    the same with the row formed once and stepped by a
//            wrap-around increment;
//   2 wide   one thread per lane, a block per 8 columns and 4 index rows
//            (256 blocks of 32 threads), the 16 KB slice staged with
//            16-byte loads;
//   3 ldg    one thread per lane, 256 blocks, no staging: the table read
//            through L1 (`__ldg`);
//   4 cluster  the package's layout (8 threads per lane, the sum passed by
//            __shfl_sync) with the slice split over a cluster of 4 blocks
//            (the 4 index-row groups of one column group), each staging a
//            quarter of the rows and reading the others' through
//            distributed shared memory;
//   5 group_first  the package's kernel as first measured: its start row
//            loaded after the staging, the staging loop not unrolled;
//   6 group4, 7 group16  the package's design with 4 threads of 64 steps
//            and 16 threads of 16 steps per lane.
//
// Every launch sets its attributes as the parent did (per call).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace k9v {

__device__ __forceinline__ int floor_mod(int a, int r) {
  const int m = a % r;
  return m < 0 ? m + r : m;
}

__device__ __forceinline__ int floor_mod64(long long a, int r) {
  const int m = (int)(a % r);
  return m < 0 ? m + r : m;
}

// 0 and 1: the parent's block of 32 columns x 16 index rows
constexpr int kOldCols = 32, kOldRows = 16;

template <bool kIncrement>
__global__ void old_kernel(const float* __restrict__ tab,
                           const int* __restrict__ idx,
                           float* __restrict__ out, int R, int W, int S,
                           int iters) {
  extern __shared__ float slice[];          // (R, kOldCols)
  const int c0 = blockIdx.x * kOldCols;
  const int lc = threadIdx.x;
  const int s = blockIdx.y * kOldRows + threadIdx.y;
  const int tid = threadIdx.y * kOldCols + threadIdx.x;
  for (int k = tid; k < R * kOldCols; k += kOldCols * kOldRows) {
    const int r = k / kOldCols, c = c0 + k % kOldCols;
    slice[k] = c < W ? tab[(size_t)r * W + c] : 0.0f;
  }
  __syncthreads();
  if (s >= S || c0 + lc >= W) return;
  const int base = idx[(size_t)s * W + c0 + lc];
  float acc = 0.0f;
  if (kIncrement) {
    int r = floor_mod64(base, R);
    for (int i = 0; i < iters; ++i) {
      acc += slice[r * kOldCols + lc];
      r = r + 1 == R ? 0 : r + 1;
    }
  } else {
    for (int i = 0; i < iters; ++i)
      acc += slice[floor_mod(base + i, R) * kOldCols + lc];
  }
  out[(size_t)s * W + c0 + lc] = acc;
}

// 2 and 3: one thread per lane, a block per 8 columns x 4 index rows
constexpr int kCols = 8, kRows = 4, kLanes = kCols * kRows;

__global__ void __launch_bounds__(kLanes)
    wide_kernel(const float* __restrict__ tab, const int* __restrict__ idx,
                float* __restrict__ out, int R, int W, int S, int iters) {
  extern __shared__ float slice[];          // (R, kCols)
  const int c0 = blockIdx.y * kCols;
  const int t = threadIdx.x;
  if ((W & 3) == 0 && c0 + kCols <= W && ((size_t)tab & 15) == 0) {
    for (int k = t; k < R * 2; k += kLanes) {
      const float4 v = *reinterpret_cast<const float4*>(
          tab + (size_t)(k >> 1) * W + c0 + (k & 1) * 4);
      reinterpret_cast<float4*>(slice)[k] = v;
    }
  } else {
    for (int k = t; k < R * kCols; k += kLanes) {
      const int r = k / kCols, c = k % kCols;
      slice[k] = c0 + c < W ? tab[(size_t)r * W + c0 + c] : 0.0f;
    }
  }
  __syncthreads();
  const int c = t % kCols, s = blockIdx.x * kRows + t / kCols;
  if (s >= S || c0 + c >= W) return;
  int r = floor_mod64(idx[(size_t)s * W + c0 + c], R);
  float acc = 0.0f;
#pragma unroll 8
  for (int i = 0; i < iters; ++i) {
    acc += slice[r * kCols + c];
    r = r + 1 == R ? 0 : r + 1;
  }
  out[(size_t)s * W + c0 + c] = acc;
}

__global__ void __launch_bounds__(kLanes)
    ldg_kernel(const float* __restrict__ tab, const int* __restrict__ idx,
               float* __restrict__ out, int R, int W, int S, int iters) {
  const int t = threadIdx.x;
  const int c = blockIdx.y * kCols + t % kCols;
  const int s = blockIdx.x * kRows + t / kCols;
  if (s >= S || c >= W) return;
  int r = floor_mod64(idx[(size_t)s * W + c], R);
  float acc = 0.0f;
#pragma unroll 8
  for (int i = 0; i < iters; ++i) {
    acc += __ldg(tab + (size_t)r * W + c);
    r = r + 1 == R ? 0 : r + 1;
  }
  out[(size_t)s * W + c] = acc;
}

// 4: the package's layout, the slice split over a cluster of kQuads blocks
constexpr int kGroup = 8, kChunk = 32, kThreads = kLanes * kGroup;
constexpr int kQuads = 4;

__device__ __forceinline__ int slice_word(int r, int c) {
  return r * kCols + (c ^ ((r >> 5) & (kCols - 1)));
}

// the first word of block q's part
__device__ __forceinline__ int r_lo_of(int q, int rpr) {
  return q * rpr * kCols;
}

__global__ void __launch_bounds__(kThreads)
    cluster_kernel(const float* __restrict__ tab, const int* __restrict__ idx,
                   float* __restrict__ out, int R, int W, int S, int iters) {
  extern __shared__ float part[];           // rows [q rpr, q rpr + rpr)
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const int rpr = (R + kQuads - 1) / kQuads;
  const int c0 = blockIdx.y * kCols;
  const int t = threadIdx.x;
  const int r_lo = q * rpr, r_hi = min(R, r_lo + rpr);
  for (int k = t; k < (r_hi - r_lo) * kCols; k += kThreads) {
    const int r = r_lo + k / kCols, c = k % kCols;
    part[slice_word(r, c) - r_lo_of(q, rpr)] =
        c0 + c < W ? tab[(size_t)r * W + c0 + c] : 0.0f;
  }
  cluster.sync();
  const int lane = t / kGroup, g = t % kGroup;
  const int c = lane % kCols, s = blockIdx.x * kRows + lane / kCols;
  const bool valid = s < S && c0 + c < W;
  const int base = valid ? idx[(size_t)s * W + c0 + c] : 0;
  const int src0 = (t & 31) & ~(kGroup - 1);
  float acc = 0.0f;
  for (int i0 = 0; i0 < iters; i0 += kGroup * kChunk) {
    const int first = i0 + g * kChunk;
    const int n = min(max(iters - first, 0), kChunk);
    int r = floor_mod64((long long)base + first, R);
    int owner = r / rpr, off = r - owner * rpr;   // off: row in the part
    float v[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      // the swizzle follows the global row r (bits 5-7), as staged
      v[k] = k < n ? *cluster.map_shared_rank(
                         part + slice_word(r, c) - r_lo_of(owner, rpr), owner)
                   : 0.0f;
      r = r + 1 == R ? 0 : r + 1;
      if (r == 0) {
        owner = 0;
        off = 0;
      } else if (++off == rpr) {
        ++owner;
        off = 0;
      }
    }
    for (int h = 0; h < kGroup; ++h) {
      if (g == h) {
#pragma unroll
        for (int k = 0; k < kChunk; ++k)
          if (k < n) acc += v[k];
      }
      acc = __shfl_sync(0xffffffffu, acc, src0 + h);
    }
  }
  if (valid && g == 0) out[(size_t)s * W + c0 + c] = acc;
  cluster.sync();         // no block leaves while its rows may be read
}

// 5-7: the package's layout with G threads of C steps per lane; kIdxFirst
// loads the start row before the staging and unrolls it (the package's
// kernel is <8, 32, true>; <8, 32, false> is its first cut)
template <int G, int C, bool kIdxFirst>
__global__ void __launch_bounds__(kLanes * G)
    group_kernel(const float* __restrict__ tab, const int* __restrict__ idx,
                 float* __restrict__ out, int R, int W, int S, int iters) {
  constexpr int kT = kLanes * G;
  extern __shared__ float gslice[];
  const int c0 = blockIdx.y * kCols;
  const int t = threadIdx.x;
  const int lane = t / G, g = t % G;
  const int c = lane % kCols, s = blockIdx.x * kRows + lane / kCols;
  const bool valid = s < S && c0 + c < W;
  int base = 0;
  if (kIdxFirst) base = valid ? idx[(size_t)s * W + c0 + c] : 0;
  auto word = [](int r, int cc) { return r * kCols + (cc ^ ((r / C) & 7)); };
  if ((W & 3) == 0 && c0 + kCols <= W && ((size_t)tab & 15) == 0) {
#pragma unroll 4
    for (int k = t; k < R * 2; k += kT) {
      const int r = k >> 1, h = (k & 1) * 4;
      const float4 v =
          *reinterpret_cast<const float4*>(tab + (size_t)r * W + c0 + h);
      gslice[word(r, h)] = v.x;
      gslice[word(r, h + 1)] = v.y;
      gslice[word(r, h + 2)] = v.z;
      gslice[word(r, h + 3)] = v.w;
    }
  } else {
    for (int k = t; k < R * kCols; k += kT) {
      const int r = k / kCols, cc = k % kCols;
      gslice[word(r, cc)] = c0 + cc < W ? tab[(size_t)r * W + c0 + cc] : 0.0f;
    }
  }
  __syncthreads();
  if (!kIdxFirst) base = valid ? idx[(size_t)s * W + c0 + c] : 0;
  const int src0 = (t & 31) & ~(G - 1);
  float acc = 0.0f;
  for (int i0 = 0; i0 < iters; i0 += G * C) {
    const int first = i0 + g * C;
    const int n = min(max(iters - first, 0), C);
    int r = floor_mod64((long long)base + first, R);
    float v[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      v[k] = k < n ? gslice[word(r, c)] : 0.0f;
      r = r + 1 == R ? 0 : r + 1;
    }
    for (int h = 0; h < G; ++h) {
      if (g == h) {
#pragma unroll
        for (int k = 0; k < C; ++k)
          if (k < n) acc += v[k];
      }
      acc = __shfl_sync(0xffffffffu, acc, src0 + h);
    }
  }
  if (valid && g == 0) out[(size_t)s * W + c0 + c] = acc;
}

template <int G, int C, bool kIdxFirst>
int group_run(const float* tb, const int* ix, float* o, int R, int W, int S,
              int iters, cudaStream_t st) {
  const size_t bytes = (size_t)R * kCols * sizeof(float);
  if (bytes > 232448) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      group_kernel<G, C, kIdxFirst>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 blocks((S + kRows - 1) / kRows, (W + kCols - 1) / kCols);
  group_kernel<G, C, kIdxFirst><<<blocks, kLanes * G, bytes, st>>>(
      tb, ix, o, R, W, S, iters);
  return (int)cudaGetLastError();
}

}  // namespace k9v

extern "C" int k9_variant_launch(int variant, const void* tab,
                                 const void* idx, void* out, int R, int W,
                                 int S, int iters, void* stream) {
  using namespace k9v;
  if (R <= 0 || W <= 0 || S <= 0 || iters < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* tb = (const float*)tab;
  const int* ix = (const int*)idx;
  float* o = (float*)out;
  cudaError_t err = cudaSuccess;
  if (variant == 0 || variant == 1) {
    const size_t bytes = (size_t)R * kOldCols * sizeof(float);
    if (bytes > 232448) return (int)cudaErrorInvalidValue;
    auto kern = variant == 0 ? old_kernel<false> : old_kernel<true>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 blocks((W + kOldCols - 1) / kOldCols,
                      (S + kOldRows - 1) / kOldRows);
    kern<<<blocks, dim3(kOldCols, kOldRows), bytes, st>>>(tb, ix, o, R, W, S,
                                                           iters);
    return (int)cudaGetLastError();
  }
  const dim3 blocks((S + kRows - 1) / kRows, (W + kCols - 1) / kCols);
  if (variant == 2) {
    const size_t bytes = (size_t)R * kCols * sizeof(float);
    if (bytes > 232448) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(
        wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    wide_kernel<<<blocks, kLanes, bytes, st>>>(tb, ix, o, R, W, S, iters);
    return (int)cudaGetLastError();
  }
  if (variant == 3) {
    ldg_kernel<<<blocks, kLanes, 0, st>>>(tb, ix, o, R, W, S, iters);
    return (int)cudaGetLastError();
  }
  if (variant == 4) {
    const int rpr = (R + kQuads - 1) / kQuads;
    const size_t bytes = (size_t)rpr * kCols * sizeof(float);
    if (bytes > 232448) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(
        cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((blocks.x + kQuads - 1) / kQuads * kQuads, blocks.y);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kQuads;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, cluster_kernel, tb, ix, o, R, W, S, iters);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  if (variant == 5)
    return group_run<8, 32, false>(tb, ix, o, R, W, S, iters, st);
  if (variant == 6)
    return group_run<4, 64, true>(tb, ix, o, R, W, S, iters, st);
  if (variant == 7)
    return group_run<16, 16, true>(tb, ix, o, R, W, S, iters, st);
  return (int)cudaErrorInvalidValue;
}
