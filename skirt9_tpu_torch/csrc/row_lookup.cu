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
// operations and latency: the gather by 2.1 M shared-memory loads and each
// lane's 256 in-order adds (about 1,000 cycles, the only serial part), the
// select loop by 1.07e9 compare-selects.
//
// Gather design: a block covers 8 columns (one 32-byte sector of a table
// row) and 4 index rows, and stages tab[:, c0:c0+8] (R x 8 floats, 16 KB at
// R = 512) with 16-byte loads where the rows allow; at the probe's shapes
// that is 256 blocks on 132 SMs and 4 MB staged in all. Each lane's chain
// is split over a group of kGroup = 8 threads: thread g loads its stretch
// of kChunk = 32 steps into registers (independent loads, all in flight,
// the row formed once by floor_mod and then stepped with a wrap-around
// increment), and the running sum passes down the group by __shfl_sync:
// thread g adds its values in step order to what thread g - 1 handed on,
// so the sum is the plain version's, bit for bit. Longer chains take
// several rounds of kGroup * kChunk steps. The slice is XOR-swizzled by
// bits 5-7 of the row, so that the 8 threads of a lane, whose rows lie 32
// apart, read 8 distinct banks. The dynamic shared-memory limit is set
// once per process and device. Of the designs timed beside it on the H100
// (perf/kernel9_variants.py), one thread per lane over the same 256 blocks
// came closest; a slice shared by a cluster through distributed shared
// memory was the slowest.
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

#include <mutex>

namespace skirt9 {

constexpr int kCols = 8;        // gather: columns per block (one sector)
constexpr int kRowsS = 4;       // gather: index rows per block
constexpr int kGroup = 8;       // gather: threads per lane
constexpr int kChunk = 32;      // gather: steps per thread and round
constexpr int kGatherThreads = kCols * kRowsS * kGroup;
constexpr int kSelRows = 64;    // select: rows a thread holds in registers
constexpr int kSelThreads = 256;
constexpr int kSelSteps = 4;    // select: chain steps in flight
constexpr int kMaxSmem = 232448;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ int floor_mod(long long a, int r) {
  const int m = (int)(a % r);
  return m < 0 ? m + r : m;
}

// the word of (row r, column c < kCols) in a staged slice
__device__ __forceinline__ int slice_word(int r, int c) {
  return r * kCols + (c ^ ((r >> 5) & (kCols - 1)));
}

__global__ void __launch_bounds__(kGatherThreads)
    row_gather_kernel(const float* __restrict__ tab,
                      const int* __restrict__ idx, float* __restrict__ out,
                      int R, int W, int S, int iters) {
  extern __shared__ float slice[];          // (R, kCols), swizzled
  const int c0 = blockIdx.y * kCols;
  const int t = threadIdx.x;
  const int lane = t / kGroup, g = t % kGroup;
  const int c = lane % kCols, s = blockIdx.x * kRowsS + lane / kCols;
  // a lane past the edge runs a chain on row 0 (every thread of the warp
  // takes part in the shuffles) and writes nothing; its start row is
  // loaded before the staging, so that the two loads overlap
  const bool valid = s < S && c0 + c < W;
  const int base = valid ? idx[(size_t)s * W + c0 + c] : 0;
  if ((W & 3) == 0 && c0 + kCols <= W &&
      ((size_t)tab & 15) == 0) {            // two float4 per row
#pragma unroll 4
    for (int k = t; k < R * 2; k += kGatherThreads) {
      const int r = k >> 1, h = (k & 1) * 4;
      const float4 v =
          *reinterpret_cast<const float4*>(tab + (size_t)r * W + c0 + h);
      slice[slice_word(r, h)] = v.x;
      slice[slice_word(r, h + 1)] = v.y;
      slice[slice_word(r, h + 2)] = v.z;
      slice[slice_word(r, h + 3)] = v.w;
    }
  } else {
#pragma unroll 4
    for (int k = t; k < R * kCols; k += kGatherThreads) {
      const int r = k / kCols, cc = k % kCols;
      slice[slice_word(r, cc)] =
          c0 + cc < W ? tab[(size_t)r * W + c0 + cc] : 0.0f;
    }
  }
  __syncthreads();
  const int src0 = (t & 31) & ~(kGroup - 1);      // the group's first lane
  float acc = 0.0f;
  for (int i0 = 0; i0 < iters; i0 += kGroup * kChunk) {
    const int first = i0 + g * kChunk;
    const int n = min(max(iters - first, 0), kChunk);
    int r = floor_mod((long long)base + first, R);
    float v[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      v[k] = k < n ? slice[slice_word(r, c)] : 0.0f;
      r = r + 1 == R ? 0 : r + 1;
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

// the gather's shared-memory limit, raised once per process and device
int gather_setup() {
  static std::once_flag once[kMaxDevices];
  static cudaError_t err[kMaxDevices];
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  std::call_once(once[dev], [dev] {
    err[dev] = cudaFuncSetAttribute(
        row_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
  });
  return (int)err[dev];
}

int row_gather_run(const void* tab, const void* idx, void* out, int R, int W,
                   int S, int iters, cudaStream_t stream) {
  const size_t bytes = (size_t)R * kCols * sizeof(float);
  if (bytes > (size_t)kMaxSmem || (W + kCols - 1) / kCols > 65535)
    return (int)cudaErrorInvalidValue;
  const int err = gather_setup();
  if (err != 0) return err;
  const dim3 blocks((S + kRowsS - 1) / kRowsS, (W + kCols - 1) / kCols);
  row_gather_kernel<<<blocks, kGatherThreads, bytes, stream>>>(
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
