// Variants of kernel 7 (skirt9_tpu_torch/csrc/sweepxl_deposit.cu) that the
// package does not ship, timed against it by perf/kernel7_variants.py; no
// simulation path launches them.
//
// `warp_sums_launch`: kernel 7 in both modes in its f32 design (one RF
// row, float atomics), with the deposits of every warp summed per warp by
// cell (as sweep_common.cuh `warp_add` does for kernel 2, here on 64-bit
// keys and a 1-D block) before the atomic, in place of one atomicAdd per
// nonzero contribution.
//
// `atomics_launch`: kernel 7 in both modes in its f32 design, one float
// atomicAdd per nonzero contribution everywhere (the package adds f64).
//
// Both take the package's arguments without the bin map, the cell map and
// the row count, and give the same outputs (the RF to float rounding).
//
// `split_launch`: kernel 7's f32 prefix mode with an RF, one part taken out
// at a time (pass A alone, plain atomics):
//   0 full           pass A in the f32 design;
//   1 no_atomics     each contribution added into a register instead of
//                    the RF, one store per thread at the end;
//   2 no_record      the record not read (every sub-step's optical depth
//                    0): the deposits' sub-DDA and atomics without it;
//   3 search_lane    the hit search and the lane set-up with its slab
//                    range, no sub-DDA and no deposit;
//   4 resolve        pass B alone, on the package's last hit slabs.
// Variants 1-3 write wrong values on purpose; only their times are read.
//
// `old_launch`: the first design of kernel 7, as the package had it before
// its redesign: one thread per (slab, lane), index t * B + lane, each
// thread loading its lane, reading its slab's scale from the (nmax, B)
// table and adding every nonzero contribution straight into the RF. Mode 0
// only; its RF equals the package kernel's mode 0 to float rounding.
#include "sweepxl_deposit.cu"

namespace skirt9 {

__global__ void old_deposit_kernel(
    GridGeom g, const float* __restrict__ pos, const float* __restrict__ dir,
    const int* __restrict__ axis, const float* __restrict__ smin,
    const float* __restrict__ smax, const float* __restrict__ dsub,
    const float* __restrict__ scale, float* __restrict__ rf, int B, int nmax,
    int n_groups) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)nmax * B) return;
  const int t = (int)(idx / B);
  const int lane = (int)(idx - (long long)t * B);
  const float sc = scale[idx];
  if (sc == 0.0f) return;
  const Lane L = load_lane(g, pos, dir, axis, smin, smax, nullptr, 0, B, lane);
  if (t >= L.na) return;
  Slab S = enter_slab(L, t);
  if (!S.act) return;
  const long long ncells = (long long)g.nx * g.ny * g.nz;
  float* rf_row = rf + (long long)(lane / (B / n_groups)) * ncells;
  const float* d = dsub + (long long)t * 3 * B + lane;
  float tau_loc = 0.0f;
  for (int j = 0; j < 3; ++j) {
    float ds;
    int cell;
    sub_step(L, t, S, ds, cell);
    const float dtau = d[(long long)j * B];
    const float contrib = sc * expf(-tau_loc) * ds * segment_factor(dtau);
    if (contrib != 0.0f) atomicAdd(rf_row + cell, contrib);
    tau_loc = tau_loc + dtau;
  }
}

// warp_add on a 64-bit key, for a 1-D block: threadIdx.x % 32 is the
// thread's lane in its warp.
template <typename Add>
__device__ inline void warp_add64(long long key, float v, float* scratch,
                                  Add add) {
  if (__ballot_sync(kFull, key >= 0) == 0) return;
  const unsigned peers = __match_any_sync(kFull, key);
  const int x = threadIdx.x & (kTile - 1);
  scratch[x] = v;
  __syncwarp();
  if (key >= 0 && x == __ffs(peers) - 1) {
    float sum = 0.0f;
    for (unsigned m = peers; m != 0; m &= m - 1) sum += scratch[__ffs(m) - 1];
    add(key, sum);
  }
  __syncwarp();
}

// The f32 design's pass A with warp sums: every
// thread of a warp walks its run's slabs to reach warp_add64, threads past
// the last (run, lane) pair included.
template <int kMode>
__global__ void __launch_bounds__(kXlDepThreads) warp_deposit_kernel(
    GridGeom g, const float* __restrict__ pos, const float* __restrict__ dir,
    const int* __restrict__ axis, const float* __restrict__ smin,
    const float* __restrict__ smax, const float* __restrict__ dsub,
    const float* __restrict__ slab, const float* __restrict__ lum,
    const float* __restrict__ tau_int, float inv_sqrt,
    float* __restrict__ rf, int* __restrict__ hitrun, int B, int nmax,
    int run, int n_groups) {
  __shared__ float scratch[kXlDepThreads / kTile][kTile];
  const long long idx = (long long)blockIdx.x * kXlDepThreads + threadIdx.x;
  const int runs = (nmax + run - 1) / run;
  const bool live = idx < (long long)runs * B;
  const int q = live ? (int)(idx / B) : 0;
  const int lane = live ? (int)(idx - (long long)q * B) : 0;
  const int ra = q * run;
  const long long ncells = (long long)g.nx * g.ny * g.nz;
  const float inf = __int_as_float(0x7f800000);
  if (kMode == kXlDepPrefix && live) {
    const float ti = tau_int[lane];
    const bool up = dir[3 * lane + axis[lane]] > 0.0f;
    float prev = ra > 0 ? slab[(size_t)(ra - 1) * B + lane] : inf;
    float cur = slab[(size_t)ra * B + lane];
    int first = nmax;
    const int rb = min(ra + run, nmax);
    for (int c = ra; c < rb && first == nmax; c += kHitChunk) {
      float next[kHitChunk];
#pragma unroll
      for (int i = 0; i < kHitChunk; ++i) {
        const int t = c + i + 1;
        next[i] = t < nmax && t <= rb ? slab[(size_t)t * B + lane] : inf;
      }
#pragma unroll
      for (int i = 0; i < kHitChunk; ++i) {
        const int t = c + i;
        if (t < rb && first == nmax) {
          if (ti - cur >= 0.0f && ti < (up ? next[i] : prev)) first = t;
          prev = cur;
          cur = next[i];
        }
      }
    }
    hitrun[(size_t)q * B + lane] = first;
  }
  const float lm =
      kMode == kXlDepPrefix && live && lum != nullptr ? lum[lane] : 0.0f;
  const bool dep =
      live && (kMode == kXlDepTables || (rf != nullptr && lm != 0.0f));
  Lane L;
  int t0 = 0, t1 = -1;
  long long row = 0;
  if (dep) {
    L = load_lane(g, pos, dir, axis, smin, smax, nullptr, 0, B, lane);
    slab_range(L, t0, t1);
    if (kMode == kXlDepTables)
      row = (long long)(lane / (B / n_groups)) * ncells;
  }
  float* rf_add = rf;
  const auto add = [rf_add](long long key, float v) {
    atomicAdd(rf_add + key, v);
  };
  for (int t = ra; t <= ra + run - 1; ++t) {
    long long key[3] = {-1, -1, -1};
    float val[3] = {0.0f, 0.0f, 0.0f};
    if (dep && t < nmax && t >= t0 && t <= t1) {
      const float tb = slab[(size_t)t * B + lane];
      const float sc =
          kMode == kXlDepPrefix ? (lm * expf(-tb)) * inv_sqrt : tb;
      Slab S = enter_slab(L, t);
      if (sc != 0.0f && S.act) {
        const float* d = dsub + (size_t)t * 3 * B + lane;
        float tau_loc = 0.0f;
        for (int j = 0; j < 3; ++j) {
          float ds;
          int cell;
          sub_step(L, t, S, ds, cell);
          const float dtau = d[(size_t)j * B];
          const float contrib =
              sc * expf(-tau_loc) * ds * segment_factor(dtau);
          if (contrib != 0.0f) {
            key[j] = row + cell;
            val[j] = contrib;
          }
          tau_loc = tau_loc + dtau;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j)
      warp_add64(key[j], val[j], scratch[threadIdx.x / kTile], add);
  }
}

// The f32 design's pass A, one float atomic per nonzero
// contribution, no warp sums: each (run, lane) thread returns as soon as
// it has nothing to deposit.
template <int kMode>
__global__ void __launch_bounds__(kXlDepThreads) atomics_deposit_kernel(
    GridGeom g, const float* __restrict__ pos, const float* __restrict__ dir,
    const int* __restrict__ axis, const float* __restrict__ smin,
    const float* __restrict__ smax, const float* __restrict__ dsub,
    const float* __restrict__ slab, const float* __restrict__ lum,
    const float* __restrict__ tau_int, float inv_sqrt,
    float* __restrict__ rf, int* __restrict__ hitrun, int B, int nmax,
    int run, int n_groups) {
  const long long idx = (long long)blockIdx.x * kXlDepThreads + threadIdx.x;
  const int runs = (nmax + run - 1) / run;
  if (idx >= (long long)runs * B) return;
  const int q = (int)(idx / B);
  const int lane = (int)(idx - (long long)q * B);
  const int ra = q * run;
  const float inf = __int_as_float(0x7f800000);
  if (kMode == kXlDepPrefix) {
    const float ti = tau_int[lane];
    const bool up = dir[3 * lane + axis[lane]] > 0.0f;
    float prev = ra > 0 ? slab[(size_t)(ra - 1) * B + lane] : inf;
    float cur = slab[(size_t)ra * B + lane];
    int first = nmax;
    const int rb = min(ra + run, nmax);
    for (int c = ra; c < rb && first == nmax; c += kHitChunk) {
      float next[kHitChunk];
#pragma unroll
      for (int i = 0; i < kHitChunk; ++i) {
        const int t = c + i + 1;
        next[i] = t < nmax && t <= rb ? slab[(size_t)t * B + lane] : inf;
      }
#pragma unroll
      for (int i = 0; i < kHitChunk; ++i) {
        const int t = c + i;
        if (t < rb && first == nmax) {
          if (ti - cur >= 0.0f && ti < (up ? next[i] : prev)) first = t;
          prev = cur;
          cur = next[i];
        }
      }
    }
    hitrun[(size_t)q * B + lane] = first;
  }
  float lm = 0.0f;
  if (kMode == kXlDepPrefix) {
    if (rf == nullptr) return;
    lm = lum[lane];
    if (lm == 0.0f) return;
  }
  const Lane L = load_lane(g, pos, dir, axis, smin, smax, nullptr, 0, B, lane);
  int t0, t1;
  slab_range(L, t0, t1);
  float* rf_row = rf;
  if (kMode == kXlDepTables)
    rf_row += (long long)(lane / (B / n_groups)) * g.nx * g.ny * g.nz;
  const int hi = min(ra + run - 1, t1);
  for (int t = max(ra, t0); t <= hi; ++t) {
    const float tb = slab[(size_t)t * B + lane];
    const float sc = kMode == kXlDepPrefix ? (lm * expf(-tb)) * inv_sqrt : tb;
    Slab S = enter_slab(L, t);
    if (sc == 0.0f || !S.act) continue;
    const float* d = dsub + (size_t)t * 3 * B + lane;
    float tau_loc = 0.0f;
    for (int j = 0; j < 3; ++j) {
      float ds;
      int cell;
      sub_step(L, t, S, ds, cell);
      const float dtau = d[(size_t)j * B];
      const float contrib = sc * expf(-tau_loc) * ds * segment_factor(dtau);
      if (contrib != 0.0f) atomicAdd(rf_row + cell, contrib);
      tau_loc = tau_loc + dtau;
    }
  }
}

enum : int { kFullS = 0, kNoAtomicsS = 1, kNoRecordS = 2, kSearchLaneS = 3 };

template <int V>
__global__ void __launch_bounds__(kXlDepThreads) split_kernel(
    GridGeom g, const float* __restrict__ pos, const float* __restrict__ dir,
    const int* __restrict__ axis, const float* __restrict__ smin,
    const float* __restrict__ smax, const float* __restrict__ dsub,
    const float* __restrict__ slab, const float* __restrict__ lum,
    const float* __restrict__ tau_int, float inv_sqrt,
    float* __restrict__ rf, int* __restrict__ hitrun, int B, int nmax,
    int run) {
  const long long idx = (long long)blockIdx.x * kXlDepThreads + threadIdx.x;
  const int runs = (nmax + run - 1) / run;
  if (idx >= (long long)runs * B) return;
  const int q = (int)(idx / B);
  const int lane = (int)(idx - (long long)q * B);
  const int ra = q * run;
  const float inf = __int_as_float(0x7f800000);
  {
    const float ti = tau_int[lane];
    const bool up = dir[3 * lane + axis[lane]] > 0.0f;
    float prev = ra > 0 ? slab[(size_t)(ra - 1) * B + lane] : inf;
    float cur = slab[(size_t)ra * B + lane];
    int first = nmax;
    const int rb = min(ra + run, nmax);
    for (int c = ra; c < rb && first == nmax; c += kHitChunk) {
      float next[kHitChunk];
#pragma unroll
      for (int i = 0; i < kHitChunk; ++i) {
        const int t = c + i + 1;
        next[i] = t < nmax && t <= rb ? slab[(size_t)t * B + lane] : inf;
      }
#pragma unroll
      for (int i = 0; i < kHitChunk; ++i) {
        const int t = c + i;
        if (t < rb && first == nmax) {
          if (ti - cur >= 0.0f && ti < (up ? next[i] : prev)) first = t;
          prev = cur;
          cur = next[i];
        }
      }
    }
    hitrun[(size_t)q * B + lane] = first;
  }
  const float lm = lum[lane];
  if (lm == 0.0f) return;
  const Lane L = load_lane(g, pos, dir, axis, smin, smax, nullptr, 0, B, lane);
  int t0, t1;
  slab_range(L, t0, t1);
  if (V == kSearchLaneS) {
    if (t0 > t1 + 1000) rf[lane] = L.smin;  // keeps the set-up
    return;
  }
  float acc = 0.0f;
  const int lo = max(ra, t0), hi = min(ra + run - 1, t1);
  for (int t = lo; t <= hi; ++t) {
    const float sc = (lm * expf(-slab[(size_t)t * B + lane])) * inv_sqrt;
    Slab S = enter_slab(L, t);
    if (sc != 0.0f && S.act) {
      const float* d = dsub + (size_t)t * 3 * B + lane;
      float tau_loc = 0.0f;
      for (int j = 0; j < 3; ++j) {
        float ds;
        int cell;
        sub_step(L, t, S, ds, cell);
        const float dtau = V == kNoRecordS ? 0.0f : d[(size_t)j * B];
        const float contrib =
            sc * expf(-tau_loc) * ds * segment_factor(dtau);
        if (contrib != 0.0f) {
          if (V == kNoAtomicsS) {
            acc = acc + contrib;
          } else {
            atomicAdd(rf + cell, contrib);
          }
        }
        tau_loc = tau_loc + dtau;
      }
    }
  }
  if (V == kNoAtomicsS) rf[idx % B] = acc;
}

}  // namespace skirt9

extern "C" int warp_sums_launch(
    const void* pos, const void* dir, const void* axis, const void* smin,
    const void* smax, const void* dsub, const void* slab, const void* lum,
    const void* tau_int, const void* active, void* rf, void* hitrun,
    void* s_int, void* icell, void* found, int B, int nx, int ny, int nz,
    int nmax, int n_groups, int run, int mode, float lox, float loy,
    float loz, float hx, float hy, float hz, float inv_sqrt, void* stream) {
  using namespace skirt9;
  const bool tables = mode == kXlDepTables && rf != nullptr && n_groups >= 1 &&
                      B % n_groups == 0;
  const bool prefix = mode == kXlDepPrefix && tau_int != nullptr &&
                      active != nullptr && hitrun != nullptr &&
                      s_int != nullptr && icell != nullptr &&
                      found != nullptr && (rf == nullptr) == (lum == nullptr);
  if (B <= 0 || nmax < 1 || run < 1 || slab == nullptr || (!tables && !prefix))
    return (int)cudaErrorInvalidValue;
  GridGeom g{nx, ny, nz, {lox, loy, loz}, {hx, hy, hz}};
  cudaStream_t s = (cudaStream_t)stream;
  const int runs = (nmax + run - 1) / run;
  const unsigned blocks = (unsigned)(((long long)runs * B + kXlDepThreads - 1) /
                                     kXlDepThreads);
  const auto pass_a = [&](auto kernel) {
    kernel<<<blocks, kXlDepThreads, 0, s>>>(
        g, (const float*)pos, (const float*)dir, (const int*)axis,
        (const float*)smin, (const float*)smax, (const float*)dsub,
        (const float*)slab, (const float*)lum, (const float*)tau_int,
        inv_sqrt, (float*)rf, (int*)hitrun, B, nmax, run, n_groups);
  };
  if (tables) {
    pass_a(warp_deposit_kernel<kXlDepTables>);
    return (int)cudaGetLastError();
  }
  pass_a(warp_deposit_kernel<kXlDepPrefix>);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sweepxl_resolve_kernel<<<(unsigned)((B + kXlDepThreads - 1) / kXlDepThreads),
                           kXlDepThreads, 0, s>>>(
      g, (const float*)pos, (const float*)dir, (const int*)axis,
      (const float*)smin, (const float*)smax, (const float*)dsub,
      (const float*)slab, (const float*)tau_int,
      (const unsigned char*)active, (const int*)hitrun, runs, (float*)s_int,
      (long long*)icell, (unsigned char*)found, B, nmax);
  return (int)cudaGetLastError();
}

extern "C" int atomics_launch(
    const void* pos, const void* dir, const void* axis, const void* smin,
    const void* smax, const void* dsub, const void* slab, const void* lum,
    const void* tau_int, const void* active, void* rf, void* hitrun,
    void* s_int, void* icell, void* found, int B, int nx, int ny, int nz,
    int nmax, int n_groups, int run, int mode, float lox, float loy,
    float loz, float hx, float hy, float hz, float inv_sqrt, void* stream) {
  using namespace skirt9;
  const bool tables = mode == kXlDepTables && rf != nullptr && n_groups >= 1 &&
                      B % n_groups == 0;
  const bool prefix = mode == kXlDepPrefix && tau_int != nullptr &&
                      active != nullptr && hitrun != nullptr &&
                      s_int != nullptr && icell != nullptr &&
                      found != nullptr && (rf == nullptr) == (lum == nullptr);
  if (B <= 0 || nmax < 1 || run < 1 || slab == nullptr || (!tables && !prefix))
    return (int)cudaErrorInvalidValue;
  GridGeom g{nx, ny, nz, {lox, loy, loz}, {hx, hy, hz}};
  cudaStream_t s = (cudaStream_t)stream;
  const int runs = (nmax + run - 1) / run;
  const unsigned blocks = (unsigned)(((long long)runs * B + kXlDepThreads - 1) /
                                     kXlDepThreads);
  const auto pass_a = [&](auto kernel) {
    kernel<<<blocks, kXlDepThreads, 0, s>>>(
        g, (const float*)pos, (const float*)dir, (const int*)axis,
        (const float*)smin, (const float*)smax, (const float*)dsub,
        (const float*)slab, (const float*)lum, (const float*)tau_int,
        inv_sqrt, (float*)rf, (int*)hitrun, B, nmax, run, n_groups);
  };
  if (tables) {
    pass_a(atomics_deposit_kernel<kXlDepTables>);
    return (int)cudaGetLastError();
  }
  pass_a(atomics_deposit_kernel<kXlDepPrefix>);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sweepxl_resolve_kernel<<<(unsigned)((B + kXlDepThreads - 1) / kXlDepThreads),
                           kXlDepThreads, 0, s>>>(
      g, (const float*)pos, (const float*)dir, (const int*)axis,
      (const float*)smin, (const float*)smax, (const float*)dsub,
      (const float*)slab, (const float*)tau_int,
      (const unsigned char*)active, (const int*)hitrun, runs, (float*)s_int,
      (long long*)icell, (unsigned char*)found, B, nmax);
  return (int)cudaGetLastError();
}

extern "C" int old_launch(const void* pos, const void* dir, const void* axis,
                          const void* smin, const void* smax,
                          const void* dsub, const void* scale, void* rf,
                          int B, int nx, int ny, int nz, int nmax,
                          int n_groups, float lox, float loy, float loz,
                          float hx, float hy, float hz, void* stream) {
  if (B <= 0 || n_groups < 1 || B % n_groups != 0)
    return (int)cudaErrorInvalidValue;
  skirt9::GridGeom g{nx, ny, nz, {lox, loy, loz}, {hx, hy, hz}};
  const long long total = (long long)nmax * B;
  skirt9::old_deposit_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                               (cudaStream_t)stream>>>(
      g, (const float*)pos, (const float*)dir, (const int*)axis,
      (const float*)smin, (const float*)smax, (const float*)dsub,
      (const float*)scale, (float*)rf, B, nmax, n_groups);
  return (int)cudaGetLastError();
}

extern "C" int split_launch(int variant, const void* pos, const void* dir,
                            const void* axis, const void* smin,
                            const void* smax, const void* dsub,
                            const void* tb, const void* lum,
                            const void* tau_int, const void* active, void* rf,
                            void* hitrun, void* s_int, void* icell,
                            void* found, int B, int nx, int ny, int nz,
                            int nmax, int run, float lox, float loy,
                            float loz, float hx, float hy, float hz,
                            float inv_sqrt, void* stream) {
  using namespace skirt9;
  if (B <= 0 || run < 1 || variant < kFullS || variant > 4)
    return (int)cudaErrorInvalidValue;
  GridGeom g{nx, ny, nz, {lox, loy, loz}, {hx, hy, hz}};
  cudaStream_t s = (cudaStream_t)stream;
  const int runs = (nmax + run - 1) / run;
  const long long threads = (long long)runs * B;
  const unsigned blocks =
      (unsigned)((threads + kXlDepThreads - 1) / kXlDepThreads);
  const float* f[7] = {(const float*)pos, (const float*)dir,
                       (const float*)smin, (const float*)smax,
                       (const float*)dsub, (const float*)tb,
                       (const float*)lum};
  const int* ax = (const int*)axis;
  switch (variant) {
    case kFullS:
      split_kernel<kFullS><<<blocks, kXlDepThreads, 0, s>>>(
          g, f[0], f[1], ax, f[2], f[3], f[4], f[5], f[6],
          (const float*)tau_int, inv_sqrt, (float*)rf, (int*)hitrun, B,
          nmax, run);
      break;
    case kNoAtomicsS:
      split_kernel<kNoAtomicsS><<<blocks, kXlDepThreads, 0, s>>>(
          g, f[0], f[1], ax, f[2], f[3], f[4], f[5], f[6],
          (const float*)tau_int, inv_sqrt, (float*)rf, (int*)hitrun, B,
          nmax, run);
      break;
    case kNoRecordS:
      split_kernel<kNoRecordS><<<blocks, kXlDepThreads, 0, s>>>(
          g, f[0], f[1], ax, f[2], f[3], f[4], f[5], f[6],
          (const float*)tau_int, inv_sqrt, (float*)rf, (int*)hitrun, B,
          nmax, run);
      break;
    case kSearchLaneS:
      split_kernel<kSearchLaneS><<<blocks, kXlDepThreads, 0, s>>>(
          g, f[0], f[1], ax, f[2], f[3], f[4], f[5], f[6],
          (const float*)tau_int, inv_sqrt, (float*)rf, (int*)hitrun, B,
          nmax, run);
      break;
    default:
      sweepxl_resolve_kernel<<<(unsigned)((B + kXlDepThreads - 1) /
                                          kXlDepThreads),
                               kXlDepThreads, 0, s>>>(
          g, f[0], f[1], ax, f[2], f[3], f[4], f[5], (const float*)tau_int,
          (const unsigned char*)active, (const int*)hitrun, runs,
          (float*)s_int, (long long*)icell, (unsigned char*)found, B, nmax);
  }
  return (int)cudaGetLastError();
}
