// Variants of kernel 6 (skirt9_tpu_torch/csrc/sweepxl_dtau.cu), built only
// to be timed against it by perf/kernel6_variants.py; no simulation path
// launches them.
//
// `old_launch`: the first design of kernel 6 (one thread per (slab, lane),
// the lane's inputs read and set up by every thread, as in the package
// before its redesign), writing the want_sub record, with one part taken
// out at a time:
//   0 full           the kernel as it was;
//   1 lane_once      the same threads and order, but a thread takes `run`
//                    consecutive slabs of its lane (thread index q * B +
//                    lane for the run q), so the lane is read and set up
//                    once per run and held in registers;
//   2 no_gathers     the full march with sig instead of the density: no
//                    table reads;
//   3 lane_stores    each thread reads and sets up its lane and stores a
//                    value made from it, no march;
//   4 stores_only    each thread stores zeros.
// Variants 2-4 write wrong values on purpose; only their times are read.
//
// `block_launch`: the design that the redesign first took, kept for its
// times: a block of 32 lanes x `warps` warps, each warp a run of
// consecutive slabs of the same 32 lanes, the lane set-up once per thread,
// the total and the prefix formed through shared memory inside the block.
// All four modes; outputs equal to the package kernel's (the total and the
// prefix to float rounding).
//
// `tile_launch`: the record mode after kernel 1's lane tile
// (csrc/sweep_dtau.cu): a block of 32 lanes x 8 warps, one warp sets the
// lanes up into shared memory with their slab ranges, the block's threads
// take the (lane, slab) items in turn into a shared (nmax, 3, 32) tile, which
// leaves row by row. Its record equals the package kernel's.
#include "sweep_common.cuh"

namespace skirt9 {

enum : int { kFullV = 0, kLaneOnceV = 1, kNoGatherV = 2, kLaneStoresV = 3,
             kStoresOnlyV = 4 };

template <int V>
__global__ void old_kernel(GridGeom g, const float* __restrict__ pos,
                           const float* __restrict__ dir,
                           const int* __restrict__ axis,
                           const float* __restrict__ smin,
                           const float* __restrict__ smax,
                           const float* __restrict__ sig,
                           const float* __restrict__ nd,
                           float* __restrict__ out, int B, int C, int nmax,
                           int run) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int per = V == kLaneOnceV ? run : 1;
  const long long nr = (nmax + per - 1) / per;
  if (idx >= nr * B) return;
  const int q = (int)(idx / B);
  const int lane = (int)(idx - (long long)q * B);
  const int ta = q * per, te = min(ta + per, nmax);
  float* o = out + lane;
  if (V == kStoresOnlyV) {
    for (int t = ta; t < te; ++t) {
      o[(size_t)t * 3 * B] = 0.0f;
      o[(size_t)t * 3 * B + B] = 0.0f;
      o[(size_t)t * 3 * B + 2 * (size_t)B] = 0.0f;
    }
    return;
  }
  const Lane L = load_lane(g, pos, dir, axis, smin, smax, sig, C, B, lane);
  for (int t = ta; t < te; ++t) {
    float d[3] = {0.0f, 0.0f, 0.0f};
    if (V == kLaneStoresV) {
      d[0] = (L.pa + L.pu + L.pv) * 0.0f;
      d[1] = (L.da + L.du + L.dv + L.smin + L.smax) * 0.0f;
      d[2] = L.sig[0] * 0.0f;
    } else if (t < L.na) {
      Slab S = enter_slab(L, t);
      if (S.act) {
        for (int j = 0; j < 3; ++j) {
          float ds;
          int cell;
          sub_step(L, t, S, ds, cell);
          d[j] = (V == kNoGatherV ? L.sig[0] : opacity(L, nd, cell, C)) * ds;
        }
      }
    }
    o[(size_t)t * 3 * B] = d[0];
    o[(size_t)t * 3 * B + B] = d[1];
    o[(size_t)t * 3 * B + 2 * (size_t)B] = d[2];
  }
}

enum : int { kBlockSummed = 0, kBlockSub = 1, kBlockTotal = 2,
             kBlockPrefix = 3 };

// The lane-block design: a block takes 32 lanes and all their slabs, one
// warp per run of `run` consecutive slabs; modes and outputs as the
// package kernel's.
__global__ void __launch_bounds__(kTile* 32)
    block_kernel(GridGeom g, float ihx, float ihy, float ihz,
                 const float* __restrict__ pos, const float* __restrict__ dir,
                 const unsigned char* __restrict__ active,
                 const float* __restrict__ sig, const float* __restrict__ nd,
                 int hint, int mode, int run, float* __restrict__ out,
                 float* __restrict__ prefix, float* __restrict__ total,
                 int* __restrict__ axis, float* __restrict__ smin_out,
                 float* __restrict__ smax_out, int B, int C, int nmax) {
  // [runs][kTile] run sums, then (mode 3) [nmax][kTile] slab sums; the
  // bank is the lane
  extern __shared__ float smem[];
  const int x = threadIdx.x, r = threadIdx.y, runs = blockDim.y;
  const int lane = blockIdx.x * kTile + x;
  const bool valid = lane < B;
  float* runsum = smem;
  float* slab = smem + runs * kTile;

  Lane L;
  int t0 = 0, t1 = -1;  // no slab for a lane past B
  bool up = true;       // slab order is ray order
  if (valid) {
    const float p[3] = {pos[3 * lane], pos[3 * lane + 1], pos[3 * lane + 2]};
    const float d[3] = {dir[3 * lane], dir[3 * lane + 1], dir[3 * lane + 2]};
    const float inv_h[3] = {ihx, ihy, ihz};
    int a;
    float smin, smax;
    lane_range(g, inv_h, p, d, active[lane] != 0, hint, a, smin, smax);
    L = make_lane(g, a, p[0], p[1], p[2], d[0], d[1], d[2]);
    L.smin = smin;
    L.smax = smax;
#pragma unroll
    for (int c = 0; c < kMaxComp; ++c)
      L.sig[c] = c < C ? sig[c * B + lane] : 0.0f;
    slab_range(L, t0, t1);
    up = L.da > 0.0f;
    if (mode == kBlockPrefix && r == 0) {
      axis[lane] = a;
      smin_out[lane] = smin;
      smax_out[lane] = smax;
    }
  }

  // the run's slabs [ra, rb), marched in ray order
  const int ra = r * run, rb = min(ra + run, nmax);
  float rsum = 0.0f;
  for (int k = 0; k < rb - ra; ++k) {
    const int t = up ? ra + k : rb - 1 - k;
    float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f;
    if (t >= t0 && t <= t1) {
      Slab S = enter_slab(L, t);
      if (S.act) {
        float ds;
        int cell;
        sub_step(L, t, S, ds, cell);
        d0 = opacity(L, nd, cell, C) * ds;
        sub_step(L, t, S, ds, cell);
        d1 = opacity(L, nd, cell, C) * ds;
        sub_step(L, t, S, ds, cell);
        d2 = opacity(L, nd, cell, C) * ds;
      }
    }
    if (!valid) continue;
    // (d0 + d1) + d2, the order of kernel 1 and of the plain version
    const float dt = d0 + d1 + d2;
    if (mode == kBlockSummed) {
      out[(size_t)t * B + lane] = dt;
    } else if (mode != kBlockTotal) {
      float* o = out + (size_t)t * 3 * B + lane;
      o[0] = d0;
      o[B] = d1;
      o[2 * (size_t)B] = d2;
    }
    if (mode == kBlockPrefix) slab[t * kTile + x] = dt;
    rsum = rsum + dt;
  }
  if (mode == kBlockSummed || mode == kBlockSub) return;

  runsum[r * kTile + x] = rsum;
  __syncthreads();
  // the total: the run sums in ray order
  float tot = 0.0f;
  for (int q = 0; q < runs; ++q)
    tot = tot + runsum[(up ? q : runs - 1 - q) * kTile + x];
  if (valid && r == 0) total[lane] = tot;
  if (mode != kBlockPrefix) return;
  if (valid && r == 0) {
    // the prefix in place, as sweep.py `slab_prefix` forms it: the running
    // sum in slab order, or tot - sum - dtau against the ray
    float sum = 0.0f;
    for (int t = 0; t < nmax; ++t) {
      const float dt = slab[t * kTile + x];
      slab[t * kTile + x] = up ? sum : (tot - sum) - dt;
      sum = sum + dt;
    }
  }
  __syncthreads();
  if (!valid) return;
  for (int t = ra; t < rb; ++t)
    prefix[(size_t)t * B + lane] = slab[t * kTile + x];
}

constexpr int kTileWarps = 8;

__global__ void __launch_bounds__(kTile* kTileWarps)
    tile_kernel(GridGeom g, float ihx, float ihy, float ihz,
                const float* __restrict__ pos, const float* __restrict__ dir,
                const unsigned char* __restrict__ active,
                const float* __restrict__ sig, const float* __restrict__ nd,
                float* __restrict__ out, int B, int C, int nmax) {
  extern __shared__ float rec[];  // [nmax][3][kTile]
  __shared__ Lane lanes[kTile];
  __shared__ int range[kTile][2];
  __shared__ int start[kTile + 1];
  const int x = threadIdx.x, y = threadIdx.y;
  const int lane = blockIdx.x * kTile + x;
  const bool valid = lane < B;
  if (y == 0) {
    int len = 0;
    if (valid) {
      const float p[3] = {pos[3 * lane], pos[3 * lane + 1],
                          pos[3 * lane + 2]};
      const float d[3] = {dir[3 * lane], dir[3 * lane + 1],
                          dir[3 * lane + 2]};
      const float inv_h[3] = {ihx, ihy, ihz};
      int a;
      float s0, s1;
      lane_range(g, inv_h, p, d, active[lane] != 0, -1, a, s0, s1);
      Lane L = make_lane(g, a, p[0], p[1], p[2], d[0], d[1], d[2]);
      L.smin = s0;
      L.smax = s1;
#pragma unroll
      for (int c = 0; c < kMaxComp; ++c)
        L.sig[c] = c < C ? sig[c * B + lane] : 0.0f;
      slab_range(L, range[x][0], range[x][1]);
      lanes[x] = L;
      len = max(range[x][1] - range[x][0] + 1, 0);
    } else {
      range[x][0] = 0;
      range[x][1] = -1;
    }
    for (int off = 1; off < kTile; off <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, len, off);
      if (x >= off) len += n;
    }
    start[x + 1] = len;
    if (x == 0) start[0] = 0;
  }
  for (int k = y * kTile + x; k < nmax * 3 * kTile; k += kTile * kTileWarps)
    rec[k] = 0.0f;
  __syncthreads();
  const int items = start[kTile];
  for (int w = y * kTile + x; w < items; w += kTile * kTileWarps) {
    int l = 0;
    for (int step = kTile / 2; step > 0; step >>= 1)
      if (start[l + step] <= w) l += step;
    const int t = range[l][0] + (w - start[l]);
    const Lane L = lanes[l];
    Slab S = enter_slab(L, t);
    if (S.act) {
      for (int j = 0; j < 3; ++j) {
        float ds;
        int cell;
        sub_step(L, t, S, ds, cell);
        rec[(t * 3 + j) * kTile + l] = opacity(L, nd, cell, C) * ds;
      }
    }
  }
  __syncthreads();
  if (!valid) return;
  for (int k = y; k < nmax * 3; k += kTileWarps)
    out[(size_t)k * B + lane] = rec[k * kTile + x];
}

}  // namespace skirt9

extern "C" int old_launch(int variant, const void* pos, const void* dir,
                          const void* axis, const void* smin, const void* smax,
                          const void* sig, const void* nd, void* out, int B,
                          int C, int nx, int ny, int nz, int nmax, int run,
                          float lox, float loy, float loz, float hx, float hy,
                          float hz, void* stream) {
  using namespace skirt9;
  if (B <= 0 || C < 1 || C > kMaxComp || run < 1 || variant < 0 ||
      variant > kStoresOnlyV)
    return (int)cudaErrorInvalidValue;
  GridGeom g{nx, ny, nz, {lox, loy, loz}, {hx, hy, hz}};
  const int per = variant == kLaneOnceV ? run : 1;
  const long long total = (long long)((nmax + per - 1) / per) * B;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  cudaStream_t s = (cudaStream_t)stream;
  const float* f[6] = {(const float*)pos, (const float*)dir,
                       (const float*)smin, (const float*)smax,
                       (const float*)sig, (const float*)nd};
  const int* ax = (const int*)axis;
  float* o = (float*)out;
  switch (variant) {
    case kFullV:
      old_kernel<kFullV><<<blocks, 256, 0, s>>>(
          g, f[0], f[1], ax, f[2], f[3], f[4], f[5], o, B, C, nmax, run);
      break;
    case kLaneOnceV:
      old_kernel<kLaneOnceV><<<blocks, 256, 0, s>>>(
          g, f[0], f[1], ax, f[2], f[3], f[4], f[5], o, B, C, nmax, run);
      break;
    case kNoGatherV:
      old_kernel<kNoGatherV><<<blocks, 256, 0, s>>>(
          g, f[0], f[1], ax, f[2], f[3], f[4], f[5], o, B, C, nmax, run);
      break;
    case kLaneStoresV:
      old_kernel<kLaneStoresV><<<blocks, 256, 0, s>>>(
          g, f[0], f[1], ax, f[2], f[3], f[4], f[5], o, B, C, nmax, run);
      break;
    default:
      old_kernel<kStoresOnlyV><<<blocks, 256, 0, s>>>(
          g, f[0], f[1], ax, f[2], f[3], f[4], f[5], o, B, C, nmax, run);
  }
  return (int)cudaGetLastError();
}

extern "C" int tile_launch(const void* pos, const void* dir,
                           const void* active, const void* sig, const void* nd,
                           void* out, int B, int C, int nx, int ny, int nz,
                           int nmax, float lox, float loy, float loz, float hx,
                           float hy, float hz, float ihx, float ihy, float ihz,
                           void* stream) {
  using namespace skirt9;
  if (B <= 0 || C < 1 || C > kMaxComp) return (int)cudaErrorInvalidValue;
  GridGeom g{nx, ny, nz, {lox, loy, loz}, {hx, hy, hz}};
  const size_t smem = (size_t)nmax * 3 * kTile * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  tile_kernel<<<(unsigned)((B + kTile - 1) / kTile), dim3(kTile, kTileWarps),
                smem, (cudaStream_t)stream>>>(
      g, ihx, ihy, ihz, (const float*)pos, (const float*)dir,
      (const unsigned char*)active, (const float*)sig, (const float*)nd,
      (float*)out, B, C, nmax);
  return (int)cudaGetLastError();
}

extern "C" int block_launch(int warps, const void* pos, const void* dir,
                            const void* active, const void* sig,
                            const void* nd, void* out, void* prefix,
                            void* total, void* axis, void* smin, void* smax,
                            int B, int C, int nx, int ny, int nz, int nmax,
                            int mode, float lox, float loy, float loz,
                            float hx, float hy, float hz, float ihx, float ihy,
                            float ihz, void* stream) {
  using namespace skirt9;
  if (B <= 0 || C < 1 || C > kMaxComp || warps < 1 || warps > 32 ||
      mode < kBlockSummed || mode > kBlockPrefix)
    return (int)cudaErrorInvalidValue;
  GridGeom g{nx, ny, nz, {lox, loy, loz}, {hx, hy, hz}};
  const int run = (nmax + warps - 1) / warps;
  const int runs = (nmax + run - 1) / run;
  const size_t smem = (size_t)(runs + (mode == kBlockPrefix ? nmax : 0)) *
                      kTile * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  block_kernel<<<(unsigned)((B + kTile - 1) / kTile), dim3(kTile, runs),
                 smem, (cudaStream_t)stream>>>(
      g, ihx, ihy, ihz, (const float*)pos, (const float*)dir,
      (const unsigned char*)active, (const float*)sig, (const float*)nd, -1,
      mode, run, (float*)out, (float*)prefix, (float*)total, (int*)axis,
      (float*)smin, (float*)smax, B, C, nmax);
  return (int)cudaGetLastError();
}
