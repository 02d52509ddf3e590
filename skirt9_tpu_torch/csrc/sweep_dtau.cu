// Pass 1 of the slab sweep: optical depth per (slab, lane), in three output
// modes, with the lane set-up inside.
//
// Replaces the Pallas TPU kernel skirt9_tpu/transport/sweep.py
// `_dtau_kernel` (wrapper `sweep_dtau`). Each lane first takes its slab axis
// (argmax |d_i| / h_i, or the caller's hint) and its in-grid path range
// [smin, smax] (sweep.py `_lane_range`, operation for operation). Then
// dtau[t] = sum over the <= 3 cells the ray crosses in slab t of
// sum_c nd[cell, c] * sig[c, lane] * ds, 0 where it does not cross slab t
// inside [smin, smax). Mode 0 (`sweep_dtau`, the TPU kernel's contract)
// writes dtau as (nmax, B); mode 1 (`sweep_tau_total`) only the lane's total,
// summed in slab order; mode 2 (`sweep_dtau_prefix`) the ray-ordered optical
// depth before each slab as (nmax, B) (sweep.py `slab_prefix`), the total,
// and the lane's axis, smin and smax.
//
// What bounds it on the H100: dependent gathers of the density table (in
// L2) and the IEEE divisions of the sub-DDA, on the (slab, lane) pairs the
// rays cross, then the (nmax, B) output of modes 0 and 2 (16.8 MB at config
// 1), the one large memory stream. Design: a block of 256 threads takes a
// tile of 32 lanes. One warp sets each lane up once into shared
// memory (axis, range, the Lane struct) with the slabs the ray can cross:
// those of its entry and exit points, one slab of margin each side, and
// prefix-sums their counts. The block's 256 threads then take the tile's
// (lane, slab) items in turn, so slabs the rays miss cost no arithmetic and
// a long ray does not hold up its warp; enter_slab's exact test decides
// inside the range. The tile's tau goes to shared memory (nmax x 32 floats;
// the bank is the lane), one warp sums it in slab order and forms the
// prefix in place, and the tile leaves row by row, each warp storing 32
// consecutive lanes.
#include "sweep_common.cuh"

namespace skirt9 {

constexpr int kSlabThreads = 8;  // threads per block: kTile * kSlabThreads

enum : int { kModeDtau = 0, kModeTotal = 1, kModePrefix = 2 };

// The lane's slab axis (argmax |d_i| / h_i, first maximum on ties, unless
// hint >= 0 names it) and in-grid path range [smin, smax], smax = smin for an
// inactive lane: sweep.py `dominant_axis` and `_lane_range`.
__device__ inline void lane_range(const GridGeom& g, const float inv_h[3],
                                  const float p[3], const float d[3],
                                  bool active, int hint, int& a, float& smin,
                                  float& smax) {
  a = 0;
  if (hint >= 0) {
    a = hint;
  } else {
    float best = fabsf(d[0]) * inv_h[0];
    for (int i = 1; i < 3; ++i) {
      const float r = fabsf(d[i]) * inv_h[i];
      if (r > best) {
        best = r;
        a = i;
      }
    }
  }
  const int n[3] = {g.nx, g.ny, g.nz};
  float enter_max = 0.0f, leave_min = 0.0f;
  bool inbox = true;
  for (int i = 0; i < 3; ++i) {
    const bool tiny = fabsf(d[i]) < 1e-30f;
    const float inv = 1.0f / (tiny ? 1e-30f : d[i]);
    const float hi = g.lo[i] + (float)n[i] * g.h[i];
    const float t1 = (g.lo[i] - p[i]) * inv;
    const float t2 = (hi - p[i]) * inv;
    const float enter = tiny ? -kBig : fminf(t1, t2);
    const float leave = tiny ? kBig : fmaxf(t1, t2);
    enter_max = i == 0 ? enter : fmaxf(enter_max, enter);
    leave_min = i == 0 ? leave : fminf(leave_min, leave);
    // a tiny direction component gives no bound on s: the ray meets the
    // box only if its position lies within that dimension's range
    if (tiny && (p[i] < g.lo[i] || p[i] >= hi)) inbox = false;
  }
  smin = fmaxf(enter_max, 0.0f);
  smax = (active && inbox && leave_min > smin) ? leave_min : smin;
}

// pos, dir: (B, 3); active: (B,) bytes; sig: (C, B); nd: (ncells, C).
// Mode 0: out (nmax, B) tau. Mode 1: total (B,). Mode 2: out (nmax, B)
// prefix, total, axis, smin_out, smax_out (B,).
__global__ void __launch_bounds__(kTile* kSlabThreads)
    sweep_dtau_kernel(GridGeom g, float ihx, float ihy, float ihz,
                      const float* __restrict__ pos,
                      const float* __restrict__ dir,
                      const unsigned char* __restrict__ active,
                      const float* __restrict__ sig,
                      const float* __restrict__ nd, int hint, int mode,
                      float* __restrict__ out, float* __restrict__ total,
                      int* __restrict__ axis, float* __restrict__ smin_out,
                      float* __restrict__ smax_out, int B, int C, int nmax) {
  extern __shared__ float tile[];  // [nmax][kTile]
  __shared__ Lane lanes[kTile];
  __shared__ int range[kTile][2];
  __shared__ int start[kTile + 1];  // the tile's (lane, slab) items per lane
  __shared__ float tot[kTile];
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
      float smin, smax;
      lane_range(g, inv_h, p, d, active[lane] != 0, hint, a, smin, smax);
      Lane L = make_lane(g, a, p[0], p[1], p[2], d[0], d[1], d[2]);
      L.smin = smin;
      L.smax = smax;
#pragma unroll
      for (int c = 0; c < kMaxComp; ++c)
        L.sig[c] = c < C ? sig[c * B + lane] : 0.0f;
      slab_range(L, range[x][0], range[x][1]);
      lanes[x] = L;
      len = max(range[x][1] - range[x][0] + 1, 0);
      if (mode == kModePrefix) {
        axis[lane] = a;
        smin_out[lane] = smin;
        smax_out[lane] = smax;
      }
    } else {
      range[x][0] = 0;
      range[x][1] = -1;
    }
    // inclusive scan of the slab counts over the warp
    for (int off = 1; off < kTile; off <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, len, off);
      if (x >= off) len += n;
    }
    start[x + 1] = len;
    if (x == 0) start[0] = 0;
  }
  __syncthreads();

  const int items = start[kTile];
  for (int w = y * kTile + x; w < items; w += kTile * kSlabThreads) {
    // the item's lane: the last l with start[l] <= w (it has slabs)
    int l = 0;
    for (int step = kTile / 2; step > 0; step >>= 1)
      if (start[l + step] <= w) l += step;
    const int t = range[l][0] + (w - start[l]);
    const Lane L = lanes[l];
    Slab S = enter_slab(L, t);
    float dtau = 0.0f;
    if (S.act) {
      for (int j = 0; j < 3; ++j) {
        float ds;
        int cell;
        sub_step(L, t, S, ds, cell);
        dtau = dtau + opacity(L, nd, cell, C) * ds;
      }
    }
    tile[t * kTile + l] = dtau;
  }
  __syncthreads();

  const int t0 = range[x][0], t1 = range[x][1];

  const bool up = valid && lanes[x].da > 0.0f;  // slab order is ray order
  if (mode != kModeDtau) {
    if (y == 0 && valid) {
      float s = 0.0f;
      for (int t = t0; t <= t1; ++t) s = s + tile[t * kTile + x];
      total[lane] = s;
      tot[x] = s;
      if (mode == kModePrefix) {
        // before_up, or total - before_up - dtau against the ray
        float r = 0.0f;
        for (int t = t0; t <= t1; ++t) {
          const float dt = tile[t * kTile + x];
          tile[t * kTile + x] = up ? r : (s - r) - dt;
          r = r + dt;
        }
      }
    }
    if (mode == kModeTotal) return;
    __syncthreads();
  }
  if (!valid) return;
  for (int t = y; t < nmax; t += kSlabThreads) {
    float v;
    if (t >= t0 && t <= t1) {
      v = tile[t * kTile + x];
    } else if (mode == kModeDtau) {
      v = 0.0f;
    } else {
      // no tau outside the range: 0 before the ray's first slab, the total
      // after its last
      v = (t < t0) == up ? 0.0f : tot[x];
    }
    out[(size_t)t * B + lane] = v;
  }
}

}  // namespace skirt9

extern "C" int sweep_dtau_launch(const void* pos, const void* dir,
                                 const void* active, const void* sig,
                                 const void* nd, void* out, void* total,
                                 void* axis, void* smin, void* smax, int B,
                                 int C, int nx, int ny, int nz, int nmax,
                                 int hint, int mode, float lox, float loy,
                                 float loz, float hx, float hy, float hz,
                                 float ihx, float ihy, float ihz,
                                 void* stream) {
  using namespace skirt9;
  const int na_max = nx > ny ? (nx > nz ? nx : nz) : (ny > nz ? ny : nz);
  if (B <= 0 || C < 1 || C > kMaxComp || nmax < na_max || hint < -1 ||
      hint > 2 || mode < kModeDtau || mode > kModePrefix ||
      (mode != kModeTotal && out == nullptr) ||
      (mode != kModeDtau && total == nullptr) ||
      (mode == kModePrefix && (axis == nullptr || smin == nullptr ||
                               smax == nullptr)))
    return (int)cudaErrorInvalidValue;
  GridGeom g{nx, ny, nz, {lox, loy, loz}, {hx, hy, hz}};
  const size_t smem = (size_t)nmax * kTile * sizeof(float);
  if (smem > 32 * 1024) {
    // above 48 KB of static plus dynamic shared memory only after opting in
    const cudaError_t err = cudaFuncSetAttribute(
        sweep_dtau_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 threads(kTile, kSlabThreads);
  const unsigned blocks = (unsigned)((B + kTile - 1) / kTile);
  sweep_dtau_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      g, ihx, ihy, ihz, (const float*)pos, (const float*)dir,
      (const unsigned char*)active, (const float*)sig, (const float*)nd, hint,
      mode, (float*)out, (float*)total, (int*)axis, (float*)smin,
      (float*)smax, B, C, nmax);
  return (int)cudaGetLastError();
}
