// Pass 1 of the large-grid (XL) sweep: optical depth per (slab, sub-step,
// lane), in four output modes, with the lane set-up inside.
//
// Replaces the Pallas TPU kernel skirt9_tpu/transport/sweepxl.py
// `_xl_dtau_kernel` (wrapper `sweep_dtau`). Each lane first takes its slab
// axis (argmax |d_i| / h_i, or the caller's hint) and its in-grid path range
// [smin, smax] (sweep_common.cuh `lane_range`, as kernel 1 does). Then
// sub-step j <= 2 of its ray in slab t of that axis contributes d[t][j] =
// sum_c nd[cell, c] * sig[c, lane] * ds, 0 where the ray does not cross slab
// t inside [smin, smax). The modes:
//   0 (`sweep_dtau`)         out[t * B + lane] = (d0 + d1) + d2;
//   1 (`sweep_dtau`, want_sub) the record out[(t * 3 + j) * B + lane] =
//                            d[t][j], which lets the deposit pass and the
//                            interaction search run without the density;
//   2 (`sweep_tau_total`)    total[lane]: the slab sums added in ray order
//                            within each run of slabs, then the run sums in
//                            ray order;
//   3 (`sweep_dtau_prefix`)  the record, prefix[t * B + lane] = the optical
//                            depth before slab t in ray order, formed as
//                            sweep.py `slab_prefix` forms it (a running sum
//                            in slab order, or total - sum - dtau against
//                            the ray), the total of mode 2, and the lane's
//                            axis, smin and smax.
// Modes 0 and 1 are the TPU kernel's contracts, bit-identical to the plain
// version. The TPU kernel's per-block slab windows and occupied-slab clip
// (sweepxl.py:324-339, :426-431) only skip work whose result is zero; here
// a thread stores zeros without arithmetic for the slabs outside its ray's
// slab range. Its streamed (U, V) planes, bf16/int8 splits and one-hot MXU
// lookups are not needed: the flat table is read by plain gathers.
//
// What bounds it on the H100: at 256^3 the f32 density table is 67 MB, more
// than the 50 MB L2, and each sub-step's gather depends on the previous
// sub-step's cell; the record is nmax * 3 * B * 4 bytes (403 MB at 256^3, B
// = 131072), written once. Each 32-byte sector of the table is read about 20
// times a batch, so the gathers hit L2 only while the threads in flight
// share slabs. The first design ran one thread per (slab, lane), slab-major,
// so they did, but every lane's inputs and set-up were read and redone once
// per slab. Design: pass A runs one thread per (run of `run` consecutive
// slabs, lane), the run the slow index, so a warp covers 32 consecutive
// lanes of one run (every record row leaves as a 128-byte store), the
// threads in flight share a few runs of slabs, and a thread forms its lane
// once per run. For modes 2 and 3 it writes its run's sum to a (runs, B)
// scratch and, mode 3, each slab's sum into the prefix rows; pass B, one
// thread per lane, adds the run sums into the total and turns the slab sums
// into the prefix in place. The caller sorts lanes by (axis, major sign,
// entry slab) (sweepxl.lane_order), which keeps a warp on one slab layout,
// on nearby cells, and active or inactive together. A design that kept a
// lane's runs in one block (a warp per run, the scan in shared memory) lost
// the L2 reuse and ran slower than the first design at 256^3
// (perf/kernel6_variants.cu keeps it and times it; PERF.md section 6).
#include "sweep_common.cuh"

namespace skirt9 {

enum : int { kXlSummed = 0, kXlSub = 1, kXlTotal = 2, kXlPrefix = 3 };
constexpr int kXlThreads = 256;

// The lane of ray `lane`: its axis, range, geometry and cross sections.
__device__ inline Lane xl_lane(const GridGeom& g, const float inv_h[3],
                               const float* pos, const float* dir,
                               const unsigned char* active, const float* sig,
                               int hint, int C, int B, int lane, int& a) {
  const float p[3] = {pos[3 * lane], pos[3 * lane + 1], pos[3 * lane + 2]};
  const float d[3] = {dir[3 * lane], dir[3 * lane + 1], dir[3 * lane + 2]};
  float smin, smax;
  lane_range(g, inv_h, p, d, active[lane] != 0, hint, a, smin, smax);
  Lane L = make_lane(g, a, p[0], p[1], p[2], d[0], d[1], d[2]);
  L.smin = smin;
  L.smax = smax;
#pragma unroll
  for (int c = 0; c < kMaxComp; ++c)
    L.sig[c] = c < C ? sig[c * B + lane] : 0.0f;
  return L;
}

// Pass A. pos, dir: (B, 3); active: (B,) bytes; sig: (C, B); nd: (ncells,
// C). Mode 0: out (nmax, B). Mode 1: out (nmax, 3, B). Modes 2-3: runsum
// (runs, B). Mode 3: out (nmax, 3, B), prefix (nmax, B) slab sums, axis,
// smin_out, smax_out (B,).
__global__ void __launch_bounds__(kXlThreads)
    sweepxl_march_kernel(GridGeom g, float ihx, float ihy, float ihz,
                         const float* __restrict__ pos,
                         const float* __restrict__ dir,
                         const unsigned char* __restrict__ active,
                         const float* __restrict__ sig,
                         const float* __restrict__ nd, int hint, int mode,
                         int run, float* __restrict__ out,
                         float* __restrict__ prefix,
                         float* __restrict__ runsum, int* __restrict__ axis,
                         float* __restrict__ smin_out,
                         float* __restrict__ smax_out, int B, int C,
                         int nmax) {
  const long long idx = (long long)blockIdx.x * kXlThreads + threadIdx.x;
  const int runs = (nmax + run - 1) / run;
  if (idx >= (long long)runs * B) return;
  const int q = (int)(idx / B);
  const int lane = (int)(idx - (long long)q * B);
  const float inv_h[3] = {ihx, ihy, ihz};
  int a;
  const Lane L = xl_lane(g, inv_h, pos, dir, active, sig, hint, C, B, lane, a);
  int t0, t1;
  slab_range(L, t0, t1);
  if (mode == kXlPrefix && q == 0) {
    axis[lane] = a;
    smin_out[lane] = L.smin;
    smax_out[lane] = L.smax;
  }
  // the run's slabs [ra, rb), marched in ray order
  const bool up = L.da > 0.0f;
  const int ra = q * run, rb = min(ra + run, nmax);
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
    // (d0 + d1) + d2, the order of kernel 1 and of the plain version
    const float dt = d0 + d1 + d2;
    if (mode == kXlSummed) {
      out[(size_t)t * B + lane] = dt;
    } else if (mode != kXlTotal) {
      float* o = out + (size_t)t * 3 * B + lane;
      o[0] = d0;
      o[B] = d1;
      o[2 * (size_t)B] = d2;
    }
    if (mode == kXlPrefix) prefix[(size_t)t * B + lane] = dt;
    rsum = rsum + dt;
  }
  if (mode >= kXlTotal) runsum[(size_t)q * B + lane] = rsum;
}

// Pass B (modes 2-3), one thread per lane: the total from the run sums in
// ray order; mode 3 the prefix in place of the slab sums.
__global__ void __launch_bounds__(kXlThreads)
    sweepxl_scan_kernel(GridGeom g, float ihx, float ihy, float ihz,
                        const float* __restrict__ pos,
                        const float* __restrict__ dir,
                        const unsigned char* __restrict__ active,
                        const float* __restrict__ runsum, int hint, int mode,
                        int runs, float* __restrict__ prefix,
                        float* __restrict__ total, int B, int nmax) {
  const int lane = blockIdx.x * kXlThreads + threadIdx.x;
  if (lane >= B) return;
  // the lane's slab axis and the sign of its major direction component, as
  // pass A found them
  const float p[3] = {pos[3 * lane], pos[3 * lane + 1], pos[3 * lane + 2]};
  const float d[3] = {dir[3 * lane], dir[3 * lane + 1], dir[3 * lane + 2]};
  const float inv_h[3] = {ihx, ihy, ihz};
  int a;
  float smin, smax;
  lane_range(g, inv_h, p, d, active[lane] != 0, hint, a, smin, smax);
  const bool up = d[a] > 0.0f;
  float tot = 0.0f;
  for (int q = 0; q < runs; ++q)
    tot = tot + runsum[(size_t)(up ? q : runs - 1 - q) * B + lane];
  total[lane] = tot;
  if (mode != kXlPrefix) return;
  float sum = 0.0f;
#pragma unroll 8
  for (int t = 0; t < nmax; ++t) {
    float* at = prefix + (size_t)t * B + lane;
    const float dt = *at;
    *at = up ? sum : (tot - sum) - dt;
    sum = sum + dt;
  }
}

}  // namespace skirt9

extern "C" int sweepxl_dtau_launch(const void* pos, const void* dir,
                                   const void* active, const void* sig,
                                   const void* nd, void* out, void* prefix,
                                   void* total, void* runsum, void* axis,
                                   void* smin, void* smax, int B, int C,
                                   int nx, int ny, int nz, int nmax, int hint,
                                   int mode, int run, float lox, float loy,
                                   float loz, float hx, float hy, float hz,
                                   float ihx, float ihy, float ihz,
                                   void* stream) {
  using namespace skirt9;
  const int na_max = nx > ny ? (nx > nz ? nx : nz) : (ny > nz ? ny : nz);
  if (B <= 0 || C < 1 || C > kMaxComp || nmax < na_max || hint < -1 ||
      hint > 2 || run < 1 || mode < kXlSummed || mode > kXlPrefix ||
      (mode != kXlTotal && out == nullptr) ||
      (mode >= kXlTotal && (total == nullptr || runsum == nullptr)) ||
      (mode == kXlPrefix && (prefix == nullptr || axis == nullptr ||
                             smin == nullptr || smax == nullptr)))
    return (int)cudaErrorInvalidValue;
  GridGeom g{nx, ny, nz, {lox, loy, loz}, {hx, hy, hz}};
  cudaStream_t s = (cudaStream_t)stream;
  const int runs = (nmax + run - 1) / run;
  const long long threads = (long long)runs * B;
  sweepxl_march_kernel<<<(unsigned)((threads + kXlThreads - 1) / kXlThreads),
                         kXlThreads, 0, s>>>(
      g, ihx, ihy, ihz, (const float*)pos, (const float*)dir,
      (const unsigned char*)active, (const float*)sig, (const float*)nd, hint,
      mode, run, (float*)out, (float*)prefix, (float*)runsum, (int*)axis,
      (float*)smin, (float*)smax, B, C, nmax);
  if (mode >= kXlTotal) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    sweepxl_scan_kernel<<<(unsigned)((B + kXlThreads - 1) / kXlThreads),
                          kXlThreads, 0, s>>>(
        g, ihx, ihy, ihz, (const float*)pos, (const float*)dir,
        (const unsigned char*)active, (const float*)runsum, hint, mode, runs,
        (float*)prefix, (float*)total, B, nmax);
  }
  return (int)cudaGetLastError();
}
