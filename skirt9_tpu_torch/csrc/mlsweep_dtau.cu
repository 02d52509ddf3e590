// Pass 1 of the tree-grid (multi-level) sweep: optical depth per (plan step,
// lane), or per (plan step, sub-step, lane) with the leaf id of each
// sub-step, in four output modes, with the lane set-up inside.
//
// Replaces the Pallas TPU kernel skirt9_tpu/transport/mlsweep.py
// `_ml_dtau_kernel` (wrapper `sweep_dtau`). Each lane first takes its slab
// axis a (argmax |d_i| / h_i of the fine grid, or the caller's hint) and
// its in-grid path range [smin, smax] (sweep_common.cuh `lane_range`, as
// kernels 1 and 6 do). Plan step st then
// marches slab tlev = step_tlev[st] of the fine grid coarsened by gs =
// step_gs[st] along a, with the <= 3-cell sub-DDA of kernels 1 and 6
// (sweep_common.cuh) on the coarsened geometry. Sub-step j at minor cell
// (iu, iv) lies in fine voxel (tlev, iu, iv) << gs of layout a, mapped to
// (x, y, z) (a=0: (t, u, v) = (x, y, z); a=1: (y, x, z); a=2: (z, x, y)),
// whose leaf is cell = leafmap[(x * nfy + y) * nfz + z]. It contributes
// d[st][j] = sum_c nd[cell, c] * sig[c, lane] * ds, or 0 for cell -1. One
// lookup is exact: the plan never lets a step at granularity gs straddle a
// leaf boundary (mlsweep._make_plan). The modes:
//   0 (`mlsweep_dtau`)          out[st * B + lane] = (d0 + d1) + d2;
//   1 (`mlsweep_dtau`, want_sub) the record out[(st * 3 + j) * B + lane] =
//                               d[st][j] and its leaf ids cells[...] (-1
//                               where the slab is missed);
//   2 (`mlsweep_tau_total`)     total[lane]: the step sums added within
//                               each run of steps, then the run sums in ray
//                               order;
//   3 (`mlsweep_dtau_prefix`)   the record, the leaf ids where cells is
//                               given, the step sums steps[st * B + lane],
//                               prefix[st * B + lane] = the optical depth
//                               before step st in ray order, formed as
//                               sweep.py `slab_prefix` forms it, the total
//                               of mode 2, and the lane's axis, smin, smax.
// Modes 0 and 1 are the TPU kernel's contracts, bit-identical to the plain
// version.
//
// What bounds it on the H100: two dependent gathers per sub-step (the leaf
// map, then the density row), about 3 * n_steps * B of them on the (step,
// lane) pairs the rays cross; the leaf map (8 MB at a 128^3 raster, 67 MB
// at 256^3) and the density (20 kB to 0.6 MB) sit in or near the 50 MB L2.
// The record is n_steps * 3 * B * 4 bytes (101 MB at n_steps = 128, B =
// 65536), twice that with the leaf ids, written once and coalesced. The
// first design ran one thread per (step, lane), each loading and
// coarsening its lane before it could find the step dead. Design, that of
// kernel 6 (sweepxl_dtau.cu): pass A runs one thread per (run of `run`
// consecutive plan steps, lane), the run the slow index, so a warp covers
// 32 consecutive lanes of one run (every record row leaves as a 128-byte
// store) and the threads in flight share a few runs of steps, which keeps
// the leaf-map gathers' L2 hits on the 256^3 raster; a thread forms its
// lane once per run and coarsens it per step (`coarsen_lane`), and a step
// whose fine slabs lie outside the ray's slab range (`slab_range`, one
// slab of margin) stores zeros without arithmetic. It walks its steps in
// geometric order: the tree loop does not sort its lanes, so a warp holds
// rays of both directions, which would split every row otherwise. For
// modes 2 and 3 it writes its run's sum to a (runs, B) scratch; pass B, one
// thread per lane in the same launch, forms the total and the prefix
// (sweep_common.cuh `scan_lane`). The TPU kernel's per-level density
// planes, the -1 non-leaf flag, the select loop over (level, layout, row)
// and the packed deposit encoding are replaced by the one leaf-map gather.
#include "sweep_common.cuh"

namespace skirt9 {

enum : int { kMlSummed = 0, kMlSub = 1, kMlTotal = 2, kMlPrefix = 3 };
constexpr int kMlThreads = 256;

__device__ __forceinline__ int leaf_at(const int* __restrict__ leafmap,
                                       const GridGeom& f, int a, int tf,
                                       int uf, int vf) {
  const int x = a == 0 ? tf : uf;
  const int y = a == 0 ? uf : (a == 1 ? tf : vf);
  const int z = a == 2 ? tf : vf;
  return leafmap[((long long)x * f.ny + y) * f.nz + z];
}

// Pass A. f: the fine grid; pos, dir: (B, 3); active: (B,) bytes; sig:
// (C, B); nd: (ncells, C); leafmap: (nfx * nfy * nfz,); step_tlev, step_gs:
// (n_steps,). Mode 0: out (n_steps, B). Mode 1: out, cells (n_steps, 3, B).
// Mode 2: runsum (runs, B). Mode 3: out, cells or null, steps (n_steps,
// B), runsum, axis, smin_out, smax_out (B,).
__global__ void __launch_bounds__(kMlThreads) mlsweep_march_kernel(
    GridGeom f, float ihx, float ihy, float ihz, const float* __restrict__ pos,
    const float* __restrict__ dir, const unsigned char* __restrict__ active,
    const float* __restrict__ sig, const float* __restrict__ nd,
    const int* __restrict__ leafmap,
    const int* __restrict__ step_tlev, const int* __restrict__ step_gs,
    int hint, int mode, int run, float* __restrict__ out,
    int* __restrict__ cells, float* __restrict__ steps,
    float* __restrict__ runsum, int* __restrict__ axis,
    float* __restrict__ smin_out, float* __restrict__ smax_out, int B, int C,
    int n_steps) {
  const long long idx = (long long)blockIdx.x * kMlThreads + threadIdx.x;
  const int runs = (n_steps + run - 1) / run;
  if (idx >= (long long)runs * B) return;
  const int q = (int)(idx / B);
  const int lane = (int)(idx - (long long)q * B);
  const float inv_h[3] = {ihx, ihy, ihz};
  int a;
  const Lane L = form_lane(f, inv_h, pos, dir, active, sig, hint, C, B, lane,
                           a);
  // the fine slabs the ray can cross
  int t0, t1;
  slab_range(L, t0, t1);
  if (mode == kMlPrefix && q == 0) {
    axis[lane] = a;
    smin_out[lane] = L.smin;
    smax_out[lane] = L.smax;
  }
  const int sa = q * run, sb = min(sa + run, n_steps);
  float rsum = 0.0f;
  for (int st = sa; st < sb; ++st) {
    const int tlev = step_tlev[st], gs = step_gs[st];
    float d[3] = {0.0f, 0.0f, 0.0f};
    int c[3] = {-1, -1, -1};
    if ((tlev << gs) <= t1 && ((tlev + 1) << gs) - 1 >= t0) {
      const Lane Lc = coarsen_lane(L, gs);
      if (tlev < Lc.na) {
        Slab S = enter_slab(Lc, tlev);
        if (S.act) {
          for (int j = 0; j < 3; ++j) {
            const int uf = S.iu << gs, vf = S.iv << gs;
            float ds;
            int coarse_cell;
            sub_step(Lc, tlev, S, ds, coarse_cell);
            c[j] = leaf_at(leafmap, f, a, tlev << gs, uf, vf);
            if (c[j] >= 0) d[j] = opacity(Lc, nd, c[j], C) * ds;
          }
        }
      }
    }
    // (d0 + d1) + d2, the order of the plain version
    const float dt = d[0] + d[1] + d[2];
    if (mode == kMlSummed) {
      out[(size_t)st * B + lane] = dt;
    } else if (mode != kMlTotal) {
      const size_t o = (size_t)st * 3 * B + lane;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        out[o + (size_t)j * B] = d[j];
        if (cells != nullptr) cells[o + (size_t)j * B] = c[j];
      }
    }
    if (mode == kMlPrefix) steps[(size_t)st * B + lane] = dt;
    rsum = rsum + dt;
  }
  if (mode >= kMlTotal) runsum[(size_t)q * B + lane] = rsum;
}

// Pass B (modes 2-3), one thread per lane: the total from the run sums in
// ray order; mode 3 the prefix from the step sums.
__global__ void __launch_bounds__(kMlThreads) mlsweep_scan_kernel(
    GridGeom f, float ihx, float ihy, float ihz, const float* __restrict__ pos,
    const float* __restrict__ dir, const unsigned char* __restrict__ active,
    const float* __restrict__ runsum, const float* __restrict__ steps,
    int hint, int runs, float* __restrict__ prefix,
    float* __restrict__ total, int B, int n_steps) {
  const int lane = blockIdx.x * kMlThreads + threadIdx.x;
  if (lane >= B) return;
  // the lane's slab axis and the sign of its major direction component, as
  // pass A found them
  const float p[3] = {pos[3 * lane], pos[3 * lane + 1], pos[3 * lane + 2]};
  const float d[3] = {dir[3 * lane], dir[3 * lane + 1], dir[3 * lane + 2]};
  const float inv_h[3] = {ihx, ihy, ihz};
  int a;
  float smin, smax;
  lane_range(f, inv_h, p, d, active[lane] != 0, hint, a, smin, smax);
  scan_lane(runsum, runs, steps, prefix, total, n_steps, B, lane,
            d[a] > 0.0f);
}

}  // namespace skirt9

extern "C" int mlsweep_dtau_launch(
    const void* pos, const void* dir, const void* active, const void* sig,
    const void* nd, const void* leafmap, const void* step_tlev,
    const void* step_gs, void* out, void* cells, void* steps, void* prefix,
    void* total, void* runsum, void* axis, void* smin, void* smax, int B,
    int C, int nx, int ny, int nz, int n_steps, int hint, int mode, int run,
    float lox, float loy, float loz, float hx, float hy, float hz, float ihx,
    float ihy, float ihz, void* stream) {
  using namespace skirt9;
  if (B <= 0 || n_steps <= 0 || C < 1 || C > kMaxComp || hint < -1 ||
      hint > 2 || run < 1 || mode < kMlSummed || mode > kMlPrefix ||
      (mode != kMlTotal && out == nullptr) ||
      (mode == kMlSub && cells == nullptr) ||
      (mode >= kMlTotal && (total == nullptr || runsum == nullptr)) ||
      (mode == kMlPrefix && (steps == nullptr || prefix == nullptr ||
                             axis == nullptr || smin == nullptr ||
                             smax == nullptr)))
    return (int)cudaErrorInvalidValue;
  GridGeom g{nx, ny, nz, {lox, loy, loz}, {hx, hy, hz}};
  cudaStream_t s = (cudaStream_t)stream;
  const int runs = (n_steps + run - 1) / run;
  const long long threads = (long long)runs * B;
  mlsweep_march_kernel<<<(unsigned)((threads + kMlThreads - 1) / kMlThreads),
                         kMlThreads, 0, s>>>(
      g, ihx, ihy, ihz, (const float*)pos, (const float*)dir,
      (const unsigned char*)active, (const float*)sig, (const float*)nd,
      (const int*)leafmap, (const int*)step_tlev, (const int*)step_gs, hint,
      mode, run, (float*)out, (int*)cells, (float*)steps, (float*)runsum,
      (int*)axis, (float*)smin, (float*)smax, B, C, n_steps);
  if (mode >= kMlTotal) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    mlsweep_scan_kernel<<<(unsigned)((B + kMlThreads - 1) / kMlThreads),
                          kMlThreads, 0, s>>>(
        g, ihx, ihy, ihz, (const float*)pos, (const float*)dir,
        (const unsigned char*)active, (const float*)runsum,
        (const float*)steps, hint, runs,
        mode == kMlPrefix ? (float*)prefix : nullptr, (float*)total, B,
        n_steps);
  }
  return (int)cudaGetLastError();
}
