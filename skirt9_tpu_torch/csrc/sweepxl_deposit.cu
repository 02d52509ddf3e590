// Pass 2 of the large-grid (XL) sweep: radiation-field deposits from the
// recorded per-sub-step optical depths, with no density access, in two
// input modes; the second also finds the interaction point.
//
// Replaces the Pallas TPU kernel skirt9_tpu/transport/sweepxl.py
// `_xl_deposit_kernel` (wrapper `sweep_deposit`). Contract: for every
// sub-step j of slab t of the ray of `lane`, with dtau = dsub[(t * 3 + j) * B
// + lane] and tau_loc the sum of the slab's earlier sub-steps, add
// scale[t] * e^-tau_loc * ds * (1 - e^-dtau) / dtau into rf[row, cell]. The
// modes:
//   0 (`sweepxl_deposit`, the TPU kernel's contract) reads scale as an
//     (nmax, B) table, row = the lane's group, lane / (B / n_groups); the
//     interaction point is found outside (sweepxl.resolve_interaction);
//   1 (`sweepxl_deposit_prefix`, the event loop's) takes pass 1's prefix tb
//     (nmax, B) and per-lane lum, tau_int and the interaction mask: scale =
//     (lum * e^-tb) * inv_sqrt, the loop's own f32 operations in its order (the
//     build's -fmad=false keeps them apart), and no deposits at all where rf is
//     null (no RF stored). The RF is a cell-major (cells, rows) f64 table: the
//     lane's group is lane / (B / n_groups), its row bin_map[group] (the group
//     itself without a bin map), a row outside [0, rows) drops the lane's
//     deposits, and a contribution to voxel v adds into rf[cell * rows + row],
//     with cell = v on a uniform grid and cellmap[v], the voxel's leaf, on a
//     tree's voxel raster. It is the simulation's own accumulator over a
//     segment (or zeros): an event that leaves a point source puts 10^3-10^4
//     deposits into each hot entry, which an f32 sum in a random order leaves
//     ~1e-6 of itself apart from run to run, and up to millions of voxels fold
//     into one coarse leaf; the caller rounds it once. It also finds the
//     interaction point as sweepxl.py `resolve_interaction` does, bit for bit:
//     the hit slab is the lowest t with tau_int - tb[t] >= 0 and tau_int < tb
//     of the next slab along the ray (+inf past the ray's last geometric slab),
//     tested on every slab t < nmax; within it the first sub-step j with cum_j
//     <= rel < cum_j + dtau_j gives s_int = s_cur + ((rel - cum_j) /
//     max(dtau_j, 1e-37)) * ds and the cell. s_int, icell (-1 where not found)
//     and found are per lane.
// Both take pass 1's lane range (axis, smin, smax). In mode 0 rf starts at
// zero and the caller adds the call's rows into its accumulator; mode 1
// adds into the table it is given, so that a 25-bin RF at 256^3 is not
// zeroed, written and added once more per event.
//
// What bounds it on the H100: the (nmax, B) input (134 MB at 256^3, B = 131072)
// and the record of the lanes that deposit (403 MB), read once and coalesced,
// and atomics into the RF (f64 in mode 1: 134 MB a bin), contended where many
// lanes cross one cell (every packet starts at the source in the first event);
// the RF and the record outgrow the 50 MB L2. Design: pass A runs one thread
// per (run of `run` consecutive slabs, lane), the run the slow index, as kernel
// 6's pass A does (sweepxl_dtau.cu): a warp covers 32 consecutive lanes of one
// run, every row it reads is one 128-byte load, and a thread loads its lane
// once per run. In mode 1 it first tests its slabs in geometric order (each
// slab's tb read once, the neighbour's carried in a register, the first hit
// ending the loop) and writes the run's first hit slab to a (runs, B) scratch;
// then, for a lane with a nonzero lum only (none when no RF is stored), it
// reads the record and runs the sub-DDA on the slabs its ray can cross, one
// atomic per nonzero contribution (f64 in mode 1). Summing a warp's deposits by
// entry first took longer on bench_config1x256's sphere rays
// (perf/kernel7_variants.cu `warp_sums_launch` against `atomics_launch`;
// PERF.md section 6), and f64 atomics keep a hot entry's sum exact where warp
// sums would only shorten it. Pass B (mode 1), one thread per lane in the same
// launch, takes the lowest hit slab over the runs, re-derives that slab's <= 3
// sub-steps, reads its three record entries and stores s_int, icell and found.
// The TPU kernel's (group, slab, axis, U, V) plane accumulator, its decode and
// the one-hot matmul pair are replaced by the atomics; the atomics make the RF
// sums order-dependent from run to run (in mode 1 in the last bits of an f64
// only). The lane groups of mode 1 are runs of B / n_groups lanes, a multiple
// of 32 (the wrapper checks it), so every warp deposits into one row.
// Offsets are 64-bit: n_groups * ncells passes 2^31 at 512^3 with 16
// groups, cells * rows at 256^3 with 128 rows, and nmax * 3 * B at 512
// slabs with B >= 2^21.
#include "sweep_common.cuh"

namespace skirt9 {

enum : int { kXlDepTables = 0, kXlDepPrefix = 1 };
constexpr int kXlDepThreads = 256;
constexpr int kHitChunk = 8;  // slabs of the hit search per batch of loads

// Pass A. pos, dir: (B, 3); axis, smin, smax: (B,); dsub: (nmax, 3, B).
// Mode 0: slab = scale (nmax, B), rf (n_groups, ncells). Mode 1: slab = tb
// (nmax, B), lum (B,) or null, tau_int (B,), rf (cells, rows) f64 or
// null, bin_map (n_groups,) or null, cellmap (ncells,) or null, hitrun
// (runs, B): the run's first hit slab, nmax for none.
template <int kMode, typename Acc>
__global__ void __launch_bounds__(kXlDepThreads) sweepxl_deposit_kernel(
    GridGeom g, const float* __restrict__ pos, const float* __restrict__ dir,
    const int* __restrict__ axis, const float* __restrict__ smin,
    const float* __restrict__ smax, const float* __restrict__ dsub,
    const float* __restrict__ slab, const float* __restrict__ lum,
    const float* __restrict__ tau_int, const int* __restrict__ bin_map,
    const int* __restrict__ cellmap, float inv_sqrt, Acc* __restrict__ rf,
    int* __restrict__ hitrun, int B, int nmax, int run, int n_groups,
    int rows) {
  const long long idx = (long long)blockIdx.x * kXlDepThreads + threadIdx.x;
  const int runs = (nmax + run - 1) / run;
  if (idx >= (long long)runs * B) return;
  const int q = (int)(idx / B);
  const int lane = (int)(idx - (long long)q * B);
  const int ra = q * run;
  const float inf = __int_as_float(0x7f800000);

  // the hit search (mode 1) on every slab of the run, in geometric order:
  // resolve_interaction's test, tau_int - tb >= 0 and tau_int below the
  // next slab's prefix along the ray; the first hit ends it. The prefix
  // is read kHitChunk slabs at a time, so that as many loads are in flight
  if (kMode == kXlDepPrefix) {
    const float ti = tau_int[lane];
    const bool up = dir[3 * lane + axis[lane]] > 0.0f;
    float prev = ra > 0 ? slab[(size_t)(ra - 1) * B + lane] : inf;
    float cur = slab[(size_t)ra * B + lane];
    int first = nmax;
    const int rb = min(ra + run, nmax);
    for (int c = ra; c < rb && first == nmax; c += kHitChunk) {
      float next[kHitChunk];  // tb of slab t + 1, +inf past the last
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
  // the deposits of the lanes with a scale, on the slabs the ray can cross
  const int grp = lane / (B / n_groups);
  int row = grp;
  float lm = 0.0f;
  if (kMode == kXlDepPrefix) {
    if (rf == nullptr) return;
    lm = lum[lane];
    if (bin_map != nullptr) row = bin_map[grp];
    if (lm == 0.0f || row < 0 || row >= rows) return;
  }
  // no cross sections: C = 0 reads none
  const Lane L = load_lane(g, pos, dir, axis, smin, smax, nullptr, 0, B, lane);
  int t0, t1;
  slab_range(L, t0, t1);
  const long long ncells = (long long)g.nx * g.ny * g.nz;
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
      if (contrib != 0.0f) {
        if (kMode == kXlDepTables) {
          atomicAdd(rf + grp * ncells + cell, (Acc)contrib);
        } else {
          const long long c = cellmap != nullptr ? cellmap[cell] : cell;
          if (c >= 0) atomicAdd(rf + c * rows + row, (Acc)contrib);
        }
      }
      tau_loc = tau_loc + dtau;
    }
  }
}

// Pass B (mode 1), one thread per lane: the lowest hit slab over the runs
// (slab 0 where none, as argmax finds it), that slab's sub-steps and the
// lane's interaction. active: (B,) bytes, the lanes that may interact;
// icell: int64; found: bytes.
__global__ void __launch_bounds__(kXlDepThreads) sweepxl_resolve_kernel(
    GridGeom g, const float* __restrict__ pos, const float* __restrict__ dir,
    const int* __restrict__ axis, const float* __restrict__ smin,
    const float* __restrict__ smax, const float* __restrict__ dsub,
    const float* __restrict__ tb, const float* __restrict__ tau_int,
    const unsigned char* __restrict__ active,
    const int* __restrict__ hitrun, int runs, float* __restrict__ s_int,
    long long* __restrict__ icell, unsigned char* __restrict__ found, int B,
    int nmax) {
  const int lane = blockIdx.x * kXlDepThreads + threadIdx.x;
  if (lane >= B) return;
  int th = nmax;
  for (int q = 0; q < runs; ++q) th = min(th, hitrun[(size_t)q * B + lane]);
  const bool any = th < nmax;
  const int t = any ? th : 0;
  const Lane L = load_lane(g, pos, dir, axis, smin, smax, nullptr, 0, B, lane);
  const float rel = tau_int[lane] - tb[(size_t)t * B + lane];
  const float* d = dsub + (size_t)t * 3 * B + lane;
  Slab S = enter_slab(L, t);
  float cum = 0.0f, s = 0.0f;
  int c = -1;
  bool got = false;
  for (int j = 0; j < 3; ++j) {
    const float s_cur = S.s_cur;
    float ds;
    int cell;
    sub_step(L, t, S, ds, cell);
    const float dj = d[(size_t)j * B];
    if (!got && rel >= cum && rel < cum + dj) {
      s = s_cur + ((rel - cum) / fmaxf(dj, 1e-37f)) * ds;
      c = cell;
      got = true;
    }
    cum = cum + dj;
  }
  const bool f = any && active[lane] != 0 && got;
  s_int[lane] = s;
  icell[lane] = f ? c : -1;
  found[lane] = f ? 1 : 0;
}

}  // namespace skirt9

// Both passes on one stream.
extern "C" int sweepxl_deposit_launch(
    const void* pos, const void* dir, const void* axis, const void* smin,
    const void* smax, const void* dsub, const void* slab, const void* lum,
    const void* tau_int, const void* active, const void* bin_map,
    const void* cellmap, void* rf, void* hitrun, void* s_int, void* icell,
    void* found, int B, int nx, int ny, int nz, int nmax, int n_groups,
    int rows, int run, int mode, float lox, float loy, float loz, float hx,
    float hy, float hz, float inv_sqrt, void* stream) {
  using namespace skirt9;
  const bool tables = mode == kXlDepTables && rf != nullptr;
  const bool prefix = mode == kXlDepPrefix && tau_int != nullptr &&
                      active != nullptr && hitrun != nullptr &&
                      s_int != nullptr && icell != nullptr &&
                      found != nullptr && (rf == nullptr) == (lum == nullptr) &&
                      rows >= 1;
  if (B <= 0 || nmax < 1 || run < 1 || slab == nullptr || n_groups < 1 ||
      B % n_groups != 0 || (!tables && !prefix))
    return (int)cudaErrorInvalidValue;
  GridGeom g{nx, ny, nz, {lox, loy, loz}, {hx, hy, hz}};
  cudaStream_t s = (cudaStream_t)stream;
  const int runs = (nmax + run - 1) / run;
  const long long threads = (long long)runs * B;
  const unsigned blocks =
      (unsigned)((threads + kXlDepThreads - 1) / kXlDepThreads);
  const auto pass_a = [&](auto kernel, auto* acc) {
    kernel<<<blocks, kXlDepThreads, 0, s>>>(
        g, (const float*)pos, (const float*)dir, (const int*)axis,
        (const float*)smin, (const float*)smax, (const float*)dsub,
        (const float*)slab, (const float*)lum, (const float*)tau_int,
        (const int*)bin_map, (const int*)cellmap, inv_sqrt, acc,
        (int*)hitrun, B, nmax, run, n_groups, rows);
  };
  if (tables) {
    pass_a(sweepxl_deposit_kernel<kXlDepTables, float>, (float*)rf);
    return (int)cudaGetLastError();
  }
  pass_a(sweepxl_deposit_kernel<kXlDepPrefix, double>, (double*)rf);
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
