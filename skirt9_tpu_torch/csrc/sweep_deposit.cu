// Pass 2 of the slab sweep: radiation-field deposits and the interaction
// point, in two input modes.
//
// Replaces the Pallas TPU kernel skirt9_tpu/transport/sweep.py
// `_deposit_kernel` (wrapper `sweep_deposit`). Contract: for every cell a
// lane's ray crosses, add scale[t] * e^-tau_loc * ds * (1 - e^-dtau) / dtau
// (1 - dtau/2 below dtau = 1e-3) into rf[row, cell]; and report the first
// sub-segment, in (slab, sub-step) order, where the slab-local cumulative
// tau crosses rel[t] = tau_int - tau before slab t: s_int (path length),
// icell, found. Mode 0 (`sweep_deposit`, the TPU kernel's contract) reads
// scale and rel as (nmax, B) tables, and row = the lane's group, lane /
// (B / n_groups). Mode 1 (`sweep_deposit_prefix`, the event loop's) forms
// them from pass 1's prefix tb (nmax, B) and per-lane lum, tau_int:
// scale = (lum * e^-tb) * inv_sqrt, rel = tau_int - tb, the loop's own f32
// operations in its order (the build's -fmad=false keeps them apart); and
// row = bin_map[group] when a bin map is given (an entry outside
// [0, rows), -1 among them, drops the group's deposits), so that the
// strata that share an RF bin add into one row. Both take pass 1's lane
// range (axis, smin, smax). rf starts at zero: the caller adds the call's
// rows into its run-long accumulator once.
//
// What bounds it on the H100: the density gathers and IEEE divisions of the
// sub-DDA on the (slab, lane) pairs the rays cross (47% of them at config
// 1), then the (nmax, B) input (16.8 MB at config 1 in mode 1, twice that
// in mode 0), and float atomics into rf where many lanes share a cell (all
// packets start at the source in the first event). Design: kernel 1's lane
// tile (sweep_common.cuh `tile_steps`). A block of 256 threads takes 32
// lanes, lists the slabs each ray can cross and spreads the (slab, lane)
// items over its threads slab-major, so missed slabs cost nothing, a long
// ray does not hold up its warp, and a warp reads 32 neighbouring lanes of
// one slab. Every item is independent, since pass 1's prefix gives each
// slab its scale and rel. The first hit per lane is a shared-memory
// 64-bit atomicMin on (t * 3 + j, bits of s), so it is the serial walk's
// whatever the thread order; warp 0 then re-walks the winning slab for the
// cell and stores the lane's results. Deposits are summed per warp by (row,
// cell) key (__match_any_sync) and each group adds once; a zero scale (no
// RF stored, a lane outside the RF's range) skips the contribution's
// arithmetic, and zero contributions issue no atomic. With an RF about half
// the time goes to these atomics (PERF.md §6): a crossed cell is one
// address, and a warp's lanes rarely share one outside the first event.
// Float atomics make the rf sums order-dependent from run to run.
#include "sweep_common.cuh"

namespace skirt9 {

enum : int { kModeTables = 0, kModePrefix = 1 };

// pos, dir: (B, 3); axis, smin, smax: (B,); sig: (C, B); nd: (ncells, C).
// Mode 0: slab_a = scale, slab_b = rel (nmax, B). Mode 1: slab_a = tb
// (nmax, B), lum and tau_int (B,), bin_map (n_groups,) or null.
// rf: (rows, ncells), zero on entry.
template <int kMode>
__global__ void __launch_bounds__(kTile* kWarps) sweep_deposit_kernel(
    GridGeom g, const float* __restrict__ pos, const float* __restrict__ dir,
    const int* __restrict__ axis, const float* __restrict__ smin,
    const float* __restrict__ smax, const float* __restrict__ sig,
    const float* __restrict__ slab_a, const float* __restrict__ slab_b,
    const float* __restrict__ lum, const float* __restrict__ tau_int,
    float inv_sqrt, const int* __restrict__ bin_map,
    const float* __restrict__ nd, float* __restrict__ rf,
    float* __restrict__ s_int, int* __restrict__ icell,
    int* __restrict__ found, int B, int C, int nmax, int n_groups,
    int rows) {
  extern __shared__ int dyn[];  // mask[nmax], start[nmax + 1]
  __shared__ Lane lanes[kTile];
  __shared__ int range[kTile][2];
  __shared__ int row_of[kTile];
  __shared__ float lum_s[kTile], tau_s[kTile];
  __shared__ unsigned long long hit[kTile];
  __shared__ float scratch[kWarps][kTile];
  __shared__ int hdr[2];
  const int x = threadIdx.x, y = threadIdx.y;
  const int first = blockIdx.x * kTile;
  const int lane = first + x;
  const bool valid = lane < B;
  const int ncells = g.nx * g.ny * g.nz;

  if (y == 0) {
    int t0 = 0, t1 = -1;
    if (valid) {
      const Lane L = load_lane(g, pos, dir, axis, smin, smax, sig, C, B, lane);
      slab_range(L, t0, t1);
      t1 = min(t1, min(L.na, nmax) - 1);
      lanes[x] = L;
      const int grp = lane / (B / n_groups);
      const int row = kMode == kModePrefix && bin_map != nullptr
                          ? bin_map[grp] : grp;
      row_of[x] = row < rows ? row : -1;
      if (kMode == kModePrefix) {
        lum_s[x] = lum[lane];
        tau_s[x] = tau_int[lane];
      }
    }
    range[x][0] = t0;
    range[x][1] = t1;
    hit[x] = ~0ull;
  }
  const TileSteps T = tile_steps(range, (unsigned*)dyn, dyn + nmax, hdr);

  float* rf_add = rf;
  const auto add = [rf_add](int key, float v) { atomicAdd(rf_add + key, v); };
  // base is uniform across the warp, so whole warps reach warp_add
  for (int base = y * kTile; base < T.items; base += kTile * kWarps) {
    const int w = base + x;
    int key[3] = {-1, -1, -1};
    float val[3] = {0.0f, 0.0f, 0.0f};
    if (w < T.items) {
      int i, l;
      tile_item(T, w, i, l);
      const int t = T.base + i;
      const Lane L = lanes[l];
      Slab S = enter_slab(L, t);
      if (S.act) {
        const size_t o = (size_t)t * B + first + l;
        float sc, rl;
        if (kMode == kModePrefix) {
          const float tb = slab_a[o], lm = lum_s[l];
          sc = lm != 0.0f ? (lm * expf(-tb)) * inv_sqrt : 0.0f;
          rl = tau_s[l] - tb;
        } else {
          sc = slab_a[o];
          rl = slab_b[o];
        }
        const int row = row_of[l];
        float tau_loc = 0.0f;
        bool got = false;
        for (int j = 0; j < 3; ++j) {
          const float s_cur = S.s_cur;
          float ds;
          int cell;
          sub_step(L, t, S, ds, cell);
          const float dtau = opacity(L, nd, cell, C) * ds;
          // a zero scale (no RF stored, a lane outside the RF's range)
          // makes every contribution zero: skip its arithmetic
          if (sc != 0.0f && row >= 0) {
            const float contrib =
                sc * expf(-tau_loc) * ds * segment_factor(dtau);
            if (contrib != 0.0f) {
              key[j] = row * ncells + cell;
              val[j] = contrib;
            }
          }
          const float rem = rl - tau_loc;
          if (!got && rem >= 0.0f && rem < dtau) {
            got = true;
            const float s = s_cur + rem / fmaxf(dtau, 1e-37f) * ds;
            atomicMin(hit + l, ((unsigned long long)(t * 3 + j) << 32) |
                                   __float_as_uint(s));
          }
          tau_loc = tau_loc + dtau;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) warp_add(key[j], val[j], scratch[y], add);
  }
  __syncthreads();

  if (y == 0 && valid) {
    const unsigned long long k = hit[x];
    float s = 0.0f;
    int c = -1;
    if (k != ~0ull) {
      // the winning sub-step's cell: re-walk its slab to sub-step j
      const int tj = (int)(k >> 32), t = tj / 3, j = tj - 3 * t;
      const Lane L = lanes[x];
      Slab S = enter_slab(L, t);
      float ds;
      for (int q = 0; q <= j; ++q) sub_step(L, t, S, ds, c);
      s = __uint_as_float((unsigned)k);
    }
    s_int[lane] = s;
    icell[lane] = c;
    found[lane] = k != ~0ull ? 1 : 0;
  }
}

}  // namespace skirt9

extern "C" int sweep_deposit_launch(
    const void* pos, const void* dir, const void* axis, const void* smin,
    const void* smax, const void* sig, const void* slab_a, const void* slab_b,
    const void* lum, const void* tau_int, const void* bin_map, const void* nd,
    void* rf, void* s_int, void* icell, void* found, int B, int C, int nx,
    int ny, int nz, int nmax, int n_groups, int rows, int mode, float lox,
    float loy, float loz, float hx, float hy, float hz, float inv_sqrt,
    void* stream) {
  using namespace skirt9;
  const long long ncells = (long long)nx * ny * nz;
  const bool tables = mode == kModeTables && slab_b != nullptr;
  const bool prefix = mode == kModePrefix && lum != nullptr &&
                      tau_int != nullptr;
  if (B <= 0 || C < 1 || C > kMaxComp || n_groups < 1 || B % n_groups != 0 ||
      nmax < 1 || rows < 1 || rows * ncells >= (1ll << 31) ||
      (!tables && !prefix) || (mode == kModeTables && rows != n_groups))
    return (int)cudaErrorInvalidValue;
  GridGeom g{nx, ny, nz, {lox, loy, loz}, {hx, hy, hz}};
  const size_t smem = (size_t)(2 * nmax + 1) * sizeof(int);
  const dim3 threads(kTile, kWarps);
  const unsigned blocks = (unsigned)((B + kTile - 1) / kTile);
  const auto launch = [&](auto kernel) {
    if (smem > 32 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
        g, (const float*)pos, (const float*)dir, (const int*)axis,
        (const float*)smin, (const float*)smax, (const float*)sig,
        (const float*)slab_a, (const float*)slab_b, (const float*)lum,
        (const float*)tau_int, inv_sqrt, (const int*)bin_map,
        (const float*)nd, (float*)rf, (float*)s_int, (int*)icell,
        (int*)found, B, C, nmax, n_groups, rows);
    return (int)cudaGetLastError();
  };
  return tables ? launch(sweep_deposit_kernel<kModeTables>)
                : launch(sweep_deposit_kernel<kModePrefix>);
}
