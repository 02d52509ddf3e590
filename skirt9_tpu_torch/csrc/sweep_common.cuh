// Shared per-lane geometry and per-slab sub-DDA of the slab-sweep kernels
// (sweep_dtau.cu, sweep_deposit.cu, sweepxl_dtau.cu, sweepxl_deposit.cu,
// mlsweep_dtau.cu, mlsweep_deposit.cu), the per-lane pass of the prefix
// modes (sweepxl_dtau.cu, mlsweep_dtau.cu), and the lane tile of the two
// deposit kernels (sweep_deposit.cu, mlsweep_deposit.cu).
//
// A lane marches the slabs of its dominant axis a; inside slab t the ray
// crosses at most 3 cells, enumerated by a bounded sub-DDA over the two minor
// axes (u, v) = (y, z), (x, z), (x, y) for a = 0, 1, 2. The arithmetic is the
// reference's (skirt9_tpu/transport/sweep.py `_slab_entry`, `_minor_idx`,
// `_minor_crossing`), operation for operation and in the same order; the
// library is built with -fmad=false so no a*b+c is contracted into an FMA.
// Density comes straight from the flat (ncells, C) table, cell =
// (ix*ny + iy)*nz + iz.
#pragma once

#include <cuda_runtime.h>

namespace skirt9 {

constexpr float kBig = 3e37f;
constexpr int kMaxComp = 4;

struct Lane {
  float pa, da, loa, ha, inv_da;  // dominant (major) axis
  float pu, du, lou, hu;          // minor axis u
  float pv, dv, lov, hv;          // minor axis v
  int na, nu, nv;                 // cells along a, u, v
  int t_stride, u_stride, v_stride;
  bool tiny_a, tiny_u, tiny_v;
  float smin, smax;               // in-grid path range
  float sig[kMaxComp];            // per-component cross sections
};

struct GridGeom {
  int nx, ny, nz;
  float lo[3], h[3];
};

// The grid at granularity 2^gs (the tree sweep's coarse plan steps): cell
// sizes x 2^gs, counts >> gs; exact, since the fine counts are powers of two
// and scaling by a power of two does not round.
__device__ __forceinline__ GridGeom coarsen(const GridGeom& g, int gs) {
  const float s = (float)(1 << gs);
  return GridGeom{g.nx >> gs, g.ny >> gs, g.nz >> gs,
                  {g.lo[0], g.lo[1], g.lo[2]},
                  {g.h[0] * s, g.h[1] * s, g.h[2] * s}};
}

__device__ __forceinline__ float sel3(int a, float x0, float x1, float x2) {
  return a == 0 ? x0 : (a == 1 ? x1 : x2);
}

__device__ __forceinline__ int sel3i(int a, int x0, int x1, int x2) {
  return a == 0 ? x0 : (a == 1 ? x1 : x2);
}

// The lane at granularity 2^gs, as make_lane builds it on coarsen(g, gs):
// cell sizes x 2^gs (exact), counts >> gs. The strides stay the fine
// grid's; the tree kernels take cells from the leaf map, not from them.
__device__ __forceinline__ Lane coarsen_lane(Lane L, int gs) {
  const float s = (float)(1 << gs);
  L.ha = L.ha * s;
  L.hu = L.hu * s;
  L.hv = L.hv * s;
  L.na >>= gs;
  L.nu >>= gs;
  L.nv >>= gs;
  return L;
}

// The geometry of a ray (px, py, pz) + s (dx, dy, dz) marching the slabs of
// axis a; the caller sets smin, smax and sig.
__device__ inline Lane make_lane(const GridGeom& g, int a, float px, float py,
                                 float pz, float dx, float dy, float dz) {
  Lane L;
  L.pa = sel3(a, px, py, pz);
  L.da = sel3(a, dx, dy, dz);
  L.loa = sel3(a, g.lo[0], g.lo[1], g.lo[2]);
  L.ha = sel3(a, g.h[0], g.h[1], g.h[2]);
  L.na = sel3i(a, g.nx, g.ny, g.nz);
  L.pu = sel3(a, py, px, px);
  L.du = sel3(a, dy, dx, dx);
  L.lou = sel3(a, g.lo[1], g.lo[0], g.lo[0]);
  L.hu = sel3(a, g.h[1], g.h[0], g.h[0]);
  L.nu = sel3i(a, g.ny, g.nx, g.nx);
  L.pv = sel3(a, pz, pz, py);
  L.dv = sel3(a, dz, dz, dy);
  L.lov = sel3(a, g.lo[2], g.lo[2], g.lo[1]);
  L.hv = sel3(a, g.h[2], g.h[2], g.h[1]);
  L.nv = sel3i(a, g.nz, g.nz, g.ny);
  L.t_stride = sel3i(a, g.ny * g.nz, g.nz, 1);
  L.u_stride = sel3i(a, g.nz, g.ny * g.nz, g.ny * g.nz);
  L.v_stride = sel3i(a, 1, 1, g.nz);
  L.tiny_a = fabsf(L.da) < 1e-30f;
  L.tiny_u = fabsf(L.du) < 1e-30f;
  L.tiny_v = fabsf(L.dv) < 1e-30f;
  L.inv_da = 1.0f / (L.tiny_a ? 1.0f : L.da);
  return L;
}

// pos, dir: (B, 3); axis, smin, smax: (B,); sig: (C, B)
__device__ inline Lane load_lane(const GridGeom& g, const float* pos,
                                 const float* dir, const int* axis,
                                 const float* smin, const float* smax,
                                 const float* sig, int C, int B, int lane) {
  Lane L = make_lane(g, axis[lane], pos[3 * lane], pos[3 * lane + 1],
                     pos[3 * lane + 2], dir[3 * lane], dir[3 * lane + 1],
                     dir[3 * lane + 2]);
  L.smin = smin[lane];
  L.smax = smax[lane];
#pragma unroll
  for (int c = 0; c < kMaxComp; ++c) L.sig[c] = c < C ? sig[c * B + lane] : 0.0f;
  return L;
}

// The lane's slab axis (argmax |d_i| / h_i, first maximum on ties, unless
// hint >= 0 names it) and in-grid path range [smin, smax], smax = smin for an
// inactive lane: sweep.py `dominant_axis` and `_lane_range`, operation for
// operation. Kernels 1 and 6 form their lanes with it.
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

// The lane of ray `lane` with its axis and range formed here (lane_range):
// pos, dir (B, 3), active (B,) bytes, sig (C, B). Kernels 4 and 6 form
// their lanes with it; a is the lane's slab axis.
__device__ inline Lane form_lane(const GridGeom& g, const float inv_h[3],
                                 const float* pos, const float* dir,
                                 const unsigned char* active,
                                 const float* sig, int hint, int C, int B,
                                 int lane, int& a) {
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

// The per-lane pass of the prefix modes (kernels 4 and 6): the lane's total
// optical depth, its run sums runsum[q * B + lane] (q < runs, in slab
// order) added in ray order; then, where prefix is given, the optical
// depth before each of its n slabs or plan steps in ray order from their
// sums, as sweep.py `slab_prefix` forms it: a running sum in slab order
// along the ray, total - sum - dtau against it. sums may be prefix itself
// (the prefix is then formed in place).
__device__ inline void scan_lane(const float* runsum, int runs,
                                 const float* sums, float* prefix,
                                 float* total, int n, int B, int lane,
                                 bool up) {
  float tot = 0.0f;
  for (int q = 0; q < runs; ++q)
    tot = tot + runsum[(size_t)(up ? q : runs - 1 - q) * B + lane];
  total[lane] = tot;
  if (prefix == nullptr) return;
  float sum = 0.0f;
#pragma unroll 8
  for (int t = 0; t < n; ++t) {
    const float dt = sums[(size_t)t * B + lane];
    prefix[(size_t)t * B + lane] = up ? sum : (tot - sum) - dt;
    sum = sum + dt;
  }
}

// One slab's sub-DDA state.
struct Slab {
  float s_in, s_out, s_cur;
  int iu, iv;
  bool act;
};

__device__ __forceinline__ int minor_index(float p, float d, float lo, float h,
                                           int n, float s) {
  // clamp in float first: the same result as int conversion + clip, without
  // relying on out-of-range conversion behaviour
  const float i = floorf((p + s * d - lo) / h);
  return (int)fminf(fmaxf(i, 0.0f), (float)(n - 1));
}

// Entry [s_in, s_out) of the ray into slab t, clipped to [smin, smax), and
// the minor cell at a point nudged 1e-4 of the span inside.
__device__ inline Slab enter_slab(const Lane& L, int t) {
  Slab S;
  const float b0 = L.loa + (float)t * L.ha;
  const float s0 = (b0 - L.pa) * L.inv_da;
  const float s1 = (b0 + L.ha - L.pa) * L.inv_da;
  S.s_in = fmaxf(L.tiny_a ? L.smin : fminf(s0, s1), L.smin);
  S.s_out = fminf(L.tiny_a ? L.smax : fmaxf(s0, s1), L.smax);
  S.act = S.s_in < S.s_out;
  const float s = S.s_in + 1e-4f * (S.s_out - S.s_in);
  S.iu = minor_index(L.pu, L.du, L.lou, L.hu, L.nu, s);
  S.iv = minor_index(L.pv, L.dv, L.lov, L.hv, L.nv, s);
  S.s_cur = S.s_in;
  return S;
}

// One sub-step of the slab's DDA: the segment length ds and cell of the
// current minor cell, then advance to the next one.
__device__ inline void sub_step(const Lane& L, int t, Slab& S, float& ds,
                                int& cell) {
  const float bu = L.lou + (float)(S.iu + (L.du > 0.0f ? 1 : 0)) * L.hu;
  const float bv = L.lov + (float)(S.iv + (L.dv > 0.0f ? 1 : 0)) * L.hv;
  const float su = L.tiny_u ? kBig : (bu - L.pu) / L.du;
  const float sv = L.tiny_v ? kBig : (bv - L.pv) / L.dv;
  const float s_nxt = fminf(fminf(su, sv), S.s_out);
  ds = fmaxf(s_nxt - S.s_cur, 0.0f) * (S.act ? 1.0f : 0.0f);
  cell = t * L.t_stride + S.iu * L.u_stride + S.iv * L.v_stride;
  if (su <= sv) {
    S.iu = min(max(S.iu + (L.du > 0.0f ? 1 : -1), 0), L.nu - 1);
  } else {
    S.iv = min(max(S.iv + (L.dv > 0.0f ? 1 : -1), 0), L.nv - 1);
  }
  S.s_cur = s_nxt;
}

// Extinction coefficient sum_c nd[cell, c] * sig_c, summed in component order.
__device__ __forceinline__ float opacity(const Lane& L, const float* nd,
                                         int cell, int C) {
  const float* row = nd + (size_t)cell * C;
  float k = row[0] * L.sig[0];
#pragma unroll
  for (int c = 1; c < kMaxComp; ++c) {
    if (c < C) k = k + row[c] * L.sig[c];
  }
  return k;
}

// Slabs [t0, t1] the ray can cross inside [smin, smax): the slabs of its
// entry and exit points with one slab of margin each side; none for an
// inactive lane, all of the axis where the estimate is not finite.
__device__ inline void slab_range(const Lane& L, int& t0, int& t1) {
  t0 = 0;
  t1 = L.na - 1;
  if (!(L.smin < L.smax)) {
    t1 = -1;
    return;
  }
  if (L.tiny_a) return;
  const float f0 = (L.pa + L.smin * L.da - L.loa) / L.ha;
  const float f1 = (L.pa + L.smax * L.da - L.loa) / L.ha;
  if (!isfinite(f0) || !isfinite(f1)) return;
  t0 = (int)fminf(fmaxf(floorf(fminf(f0, f1)) - 1.0f, 0.0f), (float)L.na);
  t1 = (int)fmaxf(fminf(floorf(fmaxf(f0, f1)) + 1.0f, (float)(L.na - 1)),
                  -1.0f);
}

// (1 - e^-dtau) / dtau: the exact integral of e^-tau over a segment per unit
// dtau; below dtau = 1e-3 the series form avoids the cancellation in
// 1 - e^-dtau.
__device__ __forceinline__ float segment_factor(float dtau) {
  return dtau < 1e-3f ? 1.0f - 0.5f * dtau
                      : (1.0f - expf(-fminf(dtau, 80.0f))) / fmaxf(dtau, 1e-37f);
}

// ------------------------------------------------ the deposit kernels' tile
//
// A block of kTile x kWarps threads takes a tile of kTile lanes. Lane l of
// the tile covers the steps [range[l][0], range[l][1]] (slabs, or plan
// steps on trees; none where the end lies before the start). The tile's
// (step, lane) items are listed step-major: the items of step base + i are
// the lanes set in mask[i], in lane order, and start[i] items come before
// them. Consecutive threads then take consecutive lanes of one step, so
// their per-(step, lane) reads coalesce, and steps a lane does not cover
// cost nothing.

constexpr int kTile = 32;   // lanes per tile: one warp's width
constexpr int kWarps = 8;   // warps per block
constexpr unsigned kFull = 0xffffffffu;

struct TileSteps {
  unsigned* mask;  // [steps] lanes covering step base + i
  int* start;      // [steps + 1] items before step base + i
  int base, n, items;
};

// Build the tile's item list; every thread of the block calls, after warp
// 0 has written range[x] for its lane x. hdr: two ints of shared memory.
__device__ inline TileSteps tile_steps(const int (*range)[2], unsigned* mask,
                                       int* start, int* hdr) {
  const int x = threadIdx.x, y = threadIdx.y;
  __syncthreads();
  if (y == 0) {
    const bool any = range[x][0] <= range[x][1];
    const int lo = __reduce_min_sync(kFull, any ? range[x][0] : 0x7fffffff);
    const int hi = __reduce_max_sync(kFull, any ? range[x][1] : -1);
    if (x == 0) {
      hdr[0] = lo;
      hdr[1] = hi >= lo ? hi - lo + 1 : 0;
    }
  }
  __syncthreads();
  TileSteps T{mask, start, hdr[0], hdr[1], 0};
  for (int i = y; i < T.n; i += kWarps) {
    const int s = T.base + i;
    const unsigned m =
        __ballot_sync(kFull, range[x][0] <= s && s <= range[x][1]);
    if (x == 0) mask[i] = m;
  }
  __syncthreads();
  if (y == 0) {
    // start = exclusive prefix sum of the masks' counts, 32 steps at a time
    int carry = 0;
    for (int c = 0; c < T.n; c += kTile) {
      const int i = c + x;
      int v = i < T.n ? __popc(mask[i]) : 0;
      for (int off = 1; off < kTile; off <<= 1) {
        const int u = __shfl_up_sync(kFull, v, off);
        if (x >= off) v += u;
      }
      if (i < T.n) start[i + 1] = carry + v;
      carry += __shfl_sync(kFull, v, kTile - 1);
    }
    if (x == 0) start[0] = 0;
  }
  __syncthreads();
  T.items = start[T.n];
  return T;
}

// Position of the k-th set bit (from 0) of m, which has more than k.
__device__ __forceinline__ int nth_set_bit(unsigned m, int k) {
  int p = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const int c = __popc((m >> p) & ((1u << w) - 1u));
    if (k >= c) {
      k -= c;
      p += w;
    }
  }
  return p;
}

// Item w < T.items of the tile: its step index i (step T.base + i) and its
// lane l in the tile.
__device__ inline void tile_item(const TileSteps& T, int w, int& i, int& l) {
  int lo = 0, hi = T.n;  // start[lo] <= w < start[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (T.start[mid] <= w) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  i = lo;
  l = nth_set_bit(T.mask[lo], w - T.start[lo]);
}

// Sum v over the warp's lanes with an equal key >= 0, in lane order, and
// hand each group's sum to add(key, sum) once, from the group's first lane.
// All 32 lanes of the warp call (key -1: nothing to add); scratch holds 32
// values for this warp.
template <typename T, typename Add>
__device__ inline void warp_add(int key, T v, T* scratch, Add add) {
  if (__ballot_sync(kFull, key >= 0) == 0) return;
  const unsigned peers = __match_any_sync(kFull, key);
  const int x = threadIdx.x;
  scratch[x] = v;
  __syncwarp();
  if (key >= 0 && x == __ffs(peers) - 1) {
    T sum = 0;
    for (unsigned m = peers; m != 0; m &= m - 1) sum += scratch[__ffs(m) - 1];
    add(key, sum);
  }
  __syncwarp();
}

}  // namespace skirt9
