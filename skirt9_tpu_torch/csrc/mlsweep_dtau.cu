// Pass 1 of the tree-grid (multi-level) sweep: optical depth per (plan step,
// lane), or per (plan step, sub-step, lane) with the leaf id of each
// sub-step.
//
// Replaces the Pallas TPU kernel skirt9_tpu/transport/mlsweep.py
// `_ml_dtau_kernel` (wrapper `sweep_dtau`). Contract: plan step st marches
// slab tlev = step_tlev[st] of the fine grid coarsened by gs = step_gs[st]
// along the lane's axis a, with the <= 3-cell sub-DDA of kernels 1 and 6
// (sweep_common.cuh) on the coarsened geometry. Sub-step j at minor cell
// (iu, iv) lies in fine voxel (tlev, iu, iv) << gs of layout a, mapped to
// (x, y, z) (a=0: (t, u, v) = (x, y, z); a=1: (y, x, z); a=2: (z, x, y)),
// whose leaf is cell = leafmap[(x * nfy + y) * nfz + z]. It contributes
// sum_c nd[cell, c] * sig[c, lane] * ds, or 0 for cell -1. One lookup is
// exact: the plan never lets a step at granularity gs straddle a leaf
// boundary (mlsweep._make_plan). With want_sub the kernel writes each
// sub-step, out/cells[(st * 3 + j) * B + lane], cell -1 where the slab is
// missed; otherwise their sum (d0 + d1) + d2, out[st * B + lane].
//
// What bounds it on the H100: two dependent gathers per sub-step (the leaf
// map, then the density row), about 3 * n_steps * B of them; the leaf map
// (8 MB at a 128^3 raster, 67 MB at 256^3) and the density (20 kB to 0.6 MB)
// sit in or near the 50 MB L2. The want_sub record is 2 * n_steps * 3 * B *
// 4 bytes (201 MB at n_steps = 128, B = 65536), written once and coalesced.
// Design: one thread per (step, lane), index st * B + lane, so a warp covers
// 32 lanes of one step and the record stores coalesce. The TPU kernel's
// per-level density planes, the -1 non-leaf flag, the select loop over
// (level, layout, row) and the packed deposit encoding are replaced by the
// one leaf-map gather.
#include "sweep_common.cuh"

namespace skirt9 {

__device__ __forceinline__ int leaf_at(const int* __restrict__ leafmap,
                                       const GridGeom& f, int a, int tf,
                                       int uf, int vf) {
  const int x = a == 0 ? tf : uf;
  const int y = a == 0 ? uf : (a == 1 ? tf : vf);
  const int z = a == 2 ? tf : vf;
  return leafmap[((long long)x * f.ny + y) * f.nz + z];
}

__global__ void mlsweep_dtau_kernel(
    GridGeom f, const float* __restrict__ pos, const float* __restrict__ dir,
    const int* __restrict__ axis, const float* __restrict__ smin,
    const float* __restrict__ smax, const float* __restrict__ sig,
    const float* __restrict__ nd, const int* __restrict__ leafmap,
    const int* __restrict__ step_tlev, const int* __restrict__ step_gs,
    float* __restrict__ out, int* __restrict__ cells, int B, int C,
    int n_steps, int want_sub) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n_steps * B) return;
  const int st = (int)(idx / B);
  const int lane = (int)(idx - (long long)st * B);
  const int tlev = step_tlev[st];
  const int gs = step_gs[st];
  const Lane L = load_lane(coarsen(f, gs), pos, dir, axis, smin, smax, sig, C,
                           B, lane);
  float d[3] = {0.0f, 0.0f, 0.0f};
  int c[3] = {-1, -1, -1};
  if (tlev < L.na) {
    Slab S = enter_slab(L, tlev);
    if (S.act) {
      const int a = axis[lane];
      for (int j = 0; j < 3; ++j) {
        const int uf = S.iu << gs, vf = S.iv << gs;
        float ds;
        int coarse_cell;
        sub_step(L, tlev, S, ds, coarse_cell);
        c[j] = leaf_at(leafmap, f, a, tlev << gs, uf, vf);
        if (c[j] >= 0) d[j] = opacity(L, nd, c[j], C) * ds;
      }
    }
  }
  if (want_sub) {
    const long long o = (long long)st * 3 * B + lane;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      out[o + (long long)j * B] = d[j];
      cells[o + (long long)j * B] = c[j];
    }
  } else {
    out[idx] = d[0] + d[1] + d[2];
  }
}

}  // namespace skirt9

extern "C" int mlsweep_dtau_launch(const void* pos, const void* dir,
                                   const void* axis, const void* smin,
                                   const void* smax, const void* sig,
                                   const void* nd, const void* leafmap,
                                   const void* step_tlev, const void* step_gs,
                                   void* out, void* cells, int B, int C,
                                   int nx, int ny, int nz, int n_steps,
                                   int want_sub, float lox, float loy,
                                   float loz, float hx, float hy, float hz,
                                   void* stream) {
  if (B <= 0 || n_steps <= 0 || C < 1 || C > skirt9::kMaxComp)
    return (int)cudaErrorInvalidValue;
  skirt9::GridGeom g{nx, ny, nz, {lox, loy, loz}, {hx, hy, hz}};
  const long long total = (long long)n_steps * B;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  skirt9::mlsweep_dtau_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      g, (const float*)pos, (const float*)dir, (const int*)axis,
      (const float*)smin, (const float*)smax, (const float*)sig,
      (const float*)nd, (const int*)leafmap, (const int*)step_tlev,
      (const int*)step_gs, (float*)out, (int*)cells, B, C, n_steps, want_sub);
  return (int)cudaGetLastError();
}
