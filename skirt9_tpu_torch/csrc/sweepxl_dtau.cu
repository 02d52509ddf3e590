// Pass 1 of the large-grid (XL) sweep: optical depth per (slab, lane), or per
// (slab, sub-step, lane).
//
// Replaces the Pallas TPU kernel skirt9_tpu/transport/sweepxl.py
// `_xl_dtau_kernel` (wrapper `sweep_dtau`). Contract: for t < nmax, the
// sub-step j <= 2 of the ray of `lane` in slab t of its dominant axis
// contributes sum_c nd[cell, c] * sig[c, lane] * ds. With want_sub the kernel
// writes each sub-step, out[(t * 3 + j) * B + lane] (the record that lets the
// deposit pass and the interaction search run without the density);
// otherwise it writes their sum, out[t * B + lane]. Inactive lanes and slabs
// the ray misses write exact zeros. The TPU kernel's per-block slab windows
// and occupied-slab clip (sweepxl.py:324-339, :426-431) only skip work whose
// result is zero, so they have no counterpart here.
//
// What bounds it on the H100: at 256^3 the f32 density table is 67 MB, more
// than the 50 MB L2, so density gathers can go to HBM; each sub-step's gather
// depends on the previous sub-step's cell. The want_sub record is
// nmax * 3 * B * 4 bytes (403 MB at 256^3, B = 131072), written once.
// Design: the arithmetic and per-lane geometry are kernel 1's
// (sweep_common.cuh). One thread per (slab, lane), index t * B + lane, so a
// warp covers 32 consecutive lanes of one slab, the record stores coalesce,
// and the threads in flight at any moment cover one or two slabs: the cells
// they touch lie in those slabs, a few MB, which L2 holds. The caller sorts
// lanes by (axis, major sign, entry slab) (sweepxl.lane_order), which keeps a
// warp on one slab layout, on nearby cells, and active or inactive together.
// The TPU kernel's streamed (U, V) planes, bf16/int8 splits and one-hot MXU
// lookups are not needed: the table is read by plain gathers.
#include "sweep_common.cuh"

namespace skirt9 {

__global__ void sweepxl_dtau_kernel(GridGeom g, const float* __restrict__ pos,
                                    const float* __restrict__ dir,
                                    const int* __restrict__ axis,
                                    const float* __restrict__ smin,
                                    const float* __restrict__ smax,
                                    const float* __restrict__ sig,
                                    const float* __restrict__ nd,
                                    float* __restrict__ out, int B, int C,
                                    int nmax, int want_sub) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)nmax * B) return;
  const int t = (int)(idx / B);
  const int lane = (int)(idx - (long long)t * B);
  const Lane L = load_lane(g, pos, dir, axis, smin, smax, sig, C, B, lane);
  float d[3] = {0.0f, 0.0f, 0.0f};
  if (t < L.na) {
    Slab S = enter_slab(L, t);
    if (S.act) {
      for (int j = 0; j < 3; ++j) {
        float ds;
        int cell;
        sub_step(L, t, S, ds, cell);
        d[j] = opacity(L, nd, cell, C) * ds;
      }
    }
  }
  if (want_sub) {
    float* o = out + (long long)t * 3 * B + lane;
    o[0] = d[0];
    o[B] = d[1];
    o[2 * (long long)B] = d[2];
  } else {
    // (d0 + d1) + d2, the order of kernel 1 and of the plain version
    out[idx] = d[0] + d[1] + d[2];
  }
}

}  // namespace skirt9

extern "C" int sweepxl_dtau_launch(const void* pos, const void* dir,
                                   const void* axis, const void* smin,
                                   const void* smax, const void* sig,
                                   const void* nd, void* out, int B, int C,
                                   int nx, int ny, int nz, int nmax,
                                   int want_sub, float lox, float loy,
                                   float loz, float hx, float hy, float hz,
                                   void* stream) {
  if (B <= 0 || C < 1 || C > skirt9::kMaxComp) return (int)cudaErrorInvalidValue;
  skirt9::GridGeom g{nx, ny, nz, {lox, loy, loz}, {hx, hy, hz}};
  const long long total = (long long)nmax * B;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  skirt9::sweepxl_dtau_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      g, (const float*)pos, (const float*)dir, (const int*)axis,
      (const float*)smin, (const float*)smax, (const float*)sig,
      (const float*)nd, (float*)out, B, C, nmax, want_sub);
  return (int)cudaGetLastError();
}
