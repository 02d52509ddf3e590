// Pass 2 of the large-grid (XL) sweep: radiation-field deposits from the
// recorded per-sub-step optical depths, with no density access.
//
// Replaces the Pallas TPU kernel skirt9_tpu/transport/sweepxl.py
// `_xl_deposit_kernel` (wrapper `sweep_deposit`). Contract: for every
// sub-step j of slab t of the ray of `lane`, with dtau = dsub[(t * 3 + j) * B
// + lane] and tau_loc the sum of the slab's earlier sub-steps, add
// scale[t * B + lane] * e^-tau_loc * ds * (1 - e^-dtau) / dtau into
// rf[group * ncells + cell], group = lane / (B / n_groups). The interaction
// point is resolved outside the kernel (sweepxl.resolve_interaction).
//
// What bounds it on the H100: float atomics into the RF table (67 MB at
// 256^3), contended where many lanes cross one cell (every packet starts at
// the source in the first event), plus the re-derived sub-DDA arithmetic.
// The record read is nmax * 4 * B * 4 bytes (537 MB at 256^3, B = 131072),
// read once and coalesced. Design: one thread per (slab, lane), index
// t * B + lane as in pass 1; each thread re-derives its <= 3 cells from
// pos/dir (sweep_common.cuh) and atomicAdds each nonzero contribution
// straight into the flat RF. A zero scale (no RF stored for the lane, or an
// inactive lane) returns before any work. The TPU kernel's (group, slab,
// axis, U, V) plane accumulator, its decode and the one-hot matmul pair are
// replaced by these atomics; float atomics make the RF sums order-dependent
// from run to run. Offsets are 64-bit: n_groups * ncells passes 2^31 at
// 512^3 with 16 groups, and nmax * 3 * B at 512 slabs with B >= 2^21.
#include "sweep_common.cuh"

namespace skirt9 {

__global__ void sweepxl_deposit_kernel(
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
  // no cross sections: C = 0 reads none
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

}  // namespace skirt9

extern "C" int sweepxl_deposit_launch(const void* pos, const void* dir,
                                      const void* axis, const void* smin,
                                      const void* smax, const void* dsub,
                                      const void* scale, void* rf, int B,
                                      int nx, int ny, int nz, int nmax,
                                      int n_groups, float lox, float loy,
                                      float loz, float hx, float hy, float hz,
                                      void* stream) {
  if (B <= 0 || n_groups < 1 || B % n_groups != 0)
    return (int)cudaErrorInvalidValue;
  skirt9::GridGeom g{nx, ny, nz, {lox, loy, loz}, {hx, hy, hz}};
  const long long total = (long long)nmax * B;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  skirt9::sweepxl_deposit_kernel<<<blocks, threads, 0,
                                   (cudaStream_t)stream>>>(
      g, (const float*)pos, (const float*)dir, (const int*)axis,
      (const float*)smin, (const float*)smax, (const float*)dsub,
      (const float*)scale, (float*)rf, B, nmax, n_groups);
  return (int)cudaGetLastError();
}
