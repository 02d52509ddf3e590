// Pass 2 of the slab sweep: radiation-field deposits and the interaction
// point.
//
// Replaces the Pallas TPU kernel skirt9_tpu/transport/sweep.py
// `_deposit_kernel` (wrapper `sweep_deposit`). Contract: for every cell a
// lane's ray crosses, add scale[t] * e^-tau_loc * ds * (1 - e^-dtau) / dtau
// (1 - dtau/2 below dtau = 1e-3) into rf[group, cell], group = lane /
// (B / n_groups); and report the first sub-segment, in slab order, where the
// slab-local cumulative tau crosses rel[t] = tau_int - tau before slab t:
// s_int (path length), icell, found.
//
// What bounds it on the H100: per lane, a serial chain of <= 3 * nmax
// dependent density gathers from L2 (the first hit in slab order needs the
// slabs in sequence), and float atomics into rf where many lanes share a cell
// (all packets start at the source in the first event). Design: one thread
// per lane walking its slabs in order, so the first hit needs no cross-thread
// reduction; deposits go straight to global memory with atomicAdd (L2
// atomics; zero contributions, e.g. when no RF is stored, issue none). The
// TPU kernel's one-hot MXU matmul pair is replaced by these atomics; float
// atomics make the rf sums order-dependent from run to run.
#include "sweep_common.cuh"

namespace skirt9 {

__global__ void sweep_deposit_kernel(
    GridGeom g, const float* __restrict__ pos, const float* __restrict__ dir,
    const int* __restrict__ axis, const float* __restrict__ smin,
    const float* __restrict__ smax, const float* __restrict__ sig,
    const float* __restrict__ scale, const float* __restrict__ rel,
    const float* __restrict__ nd, float* __restrict__ rf,
    float* __restrict__ s_int, int* __restrict__ icell,
    int* __restrict__ found, int B, int C, int nmax, int n_groups) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const Lane L = load_lane(g, pos, dir, axis, smin, smax, sig, C, B, lane);
  const int ncells = g.nx * g.ny * g.nz;
  float* rf_row = rf + (size_t)(lane / (B / n_groups)) * ncells;
  bool hit_any = false;
  float s_hit = 0.0f;
  int c_hit = -1;
  const int tmax = min(L.na, nmax);
  for (int t = 0; t < tmax; ++t) {
    Slab S = enter_slab(L, t);
    if (!S.act) continue;
    const float sc = scale[(size_t)t * B + lane];
    const float rl = rel[(size_t)t * B + lane];
    float tau_loc = 0.0f;
    for (int j = 0; j < 3; ++j) {
      const float s_cur = S.s_cur;
      float ds;
      int cell;
      sub_step(L, t, S, ds, cell);
      const float dtau = opacity(L, nd, cell, C) * ds;
      const float contrib = sc * expf(-tau_loc) * ds * segment_factor(dtau);
      if (contrib != 0.0f) atomicAdd(rf_row + cell, contrib);
      const float rem = rl - tau_loc;
      if (!hit_any && rem >= 0.0f && rem < dtau) {
        hit_any = true;
        s_hit = s_cur + rem / fmaxf(dtau, 1e-37f) * ds;
        c_hit = cell;
      }
      tau_loc = tau_loc + dtau;
    }
  }
  s_int[lane] = s_hit;
  icell[lane] = c_hit;
  found[lane] = hit_any ? 1 : 0;
}

}  // namespace skirt9

extern "C" int sweep_deposit_launch(
    const void* pos, const void* dir, const void* axis, const void* smin,
    const void* smax, const void* sig, const void* scale, const void* rel,
    const void* nd, void* rf, void* s_int, void* icell, void* found, int B,
    int C, int nx, int ny, int nz, int nmax, int n_groups, float lox,
    float loy, float loz, float hx, float hy, float hz, void* stream) {
  if (B <= 0 || C < 1 || C > skirt9::kMaxComp || n_groups < 1 ||
      B % n_groups != 0)
    return (int)cudaErrorInvalidValue;
  skirt9::GridGeom g{nx, ny, nz, {lox, loy, loz}, {hx, hy, hz}};
  const int threads = 128;
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  skirt9::sweep_deposit_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      g, (const float*)pos, (const float*)dir, (const int*)axis,
      (const float*)smin, (const float*)smax, (const float*)sig,
      (const float*)scale, (const float*)rel, (const float*)nd, (float*)rf,
      (float*)s_int, (int*)icell, (int*)found, B, C, nmax, n_groups);
  return (int)cudaGetLastError();
}
