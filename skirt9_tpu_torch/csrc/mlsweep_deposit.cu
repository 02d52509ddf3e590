// Pass 2 of the tree-grid (multi-level) sweep: radiation-field deposits per
// leaf and the interaction point, from pass 1's per-sub-step record.
//
// Replaces the Pallas TPU kernel skirt9_tpu/transport/mlsweep.py
// `_ml_deposit_kernel` (wrapper `sweep_deposit`). Contract: plan step st of
// `lane` re-derives its <= 3 sub-segments (s_cur, ds) at the step's
// granularity, as pass 1 did, and reads their optical depth dtau and leaf id
// from the record, dsub/csub[(st * 3 + j) * B + lane]; it reads neither the
// density nor the leaf map. With scale = (lum[lane] * e^-tb[st, lane]) * inv2
// and tau_loc the sum of the step's earlier sub-steps, sub-step j adds the
// f32 contribution scale * e^-tau_loc * ds * (1 - e^-dtau) / dtau into the
// f64 rf[cell] (none for a zero contribution or cell -1; the wrapper rounds
// the table to f32 once), and is the interaction when rem = tau_int -
// tb - tau_loc lies in [0, dtau): s = s_cur + rem / dtau * ds. The crossing
// step is unique per lane up to rounding; to keep the first hit in (step,
// sub-step) order whatever the thread order, the hitting thread folds
// (st << 32 | bits of s) into first_hit[lane] with a 64-bit atomicMin, which
// the wrapper decodes. The interaction cell comes from the leaf map in the
// wrapper (mlsweep.locate_cells), as in the reference.
//
// What bounds it on the H100: atomics into the leaf RF. At about 5,000
// leaves (bench_config3ism) on the order of 10^7 additions per event land on
// few addresses, and the lanes of one plan step often cross the same coarse
// leaf: a coarse leaf gathers some 10^5 contributions per event, so an f32
// sum would lose about 1e-5 of it to rounding, hence the f64 table. The
// record read is n_steps * B * (3 + 3 + 1) * 4 bytes (220 MB at n_steps =
// 120, B = 65536), read once and coalesced. Design: one thread per (step,
// lane), index st * B + lane as in pass 1, so a warp holds 32 lanes of one
// step. Per sub-step the warp groups its lanes by leaf (__match_any_sync),
// sums each group in f64 in lane order through shuffles, and the group's
// lowest lane issues one f64 atomicAdd; a zero contribution or a cell of -1
// issues none. No thread returns early, so that every lane of a warp
// reaches the shuffles. The TPU kernel's plane accumulator, its step-tiled
// loop, the one-hot matmul pair and the plane decode are replaced by these
// atomics, whose order changes from run to run (in f64, far below the f32
// result's rounding). Offsets into the record are 64-bit.
#include "sweep_common.cuh"

namespace skirt9 {

constexpr unsigned kFull = 0xffffffffu;

// The sum of v over the lanes in `peers`, in lane order; all 32 lanes of the
// warp must call.
__device__ __forceinline__ double peer_sum(unsigned peers, double v) {
  double sum = 0.0;
#pragma unroll
  for (int src = 0; src < 32; ++src) {
    const double w = __shfl_sync(kFull, v, src);
    if (peers & (1u << src)) sum += w;
  }
  return sum;
}

__global__ void mlsweep_deposit_kernel(
    GridGeom f, const float* __restrict__ pos, const float* __restrict__ dir,
    const int* __restrict__ axis, const float* __restrict__ smin,
    const float* __restrict__ smax, const float* __restrict__ dsub,
    const int* __restrict__ csub, const float* __restrict__ lum,
    const float* __restrict__ tau_int, const float* __restrict__ tb,
    const int* __restrict__ step_tlev, const int* __restrict__ step_gs,
    double* __restrict__ rf, unsigned long long* __restrict__ first_hit,
    int B, int n_steps, float inv2) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = idx < (long long)n_steps * B;
  const int st = in_range ? (int)(idx / B) : 0;
  const int lane = in_range ? (int)(idx - (long long)st * B) : 0;
  const int tlev = step_tlev[st];
  Lane L;
  Slab S;
  bool live = false;
  if (in_range) {
    // no cross sections: C = 0 reads none
    L = load_lane(coarsen(f, step_gs[st]), pos, dir, axis, smin, smax,
                  nullptr, 0, B, lane);
    if (tlev < L.na) {
      S = enter_slab(L, tlev);
      live = S.act;
    }
  }
  float sc = 0.0f, rel = 0.0f;
  if (live) {
    const float tbv = tb[idx];
    sc = (lum[lane] * expf(-tbv)) * inv2;
    rel = tau_int[lane] - tbv;
  }
  const long long o = (long long)st * 3 * B + lane;
  float tau_loc = 0.0f;
  bool hit = false;
  for (int j = 0; j < 3; ++j) {
    float contrib = 0.0f;
    int cell = -1;
    if (live) {
      const float s_cur = S.s_cur;
      float ds;
      int coarse_cell;
      sub_step(L, tlev, S, ds, coarse_cell);
      const float dtau = dsub[o + (long long)j * B];
      cell = csub[o + (long long)j * B];
      contrib = sc * expf(-tau_loc) * ds * segment_factor(dtau);
      const float rem = rel - tau_loc;
      if (!hit && rem >= 0.0f && rem < dtau) {
        hit = true;
        const float s = s_cur + rem / fmaxf(dtau, 1e-37f) * ds;
        atomicMin(first_hit + lane,
                  ((unsigned long long)st << 32) | __float_as_uint(s));
      }
      tau_loc = tau_loc + dtau;
    }
    const int key = (contrib != 0.0f && cell >= 0) ? cell : -1;
    const unsigned peers = __match_any_sync(kFull, key);
    const double sum = peer_sum(peers, (double)contrib);
    if (key >= 0 && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
      atomicAdd(rf + key, sum);
  }
}

}  // namespace skirt9

extern "C" int mlsweep_deposit_launch(
    const void* pos, const void* dir, const void* axis, const void* smin,
    const void* smax, const void* dsub, const void* csub, const void* lum,
    const void* tau_int, const void* tb, const void* step_tlev,
    const void* step_gs, void* rf, void* first_hit, int B, int nx, int ny,
    int nz, int n_steps, float lox, float loy, float loz, float hx, float hy,
    float hz, float inv2, void* stream) {
  if (B <= 0 || n_steps <= 0) return (int)cudaErrorInvalidValue;
  skirt9::GridGeom g{nx, ny, nz, {lox, loy, loz}, {hx, hy, hz}};
  const long long total = (long long)n_steps * B;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  skirt9::mlsweep_deposit_kernel<<<blocks, threads, 0,
                                   (cudaStream_t)stream>>>(
      g, (const float*)pos, (const float*)dir, (const int*)axis,
      (const float*)smin, (const float*)smax, (const float*)dsub,
      (const int*)csub, (const float*)lum, (const float*)tau_int,
      (const float*)tb, (const int*)step_tlev, (const int*)step_gs, (double*)rf,
      (unsigned long long*)first_hit, B, n_steps, inv2);
  return (int)cudaGetLastError();
}
