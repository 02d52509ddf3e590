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
// tb - tau_loc lies in [0, dtau): s = s_cur + rem / dtau * ds. The first
// hit in (step, sub-step) order is written as first_hit[lane] = (st << 32 |
// bits of s), all ones where there is none, which the wrapper decodes. The
// interaction cell comes from the leaf map in the wrapper
// (mlsweep.locate_cells), as in the reference.
//
// What bounds it on the H100: the record, n_steps * B * (3 + 3 + 1) * 4
// bytes (220 MB at n_steps = 120, B = 65536), of which the lanes need only
// the steps their rays cross (38% at bench_config3ism); and the f64 sums
// into few leaves: a coarse leaf gathers some 10^5 contributions per event,
// so an f32 sum would lose about 1e-5 of it to rounding, hence f64. The
// previous design (one thread per (step, lane), every thread through three
// __match_any_sync rounds and 32-step shuffle sums) spent two thirds of its
// time in global f64 atomics (tools/kernel5_split.py, PERF.md §6). Design: kernel 1's lane tile (sweep_common.cuh `tile_steps`):
// a block of 256 threads takes 32 lanes, finds the plan steps each ray can
// cross (the steps over its slab range, by binary search on the plan) and
// spreads the live (step, lane) items over its threads step-major, so dead
// steps cost nothing and a warp reads 32 neighbouring lanes of one step.
// The first hit per lane is a shared-memory 64-bit atomicMin, so it is the
// serial order's whatever the thread order. Deposits are summed per warp by
// leaf (__match_any_sync; the group's first lane adds its peers' values in
// lane order from shared memory). Where the leaf table fits (12 bytes a
// leaf: bench_config3ism's 5,230 leaves take 63 KB), each block keeps a
// private f64 table in shared memory and lists each leaf the first time it
// adds to it (the sum was 0: contributions are positive and f64 does not
// flush them); the blocks are persistent, one per free slot of each SM, so
// each walks many tiles, and flushes only its listed leaves into rf with
// global f64 atomics, once. Larger trees (bench_config3ismxl's 138,447
// leaves) add the warp sums straight into rf. Atomics make the f64 sums
// order-dependent from run to run, far below the f32 result's rounding.
// Offsets into the record are 64-bit.
#include "sweep_common.cuh"

namespace skirt9 {

// The last plan step whose first fine slab, step_tlev << step_gs, is <= t.
__device__ inline int step_at(const int* __restrict__ step_tlev,
                              const int* __restrict__ step_gs, int n_steps,
                              int t) {
  int lo = 0, hi = n_steps;  // step 0 starts at slab 0
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if ((step_tlev[mid] << step_gs[mid]) <= t) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Dynamic shared memory: (kShared) table[ncells] f64, list[ncells]; then
// mask[n_steps], start[n_steps + 1].
template <bool kShared>
__global__ void __launch_bounds__(kTile* kWarps) mlsweep_deposit_kernel(
    GridGeom f, const float* __restrict__ pos, const float* __restrict__ dir,
    const int* __restrict__ axis, const float* __restrict__ smin,
    const float* __restrict__ smax, const float* __restrict__ dsub,
    const int* __restrict__ csub, const float* __restrict__ lum,
    const float* __restrict__ tau_int, const float* __restrict__ tb,
    const int* __restrict__ step_tlev, const int* __restrict__ step_gs,
    double* __restrict__ rf, unsigned long long* __restrict__ first_hit,
    int B, int n_steps, int ncells, float inv2) {
  extern __shared__ double dyn[];
  double* table = dyn;
  int* list = (int*)(dyn + (kShared ? ncells : 0));
  unsigned* mask = (unsigned*)(list + (kShared ? ncells : 0));
  int* start = (int*)(mask + n_steps);
  __shared__ Lane lanes[kTile];
  __shared__ int range[kTile][2];
  __shared__ float lum_s[kTile], tau_s[kTile];
  __shared__ unsigned long long hit[kTile];
  __shared__ double scratch[kWarps][kTile];
  __shared__ int hdr[2];
  __shared__ int listed;
  const int x = threadIdx.x, y = threadIdx.y;
  const int tid = y * kTile + x;

  if (kShared) {
    for (int k = tid; k < ncells; k += kTile * kWarps) table[k] = 0.0;
    if (tid == 0) listed = 0;
  }
  double* rf_add = rf;
  int* listed_p = &listed;
  const auto add = [=](int key, double v) {
    if (!kShared) {
      atomicAdd(rf_add + key, v);
    } else if (atomicAdd(table + key, v) == 0.0) {
      list[atomicAdd(listed_p, 1)] = key;
    }
  };

  const int tiles = (B + kTile - 1) / kTile;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int first = tile * kTile;
    const int lane = first + x;
    const bool valid = lane < B;
    __syncthreads();  // the previous tile's lanes and hits are read
    if (y == 0) {
      int s0 = 0, s1 = -1;
      if (valid) {
        // no cross sections: C = 0 reads none
        const Lane L =
            load_lane(f, pos, dir, axis, smin, smax, nullptr, 0, B, lane);
        int t0, t1;
        slab_range(L, t0, t1);
        if (t0 <= t1) {
          s0 = step_at(step_tlev, step_gs, n_steps, t0);
          s1 = step_at(step_tlev, step_gs, n_steps, t1);
        }
        lanes[x] = L;
        lum_s[x] = lum[lane];
        tau_s[x] = tau_int[lane];
      }
      range[x][0] = s0;
      range[x][1] = s1;
      hit[x] = ~0ull;
    }
    const TileSteps T = tile_steps(range, mask, start, hdr);

    for (int base = y * kTile; base < T.items; base += kTile * kWarps) {
      const int w = base + x;
      int key[3] = {-1, -1, -1};
      double val[3] = {0.0, 0.0, 0.0};
      if (w < T.items) {
        int i, l;
        tile_item(T, w, i, l);
        const int st = T.base + i;
        const int tlev = step_tlev[st];
        const Lane L = coarsen_lane(lanes[l], step_gs[st]);
        Slab S;
        bool live = false;
        if (tlev < L.na) {
          S = enter_slab(L, tlev);
          live = S.act;
        }
        if (live) {
          const long long idx = (long long)st * B + first + l;
          const float tbv = tb[idx], lm = lum_s[l];
          const float sc = lm != 0.0f ? (lm * expf(-tbv)) * inv2 : 0.0f;
          const float rel = tau_s[l] - tbv;
          const long long o = (long long)st * 3 * B + first + l;
          float tau_loc = 0.0f;
          bool got = false;
          for (int j = 0; j < 3; ++j) {
            const float s_cur = S.s_cur;
            float ds;
            int coarse_cell;
            sub_step(L, tlev, S, ds, coarse_cell);
            const float dtau = dsub[o + (long long)j * B];
            const int cell = csub[o + (long long)j * B];
            if (sc != 0.0f && cell >= 0) {
              const float contrib =
                  sc * expf(-tau_loc) * ds * segment_factor(dtau);
              if (contrib != 0.0f) {
                key[j] = cell;
                val[j] = (double)contrib;
              }
            }
            const float rem = rel - tau_loc;
            if (!got && rem >= 0.0f && rem < dtau) {
              got = true;
              const float s = s_cur + rem / fmaxf(dtau, 1e-37f) * ds;
              atomicMin(hit + l, ((unsigned long long)st << 32) |
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
    if (y == 0 && valid) first_hit[lane] = hit[x];
  }

  if (kShared) {
    // the block's listed leaves into rf, once each
    __syncthreads();
    for (int k = tid; k < listed; k += kTile * kWarps) {
      const int c = list[k];
      atomicAdd(rf + c, table[c]);
    }
  }
}

}  // namespace skirt9

extern "C" int mlsweep_deposit_launch(
    const void* pos, const void* dir, const void* axis, const void* smin,
    const void* smax, const void* dsub, const void* csub, const void* lum,
    const void* tau_int, const void* tb, const void* step_tlev,
    const void* step_gs, void* rf, void* first_hit, int B, int nx, int ny,
    int nz, int n_steps, int ncells, int shared, float lox, float loy,
    float loz, float hx, float hy, float hz, float inv2, void* stream) {
  using namespace skirt9;
  if (B <= 0 || n_steps <= 0 || ncells <= 0) return (int)cudaErrorInvalidValue;
  GridGeom g{nx, ny, nz, {lox, loy, loz}, {hx, hy, hz}};
  const size_t smem = (shared ? (size_t)ncells * 12 : 0) +
                      (size_t)(2 * n_steps + 1) * sizeof(int);
  const dim3 threads(kTile, kWarps);
  const int tiles = (B + kTile - 1) / kTile;
  const auto launch = [&](auto kernel) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    // persistent blocks: as many as the SMs hold at once
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kTile * kWarps, smem)) != cudaSuccess)
      return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const int blocks = tiles < sms * per_sm ? tiles : sms * per_sm;
    kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
        g, (const float*)pos, (const float*)dir, (const int*)axis,
        (const float*)smin, (const float*)smax, (const float*)dsub,
        (const int*)csub, (const float*)lum, (const float*)tau_int,
        (const float*)tb, (const int*)step_tlev, (const int*)step_gs,
        (double*)rf, (unsigned long long*)first_hit, B, n_steps, ncells, inv2);
    return (int)cudaGetLastError();
  };
  return shared ? launch(mlsweep_deposit_kernel<true>)
                : launch(mlsweep_deposit_kernel<false>);
}
