// Variants of kernel 4 (skirt9_tpu_torch/csrc/mlsweep_dtau.cu) that the
// package does not ship, timed against it by perf/kernel4_variants.py; no
// simulation path launches them.
//
// `split_launch`: the package's pass A in its want_sub mode (the lane set-up
// inside), one part taken out at a time:
//   0 full           pass A as the package runs it;
//   1 no_gathers     the march with sig in place of the density and the
//                    step index in place of the leaf: no table reads;
//   2 lane_stores    each thread forms its lane and slab range and stores
//                    values made from them, no march;
//   3 stores_only    each thread stores zeros.
// Variants 1-3 write wrong values on purpose; only their times are read.
//
// `old_launch`: one thread per (plan step, lane), index st * B + lane;
// each thread loads its lane from the caller's (axis, smin, smax) at the
// step's granularity and marches that step, also where it then finds the
// step dead. Modes 0 (summed) and 1 (want_sub); its outputs equal the
// package kernel's bit for bit.
#include "sweep_common.cuh"

namespace skirt9 {

__device__ __forceinline__ int old_leaf_at(const int* __restrict__ leafmap,
                                           const GridGeom& f, int a, int tf,
                                           int uf, int vf) {
  const int x = a == 0 ? tf : uf;
  const int y = a == 0 ? uf : (a == 1 ? tf : vf);
  const int z = a == 2 ? tf : vf;
  return leafmap[((long long)x * f.ny + y) * f.nz + z];
}

__global__ void old_mlsweep_dtau_kernel(
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
        c[j] = old_leaf_at(leafmap, f, a, tlev << gs, uf, vf);
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

enum : int { kFullS = 0, kNoGathersS = 1, kLaneStoresS = 2,
             kStoresOnlyS = 3 };

template <int V>
__global__ void __launch_bounds__(256) split_kernel(
    GridGeom f, float ihx, float ihy, float ihz, const float* __restrict__ pos,
    const float* __restrict__ dir, const unsigned char* __restrict__ active,
    const float* __restrict__ sig, const float* __restrict__ nd,
    const int* __restrict__ leafmap, const int* __restrict__ step_tlev,
    const int* __restrict__ step_gs, int run, float* __restrict__ out,
    int* __restrict__ cells, int B, int C, int n_steps) {
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  const int runs = (n_steps + run - 1) / run;
  if (idx >= (long long)runs * B) return;
  const int q = (int)(idx / B);
  const int lane = (int)(idx - (long long)q * B);
  const int sa = q * run, sb = min(sa + run, n_steps);
  if (V == kStoresOnlyS) {
    for (int st = sa; st < sb; ++st) {
      const size_t o = (size_t)st * 3 * B + lane;
      for (int j = 0; j < 3; ++j) {
        out[o + (size_t)j * B] = 0.0f;
        cells[o + (size_t)j * B] = -1;
      }
    }
    return;
  }
  const float inv_h[3] = {ihx, ihy, ihz};
  int a;
  const Lane L = form_lane(f, inv_h, pos, dir, active, sig, -1, C, B, lane, a);
  int t0, t1;
  slab_range(L, t0, t1);
  for (int st = sa; st < sb; ++st) {
    const int tlev = step_tlev[st], gs = step_gs[st];
    float d[3] = {0.0f, 0.0f, 0.0f};
    int c[3] = {-1, -1, -1};
    if (V == kLaneStoresS) {
      d[0] = L.smin;
      c[0] = t0 + a;
    } else if ((tlev << gs) <= t1 && ((tlev + 1) << gs) - 1 >= t0) {
      const Lane Lc = coarsen_lane(L, gs);
      if (tlev < Lc.na) {
        Slab S = enter_slab(Lc, tlev);
        if (S.act) {
          for (int j = 0; j < 3; ++j) {
            const int uf = S.iu << gs, vf = S.iv << gs;
            float ds;
            int coarse_cell;
            sub_step(Lc, tlev, S, ds, coarse_cell);
            if (V == kNoGathersS) {
              c[j] = tlev + uf + vf;
              d[j] = Lc.sig[0] * ds;
            } else {
              c[j] = old_leaf_at(leafmap, f, a, tlev << gs, uf, vf);
              if (c[j] >= 0) d[j] = opacity(Lc, nd, c[j], C) * ds;
            }
          }
        }
      }
    }
    const size_t o = (size_t)st * 3 * B + lane;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      out[o + (size_t)j * B] = d[j];
      cells[o + (size_t)j * B] = c[j];
    }
  }
}

}  // namespace skirt9

extern "C" int old_launch(const void* pos, const void* dir, const void* axis,
                          const void* smin, const void* smax, const void* sig,
                          const void* nd, const void* leafmap,
                          const void* step_tlev, const void* step_gs,
                          void* out, void* cells, int B, int C, int nx,
                          int ny, int nz, int n_steps, int want_sub,
                          float lox, float loy, float loz, float hx, float hy,
                          float hz, void* stream) {
  if (B <= 0 || n_steps <= 0 || C < 1 || C > skirt9::kMaxComp)
    return (int)cudaErrorInvalidValue;
  skirt9::GridGeom g{nx, ny, nz, {lox, loy, loz}, {hx, hy, hz}};
  const long long total = (long long)n_steps * B;
  skirt9::old_mlsweep_dtau_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                                    (cudaStream_t)stream>>>(
      g, (const float*)pos, (const float*)dir, (const int*)axis,
      (const float*)smin, (const float*)smax, (const float*)sig,
      (const float*)nd, (const int*)leafmap, (const int*)step_tlev,
      (const int*)step_gs, (float*)out, (int*)cells, B, C, n_steps, want_sub);
  return (int)cudaGetLastError();
}

extern "C" int split_launch(int variant, const void* pos, const void* dir,
                            const void* active, const void* sig,
                            const void* nd, const void* leafmap,
                            const void* step_tlev, const void* step_gs,
                            void* out, void* cells, int B, int C, int nx,
                            int ny, int nz, int n_steps, int run, float lox,
                            float loy, float loz, float hx, float hy,
                            float hz, float ihx, float ihy, float ihz,
                            void* stream) {
  using namespace skirt9;
  if (B <= 0 || n_steps <= 0 || C < 1 || C > kMaxComp || run < 1 ||
      variant < kFullS || variant > kStoresOnlyS)
    return (int)cudaErrorInvalidValue;
  GridGeom g{nx, ny, nz, {lox, loy, loz}, {hx, hy, hz}};
  cudaStream_t s = (cudaStream_t)stream;
  const long long threads = (long long)((n_steps + run - 1) / run) * B;
  const unsigned blocks = (unsigned)((threads + 255) / 256);
  const float* fp[4] = {(const float*)pos, (const float*)dir,
                        (const float*)sig, (const float*)nd};
  const unsigned char* act = (const unsigned char*)active;
  const int* ip[3] = {(const int*)leafmap, (const int*)step_tlev,
                      (const int*)step_gs};
  switch (variant) {
    case kFullS:
      split_kernel<kFullS><<<blocks, 256, 0, s>>>(
          g, ihx, ihy, ihz, fp[0], fp[1], act, fp[2], fp[3], ip[0], ip[1],
          ip[2], run, (float*)out, (int*)cells, B, C, n_steps);
      break;
    case kNoGathersS:
      split_kernel<kNoGathersS><<<blocks, 256, 0, s>>>(
          g, ihx, ihy, ihz, fp[0], fp[1], act, fp[2], fp[3], ip[0], ip[1],
          ip[2], run, (float*)out, (int*)cells, B, C, n_steps);
      break;
    case kLaneStoresS:
      split_kernel<kLaneStoresS><<<blocks, 256, 0, s>>>(
          g, ihx, ihy, ihz, fp[0], fp[1], act, fp[2], fp[3], ip[0], ip[1],
          ip[2], run, (float*)out, (int*)cells, B, C, n_steps);
      break;
    default:
      split_kernel<kStoresOnlyS><<<blocks, 256, 0, s>>>(
          g, ihx, ihy, ihz, fp[0], fp[1], act, fp[2], fp[3], ip[0], ip[1],
          ip[2], run, (float*)out, (int*)cells, B, C, n_steps);
  }
  return (int)cudaGetLastError();
}
