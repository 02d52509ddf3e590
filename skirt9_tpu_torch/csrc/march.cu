// The scan march: one thread per lane walks the grid's cells step by step
// and writes column b of the (S, B) cell and step-length tables.
//
// Replaces the reference's XLA scan `march_geometry`
// (skirt9_tpu/transport/lifecycle.py:132, a lax.scan over the grid's `step`),
// which is not a Pallas kernel: the plain PyTorch version
// (skirt9_tpu_torch/transport/march.py `march_geometry_plain`) is one torch
// step per step, about 30 launches each, times up to 256 steps, times three
// marches an event. Three modes, one per grid kind, each with its own launch
// counter:
//   march_uniform  a uniform Cartesian grid: the next border of each axis is
//                  lo + index * h (UniformCartesianGrid.step,
//                  skirt9_tpu/grids/cartesian.py:245-270);
//   march_mesh     a Cartesian grid with per-axis border tables, staged in
//                  shared memory when they fit (CartesianGrid.step,
//                  cartesian.py:67-119);
//   march_voronoi  the exact Voronoi walk: the nearest positive crossing of a
//                  bisector plane over the -1-padded neighbour list, or the
//                  domain wall; the sites and neighbour lists are read through
//                  L1/L2 (VoronoiGrid.step, skirt9_tpu/grids/voronoi.py:77-110).
// Every f32 operation follows the plain version one for one (built with
// -fmad=false); where the plain version replays one of XLA's fused
// multiply-adds (ops/xlamath.py `fma`), because an ulp there decides which
// cell a step lands in, this kernel calls fmaf in exactly that place. A lane
// masked off or outside the grid writes cell 0 and length 0 for each step.
// The stores of one step are coalesced across the lanes of a warp.
#include <cuda_runtime.h>

namespace skirt9 {

constexpr float kBig = 3e38f;
constexpr int kThreads = 128;
constexpr int kSmemFloats = 48 * 1024 / 4;

struct Step {
  float ds;
  int next;
};

// The common tail of both Cartesian steps: the first axis of least exit
// distance, the position moved on with that coordinate on its border, and
// the neighbour cell across it (-1 past the grid).
__device__ __forceinline__ Step cartesian_exit(const int i[3], const int n[3],
                                               const float border[3],
                                               const float s[3], float p[3],
                                               const float d[3]) {
  int ax = 0;
  if (s[1] < s[ax]) ax = 1;
  if (s[2] < s[ax]) ax = 2;
  const float ds = s[ax];
  int j[3];
  bool inside = true;
  for (int a = 0; a < 3; ++a) {
    p[a] = a == ax ? border[a] : fmaf(ds, d[a], p[a]);
    j[a] = i[a] + (a == ax ? (d[a] >= 0.0f ? 1 : -1) : 0);
    inside = inside && j[a] >= 0 && j[a] < n[a];
  }
  return {ds, inside ? (j[0] * n[1] + j[1]) * n[2] + j[2] : -1};
}

__device__ __forceinline__ void split(int c, const int n[3], int i[3]) {
  i[0] = c / (n[1] * n[2]);
  i[1] = (c / n[2]) % n[1];
  i[2] = c % n[2];
}

__device__ __forceinline__ Step uniform_step(int c, const int n[3],
                                             const float lo[3],
                                             const float h[3], float p[3],
                                             const float d[3]) {
  int i[3];
  split(c, n, i);
  float border[3], s[3];
  for (int a = 0; a < 3; ++a) {
    border[a] = fmaf((float)(i[a] + (d[a] > 0.0f ? 1 : 0)), h[a], lo[a]);
    const bool tiny = fabsf(d[a]) < 1e-30f;
    s[a] = tiny ? kBig : fmaxf((border[a] - p[a]) / d[a], 0.0f);
  }
  return cartesian_exit(i, n, border, s, p, d);
}

__device__ __forceinline__ Step mesh_step(int c, const int n[3],
                                          const float* const b[3], float p[3],
                                          const float d[3]) {
  int i[3];
  split(c, n, i);
  float border[3], s[3];
  for (int a = 0; a < 3; ++a) {
    border[a] = d[a] > 0.0f ? b[a][i[a] + 1] : b[a][i[a]];
    const bool tiny = fabsf(d[a]) < 1e-30f;
    s[a] = tiny ? kBig : fmaxf((border[a] - p[a]) / d[a], 0.0f);
  }
  return cartesian_exit(i, n, border, s, p, d);
}

__device__ __forceinline__ Step voronoi_step(int c, int degree,
                                             const float* __restrict__ sites,
                                             const int* __restrict__ nbrs,
                                             const float lo[3],
                                             const float hi[3], float p[3],
                                             const float d[3]) {
  const float si[3] = {sites[3 * c], sites[3 * c + 1], sites[3 * c + 2]};
  float t_nb = kBig;
  int j_nb = 0;
  for (int k = 0; k < degree; ++k) {
    const int j = nbrs[(long long)c * degree + k];
    const int jj = j < 0 ? 0 : j;
    float nv[3], mp[3];
    for (int a = 0; a < 3; ++a) {
      const float sj = sites[3 * jj + a];
      nv[a] = sj - si[a];
      mp[a] = 0.5f * (sj + si[a]) - p[a];
    }
    const float dn = fmaf(d[2], nv[2], fmaf(d[1], nv[1], d[0] * nv[0]));
    const float num = fmaf(mp[2], nv[2], fmaf(mp[1], nv[1], mp[0] * nv[0]));
    float t = num / (fabsf(dn) < 1e-30f ? 1.0f : dn);
    if (!(j >= 0 && dn > 0.0f && t > 0.0f)) t = kBig;
    if (k == 0 || t < t_nb) {
      t_nb = t;
      j_nb = k;
    }
  }
  float t_wall = kBig;
  for (int a = 0; a < 3; ++a) {
    const bool tiny = fabsf(d[a]) < 1e-30f;
    const float tgt = d[a] > 0.0f ? hi[a] : lo[a];
    const float tw = tiny ? kBig : fmaxf((tgt - p[a]) / d[a], 0.0f);
    t_wall = fminf(t_wall, tw);
  }
  const float ds = fminf(t_nb, t_wall);
  const int next = t_wall <= t_nb ? -1 : nbrs[(long long)c * degree + j_nb];
  const float nudged = ds * (float)(1.0 + 1e-6);
  for (int a = 0; a < 3; ++a) p[a] = fmaf(nudged, d[a], p[a]);
  return {ds, next};
}

// mode 0: uniform (consts = lo, h); 1: mesh (t0..t2 = the border tables);
// 2: Voronoi (t0 = sites, t1 = neighbours, consts = box lo, hi). The six
// grid constants come from the device, so that a launch needs no copy of
// them to the host.
__global__ void march_kernel(const float* __restrict__ pos,
                             const float* __restrict__ dir,
                             const int* __restrict__ cell0,
                             const unsigned char* __restrict__ mask,
                             const float* __restrict__ t0,
                             const float* __restrict__ t1,
                             const float* __restrict__ t2,
                             const float* __restrict__ consts,
                             int* __restrict__ cells, float* __restrict__ dss,
                             int B, int S, int n0, int n1, int n2, int degree,
                             int mode, bool staged) {
  extern __shared__ float tables[];
  const int n[3] = {n0, n1, n2};
  const float* b[3] = {t0, t1, t2};
  if (mode == 1 && staged) {
    // the three border tables, one after another
    const int len = (n0 + 1) + (n1 + 1) + (n2 + 1);
    for (int k = threadIdx.x; k < len; k += blockDim.x) {
      tables[k] = k <= n0 ? t0[k]
                  : k <= n0 + n1 + 1 ? t1[k - n0 - 1]
                                     : t2[k - n0 - n1 - 2];
    }
    __syncthreads();
    b[0] = tables;
    b[1] = tables + n0 + 1;
    b[2] = tables + n0 + n1 + 2;
  }
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  float ga[3] = {0.0f, 0.0f, 0.0f}, gb[3] = {0.0f, 0.0f, 0.0f};
  if (mode != 1) {
    for (int a = 0; a < 3; ++a) {
      ga[a] = consts[a];
      gb[a] = consts[3 + a];
    }
  }
  float p[3] = {pos[3 * lane], pos[3 * lane + 1], pos[3 * lane + 2]};
  const float d[3] = {dir[3 * lane], dir[3 * lane + 1], dir[3 * lane + 2]};
  int c = mask[lane] ? cell0[lane] : -1;
  for (int s = 0; s < S; ++s) {
    const long long at = (long long)s * B + lane;
    if (c < 0) {
      cells[at] = 0;
      dss[at] = 0.0f;
      continue;
    }
    Step st;
    if (mode == 0) {
      st = uniform_step(c, n, ga, gb, p, d);
    } else if (mode == 1) {
      st = mesh_step(c, n, b, p, d);
    } else {
      st = voronoi_step(c, degree, t0, (const int*)t1, ga, gb, p, d);
    }
    cells[at] = c;
    dss[at] = st.ds;
    c = st.next;
  }
}

}  // namespace skirt9

extern "C" int march_launch(const void* pos, const void* dir,
                            const void* cell0, const void* mask,
                            const void* t0, const void* t1, const void* t2,
                            const void* consts, void* cells, void* ds, int B,
                            int S, int n0, int n1, int n2, int degree,
                            int mode, void* stream) {
  if (B <= 0 || S <= 0 || mode < 0 || mode > 2 || n0 <= 0 ||
      (mode != 2 && (n1 <= 0 || n2 <= 0)) || (mode == 2 && degree <= 0) ||
      (mode != 0 && (t0 == nullptr || t1 == nullptr)) ||
      (mode == 1 && t2 == nullptr) || (mode != 1 && consts == nullptr))
    return (int)cudaErrorInvalidValue;
  const int len = mode == 1 ? (n0 + 1) + (n1 + 1) + (n2 + 1) : 0;
  const bool staged = mode == 1 && len <= skirt9::kSmemFloats;
  const size_t smem = staged ? (size_t)len * sizeof(float) : 0;
  const int blocks = (B + skirt9::kThreads - 1) / skirt9::kThreads;
  skirt9::march_kernel<<<blocks, skirt9::kThreads, smem,
                         (cudaStream_t)stream>>>(
      (const float*)pos, (const float*)dir, (const int*)cell0,
      (const unsigned char*)mask, (const float*)t0, (const float*)t1,
      (const float*)t2, (const float*)consts, (int*)cells, (float*)ds, B, S,
      n0, n1, n2, degree, mode, staged);
  return (int)cudaGetLastError();
}
