// The scan march: one thread per lane walks the grid's cells step by step
// and writes column b of the (S, B) cell and step-length tables.
//
// Replaces the reference's XLA scan `march_geometry`
// (skirt9_tpu/transport/lifecycle.py:132, a lax.scan over the grid's `step`),
// which is not a Pallas kernel: the plain PyTorch version
// (skirt9_tpu_torch/transport/march.py `march_geometry_plain`) is one torch
// step per step, about 30 launches each, times up to 256 steps, times three
// marches an event. One mode per grid kind, each with its own launch
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
//                  L1/L2 (VoronoiGrid.step, skirt9_tpu/grids/voronoi.py:77-110);
//   march_octree   an octree: exit the leaf box, nudge past the face by 1e-4
//                  of the leaf's smallest edge, and find the next leaf by
//                  descent from the root, `levels` levels at most, the node
//                  tables read through the read-only cache (OctreeGrid.step,
//                  skirt9_tpu/grids/octree.py:81-101);
//   march_bintree  a bintree: the same step, each node's descent along its
//                  split axis (BinTreeGrid.step, skirt9_tpu/grids/bintree.py:
//                  67-83).
//   march_sphere1d concentric shells: the ray-sphere quadratics of the outer
//                  border and, heading inward with r_in > 0 and a positive
//                  discriminant, of the inner one; the inner wins a tie
//                  (Sphere1DGrid.step, skirt9_tpu/grids/sphere.py:35-64);
//   march_cylinder2d annular (R, z) cells: the ray-cylinder quadratics of
//                  the outer and inner borders and the z-plane crossing, on
//                  a tie the inner cylinder, then the outer, then the plane
//                  (Cylinder2DGrid.step, skirt9_tpu/grids/cylinder.py:53-100).
//   march_amr      an adaptive mesh: exit the leaf box, move on by the
//                  run's nudge (1e-6 of the root box's diagonal) and find the
//                  next leaf by the bounded descent from the root over the
//                  node tables (box, subdivisions, child lists), read through
//                  the read-only cache (AMRGrid.step, skirt9_tpu/grids/amr.py:
//                  73-91).
//   march_tetra    a tetrahedral mesh: the nearest outgoing face of the four
//                  planes (normals and offsets read through the read-only
//                  cache), the neighbour across it, the position moved on by
//                  ds (1 + 1e-6) (TetraGrid.step, skirt9_tpu/grids/tetra.py:
//                  84-105);
//   march_sphere2d shells x polar cones: the least crossing of the two
//                  spheres and the two cones, then the next cell located at
//                  pos + (ds + eta) dir, eta = 1e-6 of the outer radius
//                  (Sphere2DGrid.step, skirt9_tpu/grids/polar.py:154-168);
//   march_sphere3d the same with the two azimuthal half-planes of the cell
//                  (Sphere3DGrid.step, polar.py:265-284);
//   march_cylinder3d annuli x half-planes x z slabs: the two cylinders, the
//                  two half-planes and the z plane, then the relocation
//                  (Cylinder3DGrid.step, polar.py:386-423).
//   march_clumpy   the clumpy sphere: march_sphere3d's step from the
//                  structured cell, cut at the first clump entry ahead, or
//                  out of a clump through its far crossing, then the
//                  relocation among the clumps first (ClumpySphericalGrid.
//                  step, skirt9_tpu/grids/clumpy.py:80-97).
// The two tree modes have their own entry point, march_tree_launch, the
// two curvilinear ones theirs, march_curvi_launch, with the border tables
// staged in shared memory (a few hundred floats), the adaptive mesh its
// own, march_amr_launch, the tetrahedral mesh march_tetra_launch, and the
// three polar modes march_polar_launch, their border tables and the
// tabulated cosines and sines of their angles staged in shared memory, the
// clumpy sphere march_clumpy_launch, its clump table staged beside them. A
// polar step locates with the C library's atan2f (glibc's, the function
// XLA's CPU code calls, and the plain version's `ops/xlamath.atan2`),
// written out here operation for operation.
// Every f32 operation follows the plain version one for one (built with
// -fmad=false); where the plain version replays one of XLA's fused
// multiply-adds (ops/xlamath.py `fma`), because an ulp there decides which
// cell a step lands in, this kernel calls fmaf in exactly that place. A lane
// masked off or outside the grid writes cell 0 and length 0 for each step.
// The stores of one step are coalesced across the lanes of a warp.
#include <cuda_runtime.h>

namespace skirt9 {

constexpr float kBig = 3e38f;
// a missed clump's crossings (the reference's _BIG of grids/clumpy.py)
constexpr float kClumpBig = 1e30f;
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

// One tree step from leaf c: the exit distance, the position moved onto the
// exit face, and the next leaf (-1 past the root box) located by descent at
// the exit point nudged on along the direction.
template <bool kOctree>
__device__ __forceinline__ Step tree_step(
    int c, int levels, const int* __restrict__ node_child,
    const int* __restrict__ node_axis, const float* __restrict__ node_geom,
    const int* __restrict__ node_cell, const float* __restrict__ cell_lo,
    const float* __restrict__ cell_hi, const float blo[3],
    const float bhi[3], float p[3], const float d[3]) {
  float lo[3], hi[3], s[3];
  for (int a = 0; a < 3; ++a) {
    lo[a] = __ldg(cell_lo + 3 * c + a);
    hi[a] = __ldg(cell_hi + 3 * c + a);
    const float tgt = d[a] > 0.0f ? hi[a] : lo[a];
    const bool tiny = fabsf(d[a]) < 1e-30f;
    s[a] = tiny ? kBig : fmaxf(__fdiv_rn(tgt - p[a], d[a]), 0.0f);
  }
  const float ds = fminf(fminf(s[0], s[1]), s[2]);
  const float eps =
      1e-4f * fminf(fminf(hi[0] - lo[0], hi[1] - lo[1]), hi[2] - lo[2]);
  float q[3];
  bool inside = true;
  for (int a = 0; a < 3; ++a) {
    p[a] = fmaf(ds, d[a], p[a]);
    q[a] = fmaf(eps, d[a], p[a]);
    inside = inside && q[a] >= blo[a] && q[a] < bhi[a];
  }
  int node = 0;
  for (int l = 0; l < levels; ++l) {
    const int child = __ldg(node_child + node);
    if (child < 0) break;  // a leaf stays where it is
    if (kOctree) {
      const float* ctr = node_geom + 3 * node;
      node = child + (q[0] >= __ldg(ctr) ? 1 : 0) +
             (q[1] >= __ldg(ctr + 1) ? 2 : 0) +
             (q[2] >= __ldg(ctr + 2) ? 4 : 0);
    } else {
      const int ax = __ldg(node_axis + node);
      node = child + (q[ax] >= __ldg(node_geom + node) ? 1 : 0);
    }
  }
  return {ds, inside ? __ldg(node_cell + node) : -1};
}

// The tree modes: node_geom holds the octree's split centres (N, 3) or the
// bintree's split values (N,), node_axis the bintree's split axes (unused
// for an octree); box = root lo, hi on the device.
template <bool kOctree>
__global__ void march_tree_kernel(
    const float* __restrict__ pos, const float* __restrict__ dir,
    const int* __restrict__ cell0, const unsigned char* __restrict__ mask,
    const int* __restrict__ node_child, const int* __restrict__ node_axis,
    const float* __restrict__ node_geom, const int* __restrict__ node_cell,
    const float* __restrict__ cell_lo, const float* __restrict__ cell_hi,
    const float* __restrict__ box, int* __restrict__ cells,
    float* __restrict__ dss, int B, int S, int levels) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const float blo[3] = {box[0], box[1], box[2]};
  const float bhi[3] = {box[3], box[4], box[5]};
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
    const Step st = tree_step<kOctree>(c, levels, node_child, node_axis,
                                       node_geom, node_cell, cell_lo, cell_hi,
                                       blo, bhi, p, d);
    cells[at] = c;
    dss[at] = st.ds;
    c = st.next;
  }
}

// One shell step from shell c: the nearer positive crossing, the position
// moved there, and the next shell (-1 past the grid). The dot products are
// running fused sums, as XLA forms the reference's; square roots correctly
// rounded.
__device__ __forceinline__ Step sphere_step(int c, int nr,
                                            const float* __restrict__ rb,
                                            float ts, float p[3],
                                            const float d[3]) {
  const float r_in = rb[c] * ts, r_out = rb[c + 1] * ts;
  const float b = fmaf(p[2], d[2], fmaf(p[1], d[1], p[0] * d[0]));
  const float r2 = fmaf(p[2], p[2], fmaf(p[1], p[1], p[0] * p[0]));
  const float p2 = fmaf(-b, b, r2);
  const float t_out = -b + __fsqrt_rn(fmaxf(fmaf(r_out, r_out, -p2), 0.0f));
  const float disc_in = fmaf(r_in, r_in, -p2);
  const bool can_in = r_in > 0.0f && b < 0.0f && disc_in > 0.0f;
  float t_in = can_in ? -b - __fsqrt_rn(fmaxf(disc_in, 0.0f)) : kBig;
  if (!(t_in > 0.0f)) t_in = kBig;
  const bool inward = t_in < t_out;
  const float ds = inward ? t_in : t_out;
  int next = inward ? c - 1 : c + 1;
  if (next < 0 || next >= nr) next = -1;
  for (int a = 0; a < 3; ++a) p[a] = fmaf(ds, d[a], p[a]);
  return {ds, next};
}

// One annular-cell step from cell c = ir * nz + iz: the least of the outer
// and inner cylinder crossings and the z-plane crossing (ties: inner, outer,
// plane), the position moved there, and the next cell (-1 past the grid).
__device__ __forceinline__ Step cylinder_step(int c, int nr, int nz,
                                              const float* __restrict__ rb,
                                              const float* __restrict__ zb,
                                              float ts, float p[3],
                                              const float d[3]) {
  const int ir = c / nz, iz = c % nz;
  const float q = fmaf(d[0], d[0], d[1] * d[1]);
  const float b = fmaf(p[0], d[0], p[1] * d[1]);
  const float R2 = fmaf(p[0], p[0], p[1] * p[1]);
  const float r_in = rb[ir] * ts, r_out = rb[ir + 1] * ts;
  const float safe_q = fmaxf(q, 1e-30f);
  const bool moves = q > 1e-30f;
  const float disc_out =
      fmaxf(fmaf(b, b, safe_q * fmaf(r_out, r_out, -R2)), 0.0f);
  float t_out = __fdiv_rn(__fsqrt_rn(disc_out) - b, safe_q);
  t_out = moves ? fmaxf(t_out, 0.0f) : kBig;
  const float disc_in = fmaf(b, b, safe_q * fmaf(r_in, r_in, -R2));
  const bool can_in = r_in > 0.0f && b < 0.0f && disc_in > 0.0f;
  float t_in = can_in && moves
                   ? __fdiv_rn(-b - __fsqrt_rn(fmaxf(disc_in, 0.0f)), safe_q)
                   : kBig;
  if (!(t_in > 0.0f)) t_in = kBig;
  const bool up = d[2] > 0.0f;
  const float z_tgt = (up ? zb[iz + 1] : zb[iz]) * ts;
  const float t_z = fabsf(d[2]) < 1e-30f
                        ? kBig
                        : fmaxf(__fdiv_rn(z_tgt - p[2], d[2]), 0.0f);
  const float ds = fminf(fminf(t_out, t_in), t_z);
  const bool hit_rin = ds == t_in;
  const bool hit_rout = ds == t_out && !hit_rin;
  const int jr = ir + (hit_rout ? 1 : 0) - (hit_rin ? 1 : 0);
  const int jz = iz + (!hit_rin && !hit_rout ? (up ? 1 : -1) : 0);
  const bool inside = jr >= 0 && jr < nr && jz >= 0 && jz < nz;
  for (int a = 0; a < 3; ++a) p[a] = fmaf(ds, d[a], p[a]);
  return {ds, inside ? jr * nz + jz : -1};
}

// The curvilinear modes: rb (nr + 1 radii) and, for the cylinder, zb (nz + 1
// planes), staged in shared memory when they fit, else read from global.
// Lengths enter times `scale` (2^-shift, exact; 1 on grids inside 2^60 m)
// and the step lengths leave times `unscale`, so that the squares of galaxy
// radii stay inside f32, as the plain version's `shift` has it.
template <bool kCylinder>
__global__ void march_curvi_kernel(const float* __restrict__ pos,
                                   const float* __restrict__ dir,
                                   const int* __restrict__ cell0,
                                   const unsigned char* __restrict__ mask,
                                   const float* __restrict__ rb_g,
                                   const float* __restrict__ zb_g,
                                   int* __restrict__ cells,
                                   float* __restrict__ dss, int B, int S,
                                   int nr, int nz, float scale, float unscale,
                                   bool staged) {
  extern __shared__ float tables[];
  const float* rb = rb_g;
  const float* zb = zb_g;
  if (staged) {
    const int len = (nr + 1) + (kCylinder ? nz + 1 : 0);
    for (int k = threadIdx.x; k < len; k += blockDim.x)
      tables[k] = (k <= nr ? rb_g[k] : zb_g[k - nr - 1]) * scale;
    __syncthreads();
    rb = tables;
    zb = tables + nr + 1;
  }
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  float p[3] = {pos[3 * lane] * scale, pos[3 * lane + 1] * scale,
                pos[3 * lane + 2] * scale};
  const float ts = staged ? 1.0f : scale;  // the tables' own scale
  const float d[3] = {dir[3 * lane], dir[3 * lane + 1], dir[3 * lane + 2]};
  int c = mask[lane] ? cell0[lane] : -1;
  for (int s = 0; s < S; ++s) {
    const long long at = (long long)s * B + lane;
    if (c < 0) {
      cells[at] = 0;
      dss[at] = 0.0f;
      continue;
    }
    const Step st = kCylinder ? cylinder_step(c, nr, nz, rb, zb, ts, p, d)
                              : sphere_step(c, nr, rb, ts, p, d);
    cells[at] = c;
    dss[at] = st.ds * unscale;
    c = st.next;
  }
}

// The leaf of the adaptive mesh holding q: at most `depth` levels of
// descent, each the child whose slot the position's fraction of the node box
// picks (truncated toward zero, clamped to the node's subdivisions).
__device__ __forceinline__ int amr_descend(
    const float q[3], const float* __restrict__ node_lo,
    const float* __restrict__ node_span, const int* __restrict__ node_div,
    const int* __restrict__ node_child, const int* __restrict__ node_cell,
    const int* __restrict__ child_flat, int depth) {
  int node = 0;
  for (int l = 0; l < depth; ++l) {
    const int child = __ldg(node_child + node);
    if (child < 0) break;  // a leaf stays where it is
    int div[3], ijk[3];
    for (int a = 0; a < 3; ++a) {
      div[a] = __ldg(node_div + 3 * node + a);
      const float rel = __fdiv_rn(q[a] - __ldg(node_lo + 3 * node + a),
                                  __ldg(node_span + 3 * node + a));
      const int i = __float2int_rz(__fmul_rn(rel, (float)div[a]));
      ijk[a] = min(max(i, 0), max(div[a] - 1, 0));
    }
    node = __ldg(child_flat + child + ijk[0] +
                 div[0] * (ijk[1] + div[1] * ijk[2]));
  }
  return __ldg(node_cell + node);
}

// The adaptive-mesh mode: the exit distance of leaf c's box, the position
// moved on past the face by ds + nudge (fused on x and y, as XLA forms the
// plain version's move), and the next leaf there (-1 outside the root box).
__global__ void march_amr_kernel(
    const float* __restrict__ pos, const float* __restrict__ dir,
    const int* __restrict__ cell0, const unsigned char* __restrict__ mask,
    const float* __restrict__ node_lo, const float* __restrict__ node_span,
    const int* __restrict__ node_div, const int* __restrict__ node_child,
    const int* __restrict__ node_cell, const int* __restrict__ child_flat,
    const float* __restrict__ cell_lo, const float* __restrict__ cell_hi,
    const float* __restrict__ box, int* __restrict__ cells,
    float* __restrict__ dss, int B, int S, int depth, float nudge) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const float blo[3] = {box[0], box[1], box[2]};
  const float bhi[3] = {box[3], box[4], box[5]};
  float p[3] = {pos[3 * lane], pos[3 * lane + 1], pos[3 * lane + 2]};
  const float d[3] = {dir[3 * lane], dir[3 * lane + 1], dir[3 * lane + 2]};
  float inv[3];
  for (int a = 0; a < 3; ++a)
    inv[a] = __fdiv_rn(1.0f, fabsf(d[a]) < 1e-30f ? 1e-30f : d[a]);
  int c = mask[lane] ? cell0[lane] : -1;
  for (int s = 0; s < S; ++s) {
    const long long at = (long long)s * B + lane;
    if (c < 0) {
      cells[at] = 0;
      dss[at] = 0.0f;
      continue;
    }
    float t[3];
    for (int a = 0; a < 3; ++a) {
      const float tgt = d[a] > 0.0f ? __ldg(cell_hi + 3 * c + a)
                                    : __ldg(cell_lo + 3 * c + a);
      t[a] = fabsf(d[a]) < 1e-30f
                 ? kBig
                 : fmaxf(__fmul_rn(tgt - p[a], inv[a]), 0.0f);
    }
    const float ds = fminf(fminf(t[0], t[1]), t[2]);
    const float move = __fadd_rn(ds, nudge);
    p[0] = fmaf(move, d[0], p[0]);
    p[1] = fmaf(move, d[1], p[1]);
    p[2] = __fadd_rn(p[2], __fmul_rn(move, d[2]));
    bool inside = true;
    for (int a = 0; a < 3; ++a)
      inside = inside && p[a] >= blo[a] && p[a] < bhi[a];
    cells[at] = c;
    dss[at] = ds;
    c = inside ? amr_descend(p, node_lo, node_span, node_div, node_child,
                             node_cell, child_flat, depth)
               : -1;
  }
}

// One tetrahedron step from cell c: over the four face planes (outward
// normal n, offset d: n.x + d <= 0 inside) the least t = -(n.p + d) / (n.dir)
// of the faces the ray leaves through (n.dir > 0; t at least 0), the first
// face on a tie; the position moved on by ds (1 + 1e-6) and the neighbour
// across that face (-1 at the hull).
__device__ __forceinline__ Step tetra_step(int c,
                                           const float* __restrict__ face_n,
                                           const float* __restrict__ face_d,
                                           const int* __restrict__ nbrs,
                                           float p[3], const float d[3]) {
  float best = 0.0f;
  int j = 0;
  for (int k = 0; k < 4; ++k) {
    const float* n = face_n + 12 * (long long)c + 3 * k;
    const float n0 = __ldg(n), n1 = __ldg(n + 1), n2 = __ldg(n + 2);
    const float dn = fmaf(d[2], n2, fmaf(d[1], n1, d[0] * n0));
    const float sd =
        fmaf(n2, p[2], fmaf(n1, p[1], n0 * p[0])) + __ldg(face_d + 4 * c + k);
    float t = __fdiv_rn(-sd, fabsf(dn) < 1e-30f ? 1.0f : dn);
    t = dn > 0.0f ? fmaxf(t, 0.0f) : kBig;
    if (k == 0 || t < best) {
      best = t;
      j = k;
    }
  }
  const float moved = best * (float)(1.0 + 1e-6);
  for (int a = 0; a < 3; ++a) p[a] = fmaf(moved, d[a], p[a]);
  return {best, __ldg(nbrs + 4 * c + j)};
}

__global__ void march_tetra_kernel(const float* __restrict__ pos,
                                   const float* __restrict__ dir,
                                   const int* __restrict__ cell0,
                                   const unsigned char* __restrict__ mask,
                                   const float* __restrict__ face_n,
                                   const float* __restrict__ face_d,
                                   const int* __restrict__ nbrs,
                                   int* __restrict__ cells,
                                   float* __restrict__ dss, int B, int S) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
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
    const Step st = tetra_step(c, face_n, face_d, nbrs, p, d);
    cells[at] = c;
    dss[at] = st.ds;
    c = st.next;
  }
}

// glibc's atanf of finite x >= 0 (fdlibm's, each operation rounded alone):
// the argument reduction at 7/16, 11/16, 19/16 and 39/16 and the two
// polynomials in w = x^4.
__device__ __forceinline__ float atanf_glibc(float x) {
  constexpr float kHi[4] = {4.6364760399e-01f, 7.8539812565e-01f,
                            9.8279368877e-01f, 1.5707962513e+00f};
  constexpr float kLo[4] = {5.0121582440e-09f, 3.7748947079e-08f,
                            3.4473217170e-08f, 7.5497894159e-08f};
  const int ix = __float_as_int(x);
  if (ix >= 0x4C000000) return __fadd_rn(kHi[3], kLo[3]);
  int band;
  float r;
  if (ix < 0x3EE00000) {
    band = -1;
    r = x;
  } else if (ix < 0x3F300000) {
    band = 0;
    r = __fdiv_rn(__fsub_rn(__fmul_rn(x, 2.0f), 1.0f), __fadd_rn(x, 2.0f));
  } else if (ix < 0x3F980000) {
    band = 1;
    r = __fdiv_rn(__fsub_rn(x, 1.0f), __fadd_rn(x, 1.0f));
  } else if (ix < 0x401C0000) {
    band = 2;
    r = __fdiv_rn(__fsub_rn(x, 1.5f), __fadd_rn(__fmul_rn(x, 1.5f), 1.0f));
  } else {
    band = 3;
    r = __fdiv_rn(-1.0f, x > 0.0f ? x : 1.0f);
  }
  const float z = __fmul_rn(r, r);
  const float w = __fmul_rn(z, z);
  float s1 = __fadd_rn(__fmul_rn(w, 1.6285819933e-02f), 4.9768779427e-02f);
  s1 = __fadd_rn(__fmul_rn(s1, w), 6.6610731184e-02f);
  s1 = __fadd_rn(__fmul_rn(s1, w), 9.0908870101e-02f);
  s1 = __fadd_rn(__fmul_rn(s1, w), 1.4285714924e-01f);
  s1 = __fadd_rn(__fmul_rn(s1, w), __int_as_float(0x3EAAAAAB));
  float s2 = __fadd_rn(__fmul_rn(w, -3.6531571299e-02f), -5.8335702866e-02f);
  s2 = __fadd_rn(__fmul_rn(s2, w), -7.6918758452e-02f);
  s2 = __fadd_rn(__fmul_rn(s2, w), -1.1111110449e-01f);
  s2 = __fadd_rn(__fmul_rn(s2, w), -2.0000000298e-01f);
  const float poly =
      __fmul_rn(r, __fadd_rn(__fmul_rn(s1, z), __fmul_rn(s2, w)));
  if (band < 0) return __fsub_rn(r, poly);
  return __fsub_rn(kHi[band], __fsub_rn(__fsub_rn(poly, kLo[band]), r));
}

// glibc's atan2f(y, x) on finite inputs: atanf of |y / x| (past a ratio of
// 2^60 pi/2, below 2^-60 with x < 0 zero) moved into the quadrant with
// pi in two parts; +-0 and +-pi for y = 0, +-pi/2 for x = 0, atanf(y) for
// x = 1.
__device__ __forceinline__ float atan2_glibc(float y, float x) {
  const float kPi = __int_as_float(0x40490FDB);
  const float kPiLo = __int_as_float(0xB3BBBD2E);
  const float kPi2 = __int_as_float(0x3FC90FDB);
  const int hx = __float_as_int(x), hy = __float_as_int(y);
  const int ix = hx & 0x7FFFFFFF, iy = hy & 0x7FFFFFFF;
  const bool neg_x = hx < 0, neg_y = hy < 0;
  if (hx == 0x3F800000) {
    const float a = atanf_glibc(fabsf(y));
    return neg_y ? -a : a;
  }
  if (iy == 0) return neg_x ? (neg_y ? -kPi : kPi) : y;
  if (ix == 0) return neg_y ? -kPi2 : kPi2;
  const int k = (iy - ix) >> 23;
  float z;
  if (k > 60) {
    z = __fadd_rn(kPi2, __fmul_rn(0.5f, kPiLo));
  } else if (neg_x && k < -60) {
    z = 0.0f;
  } else {
    float q = fabsf(__fdiv_rn(y, x));
    if (!isfinite(q)) q = 0.0f;
    z = atanf_glibc(q);
  }
  if (!neg_x) return neg_y ? -z : z;
  return neg_y ? __fsub_rn(__fsub_rn(z, kPiLo), kPi)
               : __fsub_rn(kPi, __fsub_rn(z, kPiLo));
}

// jnp.hypot's form: a sqrt(1 + (b / a)^2), a = max(|x|, |y|), 0 where a is.
__device__ __forceinline__ float hypot_jax(float x, float y) {
  const float a = fmaxf(fabsf(x), fabsf(y)), b = fminf(fabsf(x), fabsf(y));
  if (a == 0.0f) return a;
  const float q = __fdiv_rn(b, a);
  return __fmul_rn(a, __fsqrt_rn(fmaf(q, q, 1.0f)));
}

// The index i of the last border <= v (-1 below the first), as
// torch.searchsorted(borders, v, right=True) - 1.
__device__ __forceinline__ int border_bin(const float* b, int len, float v) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (b[mid] > v)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo - 1;
}

__device__ __forceinline__ float dot3f(const float a[3], const float b[3]) {
  return fmaf(a[2], b[2], fmaf(a[1], b[1], a[0] * b[0]));
}

__device__ __forceinline__ float sign_of(float v) {
  return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
}

// The polar grids' tables: border radii (scaled by 2^-shift), polar border
// angles and their cosines, azimuthal border angles and their cosines and
// sines, z borders (scaled).
struct PolarTabs {
  const float* rb;
  const float* tb;
  const float* cos_t;
  const float* pb;
  const float* cos_p;
  const float* sin_p;
  const float* zb;
  int nr, nt, nphi, nz;
};

// The cell of the (scaled) position q, -1 outside: Sphere2D ir * nt + it,
// Sphere3D (ir * nt + it) * nphi + ip, Cylinder3D (ir * nphi + ip) * nz + iz.
template <int kKind>
__device__ __forceinline__ int polar_locate(const PolarTabs& g,
                                            const float q[3]) {
  if (kKind == 2) {
    const float R = hypot_jax(q[0], q[1]);
    const int ir = border_bin(g.rb, g.nr + 1, R);
    const int ip =
        min(max(border_bin(g.pb, g.nphi + 1, atan2_glibc(q[1], q[0])), 0),
            g.nphi - 1);
    const int iz = border_bin(g.zb, g.nz + 1, q[2]);
    const bool inside = R >= g.rb[0] && R < g.rb[g.nr] && q[2] >= g.zb[0] &&
                        q[2] < g.zb[g.nz];
    if (!inside) return -1;
    return (min(max(ir, 0), g.nr - 1) * g.nphi + ip) * g.nz +
           min(max(iz, 0), g.nz - 1);
  }
  const float r = __fsqrt_rn(dot3f(q, q));
  const int ir = border_bin(g.rb, g.nr + 1, r);
  const float th = atan2_glibc(hypot_jax(q[0], q[1]), q[2]);
  const int it = min(max(border_bin(g.tb, g.nt + 1, th), 0), g.nt - 1);
  if (!(r >= g.rb[0] && r < g.rb[g.nr])) return -1;
  const int cell = min(max(ir, 0), g.nr - 1) * g.nt + it;
  if (kKind == 0) return cell;
  const int ip =
      min(max(border_bin(g.pb, g.nphi + 1, atan2_glibc(q[1], q[0])), 0),
          g.nphi - 1);
  return cell * g.nphi + ip;
}

// The least crossing (> eta) of the polar cone cos(theta) = c (see the plain
// version, grids/polar.py cone_cross, for the fused products).
__device__ __forceinline__ float cone_cross(const float p[3], const float d[3],
                                            float c, float eta) {
  const float x = p[0], y = p[1], z = p[2], dz = d[2];
  const float c2 = c * c;
  const float zdz = z * dz, zz = z * z, dzdz = dz * dz;
  const float pd = zdz + fmaf(x, d[0], y * d[1]);
  const float r2 = zz + fmaf(x, x, y * y);
  const float A = dzdz - c2;
  const float B = fmaf(-c2, pd, zdz);
  const float C = fmaf(-c2, r2, zz);
  float t_plane = fabsf(dz) > 1e-30f ? __fdiv_rn(-z, dz) : kBig;
  if (!(t_plane > eta)) t_plane = kBig;
  const float disc = fmaf(B, B, -(A * C));
  const float sq = __fsqrt_rn(fmaxf(disc, 0.0f));
  const float safe_A = fabsf(A) > 1e-30f ? A : 1.0f;
  const float t1 = __fdiv_rn(-B - sq, safe_A);
  const float t2 = __fdiv_rn(sq - B, safe_A);
  const float t_lin =
      fabsf(B) > 1e-30f ? __fdiv_rn(-C, 2.0f * B) : kBig;
  const bool lin = fabsf(A) < (float)1e-12 * ((dzdz + c2) + (float)1e-30);
  const float sc = sign_of(c);
  auto valid = [&](float t) {
    const float zc = fmaf(t, dz, z);
    return t > eta && disc >= 0.0f && sign_of(zc) == sc ? t : kBig;
  };
  const float t_quad = fminf(valid(lin ? t_lin : t1), valid(lin ? kBig : t2));
  if (fabsf(c) > (float)(1 - 1e-7)) return kBig;
  return fabsf(c) < (float)1e-7 ? t_plane : t_quad;
}

// The least crossing (> eta) of the azimuthal half-plane of cosine cb and
// sine sb (its half with x cb + y sb > 0).
__device__ __forceinline__ float halfplane_cross(const float p[3],
                                                 const float d[3], float cb,
                                                 float sb, float eta) {
  const float num = -fmaf(p[0], sb, -(p[1] * cb));
  const float den = fmaf(d[0], sb, -(d[1] * cb));
  const float t = fabsf(den) > 1e-30f ? __fdiv_rn(num, den) : kBig;
  const bool on_half =
      fmaf(fmaf(t, d[0], p[0]), cb, fmaf(t, d[1], p[1]) * sb) > 0.0f;
  return t > eta && on_half ? t : kBig;
}

// The length of one polar step from cell c in scaled lengths: the least
// crossing of the cell's bounding surfaces.
template <int kKind>
__device__ __forceinline__ float polar_length(int c, const PolarTabs& g,
                                              float eta, const float p[3],
                                              const float d[3]) {
  float ds;
  if (kKind == 2) {
    const int iz = c % g.nz, ip = (c / g.nz) % g.nphi,
              ir = c / (g.nz * g.nphi);
    const float x = p[0], y = p[1], z = p[2];
    const float q = fmaf(d[0], d[0], d[1] * d[1]);
    const float b = fmaf(x, d[0], y * d[1]);
    const float R2 = fmaf(x, x, y * y);
    const bool moves = q > 1e-30f;
    const float safe_q = fmaxf(q, 1e-30f);
    const float r_out = g.rb[ir + 1], r_in = g.rb[ir];
    const float disc_out =
        fmaxf(fmaf(safe_q, fmaf(r_out, r_out, -R2), b * b), 0.0f);
    const float t_out =
        moves ? fmaxf(__fdiv_rn(__fsqrt_rn(disc_out) - b, safe_q), 0.0f)
              : kBig;
    const float disc_in = fmaf(safe_q, fmaf(r_in, r_in, -R2), b * b);
    const bool can_in = r_in > 0.0f && b < 0.0f && disc_in > 0.0f && moves;
    float t_in =
        can_in ? __fdiv_rn(-b - __fsqrt_rn(fmaxf(disc_in, 0.0f)), safe_q)
               : kBig;
    if (!(t_in > 0.0f)) t_in = kBig;
    const float t_p0 =
        halfplane_cross(p, d, g.cos_p[ip], g.sin_p[ip], eta);
    const float t_p1 =
        halfplane_cross(p, d, g.cos_p[ip + 1], g.sin_p[ip + 1], eta);
    const float z_tgt = d[2] > 0.0f ? g.zb[iz + 1] : g.zb[iz];
    const float t_z = fabsf(d[2]) < 1e-30f
                          ? kBig
                          : fmaxf(__fdiv_rn(z_tgt - z, d[2]), 0.0f);
    ds = fminf(fminf(fminf(t_out, t_in), fminf(t_p0, t_p1)), t_z);
  } else {
    int ir, it, ip = 0;
    if (kKind == 0) {
      ir = c / g.nt;
      it = c % g.nt;
    } else {
      ip = c % g.nphi;
      it = (c / g.nphi) % g.nt;
      ir = c / (g.nphi * g.nt);
    }
    const float b = dot3f(p, d), r2 = dot3f(p, p);
    const float r_out = g.rb[ir + 1], r_in = g.rb[ir];
    const float disc_out =
        fmaxf(fmaf(r_out, r_out, -fmaf(-b, b, r2)), 0.0f);
    const float t_out = fmaxf(__fsqrt_rn(disc_out) - b, 0.0f);
    const float disc_in = fmaf(r_in, r_in, -fmaf(-b, b, r2));
    const float t_root = -b - __fsqrt_rn(fmaxf(disc_in, 0.0f));
    const float t_in = r_in > 0.0f && b < 0.0f && disc_in > 0.0f &&
                               t_root > 0.0f
                           ? t_root
                           : kBig;
    const float t_up = cone_cross(p, d, g.cos_t[it], eta);
    const float t_dn = cone_cross(p, d, g.cos_t[it + 1], eta);
    ds = fminf(fminf(t_out, t_in), fminf(t_up, t_dn));
    if (kKind == 1) {
      const float t_p0 =
          halfplane_cross(p, d, g.cos_p[ip], g.sin_p[ip], eta);
      const float t_p1 =
          halfplane_cross(p, d, g.cos_p[ip + 1], g.sin_p[ip + 1], eta);
      ds = fminf(ds, fminf(t_p0, t_p1));
    }
  }
  return ds;
}

// The position moved to p + ds dir, and q = p + (ds + eta) dir, where the
// next cell is located.
__device__ __forceinline__ void relocate(float ds, float eta, float p[3],
                                         const float d[3], float q[3]) {
  const float ahead = ds + eta;
  for (int a = 0; a < 3; ++a) {
    q[a] = fmaf(ahead, d[a], p[a]);
    p[a] = fmaf(ds, d[a], p[a]);
  }
}

// One polar step from cell c in scaled lengths: ds, the position moved to
// p + ds dir, and the cell located at p + (ds + eta) dir.
template <int kKind>
__device__ __forceinline__ Step polar_step(int c, const PolarTabs& g,
                                           float eta, float p[3],
                                           const float d[3]) {
  const float ds = polar_length<kKind>(c, g, eta, p, d);
  float q[3];
  relocate(ds, eta, p, d, q);
  return {ds, polar_locate<kKind>(g, q)};
}

// The polar modes (kKind 0 Sphere2D, 1 Sphere3D, 2 Cylinder3D) over the
// packed tables (rb, tb, cos_t, pb, cos_p, sin_p, zb one after another,
// the radii and z borders times 2^-shift, an absent table's count 0),
// staged in shared memory when they fit, else read from global; lengths
// enter times `scale` = 2^-shift and the step lengths leave times
// `unscale`, exactly.
template <int kKind>
__global__ void march_polar_kernel(
    const float* __restrict__ pos, const float* __restrict__ dir,
    const int* __restrict__ cell0, const unsigned char* __restrict__ mask,
    const float* __restrict__ tabs, int* __restrict__ cells,
    float* __restrict__ dss, int B, int S, int nr, int nt, int nphi, int nz,
    float scale, float unscale, int len, bool staged) {
  extern __shared__ float tables[];
  const float* tab = tabs;
  if (staged) {
    for (int k = threadIdx.x; k < len; k += blockDim.x) tables[k] = tabs[k];
    __syncthreads();
    tab = tables;
  }
  const auto count = [](int n) { return n > 0 ? n + 1 : 0; };
  PolarTabs g;
  g.rb = tab;
  g.tb = g.rb + count(nr);
  g.cos_t = g.tb + count(nt);
  g.pb = g.cos_t + count(nt);
  g.cos_p = g.pb + count(nphi);
  g.sin_p = g.cos_p + count(nphi);
  g.zb = g.sin_p + count(nphi);
  g.nr = nr;
  g.nt = nt;
  g.nphi = nphi;
  g.nz = nz;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const float eta =
      kKind == 2 ? fmaxf(g.rb[nr], g.zb[nz] - g.zb[0]) * (float)1e-6
                 : g.rb[nr] * (float)1e-6;
  float p[3] = {pos[3 * lane] * scale, pos[3 * lane + 1] * scale,
                pos[3 * lane + 2] * scale};
  const float d[3] = {dir[3 * lane], dir[3 * lane + 1], dir[3 * lane + 2]};
  int c = mask[lane] ? cell0[lane] : -1;
  for (int s = 0; s < S; ++s) {
    const long long at = (long long)s * B + lane;
    if (c < 0) {
      cells[at] = 0;
      dss[at] = 0.0f;
      continue;
    }
    const Step st = polar_step<kKind>(c, g, eta, p, d);
    cells[at] = c;
    dss[at] = st.ds >= kBig ? st.ds : st.ds * unscale;
    c = st.next;
  }
}


// The clumps' ray crossings and point test, clump k's centre and radius at
// cl[4k .. 4k+3] (scaled lengths), as grids/clumpy.py forms them: rel . dir
// and rel . rel running sums with each product fused, b^2 - c0 fused.
struct Crossing {
  float t0, t1;
};

// A clump table entry: from shared memory, or from global memory through the
// read-only cache.
template <bool kLdg>
__device__ __forceinline__ float clump_at(const float* cl, int i) {
  return kLdg ? __ldg(cl + i) : cl[i];
}

template <bool kLdg>
__device__ __forceinline__ Crossing clump_crossing(const float* cl,
                                                   const float p[3],
                                                   const float d[3]) {
  const float r = clump_at<kLdg>(cl, 3);
  const float rel[3] = {p[0] - clump_at<kLdg>(cl, 0),
                        p[1] - clump_at<kLdg>(cl, 1),
                        p[2] - clump_at<kLdg>(cl, 2)};
  const float b = dot3f(rel, d);
  const float c0 = dot3f(rel, rel) - r * r;
  const float disc = fmaf(b, b, -c0);
  const float sq = __fsqrt_rn(fmaxf(disc, 0.0f));
  if (disc <= 0.0f) return {kClumpBig, kClumpBig};
  return {-b - sq, -b + sq};
}

// The cell of the (scaled) position q on the clumpy sphere: the first clump
// holding it (cells 0 .. nc-1), else the sphere's cell + nc; -1 outside.
template <bool kLdg>
__device__ __forceinline__ int clumpy_locate(const PolarTabs& g,
                                             const float* cl, int nc,
                                             const float q[3]) {
  const int s = polar_locate<1>(g, q);
  if (s < 0) return -1;
  for (int k = 0; k < nc; ++k) {
    const float* c = cl + 4 * k;
    const float r = clump_at<kLdg>(c, 3);
    const float rel[3] = {q[0] - clump_at<kLdg>(c, 0),
                          q[1] - clump_at<kLdg>(c, 1),
                          q[2] - clump_at<kLdg>(c, 2)};
    if (dot3f(rel, rel) <= r * r) return k;
  }
  return s + nc;
}

// The clumpy sphere (ClumpySphericalGrid.step, skirt9_tpu/grids/clumpy.py:
// 80-97): the Sphere3D step from the located structured cell, cut at the
// first clump entry ahead (> eta); in a clump, out through its far crossing;
// then the relocation. The Sphere3D tables as march_polar_kernel<1> packs
// them, then the clumps (x, y, z, r each, scaled), staged in shared memory
// together when they fit (a thousand clumps are 16 KB), else all read from
// global memory, the clumps through the read-only cache.
template <bool kStaged>
__global__ void march_clumpy_kernel(
    const float* __restrict__ pos, const float* __restrict__ dir,
    const int* __restrict__ cell0, const unsigned char* __restrict__ mask,
    const float* __restrict__ tabs, int* __restrict__ cells,
    float* __restrict__ dss, int B, int S, int nr, int nt, int nphi, int nc,
    float scale, float unscale, int len) {
  extern __shared__ float tables[];
  const float* tab = tabs;
  if (kStaged) {
    for (int k = threadIdx.x; k < len; k += blockDim.x) tables[k] = tabs[k];
    __syncthreads();
    tab = tables;
  }
  constexpr bool kLdg = !kStaged;
  PolarTabs g;
  g.rb = tab;
  g.tb = g.rb + nr + 1;
  g.cos_t = g.tb + nt + 1;
  g.pb = g.cos_t + nt + 1;
  g.cos_p = g.pb + nphi + 1;
  g.sin_p = g.cos_p + nphi + 1;
  g.zb = nullptr;
  g.nr = nr;
  g.nt = nt;
  g.nphi = nphi;
  g.nz = 0;
  const float* cl = g.sin_p + nphi + 1;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const float eta = g.rb[nr] * (float)1e-6;
  float p[3] = {pos[3 * lane] * scale, pos[3 * lane + 1] * scale,
                pos[3 * lane + 2] * scale};
  const float d[3] = {dir[3 * lane], dir[3 * lane + 1], dir[3 * lane + 2]};
  int c = mask[lane] ? cell0[lane] : -1;
  for (int s = 0; s < S; ++s) {
    const long long at = (long long)s * B + lane;
    if (c < 0) {
      cells[at] = 0;
      dss[at] = 0.0f;
      continue;
    }
    float ds;
    if (c < nc) {
      ds = fmaxf(clump_crossing<kLdg>(cl + 4 * c, p, d).t1, 0.0f);
    } else {
      const int sc = polar_locate<1>(g, p);
      ds = sc < 0 ? 0.0f : polar_length<1>(sc, g, eta, p, d);
      float t_entry = kClumpBig;
      for (int k = 0; k < nc; ++k) {
        const float t0 = clump_crossing<kLdg>(cl + 4 * k, p, d).t0;
        t_entry = fminf(t_entry, t0 > eta ? t0 : kClumpBig);
      }
      ds = fminf(ds, t_entry);
    }
    float q[3];
    relocate(ds, eta, p, d, q);
    cells[at] = c;
    dss[at] = ds >= kBig ? ds : ds * unscale;
    c = clumpy_locate<kLdg>(g, cl, nc, q);
  }
}

}  // namespace skirt9

extern "C" int march_amr_launch(const void* pos, const void* dir,
                                const void* cell0, const void* mask,
                                const void* node_lo, const void* node_span,
                                const void* node_div, const void* node_child,
                                const void* node_cell, const void* child_flat,
                                const void* cell_lo, const void* cell_hi,
                                const void* box, void* cells, void* ds, int B,
                                int S, int depth, float nudge, void* stream) {
  if (B <= 0 || S <= 0 || depth < 0 || node_lo == nullptr ||
      node_span == nullptr || node_div == nullptr || node_child == nullptr ||
      node_cell == nullptr || child_flat == nullptr || cell_lo == nullptr ||
      cell_hi == nullptr || box == nullptr)
    return (int)cudaErrorInvalidValue;
  const int blocks = (B + skirt9::kThreads - 1) / skirt9::kThreads;
  skirt9::march_amr_kernel<<<blocks, skirt9::kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const float*)pos, (const float*)dir, (const int*)cell0,
      (const unsigned char*)mask, (const float*)node_lo,
      (const float*)node_span, (const int*)node_div, (const int*)node_child,
      (const int*)node_cell, (const int*)child_flat, (const float*)cell_lo,
      (const float*)cell_hi, (const float*)box, (int*)cells, (float*)ds, B, S,
      depth, nudge);
  return (int)cudaGetLastError();
}

extern "C" int march_curvi_launch(const void* pos, const void* dir,
                                  const void* cell0, const void* mask,
                                  const void* rb, const void* zb, void* cells,
                                  void* ds, int B, int S, int nr, int nz,
                                  int cylinder, int shift, void* stream) {
  if (B <= 0 || S <= 0 || nr <= 0 || rb == nullptr || shift < 0 ||
      shift > 100 || (cylinder && (nz <= 0 || zb == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int len = (nr + 1) + (cylinder ? nz + 1 : 0);
  const bool staged = len <= skirt9::kSmemFloats;
  const float scale = ldexpf(1.0f, -shift), unscale = ldexpf(1.0f, shift);
  const size_t smem = staged ? (size_t)len * sizeof(float) : 0;
  const int blocks = (B + skirt9::kThreads - 1) / skirt9::kThreads;
  auto* kern = cylinder ? skirt9::march_curvi_kernel<true>
                        : skirt9::march_curvi_kernel<false>;
  kern<<<blocks, skirt9::kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)pos, (const float*)dir, (const int*)cell0,
      (const unsigned char*)mask, (const float*)rb, (const float*)zb,
      (int*)cells, (float*)ds, B, S, nr, cylinder ? nz : 0, scale, unscale,
      staged);
  return (int)cudaGetLastError();
}

extern "C" int march_tree_launch(const void* pos, const void* dir,
                                 const void* cell0, const void* mask,
                                 const void* node_child, const void* node_axis,
                                 const void* node_geom, const void* node_cell,
                                 const void* cell_lo, const void* cell_hi,
                                 const void* box, void* cells, void* ds,
                                 int B, int S, int levels, int octree,
                                 void* stream) {
  if (B <= 0 || S <= 0 || levels < 0 || node_child == nullptr ||
      node_geom == nullptr || node_cell == nullptr || cell_lo == nullptr ||
      cell_hi == nullptr || box == nullptr || (!octree && node_axis == nullptr))
    return (int)cudaErrorInvalidValue;
  const int blocks = (B + skirt9::kThreads - 1) / skirt9::kThreads;
  auto* kern = octree ? skirt9::march_tree_kernel<true>
                      : skirt9::march_tree_kernel<false>;
  kern<<<blocks, skirt9::kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)pos, (const float*)dir, (const int*)cell0,
      (const unsigned char*)mask, (const int*)node_child,
      (const int*)node_axis, (const float*)node_geom, (const int*)node_cell,
      (const float*)cell_lo, (const float*)cell_hi, (const float*)box,
      (int*)cells, (float*)ds, B, S, levels);
  return (int)cudaGetLastError();
}

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

extern "C" int march_tetra_launch(const void* pos, const void* dir,
                                  const void* cell0, const void* mask,
                                  const void* face_n, const void* face_d,
                                  const void* nbrs, void* cells, void* ds,
                                  int B, int S, void* stream) {
  if (B <= 0 || S <= 0 || face_n == nullptr || face_d == nullptr ||
      nbrs == nullptr)
    return (int)cudaErrorInvalidValue;
  const int blocks = (B + skirt9::kThreads - 1) / skirt9::kThreads;
  skirt9::march_tetra_kernel<<<blocks, skirt9::kThreads, 0,
                               (cudaStream_t)stream>>>(
      (const float*)pos, (const float*)dir, (const int*)cell0,
      (const unsigned char*)mask, (const float*)face_n, (const float*)face_d,
      (const int*)nbrs, (int*)cells, (float*)ds, B, S);
  return (int)cudaGetLastError();
}

// kind 0: Sphere2D (rb, tb, cos_t), 1: Sphere3D (and pb, cos_p, sin_p), 2:
// Cylinder3D (rb, pb, cos_p, sin_p, zb), packed in that order into `tabs`
// (rb and zb times 2^-shift), an absent table's count 0.
extern "C" int march_polar_launch(const void* pos, const void* dir,
                                  const void* cell0, const void* mask,
                                  const void* tabs, void* cells, void* ds,
                                  int B, int S, int nr, int nt, int nphi,
                                  int nz, int kind, int shift, void* stream) {
  const bool sphere = kind == 0 || kind == 1, azim = kind == 1 || kind == 2;
  if (B <= 0 || S <= 0 || kind < 0 || kind > 2 || nr <= 0 ||
      tabs == nullptr || shift < 0 || shift > 100 || (sphere != (nt > 0)) ||
      (azim ? nphi < 3 : nphi != 0) || ((kind == 2) != (nz > 0)))
    return (int)cudaErrorInvalidValue;
  const auto count = [](int n) { return n > 0 ? n + 1 : 0; };
  const int len = count(nr) + 2 * count(nt) + 3 * count(nphi) + count(nz);
  const bool staged = len <= skirt9::kSmemFloats;
  const float scale = ldexpf(1.0f, -shift), unscale = ldexpf(1.0f, shift);
  const size_t smem = staged ? (size_t)len * sizeof(float) : 0;
  const int blocks = (B + skirt9::kThreads - 1) / skirt9::kThreads;
  auto* kern = kind == 0   ? skirt9::march_polar_kernel<0>
               : kind == 1 ? skirt9::march_polar_kernel<1>
                           : skirt9::march_polar_kernel<2>;
  kern<<<blocks, skirt9::kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)pos, (const float*)dir, (const int*)cell0,
      (const unsigned char*)mask, (const float*)tabs, (int*)cells,
      (float*)ds, B, S, nr, nt, nphi, nz, scale, unscale, len, staged);
  return (int)cudaGetLastError();
}

// The clumpy sphere: the Sphere3D tables (rb, tb, cos_t, pb, cos_p, sin_p)
// then nc clumps (x, y, z, r), packed in that order into `tabs`, every
// length times 2^-shift.
extern "C" int march_clumpy_launch(const void* pos, const void* dir,
                                   const void* cell0, const void* mask,
                                   const void* tabs, void* cells, void* ds,
                                   int B, int S, int nr, int nt, int nphi,
                                   int nc, int shift, void* stream) {
  if (B <= 0 || S <= 0 || nr <= 0 || nt <= 0 || nphi < 3 || nc < 0 ||
      tabs == nullptr || shift < 0 || shift > 100)
    return (int)cudaErrorInvalidValue;
  const long long len =
      (long long)(nr + 1) + 2LL * (nt + 1) + 3LL * (nphi + 1) + 4LL * nc;
  const bool staged = len <= skirt9::kSmemFloats;
  const float scale = ldexpf(1.0f, -shift), unscale = ldexpf(1.0f, shift);
  const size_t smem = staged ? (size_t)len * sizeof(float) : 0;
  const int blocks = (B + skirt9::kThreads - 1) / skirt9::kThreads;
  auto* kern = staged ? skirt9::march_clumpy_kernel<true>
                      : skirt9::march_clumpy_kernel<false>;
  kern<<<blocks, skirt9::kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)pos, (const float*)dir, (const int*)cell0,
      (const unsigned char*)mask, (const float*)tabs, (int*)cells,
      (float*)ds, B, S, nr, nt, nphi, nc, scale, unscale, (int)len);
  return (int)cudaGetLastError();
}
