// Peel-off detection into one distant instrument, in one launch: SED row,
// Monte Carlo statistics and frame, and in its Stokes mode the Stokes Q, U,
// V of the SED and the frame.
//
// Replaces, on the simulation paths, the seven calls per detection of the
// Pallas TPU kernel skirt9_tpu/ops/scatteradd.py `_kernel` (the SED row, the
// five statistics rows and the frame of skirt9_tpu/instruments/distant.py
// `detect`), and the six more of a polarized detection (:214-217, 240-247),
// with the elementwise work around them. Contract (instruments/distant.py
// `detect_plain`), per lane: the wavelength bin b = #(borders <= lam) - 1;
// ok = active & 0 <= b < nb & contrib > 0; c = ok ? contrib : 0;
// sed[kind, b] += c; stats[:, b] += (ok, cn, cn^2, cn cn^2, cn^2 cn^2) with
// cn = c * inv_scale; the position projected on the frame axes gives pixel
// (ix, iy), and frame[kind, b, iy, ix] += contrib where ok and the pixel
// lies inside the frame. In the Stokes mode (quv, (B, 3), given) also
// sed_quv[i, b] += quv_i c and, where frame_quv is given (not for the
// transparent kind), frame_quv[i, b, iy, ix] += quv_i contrib where the
// frame takes the lane. Sums go in place into the accumulators.
//
// What bounds it on the H100: not the card (B = 131,072 lanes read 3.7 MB,
// about 0.001 ms of HBM time) but the host: the seven-call form took 1-2 ms
// per call for its 79 device launches (PERF.md §6). Design: grid-stride
// blocks of 1024 threads, one per SM at most. The borders sit in shared
// memory for a binary search. The SED row and the five statistics rows
// (6 nb bins) are a block-private f64 table in shared memory; the frame (4,096
// and 163,840 bins on configs 1 and 2, sparsely hit) takes global atomics: a
// block-private copy does not pay at that density (PERF.md §6: the probe's
// 32,768-bin shared-memory scatter loses to global atomics). Both
// aggregate per warp first, since many lanes hit one address (config 1's
// single bin takes every lane, an emission peel-off from a point source one
// pixel): a warp with at most kGroups distinct keys sums each group with
// shuffles and adds once, otherwise each lane adds. Lanes that add nothing
// keep the bin they would have (the plain version's clamped bin) with zero
// values, so that they do not split the warp's group.
//
// The Stokes mode is the same launch with three more rows in the table (9 nb
// entries) and three more cubes in the scratch: a warp's group sums its
// lanes' Stokes values beside the intensity, with the same shuffles.
//
// The call's sums start from zero, as the seven-call form's did, and reach
// the run's accumulators once per bin: adding every block's or warp's part
// straight into a run-long sum rounds the same way thousands of times when
// the parts are equal (1.8e-5 on config 1's transparent SED). The table's
// sums (SED, statistics and Stokes rows) are f64 from the lanes' f32 terms
// on, in the warps' shuffles, in shared memory and in `scratch.table`, and
// round to f32 once per call: the blocks' and warps' parts add in an order
// that varies from run to run, which with f32 parts moved whole runs'
// SEDs by ~1e-10 (two runs of bench1 on an H100), and in f64 moves a
// call's sum by ~1e-16, which its rounding to f32 absorbs. So a call's
// table is the f64 sum of its terms rounded once, as the plain version
// summed in f64 gives it (`scatter_f64` in the tests).
// The last block adds the table's nonzero sums into the accumulators and
// zeroes them. The frame and the Stokes cubes, too large for that, add in
// f32 into `scratch.sum` (frame cube, then the Stokes cubes), which
// is zero on entry, and list each entry they touch, once: a flag per entry
// set to the call's epoch decides, not the sum, since global float atomics
// flush a subnormal addend (a cn^4 sum in a Wien-tail bin) to zero, so that
// a sum can stay zero after an add, and a Stokes sum is signed and can
// cancel to zero. The last block to finish (a ticket after a memory
// fence) adds the listed entries into the accumulators and zeroes their
// sums, leaving the scratch zero for the next call, whose new epoch clears
// the flags without a write. It takes four entries per thread at a time,
// so that their atomics and loads overlap: on config 2 it alone flushes
// ~21,000 frame entries.
//
// The pixel arithmetic is the reference's XLA arithmetic on the CPU
// (`frame_pixels`, the plain version): xp = fma(z, ex2, fma(y, ex1, x ex0))
// - cx, then fma(xp, 1/fovx, 0.5) with the float reciprocal of the float
// field of view, which the wrapper passes, times npx rounded on its own.
// The frame's float atomics make its sums order-dependent from run to run.
#include "scatter_common.cuh"

namespace skirt9 {

constexpr int kGroups = 4;

struct Frame {
  float ex[3], ey[3];
  float cx, cy, inv_fovx, inv_fovy;
  int npx, npy;
};

// The call's scratch: per-entry f32 sums of the cubes (zero on entry and
// on exit) and flags (the epoch of the last call that listed the entry),
// the list of this call's entries, {blocks done, listed} (zero on entry and
// on exit), the table's f64 sums (zero on entry and on exit), and this
// call's epoch, which no flag holds on entry.
struct Scratch {
  float* sum;
  int* flag;
  int* list;
  int* counts;
  double* table;
  int epoch;
};

// Add v into sum[j] and append j to the list the first time an add reaches
// it; all 32 lanes of the warp must call, with add = false where they have
// nothing to add. An entry whose sum was nonzero before this add was
// reached before, so it is listed already: only an add that finds the sum
// zero (never reached, or a signed Stokes sum that cancelled) consults the
// flag, and the flag lists the entry once.
__device__ __forceinline__ void add_listed(const Scratch& s, bool add, int j,
                                           float v) {
  const bool first = add && atomicAdd(s.sum + j, v) == 0.0f &&
                     atomicExch(s.flag + j, s.epoch) != s.epoch;
  const unsigned m = __ballot_sync(kFull, first);
  if (m == 0) return;
  const int lane = threadIdx.x & 31, leader = __ffs(m) - 1;
  int pos = 0;
  if (lane == leader) pos = atomicAdd(s.counts + 1, __popc(m));
  pos = __shfl_sync(kFull, pos, leader);
  if (first) s.list[pos + __popc(m & ((1u << lane) - 1u))] = j;
}

// Sum of v over the warp in f64; the total is valid in lane 0.
__device__ __forceinline__ double warp_sum_d(double v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

// The first lane of each group of lanes with an equal key >= 0, as a mask;
// all 32 lanes of the warp must call.
__device__ __forceinline__ unsigned group_heads(int key) {
  const unsigned same = __match_any_sync(kFull, key);
  return __ballot_sync(kFull, key >= 0 &&
                                  (threadIdx.x & 31) == __ffs(same) - 1);
}

// Which rows of the table a call fills: the SED row 0, the statistics rows
// 1-5 where stats are recorded, the Stokes rows 6-8 in the Stokes mode.
__device__ __forceinline__ bool row_on(int r, bool stats, bool quv) {
  return r == 0 || (r < 6 ? stats : quv);
}

// lam, contrib: (B,); pos: (B, 3); active: (B,) bytes; quv: (B, 3) or null
// (the Stokes mode); borders: (nb + 1,); sed: the kind's (nb,) row; stats:
// (5, nb) or null; frame: the kind's (nb, npy, npx) cube or null; sed_quv:
// (3, nb), given with quv; frame_quv: (3, nb, npy, npx) or null; scratch:
// sums, flags and list of rows nb + the cubes' bins each, and the table's
// rows nb f64 sums, rows = 9 in the Stokes mode, else 6.
__global__ void detect_kernel(const float* __restrict__ lam,
                              const float* __restrict__ pos,
                              const float* __restrict__ contrib,
                              const unsigned char* __restrict__ active,
                              const float* __restrict__ quv,
                              const float* __restrict__ borders, int nb,
                              float inv_scale, Frame f,
                              float* __restrict__ sed,
                              float* __restrict__ stats,
                              float* __restrict__ frame,
                              float* __restrict__ sed_quv,
                              float* __restrict__ frame_quv, Scratch scr,
                              int B) {
  extern __shared__ double smem[];
  const bool has_stats = stats != nullptr, has_quv = quv != nullptr;
  const int rows = has_quv ? 9 : 6;
  // scratch.sum layout: the table's rows (unused), the frame cube, the 3
  // Stokes cubes
  const int cube = frame != nullptr ? nb * f.npy * f.npx : 0;
  const int frame0 = rows * nb, quv0 = frame0 + cube;
  double* table = smem;             // SED row, 5 statistics, 3 Stokes rows
  float* bord = (float*)(smem + rows * nb);   // nb + 1 borders
  __shared__ int last, listed;
  for (int i = threadIdx.x; i <= nb; i += blockDim.x) bord[i] = borders[i];
  for (int i = threadIdx.x; i < rows * nb; i += blockDim.x) table[i] = 0.0;
  __syncthreads();

  const int stride = gridDim.x * blockDim.x;
  // base is uniform across the block, so whole warps iterate together
  for (int base = blockIdx.x * blockDim.x; base < B; base += stride) {
    const int i = base + threadIdx.x;
    const bool in = i < B;
    const float v = in ? contrib[i] : 0.0f;
    int b = -1;
    if (in) {
      // searchsorted(borders, lam, right=True) - 1
      const float x = lam[i];
      int lo = 0, hi = nb + 1;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (bord[mid] <= x) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      b = lo - 1;
    }
    const bool ok = in && active[i] != 0 && b >= 0 && b < nb && v > 0.0f;
    const float c = ok ? v : 0.0f;
    const float cn = c * inv_scale;
    const float cn2 = cn * cn;
    // the lane's Stokes values, read only in the Stokes mode
    float q[3] = {0.0f, 0.0f, 0.0f};
    if (has_quv && in) {
      q[0] = quv[3 * i];
      q[1] = quv[3 * i + 1];
      q[2] = quv[3 * i + 2];
    }
    const float row[9] = {c,        ok ? 1.0f : 0.0f, cn,
                          cn2,      cn * cn2,         cn2 * cn2,
                          q[0] * c, q[1] * c,         q[2] * c};

    const int lane = threadIdx.x & 31;
    const int key = in ? min(max(b, 0), nb - 1) : -1;
    unsigned heads = group_heads(key);
    if (__popc(heads) <= kGroups) {
      for (; heads != 0; heads &= heads - 1) {
        const int k = __shfl_sync(kFull, key, __ffs(heads) - 1);
#pragma unroll
        for (int r = 0; r < 9; ++r) {
          if (row_on(r, has_stats, has_quv)) {
            const double s = warp_sum_d(key == k ? (double)row[r] : 0.0);
            if (lane == 0 && s != 0.0) atomicAdd(table + r * nb + k, s);
          }
        }
      }
    } else if (ok) {
#pragma unroll
      for (int r = 0; r < 9; ++r)
        if (row_on(r, has_stats, has_quv) && row[r] != 0.0f)
          atomicAdd(table + r * nb + b, (double)row[r]);
    }

    if (frame != nullptr) {
      int pix = -1;
      if (ok) {
        const float px = pos[3 * i], py = pos[3 * i + 1], pz = pos[3 * i + 2];
        // the reference's XLA arithmetic, every rounding spelled out so
        // that nvcc contracts nothing on its own
        const float xp = __fsub_rn(
            __fmaf_rn(pz, f.ex[2], __fmaf_rn(py, f.ex[1], __fmul_rn(px, f.ex[0]))),
            f.cx);
        const float yp = __fsub_rn(
            __fmaf_rn(pz, f.ey[2], __fmaf_rn(py, f.ey[1], __fmul_rn(px, f.ey[0]))),
            f.cy);
        const float ix =
            floorf(__fmul_rn(__fmaf_rn(xp, f.inv_fovx, 0.5f), (float)f.npx));
        const float iy =
            floorf(__fmul_rn(__fmaf_rn(yp, f.inv_fovy, 0.5f), (float)f.npy));
        if (ix >= 0.0f && ix < (float)f.npx && iy >= 0.0f &&
            iy < (float)f.npy)
          pix = (b * f.npy + (int)iy) * f.npx + (int)ix;
      }
      const bool fq = frame_quv != nullptr;
      unsigned pheads = group_heads(pix);
      if (__popc(pheads) <= kGroups) {
        for (; pheads != 0; pheads &= pheads - 1) {
          const int k = __shfl_sync(kFull, pix, __ffs(pheads) - 1);
          const float s = warp_sum(pix == k ? c : 0.0f);
          add_listed(scr, lane == 0, frame0 + k, s);
          if (fq) {
#pragma unroll
            for (int r = 0; r < 3; ++r) {
              const float sq = warp_sum(pix == k ? row[6 + r] : 0.0f);
              add_listed(scr, lane == 0, quv0 + r * cube + k, sq);
            }
          }
        }
      } else {
        add_listed(scr, pix >= 0, frame0 + pix, c);
        if (fq) {
#pragma unroll
          for (int r = 0; r < 3; ++r)
            add_listed(scr, pix >= 0, quv0 + r * cube + pix, row[6 + r]);
        }
      }
    }
  }
  __syncthreads();
  // the block's table into the call's f64 sums
  for (int i = threadIdx.x; i < rows * nb; i += blockDim.x) {
    const double h = table[i];
    if (h != 0.0) atomicAdd(scr.table + i, h);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(scr.counts, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // the last block: every other block fenced its sums before its ticket;
  // the flags list each entry once, so no two threads share a target
  if (threadIdx.x == 0) listed = atomicAdd(scr.counts + 1, 0);
  __syncthreads();
  // the table's sums, each rounded to f32 once (a row that is not on stays
  // zero)
  for (int j = threadIdx.x; j < rows * nb; j += blockDim.x) {
    const double v = __ldcg(scr.table + j);
    if (v != 0.0) {
      float* dst = j < nb ? sed + j : j < 6 * nb ? stats + (j - nb)
                                                 : sed_quv + (j - 6 * nb);
      *dst = *dst + __double2float_rn(v);
      scr.table[j] = 0.0;
    }
  }
  constexpr int kPer = 4;
  for (int k0 = threadIdx.x; k0 < listed; k0 += kPer * blockDim.x) {
    float* dst[kPer];
    float v[kPer], old[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int k = k0 + u * blockDim.x;
      const int j = k < listed ? __ldcg(scr.list + k) : -1;
      dst[u] = j < 0      ? nullptr
               : j < quv0 ? frame + (j - frame0)
                          : frame_quv + (j - quv0);
      v[u] = j < 0 ? 0.0f : atomicExch(scr.sum + j, 0.0f);
    }
    // the targets are distinct, so every load may precede every store
#pragma unroll
    for (int u = 0; u < kPer; ++u) old[u] = dst[u] ? *dst[u] : 0.0f;
#pragma unroll
    for (int u = 0; u < kPer; ++u)
      if (dst[u]) *dst[u] = old[u] + v[u];
  }
  if (threadIdx.x == 0) {
    scr.counts[0] = 0;
    scr.counts[1] = 0;
  }
}

}  // namespace skirt9

extern "C" int detect_launch(const void* lam, const void* pos,
                             const void* contrib, const void* active,
                             const void* quv, const void* borders, void* sed,
                             void* stats, void* frame, void* sed_quv,
                             void* frame_quv, void* sums, void* flags,
                             void* list, void* counts, void* table, int B,
                             int nb, int npx,
                             int npy, int epoch, float inv_scale, float ex0,
                             float ex1, float ex2, float ey0, float ey1,
                             float ey2, float cx, float cy, float inv_fovx,
                             float inv_fovy, void* stream) {
  using namespace skirt9;
  // the Stokes mode takes the SED's Stokes rows, and the frame's cubes
  // only with a frame
  if (B < 0 || nb < 1 || (frame != nullptr && (npx < 1 || npy < 1)) ||
      sums == nullptr || flags == nullptr || list == nullptr ||
      counts == nullptr || table == nullptr || epoch == 0 ||
      (quv == nullptr) != (sed_quv == nullptr) ||
      (frame_quv != nullptr && (quv == nullptr || frame == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int rows = quv != nullptr ? 9 : 6;
  const size_t smem =
      (size_t)rows * nb * sizeof(double) + (size_t)(nb + 1) * sizeof(float);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        detect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  Frame f{{ex0, ex1, ex2}, {ey0, ey1, ey2}, cx, cy, inv_fovx, inv_fovy,
          npx, npy};
  const int threads = 1024;
  int blocks = (B + threads - 1) / threads;
  // one block per SM of an H100 at most; each strides over the rest, so the
  // table costs few atomics and the last block flushes with 1024 threads
  if (blocks > 132) blocks = 132;
  detect_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const float*)lam, (const float*)pos, (const float*)contrib,
      (const unsigned char*)active, (const float*)quv, (const float*)borders,
      nb, inv_scale, f, (float*)sed, (float*)stats, (float*)frame,
      (float*)sed_quv, (float*)frame_quv,
      Scratch{(float*)sums, (int*)flags, (int*)list, (int*)counts,
              (double*)table, epoch},
      B);
  return (int)cudaGetLastError();
}
