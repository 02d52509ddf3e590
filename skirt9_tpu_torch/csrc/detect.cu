// Peel-off detection into one distant instrument, in one launch: SED row,
// Monte Carlo statistics and frame.
//
// Replaces, on the simulation paths, the seven calls per detection of the
// Pallas TPU kernel skirt9_tpu/ops/scatteradd.py `_kernel` (the SED row, the
// five statistics rows and the frame of skirt9_tpu/instruments/distant.py
// `detect`) with the elementwise work around them. Contract
// (instruments/distant.py `detect_plain`), per lane: the wavelength bin
// b = #(borders <= lam) - 1; ok = active & 0 <= b < nb & contrib > 0;
// c = ok ? contrib : 0; sed[kind, b] += c; stats[:, b] += (ok, cn, cn^2,
// cn cn^2, cn^2 cn^2) with cn = c * inv_scale; the position projected on the
// frame axes gives pixel (ix, iy), and frame[kind, b, iy, ix] += contrib
// where ok and the pixel lies inside the frame. Sums go in place into the
// accumulators.
//
// What bounds it on the H100: not the card (B = 131,072 lanes read 3.7 MB,
// about 0.001 ms of HBM time) but the host: the seven-call form took 1-2 ms
// per call for its 79 device launches (PERF.md §6). Design: grid-stride
// blocks of 1024 threads, one per SM at most. The borders sit in shared
// memory for a binary search. The SED row and the five statistics rows
// (6 nb bins) are a block-private table in shared memory; the frame (4,096
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
// The call's sums start from zero, as the seven-call form's did, and reach
// the run's accumulators once per bin: adding every block's or warp's part
// straight into a run-long sum rounds the same way thousands of times when
// the parts are equal (1.8e-5 on config 1's transparent SED). So the blocks
// add into `scratch` (table, then frame cube), which is zero on entry, and
// list each entry they touch, once: a flag per entry set to the call's
// epoch decides, not the sum, since global float atomics flush a subnormal
// addend (a cn^4 sum in a Wien-tail bin) to zero, so that a sum can stay
// zero after an add. The last block to finish (a ticket after a memory
// fence) adds the listed entries into the accumulators and zeroes their
// sums, leaving the scratch zero for the next call, whose new epoch clears
// the flags without a write. It takes four entries per thread at a time,
// so that their atomics and loads overlap: on config 2 it alone flushes
// ~21,000 frame entries.
//
// The pixel arithmetic is PyTorch's on the card: xp = ((x ex0 + y ex1) +
// z ex2) - cx, then a division by a host scalar as a multiply by its float
// reciprocal, which the wrapper passes. Float atomics make the sums
// order-dependent from run to run.
#include "scatter_common.cuh"

namespace skirt9 {

constexpr int kGroups = 4;

struct Frame {
  float ex[3], ey[3];
  float cx, cy, inv_fovx, inv_fovy;
  int npx, npy;
};

// The call's scratch: per-entry sums (zero on entry and on exit) and flags
// (the epoch of the last call that listed the entry), the list of this
// call's entries, {blocks done, listed} (zero on entry and on exit), and
// this call's epoch, which no flag holds on entry.
struct Scratch {
  float* sum;
  int* flag;
  int* list;
  int* counts;
  int epoch;
};

// Add v (>= 0) into sum[j] and append j to the list the first time an add
// reaches it; all 32 lanes of the warp must call, with add = false where
// they have nothing to add. Sums only grow, so an entry whose sum was
// nonzero before this add is listed already, and only an add that finds it
// zero consults the flag.
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

// The first lane of each group of lanes with an equal key >= 0, as a mask;
// all 32 lanes of the warp must call.
__device__ __forceinline__ unsigned group_heads(int key) {
  const unsigned same = __match_any_sync(kFull, key);
  return __ballot_sync(kFull, key >= 0 &&
                                  (threadIdx.x & 31) == __ffs(same) - 1);
}

// lam, contrib: (B,); pos: (B, 3); active: (B,) bytes; borders: (nb + 1,);
// sed: the kind's (nb,) row; stats: (5, nb) or null; frame: the kind's
// (nb, npy, npx) cube or null; scratch: sums, flags and list of 6 nb + the
// cube's bins each.
__global__ void detect_kernel(const float* __restrict__ lam,
                              const float* __restrict__ pos,
                              const float* __restrict__ contrib,
                              const unsigned char* __restrict__ active,
                              const float* __restrict__ borders, int nb,
                              float inv_scale, Frame f,
                              float* __restrict__ sed,
                              float* __restrict__ stats,
                              float* __restrict__ frame, Scratch scr,
                              int B) {
  extern __shared__ float smem[];
  float* bord = smem;               // nb + 1 borders
  float* table = smem + nb + 1;     // SED row, then the 5 statistics rows
  __shared__ int last, listed;
  const int nrows = stats != nullptr ? 6 : 1;
  for (int i = threadIdx.x; i <= nb; i += blockDim.x) bord[i] = borders[i];
  for (int i = threadIdx.x; i < nrows * nb; i += blockDim.x) table[i] = 0.0f;
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
    const float row[6] = {c, ok ? 1.0f : 0.0f, cn, cn2, cn * cn2, cn2 * cn2};

    const int lane = threadIdx.x & 31;
    const int key = in ? min(max(b, 0), nb - 1) : -1;
    unsigned heads = group_heads(key);
    if (__popc(heads) <= kGroups) {
      for (; heads != 0; heads &= heads - 1) {
        const int k = __shfl_sync(kFull, key, __ffs(heads) - 1);
#pragma unroll
        for (int r = 0; r < 6; ++r) {
          if (r < nrows) {
            const float s = warp_sum(key == k ? row[r] : 0.0f);
            if (lane == 0 && s != 0.0f) atomicAdd(table + r * nb + k, s);
          }
        }
      }
    } else if (ok) {
#pragma unroll
      for (int r = 0; r < 6; ++r)
        if (r < nrows && row[r] != 0.0f) atomicAdd(table + r * nb + b, row[r]);
    }

    if (frame != nullptr) {
      int pix = -1;
      if (ok) {
        const float px = pos[3 * i], py = pos[3 * i + 1], pz = pos[3 * i + 2];
        const float xp = ((px * f.ex[0] + py * f.ex[1]) + pz * f.ex[2]) - f.cx;
        const float yp = ((px * f.ey[0] + py * f.ey[1]) + pz * f.ey[2]) - f.cy;
        const float ix = floorf((xp * f.inv_fovx + 0.5f) * (float)f.npx);
        const float iy = floorf((yp * f.inv_fovy + 0.5f) * (float)f.npy);
        if (ix >= 0.0f && ix < (float)f.npx && iy >= 0.0f &&
            iy < (float)f.npy)
          pix = (b * f.npy + (int)iy) * f.npx + (int)ix;
      }
      unsigned pheads = group_heads(pix);
      if (__popc(pheads) <= kGroups) {
        for (; pheads != 0; pheads &= pheads - 1) {
          const int k = __shfl_sync(kFull, pix, __ffs(pheads) - 1);
          const float s = warp_sum(pix == k ? c : 0.0f);
          add_listed(scr, lane == 0, 6 * nb + k, s);
        }
      } else {
        add_listed(scr, pix >= 0, 6 * nb + pix, c);
      }
    }
  }
  __syncthreads();
  // the block's table into the call's sums (whole warps iterate together)
  for (int base = 0; base < nrows * nb; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const float h = i < nrows * nb ? table[i] : 0.0f;
    add_listed(scr, h != 0.0f, i, h);
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
  constexpr int kPer = 4;
  for (int k0 = threadIdx.x; k0 < listed; k0 += kPer * blockDim.x) {
    float* dst[kPer];
    float v[kPer], old[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int k = k0 + u * blockDim.x;
      const int j = k < listed ? __ldcg(scr.list + k) : -1;
      dst[u] = j < 0 ? nullptr
                     : (j < nb ? sed + j
                               : (j < 6 * nb ? stats + (j - nb)
                                             : frame + (j - 6 * nb)));
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
                             const void* borders, void* sed, void* stats,
                             void* frame, void* sums, void* flags,
                             void* list, void* counts, int B, int nb, int npx,
                             int npy, int epoch, float inv_scale, float ex0, float ex1, float ex2,
                             float ey0, float ey1, float ey2, float cx,
                             float cy, float inv_fovx, float inv_fovy,
                             void* stream) {
  using namespace skirt9;
  if (B < 0 || nb < 1 || (frame != nullptr && (npx < 1 || npy < 1)) ||
      sums == nullptr || flags == nullptr || list == nullptr ||
      counts == nullptr || epoch == 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = (size_t)(nb + 1 + 6 * nb) * sizeof(float);
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
      (const unsigned char*)active, (const float*)borders, nb, inv_scale, f,
      (float*)sed, (float*)stats, (float*)frame,
      Scratch{(float*)sums, (int*)flags, (int*)list, (int*)counts, epoch},
      B);
  return (int)cudaGetLastError();
}
