// The f32 sine and cosine of n values as glibc 2.36's sinf and cosf compute
// them (sysdeps/ieee754/flt-32/s_sinf.c, s_cosf.c, sincosf.h), the
// __sinf_fma/__cosf_fma variants that x86-64 glibc picks on a CPU with FMA
// and AVX2, whose f64 `a + x * b` are fused multiply-adds. XLA's CPU code
// calls them for f32 sin and cos, so the reference's directions and
// rotations take these bits.
//
// Not a TPU kernel: the plain version, ops/xlamath.py `sincos_plain`, writes
// the same function out in ~140 PyTorch operations (its f64 FMAs by
// TwoProduct and rounding to odd, `fma64`), which the event loop would
// launch at every launch and scattering. Here one thread per value does it
// in registers, each fused multiply-add one __fma_rn (rounded once, as the
// plain version's fma64 and the x86 vfmadd round), every other operation
// rounded alone (-fmad=false), so the card and the plain version agree bit
// for bit. Past |x| = 120 (outside every draw site but the polarized
// azimuth's Newton iterates) both take f64's sin and cos rounded to f32.
#include <cuda_runtime.h>

namespace skirt9 {

// cosine coefficients c0..c4 and sine s1..s3 (sincosf_data.c); the table of
// quadrants 2 and 3 negates the cosine's
__constant__ double kSinCosC[5] = {
    0x1p0, -0x1.ffffffd0c621cp-2, 0x1.55553e1068f19p-5,
    -0x1.6c087e89a359dp-10, 0x1.99343027bf8c3p-16};
__constant__ double kSinCosS[3] = {-0x1.555545995a603p-3,
                                   0x1.1107605230bc4p-7,
                                   -0x1.994eb3774cf24p-13};

__device__ __forceinline__ void sincosf_glibc(float y, float* sp,
                                              float* cp) {
  const int top = (__float_as_int(y) >> 20) & 0x7ff;
  const double x = (double)y;
  if (top >= 0x42f) {  // |y| >= 120: outside reduce_fast
    *sp = (float)sin(x);
    *cp = (float)cos(x);
    return;
  }
  if (top < 0x398) {  // |y| < 2^-12
    *sp = y;
    *cp = 1.0f;
    return;
  }
  // reduce_fast: n from x 2/pi 2^24, truncated, plus 2^23, shifted down 24
  // bits (0 below 0.75, where glibc skips the reduction); x - n pi/2 fused
  const int n = (__double2int_rz(__dmul_rn(x, 0x1.45f306dc9c883p+23)) +
                 0x800000) >> 24;
  const double xr = __fma_rn(-(double)n, 0x1.921fb54442d18p0, x);
  const int q = n & 3;
  const double xs = (q == 1 || q == 2) ? -xr : xr;
  const double x2 = __dmul_rn(xr, xr);
  const double x3 = __dmul_rn(xs, x2);
  const double x4 = __dmul_rn(x2, x2);
  // sinf_poly: the sine's s1 = s2 + x2 s3, s = x + x3 s1, x + ... + x5 s1;
  // the cosine's c2 = c3 + x2 c4, c1 = c0 + x2 c1, c = c1 + x4 c2,
  // c + x6 c2
  const double s1 = __fma_rn(x2, kSinCosS[2], kSinCosS[1]);
  const double c2 = __fma_rn(x2, kSinCosC[4], kSinCosC[3]);
  const double c1 = __fma_rn(x2, kSinCosC[1], kSinCosC[0]);
  const double s = __fma_rn(x3, kSinCosS[0], xs);
  const double c = __fma_rn(x4, kSinCosC[2], c1);
  const float sv = (float)__fma_rn(__dmul_rn(x3, x2), s1, s);
  float cv = (float)__fma_rn(__dmul_rn(x4, x2), c2, c);
  if (n & 2) cv = -cv;
  const bool odd = n & 1;
  *sp = odd ? cv : sv;
  *cp = odd ? sv : cv;
}

__global__ void sincos_kernel(const float* __restrict__ x,
                              float* __restrict__ s, float* __restrict__ c,
                              int n) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float sv, cv;
    sincosf_glibc(x[i], &sv, &cv);
    s[i] = sv;
    c[i] = cv;
  }
}

constexpr int kHgTail = 8;

__global__ void hg_direction_kernel(const float* __restrict__ k,
                                    const float* __restrict__ g,
                                    const float* __restrict__ u_ct,
                                    const float* __restrict__ u_phi,
                                    float* __restrict__ out, int n) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    // cos(theta): isotropic for |g| < 1e-5; 1 - g^2, 1 - g + 2 g u,
    // 1 + g^2 and 1 + g^2 - f^2 each one fused multiply-add
    const float gi = g[i], u = u_ct[i];
    const bool iso = fabsf(gi) < 1e-5f;
    const float gs = iso ? 0.5f : gi;
    const float f = __fdiv_rn(__fmaf_rn(-gs, gs, 1.0f),
                              __fmaf_rn(2.0f * gs, u, 1.0f - gs));
    const float ct_aniso = __fdiv_rn(
        __fmaf_rn(-f, f, __fmaf_rn(gs, gs, 1.0f)), 2.0f * gs);
    const float ct = fminf(fmaxf(iso ? 2.0f * u - 1.0f : ct_aniso, -1.0f),
                           1.0f);
    // the frame about k: e1 = (1 + s kx^2 a, s b, -s kx), e2 = (b, s +
    // ky^2 a, -ky), a = -1 / (s + kz), b = kx ky a
    const float kx = k[3 * i], ky = k[3 * i + 1], kz = k[3 * i + 2];
    const float sg = kz >= 0.0f ? 1.0f : -1.0f;
    const float a = __fdiv_rn(-1.0f, sg + kz);
    const float b = kx * ky * a;
    const float e1x = __fmaf_rn(sg * kx * kx, a, 1.0f), e1y = sg * b,
                e1z = -sg * kx;
    const float e2x = b, e2y = __fmaf_rn(ky * ky, a, sg), e2z = -ky;
    const float st = __fsqrt_rn(fmaxf(__fmaf_rn(-ct, ct, 1.0f), 0.0f));
    float sp, cp;
    sincosf_glibc(6.283185307179586f * u_phi[i], &sp, &cp);
    const float ix = __fmaf_rn(cp, e1x, sp * e2x);
    const float iy = __fmaf_rn(cp, e1y, sp * e2y);
    const float iz = __fmaf_rn(cp, e1z, sp * e2z);
    float ox, oy;
    if (i >= n - kHgTail) {
      ox = __fmaf_rn(ct, kx, st * ix);
      oy = __fmaf_rn(ct, ky, st * iy);
    } else {
      ox = __fmaf_rn(st, ix, ct * kx);
      oy = __fmaf_rn(st, iy, ct * ky);
    }
    const float oz = __fmaf_rn(ct, kz, st * iz);
    const float norm = __fsqrt_rn(__fmaf_rn(oz, oz, __fmaf_rn(oy, oy,
                                                               ox * ox)));
    out[3 * i] = __fdiv_rn(ox, norm);
    out[3 * i + 1] = __fdiv_rn(oy, norm);
    out[3 * i + 2] = __fdiv_rn(oz, norm);
  }
}

}  // namespace skirt9

extern "C" int hg_direction_launch(const void* k, const void* g,
                                   const void* u_ct, const void* u_phi,
                                   void* out, int n, void* stream) {
  if (n < 0 || (n > 0 && (k == nullptr || g == nullptr || u_ct == nullptr ||
                          u_phi == nullptr || out == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads < 4096
                         ? (n + threads - 1) / threads
                         : 4096;
  skirt9::hg_direction_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)k, (const float*)g, (const float*)u_ct,
      (const float*)u_phi, (float*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int sincos_launch(const void* x, void* s, void* c, int n,
                             void* stream) {
  if (n < 0 || (n > 0 && (x == nullptr || s == nullptr || c == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads < 4096
                         ? (n + threads - 1) / threads
                         : 4096;
  skirt9::sincos_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)s, (float*)c, n);
  return (int)cudaGetLastError();
}
