// XLA's f32 exp, expm1, log and log1p on the CPU, as the reference's life
// cycle computes them, in the two places of every event loop where they
// decide a discrete outcome: the interaction optical depth of forced
// scattering with its bias weight (skirt9_tpu/transport/lifecycle.py:286
// sample_interaction_tau, over ops/rng.py expon_cutoff) and the scan
// march's deposit factor (1 - e^-dtau) ds / dtau per step (lifecycle.py:
// 239-242). XLA's CPU code evaluates exp and log by Cephes' polynomials,
// expm1 as exp(x) - 1 or tanh(x/2) (exp(x) + 1) with its own rational
// tanh, and log1p by a rational approximation near 0.
//
// Not a TPU kernel: the plain versions, ops/xlamath.py `exp_xla`,
// `expm1_xla`, `tanh_xla`, `log_xla`, `log1p_xla`, write these out in ~350
// PyTorch operations a call (each fused multiply-add `xlamath.fma`: the
// f32 operands' product and sum in f64, rounded to f32), which every event
// would launch. Here one thread per value does it in registers, each
// `xlamath.fma` the same f64 product and sum rounded to f32
// (__dmul_rn, __dadd_rn, __double2float_rn), every other operation rounded
// alone (-fmad=false), so the card and the plain versions agree bit for
// bit.
#include <cuda_runtime.h>

namespace skirt9 {

__device__ __forceinline__ float xfma(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

// Cephes' expf: e^x = 2^n e^r, n = floor(x log2(e) + 1/2), r reduced in two
// parts of ln 2, e^r a degree-5 polynomial (xlamath._EXPF_*)
__device__ __forceinline__ float exp_xla(float x) {
  const float lo = -0x1.5f3334p+6f, hi = 0x1.633334p+6f;
  x = fminf(fmaxf(x, lo), hi);
  float n = floorf(xfma(x, 0x1.715476p+0f, 0.5f));
  n = fminf(fmaxf(n, -127.0f), 127.0f);
  float r = xfma(n, -0x1.63p-1f, x);
  r = xfma(n, 0x1.bd0106p-13f, r);
  float y = 0x1.a0d2cep-13f;
  y = xfma(r, y, 0x1.6e879cp-10f);
  y = xfma(r, y, 0x1.111210p-7f);
  y = xfma(r, y, 0x1.555382p-5f);
  y = xfma(r, y, 0x1.555554p-3f);
  y = xfma(r, y, 0.5f);
  y = __fadd_rn(xfma(y, __fmul_rn(r, r), r), 1.0f);
  const float scale = __int_as_float(((int)n + 127) << 23);
  const float out = __fmul_rn(y, scale);
  return out < 0x1p-126f ? 0.0f : out;
}

// XLA's fast tanh: x clamped to +-7.99, a rational function of x^2, x
// itself below 4e-4, +-1 from 20 on (xlamath._TANH_*)
__device__ __forceinline__ float tanh_xla(float x) {
  const float cl = 0x1.ffec88p+2f;
  const float c = fminf(fmaxf(x, -cl), cl);
  const float c2 = __fmul_rn(c, c);
  float p = xfma(c2, -0x1.3e4b8p-52f, 0x1.c266fcp-43f);
  p = xfma(c2, p, -0x1.7a6ffep-34f);
  p = xfma(c2, p, 0x1.b80082p-25f);
  p = xfma(c2, p, 0x1.f28694p-17f);
  p = xfma(c2, p, 0x1.4e1bdap-11f);
  p = xfma(c2, p, 0x1.40b3b8p-8f);
  float q = xfma(c2, 0x1.41a7bp-20f, 0x1.f12bacp-14f);
  q = xfma(c2, q, 0x1.29540ap-9f);
  q = xfma(c2, q, 0x1.40b3bap-8f);
  const float t = fabsf(x) < 0x1.a36e2ep-12f ? x
                  : __fdiv_rn(__fmul_rn(c, p), q);
  return fabsf(x) >= 20.0f ? copysignf(1.0f, x) : t;
}

// XLA's expm1: exp(x) - 1 where |x| > 1/2, else tanh(x/2) (exp(x) + 1), and
// x where x/2 is 0
__device__ __forceinline__ float expm1_xla(float x) {
  const float e = exp_xla(x);
  const float h = __fmul_rn(x, 0.5f);
  const float out = fabsf(x) > 0.5f
                        ? __fsub_rn(e, 1.0f)
                        : __fmul_rn(tanh_xla(h), __fadd_rn(e, 1.0f));
  return h == 0.0f ? x : out;
}

// Cephes' logf (xlamath.log_xla): the mantissa in [sqrt(1/2), sqrt(2)),
// its polynomial in an Estrin order
__device__ __forceinline__ float log_xla(float x) {
  const int bits = __float_as_int(fmaxf(x, 0x1p-126f));
  const float m = __int_as_float((bits & 0x7FFFFF) | 0x3F000000);
  const bool low = m < 0x1.6a09e6p-1f;
  const float e = __fsub_rn(__fadd_rn((float)((bits >> 23) - 127), 1.0f),
                            low ? 1.0f : 0.0f);
  const float t = __fadd_rn(__fsub_rn(m, 1.0f), low ? m : 0.0f);
  const float z = __fmul_rn(t, t);
  const float t3 = __fmul_rn(z, t);
  const float b1 = xfma(xfma(t, 0x1.204376p-4f, -0x1.d7a37p-4f), t,
                        0x1.de4a34p-4f);
  const float b2 = xfma(xfma(t, -0x1.fcba9ep-4f, 0x1.23d37ep-3f), t,
                        -0x1.555ca0p-3f);
  const float b3 = xfma(xfma(t, 0x1.999d58p-3f, -0x1.fffff8p-3f), t,
                        0x1.555554p-2f);
  const float y = xfma(xfma(xfma(b1, t3, b2), t3, b3), t3,
                       __fmul_rn(e, -0x1.bd0106p-13f));
  const float out = __fadd_rn(__fadd_rn(__fsub_rn(t, __fmul_rn(z, 0.5f)), y),
                              __fmul_rn(e, 0x1.63p-1f));
  return x == 0.0f ? -__int_as_float(0x7f800000) : out;
}

// XLA's log1p (xlamath.log1p_xla): a rational approximation below
// sqrt(2) - 1, else log_xla(1 + a)
__device__ __forceinline__ float log1p_xla(float a) {
  const float a2 = __fmul_rn(a, a);
  float den = 1.0f;
  den = xfma(den, a, 0x1.e2035ap+3f);
  den = xfma(den, a, 0x1.4c30b6p+6f);
  den = xfma(den, a, 0x1.bb865ap+7f);
  den = xfma(den, a, 0x1.351946p+8f);
  den = xfma(den, a, 0x1.b0db14p+7f);
  den = xfma(den, a, 0x1.e0f304p+5f);
  float num = 0x1.7bc096p-15f;
  num = xfma(num, a, 0x1.fe818ap-2f);
  num = xfma(num, a, 0x1.a509f4p+2f);
  num = xfma(num, a, 0x1.de9738p+4f);
  num = xfma(num, a, 0x1.e798ecp+5f);
  num = xfma(num, a, 0x1.c8e75ap+5f);
  num = xfma(num, a, 0x1.40a202p+4f);
  const float small = __fadd_rn(
      a, __fadd_rn(__fmul_rn(a2, -0.5f),
                   __fmul_rn(__fmul_rn(a, a2), __fdiv_rn(num, den))));
  return fabsf(a) < 0x1.a8279ap-2f ? small : log_xla(__fadd_rn(a, 1.0f));
}

// the interaction depth of one event and its bias weight (lifecycle.
// sample_interaction_tau): mode 0 forced scattering with the composite
// uniform/exponential path-length bias xi, 1 forced with xi = 0, 2 a plain
// exponential free path
__global__ void interaction_depth_kernel(
    const float* __restrict__ tau_path, const float* __restrict__ u_choice,
    const float* __restrict__ u_uni, const float* __restrict__ u_exp,
    float* __restrict__ tau_int, float* __restrict__ w_bias,
    bool* __restrict__ ok, int n, int mode, float xi, float one_minus_xi) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (mode == 2) {
    tau_int[i] = -log1p_xla(-u_exp[i]);
    w_bias[i] = 1.0f;
    ok[i] = true;
    return;
  }
  const float tau = tau_path[i];
  const float em1 = expm1_xla(-tau);
  const float ome = -em1;
  const float tau_exp = -log1p_xla(__fmul_rn(u_exp[i], em1));
  float t = tau_exp, w = ome;
  if (mode == 0) {
    t = u_choice[i] < xi ? __fmul_rn(u_uni[i], tau) : tau_exp;
    const float p = __fdiv_rn(exp_xla(-t), fmaxf(ome, 1e-30f));
    // the plain version's xi / tau is PyTorch's float / tensor: the
    // tensor's reciprocal times the float
    const float q = __fadd_rn(
        __fmul_rn(p, one_minus_xi),
        __fmul_rn(__frcp_rn(fmaxf(tau, 1e-30f)), xi));
    w = __fdiv_rn(__fmul_rn(ome, p), fmaxf(q, 1e-30f));
  }
  tau_int[i] = t;
  w_bias[i] = w;
  ok[i] = tau > 1e-6f;
}

// the scan march's deposit factor per step (march.deposit_factor)
__global__ void deposit_factor_kernel(const float* __restrict__ ds,
                                      const float* __restrict__ dtau,
                                      float* __restrict__ out, long n) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float d = dtau[i], s = ds[i];
  out[i] = d < 1e-4f
               ? __fmul_rn(s, xfma(-0.5f, d, 1.0f))
               : __fdiv_rn(__fmul_rn(-expm1_xla(-d), s), fmaxf(d, 1e-37f));
}

}  // namespace skirt9

extern "C" int interaction_depth_launch(
    const void* tau_path, const void* u_choice, const void* u_uni,
    const void* u_exp, void* tau_int, void* w_bias, void* ok, int n,
    int mode, float xi, float one_minus_xi, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  skirt9::interaction_depth_kernel<<<blocks, threads, 0,
                                     (cudaStream_t)stream>>>(
      (const float*)tau_path, (const float*)u_choice, (const float*)u_uni,
      (const float*)u_exp, (float*)tau_int, (float*)w_bias, (bool*)ok, n,
      mode, xi, one_minus_xi);
  return (int)cudaGetLastError();
}

extern "C" int deposit_factor_launch(const void* ds, const void* dtau,
                                     void* out, long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const long blocks = (n + threads - 1) / threads;
  skirt9::deposit_factor_kernel<<<(unsigned)blocks, threads, 0,
                                  (cudaStream_t)stream>>>(
      (const float*)ds, (const float*)dtau, (float*)out, n);
  return (int)cudaGetLastError();
}
