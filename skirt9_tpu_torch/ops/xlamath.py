"""XLA's f32 arithmetic on the CPU, operation for operation, in PyTorch.

The reference runs its f32 math through XLA, whose CPU code fuses a
product into the sum it feeds (a fused multiply-add, rounded once) and
evaluates log, log1p, exp and erf_inv by its own polynomials (Cephes' logf
and expf, Giles' erf_inv). PyTorch rounds every product and has other
polynomials, ulps away. Where an ulp decides a discrete outcome (a
Gaussian draw's value, a rejection test, a table row), the port uses these
replicas: pure IEEE operations that give XLA's bits on any device (its
subnormal inputs aside, which XLA flushes to zero). `fma` forms a * b + c
in f64, where the product of two f32 values is exact, and rounds once
more to f32, which equals the fused rounding but in a vanishing share of
ties.
"""

from __future__ import annotations

import math
import struct

import torch


_TINY = torch.finfo(torch.float32).tiny


def f32(v: float) -> float:
    """v rounded to f32: a Python float as the reference's jax.numpy takes
    it into an f32 expression (XLA folds constant expressions in f32)."""
    return struct.unpack("<f", struct.pack("<f", v))[0]


def sqrt(t: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, as XLA's (through f64:
    PyTorch's f32 sqrt on the CPU is not correctly rounded on some
    inputs)."""
    return torch.sqrt(t.double()).float()


def cos(t: torch.Tensor) -> torch.Tensor:
    """f32 cosine as XLA's CPU code computes it: glibc's cosf
    (`sincos`)."""
    return sincos(t)[1]


def sin(t: torch.Tensor) -> torch.Tensor:
    """f32 sine as XLA's CPU code computes it: glibc's sinf (`sincos`)."""
    return sincos(t)[0]


def hypot(x: torch.Tensor, y: torch.Tensor, fma_fn=None) -> torch.Tensor:
    """`jnp.hypot` of f32 x and y as jax forms it: a sqrt(1 + (b/a)^2) with
    a = max(|x|, |y|), b = min (the square fused into the sum, by fma_fn,
    `fma` by default), and 0 where a is 0."""
    x, y = torch.abs(x), torch.abs(y)
    a, b = torch.maximum(x, y), torch.minimum(x, y)
    zero = a == 0
    q = b / torch.where(zero, torch.ones_like(a), a)
    return torch.where(zero, a, a * sqrt((fma_fn or fma)(q, q, 1.0)))


def move_xy_fused(pos: torch.Tensor, t: torch.Tensor,
                  dirn: torch.Tensor) -> torch.Tensor:
    """pos + t dirn over (B, 3) as XLA's CPU code forms the move of a
    `move_inside`: fused into a multiply-add on x and y (`fma_rn`, rounded
    once as the march kernel's fmaf), not on z."""
    t = t[:, None]
    return torch.cat([fma_rn(t, dirn[:, :2], pos[:, :2]),
                      pos[:, 2:] + t * dirn[:, 2:]], dim=1)


def _f32_of(bits: int) -> float:
    """The f32 constant whose f64 encoding is `bits`."""
    return struct.unpack("<d", struct.pack("<Q", bits))[0]


# set by `eager()`: jax.numpy run op by op compiles each operation alone,
# so no product fuses into a sum
_EAGER = [False]


class eager:
    """Inside `with xlamath.eager():` `fma` rounds the product and the sum
    apart, as the reference's jax.numpy does outside a jitted function (its
    set-up draws), and `is_eager()` is true."""

    def __enter__(self):
        self._was = _EAGER[0]
        _EAGER[0] = True

    def __exit__(self, *exc):
        _EAGER[0] = self._was


def is_eager() -> bool:
    return _EAGER[0]


def _split(a: torch.Tensor):
    """Veltkamp's split of f64 a into two halves of 26 bits, so that a
    product of two halves is exact."""
    c = a * 134217729.0
    hi = c - (c - a)
    return hi, a - hi


def _two_sum(a, b):
    """s = a + b rounded, and its rounding error, exactly (Knuth)."""
    s = a + b
    bp = s - a
    return s, (a - (s - bp)) + (b - bp)


def _round_odd(s: torch.Tensor, err: torch.Tensor) -> torch.Tensor:
    """The f64 value s + err (err the exact error of s) rounded to odd:
    truncated toward zero, its last bit set where it was inexact."""
    inexact = (err != 0) & torch.isfinite(s)
    bits = s.view(torch.int64)
    bits = (bits - (inexact & ((err < 0) != (s < 0))).long()) \
        | inexact.long()
    return bits.view(torch.float64)


def fma(a, b, c) -> torch.Tensor:
    """a * b + c rounded once to f32 (through f64, where the product of two
    f32 values is exact), as the fused multiply-add that XLA's CPU code
    emits rounds it. Python floats among a, b and c act as f32 constants,
    as they do in the reference's jax.numpy expressions (one of a and b is
    a tensor). Inside `eager()` the product is rounded before the sum."""
    to64 = lambda v: v.double() if torch.is_tensor(v) else f32(v)
    if _EAGER[0]:
        return ((to64(a) * to64(b)).float().double() + to64(c)).float()
    return (to64(a) * to64(b) + to64(c)).float()


def fma_rn(a, b, c) -> torch.Tensor:
    """`fma` rounded once in every case: the f64 sum is rounded to odd
    (its rounding error, exact by TwoSum, pulls it toward zero and sets
    its last bit) before it is rounded to f32, so a sum that lands on an
    f32 midpoint in f64 (about one in 10^9) rounds as CUDA's fmaf and
    XLA's fused multiply-add round it. The grids' steps (the plain
    versions of every march-kernel mode) use it: the card holds them bit
    for bit; it costs four times `fma`'s operations, so the life cycle's
    own f32 math keeps `fma`."""
    to64 = lambda v: v.double() if torch.is_tensor(v) else f32(v)
    return _round_odd(*_two_sum(to64(a) * to64(b), to64(c))).float()


def rdiv(c: float, t: torch.Tensor) -> torch.Tensor:
    """The f32 quotient c / t, rounded once (PyTorch forms a Python float
    over a tensor as the reciprocal times the float, rounded twice)."""
    return torch.full_like(t, f32(c)) / t


# XLA's f32 log1p on the CPU: Cephes' logf of 1 + a (its polynomial in an
# Estrin order) beside a rational approximation for |a| < sqrt(2) - 1
_LOGF_P = tuple(_f32_of(b) for b in (
    0x3FB2043760000000, 0xBFBD7A3700000000, 0x3FBDE4A340000000,
    0xBFBFCBA9E0000000, 0x3FC23D37E0000000, 0xBFC555CA00000000,
    0x3FC999D580000000, 0xBFCFFFFF80000000, 0x3FD5555540000000))
_LOGF_LN2_LO = _f32_of(0xBF2BD01060000000)
_LOGF_LN2_HI = _f32_of(0x3FE6300000000000)
_LOG1P_DEN = tuple(_f32_of(b) for b in (
    0x402E2035A0000000, 0x4054C30B60000000, 0x406BB865A0000000,
    0x4073519460000000, 0x406B0DB140000000, 0x404E0F3040000000))
_LOG1P_NUM = tuple(_f32_of(b) for b in (
    0x3F07BC0960000000, 0x3FDFE818A0000000, 0x401A509F40000000,
    0x403DE97380000000, 0x404E798EC0000000, 0x404C8E75A0000000,
    0x40340A2020000000))
_LOG1P_SMALL = _f32_of(0x3FDA8279A0000000)


def log_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU log of f32 x > 0 (Cephes' logf), operation for operation
    with its fused multiply-adds: bit for bit except on subnormals."""
    bits = torch.clamp_min(x, torch.finfo(torch.float32).tiny).view(
        torch.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    low = m < _f32_of(0x3FE6A09E60000000)
    e = (((bits >> 23) - 127).float() + 1.0) - low.float()
    t = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    z = t * t
    t3 = z * t
    p = _LOGF_P
    b1 = fma(fma(t, p[0], p[1]), t, p[2])
    b2 = fma(fma(t, p[3], p[4]), t, p[5])
    b3 = fma(fma(t, p[6], p[7]), t, p[8])
    y = fma(fma(fma(b1, t3, b2), t3, b3), t3, e * _LOGF_LN2_LO)
    out = ((t - z * 0.5) + y) + e * _LOGF_LN2_HI
    return torch.where(x == 0.0, torch.full_like(out, -math.inf), out)


def log1p_xla(a: torch.Tensor) -> torch.Tensor:
    """XLA's CPU log1p of f32 a > -1: log_xla(1 + a), or a rational
    approximation for |a| < sqrt(2) - 1; bit for bit except on subnormal
    inputs, which XLA flushes to zero."""
    a2 = a * a
    den = torch.ones_like(a)
    for c in _LOG1P_DEN:
        den = fma(den, a, c)
    num = torch.full_like(a, _LOG1P_NUM[0])
    for c in _LOG1P_NUM[1:]:
        num = fma(num, a, c)
    small = a + (a2 * -0.5 + (a * a2) * (num / den))
    return torch.where(a.abs() < _LOG1P_SMALL, small, log_xla(a + 1.0))


# XLA's f32 erf_inv (Giles' single-precision approximation): Horner
# coefficients in w - 2.5 for w = -log1p(-x^2) < 5, else in sqrt(w) - 3
_ERFINV_CENTRAL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                   -4.39150654e-06, 0.00021858087, -0.00125372503,
                   -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_TAIL = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 inverse error function on the CPU, step for step (its
    log1p, and each Horner step one fused multiply-add). PyTorch's erfinv
    is another algorithm, tens of ulps away."""
    w = -log1p_xla(x * -x)
    central = w < 5.0
    w = torch.where(central, w - 2.5, sqrt(w) - 3.0)
    coef = lambda i: torch.where(central,
                                 torch.full_like(w, _ERFINV_CENTRAL[i]),
                                 torch.full_like(w, _ERFINV_TAIL[i]))
    p = coef(0)
    for i in range(1, len(_ERFINV_CENTRAL)):
        p = fma(p, w, coef(i))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)




# Cephes' expf: e^x = 2^n e^r, n = floor(x log2(e) + 1/2), r reduced in two
# parts of ln 2, e^r a degree-5 polynomial
_EXPF_P = tuple(_f32_of(b) for b in (
    0x3F2A0D2CE0000000, 0x3F56E879C0000000, 0x3F81112100000000,
    0x3FA5553820000000, 0x3FC5555540000000))
_EXPF_LO = _f32_of(0xC055F33340000000)
_EXPF_HI = _f32_of(0x4056333340000000)
_LOG2E = _f32_of(0x3FF7154760000000)


def exp_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU exp of f32 x, operation for operation (subnormal results
    flushed to zero, as XLA flushes them)."""
    x = torch.clamp(x, _EXPF_LO, _EXPF_HI)
    n = torch.clamp(torch.floor(fma(x, _LOG2E, 0.5)), -127.0, 127.0)
    r = fma(n, -_LOGF_LN2_HI, x)
    r = fma(n, -_LOGF_LN2_LO, r)
    y = _EXPF_P[0]
    for c in _EXPF_P[1:] + (0.5,):
        y = fma(r, y, c)
    y = fma(y, r * r, r) + 1.0
    scale = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    out = y * scale
    # XLA flushes subnormal results to zero
    return torch.where(out < _TINY, torch.zeros_like(out), out)


# XLA's fast tanh on the CPU: x clamped to +-7.99, a rational function of
# x^2 (degree 13 over 6 in x), x itself below 4e-4, +-1 from 20 on
_TANH_P = tuple(_f32_of(b) for b in (
    0xBCB3E4B800000000, 0x3D4C266FC0000000, 0xBDD7A6FFE0000000,
    0x3E6B800820000000, 0x3EEF286940000000, 0x3F44E1BDA0000000,
    0x3F740B3B80000000))
_TANH_Q = tuple(_f32_of(b) for b in (
    0x3EB41A7B00000000, 0x3F1F12BAC0000000, 0x3F629540A0000000,
    0x3F740B3BA0000000))
_TANH_SMALL = _f32_of(0x3F3A36E2E0000000)
_TANH_CLAMP = _f32_of(0x401FFEC880000000)


def tanh_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU tanh of f32 x, operation for operation (its LLVM IR,
    each product fused into the sum it feeds)."""
    c = torch.clamp(x, -_TANH_CLAMP, _TANH_CLAMP)
    c2 = c * c
    p = fma(c2, _TANH_P[0], _TANH_P[1])
    for k in _TANH_P[2:]:
        p = fma(c2, p, k)
    q = fma(c2, _TANH_Q[0], _TANH_Q[1])
    for k in _TANH_Q[2:]:
        q = fma(c2, q, k)
    t = torch.where(x.abs() < _TANH_SMALL, x, (c * p) / q)
    return torch.where(x.abs() >= 20.0, torch.copysign(torch.ones_like(x), x),
                       t)


def expm1_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU expm1 of f32 x: exp(x) - 1 where |x| > 1/2, else
    tanh(x/2) (exp(x) + 1), and x where x/2 is 0 (`exp_xla`, `tanh_xla`;
    2^n e^r times the power of two is exact, so the sums round once)."""
    e = exp_xla(x)
    h = x * 0.5
    out = torch.where(x.abs() > 0.5, e - 1.0, tanh_xla(h) * (e + 1.0))
    return torch.where(h == 0, x, out)


def _running_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The f32 running sum along dim, one addition after another."""
    out = x.clone()
    a, b = out.movedim(dim, 0), x.movedim(dim, 0)
    for k in range(1, a.shape[0]):
        a[k] = a[k - 1] + b[k]
    return out


def cumsum(x: torch.Tensor, tile: int = 16) -> torch.Tensor:
    """XLA's CPU f32 cumsum over dim 0: a running sum inside tiles of 16
    steps, the tiles' totals summed the same way (recursively), and each
    tile's running sum plus the total before it. (PyTorch's CPU cumsum
    accumulates in f64, and XLA's order is not one running sum, so the two
    differ in the last bit, which decides the step of a crossing.)"""
    S = x.shape[0]
    if S <= tile:
        return _running_sum(x, 0)
    nt = -(-S // tile)
    pad = x.new_zeros((nt * tile - S,) + tuple(x.shape[1:]))
    inner = _running_sum(torch.cat([x, pad]).reshape(
        (nt, tile) + tuple(x.shape[1:])), 1)
    outer = cumsum(inner[:, -1], tile)
    before = torch.cat([torch.zeros_like(outer[:1]), outer[:-1]])
    return (inner + before[:, None]).reshape(
        (nt * tile,) + tuple(x.shape[1:]))[:S]


def ftz(t: torch.Tensor) -> torch.Tensor:
    """t with its subnormal f32 values flushed to zero, as XLA's CPU code
    flushes subnormal inputs and results (PyTorch keeps them)."""
    return torch.where(t.abs() < _TINY, torch.zeros_like(t), t)


# The C library's atan2f and atanf (glibc 2.36, from fdlibm), which XLA's
# CPU code calls for f32 atan2: the argument reduction of atanf at 7/16,
# 11/16, 19/16 and 39/16, its two polynomials in w = x^4, each operation
# rounded alone (glibc's generic build has no fused multiply-adds)
_ATAN_HI = tuple(_f32_of(b) for b in (
    0x3FDDAC6700000000, 0x3FE921FB40000000, 0x3FEF730BC0000000,
    0x3FF921FB40000000))
_ATAN_LO = tuple(_f32_of(b) for b in (
    0x3E3586ED20000000, 0x3E64442D00000000, 0x3E6281F680000000,
    0x3E74442D00000000))
_ATAN_T = tuple(_f32_of(b) for b in (
    0x3FD5555560000000, 0xBFC99999A0000000, 0x3FC24924A0000000,
    0xBFBC71C700000000, 0x3FB745CDC0000000, 0xBFB3B0F2A0000000,
    0x3FB10D66A0000000, 0xBFADDE2D60000000, 0x3FA97B4B20000000,
    0xBFA2B44420000000, 0x3F90AD3AE0000000))
_PI = _f32_of(0x400921FB60000000)
_PI_LO = _f32_of(0xBE7777A5C0000000)          # pi - f32(pi), negative
_PI_2 = _f32_of(0x3FF921FB60000000)


def _atanf_pos(x: torch.Tensor) -> torch.Tensor:
    """glibc's atanf of finite f32 x >= 0, operation for operation."""
    ix = x.view(torch.int32)
    band = torch.where(ix < 0x3EE00000, -1, torch.where(
        ix < 0x3F300000, 0, torch.where(ix < 0x3F980000, 1, torch.where(
            ix < 0x401C0000, 2, 3))))
    safe = torch.where(x > 0, x, torch.ones_like(x))
    r = torch.where(band == -1, x, torch.where(
        band == 0, (x * 2.0 - 1.0) / (x + 2.0), torch.where(
            band == 1, (x - 1.0) / (x + 1.0), torch.where(
                band == 2, (x - 1.5) / (x * 1.5 + 1.0),
                rdiv(-1.0, safe)))))
    z = r * r
    w = z * z
    s1 = w * _ATAN_T[10] + _ATAN_T[8]
    for c in _ATAN_T[6::-2]:
        s1 = s1 * w + c
    s2 = w * _ATAN_T[9] + _ATAN_T[7]
    for c in _ATAN_T[5::-2]:
        s2 = s2 * w + c
    poly = r * (s1 * z + s2 * w)
    pick = lambda tab: torch.where(band == 0, tab[0], torch.where(
        band == 1, tab[1], torch.where(band == 2, tab[2], tab[3])))
    hi = pick(_ATAN_HI) + torch.zeros_like(x)
    out = torch.where(band < 0, r - poly,
                      hi - ((poly - pick(_ATAN_LO)) - r))
    return torch.where(ix >= 0x4C000000,
                       torch.full_like(x, f32(_ATAN_HI[3] + _ATAN_LO[3])),
                       out)


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """f32 atan2(y, x) as XLA's CPU code computes it, a call of the C
    library's atan2f (glibc's): atanf of |y / x| (past a ratio of 2^60 the
    constant pi/2, below 2^-60 with x < 0 zero) moved into the quadrant, in
    two parts of pi. Bit for bit on finite inputs (NaN aside); the march
    kernel's `atan2_glibc` (`csrc/march.cu`) is the same code in CUDA."""
    hx, hy = x.view(torch.int32), y.view(torch.int32)
    ix, iy = hx & 0x7FFFFFFF, hy & 0x7FFFFFFF
    k = (iy - ix) >> 23
    q = torch.abs(y / torch.where(ix == 0, torch.ones_like(x), x))
    q = torch.where(torch.isfinite(q), q, torch.zeros_like(q))
    z = _atanf_pos(q)
    z = torch.where(k > 60, torch.full_like(z, f32(_PI_2 + 0.5 * _PI_LO)), z)
    z = torch.where((hx < 0) & (k < -60), torch.zeros_like(z), z)
    neg_x, neg_y = hx < 0, hy < 0
    pi = torch.full_like(z, _PI)
    out = torch.where(~neg_x, torch.where(neg_y, -z, z),
                      torch.where(neg_y, (z - _PI_LO) - pi,
                                  pi - (z - _PI_LO)))
    # y = +-0: +-0 for x >= +0, +-pi for x <= -0 (1e-30 below an ulp)
    out = torch.where(iy == 0, torch.where(neg_x, torch.where(
        neg_y, -pi, pi), y), out)
    # x = +-0 and y != 0: +-pi/2
    out = torch.where((ix == 0) & (iy != 0), torch.where(
        neg_y, torch.full_like(z, -_PI_2), torch.full_like(z, _PI_2)), out)
    # x = 1: atanf(y) itself
    one = hx == 0x3F800000
    return torch.where(one, torch.where(neg_y, -1.0, 1.0) * _atanf_pos(
        torch.abs(y)), out)


def fma64(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c of f64 tensors rounded once, as an FMA instruction rounds
    it. PyTorch has no fused f64 multiply-add that is one on every device,
    so the product is made exact by Dekker's TwoProduct (Veltkamp's split)
    and the three-term sum rounded once by Boldo and Melquiond's rounding
    to odd: th + tl = c + ph exactly, then th + RO(tl + pl) rounded to
    nearest. Pure IEEE f64 adds and products: the same bits on the CPU and
    on the card. Finite operands far from overflow (the polynomials and
    reductions of `sincos`)."""
    ph = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    pl = ((ah * bh - ph) + ah * bl + al * bh) + al * bl
    th, tl = _two_sum(c, ph)
    return th + _round_odd(*_two_sum(tl, pl))


# glibc 2.36's sinf and cosf (sysdeps/ieee754/flt-32/s_sinf.c, s_cosf.c,
# sincosf.h, sincosf_data.c), which XLA's CPU code calls for f32 sin and
# cos: the argument in f64, reduced by the nearest multiple n of pi/2
# (reduce_fast: n from x 2/pi 2^24 truncated to an int, plus 2^23, shifted
# down 24 bits), then an odd polynomial for the sine and an even one for
# the cosine of the remainder. On x86-64 with FMA and AVX2 glibc runs
# __sinf_fma/__cosf_fma, the same C compiled with contraction: the
# reduction x - n pi/2 and every `a + x * b` of the polynomials are f64
# fused multiply-adds (`fma64`)
_SC_C = tuple(float.fromhex(h) for h in (
    "0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
    "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16"))
_SC_S = tuple(float.fromhex(h) for h in (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
    "-0x1.994eb3774cf24p-13"))
_HPI_INV_2_24 = float.fromhex("0x1.45f306dc9c883p+23")
_HPI = float.fromhex("0x1.921fb54442d18p0")


def sincos(t: torch.Tensor):
    """(sinf(t), cosf(t)) of f32 t as glibc 2.36 computes them on x86-64
    with FMA: on a CUDA tensor one launch of `csrc/sincos.cu` (counted as
    `sincos`), on a CPU tensor `sincos_plain`, bit for bit the same."""
    if t.device.type == "cpu":
        return sincos_plain(t)
    if t.device.type != "cuda":
        raise ValueError(f"no sincos kernel for device {t.device}")
    from ..kernels import build as kb
    x = t.to(torch.float32).contiguous()
    s, c = torch.empty_like(x), torch.empty_like(x)
    kb.launch("sincos", x.data_ptr(), s.data_ptr(), c.data_ptr(), x.numel(),
              kb.stream_of(x))
    return s.reshape(t.shape), c.reshape(t.shape)


def sincos_plain(t: torch.Tensor):
    """(sinf(t), cosf(t)) of f32 t as glibc 2.36 computes them on x86-64
    with FMA (the __sinf_fma and __cosf_fma variants), operation for
    operation: bit for bit for |t| < 120, every branch there (|t| < 2^-12:
    t and 1; below 0.75 the polynomials alone, which equal reduce_fast's
    quadrant 0). Larger arguments are outside: glibc reduces them by a
    192-bit 4/pi table, and these fall back to f64 sin and cos rounded to
    f32, within an ulp of glibc's. The direction, geometry, Stokes and
    Lyman-alpha sites stay inside [-4 pi, 4 pi]; only the polarized azimuth
    sampler's Newton iterates go past 120, at the most polarized packets.
    The sine and cosine share one reduction."""
    shape, t = t.shape, t.reshape(-1)
    x = t.double()
    top = (t.view(torch.int32) >> 20) & 0x7FF
    # n is 0 below 0.75, where glibc skips the reduction
    n = ((x * _HPI_INV_2_24).trunc().to(torch.int32) + 0x800000) >> 24
    xr = fma64(-n.double(), torch.full_like(x, _HPI), x)
    q = n & 3
    xs = torch.where((q == 1) | (q == 2), -xr, xr)
    x2 = xr * xr
    x3 = xs * x2
    x4 = x2 * x2
    k = lambda v: torch.full_like(x, v)
    # sinf_poly: s1 = s2 + x2 s3, s = x + x3 s1, sin = s + x5 s1; c2 = c3 +
    # x2 c4, c1 = c0 + x2 c1, c = c1 + x4 c2, cos = c + x6 c2
    s1 = fma64(x2, k(_SC_S[2]), k(_SC_S[1]))
    c2 = fma64(x2, k(_SC_C[4]), k(_SC_C[3]))
    c1 = fma64(x2, k(_SC_C[1]), k(_SC_C[0]))
    sp = fma64(x3 * x2, s1, fma64(x3, k(_SC_S[0]), xs)).float()
    cp = fma64(x4 * x2, c2, fma64(x4, k(_SC_C[2]), c1)).float()
    cp = torch.where((n & 2) != 0, -cp, cp)
    odd = (n & 1) != 0
    s, c = torch.where(odd, cp, sp), torch.where(odd, sp, cp)
    tiny = top < 0x398
    s = torch.where(tiny, t, s)
    c = torch.where(tiny, torch.ones_like(c), c)
    big = top >= 0x42F
    s = torch.where(big, torch.sin(x).float(), s)
    c = torch.where(big, torch.cos(x).float(), c)
    return s.reshape(shape), c.reshape(shape)


def libm_f32(name: str, values) -> "np.ndarray":
    """The C library's f32 function `name` ("cosf", "sinf") of each value,
    on the host: the function XLA's CPU code calls. For tables of a few
    hundred entries (the angles of a grid's borders)."""
    import ctypes
    import ctypes.util

    import numpy as np
    fn = getattr(ctypes.CDLL(ctypes.util.find_library("m")), name)
    fn.argtypes, fn.restype = [ctypes.c_float], ctypes.c_float
    vals = np.asarray(values, np.float32).reshape(-1)
    out = np.array([fn(float(v)) for v in vals], np.float32)
    return out.reshape(np.shape(values))
