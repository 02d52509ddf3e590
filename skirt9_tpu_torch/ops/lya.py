"""Lyman-alpha resonant line transfer: Voigt cross sections and atom
velocity sampling, on tensors.

Port of `skirt9_tpu/ops/lya.py`. With x = (nu - nu0) / Dnu_D the
dimensionless frequency, v_th = sqrt(2 k T / m_p) the thermal velocity and
a = A21 / (4 pi Dnu_D) the damping parameter, the cross section per atom
is sigma0(T) H(a, x) (Tasitsiomi's 2006 fit of the Voigt-Hjerting
function), and a scattering takes the atom's velocity along the photon
from Zheng & Miralda-Escude's (2002) rejection method in a fixed number of
masked rounds.

Temperatures come as tensors, or as one Python float (the uniform gas
temperature of the resident sweep); a float is carried in f64 up to the
first tensor operation, where it rounds to f32, as the reference's
jax.numpy does with it. Square roots are correctly rounded (through f64),
as XLA's are, and exp, log and the fused multiply-adds are XLA's
(`ops.xlamath`), so that on the CPU the rejection tests decide as the
reference's do but where its tan or atan (the C library's) differs by an
ulp.
"""

from __future__ import annotations

import functools
import math

import torch

from ..utils import constants as c
from . import rng
from . import xlamath as xm

LAM0 = 1215.67e-10            # Lya rest wavelength [m]
NU0 = c.C_LIGHT / LAM0
A21 = 6.25e8                  # Einstein A coefficient [1/s]
SIGMA0_T4 = 5.898e-18         # line-centre cross section at 1e4 K [m^2]
ITERS = 24                    # rejection rounds
_INV_SQRT2 = 0.7071067811865476


# the constants as XLA folds the reference's expressions: products and
# quotients of Python floats in f64, rounded once to f32; a division by a
# constant becomes a product with its f32 reciprocal
_LAM0 = xm.f32(LAM0)
_INV_LAM0 = xm.f32(1.0 / _LAM0)
_INV_C = xm.f32(1.0 / xm.f32(c.C_LIGHT))
_VTH2_PER_K = xm.f32(xm.f32(2.0 * c.K_BOLTZMANN) / xm.f32(c.PROTON_MASS))
_A21_C = xm.f32(A21 * c.C_LIGHT)
_FOUR_PI_NU0 = xm.f32(4.0 * math.pi * NU0)


def thermal_velocity(T, like: torch.Tensor) -> torch.Tensor:
    """v_th = sqrt(2kT/m_p) [m/s]; like: a tensor on the target device."""
    if torch.is_tensor(T):
        return xm.sqrt(T * _VTH2_PER_K)
    return xm.sqrt(torch.full_like(like, 2.0 * c.K_BOLTZMANN * T
                                 / c.PROTON_MASS))


def damping_parameter(T, like: torch.Tensor) -> torch.Tensor:
    """a = A21 c / (4 pi nu0 v_th)."""
    return xm.rdiv(_A21_C, _FOUR_PI_NU0 * thermal_velocity(T, like))


def dimensionless_x(lam: torch.Tensor, T) -> torch.Tensor:
    """x = c (lam0 - lam) / (lam v_th) (lam / lam0)."""
    vth = thermal_velocity(T, lam)
    return (_LAM0 - lam) * c.C_LIGHT / (torch.clamp_min(lam, 1e-30) * vth) \
        * (lam * _INV_LAM0)


def voigt_H(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The Voigt-Hjerting function H(a, x), Tasitsiomi's analytic fit."""
    x2 = x * x
    z = (x2 - 0.855) / (x2 + 3.42)
    poly = xm.fma(z, xm.fma(z, xm.fma(z, 5.674, -9.207), 4.421), 0.1117)
    q = z * (1.0 + xm.rdiv(21.0, x2)) * a / (math.pi * (x2 + 1.0)) * poly
    q = torch.where(z > 0.0, q, torch.zeros_like(q))
    # the select before the product keeps XLA from fusing this sum
    return q * math.sqrt(math.pi) + xm.exp_xla(-x2)


def cross_section(lam: torch.Tensor, T) -> torch.Tensor:
    """Lya scattering cross section per neutral H atom [m^2]."""
    a = damping_parameter(T, lam)
    x = dimensionless_x(lam, T)
    Tt = T if torch.is_tensor(T) else torch.full_like(lam, T)
    return SIGMA0_T4 * xm.sqrt(xm.rdiv(1e4, torch.clamp_min(Tt, 1.0))) \
        * voigt_H(a, x)


# ------------------------------------------------------- scattering sampling

# the u0 fit's coefficients of 1, log10(a) and log10(a)^2, per power of x
_U0 = ((2.648963, 2.014446, 0.351479), (-4.058673, -3.675859, -0.640003),
       (3.017395, 2.117133, 0.370294), (-0.869789, -0.565886, -0.096312),
       (0.110987, 0.070103, 0.011557), (-0.005200, -0.003240, -0.000519))
_INV_LN10 = xm.f32(1.0 / math.log(10.0))
# XLA folds c1 log10(a) into log(a) (c1 / ln 10), in f32
_U0_FOLDED = tuple((c0, xm.f32(xm.f32(c1) * _INV_LN10), c2) for c0, c1, c2 in _U0)


def _u0_fit(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The comparison function's separation point u0(a, x): the polynomial
    fit in log10(a) and x of the rejection method, as XLA evaluates the
    reference's expression: log10(a) = log(a) / ln 10 with each product
    c1 log10(a) folded into log(a) (c1 / ln 10), and each product summed in
    one fused multiply-add."""
    lg = xm.log_xla(a)
    z = lg * _INV_LN10
    z2 = z * z
    coef = [xm.fma(z2, c2, xm.fma(lg, c1, c0)) for c0, c1, c2 in _U0_FOLDED]
    u0 = coef[-1]
    for cf in coef[-2::-1]:
        u0 = xm.fma(x, u0, cf)
    return u0


def round_tags(tag: int, iters: int = ITERS) -> list[int]:
    """The purpose tags of the rejection rounds, tag + 13 i."""
    return [tag + 13 * i for i in range(iters)]


@functools.lru_cache(maxsize=None)
def _round_tags_on(device: str, tag: int, iters: int) -> torch.Tensor:
    """round_tags as an int64 tensor on device, made once, so that an event
    copies nothing from the host."""
    return torch.tensor(round_tags(tag, iters), dtype=torch.int64,
                        device=device)


def sample_parallel_velocity(keys: torch.Tensor, tag: int, a: torch.Tensor,
                             x: torch.Tensor,
                             iters: int = ITERS) -> torch.Tensor:
    """The atom velocity along the incoming photon (units of v_th),
    u ~ exp(-u^2) / ((x - u)^2 + a^2): a two-piece Lorentzian comparison
    function split at u0, `iters` rejection rounds under the purpose keys
    tag + 13 i (three uniforms each), the first accepted round's candidate
    kept; a lane that accepts none takes a Gaussian core draw, and |x| >= 8
    a Gaussian around 1/x. The rounds are drawn and tested all at once:
    the reference's masked scan keeps the first acceptance too, so the
    result is the same draw for draw."""
    sign = torch.where(x >= 0, torch.ones_like(x), -torch.ones_like(x))
    xa = torch.abs(x)
    u0 = _u0_fit(a, torch.clamp_max(xa, 8.0))
    exp_u02 = xm.exp_xla(-u0 * u0)
    theta0 = torch.atan((u0 - xa) / a)
    half_pi = 0.5 * math.pi
    p = (theta0 + half_pi) / xm.fma(1.0 - exp_u02, theta0,
                                     (1.0 + exp_u02) * half_pi)
    gauss_fb = rng.gauss(keys, tag + 997) * _INV_SQRT2
    u_large = 1.0 / torch.clamp_min(xa, 1e-3) + gauss_fb

    tags = _round_tags_on(str(keys.device), tag, iters)
    pk = rng.fold_in(keys.unsqueeze(0), tags.unsqueeze(1))    # (R, B, 2)
    u1, u2, u3 = (rng.bits_to_unit_exact(rng.draw(pk, j)) for j in range(3))
    left = u1 <= p
    lo = torch.where(left, torch.full_like(u1, -half_pi), theta0.expand_as(u1))
    hi = torch.where(left, theta0.expand_as(u1), torch.full_like(u1, half_pi))
    u_cand = xm.fma(a, torch.tan(xm.fma(u2, hi - lo, lo)), xa)
    frac = xm.exp_xla(-u_cand * u_cand)
    frac = torch.where(u_cand > u0, frac / torch.clamp_min(exp_u02, 1e-37),
                       frac)
    acc = u3 < frac
    first = torch.argmax(acc.to(torch.int8), dim=0)
    u = torch.where(acc.any(dim=0),
                    u_cand.gather(0, first.unsqueeze(0))[0], gauss_fb)
    u = torch.where(xa >= 8.0, u_large, u)
    return sign * u


def _dot3(a, b):
    """Row-wise dot products of (B, 3) tensors as XLA's reduction forms them:
    each product fused into the running sum."""
    return xm.fma(a[..., 2], b[..., 2],
                  xm.fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def scatter_wavelength(lam_in: torch.Tensor, k_in: torch.Tensor,
                       k_out: torch.Tensor, u_par: torch.Tensor,
                       u_perp1: torch.Tensor, T) -> torch.Tensor:
    """The outgoing wavelength after a scattering off an atom with velocity
    u = u_par k_in + u_perp1 e1 (units of v_th, e1 perpendicular to k_in in
    the plane of k_out): the frequency is conserved in the atom's frame,
    x_out = x_in - u.k_in + u.k_out, inverted to first order in v/c."""
    vth = thermal_velocity(T, lam_in)
    mu = _dot3(k_in, k_out)
    kperp = xm.fma(-mu[..., None], k_in, k_out)
    kpn = xm.sqrt(_dot3(kperp, kperp))
    x_in = dimensionless_x(lam_in, T)
    x_out = (x_in - u_par) + xm.fma(u_par, mu, u_perp1 * kpn)
    return xm.rdiv(_LAM0, xm.fma(x_out * vth, _INV_C, 1.0))
