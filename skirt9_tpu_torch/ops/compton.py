"""Compton scattering on free electrons: Klein-Nishina cross sections,
angle sampling and wavelength shifts, on tensors.

Port of `skirt9_tpu/ops/compton.py`. With x = (h c / lambda) / (m_e c^2)
the photon energy in electron rest masses, a scattering through cos theta
= mu shifts the wavelength by lambda' / lambda = 1 + x (1 - mu), and mu
follows dsigma/dOmega ~ C^2 (C + 1/C - 1 + mu^2) / 2, C = 1 / (1 + x (1 -
mu)). The angle is sampled by inverting conditional cdfs tabulated on the
host once (48 log-x rows of 257 mu points) in the two rows that bracket x,
blended linearly in log x.

The reference inverts a row by counting its entries below u (a
compare-and-sum); here one `torch.searchsorted` over the table's rows laid
end to end in f64, each row offset by twice its index, finds the same
count. The blends and interpolations round as XLA's fused multiply-adds
do, and the logarithms are XLA's (`ops.xlamath`).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..media import mixes as mx
from ..utils import constants as c
from . import xlamath as xm

X_OF_LAM = c.H_PLANCK / (c.ELECTRON_MASS * c.C_LIGHT)  # x = X_OF_LAM / lam

_NX, _NMU = 48, 257
_XGRID = np.geomspace(1e-6, 30.0, _NX)
_MUGRID = np.linspace(-1.0, 1.0, _NMU)


def _build_tables():
    """Per row of _XGRID the normalised trapezoid cdf of the KN angular
    density over _MUGRID, and the density's integral."""
    cdfs = np.zeros((_NX, _NMU))
    norms = np.zeros(_NX)
    for i, xv in enumerate(_XGRID):
        C = 1.0 / (1.0 + xv * (1.0 - _MUGRID))
        pdf = 0.5 * C * C * (C + 1.0 / C - 1.0 + _MUGRID**2)
        norms[i] = np.trapezoid(pdf, _MUGRID)
        cdf = np.concatenate([[0.0], np.cumsum(
            0.5 * (pdf[1:] + pdf[:-1]) * np.diff(_MUGRID))])
        cdfs[i] = cdf / cdf[-1]
    return cdfs, norms


_CDFS, _NORMS = _build_tables()


@functools.lru_cache(maxsize=None)
def _tables_on(device: str) -> dict:
    """The f32 tables on `device`, made once, so that an event copies
    nothing from the host: the cdf rows, their f64 concatenation with row
    i offset by 2 i, the mu and log-x grids and the norms."""
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    cdfs = f32(_CDFS)
    offs = 2.0 * torch.arange(_NX, dtype=torch.float64, device=device)
    return {"cdfs": cdfs,
            "flat": (cdfs.double() + offs[:, None]).reshape(-1),
            "mu": f32(_MUGRID),
            # the grid's logarithms as XLA folds them on its constant
            # table: correctly rounded
            "lxg": torch.log(f32(_XGRID).double()).float(),
            "norms": f32(_NORMS),
            "lo": float(np.float32(_XGRID[0])),
            "hi": float(np.float32(_XGRID[-1]))}


def _tables(device) -> dict:
    return _tables_on(str(device))


def x_of_lambda(lam: torch.Tensor) -> torch.Tensor:
    return xm.rdiv(X_OF_LAM, torch.clamp_min(lam, 1e-30))


def sigma_kn_ratio(x: torch.Tensor) -> torch.Tensor:
    """Total Klein-Nishina cross section over Thomson: the closed form, with
    the series 1 - 2x + 26x^2/5 below x = 1e-2."""
    xs = torch.clamp_min(x, 1e-2)
    t1 = (1 + xs) / xs**3 * (2 * xs * (1 + xs) / (1 + 2 * xs)
                             - torch.log1p(2 * xs))
    t2 = torch.log1p(2 * xs) / (2 * xs)
    t3 = -(1 + 3 * xs) / (1 + 2 * xs) ** 2
    exact = 0.75 * (t1 + t2 + t3)
    series = 1.0 - 2.0 * x + 5.2 * x * x
    return torch.where(x < 1e-2, series, exact)


def kn_diff(x: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Unnormalised KN differential cross section at mu = cos theta."""
    C = 1.0 / xm.fma(x, 1.0 - mu, 1.0)
    return 0.5 * C * C * xm.fma(mu, mu, C + 1.0 / C - 1.0)


def _log_x(x: torch.Tensor, tabs: dict) -> torch.Tensor:
    return xm.log_xla(torch.clamp(x, tabs["lo"], tabs["hi"]))


def sample_costheta(u: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """mu from the KN angular distribution at photon energies x (B,): the
    inverse cdf in the two rows that bracket log x, blended linearly."""
    tabs = _tables(u.device)
    lxg, mug = tabs["lxg"], tabs["mu"]
    lx = _log_x(x, tabs)
    i = torch.clamp(torch.searchsorted(lxg, lx, right=True) - 1, 0, _NX - 2)
    w = (lx - lxg[i]) / (lxg[i + 1] - lxg[i])

    def invert(row):
        # the count of the row's entries below u, in the offset rows
        li = torch.searchsorted(tabs["flat"], u.double() + 2.0 * row) \
            - row * _NMU
        li = torch.clamp(li, 1, _NMU - 1)
        c0 = tabs["cdfs"][row, li - 1]
        c1 = tabs["cdfs"][row, li]
        f = torch.where(c1 > c0, (u - c0) / torch.clamp_min(c1 - c0, 1e-30),
                        torch.full_like(u, 0.5))
        return xm.fma(f, mug[li] - mug[li - 1], mug[li - 1])

    mu = xm.fma(1.0 - w, invert(i), w * invert(i + 1))
    return torch.clamp(mu, -1.0, 1.0)


def shifted_wavelength(lam: torch.Tensor, x: torch.Tensor,
                       mu: torch.Tensor) -> torch.Tensor:
    """lambda' = lambda (1 + x (1 - mu))."""
    return lam * xm.fma(x, 1.0 - mu, 1.0)


def phase_value(x: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """The KN phase function normalised over the sphere (B,): kn_diff over
    2 pi times its integral over mu, interpolated in log x (jnp.interp's
    arithmetic)."""
    tabs = _tables(x.device)
    lxg, norms = tabs["lxg"], tabs["norms"]
    lx = _log_x(x, tabs)
    j = torch.clamp(torch.searchsorted(lxg, lx, right=True), 1, _NX - 1)
    n = xm.fma((lx - lxg[j - 1]) / (lxg[j] - lxg[j - 1]),
                norms[j] - norms[j - 1], norms[j - 1])
    n = torch.where(lx < lxg[0], norms[0], torch.where(lx > lxg[-1],
                                                       norms[-1], n))
    return kn_diff(x, mu) / (2.0 * math.pi * n)


def electron_mix_kn(n: int = 160) -> mx.MixTables:
    """An electron mix with the exact KN total cross section against
    wavelength (host f64)."""
    lam = np.geomspace(1e-14, 1e-4, n)
    x = X_OF_LAM / lam
    xs = np.maximum(x, 1e-4)
    t1 = (1 + xs) / xs**3 * (2 * xs * (1 + xs) / (1 + 2 * xs)
                             - np.log1p(2 * xs))
    t2 = np.log1p(2 * xs) / (2 * xs)
    t3 = -(1 + 3 * xs) / (1 + 2 * xs) ** 2
    ratio = np.where(x < 1e-4, 1.0 - 2.0 * x + 5.2 * x * x,
                     0.75 * (t1 + t2 + t3))
    sig = c.SIGMA_THOMSON * ratio
    return mx.tabulated(lam, sig, np.ones(n), np.zeros(n),
                        mu=c.ELECTRON_MASS)
