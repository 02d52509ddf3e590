"""SED templates on wavelength grids (host numpy).

Port of `skirt9_tpu/spectral/seds.py` for the templates the golden ski
files reach: `blackbody`, `from_file` (FileSED), `lya_gaussian`
(LyaGaussianSED), `clipped`, `integrate` and `normalized`. Each returns a
`sources.base.TabulatedSED` (lam [m], s_lambda up to normalisation); the
source normalises it to its luminosity. The reference's quasar, line and
double-peaked Lyman-alpha templates are not ported yet.
"""

from __future__ import annotations

import numpy as np

from ..ops import planck
from ..sources.base import TabulatedSED


def blackbody(T: float, lam_min: float = 0.01e-6, lam_max: float = 100e-6,
              n: int = 512) -> TabulatedSED:
    """(ref: SKIRT/core/BlackBodySED)"""
    lam = np.geomspace(lam_min, lam_max, n)
    return TabulatedSED(lam=lam, s=np.pi * planck.b_lambda_np(lam, T))


def from_file(path: str, lam_unit: float = 1.0,
              s_unit: float = 1.0) -> TabulatedSED:
    """Two-column text file: wavelength, specific luminosity
    (ref: FileSED via TextInFile)."""
    data = np.loadtxt(path)
    return TabulatedSED(lam=data[:, 0] * lam_unit, s=data[:, 1] * s_unit)


LAM_LYA = 1215.67e-10   # Lyman-alpha centre [m] (ref: Constants::lambdaLya)
_C = 2.99792458e8


def lya_gaussian(dispersion: float, n: int = 1200) -> TabulatedSED:
    """A Gaussian Lyman-alpha line in velocity space with dispersion s
    [m/s] (ref: LyaGaussianSED: exp(-v^2 / 2 s^2) over v = (lam - lam_a) /
    lam_a c), on +-6 s."""
    v = np.linspace(-6.0, 6.0, n) * dispersion
    lam = LAM_LYA * (1.0 + v / _C)
    s = np.exp(-0.5 * (v / dispersion) ** 2)
    return TabulatedSED(lam=lam, s=s)


def clipped(sed: TabulatedSED, lam_min: float, lam_max: float) -> TabulatedSED:
    """Restrict the SED support to [lam_min, lam_max] with exact endpoint
    samples."""
    lam = np.asarray(sed.lam, np.float64)
    s = np.asarray(sed.s, np.float64)
    lo = max(lam_min, lam[0])
    hi = min(lam_max, lam[-1])
    if lo >= hi:
        raise ValueError("source range does not overlap the SED support")
    inner = lam[(lam > lo) & (lam < hi)]
    grid = np.concatenate([[lo], inner, [hi]])
    return TabulatedSED(lam=grid, s=np.interp(grid, lam, s))


def integrate(sed: TabulatedSED, lam_min=None, lam_max=None) -> float:
    """Integrated luminosity over a range (trapezoid on the SED's grid)."""
    lam = np.asarray(sed.lam, np.float64)
    s = np.asarray(sed.s, np.float64)
    lo = lam_min if lam_min is not None else lam[0]
    hi = lam_max if lam_max is not None else lam[-1]
    grid = np.unique(np.clip(np.concatenate([lam, [lo, hi]]), lo, hi))
    sv = np.interp(grid, lam, s)
    return float(np.trapezoid(sv, grid))


def normalized(sed: TabulatedSED, luminosity: float,
               lam_min=None, lam_max=None) -> TabulatedSED:
    """Scale so the integrated luminosity over the range equals
    `luminosity`."""
    tot = integrate(sed, lam_min, lam_max)
    return TabulatedSED(lam=sed.lam, s=np.asarray(sed.s) * (luminosity / tot))
