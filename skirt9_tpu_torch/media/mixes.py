"""Material mixes: optical-property tables on a wavelength grid.

A copy of the part of `skirt9_tpu/media/mixes.py` (host numpy, no jax) that
the golden ski files bench1, bench1h, bench2, bench3 and bench5 reach:
`MixTables`, `tabulated`, `trivial_gas` (TrivialGasMix, which the
reference's loader builds inline), `from_file` (the MeanFileDustMix text
format of `tests/golden/mrn_mean.txt`), `mean_interstellar_approx` (the
reference's stand-in for MeanInterstellarDustMix), `electron_mix` and
`stack`. The reference's other analytic benchmark mixes and resource-pack
readers are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils import constants as c


@dataclasses.dataclass(frozen=True)
class MixTables:
    """Optical properties of one medium component on a wavelength table."""

    lam: np.ndarray        # (T,) [m]
    sigma_ext: np.ndarray  # (T,) extinction cross section per entity [m^2]
    albedo: np.ndarray     # (T,)
    g: np.ndarray          # (T,) HG asymmetry
    mu: float = 0.0        # mass per entity [kg] (for mass normalizations)

    @property
    def sigma_abs(self) -> np.ndarray:
        return self.sigma_ext * (1.0 - self.albedo)

    @property
    def sigma_sca(self) -> np.ndarray:
        return self.sigma_ext * self.albedo

    def kappa_ext(self) -> np.ndarray:
        """Mass extinction coefficient [m^2/kg]."""
        return self.sigma_ext / self.mu if self.mu > 0 else self.sigma_ext

    def at(self, lam0: float) -> tuple[float, float, float]:
        """(sigma_ext, albedo, g) interpolated at one wavelength."""
        se = np.exp(np.interp(np.log(lam0), np.log(self.lam),
                              np.log(np.maximum(self.sigma_ext, 1e-300))))
        al = np.interp(lam0, self.lam, self.albedo)
        gg = np.interp(lam0, self.lam, self.g)
        return float(se), float(al), float(gg)


def tabulated(lam, sigma_ext, albedo, g, mu: float = 0.0) -> MixTables:
    """(ref: TabulatedDustMix / MeanListDustMix)"""
    return MixTables(lam=np.asarray(lam, np.float64),
                     sigma_ext=np.asarray(sigma_ext, np.float64),
                     albedo=np.asarray(albedo, np.float64),
                     g=np.asarray(g, np.float64), mu=mu)


def trivial_gas(sigma_abs: float, sigma_sca: float, g: float) -> MixTables:
    """Constant cross sections and asymmetry over 1e-8 to 1e-3 m
    (ref: TrivialGasMix; `skirt9_tpu/config/ski.py:937-945`)."""
    sext = sigma_abs + sigma_sca
    return tabulated(np.array([1e-8, 1e-3]), [sext, sext],
                     [sigma_sca / sext, sigma_sca / sext], [g, g])


def from_file(path: str) -> MixTables:
    """MeanFileDustMix text format: four columns — wavelength [micron],
    extinction mass coefficient kappa_ext [m2/kg], albedo, asymmetry g —
    using the reference's fixed arbitrary dust mass per hydrogen atom
    mu = 1.5e-29 kg/H to set the cross-section scale
    (ref: MeanFileDustMix.hpp:18-36)."""
    d = np.loadtxt(path)
    mu = 1.5e-29
    lam = d[:, 0] * 1e-6
    if lam[0] > lam[-1]:  # decreasing order is allowed
        d = d[::-1]
        lam = lam[::-1]
    return tabulated(lam, d[:, 1] * mu, d[:, 2], d[:, 3], mu=mu)


def mean_interstellar_approx(n: int = 300) -> MixTables:
    """The reference's analytic approximation of the mean Milky Way dust
    extinction curve, standing in for MeanInterstellarDustMix's resource
    table (`skirt9_tpu/media/mixes.py:77-105`): sigma ~ lam^-1.3 with a
    Drude 2175 A bump in the UV and optical, ~lam^-2 beyond 10 micron,
    kappa_ext(0.55 micron) = 2.4e3 m2/kg of dust."""
    lam = np.geomspace(0.01e-6, 3000e-6, n)
    l_um = lam * 1e6
    s_opt = (l_um / 0.55) ** -1.3
    x = 1.0 / l_um
    x0, gam = 4.6, 1.0
    drude = 0.35 * x**2 / ((x**2 - x0**2) ** 2 + x**2 * gam**2) * gam**2 \
        * x0**2 / 4.6**2 * 4
    shape = np.where(l_um < 10.0, s_opt * (1 + drude),
                     (l_um / 10.0) ** -2.0 * (10.0 / 0.55) ** -1.3)
    mu = 4.0 / 3.0 * np.pi * (0.1e-6) ** 3 * 3000.0  # grain mass [kg]
    kappa_v = 2.4e3  # m^2/kg of dust
    sigma = shape / np.interp(0.55, l_um, shape) * kappa_v * mu
    albedo = 0.6 * np.exp(-((np.log(l_um / 0.4)) ** 2) / 8.0) * (l_um < 20) \
        + 0.0
    g = np.clip(0.6 - 0.25 * np.log10(np.maximum(l_um, 1e-3) / 0.2), 0.0,
                0.9) * (l_um < 5)
    return MixTables(lam=lam, sigma_ext=sigma,
                     albedo=np.clip(albedo, 0, 0.95), g=np.clip(g, 0, 0.95),
                     mu=mu)


def electron_mix(n: int = 8) -> MixTables:
    """Free electrons: wavelength-independent Thomson scattering; the
    dipole phase function stands as HG g = 0 unless the loader attaches
    the Mueller tables of `ops.stokes.electron_mueller`
    (ref: SKIRT/core/ElectronMix.hpp:56)."""
    lam = np.geomspace(1e-11, 1e-2, n)
    return MixTables(lam=lam, sigma_ext=np.full(n, c.SIGMA_THOMSON),
                     albedo=np.ones(n), g=np.zeros(n), mu=c.ELECTRON_MASS)


def stack(mixes: list[MixTables], lam_grid: np.ndarray | None = None):
    """Resample several mixes onto a common wavelength table; returns
    (lam, sigma_ext (H,T), albedo (H,T), g (H,T)) ready for make_medium."""
    if lam_grid is None:
        lo = max(m.lam[0] for m in mixes)
        hi = min(m.lam[-1] for m in mixes)
        lam_grid = np.geomspace(lo, hi, 200)
    se, al, gg = [], [], []
    for m in mixes:
        logs = np.interp(np.log(lam_grid), np.log(m.lam),
                         np.log(np.maximum(m.sigma_ext, 1e-300)))
        se.append(np.exp(logs))
        al.append(np.interp(lam_grid, m.lam, m.albedo))
        gg.append(np.interp(lam_grid, m.lam, m.g))
    return lam_grid, np.array(se), np.array(al), np.array(gg)
