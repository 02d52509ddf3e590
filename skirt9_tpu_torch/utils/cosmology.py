"""Cosmology: redshift and distances for detection and calibration.

Counterpart of the reference's Cosmology hierarchy (ref:
SKIRT/core/Cosmology.hpp:16, LocalUniverseCosmology,
FlatUniverseCosmology.hpp:46-58): a model at redshift z is observed with
wavelengths stretched by (1+z), fluxes calibrated with the luminosity
distance, and pixel solid angles with the angular-diameter distance
(ref: FluxRecorder.cpp:310 detection shift, :503-507 calibration factors).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import constants as c

MPC = 1e6 * c.PARSEC
H0_UNIT = 1e5 / MPC  # 100 km/s/Mpc in 1/s


@dataclasses.dataclass(frozen=True)
class LocalUniverseCosmology:
    """z = 0; distances come from the instrument configuration."""

    @property
    def redshift(self) -> float:
        return 0.0

    def luminosity_distance(self) -> float:
        return 0.0

    def angular_diameter_distance(self) -> float:
        return 0.0

    def relative_expansion_rate(self) -> float:
        return 0.0


@dataclasses.dataclass(frozen=True)
class FlatUniverseCosmology:
    """Flat LCDM (ref: FlatUniverseCosmology; defaults h=0.675,
    Omega_m=0.31 per the reference's attribute defaults)."""

    redshift: float = 0.0
    h: float = 0.675
    omega_m: float = 0.31

    def _comoving_distance(self) -> float:
        z = self.redshift
        if z <= 0:
            return 0.0
        H0 = self.h * H0_UNIT
        ol = 1.0 - self.omega_m
        zs = np.linspace(0.0, z, 4097)
        E = np.sqrt(self.omega_m * (1 + zs) ** 3 + ol)
        return (c.C_LIGHT / H0) * np.trapezoid(1.0 / E, zs)

    def luminosity_distance(self) -> float:
        return (1.0 + self.redshift) * self._comoving_distance()

    def angular_diameter_distance(self) -> float:
        return self._comoving_distance() / (1.0 + self.redshift)

    def relative_expansion_rate(self) -> float:
        H0 = self.h * H0_UNIT
        ol = 1.0 - self.omega_m
        return H0 * np.sqrt(self.omega_m * (1 + self.redshift) ** 3 + ol)


def from_ski(cos_el):
    """Build from the ski <cosmology> child element."""
    if cos_el is None or cos_el.tag == "LocalUniverseCosmology":
        return LocalUniverseCosmology()
    if cos_el.tag == "FlatUniverseCosmology":
        a = cos_el.attrib
        return FlatUniverseCosmology(
            redshift=float(a.get("redshift", 0.0)),
            h=float(a.get("reducedHubbleConstant", 0.675)),
            omega_m=float(a.get("matterDensityFraction", 0.31)))
    raise NotImplementedError(f"cosmology '{cos_el.tag}' not supported")
