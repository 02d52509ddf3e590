"""Output unit systems: SI / Stellar / Extragalactic + flux output styles.

Counterpart of the reference's Units hierarchy (ref: SKIRT/core/Units.hpp:29,
SkirtUnitDef.cpp:560-746 addDefaultUnit tables): a unit system selects the
units used for OUTPUT files, and the fluxOutputStyle selects between
F_lambda (Wavelength), F_nu (Frequency) and lambda*F_lambda (Neutral)
flux representations. Inputs are always parsed through utils/units.py;
this module formats outputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import constants as c

C_LIGHT = c.C_LIGHT
PC = c.PARSEC
L_SUN = 3.846e26
JY = 1e-26  # W/m2/Hz

# per-system output units: quantity -> (unit name, SI value of one unit)
_SYSTEMS = {
    "SIUnits": {
        "wavelength": ("m", 1.0),
        "length": ("m", 1.0),
        "distance": ("m", 1.0),
        "wavelengthfluxdensity": ("W/m3", 1.0),
        "frequencyfluxdensity": ("W/m2/Hz", 1.0),
        "neutralfluxdensity": ("W/m2", 1.0),
        "bolluminosity": ("W", 1.0),
        "temperature": ("K", 1.0),
        "timelag": ("s", 1.0),
    },
    "StellarUnits": {
        "wavelength": ("micron", 1e-6),
        "length": ("AU", c.AU),
        "distance": ("pc", PC),
        "wavelengthfluxdensity": ("W/m2/micron", 1e6),
        "frequencyfluxdensity": ("Jy", JY),
        "neutralfluxdensity": ("W/m2", 1.0),
        "bolluminosity": ("Lsun", L_SUN),
        "temperature": ("K", 1.0),
        "timelag": ("s", 1.0),
    },
    "ExtragalacticUnits": {
        "wavelength": ("micron", 1e-6),
        "length": ("pc", PC),
        "distance": ("Mpc", 1e6 * PC),
        "wavelengthfluxdensity": ("W/m2/micron", 1e6),
        "frequencyfluxdensity": ("Jy", JY),
        "neutralfluxdensity": ("W/m2", 1.0),
        "bolluminosity": ("Lsun", L_SUN),
        "temperature": ("K", 1.0),
        "timelag": ("s", 1.0),
    },
}


@dataclasses.dataclass(frozen=True)
class UnitSystem:
    """Output formatting for one system + flux style (ref: Units.hpp)."""

    system: str = "ExtragalacticUnits"
    flux_style: str = "Wavelength"  # Wavelength | Frequency | Neutral

    def _u(self, qty):
        return _SYSTEMS[self.system][qty]

    # --------------------------------------------------------- conversions

    def out(self, qty: str, value_si):
        """Convert an SI value to the system's output unit."""
        name, one = self._u(qty)
        return np.asarray(value_si) / one

    def unit(self, qty: str) -> str:
        return self._u(qty)[0]

    def out_wavelength(self, lam_m):
        return self.out("wavelength", lam_m)

    def out_flux(self, f_lambda_si, lam_m):
        """Convert F_lambda [W/m2/m] to the configured flux style + unit
        (ref: Units::ofluxdensity — Wavelength: F_lambda; Frequency:
        F_nu = F_lambda lam^2/c; Neutral: lam F_lambda)."""
        f = np.asarray(f_lambda_si, np.float64)
        lam = np.asarray(lam_m, np.float64)
        if self.flux_style == "Wavelength":
            return self.out("wavelengthfluxdensity", f)
        if self.flux_style == "Frequency":
            return self.out("frequencyfluxdensity", f * lam * lam / C_LIGHT)
        return self.out("neutralfluxdensity", f * lam)  # Neutral

    @property
    def flux_symbol(self) -> str:
        return {"Wavelength": "F_lambda", "Frequency": "F_nu",
                "Neutral": "lambda*F_lambda"}[self.flux_style]

    @property
    def flux_unit(self) -> str:
        return {"Wavelength": self.unit("wavelengthfluxdensity"),
                "Frequency": self.unit("frequencyfluxdensity"),
                "Neutral": self.unit("neutralfluxdensity")}[self.flux_style]


def from_ski(units_el) -> UnitSystem:
    """Build from the ski <units> child element (SIUnits /StellarUnits/
    ExtragalacticUnits with fluxOutputStyle)."""
    if units_el is None:
        return UnitSystem()
    name = units_el.tag
    if name not in _SYSTEMS:
        raise NotImplementedError(f"unit system '{name}' not supported")
    style = units_el.attrib.get("fluxOutputStyle", "Wavelength")
    return UnitSystem(system=name, flux_style=style)
