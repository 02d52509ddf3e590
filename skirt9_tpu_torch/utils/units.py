"""Unit system: quantity -> unit -> SI conversion.

TPU-native re-design of the reference's unit layer
(ref: SKIRT/core/SkirtUnitDef.cpp:27-346, SMILE/schema/UnitDef.hpp): internal
representation is always SI; user-facing values parse/format through the
tables below. Three output unit systems exist (SI, stellar, extragalactic),
selected per simulation (ref: SKIRT/core/Units.hpp:29).

Conversions are y_SI = factor * y_unit (power/offset generalization is not
needed for the supported units, matching the reference's tables which are all
pure factors except dimensionless).
"""

from __future__ import annotations

import re

from . import constants as c

# quantity -> { unit-string: factor to SI }
_UNITS: dict[str, dict[str, float]] = {
    "dimensionless": {"1": 1.0, "": 1.0},
    "length": {
        "m": 1.0, "cm": 1e-2, "mm": 1e-3, "km": 1e3,
        "AU": c.AU, "au": c.AU, "pc": c.PARSEC, "kpc": 1e3 * c.PARSEC,
        "Mpc": 1e6 * c.PARSEC, "Rsun": 6.9551e8, "lyr": c.LIGHT_YEAR,
    },
    "distance": {
        "m": 1.0, "AU": c.AU, "pc": c.PARSEC, "kpc": 1e3 * c.PARSEC,
        "Mpc": 1e6 * c.PARSEC, "lyr": c.LIGHT_YEAR,
    },
    "wavelength": {
        "m": 1.0, "cm": 1e-2, "mm": 1e-3, "micron": 1e-6, "nm": 1e-9,
        "Angstrom": 1e-10, "A": 1e-10,
    },
    "grainsize": {"m": 1.0, "cm": 1e-2, "mm": 1e-3, "micron": 1e-6, "nm": 1e-9},
    "pergrainsize": {"1/m": 1.0, "1/cm": 1e2, "1/mm": 1e3, "1/micron": 1e6, "1/nm": 1e9},
    "section": {"m2": 1.0, "cm2": 1e-4, "mm2": 1e-6},
    "volume": {"m3": 1.0, "cm3": 1e-6, "AU3": c.AU**3, "pc3": c.PARSEC**3},
    "velocity": {"m/s": 1.0, "cm/s": 1e-2, "km/s": 1e3, "km/h": 1.0 / 3.6},
    "mass": {"kg": 1.0, "g": 1e-3, "Msun": c.SOLAR_MASS},
    "bulkmass": {"kg": 1.0, "g": 1e-3},
    "bulkmassdensity": {"kg/m3": 1.0, "g/cm3": 1e3},
    "masssurfacedensity": {"kg/m2": 1.0, "g/cm2": 10.0, "Msun/AU2": c.SOLAR_MASS / c.AU**2, "Msun/pc2": c.SOLAR_MASS / c.PARSEC**2},
    "massvolumedensity": {"kg/m3": 1.0, "g/cm3": 1e3, "Msun/AU3": c.SOLAR_MASS / c.AU**3, "Msun/pc3": c.SOLAR_MASS / c.PARSEC**3},
    "massrate": {"kg/s": 1.0, "g/s": 1e-3, "Msun/yr": c.SOLAR_MASS / c.YEAR},
    "numbersurfacedensity": {"1/m2": 1.0, "1/cm2": 1e4},
    "numbervolumedensity": {"1/m3": 1.0, "1/cm3": 1e6},
    "mass coefficient": {"m2/kg": 1.0, "cm2/g": 0.1},
    "time": {"s": 1.0, "yr": c.YEAR, "Myr": 1e6 * c.YEAR, "Gyr": 1e9 * c.YEAR},
    "temperature": {"K": 1.0},
    "acceleration": {"m/s2": 1.0, "cm/s2": 1e-2, "km/s2": 1e3},
    "energy": {"J": 1.0, "erg": 1e-7, "eV": c.ELECTRON_CHARGE, "keV": 1e3 * c.ELECTRON_CHARGE},
    "magneticfield": {"T": 1.0, "G": 1e-4, "uG": 1e-10, "nG": 1e-13},
    "pressure": {"Pa": 1.0, "N/m2": 1.0, "J/m3": 1.0, "bar": 1e5, "hPa": 1e2, "Ba": 0.1, "erg/cm3": 0.1, "K/m3": c.K_BOLTZMANN},
    "bolluminosity": {"W": 1.0, "erg/s": 1e-7, "Lsun": c.SOLAR_LUMINOSITY},
    "bolluminosityvolumedensity": {"W/m3": 1.0, "Lsun/AU3": c.SOLAR_LUMINOSITY / c.AU**3, "Lsun/pc3": c.SOLAR_LUMINOSITY / c.PARSEC**3},
    # specific luminosity: internal W/m (per wavelength)
    "monluminosity": {
        "W/m": 1.0, "W/micron": 1e6, "W/Angstrom": 1e10,
        "Lsun/micron": c.SOLAR_LUMINOSITY * 1e6,
    },
    # per-frequency specific luminosity (ref: SkirtUnitDef
    # "frequencymonluminosity": W/Hz, erg/s/Hz, Jy-style not applicable)
    "monluminosityHz": {"W/Hz": 1.0, "erg/s/Hz": 1e-7,
                        "Lsun/Hz": c.SOLAR_LUMINOSITY},
    # flux density: internal W/m2/m (F_lambda per wavelength)
    "fluxdensity": {"W/m3": 1.0, "W/m2/micron": 1e6, "W/m2/m": 1.0},
    "angle": {"rad": 1.0, "deg": 3.141592653589793 / 180.0, "arcsec": 3.141592653589793 / 180.0 / 3600.0, "arcmin": 3.141592653589793 / 180.0 / 60.0},
    "posangle": {"rad": 1.0, "deg": 3.141592653589793 / 180.0},
    "solidangle": {"sr": 1.0, "arcsec2": (3.141592653589793 / 180.0 / 3600.0) ** 2},
}

# aliases with per-X interpretations that reduce to the same factor tables
_QUANTITY_ALIASES = {
    "lengthquantity": "length",
    "wavelengthquantity": "wavelength",
}


def has_quantity(qty: str) -> bool:
    return qty in _UNITS or qty in _QUANTITY_ALIASES


def to_si(qty: str, value: float, unit: str) -> float:
    """Convert `value` expressed in `unit` of quantity `qty` to SI."""
    qty = _QUANTITY_ALIASES.get(qty, qty)
    try:
        table = _UNITS[qty]
    except KeyError:
        raise ValueError(f"unknown quantity '{qty}'") from None
    try:
        return value * table[unit]
    except KeyError:
        raise ValueError(f"unknown unit '{unit}' for quantity '{qty}'") from None


def from_si(qty: str, value: float, unit: str) -> float:
    qty = _QUANTITY_ALIASES.get(qty, qty)
    return value / _UNITS[qty][unit]


def si_unit(qty: str) -> str:
    """The quantity's SI base unit name (conversion factor 1.0)."""
    qty = _QUANTITY_ALIASES.get(qty, qty)
    for unit, factor in _UNITS[qty].items():
        if factor == 1.0:
            return unit
    raise ValueError(f"quantity '{qty}' has no SI base unit")


def format_si(qty: str, value: float) -> str:
    """Format an SI value as a ski-syntax literal that parses back to the
    same float exactly (used when materializing defaults the loader
    applied into the regenerated parameters.xml)."""
    return f"{float(value)!r} {si_unit(qty)}"


_VALUE_RE = re.compile(r"^\s*([-+0-9.eE]+)\s*([A-Za-z/0-9]*)\s*$")


def parse(qty: str, text: str) -> float:
    """Parse a string like '1 pc', '0.55 micron', '2e14 W' into SI.

    A bare number is interpreted as already-SI (or dimensionless).
    Equivalent role to the reference's unit-aware ski parsing
    (ref: SMILE/serialize/XmlHierarchyCreator, SKIRT unit defs).
    """
    m = _VALUE_RE.match(text)
    if not m:
        raise ValueError(f"cannot parse quantity string '{text}'")
    value = float(m.group(1))
    unit = m.group(2)
    if not unit:
        return value
    return to_si(qty, value, unit)


def parse_list(qty: str, text: str) -> list[float]:
    """Parse a comma-separated list of quantity strings."""
    return [parse(qty, part) for part in text.split(",") if part.strip()]
