"""Analytic geometries: normalised density profiles.

Port of the part of `skirt9_tpu/geometries/analytic.py` that configs 2
and 5 reach: `Geometry`, `SphericalProfileGeometry`, `ShellGeometry` and
`ExpDiskGeometry`, with their host-side `density_np` (unit total mass) and
the shell's `rmax`, which the medium build needs. Sampling positions from a geometry serves `GeometricSource`,
which is not ported yet: `sample` raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses

import numpy as np


class Geometry:
    """Base: subclasses implement density_np (and, later, sample)."""

    def density_np(self, pos: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def sample(self, keys, tag: int = 0):
        raise NotImplementedError(
            f"{type(self).__name__}.sample (GeometricSource launches) is not "
            "ported yet")


@dataclasses.dataclass(frozen=True)
class SphericalProfileGeometry(Geometry):
    """Generic spherical geometry from a radial profile rho(r) with unit
    total mass."""

    rmax: float

    def rho(self, r: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def density_np(self, pos: np.ndarray) -> np.ndarray:
        r = np.linalg.norm(np.asarray(pos, np.float64), axis=-1)
        out = self.rho(np.maximum(r, self.rmax * 1e-12))
        return np.where(r <= self.rmax, out, 0.0)


@dataclasses.dataclass(frozen=True)
class ShellGeometry(SphericalProfileGeometry):
    """Power-law shell rho ~ r^-p for rmin < r < rmax (ref: ShellGeometry)."""

    rmin: float = 0.5
    rmax: float = 1.0
    p: float = 0.0

    def rho(self, r):
        if abs(self.p - 3.0) > 1e-12:
            integral = 4 * np.pi * (self.rmax ** (3 - self.p)
                                    - self.rmin ** (3 - self.p)) / (3 - self.p)
        else:
            integral = 4 * np.pi * np.log(self.rmax / self.rmin)
        out = np.where((r >= self.rmin) & (r <= self.rmax), r ** -self.p, 0.0)
        return out / integral


@dataclasses.dataclass(frozen=True)
class ExpDiskGeometry(Geometry):
    """Double-exponential disk rho ~ exp(-R/hR) exp(-|z|/hz)
    (ref: ExpDiskGeometry); the inner and outer truncations are ignored,
    as in the reference."""

    h_r: float = 1.0
    h_z: float = 0.2

    def density_np(self, pos: np.ndarray) -> np.ndarray:
        pos = np.asarray(pos, np.float64)
        R = np.hypot(pos[..., 0], pos[..., 1])
        z = np.abs(pos[..., 2])
        norm = 1.0 / (4 * np.pi * self.h_r ** 2 * self.h_z)
        return norm * np.exp(-R / self.h_r - z / self.h_z)
