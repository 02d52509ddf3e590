"""Geometric media: per-cell medium state from analytic geometries.

Port of the part of `skirt9_tpu/media/geometric.py` (host numpy) that
the golden ski files reach: the optical-depth, number and number-column
normalisations, the deterministic midpoint cell quadrature
`cell_densities`, and `build_medium` onto `media.system.make_medium`. The
mass and mass-column normalisations are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import mixes as mx
from . import system as msys


@dataclasses.dataclass(frozen=True)
class OpticalDepthNormalization:
    """Optical depth along a full axis through the origin at wavelength lam
    (ref: OpticalDepthMaterialNormalization; axis in {'x','y','z'})."""

    tau: float
    lam: float
    axis: str = "z"
    rmax: float = 0.0  # integration bound; default: inferred from geometry

    def number_factor(self, geometry, mix: mx.MixTables) -> float:
        sigma, _, _ = mix.at(self.lam)
        rmax = self.rmax or getattr(geometry, "rmax", None)
        if rmax is None:
            raise ValueError("provide rmax for optical-depth normalization")
        s = np.linspace(-rmax, rmax, 20001)
        unit = {"x": [1, 0, 0], "y": [0, 1, 0], "z": [0, 0, 1]}[self.axis]
        pos = s[:, None] * np.asarray(unit, np.float64)
        col = np.trapezoid(geometry.density_np(pos), s)
        if col <= 0:
            raise ValueError("geometry has zero column along the axis")
        return self.tau / (sigma * col)


@dataclasses.dataclass(frozen=True)
class NumberNormalization:
    """Total number of entities (ref: NumberMaterialNormalization)."""

    number: float

    def number_factor(self, geometry, mix: mx.MixTables) -> float:
        return self.number


def _axis_column(geometry, axis: str, rmax: float = 0.0) -> float:
    """The normalised column (the integral of the unit-mass density) along a
    full axis through the origin [1/m^2]."""
    rmax = rmax or getattr(geometry, "rmax", None)
    if rmax is None:
        raise ValueError("provide rmax for column normalization")
    s = np.linspace(-rmax, rmax, 20001)
    unit = {"x": [1, 0, 0], "y": [0, 1, 0], "z": [0, 0, 1]}[axis]
    pos = s[:, None] * np.asarray(unit, np.float64)
    col = np.trapezoid(geometry.density_np(pos), s)
    if col <= 0:
        raise ValueError("geometry has zero column along the axis")
    return col


@dataclasses.dataclass(frozen=True)
class NumberColumnNormalization:
    """Number column density along a full coordinate axis
    (ref: NumberColumnMaterialNormalization)."""

    column: float    # [1/m^2]
    axis: str = "z"
    rmax: float = 0.0

    def number_factor(self, geometry, mix: mx.MixTables) -> float:
        return self.column / _axis_column(geometry, self.axis, self.rmax)


def cell_densities(grid, geometry, samples: int = 64) -> np.ndarray:
    """Normalised density averaged over the midpoints of an n^3 subdivision
    of each cell (n = cbrt(samples)); the pattern is symmetric, so every
    mirror symmetry of the geometry survives exactly. The subdivision spans
    the grid's `cell_jitter_halfwidths` where it has them (an annular
    cell, thin in R and z, wide in azimuth), else a cube of the cell's
    volume."""
    centers = grid.cell_centers().cpu().numpy().astype(np.float64)
    if samples <= 1:
        return geometry.density_np(centers)
    if hasattr(grid, "cell_jitter_halfwidths"):
        h = 2.0 * np.asarray(grid.cell_jitter_halfwidths(), np.float64)
    else:
        h = np.cbrt(np.asarray(grid.volumes(), np.float64))[:, None]
    n = max(int(round(samples ** (1.0 / 3.0))), 2)
    mid = (np.arange(n) + 0.5) / n - 0.5          # symmetric midpoints
    ox, oy, oz = np.meshgrid(mid, mid, mid, indexing="ij")
    offsets = np.stack([ox.ravel(), oy.ravel(), oz.ravel()], axis=-1)
    acc = np.zeros(len(centers))
    for off in offsets:
        acc += geometry.density_np(centers + off * h)
    return acc / len(offsets)


def build_medium(grid, components, lam_grid=None,
                 samples: int = 8) -> msys.MediumTables:
    """MediumTables (on the CPU) from [(geometry, mix, normalization), ...]:
    each component's number density is its normalization's number factor
    times the cell-averaged normalised density."""
    lam, se, al, gg = mx.stack([m for (_, m, _) in components], lam_grid)
    nds = []
    for geom, mix, norm in components:
        f = norm.number_factor(geom, mix)
        nds.append(cell_densities(grid, geom, samples=samples) * f)
    nd = np.stack(nds, axis=-1).astype(np.float32)
    return msys.make_medium(grid, nd, lam, se, al, gg)
