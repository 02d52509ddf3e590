"""Imported geometries: snapshot data as normalized density profiles.

Port of `skirt9_tpu/geometries/imported.py` (ref: ImportedGeometry.hpp:19
and its subclasses): a geometry whose density and positions come from a
snapshot, usable wherever an analytic geometry is (a GeometricSource's
shape, a GeometricMedium's density profile, a site list):

  ParticleGeometry          SPH particles and a smoothing kernel
  CellGeometry              cuboidal cells
  CylindricalCellGeometry   cylindrical sectors (R, phi, z)
  SphericalCellGeometry     spherical sectors (r, theta, phi)
  MeshGeometry              a regular mesh
  AdaptiveMeshGeometry      the leaf boxes of an AMR tree (`grids/amr.py`)
  VoronoiMeshGeometry       the cells of a Voronoi tessellation

`density_np` is host f64 (the normalised snapshot density). `sample(keys,
tag)` draws on the device: the entity from the mass cdf (purpose tag + 7),
then a position in it, closed-form for the particle kernels, boxes and
sectors, and for a Voronoi cell 8 rounds of bounded rejection in the cell's
bounding box against `VoronoiGrid.locate` (a lane that finds nothing keeps
the site). The f32 operations follow the reference's as XLA runs them in
its jitted launch (`ops.xlamath`: a product that feeds a sum is one fused
multiply-add); the tables live on each device once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import rng, sampling
from ..ops import xlamath as xm
from .analytic import Geometry


def _mass_cdf(mass: np.ndarray) -> np.ndarray:
    m = np.asarray(mass, np.float64)
    tot = m.sum()
    if not tot > 0:
        raise ValueError("imported geometry has zero total mass")
    return np.cumsum(m) / tot


def _uniform3(keys, tag):
    """Three uniforms (B, 3): two of one draw at tag + 20, one at tag + 21
    (the reference's `_uniform3`)."""
    u0, u1 = rng.uniform2(keys, tag + 20)
    return torch.stack([u0, u1, rng.uniform(keys, tag + 21)], dim=-1)


class ImportedGeometry(Geometry):
    """Base adapter: normalized density and entity-cdf position sampling
    over a snapshot (ref: ImportedGeometry.hpp:19). Subclasses set, in
    __post_init__, the host mass cdf `_cdf`, the total mass `_mtot`, the
    bounding radius `_rmax` and the site list `_sites`, and implement
    `_density_at` and `entity_position`."""

    @property
    def total_mass(self) -> float:
        return self._mtot

    @property
    def rmax(self) -> float:
        """Bounding radius of the imported mass."""
        return self._rmax

    def density_np(self, pos: np.ndarray) -> np.ndarray:
        return np.asarray(self._density_at(np.asarray(pos, np.float64)),
                          np.float64) / self._mtot

    def terms(self, keys: torch.Tensor, tag: int = rng.LAUNCH_POSITION):
        cdf = self._dev("cdf", lambda: self._cdf, keys.device)
        u = rng.uniform(keys, tag + 7)
        j = torch.clamp(sampling.searchsorted_right(cdf, u), 0,
                        cdf.shape[0] - 1)
        return self.entity_terms(keys, j, tag)

    def entity_terms(self, keys, j, tag):
        return self.entity_position(keys, j, tag), None

    def entity_position(self, keys: torch.Tensor, j: torch.Tensor,
                        tag: int) -> torch.Tensor:
        """(B, 3) positions inside the entities j (B,)."""
        a, b = self.entity_terms(keys, j, tag)
        return a if b is None else a * b

    def sites_np(self) -> np.ndarray:
        """The entities' sites (ref: SiteListInterface.hpp)."""
        return np.asarray(self._sites, np.float64)


@dataclasses.dataclass(eq=False)
class ParticleGeometry(ImportedGeometry):
    """Smoothed-particle geometry (ref: ParticleGeometry.hpp:43)."""

    snapshot: object                 # imports.snapshots.ParticleSnapshot
    kernel_kind: str = "CubicSplineSmoothingKernel"

    def __post_init__(self):
        ss = self.snapshot
        self._cdf = _mass_cdf(ss.mass)
        self._mtot = float(np.sum(ss.mass))
        self._sites = ss.positions
        self._rmax = float(np.max(np.linalg.norm(ss.positions, axis=-1)
                                  + ss.h))

    def _density_at(self, pos):
        return self.snapshot.density_at(pos)

    def entity_position(self, keys, j, tag):
        from ..imports import snapshots as snap
        dev = keys.device
        if self.kernel_kind == "CubicSplineSmoothingKernel":
            kq, kc = snap.kernel_radius_tables(dev)
        else:
            kq, kc = snap.kernel_tables(self.kernel_kind, dev)
        q = sampling.sample_cdf_linlin(rng.uniform(keys, tag), kq, kc)
        d = rng.isotropic_direction(keys, tag + 60)
        pos = self._dev("pos", lambda: self.snapshot.positions, dev)
        h = self._dev("h", lambda: self.snapshot.h, dev)
        return xm.fma((q * h[j])[:, None], d, pos[j])


@dataclasses.dataclass(eq=False)
class CellGeometry(ImportedGeometry):
    """Cuboidal-cell geometry (ref: CellGeometry.hpp:55): uniform density
    per cell, uniform in-cell positions."""

    snapshot: object                 # imports.snapshots.CellSnapshot

    def __post_init__(self):
        ss = self.snapshot
        self._cdf = _mass_cdf(ss.mass)
        self._mtot = float(np.sum(ss.mass))
        lo = np.asarray(ss.lo, np.float64)
        hi = np.asarray(ss.hi, np.float64)
        self._sites = 0.5 * (lo + hi)
        self._rmax = float(np.max(np.linalg.norm(
            np.concatenate([lo, hi]), axis=-1)))
        self._rho = np.asarray(ss.mass, np.float64) \
            / np.maximum(np.prod(hi - lo, axis=-1), 1e-300)

    def _density_at(self, pos):
        """The sum of the densities of the cells holding each point."""
        pos = np.atleast_2d(pos)
        lo = np.asarray(self.snapshot.lo, np.float64)
        hi = np.asarray(self.snapshot.hi, np.float64)
        out = np.zeros(len(pos))
        step = max(1, (1 << 22) // max(len(pos), 1))
        for s in range(0, len(lo), step):
            sel = np.all((pos[:, None] >= lo[None, s:s + step])
                         & (pos[:, None] < hi[None, s:s + step]), axis=-1)
            out += sel.astype(np.float64) @ self._rho[s:s + step]
        return out

    def entity_position(self, keys, j, tag):
        lo = self._dev("lo", lambda: self.snapshot.lo, keys.device)[j]
        hi = self._dev("hi", lambda: self.snapshot.hi, keys.device)[j]
        return xm.fma(_uniform3(keys, tag), hi - lo, lo)


@dataclasses.dataclass(eq=False)
class CylindricalCellGeometry(ImportedGeometry):
    """Cylindrical-cell geometry (ref: CylindricalCellGeometry.hpp:59):
    uniform in (R^2, phi, z) within each cell sector."""

    snapshot: object          # imports.snapshots.CylindricalCellSnapshot

    def __post_init__(self):
        ss = self.snapshot
        self._cdf = _mass_cdf(ss.mass)
        self._mtot = float(np.sum(ss.mass))
        lo = np.asarray(ss.lo, np.float64)
        hi = np.asarray(ss.hi, np.float64)
        phi_c = 0.5 * (lo[:, 1] + hi[:, 1])
        R_c = 0.5 * (lo[:, 0] + hi[:, 0])
        self._sites = np.stack([R_c * np.cos(phi_c), R_c * np.sin(phi_c),
                                0.5 * (lo[:, 2] + hi[:, 2])], axis=-1)
        self._rmax = float(np.max(np.hypot(
            hi[:, 0], np.maximum(np.abs(lo[:, 2]), np.abs(hi[:, 2])))))

    def _density_at(self, pos):
        return self.snapshot.density_at(pos)

    def entity_terms(self, keys, j, tag):
        u = _uniform3(keys, tag)
        lo = self._dev("lo", lambda: self.snapshot.lo, keys.device)[j]
        hi = self._dev("hi", lambda: self.snapshot.hi, keys.device)[j]
        # normalised by the outer radius before squaring: R^2 at pc scales
        # sits near the f32 edge
        f = lo[:, 0] / torch.clamp_min(hi[:, 0], 1e-37)
        ff = f * f
        R = hi[:, 0] * xm.sqrt(xm.fma(u[:, 0], 1.0 - ff, ff))
        phi = xm.fma(u[:, 1], hi[:, 1] - lo[:, 1], lo[:, 1])
        z = xm.fma(u[:, 2], hi[:, 2] - lo[:, 2], lo[:, 2])
        one = torch.ones_like(R)
        return (torch.stack([R, R, z], dim=-1),
                torch.stack([xm.cos(phi), xm.sin(phi), one], dim=-1))


@dataclasses.dataclass(eq=False)
class SphericalCellGeometry(ImportedGeometry):
    """Spherical-cell geometry (ref: SphericalCellGeometry.hpp:67):
    uniform in (r^3, cos theta, phi) within each cell sector."""

    snapshot: object          # imports.snapshots.SphericalCellSnapshot

    def __post_init__(self):
        ss = self.snapshot
        self._cdf = _mass_cdf(ss.mass)
        self._mtot = float(np.sum(ss.mass))
        lo = np.asarray(ss.lo, np.float64)
        hi = np.asarray(ss.hi, np.float64)
        r_c = 0.5 * (lo[:, 0] + hi[:, 0])
        th_c = 0.5 * (lo[:, 1] + hi[:, 1])
        ph_c = 0.5 * (lo[:, 2] + hi[:, 2])
        self._sites = np.stack(
            [r_c * np.sin(th_c) * np.cos(ph_c),
             r_c * np.sin(th_c) * np.sin(ph_c),
             r_c * np.cos(th_c)], axis=-1)
        self._rmax = float(np.max(hi[:, 0]))

    def _density_at(self, pos):
        return self.snapshot.density_at(pos)

    def entity_terms(self, keys, j, tag):
        u = _uniform3(keys, tag)
        lo = self._dev("lo", lambda: self.snapshot.lo, keys.device)[j]
        hi = self._dev("hi", lambda: self.snapshot.hi, keys.device)[j]
        # r^3 at pc scales overflows f32: work in r / r_max
        f = lo[:, 0] / torch.clamp_min(hi[:, 0], 1e-37)
        f3 = f * f * f
        # XLA's f32 pow: exp(y log x) carried in higher precision
        x = xm.fma(u[:, 0], 1.0 - f3, f3).double()
        r = hi[:, 0] * torch.exp(torch.log(x) * xm.f32(1.0 / 3.0)).float()
        mu0, mu1 = xm.cos(hi[:, 1]), xm.cos(lo[:, 1])
        mu = xm.fma(u[:, 1], mu1 - mu0, mu0)
        st = xm.sqrt(torch.clamp_min(xm.fma(-mu, mu, 1.0), 0.0))
        phi = xm.fma(u[:, 2], hi[:, 2] - lo[:, 2], lo[:, 2])
        rs = r * st
        return (torch.stack([rs, rs, r], dim=-1),
                torch.stack([xm.cos(phi), xm.sin(phi), mu], dim=-1))


@dataclasses.dataclass(eq=False)
class MeshGeometry(ImportedGeometry):
    """Regular-mesh geometry (ref: MeshGeometry.hpp:31 over a uniform
    mesh): per-mesh-cell masses, uniform in-cell positions."""

    snapshot: object                 # imports.snapshots.MeshSnapshot

    def __post_init__(self):
        ss = self.snapshot
        mass = np.asarray(ss.mass, np.float64).reshape(-1)
        self._cdf = _mass_cdf(mass)
        self._mtot = float(mass.sum())
        self._lo = ss.cell_bounds()[0]
        self._h = ss._cellsize()
        self._sites = self._lo + 0.5 * self._h
        self._rmax = float(max(np.linalg.norm(np.asarray(ss.lo)),
                               np.linalg.norm(np.asarray(ss.hi))))

    def _density_at(self, pos):
        return self.snapshot.density_at(pos)

    def entity_position(self, keys, j, tag):
        lo = self._dev("lo", lambda: self._lo, keys.device)[j]
        return xm.fma(_uniform3(keys, tag),
                      self._dev("h", lambda: self._h, keys.device), lo)


@dataclasses.dataclass(eq=False)
class AdaptiveMeshGeometry(ImportedGeometry):
    """Adaptive-mesh geometry (ref: AdaptiveMeshGeometry.hpp:46): leaf
    boxes of an imported Morton-order AMR tree with per-leaf masses."""

    grid: object                     # grids.amr.AMRGrid
    mass: np.ndarray                 # (nleaf,) mass per leaf [kg]

    def __post_init__(self):
        self._cdf = _mass_cdf(self.mass)
        self._mtot = float(np.sum(self.mass))
        lo, hi = self.grid.cell_bounds()
        self._sites = 0.5 * (lo + hi)
        self._rmax = float(np.max(np.linalg.norm(
            np.concatenate([lo, hi]), axis=-1)))
        self._rho = np.asarray(self.mass, np.float64) \
            / np.maximum(self.grid.volumes(), 1e-300)

    def _density_at(self, pos):
        pos = np.atleast_2d(pos)
        cells = self.grid.to("cpu").locate(
            torch.tensor(pos.astype(np.float32))).numpy()
        ok = cells >= 0
        out = np.zeros(len(pos))
        out[ok] = self._rho[cells[ok]]
        return out

    def entity_position(self, keys, j, tag):
        lo = self._dev("lo", lambda: self.grid.cell_lo.cpu().numpy(),
                       keys.device)[j]
        hi = self._dev("hi", lambda: self.grid.cell_hi.cpu().numpy(),
                       keys.device)[j]
        return xm.fma(_uniform3(keys, tag), hi - lo, lo)


@dataclasses.dataclass(eq=False)
class VoronoiMeshGeometry(ImportedGeometry):
    """Voronoi-mesh geometry (ref: VoronoiMeshGeometry.hpp:48): one mass
    per site, the density piecewise constant on the tessellation.

    In-cell positions by bounded rejection inside the cell's exact bounding
    box with the nearest-site membership test: 8 masked rounds, a lane that
    finds nothing keeps the site (the reference's strategy, after
    VoronoiMeshSnapshot::generatePosition)."""

    sites: np.ndarray                # (N,3) [m]
    mass: np.ndarray | None = None   # (N,) mass per cell, OR
    mass_density: np.ndarray | None = None   # (N,) density per cell
    extent: tuple = ()               # ((x0,x1),(y0,y1),(z0,z1))
    rejection_rounds: int = 8

    def __post_init__(self):
        from ..grids.voronoi import build_voronoi
        self._grid = build_voronoi(np.asarray(self.sites, np.float64),
                                   self.extent)
        if self.mass is None:
            self.mass = np.asarray(self.mass_density, np.float64) \
                * self._grid.volumes()
        self._cdf = _mass_cdf(self.mass)
        self._mtot = float(np.sum(self.mass))
        self._sites = np.asarray(self.sites, np.float64)
        self._rmax = float(np.max(np.linalg.norm(
            np.asarray([[self.extent[a][i] for a in range(3)]
                        for i in range(2)]), axis=-1)))
        self._rho = np.asarray(self.mass, np.float64) \
            / np.maximum(self._grid.volumes(), 1e-300)

    def grid_on(self, device):
        """The tessellation's grid on `device`, moved there once."""
        cache = self.__dict__.setdefault("_grids", {})
        key = str(device)
        if key not in cache:
            cache[key] = self._grid.to(device)
        return cache[key]

    def _density_at(self, pos):
        pos = np.atleast_2d(pos)
        cells = self._grid.locate(torch.tensor(pos.astype(np.float32))) \
            .numpy()
        ok = cells >= 0
        out = np.zeros(len(pos))
        out[ok] = self._rho[cells[ok]]
        return out

    def entity_position(self, keys, j, tag):
        g = self.grid_on(keys.device)
        lo, hi = g.aabb_lo[j], g.aabb_hi[j]
        pos = g.sites[j]                       # fallback: the site itself
        done = torch.zeros(j.shape, dtype=torch.bool, device=keys.device)
        for r in range(self.rejection_rounds):
            cand = xm.fma(_uniform3(keys, tag + 100 * r), hi - lo, lo)
            ok = (g.locate(cand) == j) & ~done
            pos = torch.where(ok[:, None], cand, pos)
            done = done | ok
        return pos
