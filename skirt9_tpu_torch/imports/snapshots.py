"""Imported snapshots: particle (SPH) and cell data as media and sources.

Port of `skirt9_tpu/imports/snapshots.py` (ref: Snapshot.hpp:47,
ParticleSnapshot.hpp:25, CellSnapshot, TextInFile.hpp:87 column import,
SmoothingKernel.hpp:22, ImportedSource.hpp:70):

  * the import is column-oriented host numpy, and so are the snapshot
    queries: the kernel-smoothed densities (`ParticleSnapshot.density_at`,
    which a `DensityTreePolicy` octree calls on 64 points per node and
    level) are one `cKDTree` search per smoothing-length group and chunk of
    points, flat (point, particle) pair arrays and one grouped f64 sum
    (`np.bincount`), where the reference loops over the points in Python;
    the cell snapshots' box membership is a chunked broadcast, the last
    matching cell winning as in the reference's loop;
  * an imported medium resamples the snapshot onto the spatial grid once at
    set-up (`imported_medium`);
  * an imported source launches packets from its entities on the device:
    luminosity-weighted selection, positions in the entity (a smoothing
    kernel, a box, or an imported geometry's sampler) and wavelengths from a
    blackbody (`ParticleSource`) or an SED family (`FamilyParticleSource`,
    `CellFamilySource`, `EntityFamilySource`). Moving entities (imported
    velocities) need emission Doppler shifts, which are not ported yet: a
    source with velocities raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..media import system as msys
from ..ops import rng, sampling
from ..ops import xlamath as xm
from ..utils import constants as c
from ..utils import units as U

# points per chunk of the host kernel sums, which bounds the pair arrays
_CHUNK = 1 << 17


# ------------------------------------------------------------- SPH kernels

def cubic_spline_w(q: np.ndarray) -> np.ndarray:
    """Standard cubic spline kernel W(q), normalized in 3D with support q<1
    (ref: CubicSplineSmoothingKernel)."""
    q = np.asarray(q)
    a = 8.0 / np.pi
    w = np.where(q < 0.5,
                 1 - 6 * q**2 + 6 * q**3,
                 np.where(q < 1.0, 2 * (1 - q) ** 3, 0.0))
    return a * w


_CUM_Q = np.linspace(0, 1, 513)
_CUM_W = np.cumsum(cubic_spline_w(_CUM_Q) * _CUM_Q**2)
_CUM_W /= _CUM_W[-1]


def kernel_radius_tables(device) -> tuple:
    """The cubic-spline radius cdf (q, cum) as f32 tensors on `device`."""
    return (torch.tensor(_CUM_Q.astype(np.float32), device=device),
            torch.tensor(_CUM_W.astype(np.float32), device=device))


def sample_kernel_radius(u: torch.Tensor, tables=None) -> torch.Tensor:
    """Normalized radius q from the cubic-spline kernel; tables: the
    `kernel_radius_tables` of u's device, where the caller has them."""
    q, cum = tables or kernel_radius_tables(u.device)
    return sampling.sample_cdf_linlin(u, q, cum)


def kernel_tables(kind: str, device) -> tuple:
    """(q, cum) radius-sampling tables of a smoothing kernel as f32 tensors
    on `device` (ref: CubicSpline/QuarticSpline/Uniform/ScaledGaussian
    SmoothingKernel; `snapshots.py:709-736`): the quartic spline is the M5
    B-spline with its support scaled to 1, the scaled Gaussian has
    sigma = 0.29214 of the support."""
    q = np.linspace(0.0, 1.0, 512)
    if "Uniform" in kind:
        w = np.ones_like(q)
    elif "Quartic" in kind:
        s = 2.5 * q
        w = np.where(s < 0.5,
                     (2.5 - s) ** 4 - 5 * (1.5 - s) ** 4
                     + 10 * (0.5 - s) ** 4,
                     np.where(s < 1.5,
                              (2.5 - s) ** 4 - 5 * (1.5 - s) ** 4,
                              (2.5 - s) ** 4))
    elif "Gaussian" in kind:
        sigma = 0.29214381374061638716
        w = np.exp(-0.5 * (q / sigma) ** 2)
    else:  # cubic spline
        w = np.where(q < 0.5, 1 - 6 * q**2 + 6 * q**3,
                     2 * (1 - q) ** 3)
    pdf = np.maximum(q * q * w, 0.0)
    cum = np.concatenate([[0.0], np.cumsum(0.5 * (pdf[1:] + pdf[:-1])
                                           * np.diff(q))])
    cum /= max(cum[-1], 1e-300)
    return (torch.tensor(q.astype(np.float32), device=device),
            torch.tensor(cum.astype(np.float32), device=device))


def _radius_tables(kind: str, device) -> tuple:
    """The radius tables of a smoothing kernel, the 513-point cubic-spline
    cdf for the cubic spline (as the reference's launch takes it)."""
    if kind == "CubicSplineSmoothingKernel":
        return kernel_radius_tables(device)
    return kernel_tables(kind, device)


def kernel_density(positions, h, mass, points) -> np.ndarray:
    """sum_j m_j W(|x - r_j| / h_j) / h_j^3 at each point x (N, 3) [m]:
    the reference's per-point loop (`snapshots.py:98-115`) vectorised.
    Particles are grouped by smoothing length (a factor sqrt 2 per
    group), one `sparse_distance_matrix` per group and chunk of points
    lists the pairs within the group's largest h, and `np.bincount` sums
    W m / h^3 per point in f64. A pair at q >= 1 adds 0, as in the
    reference, whose search radius is the largest h of all: it is dropped
    before the kernel is evaluated."""
    from scipy.spatial import cKDTree
    positions = np.asarray(positions, np.float64)
    h = np.asarray(h, np.float64)
    mass = np.asarray(mass, np.float64)
    points = np.atleast_2d(np.asarray(points, np.float64))
    out = np.zeros(len(points))
    if not len(points) or not len(mass):
        return out
    band = np.floor(2.0 * np.log2(h / h.min())).astype(np.int64)
    groups = []
    for b in np.unique(band):
        idx = np.flatnonzero(band == b)
        groups.append((cKDTree(positions[idx]), float(h[idx].max()), h[idx],
                       mass[idx] / h[idx] ** 3))
    for s in range(0, len(points), _CHUNK):
        pts = cKDTree(points[s:s + _CHUNK])
        acc = np.zeros(pts.n)
        for tree, r, hg, mh3 in groups:
            pairs = pts.sparse_distance_matrix(tree, r, output_type="ndarray")
            j = pairs["j"]
            q = pairs["v"] / hg[j]
            near = q < 1.0
            if not near.any():
                continue
            acc += np.bincount(pairs["i"][near],
                               weights=cubic_spline_w(q[near]) * mh3[j[near]],
                               minlength=pts.n)
        out[s:s + _CHUNK] = acc
    return out


def _last_box(lo, hi, pts) -> np.ndarray:
    """(P,) index of the last box j with lo[j] <= pt < hi[j] on every axis,
    -1 for none: the reference's loop of `np.where` over the boxes, in
    chunks of boxes."""
    out = np.full(len(pts), -1, np.int64)
    step = max(1, (1 << 22) // max(len(pts), 1))
    for s in range(0, len(lo), step):
        l, u = lo[s:s + step], hi[s:s + step]
        sel = np.all((pts[:, None, :] >= l[None]) & (pts[:, None, :]
                                                     < u[None]), axis=-1)
        hit = sel.any(axis=1)
        last = sel.shape[1] - 1 - np.argmax(sel[:, ::-1], axis=1)
        out = np.where(hit, s + last, out)
    return out


# ---------------------------------------------------------------- snapshots

@dataclasses.dataclass
class ParticleSnapshot:
    """SPH particles: positions (N,3) [m], smoothing lengths h (N,) [m],
    masses m (N,) [kg] (or entity counts), optional velocity (N,3) [m/s]
    and extra per-particle properties (dict of (N,) arrays)."""

    positions: np.ndarray
    h: np.ndarray
    mass: np.ndarray
    velocity: np.ndarray | None = None
    props: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.positions = np.asarray(self.positions, np.float64)
        self.h = np.asarray(self.h, np.float64)
        self.mass = np.asarray(self.mass, np.float64)

    @property
    def n(self) -> int:
        return len(self.mass)

    def density_on_cells(self, grid, samples: int = 1,
                         seed: int = 9) -> np.ndarray:
        """Kernel-smoothed mass density at the cell centres [kg/m^3]
        (ref: ParticleSnapshot::density; samples and seed unused, as in
        the reference)."""
        return self.density_at(grid.cell_centers().cpu().numpy()
                               .astype(np.float64))

    def density_at(self, points: np.ndarray) -> np.ndarray:
        """Kernel-smoothed mass density at arbitrary positions [kg/m^3]:
        the density_np adapter of a grid-refinement policy."""
        return kernel_density(self.positions, self.h, self.mass, points)

    def velocity_on_cells(self, grid) -> np.ndarray:
        """The velocity of the particle nearest to each cell centre."""
        if self.velocity is None:
            return np.zeros((grid.ncells, 3))
        from scipy.spatial import cKDTree
        centers = grid.cell_centers().cpu().numpy().astype(np.float64)
        _, idx = cKDTree(self.positions).query(centers)
        return np.asarray(self.velocity, np.float64)[idx]

    # EntityCollection-style overlap queries (ref: SKIRT/utils/
    # EntityCollection.hpp), on the host as in the reference
    def entities_at(self, pos) -> list:
        """(entity index, kernel weight) pairs overlapping a position."""
        from scipy.spatial import cKDTree
        pos = np.asarray(pos, np.float64)
        plist = cKDTree(self.positions).query_ball_point(pos, self.h.max())
        out = []
        for j in plist:
            q = np.linalg.norm(self.positions[j] - pos) / self.h[j]
            w = float(cubic_spline_w(np.array([q]))[0] / self.h[j] ** 3)
            if w > 0:
                out.append((int(j), w))
        return out

    def entities_along_path(self, r0, k, smax: float) -> list:
        """(entity, column weight) pairs for the segment r0 + s k, s in
        [0, smax]: the kernel's column integral through each particle."""
        r0 = np.asarray(r0, np.float64)
        k = np.asarray(k, np.float64)
        k = k / np.linalg.norm(k)
        rel = self.positions - r0
        s_close = rel @ k
        d_perp = np.linalg.norm(rel - s_close[:, None] * k[None, :], axis=-1)
        hits = np.flatnonzero((d_perp < self.h) & (s_close > -self.h)
                              & (s_close < smax + self.h))
        out = []
        for j in hits:
            t = np.linspace(-self.h[j], self.h[j], 33)
            q = np.sqrt(d_perp[j] ** 2 + t ** 2) / self.h[j]
            w = np.trapezoid(cubic_spline_w(q) / self.h[j] ** 3, t)
            if w > 0:
                out.append((int(j), float(w)))
        return out

    def column_density(self, r0, k, smax: float) -> float:
        """Kernel-weighted mass column [kg/m^2] along a path."""
        return sum(self.mass[j] * w
                   for j, w in self.entities_along_path(r0, k, smax))


@dataclasses.dataclass
class CellSnapshot:
    """Axis-aligned box cells: lo (N,3), hi (N,3) [m], mass (N,) [kg]
    (ref: CellSnapshot)."""

    lo: np.ndarray
    hi: np.ndarray
    mass: np.ndarray
    velocity: np.ndarray | None = None

    def _boxes(self):
        return (np.asarray(self.lo, np.float64),
                np.asarray(self.hi, np.float64))

    def velocity_on_cells(self, grid) -> np.ndarray:
        """Bulk velocity of the snapshot cell holding each grid-cell
        centre (zero outside every snapshot cell)."""
        if self.velocity is None:
            return np.zeros((grid.ncells, 3))
        centers = grid.cell_centers().cpu().numpy().astype(np.float64)
        j = _last_box(*self._boxes(), centers)
        v = np.asarray(self.velocity, np.float64)
        return np.where(j[:, None] >= 0, v[np.maximum(j, 0)], 0.0)

    def box_density(self, pts) -> np.ndarray:
        """The density of the last snapshot box holding each point, 0
        outside every box."""
        lo, hi = self._boxes()
        rho = np.asarray(self.mass, np.float64) / np.prod(hi - lo, axis=-1)
        j = _last_box(lo, hi, np.atleast_2d(np.asarray(pts, np.float64)))
        return np.where(j >= 0, rho[np.maximum(j, 0)], 0.0)

    def density_on_cells(self, grid, samples: int = 4,
                         seed: int = 9) -> np.ndarray:
        """The snapshot's box densities averaged over `samples` seeded
        points per grid cell, uniform in the cube of the cell's volume
        about its centre (`snapshots.py:203-222`)."""
        centers = grid.cell_centers().cpu().numpy().astype(np.float64)
        halfe = np.cbrt(np.asarray(grid.volumes(), np.float64))[:, None] \
            * 0.5
        rs = np.random.default_rng(seed)
        out = np.zeros(len(centers))
        for _ in range(samples):
            out += self.box_density(
                centers + rs.uniform(-1, 1, centers.shape) * halfe)
        return out / samples


def _sector_density(lo, hi, mass, volume, coords) -> np.ndarray:
    """Density of the last curvilinear cell [lo, hi) holding each point's
    coordinates (P, 3), 0 outside every cell."""
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    rho = np.asarray(mass, np.float64) / np.maximum(volume, 1e-300)
    flat = coords.reshape(-1, 3)
    j = _last_box(lo, hi, flat)
    return np.where(j >= 0, rho[np.maximum(j, 0)], 0.0).reshape(
        coords.shape[:-1])


@dataclasses.dataclass(frozen=True)
class CylindricalCellSnapshot:
    """Cylindrical cells (Rmin, phimin, zmin, Rmax, phimax, zmax) with a
    mass per cell (ref: CylindricalCellSnapshot.hpp; angles in radians)."""

    lo: np.ndarray        # (N,3) [R, phi, z]
    hi: np.ndarray
    mass: np.ndarray
    velocity: np.ndarray | None = None

    def density_at(self, pos):
        pos = np.asarray(pos, np.float64)
        lo, hi = np.asarray(self.lo, np.float64), np.asarray(self.hi,
                                                             np.float64)
        vol = 0.5 * (hi[:, 0] ** 2 - lo[:, 0] ** 2) \
            * (hi[:, 1] - lo[:, 1]) * (hi[:, 2] - lo[:, 2])
        coords = np.stack([np.hypot(pos[..., 0], pos[..., 1]),
                           np.mod(np.arctan2(pos[..., 1], pos[..., 0]),
                                  2 * np.pi), pos[..., 2]], axis=-1)
        return _sector_density(lo, hi, self.mass, vol, coords)

    def density_on_cells(self, grid, samples: int = 1, seed: int = 9):
        return self.density_at(grid.cell_centers().cpu().numpy()
                               .astype(np.float64))


@dataclasses.dataclass(frozen=True)
class SphericalCellSnapshot:
    """Spherical cells (rmin, thetamin, phimin, ...) with a mass per cell
    (ref: SphericalCellSnapshot.hpp; angles in radians)."""

    lo: np.ndarray        # (N,3) [r, theta, phi]
    hi: np.ndarray
    mass: np.ndarray
    velocity: np.ndarray | None = None

    def density_at(self, pos):
        pos = np.asarray(pos, np.float64)
        lo, hi = np.asarray(self.lo, np.float64), np.asarray(self.hi,
                                                             np.float64)
        vol = (hi[:, 0] ** 3 - lo[:, 0] ** 3) / 3.0 \
            * (np.cos(lo[:, 1]) - np.cos(hi[:, 1])) \
            * (hi[:, 2] - lo[:, 2])
        r = np.linalg.norm(pos, axis=-1)
        coords = np.stack([
            r, np.arccos(np.clip(pos[..., 2] / np.maximum(r, 1e-300), -1, 1)),
            np.mod(np.arctan2(pos[..., 1], pos[..., 0]), 2 * np.pi)],
            axis=-1)
        return _sector_density(lo, hi, self.mass, vol, coords)

    def density_on_cells(self, grid, samples: int = 1, seed: int = 9):
        return self.density_at(grid.cell_centers().cpu().numpy()
                               .astype(np.float64))


@dataclasses.dataclass(frozen=True)
class MeshSnapshot:
    """Data on a regular Cartesian mesh spanning a box: values (nx,ny,nz)
    of mass per mesh cell (ref: MeshSnapshot behind MeshGeometry /
    MeshSource / MeshMedium)."""

    lo: np.ndarray         # (3,) box corner [m]
    hi: np.ndarray
    mass: np.ndarray       # (nx, ny, nz) mass per mesh cell [kg]
    velocity: np.ndarray | None = None   # (nx, ny, nz, 3)

    @property
    def shape(self):
        return self.mass.shape

    def _cellsize(self):
        return (np.asarray(self.hi, np.float64)
                - np.asarray(self.lo, np.float64)) \
            / np.asarray(self.mass.shape, np.float64)

    def density_at(self, pos):
        pos = np.asarray(pos, np.float64)
        h = self._cellsize()
        ijk = np.floor((pos - np.asarray(self.lo)) / h).astype(np.int64)
        n = np.asarray(self.mass.shape)
        inside = np.all((ijk >= 0) & (ijk < n), axis=-1)
        ijk = np.clip(ijk, 0, n - 1)
        rho = np.asarray(self.mass, np.float64) / np.prod(h)
        return np.where(inside, rho[ijk[..., 0], ijk[..., 1], ijk[..., 2]],
                        0.0)

    def density_on_cells(self, grid, samples: int = 1, seed: int = 9):
        return self.density_at(grid.cell_centers().cpu().numpy()
                               .astype(np.float64))

    def cell_bounds(self):
        """The mesh cells' boxes (lo, hi), (nx ny nz, 3) f64, x slowest."""
        n = self.mass.shape
        idx = np.stack(np.meshgrid(np.arange(n[0]), np.arange(n[1]),
                                   np.arange(n[2]), indexing="ij"),
                       axis=-1).reshape(-1, 3)
        lo = np.asarray(self.lo) + idx * self._cellsize()
        return lo, lo + self._cellsize()

    def as_cell_source(self, luminosity_per_cell: np.ndarray, ems_borders,
                       spectra, spatial_bias: float = 0.5, device="cpu"):
        """A source launching from the mesh cells with the given per-cell
        spectra (ref: MeshSource): the secondary source's per-cell launch
        on `device`."""
        from ..sources import secondary as sec
        return sec.prepare(self,
                           np.asarray(luminosity_per_cell,
                                      np.float64).reshape(-1),
                           np.asarray(spectra, np.float64).reshape(
                               -1, np.asarray(spectra).shape[-1]),
                           np.asarray(ems_borders, np.float64), spatial_bias,
                           device=device)


def imported_medium(grid, snapshot, mix, samples: int = 1) \
        -> msys.MediumTables:
    """MediumTables (on the CPU) from a snapshot and a material mix: number
    density = mass density / mix.mu (ref: ImportedMedium with massType
    Mass), and the snapshot's velocities on the cells where it has them."""
    from ..media import mixes as mx
    rho = snapshot.density_on_cells(grid, samples=samples)
    if mix.mu <= 0:
        raise ValueError("imported medium needs a mix with mu > 0")
    lam, se, al, g = mx.stack([mix])
    bulk_v = snapshot.velocity_on_cells(grid) if hasattr(
        snapshot, "velocity_on_cells") else None
    return msys.make_medium(grid, (rho / mix.mu).astype(np.float32), lam, se,
                            al, g, bulk_v=None if bulk_v is None else
                            np.asarray(bulk_v, np.float32))


# --------------------------------------------------------------- BB family

_X_GRID = np.geomspace(1e-2, 50, 512)          # x = hc/(lam k T)
_planck_x = _X_GRID**3 / np.expm1(_X_GRID)     # dimensionless B in x
_X_CDF = np.concatenate([[0.0], np.cumsum(
    0.5 * (_planck_x[1:] + _planck_x[:-1]) * np.diff(_X_GRID))])
_X_CDF /= _X_CDF[-1]


def planck_tables(device) -> tuple:
    """The dimensionless Planck cdf (x, cdf) as f32 tensors on `device`."""
    return (torch.tensor(_X_GRID.astype(np.float32), device=device),
            torch.tensor(_X_CDF[1:].astype(np.float32), device=device))


def sample_planck_wavelength(u: torch.Tensor, T: torch.Tensor,
                             tables=None) -> torch.Tensor:
    """lam from a blackbody at per-packet temperature T through the one
    dimensionless Planck cdf in x = hc/(lam k T) for all temperatures
    (ref: BlackBodySEDFamily); tables: the `planck_tables` of u's device."""
    xv, cdf = tables or planck_tables(u.device)
    x = sampling.sample_cdf_linlin(u, xv, cdf)
    return xm.rdiv(c.H_PLANCK * c.C_LIGHT, x * c.K_BOLTZMANN * T)


# ----------------------------------------------------------------- sources

def _no_velocity(velocity, name: str) -> None:
    if velocity is not None:
        raise NotImplementedError(
            f"{name} with imported velocities (importVelocity) not ported "
            "yet: moving sources need emission Doppler shifts (ROADMAP "
            "queue A item 45)")


def _pick(tabs: dict, keys: torch.Tensor) -> torch.Tensor:
    """The entity of each packet by its luminosity cdf."""
    cdf = tabs["cdf"]
    u = rng.uniform(keys, rng.LAUNCH_SOURCE)
    return torch.clamp(sampling.searchsorted_right(cdf, u), 0,
                       cdf.shape[0] - 1)


def _in_box(lo, hi, keys, tag: int) -> torch.Tensor:
    """lo + u (hi - lo) for uniform u of three purposes (B, 3)."""
    u = torch.stack([rng.uniform(keys, tag + i) for i in range(3)], dim=-1)
    return xm.fma(u, hi - lo, lo)


def _kernel_position(tabs, keys, p) -> torch.Tensor:
    """A kernel-smoothed position about particle p."""
    q = sampling.sample_cdf_linlin(rng.uniform(keys, rng.LAUNCH_POSITION),
                                   tabs["kq"], tabs["kc"])
    d = rng.isotropic_direction(keys, rng.LAUNCH_POSITION + 60)
    return tabs["pos"][p] + (q * tabs["h"][p])[:, None] * d


def _family_tables(ft, scales, params, device) -> dict:
    """The luminosity cdf and the family's corner tables of the entities."""
    L = ft.entity_luminosities(scales, params)
    cdf = np.cumsum(L) / max(L.sum(), 1e-300)
    cidx, ccdf, cw, ratio = ft.corner_tables(params, device)
    return {"cdf": torch.tensor(cdf.astype(np.float32), device=device),
            "corner_idx": cidx, "corner_cdf": ccdf, "corner_w": cw,
            "lin_over_geo": ratio}


def _family_launch(ft, luminosity, tabs, keys, p, pos, n_total) -> dict:
    """The launch fields of entity p's packets at pos: isotropic
    directions, wavelengths from the family (stratified where the launch
    carries strata) with the mixture's importance weight."""
    B = keys.shape[0]
    dirn = rng.isotropic_direction(keys, rng.LAUNCH_DIRECTION)
    if "strata" in tabs:
        # bin-pure lane groups for wavelength-binned deposits
        lam, w_strat = ft.sample_wavelength_stratified(
            keys, p, tabs["corner_idx"], tabs["corner_cdf"], tabs["strata"],
            tabs.get("strata_w"))
    else:
        lam = ft.sample_wavelength(keys, p, tabs["corner_idx"],
                                   tabs["corner_cdf"])
        w_strat = 1.0
    # importance correction: the linear corner mixture proposal -> the
    # reference's geometric (log-interpolated) parameter mixture
    wgt = ft.mixture_weight(lam, p, tabs["corner_idx"], tabs["corner_w"],
                            tabs["lin_over_geo"]) * w_strat
    lum = torch.full((B,), luminosity / n_total, dtype=torch.float32,
                     device=keys.device) * wgt
    return {"lam": lam, "lum": lum, "pos": pos, "dir": dirn}


@dataclasses.dataclass(frozen=True)
class ParticleSource:
    """Imported source: particles with luminosities and a blackbody of a
    per-particle temperature (ref: ParticleSource + BlackBodySEDFamily):
    kernel-smoothed positions, wavelengths through the dimensionless
    Planck cdf."""

    snapshot: ParticleSnapshot
    luminosities: np.ndarray   # (N,) [W]
    temperatures: np.ndarray   # (N,) [K]

    def __post_init__(self):
        _no_velocity(self.snapshot.velocity, "ParticleSource")

    @property
    def luminosity(self) -> float:
        return float(np.sum(self.luminosities))

    def tables(self, device) -> dict:
        L = np.asarray(self.luminosities, np.float64)
        f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
        kq, kc = kernel_radius_tables(device)
        xv, xc = planck_tables(device)
        return {"cdf": f32(np.cumsum(L) / L.sum()),
                "pos": f32(self.snapshot.positions), "h": f32(self.snapshot.h),
                "T": f32(self.temperatures), "kq": kq, "kc": kc, "xv": xv,
                "xc": xc}

    def launch(self, tabs: dict, keys: torch.Tensor, n_total: int) -> dict:
        """Launch fields lam, lum, pos, dir from the launch keys (B, 2)."""
        B = keys.shape[0]
        p = _pick(tabs, keys)
        pos = _kernel_position(tabs, keys, p)
        dirn = rng.isotropic_direction(keys, rng.LAUNCH_DIRECTION)
        lam = sample_planck_wavelength(
            rng.uniform(keys, rng.LAUNCH_WAVELENGTH), tabs["T"][p],
            (tabs["xv"], tabs["xc"]))
        lum = torch.full((B,), self.luminosity / n_total, dtype=torch.float32,
                         device=keys.device)
        return {"lam": lam, "lum": lum, "pos": pos, "dir": dirn}


@dataclasses.dataclass(frozen=True)
class FamilyParticleSource:
    """Imported source whose per-particle spectra come from an SEDFamily
    (ref: ImportedSource.hpp:104 sedFamily + ParticleSource). Wavelengths
    are sampled by the family's corner-mixture tables; luminosity
    allocation integrates the family over the source range per entity;
    positions are smoothed by the particle's kernel."""

    snapshot: ParticleSnapshot
    family_tables: object      # spectral.sedfamily.FamilyTables
    scales: np.ndarray         # (N,) linear scale param (Minit/area/L)
    params: np.ndarray         # (N,P) family parameters per entity
    kernel_kind: str = "CubicSplineSmoothingKernel"

    def __post_init__(self):
        _no_velocity(self.snapshot.velocity, "ParticleSource")

    @property
    def lam_range(self) -> tuple:
        """Wavelength support for stratified bin-pure launches."""
        return self.family_tables.lam_range

    @property
    def luminosity(self) -> float:
        return float(np.sum(self.family_tables.entity_luminosities(
            self.scales, self.params)))

    def tables(self, device) -> dict:
        f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
        kq, kc = _radius_tables(self.kernel_kind, device)
        return dict(_family_tables(self.family_tables, self.scales,
                                   self.params, device),
                    pos=f32(self.snapshot.positions), h=f32(self.snapshot.h),
                    kq=kq, kc=kc)

    def launch(self, tabs: dict, keys: torch.Tensor, n_total: int) -> dict:
        """Launch fields lam, lum, pos, dir from the launch keys (B, 2)."""
        p = _pick(tabs, keys)
        return _family_launch(self.family_tables, self.luminosity, tabs, keys,
                              p, _kernel_position(tabs, keys, p), n_total)


@dataclasses.dataclass(frozen=True)
class CellFamilySource:
    """Imported source whose entities are axis-aligned box cells: packets
    launch uniformly within a luminosity-selected cell, wavelengths from
    the per-entity SED family (ref: CellSource + ImportedSource.hpp:70)."""

    lo: np.ndarray             # (N,3)
    hi: np.ndarray             # (N,3)
    family_tables: object
    scales: np.ndarray
    params: np.ndarray
    velocity: np.ndarray | None = None

    def __post_init__(self):
        _no_velocity(self.velocity, "CellSource")

    @property
    def lam_range(self):
        return self.family_tables.lam_range

    @property
    def luminosity(self) -> float:
        return float(np.sum(self.family_tables.entity_luminosities(
            self.scales, self.params)))

    def tables(self, device) -> dict:
        f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
        return dict(_family_tables(self.family_tables, self.scales,
                                   self.params, device),
                    lo=f32(self.lo), hi=f32(self.hi))

    def launch(self, tabs: dict, keys: torch.Tensor, n_total: int) -> dict:
        p = _pick(tabs, keys)
        pos = _in_box(tabs["lo"][p], tabs["hi"][p], keys, rng.LAUNCH_POSITION)
        return _family_launch(self.family_tables, self.luminosity, tabs, keys,
                              p, pos, n_total)


@dataclasses.dataclass(frozen=True)
class EntityFamilySource:
    """Imported source over entity shapes that an imported geometry samples
    (`geometries/imported.py`): AdaptiveMeshSource's leaf boxes
    (ref: AdaptiveMeshSource.hpp:46) and VoronoiMeshSource's cells
    (ref: VoronoiMeshSource.hpp:47), with per-entity SED families."""

    sampler: object            # provides entity_position(keys, j, tag)
    family_tables: object
    scales: np.ndarray
    params: np.ndarray
    velocity: np.ndarray | None = None

    def __post_init__(self):
        _no_velocity(self.velocity, "mesh source")

    @property
    def lam_range(self):
        return self.family_tables.lam_range

    @property
    def luminosity(self) -> float:
        return float(np.sum(self.family_tables.entity_luminosities(
            self.scales, self.params)))

    def tables(self, device) -> dict:
        return _family_tables(self.family_tables, self.scales, self.params,
                              device)

    def launch(self, tabs: dict, keys: torch.Tensor, n_total: int) -> dict:
        p = _pick(tabs, keys)
        pos = self.sampler.entity_position(keys, p, rng.LAUNCH_POSITION)
        return _family_launch(self.family_tables, self.luminosity, tabs, keys,
                              p, pos, n_total)


def read_column_file(path: str, columns: list[tuple[str, str, str]]):
    """Text import with unit conversion: columns = [(name, quantity, unit)]
    (ref: TextInFile column descriptors). Returns dict of SI arrays."""
    data = np.loadtxt(path, ndmin=2)
    if data.shape[1] < len(columns):
        raise ValueError(f"file has {data.shape[1]} columns, "
                         f"need {len(columns)}")
    out = {}
    for i, (name, qty, unit) in enumerate(columns):
        factor = U.to_si(qty, 1.0, unit) if unit else 1.0
        out[name] = data[:, i] * factor
    return out
