"""Imported snapshots: star particles as a source.

Port of the part of `skirt9_tpu/imports/snapshots.py` that a
`ParticleSource` with an SED family reaches (ref: ParticleSnapshot.hpp:25,
ImportedSource.hpp:70, SmoothingKernel.hpp:22, TextInFile.hpp:87): the
cubic-spline smoothing kernel and its radius sampler, the particle fields,
`FamilyParticleSource` (luminosity-weighted particle selection,
kernel-smoothed launch positions, per-particle wavelengths through the
family, stratified over wavelength strata where the launch carries them)
and the column-file import. The other snapshot classes, `imported_medium`,
the other smoothing kernels (`kernel_tables`) and the other imported
sources are not ported yet: asking the module for one raises
NotImplementedError naming it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import rng, sampling
from ..utils import units as U

# the reference's names this module does not port yet
_WAITING = frozenset((
    "CellSnapshot", "CylindricalCellSnapshot", "SphericalCellSnapshot",
    "MeshSnapshot", "imported_medium", "sample_planck_wavelength",
    "ParticleSource", "CellFamilySource", "EntityFamilySource",
    "kernel_tables"))


def __getattr__(name):
    if name in _WAITING:
        raise NotImplementedError(f"imports.snapshots.{name} not ported yet")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# ------------------------------------------------------------- SPH kernel

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


# --------------------------------------------------------------- snapshot

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


# ----------------------------------------------------------------- source

@dataclasses.dataclass(frozen=True)
class FamilyParticleSource:
    """Imported source whose per-particle spectra come from an SEDFamily
    (ref: ImportedSource.hpp:104 sedFamily + ParticleSource). Wavelengths
    are sampled by the family's corner-mixture tables; luminosity
    allocation integrates the family over the source range per entity.
    Particles without velocities and the cubic-spline kernel only."""

    snapshot: ParticleSnapshot
    family_tables: object      # spectral.sedfamily.FamilyTables
    scales: np.ndarray         # (N,) linear scale param (Minit/area/L)
    params: np.ndarray         # (N,P) family parameters per entity
    kernel_kind: str = "CubicSplineSmoothingKernel"

    def __post_init__(self):
        if self.kernel_kind != "CubicSplineSmoothingKernel":
            raise NotImplementedError(f"{self.kernel_kind} not ported yet "
                                      "(CubicSplineSmoothingKernel)")
        if self.snapshot.velocity is not None:
            raise NotImplementedError("particle velocities (importVelocity) "
                                      "not ported yet")

    @property
    def lam_range(self) -> tuple:
        """Wavelength support for stratified bin-pure launches."""
        return self.family_tables.lam_range

    @property
    def luminosity(self) -> float:
        return float(np.sum(self.family_tables.entity_luminosities(
            self.scales, self.params)))

    def tables(self, device="cpu") -> dict:
        ft = self.family_tables
        L = ft.entity_luminosities(self.scales, self.params)
        cdf = np.cumsum(L) / max(L.sum(), 1e-300)
        cidx, ccdf, cw, ratio = ft.corner_tables(self.params, device)
        f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
        kq, kc = kernel_radius_tables(device)
        return {"cdf": f32(cdf), "pos": f32(self.snapshot.positions),
                "h": f32(self.snapshot.h), "corner_idx": cidx,
                "corner_cdf": ccdf, "corner_w": cw, "lin_over_geo": ratio,
                "kq": kq, "kc": kc}

    def launch(self, tabs: dict, keys: torch.Tensor, n_total: int) -> dict:
        """Launch fields lam, lum, pos, dir from the launch keys (B, 2)."""
        B = keys.shape[0]
        u_sel = rng.uniform(keys, rng.LAUNCH_SOURCE)
        cdf = tabs["cdf"]
        p = torch.clamp(sampling.searchsorted_right(cdf, u_sel), 0,
                        cdf.shape[0] - 1)
        q = sample_kernel_radius(rng.uniform(keys, rng.LAUNCH_POSITION),
                                 (tabs["kq"], tabs["kc"]))
        dirn_r = rng.isotropic_direction(keys, rng.LAUNCH_POSITION + 60)
        pos = tabs["pos"][p] + (q * tabs["h"][p])[:, None] * dirn_r
        dirn = rng.isotropic_direction(keys, rng.LAUNCH_DIRECTION)
        ft = self.family_tables
        if "strata" in tabs:
            # bin-pure lane groups for wavelength-binned deposits
            lam, w_strat = ft.sample_wavelength_stratified(
                keys, p, tabs["corner_idx"], tabs["corner_cdf"],
                tabs["strata"], tabs.get("strata_w"))
        else:
            lam = ft.sample_wavelength(keys, p, tabs["corner_idx"],
                                       tabs["corner_cdf"])
            w_strat = 1.0
        # importance correction: the linear corner mixture proposal -> the
        # reference's geometric (log-interpolated) parameter mixture
        wgt = ft.mixture_weight(lam, p, tabs["corner_idx"], tabs["corner_w"],
                                tabs["lin_over_geo"]) * w_strat
        lum = torch.full((B,), self.luminosity / n_total, dtype=torch.float32,
                         device=keys.device) * wgt
        return {"lam": lam, "lum": lum, "pos": pos, "dir": dirn}


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
