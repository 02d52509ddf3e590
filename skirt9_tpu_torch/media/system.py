"""Medium system: per-cell densities and per-component optical tables.

Port of `skirt9_tpu/media/system.py:30-183`. The medium is a pair of dense
tables: nd[cell, h] number densities and (H, T) cross-section / asymmetry
tables on a wavelength axis, gathered once per packet wavelength into
(B, H) `Optics`, the per-cell bulk velocities of moving media, the
per-cell gas temperatures of resonant-line media (Lyman-alpha) and the
metallicities an imported medium carries.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import sampling
from . import mixes as mx


class MediumTables(NamedTuple):
    nd: torch.Tensor         # (ncells, H) number density [1/m^3]
    lam_t: torch.Tensor      # (T,) wavelength table [m], increasing
    sigma_ext: torch.Tensor  # (H, T) extinction cross section [m^2]
    sigma_sca: torch.Tensor  # (H, T) scattering cross section [m^2]
    g: torch.Tensor          # (H, T) HG asymmetry parameter
    bulk_v: torch.Tensor     # (ncells, 3) bulk velocity [m/s]
    temperature: torch.Tensor  # (ncells,) gas kinetic temperature [K]
    metallicity: torch.Tensor  # (ncells,) imported metallicity, else zeros

    @property
    def ncomp(self) -> int:
        return self.sigma_ext.shape[0]

    @property
    def ncells(self) -> int:
        return self.nd.shape[0]

    def to(self, device) -> "MediumTables":
        return MediumTables(*(t.to(device) for t in self))


class Optics(NamedTuple):
    """Per-packet per-component cross sections at the packet wavelength."""

    sigma_ext: torch.Tensor  # (B, H)
    sigma_sca: torch.Tensor  # (B, H)
    g: torch.Tensor          # (B, H)


def optics_at(med: MediumTables, lam: torch.Tensor) -> Optics:
    """Log-log interpolated cross sections and linear g at wavelengths (B,)."""
    se, ss, gg = [], [], []
    for h in range(med.ncomp):
        se.append(sampling.interp_loglog(lam, med.lam_t, med.sigma_ext[h]))
        ss.append(sampling.interp_loglog(lam, med.lam_t, med.sigma_sca[h]))
        gg.append(sampling.interp_linlin(lam, med.lam_t, med.g[h]))
    return Optics(sigma_ext=torch.stack(se, dim=1),
                  sigma_sca=torch.stack(ss, dim=1), g=torch.stack(gg, dim=1))


def _opacity(med: MediumTables, sigma: torch.Tensor, cell: torch.Tensor):
    k = torch.sum(med.nd[torch.clamp_min(cell, 0)] * sigma, dim=-1)
    return torch.where(cell >= 0, k, torch.zeros_like(k))


def albedo_for_scattering(med: MediumTables, opt: Optics,
                          cell: torch.Tensor) -> torch.Tensor:
    """Aggregate albedo k_sca/k_ext at the interaction cell."""
    if med.ncomp == 1:
        # one component: the density cancels
        ke = opt.sigma_ext[..., 0]
        ks = opt.sigma_sca[..., 0]
    else:
        ke = _opacity(med, opt.sigma_ext, cell)
        ks = _opacity(med, opt.sigma_sca, cell)
    return torch.where(ke > 0, ks / torch.clamp_min(ke, 1e-30),
                       torch.zeros_like(ke))


def scattering_weights(med: MediumTables, opt: Optics,
                       cell: torch.Tensor) -> torch.Tensor:
    """Normalised per-component scattering-opacity weights (B, H)."""
    if med.ncomp == 1:
        return torch.ones(cell.shape + (1,), dtype=torch.float32,
                          device=cell.device)
    w = med.nd[torch.clamp_min(cell, 0)] * opt.sigma_sca
    return w / torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), 1e-30)


def select_component(med: MediumTables, opt: Optics, cell: torch.Tensor,
                     u: torch.Tensor) -> torch.Tensor:
    """Scattering component per packet, sampled from the weights."""
    if med.ncomp == 1:
        return torch.zeros(cell.shape, dtype=torch.int64, device=cell.device)
    cdf = torch.cumsum(scattering_weights(med, opt, cell), dim=-1)
    return torch.argmax((cdf >= u[..., None]).to(torch.int8), dim=-1)


# ------------------------------------------------------------------ builders

def uniform_density_sphere(grid, tau_radius: float, sigma_ext_val: float,
                           radius: float, center=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Host-side per-cell number density of a uniform sphere with radial
    optical depth tau_radius, sampled at cell centres."""
    centers = grid.cell_centers().cpu().numpy()
    r = np.linalg.norm(centers - np.asarray(center), axis=-1)
    nd_val = tau_radius / (sigma_ext_val * radius)
    return np.where(r <= radius, nd_val, 0.0).astype(np.float32)


def make_medium(grid, nd: np.ndarray, lam_t: np.ndarray, sigma_ext: np.ndarray,
                albedo: np.ndarray, g: np.ndarray,
                bulk_v: np.ndarray | None = None,
                temperature: np.ndarray | None = None,
                magnetic_field: np.ndarray | None = None,
                metallicity: np.ndarray | None = None) -> MediumTables:
    """Assemble MediumTables (on the CPU) from host arrays.

    nd: (ncells,) or (ncells, H); tables: (T,) or (H, T); bulk_v: (ncells,
    3) per-cell bulk velocities, temperature: (ncells,) gas temperatures
    and metallicity: (ncells,) imported metallicities, zeros by default.
    Per-cell magnetic fields serve the aligned spheroidal grains, which
    are not ported yet (ROADMAP queue A item 32), and raise."""
    if magnetic_field is not None:
        raise NotImplementedError(
            "medium state magnetic_field is not ported yet (it serves the "
            "aligned spheroidal grains' emission)")
    nd = np.asarray(nd, np.float32)
    if nd.ndim == 1:
        nd = nd[:, None]
    sigma_ext = np.atleast_2d(np.asarray(sigma_ext, np.float64))
    albedo = np.atleast_2d(np.asarray(albedo, np.float64))
    g = np.atleast_2d(np.asarray(g, np.float64))
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32))
    if bulk_v is None:
        bulk_v = np.zeros((nd.shape[0], 3), np.float32)
    if temperature is None:
        temperature = np.zeros(nd.shape[0], np.float32)
    if metallicity is None:
        metallicity = np.zeros(nd.shape[0], np.float32)
    return MediumTables(nd=f32(nd), lam_t=f32(lam_t), sigma_ext=f32(sigma_ext),
                        sigma_sca=f32(sigma_ext * albedo), g=f32(g),
                        bulk_v=f32(bulk_v), temperature=f32(temperature),
                        metallicity=f32(metallicity))


def site_medium(grid, density: np.ndarray, mass_type: str, mix,
                metallicity: np.ndarray | None = None,
                temperature: np.ndarray | None = None,
                bulk_v: np.ndarray | None = None) -> MediumTables:
    """One imported component with a density per cell, as a Voronoi mesh's
    sites carry it (the reference's loader, `skirt9_tpu/config/ski.py:
    1783-1800, 1983-2000`): a MassDensity [kg/m^3] becomes a number density
    through the mix's mass per entity, a NumberDensity [1/m^3] is one; an
    imported metallicity scales it and is kept, as are the imported
    temperatures and velocities."""
    if mass_type == "MassDensity":
        nd = np.asarray(density, np.float64) / mix.mu
    elif mass_type == "NumberDensity":
        nd = np.asarray(density, np.float64)
    else:
        raise NotImplementedError(f"massType '{mass_type}' not ported yet "
                                  "(MassDensity, NumberDensity)")
    if metallicity is not None:
        nd = nd * metallicity
    lam, se, al, gg = mx.stack([mix])
    return make_medium(grid, nd.astype(np.float32), lam, se, al, gg,
                       bulk_v=None if bulk_v is None else
                       np.asarray(bulk_v, np.float32),
                       temperature=temperature, metallicity=metallicity)
