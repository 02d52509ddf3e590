"""Equilibrium dust emission: temperatures and emission spectra per cell.

Port of `skirt9_tpu/emission/equilibrium.py`. The energy balance

    P_abs = sum_bins sigma_abs(bin) rf[cell, bin] / V_cell = P_em(T)
          = 4 pi integral sigma_abs(lam) B_lam(T) dlam

is solved per (cell, component) by inverting a precomputed P_em(T) table on
a log-T grid. rf holds path-length sums L ds e^-tau in units of rf_scale
[W m]; rf_scale (~1e36 for a 1e5 Lsun source at parsec scales) is beyond
f32, so the device path keeps it out of every f32 intermediate: the
absorbed power stays in rf_scale units, the luminosity takes sqrt(rf_scale)
twice, and the temperature inversion runs in logs. The host functions work
in float64, as the reference's do.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..media.system import MediumTables
from ..ops import planck, sampling
from ..ops import xlamath as xm


class EmissionTables(NamedTuple):
    """Precomputed tables for equilibrium emission, on the medium's device."""

    T_grid: torch.Tensor        # (NT,) temperature grid [K]
    P_em: torch.Tensor          # (H, NT) emitted power per entity [W]
    lam_ems: torch.Tensor       # (L,) emission wavelength bin centres [m]
    dlam_ems: torch.Tensor      # (L,) bin widths
    sigma_abs_ems: torch.Tensor  # (H, L) absorption cross section on lam_ems
    sigma_abs_rf: torch.Tensor   # (H, R) absorption cross section, RF bins


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def build_emission_tables(med: MediumTables, rf_borders, ems_borders,
                          T_min: float = 2.0, T_max: float = 3000.0,
                          nT: int = 256) -> EmissionTables:
    lam_t = _host(med.lam_t)
    s_abs = np.maximum(_host(med.sigma_ext) - _host(med.sigma_sca), 0.0)
    rf_borders = np.asarray(rf_borders, np.float64)
    ems_borders = np.asarray(ems_borders, np.float64)

    def interp_abs(lams):
        out = np.array([np.exp(np.interp(np.log(lams), np.log(lam_t),
                                         np.log(np.maximum(s_abs[h], 1e-300))))
                        for h in range(s_abs.shape[0])])
        out[out < 1e-200] = 0.0
        return out

    rf_c = np.sqrt(rf_borders[1:] * rf_borders[:-1])
    ems_c = np.sqrt(ems_borders[1:] * ems_borders[:-1])
    # P_em(T) on a fine log-spaced integration grid
    lam_int = np.geomspace(1e-8, 1e-2, 800)
    sa_int = interp_abs(lam_int)                                 # (H, LI)
    T_grid = np.geomspace(T_min, T_max, nT)
    B = planck.b_lambda_np(lam_int[None, :], T_grid[:, None])    # (NT, LI)
    P = 4 * np.pi * np.trapezoid(sa_int[:, None, :] * B[None, :, :],
                                 lam_int, axis=-1)               # (H, NT)
    dev = med.nd.device
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    return EmissionTables(T_grid=f32(T_grid), P_em=f32(P), lam_ems=f32(ems_c),
                          dlam_ems=f32(np.diff(ems_borders)),
                          sigma_abs_ems=f32(interp_abs(ems_c)),
                          sigma_abs_rf=f32(interp_abs(rf_c)))


def absorbed_power(med: MediumTables, tabs: EmissionTables, rf, volumes,
                   rf_scale: float = 1.0) -> np.ndarray:
    """Absorbed power per entity per component (ncells, H) [W], host f64."""
    sab = _host(tabs.sigma_abs_rf)                     # (H, R)
    v = np.asarray(volumes, np.float64)
    return (_host(rf) @ sab.T) * (rf_scale / v)[:, None]


def cmb_heating_power(tabs: EmissionTables, T_cmb: float) -> np.ndarray:
    """Per-entity absorbed CMB power (H,) [W]: by Kirchhoff's law, P_em at
    the CMB temperature."""
    P = _host(tabs.P_em)
    if not T_cmb or T_cmb <= 0:
        return np.zeros(P.shape[0])
    lT = np.log(_host(tabs.T_grid))
    return np.array([np.exp(np.interp(np.log(T_cmb), lT,
                                      np.log(np.maximum(P[h], 1e-300))))
                     for h in range(P.shape[0])])


def equilibrium_temperature(tabs: EmissionTables, p_abs,
                            p_cmb=None) -> np.ndarray:
    """Invert P_em(T) per component: p_abs (ncells, H) -> T (ncells, H),
    log-log on the table, host f64; p_cmb (H,) joins the balance."""
    p = np.asarray(p_abs, np.float64)
    if p_cmb is not None:
        p = p + np.asarray(p_cmb, np.float64)[None, :]
    P = _host(tabs.P_em)
    lT = np.log(_host(tabs.T_grid))
    out = np.empty_like(p)
    for h in range(P.shape[0]):
        out[:, h] = np.exp(np.interp(np.log(np.maximum(p[:, h], 1e-300)),
                                     np.log(np.maximum(P[h], 1e-300)), lT))
    return out


def cell_emission_spectra(med: MediumTables, tabs: EmissionTables,
                          T) -> torch.Tensor:
    """Emission spectrum per cell on lam_ems (ncells, L), summed over
    components: 4 pi sum_h nd[cell, h] sigma_abs[h, l] B_lam(lam_l,
    T[cell, h]) [W/m per unit volume]."""
    T = torch.as_tensor(T, dtype=torch.float32, device=med.nd.device)
    B = planck.b_lambda(tabs.lam_ems[None, None, :], T[:, :, None])
    return 4 * math.pi * torch.sum(
        med.nd[:, :, None] * tabs.sigma_abs_ems[None, :, :] * B, dim=1)


def emission_state_device(med: MediumTables, tabs: EmissionTables, rf,
                          volumes, rf_scale: float, p_cmb=None):
    """Per-cell emission state on the device: (L_cell [W], T [K], eps);
    only the (ncells,) luminosities leave it, for the launch cdf. Subnormal
    absorption terms flush to zero as in the reference's XLA arithmetic: a
    cell that a sparse RF barely touches then emits nothing there too, and
    the launch cdf's count of emitting cells (its uniform share) agrees."""
    a = xm.ftz(xm.ftz(rf) @ tabs.sigma_abs_rf.T)  # (ncells, H), rf_scale units
    half = float(np.float32(np.sqrt(rf_scale)))
    L_cell = (xm.ftz(torch.sum(xm.ftz(a * med.nd), dim=1)) * half) * half
    # temperatures in logs: volumes (~1e47 m^3) and rf_scale leave f32
    log_v = torch.tensor(np.log(np.asarray(volumes, np.float64)),
                         dtype=torch.float32, device=rf.device)
    log_pabs = (torch.log(torch.clamp_min(a, 1e-30)) + float(np.log(rf_scale))
                - log_v[:, None])
    if p_cmb is not None and np.any(np.asarray(p_cmb) > 0):
        log_cmb = torch.tensor(np.log(np.maximum(np.asarray(p_cmb), 1e-300)),
                               dtype=torch.float32, device=rf.device)
        log_pabs = torch.logaddexp(log_pabs, log_cmb[None, :])
    lT = torch.log(tabs.T_grid)
    T = torch.stack([torch.exp(sampling.interp_linlin(
        log_pabs[:, h].contiguous(),
        torch.log(torch.clamp_min(tabs.P_em[h], 1e-300)), lT))
        for h in range(tabs.P_em.shape[0])], dim=1)             # (ncells, H)
    return L_cell, T, cell_emission_spectra(med, tabs, T)


def total_absorbed_device(med: MediumTables, tabs: EmissionTables, rf,
                          rf_scale: float) -> float:
    """Total absorbed (= emitted) power [W]; one scalar leaves the
    device."""
    a = rf @ tabs.sigma_abs_rf.T
    return float(torch.sum(a * med.nd)) * rf_scale


def dust_luminosities(med: MediumTables, tabs: EmissionTables, rf,
                      rf_scale: float = 1.0) -> np.ndarray:
    """Bolometric dust luminosity per cell (ncells,) [W], host f64: the
    absorbed power summed over components."""
    sab = _host(tabs.sigma_abs_rf)
    return np.sum((_host(rf) @ sab.T) * _host(med.nd), axis=1) * rf_scale
