"""Primary sources: packet launching as batched functions of RNG keys.

Port of `skirt9_tpu/sources/base.py:29-51,87-162,177-331`: `TabulatedSED`,
the isotropic `PointSource` (monochromatic, or with a tabulated SED and the
composite wavelength bias: with probability 1-xi from the SED, else
log-uniform over its range, weighted by s / ((1-xi) s + xi b)), the
`GeometricSource` (positions from an analytic geometry), the stratified
wavelength launch and `launch_batch`. Wavelength-bias
distributions, angular distributions and polarisation profiles are not
ported yet and raise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import rng, sampling
from ..ops import xlamath as xm
from ..transport.packets import PacketBatch


def _f32(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=device)


@dataclasses.dataclass(frozen=True)
class TabulatedSED:
    """SED on a wavelength grid: lam (T,) [m], s_lambda (T,) in any units
    (normalised over its range); host-built cdf, sampled on the device."""

    lam: np.ndarray
    s: np.ndarray

    def tables(self, device) -> dict:
        cdf, _ = sampling.cdf_loglog(self.lam, self.s)
        s = np.asarray(self.s, np.float64)
        # pdf normalised to unit integral over the SED's range
        pdf = s / np.trapezoid(s, self.lam)
        return {"lam": _f32(self.lam, device), "cdf": _f32(cdf, device),
                "pdf": _f32(pdf, device)}


@dataclasses.dataclass(frozen=True)
class PointSource:
    """Isotropic point source of luminosity [W] over its wavelength range;
    monochromatic at lam0 when sed is None."""

    position: tuple = (0.0, 0.0, 0.0)
    luminosity: float = 1.0
    lam0: float = 0.55e-6
    sed: TabulatedSED | None = None
    wavelength_bias: float = 0.5
    angular: object = None
    bias_dist: object = None
    polarization: object = None

    def __post_init__(self):
        missing = [name for name in ("angular", "bias_dist", "polarization")
                   if getattr(self, name) is not None]
        if missing:
            raise NotImplementedError(
                f"PointSource {', '.join(missing)} not ported yet")

    def tables(self, device) -> dict:
        t = {"pos": _f32(self.position, device)}
        if self.sed is not None:
            t["sed"] = self.sed.tables(device)
        return t

    def launch(self, tabs: dict, keys: torch.Tensor, n_total: int) -> dict:
        """Launch fields lam (B,), lum (B,), pos (B, 3), dir (B, 3) from the
        per-packet launch keys (B, 2)."""
        B = keys.shape[0]
        pos = tabs["pos"].expand(B, 3)
        dirn = rng.isotropic_direction(keys, rng.LAUNCH_DIRECTION)
        lum = torch.full((B,), self.luminosity / n_total, dtype=torch.float32,
                         device=keys.device)
        lam, lum = _sample_wavelength(tabs, keys, lum, self.sed, self.lam0,
                                      self.wavelength_bias)
        return {"lam": lam, "lum": lum, "pos": pos, "dir": dirn}


@dataclasses.dataclass(frozen=True)
class GeometricSource:
    """A source with an analytic geometry and an SED (the reference's
    `skirt9_tpu/sources/base.py:135-162`; ref: SKIRT/core/GeometricSource):
    positions drawn from the geometry's normalised density (its `sample`,
    `geometries/`), isotropic directions, and the wavelength sampling of a
    point source. The velocity is carried and unused, as in the
    reference."""

    geometry: object
    luminosity: float = 1.0
    lam0: float = 0.55e-6
    sed: TabulatedSED | None = None
    wavelength_bias: float = 0.5
    velocity: tuple = (0.0, 0.0, 0.0)
    bias_dist: object = None

    def __post_init__(self):
        if self.bias_dist is not None:
            raise NotImplementedError("GeometricSource wavelengthBias"
                                      "Distribution not ported yet")

    def tables(self, device) -> dict:
        return {} if self.sed is None else {"sed": self.sed.tables(device)}

    def launch(self, tabs: dict, keys: torch.Tensor, n_total: int) -> dict:
        """Launch fields lam (B,), lum (B,), pos (B, 3), dir (B, 3) from the
        per-packet launch keys (B, 2)."""
        B = keys.shape[0]
        pos = self.geometry.sample(keys, rng.LAUNCH_POSITION)
        dirn = rng.isotropic_direction(keys, rng.LAUNCH_DIRECTION)
        lum = torch.full((B,), self.luminosity / n_total, dtype=torch.float32,
                         device=keys.device)
        lam, lum = _sample_wavelength(tabs, keys, lum, self.sed, self.lam0,
                                      self.wavelength_bias)
        return {"lam": lam, "lum": lum, "pos": pos, "dir": dirn}


def _sample_wavelength(tabs, keys, lum, sed, lam0, xi):
    """Composite-bias wavelength sampling shared by sources; stratified
    over tabs["strata"] when the launch carries strata."""
    if sed is None:
        return torch.full_like(lum, lam0), lum
    sedt = tabs["sed"]
    if "strata" in tabs:
        return _sample_wavelength_stratified(sedt, tabs["strata"], keys, lum,
                                             xi, tabs.get("strata_w"))
    # XLA's log, exp and fused multiply-adds (`ops.xlamath`): an ulp of a
    # logarithm moves a narrow line's wavelength by 1e-6 of itself
    u = rng.uniform(keys, rng.LAUNCH_WAVELENGTH)
    lam_sed = sampling.sample_cdf_loglog(u, sedt["lam"], sedt["cdf"],
                                         xla=True)
    if xi <= 0:
        return lam_sed, lum
    u2 = rng.uniform(keys, rng.LAUNCH_CELL)
    u3 = rng.uniform(keys, rng.LAUNCH_SOURCE)
    lmin, lmax = sedt["lam"][0], sedt["lam"][-1]
    log_w = xm.log_xla(lmax / lmin)
    lam_bias = lmin * xm.exp_xla(u2 * log_w)
    lam = torch.where(u3 < xi, lam_bias, lam_sed)
    b = 1.0 / (lam * log_w)
    s = sampling.interp_loglog(lam, sedt["lam"], sedt["pdf"], xla=True)
    w = s / torch.clamp_min(xm.fma(1.0 - xi, s, xi * b), 1e-37)
    return lam, lum * w


def _cdf_at(sedt, x):
    """Forward cdf S(x) of the tabulated SED, the exact inverse of
    `sampling.sample_cdf_loglog` (linear in log x within cdf bins)."""
    lam, cdf = sedt["lam"], sedt["cdf"]
    i = sampling.locate_clip(lam, x)
    lx0 = torch.log(lam[i])
    lx1 = torch.log(lam[i + 1])
    frac = torch.clamp((torch.log(x) - lx0) / torch.clamp_min(lx1 - lx0, 1e-30),
                       0.0, 1.0)
    c0 = cdf[i]
    S = c0 + frac * (cdf[i + 1] - c0)
    return torch.where(x <= lam[0], torch.zeros_like(S),
                       torch.where(x >= lam[-1], torch.ones_like(S), S))


def _sample_wavelength_stratified(sedt, borders, keys, lum, xi,
                                  strata_w=None):
    """Composite-bias sampling conditioned on per-lane wavelength strata.

    borders: (R+1,) stratum borders; lane i lies in stratum (i*R)//B and
    draws inside it, weighted by R times the stratum's mixture mass Q_r, so
    the estimator keeps its expectation. strata_w: (R,) per-stratum
    valid-lane corrections of the segment's last batch."""
    B = lum.shape[0]
    R = borders.shape[0] - 1
    stratum = (torch.arange(B, device=lum.device) * R) // B
    lo, hi = borders[stratum], borders[stratum + 1]
    lmin, lmax = sedt["lam"][0], sedt["lam"][-1]
    logw = torch.log(lmax / lmin)
    lo_c = torch.clamp(lo, lmin, lmax)
    hi_c = torch.clamp(hi, lmin, lmax)
    # component masses within the stratum
    Slo = _cdf_at(sedt, lo_c)
    Shi = _cdf_at(sedt, hi_c)
    p_sed = torch.clamp_min(Shi - Slo, 0.0)
    Blo = torch.log(lo_c / lmin) / logw
    Bhi = torch.log(hi_c / lmin) / logw
    p_bias = torch.clamp_min(Bhi - Blo, 0.0)
    Q = (1.0 - xi) * p_sed + xi * p_bias
    xi_r = torch.where(Q > 0, xi * p_bias / torch.clamp_min(Q, 1e-37),
                       torch.ones_like(Q))
    # conditional draws from each mixture component inside the stratum
    u = rng.uniform(keys, rng.LAUNCH_WAVELENGTH)
    lam_sed = sampling.sample_cdf_loglog(Slo + u * (Shi - Slo), sedt["lam"],
                                         sedt["cdf"])
    u2 = rng.uniform(keys, rng.LAUNCH_CELL)
    lam_bias = lo_c * torch.exp(u2 * (Bhi - Blo) * logw)
    u3 = rng.uniform(keys, rng.LAUNCH_SOURCE)
    lam = torch.where(u3 < xi_r, lam_bias, lam_sed)
    # keep strictly inside the stratum against interpolation rounding
    lam = torch.minimum(torch.maximum(lam, lo_c), hi_c * (1.0 - 1e-7))
    s = sampling.interp_loglog(lam, sedt["lam"], sedt["pdf"])
    b = 1.0 / (lam * logw)
    q = torch.clamp_min((1.0 - xi) * s + xi * b, 1e-37)
    w = torch.where(Q > 0, (R * Q) * s / q, torch.zeros_like(Q))
    if strata_w is not None:
        w = w * strata_w[stratum]
    return lam, lum * w


def launch_batch(source, tabs: dict, grid, seed_key: torch.Tensor,
                 history: torch.Tensor, n_total: int,
                 hist_end: int | None = None) -> PacketBatch:
    """A full PacketBatch for absolute history indices (B,), from any source
    with `launch(tabs, keys, n_total)` (a point source, the dust emission,
    `imports.snapshots.FamilyParticleSource`). n_total is this source's
    packet count; lanes with history >= hist_end carry no weight."""
    hkeys = rng.history_keys(seed_key, history)
    keys0 = rng.event_keys(hkeys, rng.LAUNCH_EVENT)
    f = source.launch(tabs, keys0, n_total)
    pos, cell, _ = grid.move_inside(f["pos"], f["dir"])
    valid = history < (n_total if hist_end is None else hist_end)
    lum = f["lum"]
    B = history.shape[0]
    # unpolarized, with the reference's normal (1, 0, 0) whatever the
    # direction (`skirt9_tpu/sources/base.py:325-328`)
    stokes = torch.zeros((B, 4), dtype=torch.float32, device=lum.device)
    stokes[:, 0] = 1.0
    normal = torch.zeros((B, 3), dtype=torch.float32, device=lum.device)
    normal[:, 0] = 1.0
    return PacketBatch(
        lam=f["lam"],
        lum=torch.where(valid, lum, torch.zeros_like(lum)),
        lum0=torch.clamp_min(lum, 1e-37),
        pos=pos, dir=f["dir"], cell=cell,
        nscat=torch.zeros_like(history),
        alive=valid & (lum > 0),
        hkey=hkeys, stokes=stokes, normal=normal)
