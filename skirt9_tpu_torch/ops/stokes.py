"""Polarization: batched Stokes-vector algebra and Mueller scattering.

Port of `skirt9_tpu/ops/stokes.py` (the whole module) on PyTorch tensors.
All functions are batched over (B,).

Conventions (the reference's):
  * Stokes (I, Q, U, V) with I kept normalised to 1 on the packet; the
    luminosity carries the magnitude;
  * the reference direction n is perpendicular to the propagation k and
    defines the plane for +Q;
  * rotating the reference frame by phi around k transforms
    Q' = Q cos2phi + U sin2phi, U' = -Q sin2phi + U cos2phi.

Spherical-particle Mueller matrices reduce to (S11, S12, S33, S34):
    [S11 S12  0    0 ]
    [S12 S11  0    0 ]
    [ 0   0  S33  S34]
    [ 0   0 -S34  S33]

The reference's compare-reduce table lookups (`_take_comp`, the cdf count
of `sample_costheta`) work around the TPU's row gathers; here they are a
plain gather and `torch.searchsorted`, which give the same indices.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import sampling
from . import xlamath as xm


class MuellerTables(NamedTuple):
    """Tabulated spherical-particle Mueller matrix against the scattering
    angle, per medium component: theta (T,), S (H, T) each (not
    normalised; the phase function is normalised by `s11_norm`), and the
    S11-weighted cos(theta) sampling cdf on an increasing cos grid."""

    theta: torch.Tensor
    S11: torch.Tensor
    S12: torch.Tensor
    S33: torch.Tensor
    S34: torch.Tensor
    ct_grid: torch.Tensor   # (T,) cos(theta), increasing
    ct_cdf: torch.Tensor    # (H, T) cdf over cos(theta) weighted by S11

    def to(self, device) -> "MuellerTables":
        return MuellerTables(*(t.to(device) for t in self))


def electron_mueller(n_theta: int = 181) -> MuellerTables:
    """Thomson-scattering Mueller matrix (the exact dipole):
    S11 = (1 + c^2)/2, S12 = (c^2 - 1)/2, S33 = c, S34 = 0."""
    theta = np.linspace(0.0, np.pi, n_theta)
    c = np.cos(theta)
    return build_mueller(theta[None, :], (0.5 * (1 + c ** 2))[None, :],
                         (0.5 * (c ** 2 - 1))[None, :], c[None, :],
                         np.zeros_like(c)[None, :])


def rayleigh_like_mueller(pmax: float = 1.0,
                          n_theta: int = 181) -> MuellerTables:
    """Dipole-shaped polarization with peak linear polarization pmax (exact
    for pmax = 1 electrons)."""
    theta = np.linspace(0.0, np.pi, n_theta)
    c = np.cos(theta)
    return build_mueller(theta[None, :], (0.5 * (1 + c ** 2))[None, :],
                         (-pmax * 0.5 * (1 - c ** 2))[None, :], c[None, :],
                         np.zeros_like(c)[None, :])


def build_mueller(theta, S11, S12, S33, S34) -> MuellerTables:
    """Tables and the S11-weighted cos(theta) sampling cdf, built on the
    host in float64 and stored as float32 CPU tensors."""
    theta = np.atleast_2d(np.asarray(theta, np.float64))[0]
    S11 = np.atleast_2d(np.asarray(S11, np.float64))
    ct = np.cos(theta)[::-1].copy()          # increasing in cos
    w = S11[:, ::-1]
    seg = 0.5 * (w[:, 1:] + w[:, :-1]) * np.diff(ct)[None, :]
    cdf = np.concatenate([np.zeros((S11.shape[0], 1)),
                          np.cumsum(seg, axis=1)], axis=1)
    cdf /= cdf[:, -1:]
    f32 = lambda a: torch.tensor(np.atleast_2d(np.asarray(a, np.float64))
                                 .astype(np.float32))
    return MuellerTables(
        theta=torch.tensor(theta.astype(np.float32)), S11=f32(S11),
        S12=f32(S12), S33=f32(S33), S34=f32(S34),
        ct_grid=torch.tensor(ct.astype(np.float32)), ct_cdf=f32(cdf))


# --------------------------------------------------------------- Stokes math

def rotate_stokes(stokes: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Rotate the reference frame by phi around k: (B, 4)."""
    s2, c2 = xm.sincos(2 * phi)
    I, Q, U, V = stokes.unbind(-1)
    return torch.stack([I, Q * c2 + U * s2, -Q * s2 + U * c2, V], dim=-1)


def apply_mueller(stokes: torch.Tensor, S11, S12, S33, S34) -> torch.Tensor:
    """Apply a spherical-particle Mueller matrix (each S (B,))."""
    I, Q, U, V = stokes.unbind(-1)
    return torch.stack([S11 * I + S12 * Q, S12 * I + S11 * Q,
                        S33 * U + S34 * V, -S34 * U + S33 * V], dim=-1)


def normalize_stokes(stokes: torch.Tensor):
    """(stokes with I = 1, the former I): the packet keeps I = 1 and its
    luminosity absorbs the magnitude."""
    I = stokes[..., 0]
    return stokes / torch.clamp_min(I, 1e-37)[..., None], I


def rotate_normal_into_plane(k: torch.Tensor, normal: torch.Tensor,
                             kobs: torch.Tensor):
    """(phi, pn): the angle that rotates the reference normal into the
    scattering plane of (k, kobs), and that plane's normal (the current
    normal where k and kobs are parallel)."""
    pn = torch.cross(k, kobs, dim=-1)
    pn_norm = torch.linalg.vector_norm(pn, dim=-1, keepdim=True)
    ok = pn_norm[..., 0] > 1e-12
    pn = torch.where(ok[..., None], pn / torch.clamp_min(pn_norm, 1e-30),
                     normal)
    cosphi = torch.clamp(torch.sum(normal * pn, dim=-1), -1.0, 1.0)
    sinphi = torch.sum(torch.cross(normal, pn, dim=-1) * k, dim=-1)
    phi = torch.atan2(sinphi, cosphi)
    return torch.where(ok, phi, torch.zeros_like(phi)), pn


def mueller_at(tabs: MuellerTables, h: torch.Tensor, costheta: torch.Tensor):
    """(S11, S12, S33, S34) at cos(theta), linear in theta, for component
    h (B,)."""
    th = torch.arccos(torch.clamp(costheta, -1.0, 1.0))
    tgrid = tabs.theta
    i = torch.clamp(sampling.searchsorted_right(tgrid, th) - 1, 0,
                    tgrid.shape[0] - 2)
    t0, t1 = tgrid[i], tgrid[i + 1]
    f = torch.where(t1 > t0, (th - t0) / torch.clamp_min(t1 - t0, 1e-30),
                    torch.zeros_like(th))

    def interp(tab):
        v0 = tab[h, i]
        return v0 + f * (tab[h, i + 1] - v0)

    return interp(tabs.S11), interp(tabs.S12), interp(tabs.S33), \
        interp(tabs.S34)


def sample_costheta(tabs: MuellerTables, h: torch.Tensor,
                    u: torch.Tensor) -> torch.Tensor:
    """cos(theta) from the S11-weighted marginal of component h: li is the
    count of cdf entries below u (searchsorted, left)."""
    H, T = tabs.ct_cdf.shape
    u = u.contiguous()
    li = torch.searchsorted(tabs.ct_cdf[0], u)
    for c in range(1, H):
        li = torch.where(h == c, torch.searchsorted(tabs.ct_cdf[c], u), li)
    li = torch.clamp(li, 1, T - 1)
    c0, c1 = tabs.ct_cdf[h, li - 1], tabs.ct_cdf[h, li]
    f = torch.where(c1 > c0, (u - c0) / torch.clamp_min(c1 - c0, 1e-30),
                    torch.full_like(u, 0.5))
    x0, x1 = tabs.ct_grid[li - 1], tabs.ct_grid[li]
    return torch.clamp(x0 + f * (x1 - x0), -1.0, 1.0)


def sample_azimuth(S11, S12, stokes: torch.Tensor, u: torch.Tensor,
                   newton_iters: int = 6) -> torch.Tensor:
    """The scattering azimuth from p(phi) ~ 1 + PL cos 2(phi - phi0), with
    PL = -S12/S11 sqrt(Q^2 + U^2)/I and phi0 = atan2(U, Q)/2: its cdf
    phi/2pi + (PL/4pi)[sin 2(phi - phi0) + sin 2phi0] inverted by a fixed
    number of Newton steps from 2 pi u."""
    I, Q, U = stokes[..., 0], stokes[..., 1], stokes[..., 2]
    P = torch.sqrt(Q * Q + U * U) / torch.clamp_min(I, 1e-30)
    ratio = -S12 / torch.clamp_min(torch.abs(S11), 1e-30) * torch.sign(S11)
    PL = torch.clamp(ratio * P, -0.99, 0.99)
    phi0 = 0.5 * torch.atan2(U, Q)
    two_pi = 2 * math.pi
    phi = two_pi * u
    s0 = xm.sin(2 * phi0)
    for _ in range(newton_iters):
        s, c = xm.sincos(2 * (phi - phi0))
        F = (phi + 0.5 * PL * (s + s0)) / two_pi - u
        dF = (1 + PL * c) / two_pi
        phi = phi - F / torch.clamp_min(dF, 1e-4)
    return torch.remainder(phi, two_pi)


def phase_value(S11, S12, stokes: torch.Tensor, costheta: torch.Tensor,
                phi: torch.Tensor, norm: torch.Tensor) -> torch.Tensor:
    """Polarized phase-function value toward (theta, phi) in the packet
    frame, unit integral over the sphere:
    [S11 I + S12 (Q cos2phi + U sin2phi)] / (2 pi N I)."""
    I, Q, U = stokes[..., 0], stokes[..., 1], stokes[..., 2]
    s2, c2 = xm.sincos(2 * phi)
    val = S11 * I + S12 * (Q * c2 + U * s2)
    return val / torch.clamp_min(2 * math.pi * norm
                                 * torch.clamp_min(I, 1e-30), 1e-30)


def s11_norm(tabs: MuellerTables) -> torch.Tensor:
    """The integral of S11 over cos(theta), per component (H,)."""
    ct = tabs.ct_grid
    w = torch.flip(tabs.S11, dims=(1,))
    return torch.sum(0.5 * (w[:, 1:] + w[:, :-1]) * torch.diff(ct)[None, :],
                     dim=1)
