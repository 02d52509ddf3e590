"""Henyey-Greenstein and dipole phase functions and direction rotation.

Port of `skirt9_tpu/ops/phase.py:16-76`: batched, branch-free functions on
(B,) and (B, 3) tensors.
"""

from __future__ import annotations

import math

import torch

_ISO = 1.0 / (4.0 * math.pi)


def hg_phase(g: torch.Tensor, costheta: torch.Tensor) -> torch.Tensor:
    """HG phase function normalised to 1 over 4 pi sr."""
    t = 1.0 + g * g - 2.0 * g * costheta
    return _ISO * (1.0 - g * g) / torch.clamp_min(t * torch.sqrt(t), 1e-30)


def hg_sample_costheta(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-cdf sample of cos(theta) from HG; isotropic for |g| < 1e-5."""
    near_iso = torch.abs(g) < 1e-5
    gs = torch.where(near_iso, torch.full_like(g, 0.5), g)
    f = (1.0 - gs * gs) / (1.0 - gs + 2.0 * gs * u)
    ct_aniso = (1.0 + gs * gs - f * f) / (2.0 * gs)
    ct_iso = 2.0 * u - 1.0
    return torch.clamp(torch.where(near_iso, ct_iso, ct_aniso), -1.0, 1.0)


def dipole_phase(costheta: torch.Tensor) -> torch.Tensor:
    """The dipole (Rayleigh) phase function normalised over 4 pi sr:
    (3 / 16 pi)(1 + cos^2 theta)."""
    return 3.0 / (16.0 * math.pi) * (1.0 + costheta * costheta)


def dipole_sample_costheta(u: torch.Tensor) -> torch.Tensor:
    """Invert the dipole cdf: cos theta is the real root of mu^3 + 3 mu +
    (4 - 8 u) = 0, by Cardano's formula (cube roots through f64)."""
    p = 4.0 * u - 2.0
    d = torch.sqrt((1.0 + p * p).double()).float()
    cbrt = lambda v: (torch.sign(v.double())
                      * torch.abs(v.double()) ** (1.0 / 3.0)).float()
    return torch.clamp(cbrt(p + d) + cbrt(p - d), -1.0, 1.0)


def rotate_direction(k: torch.Tensor, costheta: torch.Tensor,
                     phi: torch.Tensor) -> torch.Tensor:
    """New direction at polar angle (costheta, phi) about axis k (B, 3),
    through a branch-free orthonormal frame, renormalised."""
    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    sign = torch.where(kz >= 0.0, torch.ones_like(kz), -torch.ones_like(kz))
    a = -1.0 / (sign + kz)
    b = kx * ky * a
    e1 = torch.stack([1.0 + sign * kx * kx * a, sign * b, -sign * kx], dim=-1)
    e2 = torch.stack([b, sign + ky * ky * a, -ky], dim=-1)
    sint = torch.sqrt(torch.clamp_min(1.0 - costheta * costheta, 0.0))
    cp = torch.cos(phi)
    sp = torch.sin(phi)
    out = (sint[..., None] * (cp[..., None] * e1 + sp[..., None] * e2)
           + costheta[..., None] * k)
    return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)
