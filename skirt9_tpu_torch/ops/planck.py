"""Planck function and integrals (tensor and host variants).

Port of `skirt9_tpu/ops/planck.py`: `b_lambda` on tensors (the equilibrium
emission spectra), `b_lambda_np` in float64 numpy (SED and emission tables
at set-up), and `integrated_b`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import constants as c

_C1 = 2.0 * c.H_PLANCK * c.C_LIGHT**2          # 2hc^2
_C2 = c.H_PLANCK * c.C_LIGHT / c.K_BOLTZMANN   # hc/k
SIGMA_SB = 5.670374419e-8                      # Stefan-Boltzmann [W/m2/K4]


def b_lambda(lam: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Planck spectral radiance B_lambda(T) [W / m^2 / m / sr], broadcast
    over lam and T; exponents past 700 give exactly 0.

    Rounds as XLA does: `scalar / tensor` in PyTorch multiplies by a
    reciprocal (one rounding more), so the constants divide as tensors, and
    lam^5 is XLA's integer power lam * ((lam lam)(lam lam))."""
    const = lambda v: torch.tensor(v, dtype=lam.dtype, device=lam.device)
    x = const(_C2) / (lam * T)
    xs = torch.clamp_max(x, 700.0)
    l2 = lam * lam
    return const(_C1) / ((lam * (l2 * l2)) * torch.expm1(xs)) * torch.where(
        x > 700.0, torch.zeros_like(x), torch.ones_like(x))


def b_lambda_np(lam, T):
    lam = np.asarray(lam, np.float64)
    T = np.asarray(T, np.float64)
    x = _C2 / (lam * T)
    out = np.zeros(np.broadcast_shapes(lam.shape, T.shape))
    ok = x < 700
    out[ok] = (_C1 / lam**5 / np.expm1(np.minimum(x, 700.0)))[ok]
    return out


def integrated_b(T):
    """Bolometric integral of pi*B over wavelength = sigma T^4 [W/m^2]."""
    return SIGMA_SB * T**4 / np.pi
