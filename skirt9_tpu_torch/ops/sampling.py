"""Table lookups and cdf sampling: host cdf builds, batched inversion.

Port of `skirt9_tpu/ops/sampling.py`, with `interp_jnp`, the counterpart
of `jnp.interp` and its edge clamping that the spiral decorator calls. The cdf builds run once at set-up in
float64 numpy, as in the reference; the lookups and inversions run on
tensors. The reference's dense compare-reduce lookups are TPU gather
workarounds; here they are `torch.searchsorted` and plain indexing, which
give the same indices and values. With `xla=True` the interpolations
evaluate as XLA does on the CPU (its log and exp, each product fused into
the sum it feeds: `ops.xlamath`), bit for bit with the reference there,
and the same bits on any device; the launch samplers take that form, where
an ulp of a logarithm moves a narrow line's wavelength by 1e-6 of itself.
"""

from __future__ import annotations

import numpy as np
import torch

from . import xlamath as xm

_TINY = torch.finfo(torch.float32).tiny


# ---------------------------------------------------------------- host (setup)

def cdf_linlin(xv, pv) -> tuple[np.ndarray, float]:
    """Normalised cdf of a piecewise-linear density p(x) on grid xv, and
    its normalisation integral."""
    xv = np.asarray(xv, dtype=np.float64)
    pv = np.asarray(pv, dtype=np.float64)
    seg = 0.5 * (pv[1:] + pv[:-1]) * np.diff(xv)
    cdf = np.concatenate([[0.0], np.cumsum(seg)])
    total = cdf[-1]
    if total <= 0:
        raise ValueError("cannot build cdf of non-positive density")
    return cdf / total, total


def cdf_loglog(xv, pv) -> tuple[np.ndarray, float]:
    """cdf of a density that is a power law between grid points, and its
    normalisation integral."""
    xv = np.asarray(xv, dtype=np.float64)
    pv = np.asarray(pv, dtype=np.float64).copy()
    pv = np.maximum(pv, np.finfo(np.float64).tiny)
    alpha = np.log(pv[1:] / pv[:-1]) / np.log(xv[1:] / xv[:-1])
    # integral of p0*(x/x0)^alpha dx over [x0,x1]
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        seg = np.where(
            np.abs(alpha + 1.0) > 1e-6,
            pv[:-1] * xv[:-1] / (alpha + 1.0)
            * ((xv[1:] / xv[:-1]) ** (alpha + 1.0) - 1.0),
            pv[:-1] * xv[:-1] * np.log(xv[1:] / xv[:-1]),
        )
    cdf = np.concatenate([[0.0], np.cumsum(seg)])
    total = cdf[-1]
    return cdf / total, total


# ---------------------------------------------------- tensors (hot path)

def searchsorted_right(tab: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Number of table entries <= x (searchsorted side='right'), int64."""
    return torch.searchsorted(tab, x.contiguous(), right=True)


def locate_clip(xv: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Index i with xv[i] <= x < xv[i+1], clipped to [0, N-2]."""
    return torch.clamp(searchsorted_right(xv, x) - 1, 0, xv.shape[0] - 2)


def interp_linlin(x: torch.Tensor, xv: torch.Tensor, yv: torch.Tensor,
                  xla: bool = False):
    """Batched linear interpolation with edge clamping."""
    i = locate_clip(xv, x)
    x0, x1 = xv[i], xv[i + 1]
    y0, y1 = yv[i], yv[i + 1]
    t = torch.clamp((x - x0) / torch.clamp_min(x1 - x0, _TINY), 0.0, 1.0)
    return xm.fma(t, y1 - y0, y0) if xla else y0 + t * (y1 - y0)


def interp_loglog(x: torch.Tensor, xv: torch.Tensor, yv: torch.Tensor,
                  xla: bool = False):
    """Batched log-log (power-law) interpolation, clamped; values from the
    tiny-clamped floor come back as exact zeros."""
    log, exp = (xm.log_xla, xm.exp_xla) if xla else (torch.log, torch.exp)
    out = exp(interp_linlin(log(x), log(xv),
                            log(torch.clamp_min(yv, _TINY)), xla=xla))
    return torch.where(out < 1e-35, torch.zeros_like(out), out)


def _cdf_frac(u, cdf, i):
    c0, c1 = cdf[i], cdf[i + 1]
    return torch.where(c1 > c0, (u - c0) / torch.clamp_min(c1 - c0, 1e-30),
                       torch.zeros_like(u))


def sample_cdf_linlin(u: torch.Tensor, xv: torch.Tensor,
                      cdf: torch.Tensor) -> torch.Tensor:
    """Invert a tabulated cdf, linear in x within bins; u in (0, 1)."""
    i = locate_clip(cdf, u)
    x0 = xv[i]
    return x0 + _cdf_frac(u, cdf, i) * (xv[i + 1] - x0)


def sample_cdf_loglog(u: torch.Tensor, xv: torch.Tensor,
                      cdf: torch.Tensor, xla: bool = False) -> torch.Tensor:
    """Invert a tabulated cdf, linear in log x within bins."""
    i = locate_clip(cdf, u)
    if xla:
        lx0, lx1 = xm.log_xla(xv[i]), xm.log_xla(xv[i + 1])
        return xm.exp_xla(xm.fma(_cdf_frac(u, cdf, i), lx1 - lx0, lx0))
    lx0 = torch.log(xv[i])
    lx1 = torch.log(xv[i + 1])
    return torch.exp(lx0 + _cdf_frac(u, cdf, i) * (lx1 - lx0))


def interp_jnp(x: torch.Tensor, xp: torch.Tensor,
               fp: torch.Tensor) -> torch.Tensor:
    """`jnp.interp(x, xp, fp)`: linear between the table's points, clamped
    to fp[0] below xp[0] and fp[-1] above xp[-1], with jax's operations
    (the slope's product fused into the sum)."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    n - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1], xm.fma(
        delta / torch.where(dx0, torch.ones_like(dx), dx), df, fp[i - 1]))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)
