"""Henyey-Greenstein and dipole phase functions and direction rotation.

Port of `skirt9_tpu/ops/phase.py:16-76`: batched, branch-free functions on
(B,) and (B, 3) tensors.
"""

from __future__ import annotations

import math

import torch

from . import xlamath as xm

_ISO = 1.0 / (4.0 * math.pi)


def hg_phase(g: torch.Tensor, costheta: torch.Tensor) -> torch.Tensor:
    """HG phase function normalised to 1 over 4 pi sr."""
    t = 1.0 + g * g - 2.0 * g * costheta
    return _ISO * (1.0 - g * g) / torch.clamp_min(t * torch.sqrt(t), 1e-30)


def hg_sample_costheta(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-cdf sample of cos(theta) from HG; isotropic for |g| < 1e-5.
    The fusions of the reference's life cycle (XLA's vectorised loop):
    1 - g^2, 1 - g + 2g u, 1 + g^2 and 1 + g^2 - f^2 each one fused
    multiply-add, rounded once (`xlamath.fma_rn`)."""
    fma = xm.fma_rn
    near_iso = torch.abs(g) < 1e-5
    gs = torch.where(near_iso, torch.full_like(g, 0.5), g)
    f = fma(-gs, gs, 1.0) / fma(2.0 * gs, u, 1.0 - gs)
    ct_aniso = fma(-f, f, fma(gs, gs, 1.0)) / (2.0 * gs)
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
                     phi: torch.Tensor, fma=xm.fma,
                     tail: int = 0) -> torch.Tensor:
    """New direction at polar angle (costheta, phi) about axis k (B, 3),
    through a branch-free orthonormal frame, renormalised, with the fused
    multiply-adds of the reference's life cycle (its vectorised loop over
    the (B, 3) components): 1 + s kx^2 a, s + ky^2 a, cos(phi) e1 +
    sin(phi) e2 (the first product fused), then x and y sint (...) +
    costheta k with the first product fused and z with the second, and
    |out|^2 summed in x, y, z order; glibc's cosf and sinf of phi
    (`xlamath.sincos`); each fused multiply-add by `fma`. XLA's scalar
    loop over the last `tail` lanes of the array fuses all three z's way
    (`hg_scatter`)."""
    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    sign = torch.where(kz >= 0.0, torch.ones_like(kz), -torch.ones_like(kz))
    a = xm.rdiv(-1.0, sign + kz)
    b = kx * ky * a
    e1 = torch.stack([fma(sign * kx * kx, a, 1.0), sign * b, -sign * kx],
                     dim=-1)
    e2 = torch.stack([b, fma(ky * ky, a, sign), -ky], dim=-1)
    sint = xm.sqrt(torch.clamp_min(fma(-costheta, costheta, 1.0), 0.0))
    sp, cp = xm.sincos(phi)
    inner = fma(cp[..., None], e1, sp[..., None] * e2)
    ct, st = costheta[..., None], sint[..., None]
    out = torch.cat([fma(st, inner[..., :2], ct * k[..., :2]),
                     fma(ct, k[..., 2:], st * inner[..., 2:])], dim=-1)
    if tail:
        out[-tail:] = fma(ct[-tail:], k[-tail:], st[-tail:] * inner[-tail:])
    ox, oy, oz = out[..., 0], out[..., 1], out[..., 2]
    n2 = fma(oz, oz, fma(oy, oy, ox * ox))
    return out / xm.sqrt(n2)[..., None]


# the lanes at the end of an array whose rotation XLA's scalar loop fuses
# its other way (csrc/sincos.cu kHgTail)
HG_TAIL = 8


def hg_scatter(k: torch.Tensor, g: torch.Tensor, u_ct: torch.Tensor,
               u_phi: torch.Tensor) -> torch.Tensor:
    """The Henyey-Greenstein scattering direction of each lane about its
    direction k (B, 3), from asymmetry g and two uniforms (B,), as the
    reference's jitted life cycle forms it: on a CUDA tensor one launch of
    `csrc/sincos.cu`'s hg_direction kernel (counted as `hg_direction`), on
    a CPU tensor `hg_scatter_plain`, bit for bit the same."""
    if k.device.type == "cpu":
        return hg_scatter_plain(k, g, u_ct, u_phi)
    if k.device.type != "cuda":
        raise ValueError(f"no hg_direction kernel for device {k.device}")
    from ..kernels import build as kb
    f32 = lambda t: t.to(torch.float32).contiguous()
    k, g, u_ct, u_phi = f32(k), f32(g), f32(u_ct), f32(u_phi)
    out = torch.empty_like(k)
    kb.launch("hg_direction", k.data_ptr(), g.data_ptr(), u_ct.data_ptr(),
              u_phi.data_ptr(), out.data_ptr(), k.shape[0], kb.stream_of(k))
    return out


def hg_scatter_plain(k, g, u_ct, u_phi) -> torch.Tensor:
    """`hg_scatter` in PyTorch operations: cos(theta) by the inverse cdf,
    the azimuth 2 pi u, the rotation about k, each fused multiply-add
    rounded once (`xlamath.fma_rn`, as XLA's and the kernel's are), the
    last HG_TAIL lanes rotated as XLA's scalar loop fuses them."""
    ct = hg_sample_costheta(g, u_ct)
    phi = xm.f32(2.0 * math.pi) * u_phi
    return rotate_direction(k, ct, phi, fma=xm.fma_rn, tail=HG_TAIL)
