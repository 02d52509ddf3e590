"""Analytic geometries: normalised density profiles and position sampling.

Port of `skirt9_tpu/geometries/analytic.py`: every profile of the
reference, each with its host-side `density_np` (unit total mass) and
`sample(keys, tag)`, which draws (B, 3) positions from the per-packet
keys. The cdf tables are built once in float64 numpy, as in the
reference, and kept per device as f32 tensors, so that a launch copies
nothing from the host after its first.

The samplers follow the reference's f32 operations as XLA runs them
inside the reference's jitted launch (`ops.xlamath`): a product that feeds
a sum is one fused multiply-add, a division by a constant a product with
its f32 reciprocal, log1p XLA's own. So a position lands where the
reference's does but where XLA's sine or cosine is off by an ulp.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops import rng, sampling
from ..ops import xlamath as xm

_TWO_PI = xm.f32(2.0 * math.pi)


class Geometry:
    """Base: subclasses implement density_np and sample."""

    def density_np(self, pos: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def sample(self, keys: torch.Tensor,
               tag: int = rng.LAUNCH_POSITION) -> torch.Tensor:
        """(B, 3) f32 positions from the per-packet keys (B, 2)."""
        a, b = self.terms(keys, tag)
        return a if b is None else a * b

    def terms(self, keys: torch.Tensor, tag: int = rng.LAUNCH_POSITION):
        """The positions as the factors (a, b) of their last product,
        position = a * b rounded, or (positions, None) where the last
        operation is no product. XLA fuses that product into a sum that
        a decorator adds (an offset): `decorators.OffsetDecorator` forms
        it as one fused multiply-add."""
        raise NotImplementedError

    def _dev(self, name: str, build, device) -> torch.Tensor:
        """The f32 tensor `build()` (a numpy array) on `device`, built once
        per device and kept on the (frozen) geometry."""
        cache = self.__dict__.get("_dev_cache")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_dev_cache", cache)
        key = (name, str(device))
        if key not in cache:
            cache[key] = torch.tensor(np.asarray(build(), np.float32),
                                      device=device)
        return cache[key]


def _radial_cdf_tables(rho_of_r, rmax: float, n: int = 4096):
    """Host-built cdf of 4 pi r^2 rho(r) for spherical profiles: (r, cdf)
    in float64 and the integral."""
    r = np.linspace(0.0, rmax, n)
    w = 4 * np.pi * r ** 2 * rho_of_r(np.maximum(r, rmax * 1e-9))
    cdf, total = sampling.cdf_linlin(r, w)
    return r, cdf, total


def sample_cdf_linlin(u, xv, cdf):
    """`sampling.sample_cdf_linlin` with its last product fused into the
    sum, as XLA forms it in the reference's jitted launch."""
    i = sampling.locate_clip(cdf, u)
    x0 = xv[i]
    return xm.fma(sampling._cdf_frac(u, cdf, i), xv[i + 1] - x0, x0)


def polar(R, phi, z, z_factor=None):
    """(R cos phi, R sin phi, z) as the terms (a, b) of a product: (B, 3)
    each, z the product z * z_factor where that is given."""
    one = torch.ones_like(R)
    return (torch.stack([R, R, z], dim=-1),
            torch.stack([xm.cos(phi), xm.sin(phi),
                         one if z_factor is None else z_factor], dim=-1))


@dataclasses.dataclass(frozen=True)
class SphericalProfileGeometry(Geometry):
    """Generic spherical geometry from a radial profile rho(r) with unit
    total mass."""

    rmax: float

    def rho(self, r: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def density_np(self, pos: np.ndarray) -> np.ndarray:
        r = np.linalg.norm(np.asarray(pos, np.float64), axis=-1)
        out = self.rho(np.maximum(r, self.rmax * 1e-12))
        return np.where(r <= self.rmax, out, 0.0)

    def _tables(self):
        t = self.__dict__.get("_host_tables")
        if t is None:
            t = _radial_cdf_tables(self.rho, self.rmax)
            object.__setattr__(self, "_host_tables", t)
        return t

    def terms(self, keys, tag: int = rng.LAUNCH_POSITION):
        dev = keys.device
        rv = self._dev("r", lambda: self._tables()[0], dev)
        cdf = self._dev("cdf", lambda: self._tables()[1], dev)
        r = sample_cdf_linlin(rng.uniform(keys, tag), rv, cdf)
        d = rng.isotropic_direction(keys, tag + 50)
        return r[:, None].expand_as(d), d


@dataclasses.dataclass(frozen=True)
class PlummerGeometry(SphericalProfileGeometry):
    """rho(r) = 3/(4 pi b^3) (1+r^2/b^2)^-5/2 (ref: PlummerGeometry)."""

    b: float = 1.0
    rmax: float = 0.0

    def __post_init__(self):
        if self.rmax == 0.0:
            object.__setattr__(self, "rmax", 20.0 * self.b)

    def rho(self, r):
        return 3.0 / (4 * np.pi * self.b ** 3) * (1 + (r / self.b) ** 2) ** -2.5


@dataclasses.dataclass(frozen=True)
class GammaGeometry(SphericalProfileGeometry):
    """Dehnen/gamma profile rho ~ (r/b)^-gamma (1+r/b)^(gamma-4)
    (ref: GammaGeometry)."""

    b: float = 1.0
    gamma: float = 1.0
    rmax: float = 0.0

    def __post_init__(self):
        if self.rmax == 0.0:
            object.__setattr__(self, "rmax", 50.0 * self.b)

    def rho(self, r):
        x = r / self.b
        norm = (3.0 - self.gamma) / (4 * np.pi * self.b ** 3)
        return norm * x ** -self.gamma * (1 + x) ** (self.gamma - 4.0)


@dataclasses.dataclass(frozen=True)
class ShellGeometry(SphericalProfileGeometry):
    """Power-law shell rho ~ r^-p for rmin < r < rmax (ref: ShellGeometry);
    the geometry of the Ivezic benchmark problem."""

    rmin: float = 0.5
    rmax: float = 1.0
    p: float = 0.0

    def rho(self, r):
        if abs(self.p - 3.0) > 1e-12:
            integral = 4 * np.pi * (self.rmax ** (3 - self.p)
                                    - self.rmin ** (3 - self.p)) / (3 - self.p)
        else:
            integral = 4 * np.pi * np.log(self.rmax / self.rmin)
        out = np.where((r >= self.rmin) & (r <= self.rmax), r ** -self.p, 0.0)
        return out / integral


@dataclasses.dataclass(frozen=True)
class UniformSphereGeometry(SphericalProfileGeometry):
    """Constant density inside rmax."""

    rmax: float = 1.0

    def rho(self, r):
        v = 4.0 / 3.0 * np.pi * self.rmax ** 3
        return np.where(r <= self.rmax, 1.0 / v, 0.0)


@dataclasses.dataclass(frozen=True)
class GaussianGeometry(SphericalProfileGeometry):
    """Spherical Gaussian with dispersion sigma (ref: GaussianGeometry)."""

    sigma: float = 1.0
    rmax: float = 0.0

    def __post_init__(self):
        if self.rmax == 0.0:
            object.__setattr__(self, "rmax", 8.0 * self.sigma)

    def rho(self, r):
        s = self.sigma
        return (2 * np.pi * s ** 2) ** -1.5 * np.exp(-(r ** 2) / (2 * s ** 2))


# the inverse cdf table of x e^-x, the radial profile of an exponential disk
_EXPDISK_X = np.linspace(0, 30, 4096)


@dataclasses.dataclass(frozen=True)
class ExpDiskGeometry(Geometry):
    """Double-exponential disk rho ~ exp(-R/hR) exp(-|z|/hz)
    (ref: ExpDiskGeometry); the inner and outer truncations are ignored,
    as in the reference."""

    h_r: float = 1.0
    h_z: float = 0.2

    def density_np(self, pos: np.ndarray) -> np.ndarray:
        pos = np.asarray(pos, np.float64)
        R = np.hypot(pos[..., 0], pos[..., 1])
        z = np.abs(pos[..., 2])
        norm = 1.0 / (4 * np.pi * self.h_r ** 2 * self.h_z)
        return norm * np.exp(-R / self.h_r - z / self.h_z)

    def terms(self, keys, tag: int = rng.LAUNCH_POSITION):
        dev = keys.device
        x = self._dev("x", lambda: _EXPDISK_X, dev)
        cdf = self._dev("cdf", lambda: sampling.cdf_linlin(
            _EXPDISK_X, _EXPDISK_X * np.exp(-_EXPDISK_X))[0], dev)
        R = xm.f32(self.h_r) * sample_cdf_linlin(rng.uniform(keys, tag), x,
                                                 cdf)
        u2, u3 = rng.uniform2(keys, tag + 50)
        # z: the Laplace inverse cdf, (-h_z sign(u3 - 1/2)) log1p(-2|u3 - 1/2|)
        d = u3 - 0.5
        return polar(R, _TWO_PI * u2, xm.f32(-self.h_z) * torch.sign(d),
                     xm.log1p_xla(-2.0 * torch.abs(d)))


@dataclasses.dataclass(frozen=True)
class SersicGeometry(SphericalProfileGeometry):
    """Spherical Sersic profile of index m via the Prugniel-Simien
    approximation of the deprojected density (ref: SersicGeometry,
    SKIRT/utils/SersicFunction)."""

    reff: float = 1.0
    m: float = 4.0
    rmax: float = 0.0

    def __post_init__(self):
        if self.rmax == 0.0:
            object.__setattr__(self, "rmax", 40.0 * self.reff)

    def rho(self, r):
        m = self.m
        b = 2 * m - 1.0 / 3.0 + 4.0 / (405 * m) + 46.0 / (25515 * m ** 2)
        p = 1.0 - 0.6097 / m + 0.05463 / m ** 2
        x = np.maximum(r / self.reff, 1e-12)
        rho = x ** -p * np.exp(-b * x ** (1.0 / m))
        rr = np.geomspace(1e-6, self.rmax / self.reff, 2048)
        w = 4 * np.pi * rr ** 2 * rr ** -p * np.exp(-b * rr ** (1.0 / m))
        norm = np.trapezoid(w, rr) * self.reff ** 3
        return rho / norm


@dataclasses.dataclass(frozen=True)
class PointGeometry(Geometry):
    """Delta function at the origin (sources only)."""

    def density_np(self, pos):
        return np.zeros(np.asarray(pos).shape[:-1])

    def terms(self, keys, tag: int = rng.LAUNCH_POSITION):
        return torch.zeros((keys.shape[0], 3), dtype=torch.float32,
                           device=keys.device), None


@dataclasses.dataclass(frozen=True)
class EinastoGeometry(SphericalProfileGeometry):
    """Einasto profile rho ~ exp(-2n ((r/rs)^(1/n) - 1))
    (ref: SKIRT/core/EinastoGeometry.hpp)."""

    rs: float = 1.0
    n: float = 5.0
    rmax: float = 0.0

    def __post_init__(self):
        if self.rmax == 0.0:
            object.__setattr__(self, "rmax", 30.0 * self.rs)

    def rho(self, r):
        x = np.maximum(r / self.rs, 1e-12)
        raw = np.exp(-2 * self.n * (x ** (1.0 / self.n) - 1.0))
        rr = np.geomspace(1e-6, self.rmax / self.rs, 2048)
        w = 4 * np.pi * rr ** 2 * np.exp(-2 * self.n
                                         * (rr ** (1.0 / self.n) - 1.0))
        norm = np.trapezoid(w, rr) * self.rs ** 3
        return raw / norm


@dataclasses.dataclass(frozen=True)
class PseudoSersicGeometry(SphericalProfileGeometry):
    """Pseudo-Sersic (Prugniel-Simien 1997) spherical profile
    (ref: SKIRT/core/PseudoSersicGeometry.hpp)."""

    reff: float = 1.0
    m: float = 4.0
    rmax: float = 0.0

    def __post_init__(self):
        if self.rmax == 0.0:
            object.__setattr__(self, "rmax", 40.0 * self.reff)

    def rho(self, r):
        m = self.m
        bn = 2 * m - 1.0 / 3.0 + 4.0 / (405 * m) + 46.0 / (25515 * m ** 2)
        pn = 1.0 - 0.6097 / m + 0.05463 / m ** 2
        x = np.maximum(r / self.reff, 1e-12)
        raw = x ** -pn * np.exp(-bn * x ** (1.0 / m))
        rr = np.geomspace(1e-6, self.rmax / self.reff, 2048)
        w = 4 * np.pi * rr ** 2 * rr ** -pn * np.exp(-bn * rr ** (1.0 / m))
        norm = np.trapezoid(w, rr) * self.reff ** 3
        return raw / norm


@dataclasses.dataclass(frozen=True)
class UniformBoxGeometry(Geometry):
    """Constant density inside an axis-aligned box
    (ref: SKIRT/core/UniformBoxGeometry.hpp)."""

    lx: float = 1.0
    ly: float = 1.0
    lz: float = 1.0
    cx: float = 0.0
    cy: float = 0.0
    cz: float = 0.0

    def density_np(self, pos):
        pos = np.asarray(pos, np.float64)
        c = np.array([self.cx, self.cy, self.cz])
        half = 0.5 * np.array([self.lx, self.ly, self.lz])
        inside = np.all(np.abs(pos - c) <= half, axis=-1)
        return np.where(inside, 1.0 / (self.lx * self.ly * self.lz), 0.0)

    def terms(self, keys, tag: int = rng.LAUNCH_POSITION):
        dev = keys.device
        u1, u2 = rng.uniform2(keys, tag)
        u3 = rng.uniform(keys, tag + 50)
        c = self._dev("c", lambda: [self.cx, self.cy, self.cz], dev)
        side = self._dev("l", lambda: [self.lx, self.ly, self.lz], dev)
        u = torch.stack([u1, u2, u3], dim=-1)
        return xm.fma(u - 0.5, side, c), None


@dataclasses.dataclass(frozen=True)
class MultiGaussianExpansionGeometry(Geometry):
    """Sum of co-axial Gaussian components with weights, dispersions and a
    common flattening per component (ref:
    SKIRT/core/MultiGaussianExpansionGeometry.hpp); components is a tuple
    of (weight, sigma, q) with q the z-axis flattening."""

    components: tuple = ((1.0, 1.0, 1.0),)

    def density_np(self, pos):
        pos = np.asarray(pos, np.float64)
        R2 = pos[..., 0] ** 2 + pos[..., 1] ** 2
        z = pos[..., 2]
        wtot = sum(w for w, _, _ in self.components)
        out = np.zeros(pos.shape[:-1])
        for w, s, q in self.components:
            norm = w / wtot / ((2 * np.pi) ** 1.5 * s ** 3 * q)
            out = out + norm * np.exp(-(R2 + (z / q) ** 2) / (2 * s ** 2))
        return out

    def terms(self, keys, tag: int = rng.LAUNCH_POSITION):
        dev = keys.device
        comps = self.components
        ws = np.array([w for w, _, _ in comps], np.float64)
        cdf = self._dev("cdf", lambda: np.cumsum(ws) / ws.sum(), dev)
        sig = self._dev("sig", lambda: [s for _, s, _ in comps], dev)
        qs = self._dev("q", lambda: [q for _, _, q in comps], dev)
        u = rng.uniform(keys, tag)
        k = torch.clamp(torch.searchsorted(cdf, u.contiguous()), 0,
                        len(comps) - 1)
        g = torch.stack([rng.gauss(keys, tag + 50 + i) for i in range(3)],
                        dim=-1)
        s = sig[k]
        return g, torch.stack([s, s, s * qs[k]], dim=-1)
