"""Geometry decorators: offset, rotate, deform, clip, combine, clump, spiral
and redistribute any geometry.

Port of `skirt9_tpu/geometries/decorators.py`. Each decorator keeps the
Geometry contract (`density_np` on the host, `sample(keys, tag)` on the
keys' device) by transforming coordinates, so decorators nest as the
reference's do. The tags and retry keys are the reference's:
`LAUNCH_POSITION` + 50, 51, 76-78 and 88-91, `purpose_key(keys, 7000 + t)`
for a clip's retries and `7100 + t` for a redistribution's.

Where the reference works on the host:

- a clip rejects in numpy, redrawing only the failing lanes, up to 16
  rounds; here every round redraws the whole batch on the device and the
  lanes still failing take their new draw where it passes. A lane's retry
  depends on its own key only, so the result is the same, with no host
  round trip; a lane failing all 16 rounds keeps its first draw, as in the
  reference;
- the clip's and the redistribution's norms and the clumps' centres come
  from draws at construction under `jax.random.PRNGKey(seed)`, here
  `rng.seed_key(seed)`, which gives the same keys bit for bit; they are
  drawn on the CPU in float64 numpy, as the reference reads them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops import rng, sampling
from ..ops import xlamath as xm
from .analytic import Geometry, polar


def _rotation_matrix(alpha: float, beta: float, gamma: float) -> np.ndarray:
    """Z-Y-Z Euler rotation (ref: RotateGeometryDecorator convention)."""
    ca, sa = np.cos(alpha), np.sin(alpha)
    cb, sb = np.cos(beta), np.sin(beta)
    cg, sg = np.cos(gamma), np.sin(gamma)
    rz1 = np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]])
    ry = np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]])
    rz2 = np.array([[cg, -sg, 0], [sg, cg, 0], [0, 0, 1]])
    return rz1 @ ry @ rz2


def _host_sample(geometry, seed: int, n: int) -> np.ndarray:
    """n positions of a geometry under the keys of histories 0..n-1 of
    `jax.random.PRNGKey(seed)`, drawn on the CPU, as float64."""
    keys = rng.history_keys(rng.seed_key(seed, "cpu"), torch.arange(n))
    with xm.eager():   # the reference draws them op by op, unjitted
        return geometry.sample(keys).numpy().astype(np.float64)


@dataclasses.dataclass(frozen=True)
class OffsetDecorator(Geometry):
    """Translate a geometry (ref: OffsetGeometryDecorator)."""

    base: Geometry
    offset: tuple = (0.0, 0.0, 0.0)

    def density_np(self, pos):
        return self.base.density_np(np.asarray(pos) - np.asarray(self.offset))

    def terms(self, keys, tag: int = rng.LAUNCH_POSITION):
        off = self._dev("offset", lambda: self.offset, keys.device)
        a, b = self.base.terms(keys, tag)
        # the base's last product fused into the offset's sum
        return (a + off if b is None else xm.fma(a, b, off)), None


@dataclasses.dataclass(frozen=True)
class RotateDecorator(Geometry):
    """Rotate a geometry by Euler angles (ref: RotateGeometryDecorator)."""

    base: Geometry
    alpha: float = 0.0
    beta: float = 0.0
    gamma: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "_R",
                           _rotation_matrix(self.alpha, self.beta, self.gamma))

    def density_np(self, pos):
        return self.base.density_np(np.asarray(pos) @ self._R)

    def terms(self, keys, tag: int = rng.LAUNCH_POSITION):
        p = self.base.sample(keys, tag)
        rt = self._dev("RT", lambda: self._R.T, keys.device)
        x, y, z = p[:, 0:1], p[:, 1:2], p[:, 2:3]
        if xm.is_eager():
            # XLA's CPU dot of (B, 3) by (3, 3) on its own: each output
            # p0 r0 + p1 r1 + p2 r2 in order, the products rounded for the
            # first two columns and fused into the sum for the third
            xy = (x * rt[0] + y * rt[1]) + z * rt[2]
            out = xm.fma(z, rt[2], xm.fma(y, rt[1], x * rt[0]))
            return torch.cat([xy[:, :2], out[:, 2:]], dim=1), None
        # inside a jitted launch XLA turns the dot into elementwise
        # products and sums fused with the sampler: z r2 + (x r0 + y r1),
        # both outer products fused
        return xm.fma(z, rt[2], xm.fma(x, rt[0], y * rt[1])), None


@dataclasses.dataclass(frozen=True)
class SpheroidalDecorator(Geometry):
    """Flatten or stretch along z by a factor q: rho'(x, y, z) ~
    rho(x, y, z/q) (ref: SpheroidalGeometryDecorator)."""

    base: Geometry
    q: float = 1.0

    def density_np(self, pos):
        pos = np.asarray(pos, np.float64).copy()
        pos[..., 2] = pos[..., 2] / self.q
        return self.base.density_np(pos) / self.q

    def terms(self, keys, tag: int = rng.LAUNCH_POSITION):
        a, b = self.base.terms(keys, tag)
        if b is None:
            b = torch.ones_like(a)
        q = torch.tensor([1.0, 1.0, xm.f32(self.q)], device=a.device)
        # z becomes the product (z) * q, x and y keep their terms
        z = a[:, 2:] * b[:, 2:]
        return (torch.cat([a[:, :2], z], dim=1),
                torch.cat([b[:, :2], torch.ones_like(z)], dim=1) * q)


@dataclasses.dataclass(frozen=True)
class TriaxialDecorator(Geometry):
    """Independent y and z axis ratios (ref: TriaxialGeometryDecorator)."""

    base: Geometry
    p: float = 1.0
    q: float = 1.0

    def density_np(self, pos):
        pos = np.asarray(pos, np.float64).copy()
        pos[..., 1] = pos[..., 1] / self.p
        pos[..., 2] = pos[..., 2] / self.q
        return self.base.density_np(pos) / (self.p * self.q)

    def terms(self, keys, tag: int = rng.LAUNCH_POSITION):
        a, b = self.base.terms(keys, tag)
        if b is None:
            b = torch.ones_like(a)
        f = torch.tensor([1.0, xm.f32(self.p), xm.f32(self.q)],
                         device=a.device)
        # y and z become the products (y) * p and (z) * q
        yz = a[:, 1:] * b[:, 1:]
        return (torch.cat([a[:, :1], yz], dim=1),
                torch.cat([b[:, :1], torch.ones_like(yz)], dim=1) * f)


@dataclasses.dataclass(frozen=True)
class ClipDecorator(Geometry):
    """Remove (or keep only) the region of `inside_np` (ref:
    ClipGeometryDecorator with remove=Inside/Outside); the density is
    renormalised to unit mass by a factor estimated from base samples."""

    base: Geometry
    remove_inside: bool = True
    mc_samples: int = 20000

    def inside_np(self, pos) -> np.ndarray:
        raise NotImplementedError

    def inside(self, pos: torch.Tensor) -> torch.Tensor:
        """`inside_np` on an f64 tensor, on its device."""
        raise NotImplementedError

    def __post_init__(self):
        inside = self.inside_np(_host_sample(self.base, 1234,
                                             self.mc_samples))
        keep = ~inside if self.remove_inside else inside
        object.__setattr__(self, "_norm", 1.0 / max(float(keep.mean()), 1e-8))

    def density_np(self, pos):
        rho = self.base.density_np(pos)
        inside = self.inside_np(np.asarray(pos))
        keep = ~inside if self.remove_inside else inside
        return np.where(keep, rho * self._norm, 0.0)

    def _keep(self, p: torch.Tensor) -> torch.Tensor:
        inside = self.inside(p.double())
        return ~inside if self.remove_inside else inside

    def terms(self, keys, tag: int = rng.LAUNCH_POSITION):
        pts = self.base.sample(keys, tag)
        bad = ~self._keep(pts)
        for t in range(16):
            newp = self.base.sample(rng.purpose_key(keys, 7000 + t), tag)
            take = bad & self._keep(newp)
            pts = torch.where(take[:, None], newp, pts)
            bad = bad & ~take
        return pts, None


@dataclasses.dataclass(frozen=True)
class SphereClipDecorator(ClipDecorator):
    """(ref: SphericalClipGeometryDecorator)"""

    center: tuple = (0.0, 0.0, 0.0)
    radius: float = 1.0

    def inside_np(self, pos):
        r = np.linalg.norm(np.asarray(pos) - np.asarray(self.center), axis=-1)
        return r < self.radius

    def inside(self, pos):
        c = torch.tensor(self.center, dtype=torch.float64, device=pos.device)
        return torch.linalg.vector_norm(pos - c, dim=-1) < self.radius


@dataclasses.dataclass(frozen=True)
class BoxClipDecorator(ClipDecorator):
    """(ref: BoxClipGeometryDecorator)"""

    lo: tuple = (-1.0, -1.0, -1.0)
    hi: tuple = (1.0, 1.0, 1.0)

    def inside_np(self, pos):
        pos = np.asarray(pos)
        return np.all((pos >= np.asarray(self.lo))
                      & (pos <= np.asarray(self.hi)), axis=-1)

    def inside(self, pos):
        lo = torch.tensor(self.lo, dtype=torch.float64, device=pos.device)
        hi = torch.tensor(self.hi, dtype=torch.float64, device=pos.device)
        return torch.all((pos >= lo) & (pos <= hi), dim=-1)


@dataclasses.dataclass(frozen=True)
class CylinderClipDecorator(ClipDecorator):
    """(ref: CylindricalClipGeometryDecorator)"""

    radius: float = 1.0
    zmin: float = -1e300
    zmax: float = 1e300

    def inside_np(self, pos):
        pos = np.asarray(pos)
        R = np.hypot(pos[..., 0], pos[..., 1])
        return (R < self.radius) & (pos[..., 2] > self.zmin) \
            & (pos[..., 2] < self.zmax)

    def inside(self, pos):
        R = torch.hypot(pos[:, 0], pos[:, 1])
        return (R < self.radius) & (pos[:, 2] > self.zmin) \
            & (pos[:, 2] < self.zmax)


@dataclasses.dataclass(frozen=True)
class CombineDecorator(Geometry):
    """Weighted sum of two geometries (ref: CombineGeometryDecorator)."""

    first: Geometry
    second: Geometry
    w1: float = 1.0
    w2: float = 1.0

    def density_np(self, pos):
        wtot = self.w1 + self.w2
        return (self.w1 * self.first.density_np(pos)
                + self.w2 * self.second.density_np(pos)) / wtot

    def terms(self, keys, tag: int = rng.LAUNCH_POSITION):
        u = rng.uniform(keys, tag + 77)
        p1 = self.first.sample(keys, tag)
        p2 = self.second.sample(keys, tag)
        pick1 = u < xm.f32(self.w1 / (self.w1 + self.w2))
        return torch.where(pick1[:, None], p1, p2), None


@dataclasses.dataclass(frozen=True)
class ClumpyDecorator(Geometry):
    """Redistribute a fraction of the mass into uniform spherical clumps
    whose centres are drawn from the base density at construction (ref:
    ClumpyGeometryDecorator)."""

    base: Geometry
    clump_fraction: float = 0.3
    num_clumps: int = 100
    clump_radius: float = 1.0
    seed: int = 99

    def __post_init__(self):
        object.__setattr__(self, "_centers", _host_sample(
            self.base, self.seed, self.num_clumps))

    def density_np(self, pos):
        pos = np.asarray(pos, np.float64)
        smooth = (1 - self.clump_fraction) * self.base.density_np(pos)
        vol = 4 / 3 * np.pi * self.clump_radius ** 3
        m_clump = self.clump_fraction / self.num_clumps
        clump = np.zeros(pos.shape[:-1])
        for cpos in self._centers:
            r = np.linalg.norm(pos - cpos, axis=-1)
            clump += np.where(r < self.clump_radius, m_clump / vol, 0.0)
        return smooth + clump

    def terms(self, keys, tag: int = rng.LAUNCH_POSITION):
        u = rng.uniform(keys, tag + 88)
        p_smooth = self.base.sample(keys, tag)
        n = self.num_clumps
        ci = torch.clamp((rng.uniform(keys, tag + 89) * float(n)).to(
            torch.int32), 0, n - 1).long()
        centers = self._dev("centers", lambda: self._centers, keys.device)
        u_r = torch.pow(rng.uniform(keys, tag + 90).double(),
                        xm.f32(1.0 / 3.0)).float()
        s = u_r * xm.f32(self.clump_radius)
        p_clump = xm.fma(rng.isotropic_direction(keys, tag + 91),
                         s[:, None], centers[ci])
        return torch.where((u < xm.f32(self.clump_fraction))[:, None],
                           p_clump, p_smooth), None


@dataclasses.dataclass(frozen=True)
class SpiralStructureDecorator(Geometry):
    """Logarithmic spiral arms on an axisymmetric geometry
    (ref: SpiralStructureGeometryDecorator.cpp:18-74): the density times
    (1-w) + w c_N sin^{2N}(m (gamma - phi) / 2), with gamma = ln(R/R0) /
    tan(p) + phi0 + pi/(2m) and c_N = sqrt(pi) Gamma(N+1) / Gamma(N+1/2),
    which keeps unit mass. Sampling is the reference's rejection-free one:
    psi from an inverse-cdf table of (1-w) + w c_N sin^{2N}(psi) over one
    period, an arm k uniformly, phi = gamma(R) - 2 (k pi + psi) / m."""

    base: Geometry
    num_arms: int = 2
    pitch_angle: float = 0.1745       # [rad]
    radius_zero_point: float = 1.0    # R0 [m]
    phase_zero_point: float = 0.0     # phi0 [rad]
    perturbation_weight: float = 0.5  # w
    index: int = 1                    # N

    def __post_init__(self):
        from scipy.special import gammaln
        N = float(self.index)
        cn = np.sqrt(np.pi) * np.exp(gammaln(N + 1.0) - gammaln(N + 0.5))
        object.__setattr__(self, "_cn", float(cn))
        psi = np.linspace(0.0, np.pi, 1025)
        f = (1.0 - self.perturbation_weight) \
            + self.perturbation_weight * cn * np.sin(psi) ** (2 * self.index)
        cdf = np.concatenate([[0.0], np.cumsum(
            0.5 * (f[1:] + f[:-1]) * np.diff(psi))])
        cdf /= cdf[-1]
        object.__setattr__(self, "_psi_grid", psi)
        object.__setattr__(self, "_psi_cdf", cdf)

    def _gamma_np(self, R):
        return (np.log(np.maximum(R, 1e-300) / self.radius_zero_point)
                / np.tan(self.pitch_angle) + self.phase_zero_point
                + 0.5 * np.pi / self.num_arms)

    def perturbation_np(self, R, phi):
        g = self._gamma_np(np.asarray(R, np.float64))
        return (1.0 - self.perturbation_weight) + self.perturbation_weight \
            * self._cn * np.sin(0.5 * self.num_arms * (g - phi)) \
            ** (2 * self.index)

    def density_np(self, pos):
        pos = np.asarray(pos, np.float64)
        R = np.hypot(pos[..., 0], pos[..., 1])
        phi = np.arctan2(pos[..., 1], pos[..., 0])
        return self.base.density_np(pos) * self.perturbation_np(R, phi)

    def _gamma(self, R):
        """gamma(R) in f32 as XLA forms the reference's expression: in a
        jitted launch the divisions by constants are products with f32
        reciprocals, the two added constants are folded into one, and the
        product is fused into that sum; op by op (`xlamath.eager`) each
        operation rounds on its own."""
        r0 = xm.f32(self.radius_zero_point)
        tan_p = xm.f32(float(np.tan(self.pitch_angle)))
        phi0, c = xm.f32(self.phase_zero_point), xm.f32(
            0.5 * np.pi / self.num_arms)
        R = torch.clamp_min(R, 0.0)    # max(R, 1e-300) in f32
        if xm.is_eager():
            g = xm.log_xla(R / r0) / tan_p
            return (g + phi0 if self.phase_zero_point != 0.0 else g) + c
        lr = xm.log_xla(R * xm.f32(1.0 / r0))
        return xm.fma(lr, xm.f32(1.0 / tan_p), xm.f32(phi0 + c))

    def terms(self, keys, tag: int = rng.LAUNCH_POSITION):
        dev = keys.device
        a, b = self.base.terms(keys, tag)
        p = a if b is None else a * b
        R = xm.hypot(p[:, 0], p[:, 1])
        u = rng.uniform(keys, tag + 77)
        psi = sampling.interp_jnp(
            u, self._dev("cdf", lambda: self._psi_cdf, dev),
            self._dev("psi", lambda: self._psi_grid, dev))
        m = self.num_arms
        k = torch.clamp((rng.uniform(keys, tag + 78) * float(m)).to(
            torch.int32), 0, m - 1)
        theta = xm.fma(k.float(), xm.f32(math.pi), psi)
        if xm.is_eager():
            phi = self._gamma(R) - (2.0 * theta) / float(m)
        else:   # the division by m a product with 1/m, fused
            phi = xm.fma(2.0 * theta, -xm.f32(1.0 / m), self._gamma(R))
        # z is the base's, its last product kept
        return polar(R, phi, p[:, 2] if b is None else a[:, 2],
                     None if b is None else b[:, 2])


@dataclasses.dataclass(frozen=True)
class RedistributeDecorator(Geometry):
    """Multiply a geometry's density by a weight function, renormalised
    (ref: RedistributeGeometryDecorator): the norm from base samples at
    construction, positions by rejection against w / max w over 24 retry
    rounds."""

    base: Geometry

    def weight_np(self, pos):
        raise NotImplementedError

    def weight(self, pos: torch.Tensor) -> torch.Tensor:
        """The f32 weight of f32 positions, on their device."""
        raise NotImplementedError

    def max_weight(self) -> float:
        raise NotImplementedError

    def __post_init__(self):
        mean_w = float(self.weight_np(_host_sample(self.base, 20240817,
                                                   16384)).mean())
        object.__setattr__(self, "_norm", 1.0 / max(mean_w, 1e-300))

    def density_np(self, pos):
        return self.base.density_np(pos) * self.weight_np(np.asarray(pos)) \
            * self._norm

    def terms(self, keys, tag: int = rng.LAUNCH_POSITION):
        pts = self.base.sample(keys, tag)
        maxw = xm.f32(self.max_weight())
        accept = rng.uniform(keys, tag + 76) * maxw < self.weight(pts)
        for t in range(24):
            keys2 = rng.purpose_key(keys, 7100 + t)
            newp = self.base.sample(keys2, tag)
            ok = rng.uniform(keys2, tag + 76) * maxw < self.weight(newp)
            pts = torch.where(((~accept) & ok)[:, None], newp, pts)
            accept = accept | ok
        return pts, None


def _power_weight(r: torch.Tensor, min_radius: float, exponent: float):
    """where(r >= min_radius, max(r, 1e-30)^-exponent, 0) in f32, the power
    rounded from f64."""
    w = torch.pow(torch.clamp_min(r, xm.f32(1e-30)).double(),
                  xm.f32(-exponent)).float()
    return torch.where(r >= xm.f32(min_radius), w, torch.zeros_like(w))


@dataclasses.dataclass(frozen=True)
class SphePowerLawRedistributeDecorator(RedistributeDecorator):
    """Spherical power-law weight r^-p outside a clipping sphere
    (ref: SphePowerLawRedistributeGeometryDecorator)."""

    exponent: float = 1.0
    min_radius: float = 1.0

    def weight_np(self, pos):
        r = np.linalg.norm(np.asarray(pos), axis=-1)
        return np.where(r >= self.min_radius, np.maximum(r, 1e-300)
                        ** (-self.exponent), 0.0)

    def weight(self, pos):
        # jnp.linalg.norm: the square root of the in-order sum of squares
        s = xm.fma(pos[:, 2], pos[:, 2],
                   xm.fma(pos[:, 1], pos[:, 1], pos[:, 0] * pos[:, 0]))
        return _power_weight(xm.sqrt(s), self.min_radius, self.exponent)

    def max_weight(self) -> float:
        return self.min_radius ** (-self.exponent)


@dataclasses.dataclass(frozen=True)
class AxPowerLawRedistributeDecorator(RedistributeDecorator):
    """Cylindrical power-law weight R^-p outside a clipping cylinder
    (ref: AxPowerLawRedistributeGeometryDecorator)."""

    exponent: float = 1.0
    min_radius: float = 1.0

    def weight_np(self, pos):
        pos = np.asarray(pos)
        R = np.hypot(pos[..., 0], pos[..., 1])
        return np.where(R >= self.min_radius, np.maximum(R, 1e-300)
                        ** (-self.exponent), 0.0)

    def weight(self, pos):
        return _power_weight(xm.hypot(pos[:, 0], pos[:, 1]),
                             self.min_radius, self.exponent)

    def max_weight(self) -> float:
        return self.min_radius ** (-self.exponent)
