"""Axisymmetric analytic geometries, sampled from one tabulated (R, z) cdf.

Port of `skirt9_tpu/geometries/axial.py`: `AxialTabulatedGeometry` and its
shapes (torus, conical shell, T Tauri disk, ring, annulus, donut, broken
exponential disk, paraboloid and hyperboloid, each solid or a shell).
`density_np` is analytic, normalised by the mass of the tabulated profile;
sampling inverts a 512 x 512 (R, z) cdf built in float64 on the host and
kept as f32 on the device: one `searchsorted` per packet, then a jitter
inside the chosen cell that is uniform in z and in R^2 (area-correct),
and a uniform azimuth. The f32 operations follow XLA's CPU fusions in the
reference's jitted launch (`ops.xlamath.fma`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import rng
from ..ops import xlamath as xm
from .analytic import _TWO_PI, Geometry, polar


@dataclasses.dataclass(frozen=True)
class AxialTabulatedGeometry(Geometry):
    """Base: subclasses provide rho_Rz(R, z) (unnormalised) and bounds()
    = (Rmax, zmax)."""

    def rho_Rz(self, R: np.ndarray, z: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def bounds(self) -> tuple:
        raise NotImplementedError

    def density_np(self, pos: np.ndarray) -> np.ndarray:
        pos = np.asarray(pos, np.float64)
        R = np.hypot(pos[..., 0], pos[..., 1])
        return self.rho_Rz(R, pos[..., 2]) / self._norm()

    def _norm(self) -> float:
        return self._tables()[3]

    def _tables(self, nR: int = 512, nz: int = 512):
        """(cdf over the nR x nz cells, R borders, z borders, mass) in
        float64, built once."""
        t = self.__dict__.get("_host_tables")
        if t is not None:
            return t
        Rmax, zmax = self.bounds()
        Rb = np.linspace(0.0, Rmax, nR + 1)
        zb = np.linspace(-zmax, zmax, nz + 1)
        Rc = 0.5 * (Rb[1:] + Rb[:-1])
        zc = 0.5 * (zb[1:] + zb[:-1])
        w = self.rho_Rz(Rc[:, None], zc[None, :]) * Rc[:, None]
        flat = np.maximum(w, 0.0).reshape(-1).astype(np.float64)
        total = flat.sum()
        mass = float(total * 2 * np.pi * (Rb[1] - Rb[0]) * (zb[1] - zb[0]))
        cdf = np.concatenate([[0.0], np.cumsum(flat / total)])
        cdf[-1] = 1.0
        t = (cdf, Rb, zb, mass)
        object.__setattr__(self, "_host_tables", t)
        return t

    def terms(self, keys, tag: int = rng.LAUNCH_POSITION):
        dev = keys.device
        cdf = self._dev("cdf", lambda: self._tables()[0], dev)
        Rb = self._dev("Rb", lambda: self._tables()[1], dev)
        zb = self._dev("zb", lambda: self._tables()[2], dev)
        nR, nz = Rb.shape[0] - 1, zb.shape[0] - 1
        u = rng.uniform(keys, tag)
        cell = torch.clamp(torch.searchsorted(cdf, u.contiguous(), right=True)
                           - 1, 0, nR * nz - 1)
        i, j = cell // nz, cell % nz
        u1, u2 = rng.uniform2(keys, tag + 50)
        # area-correct jitter in R within the bin (p ~ R)
        R0, R1 = Rb[i], Rb[i + 1]
        R = xm.sqrt(xm.fma(u1, xm.fma(R1, R1, -(R0 * R0)), R0 * R0))
        z0 = zb[j]
        z = xm.fma(u2, zb[j + 1] - z0, z0)
        return polar(R, _TWO_PI * rng.uniform(keys, tag + 51), z)


# ------------------------------------------------------------ concrete shapes

@dataclasses.dataclass(frozen=True)
class TorusGeometry(AxialTabulatedGeometry):
    """AGN torus rho ~ r^-p exp(-q|cos theta|) within the opening angle
    (ref: SKIRT/core/TorusGeometry.hpp)."""

    rmin: float = 0.1
    rmax: float = 1.0
    p: float = 1.0
    q: float = 0.0
    delta: float = 0.35  # half-opening angle from the equatorial plane [rad]

    def bounds(self):
        return self.rmax, self.rmax * np.sin(self.delta) * 1.001

    def rho_Rz(self, R, z):
        r = np.hypot(R, z)
        rs = np.maximum(r, 1e-300)
        cost = np.abs(z) / rs
        inside = ((r >= self.rmin) & (r <= self.rmax)
                  & (cost <= np.sin(self.delta)))
        return np.where(inside, rs ** -self.p * np.exp(-self.q * cost), 0.0)


@dataclasses.dataclass(frozen=True)
class ConicalShellGeometry(AxialTabulatedGeometry):
    """Conical shell around the symmetry axis, rho ~ r^-p between half-
    opening angles delta_in..delta_out from the axis and radii rmin..rmax
    (ref: SKIRT/core/ConicalShellGeometry.hpp)."""

    rmin: float = 0.1
    rmax: float = 1.0
    p: float = 1.0
    delta_in: float = 0.3   # from the axis
    delta_out: float = 0.7

    def bounds(self):
        return self.rmax * np.sin(self.delta_out) * 1.001, self.rmax

    def rho_Rz(self, R, z):
        r = np.hypot(R, z)
        rs = np.maximum(r, 1e-300)
        theta = np.arccos(np.clip(np.abs(z) / rs, 0, 1))
        inside = ((r >= self.rmin) & (r <= self.rmax)
                  & (theta >= self.delta_in) & (theta <= self.delta_out))
        return np.where(inside, rs ** -self.p, 0.0)


@dataclasses.dataclass(frozen=True)
class TTauriDiskGeometry(AxialTabulatedGeometry):
    """Flared T Tauri protoplanetary disk
    rho ~ (R/Rd)^-15/8 exp(-pi/4 (z / (zd (R/Rd)^9/8))^2), Rin <= R <= Rout
    (ref: SKIRT/core/TTauriDiskGeometry.hpp)."""

    rinn: float = 0.01
    rout: float = 1.0
    rd: float = 0.5
    zd: float = 0.05

    def bounds(self):
        hmax = self.zd * (self.rout / self.rd) ** 1.125
        return self.rout, 6.0 * hmax

    def rho_Rz(self, R, z):
        Rs = np.maximum(R, 1e-300)
        h = self.zd * (Rs / self.rd) ** 1.125
        inside = (R >= self.rinn) & (R <= self.rout)
        return np.where(inside, (Rs / self.rd) ** -1.875
                        * np.exp(-np.pi / 4 * (z / h) ** 2), 0.0)


@dataclasses.dataclass(frozen=True)
class RingGeometry(AxialTabulatedGeometry):
    """Gaussian radial ring with an exponential vertical profile
    rho ~ exp(-(R-R0)^2/2w^2) exp(-|z|/hz) (ref: SKIRT/core/RingGeometry.hpp)."""

    r0: float = 1.0
    width: float = 0.2
    hz: float = 0.1

    def bounds(self):
        return self.r0 + 6 * self.width, 12.0 * self.hz

    def rho_Rz(self, R, z):
        return (np.exp(-((R - self.r0) ** 2) / (2 * self.width ** 2))
                * np.exp(-np.abs(z) / self.hz))


@dataclasses.dataclass(frozen=True)
class AnnulusGeometry(AxialTabulatedGeometry):
    """Uniform annulus rmin <= R <= rmax, |z| <= h/2
    (ref: SKIRT/core/AnnulusGeometry.hpp)."""

    rmin: float = 0.5
    rmax: float = 1.0
    height: float = 0.2

    def bounds(self):
        return self.rmax, self.height / 2 * 1.001

    def rho_Rz(self, R, z):
        return np.where((R >= self.rmin) & (R <= self.rmax)
                        & (np.abs(z) <= self.height / 2), 1.0, 0.0)


@dataclasses.dataclass(frozen=True)
class DonutGeometry(AxialTabulatedGeometry):
    """Uniform circular torus (donut): tube radius rc around ring radius r0
    (ref: SKIRT/core/DonutGeometry.hpp)."""

    r0: float = 1.0
    rc: float = 0.25

    def bounds(self):
        return self.r0 + self.rc, self.rc * 1.001

    def rho_Rz(self, R, z):
        return np.where((R - self.r0) ** 2 + z ** 2 <= self.rc ** 2, 1.0, 0.0)


@dataclasses.dataclass(frozen=True)
class BrokenExpDiskGeometry(AxialTabulatedGeometry):
    """Radially broken double-exponential disk: inner scale length h_inn,
    outer h_out beyond break radius rb, vertical exponential scale hz
    (ref: SKIRT/core/BrokenExpDiskGeometry.hpp)."""

    h_inn: float = 1.0
    h_out: float = 0.5
    rb: float = 2.0
    hz: float = 0.2

    def bounds(self):
        return self.rb + 12 * self.h_out, 12 * self.hz

    def rho_Rz(self, R, z):
        radial = np.where(
            R <= self.rb, np.exp(-R / self.h_inn),
            np.exp(-self.rb / self.h_inn) * np.exp(-(R - self.rb) / self.h_out))
        return radial * np.exp(-np.abs(z) / self.hz)


@dataclasses.dataclass(frozen=True)
class ParaboloidGeometry(AxialTabulatedGeometry):
    """Uniform density inside the paraboloid R^2 = a^2 z (both lobes) up to
    |z| <= zmax (ref: SKIRT/core/ParaboloidGeometry.hpp)."""

    a: float = 1.0
    zmax: float = 1.0

    def bounds(self):
        return self.a * np.sqrt(self.zmax), self.zmax * 1.001

    def rho_Rz(self, R, z):
        az = np.abs(z)
        return np.where((az <= self.zmax) & (R * R <= self.a ** 2 * az),
                        1.0, 0.0)


@dataclasses.dataclass(frozen=True)
class ParaboloidShellGeometry(AxialTabulatedGeometry):
    """Uniform density between two nested paraboloids
    (ref: SKIRT/core/ParaboloidShellGeometry.hpp)."""

    a_in: float = 0.7
    a_out: float = 1.0
    zmax: float = 1.0

    def bounds(self):
        return self.a_out * np.sqrt(self.zmax), self.zmax * 1.001

    def rho_Rz(self, R, z):
        az = np.abs(z)
        r2 = R * R
        return np.where((az <= self.zmax) & (r2 <= self.a_out ** 2 * az)
                        & (r2 >= self.a_in ** 2 * az), 1.0, 0.0)


@dataclasses.dataclass(frozen=True)
class HyperboloidGeometry(AxialTabulatedGeometry):
    """Uniform density inside the one-sheet hyperboloid
    R^2/a^2 - z^2/c^2 <= 1, |z| <= zmax
    (ref: SKIRT/core/HyperboloidGeometry.hpp)."""

    a: float = 0.5
    c: float = 1.0
    zmax: float = 1.0

    def bounds(self):
        return self.a * np.sqrt(1 + (self.zmax / self.c) ** 2), \
            self.zmax * 1.001

    def rho_Rz(self, R, z):
        return np.where((np.abs(z) <= self.zmax)
                        & (R ** 2 / self.a ** 2 - z ** 2 / self.c ** 2 <= 1.0),
                        1.0, 0.0)


@dataclasses.dataclass(frozen=True)
class HyperboloidShellGeometry(AxialTabulatedGeometry):
    """Uniform density between two nested one-sheet hyperboloids
    (ref: SKIRT/core/HyperboloidShellGeometry.hpp)."""

    a_in: float = 0.3
    c_in: float = 1.0
    a_out: float = 0.5
    c_out: float = 1.0
    zmax: float = 1.0

    def bounds(self):
        return (self.a_out * np.sqrt(1 + (self.zmax / self.c_out) ** 2),
                self.zmax * 1.001)

    def rho_Rz(self, R, z):
        az = np.abs(z)
        inner = R ** 2 / self.a_in ** 2 - z ** 2 / self.c_in ** 2 <= 1.0
        outer = R ** 2 / self.a_out ** 2 - z ** 2 / self.c_out ** 2 <= 1.0
        return np.where((az <= self.zmax) & outer & ~inner, 1.0, 0.0)
