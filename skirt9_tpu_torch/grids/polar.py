"""Polar spatial grids: Sphere2D (r, theta), Sphere3D (r, theta, phi) and
Cylinder3D (R, phi, z).

Port of `skirt9_tpu/grids/polar.py` (ref: SKIRT/core/Sphere2DSpatialGrid,
Sphere3DSpatialGrid, Cylinder3DSpatialGrid): shells x polar cones (x
azimuthal half-planes), and annuli x half-planes x z slabs. A step takes
the least positive crossing over the cell's bounding surfaces (the sphere,
cone, half-plane, cylinder and z-plane quadratics in closed form), moves
there, and *relocates* the packet at pos + (ds + eta) dirn, eta = 1e-6 of
the grid's size, so every step advances at least eta. `locate` is a
binary search per coordinate: r, theta = atan2(hypot(x, y), z), phi =
atan2(y, x), R = hypot(x, y), z.

`locate`, `step` and `move_inside` follow the reference's f32 operations
as XLA runs them in its jitted march, with the grid's tables constants:
products fused into the sums they feed (`ops.xlamath.fma_rn`), the square
roots and divisions correctly rounded, atan2 the C library's atan2f
(`xlamath.atan2`), and the cosines and sines of the border angles the C
library's cosf and sinf, tabulated at build (`cos_t`, `cos_p`, `sin_p`),
so that a step lands in the reference's cell. The march kernel's modes
`march_sphere2d`, `march_sphere3d` and `march_cylinder3d`
(`csrc/march.cu`) do the same on the card.

As on the 1D sphere (`grids/sphere.py`), a grid past 2^60 m keeps a
power-of-two `shift`: the steps work in lengths times 2^-shift, exactly,
where the reference's squares of radii overflow f32 (past ~0.6 kpc).

The reference's polar grids have no cell bounds, so its dust emission
fails on them; the port's raises NotImplementedError (`sources/
secondary.cell_bounds`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import xlamath as xm
from .sphere import length_shift

_BIG = 3e38
# every fused multiply-add of a step rounds once, as the march kernel's
# fmaf does (xlamath.fma_rn), so that the card holds the kernel bit for bit
fma = xm.fma_rn


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`jnp.sum(a * b, axis=-1)` over (B, 3) as XLA's CPU code forms it:
    a running sum, each product fused into it."""
    return fma(a[:, 2], b[:, 2], fma(a[:, 1], b[:, 1], a[:, 0] * b[:, 0]))


def _big(t):
    return torch.full_like(t, _BIG)


# ------------------------------------------------------------- primitives

def sphere_out(pos, dirn, r_out):
    """Distance to the outer sphere |p + t d| = r_out from inside."""
    b = dot3(pos, dirn)
    disc = fma(r_out, r_out, -fma(-b, b, dot3(pos, pos)))
    disc = torch.clamp_min(disc, 0.0)
    return torch.clamp_min(xm.sqrt(disc) - b, 0.0)


def sphere_in(pos, dirn, r_in):
    """Distance to the inner sphere, heading inward with the ray's
    perihelion inside it; else _BIG."""
    b = dot3(pos, dirn)
    disc = fma(r_in, r_in, -fma(-b, b, dot3(pos, pos)))
    t = -b - xm.sqrt(torch.clamp_min(disc, 0.0))
    ok = (r_in > 0) & (b < 0) & (disc > 0) & (t > 0)
    return torch.where(ok, t, _big(t))


def cone_cross(pos, dirn, c, eta):
    """The least crossing distance (> eta) with the polar cone
    cos(theta) = c, the crossing point's z of c's sign; _BIG on the axis
    (|c| ~ 1), the z = 0 plane where |c| ~ 0.

    XLA's CPU code fuses a product into the sum it feeds where the
    product has no other use (where both terms are such products, the
    first, or the one of fewer uses). In the reference's march z dz and
    z^2, each in two sums, fuse into B and C only, and dz^2 and c^2 into
    nothing."""
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    dx, dy, dz = dirn[:, 0], dirn[:, 1], dirn[:, 2]
    big = _big(z)
    c2 = c * c
    zdz, zz, dzdz = z * dz, z * z, dz * dz
    pd = zdz + fma(x, dx, y * dy)
    r2 = zz + fma(x, x, y * y)
    A = dzdz - c2
    B = fma(-c2, pd, zdz)
    C = fma(-c2, r2, zz)
    steep = torch.abs(dz) > xm.f32(1e-30)
    t_plane = torch.where(steep, -z / torch.where(steep, dz,
                                                  torch.ones_like(dz)), big)
    t_plane = torch.where(t_plane > eta, t_plane, big)
    disc = fma(B, B, -(A * C))
    sq = xm.sqrt(torch.clamp_min(disc, 0.0))
    safe_A = torch.where(torch.abs(A) > xm.f32(1e-30), A, torch.ones_like(A))
    t1 = (-B - sq) / safe_A
    t2 = (sq - B) / safe_A
    flat = torch.abs(B) > xm.f32(1e-30)
    t_lin = torch.where(flat, -C / (2.0 * torch.where(
        flat, B, torch.ones_like(B))), big)
    lin = torch.abs(A) < xm.f32(1e-12) * ((dzdz + c2) + xm.f32(1e-30))
    sc = torch.sign(c)

    def valid(t):
        zc = fma(t, dz, z)
        ok = (t > eta) & (disc >= 0) & (torch.sign(zc) == sc)
        return torch.where(ok, t, big)

    t_quad = torch.minimum(valid(torch.where(lin, t_lin, t1)),
                           valid(torch.where(lin, big, t2)))
    axis = torch.abs(c) > xm.f32(1 - 1e-7)
    plane = torch.abs(c) < xm.f32(1e-7)
    return torch.where(axis, big, torch.where(plane, t_plane, t_quad))


def halfplane_cross(pos, dirn, cb, sb, eta):
    """The least crossing distance (> eta) with the azimuthal half-plane
    of cosine cb and sine sb (its half with x cb + y sb > 0)."""
    x, y = pos[:, 0], pos[:, 1]
    dx, dy = dirn[:, 0], dirn[:, 1]
    num = -fma(x, sb, -(y * cb))
    den = fma(dx, sb, -(dy * cb))
    ok = torch.abs(den) > xm.f32(1e-30)
    t = torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                    _big(den))
    on_half = fma(fma(t, dx, x), cb, fma(t, dy, y) * sb) > 0
    return torch.where((t > eta) & on_half, t, _big(t))


def theta_of(pos):
    return xm.atan2(xm.hypot(pos[:, 0], pos[:, 1], fma), pos[:, 2])


def phi_of(pos):
    return xm.atan2(pos[:, 1], pos[:, 0])


def _bin(borders, v):
    return torch.searchsorted(borders, v.contiguous(), right=True) - 1


def _angles(values, *names):
    """Host f32 tables of the C library's functions of the angles."""
    return tuple(torch.tensor(xm.libm_f32(n, values)) for n in names)


class _Polar:
    """What the three grids share: the length scaling, the relocating step
    and the entry through the outer surface."""

    def _scale(self, *lengths):
        if not self.shift:
            return lengths
        s = 2.0 ** -self.shift
        return tuple(v * s for v in lengths)

    def _unscale(self, t):
        """Scaled distances back in metres (exact); _BIG stays _BIG."""
        if not self.shift:
            return t
        return torch.where(t >= _BIG, t, t * 2.0 ** self.shift)

    def _finish(self, pos_m, pos, dirn, cell, ds, eta):
        """The step's tail: the next cell at pos + (ds + eta) dirn, the
        position moved to pos + ds dirn (in metres), ds 0 and -1 for a lane
        outside."""
        nxt = self._locate_scaled(fma((ds + eta)[:, None], dirn, pos))
        newpos = fma(ds[:, None], dirn, pos)
        ds = self._unscale(ds)
        if self.shift:
            newpos = newpos * 2.0 ** self.shift
        out = cell < 0
        return (torch.where(out, torch.zeros_like(ds), ds),
                torch.where(out, -1, nxt),
                torch.where(out[:, None], pos_m, newpos))

    def locate(self, pos: torch.Tensor) -> torch.Tensor:
        """(B, 3) -> (B,) int64 cell index, -1 outside the grid."""
        return self._locate_scaled(*self._scale(pos))

    def move_inside(self, pos: torch.Tensor, dirn: torch.Tensor):
        """Advance packets outside to the outer surface, eta beyond (the
        reference's `move_inside`): (pos', cell', distance); a packet that
        misses the grid travels _BIG and lands nowhere."""
        pos_m = pos
        (pos,) = self._scale(pos)
        t = self._entry(pos, dirn)
        already = self._locate_scaled(pos) >= 0
        t = self._unscale(torch.where(already, torch.zeros_like(t), t))
        newpos = xm.move_xy_fused(pos_m, t, dirn)
        return newpos, self.locate(newpos), t

    def _sphere_entry(self, pos, dirn, rb, eta):
        R = rb[-1]
        b = dot3(pos, dirn)
        r2 = dot3(pos, pos)
        disc = R * R - fma(-b, b, r2)
        t = torch.where(disc > 0, -b - xm.sqrt(torch.clamp_min(disc, 0.0)),
                        _big(b))
        return torch.clamp_min(t, 0.0) + eta


# -------------------------------------------------------------- Sphere2D

class _Sphere2DTables(NamedTuple):
    rb: torch.Tensor      # (nr+1,) shell radii [m], f32, rb[0] >= 0
    tb: torch.Tensor      # (nt+1,) polar border angles [rad], 0 .. pi
    cos_t: torch.Tensor   # (nt+1,) cosf of tb
    shift: int = 0        # lengths enter the steps times 2^-shift (exact)


class Sphere2DGrid(_Sphere2DTables, _Polar):
    """Axisymmetric shells x polar cones (ref: Sphere2DSpatialGrid), cell
    index ir * nt + it."""

    __slots__ = ()

    @property
    def nr(self) -> int:
        return self.rb.shape[0] - 1

    @property
    def nt(self) -> int:
        return self.tb.shape[0] - 1

    @property
    def ncells(self) -> int:
        return self.nr * self.nt

    def to(self, device) -> "Sphere2DGrid":
        return self._replace(rb=self.rb.to(device), tb=self.tb.to(device),
                             cos_t=self.cos_t.to(device))

    def _eta(self, rb):
        return rb[-1] * xm.f32(1e-6)

    def _locate_scaled(self, pos):
        (rb,) = self._scale(self.rb)
        r = xm.sqrt(dot3(pos, pos))
        ir = _bin(rb, r)
        it = torch.clamp(_bin(self.tb, theta_of(pos)), 0, self.nt - 1)
        inside = (r >= rb[0]) & (r < rb[-1])
        cell = torch.clamp(ir, 0, self.nr - 1) * self.nt + it
        return torch.where(inside, cell, -1)

    def step(self, pos: torch.Tensor, dirn: torch.Tensor, cell: torch.Tensor):
        """One step (the reference's `polar.py:154-168`): (ds, next cell,
        next position); a lane outside (cell < 0) stays there with ds 0,
        and leaving the grid gives -1."""
        pos_m = pos
        pos, rb = self._scale(pos, self.rb)
        eta = self._eta(rb)
        i = torch.clamp_min(cell, 0)
        ir, it = i // self.nt, i % self.nt
        t_out = sphere_out(pos, dirn, rb[ir + 1])
        t_in = sphere_in(pos, dirn, rb[ir])
        t_up = cone_cross(pos, dirn, self.cos_t[it], eta)
        t_dn = cone_cross(pos, dirn, self.cos_t[it + 1], eta)
        ds = torch.minimum(torch.minimum(t_out, t_in),
                           torch.minimum(t_up, t_dn))
        return self._finish(pos_m, pos, dirn, cell, ds, eta)

    def _entry(self, pos, dirn):
        (rb,) = self._scale(self.rb)
        return self._sphere_entry(pos, dirn, rb, self._eta(rb))

    def volumes(self) -> np.ndarray:
        rb = self.rb.cpu().numpy().astype(np.float64)
        tb = self.tb.cpu().numpy().astype(np.float64)
        shell = 2.0 * np.pi / 3.0 * (rb[1:] ** 3 - rb[:-1] ** 3)
        band = np.cos(tb[:-1]) - np.cos(tb[1:])
        return (shell[:, None] * band[None, :]).reshape(-1)

    def cell_centers(self) -> torch.Tensor:
        """Mid radius and mid angle of each cell, on the x-z plane."""
        rc = 0.5 * (self.rb[1:] + self.rb[:-1])
        tc = 0.5 * (self.tb[1:] + self.tb[:-1])
        sin_t, cos_t = _angles(tc.cpu().numpy(), "sinf", "cosf")
        R = rc[:, None].cpu()
        return torch.stack([(R * sin_t[None, :]).reshape(-1),
                            torch.zeros(self.ncells),
                            (R * cos_t[None, :]).reshape(-1)],
                           dim=-1).to(self.rb.device)

    def cell_jitter_halfwidths(self) -> np.ndarray:
        rb = self.rb.cpu().numpy().astype(np.float64)
        tb = self.tb.cpu().numpy().astype(np.float64)
        rc = 0.5 * (rb[1:] + rb[:-1])
        harc = np.minimum.outer(rc, np.diff(tb)) * 0.5
        hr = np.repeat(np.diff(rb) * 0.5, self.nt).reshape(self.nr, self.nt)
        h = np.minimum(hr, harc).reshape(-1)
        return np.stack([h, h, h], axis=-1)

    def diagonal(self) -> float:
        return float(2 * float(self.rb[-1]))

    def max_steps(self) -> int:
        return 4 * self.nr + 4 * self.nt + 8


def make_sphere2d(r_max: float, nr: int, nt: int, r_min: float = 0.0,
                  log_r: bool = False, rb=None, tb=None) -> Sphere2DGrid:
    if rb is not None:
        rb = np.asarray(rb, np.float64)
    elif log_r:
        rb = np.concatenate([[0.0], np.geomspace(max(r_min, r_max * 1e-4),
                                                 r_max, nr)])
    else:
        rb = np.linspace(r_min, r_max, nr + 1)
    if tb is None:
        tb = np.linspace(0.0, np.pi, nt + 1)
    rb, tb = np.asarray(rb, np.float32), np.asarray(tb, np.float32)
    (cos_t,) = _angles(tb, "cosf")
    return Sphere2DGrid(rb=torch.tensor(rb), tb=torch.tensor(tb),
                        cos_t=cos_t, shift=length_shift(rb))


# -------------------------------------------------------------- Sphere3D

class _Sphere3DTables(NamedTuple):
    rb: torch.Tensor      # (nr+1,) shell radii [m], f32
    tb: torch.Tensor      # (nt+1,) polar border angles [rad]
    pb: torch.Tensor      # (nphi+1,) azimuth borders [rad], -pi .. pi
    cos_t: torch.Tensor   # (nt+1,) cosf of tb
    cos_p: torch.Tensor   # (nphi+1,) cosf of pb
    sin_p: torch.Tensor   # (nphi+1,) sinf of pb
    shift: int = 0


class Sphere3DGrid(_Sphere3DTables, _Polar):
    """Shells x cones x azimuthal wedges (ref: Sphere3DSpatialGrid), cell
    index (ir * nt + it) * nphi + ip."""

    __slots__ = ()

    @property
    def nr(self) -> int:
        return self.rb.shape[0] - 1

    @property
    def nt(self) -> int:
        return self.tb.shape[0] - 1

    @property
    def nphi(self) -> int:
        return self.pb.shape[0] - 1

    @property
    def ncells(self) -> int:
        return self.nr * self.nt * self.nphi

    def to(self, device) -> "Sphere3DGrid":
        return self._replace(**{f: getattr(self, f).to(device) for f in (
            "rb", "tb", "pb", "cos_t", "cos_p", "sin_p")})

    def _eta(self, rb):
        return rb[-1] * xm.f32(1e-6)

    def _locate_scaled(self, pos):
        (rb,) = self._scale(self.rb)
        r = xm.sqrt(dot3(pos, pos))
        ir = _bin(rb, r)
        it = torch.clamp(_bin(self.tb, theta_of(pos)), 0, self.nt - 1)
        ip = torch.clamp(_bin(self.pb, phi_of(pos)), 0, self.nphi - 1)
        inside = (r >= rb[0]) & (r < rb[-1])
        cell = (torch.clamp(ir, 0, self.nr - 1) * self.nt + it) \
            * self.nphi + ip
        return torch.where(inside, cell, -1)

    def step(self, pos: torch.Tensor, dirn: torch.Tensor, cell: torch.Tensor):
        """One step (the reference's `polar.py:265-284`)."""
        pos_m = pos
        pos, rb = self._scale(pos, self.rb)
        eta = self._eta(rb)
        ds = self.step_length(pos, dirn, cell, rb, eta)
        return self._finish(pos_m, pos, dirn, cell, ds, eta)

    def step_length(self, pos, dirn, cell, rb, eta):
        """The step's length from cell in scaled lengths (pos and rb times
        2^-shift): the least crossing of the cell's two spheres, two cones
        and two half-planes."""
        i = torch.clamp_min(cell, 0)
        ip = i % self.nphi
        it = (i // self.nphi) % self.nt
        ir = i // (self.nphi * self.nt)
        t_out = sphere_out(pos, dirn, rb[ir + 1])
        t_in = sphere_in(pos, dirn, rb[ir])
        t_up = cone_cross(pos, dirn, self.cos_t[it], eta)
        t_dn = cone_cross(pos, dirn, self.cos_t[it + 1], eta)
        t_p0 = halfplane_cross(pos, dirn, self.cos_p[ip], self.sin_p[ip],
                               eta)
        t_p1 = halfplane_cross(pos, dirn, self.cos_p[ip + 1],
                               self.sin_p[ip + 1], eta)
        return torch.minimum(torch.minimum(torch.minimum(t_out, t_in),
                                           torch.minimum(t_up, t_dn)),
                             torch.minimum(t_p0, t_p1))

    def _entry(self, pos, dirn):
        (rb,) = self._scale(self.rb)
        return self._sphere_entry(pos, dirn, rb, self._eta(rb))

    def volumes(self) -> np.ndarray:
        rb = self.rb.cpu().numpy().astype(np.float64)
        tb = self.tb.cpu().numpy().astype(np.float64)
        pb = self.pb.cpu().numpy().astype(np.float64)
        shell = (rb[1:] ** 3 - rb[:-1] ** 3) / 3.0
        band = np.cos(tb[:-1]) - np.cos(tb[1:])
        v = shell[:, None, None] * band[None, :, None] \
            * np.diff(pb)[None, None, :]
        return v.reshape(-1)

    def cell_centers(self) -> torch.Tensor:
        """Mid radius, mid polar and mid azimuthal angle of each cell."""
        rc = (0.5 * (self.rb[1:] + self.rb[:-1])).cpu()
        tc = 0.5 * (self.tb[1:] + self.tb[:-1])
        pc = 0.5 * (self.pb[1:] + self.pb[:-1])
        sin_t, cos_t = _angles(tc.cpu().numpy(), "sinf", "cosf")
        cos_p, sin_p = _angles(pc.cpu().numpy(), "cosf", "sinf")
        R = rc[:, None, None]
        rs = R * sin_t[None, :, None]
        x = rs * cos_p[None, None, :]
        y = rs * sin_p[None, None, :]
        z = (R * cos_t[None, :, None]).expand_as(x)
        return torch.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)],
                           dim=-1).to(self.rb.device)

    def cell_jitter_halfwidths(self) -> np.ndarray:
        h = 0.5 * np.cbrt(np.asarray(self.volumes(), np.float64))
        return np.stack([h, h, h], axis=-1)

    def diagonal(self) -> float:
        return float(2 * float(self.rb[-1]))

    def max_steps(self) -> int:
        return 4 * self.nr + 4 * self.nt + 2 * self.nphi + 10


def make_sphere3d(r_max: float, nr: int, nt: int, nphi: int,
                  r_min: float = 0.0, rb=None, tb=None,
                  pb=None) -> Sphere3DGrid:
    if nphi < 3:
        raise ValueError("Sphere3D needs >= 3 azimuth bins (half-plane "
                         "traversal assumes wedge spans < pi)")
    if rb is None:
        rb = np.linspace(r_min, r_max, nr + 1)
    if tb is None:
        tb = np.linspace(0.0, np.pi, nt + 1)
    if pb is None:
        pb = np.linspace(-np.pi, np.pi, nphi + 1)
    rb, tb, pb = (np.asarray(a, np.float32) for a in (rb, tb, pb))
    (cos_t,) = _angles(tb, "cosf")
    cos_p, sin_p = _angles(pb, "cosf", "sinf")
    return Sphere3DGrid(rb=torch.tensor(rb), tb=torch.tensor(tb),
                        pb=torch.tensor(pb), cos_t=cos_t, cos_p=cos_p,
                        sin_p=sin_p, shift=length_shift(rb))


# ------------------------------------------------------------ Cylinder3D

class _Cylinder3DTables(NamedTuple):
    rb: torch.Tensor      # (nr+1,) cylindrical radii [m], f32
    pb: torch.Tensor      # (nphi+1,) azimuth borders [rad]
    zb: torch.Tensor      # (nz+1,) z borders [m]
    cos_p: torch.Tensor   # (nphi+1,) cosf of pb
    sin_p: torch.Tensor   # (nphi+1,) sinf of pb
    shift: int = 0


class Cylinder3DGrid(_Cylinder3DTables, _Polar):
    """Annuli x azimuthal wedges x z slabs (ref: Cylinder3DSpatialGrid),
    cell index (ir * nphi + ip) * nz + iz."""

    __slots__ = ()

    @property
    def nr(self) -> int:
        return self.rb.shape[0] - 1

    @property
    def nphi(self) -> int:
        return self.pb.shape[0] - 1

    @property
    def nz(self) -> int:
        return self.zb.shape[0] - 1

    @property
    def ncells(self) -> int:
        return self.nr * self.nphi * self.nz

    def to(self, device) -> "Cylinder3DGrid":
        return self._replace(**{f: getattr(self, f).to(device) for f in (
            "rb", "pb", "zb", "cos_p", "sin_p")})

    def _eta(self, rb, zb):
        return torch.maximum(rb[-1], zb[-1] - zb[0]) * xm.f32(1e-6)

    def _locate_scaled(self, pos):
        rb, zb = self._scale(self.rb, self.zb)
        R = xm.hypot(pos[:, 0], pos[:, 1], fma)
        z = pos[:, 2]
        ir = _bin(rb, R)
        ip = torch.clamp(_bin(self.pb, phi_of(pos)), 0, self.nphi - 1)
        iz = _bin(zb, z)
        inside = (R >= rb[0]) & (R < rb[-1]) & (z >= zb[0]) & (z < zb[-1])
        cell = (torch.clamp(ir, 0, self.nr - 1) * self.nphi + ip) * self.nz \
            + torch.clamp(iz, 0, self.nz - 1)
        return torch.where(inside, cell, -1)

    def step(self, pos: torch.Tensor, dirn: torch.Tensor, cell: torch.Tensor):
        """One step (the reference's `polar.py:386-423`)."""
        pos_m = pos
        pos, rb, zb = self._scale(pos, self.rb, self.zb)
        eta = self._eta(rb, zb)
        i = torch.clamp_min(cell, 0)
        iz = i % self.nz
        ip = (i // self.nz) % self.nphi
        ir = i // (self.nz * self.nphi)
        x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
        dx, dy, dz = dirn[:, 0], dirn[:, 1], dirn[:, 2]
        big = _big(x)
        q = fma(dx, dx, dy * dy)
        b = fma(x, dx, y * dy)
        R2 = fma(x, x, y * y)
        moves = q > xm.f32(1e-30)
        safe_q = torch.clamp_min(q, xm.f32(1e-30))
        r_out, r_in = rb[ir + 1], rb[ir]
        # in the reference's march the second product fuses: q (r^2 - R^2)
        disc_out = torch.clamp_min(
            fma(safe_q, fma(r_out, r_out, -R2), b * b), 0.0)
        t_out = torch.where(moves, torch.clamp_min(
            (xm.sqrt(disc_out) - b) / safe_q, 0.0), big)
        disc_in = fma(safe_q, fma(r_in, r_in, -R2), b * b)
        can_in = (r_in > 0) & (b < 0) & (disc_in > 0) & moves
        t_in = torch.where(can_in, (-b - xm.sqrt(torch.clamp_min(
            disc_in, 0.0))) / safe_q, big)
        t_in = torch.where(t_in > 0, t_in, big)
        t_p0 = halfplane_cross(pos, dirn, self.cos_p[ip], self.sin_p[ip],
                               eta)
        t_p1 = halfplane_cross(pos, dirn, self.cos_p[ip + 1],
                               self.sin_p[ip + 1], eta)
        z_tgt = torch.where(dz > 0, zb[iz + 1], zb[iz])
        flat = torch.abs(dz) < xm.f32(1e-30)
        t_z = torch.where(flat, big, torch.clamp_min(
            (z_tgt - z) / torch.where(flat, torch.ones_like(dz), dz), 0.0))
        ds = torch.minimum(torch.minimum(torch.minimum(t_out, t_in),
                                         torch.minimum(t_p0, t_p1)), t_z)
        return self._finish(pos_m, pos, dirn, cell, ds, eta)

    def _entry(self, pos, dirn):
        rb, zb = self._scale(self.rb, self.zb)
        R_out = rb[-1]
        x, y = pos[:, 0], pos[:, 1]
        dx, dy, dz = dirn[:, 0], dirn[:, 1], dirn[:, 2]
        q = torch.clamp_min(fma(dx, dx, dy * dy), xm.f32(1e-30))
        b = fma(x, dx, y * dy)
        # R_out^2 is a constant of the jitted launch, folded in f32; here
        # XLA does not fuse x^2 into R^2
        disc = fma(b, b, q * (R_out * R_out - (x * x + y * y)))
        t_cyl = torch.where(disc > 0, (-b - xm.sqrt(torch.clamp_min(
            disc, 0.0))) / q, _big(b))
        dzs = torch.where(torch.abs(dz) < xm.f32(1e-30),
                          torch.full_like(dz, xm.f32(1e-30)), dz)
        t_slab = torch.minimum((zb[0] - pos[:, 2]) / dzs,
                               (zb[-1] - pos[:, 2]) / dzs)
        return torch.clamp_min(torch.maximum(t_cyl, t_slab), 0.0) \
            + self._eta(rb, zb)

    def volumes(self) -> np.ndarray:
        rb = self.rb.cpu().numpy().astype(np.float64)
        pb = self.pb.cpu().numpy().astype(np.float64)
        zb = self.zb.cpu().numpy().astype(np.float64)
        ring = 0.5 * (rb[1:] ** 2 - rb[:-1] ** 2)
        v = ring[:, None, None] * np.diff(pb)[None, :, None] \
            * np.diff(zb)[None, None, :]
        return v.reshape(-1)

    def cell_centers(self) -> torch.Tensor:
        """Mid radius, mid azimuth and mid z of each cell."""
        rc = (0.5 * (self.rb[1:] + self.rb[:-1])).cpu()
        pc = 0.5 * (self.pb[1:] + self.pb[:-1])
        zc = (0.5 * (self.zb[1:] + self.zb[:-1])).cpu()
        cos_p, sin_p = _angles(pc.cpu().numpy(), "cosf", "sinf")
        shape = (self.nr, self.nphi, self.nz)
        x = (rc[:, None, None] * cos_p[None, :, None]).expand(shape)
        y = (rc[:, None, None] * sin_p[None, :, None]).expand(shape)
        z = zc[None, None, :].expand(shape)
        return torch.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)],
                           dim=-1).to(self.rb.device)

    def cell_jitter_halfwidths(self) -> np.ndarray:
        h = 0.5 * np.cbrt(np.asarray(self.volumes(), np.float64))
        return np.stack([h, h, h], axis=-1)

    def diagonal(self) -> float:
        rb = self.rb.cpu().numpy().astype(np.float64)
        zb = self.zb.cpu().numpy().astype(np.float64)
        return float(np.hypot(2 * rb[-1], zb[-1] - zb[0]))

    def max_steps(self) -> int:
        return 4 * self.nr + 2 * self.nphi + 2 * self.nz + 10


def make_cylinder3d(r_max: float, z_min: float, z_max: float,
                    nr: int, nphi: int, nz: int,
                    rb=None, zb=None, pb=None) -> Cylinder3DGrid:
    if nphi < 3:
        raise ValueError("Cylinder3D needs >= 3 azimuth bins")
    if rb is None:
        rb = np.linspace(0.0, r_max, nr + 1)
    if pb is None:
        pb = np.linspace(-np.pi, np.pi, nphi + 1)
    if zb is None:
        zb = np.linspace(z_min, z_max, nz + 1)
    rb, pb, zb = (np.asarray(a, np.float32) for a in (rb, pb, zb))
    cos_p, sin_p = _angles(pb, "cosf", "sinf")
    return Cylinder3DGrid(rb=torch.tensor(rb), pb=torch.tensor(pb),
                          zb=torch.tensor(zb), cos_p=cos_p, sin_p=sin_p,
                          shift=length_shift(rb, zb))
