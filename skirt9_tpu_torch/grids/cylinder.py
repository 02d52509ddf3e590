"""2D cylindrical (R, z) spatial grid with closed-form traversal.

Port of `skirt9_tpu/grids/cylinder.py` (`Cylinder2DGrid`,
`make_cylinder2d`): annular cells [R_i, R_i+1] x [z_j, z_j+1], the natural
grid of axisymmetric disks (the Pascucci et al. 2004 benchmark), cell index
m = ir * nz + iz. A step solves the ray-cylinder quadratic of the outer
border, and of the inner one where the ray heads inward (b < 0), r_in > 0
and the discriminant is positive, beside the z-plane crossing; the least
wins, on a tie the inner cylinder, then the outer, then the plane.

`step`, `locate` and `move_inside` follow the reference's f32 operations
as XLA runs them inside the reference's jitted life cycle, where the
grid's tables are constants (products fused into the sums they feed, the
divisions and square roots correctly rounded, `jnp.hypot`'s own form:
`ops.xlamath`), so that a step lands in the reference's cell; the march
kernel's mode `march_cylinder2d` (`csrc/march.cu`) does the same. As on
the 1D sphere (`grids/sphere.py`), a grid past 2^60 m works in lengths
times 2^-shift, exactly, where the reference's squares overflow f32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import xlamath as xm
from .sphere import length_shift

_BIG = 3e38


class Cylinder2DGrid(NamedTuple):
    rb: torch.Tensor  # (nr+1,) cylindrical radius borders [m], f32, rb[0] >= 0
    zb: torch.Tensor  # (nz+1,) z borders [m], f32
    shift: int = 0    # lengths enter the steps times 2^-shift (exact)

    @property
    def nr(self) -> int:
        return self.rb.shape[0] - 1

    @property
    def nz(self) -> int:
        return self.zb.shape[0] - 1

    @property
    def ncells(self) -> int:
        return self.nr * self.nz

    def to(self, device) -> "Cylinder2DGrid":
        return self._replace(rb=self.rb.to(device), zb=self.zb.to(device))

    def _scaled(self, pos):
        """(pos, rb, zb) times 2^-shift."""
        if not self.shift:
            return pos, self.rb, self.zb
        s = 2.0 ** -self.shift
        return pos * s, self.rb * s, self.zb * s

    def locate(self, pos: torch.Tensor) -> torch.Tensor:
        """(B, 3) -> (B,) int64 cell index, -1 outside."""
        pos, rb, zb = self._scaled(pos)
        R = xm.hypot(pos[:, 0], pos[:, 1], xm.fma_rn)
        ir = torch.searchsorted(rb, R.contiguous(), right=True) - 1
        iz = torch.searchsorted(zb, pos[:, 2].contiguous(), right=True) - 1
        inside = ((R >= rb[0]) & (R < rb[-1])
                  & (iz >= 0) & (iz < self.nz))
        cell = torch.clamp(ir, 0, self.nr - 1) * self.nz \
            + torch.clamp(iz, 0, self.nz - 1)
        return torch.where(inside, cell, -1)

    def step(self, pos: torch.Tensor, dirn: torch.Tensor, cell: torch.Tensor):
        """One exact step (the reference's `cylinder.py:53-100`): (ds, next
        cell, next position); a lane outside (cell < 0) stays there with
        ds 0, and leaving the grid gives -1."""
        pos_m = pos
        pos, rb, zb = self._scaled(pos)
        c = torch.clamp_min(cell, 0)
        ir, iz = c // self.nz, c % self.nz
        x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
        dx, dy, dz = dirn[:, 0], dirn[:, 1], dirn[:, 2]
        big = torch.full_like(x, _BIG)
        # the 2-term sums as XLA fuses them: the first product into the sum
        q = xm.fma_rn(dx, dx, dy * dy)            # in-plane direction norm^2
        b = xm.fma_rn(x, dx, y * dy)              # in-plane projection
        R2 = xm.fma_rn(x, x, y * y)
        r_in, r_out = rb[ir], rb[ir + 1]
        safe_q = torch.clamp_min(q, xm.f32(1e-30))
        disc_out = torch.clamp_min(
            xm.fma_rn(b, b, safe_q * xm.fma_rn(r_out, r_out, -R2)), 0.0)
        t_out = (xm.sqrt(disc_out) - b) / safe_q
        t_out = torch.where(q > xm.f32(1e-30), torch.clamp_min(t_out, 0.0),
                            big)
        disc_in = xm.fma_rn(b, b, safe_q * xm.fma_rn(r_in, r_in, -R2))
        can_in = (r_in > 0) & (b < 0) & (disc_in > 0)
        t_in = torch.where(can_in & (q > xm.f32(1e-30)),
                           (-b - xm.sqrt(torch.clamp_min(disc_in, 0.0)))
                           / safe_q, big)
        t_in = torch.where(t_in > 0, t_in, big)
        up = dz > 0
        z_tgt = torch.where(up, zb[iz + 1], zb[iz])
        flat = torch.abs(dz) < xm.f32(1e-30)
        t_z = torch.where(flat, big, torch.clamp_min(
            (z_tgt - z) / torch.where(flat, torch.ones_like(dz), dz), 0.0))
        ds = torch.minimum(torch.minimum(t_out, t_in), t_z)
        hit_rin = ds == t_in
        hit_rout = (ds == t_out) & ~hit_rin
        hit_z = ~hit_rin & ~hit_rout
        jr = ir + hit_rout.long() - hit_rin.long()
        jz = iz + torch.where(hit_z, torch.where(up, 1, -1), 0)
        inside = (jr >= 0) & (jr < self.nr) & (jz >= 0) & (jz < self.nz)
        nxt = torch.clamp(jr, 0, self.nr - 1) * self.nz \
            + torch.clamp(jz, 0, self.nz - 1)
        out = cell < 0
        newpos = xm.fma_rn(ds[:, None], dirn, pos)
        if self.shift:
            ds, newpos = ds * 2.0 ** self.shift, newpos * 2.0 ** self.shift
        return (torch.where(out, torch.zeros_like(ds), ds),
                torch.where(out | ~inside, -1, nxt),
                torch.where(out[:, None], pos_m, newpos))

    def move_inside(self, pos: torch.Tensor, dirn: torch.Tensor):
        """Advance packets outside to the bounding cylinder
        (`cylinder.py:102-122`): the later of the cylinder's and the
        z-slab's entries, 1e-6 beyond; (pos', cell', distance)."""
        pos_m = pos
        pos, rb, zb = self._scaled(pos)
        R_out = rb[-1]
        x, y = pos[:, 0], pos[:, 1]
        dx, dy, dz = dirn[:, 0], dirn[:, 1], dirn[:, 2]
        q = torch.clamp_min(xm.fma_rn(dx, dx, dy * dy), xm.f32(1e-30))
        b = xm.fma_rn(x, dx, y * dy)
        # R_out^2 is a constant of the jitted launch, folded in f32; here
        # XLA does not fuse x^2 into R^2
        disc = xm.fma_rn(b, b, q * (R_out * R_out - (x * x + y * y)))
        t_cyl = torch.where(disc > 0, (-b - xm.sqrt(torch.clamp_min(
            disc, 0.0))) / q, torch.full_like(b, _BIG))
        dzs = torch.where(torch.abs(dz) < xm.f32(1e-30),
                          torch.full_like(dz, xm.f32(1e-30)), dz)
        t_z1 = (zb[0] - pos[:, 2]) / dzs
        t_z2 = (zb[-1] - pos[:, 2]) / dzs
        t_slab = torch.minimum(t_z1, t_z2)
        t_entry = torch.clamp_min(torch.maximum(t_cyl, t_slab), 0.0) \
            * xm.f32(1 + 1e-6)
        already = self.locate(pos_m) >= 0
        t_entry = torch.where(already, torch.zeros_like(t_entry), t_entry)
        if self.shift:
            # back in metres (exact), but a miss's sentinel distance (3e38)
            # stays what it is in the reference's metres
            t_entry = torch.where(t_entry >= _BIG, t_entry,
                                  t_entry * 2.0 ** self.shift)
        newpos = xm.move_xy_fused(pos_m, t_entry, dirn)
        return newpos, self.locate(newpos), t_entry

    def volumes(self) -> np.ndarray:
        rb = self.rb.cpu().numpy().astype(np.float64)
        zb = self.zb.cpu().numpy().astype(np.float64)
        ring = np.pi * (rb[1:] ** 2 - rb[:-1] ** 2)
        return (ring[:, None] * np.diff(zb)[None, :]).reshape(-1)

    def cell_centers(self) -> torch.Tensor:
        """A representative position per cell: its mid R on +x, mid z."""
        rc = 0.5 * (self.rb[1:] + self.rb[:-1])
        zc = 0.5 * (self.zb[1:] + self.zb[:-1])
        R, Z = torch.meshgrid(rc, zc, indexing="ij")
        return torch.stack([R.reshape(-1), torch.zeros_like(R).reshape(-1),
                            Z.reshape(-1)], dim=-1)

    def cell_jitter_halfwidths(self) -> np.ndarray:
        """Per-cell half extents (dR/2, dR/2, dz/2) for the density
        quadrature: an annular cell is thin in (R, z) but wide in azimuth,
        so the isotropic cube-root-of-volume jitter would sample far
        outside it."""
        dr = np.diff(self.rb.cpu().numpy().astype(np.float64))
        dz = np.diff(self.zb.cpu().numpy().astype(np.float64))
        hr = np.repeat(dr, self.nz) * 0.5
        hz = np.tile(dz, self.nr) * 0.5
        return np.stack([hr, hr, hz], axis=-1)

    def diagonal(self) -> float:
        rb = self.rb.cpu().numpy().astype(np.float64)
        zb = self.zb.cpu().numpy().astype(np.float64)
        return float(np.hypot(2 * rb[-1], zb[-1] - zb[0]))

    def max_steps(self) -> int:
        return 4 * self.nr + 2 * self.nz + 5


def make_cylinder2d(r_max: float, z_min: float, z_max: float,
                    nr: int, nz: int, log_r: bool = False,
                    r_min: float = 0.0, rb=None, zb=None) -> Cylinder2DGrid:
    if rb is not None:
        rb = np.asarray(rb, np.float64)
    elif log_r:
        rb = np.concatenate([[0.0], np.geomspace(max(r_min, r_max * 1e-4),
                                                 r_max, nr)])
    else:
        rb = np.linspace(r_min, r_max, nr + 1)
    if zb is None:
        zb = np.linspace(z_min, z_max, nz + 1)
    rb, zb = np.asarray(rb, np.float32), np.asarray(zb, np.float32)
    return Cylinder2DGrid(rb=torch.tensor(rb), zb=torch.tensor(zb),
                          shift=length_shift(rb, zb))
