"""Spherical (1D shell) spatial grid with exact ray-sphere traversal.

Port of `skirt9_tpu/grids/sphere.py` (`Sphere1DGrid`, `make_sphere1d`):
concentric shells around the origin, the natural grid of the 1D benchmark
problems (Ivezic et al. 1997). A step solves the ray-sphere quadratics in
closed form: the outer border always, the inner one only where the ray
heads inward (b < 0), r_in > 0 and the discriminant is positive; the
nearer positive crossing wins, the inner one on a tie.

`step`, `locate` and `move_inside` follow the reference's f32 operations
as XLA runs them inside the reference's jitted life cycle, where the
grid's tables are constants: the 3-term dot products and sums of squares
as running fused multiply-adds, each product that feeds a sum fused into
it, the square roots correctly rounded (`ops.xlamath`); so a step lands in
the reference's shell. The march kernel's mode `march_sphere1d`
(`csrc/march.cu`) does the same with `fmaf` and `__fsqrt_rn`.

The squares of radii past ~1.8e19 m (0.6 kpc) overflow f32, and the
reference's steps there give inf and NaN. A grid past 2^60 m keeps a
`shift`: `step`, `locate` and `move_inside` work in lengths times 2^-shift,
which scales every f32 operation exactly, so the results equal the
reference's wherever its squares stay finite, and are finite beyond.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import xlamath as xm

_BIG = 3e38
# the largest border kept unscaled: 2^60 m (37 pc)
_MAX_EXP = 60


def length_shift(*borders) -> int:
    """The power of two k such that lengths times 2^-k keep the largest
    |border| at or below 2^60 m (0 where it already is)."""
    m = max(float(np.abs(np.asarray(b, np.float64)).max()) for b in borders)
    return max(int(np.ceil(np.log2(max(m, 1.0)))) - _MAX_EXP, 0)


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`jnp.sum(a * b, axis=-1)` over (B, 3) as XLA's CPU code forms it in
    a jitted function: a running sum, each product fused into it."""
    return xm.fma_rn(a[:, 2], b[:, 2], xm.fma_rn(a[:, 1], b[:, 1], a[:, 0] * b[:, 0]))


class Sphere1DGrid(NamedTuple):
    rb: torch.Tensor  # (nr+1,) shell border radii [m], f32, rb[0] >= 0
    shift: int = 0    # lengths enter the steps times 2^-shift (exact)

    @property
    def ncells(self) -> int:
        return self.rb.shape[0] - 1

    def to(self, device) -> "Sphere1DGrid":
        return self._replace(rb=self.rb.to(device))

    def _scaled(self, pos):
        """(pos, rb) times 2^-shift."""
        if not self.shift:
            return pos, self.rb
        s = 2.0 ** -self.shift
        return pos * s, self.rb * s

    def locate(self, pos: torch.Tensor) -> torch.Tensor:
        """(B, 3) -> (B,) int64 shell index, -1 outside [rb[0], rb[-1])."""
        pos, rb = self._scaled(pos)
        r = xm.sqrt(dot3(pos, pos))
        i = torch.searchsorted(rb, r.contiguous(), right=True) - 1
        inside = (r >= rb[0]) & (r < rb[-1])
        return torch.where(inside, torch.clamp(i, 0, self.ncells - 1), -1)

    def step(self, pos: torch.Tensor, dirn: torch.Tensor, cell: torch.Tensor):
        """One exact step (the reference's `sphere.py:35-64`): (ds, next
        shell, next position); a lane outside (cell < 0) stays there with
        ds 0, and leaving the grid gives -1."""
        pos_m = pos
        pos, rb = self._scaled(pos)
        i = torch.clamp_min(cell, 0)
        r_in, r_out = rb[i], rb[i + 1]
        b = dot3(pos, dirn)
        p2 = xm.fma_rn(-b, b, dot3(pos, pos))           # impact parameter^2
        t_out = -b + xm.sqrt(torch.clamp_min(xm.fma_rn(r_out, r_out, -p2), 0.0))
        disc_in = xm.fma_rn(r_in, r_in, -p2)
        can_in = (r_in > 0) & (b < 0) & (disc_in > 0)
        t_in = torch.where(can_in, -b - xm.sqrt(torch.clamp_min(disc_in, 0.0)),
                           torch.full_like(b, _BIG))
        t_in = torch.where(t_in > 0, t_in, torch.full_like(b, _BIG))
        inward = t_in < t_out
        ds = torch.where(inward, t_in, t_out)
        nxt = torch.where(inward, i - 1, i + 1)
        nxt = torch.where((nxt < 0) | (nxt >= self.ncells), -1, nxt)
        out = cell < 0
        newpos = xm.fma_rn(ds[:, None], dirn, pos)
        if self.shift:
            ds, newpos = ds * 2.0 ** self.shift, newpos * 2.0 ** self.shift
        return (torch.where(out, torch.zeros_like(ds), ds),
                torch.where(out, -1, nxt),
                torch.where(out[:, None], pos_m, newpos))

    def move_inside(self, pos: torch.Tensor, dirn: torch.Tensor):
        """Advance packets outside to the outer sphere (`sphere.py:66-79`):
        (pos', cell', distance); packets missing it get -1. R^2 is a
        constant of the reference's jitted launch, folded in f32."""
        pos_m = pos
        pos, rb = self._scaled(pos)
        R = rb[-1]
        b = dot3(pos, dirn)
        r2 = dot3(pos, pos)
        RR = R * R
        disc = RR - xm.fma_rn(-b, b, r2)
        hits = (disc > 0) & (b < 0)
        t = torch.where(hits, (-b - xm.sqrt(torch.clamp_min(disc, 0.0)))
                        * xm.f32(1 + 1e-6), torch.zeros_like(b))
        already = r2 < RR
        t = torch.where(already, torch.zeros_like(t), torch.clamp_min(t, 0.0))
        newpos = xm.move_xy_fused(pos, t, dirn)
        if self.shift:
            t, newpos = t * 2.0 ** self.shift, newpos * 2.0 ** self.shift
        cell = torch.where(already | hits, self.locate(newpos), -1)
        return newpos, cell, t

    def volumes(self) -> np.ndarray:
        rb = self.rb.cpu().numpy().astype(np.float64)
        return 4.0 / 3.0 * np.pi * (rb[1:] ** 3 - rb[:-1] ** 3)

    def cell_centers(self) -> torch.Tensor:
        """A representative position per shell: its mid radius on +x."""
        rc = 0.5 * (self.rb[1:] + self.rb[:-1])
        z = torch.zeros_like(rc)
        return torch.stack([rc, z, z], dim=-1)

    def cell_bounds(self):
        """Each shell's bounding cube, as the reference gives it."""
        r = self.rb.cpu().numpy().astype(np.float64)[1:]
        return (np.stack([-r, -r, -r], -1), np.stack([r, r, r], -1))

    def diagonal(self) -> float:
        return float(2 * float(self.rb[-1]))

    def max_steps(self) -> int:
        return 2 * self.ncells + 3


def make_sphere1d(r_max: float, nr: int, r_min: float = 0.0,
                  log: bool = False, rb=None) -> Sphere1DGrid:
    if rb is not None:
        rb = np.asarray(rb, np.float64)
    elif log and r_min > 0:
        rb = np.geomspace(r_min, r_max, nr + 1)
    elif log:
        # the innermost border pinned to 0, log spacing from r_max * 1e-4
        rb = np.concatenate([[0.0], np.geomspace(r_max * 1e-4, r_max, nr)])
    else:
        rb = np.linspace(r_min, r_max, nr + 1)
    rb = rb.astype(np.float32)
    return Sphere1DGrid(rb=torch.tensor(rb), shift=length_shift(rb))
