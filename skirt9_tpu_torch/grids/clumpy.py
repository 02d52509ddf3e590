"""The clumpy spherical grid: a 3D spherical grid with spherical clump
cells superposed.

Port of `skirt9_tpu/grids/clumpy.py` (ref: SKIRT/core/
ClumpySphericalSpatialGrid.hpp:67): cells 0..Nc-1 are the clumps (imported
centres and radii, kept where they lie wholly inside the shell and overlap
no clump kept before them), cells Nc.. the (r, theta, phi) cells of the
`Sphere3DGrid` beneath, their volumes reduced by the clumps' overlaps,
estimated by Monte Carlo at set-up as the reference does. `locate` tests
the clumps first; a step is the sphere's step cut at the first clump entry
ahead, or, inside a clump, its far crossing, then the relocation at
pos + (ds + eta) dirn, eta = 1e-6 of the outer radius.

Every f32 operation follows the reference's step as XLA fuses it inside
its jitted march (`lifecycle.march_geometry`): the (B, Nc) products
rel . dirn and rel . rel as running sums with each product fused
(`ops.xlamath.fma_rn`), b^2 - c0 one fused multiply-add, and the moves
pos + ds dirn fused; the march kernel's mode `march_clumpy`
(`csrc/march.cu`) does the same with fmaf. A grid past 2^60 m keeps the
sphere's power-of-two `shift`: its clumps enter the steps scaled with the
borders, exactly, where the reference's squares overflow f32 (past ~0.6
kpc). The clump tests run in chunks of 1,024 clumps, which bounds the
(B, Nc) temporaries of a grid with more.

The reference's clumpy grid has no cell bounds, so its dust emission fails
on it; the port's raises NotImplementedError (`sources/secondary.
cell_bounds`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import xlamath as xm
from .polar import Sphere3DGrid, dot3, make_sphere3d

_BIG = 1e30
_CHUNK = 1024
fma = xm.fma_rn


class _ClumpyTables(NamedTuple):
    sph: Sphere3DGrid     # the structured (r, theta, phi) grid
    ccen: torch.Tensor    # (Nc, 3) clump centres [m], f32
    crad: torch.Tensor    # (Nc,) clump radii [m], f32
    vols: torch.Tensor    # (ncells,) f64 volumes: clumps, then the sphere's


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`jnp.sum(a * b, axis=-1)` over (..., 3), each product fused into the
    running sum."""
    return fma(a[..., 2], b[..., 2], fma(a[..., 1], b[..., 1],
                                         a[..., 0] * b[..., 0]))


class ClumpySphericalGrid(_ClumpyTables):
    """A `Sphere3DGrid` plus Nc clump spheres (ref:
    ClumpySphericalSpatialGrid), clump cells first."""

    __slots__ = ()

    @property
    def n_clumps(self) -> int:
        return self.crad.shape[0]

    @property
    def ncells(self) -> int:
        return self.n_clumps + self.sph.ncells

    @property
    def shift(self) -> int:
        return self.sph.shift

    def to(self, device) -> "ClumpySphericalGrid":
        return self._replace(sph=self.sph.to(device),
                             ccen=self.ccen.to(device),
                             crad=self.crad.to(device))

    def _scaled(self):
        """(rb, ccen, crad) times 2^-shift."""
        return self.sph._scale(self.sph.rb, self.ccen, self.crad)

    def _clump_of(self, pos, ccen, crad) -> torch.Tensor:
        """The lowest-numbered clump holding each (scaled) position, -1 for
        none (the reference's argmax over d^2 <= r^2)."""
        out = torch.full(pos.shape[:1], -1, dtype=torch.int64,
                         device=pos.device)
        for k in range(0, self.n_clumps, _CHUNK):
            rel = pos[:, None, :] - ccen[None, k:k + _CHUNK]
            r = crad[k:k + _CHUNK]
            inside = _dot(rel, rel) <= r * r
            hit = inside.any(dim=1)
            first = k + torch.argmax(inside.to(torch.uint8), dim=1)
            out = torch.where((out < 0) & hit, first, out)
        return out

    def _locate_scaled(self, pos, rb, ccen, crad) -> torch.Tensor:
        c = self._clump_of(pos, ccen, crad)
        s = self.sph._locate_scaled(pos)
        out = torch.where(c >= 0, c, s + self.n_clumps)
        return torch.where(s >= 0, out, -1)

    def locate(self, pos: torch.Tensor) -> torch.Tensor:
        """(B, 3) -> (B,) int64 cell index, -1 outside the sphere."""
        rb, ccen, crad = self._scaled()
        (pos,) = self.sph._scale(pos)
        return self._locate_scaled(pos, rb, ccen, crad)

    @staticmethod
    def _crossings(pos, dirn, ccen, crad):
        """(t0, t1): the entry and exit distances of each lane's ray through
        each clump given (ccen (1 or B, n, 3), crad (1 or B, n)), (B, n),
        _BIG where it misses."""
        rel = pos[:, None, :] - ccen
        b = _dot(rel, dirn[:, None, :])
        c0 = _dot(rel, rel) - crad * crad
        disc = fma(b, b, -c0)
        sq = xm.sqrt(torch.clamp_min(disc, 0.0))
        miss = disc <= 0
        big = torch.full_like(b, _BIG)
        return (torch.where(miss, big, -b - sq),
                torch.where(miss, big, -b + sq))

    def step(self, pos: torch.Tensor, dirn: torch.Tensor, cell: torch.Tensor):
        """One step (the reference's `clumpy.py:80-97`): (ds, next cell,
        next position); a lane outside (cell < 0) stays there with ds 0,
        and leaving the grid gives -1."""
        sph, nc = self.sph, self.n_clumps
        pos_m = pos
        rb, ccen, crad = self._scaled()
        (pos,) = sph._scale(pos)
        eta = rb[-1] * xm.f32(1e-6)
        scell = sph._locate_scaled(pos)
        ds_sph = sph.step_length(pos, dirn, scell, rb, eta)
        ds_sph = torch.where(scell < 0, torch.zeros_like(ds_sph), ds_sph)
        # the structured cell's step, cut at the first clump entry ahead
        t_entry = torch.full_like(ds_sph, _BIG)
        for k in range(0, nc, _CHUNK):
            t0, _ = self._crossings(pos, dirn, ccen[None, k:k + _CHUNK],
                                    crad[None, k:k + _CHUNK])
            t0 = torch.where(t0 > eta, t0, torch.full_like(t0, _BIG))
            t_entry = torch.minimum(t_entry, t0.min(dim=1).values)
        ds_struct = torch.minimum(ds_sph, t_entry)
        # a clump cell: out through the clump's far crossing
        in_clump = (cell >= 0) & (cell < nc)
        ci = torch.clamp(cell, 0, max(nc - 1, 0))
        if nc:
            t_exit = self._crossings(pos, dirn, ccen[ci][:, None],
                                     crad[ci][:, None])[1][:, 0]
        else:
            t_exit = torch.zeros_like(ds_sph)
        ds = torch.where(in_clump, torch.clamp_min(t_exit, 0.0), ds_struct)
        nxt = self._locate_scaled(fma((ds + eta)[:, None], dirn, pos), rb,
                                  ccen, crad)
        newpos = fma(ds[:, None], dirn, pos)
        ds = sph._unscale(ds)
        if self.shift:
            newpos = newpos * 2.0 ** self.shift
        out = cell < 0
        return (torch.where(out, torch.zeros_like(ds), ds),
                torch.where(out, -1, nxt),
                torch.where(out[:, None], pos_m, newpos))

    def move_inside(self, pos: torch.Tensor, dirn: torch.Tensor):
        """The sphere's `move_inside`, located among the clumps too."""
        newpos, _, t = self.sph.move_inside(pos, dirn)
        return newpos, self.locate(newpos), t

    def volumes(self) -> np.ndarray:
        return self.vols.cpu().numpy()

    def cell_centers(self) -> torch.Tensor:
        return torch.cat([self.ccen, self.sph.cell_centers().to(
            self.ccen.device)])

    def cell_jitter_halfwidths(self) -> np.ndarray:
        h = 0.5 * np.cbrt(np.maximum(self.volumes(), 0.0))
        return np.stack([h, h, h], axis=-1)

    def diagonal(self) -> float:
        return float(2 * float(self.sph.rb[-1]))

    def max_steps(self) -> int:
        return self.sph.max_steps() + 2 * max(self.n_clumps, 1)


def retained_clumps(cen: np.ndarray, rad: np.ndarray, r_min: float,
                    r_max: float) -> np.ndarray:
    """The indices of the clumps kept, in file order (ref:
    ClumpySphericalSpatialGrid setupSelfAfter): wholly inside the shell
    [r_min, r_max], and overlapping no clump kept before (centres at least
    r_i + r_j apart; touching clumps are kept)."""
    r_c = np.linalg.norm(cen, axis=1)
    fits = ~((r_c + rad > r_max) | (r_c - rad < r_min))
    keep = []
    for i in np.nonzero(fits)[0]:
        if keep:
            k = np.asarray(keep)
            if (np.linalg.norm(cen[i] - cen[k], axis=1)
                    < rad[i] + rad[k]).any():
                continue
        keep.append(i)
    return np.asarray(keep, np.int64)


def make_clumpy_spherical(r_max: float, nr: int, nt: int, nphi: int,
                          clump_centers, clump_radii, r_min: float = 0.0,
                          rb=None, tb=None, overlap_samples: int = 20000,
                          seed: int = 23, device="cpu"
                          ) -> ClumpySphericalGrid:
    """Build the grid as the reference's `make_clumpy_spherical` does: the
    retained clumps (`retained_clumps`), then the structured cells'
    volumes less the share of each clump's volume that falls in them, from
    `overlap_samples` uniform points in each clump (numpy's generator
    seeded with `seed`, drawn clump after clump as the reference draws
    them) located by the sphere's f32 `locate` on `device` (bit for bit
    the reference's on any device; a thousand clumps are 2 x 10^7 points),
    and subtracted clump after clump in f64. The grid is returned on the
    CPU."""
    sph = make_sphere3d(r_max, nr, nt, nphi, r_min=r_min, rb=rb, tb=tb)
    cen = np.asarray(clump_centers, np.float64).reshape(-1, 3)
    rad = np.asarray(clump_radii, np.float64).reshape(-1)
    keep = retained_clumps(cen, rad, r_min, r_max)
    cen, rad = cen[keep], rad[keep]
    v_clump = 4.0 / 3.0 * np.pi * rad ** 3
    v_struct = np.asarray(sph.volumes(), np.float64)
    if len(rad):
        rs = np.random.default_rng(seed)
        pts = np.empty((len(rad), overlap_samples, 3), np.float32)
        for i in range(len(rad)):
            u = rs.normal(size=(overlap_samples, 3))
            u /= np.linalg.norm(u, axis=-1, keepdims=True)
            rr = rad[i] * rs.uniform(size=overlap_samples) ** (1.0 / 3.0)
            pts[i] = cen[i] + rr[:, None] * u
        on = sph.to(device)
        flat = pts.reshape(-1, 3)
        step = 1 << 21
        cells = np.concatenate([
            on.locate(torch.from_numpy(flat[k:k + step]).to(device)).cpu()
            .numpy() for k in range(0, len(flat), step)]).reshape(
                len(rad), overlap_samples)
        for i in range(len(rad)):
            m = cells[i] >= 0
            frac = np.bincount(cells[i][m], minlength=sph.ncells) \
                / overlap_samples
            v_struct = v_struct - frac * v_clump[i]
    v_struct = np.maximum(v_struct, 0.0)
    return ClumpySphericalGrid(
        sph=sph, ccen=torch.tensor(cen.astype(np.float32)).reshape(-1, 3),
        crad=torch.tensor(rad.astype(np.float32)),
        vols=torch.tensor(np.concatenate([v_clump, v_struct])))
