"""Uniform Cartesian spatial grid.

Port of `skirt9_tpu/grids/cartesian.py:205-332` (`UniformCartesianGrid`):
cell linear index m = (ix*ny + iy)*nz + iz, all traversal math arithmetic.
Grids with custom border meshes are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class UniformCartesianGrid(NamedTuple):
    lo: torch.Tensor     # (3,) box minimum [m], f32
    hi: torch.Tensor     # (3,) box maximum [m]
    inv_h: torch.Tensor  # (3,) 1 / cell size
    h: torch.Tensor      # (3,) cell size
    nx: int
    ny: int
    nz: int

    @property
    def shape(self):
        return (self.nx, self.ny, self.nz)

    @property
    def ncells(self) -> int:
        return self.nx * self.ny * self.nz

    def to(self, device) -> "UniformCartesianGrid":
        return self._replace(lo=self.lo.to(device), hi=self.hi.to(device),
                             inv_h=self.inv_h.to(device), h=self.h.to(device))

    def join(self, ix, iy, iz):
        return (ix * self.ny + iy) * self.nz + iz

    def _n(self, device):
        return torch.tensor([self.nx, self.ny, self.nz], dtype=torch.int64,
                            device=device)

    def locate(self, pos: torch.Tensor) -> torch.Tensor:
        """(B, 3) -> (B,) int64 cell index, -1 outside."""
        i = torch.floor((pos - self.lo) * self.inv_h).to(torch.int64)
        n = self._n(pos.device)
        inside = torch.all((i >= 0) & (i < n), dim=-1)
        i = torch.minimum(torch.clamp_min(i, 0), n - 1)
        cell = self.join(i[..., 0], i[..., 1], i[..., 2])
        return torch.where(inside, cell, torch.full_like(cell, -1))

    def move_inside(self, pos: torch.Tensor, dirn: torch.Tensor):
        """Advance packets launched outside the box to its surface.
        Returns (pos', cell', distance); packets missing the box get -1."""
        tiny = torch.abs(dirn) < 1e-30
        inv = 1.0 / torch.where(tiny, torch.full_like(dirn, 1e-30), dirn)
        t1 = (self.lo - pos) * inv
        t2 = (self.hi - pos) * inv
        tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
        tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
        hits = tmax > torch.clamp_min(tmin, 0.0)
        already = self.locate(pos) >= 0
        t_entry = torch.where(already, torch.zeros_like(tmin),
                              torch.clamp_min(tmin, 0.0) * (1.0 + 1e-6))
        newpos = pos + t_entry[..., None] * dirn
        # clamp hi-face entries just inside the box
        eps = 1e-6 * (self.hi - self.lo)
        newpos = torch.where(already[..., None], newpos,
                             torch.clamp(newpos, min=self.lo, max=self.hi - eps))
        cell = self.locate(newpos)
        cell = torch.where(already | hits, cell, torch.full_like(cell, -1))
        return newpos, cell, t_entry

    def cell_centers(self) -> torch.Tensor:
        dev = self.lo.device
        cx = self.lo[0] + (torch.arange(self.nx, device=dev) + 0.5) * self.h[0]
        cy = self.lo[1] + (torch.arange(self.ny, device=dev) + 0.5) * self.h[1]
        cz = self.lo[2] + (torch.arange(self.nz, device=dev) + 0.5) * self.h[2]
        g = torch.stack(torch.meshgrid(cx, cy, cz, indexing="ij"), dim=-1)
        return g.reshape(-1, 3)

    @property
    def xb(self) -> torch.Tensor:
        """(nx + 1,) cell borders along x [m], f32."""
        return self.lo[0] + torch.arange(self.nx + 1,
                                         device=self.lo.device) * self.h[0]

    @property
    def yb(self) -> torch.Tensor:
        return self.lo[1] + torch.arange(self.ny + 1,
                                         device=self.lo.device) * self.h[1]

    @property
    def zb(self) -> torch.Tensor:
        return self.lo[2] + torch.arange(self.nz + 1,
                                         device=self.lo.device) * self.h[2]

    def volumes(self) -> np.ndarray:
        """Cell volumes (ncells,) [m^3], host f64."""
        h = self.h.cpu().numpy().astype(np.float64)
        return np.full(self.ncells, h[0] * h[1] * h[2])

    def cell_bounds(self):
        """Per-cell box corners (lo, hi), (ncells, 3) host f64 each."""
        lo = self.lo.cpu().numpy().astype(np.float64)
        h = self.h.cpu().numpy().astype(np.float64)
        axes = [lo[a] + np.arange(n) * h[a] for a, n in enumerate(self.shape)]
        clo = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
        return clo, clo + h

    def diagonal(self) -> float:
        lo = self.lo.cpu().numpy().astype(np.float64)
        hi = self.hi.cpu().numpy().astype(np.float64)
        return float(np.linalg.norm(hi - lo))

    def max_steps(self) -> int:
        return self.nx + self.ny + self.nz + 3


def make_cartesian(extent, shape, meshes=None, force_general: bool = False):
    """Uniform Cartesian grid over extent ((xmin, xmax), (ymin, ymax),
    (zmin, zmax)) [m] with shape (nx, ny, nz), on the CPU (a Simulation moves
    it to its device)."""
    if meshes is not None or force_general:
        raise NotImplementedError(
            "non-uniform Cartesian meshes (CartesianGrid) are not ported yet")
    lo = np.array([extent[a][0] for a in range(3)], np.float64)
    hi = np.array([extent[a][1] for a in range(3)], np.float64)
    h = (hi - lo) / np.array(shape, np.int64)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32))
    return UniformCartesianGrid(lo=f32(lo), hi=f32(hi), inv_h=f32(1.0 / h),
                                h=f32(h), nx=int(shape[0]), ny=int(shape[1]),
                                nz=int(shape[2]))
