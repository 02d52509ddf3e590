"""Cartesian spatial grids: uniform, and with per-axis border meshes.

Port of `skirt9_tpu/grids/cartesian.py`: `UniformCartesianGrid`, whose
traversal is all arithmetic, and `CartesianGrid`, whose borders come from a
mesh per axis (`grids/meshes.py`) and which the reference's sweeps do not
take, so that it rides the scan march only (`transport/march.py`). Cell
linear index m = (ix*ny + iy)*nz + iz.

`step` is one DDA step of the scan march: the distance to the cell's exit,
the next cell and the next position with the crossed coordinate snapped
onto the border. It follows the reference's f32 operations one for one,
with XLA's CPU fusion of a product into the sum it feeds replayed by
`ops.xlamath.fma_rn` (rounded once; an ulp there decides which cell a
step lands in), so that the port's march takes the reference's cells on
the CPU; the march kernel (`csrc/march.cu`) does the same with `fmaf`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import xlamath as xm

_BIG = 3e38


def _exit_step(i3, n, border, s, pos, dirn, cell):
    """The common tail of both grids' `step`: the axis of the first exit
    (the lowest on a tie), the distance, the next position with that
    coordinate on the border, and the next cell (-1 past the grid or for a
    lane already outside, whose ds is 0 and position unchanged)."""
    ds, ax = torch.min(s, dim=-1)
    onehot = torch.arange(3, device=pos.device) == ax[:, None]
    newpos = torch.where(onehot, border, xm.fma_rn(ds[:, None], dirn, pos))
    stp = torch.where(dirn >= 0, 1, -1)
    j3 = i3 + torch.where(onehot, stp, 0)
    inside = torch.all((j3 >= 0) & (j3 < n), dim=-1)
    j3 = torch.minimum(torch.clamp_min(j3, 0), n - 1)
    nxt = (j3[:, 0] * n[1] + j3[:, 1]) * n[2] + j3[:, 2]
    out = cell < 0
    return (torch.where(out, torch.zeros_like(ds), ds),
            torch.where(out | ~inside, -1, nxt),
            torch.where(out[:, None], pos, newpos))


def _split(cell, ny: int, nz: int):
    c = torch.clamp_min(cell, 0)
    return torch.stack([c // (ny * nz), (c // nz) % ny, c % nz], dim=-1)


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
        # fused, as XLA's CPU code forms it (bit for bit on every axis)
        newpos = xm.fma_rn(t_entry[..., None], dirn, pos)
        # clamp hi-face entries just inside the box
        eps = 1e-6 * (self.hi - self.lo)
        newpos = torch.where(already[..., None], newpos,
                             torch.clamp(newpos, min=self.lo, max=self.hi - eps))
        cell = self.locate(newpos)
        cell = torch.where(already | hits, cell, torch.full_like(cell, -1))
        return newpos, cell, t_entry

    def step(self, pos: torch.Tensor, dirn: torch.Tensor, cell: torch.Tensor):
        """One DDA step (the reference's `cartesian.py:245-270`): (ds, next
        cell, next position); a lane outside (cell < 0) stays there with ds
        0. The border is lo + index * h, fused."""
        i3 = _split(cell, self.ny, self.nz)
        n = self._n(pos.device)
        nxt_idx = i3 + (dirn > 0).to(i3.dtype)
        border = xm.fma_rn(nxt_idx.to(pos.dtype), self.h, self.lo)
        tiny = torch.abs(dirn) < 1e-30
        s = torch.where(tiny, torch.full_like(pos, _BIG), torch.clamp_min(
            (border - pos) / torch.where(tiny, torch.ones_like(dirn), dirn),
            0.0))
        return _exit_step(i3, n, border, s, pos, dirn, cell)

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


class CartesianGrid(NamedTuple):
    """A Cartesian grid with arbitrary per-axis borders (the reference's
    `cartesian.py:25-167`), f32 border tables."""

    xb: torch.Tensor     # (nx + 1,) x borders [m], f32
    yb: torch.Tensor     # (ny + 1,)
    zb: torch.Tensor     # (nz + 1,)

    @property
    def shape(self) -> tuple:
        return (self.xb.shape[0] - 1, self.yb.shape[0] - 1,
                self.zb.shape[0] - 1)

    @property
    def ncells(self) -> int:
        nx, ny, nz = self.shape
        return nx * ny * nz

    def to(self, device) -> "CartesianGrid":
        return CartesianGrid(*(b.to(device) for b in self))

    def _n(self, device):
        return torch.tensor(self.shape, dtype=torch.int64, device=device)

    def _box(self):
        """(lo, hi) (3,) f32 corners."""
        return (torch.stack([b[0] for b in self]),
                torch.stack([b[-1] for b in self]))

    def locate(self, pos: torch.Tensor) -> torch.Tensor:
        """(B, 3) -> (B,) int64 cell index, -1 outside (a binary search of
        each axis's borders)."""
        n = self._n(pos.device)
        i = torch.stack([torch.searchsorted(b, pos[:, a].contiguous(),
                                            right=True) - 1
                         for a, b in enumerate(self)], dim=-1)
        inside = torch.all((i >= 0) & (i < n), dim=-1)
        i = torch.minimum(torch.clamp_min(i, 0), n - 1)
        cell = (i[:, 0] * n[1] + i[:, 1]) * n[2] + i[:, 2]
        return torch.where(inside, cell, torch.full_like(cell, -1))

    def step(self, pos: torch.Tensor, dirn: torch.Tensor, cell: torch.Tensor):
        """One DDA step (the reference's `cartesian.py:67-119`): the next
        border of each axis from the tables, (ds, next cell, next
        position); a lane outside (cell < 0) stays there with ds 0."""
        nx, ny, nz = self.shape
        i3 = _split(cell, ny, nz)
        n = self._n(pos.device)
        up = dirn > 0
        border = torch.stack([
            torch.where(up[:, a], b[torch.clamp(i3[:, a] + 1, 0, na)],
                        b[torch.clamp(i3[:, a], 0, na)])
            for a, (b, na) in enumerate(zip(self, self.shape))], dim=-1)
        tiny = torch.abs(dirn) < 1e-30
        s = (border - pos) / torch.where(tiny, torch.ones_like(dirn), dirn)
        s = torch.clamp_min(torch.where(tiny, torch.full_like(s, _BIG), s),
                            0.0)
        return _exit_step(i3, n, border, s, pos, dirn, cell)

    def move_inside(self, pos: torch.Tensor, dirn: torch.Tensor):
        """Advance packets launched outside the box to its surface (the
        reference's `cartesian.py:121-146`). Returns (pos', cell',
        distance); packets missing the box get -1."""
        lo, hi = self._box()
        tiny = torch.abs(dirn) < 1e-30
        inv = 1.0 / torch.where(tiny, torch.full_like(dirn, 1e-30), dirn)
        t1 = (lo - pos) * inv
        t2 = (hi - pos) * inv
        tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
        tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
        hits = tmax > torch.clamp_min(tmin, 0.0)
        already = self.locate(pos) >= 0
        t_entry = torch.where(already, torch.zeros_like(tmin),
                              torch.clamp_min(tmin, 0.0) * (1.0 + 1e-6))
        # fused, as XLA's CPU code forms it (bit for bit on every axis)
        newpos = xm.fma_rn(t_entry[..., None], dirn, pos)
        # rays entering exactly on the hi face would locate outside: clamp
        # entries just inside the box
        eps = 1e-6 * (hi - lo)
        newpos = torch.where(already[..., None], newpos,
                             torch.clamp(newpos, min=lo, max=hi - eps))
        cell = self.locate(newpos)
        cell = torch.where(already | hits, cell, torch.full_like(cell, -1))
        return newpos, cell, t_entry

    def volumes(self) -> np.ndarray:
        """Cell volumes (ncells,) [m^3], host f64 (parsec-scale cells
        overflow f32)."""
        dx, dy, dz = (np.diff(b.cpu().numpy().astype(np.float64))
                      for b in self)
        return (dx[:, None, None] * dy[None, :, None]
                * dz[None, None, :]).reshape(-1)

    def cell_centers(self) -> torch.Tensor:
        """(ncells, 3) f32 cell centres, the borders' midpoints."""
        c = [0.5 * (b[1:] + b[:-1]) for b in self]
        return torch.stack(torch.meshgrid(*c, indexing="ij"),
                           dim=-1).reshape(-1, 3)

    def cell_bounds(self):
        """Per-cell box corners (lo, hi), (ncells, 3) host f64 each."""
        b = [x.cpu().numpy().astype(np.float64) for x in self]
        corners = lambda sl: np.stack(np.meshgrid(
            *(x[sl] for x in b), indexing="ij"), axis=-1).reshape(-1, 3)
        return corners(slice(None, -1)), corners(slice(1, None))

    def diagonal(self) -> float:
        """The box diagonal in f32, as the reference forms it from its f32
        borders (`cartesian.py:157-162`): rf_scale, and with it every stored
        RF, is then the reference's."""
        d2 = [(b[-1] - b[0]).cpu() ** 2 for b in self]
        return float(torch.sqrt(((d2[0] + d2[1]) + d2[2]).double()).float())

    def max_steps(self) -> int:
        """An upper bound on the cells one straight path crosses."""
        return sum(self.shape) + 3


def make_cartesian(extent, shape, meshes=None, force_general: bool = False):
    """A Cartesian grid over extent ((xmin, xmax), (ymin, ymax), (zmin,
    zmax)) [m] with shape (nx, ny, nz), on the CPU (a Simulation moves it to
    its device): uniform without meshes, else a `CartesianGrid` whose axes
    take the given border arrays (None: linear spacing), as the reference's
    `cartesian.py:171-200` builds it."""
    if meshes is not None or force_general:
        borders = []
        for a in range(3):
            if meshes is not None and meshes[a] is not None:
                b = np.asarray(meshes[a], np.float64)
            else:
                b = np.linspace(extent[a][0], extent[a][1], shape[a] + 1)
            borders.append(torch.tensor(b.astype(np.float32)))
        return CartesianGrid(*borders)
    lo = np.array([extent[a][0] for a in range(3)], np.float64)
    hi = np.array([extent[a][1] for a in range(3)], np.float64)
    h = (hi - lo) / np.array(shape, np.int64)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32))
    return UniformCartesianGrid(lo=f32(lo), hi=f32(hi), inv_h=f32(1.0 / h),
                                h=f32(h), nx=int(shape[0]), ny=int(shape[1]),
                                nz=int(shape[2]))
