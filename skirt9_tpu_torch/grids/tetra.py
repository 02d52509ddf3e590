"""Tetrahedral spatial grid: scipy Delaunay host build, face-plane walk.

Port of `skirt9_tpu/grids/tetra.py` (ref: SKIRT/core/TetraMeshSpatialGrid.
cpp:388-407, TetGen's Delaunay build): the Delaunay tetrahedralization of
the eight box corners plus the sites (scipy/Qhull), so its convex hull is
the domain box and every interior point lies in one tetrahedron. Each
tetrahedron keeps its four outward unit face normals and plane offsets (in
f64 on the host, cast to f32) and the neighbour across each face (Qhull's
neighbour array, -1 at the hull).

`locate` takes a coarse lookup table's guess and walks along the most
violated face plane, `walk_steps` times at most; a point inside its cell
stays put, so the walk ends early once no lane moves. `step` leaves
through the nearest outgoing face to the neighbour across it, moved on by
ds (1 + 1e-6). Both follow the reference's f32 operations as XLA runs
them (the face-plane dot products as running fused multiply-adds), so a
walk and a march land in the reference's cells; the march kernel's mode
`march_tetra` (`csrc/march.cu`) does the same on the card. Volumes are
exact (|det| / 6).

The reference's tetrahedral grid has no cell bounds, so its dust emission
fails on it; the port's raises NotImplementedError (`sources/
secondary.cell_bounds`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import xlamath as xm

_BIG = 3e38


def _dot3(a, b):
    """Dot products over the last axis of size 3 as XLA's CPU reduction
    forms them: each product fused into the running sum, rounded once as
    the march kernel's fmaf rounds it (`xlamath.fma_rn`)."""
    return xm.fma_rn(a[..., 2], b[..., 2],
                     xm.fma_rn(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


class TetraGrid(NamedTuple):
    face_n: torch.Tensor     # (N, 4, 3) f32 outward unit face normals
    face_d: torch.Tensor     # (N, 4) f32 plane offsets: n.x + d <= 0 inside
    neighbors: torch.Tensor  # (N, 4) int32 neighbour across each face (-1)
    centroids: torch.Tensor  # (N, 3) f32
    box_lo: torch.Tensor     # (3,) f32
    box_hi: torch.Tensor     # (3,) f32
    lookup: torch.Tensor     # (G, G, G) int32 candidate cell per voxel
    vol_frac: torch.Tensor   # (N,) f32 exact volumes / box volume
    walk_steps: int

    @property
    def ncells(self) -> int:
        return self.face_n.shape[0]

    def to(self, device) -> "TetraGrid":
        return self._replace(**{
            name: value.to(device) for name, value in zip(self._fields, self)
            if isinstance(value, torch.Tensor)})

    # ---------------------------------------------------------------- locate

    def _guess(self, pos: torch.Tensor) -> torch.Tensor:
        G = self.lookup.shape[0]
        rel = (pos - self.box_lo) / (self.box_hi - self.box_lo)
        ig = torch.clamp((rel * G).to(torch.int32), 0, G - 1).long()
        return self.lookup[ig[:, 0], ig[:, 1], ig[:, 2]].long()

    def _signed(self, cell: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """(B, 4) signed distances to the cell's face planes (<= 0 inside)."""
        return _dot3(self.face_n[cell], pos[:, None, :]) + self.face_d[cell]

    def tolerance(self) -> float:
        """The walk's tolerance, 1e-7 of the box's largest edge (f32)."""
        span = (self.box_hi - self.box_lo).max()
        return xm.f32(float(span * xm.f32(1e-7)))

    def walk(self, pos: torch.Tensor, cell: torch.Tensor) -> torch.Tensor:
        """walk_steps moves across the most violated face plane (beyond the
        tolerance) from cell, ending early once no lane moves: a lane that
        stays stays for good (the reference's scan of `walk`)."""
        tol = self.tolerance()
        nbrs = self.neighbors.long()
        for _ in range(self.walk_steps):
            s = self._signed(cell, pos)
            worst = torch.argmax(s, dim=-1)
            val = s.gather(1, worst[:, None])[:, 0]
            nxt = nbrs[cell].gather(1, worst[:, None])[:, 0]
            move = (val > tol) & (nxt >= 0)
            if not bool(move.any()):
                break
            cell = torch.where(move, nxt, cell)
        return cell

    def locate(self, pos: torch.Tensor) -> torch.Tensor:
        """(B, 3) -> (B,) int64 containing tetrahedron, -1 outside the box
        (the reference's `tetra.py:62-80`)."""
        inside = torch.all((pos >= self.box_lo) & (pos < self.box_hi), dim=-1)
        cell = self.walk(pos, self._guess(pos))
        return torch.where(inside, cell, -1)

    # --------------------------------------------------------------- traversal

    def step(self, pos: torch.Tensor, dirn: torch.Tensor, cell: torch.Tensor):
        """Leave the tetrahedron through the nearest outgoing face (the
        reference's `tetra.py:84-105`): (ds, the neighbour across it, the
        position moved on by ds (1 + 1e-6)); a lane outside (cell < 0)
        stays there with ds 0, and leaving through the hull gives -1."""
        c = torch.clamp_min(cell, 0)
        n = self.face_n[c]                               # (B, 4, 3)
        dn = _dot3(dirn[:, None, :], n)
        s = _dot3(n, pos[:, None, :]) + self.face_d[c]
        t = -s / torch.where(torch.abs(dn) < xm.f32(1e-30),
                             torch.ones_like(dn), dn)
        t = torch.where(dn > 0, torch.clamp_min(t, 0.0),
                        torch.full_like(t, _BIG))
        j = torch.argmin(t, dim=-1)
        ds = t.gather(1, j[:, None])[:, 0]
        nxt = self.neighbors[c].long().gather(1, j[:, None])[:, 0]
        newpos = xm.fma_rn((ds * xm.f32(1.0 + 1e-6))[:, None], dirn, pos)
        out = cell < 0
        return (torch.where(out, torch.zeros_like(ds), ds),
                torch.where(out, -1, nxt),
                torch.where(out[:, None], pos, newpos))

    def move_inside(self, pos: torch.Tensor, dirn: torch.Tensor):
        """Advance packets launched outside the box to its surface (the
        reference's `tetra.py:107-118`): (pos', cell' int64, distance)."""
        tiny = torch.abs(dirn) < xm.f32(1e-30)
        inv = xm.rdiv(1.0, torch.where(tiny, torch.full_like(dirn, 1e-30),
                                       dirn))
        t1 = (self.box_lo - pos) * inv
        t2 = (self.box_hi - pos) * inv
        tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
        tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
        hits = tmax > torch.clamp_min(tmin, 0.0)
        already = torch.all((pos >= self.box_lo) & (pos < self.box_hi),
                            dim=-1)
        t_entry = torch.where(already, torch.zeros_like(tmin),
                              torch.clamp_min(tmin, 0.0) * xm.f32(1 + 1e-6))
        newpos = xm.move_xy_fused(pos, t_entry, dirn)
        cell = torch.where(already | hits, self.locate(newpos), -1)
        return newpos, cell, t_entry

    # ------------------------------------------------------------------ misc

    def _box(self) -> tuple:
        return (self.box_lo.cpu().numpy().astype(np.float64),
                self.box_hi.cpu().numpy().astype(np.float64))

    def volumes(self) -> np.ndarray:
        """Cell volumes [m^3], host f64."""
        lo, hi = self._box()
        return self.vol_frac.cpu().numpy().astype(np.float64) \
            * np.prod(hi - lo)

    def cell_centers(self) -> torch.Tensor:
        return self.centroids

    def diagonal(self) -> float:
        lo, hi = self._box()
        return float(np.linalg.norm(hi - lo))

    def max_steps(self) -> int:
        return int(6 * np.ceil(self.ncells ** (1 / 3))) + 16


def build_tetra(sites: np.ndarray, extent, lookup_res: int = 32,
                walk_steps: int | None = None) -> TetraGrid:
    """Host build (the reference's `tetra.py:126-207`): the Delaunay
    tetrahedralization of the box corners and the sites (N, 3) in
    box-normalized coordinates, each tetrahedron's face planes in f64
    (the normal of the face opposite vertex k, oriented away from it),
    exact volumes, centroids, and the lookup of the tetrahedron holding
    each of G^3 voxel centres (scipy's find_simplex; the nearest centroid
    where none does). CPU tensors."""
    from scipy.spatial import Delaunay

    lo = np.array([extent[a][0] for a in range(3)], np.float64)
    hi = np.array([extent[a][1] for a in range(3)], np.float64)
    corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                        for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])
    pts = np.vstack([corners, np.asarray(sites, np.float64)])
    span = hi - lo
    tri = Delaunay((pts - lo) / span)
    simp = tri.simplices
    verts = tri.points[simp] * span + lo                  # (N, 4, 3)
    n_t = len(simp)
    face_n = np.zeros((n_t, 4, 3))
    face_d = np.zeros((n_t, 4))
    for k in range(4):
        idx = [a for a in range(4) if a != k]
        v1, v2, v3 = verts[:, idx[0]], verts[:, idx[1]], verts[:, idx[2]]
        nrm = np.cross(v2 - v1, v3 - v1)
        nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True),
                          1e-300)
        flip = np.sum(nrm * (verts[:, k] - v1), axis=-1) > 0
        nrm = np.where(flip[:, None], -nrm, nrm)
        face_n[:, k] = nrm
        face_d[:, k] = -np.sum(nrm * v1, axis=-1)
    e1 = verts[:, 1] - verts[:, 0]
    e2 = verts[:, 2] - verts[:, 0]
    e3 = verts[:, 3] - verts[:, 0]
    vol = np.abs(np.einsum("ij,ij->i", np.cross(e1, e2), e3)) / 6.0
    centroids = verts.mean(axis=1)

    G = lookup_res
    gx = (np.arange(G) + 0.5) / G
    pts_g = np.stack(np.meshgrid(gx, gx, gx, indexing="ij"), -1).reshape(-1, 3)
    owner = tri.find_simplex(pts_g)
    bad = owner < 0
    if bad.any():
        from scipy.spatial import cKDTree
        _, repl = cKDTree((centroids - lo) / span).query(pts_g[bad])
        owner[bad] = repl
    lookup = owner.astype(np.int32).reshape(G, G, G)
    if walk_steps is None:
        walk_steps = max(12, int(3 * np.ceil(n_t ** (1 / 3))))
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32))
    return TetraGrid(face_n=f32(face_n), face_d=f32(face_d),
                     neighbors=torch.tensor(tri.neighbors.astype(np.int32)),
                     centroids=f32(centroids), box_lo=f32(lo), box_hi=f32(hi),
                     lookup=torch.tensor(lookup),
                     vol_frac=f32(vol / np.prod(span)),
                     walk_steps=walk_steps)
