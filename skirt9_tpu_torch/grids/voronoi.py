"""Voronoi spatial grid: scipy/Qhull host build, nearest-site locate.

Port of `skirt9_tpu/grids/voronoi.py` (ref: SKIRT/core/VoronoiMeshSnapshot.
cpp:557-663, build through Voro++): the tessellation's neighbour graph
comes from the Delaunay ridges of scipy.spatial (Qhull), padded to a fixed
degree; a point is located by a coarse Cartesian lookup table of nearest
sites and a monotone walk to the nearest neighbour; cell volumes and
bounding boxes are exact box-clipped polyhedra (Qhull region vertices, or
halfspace intersection for wall cells), with a Monte-Carlo estimate for a
degenerate cell.

The port's transport rasterizes the cells (`transport/raster.py`) as the
reference's accelerator run does; where the raster declines the grid (its
`raster_fallback` off, kinematics, Lya, Compton, X-ray, explicit
absorption, more than 4 components) the scan march walks the cells exactly
through `step`, the reference's bisector walk (`voronoi.py:77-110`).
Density-sampled sites (`density_sites`) and Lloyd relaxation
(`lloyd_relax`) serve the loader's DustDensity and Uniform site policies
(`config/ski.build_site_grid`), for Voronoi and tetrahedral meshes alike.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import xlamath as xm

_BIG = 3e38


def _dot3(a, b):
    """Dot products over the last axis of size 3 as XLA's CPU reduction
    forms them: each product fused into the running sum."""
    return xm.fma_rn(a[..., 2], b[..., 2],
                  xm.fma_rn(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


class VoronoiGrid(NamedTuple):
    sites: torch.Tensor       # (N, 3) f32 generator points
    neighbors: torch.Tensor   # (N, D) int32, padded with -1
    box_lo: torch.Tensor      # (3,) f32
    box_hi: torch.Tensor      # (3,) f32
    lookup: torch.Tensor      # (G, G, G) int32 nearest-site table
    cell_volumes: torch.Tensor  # (N,) f32 exact cell volumes as fractions
                                # of the box volume (m^3 overflows f32)
    aabb_lo: torch.Tensor     # (N, 3) f32 exact per-cell bounding boxes
    aabb_hi: torch.Tensor     # (N, 3) f32
    walk_steps: int           # locate walk iterations

    @property
    def ncells(self) -> int:
        return self.sites.shape[0]

    def to(self, device) -> "VoronoiGrid":
        return self._replace(**{
            name: value.to(device) for name, value in zip(self._fields, self)
            if isinstance(value, torch.Tensor)})

    # ---------------------------------------------------------------- locate

    def _guess(self, pos: torch.Tensor) -> torch.Tensor:
        G = self.lookup.shape[0]
        rel = (pos - self.box_lo) / (self.box_hi - self.box_lo)
        ig = torch.clamp((rel * G).to(torch.int64), 0, G - 1)
        return self.lookup[ig[..., 0], ig[..., 1], ig[..., 2]].to(torch.int64)

    def locate(self, pos: torch.Tensor) -> torch.Tensor:
        """(B, 3) -> (B,) int64 nearest-site cell, -1 outside the box: the
        lookup's guess, then walk_steps moves to the nearest of the cell
        and its neighbours (the first in that order on a tie)."""
        inside = torch.all((pos >= self.box_lo) & (pos < self.box_hi), dim=-1)
        cell = self._guess(pos)
        nbrs = self.neighbors.to(torch.int64)
        for _ in range(self.walk_steps):
            cand = torch.cat([cell[:, None], nbrs[cell]], dim=1)  # (B, D+1)
            spos = self.sites[torch.clamp_min(cand, 0)]           # (B, D+1, 3)
            diff = spos - pos[:, None, :]
            d2 = torch.sum(diff * diff, dim=-1)
            d2 = torch.where(cand >= 0, d2, torch.full_like(d2, _BIG))
            cell = cand.gather(1, torch.argmin(d2, dim=-1)[:, None])[:, 0]
        return torch.where(inside, cell, torch.full_like(cell, -1))

    def step(self, pos: torch.Tensor, dirn: torch.Tensor, cell: torch.Tensor):
        """One step of the exact walk (the reference's `voronoi.py:77-110`):
        the nearest positive crossing of a bisector plane between the cell's
        site and a neighbour's (over the -1-padded neighbour list), or the
        domain wall if that comes first (next cell -1); the position moves
        on by ds * (1 + 1e-6), off the plane. Returns (ds, next cell, next
        position); a lane outside (cell < 0) stays there with ds 0."""
        c = torch.clamp_min(cell, 0)
        si = self.sites[c]                                   # (B, 3)
        nb = self.neighbors[c].to(torch.int64)               # (B, D)
        sj = self.sites[torch.clamp_min(nb, 0)]              # (B, D, 3)
        n = sj - si[:, None, :]
        m = 0.5 * (sj + si[:, None, :])
        dn = _dot3(dirn[:, None, :], n)
        t = _dot3(m - pos[:, None, :], n) / torch.where(
            torch.abs(dn) < 1e-30, torch.ones_like(dn), dn)
        t = torch.where((nb >= 0) & (dn > 0) & (t > 0), t,
                        torch.full_like(t, _BIG))
        t_nb, j_nb = torch.min(t, dim=-1)
        tiny = torch.abs(dirn) < 1e-30
        tgt = torch.where(dirn > 0, self.box_hi, self.box_lo)
        t_ax = torch.clamp_min((tgt - pos) / torch.where(
            tiny, torch.ones_like(dirn), dirn), 0.0)
        t_wall = torch.amin(torch.where(tiny, torch.full_like(dirn, _BIG),
                                        t_ax), dim=-1)
        ds = torch.minimum(t_nb, t_wall)
        nxt = torch.where(t_wall <= t_nb, -1,
                          nb.gather(1, j_nb[:, None])[:, 0])
        newpos = xm.fma_rn((ds * xm.f32(1.0 + 1e-6))[:, None], dirn, pos)
        out = cell < 0
        return (torch.where(out, torch.zeros_like(ds), ds),
                torch.where(out, -1, nxt),
                torch.where(out[:, None], pos, newpos))

    def move_inside(self, pos: torch.Tensor, dirn: torch.Tensor):
        """Advance packets launched outside the box to its surface (the
        reference's `voronoi.py:120-130`, which the launch calls). Returns
        (pos', cell' int64, distance)."""
        tiny = torch.abs(dirn) < 1e-30
        inv = 1.0 / torch.where(tiny, torch.full_like(dirn, 1e-30), dirn)
        t1 = (self.box_lo - pos) * inv
        t2 = (self.box_hi - pos) * inv
        tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
        tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
        hits = tmax > torch.clamp_min(tmin, 0.0)
        already = torch.all((pos >= self.box_lo) & (pos < self.box_hi),
                            dim=-1)
        t_entry = torch.where(already, torch.zeros_like(tmin),
                              torch.clamp_min(tmin, 0.0) * (1.0 + 1e-6))
        newpos = pos + t_entry[..., None] * dirn
        cell = self.locate(newpos)
        return newpos, torch.where(already | hits, cell,
                                   torch.full_like(cell, -1)), t_entry

    # ------------------------------------------------------------------ misc

    def _box(self) -> tuple:
        return (self.box_lo.cpu().numpy().astype(np.float64),
                self.box_hi.cpu().numpy().astype(np.float64))

    def volumes(self) -> np.ndarray:
        """Cell volumes [m^3], host f64."""
        lo, hi = self._box()
        return self.cell_volumes.cpu().numpy().astype(np.float64) \
            * np.prod(hi - lo)

    def cell_centers(self) -> torch.Tensor:
        return self.sites

    def diagonal(self) -> float:
        """The box diagonal [m], the f32 corners taken to f64 first, as the
        reference takes it (`voronoi.py:137-140`): rf_scale, and with it
        every stored RF, is then the reference's."""
        lo, hi = self._box()
        return float(np.linalg.norm(hi - lo))

    def max_steps(self) -> int:
        # ~ sites crossed by a straight chord, with slack
        return int(4 * np.ceil(self.ncells ** (1 / 3))) + 16

    def cell_bounds(self):
        """Exact per-cell bounding boxes (lo, hi), (N, 3) f64 each on the
        host, for in-cell position sampling (ref: VoronoiMeshSnapshot::
        generatePosition)."""
        return (self.aabb_lo.cpu().numpy().astype(np.float64),
                self.aabb_hi.cpu().numpy().astype(np.float64))


def build_voronoi(sites: np.ndarray, extent, lookup_res: int = 32,
                  volume_samples: int = 200_000, seed: int = 11,
                  walk_steps: int | None = None) -> VoronoiGrid:
    """Host build: the Delaunay neighbour graph, the locate lookup, exact
    volumes and boxes (CPU tensors).

    sites: (N,3) generator positions inside the extent box."""
    from scipy.spatial import Delaunay, cKDTree

    sites = np.asarray(sites, np.float64)
    n = len(sites)
    lo = np.array([extent[a][0] for a in range(3)], np.float64)
    hi = np.array([extent[a][1] for a in range(3)], np.float64)

    # Delaunay adjacency == Voronoi face adjacency
    tri = Delaunay(sites)
    indptr, indices = tri.vertex_neighbor_vertices
    degree = np.diff(indptr)
    D = int(degree.max())
    neighbors = np.full((n, D), -1, np.int32)
    for i in range(n):
        nbs = indices[indptr[i]:indptr[i + 1]]
        neighbors[i, :len(nbs)] = nbs

    # coarse nearest-site lookup for locate()
    kdt = cKDTree(sites)
    G = lookup_res
    axes = [np.linspace(lo[a], hi[a], G, endpoint=False)
            + (hi[a] - lo[a]) / (2 * G) for a in range(3)]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    _, owner = kdt.query(pts)
    lookup = owner.astype(np.int32).reshape(G, G, G)

    # exact clipped-polyhedron volume fractions and boxes, a Monte-Carlo
    # estimate for degenerate cells
    vols, blo, bhi = exact_volumes(sites, neighbors, lo, hi)
    bad = ~np.isfinite(vols) | (vols <= 0)
    if bad.any():
        rs = np.random.default_rng(seed)
        samp = lo + rs.uniform(size=(volume_samples, 3)) * (hi - lo)
        _, which = kdt.query(samp)
        counts = np.bincount(which, minlength=n).astype(np.float64)
        vols = np.where(bad, counts / volume_samples, vols)
        half = 0.5 * (hi - lo) / n ** (1 / 3)
        blo = np.where(bad[:, None], sites - half, blo)
        bhi = np.where(bad[:, None], sites + half, bhi)
    blo = np.clip(blo, lo, hi)
    bhi = np.clip(bhi, lo, hi)

    if walk_steps is None:
        walk_steps = max(8, int(2 * np.ceil(n ** (1 / 3))))

    f32 = lambda a: torch.tensor(np.asarray(a, np.float32))
    return VoronoiGrid(
        sites=f32(sites), neighbors=torch.tensor(neighbors),
        box_lo=f32(lo), box_hi=f32(hi), lookup=torch.tensor(lookup),
        cell_volumes=f32(vols), aabb_lo=f32(blo), aabb_hi=f32(bhi),
        walk_steps=walk_steps)


def exact_volumes(sites: np.ndarray, neighbors: np.ndarray,
                  lo: np.ndarray, hi: np.ndarray):
    """Exact box-clipped Voronoi cell volumes, as fractions of the box
    volume, and the cells' bounding boxes [m].

    Interior cells whose Qhull region vertices all lie inside the box get
    the convex-hull volume of those vertices; wall cells intersect their
    bisector halfspaces with the box faces (scipy HalfspaceIntersection, the
    reference's Voro++ cell clipping, ref: VoronoiMeshSnapshot.cpp:557-580).
    The work is in box-normalized coordinates, for Qhull's conditioning.
    NaN marks a cell where Qhull fails (the caller estimates it)."""
    from scipy.spatial import ConvexHull, HalfspaceIntersection, Voronoi
    from scipy.spatial import QhullError

    n = len(sites)
    span = hi - lo
    s = (sites - lo) / span
    vor = Voronoi(s)
    vols = np.full(n, np.nan)
    blo = np.full((n, 3), np.nan)
    bhi = np.full((n, 3), np.nan)
    eps = 1e-9
    for i in range(n):
        reg = vor.regions[vor.point_region[i]]
        if reg and -1 not in reg:
            verts = vor.vertices[reg]
            if np.all((verts > -eps) & (verts < 1 + eps)):
                try:
                    vols[i] = ConvexHull(verts).volume
                    blo[i] = verts.min(axis=0)
                    bhi[i] = verts.max(axis=0)
                except QhullError:
                    pass
                continue
        # wall cell (or a region escaping the box): halfspace clipping
        nbs = neighbors[i]
        nbs = nbs[nbs >= 0]
        p = s[i]
        d = s[nbs] - p                          # plane normals
        mid = 0.5 * (s[nbs] + p)
        # halfspaces A x + b <= 0: the bisectors and the 6 box faces
        A = np.vstack([d, np.eye(3), -np.eye(3)])
        b = np.concatenate([-(d * mid).sum(1), -np.ones(3), np.zeros(3)])
        try:
            hsi = HalfspaceIntersection(np.hstack([A, b[:, None]]), p)
            vols[i] = ConvexHull(hsi.intersections).volume
            blo[i] = hsi.intersections.min(axis=0)
            bhi[i] = hsi.intersections.max(axis=0)
        except (QhullError, ValueError):
            pass
    return vols, blo * span + lo, bhi * span + lo


def lloyd_relax(sites: np.ndarray, extent, n_iter: int = 10,
                samples: int = 500_000, seed: int = 17) -> np.ndarray:
    """Lloyd (centroidal) relaxation of the sites, the reference's
    (`skirt9_tpu/grids/voronoi.py:222-247`): n_iter times each site moves
    to its cell's centroid, estimated from one shared uniform sample of the
    box through a nearest-site query (ref: VoronoiMeshSnapshot.cpp:609
    relax; the reference iterates Voro++'s centroids, the same fixed point
    by another estimator). An empty cell keeps its site."""
    from scipy.spatial import cKDTree

    sites = np.array(sites, np.float64, copy=True)
    n = len(sites)
    lo = np.array([extent[a][0] for a in range(3)], np.float64)
    hi = np.array([extent[a][1] for a in range(3)], np.float64)
    pts = lo + np.random.default_rng(seed).uniform(size=(samples, 3)) \
        * (hi - lo)
    for _ in range(n_iter):
        _, owner = cKDTree(sites).query(pts)
        cnt = np.bincount(owner, minlength=n)
        cen = np.stack([np.bincount(owner, weights=pts[:, a], minlength=n)
                        for a in range(3)], axis=-1)
        ok = cnt > 0
        sites[ok] = cen[ok] / cnt[ok, None]
    return sites


def density_sites(density_fn, extent, n_sites: int, seed: int = 3,
                  oversample: int = 40) -> np.ndarray:
    """n_sites sites drawn from a density field, the reference's
    (`skirt9_tpu/grids/voronoi.py:304-317`; ref: VoronoiMeshSpatialGrid's
    DustDensity policy): oversample times as many uniform candidates in the
    box, then n_sites of them without replacement, each with probability
    proportional to its density."""
    rs = np.random.default_rng(seed)
    lo = np.array([extent[a][0] for a in range(3)])
    hi = np.array([extent[a][1] for a in range(3)])
    cand = lo + rs.uniform(size=(n_sites * oversample, 3)) * (hi - lo)
    w = np.maximum(density_fn(cand), 0.0)
    if w.sum() <= 0:
        raise ValueError("density is zero everywhere in the extent")
    idx = rs.choice(len(cand), size=n_sites, replace=False, p=w / w.sum())
    return cand[idx]
