"""Octree spatial grid: density- or site-list-policy host build, device locate.

Port of `skirt9_tpu/grids/octree.py:32-263`. The tree is flat arrays

  node_child  (N,)    first-child index (8 contiguous children), -1 for leaves
  node_cell   (N,)    leaf -> cell index, -1 for internal nodes
  node_center (N, 3)  split centre of each node
  cell_lo/cell_hi (ncells, 3)  leaf boxes

built on the host in numpy (the same arguments and seed give the reference's
arrays) and moved to a device with `.to(device)`. `locate` is a fixed-depth
descent from the root, or one gather from the fine leaf map (fine voxel ->
leaf id) when a `Simulation` has attached it. The reference's scan-march
`step` and its topology save/load are not ported: the port marches trees with
the multi-level sweep (`transport/mlsweep.py`) only.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


# ------------------------------------------------- shared by the tree grids

def leafmap_locate(grid, pos: torch.Tensor) -> torch.Tensor:
    """(B, 3) -> (B,) int64 leaf index through the fine leaf map, -1 outside
    the root box (the reference's f32 arithmetic, `octree.py:56-63`)."""
    inside = torch.all((pos >= grid.box_lo) & (pos < grid.box_hi), dim=-1)
    nf = torch.tensor(grid.fine_n, dtype=torch.int64, device=pos.device)
    h = (grid.box_hi - grid.box_lo) / nf.to(torch.float32)
    ijk = torch.floor((pos - grid.box_lo) / h).to(torch.int64)
    ijk = torch.minimum(torch.clamp_min(ijk, 0), nf - 1)
    flat = (ijk[..., 0] * grid.fine_n[1] + ijk[..., 1]) * grid.fine_n[2] \
        + ijk[..., 2]
    cell = grid.leafmap[flat].to(torch.int64)
    return torch.where(inside, cell, torch.full_like(cell, -1))


def move_inside(grid, pos: torch.Tensor, dirn: torch.Tensor):
    """Advance packets launched outside the root box to its surface
    (`octree.py:103-114`). Returns (pos', cell' int64, distance)."""
    tiny = torch.abs(dirn) < 1e-30
    inv = 1.0 / torch.where(tiny, torch.full_like(dirn, 1e-30), dirn)
    t1 = (grid.box_lo - pos) * inv
    t2 = (grid.box_hi - pos) * inv
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    hits = tmax > torch.clamp_min(tmin, 0.0)
    already = grid.locate(pos) >= 0
    t_entry = torch.where(already, torch.zeros_like(tmin),
                          torch.clamp_min(tmin, 0.0) * (1.0 + 1e-6))
    newpos = pos + t_entry[..., None] * dirn
    cell = grid.locate(newpos)
    return newpos, torch.where(already | hits, cell,
                               torch.full_like(cell, -1)), t_entry


def volumes(grid) -> np.ndarray:
    """Cell volumes [m^3], host f64 (f32 products overflow at pc scale)."""
    d = (grid.cell_hi.cpu().numpy().astype(np.float64)
         - grid.cell_lo.cpu().numpy().astype(np.float64))
    return d[:, 0] * d[:, 1] * d[:, 2]


def diagonal(grid) -> float:
    """Length of the root box's diagonal [m] (the reference's
    `Simulation._grid_diagonal`)."""
    lo = grid.box_lo.cpu().numpy().astype(np.float64)
    hi = grid.box_hi.cpu().numpy().astype(np.float64)
    return float(np.linalg.norm(hi - lo))


def to_device(grid, device):
    """The grid with every tensor field on `device`."""
    return grid._replace(**{
        name: value.to(device) for name, value in zip(grid._fields, grid)
        if isinstance(value, torch.Tensor)})


def cell_centers(grid) -> torch.Tensor:
    return 0.5 * (grid.cell_lo + grid.cell_hi)


def host_fields(node_child, nodes_lo, nodes_hi, lo0, hi0, levels) -> dict:
    """The fields both trees share, as CPU tensors, from the host build:
    leaves are the nodes without children, numbered in node order."""
    leaves = np.flatnonzero(node_child < 0)
    node_cell = np.full(len(node_child), -1, np.int32)
    node_cell[leaves] = np.arange(len(leaves), dtype=np.int32)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32))
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32))
    return dict(node_child=i32(node_child), node_cell=i32(node_cell),
                cell_lo=f32(nodes_lo[leaves]), cell_hi=f32(nodes_hi[leaves]),
                box_lo=f32(lo0), box_hi=f32(hi0), levels=int(levels))


def mass_estimator(extent, density_fn, samples: int, seed: int):
    """(root lo, root hi, node_mass(lo, hi) -> (M,), total mass): the
    reference's Monte Carlo node mass, drawing from one seeded stream in
    call order."""
    lo0 = np.array([extent[a][0] for a in range(3)], np.float64)
    hi0 = np.array([extent[a][1] for a in range(3)], np.float64)
    rs = np.random.default_rng(seed)

    def node_mass(lo, hi):
        u = rs.uniform(size=(samples, lo.shape[0], 3))
        pts = lo[None] + u * (hi - lo)[None]
        dens = density_fn(pts.reshape(-1, 3)).reshape(samples, -1)
        return dens.mean(axis=0) * np.prod(hi - lo, axis=-1)

    total = (max(node_mass(lo0[None], hi0[None])[0], 1e-300)
             if density_fn is not None else 1.0)
    return lo0, hi0, node_mass, total


# ------------------------------------------------------------------ octree

class OctreeGrid(NamedTuple):
    node_child: torch.Tensor   # (N,) int32
    node_cell: torch.Tensor    # (N,) int32
    node_center: torch.Tensor  # (N, 3) f32
    cell_lo: torch.Tensor      # (ncells, 3) f32
    cell_hi: torch.Tensor      # (ncells, 3) f32
    box_lo: torch.Tensor       # (3,) f32
    box_hi: torch.Tensor       # (3,) f32
    levels: int                # descent depth
    leafmap: torch.Tensor | None = None   # (nfx*nfy*nfz,) int32 or None
    fine_n: tuple = ()                    # (nfx, nfy, nfz) of the leaf map

    @property
    def ncells(self) -> int:
        return self.cell_lo.shape[0]

    def locate(self, pos: torch.Tensor) -> torch.Tensor:
        """(B, 3) -> (B,) int64 leaf index, -1 outside the root box."""
        if self.leafmap is not None:
            return leafmap_locate(self, pos)
        inside = torch.all((pos >= self.box_lo) & (pos < self.box_hi), dim=-1)
        child_t = self.node_child.to(torch.int64)
        node = torch.zeros(pos.shape[:-1], dtype=torch.int64,
                           device=pos.device)
        for _ in range(self.levels):
            child = child_t[node]
            center = self.node_center[node]
            octant = ((pos[..., 0] >= center[..., 0]).to(torch.int64)
                      + 2 * (pos[..., 1] >= center[..., 1]).to(torch.int64)
                      + 4 * (pos[..., 2] >= center[..., 2]).to(torch.int64))
            node = torch.where(child >= 0, child + octant, node)
        cell = self.node_cell[node].to(torch.int64)
        return torch.where(inside, cell, torch.full_like(cell, -1))

    move_inside = move_inside
    volumes = volumes
    diagonal = diagonal
    cell_centers = cell_centers
    to = to_device

    def max_steps(self) -> int:
        return 4 * (1 << self.levels) + 8


def build_octree(extent, density_fn, max_level: int = 6, min_level: int = 2,
                 max_fraction: float = 1e-2, samples: int = 64,
                 seed: int = 7, refine_fn=None) -> OctreeGrid:
    """Density-policy octree construction (host-side, numpy), on the CPU.

    Subdivide while a node holds more than `max_fraction` of the total mass
    or is below min_level; refine_fn(lo, hi, level) -> (M,) bool replaces
    the density criterion (site lists). Same arrays as the reference's
    `build_octree` for the same arguments: the same random draws per level
    and the same f64 midpoints, appended level by level in frontier order
    (vectorised per level where the reference loops per node)."""
    lo0, hi0, node_mass, total_mass = mass_estimator(extent, density_fn,
                                                     samples, seed)
    octant = ((np.arange(8)[:, None] >> np.arange(3)) & 1).astype(bool)
    los, his, childs = [lo0[None]], [hi0[None]], [np.full(1, -1, np.int64)]
    n_nodes, depth, level = 1, 0, 0
    while len(los[-1]) and level < max_level:
        f_lo, f_hi = los[-1], his[-1]          # the frontier: the last level
        if level < min_level:
            refine = np.ones(len(f_lo), bool)
        elif refine_fn is not None:
            refine = np.asarray(refine_fn(f_lo, f_hi, level), bool)
        else:
            refine = node_mass(f_lo, f_hi) / total_mass > max_fraction
        lo, hi = f_lo[refine], f_hi[refine]
        childs[-1][refine] = n_nodes + 8 * np.arange(len(lo))
        c = 0.5 * (lo + hi)
        los.append(np.where(octant, c[:, None], lo[:, None]).reshape(-1, 3))
        his.append(np.where(octant, hi[:, None], c[:, None]).reshape(-1, 3))
        childs.append(np.full(len(los[-1]), -1, np.int64))
        n_nodes += len(los[-1])
        depth = level + 1 if len(lo) else depth
        level += 1
    nodes_lo, nodes_hi = np.concatenate(los), np.concatenate(his)
    return OctreeGrid(
        node_center=torch.tensor((0.5 * (nodes_lo + nodes_hi))
                                 .astype(np.float32)),
        **host_fields(np.concatenate(childs), nodes_lo, nodes_hi, lo0, hi0,
                      depth + 1))


def site_list_refine_fn(sites: np.ndarray, max_sites_per_leaf: int = 1):
    """TreePolicy that subdivides while a node holds more than
    `max_sites_per_leaf` sites (`octree.py:249-263`; SiteListTreePolicy).

    The reference tests every site against every node. Here the nodes of one
    call are one tree level: along each axis their bounds are points of one
    strictly increasing set, and each node spans two neighbours of it. So a
    site lies in the node whose lower bound is, on every axis, the last point
    <= its coordinate (`searchsorted`), and one `np.unique` counts them: the
    same test, lo <= site < hi, in O(sites log nodes)."""
    sites = np.asarray(sites, np.float64)

    def refine(lo, hi, level):
        lo = np.asarray(lo, np.float64)
        hi = np.asarray(hi, np.float64)
        site_key = np.zeros(len(sites), np.int64)
        node_key = np.zeros(len(lo), np.int64)
        inside = np.ones(len(sites), bool)
        for a in range(3):
            pts = np.unique(np.concatenate([lo[:, a], hi[:, a]]))
            j = np.searchsorted(pts, sites[:, a], side="right") - 1
            inside &= (j >= 0) & (j < len(pts) - 1)
            site_key = site_key * len(pts) + np.clip(j, 0, len(pts) - 1)
            node_key = node_key * len(pts) + np.searchsorted(pts, lo[:, a])
        keys, counts = np.unique(site_key[inside], return_counts=True)
        n_in = np.zeros(len(lo), np.int64)
        if len(keys):
            at = np.minimum(np.searchsorted(keys, node_key), len(keys) - 1)
            n_in = np.where(keys[at] == node_key, counts[at], 0)
        return n_in > max_sites_per_leaf

    return refine
