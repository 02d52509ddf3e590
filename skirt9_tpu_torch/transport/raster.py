"""Rasterized sweep: unstructured grids on the multi-level sweep.

Port of `skirt9_tpu/transport/raster.py` for Voronoi grids. The reference's
accelerator run does not walk the Voronoi cells: it rasterizes them onto a
uniform voxel grid, where every voxel belongs to the cell that owns its
centre (the nearest site), and runs the tree engine's kernels 4-5 on that
grid as a single-level tree (`mlsweep.MLTables` with one level of shift 0,
the owner map as its leaf map and a plan of one step per slab). The port
does the same, so that its run sees the medium the reference's accelerator
run sees.

Cell interfaces become voxel staircases: per-ray optical depths carry a
zero-mean voxelization error of order (voxel size / cell size) x the
density contrast (the reference measures 1-2 % per chord), while deposits
and interactions stay in the cell that supplied the opacity.

`choose_resolution` keeps the reference's result (73^3 for a cubic box):
its caps (128 encoding rows, 5 MB of tables) are TPU limits, but its output
defines the medium, so the port reproduces it.

Tetrahedral grids rasterize the same way. The reference's owner map of a
tetrahedral grid is its own `locate` in chunks of 2^16 voxel centres (its
`_delaunay` shortcut is never set on the grid), so the port's is the
port's `locate`, which walks as the reference's does, on the grid's
device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..grids.tetra import TetraGrid
from ..grids.voronoi import VoronoiGrid
from ..utils.log import default as _log
from . import mlsweep as ml
from . import sweep as sw

# layout a -> its (u, v) minor physical axes (the reference's `_MINOR`)
_MINOR = {0: (1, 2), 1: (0, 2), 2: (0, 1)}


def _rows(nu: int, nv: int) -> int:
    return -(-(nu * nv) // 128)


def choose_resolution(box: np.ndarray, max_enc: int = 128,
                      max_n: int = 256, ncomp: int = 1) -> tuple:
    """Per-axis voxel counts, the reference's (`raster.py:48-87`): the
    largest near-cubic resolution (n_a proportional to the box's edges, at
    least 4) with sum_a ceil(minor_a / 128) <= max_enc encoding rows, each
    n_a <= max_n, and the three slab layouts' tables within 5 MB."""
    box = np.asarray(box, np.float64)
    rel = box / box.max()

    def res_for(scale: float):
        n = np.maximum(np.rint(rel * scale).astype(int), 4)
        return tuple(int(v) for v in np.minimum(n, max_n))

    def fits(n):
        nx, ny, nz = n
        enc = _rows(ny, nz) + _rows(nx, nz) + _rows(nx, ny)
        if enc > max_enc:
            return False
        tab = sum(ncomp * n[a] * _rows(n[_MINOR[a][0]], n[_MINOR[a][1]])
                  * 128 * 4 for a in range(3))
        return tab <= 5 * 2**20

    lo_s, hi_s = 4.0, 512.0
    while hi_s - lo_s > 0.5:
        mid = 0.5 * (lo_s + hi_s)
        if fits(res_for(mid)):
            lo_s = mid
        else:
            hi_s = mid
    return res_for(lo_s)


def _owner_map(grid, centers: np.ndarray) -> np.ndarray:
    """Host voxel-centre -> cell id map: the nearest site of a Voronoi
    grid; the tetrahedron that a tetrahedral grid's `locate` walks to from
    each f32 centre, 2^16 at a time (-1 outside)."""
    if isinstance(grid, TetraGrid):
        dev = grid.box_lo.device
        out = np.empty(len(centers), np.int32)
        step = 1 << 16
        for i in range(0, len(centers), step):
            pos = torch.tensor(centers[i:i + step].astype(np.float32),
                               device=dev)
            out[i:i + step] = grid.locate(pos).cpu().numpy()
        return out
    if not isinstance(grid, VoronoiGrid):
        raise NotImplementedError(f"rasterizing a {type(grid).__name__} not "
                                  "ported yet (Voronoi and tetrahedral "
                                  "grids)")
    from scipy.spatial import cKDTree
    kdt = cKDTree(grid.sites.cpu().numpy().astype(np.float64))
    _, owner = kdt.query(centers)
    return owner.astype(np.int32)


def supports(grid, med, options=None) -> bool:
    """True when (grid, medium, options) takes the rasterized sweep: the
    reference's grid, option and component gates (`raster.py:113-135`)
    without its backend test, as `mlsweep.supports` drops it."""
    if not isinstance(grid, (VoronoiGrid, TetraGrid)):
        return False
    if options is not None and (options.kinematics or options.lya
                                or options.compton or options.xray
                                or options.explicit_absorption
                                or not options.raster_fallback):
        return False
    return med.ncomp <= 4


def boundary_fraction(owner3d: np.ndarray) -> float:
    """Share of voxels with a face neighbour owned by another cell: the
    voxels whose density is approximate."""
    b = np.zeros(owner3d.shape, bool)
    for a in range(3):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[a] = slice(0, -1)
        hi[a] = slice(1, None)
        d = owner3d[tuple(lo)] != owner3d[tuple(hi)]
        b[tuple(lo)] |= d
        b[tuple(hi)] |= d
    return float(b.mean())


def build_tables(grid, med, resolution: tuple | None = None) -> ml.MLTables:
    """Rasterize (grid, medium) into single-level `mlsweep.MLTables` on the
    medium's device: the medium's own density table, the owner map as the
    leaf map (-1 for a voxel no cell owns) and a plan of one step per slab.
    resolution: the voxel counts, else `choose_resolution`'s with each axis
    capped at `SKIRT9_TPU_RASTER_MAX_N` (default 256), as the reference
    reads it (`skirt9_tpu/transport/raster.py:142-145`)."""
    cap = int(os.environ.get("SKIRT9_TPU_RASTER_MAX_N", "256"))
    lo = grid.box_lo.cpu().numpy().astype(np.float64)
    hi = grid.box_hi.cpu().numpy().astype(np.float64)
    box = hi - lo
    n = tuple(int(v) for v in (resolution or choose_resolution(
        box, max_n=cap, ncomp=med.ncomp)))
    h = box / np.asarray(n, np.float64)
    c = [lo[a] + (np.arange(n[a]) + 0.5) * h[a] for a in range(3)]
    centers = np.stack(np.meshgrid(*c, indexing="ij"), axis=-1).reshape(-1, 3)
    owner = _owner_map(grid, centers)            # x-major
    level = ml._Level(shift=(0, 0, 0),
                      ax=tuple(ml._LevelAxis(0, n[a], 0) for a in range(3)))
    nmax = max(n)
    tlev, gs = ml._make_plan((level,), nmax)
    dev = med.nd.device
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    lo_t = tuple(float(v) for v in lo)
    h_t = tuple(float(v) for v in h)
    enc = sum(_rows(n[_MINOR[a][0]], n[_MINOR[a][1]]) for a in range(3))
    _log().info(
        f"transport: rasterized {type(grid).__name__} ({grid.ncells} cells) "
        f"onto a {'x'.join(map(str, n))} voxel sweep grid (encoding rows "
        f"{enc}, boundary-voxel fraction "
        f"{boundary_fraction(owner.reshape(n)):.2f})")
    return ml.MLTables(nd=med.nd.contiguous(), leafmap=i32(owner), n=n,
                       lo=lo_t, h=h_t, nmax=nmax, levels=(level,),
                       n_steps=len(tlev), step_tlev=i32(tlev),
                       step_gs=i32(gs), axes=sw.grid_axes(lo_t, n, h_t, dev),
                       geom=sw.axis_tables(lo_t, n, h_t, dev))
