"""Voxel rasters of grids for the slab engines.

Port of the tree branch of `skirt9_tpu/parallel/domain.py`
`voxelize_for_dd` (`:568-612, 626-636`), octrees, bintrees and adaptive
meshes. Every leaf of a power-of-two tree is an aligned block of voxels of
its finest level's uniform raster, so the tree rasterizes exactly onto
that raster: the owner map (fine voxel -> leaf id) and the voxel density
(each voxel its leaf's) describe the same medium on a uniform grid. The large-grid (XL) contracts run trees past the
multi-level sweep's raster on it (`transport/sweepxl.build_tree_tables`).

The owner map is built vectorised per level (`mlsweep.owner_map`, the leaf
map of the multi-level sweep), where the reference loops over leaves in
Python. Domain decomposition itself (the slab partition, the sharded
tables) is not ported yet.
"""

from __future__ import annotations

import torch

from ..grids.amr import AMRGrid
from ..grids.bintree import BinTreeGrid
from ..grids.cartesian import UniformCartesianGrid, make_cartesian
from ..grids.octree import OctreeGrid
from ..transport import mlsweep as ml
from ..utils.log import default as _log


def voxelize_for_dd(grid, med, n_slabs: int = 1):
    """(vox_grid, med_vox, cellmap): the uniform grid of a tree's finest
    level over its root box, the medium with each voxel's density its
    leaf's, and the (nvox,) int32 voxel -> leaf map (-1 where no leaf
    lies), on the medium's device; (grid, med, None) for a uniform grid.
    n_slabs sets the reference's Voronoi and tetrahedral rasters, which are
    not ported."""
    if isinstance(grid, UniformCartesianGrid):
        return grid, med, None
    if not isinstance(grid, (OctreeGrid, BinTreeGrid, AMRGrid)):
        raise NotImplementedError(
            f"voxel raster of a {type(grid).__name__} not ported yet (trees "
            "and adaptive meshes only; Voronoi and tetrahedral grids come "
            "with ROADMAP item 22)")
    meta = ml._analyze(grid)
    nf = meta["nf"]
    lo0, box = meta["lo0"], meta["box"]
    vox_grid = make_cartesian(tuple((float(lo0[a]), float(lo0[a] + box[a]))
                                    for a in range(3)), nf)
    dev = med.nd.device
    cellmap = torch.from_numpy(ml.owner_map(meta).reshape(-1)).to(dev)
    owned = (cellmap >= 0)[:, None]
    nd_vox = torch.where(owned, med.nd[cellmap.clamp_min(0).long()],
                         torch.zeros((), dtype=med.nd.dtype, device=dev))
    _log().info(f"voxel raster: {type(grid).__name__} ({grid.ncells} cells) "
                f"on {'x'.join(map(str, vox_grid.shape))} voxels")
    return vox_grid, med._replace(nd=nd_vox.contiguous()), cellmap
