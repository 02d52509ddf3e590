"""Binary-tree spatial grid: k-d style alternate-axis splits.

Port of `skirt9_tpu/grids/bintree.py:26-200`: each node splits in half along
one axis, cycling x, y, z with depth, so a leaf three levels down equals one
octree child and intermediate leaves are anisotropic slabs. Flat node arrays
built on the host in numpy (the reference's arrays for the same arguments),
a fixed-depth descent or the fine leaf map for `locate`, and the helpers the
octree shares (`grids/octree.py`), the scan-march `step` among them (the
reference's `bintree.py:67-83`, the same formula with this tree's descent).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import octree as ot


class BinTreeGrid(NamedTuple):
    node_child: torch.Tensor   # (N,) int32, first of 2 children, -1 for leaves
    node_axis: torch.Tensor    # (N,) int32 split axis 0/1/2
    node_split: torch.Tensor   # (N,) f32 split coordinate
    node_cell: torch.Tensor    # (N,) int32 leaf -> cell, -1 internal
    cell_lo: torch.Tensor      # (ncells, 3) f32
    cell_hi: torch.Tensor      # (ncells, 3) f32
    box_lo: torch.Tensor       # (3,) f32
    box_hi: torch.Tensor       # (3,) f32
    levels: int                # descent depth
    leafmap: torch.Tensor | None = None
    fine_n: tuple = ()

    @property
    def ncells(self) -> int:
        return self.cell_lo.shape[0]

    def locate(self, pos: torch.Tensor) -> torch.Tensor:
        """(B, 3) -> (B,) int64 leaf index, -1 outside the root box: one
        gather from the leaf map where one is attached, else `descend`."""
        if self.leafmap is not None:
            return ot.leafmap_locate(self, pos)
        return self.descend(pos)

    def descend(self, pos: torch.Tensor) -> torch.Tensor:
        """(B, 3) -> (B,) int64 leaf index by descent from the root along
        each node's split axis (the reference's `bintree.py:54-65`), -1
        outside the root box."""
        inside = ot.inside_box(self, pos)
        child_t = self.node_child.to(torch.int64)
        axis_t = self.node_axis.to(torch.int64)
        node = torch.zeros(pos.shape[:-1], dtype=torch.int64,
                           device=pos.device)
        for _ in range(self.levels):
            child = child_t[node]
            val = pos.gather(-1, axis_t[node][..., None])[..., 0]
            upper = (val >= self.node_split[node]).to(torch.int64)
            node = torch.where(child >= 0, child + upper, node)
        cell = self.node_cell[node].to(torch.int64)
        return torch.where(inside, cell, torch.full_like(cell, -1))

    step = ot.tree_step
    move_inside = ot.move_inside
    volumes = ot.volumes
    diagonal = ot.diagonal
    cell_centers = ot.cell_centers
    cell_bounds = ot.cell_bounds
    to = ot.to_device

    def max_steps(self) -> int:
        return 4 * (1 << ((self.levels + 2) // 3)) * 3 + 8


def build_bintree(extent, density_fn, max_level: int = 18,
                  min_level: int = 6, max_fraction: float = 1e-2,
                  samples: int = 64, seed: int = 7,
                  refine_fn=None) -> BinTreeGrid:
    """Density-policy bintree construction (host-side, numpy), on the CPU:
    split the working axis (level % 3) in half while a node holds more than
    max_fraction of the total mass (levels count splits). Same arrays as the
    reference's `build_bintree`, vectorised per level."""
    lo0, hi0, node_mass, total_mass = ot.mass_estimator(extent, density_fn,
                                                        samples, seed)
    los, his = [lo0[None]], [hi0[None]]
    childs, axes, splits = [np.full(1, -1, np.int64)], [np.zeros(1, np.int32)], \
        [np.zeros(1, np.float64)]
    n_nodes, level = 1, 0
    while len(los[-1]) and level < max_level:
        ax = level % 3
        f_lo, f_hi = los[-1], his[-1]
        if level < min_level:
            refine = np.ones(len(f_lo), bool)
        elif refine_fn is not None:
            refine = np.asarray(refine_fn(f_lo, f_hi, level), bool)
        else:
            refine = node_mass(f_lo, f_hi) / total_mass > max_fraction
        lo, hi = f_lo[refine], f_hi[refine]
        mid = 0.5 * (lo[:, ax] + hi[:, ax])
        childs[-1][refine] = n_nodes + 2 * np.arange(len(lo))
        axes[-1][refine] = ax
        splits[-1][refine] = mid
        c_lo = np.repeat(lo, 2, axis=0)
        c_hi = np.repeat(hi, 2, axis=0)
        c_hi[0::2, ax] = mid
        c_lo[1::2, ax] = mid
        los.append(c_lo)
        his.append(c_hi)
        childs.append(np.full(len(c_lo), -1, np.int64))
        axes.append(np.zeros(len(c_lo), np.int32))
        splits.append(np.zeros(len(c_lo), np.float64))
        n_nodes += len(c_lo)
        level += 1
    nodes_lo, nodes_hi = np.concatenate(los), np.concatenate(his)
    return BinTreeGrid(
        node_axis=torch.tensor(np.concatenate(axes).astype(np.int32)),
        node_split=torch.tensor(np.concatenate(splits).astype(np.float32)),
        **ot.host_fields(np.concatenate(childs), nodes_lo, nodes_hi, lo0, hi0,
                         level + 1))
