"""Adaptive-mesh (AMR) snapshot import and spatial grid.

Port of `skirt9_tpu/grids/amr.py` (ref: AdaptiveMeshSnapshot.hpp:121, the
Morton-order tree text format with '!' nonleaf lines). The host parses the
file into flat node tables, in numpy:

  node_lo, node_span (M, 3)  each node's box corner and size (f32)
  node_div   (M, 3)  its subdivisions per axis, 0 for leaves
  node_child (M,)    offset of its children in child_flat, -1 for leaves
  node_cell  (M,)    leaf -> cell index, -1 for nonleaf nodes
  child_flat (C,)    child node ids, x fastest, per nonleaf node
  cell_lo, cell_hi (N, 3)  the leaf boxes

numbered as the reference numbers them (nodes in file order, the child lists
of the nonleaf nodes in the order their last child completes), built with an
explicit stack where the reference recurses. `locate` is the bounded descent
from the root over `depth` levels; `step` exits the leaf box, moves on by
1e-6 of the root box's diagonal and descends again; `move_inside` brings
lanes launched outside onto the root box. Each follows the reference's f32
operations as XLA runs them in its jitted march (the last move fused into
a multiply-add on x and y), so that every step lands in the reference's
cell. An AMR grid has no fine leaf map, as in the reference: launches
locate by descent.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import xlamath as xm

_BIG = 3e38


class AMRGrid(NamedTuple):
    node_lo: torch.Tensor     # (M, 3) f32
    node_span: torch.Tensor   # (M, 3) f32
    node_div: torch.Tensor    # (M, 3) int32
    node_child: torch.Tensor  # (M,) int32
    node_cell: torch.Tensor   # (M,) int32
    child_flat: torch.Tensor  # (C,) int32
    cell_lo: torch.Tensor     # (N, 3) f32
    cell_hi: torch.Tensor     # (N, 3) f32
    box_lo: torch.Tensor      # (3,) f32
    box_hi: torch.Tensor      # (3,) f32
    depth: int                # descent levels

    @property
    def ncells(self) -> int:
        return self.cell_lo.shape[0]

    def inside(self, pos: torch.Tensor) -> torch.Tensor:
        return torch.all((pos >= self.box_lo) & (pos < self.box_hi), dim=-1)

    def locate(self, pos: torch.Tensor) -> torch.Tensor:
        """(B, 3) -> (B,) int64 leaf index by the bounded descent from the
        root (`amr.py:50-69`), -1 outside the root box."""
        div_t = self.node_div.to(torch.int64)
        child_t = self.node_child.to(torch.int64)
        node = torch.zeros(pos.shape[:-1], dtype=torch.int64,
                           device=pos.device)
        for _ in range(self.depth):
            child = child_t[node]
            leaf = child < 0
            if bool(leaf.all()):
                break
            div = div_t[node]
            rel = (pos - self.node_lo[node]) / self.node_span[node]
            ijk = (rel * div.to(torch.float32)).to(torch.int64)
            ijk = torch.minimum(torch.clamp_min(ijk, 0),
                                torch.clamp_min(div - 1, 0))
            flat = ijk[..., 0] + div[..., 0] * (
                ijk[..., 1] + div[..., 1] * ijk[..., 2])
            nxt = self.child_flat[torch.clamp_min(child, 0) + flat]
            node = torch.where(leaf, node, nxt.to(torch.int64))
        cell = self.node_cell[node].to(torch.int64)
        return torch.where(self.inside(pos), cell, torch.full_like(cell, -1))

    def span(self) -> float:
        """The f32 length of the root box's diagonal, as XLA folds the
        reference's `jnp.linalg.norm(box_hi - box_lo)`: its squares and sum
        in f32, scaled by an exact power of two where they would overflow
        (a box past ~0.6 kpc, where the reference's span is infinite and
        its steps leave the grid), which changes no finite result."""
        d = (self.box_hi - self.box_lo).cpu().numpy().astype(np.float32)
        k = max(0, int(np.ceil(np.log2(float(np.abs(d).max()) or 1.0))) - 60)
        d = np.ldexp(d, -k).astype(np.float32)
        s = np.float32(0.0)
        for v in d:
            s = np.float32(s + np.float32(v * v))
        return float(np.ldexp(np.sqrt(s, dtype=np.float32), k))

    def nudge(self) -> float:
        """The f32 distance a step moves on past the exit face: 1e-6 of
        the diagonal, as XLA folds the reference's product."""
        return float(np.float32(1e-6) * np.float32(self.span()))

    def step(self, pos: torch.Tensor, dirn: torch.Tensor, cell: torch.Tensor):
        """One scan-march step (`amr.py:73-91`): the exit distance ds of
        the leaf box, the next leaf by descent at the exit point moved on
        by 1e-6 of the diagonal, and that moved point as the next position;
        a lane outside (cell < 0) stays with ds 0 and cell -1."""
        c = torch.clamp_min(cell, 0)
        lo, hi = self.cell_lo[c], self.cell_hi[c]
        tiny = torch.abs(dirn) < 1e-30
        inv = 1.0 / torch.where(tiny, torch.full_like(dirn, 1e-30), dirn)
        tgt = torch.where(dirn > 0, hi, lo)
        t_ax = torch.where(tiny, torch.full_like(pos, _BIG),
                           torch.clamp_min((tgt - pos) * inv, 0.0))
        ds = torch.amin(t_ax, dim=-1)
        # XLA's CPU code fuses the move into a multiply-add on x and y but
        # not on z, in the step as in move_inside
        newpos = xm.move_xy_fused(pos, ds + self.nudge(), dirn)
        nxt = self.locate(newpos)
        out = cell < 0
        return (torch.where(out, torch.zeros_like(ds), ds),
                torch.where(out, torch.full_like(nxt, -1), nxt),
                torch.where(out[..., None], pos, newpos))

    def move_inside(self, pos: torch.Tensor, dirn: torch.Tensor):
        """Advance packets launched outside the root box onto it
        (`amr.py:93-104`). Returns (pos', cell' int64, distance)."""
        tiny = torch.abs(dirn) < 1e-30
        inv = 1.0 / torch.where(tiny, torch.full_like(dirn, 1e-30), dirn)
        t1 = (self.box_lo - pos) * inv
        t2 = (self.box_hi - pos) * inv
        tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
        tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
        hits = tmax > torch.clamp_min(tmin, 0.0)
        already = self.inside(pos)
        t_entry = torch.where(already, torch.zeros_like(tmin),
                              torch.clamp_min(tmin, 0.0) * (1.0 + 1e-6))
        newpos = xm.move_xy_fused(pos, t_entry, dirn)
        cell = self.locate(newpos)
        return newpos, torch.where(already | hits, cell,
                                   torch.full_like(cell, -1)), t_entry

    def volumes(self) -> np.ndarray:
        """Leaf volumes [m^3], host f64."""
        lo, hi = self.cell_bounds()
        return np.prod(hi - lo, axis=-1)

    def cell_centers(self) -> torch.Tensor:
        return 0.5 * (self.cell_lo + self.cell_hi)

    def cell_bounds(self):
        """The leaf boxes (cell_lo, cell_hi), (ncells, 3) f64 on the host
        (`amr.py:113-115`)."""
        return (self.cell_lo.cpu().numpy().astype(np.float64),
                self.cell_hi.cpu().numpy().astype(np.float64))

    def cell_jitter_halfwidths(self) -> np.ndarray:
        lo, hi = self.cell_bounds()
        return 0.5 * (hi - lo)

    def diagonal(self) -> float:
        """The root box's diagonal [m], in f64 from the f32 corners, as the
        reference's `AMRGrid.diagonal` takes it (`amr.py:122-125`)."""
        lo = self.box_lo.cpu().numpy().astype(np.float64)
        hi = self.box_hi.cpu().numpy().astype(np.float64)
        return float(np.linalg.norm(hi - lo))

    def max_steps(self) -> int:
        return int(4 * np.ceil(self.ncells ** (1 / 3))) + 32

    def to(self, device) -> "AMRGrid":
        return self._replace(**{
            name: value.to(device) for name, value in zip(self._fields, self)
            if isinstance(value, torch.Tensor)})


def parse_amr_file(path: str):
    """Parse the Morton-order AMR text format (ref: AdaptiveMeshSnapshot.hpp:
    63-76): '!' lines declare a nonleaf node's subdivisions Nx Ny Nz, other
    lines are leaf rows in Morton (depth-first, x-fastest) order, '#' lines
    comments. Returns (tokens, values): the node stream, ("node", nx, ny,
    nz) or ("leaf", index), and the (Nleaf, ncols) f64 leaf rows."""
    tokens, values = [], []
    with open(path) as f:
        for line in f:
            t = line.strip()
            if not t or t.startswith("#"):
                continue
            if t.startswith("!"):
                parts = t[1:].split()
                tokens.append(("node", int(parts[0]), int(parts[1]),
                               int(parts[2])))
            else:
                tokens.append(("leaf", len(values)))
                values.append([float(v) for v in t.split()])
    return tokens, np.asarray(values, np.float64)


def build_amr(path: str, extent) -> tuple[AMRGrid, np.ndarray]:
    """The grid (CPU tensors) and the leaf rows of an AMR file in the box
    `extent` ((x0, x1), (y0, y1), (z0, z1)): the reference's `build_amr`
    arrays, with an explicit stack of open nonleaf nodes instead of its
    recursion."""
    tokens, values = parse_amr_file(path)
    lo = np.array([extent[a][0] for a in range(3)], np.float64)
    hi = np.array([extent[a][1] for a in range(3)], np.float64)
    M = len(tokens)
    node_lo = np.empty((M, 3), np.float64)
    node_span = np.empty((M, 3), np.float64)
    node_div = np.zeros((M, 3), np.int64)
    node_cell = np.full(M, -1, np.int64)
    cell_nodes = []
    closed = []               # (nid, child ids) as each nonleaf completes
    stack = []                # open nonleaf nodes: [nid, lo, sub, div, ids]
    max_depth = 1
    for nid, tok in enumerate(tokens):
        if stack:
            top = stack[-1]
            k = len(top[4])
            nx, ny, _ = top[3]
            ijk = np.array([k % nx, (k // nx) % ny, k // (nx * ny)],
                           np.float64)
            blo, bspan = top[1] + top[2] * ijk, top[2]
            top[4].append(nid)
        elif nid == 0:
            blo, bspan = lo, hi - lo
        else:
            raise ValueError(f"{path}: nodes past the end of the root")
        node_lo[nid], node_span[nid] = blo, bspan
        max_depth = max(max_depth, len(stack) + 1)
        if tok[0] == "leaf":
            node_cell[nid] = tok[1]
            cell_nodes.append(nid)
        else:
            div = tok[1:]
            node_div[nid] = div
            stack.append([nid, blo, bspan / np.array(div, np.float64), div,
                          []])
        # close every nonleaf node whose last child is now complete
        while stack and len(stack[-1][4]) == int(np.prod(stack[-1][3])):
            done = stack.pop()
            closed.append((done[0], done[4]))
    if stack:
        raise ValueError(f"{path}: the Morton stream ends inside a node")
    child_base = np.full(M, -1, np.int64)
    child_flat = []
    for nid, ids in closed:
        child_base[nid] = len(child_flat)
        child_flat.extend(ids)
    if not child_flat:        # a single-leaf mesh
        child_flat = [0]
    cells = np.asarray(cell_nodes, np.int64)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32))
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32))
    return AMRGrid(node_lo=f32(node_lo), node_span=f32(node_span),
                   node_div=i32(node_div), node_child=i32(child_base),
                   node_cell=i32(node_cell), child_flat=i32(child_flat),
                   cell_lo=f32(node_lo[cells]),
                   cell_hi=f32(node_lo[cells] + node_span[cells]),
                   box_lo=f32(lo), box_hi=f32(hi),
                   depth=int(max_depth + 1)), values
