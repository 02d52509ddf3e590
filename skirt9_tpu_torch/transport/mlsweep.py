"""Multi-level slab sweep: the tree-grid engine's contracts.

Port of `skirt9_tpu/transport/mlsweep.py` for octrees and bintrees. Every
leaf of a power-of-two tree is an aligned block of voxels of the finest
level's uniform raster (the fine grid, nf per axis), so a ray marches that
raster's slabs with the resident sweep's <= 3-cell sub-DDA
(`sweep._substeps`) along a static multi-granularity plan (`_make_plan`):
steps of 2^gs fine slabs where every level the step crosses is at least
2^gs fine voxels wide, so that a step's sub-segment never straddles a leaf
boundary. One fine leaf map (fine voxel -> leaf id) then gives each
sub-segment's cell exactly, with one lookup.

  pass 1 `sweep_dtau`         -> (n_steps, B) optical depth per plan step,
         or with want_sub per sub-step (n_steps, 3, B) with the leaf id of
         each sub-step, so that nothing after it reads the density;
  pass 2 `sweep_deposit`      -> RF deposits (n_groups or nbins, ncells)
         per leaf, lane groups folded into RF bins by a bin map, and the
         interaction point, from that record;
  `resolve_interaction`       -> the interaction point alone, in plain tensor
         ops, for segments that store no RF.

Pass 1 has two more modes, which the event loop uses, as the XL sweep's
pass 1 has:
  `sweep_tau_total`   -> (B,) total optical depth (the peel-off tracer);
  `sweep_dtau_prefix` -> the record (with its leaf ids where asked), the
                         step sums, their `slab_prefix` and total, and the
                         lane range that the kernel formed, which
                         `sweep_deposit` and `resolve_interaction` take.

Both passes are CUDA kernels on the GPU (`csrc/mlsweep_dtau.cu`, which
forms the lane range itself and, for the total and the prefix, adds a
per-lane pass over its run sums, and `csrc/mlsweep_deposit.cu`) beside
their plain PyTorch versions. What the
reference needs for the TPU and the port does not: the per-level density
planes with the -1 non-leaf flag, the select loop over (level, layout,
row), the level clustering and merging that keep encoding rows and VMEM
tables small (`_cluster_levels`, `_merge_coarse_levels`), the packed
(row, col, leaf) deposit encoding, the one-hot MXU deposit and the plane
decode. The levels here are the raw stack, one per leaf signature; they
only set the plan.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..grids.bintree import BinTreeGrid
from ..grids.octree import OctreeGrid
from ..kernels import build as kb
from . import sweep as sw

NF_MAX = 256           # fine raster cells per axis the engine takes
# leaves up to which pass 2's kernel sums each block's deposits in a private
# shared-memory table (12 bytes a leaf: 96 KB leaves room for two blocks
# per SM), beyond which it adds them straight into the RF
SHARED_LEAVES = 8192


class _LevelAxis(NamedTuple):
    """One level's bounding box along the major axis of one slab layout: its
    slab range [t0, t1) in level coordinates and the fine -> level shift of
    that axis (per axis, for bintrees)."""

    t0: int
    t1: int
    sht: int


class _Level(NamedTuple):
    shift: tuple        # per-physical-axis fine-minus-level shifts
    ax: tuple           # (_LevelAxis,) * 3, layout a has major axis a


class MLTables(NamedTuple):
    """Density table, fine leaf map and the static march plan."""

    nd: torch.Tensor          # (ncells, C) f32: the medium's own table
    leafmap: torch.Tensor     # (nfx*nfy*nfz,) int32 fine voxel -> leaf id
    n: tuple                  # fine grid (nfx, nfy, nfz)
    lo: tuple                 # box lower corner
    h: tuple                  # fine cell sizes
    nmax: int                 # max(n): fine slabs along the longest axis
    levels: tuple             # (_Level,) * L, one per leaf signature
    n_steps: int              # march steps of the plan
    step_tlev: torch.Tensor   # (n_steps,) int32 slab index at granularity gs
    step_gs: torch.Tensor     # (n_steps,) int32 granularity shift
    axes: tuple               # sweep.grid_axes of the fine grid
    geom: dict                # sweep.axis_tables of the fine grid

    @property
    def ncomp(self) -> int:
        return self.nd.shape[1]


# ------------------------------------------------------------------ host side

def _signature_levels(grid) -> np.ndarray:
    """(ncells, 3) per-axis refinement level of every leaf: its size is
    box / 2^l along each axis. Raises ValueError when a leaf is not a
    power-of-two fraction of the root box (`mlsweep.py:274-284`)."""
    lo0 = grid.box_lo.cpu().numpy().astype(np.float64)
    hi0 = grid.box_hi.cpu().numpy().astype(np.float64)
    size = (grid.cell_hi.cpu().numpy().astype(np.float64)
            - grid.cell_lo.cpu().numpy().astype(np.float64))
    lev_f = np.log2((hi0 - lo0)[None, :] / np.maximum(size, 1e-300))
    lev = np.rint(lev_f).astype(np.int64)
    if (np.abs(lev_f - lev) > 1e-3).any():
        raise ValueError("cells are not power-of-two fractions of the box")
    return lev


def _analyze(grid) -> dict:
    """Host: classify leaves by signature (per-axis levels), one level per
    signature with its leaves' ids and level coordinates (the raw level
    stack; the reference's candidate search over merged and clustered
    layouts is a TPU budget, `mlsweep.py:295-309`)."""
    lev = _signature_levels(grid)
    lo0 = grid.box_lo.cpu().numpy().astype(np.float64)
    box = grid.box_hi.cpu().numpy().astype(np.float64) - lo0
    clo = grid.cell_lo.cpu().numpy().astype(np.float64)
    Lmax = tuple(int(v) for v in lev.max(axis=0))
    sigs, inverse = np.unique(lev, axis=0, return_inverse=True)
    order = sorted(range(len(sigs)), key=lambda i: (int(sigs[i].sum()),
                                                     tuple(sigs[i])))
    coords = {}
    for i in order:
        sig = tuple(int(v) for v in sigs[i])
        ids = np.flatnonzero(inverse.reshape(-1) == i)
        hsig = box / (1 << np.asarray(sig))
        coords[sig] = (ids, np.rint((clo[ids] - lo0) / hsig).astype(np.int64))
    return {"coords": coords, "Lmax": Lmax, "nf": tuple(1 << L for L in Lmax),
            "lo0": lo0, "box": box, "levels": _level_meta(coords, Lmax)}


def _level_meta(coords, Lmax):
    """Per level: its shifts and, per slab layout, its bounding box along
    the major axis (`mlsweep.py:445-470`, reduced to what the plan reads)."""
    levels = []
    for sig, (_, cl) in coords.items():
        shifts = tuple(Lmax[i] - sig[i] for i in range(3))
        lo, hi = cl.min(axis=0), cl.max(axis=0) + 1
        levels.append(_Level(shift=shifts, ax=tuple(
            _LevelAxis(int(lo[a]), int(hi[a]), shifts[a]) for a in range(3))))
    return tuple(levels)


def _make_plan(levels, nmax: int):
    """Static multi-granularity march plan over the fine slab axis
    (`mlsweep.py:143-193`).

    Granularity at fine slab t = min over (level, axis-layout) pairs whose
    bounding box covers t of the level's minimum per-axis shift: every
    covering level's voxels are then aligned blocks of >= 2^gs fine voxels
    along all three axes, so a gs-granularity sub-DDA step never straddles a
    leaf boundary. Aligned greedy packing gives the steps. Returns (tlev,
    gs) as (n_steps,) int32 arrays: each step's slab index at its
    granularity and the granularity shift. The reference then groups the
    steps into segments of constant (gs, covering levels) to prune its
    select loop per segment, and broadcasts the step tables across 128
    lanes; the port needs neither."""
    gs_t = np.zeros(nmax, np.int64)
    for t in range(nmax):
        gh = None
        for lv in levels:
            for a in range(3):
                g = lv.ax[a]
                if g.t0 <= (t >> g.sht) < g.t1:
                    m = min(lv.shift)
                    gh = m if gh is None else min(gh, m)
        gs_t[t] = 0 if gh is None else gh
    tlev, gs = [], []
    t = 0
    while t < nmax:
        g = int(gs_t[t])
        while g > 0 and (t % (1 << g) or (gs_t[t:t + (1 << g)] < g).any()):
            g -= 1
        tlev.append(t >> g)
        gs.append(g)
        t += 1 << g
    return np.asarray(tlev, np.int32), np.asarray(gs, np.int32)


def supports(grid, med, options=None) -> bool:
    """True when (grid, medium) takes the multi-level sweep.

    The reference's tree-class, option and component gates
    (`mlsweep.py:225-234`) and its fine-raster cap max(nf) <= 256
    (`:248-250`). It departs from the reference on purpose: the backend
    test, the encoding-row cap and the VMEM table cap (`:222-224`,
    `:239-247`, `:251-261`) are TPU limits and are dropped. So, for
    example, `bench_config3ismxl`'s 1.4e5-leaf octree (nf = 256) rides
    this engine here, where the reference sends it to the XL fine raster
    (`skirt9_tpu/simulation.py:216-217`)."""
    if not isinstance(grid, (OctreeGrid, BinTreeGrid)):
        return False
    if options is not None and (options.kinematics or options.lya
                                or options.compton or options.xray
                                or options.explicit_absorption):
        return False
    if med.ncomp > 4:
        return False
    try:
        lev = _signature_levels(grid)
    except ValueError:
        return False
    return (1 << int(lev.max())) <= NF_MAX


def owner_map(meta) -> np.ndarray:
    """The (nfx, nfy, nfz) int32 fine voxel -> leaf id map of an `_analyze`
    result, vectorised per level (every leaf writes its aligned block of
    voxels at once); -1 where no leaf lies."""
    nf, Lmax = meta["nf"], meta["Lmax"]
    owner = np.full(nf, -1, np.int32)
    for sig, (ids, cl) in meta["coords"].items():
        blocks = []
        for a in range(3):
            s = Lmax[a] - sig[a]
            idx = (cl[:, a:a + 1] << s) + np.arange(1 << s)   # (n_l, 2^s)
            shape = [len(ids), 1, 1, 1]
            shape[a + 1] = 1 << s
            blocks.append(idx.reshape(shape))
        owner[blocks[0], blocks[1], blocks[2]] = ids[:, None, None, None]
    return owner


def build_tables(grid, med) -> MLTables:
    """The leaf map (vectorised per level), the raw level stack and the
    plan, on the medium's device; the density is the medium's table."""
    meta = _analyze(grid)
    nf = meta["nf"]
    leafmap = owner_map(meta)
    nmax = int(max(nf))
    tlev, gs = _make_plan(meta["levels"], nmax)
    dev = med.nd.device
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    hf = meta["box"] / np.asarray(nf, np.float64)
    n = tuple(int(v) for v in nf)
    lo = tuple(float(v) for v in meta["lo0"])
    h = tuple(float(v) for v in hf)
    return MLTables(nd=med.nd.contiguous(), leafmap=i32(leafmap.reshape(-1)),
                    n=n, lo=lo, h=h, nmax=nmax,
                    levels=meta["levels"], n_steps=len(tlev),
                    step_tlev=i32(tlev), step_gs=i32(gs),
                    axes=sw.grid_axes(lo, n, h, dev),
                    geom=sw.axis_tables(lo, n, h, dev))


def locate_cells(tabs: MLTables, pos) -> torch.Tensor:
    """Fine-raster locate (`mlsweep.py:1106-1116`): position -> leaf id
    (int64), -1 outside."""
    lo, h, nf = tabs.geom["lo"], tabs.geom["h"], tabs.geom["n"]
    ijk = torch.floor((pos - lo) / h).to(torch.int64)
    inside = torch.all((ijk >= 0) & (ijk < nf), dim=-1)
    ijk = torch.minimum(torch.clamp_min(ijk, 0), nf - 1)
    flat = (ijk[..., 0] * tabs.n[1] + ijk[..., 1]) * tabs.n[2] + ijk[..., 2]
    cell = tabs.leafmap[flat].to(torch.int64)
    return torch.where(inside, cell, torch.full_like(cell, -1))


# ------------------------------------------------------- plain PyTorch versions

def _scaled(g: dict, gs) -> dict:
    """Per-lane geometry at granularity 2^gs (the reference's
    `_scaled_geom`, `mlsweep.py:707-716`): cell sizes x 2^gs, counts >> gs.
    gs broadcasts against the lanes: (n_steps, 1) or (B,)."""
    scale = torch.bitwise_left_shift(torch.ones_like(gs), gs).to(torch.float32)
    gg = dict(g)
    for k in ("ha", "hu", "hv"):
        gg[k] = g[k] * scale
    for k in ("na", "nu", "nv"):
        gg[k] = torch.bitwise_right_shift(g[k], gs)
    return gg


def _plan_substeps(tabs, pos, dirn, group, smin, smax):
    """The <= 3 sub-steps of every (plan step, lane) at the step's
    granularity: [(s_cur, ds, iu, iv)] * 3 as (n_steps, B) tensors (minor
    indices at the step's granularity), the fine slab index tf (n_steps, 1),
    the mask of live steps (the slab exists on the lane's axis and the ray
    crosses it) and the fine per-lane geometry."""
    g = sw._lane_geometry(tabs, pos, dirn, group)
    tlev = tabs.step_tlev.to(torch.int64)[:, None]
    gs = tabs.step_gs.to(torch.int64)[:, None]
    gg = _scaled(g, gs)
    subs, act = sw._substeps(gg, tlev, smin, smax)
    live = act & (tlev < gg["na"])
    return subs, tlev, gs, live, g


def _leaf_ids(tabs, group, tlev, gs, iu, iv, live, na):
    """Leaf id of each sub-step: its fine voxel (tlev, iu, iv) << gs mapped
    to (x, y, z) by the axis layout (a=0: (t, u, v) = (x, y, z); a=1:
    (y, x, z); a=2: (z, x, y)), x-major flat index, -1 on dead steps."""
    a = group.to(torch.int64)
    tf = torch.minimum(tlev << gs, na - 1)
    uf, vf = iu << gs, iv << gs
    x = torch.where(a == 0, tf, uf)
    y = torch.where(a == 0, uf, torch.where(a == 1, tf, vf))
    z = torch.where(a == 2, tf, vf)
    flat = (x * tabs.n[1] + y) * tabs.n[2] + z
    cell = tabs.leafmap[flat].to(torch.int64)
    return torch.where(live, cell, torch.full_like(cell, -1))


def _march_plain(tabs, pos, dirn, group, smin, smax, sig):
    """Per sub-step (dtau, cell) as (n_steps, B) tensors: sum_c nd[cell, c]
    * sig[c] * ds, zero where the cell is -1. The kernel's f32 operations,
    in its order."""
    subs, tlev, gs, live, g = _plan_substeps(tabs, pos, dirn, group, smin,
                                             smax)
    out = []
    for _, ds, iu, iv in subs:
        cell = _leaf_ids(tabs, group, tlev, gs, iu, iv, live, g["na"])
        c0 = torch.clamp_min(cell, 0)
        k = tabs.nd[c0, 0] * sig[0]
        for c in range(1, sig.shape[0]):
            k = k + tabs.nd[c0, c] * sig[c]
        out.append((torch.where(cell >= 0, k * ds, torch.zeros_like(ds)),
                    cell))
    return out


def _dtau_plain(tabs, pos, dirn, group, smin, smax, sig, want_sub):
    steps = _march_plain(tabs, pos, dirn, group, smin, smax, sig)
    if want_sub:
        return (torch.stack([d for d, _ in steps], dim=1),
                torch.stack([c for _, c in steps], dim=1).to(torch.int32))
    return steps[0][0] + steps[1][0] + steps[2][0]


def _pass1_plain(tabs, pos, dirn, sig, active, axis_hint, want_sub):
    group, smin, smax = sw._lane_range(tabs, pos, dirn, active)
    return _dtau_plain(tabs, pos, dirn, sw._hinted(group, axis_hint), smin,
                       smax, sig, want_sub)


def _total_plain(tabs, pos, dirn, sig, active, axis_hint):
    return torch.sum(_pass1_plain(tabs, pos, dirn, sig, active, axis_hint,
                                  False), dim=0)


def _prefix_plain(tabs, pos, dirn, sig, active, axis_hint, leaf_ids):
    group, smin, smax = sw._lane_range(tabs, pos, dirn, active)
    group = sw._hinted(group, axis_hint)
    rec, cells = _dtau_plain(tabs, pos, dirn, group, smin, smax, sig, True)
    # the summed form of the same march: (d0 + d1) + d2 per step
    dtau = (rec[:, 0] + rec[:, 1]) + rec[:, 2]
    dmaj = dirn.gather(1, group.to(torch.int64)[:, None])[:, 0]
    tb, total = sw.slab_prefix(dtau, dmaj > 0)
    return (rec, cells if leaf_ids else None, dtau, tb, total,
            (group, smin, smax))


def _deposit_rows(B: int, n_groups: int, bin_map, rows: int, device):
    """(B,) int64 RF row of every lane: lane l is in group g = l // (B /
    n_groups) and deposits into row bin_map[g], or g without a bin map; -1
    where that row lies outside [0, rows) (its deposits are dropped)."""
    grp = torch.arange(B, device=device) // (B // n_groups)
    row = grp if bin_map is None else bin_map.to(torch.int64)[grp]
    return torch.where((row >= 0) & (row < rows), row,
                       torch.full_like(row, -1))


def _deposit_plain(tabs, pos, dirn, group, smin, smax, dtau_sub, cell_sub,
                   lum_pre, tau_int, tb_slab, inv2, n_groups=1, bin_map=None,
                   rows=1):
    """RF deposits into (rows, ncells), the kernel's f32 contributions summed
    per (row, leaf) in f64, and the first interaction in (step, sub-step)
    order: (rf, s_int, found), s_int undefined where not found. Lane l's
    deposits go to its group's row (`_deposit_rows`)."""
    B = pos.shape[0]
    subs, _, _, live, _ = _plan_substeps(tabs, pos, dirn, group, smin, smax)
    scale = (lum_pre[None, :] * torch.exp(-tb_slab)) * inv2
    rel = tau_int[None, :] - tb_slab
    tau_loc = torch.zeros_like(scale)
    row = _deposit_rows(B, n_groups, bin_map, rows, pos.device)
    keep = live & (row >= 0)[None, :]
    contribs, hits, s_hits = [], [], []
    for j, (s_cur, ds, _, _) in enumerate(subs):
        dtau = dtau_sub[:, j]
        contrib = scale * torch.exp(-tau_loc) * ds * sw._segment_factor(dtau)
        contribs.append(torch.where(keep & (cell_sub[:, j] >= 0), contrib,
                                    torch.zeros_like(contrib)))
        rem = rel - tau_loc
        hits.append(live & (rem >= 0.0) & (rem < dtau))
        s_hits.append(s_cur + rem / torch.clamp_min(dtau, 1e-37) * ds)
        tau_loc = tau_loc + dtau
    hit = torch.stack(hits, dim=1).reshape(-1, B)
    first = torch.argmax(hit.to(torch.int8), dim=0)[None, :]
    s_int = torch.stack(s_hits, dim=1).reshape(-1, B).gather(0, first)[0]
    # the f32 contributions summed in f64, as the kernel sums them: a leaf
    # gathers some 10^5 of them per event, too many for an f32 sum
    ncells = tabs.nd.shape[0]
    key = (torch.clamp_min(row, 0)[None, None, :] * ncells
           + torch.clamp_min(cell_sub.to(torch.int64), 0))
    rf = torch.zeros(rows * ncells, dtype=torch.float64, device=pos.device)
    rf.index_add_(0, key.reshape(-1),
                  torch.stack(contribs, dim=1).reshape(-1).to(torch.float64))
    return rf.to(torch.float32).reshape(rows, ncells), s_int, hit.any(dim=0)


# ----------------------------------------------------------- CUDA launches

def _geometry_args(tabs: MLTables):
    return (*tabs.n, tabs.n_steps, *tabs.lo, *tabs.h)


# pass 1's output modes (csrc/mlsweep_dtau.cu) and the counter of each: the
# reference's two contracts under one name
_MODES = ("summed", "want_sub", "total", "prefix")
_COUNTERS = ("mlsweep_dtau", "mlsweep_dtau", "mlsweep_tau_total",
             "mlsweep_dtau_prefix")
# pass 1's plan steps per thread (perf/kernel4_variants.py times others)
RUN = 16


def _dtau_cuda(tabs, pos, dirn, sig, active, hint, mode: str,
               leaf_ids: bool = True):
    """One launch of pass 1 in the given mode, the lane set-up inside:
    summed -> (n_steps, B); want_sub -> (record (n_steps, 3, B), leaf ids);
    total -> (B,); prefix -> (record, leaf ids or None, step sums (n_steps,
    B), prefix (n_steps, B), total, (group, smin, smax))."""
    B, C = pos.shape[0], sig.shape[0]
    NS = tabs.n_steps
    dev = pos.device
    pos, dirn = pos.contiguous(), dirn.contiguous()
    act = active.to(torch.bool).contiguous()
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    out = cells = steps = prefix = total = runsum = lane_out = None
    if mode == "summed":
        out = f32(NS, B)
    elif mode != "total":
        out = f32(NS, 3, B)
        if mode == "want_sub" or leaf_ids:
            cells = torch.empty((NS, 3, B), dtype=torch.int32, device=dev)
    if mode in ("total", "prefix"):
        total = f32(B)
        runsum = f32(-(-NS // RUN), B)
    if mode == "prefix":
        steps, prefix = f32(NS, B), f32(NS, B)
        lane_out = (torch.empty(B, dtype=torch.int32, device=dev), f32(B),
                    f32(B))
    ptr = lambda t: None if t is None else t.data_ptr()
    nx, ny, nz, n_steps, *geo = _geometry_args(tabs)
    k = _MODES.index(mode)
    kb.launch("mlsweep_dtau", *(ptr(t) for t in (
                  pos, dirn, act, sig, tabs.nd, tabs.leafmap, tabs.step_tlev, tabs.step_gs, out, cells,
                  steps, prefix, total, runsum, *(lane_out or (None,) * 3))),
              B, C, nx, ny, nz, n_steps, -1 if hint is None else int(hint),
              k, RUN, *geo, *(1.0 / v for v in tabs.h), kb.stream_of(pos),
              count_as=_COUNTERS[k])
    if mode == "summed":
        return out
    if mode == "want_sub":
        return out, cells
    if mode == "total":
        return total
    return out, cells, steps, prefix, total, lane_out


def _sub_cuda(tabs, pos, dirn, sig, active, hint, want_sub):
    return _dtau_cuda(tabs, pos, dirn, sig, active, hint,
                      "want_sub" if want_sub else "summed")


def _prefix_cuda(tabs, pos, dirn, sig, active, hint, leaf_ids):
    return _dtau_cuda(tabs, pos, dirn, sig, active, hint, "prefix",
                      leaf_ids=leaf_ids)


def _deposit_cuda(tabs, pos, dirn, group, smin, smax, dtau_sub, cell_sub,
                  lum_pre, tau_int, tb_slab, inv2, n_groups=1, bin_map=None,
                  rows=1):
    B = pos.shape[0]
    dev = pos.device
    ncells = tabs.nd.shape[0]
    args = [t.contiguous() for t in (pos, dirn, group, smin, smax, dtau_sub,
                                     cell_sub, lum_pre, tau_int, tb_slab)]
    # f64 accumulator, rounded to f32 once (see csrc/mlsweep_deposit.cu)
    rf = torch.zeros((rows, ncells), dtype=torch.float64, device=dev)
    # (step << 32 | bits of s_int) of the first hit, all ones for none
    first = torch.empty((B,), dtype=torch.int64, device=dev)
    nx, ny, nz, n_steps, *geo = _geometry_args(tabs)
    # the block-private shared-memory table serves one lane group only
    shared = int(n_groups == 1 and ncells <= SHARED_LEAVES)
    kb.launch("mlsweep_deposit", *(t.data_ptr() for t in (
                  *args, tabs.step_tlev, tabs.step_gs)),
              None if bin_map is None else bin_map.data_ptr(),
              rf.data_ptr(), first.data_ptr(), B, nx, ny, nz, n_steps,
              ncells, n_groups, rows, shared, *geo, float(inv2),
              kb.stream_of(pos))
    # the low word of each little-endian int64 holds the f32 bits of s_int
    s_int = first.view(torch.int32).reshape(B, 2)[:, 0].view(torch.float32)
    return rf.to(torch.float32), s_int, first != -1


# ---------------------------------------------------------- public wrappers

def _checked(tabs, pos, dirn, sigma, active):
    """The (C, B) cross sections, after checking pass 1's inputs."""
    sig = sw._sigma(sigma)
    sw._check(tabs, pos, dirn, sig)
    sw._check_lane(pos, active)
    return sig


def sweep_dtau(tabs: MLTables, pos, dirn, sigma, active,
               axis_hint: int | None = None, want_sub: bool = False):
    """Per-plan-step optical depth (n_steps, B) f32, or with want_sub
    (dtau_sub (n_steps, 3, B) f32, cell_sub (n_steps, 3, B) int32): each
    sub-step's optical depth and leaf id (-1 for none). Steps are spatially
    ordered along the major axis, so `sweep.slab_prefix` orders them along
    the ray. The reference's want_sub record packs a (row*512 + col*2 +
    leaf) code for its one-hot MXU deposit instead of the cell id
    (`mlsweep.py:681-687`). axis_hint: the slab axis shared by all lanes
    (peel-off toward one observer). The kernel forms each lane's range
    (`sweep._lane_range`) itself."""
    sig = _checked(tabs, pos, dirn, sigma, active)
    fn = sw._dispatch(pos, _pass1_plain, _sub_cuda)
    return fn(tabs, pos, dirn, sig, active, axis_hint, want_sub)


def sweep_dtau_plain(tabs: MLTables, pos, dirn, sigma, active,
                     axis_hint: int | None = None, want_sub: bool = False):
    """`sweep_dtau` through the plain PyTorch version on any device."""
    return _pass1_plain(tabs, pos, dirn, sw._sigma(sigma), active, axis_hint,
                        want_sub)


def sweep_tau_total(tabs: MLTables, pos, dirn, sigma, active,
                    axis_hint: int | None = None) -> torch.Tensor:
    """Optical depth of each lane's whole in-grid path (B,):
    `sweep_dtau(...).sum(0)` without the (n_steps, B) tensor."""
    sig = _checked(tabs, pos, dirn, sigma, active)
    fn = sw._dispatch(pos, _total_plain,
                      functools.partial(_dtau_cuda, mode="total"))
    return fn(tabs, pos, dirn, sig, active, axis_hint)


def sweep_tau_total_plain(tabs: MLTables, pos, dirn, sigma, active,
                          axis_hint: int | None = None) -> torch.Tensor:
    """`sweep_tau_total` through the plain PyTorch version on any device."""
    return _total_plain(tabs, pos, dirn, sw._sigma(sigma), active, axis_hint)


def sweep_dtau_prefix(tabs: MLTables, pos, dirn, sigma, active,
                      axis_hint: int | None = None, leaf_ids: bool = True):
    """Pass 1 for pass 2 and the interaction search: the record of
    `sweep_dtau(want_sub=True)`, its step sums (d0 + d1) + d2,
    `sweep.slab_prefix` of those in the lane's own slab axis, and the lane
    range. Returns (dtau_sub (n_steps, 3, B), cell_sub (n_steps, 3, B)
    int32 or None without leaf_ids, step sums (n_steps, B), tau before each
    step in ray order (n_steps, B), total (B,), lane = (group (B,) int32,
    smin, smax)); lane and the step sums for `sweep_deposit` and
    `resolve_interaction`."""
    sig = _checked(tabs, pos, dirn, sigma, active)
    fn = sw._dispatch(pos, _prefix_plain, _prefix_cuda)
    return fn(tabs, pos, dirn, sig, active, axis_hint, leaf_ids)


def sweep_dtau_prefix_plain(tabs: MLTables, pos, dirn, sigma, active,
                            axis_hint: int | None = None,
                            leaf_ids: bool = True):
    """`sweep_dtau_prefix` through the plain PyTorch version on any
    device."""
    return _prefix_plain(tabs, pos, dirn, sw._sigma(sigma), active,
                         axis_hint, leaf_ids)


def _deposit_args(tabs, pos, dirn, active, dtau_sub, cell_sub, lum_pre,
                  tau_int, tb_slab, n_groups, lane, bin_map, nbins):
    """The lane range and the RF rows of pass 2, after checking its inputs:
    (group, smin, smax, rows)."""
    B, NS = pos.shape[0], tabs.n_steps
    sw._check_inputs(pos, dirn, [(dtau_sub, (NS, 3, B), "dtau_sub"),
                                 (lum_pre, (B,), "lum_pre"),
                                 (tau_int, (B,), "tau_int"),
                                 (tb_slab, (NS, B), "tb_slab")])
    if cell_sub.shape != (NS, 3, B) or cell_sub.dtype != torch.int32:
        raise ValueError(f"cell_sub {tuple(cell_sub.shape)} {cell_sub.dtype} "
                         f"must be ({NS}, 3, {B}) int32")
    # with lane groups every 32-lane tile of the kernel in one group
    if n_groups < 1 or (n_groups > 1 and B % (32 * n_groups)):
        raise ValueError(f"batch {B} not divisible into {n_groups} groups of "
                         "32-lane tiles")
    return (*sw._lanes(tabs, pos, dirn, active, lane),
            sw.bin_rows(pos, n_groups, bin_map, nbins))


def _interaction_cells(tabs, pos, dirn, s_int, found):
    s_int = torch.where(found, torch.clamp_min(s_int, 0.0),
                        torch.zeros_like(s_int))
    icell = locate_cells(tabs, pos + s_int[:, None] * dirn)
    return s_int, torch.where(found, icell, torch.full_like(icell, -1))


def _sweep_deposit(plain: bool, tabs, pos, dirn, active, dtau_sub, cell_sub,
                   lum_pre, tau_int, tb_slab, inv2, n_groups, lane, bin_map,
                   nbins):
    group, smin, smax, rows = _deposit_args(
        tabs, pos, dirn, active, dtau_sub, cell_sub, lum_pre, tau_int,
        tb_slab, n_groups, lane, bin_map, nbins)
    fn = _deposit_plain if plain else sw._dispatch(pos, _deposit_plain,
                                                   _deposit_cuda)
    rf, s_int, found = fn(tabs, pos, dirn, group, smin, smax, dtau_sub,
                          cell_sub, lum_pre, tau_int, tb_slab, inv2, n_groups,
                          bin_map, rows)
    s_int, icell = _interaction_cells(tabs, pos, dirn, s_int, found)
    return rf, s_int, icell, found


def sweep_deposit(tabs: MLTables, pos, dirn, active, dtau_sub, cell_sub,
                  lum_pre, tau_int, tb_slab, inv2: float, n_groups: int = 1,
                  lane=None, bin_map=None, nbins: int = 0):
    """Pass 2: RF deposits per leaf and the interaction point, from pass 1's
    record (no density or leaf-map access in the march).

    lum_pre (B,): masked luminosity pre-scaled by 1/sqrt(rf_scale); inv2: the
    second 1/sqrt(rf_scale), applied per step as scale = lum_pre *
    e^-tb * inv2; tau_int (B,): the sampled interaction optical depth;
    tb_slab (n_steps, B): optical depth before each step in ray order.
    n_groups: bin-pure lane groups (B a multiple of 32 n_groups where
    there are several); lane l's
    deposits go to row l // (B / n_groups), or with bin_map ((n_groups,)
    int32) to row bin_map[group] of nbins rows (an entry outside [0,
    nbins), -1 among them: dropped), summed from zero in this call.
    Returns (rf_delta (n_groups or nbins, ncells), s_int (B,), icell (B,)
    int64 or -1, found (B,) bool): the reference's return after its
    `finalize_rf` per group (plane space -> cells, `mlsweep.py:1127-1135`)
    and the fold of the groups into bins, which the port does not need
    since deposits land per leaf and row. icell comes from `locate_cells`
    at the interaction point, as in the reference (`mlsweep.py:1014-1017`).
    lane: pass 1's (group, smin, smax) (`sweep._lane_range`), where the
    caller has it already."""
    return _sweep_deposit(False, tabs, pos, dirn, active, dtau_sub, cell_sub,
                          lum_pre, tau_int, tb_slab, inv2, n_groups, lane,
                          bin_map, nbins)


def sweep_deposit_plain(tabs: MLTables, pos, dirn, active, dtau_sub,
                        cell_sub, lum_pre, tau_int, tb_slab, inv2: float,
                        n_groups: int = 1, lane=None, bin_map=None,
                        nbins: int = 0):
    """`sweep_deposit` through the plain PyTorch version on any device."""
    return _sweep_deposit(True, tabs, pos, dirn, active, dtau_sub, cell_sub,
                          lum_pre, tau_int, tb_slab, inv2, n_groups, lane,
                          bin_map, nbins)


def resolve_interaction(tabs: MLTables, pos, dirn, active, dtau_sub, tb_slab,
                        tau_int, lane=None, dtau_step=None):
    """Exact interaction point from the per-sub-step record in plain tensor
    ops (`mlsweep.py:1021-1103`): the plan step where the ray-ordered prefix
    crosses tau_int, then that step's <= 3 sub-segments re-derived at its
    granularity. lane: pass 1's (group, smin, smax) and dtau_step: its step
    sums (n_steps, B), from `sweep_dtau_prefix`, where the caller has them
    (each otherwise formed here: `sweep._lane_range`, the record summed
    over its sub-steps). Returns (s_int, icell int64 or -1, found); the
    cell comes from `locate_cells`, as the reference's caller takes it
    (`lifecycle.py:896-908`)."""
    B = pos.shape[0]
    group, smin, smax = sw._lanes(tabs, pos, dirn, active, lane)
    if dtau_step is None:
        dtau_step = torch.sum(dtau_sub, dim=1)
    else:
        sw._check_inputs(pos, dirn, [(dtau_step, (tabs.n_steps, B),
                                      "dtau_step")])
    rel = tau_int[None, :] - tb_slab
    hit = (rel >= 0.0) & (rel < dtau_step) & (dtau_step > 0)
    found = hit.any(dim=0) & active
    # the hit step is unique per lane: argmax and gathers where the TPU
    # used dense takes
    t_hit = torch.argmax(hit.to(torch.int8), dim=0)
    tlev = tabs.step_tlev.to(torch.int64)[t_hit]
    gs = tabs.step_gs.to(torch.int64)[t_hit]
    rel_t = rel.gather(0, t_hit[None, :])[0]
    d_t = dtau_sub.gather(0, t_hit[None, None, :].expand(1, 3, B))[0]
    g = _scaled(sw._lane_geometry(tabs, pos, dirn, group), gs)
    steps, _ = sw._substeps(g, tlev, smin, smax)
    cum = torch.zeros_like(rel_t)
    s_int = torch.zeros_like(rel_t)
    got = torch.zeros((B,), dtype=torch.bool, device=pos.device)
    for j, (s_cur, ds, _, _) in enumerate(steps):
        dj = d_t[j]
        here = ~got & (rel_t >= cum) & (rel_t < cum + dj)
        frac = (rel_t - cum) / torch.clamp_min(dj, 1e-37)
        s_int = torch.where(here, s_cur + frac * ds, s_int)
        got = got | here
        cum = cum + dj
    found = found & got
    s_int, icell = _interaction_cells(tabs, pos, dirn, s_int, found)
    return s_int, icell, found
