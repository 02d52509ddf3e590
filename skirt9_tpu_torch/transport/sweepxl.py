"""Large-grid slab sweep: the XL engine's contracts on uniform grids.

Port of `skirt9_tpu/transport/sweepxl.py` for uniform Cartesian grids past
the resident sweep's ceiling (`sweep.supports_sweep`), up to 512 cells per
axis. The physics is the resident sweep's: each lane marches the slabs of
its dominant axis with the same <= 3-cell sub-DDA (`sweep._substeps`). What
differs is the contract:

  pass 1 `sweep_dtau(want_sub=True)` -> (nmax, 3, B) optical depth per
         sub-step, recorded so that nothing after it reads the density;
  `resolve_interaction`               -> the interaction point from that
         record, in plain tensor ops (XLA in the reference);
  pass 2 `sweep_deposit`              -> RF deposits (n_groups, ncells) from
         the record and the per-slab scale.

Each pass has more modes, which the event loop uses, as the resident
sweep's passes have:
  `sweep_tau_total`      -> (B,) total optical depth (the peel-off tracer);
  `sweep_dtau_prefix`    -> the record, its `slab_prefix` and total, and
                            the lane range that the kernel formed;
  `sweep_deposit_prefix` -> pass 2 from that record, prefix and lane range
                            with the interaction search inside: the RF
                            deposits of `sweep_deposit` on the scale the
                            loop forms from the prefix, where an RF is
                            stored, and the interaction point of
                            `resolve_interaction`, bit for bit.

Both passes are CUDA kernels on the GPU (`csrc/sweepxl_dtau.cu`, which
forms the lane range itself and, for the total and the prefix, adds a
per-lane pass over its run sums, and `csrc/sweepxl_deposit.cu`, which in
its prefix mode adds a per-lane pass for the interaction) beside their
plain PyTorch versions. The tables
are the flat (ncells, C) f32 density of `sweep.SweepTables`, shared and not
copied: the reference's streamed (C, nmax, 3, U, V) planes, their bf16 hi/lo
or int8 splits and the one-hot matmul lookups are MXU and VMEM workarounds
and are not carried over.

The prefix mode takes bin-pure lane groups (a multi-bin RF): group g's
deposits go to row bin_map[g], and with the caller's (ncells, nbins)
accumulator they are added straight into it, in f64 (the event loop keeps
one over each segment). Trees whose fine raster the
multi-level sweep does not take (over 256 per axis, up to 512) run on their
exact voxel raster (`build_tree_tables`, `parallel/domain.py`): the tables
are the voxel density, and `cellmap` (voxel -> leaf) sends the deposits to
their leaves inside the kernel, as the reference's `_rf_finalize` folds
its voxel RF (`skirt9_tpu/simulation.py:257-274`); the event loop maps the
interaction cell through it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..grids.bintree import BinTreeGrid
from ..grids.cartesian import UniformCartesianGrid
from ..grids.octree import OctreeGrid
from ..kernels import build as kb
from ..parallel import domain as dom
from . import mlsweep as ml
from . import sweep as sw

# the fine raster per axis up to which trees run on their voxel raster
TREE_NF_MAX = 512
# the reference's ceiling on a tree raster's table bytes (its bf16 hi + lo
# planes, C * nmax * 3 * nmax^2 * 4 bytes, `sweepxl.py:152-154`)
TREE_TABLE_BYTES = 2_500_000_000


class XLTables(NamedTuple):
    """Flat density table + static grid geometry for the XL contracts."""

    nd: torch.Tensor   # (ncells, C) f32, contiguous; shared with SweepTables
    n: tuple           # (nx, ny, nz)
    lo: tuple          # box minimum per axis
    h: tuple           # cell size per axis
    nmax: int          # max(nx, ny, nz): slabs per lane in the records
    axes: tuple        # sweep.grid_axes: (lo, hi, 1/h) as (3,) f32 tensors
    geom: dict         # sweep.axis_tables: the per-axis tables
    # tree rasters: (nvox,) int32 voxel -> leaf id, and the leaf count
    cellmap: torch.Tensor | None = None
    nleaves: int = 0

    @property
    def ncomp(self) -> int:
        return self.nd.shape[1]

    @property
    def rf_cells(self) -> int:
        """Cells of the RF: the tree's leaves on a tree raster, else the
        grid's cells."""
        return self.nd.shape[0] if self.cellmap is None else self.nleaves


def supports_xl(grid, med) -> bool:
    """The reference's rule (`sweepxl.py:109-125`) without its backend test:
    a uniform grid with axes <= 512 and <= 4 components that the resident
    sweep does not take."""
    if not isinstance(grid, UniformCartesianGrid):
        return False
    if max(grid.shape) > 512 or med.ncomp > 4:
        return False
    return not sw.supports_sweep(grid, med)


def supports_tree_xl(grid, med) -> bool:
    """The reference's rule (`sweepxl.py:128-166`) without its backend
    test: a power-of-two octree or bintree that the multi-level sweep does
    not take, with a fine raster <= 512 per axis, <= 4 components, table
    bytes under the reference's ceiling, and not every leaf a fine voxel (a
    uniform grid in disguise)."""
    if not isinstance(grid, (OctreeGrid, BinTreeGrid)) or med.ncomp > 4:
        return False
    if ml.supports(grid, med):
        return False
    try:
        nf = ml._analyze(grid)["nf"]
    except ValueError:
        return False
    m = max(nf)
    if m > TREE_NF_MAX or med.ncomp * m * 3 * m * m * 4 > TREE_TABLE_BYTES:
        return False
    return nf[0] * nf[1] * nf[2] != grid.ncells


def build_tree_tables(grid, med) -> XLTables:
    """XL tables on a tree's fine voxel raster (exact: every leaf is an
    aligned block of voxels) with the voxel -> leaf map; the medium's
    device."""
    vox_grid, med_vox, cellmap = dom.voxelize_for_dd(grid, med, 1)
    return build_tables(vox_grid, med_vox)._replace(cellmap=cellmap,
                                                    nleaves=grid.ncells)


def build_tables(grid, med) -> XLTables:
    st = sw.build_tables(grid, med)
    return XLTables(nd=st.nd, n=st.n, lo=st.lo, h=st.h, nmax=st.nmax,
                    axes=st.axes, geom=st.geom)


def lane_order(tabs: XLTables, pos, dirn, group, n_groups: int = 1):
    """Stable permutation sorting lanes by (lane group, dominant axis, sign
    of the major direction, entry slab), the key of `skirt9_tpu/transport/
    lifecycle.py:817-836`. Sorted lanes put neighbouring threads of the
    kernels on the same slab layout and on nearby cells; with n_groups
    bin-pure groups of B / n_groups consecutive lanes each group stays
    where it was, so that a sorted lane's group is still its position //
    (B / n_groups)."""
    lo, h = tabs.geom["lo"][group], tabs.geom["h"][group]
    pa = pos.gather(1, group[:, None])[:, 0]
    da = dirn.gather(1, group[:, None])[:, 0]
    t_ent = torch.clamp(((pa - lo) / h).to(torch.int32), 0, tabs.nmax - 1)
    key = (group * 2 + (da > 0).to(group.dtype)) * tabs.nmax + t_ent
    if n_groups > 1:
        B = pos.shape[0]
        lanes = torch.arange(B, dtype=key.dtype, device=key.device)
        key = (lanes // (B // n_groups)) * (6 * tabs.nmax) + key
    return torch.argsort(key, stable=True)


def entry_order(tabs: XLTables, pos, axis: int):
    """Stable permutation sorting lanes by their entry slab along `axis` (the
    peel-off marches, `lifecycle.py:642-646` of the reference)."""
    t_e = ((pos[:, axis] - tabs.lo[axis]) / tabs.h[axis]).to(torch.int32)
    return torch.argsort(torch.clamp(t_e, 0, tabs.nmax - 1), stable=True)


# ------------------------------------------------------- plain PyTorch versions

def _dtau_plain(tabs, pos, dirn, group, smin, smax, sig, want_sub):
    if not want_sub:
        return sw._dtau_plain(tabs, pos, dirn, group, smin, smax, sig)
    steps, _ = sw._march_plain(tabs, pos, dirn, group, smin, smax, sig)
    return torch.stack([dtau for _, _, dtau, _ in steps], dim=1)


def _pass1_plain(tabs, pos, dirn, sig, active, axis_hint, want_sub):
    group, smin, smax = sw._lane_range(tabs, pos, dirn, active)
    return _dtau_plain(tabs, pos, dirn, sw._hinted(group, axis_hint), smin,
                       smax, sig, want_sub)


def _total_plain(tabs, pos, dirn, sig, active, axis_hint):
    return torch.sum(_pass1_plain(tabs, pos, dirn, sig, active, axis_hint,
                                  False), dim=0)


def _prefix_plain(tabs, pos, dirn, sig, active, axis_hint):
    group, smin, smax = sw._lane_range(tabs, pos, dirn, active)
    group = sw._hinted(group, axis_hint)
    rec = _dtau_plain(tabs, pos, dirn, group, smin, smax, sig, True)
    # the summed form of the same march: (d0 + d1) + d2 per slab
    dtau = (rec[:, 0] + rec[:, 1]) + rec[:, 2]
    dmaj = dirn.gather(1, group.to(torch.int64)[:, None])[:, 0]
    tb, total = sw.slab_prefix(dtau, dmaj > 0)
    return rec, tb, total, (group, smin, smax)


def _deposit_plain(tabs, pos, dirn, group, smin, smax, dtau_sub, scale,
                   n_groups, leaves: bool = False):
    """(n_groups, ncells) f32 deposits per voxel, or with leaves (n_groups,
    rf_cells) per leaf through the cell map: the f32 contributions summed
    in f64 and rounded once, so that the float atomics of kernel 7 are
    held to exact sums (an f32 sum of the ~10^3 terms of a hot cell strays
    ~1e-6 in any order)."""
    steps, _ = sw._slab_cells(tabs, pos, dirn, group, smin, smax)
    tau_loc = torch.zeros_like(scale)
    contribs, cells = [], []
    for j, (_, ds, cell) in enumerate(steps):
        dtau = dtau_sub[:, j]
        contribs.append(scale * torch.exp(-tau_loc) * ds
                        * sw._segment_factor(dtau))
        cells.append(cell)
        tau_loc = tau_loc + dtau
    cells = torch.stack(cells, dim=1)
    contribs = torch.stack(contribs, dim=1).double()
    if leaves:
        return sw._deposit_sum(tabs.cellmap[cells].to(torch.int64), contribs,
                               tabs.rf_cells, n_groups).float()
    return sw._deposit_sum(cells, contribs, tabs.nd.shape[0],
                           n_groups).float()


def _resolve_plain(tabs, pos, dirn, group, smin, smax, active, dtau_sub,
                   tb_slab, tau_int):
    """The interaction point from the record and the prefix: the slab where
    the ray-ordered prefix crosses tau_int, then that one slab's <= 3
    sub-segments re-derived per lane."""
    B = pos.shape[0]
    g = sw._lane_geometry(tabs, pos, dirn, group)
    # the slab holds tau_int when its prefix is <= tau_int and the next
    # slab's along the ray is above it (the ray's last slab has no bound):
    # the prefix alone, without summing the record over its sub-steps
    # (the reference tests tau_int - tb < the slab's sum instead)
    rel = tau_int[None, :] - tb_slab
    end = torch.full_like(tb_slab[:1], float("inf"))
    tb_next = torch.where((g["da"] > 0)[None, :],
                          torch.cat([tb_slab[1:], end]),
                          torch.cat([end, tb_slab[:-1]]))
    hit = (rel >= 0.0) & (tau_int[None, :] < tb_next)
    found = hit.any(dim=0) & active
    # the hit slab is unique per lane (the prefix grows along the ray): one
    # gather per table where the TPU used masked reductions
    t_hit = torch.argmax(hit.to(torch.int8), dim=0)
    rel_t = rel.gather(0, t_hit[None, :])[0]
    d_t = dtau_sub.gather(0, t_hit[None, None, :].expand(1, 3, B))[0]
    # the sub-DDA always walks in +s, so sub-steps are already in ray order
    steps, _ = sw._substeps(g, t_hit, smin, smax)
    cum = torch.zeros_like(rel_t)
    s_int = torch.zeros_like(rel_t)
    icell = torch.full((B,), -1, dtype=torch.int64, device=pos.device)
    got = torch.zeros((B,), dtype=torch.bool, device=pos.device)
    for j, (s_cur, ds, iu, iv) in enumerate(steps):
        dj = d_t[j]
        here = ~got & (rel_t >= cum) & (rel_t < cum + dj)
        frac = (rel_t - cum) / torch.clamp_min(dj, 1e-37)
        s_int = torch.where(here, s_cur + frac * ds, s_int)
        cell = (t_hit * g["t_stride"] + iu * g["u_stride"]
                + iv * g["v_stride"])
        icell = torch.where(here, cell, icell)
        got = got | here
        cum = cum + dj
    found = found & got
    return s_int, torch.where(found, icell, torch.full_like(icell, -1)), found


def _deposit_prefix_plain(tabs, pos, dirn, group, smin, smax, active,
                          dtau_sub, lum_half, tau_int, tb_slab, inv_sqrt,
                          n_groups, bin_map, rows, rf):
    """The reference's composition: `_deposit_plain` per lane group on the
    scale the event loop forms from the prefix (none where lum_half is
    None; on a tree raster per leaf, as the reference folds its voxel RF
    into leaves, `skirt9_tpu/simulation.py:257-274`), the groups folded
    into their rows by the bin map; added into rf ((rf_cells, rows)) where
    given. Then `_resolve_plain`."""
    out = None
    if lum_half is not None:
        scale = (lum_half[None, :] * torch.exp(-tb_slab)) * inv_sqrt
        out = sw._fold_bins(_deposit_plain(
            tabs, pos, dirn, group, smin, smax, dtau_sub, scale, n_groups,
            leaves=tabs.cellmap is not None), bin_map, rows)
        if rf is not None:
            rf += out.T
            out = rf.T
    return (out, *_resolve_plain(tabs, pos, dirn, group, smin, smax, active,
                                 dtau_sub, tb_slab, tau_int))


# ----------------------------------------------------------- CUDA launches

# pass 1's output modes (csrc/sweepxl_dtau.cu) and the counter of each: the
# reference's two contracts under one name
_MODES = ("summed", "want_sub", "total", "prefix")
_COUNTERS = ("sweepxl_dtau", "sweepxl_dtau", "sweepxl_tau_total",
             "sweepxl_dtau_prefix")
# pass 1's slabs per thread (perf/kernel6_variants.py times others)
RUN = 16
# pass 2's slabs per thread (perf/kernel7_variants.py times others)
DEPOSIT_RUN = 16


def _dtau_cuda(tabs, pos, dirn, sig, active, hint, mode: str):
    """One launch of pass 1 in the given mode, the lane set-up inside:
    summed -> (nmax, B); want_sub -> (nmax, 3, B); total -> (B,); prefix ->
    (record (nmax, 3, B), prefix (nmax, B), total, (group, smin, smax))."""
    B, C = pos.shape[0], sig.shape[0]
    dev = pos.device
    pos, dirn = pos.contiguous(), dirn.contiguous()
    act = active.to(torch.bool).contiguous()
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    out = total = runsum = prefix = lane = None
    if mode == "summed":
        out = f32(tabs.nmax, B)
    elif mode != "total":
        out = f32(tabs.nmax, 3, B)
    if mode in ("total", "prefix"):
        total = f32(B)
        runsum = f32(-(-tabs.nmax // RUN), B)
    if mode == "prefix":
        prefix = f32(tabs.nmax, B)
        lane = (torch.empty(B, dtype=torch.int32, device=dev), f32(B), f32(B))
    ptr = lambda t: None if t is None else t.data_ptr()
    nx, ny, nz, nmax, *geo = sw._geometry_args(tabs)
    k = _MODES.index(mode)
    kb.launch("sweepxl_dtau", *(ptr(t) for t in (
                  pos, dirn, act, sig, tabs.nd, out, prefix, total, runsum,
                  *(lane or (None,) * 3))),
              B, C, nx, ny, nz, nmax, -1 if hint is None else int(hint), k,
              RUN, *geo, *(1.0 / v for v in tabs.h), kb.stream_of(pos),
              count_as=_COUNTERS[k])
    if mode == "total":
        return total
    if mode == "prefix":
        return out, prefix, total, lane
    return out


# pass 2's input modes (csrc/sweepxl_deposit.cu), each counted under its name
_DEPOSIT_MODES = ("sweepxl_deposit", "sweepxl_deposit_prefix")


def _deposit_launch(tabs, pos, dirn, group, smin, smax, dtau_sub, slab, lum,
                    tau_int, active, inv_sqrt, n_groups, mode, bin_map=None,
                    rows=1, rf=None):
    """One launch of pass 2: sweepxl_deposit -> rf (n_groups, ncells);
    sweepxl_deposit_prefix -> (rf (rows, rf_cells), a view of the caller's
    (rf_cells, rows) table, or of a fresh one, or None without lum; s_int,
    icell int64, found bool). The prefix mode sums in f64: into the
    caller's table where it is f64, else into a zeroed f64 table, rounded
    once into the caller's f32 table or returned."""
    B = pos.shape[0]
    dev = pos.device
    prefix = mode == "sweepxl_deposit_prefix"
    fresh = prefix and lum is not None and (rf is None
                                            or rf.dtype != torch.float64)
    acc = None
    if not prefix:
        rf = torch.zeros((n_groups, tabs.nd.shape[0]), dtype=torch.float32,
                         device=dev)
    elif lum is None:
        rf = None
    elif fresh:
        acc, rf = rf, torch.zeros((tabs.rf_cells, rows), dtype=torch.float64,
                                  device=dev)
    out = hitrun = None
    if prefix:
        out = (torch.empty(B, dtype=torch.float32, device=dev),
               torch.empty(B, dtype=torch.int64, device=dev),
               torch.empty(B, dtype=torch.bool, device=dev))
        hitrun = torch.empty((-(-tabs.nmax // DEPOSIT_RUN), B),
                             dtype=torch.int32, device=dev)
        active = active.to(torch.bool)
    # held here, so that no contiguous copy is freed before the launch (the
    # RF, added into in place, is contiguous: `_prefix_args` checks it)
    args = [None if t is None else t.contiguous() for t in (
        pos, dirn, group, smin, smax, dtau_sub, slab, lum, tau_int, active,
        bin_map, tabs.cellmap if prefix else None, rf, hitrun,
        *(out or (None,) * 3))]
    nx, ny, nz, nmax, *geo = sw._geometry_args(tabs)
    kb.launch("sweepxl_deposit", *(None if t is None else t.data_ptr()
                                   for t in args),
              B, nx, ny, nz, nmax, n_groups, rows, DEPOSIT_RUN,
              _DEPOSIT_MODES.index(mode), *geo, float(inv_sqrt),
              kb.stream_of(pos), count_as=mode)
    if not prefix:
        return rf
    if fresh:
        rf = rf.float() if acc is None else acc.add_(rf.float())
    return (None if rf is None else rf.T, *out)


def _deposit_cuda(tabs, pos, dirn, group, smin, smax, dtau_sub, scale,
                  n_groups):
    return _deposit_launch(tabs, pos, dirn, group, smin, smax, dtau_sub,
                           scale, None, None, None, 1.0, n_groups,
                           "sweepxl_deposit")


def _deposit_prefix_cuda(tabs, pos, dirn, group, smin, smax, active,
                         dtau_sub, lum_half, tau_int, tb_slab, inv_sqrt,
                         n_groups, bin_map, rows, rf):
    return _deposit_launch(tabs, pos, dirn, group, smin, smax, dtau_sub,
                           tb_slab, lum_half, tau_int, active, inv_sqrt,
                           n_groups, "sweepxl_deposit_prefix", bin_map, rows,
                           rf)


# ---------------------------------------------------------- public wrappers

def _pass1(tabs, pos, dirn, sigma, active, axis_hint, mode, plain):
    """Check the inputs, then the plain version on the CPU or the kernel in
    the given mode on the GPU."""
    sig = sw._sigma(sigma)
    sw._check(tabs, pos, dirn, sig)
    sw._check_lane(pos, active)
    fn = sw._dispatch(pos, plain, functools.partial(_dtau_cuda, mode=mode))
    return fn(tabs, pos, dirn, sig, active, axis_hint)


def sweep_dtau(tabs: XLTables, pos, dirn, sigma, active,
               axis_hint: int | None = None, want_sub: bool = False):
    """Optical depth per slab (nmax, B), or per sub-step (nmax, 3, B) when
    want_sub, in geometric slab order and, within a slab, in ray order.
    axis_hint: the slab axis shared by all lanes (peel-off toward one
    observer). Lanes should arrive sorted by `lane_order` or `entry_order`:
    that keeps neighbouring threads on neighbouring cells; any order gives
    the same result."""
    plain = functools.partial(_pass1_plain, want_sub=want_sub)
    return _pass1(tabs, pos, dirn, sigma, active, axis_hint,
                  "want_sub" if want_sub else "summed", plain)


def sweep_dtau_plain(tabs: XLTables, pos, dirn, sigma, active,
                     axis_hint: int | None = None, want_sub: bool = False):
    """`sweep_dtau` through the plain PyTorch version on any device."""
    return _pass1_plain(tabs, pos, dirn, sw._sigma(sigma), active, axis_hint,
                        want_sub)


def sweep_tau_total(tabs: XLTables, pos, dirn, sigma, active,
                    axis_hint: int | None = None) -> torch.Tensor:
    """Optical depth of each lane's whole in-grid path (B,):
    `sweep_dtau(...).sum(0)` without the (nmax, B) tensor."""
    return _pass1(tabs, pos, dirn, sigma, active, axis_hint, "total",
                  _total_plain)


def sweep_tau_total_plain(tabs: XLTables, pos, dirn, sigma, active,
                          axis_hint: int | None = None) -> torch.Tensor:
    """`sweep_tau_total` through the plain PyTorch version on any device."""
    return _total_plain(tabs, pos, dirn, sw._sigma(sigma), active, axis_hint)


def sweep_dtau_prefix(tabs: XLTables, pos, dirn, sigma, active,
                      axis_hint: int | None = None):
    """Pass 1 for the interaction search and pass 2: the record of
    `sweep_dtau(want_sub=True)`, `sweep.slab_prefix` of its slab sums in the
    lane's own slab axis, and the lane range.
    Returns (record (nmax, 3, B), tau before each slab in ray order
    (nmax, B), total (B,), lane = (group (B,) int32, smin, smax)), lane for
    `resolve_interaction` and `sweep_deposit`."""
    return _pass1(tabs, pos, dirn, sigma, active, axis_hint, "prefix",
                  _prefix_plain)


def sweep_dtau_prefix_plain(tabs: XLTables, pos, dirn, sigma, active,
                            axis_hint: int | None = None):
    """`sweep_dtau_prefix` through the plain PyTorch version on any
    device."""
    return _prefix_plain(tabs, pos, dirn, sw._sigma(sigma), active,
                         axis_hint)


def _deposit_args(tabs, pos, dirn, active, dtau_sub, scale_slab, n_groups,
                  lane=None):
    B = pos.shape[0]
    if B % n_groups:
        raise ValueError(f"batch {B} not divisible into {n_groups} groups")
    sw._check_inputs(pos, dirn, [
        (dtau_sub, (tabs.nmax, 3, B), "dtau_sub"),
        (scale_slab, (tabs.nmax, B), "scale_slab")])
    group, smin, smax = sw._lanes(tabs, pos, dirn, active, lane)
    return (tabs, pos, dirn, group, smin, smax, dtau_sub, scale_slab,
            n_groups)


def sweep_deposit(tabs: XLTables, pos, dirn, active, dtau_sub, scale_slab,
                  n_groups: int = 1, lane=None) -> torch.Tensor:
    """RF deposits from the recorded per-sub-step optical depths, with no
    density access: scale_slab[t] * e^-tau_loc * ds * (1 - e^-dtau) / dtau
    per sub-step, into row lane // (B / n_groups).

    dtau_sub: (nmax, 3, B) from `sweep_dtau(want_sub=True)`; scale_slab:
    (nmax, B) L * e^-(tau before the slab) in geometric slab order. lane:
    pass 1's (group, smin, smax) from `sweep_dtau_prefix`, which saves the
    set-up. Returns (n_groups, ncells)."""
    args = _deposit_args(tabs, pos, dirn, active, dtau_sub, scale_slab,
                         n_groups, lane)
    return sw._dispatch(pos, _deposit_plain, _deposit_cuda)(*args)


def sweep_deposit_plain(tabs: XLTables, pos, dirn, active, dtau_sub,
                        scale_slab, n_groups: int = 1) -> torch.Tensor:
    """`sweep_deposit` through the plain PyTorch version on any device."""
    return _deposit_plain(*_deposit_args(tabs, pos, dirn, active, dtau_sub,
                                         scale_slab, n_groups))


def resolve_interaction(tabs: XLTables, pos, dirn, active, dtau_sub, tb_slab,
                        tau_int, lane=None):
    """Exact interaction point and cell from the per-sub-step record: find
    the slab where the ray-ordered prefix crosses tau_int, then re-derive that
    one slab's <= 3 sub-segments per lane (no density access), in plain
    tensor ops on any device (`sweep_deposit_prefix` does the same inside
    its kernel).

    tb_slab: (nmax, B) optical depth before each slab in ray order
    (`sweep.slab_prefix`). lane: pass 1's (group, smin, smax) from
    `sweep_dtau_prefix`, which saves the set-up. Returns (s_int, icell int64
    or -1, found)."""
    group, smin, smax = sw._lanes(tabs, pos, dirn, active, lane)
    return _resolve_plain(tabs, pos, dirn, group, smin, smax, active,
                          dtau_sub, tb_slab, tau_int)


def _prefix_args(tabs, pos, dirn, active, dtau_sub, lum_half, tau_int,
                 tb_slab, inv_sqrt, lane, n_groups, bin_map, nbins, rf):
    B = pos.shape[0]
    # with lane groups every 32-lane warp of the kernel in one group
    if n_groups < 1 or (n_groups > 1 and B % (32 * n_groups)):
        raise ValueError(f"batch {B} not divisible into {n_groups} groups of "
                         "32-lane tiles")
    sw._check_lane(pos, active, lane)
    sw._check_inputs(pos, dirn, [
        (dtau_sub, (tabs.nmax, 3, B), "dtau_sub"),
        (tb_slab, (tabs.nmax, B), "tb_slab"), (tau_int, (B,), "tau_int")]
        + ([] if lum_half is None else [(lum_half, (B,), "lum_half")]))
    rows = sw.bin_rows(pos, n_groups, bin_map, nbins)
    if rf is not None and (
            tuple(rf.shape) != (tabs.rf_cells, rows) or rf.device != pos.device
            or rf.dtype not in (torch.float32, torch.float64)
            or not rf.is_contiguous()):
        raise ValueError(f"rf {tuple(rf.shape)} {rf.dtype} must be a "
                         f"contiguous ({tabs.rf_cells}, {rows}) f32 or f64 "
                         f"table on {pos.device}: pass 2 adds into it")
    return (tabs, pos, dirn, *lane, active, dtau_sub, lum_half, tau_int,
            tb_slab, float(inv_sqrt), n_groups, bin_map, rows, rf)


def sweep_deposit_prefix(tabs: XLTables, pos, dirn, active, dtau_sub,
                         lum_half, tau_int, tb_slab, inv_sqrt: float, lane,
                         n_groups: int = 1, bin_map=None, nbins: int = 0,
                         rf=None):
    """Pass 2 from pass 1's record, prefix and lane range, with the
    interaction search inside: `sweep_deposit` on scale_slab = (lum_half *
    e^-tb_slab) * inv_sqrt, formed per (slab, lane) inside (the event loop's
    operations, in its order), and `resolve_interaction`, in one launch.

    dtau_sub (nmax, 3, B), tb_slab (nmax, B) and lane = (group, smin, smax)
    from `sweep_dtau_prefix`; active: (B,) the lanes that may interact;
    lum_half, tau_int: (B,) f32, lum_half None where no RF is stored.
    n_groups: bin-pure groups of B / n_groups consecutive lanes (B a
    multiple of 32 n_groups where there are several); group g deposits
    into row g, or with bin_map ((n_groups,) int32) into row bin_map[g] of
    nbins rows (an entry outside [0, nbins), -1 among them: dropped). On a
    tree raster the deposits land on the leaves (`cellmap`). rf: the
    caller's (rf_cells, rows) accumulator, which the deposits are added
    into in place: f64 (the event loop's, over a segment) or f32, which
    takes them summed in f64 and rounded once; without it they are summed
    from zero in this call. Returns (rf (rows, rf_cells): a view of that
    table, or None without lum_half; s_int, icell int64 (a voxel on a tree
    raster) or -1, found bool), the interaction equal to
    `resolve_interaction`'s bit for bit."""
    args = _prefix_args(tabs, pos, dirn, active, dtau_sub, lum_half, tau_int,
                        tb_slab, inv_sqrt, lane, n_groups, bin_map, nbins, rf)
    return sw._dispatch(pos, _deposit_prefix_plain,
                        _deposit_prefix_cuda)(*args)


def sweep_deposit_prefix_plain(tabs: XLTables, pos, dirn, active, dtau_sub,
                               lum_half, tau_int, tb_slab, inv_sqrt: float,
                               lane, n_groups: int = 1, bin_map=None,
                               nbins: int = 0, rf=None):
    """`sweep_deposit_prefix` through the plain PyTorch version on any
    device."""
    return _deposit_prefix_plain(*_prefix_args(
        tabs, pos, dirn, active, dtau_sub, lum_half, tau_int, tb_slab,
        inv_sqrt, lane, n_groups, bin_map, nbins, rf))
