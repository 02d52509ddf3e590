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

Both passes are CUDA kernels on the GPU (`csrc/sweepxl_dtau.cu`,
`csrc/sweepxl_deposit.cu`) beside their plain PyTorch versions. The tables
are the flat (ncells, C) f32 density of `sweep.SweepTables`, shared and not
copied: the reference's streamed (C, nmax, 3, U, V) planes, their bf16 hi/lo
or int8 splits and the one-hot matmul lookups are MXU and VMEM workarounds
and are not carried over. Tree fine rasters (`build_tree_tables`) come with
the tree slice and raise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..grids.cartesian import UniformCartesianGrid
from ..kernels import build as kb
from . import sweep as sw


class XLTables(NamedTuple):
    """Flat density table + static grid geometry for the XL contracts."""

    nd: torch.Tensor   # (ncells, C) f32, contiguous; shared with SweepTables
    n: tuple           # (nx, ny, nz)
    lo: tuple          # box minimum per axis
    h: tuple           # cell size per axis
    nmax: int          # max(nx, ny, nz): slabs per lane in the records
    axes: tuple        # sweep.grid_axes: (lo, hi, 1/h) as (3,) f32 tensors
    geom: dict         # sweep.axis_tables: the per-axis tables
    cellmap: torch.Tensor | None = None   # tree-raster voxel -> cell (unused)

    @property
    def ncomp(self) -> int:
        return self.nd.shape[1]


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
    raise NotImplementedError("tree grids on the XL engine (fine-voxel "
                              "rasters) are not ported yet")


def build_tree_tables(grid, med) -> XLTables:
    raise NotImplementedError("tree grids on the XL engine (fine-voxel "
                              "rasters) are not ported yet")


def build_tables(grid, med) -> XLTables:
    st = sw.build_tables(grid, med)
    return XLTables(nd=st.nd, n=st.n, lo=st.lo, h=st.h, nmax=st.nmax,
                    axes=st.axes, geom=st.geom)


def lane_order(tabs: XLTables, pos, dirn, group):
    """Stable permutation sorting lanes by (dominant axis, sign of the major
    direction, entry slab), the key of `skirt9_tpu/transport/lifecycle.py:
    817-836`. Sorted lanes put neighbouring threads of the kernels on the
    same slab layout and on nearby cells."""
    lo, h = tabs.geom["lo"][group], tabs.geom["h"][group]
    pa = pos.gather(1, group[:, None])[:, 0]
    da = dirn.gather(1, group[:, None])[:, 0]
    t_ent = torch.clamp(((pa - lo) / h).to(torch.int32), 0, tabs.nmax - 1)
    key = (group * 2 + (da > 0).to(group.dtype)) * tabs.nmax + t_ent
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


def _deposit_plain(tabs, pos, dirn, group, smin, smax, dtau_sub, scale,
                   n_groups):
    steps, _ = sw._slab_cells(tabs, pos, dirn, group, smin, smax)
    tau_loc = torch.zeros_like(scale)
    contribs, cells = [], []
    for j, (_, ds, cell) in enumerate(steps):
        dtau = dtau_sub[:, j]
        contribs.append(scale * torch.exp(-tau_loc) * ds
                        * sw._segment_factor(dtau))
        cells.append(cell)
        tau_loc = tau_loc + dtau
    return sw._deposit_sum(torch.stack(cells, dim=1),
                          torch.stack(contribs, dim=1), tabs.nd.shape[0],
                          n_groups)


# ----------------------------------------------------------- CUDA launches

def _dtau_cuda(tabs, pos, dirn, group, smin, smax, sig, want_sub):
    B, C = pos.shape[0], sig.shape[0]
    pos, dirn = pos.contiguous(), dirn.contiguous()
    shape = (tabs.nmax, 3, B) if want_sub else (tabs.nmax, B)
    out = torch.empty(shape, dtype=torch.float32, device=pos.device)
    nx, ny, nz, nmax, *geo = sw._geometry_args(tabs)
    kb.launch("sweepxl_dtau", *(t.data_ptr() for t in (
                  pos, dirn, group, smin, smax, sig, tabs.nd, out)),
              B, C, nx, ny, nz, nmax, int(want_sub), *geo, kb.stream_of(pos))
    return out


def _deposit_cuda(tabs, pos, dirn, group, smin, smax, dtau_sub, scale,
                  n_groups):
    B = pos.shape[0]
    pos, dirn = pos.contiguous(), dirn.contiguous()
    dtau_sub, scale = dtau_sub.contiguous(), scale.contiguous()
    rf = torch.zeros((n_groups, tabs.nd.shape[0]), dtype=torch.float32,
                     device=pos.device)
    nx, ny, nz, nmax, *geo = sw._geometry_args(tabs)
    kb.launch("sweepxl_deposit", *(t.data_ptr() for t in (
                  pos, dirn, group, smin, smax, dtau_sub, scale, rf)),
              B, nx, ny, nz, nmax, n_groups, *geo, kb.stream_of(pos))
    return rf


# ---------------------------------------------------------- public wrappers

def sweep_dtau(tabs: XLTables, pos, dirn, sigma, active,
               axis_hint: int | None = None, want_sub: bool = False):
    """Optical depth per slab (nmax, B), or per sub-step (nmax, 3, B) when
    want_sub, in geometric slab order and, within a slab, in ray order.
    axis_hint: the slab axis shared by all lanes (peel-off toward one
    observer). Lanes should arrive sorted by `lane_order` or `entry_order`:
    that keeps neighbouring threads on neighbouring cells; any order gives
    the same result."""
    group, smin, smax, sig = sw._prep(tabs, pos, dirn, sigma, active)
    sw._check(tabs, pos, dirn, sig)
    fn = sw._dispatch(pos, _dtau_plain, _dtau_cuda)
    return fn(tabs, pos, dirn, sw._hinted(group, axis_hint), smin, smax, sig,
              want_sub)


def sweep_dtau_plain(tabs: XLTables, pos, dirn, sigma, active,
                     axis_hint: int | None = None, want_sub: bool = False):
    """`sweep_dtau` through the plain PyTorch version on any device."""
    group, smin, smax, sig = sw._prep(tabs, pos, dirn, sigma, active)
    return _dtau_plain(tabs, pos, dirn, sw._hinted(group, axis_hint), smin,
                       smax, sig, want_sub)


def _deposit_args(tabs, pos, dirn, active, dtau_sub, scale_slab, n_groups):
    B = pos.shape[0]
    if B % n_groups:
        raise ValueError(f"batch {B} not divisible into {n_groups} groups")
    sw._check_inputs(pos, dirn, [
        (dtau_sub, (tabs.nmax, 3, B), "dtau_sub"),
        (scale_slab, (tabs.nmax, B), "scale_slab")])
    group, smin, smax = sw._lane_range(tabs, pos, dirn, active)
    return (tabs, pos, dirn, group, smin, smax, dtau_sub, scale_slab,
            n_groups)


def sweep_deposit(tabs: XLTables, pos, dirn, active, dtau_sub, scale_slab,
                  n_groups: int = 1) -> torch.Tensor:
    """RF deposits from the recorded per-sub-step optical depths, with no
    density access: scale_slab[t] * e^-tau_loc * ds * (1 - e^-dtau) / dtau
    per sub-step, into row lane // (B / n_groups).

    dtau_sub: (nmax, 3, B) from `sweep_dtau(want_sub=True)`; scale_slab:
    (nmax, B) L * e^-(tau before the slab) in geometric slab order. Returns
    (n_groups, ncells)."""
    args = _deposit_args(tabs, pos, dirn, active, dtau_sub, scale_slab,
                         n_groups)
    return sw._dispatch(pos, _deposit_plain, _deposit_cuda)(*args)


def sweep_deposit_plain(tabs: XLTables, pos, dirn, active, dtau_sub,
                        scale_slab, n_groups: int = 1) -> torch.Tensor:
    """`sweep_deposit` through the plain PyTorch version on any device."""
    return _deposit_plain(*_deposit_args(tabs, pos, dirn, active, dtau_sub,
                                         scale_slab, n_groups))


def resolve_interaction(tabs: XLTables, pos, dirn, active, dtau_sub, tb_slab,
                        tau_int):
    """Exact interaction point and cell from the per-sub-step record: find
    the slab where the ray-ordered prefix crosses tau_int, then re-derive that
    one slab's <= 3 sub-segments per lane (no density access).

    tb_slab: (nmax, B) optical depth before each slab in ray order
    (`sweep.slab_prefix`). Returns (s_int, icell int64 or -1, found)."""
    B = pos.shape[0]
    dtau_slab = torch.sum(dtau_sub, dim=1)
    rel = tau_int[None, :] - tb_slab
    hit = (rel >= 0.0) & (rel < dtau_slab) & (dtau_slab > 0)
    found = hit.any(dim=0) & active
    # the hit slab is unique per lane (tau grows along the ray): one gather
    # per table where the TPU used masked reductions
    t_hit = torch.argmax(hit.to(torch.int8), dim=0)
    rel_t = rel.gather(0, t_hit[None, :])[0]
    d_t = dtau_sub.gather(0, t_hit[None, None, :].expand(1, 3, B))[0]
    group, smin, smax = sw._lane_range(tabs, pos, dirn, active)
    g = sw._lane_geometry(tabs, pos, dirn, group)
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
