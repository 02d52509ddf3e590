"""Spatial domain decomposition: the grid's tables sharded into x-slabs.

Port of `skirt9_tpu/parallel/domain.py` on its march route, over
torch.distributed (`parallel/dp.Group`). The per-cell tables, the number
densities and the radiation field (RF), shard into D axis-aligned x-slabs
of the (voxel-rastered) Cartesian grid, one per rank: rank r holds the
rows of slab r only. Packets do not migrate. Each rank launches the r-th
block of every global batch, as under packet data parallelism, and each
event (`dd_segment`, the reference's order):

  1. all_gathers the compact ray states (positions, directions, cross
     sections, masks, luminosities) of every rank's lanes;
  2. marches ALL gathered rays through its own slab (`_slab_march`: the
     slab's own grid, `transport/march.march_geometry`, so that on the card
     `csrc/march.cu`'s `march_uniform` or `march_mesh` launches at
     S_loc = nx_local + ny + nz + 3 steps);
  3. all_to_alls the per-slab partial optical depths to the owning ranks,
     whose sum over slabs is each lane's path depth, and samples the
     interaction depth there (`lifecycle.sample_interaction_tau`);
  4. forms each lane's depth before every slab (a prefix along the ray's
     x direction) and all_to_alls it back to the slabs, beside the
     interaction depths;
  5. deposits into the local RF rows, and finds the interaction in the one
     slab where the cumulative depth crosses it; position, cell, the
     densities there and the found flag return to the owner by a masked
     sum (one slab contributes each);
  6. runs the shared event tail (`lifecycle.albedo_and_weights`,
     `select_component_from_weights`, `peel_phase_nonpolarized`,
     `scatter_nonpolarized`, `survives_cutoff`); the peel-off's optical
     depth is the sum over slabs of each slab's partial (one all_reduce per
     observer).

The collectives are gloo's or NCCL's (`Group.all_gather`,
`Group.all_to_all`, `Group.all_reduce`). Several ranks sharing one card
run gloo, which takes host copies: each collective of an event is then a
host round trip (`Group.host_trips`), the one-card route's cost.

The XL route (the reference's on a TPU, here on the card, or with
`SKIRT9_TPU_FORCE_SWEEP=1`; one RF bin) runs each slab on the XL sweep's
contracts instead of the march (`build_local_xl`; `dd_segment(xl_local=)`,
the reference's `use_xl` branches): the gathered rays sorted by (axis,
sign, entry slab), pass 1 by `sweepxl.sweep_dtau(want_sub=True)` (kernel
6's record), the local `sweep.slab_prefix`, the RF by `sweepxl.
sweep_deposit` (kernel 7's contract mode) on the scale e^-(depth before
the slab + the local prefix), the interaction by `sweepxl.
resolve_interaction`, and the peel-off's partial depths by the summed
`sweepxl.sweep_dtau` (kernel 6). The collectives and the event's tail are
the march route's. The reference stores each slab's planes as int8 or bf16
hi/lo splits (`_quantize_rows`); the port's XL tables are the slab's f32
density rows themselves (`transport/sweepxl.py`), so its depths are the
f32 sums the reference's splits approximate to ~1e-5. Meshed grids keep
the march route: the XL tables are uniform (the reference's would take
the mean cell size).

`voxelize_for_dd` gives a non-Cartesian grid its voxel raster: a tree's
finest level (exact: every leaf is a block of voxels), or a Voronoi or
tetrahedral grid's owner raster at `SKIRT9_TPU_DD_RASTER_N` voxels an axis
(64 by default, rounded up to a multiple of D). The owner map is built
vectorised per level for trees (`mlsweep.owner_map`), where the reference
loops over leaves in Python.
"""

from __future__ import annotations

import math
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from ..grids.amr import AMRGrid
from ..grids.bintree import BinTreeGrid
from ..grids.cartesian import (CartesianGrid, UniformCartesianGrid,
                               make_cartesian)
from ..grids.octree import OctreeGrid
from ..grids.tetra import TetraGrid
from ..grids.voronoi import VoronoiGrid
from ..instruments import distant as dinst
from ..media import system as msys
from ..ops import rng
from ..ops import sampling
from ..ops import xlamath as xm
from ..sources import base as src
from ..transport import lifecycle as lc
from ..transport import march as mr
from ..transport import mlsweep as ml
from ..transport import raster
from ..transport import sweep as sw
from ..transport import sweepxl as xl
from ..utils.log import default as _log

_ISO = 1.0 / (4.0 * math.pi)


class SlabDecomposition(NamedTuple):
    """An x-slab partition of a Cartesian grid, uniform or meshed (the
    reference's, field for field; host f64 tables)."""

    n_slabs: int
    nx_local: int
    ny: int
    nz: int
    slab_lohi: np.ndarray        # (n_slabs, 6) [lo_xyz, hi_xyz] per slab
    h: np.ndarray                # (3,) cell size (uniform) or mean
    uniform: bool = True
    xb_slab: np.ndarray = None   # (n_slabs, nx_local + 1) x borders (meshed)
    yb: np.ndarray = None        # (ny + 1,) borders (meshed)
    zb: np.ndarray = None

    @property
    def ncells_local(self) -> int:
        return self.nx_local * self.ny * self.nz

    @property
    def max_steps_local(self) -> int:
        """The steps of a slab march: a straight path crosses at most
        nx_local + ny + nz cells of a slab (+ slack)."""
        return self.nx_local + self.ny + self.nz + 3


def decompose_slabs(grid, n_slabs: int) -> SlabDecomposition:
    """Partition a Cartesian grid into n equal x-slabs (the reference's
    `domain.py:102-149`). Cells are x-major, so slab s owns the global
    cells [s ncells_local, (s + 1) ncells_local)."""
    if isinstance(grid, UniformCartesianGrid):
        if grid.nx % n_slabs:
            raise ValueError(
                f"nx={grid.nx} not divisible into {n_slabs} slabs")
        nx_l = grid.nx // n_slabs
        host = lambda t: t.cpu().numpy().astype(np.float64)
        lo, hi, h = host(grid.lo), host(grid.hi), host(grid.h)
        lohi = np.empty((n_slabs, 6), np.float64)
        for s in range(n_slabs):
            lohi[s, :3] = (lo[0] + s * nx_l * h[0], lo[1], lo[2])
            lohi[s, 3:] = (lo[0] + (s + 1) * nx_l * h[0], hi[1], hi[2])
        # the outer faces exactly the grid's
        lohi[0, 0] = lo[0]
        lohi[-1, 3] = hi[0]
        return SlabDecomposition(n_slabs=n_slabs, nx_local=nx_l,
                                 ny=grid.ny, nz=grid.nz, slab_lohi=lohi, h=h)
    if isinstance(grid, CartesianGrid):
        xb, yb, zb = (b.cpu().numpy().astype(np.float64) for b in grid)
        nx, ny, nz = grid.shape
        if nx % n_slabs:
            raise ValueError(f"nx={nx} not divisible into {n_slabs} slabs")
        nx_l = nx // n_slabs
        lohi = np.empty((n_slabs, 6), np.float64)
        xbs = np.empty((n_slabs, nx_l + 1), np.float64)
        for s in range(n_slabs):
            xbs[s] = xb[s * nx_l:(s + 1) * nx_l + 1]
            lohi[s, :3] = (xbs[s][0], yb[0], zb[0])
            lohi[s, 3:] = (xbs[s][-1], yb[-1], zb[-1])
        h = np.array([(xb[-1] - xb[0]) / nx, (yb[-1] - yb[0]) / ny,
                      (zb[-1] - zb[0]) / nz])
        return SlabDecomposition(n_slabs=n_slabs, nx_local=nx_l, ny=ny,
                                 nz=nz, slab_lohi=lohi, h=h, uniform=False,
                                 xb_slab=xbs, yb=yb, zb=zb)
    raise NotImplementedError(
        "slab decomposition supports Cartesian grids (uniform or meshed)")


def _local_grid(dec: SlabDecomposition, s: int, device):
    """Slab s's own grid on device, in f32 as the reference forms it from
    the f64 tables (`domain.py:152-166`)."""
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    if not dec.uniform:
        return CartesianGrid(f32(dec.xb_slab[s]), f32(dec.yb), f32(dec.zb))
    h = f32(dec.h)
    return UniformCartesianGrid(lo=f32(dec.slab_lohi[s, :3]),
                                hi=f32(dec.slab_lohi[s, 3:]),
                                inv_h=xm.rdiv(1.0, h), h=h, nx=dec.nx_local,
                                ny=dec.ny, nz=dec.nz)


def _slab_march(grid_loc, nd_local, pos, dirn, sigma, mask, max_steps: int):
    """March all N gathered rays through the local slab (the reference's
    `domain.py:169-180`): each ray moved onto the slab where it starts
    outside it, then one march. Returns (entry positions (N, 3), local
    cells, ds, dtau), (S, N) each; a ray that misses the slab walks
    nothing."""
    p0, c0, _ = grid_loc.move_inside(pos, dirn)
    m = mask & (c0 >= 0)
    cells, ds = mr.march_geometry(grid_loc, p0, dirn, c0, max_steps, m)
    nd = nd_local[cells.to(torch.int64)]                      # (S, N, H)
    dtau = mr.step_tau(nd, sigma[None].expand_as(nd), ds)
    return p0, cells, ds, dtau


def build_local_xl(dec: SlabDecomposition, med: msys.MediumTables) -> list:
    """One `sweepxl.XLTables` per slab (the reference's `build_local_xl`,
    `domain.py:183-237`), in slab-local coordinates: x measured from the
    slab's lower border, so that every slab's tables have lo = (0, lo_y,
    lo_z) and a ray's position shifts by its slab's x offset. Each table is
    the slab's rows of the density, a view (cells are x-major), f32."""
    if not dec.uniform:
        raise ValueError("the XL tables need a uniform grid")
    n = dec.ncells_local
    shape = (dec.nx_local, dec.ny, dec.nz)
    lo = (0.0, float(dec.slab_lohi[0, 1]), float(dec.slab_lohi[0, 2]))
    h = tuple(float(v) for v in dec.h)
    dev = med.nd.device
    axes = sw.grid_axes(lo, shape, h, dev)
    geom = sw.axis_tables(lo, shape, h, dev)
    return [xl.XLTables(nd=med.nd[s * n:(s + 1) * n].contiguous(), n=shape,
                        lo=lo, h=h, nmax=max(shape), axes=axes, geom=geom)
            for s in range(dec.n_slabs)]


def _xl_sort(tabs: xl.XLTables, pos, dirn):
    """The (axis, sign, entry slab) sort of the gathered rays (the
    reference's `_xl_sort`, `domain.py:299-313`, `sweepxl.lane_order`'s
    key): (permutation, its inverse, each sorted ray's major direction
    component > 0)."""
    grp = sw.dominant_axis(tabs, dirn)
    prm = xl.lane_order(tabs, pos, dirn, grp)
    inv = torch.empty_like(prm)
    inv[prm] = torch.arange(prm.shape[0], device=prm.device)
    d_pos = dirn.gather(1, grp[:, None])[:, 0] > 0
    return prm, inv, d_pos[prm]


def shard_tables(dec: SlabDecomposition, med: msys.MediumTables, nrf: int,
                 rank: int):
    """This rank's rows of the sharded tables (the reference's
    `shard_tables`, `domain.py:638-646`): slab rank's densities (a copy,
    contiguous) and a zero RF of its cells, f64, the segment's deposits
    summed there and rounded once."""
    n = dec.ncells_local
    nd = med.nd[rank * n:(rank + 1) * n].contiguous()
    return nd, torch.zeros((n, nrf), dtype=torch.float64, device=nd.device)


def dd_segment(group, dec: SlabDecomposition, grid, nd_local,
               med: msys.MediumTables, opts: lc.TransportOptions, inst_cfgs,
               inst_tabs, rf_borders, source, n_total: int,
               hist_base: int = 0, xl_local=None):
    """The segment runner of this rank under domain decomposition (the
    reference's `dd_segment`, `domain.py:240-561`): the march route, or
    with xl_local (`build_local_xl`'s tables, one per slab) the XL route,
    which takes one RF bin.

    Returns run(seed_key, history, stabs, rf_local, accs, stats=None): one
    batch, history the (B,) histories of this rank's lanes (the r-th block
    of the global batch, the same block size on every rank), stabs the
    source's tables (an argument, so that a secondary source's new tables
    of each iteration reuse the runner); rf_local this rank's slab rows
    of the RF (f64, from `shard_tables`) or None, accs this rank's partial
    instrument accumulators. Both are updated in place; the caller reduces
    them once per segment. stats, when given, counts "events", "syncs" and
    "sync_s" as the life cycle does. grid: the simulation's grid, from
    which the sources launch; nd_local: this rank's slab densities;
    rf_borders: the RF's bin borders on the device, or None. Local
    instruments have no branch here, as in the reference, and raise."""
    D, r = group.size, group.rank
    if dec.n_slabs != D:
        raise ValueError(f"{dec.n_slabs} slabs on {D} ranks")
    local = [c.name for c in inst_cfgs if lc.is_local(c)]
    if local and opts.peel_off:
        raise NotImplementedError(
            "domain decomposition (--dd) peels off to distant instruments "
            f"only, as the reference's does; local instruments: {local}")
    dev = nd_local.device
    S_loc = dec.max_steps_local
    grid_loc = _local_grid(dec, r, dev)
    nc_loc = dec.ncells_local
    use_rf = opts.store_rf and rf_borders is not None
    nrf = rf_borders.shape[0] - 1 if use_rf else 1
    kind_direct = (dinst.KIND_PRIMARY_DIRECT if opts.primary
                   else dinst.KIND_SECONDARY_DIRECT)
    kind_scat = (dinst.KIND_PRIMARY_SCATTERED if opts.primary
                 else dinst.KIND_SECONDARY_SCATTERED)
    do_peel = bool(inst_cfgs) and opts.peel_off
    ncomp = nd_local.shape[1]
    tags = lc._path_tags(opts) + (lc._TAG_SCATTER_CT, lc._TAG_SCATTER_PHI)
    if ncomp > 1:
        tags = tags + (lc._TAG_SCATTER_COMP,)
    tag_t = torch.tensor(tags, dtype=torch.int64, device=dev)
    use_xl = xl_local is not None
    if use_xl:
        if use_rf and nrf != 1:
            raise ValueError("dd_segment: the XL route takes one RF bin (the "
                             "march route takes several)")
        tabs_loc = xl_local[r]
        # slab-local coordinates: x from the slab's lower border
        shift = torch.tensor([dec.slab_lohi[r, 0], 0.0, 0.0],
                             dtype=torch.float32, device=dev)
        inv_sqrt = 1.0 / float(np.sqrt(opts.rf_scale))

    def run(seed_key, history, stabs, rf_local, accs, stats=None):
        B = history.shape[0]
        mine = slice(r * B, (r + 1) * B)
        pkt = src.launch_batch(source, stabs, grid, seed_key, history,
                               n_total, hist_end=hist_base + n_total)
        opt = msys.optics_at(med, pkt.lam)
        if use_rf:
            rf_bin = torch.clamp(sampling.searchsorted_right(
                rf_borders, pkt.lam) - 1, 0, nrf - 1)
            rf_in = (pkt.lam >= rf_borders[0]) & (pkt.lam < rf_borders[-1])
        else:
            rf_bin = torch.zeros_like(history)
            rf_in = torch.zeros_like(pkt.alive)
        # the lanes' constants, gathered once a batch
        gsig, grfbin = group.all_gather([opt.sigma_ext.contiguous(),
                                         rf_bin.to(torch.float32)])
        grfbin = grfbin.to(torch.int64)

        def peel_tau(gpos, kobs, gmask):
            """The observer-direction depth of this rank's lanes: the sum
            over slabs of each slab's partial, an all_reduce."""
            N = gpos.shape[0]
            kdir = kobs.expand(N, 3)
            if use_xl:
                pos_all = gpos - shift
                prm, inv, _ = _xl_sort(tabs_loc, pos_all, kdir)
                part = torch.sum(xl.sweep_dtau(
                    tabs_loc, pos_all[prm], kdir[prm].contiguous(),
                    gsig.T[:, prm], gmask[prm]), dim=0)[inv]
            else:
                *_, dtau = _slab_march(grid_loc, nd_local, gpos, kdir, gsig,
                                       gmask, S_loc)
                part = torch.sum(dtau, dim=0)
            group.all_reduce([part])
            return part[mine]

        def tracer_of(gpos, gmask):
            return lambda pos, kdir, *a: peel_tau(gpos, kdir[0], gmask)

        for ev in range(opts.max_events):
            active = pkt.alive
            rf_mask = (active & rf_in) if use_rf else torch.zeros_like(active)
            gpos, gdir, glum, gflag = group.all_gather([
                pkt.pos, pkt.dir, pkt.lum,
                torch.stack([active, rf_mask], dim=1).to(torch.float32)])
            gact, grf = gflag[:, 0] > 0, gflag[:, 1] > 0
            if ev == 0 and do_peel:
                # the emission peel-off, at the launch positions
                lc.peel_off(inst_cfgs, inst_tabs, accs, pkt.lam, pkt.pos,
                            lambda i, kobs: (pkt.lum * _ISO, None),
                            kind_direct, pkt.alive, tracer_of(gpos, gact),
                            transparent_too=True)
            t0 = time.perf_counter()
            if not bool(gact.any()):
                break
            if stats is not None:
                stats["sync_s"] = (stats.get("sync_s", 0.0)
                                   + time.perf_counter() - t0)
                stats["syncs"] = stats.get("syncs", 0) + 1
                stats["events"] = stats.get("events", 0) + 1
            keys = rng.event_keys(pkt.hkey, pkt.nscat)
            u = dict(zip(tags, rng.uniforms(keys, tag_t)))

            # pass 1: the slab's partial depths of every gathered ray, the
            # owners' path depths
            if use_xl:
                pos_all = gpos - shift
                prm, inv, d_pos = _xl_sort(tabs_loc, pos_all, gdir)
                p_pos, p_dir = pos_all[prm], gdir[prm]
                dtau_sub = xl.sweep_dtau(tabs_loc, p_pos, p_dir,
                                         gsig.T[:, prm], gact[prm],
                                         want_sub=True)
                dtau_ls = (dtau_sub[:, 0] + dtau_sub[:, 1]) + dtau_sub[:, 2]
                ptau = torch.sum(dtau_ls, dim=0)[inv]
            else:
                p0, cells, ds, dtau = _slab_march(grid_loc, nd_local, gpos,
                                                  gdir, gsig, gact, S_loc)
                ptau = torch.sum(dtau, dim=0)                      # (N,)
            pt_own = group.all_to_all(ptau.reshape(D, B))          # (D, B)
            tau_path = torch.sum(pt_own, dim=0)
            tau_int, w_bias, tau_ok = lc.sample_interaction_tau(opts, u,
                                                                tau_path)
            active_int = active & tau_ok
            # the depth before each slab along each ray, back to the slabs
            # with the interaction depths
            cum = torch.cumsum(pt_own, dim=0)
            up = cum - pt_own
            dn = torch.sum(pt_own, dim=0)[None, :] - cum
            tb_own = torch.where((pkt.dir[:, 0] > 0)[None, :], up, dn)
            back = group.all_to_all(torch.stack([
                tb_own, tau_int.expand(D, B),
                tau_ok.to(torch.float32).expand(D, B)], dim=2).reshape(
                    D * B, 3))
            tb_slab, gtau_int, gtau_ok = back.unbind(1)            # (N,)

            # pass 2: the deposits into the slab's RF rows and the
            # interaction in the one slab where the depth crosses it
            if use_xl:
                # the depth before a local slab: the slab's entry depth plus
                # the local prefix along the ray
                tb_loc, _ = sw.slab_prefix(dtau_ls, d_pos)
                if use_rf:
                    glum_half = ((glum * grf) * inv_sqrt)[prm]
                    scale_slab = (glum_half[None, :] * torch.exp(
                        -(tb_slab[prm][None, :] + tb_loc))) * inv_sqrt
                    rf_delta = xl.sweep_deposit(tabs_loc, p_pos, p_dir,
                                                grf[prm], dtau_sub,
                                                scale_slab)
                    rf_local += rf_delta[0][:, None]
                s_s, ic_s, fd_s = xl.resolve_interaction(
                    tabs_loc, p_pos, p_dir, gact[prm], dtau_sub, tb_loc,
                    (gtau_int - tb_slab)[prm])
                found_l = fd_s[inv]
                icell_l = ic_s[inv].clamp_min(0)
                ipos_l = gpos + s_s[inv][:, None] * gdir
            else:
                cum_before = (tb_slab[None, :] + xm.cumsum(dtau)) - dtau
                if use_rf:
                    mr.deposit_rf(rf_local, cells, ds, dtau, cum_before,
                                  glum, grfbin, grf, opts.rf_scale)
                ipos_l, icell_l, found_l, _, _ = mr.interaction_point(
                    p0, gdir, cells, ds, dtau, cum_before, gtau_int,
                    (tb_slab < gtau_int) & (tb_slab + ptau >= gtau_int))
            nd_at_l = nd_local[icell_l]
            f64 = lambda t: torch.where(
                found_l.view((-1,) + (1,) * (t.dim() - 1)), t,
                torch.zeros_like(t)).double()
            ret = torch.cat([f64(ipos_l), f64(nd_at_l),
                             f64(icell_l + r * nc_loc)[:, None],
                             found_l.double()[:, None]], dim=1)
            group.all_reduce([ret])
            ipos_all = ret[:, :3].float()
            found_all = ret[:, -1] > 0
            ipos, found = ipos_all[mine], found_all[mine]
            nd_at = ret[mine, 3:3 + ncomp].float()
            icell = ret[mine, 3 + ncomp].to(torch.int64)
            active_int = active_int & found

            # the event's tail, shared with the replicated life cycle
            albedo, w = lc.albedo_and_weights(opt, nd_at)
            lum_at = pkt.lum * w_bias
            pkt = pkt._replace(
                pos=torch.where(active_int[:, None], ipos, pkt.pos),
                cell=torch.where(active_int, icell, pkt.cell),
                lum=torch.where(active_int, lum_at, pkt.lum))
            h = (lc.select_component_from_weights(w, u[lc._TAG_SCATTER_COMP])
                 if ncomp > 1 else torch.zeros_like(icell))
            if do_peel:
                gint = gact & (gtau_ok > 0) & found_all
                phase = lc.peel_phase_nonpolarized(opt, w, pkt.dir)
                lum_alb = pkt.lum * albedo
                lc.peel_off(inst_cfgs, inst_tabs, accs, pkt.lam, pkt.pos,
                            lambda i, kobs: (lum_alb * phase(kobs), None),
                            kind_scat, active_int, tracer_of(
                                torch.where(gint[:, None], ipos_all, gpos),
                                gint))
            newdir = lc.scatter_nonpolarized(u, opt, h, pkt.dir)
            lum_new = pkt.lum * albedo
            nscat_new = pkt.nscat + 1
            survive = lc.survives_cutoff(opts, lum_new, nscat_new, pkt.lum0)
            pkt = pkt._replace(
                dir=torch.where(active_int[:, None], newdir, pkt.dir),
                lum=torch.where(active_int, lum_new, pkt.lum),
                nscat=torch.where(active_int, nscat_new, pkt.nscat),
                alive=active_int & survive & (lum_new > 0))
        return rf_local, accs

    return run


def voxelize_for_dd(grid, med, n_slabs: int = 1):
    """(vox_grid, med_vox, cellmap): a non-Cartesian grid on a uniform
    voxel grid over its box, the medium with each voxel's density its
    cell's, and the (nvox,) int32 voxel -> cell map (-1 where no cell
    owns the voxel), on the medium's device; (grid, med, None) for a
    Cartesian grid (the reference's `domain.py:568-635`). Trees and
    adaptive meshes rasterize exactly onto their finest level; Voronoi and
    tetrahedral grids onto n^3 voxels, n = `SKIRT9_TPU_DD_RASTER_N` (64)
    rounded up to a multiple of n_slabs, each voxel its centre's cell
    (`transport/raster._owner_map`)."""
    if isinstance(grid, (UniformCartesianGrid, CartesianGrid)):
        return grid, med, None
    dev = med.nd.device
    if isinstance(grid, (OctreeGrid, BinTreeGrid, AMRGrid)):
        meta = ml._analyze(grid)
        nf = meta["nf"]
        lo0, box = meta["lo0"], meta["box"]
        vox_grid = make_cartesian(tuple((float(lo0[a]), float(lo0[a] + box[a]))
                                        for a in range(3)), nf)
        owner = ml.owner_map(meta).reshape(-1)
    elif isinstance(grid, (VoronoiGrid, TetraGrid)):
        n = int(os.environ.get("SKIRT9_TPU_DD_RASTER_N", "64"))
        n = -(-n // n_slabs) * n_slabs
        lo0 = grid.box_lo.cpu().numpy().astype(np.float64)
        hi0 = grid.box_hi.cpu().numpy().astype(np.float64)
        h = (hi0 - lo0) / n
        c = [lo0[a] + (np.arange(n) + 0.5) * h[a] for a in range(3)]
        centers = np.stack(np.meshgrid(*c, indexing="ij"),
                           axis=-1).reshape(-1, 3)
        owner = raster._owner_map(grid, centers)
        vox_grid = make_cartesian(tuple((lo0[a], hi0[a]) for a in range(3)),
                                  (n, n, n))
    else:
        raise NotImplementedError(
            f"domain decomposition: unsupported grid {type(grid).__name__} "
            "(Cartesian grids, trees, adaptive meshes, Voronoi and "
            "tetrahedral grids)")
    cellmap = torch.from_numpy(np.asarray(owner, np.int32)).to(dev)
    owned = (cellmap >= 0)[:, None]
    nd_vox = torch.where(owned, med.nd[cellmap.clamp_min(0).long()],
                         torch.zeros((), dtype=med.nd.dtype, device=dev))
    _log().info(f"voxel raster: {type(grid).__name__} ({grid.ncells} cells) "
                f"on {'x'.join(map(str, vox_grid.shape))} voxels")
    return vox_grid, med._replace(nd=nd_vox.contiguous()), cellmap
