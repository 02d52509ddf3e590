"""Slab-sweep ray march: per-slab optical depth, RF deposits, interaction point.

Port of `skirt9_tpu/transport/sweep.py`. Each packet is assigned its dominant
axis (highest cell-crossing rate); the march walks the slabs of that axis and
visits at most 3 cells per slab through a bounded sub-DDA over the two minor
axes (`_slab_entry`, `_minor_idx`, `_minor_crossing` of the reference, with
the same constants: the 1e-4*span nudge, _BIG = 3e37 and the 1e-30
tiny-direction guards, which the <= 3-cell bound depends on).

The reference's two contracts, each a CUDA kernel on the GPU
(`csrc/sweep_dtau.cu`, `csrc/sweep_deposit.cu`) beside its plain PyTorch
version:
  pass 1 `sweep_dtau`    -> (nmax, B) optical depth per slab;
  pass 2 `sweep_deposit` -> RF deposits (n_groups, ncells) plus the exact
                            interaction point (s_int, icell, found).
Each kernel has a second mode, which the event loop uses:
  `sweep_tau_total`      -> (B,) total optical depth (the peel-off tracer);
  `sweep_dtau_prefix`    -> `slab_prefix` of pass 1 plus the lane range
                            (pass 1 takes the lane set-up, `_lane_range`,
                            inside);
  `sweep_deposit_prefix` -> pass 2 from that prefix, the lane range and the
                            per-lane luminosity and interaction depth, with
                            the RF rows folded into bins by a bin map.
The grid's constants reach the kernels as scalars and the plain versions
through tensors built with the tables (`grid_axes`, `axis_tables`), so the
event loops copy nothing from the host.

The density is read from the flat (ncells, C) table, cell =
(ix*ny + iy)*nz + iz; the reference's transposed slab layouts and its
select-loop lookup are TPU workarounds and are not carried over.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..grids.cartesian import UniformCartesianGrid
from ..kernels import build as kb

_BIG = 3e37


class SweepTables(NamedTuple):
    """Flat density table + static grid geometry (f32-exact floats)."""

    nd: torch.Tensor   # (ncells, C) f32, contiguous
    n: tuple           # (nx, ny, nz)
    lo: tuple          # box minimum per axis
    h: tuple           # cell size per axis
    nmax: int          # max(nx, ny, nz): slabs per lane in the output
    axes: tuple        # `grid_axes`: (lo, hi, 1/h) as (3,) f32 tensors
    geom: dict         # `axis_tables`: per-axis tables of `_lane_geometry`

    @property
    def ncomp(self) -> int:
        return self.nd.shape[1]


def supports_sweep(grid, med) -> bool:
    """True when (grid, medium) takes the resident-table sweep.

    The rule is the reference's geometry test (`skirt9_tpu/transport/
    sweep.py:93-108`: a uniform grid, 3 * ceil(minor plane / 128) <= 128
    rows, axes <= 256, the VMEM formula, <= 4 components) without its
    backend test, so that the port picks the engine the reference picks on
    its accelerator and each contract is held against its own counterpart.
    It mirrors TPU limits (VMEM, the deposit's 128-row encoding), not
    limits of the H100 kernels, which take any uniform grid."""
    if not isinstance(grid, UniformCartesianGrid):
        return False
    nx, ny, nz = grid.shape
    minor = max(ny * nz, nx * nz, nx * ny)
    rows = -(-minor // 128)
    nmax = max(nx, ny, nz)
    if 3 * rows > 128 or nmax > 256:
        return False
    vmem = (med.ncomp * 3 + 3) * nmax * rows * 128 * 4
    return med.ncomp <= 4 and vmem <= 10 * 2**20


def build_tables(grid, med) -> SweepTables:
    lo = tuple(float(v) for v in grid.lo.cpu().numpy().astype(np.float64))
    h = tuple(float(v) for v in grid.h.cpu().numpy().astype(np.float64))
    dev = med.nd.device
    return SweepTables(nd=med.nd.contiguous(), n=grid.shape, lo=lo, h=h,
                       nmax=max(grid.shape),
                       axes=grid_axes(lo, grid.shape, h, dev),
                       geom=axis_tables(lo, grid.shape, h, dev))


def grid_axes(lo: tuple, n: tuple, h: tuple, device) -> tuple:
    """(lo, hi, 1/h) per axis as (3,) f32 tensors on the device, hi = lo +
    n*h in f32: the grid constants of `dominant_axis` and `_lane_range`,
    built once with the tables so that the event loop copies nothing from
    the host."""
    lo_t = torch.tensor(lo, dtype=torch.float32, device=device)
    hi_t = lo_t + (torch.tensor(n, dtype=torch.float32, device=device)
                   * torch.tensor(h, dtype=torch.float32, device=device))
    inv_h = torch.tensor([1.0 / v for v in h], dtype=torch.float32,
                         device=device)
    return lo_t, hi_t, inv_h


def axis_tables(lo: tuple, n: tuple, h: tuple, device) -> dict:
    """Per-axis tables that `_lane_geometry`, `mlsweep.locate_cells` and
    `sweepxl.lane_order` index by a lane's axis, as tensors on the device,
    built once with the tables so that the event loops copy nothing from
    the host: the cell counts n (int64), lo and h (f32), the minor axes ua,
    va of each slab axis, and the flat-cell strides of (slab, u, v)."""
    nx, ny, nz = n
    i64 = lambda a: torch.tensor(a, dtype=torch.int64, device=device)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    return dict(n=i64(n), lo=f32(lo), h=f32(h), ua=i64([1, 0, 0]),
                va=i64([2, 2, 1]), t_stride=i64([ny * nz, nz, 1]),
                u_stride=i64([nz, ny * nz, ny * nz]),
                v_stride=i64([1, 1, nz]))


def dominant_axis(tabs: SweepTables, dirn: torch.Tensor) -> torch.Tensor:
    """Slab axis per lane: the highest CELL-crossing rate |dir_i|/h_i (a plain
    argmax|dir| breaks the 3-substep bound for anisotropic cells)."""
    inv_h = tabs.axes[2]
    return torch.argmax(torch.abs(dirn) * inv_h, dim=-1)


def _lane_range(tabs, pos, dirn, active):
    """Per-lane dominant axis (int32) and in-grid path range [smin, smax],
    with smax = smin for inactive lanes."""
    lo, hi, _ = tabs.axes
    group = dominant_axis(tabs, dirn).to(torch.int32)
    tiny = torch.abs(dirn) < 1e-30
    inv = 1.0 / torch.where(tiny, torch.full_like(dirn, 1e-30), dirn)
    t1 = (lo - pos) * inv
    t2 = (hi - pos) * inv
    big = torch.full_like(t1, _BIG)
    smin = torch.clamp_min(
        torch.amax(torch.where(tiny, -big, torch.minimum(t1, t2)), dim=-1), 0.0)
    smax = torch.amin(torch.where(tiny, big, torch.maximum(t1, t2)), dim=-1)
    # a tiny direction component gives no bound on s: the ray meets the box
    # only if its position lies within that dimension's range
    inbox = ~torch.any(tiny & ((pos < lo) | (pos >= hi)), dim=-1)
    smax = torch.where(active & inbox & (smax > smin), smax, smin)
    return group, smin.contiguous(), smax.contiguous()


def _sigma(sigma):
    """The (C, B) contiguous f32 cross sections."""
    if sigma.dim() == 1:
        sigma = sigma[None, :]
    return sigma.to(torch.float32).contiguous()


def _lanes(tabs, pos, dirn, active, lane=None):
    """Pass 1's lane range (group, smin, smax) where the caller has it,
    checked, else `_lane_range`."""
    if lane is None:
        return _lane_range(tabs, pos, dirn, active)
    _check_lane(pos, active, lane)
    return lane


def _prep(tabs: SweepTables, pos, dirn, sigma, active, lane=None):
    """`_lanes` plus the (C, B) contiguous f32 cross sections."""
    return (*_lanes(tabs, pos, dirn, active, lane), _sigma(sigma))


def _check_inputs(pos, dirn, shaped):
    """Raise on inputs the kernels do not take (the wrappers pass raw
    pointers): f32 (B, 3) rays and f32 tables of the given shapes, all on
    one device. shaped: (tensor, expected shape, name) triples."""
    B = pos.shape[0]
    if pos.shape != (B, 3) or dirn.shape != (B, 3):
        raise ValueError(f"pos {tuple(pos.shape)} / dir {tuple(dirn.shape)} "
                         "must be (B, 3)")
    for t, shape, name in shaped:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} {tuple(t.shape)} must be {tuple(shape)}")
    for t in (pos, dirn, *(t for t, _, _ in shaped)):
        if t.dtype != torch.float32:
            raise ValueError(f"sweep inputs must be float32, got {t.dtype}")
        if t.device != pos.device:
            raise ValueError("all sweep inputs must lie on one device")


def _check(tabs: SweepTables, pos, dirn, sig, *slab_tables):
    """`_check_inputs` for the resident kernels: (C, B) cross sections with
    1 <= C <= 4 and C equal to the table's, the (ncells, C) table, and
    (nmax, B) slab tables."""
    B = pos.shape[0]
    if not 1 <= sig.shape[0] <= 4 or sig.shape != (tabs.ncomp, B):
        raise ValueError(f"sigma {tuple(sig.shape)} must be (C, B) with "
                         f"C = {tabs.ncomp} <= 4 components")
    _check_inputs(pos, dirn, [(sig, sig.shape, "sigma"),
                              (tabs.nd, tabs.nd.shape, "density table")]
                  + [(t, (tabs.nmax, B), "slab table") for t in slab_tables])


def _check_lane(pos, active, lane=None):
    """Raise unless active is (B,) on the rays' device and the lane range,
    where given, is (group int32, smin f32, smax f32), each (B,)."""
    B = pos.shape[0]
    named = [(active, None, "active")]
    if lane is not None:
        named += list(zip(lane, (torch.int32, torch.float32, torch.float32),
                          ("lane group", "lane smin", "lane smax")))
    for t, dtype, name in named:
        if tuple(t.shape) != (B,) or t.device != pos.device:
            raise ValueError(f"{name} {tuple(t.shape)} must be ({B},) on "
                             f"{pos.device}")
        if dtype is not None and t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")


# ------------------------------------------------------- plain PyTorch march

def _lane_geometry(tabs, pos, dirn, group):
    """Per-lane major/minor decomposition for the dominant axis `group`
    (the reference's `_axis_geometry`): minor axes (u, v) = (y, z), (x, z),
    (x, y) for axis 0, 1, 2, and the flat-cell strides of (slab, u, v).
    Returns a dict of (B,) tensors."""
    a = group.to(torch.int64)
    k = tabs.geom
    n_t, lo_t, h_t = k["n"], k["lo"], k["h"]
    ua, va = k["ua"][a], k["va"][a]
    sel = lambda x, ax: x.gather(1, ax[:, None])[:, 0]
    return dict(
        pa=sel(pos, a), da=sel(dirn, a), loa=lo_t[a], ha=h_t[a], na=n_t[a],
        pu=sel(pos, ua), du=sel(dirn, ua), lou=lo_t[ua], hu=h_t[ua],
        nu=n_t[ua],
        pv=sel(pos, va), dv=sel(dirn, va), lov=lo_t[va], hv=h_t[va],
        nv=n_t[va],
        t_stride=k["t_stride"][a], u_stride=k["u_stride"][a],
        v_stride=k["v_stride"][a])


def _substeps(g, t, smin, smax):
    """The <= 3 sub-segments of slab t for every lane (the reference's
    `sweepxl._substeps`): t is an int64 slab index broadcasting against the
    lanes, (nmax, 1) for a whole march or (B,) for one slab per lane.
    Returns [(s_cur, ds, iu, iv)] * 3 and the slab's activity mask. Same f32
    operations, in the same order, as the kernels."""
    # slab entry [s_in, s_out) clipped to the in-grid range
    tiny = torch.abs(g["da"]) < 1e-30
    inv_da = 1.0 / torch.where(tiny, torch.ones_like(g["da"]), g["da"])
    b0 = g["loa"] + t.to(torch.float32) * g["ha"]
    s0 = (b0 - g["pa"]) * inv_da
    s1 = (b0 + g["ha"] - g["pa"]) * inv_da
    s_in = torch.maximum(torch.where(tiny, smin, torch.minimum(s0, s1)), smin)
    s_out = torch.minimum(torch.where(tiny, smax, torch.maximum(s0, s1)), smax)
    act = s_in < s_out
    actf = act.to(torch.float32)
    span = s_out - s_in

    def minor(p, d, lo_, h_, n_, s):
        i = torch.floor((p + s * d - lo_) / h_)
        return torch.minimum(torch.clamp_min(i, 0.0), (n_ - 1).to(torch.float32)
                             ).to(torch.int64)

    s_nudge = s_in + 1e-4 * span
    pu, du, lou, hu, nu = (g[k] for k in ("pu", "du", "lou", "hu", "nu"))
    pv, dv, lov, hv, nv = (g[k] for k in ("pv", "dv", "lov", "hv", "nv"))
    iu = minor(pu, du, lou, hu, nu, s_nudge)
    iv = minor(pv, dv, lov, hv, nv, s_nudge)
    tiny_u = torch.abs(du) < 1e-30
    tiny_v = torch.abs(dv) < 1e-30
    du_safe = torch.where(tiny_u, torch.ones_like(du), du)
    dv_safe = torch.where(tiny_v, torch.ones_like(dv), dv)
    step_u = torch.where(du > 0, 1, -1)
    step_v = torch.where(dv > 0, 1, -1)
    big = torch.full((), _BIG, device=du.device)
    s_cur = s_in
    steps = []
    for _ in range(3):
        bu = lou + (iu + (du > 0)).to(torch.float32) * hu
        bv = lov + (iv + (dv > 0)).to(torch.float32) * hv
        su = torch.where(tiny_u, big, (bu - pu) / du_safe)
        sv = torch.where(tiny_v, big, (bv - pv) / dv_safe)
        s_nxt = torch.minimum(torch.minimum(su, sv), s_out)
        ds = torch.clamp_min(s_nxt - s_cur, 0.0) * actf
        steps.append((s_cur, ds, iu, iv))
        cross_u = su <= sv
        iu = torch.minimum(torch.clamp_min(
            iu + torch.where(cross_u, step_u, 0), 0), nu - 1)
        iv = torch.minimum(torch.clamp_min(
            iv + torch.where(cross_u, 0, step_v), 0), nv - 1)
        s_cur = s_nxt
    return steps, act


def _slab_cells(tabs, pos, dirn, group, smin, smax):
    """The march vectorised over (slab, lane), without the density: for each
    of the 3 sub-steps (s_cur, ds, cell) as (nmax, B) tensors, plus the
    activity mask."""
    g = _lane_geometry(tabs, pos, dirn, group)
    t_i = torch.arange(tabs.nmax, device=pos.device)[:, None]   # (nmax, 1)
    subs, act = _substeps(g, t_i, smin, smax)
    # slabs past the lane's own axis length are inactive (ds = 0); clamp
    # their index so the lookup stays inside the table
    t_c = torch.minimum(t_i, g["na"] - 1)
    steps = [(s_cur, ds, t_c * g["t_stride"] + iu * g["u_stride"]
              + iv * g["v_stride"]) for s_cur, ds, iu, iv in subs]
    return steps, act


def _march_plain(tabs: SweepTables, pos, dirn, group, smin, smax, sig):
    """`_slab_cells` with the optical depth: for each of the 3 sub-steps
    yields (s_cur, ds, dtau, cell) as (nmax, B) tensors, plus the activity
    mask."""
    steps, act = _slab_cells(tabs, pos, dirn, group, smin, smax)
    out = []
    for s_cur, ds, cell in steps:
        k = tabs.nd[cell, 0] * sig[0]
        for c in range(1, sig.shape[0]):
            k = k + tabs.nd[cell, c] * sig[c]
        out.append((s_cur, ds, k * ds, cell))
    return out, act


def _dtau_plain(tabs, pos, dirn, group, smin, smax, sig):
    steps, _ = _march_plain(tabs, pos, dirn, group, smin, smax, sig)
    dtau = steps[0][2]
    for st in steps[1:]:
        dtau = dtau + st[2]
    return dtau


def _segment_factor(dtau):
    """(1 - e^-dtau) / dtau: the exact integral of e^-tau over a segment per
    unit dtau; below dtau = 1e-3 the series form avoids the cancellation in
    1 - e^-dtau."""
    return torch.where(dtau < 1e-3, 1.0 - 0.5 * dtau,
                       (1.0 - torch.exp(-torch.clamp_max(dtau, 80.0)))
                       / torch.clamp_min(dtau, 1e-37))


def _deposit_plain(tabs, pos, dirn, group, smin, smax, sig, scale, rel,
                   n_groups):
    steps, act = _march_plain(tabs, pos, dirn, group, smin, smax, sig)
    B = pos.shape[0]
    tau_loc = torch.zeros_like(scale)
    contribs, hits, s_hits, cells = [], [], [], []
    for s_cur, ds, dtau, cell in steps:
        contribs.append(scale * torch.exp(-tau_loc) * ds
                        * _segment_factor(dtau))
        rem = rel - tau_loc
        hits.append(act & (rem >= 0.0) & (rem < dtau))
        s_hits.append(s_cur + rem / torch.clamp_min(dtau, 1e-37) * ds)
        cells.append(cell)
        tau_loc = tau_loc + dtau
    # the first hit in (slab, sub-step) order, as the sequential kernel finds
    hit = torch.stack(hits, dim=1).reshape(-1, B)
    found = hit.any(dim=0)
    first = torch.argmax(hit.to(torch.int8), dim=0)[None, :]
    s_int = torch.stack(s_hits, dim=1).reshape(-1, B).gather(0, first)[0]
    icell = torch.stack(cells, dim=1).reshape(-1, B).gather(0, first)[0]
    s_int = torch.where(found, s_int, torch.zeros_like(s_int))
    icell = torch.where(found, icell, torch.full_like(icell, -1))
    rf = _deposit_sum(torch.stack(cells, dim=1),
                      torch.stack(contribs, dim=1), tabs.nd.shape[0], n_groups)
    return rf, s_int, icell, found


def _deposit_prefix_plain(tabs, pos, dirn, group, smin, smax, sig, lum_half,
                          tau_int, tb_slab, inv_sqrt, n_groups, bin_map, rows):
    """`_deposit_plain` with scale and rel formed as the event loop forms
    them, the rows then folded into bins: row g adds into bin_map[g] of a
    (rows, ncells) table that starts at zero (an entry outside [0, rows):
    dropped)."""
    scale = (lum_half[None, :] * torch.exp(-tb_slab)) * inv_sqrt
    rel = tau_int[None, :] - tb_slab
    rf, s_int, icell, found = _deposit_plain(tabs, pos, dirn, group, smin,
                                             smax, sig, scale, rel, n_groups)
    return _fold_bins(rf, bin_map, rows), s_int, icell, found


def _fold_bins(rf, bin_map, rows: int):
    """(n_groups, ncells) group rows folded into (rows, ncells) bins: row g
    adds into bin_map[g] (an entry outside [0, rows): dropped); rf itself
    without a bin map."""
    if bin_map is None:
        return rf
    keep = ((bin_map >= 0) & (bin_map < rows)).to(rf.dtype)[:, None]
    binned = torch.zeros((rows, rf.shape[1]), dtype=rf.dtype, device=rf.device)
    binned.index_add_(0, bin_map.clamp(0, rows - 1).to(torch.int64),
                      rf * keep)
    return binned


def _deposit_sum(cells, contribs, ncells: int, n_groups: int):
    """Sum (..., B) per-segment contributions into (n_groups, ncells) RF rows
    of their dtype; lane b deposits into row b // (B / n_groups)."""
    B = cells.shape[-1]
    grp = torch.arange(B, device=cells.device) // (B // n_groups)
    rf = torch.zeros(n_groups * ncells, dtype=contribs.dtype,
                     device=cells.device)
    rf.index_add_(0, (grp * ncells + cells).reshape(-1), contribs.reshape(-1))
    return rf.reshape(n_groups, ncells)


# ----------------------------------------------------------- CUDA launches

def _geometry_args(tabs: SweepTables):
    return (*tabs.n, tabs.nmax, *tabs.lo, *tabs.h)


# pass 1's output modes (csrc/sweep_dtau.cu), each counted under its name
_MODES = ("sweep_dtau", "sweep_tau_total", "sweep_dtau_prefix")


def _dtau_cuda(tabs, pos, dirn, sig, active, hint, mode: str):
    """One launch of pass 1 in the given mode, the lane set-up inside:
    sweep_dtau -> (nmax, B) tau; sweep_tau_total -> (B,) total;
    sweep_dtau_prefix -> ((nmax, B) prefix, total, (group, smin, smax))."""
    B, C = pos.shape[0], sig.shape[0]
    dev = pos.device
    pos, dirn = pos.contiguous(), dirn.contiguous()
    act = active.to(torch.bool).contiguous()
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    out = None if mode == "sweep_tau_total" else f32(tabs.nmax, B)
    total = None if mode == "sweep_dtau" else f32(B)
    lane = None
    if mode == "sweep_dtau_prefix":
        lane = (torch.empty(B, dtype=torch.int32, device=dev), f32(B), f32(B))
    ptr = lambda t: None if t is None else t.data_ptr()
    nx, ny, nz, nmax, *geo = _geometry_args(tabs)
    kb.launch("sweep_dtau", *(ptr(t) for t in (
                  pos, dirn, act, sig, tabs.nd, out, total,
                  *(lane or (None,) * 3))),
              B, C, nx, ny, nz, nmax, -1 if hint is None else int(hint),
              _MODES.index(mode), *geo, *(1.0 / v for v in tabs.h),
              kb.stream_of(pos), count_as=mode)
    if mode == "sweep_dtau":
        return out
    if mode == "sweep_tau_total":
        return total
    return out, total, lane


# pass 2's input modes (csrc/sweep_deposit.cu), each counted under its name
_DEPOSIT_MODES = ("sweep_deposit", "sweep_deposit_prefix")


def _deposit_launch(tabs, pos, dirn, group, smin, smax, sig, slab_a, slab_b,
                    lum, tau_int, inv_sqrt, bin_map, n_groups, rows, mode):
    B, C = pos.shape[0], sig.shape[0]
    dev = pos.device
    rf = torch.zeros((rows, tabs.nd.shape[0]), dtype=torch.float32,
                     device=dev)
    s_int = torch.empty(B, dtype=torch.float32, device=dev)
    icell = torch.empty(B, dtype=torch.int32, device=dev)
    found = torch.empty(B, dtype=torch.int32, device=dev)
    # held here, so that no contiguous copy is freed before the launch
    args = [None if t is None else t.contiguous() for t in (
        pos, dirn, group, smin, smax, sig, slab_a, slab_b, lum, tau_int,
        bin_map, tabs.nd, rf, s_int, icell, found)]
    nx, ny, nz, nmax, *geo = _geometry_args(tabs)
    kb.launch("sweep_deposit", *(None if t is None else t.data_ptr()
                                 for t in args),
              B, C, nx, ny, nz, nmax, n_groups, rows,
              _DEPOSIT_MODES.index(mode), *geo, float(inv_sqrt),
              kb.stream_of(pos), count_as=mode)
    return rf, s_int, icell.to(torch.int64), found != 0


def _deposit_cuda(tabs, pos, dirn, group, smin, smax, sig, scale, rel,
                  n_groups):
    return _deposit_launch(tabs, pos, dirn, group, smin, smax, sig, scale,
                           rel, None, None, 1.0, None, n_groups, n_groups,
                           "sweep_deposit")


def _deposit_prefix_cuda(tabs, pos, dirn, group, smin, smax, sig, lum_half,
                         tau_int, tb_slab, inv_sqrt, n_groups, bin_map, rows):
    return _deposit_launch(tabs, pos, dirn, group, smin, smax, sig, tb_slab,
                           None, lum_half, tau_int, inv_sqrt, bin_map,
                           n_groups, rows, "sweep_deposit_prefix")


# ---------------------------------------------------------- public wrappers

def _dispatch(t: torch.Tensor, plain, cuda):
    if t.device.type == "cpu":
        return plain
    if t.device.type == "cuda":
        return cuda
    raise ValueError(f"no sweep kernel for device {t.device}")


def _hinted(group, axis_hint):
    return group if axis_hint is None else torch.full_like(group, int(axis_hint))


def _pass1(tabs, pos, dirn, sigma, active, axis_hint, mode, plain):
    """Check the inputs, then the plain version on the CPU or the kernel in
    the given mode on the GPU."""
    sig = _sigma(sigma)
    _check(tabs, pos, dirn, sig)
    _check_lane(pos, active)
    fn = _dispatch(pos, plain, functools.partial(_dtau_cuda, mode=mode))
    return fn(tabs, pos, dirn, sig, active, axis_hint)


def sweep_dtau(tabs: SweepTables, pos, dirn, sigma, active,
               axis_hint: int | None = None) -> torch.Tensor:
    """Per-slab optical depth (nmax, B) f32. axis_hint: the dominant axis
    shared by all lanes (peel-off toward one observer)."""
    return _pass1(tabs, pos, dirn, sigma, active, axis_hint, "sweep_dtau",
                  sweep_dtau_plain)


def sweep_dtau_plain(tabs: SweepTables, pos, dirn, sigma, active,
                     axis_hint: int | None = None) -> torch.Tensor:
    """`sweep_dtau` through the plain PyTorch version on any device."""
    group, smin, smax, sig = _prep(tabs, pos, dirn, sigma, active)
    return _dtau_plain(tabs, pos, dirn, _hinted(group, axis_hint), smin, smax,
                       sig)


def sweep_tau_total(tabs: SweepTables, pos, dirn, sigma, active,
                    axis_hint: int | None = None) -> torch.Tensor:
    """Optical depth of each lane's whole in-grid path (B,), summed in slab
    order: `sweep_dtau(...).sum(0)` without the (nmax, B) tensor."""
    return _pass1(tabs, pos, dirn, sigma, active, axis_hint,
                  "sweep_tau_total", sweep_tau_total_plain)


def sweep_tau_total_plain(tabs: SweepTables, pos, dirn, sigma, active,
                          axis_hint: int | None = None) -> torch.Tensor:
    """`sweep_tau_total` through the plain PyTorch version on any device."""
    return torch.sum(sweep_dtau_plain(tabs, pos, dirn, sigma, active,
                                      axis_hint), dim=0)


def sweep_dtau_prefix(tabs: SweepTables, pos, dirn, sigma, active,
                      axis_hint: int | None = None):
    """Pass 1 for pass 2: `slab_prefix` of `sweep_dtau` in the lane's own
    slab axis, and that lane range.
    Returns (tau before each slab in ray order (nmax, B), total (B,),
    lane = (group (B,) int32, smin, smax)), lane for `sweep_deposit`."""
    return _pass1(tabs, pos, dirn, sigma, active, axis_hint,
                  "sweep_dtau_prefix", sweep_dtau_prefix_plain)


def sweep_dtau_prefix_plain(tabs: SweepTables, pos, dirn, sigma, active,
                            axis_hint: int | None = None):
    """`sweep_dtau_prefix` through the plain PyTorch version on any device."""
    group, smin, smax, sig = _prep(tabs, pos, dirn, sigma, active)
    group = _hinted(group, axis_hint)
    dtau = _dtau_plain(tabs, pos, dirn, group, smin, smax, sig)
    dmaj = dirn.gather(1, group.to(torch.int64)[:, None])[:, 0]
    tb, total = slab_prefix(dtau, dmaj > 0)
    return tb, total, (group, smin, smax)


def sweep_deposit(tabs: SweepTables, pos, dirn, sigma, active, scale_slab,
                  rel_slab, n_groups: int = 1, lane=None):
    """Pass 2: RF deposits + interaction resolution.

    scale_slab: (nmax, B) L*exp(-tau before the slab); rel_slab: (nmax, B)
    tau_int - tau before the slab (both in ray order). Lanes form n_groups
    contiguous groups, each depositing into its own RF row. lane: pass 1's
    (group, smin, smax) from `sweep_dtau_prefix`, which saves the set-up.
    Returns (rf (n_groups, ncells), s_int (B,), icell (B,) int64 or -1,
    found (B,) bool)."""
    if pos.shape[0] % n_groups:
        raise ValueError(f"batch {pos.shape[0]} not divisible into "
                         f"{n_groups} groups")
    group, smin, smax, sig = _prep(tabs, pos, dirn, sigma, active, lane)
    _check(tabs, pos, dirn, sig, scale_slab, rel_slab)
    fn = _dispatch(pos, _deposit_plain, _deposit_cuda)
    return fn(tabs, pos, dirn, group, smin, smax, sig, scale_slab, rel_slab,
              n_groups)


def sweep_deposit_plain(tabs: SweepTables, pos, dirn, sigma, active,
                        scale_slab, rel_slab, n_groups: int = 1):
    """`sweep_deposit` through the plain PyTorch version on any device."""
    group, smin, smax, sig = _prep(tabs, pos, dirn, sigma, active)
    return _deposit_plain(tabs, pos, dirn, group, smin, smax, sig, scale_slab,
                          rel_slab, n_groups)


def _prefix_args(tabs, pos, dirn, sigma, active, lum_half, tau_int, tb_slab,
                 inv_sqrt, lane, n_groups, bin_map, nbins):
    B = pos.shape[0]
    if B % n_groups:
        raise ValueError(f"batch {B} not divisible into {n_groups} groups")
    _check_lane(pos, active, lane)
    sig = _sigma(sigma)
    _check(tabs, pos, dirn, sig, tb_slab)
    _check_inputs(pos, dirn, [(lum_half, (B,), "lum_half"),
                              (tau_int, (B,), "tau_int")])
    return (tabs, pos, dirn, *lane, sig, lum_half, tau_int, tb_slab,
            float(inv_sqrt), n_groups, bin_map,
            bin_rows(pos, n_groups, bin_map, nbins))


def bin_rows(pos, n_groups: int, bin_map, nbins: int) -> int:
    """The RF rows pass 2 deposits into: n_groups, or nbins where a
    (n_groups,) int32 bin map on the rays' device folds the groups into
    bins; raises on any other bin map."""
    if bin_map is None:
        return n_groups
    if (bin_map.shape != (n_groups,) or bin_map.dtype != torch.int32
            or bin_map.device != pos.device or nbins < 1):
        raise ValueError(f"bin_map {tuple(bin_map.shape)} {bin_map.dtype} "
                         f"must be ({n_groups},) int32 on {pos.device}, with "
                         "nbins >= 1")
    return nbins


def sweep_deposit_prefix(tabs: SweepTables, pos, dirn, sigma, active,
                         lum_half, tau_int, tb_slab, inv_sqrt: float, lane,
                         n_groups: int = 1, bin_map=None, nbins: int = 0):
    """Pass 2 from pass 1's prefix: `sweep_deposit` with scale_slab =
    (lum_half * e^-tb_slab) * inv_sqrt and rel_slab = tau_int - tb_slab
    formed per (slab, lane) inside (the event loop's operations, in its
    order), so that neither (nmax, B) table is written.

    lum_half, tau_int: (B,) f32; tb_slab: (nmax, B) and lane = (group,
    smin, smax) from `sweep_dtau_prefix`. bin_map: (n_groups,) int32 or
    None: group g's deposits add into row bin_map[g] of nbins rows (an
    entry outside [0, nbins), -1 among them: dropped), summed from zero in
    this call. Returns (rf (n_groups or
    nbins, ncells), s_int, icell int64 or -1, found bool)."""
    args = _prefix_args(tabs, pos, dirn, sigma, active, lum_half, tau_int,
                        tb_slab, inv_sqrt, lane, n_groups, bin_map, nbins)
    return _dispatch(pos, _deposit_prefix_plain, _deposit_prefix_cuda)(*args)


def sweep_deposit_prefix_plain(tabs: SweepTables, pos, dirn, sigma, active,
                               lum_half, tau_int, tb_slab, inv_sqrt: float,
                               lane, n_groups: int = 1, bin_map=None,
                               nbins: int = 0):
    """`sweep_deposit_prefix` through the plain PyTorch version on any
    device."""
    return _deposit_prefix_plain(*_prefix_args(
        tabs, pos, dirn, sigma, active, lum_half, tau_int, tb_slab, inv_sqrt,
        lane, n_groups, bin_map, nbins))


def slab_prefix(dtau_slab: torch.Tensor, d_major_pos: torch.Tensor):
    """Ray-ordered optical depth before each slab, and the total.
    Slab order is ray order when the dominant component is positive, else
    reversed."""
    total = torch.sum(dtau_slab, dim=0)
    before_up = torch.cumsum(dtau_slab, dim=0)
    before_up = torch.cat([torch.zeros_like(before_up[:1]), before_up[:-1]])
    before_dn = total[None, :] - before_up - dtau_slab
    return torch.where(d_major_pos[None, :], before_up, before_dn), total
