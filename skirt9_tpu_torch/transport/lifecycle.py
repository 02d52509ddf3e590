"""The photon-packet life cycle of one batch, on PyTorch tensors.

Port of `skirt9_tpu/transport/lifecycle.py` for its slab-sweep paths: the
emission peel-off, then up to max_events forced-scattering events, each

  1. pass 1: optical depth per slab and its ray-ordered prefix,
  2. biased interaction optical depth (composite uniform/exponential),
  3. pass 2 `sweep_deposit`: RF deposits and the interaction point,
  4. HG peel-off toward every distant instrument (the optical depth along
     the observer direction, then `instruments.distant.detect`),
  5. HG scattering, albedo weighting and the weight-cutoff test.

On the resident sweep, pass 1 is one `sweep_dtau_prefix` launch (the slab
prefix and the lane range come out of the kernel), pass 2 one
`sweep_deposit_prefix` launch (it takes the prefix, the range, the
luminosity and the interaction depth, and folds the RF rows into their
bins), the peel-off tracer one `sweep_tau_total` launch. No event loop
copies a tensor from the host.

With `sweepxl.XLTables` (large uniform grids, and trees on their voxel
raster) the event runs the XL contracts instead: lanes sorted by (lane
group, axis, major sign, entry slab), pass 1 is one
`sweepxl.sweep_dtau_prefix` launch (the optical depth per sub-step, its
slab prefix and the lane range), pass 2 one `sweepxl.sweep_deposit_prefix`
launch, with or without an RF (the deposits from that record and prefix,
added straight into the RF where one is stored: the segment's f64 table,
`Simulation._run_segment`, and the interaction point); the tracer is one `sweepxl.sweep_tau_total` launch. Everything
between pass 1 and pass 2 stays in sorted lane order; only per-lane results
go back to launch order. On a tree raster the interaction voxel maps to
its leaf through the tables' `cellmap` (`lifecycle.py:927-933` of the
reference), so that albedo, scattering and detection index leaves.

With `mlsweep.MLTables` (octrees and bintrees) the event follows the
reference's tree branch: pass 1 is one `mlsweep.sweep_dtau_prefix` launch
(the optical depth per sub-step of the multi-granularity plan, with the
leaf ids where an RF is stored, the step sums, their slab prefix, which
follows the plan's steps in spatial order along the major axis, and the
lane range), in launch order (no lane sort). Pass 2 is
`mlsweep.sweep_deposit` when an RF is stored, else
`mlsweep.resolve_interaction`, whose cell comes from the fine leaf map; the
tracer is one `mlsweep.sweep_tau_total` launch.

A multi-bin radiation field runs on every engine: the batch comes in
bin-pure lane groups (a stratified launch, `rf_strata` groups with their
`rf_bin_map`, or one group for a monochromatic source's `rf_mono_bin`),
and pass 2 deposits each group into the row of its bin.

The event loop exits early once no lane is alive; that test is the one
host sync per event on the resident sweep. There is no scan-march
fallback: every option outside this path raises NotImplementedError and
names itself.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch
from torch.profiler import record_function

from ..instruments import distant as dinst
from ..media import system as msys
from ..ops import phase as phs
from ..ops import rng
from . import mlsweep as ml
from . import sweep as sw
from . import sweepxl as xl

# the name of the profiler range around the event loop
EVENT_LOOP_RANGE = "life_cycle.events"

_TAG_PATH_CHOICE = 21
_TAG_PATH_TAU_UNI = 22
_TAG_PATH_TAU_EXP = 23
_TAG_SCATTER_COMP = 24
_TAG_SCATTER_CT = 25
_TAG_SCATTER_PHI = 26

_ISO = 1.0 / (4.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class TransportOptions:
    """Static knobs of the Monte Carlo variant (the reference's fields; see
    `skirt9_tpu/transport/lifecycle.py:58-127` for their meaning)."""

    max_steps: int
    max_events: int = 64
    path_length_bias: float = 0.5
    min_weight_reduction: float = 1e4
    min_scatt_events: int = 0
    force_scattering: bool = True
    explicit_absorption: bool = False
    store_rf: bool = True
    primary: bool = True
    peel_off: bool = True
    polarization: bool = False
    compton: bool = False
    lya: bool = False
    lya_xcrit: float = 0.0
    lya_variable: bool = False
    lya_strength: float = 1.0
    xray: bool = False
    kinematics: bool = False
    emission_doppler: bool = False
    rf_scale: float = 1.0
    rf_strata: int = 0
    rf_bin_map: tuple = ()
    rf_mono_bin: int = -1
    raster_fallback: bool = True


_NOT_PORTED = (
    ("polarization", lambda o: o.polarization),
    ("compton", lambda o: o.compton),
    ("lya", lambda o: o.lya or o.lya_variable or o.lya_xcrit > 0),
    ("xray", lambda o: o.xray),
    ("kinematics", lambda o: o.kinematics),
    ("emission_doppler", lambda o: o.emission_doppler),
    ("explicit_absorption", lambda o: o.explicit_absorption),
)


def check_supported(opts: TransportOptions) -> None:
    """Raise NotImplementedError naming every option outside the port."""
    missing = [name for name, on in _NOT_PORTED if on(opts)]
    if missing:
        raise NotImplementedError(
            f"transport options not ported yet: {', '.join(missing)}")


# --------------------------------------------------- shared event primitives

def _path_tags(opts: TransportOptions) -> tuple:
    if opts.force_scattering and opts.path_length_bias > 0:
        return (_TAG_PATH_CHOICE, _TAG_PATH_TAU_UNI, _TAG_PATH_TAU_EXP)
    return (_TAG_PATH_TAU_EXP,)


def sample_interaction_tau(opts: TransportOptions, u: dict, tau_path):
    """Interaction optical depth, bias weight and the mask of lanes whose
    path supports an interaction, from the event's uniforms u[tag]: forced
    scattering with the composite uniform/exponential path-length bias, or
    a plain exponential free path."""
    if opts.force_scattering:
        xi = opts.path_length_bias
        one_minus_exp = -torch.expm1(-tau_path)
        tau_exp = rng.expon_cutoff_from_uniform(u[_TAG_PATH_TAU_EXP], tau_path)
        if xi > 0:
            tau_uni = u[_TAG_PATH_TAU_UNI] * tau_path
            tau_int = torch.where(u[_TAG_PATH_CHOICE] < xi, tau_uni, tau_exp)
            p = torch.exp(-tau_int) / torch.clamp_min(one_minus_exp, 1e-30)
            q = (1.0 - xi) * p + xi / torch.clamp_min(tau_path, 1e-30)
            w_bias = one_minus_exp * p / torch.clamp_min(q, 1e-30)
        else:
            tau_int = tau_exp
            w_bias = one_minus_exp
        return tau_int, w_bias, tau_path > 1e-6
    tau_int = -torch.log1p(-u[_TAG_PATH_TAU_EXP])
    return tau_int, torch.ones_like(tau_path), torch.ones_like(tau_path,
                                                              dtype=torch.bool)


def hg_scatter_direction(u_ct, u_phi, g_sel, dirn):
    """Henyey-Greenstein direction update from two uniforms."""
    ct = phs.hg_sample_costheta(g_sel, u_ct)
    phi = (2.0 * math.pi) * u_phi
    return phs.rotate_direction(dirn, ct, phi)


def survives_cutoff(opts: TransportOptions, lum_new, nscat_new, lum0):
    """Weight-cutoff / minimum-scattering termination test."""
    return (lum_new * opts.min_weight_reduction > lum0) | \
        (nscat_new < opts.min_scatt_events)


# ------------------------------------------------- wavelength-binned RF

def _rf_groups(opts: TransportOptions, rf, B: int, xl_grid: bool) -> int:
    """Bin-pure lane groups of the pass-2 deposits (the reference's choice,
    `skirt9_tpu/transport/lifecycle.py:515-524,573-578`): one for a one-bin
    RF or a monochromatic source in a multi-bin one (`rf_mono_bin`), else
    the `rf_strata` groups of a stratified launch. A layout the reference
    sends to its scan march raises: groups of 128-lane blocks, and on large
    (XL) grids a batch of whole 8-block rows."""
    if rf is None or rf.shape[1] == 1:
        return 1
    if opts.rf_strata > 0:
        if B % (128 * opts.rf_strata) or (xl_grid and (B // 128) % 8):
            raise NotImplementedError(
                f"batch {B} not divisible into {opts.rf_strata} groups of "
                "128-lane blocks" + (" in rows of 8 blocks" if xl_grid
                                     else "")
                + " (the reference's scan march; not ported)")
        return opts.rf_strata
    if opts.rf_mono_bin < 0:
        raise NotImplementedError(
            "multi-bin radiation field without a bin-pure lane layout (the "
            "reference's scan march; not ported)")
    return 1


def _bin_map(opts: TransportOptions, rf, n_groups: int, device):
    """The (n_groups,) int32 group -> RF bin map of a stratified launch on
    the device, built once per life cycle (-1: outside the RF grid), or
    None where the deposits need no folding."""
    if rf is None or rf.shape[1] == 1 or n_groups == 1:
        return None
    bins = tuple(opts.rf_bin_map)
    if len(bins) != n_groups or not all(-1 <= b < rf.shape[1] for b in bins):
        raise ValueError(f"rf_bin_map {bins} must map {n_groups} groups to "
                         f"bins of [-1, {rf.shape[1]})")
    return torch.tensor(bins, dtype=torch.int32, device=device)


def _add_rf(rf, rf_delta, opts: TransportOptions, n_groups: int) -> None:
    """Add pass 2's deposits into the (ncells, nbins) RF in place: one row
    for a one-bin RF or a monochromatic source's bin (`rf_mono_bin`), else
    (nbins, ncells) rows already folded by the bin map."""
    if rf.shape[1] == 1:
        rf[:, 0] += rf_delta[0]
    elif n_groups == 1:
        rf[:, opts.rf_mono_bin] += rf_delta[0]
    else:
        rf += rf_delta.T


# ------------------------------------------------------------------- peel-off

def _observer_groups(inst_cfgs) -> list[list[int]]:
    """Instrument indices grouped by identical observer geometry, so that
    one observer-direction march serves the whole group."""
    groups: list[list[int]] = []
    seen: dict[tuple, int] = {}
    for i, cfg in enumerate(inst_cfgs):
        key = (cfg.inclination, cfg.azimuth, cfg.distance)
        if key in seen:
            groups[seen[key]].append(i)
        else:
            seen[key] = len(groups)
            groups.append([i])
    return groups


def peel_off(inst_cfgs, inst_tabs, accs, lam, pos, contrib_per_sr, kind: int,
             active, tracer, transparent_too: bool = False):
    """Peel a batch of events off toward every distant instrument.
    contrib_per_sr(kobs) -> (B,) luminosity per steradian toward kobs."""
    B = lam.shape[0]
    for group in _observer_groups(inst_cfgs):
        kobs = inst_tabs[group[0]]["kobs"]
        tau_obs = tracer(pos, kobs.expand(B, 3), active,
                         inst_cfgs[group[0]].frame_axes()[0])
        att = torch.exp(-tau_obs)
        for i in group:
            per_sr = contrib_per_sr(inst_tabs[i]["kobs"])
            dinst.detect(inst_cfgs[i], inst_tabs[i], accs[i], lam, pos,
                         per_sr * att, kind, active)
            if transparent_too:
                dinst.detect(inst_cfgs[i], inst_tabs[i], accs[i], lam, pos,
                             per_sr, dinst.KIND_TRANSPARENT, active)
    return accs


def _unsort(x, perm):
    """Per-lane results of sorted lanes back in launch order."""
    out = torch.empty_like(x)
    out[perm] = x
    return out


# ---------------------------------------------------------------- the life cycle

def life_cycle(med: msys.MediumTables, opts: TransportOptions, inst_cfgs,
               inst_tabs, rf_borders, pkt, rf, accs, sweep_tabs,
               stats: dict | None = None, emit_mask=None,
               return_state: bool = False):
    """Run the complete life cycle of one launched packet batch.

    rf: (ncells, nbins) radiation-field accumulator or None; accs: one dict of
    accumulators per instrument. Both are updated in place and returned,
    with the final packet state as a third value when return_state is set
    (lane-refill generations). emit_mask: the lanes whose emission peel-off
    is recorded (default: every alive lane); under lane refill only the
    freshly launched lanes emit, survivors already did in an earlier call.
    stats, when given, accumulates "events" (event iterations run), "syncs"
    (early-exit tests) and "sync_s" (host seconds spent waiting in them).
    """
    check_supported(opts)
    opt = msys.optics_at(med, pkt.lam)
    sigma_lanes = opt.sigma_ext.T.contiguous()   # (H, B)
    h_cells = np.asarray(sweep_tabs.h)
    is_xl = isinstance(sweep_tabs, xl.XLTables)
    is_ml = isinstance(sweep_tabs, ml.MLTables)

    def tracer(pos, kdir, mask, kobs_host):
        # every lane marches toward the same observer: one shared slab axis
        hint = int(np.argmax(np.abs(np.asarray(kobs_host, np.float64))
                             / h_cells))
        if is_xl:
            prm = xl.entry_order(sweep_tabs, pos, hint)
            tau = xl.sweep_tau_total(sweep_tabs, pos[prm], kdir[prm],
                                     sigma_lanes[:, prm], mask[prm],
                                     axis_hint=hint)
            return _unsort(tau, prm)
        if is_ml:
            return ml.sweep_tau_total(sweep_tabs, pos, kdir, sigma_lanes,
                                      mask, axis_hint=hint)
        return sw.sweep_tau_total(sweep_tabs, pos, kdir, sigma_lanes, mask,
                                  axis_hint=hint)

    kind_direct = (dinst.KIND_PRIMARY_DIRECT if opts.primary
                   else dinst.KIND_SECONDARY_DIRECT)
    kind_scat = (dinst.KIND_PRIMARY_SCATTERED if opts.primary
                 else dinst.KIND_SECONDARY_SCATTERED)

    use_rf = opts.store_rf and rf is not None and rf_borders is not None
    n_groups = _rf_groups(opts, rf if use_rf else None, pkt.lam.shape[0],
                          is_xl)
    # the small tensors the event loop needs, built here so that the loop
    # copies nothing from the host
    bin_map = None
    if use_rf:
        rf_in_range = (pkt.lam >= rf_borders[0]) & (pkt.lam < rf_borders[-1])
        bin_map = _bin_map(opts, rf, n_groups, rf.device)
        if is_xl and bin_map is None and rf.shape[1] > 1:
            # kernel 7 adds into the RF itself: the one group of a
            # monochromatic source maps to the source's bin
            bin_map = torch.tensor([opts.rf_mono_bin], dtype=torch.int32,
                                   device=rf.device)
    do_peel = bool(inst_cfgs) and opts.peel_off

    # ---- emission peel-off
    if do_peel:
        emit = pkt.alive if emit_mask is None else emit_mask & pkt.alive
        peel_off(inst_cfgs, inst_tabs, accs, pkt.lam, pkt.pos,
                 lambda kobs: pkt.lum * _ISO, kind_direct, emit, tracer,
                 transparent_too=True)

    tags = _path_tags(opts) + (_TAG_SCATTER_CT, _TAG_SCATTER_PHI)
    if med.ncomp > 1:
        tags = tags + (_TAG_SCATTER_COMP,)
    tag_t = torch.tensor(tags, dtype=torch.int64, device=pkt.lam.device)
    inv_sqrt = 1.0 / float(np.sqrt(opts.rf_scale))

    # one profiler range around the loop, so that a profile can tell the
    # loop's device work from the batch's set-up (tools/event_profile.py)
    with record_function(EVENT_LOOP_RANGE):
        for _ in range(opts.max_events):
            t0 = time.perf_counter()
            any_alive = bool(pkt.alive.any())
            if stats is not None:
                stats["sync_s"] = (stats.get("sync_s", 0.0)
                                   + time.perf_counter() - t0)
                stats["syncs"] = stats.get("syncs", 0) + 1
            if not any_alive:
                break
            if stats is not None:
                stats["events"] = stats.get("events", 0) + 1
            keys = rng.event_keys(pkt.hkey, pkt.nscat)
            u = dict(zip(tags, rng.uniforms(keys, tag_t)))
            active = pkt.alive

            # pass 1: optical depth per slab and along the whole path
            if is_xl:
                # the record, its prefix and the lane range come out of the
                # kernel, in sorted lane order
                perm = xl.lane_order(sweep_tabs, pkt.pos, pkt.dir,
                                     sw.dominant_axis(sweep_tabs, pkt.dir),
                                     n_groups)
                p_pos, p_dir, p_act = pkt.pos[perm], pkt.dir[perm], active[perm]
                dtau_sub, tb_slab, tau_path, lane = xl.sweep_dtau_prefix(
                    sweep_tabs, p_pos, p_dir, sigma_lanes[:, perm], p_act)
                tau_path = _unsort(tau_path, perm)
            elif is_ml:
                # per plan step; the record feeds pass 2 without the density
                # (the leaf ids only the deposits read), the lane range and
                # the step sums both passes
                (dtau_sub, cell_sub, dtau_step, tb_slab, tau_path,
                 lane) = ml.sweep_dtau_prefix(
                    sweep_tabs, pkt.pos, pkt.dir, sigma_lanes, active,
                    leaf_ids=use_rf)
            else:
                # the prefix and the lane range come out of the kernel
                tb_slab, tau_path, lane = sw.sweep_dtau_prefix(
                    sweep_tabs, pkt.pos, pkt.dir, sigma_lanes, active)
            tau_int, w_bias, tau_ok = sample_interaction_tau(opts, u, tau_path)
            active_int = active & tau_ok

            # pass 2: RF deposits and the exact interaction point
            rf_mask = ((active & rf_in_range) if use_rf
                       else torch.zeros_like(active))
            lum_half = (pkt.lum * rf_mask) * inv_sqrt
            if is_xl:
                # the scale per slab is formed inside from the prefix; the
                # lane groups' deposits land in their bins of the RF itself
                _, *res = xl.sweep_deposit_prefix(
                    sweep_tabs, p_pos, p_dir, active_int[perm], dtau_sub,
                    lum_half[perm] if use_rf else None, tau_int[perm],
                    tb_slab, inv_sqrt, lane, n_groups=n_groups,
                    bin_map=bin_map, nbins=rf.shape[1] if use_rf else 0,
                    rf=rf if use_rf else None)
                s_int, icell, found = (_unsort(x, perm) for x in res)
                if sweep_tabs.cellmap is not None:
                    # a tree raster: the interaction voxel's leaf
                    icell = torch.where(
                        found, sweep_tabs.cellmap[icell.clamp_min(0)].to(
                            torch.int64), torch.full_like(icell, -1))
            elif is_ml:
                if use_rf:
                    # lane groups fold into their bins inside the kernel
                    rf_delta, s_int, icell, found = ml.sweep_deposit(
                        sweep_tabs, pkt.pos, pkt.dir, active, dtau_sub,
                        cell_sub, lum_half, tau_int, tb_slab, inv_sqrt,
                        n_groups=n_groups, lane=lane, bin_map=bin_map,
                        nbins=rf.shape[1])
                    _add_rf(rf, rf_delta, opts, n_groups)
                else:
                    s_int, icell, found = ml.resolve_interaction(
                        sweep_tabs, pkt.pos, pkt.dir, active_int, dtau_sub,
                        tb_slab, tau_int, lane=lane, dtau_step=dtau_step)
            else:
                # scale and rel per slab are formed inside from the prefix
                rf_delta, s_int, icell, found = sw.sweep_deposit_prefix(
                    sweep_tabs, pkt.pos, pkt.dir, sigma_lanes, active,
                    lum_half, tau_int, tb_slab, inv_sqrt, lane,
                    n_groups=n_groups,
                    bin_map=bin_map, nbins=rf.shape[1] if use_rf else 0)
                if use_rf:
                    _add_rf(rf, rf_delta, opts, n_groups)
            ipos = pkt.pos + s_int[:, None] * pkt.dir
            active_int = active_int & found

            lum_at = pkt.lum * w_bias
            albedo = msys.albedo_for_scattering(med, opt, icell)
            pkt = pkt._replace(
                pos=torch.where(active_int[:, None], ipos, pkt.pos),
                cell=torch.where(active_int, icell, pkt.cell),
                lum=torch.where(active_int, lum_at, pkt.lum))
            if med.ncomp > 1:
                h = msys.select_component(med, opt, icell,
                                          u[_TAG_SCATTER_COMP])
            else:
                h = torch.zeros_like(icell)

            # scattering peel-off
            if do_peel:
                w_comp = msys.scattering_weights(med, opt, icell)
                lum_alb = pkt.lum * albedo

                def per_sr(kobs):
                    ct = torch.sum(pkt.dir * kobs, dim=-1)
                    ph = torch.sum(w_comp * phs.hg_phase(opt.g, ct[:, None]),
                                   dim=-1)
                    return lum_alb * ph

                peel_off(inst_cfgs, inst_tabs, accs, pkt.lam, pkt.pos, per_sr,
                         kind_scat, active_int, tracer)

            # the scattering event proper
            g_sel = opt.g.gather(1, h[:, None])[:, 0]
            newdir = hg_scatter_direction(u[_TAG_SCATTER_CT],
                                          u[_TAG_SCATTER_PHI], g_sel, pkt.dir)
            lum_new = pkt.lum * albedo
            nscat_new = pkt.nscat + 1
            survive = survives_cutoff(opts, lum_new, nscat_new, pkt.lum0)
            pkt = pkt._replace(
                dir=torch.where(active_int[:, None], newdir, pkt.dir),
                lum=torch.where(active_int, lum_new, pkt.lum),
                nscat=torch.where(active_int, nscat_new, pkt.nscat),
                alive=active_int & survive & (lum_new > 0))
    if return_state:
        return rf, accs, pkt
    return rf, accs
