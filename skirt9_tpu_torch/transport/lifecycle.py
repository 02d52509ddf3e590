"""The photon-packet life cycle of one batch, on PyTorch tensors.

Port of `skirt9_tpu/transport/lifecycle.py`: the emission peel-off, then
up to max_events forced-scattering events, each

  1. pass 1: optical depth per slab and its ray-ordered prefix (a sweep)
     or per step of the scan march,
  2. biased interaction optical depth (composite uniform/exponential),
  3. pass 2: RF deposits and the interaction point,
  4. HG peel-off toward every distant instrument (the optical depth along
     the observer direction, then `instruments.distant.detect`),
  5. HG scattering, albedo weighting and the weight-cutoff test.

With Mueller tables (`life_cycle(..., mueller=)`, polarization) steps 4
and 5 track the Stokes vector: the peel-off rotates the packet's frame into
the scattering plane, applies the Mueller matrix and records Q, U, V in
the instrument frame, and the scattering event samples the polarized phase
function and carries the Stokes vector and reference normal on. With
kinematics each interaction sees the wavelength in its cell's rest frame,
and the scattered packet takes the Doppler shift of its new direction.
Both ride every sweep, the resident, the tree (multi-level) and the XL one
(uniform grids and tree rasters) alike, as in the reference: polarization
touches only the peel-off and the scattering, and kinematics rides a
sweep only where every component's cross sections are
wavelength-independent and at most one RF bin is stored (the reference's
`kin_ok`): the perceived-wavelength opacity then equals the
launch-wavelength one, so the sweep's constant per-lane cross sections
stay exact. Elsewhere kinematics takes the march. The multi-level sweep
itself declines kinematics and the wavelength-changing physics (its
tables are never built for them, `mlsweep.supports`), so a tree with them
runs on its voxel raster's XL tables or on the march.

With Compton, Lyman-alpha or X-ray physics (`TransportOptions.compton`,
`lya`, `xray`) a scattering changes the packet's wavelength, so each event
re-derives the optics and the per-lane cross sections the sweep kernels
take, and each of these branches peels off at its own detection
wavelengths, the observer ray's optical depth taken there (the
reference's `march_uses_lam_fn`): Klein-Nishina scattering with its
Compton shift (`ops/compton.py`); Lya resonant scattering (`ops/lya.py`:
the atom's velocity by rejection, core skipping, the dipole or isotropic
direction, the redistributed wavelength; albedo 1); the X-ray gas's
electron and fluorescence channels (`lifecycle.xray_channels`, the line
from the absorbing bin's cdf, two peel-offs).

Which engine an event runs is the reference's `use_sweep` gate
(`skirt9_tpu/transport/lifecycle.py:566-608`, `sweep_gate` here): a sweep
where the simulation built sweep tables and the options and the batch
suit them, else the scan march (`transport/march.py`). The march takes
explicit absorption (the interaction sampled on the scattering optical
depth, absorption an exp(-tau_abs) weight, albedo 1), kinematics with
wavelength-dependent cross sections or a multi-bin RF (per-cell perceived
wavelengths), Compton, Lya and X-ray physics with a multi-bin RF (binned by
each lane's current wavelength), Lya in multi-component, moving or
multi-temperature media (the Voigt opacity at each cell's temperature and
perceived wavelength), multi-bin RFs without bin-pure lane groups, batches
that do not divide into 128-lane blocks (1,024-lane rows on XL tables),
and every grid without sweep tables (meshed Cartesian grids, Voronoi
grids walked exactly, trees that no sweep takes). On the march, pass 1 is
one march recording (S, B) step tables and their cumulative sums, pass 2
the RF deposits into the bin of each lane's current wavelength (an f64
table over the life cycle, added into the RF rounded once) and the
interaction point; the tracer marches again. Everything after pass 2 is
the same code on every engine. A tree's multi-level sweep tables cannot
fall back to the march: `sweep_gate` raises there, as the reference does
(a batch that does not divide into 128-lane blocks, a multi-bin RF
without bin-pure lanes); the XL tables of a tree's raster fall back like
a uniform grid's.

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

With `mlsweep.MLTables` (octrees and bintrees, and Voronoi grids on their
raster) the event follows the
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
host sync per event on the resident sweep and on the march. Options
outside the port raise NotImplementedError and name themselves.
"""

from __future__ import annotations

import dataclasses
import math
import time
import typing

import numpy as np
import torch
from torch.profiler import record_function

from ..instruments import distant as dinst
from ..media import system as msys
from ..ops import compton as co
from ..ops import lya as lyo
from ..ops import phase as phs
from ..ops import rng
from ..ops import sampling
from ..ops import stokes as stk
from ..ops import xlamath as xm
from . import march as mr
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
# the wavelength-changing branches' draws (the reference's tags)
_TAG_LYA_UPAR = _TAG_SCATTER_COMP + 40      # the rejection rounds' base
_TAG_LYA_PERP1 = _TAG_SCATTER_COMP + 41     # a Gaussian
_TAG_LYA_SKIP_R = _TAG_SCATTER_COMP + 43
_TAG_LYA_SKIP_A = _TAG_SCATTER_COMP + 44
_TAG_LYA_DIPOLE = _TAG_SCATTER_COMP + 45
_TAG_XRAY_LINE = _TAG_SCATTER_COMP + 50
_TAG_XRAY_CHANNEL = _TAG_SCATTER_COMP + 51
_TAG_XRAY_ISO = _TAG_SCATTER_COMP + 52

_ISO = 1.0 / (4.0 * math.pi)
_INV_SQRT2 = 0.7071067811865476
_INV_C = 1.0 / 2.99792458e8  # inverse speed of light [s/m]


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
    ("emission_doppler", lambda o: o.emission_doppler),
)


def check_supported(opts: TransportOptions) -> None:
    """Raise NotImplementedError naming every option outside the port."""
    missing = [name for name, on in _NOT_PORTED if on(opts)]
    if missing:
        raise NotImplementedError(
            f"transport options not ported yet: {', '.join(missing)}")


def lam_changing(opts: TransportOptions) -> bool:
    """Whether scatterings change the packets' wavelengths (Compton,
    Lyman-alpha or X-ray physics)."""
    return opts.compton or opts.lya or opts.xray


def check_kinematics(med: msys.MediumTables, opts: TransportOptions,
                     rf_nbins: int) -> bool:
    """The reference's `kin_ok` (`skirt9_tpu/transport/lifecycle.py:
    566-573`): whether kinematics, where it is on, can ride a sweep, that is
    whether every component's cross sections are wavelength-independent
    and at most one RF bin is stored; where not, the scan march takes it."""
    if not opts.kinematics:
        return True
    se, ss = med.sigma_ext, med.sigma_sca
    return (bool(torch.all(se == se[:, :1]) and torch.all(ss == ss[:, :1]))
            and rf_nbins <= 1)


def check_wavelength_changing(med: msys.MediumTables, opts: TransportOptions,
                              rf_nbins: int, n_groups: int = 1):
    """The reference's `lam_sweep_ok` and `lya_sweep_ok` (`skirt9_tpu/
    transport/lifecycle.py:584-599`): wavelength-changing physics rides a
    sweep only where at most one RF bin is stored in one lane group, and
    Lya only in a static one-component medium at one gas temperature,
    where the Voigt opacity factors into one cross section per lane.
    Returns that temperature for Lya (0.0 for the others and without such
    physics), or None where the scan march takes the case."""
    if not lam_changing(opts):
        return 0.0
    if rf_nbins > 1 or n_groups != 1:
        return None
    if not opts.lya:
        return 0.0
    occ = med.nd.sum(dim=-1) > 0
    if med.ncomp != 1 or bool(torch.any(med.bulk_v != 0)) \
            or not bool(occ.any()):
        return None
    t_occ = med.temperature[occ].double()
    t_min, t_max = float(t_occ.min()), float(t_occ.max())
    if not (t_min > 0 and t_max - t_min <= 1e-6 * t_max):
        return None
    return float(t_occ[0])


class Gate(typing.NamedTuple):
    """The reference's engine choice for one batch: whether a sweep runs
    it, the bin-pure lane groups of its deposits, the Lya gas temperature
    of the sweep's cross sections, and why the march runs instead."""

    use_sweep: bool
    n_groups: int
    lya_T0: float
    why: tuple


def sweep_gate(med: msys.MediumTables, opts: TransportOptions, sweep_tabs,
               rf, B: int) -> Gate:
    """The reference's `use_sweep` (`skirt9_tpu/transport/lifecycle.py:
    566-608`) for a batch of B lanes, sweep_tabs the simulation's tables
    (None: none) and rf its stored RF (None: none): a sweep runs unless
    explicit absorption is on, kinematics or wavelength-changing physics
    fail their gates, a multi-bin RF has no bin-pure lane layout, or the
    batch does not divide into the groups' 128-lane blocks (on XL tables,
    into rows of 8 blocks). A tree's tables cannot fall back to the march
    there, and raise, as the reference's do."""
    rf_nbins = rf.shape[1] if rf is not None and opts.store_rf else 0
    n_groups = 1
    if rf_nbins > 1:
        if opts.rf_strata > 0:
            n_groups = opts.rf_strata
        elif opts.rf_mono_bin < 0:
            rf_nbins = -1
    is_xl = isinstance(sweep_tabs, xl.XLTables)
    kin_ok = check_kinematics(med, opts, rf_nbins)
    lya_T0 = check_wavelength_changing(med, opts, rf_nbins, n_groups)
    why = tuple(w for w, bad in (
        ("no sweep tables", sweep_tabs is None),
        ("explicitAbsorption", opts.explicit_absorption),
        ("kinematics with wavelength-dependent optics or a multi-bin RF",
         not kin_ok),
        ("wavelength-changing physics with a multi-bin RF, or Lya in a "
         "multi-component, moving or multi-temperature medium",
         lya_T0 is None),
        (f"batch {B} not divisible by {128 * n_groups}",
         B % (128 * n_groups) != 0),
        (f"batch {B} not divisible into the XL engine's 1024-lane blocks",
         is_xl and (B // 128) % 8 != 0),
        ("multi-bin RF without bin-pure lane layout", rf_nbins < 0)) if bad)
    if isinstance(sweep_tabs, ml.MLTables) and why:
        raise ValueError("multi-level sweep grid cannot fall back to the "
                         f"scan march ({', '.join(why)})")
    return Gate(not why, n_groups, lya_T0 or 0.0, why)


def _dot3(a, b):
    """Row-wise dot products of (B, 3) tensors, summed as (x + y) + z."""
    p = a * b
    return (p[..., 0] + p[..., 1]) + p[..., 2]


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
    """Henyey-Greenstein direction update from two uniforms
    (`phase.hg_scatter`)."""
    return phs.hg_scatter(dirn, g_sel, u_ct, u_phi)


def survives_cutoff(opts: TransportOptions, lum_new, nscat_new, lum0):
    """Weight-cutoff / minimum-scattering termination test."""
    return (lum_new * opts.min_weight_reduction > lum0) | \
        (nscat_new < opts.min_scatt_events)


# ------------------------------------------------- wavelength-binned RF

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
             active, tracer, transparent_too: bool = False, lam_fn=None,
             march_at_lam_fn: bool = False, cell=None, lam_march=None,
             lya: bool = False):
    """Peel a batch of events off toward every distant instrument.
    contrib_per_sr(i, kobs) -> ((B,) luminosity per steradian toward
    instrument i's direction kobs, (B, 3) Stokes Q, U, V in its frame or
    None); lam_fn(kobs): the detection wavelengths where they are not lam
    (a moving cell's Doppler shift, a Compton shift, a fluorescence line,
    a Lya redistribution). With march_at_lam_fn the observer ray's optical
    depth is taken at those wavelengths (the group's first observer's), as
    the reference's `march_uses_lam_fn` does, else at lam_march where one
    is given (the march's per-cell perceived wavelengths); cell: the lanes'
    cells, where the march starts; lya: the march's Voigt opacity. The
    transparent kind records no Stokes, as in the reference."""
    B = lam.shape[0]
    for group in _observer_groups(inst_cfgs):
        kobs = inst_tabs[group[0]]["kobs"]
        lam_m = lam_fn(kobs) if march_at_lam_fn else lam_march
        tau_obs = tracer(pos, kobs.expand(B, 3), active,
                         inst_cfgs[group[0]].frame_axes()[0], lam_m, cell,
                         lya)
        att = torch.exp(-tau_obs)
        for i in group:
            ko = inst_tabs[i]["kobs"]
            per_sr, quv = contrib_per_sr(i, ko)
            lam_i = lam if lam_fn is None else lam_fn(ko)
            dinst.detect(inst_cfgs[i], inst_tabs[i], accs[i], lam_i, pos,
                         per_sr * att, kind, active, stokes_quv=quv)
            if transparent_too:
                dinst.detect(inst_cfgs[i], inst_tabs[i], accs[i], lam_i, pos,
                             per_sr, dinst.KIND_TRANSPARENT, active)
    return accs


def _detector_normals(inst_tabs) -> list:
    """Per instrument, the Q/U reference normal of its frame, cross(kobs,
    north) with north its up direction e_y made perpendicular to kobs (the
    reference's polarized peel-off, `skirt9_tpu/transport/lifecycle.py:
    1303-1312`), on the device once per life cycle."""
    out = []
    for tab in inst_tabs:
        kobs, ey = tab["kobs"], tab["ey"]
        north = ey - torch.sum(ey * kobs) * kobs
        north = north / torch.clamp_min(torch.linalg.vector_norm(north),
                                        1e-30)
        out.append(torch.cross(kobs, north, dim=-1))
    return out


def polarized_per_sr(pkt, mueller, h, s11n, lum_alb, kobs, n_det):
    """The polarized scattering peel-off toward kobs (`skirt9_tpu/transport/
    lifecycle.py:1277-1316`): rotate the packet's reference normal into the
    scattering plane, apply the Mueller matrix, normalise, take the phase
    from the S11 integral, and rotate the Stokes vector from the plane's
    normal into the instrument frame's by beta. Returns (luminosity per
    steradian, (B, 3) Q, U, V). n_det: the instrument's Q/U reference
    normal (`_detector_normals`)."""
    B = pkt.lam.shape[0]
    ko = kobs.expand(B, 3)
    ct_o = torch.sum(pkt.dir * ko, dim=-1)
    phi_o, pn = stk.rotate_normal_into_plane(pkt.dir, pkt.normal, ko)
    S11, S12, S33, S34 = stk.mueller_at(mueller, h, ct_o)
    st_obs = stk.apply_mueller(stk.rotate_stokes(pkt.stokes, phi_o), S11,
                               S12, S33, S34)
    st_obs, I_obs = stk.normalize_stokes(st_obs)
    phase = I_obs / torch.clamp_min(
        2 * math.pi * s11n * torch.clamp_min(pkt.stokes[:, 0], 1e-30), 1e-30)
    nd = n_det.expand(B, 3)
    cosb = torch.sum(pn * nd, dim=-1)
    sinb = torch.sum(torch.cross(pn, nd, dim=-1) * ko, dim=-1)
    st_final = stk.rotate_stokes(st_obs, torch.atan2(sinb, cosb))
    return lum_alb * phase, st_final[:, 1:]


def polarized_scatter(pkt, mueller, h, u_ct, u_phi):
    """The polarized scattering event (`skirt9_tpu/transport/lifecycle.py:
    1346-1365`): cos(theta) from the S11 marginal, the azimuth from the
    polarization-dependent conditional, then the new direction, reference
    normal and normalised Stokes vector."""
    ct = stk.sample_costheta(mueller, h, u_ct)
    S11, S12, S33, S34 = stk.mueller_at(mueller, h, ct)
    phi = stk.sample_azimuth(S11, S12, pkt.stokes, u_phi)
    sp, cp = xm.sincos(phi)
    n_rot = (cp[:, None] * pkt.normal
             + sp[:, None] * torch.cross(pkt.dir, pkt.normal,
                                                     dim=-1))
    m = torch.cross(n_rot, pkt.dir, dim=-1)
    st = torch.sqrt(torch.clamp_min(1.0 - ct * ct, 0.0))
    newdir = ct[:, None] * pkt.dir + st[:, None] * m
    newdir = newdir / torch.linalg.vector_norm(newdir, dim=-1, keepdim=True)
    st_new = stk.apply_mueller(stk.rotate_stokes(pkt.stokes, phi), S11, S12,
                               S33, S34)
    return newdir, n_rot, stk.normalize_stokes(st_new)[0]


def _unsort(x, perm):
    """Per-lane results of sorted lanes back in launch order."""
    out = torch.empty_like(x)
    out[perm] = x
    return out


# ---------------------------------------------------------------- the life cycle

def life_cycle(med: msys.MediumTables, opts: TransportOptions, inst_cfgs,
               inst_tabs, rf_borders, pkt, rf, accs, sweep_tabs,
               stats: dict | None = None, emit_mask=None,
               return_state: bool = False, mueller=None, xray_tabs=None,
               grid=None):
    """Run the complete life cycle of one launched packet batch.

    rf: (ncells, nbins) radiation-field accumulator or None; accs: one dict of
    accumulators per instrument. Both are updated in place and returned,
    with the final packet state as a third value when return_state is set
    (lane-refill generations). emit_mask: the lanes whose emission peel-off
    is recorded (default: every alive lane); under lane refill only the
    freshly launched lanes emit, survivors already did in an earlier call.
    stats, when given, accumulates "events" (event iterations run), "syncs"
    (early-exit tests) and "sync_s" (host seconds spent waiting in them).
    mueller: the `ops.stokes.MuellerTables` of polarized scattering, on the
    batch's device; without them the scattering is not polarized, as in the
    reference. xray_tabs: `media.xray.device_tables` on the batch's device,
    which the X-ray option needs. sweep_tabs: the simulation's sweep tables
    or None; grid: the simulation's grid, which the scan march walks where
    `sweep_gate` sends the batch there.
    """
    check_supported(opts)
    B = pkt.lam.shape[0]
    gate = sweep_gate(med, opts, sweep_tabs, rf, B)
    use_sweep, n_groups, lya_T0 = gate.use_sweep, gate.n_groups, gate.lya_T0
    if not use_sweep and grid is None:
        raise ValueError("the scan march needs the grid (life_cycle(..., "
                         f"grid=)): {', '.join(gate.why)}")
    if opts.xray and xray_tabs is None:
        raise ValueError("the X-ray option needs xray_tabs "
                         "(media.xray.device_tables)")
    changing = lam_changing(opts)
    polarized = opts.polarization and mueller is not None and not changing
    march = not use_sweep
    is_xl = use_sweep and isinstance(sweep_tabs, xl.XLTables)
    is_ml = use_sweep and isinstance(sweep_tabs, ml.MLTables)
    # the march takes the cells' perceived wavelengths
    lam_moving = opts.kinematics or opts.lya

    def sig_lanes(o, lam):
        """(H, B) cross sections of optics o at wavelengths lam; in Lya mode
        component 0 adds the Voigt cross section at the uniform gas
        temperature (the marker mix's own tables are zero), as the
        reference's `sig_lanes_of` does (`lifecycle.py:610-618`)."""
        sig = o.sigma_ext.T
        if opts.lya:
            sig = sig.clone()
            sig[0] += lyo.cross_section(lam, lya_T0)
        return sig.contiguous()

    opt = msys.optics_at(med, pkt.lam)
    if use_sweep:
        h_cells = np.asarray(sweep_tabs.h)
        sigma_lanes = sig_lanes(opt, pkt.lam)      # (H, B)

    def tracer(pos, kdir, mask, kobs_host, lam_m=None, cell=None,
               lya=False):
        # every lane marches toward the same observer. On the march: from
        # the lanes' cells, at their current optics or, with lam_m, at the
        # cells' perceived wavelengths (the Voigt opacity with lya). On a
        # sweep: one shared slab axis; lam_m: the detection wavelengths,
        # where the opacity is taken there
        if march:
            return mr.trace_tau(grid, med, opt, pos, kdir, cell,
                                opts.max_steps, mask, lam=lam_m, lya=lya)
        sig = (sigma_lanes if lam_m is None
               else sig_lanes(msys.optics_at(med, lam_m), lam_m))
        hint = int(np.argmax(np.abs(np.asarray(kobs_host, np.float64))
                             / h_cells))
        if is_xl:
            prm = xl.entry_order(sweep_tabs, pos, hint)
            tau = xl.sweep_tau_total(sweep_tabs, pos[prm], kdir[prm],
                                     sig[:, prm], mask[prm], axis_hint=hint)
            return _unsort(tau, prm)
        if is_ml:
            return ml.sweep_tau_total(sweep_tabs, pos, kdir, sig, mask,
                                      axis_hint=hint)
        return sw.sweep_tau_total(sweep_tabs, pos, kdir, sig, mask,
                                  axis_hint=hint)

    kind_direct = (dinst.KIND_PRIMARY_DIRECT if opts.primary
                   else dinst.KIND_SECONDARY_DIRECT)
    kind_scat = (dinst.KIND_PRIMARY_SCATTERED if opts.primary
                 else dinst.KIND_SECONDARY_SCATTERED)

    use_rf = opts.store_rf and rf is not None and rf_borders is not None
    # the small tensors the event loop needs, built here so that the loop
    # copies nothing from the host
    bin_map = rf_acc = None
    if use_rf:
        nrf = rf_borders.shape[0] - 1
        in_range = lambda lam: (lam >= rf_borders[0]) & (lam < rf_borders[-1])
        bin_of = lambda lam: torch.clamp(
            sampling.searchsorted_right(rf_borders, lam) - 1, 0, nrf - 1)
        rf_in_range = in_range(pkt.lam)
        if march:
            # the march's deposits sum in f64 over the life cycle: an event
            # that leaves a point source puts thousands into a hot cell
            rf_bin = bin_of(pkt.lam)
            rf_acc = rf if rf.dtype == torch.float64 else rf.double()
        else:
            bin_map = _bin_map(opts, rf, n_groups, rf.device)
            if is_xl and bin_map is None and rf.shape[1] > 1:
                # kernel 7 adds into the RF itself: the one group of a
                # monochromatic source maps to the source's bin
                bin_map = torch.tensor([opts.rf_mono_bin], dtype=torch.int32,
                                       device=rf.device)
    do_peel = bool(inst_cfgs) and opts.peel_off
    if polarized:
        s11n_h = stk.s11_norm(mueller)
        n_dets = _detector_normals(inst_tabs)

    # ---- emission peel-off (at the launch wavelengths' opacity)
    if do_peel:
        emit = pkt.alive if emit_mask is None else emit_mask & pkt.alive
        peel_off(inst_cfgs, inst_tabs, accs, pkt.lam, pkt.pos,
                 lambda i, kobs: (pkt.lum * _ISO, None), kind_direct, emit,
                 tracer, transparent_too=True, cell=pkt.cell,
                 lam_march=pkt.lam if march and lam_moving else None,
                 lya=opts.lya)

    tags = _path_tags(opts) + (_TAG_SCATTER_CT, _TAG_SCATTER_PHI)
    if med.ncomp > 1:
        tags = tags + (_TAG_SCATTER_COMP,)
    if opts.lya:
        tags = tags + (_TAG_LYA_DIPOLE,)
        if opts.lya_xcrit > 0 or opts.lya_variable:
            tags = tags + (_TAG_LYA_SKIP_R, _TAG_LYA_SKIP_A)
    if opts.xray:
        tags = tags + (_TAG_XRAY_LINE, _TAG_XRAY_CHANNEL, _TAG_XRAY_ISO)
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
            if changing:
                # the optics follow the packets' current wavelengths (the
                # reference's `:786` and `:805`), and so does the RF bin
                opt = msys.optics_at(med, pkt.lam)
                if use_sweep:
                    sigma_lanes = sig_lanes(opt, pkt.lam)
                if use_rf:
                    rf_in_range = in_range(pkt.lam)
                    if march:
                        rf_bin = bin_of(pkt.lam)
            rf_mask = ((active & rf_in_range) if use_rf
                       else torch.zeros_like(active))

            # pass 1: optical depth per slab, or per march step, and along
            # the whole path
            if march:
                # one march records the path; the interaction is sampled on
                # the scattering optical depth under explicit absorption
                cells, ds, dtau_ext, *sca = mr.march_record(
                    grid, med, opt, pkt.pos, pkt.dir, pkt.cell,
                    opts.max_steps, active,
                    record_sca=opts.explicit_absorption,
                    lam=pkt.lam if lam_moving else None, lya=opts.lya)
                dtau_s = sca[0] if sca else dtau_ext
                tb_ext = mr.tau_before(dtau_ext)
                tb_s = mr.tau_before(dtau_s) if sca else tb_ext
                tau_path = tb_s[-1] + dtau_s[-1]
            elif is_xl:
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
            lum_half = None if march else (pkt.lum * rf_mask) * inv_sqrt
            if march:
                # the deposits along the whole path, into each lane's bin
                if use_rf:
                    mr.deposit_rf(rf_acc, cells, ds, dtau_ext, tb_ext,
                                  pkt.lum, rf_bin, rf_mask, opts.rf_scale)
                ipos, icell, found, idx, frac = mr.interaction_point(
                    pkt.pos, pkt.dir, cells, ds, dtau_s, tb_s, tau_int,
                    active_int)
                if opts.explicit_absorption:
                    # the absorption optical depth up to the interaction
                    take = lambda a: a.gather(0, idx[None, :])[0]
                    tau_abs_at = xm.fma(frac, take(dtau_ext - dtau_s),
                                        take(tb_ext) - take(tb_s))
                # free the step tables before the peel-off's march
                del cells, ds, dtau_ext, dtau_s, tb_ext, tb_s, sca
            elif is_xl:
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
            if use_sweep:
                ipos = pkt.pos + s_int[:, None] * pkt.dir
            active_int = active_int & found

            if opts.kinematics:
                # the wavelength perceived in the interaction cell's rest
                # frame (ref: PhotonPacket::perceivedWavelength)
                v_int = med.bulk_v[icell.clamp_min(0)]
                lam_cell = pkt.lam / (1.0 - _dot3(pkt.dir, v_int) * _INV_C)
                opt_int = msys.optics_at(med, lam_cell)
            else:
                lam_cell, opt_int = pkt.lam, opt
            lum_at = pkt.lum * w_bias
            if opts.explicit_absorption:
                # absorption as a weight, every interaction a scattering
                lum_at = lum_at * torch.exp(-torch.clamp_min(tau_abs_at, 0.0))
                albedo = torch.ones_like(lum_at)
            else:
                albedo = msys.albedo_for_scattering(med, opt_int, icell)
            if opts.lya:
                albedo = torch.ones_like(lum_at)      # resonant scattering
            if opts.xray:
                albedo, p_fl = xray_channels(xray_tabs, lam_cell)
            pkt = pkt._replace(
                pos=torch.where(active_int[:, None], ipos, pkt.pos),
                cell=torch.where(active_int, icell, pkt.cell),
                lum=torch.where(active_int, lum_at, pkt.lum))
            if med.ncomp > 1:
                h = msys.select_component(med, opt_int, icell,
                                          u[_TAG_SCATTER_COMP])
            else:
                h = torch.zeros_like(icell)

            if opts.lya:
                newdir, lam_new, per_sr, lam_fn = lya_event(
                    med, opts, keys, u, pkt, icell, lam_cell)
            elif opts.compton:
                newdir, lam_new, per_sr, lam_fn = compton_event(
                    u, pkt, albedo, lam_cell)
            elif opts.xray:
                newdir, lam_new, peels = xray_event(
                    xray_tabs, u, pkt, albedo, p_fl, lam_cell)
            if changing:
                # the branch's own peel-offs, marched at their detection
                # wavelengths
                if do_peel:
                    for per_sr_b, lam_fn_b in (peels if opts.xray
                                               else ((per_sr, lam_fn),)):
                        peel_off(inst_cfgs, inst_tabs, accs, pkt.lam,
                                 pkt.pos, per_sr_b, kind_scat, active_int,
                                 tracer, lam_fn=lam_fn_b,
                                 march_at_lam_fn=True, cell=pkt.cell,
                                 lya=opts.lya)
                pkt = pkt._replace(lam=torch.where(active_int, lam_new,
                                                   pkt.lam))
            else:
                # scattering peel-off
                if do_peel:
                    lum_alb = pkt.lum * albedo
                    lam_fn = lam_march = None
                    if polarized:
                        # detected at the packet's incoming lab-frame
                        # wavelength, as the reference's polarized
                        # peel-off does (`lifecycle.py:1323-1329`)
                        s11n = s11n_h[h]
                        per_sr = lambda i, kobs: polarized_per_sr(
                            pkt, mueller, h, s11n, lum_alb, kobs, n_dets[i])
                    else:
                        w_comp = msys.scattering_weights(med, opt_int, icell)

                        def per_sr(i, kobs):
                            ct = torch.sum(pkt.dir * kobs, dim=-1)
                            ph = torch.sum(w_comp * phs.hg_phase(
                                opt_int.g, ct[:, None]), dim=-1)
                            return lum_alb * ph, None

                        if opts.kinematics:
                            # Doppler-shifted toward each observer
                            lam_fn = lambda kobs: lam_cell * (
                                1.0 - _dot3(kobs.expand_as(v_int), v_int)
                                * _INV_C)
                            if march:
                                lam_march = pkt.lam
                    peel_off(inst_cfgs, inst_tabs, accs, pkt.lam, pkt.pos,
                             per_sr, kind_scat, active_int, tracer,
                             lam_fn=lam_fn, cell=pkt.cell,
                             lam_march=lam_march)

                # the scattering event proper
                if polarized:
                    newdir, n_rot, st_new = polarized_scatter(
                        pkt, mueller, h, u[_TAG_SCATTER_CT],
                        u[_TAG_SCATTER_PHI])
                    pkt = pkt._replace(
                        stokes=torch.where(active_int[:, None], st_new,
                                           pkt.stokes),
                        normal=torch.where(active_int[:, None], n_rot,
                                           pkt.normal))
                else:
                    g_sel = opt_int.g.gather(1, h[:, None])[:, 0]
                    newdir = hg_scatter_direction(u[_TAG_SCATTER_CT],
                                                  u[_TAG_SCATTER_PHI], g_sel,
                                                  pkt.dir)
            if opts.kinematics and not opts.lya:
                # the Doppler shift of the new direction out of the cell
                lam_new = lam_cell * (1.0 - _dot3(newdir, v_int) * _INV_C)
                pkt = pkt._replace(lam=torch.where(active_int, lam_new,
                                                   pkt.lam))
            lum_new = pkt.lum * albedo
            nscat_new = pkt.nscat + 1
            survive = survives_cutoff(opts, lum_new, nscat_new, pkt.lum0)
            pkt = pkt._replace(
                dir=torch.where(active_int[:, None], newdir, pkt.dir),
                lum=torch.where(active_int, lum_new, pkt.lum),
                nscat=torch.where(active_int, nscat_new, pkt.nscat),
                alive=active_int & survive & (lum_new > 0))
    if rf_acc is not None and rf_acc is not rf:
        rf.copy_(rf_acc)
    if return_state:
        return rf, accs, pkt
    return rf, accs


# ------------------------------------------- wavelength-changing scattering

def lya_event(med: msys.MediumTables, opts: TransportOptions, keys, u: dict,
              pkt, icell, lam_cell):
    """The Lya resonant scattering (`skirt9_tpu/transport/lifecycle.py:
    1054-1123`): the atom's velocity along the photon by rejection, a
    Gaussian perpendicular component (boosted by core skipping, Constant or
    Variable), the direction by the dipole or, for 2/3 of the core
    scatterings judged in the atom's frame, isotropically, and the
    redistributed wavelength. Returns (new direction, new wavelength, the
    peel-off's per_sr(i, kobs) and its detection wavelengths lam_fn(kobs))."""
    T = torch.clamp_min(med.temperature[icell.clamp_min(0)], 1.0)
    a = lyo.damping_parameter(T, lam_cell)
    x_in = lyo.dimensionless_x(lam_cell, T)
    u_par = lyo.sample_parallel_velocity(keys, _TAG_LYA_UPAR, a, x_in)
    up1 = rng.gauss(keys, _TAG_LYA_PERP1) * _INV_SQRT2
    if opts.lya_xcrit > 0 or opts.lya_variable:
        # core skipping: a lane in the core leaves with its perpendicular
        # velocity drawn beyond xcrit
        if opts.lya_variable:
            n_h = torch.sum(med.nd[icell.clamp_min(0)], dim=-1)
            xc = opts.lya_strength * (torch.clamp_min(n_h, 1e-30) / T) \
                ** (1.0 / 6.0)
        else:
            xc = torch.full_like(x_in, opts.lya_xcrit)
        mag = torch.sqrt(xc * xc - torch.log(u[_TAG_LYA_SKIP_R]))
        up1 = torch.where(torch.abs(x_in) < xc,
                          mag * xm.cos((2.0 * math.pi) * u[_TAG_LYA_SKIP_A]),
                          up1)
    core = (torch.abs(x_in - u_par) <= 0.2) & (u[_TAG_LYA_DIPOLE] >= 1.0 / 3.0)
    u_ct = u[_TAG_SCATTER_CT]
    ct = torch.where(core, 2.0 * u_ct - 1.0, phs.dipole_sample_costheta(u_ct))
    newdir = phs.rotate_direction(pkt.dir, ct,
                                  (2.0 * math.pi) * u[_TAG_SCATTER_PHI])
    lam_new = lyo.scatter_wavelength(lam_cell, pkt.dir, newdir, u_par, up1, T)

    def per_sr(i, kobs):
        ph = torch.where(core, torch.full_like(ct, _ISO),
                         phs.dipole_phase(torch.sum(pkt.dir * kobs, dim=-1)))
        return pkt.lum * ph, None

    def lam_fn(kobs):
        return lyo.scatter_wavelength(lam_cell, pkt.dir, kobs.expand_as(
            pkt.dir), u_par, up1, T)

    return newdir, lam_new, per_sr, lam_fn


def compton_event(u: dict, pkt, albedo, lam_cell):
    """Compton scattering on free electrons (`skirt9_tpu/transport/
    lifecycle.py:1125-1154`): the Klein-Nishina peel-off at the shifted
    wavelength toward each observer, then mu from the KN distribution and
    the shifted wavelength. Returns (new direction, new wavelength,
    per_sr, lam_fn)."""
    x_c = co.x_of_lambda(lam_cell)
    mu_s = co.sample_costheta(u[_TAG_SCATTER_CT], x_c)
    newdir = phs.rotate_direction(pkt.dir, mu_s,
                                  (2.0 * math.pi) * u[_TAG_SCATTER_PHI])
    per_sr = lambda i, kobs: (pkt.lum * albedo * co.phase_value(
        x_c, torch.sum(pkt.dir * kobs, dim=-1)), None)
    lam_fn = lambda kobs: co.shifted_wavelength(
        lam_cell, x_c, torch.sum(pkt.dir * kobs, dim=-1))
    return newdir, co.shifted_wavelength(lam_cell, x_c, mu_s), per_sr, lam_fn


def xray_channels(xray_tabs: dict, lam):
    """The X-ray gas's albedo, (electron + fluorescence) over extinction
    cross section, and the fluorescence channel's share of the scattering,
    at wavelengths lam (`skirt9_tpu/transport/lifecycle.py:1015-1031`),
    interpolated in XLA's arithmetic: the channel test compares a uniform
    with that share, and an ulp of a logarithm near -50 moves a cross
    section by 4e-6 of itself."""
    xt = xray_tabs
    interp = lambda key: sampling.interp_loglog(lam, xt["lam"], xt[key],
                                                xla=True)
    sig_e, sig_fl, sig_ext = (interp(k) for k in ("sigma_sca", "sigma_fluor",
                                                  "sigma_ext"))
    sca = sig_e + sig_fl
    zero = torch.zeros_like(sca)
    albedo = torch.where(sig_ext > 0, sca / torch.clamp_min(sig_ext, 1e-37),
                         zero)
    p_fl = torch.where(sca > 0, sig_fl / torch.clamp_min(sca, 1e-37), zero)
    return albedo, p_fl


def xray_event(xray_tabs: dict, u: dict, pkt, albedo, p_fl, lam_cell):
    """The X-ray gas's scattering (`skirt9_tpu/transport/lifecycle.py:
    1156-1229`): the fluorescence line from the absorbing wavelength bin's
    line cdf; two peel-offs, Klein-Nishina at the shifted wavelength with
    the electron channel's weight and isotropic at the line wavelength with
    the fluorescence channel's; then the channel, and the direction and
    wavelength it gives. Returns (new direction, new wavelength, the
    peel-offs' (per_sr, lam_fn) pairs)."""
    xt = xray_tabs
    x_c = co.x_of_lambda(lam_cell)
    n_lines = xt["line_lam"].shape[0]
    if n_lines > 0:
        kbin = torch.clamp(sampling.searchsorted_right(xt["lam"], lam_cell)
                           - 1, 0, xt["lam"].shape[0] - 1)
        rows = xt["line_cdf"][kbin]                              # (B, L)
        li = torch.clamp(torch.sum(rows < u[_TAG_XRAY_LINE][:, None], dim=1),
                         0, n_lines - 1)
        lam_line = xt["line_lam"][li]
    else:
        lam_line = lam_cell
    mu_o = lambda kobs: torch.sum(pkt.dir * kobs, dim=-1)
    peels = (
        (lambda i, kobs: (pkt.lum * albedo * (1.0 - p_fl) * co.phase_value(
            x_c, mu_o(kobs)), None),
         lambda kobs: co.shifted_wavelength(lam_cell, x_c, mu_o(kobs))),
        (lambda i, kobs: (pkt.lum * albedo * p_fl * _ISO, None),
         lambda kobs: lam_line))
    is_fl = u[_TAG_XRAY_CHANNEL] < p_fl
    mu_s = co.sample_costheta(u[_TAG_SCATTER_CT], x_c)
    mu = torch.where(is_fl, 2.0 * u[_TAG_XRAY_ISO] - 1.0, mu_s)
    newdir = phs.rotate_direction(pkt.dir, mu,
                                  (2.0 * math.pi) * u[_TAG_SCATTER_PHI])
    lam_new = torch.where(is_fl, lam_line,
                          co.shifted_wavelength(lam_cell, x_c, mu_s))
    return newdir, lam_new, peels
