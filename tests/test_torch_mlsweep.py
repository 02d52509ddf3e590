"""Port tree sweep (plain PyTorch) vs the reference, on three small trees.

Trees: the density octree of `tests/test_mlsweep.py` (max_level 4, a 16^3
fine raster), a density bintree (max_level 10: a 16 x 8 x 8 raster with
anisotropic leaves, so per-axis shifts differ) and a site-list octree
(max_level 5, 100 sites, a 32^3 raster). The reference grid is converted
through `skirt9_tpu_torch.bridge`; inputs are made with numpy from a seed.

Bounds, and why:
- tau against the reference's scan march (`lifecycle.trace_tau`): rtol 2e-4,
  atol 1e-5, the reference's own bound for its tree sweep
  (`tests/test_mlsweep.py:91-93`); the sweep's 1e-4 entry nudge moves up to
  that much path across a minor crossing.
- RF per leaf against `march_record`/`deposit_rf`: rtol 3e-3, atol 3e-6 of
  the total; `found` equal on in-grid lanes and `icell` equal where found,
  against `interaction_point` (`tests/test_mlsweep.py:138-150`).
- The summed pass 1 equals (d0 + d1) + d2 of the want_sub record exactly,
  and `resolve_interaction` equals kernel 5's plain interaction exactly (the
  same f32 operations on the same record).
- The reference's own tree sweep in Pallas interpret mode (one case): rtol
  2e-4, atol 1e-5, as against the march: its plan is built on merged and
  clustered levels, so its steps, and their nudges, differ.
- Pass 1's total and prefix modes: the totals against the scan march with
  the bounds above; the total and the prefix against the reference's
  `slab_prefix` of the same step sums within 1e-6 of each lane's tau (one
  f32 sum in another order); the record, leaf ids and lane range those of
  `sweep_dtau` and `sweep._lane_range` exactly.
- `resolve_interaction` given pass 1's lane range and step sums equals the
  call that forms them itself, bit for bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from skirt9_tpu.grids.bintree import build_bintree as ref_build_bintree
from skirt9_tpu.grids.octree import build_octree as ref_build_octree
from skirt9_tpu.grids.octree import site_list_refine_fn as ref_site_list
from skirt9_tpu.media import system as ref_msys
from skirt9_tpu.transport import lifecycle as ref_lc
from skirt9_tpu.transport import mlsweep as ref_ml
from skirt9_tpu.transport import sweep as ref_sw
from skirt9_tpu_torch import bridge
from skirt9_tpu_torch.kernels import build as kb
from skirt9_tpu_torch.transport import mlsweep as ml
from skirt9_tpu_torch.transport import sweep as sw

PC = 3.0857e16
SIG = 1e-24
EXT = ((-1.2 * PC, 1.2 * PC),) * 3
TREES = ("octree", "bintree", "sitelist")


def _dens(p):
    r = np.linalg.norm(p, axis=-1)
    return np.where(r < PC, (PC / np.maximum(r, 0.1 * PC)) ** 2, 0.0)


def reference_tree(kind: str):
    """One of the three reference trees of this module."""
    if kind == "octree":
        return ref_build_octree(EXT, _dens, max_level=4, min_level=1,
                                max_fraction=2e-2)
    if kind == "bintree":
        return ref_build_bintree(EXT, _dens, max_level=10, min_level=3,
                                 max_fraction=2e-2)
    sites = np.random.default_rng(5).uniform(-PC, PC, (100, 3))
    return ref_build_octree(EXT, lambda p: np.ones(len(p)), max_level=5,
                            min_level=1, refine_fn=ref_site_list(sites, 1))


def _medium(grid, C, seed):
    rs = np.random.default_rng(seed)
    centers = np.asarray(grid.cell_centers(), np.float64)
    nd = np.stack([_dens(centers) * rs.uniform(0.5, 1.5, grid.ncells)
                   / (SIG * PC) for _ in range(C)], axis=1)
    return ref_msys.make_medium(grid, nd.astype(np.float32),
                                np.array([0.4e-6, 0.7e-6]),
                                sigma_ext=SIG * np.arange(1, C + 1)[:, None]
                                * np.ones(2),
                                albedo=np.full((C, 2), 0.5),
                                g=np.full((C, 2), 0.3))


@pytest.fixture(scope="module", params=TREES)
def tree(request):
    grid = reference_tree(request.param)
    return request.param, grid


def _setup(grid, C, B, seed, hint=None):
    """Reference medium, port tables, rays inside the box and the reference
    march's inputs; with hint every lane shares one direction whose slab
    axis is `hint`."""
    rmed = _medium(grid, C, seed)
    tabs = ml.build_tables(bridge.grid(grid), bridge.medium(rmed))
    rs = np.random.default_rng(seed + 1)
    lo = np.asarray(grid.box_lo, np.float64)
    hi = np.asarray(grid.box_hi, np.float64)
    pos = rs.uniform(lo + 0.05 * (hi - lo), hi - 0.05 * (hi - lo),
                     (B, 3)).astype(np.float32)
    if hint is None:
        d = rs.normal(size=(B, 3))
    else:
        d0 = np.array([0.3, -0.2, 0.2])
        d0[hint] = 0.93 * (-1) ** hint
        d = np.broadcast_to(d0, (B, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    if hint is not None:
        assert int(np.argmax(np.abs(d[0]) / np.asarray(tabs.h))) == hint
    opt = ref_msys.optics_at(rmed, jnp.full((B,), 0.55e-6))
    cell = grid.locate(jnp.asarray(pos))
    sig = np.ascontiguousarray(np.asarray(opt.sigma_ext).T)
    return rmed, tabs, pos, d, opt, cell, sig


def _port(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


@pytest.mark.parametrize("C,hint", [(1, None), (2, None), (1, 2), (2, 0)],
                         ids=["C1", "C2", "C1-hint2", "C2-hint0"])
def test_dtau_matches_scan_march(tree, C, hint):
    _, grid = tree
    B = 512
    rmed, tabs, pos, d, opt, cell, sig = _setup(grid, C, B, 10 + C, hint)
    active = cell >= 0
    tau_ref = np.asarray(ref_lc.trace_tau(grid, rmed, opt, jnp.asarray(pos),
                                          jnp.asarray(d), cell,
                                          grid.max_steps(), active))
    tpos, td, tsig, tact = _port(pos, d, sig, np.asarray(active))
    kb.reset_launches()
    summed = ml.sweep_dtau(tabs, tpos, td, tsig, tact, axis_hint=hint)
    sub, cells = ml.sweep_dtau(tabs, tpos, td, tsig, tact, axis_hint=hint,
                               want_sub=True)
    assert all(v == 0 for v in kb.LAUNCHES.values())   # CPU: plain versions
    assert summed.shape == (tabs.n_steps, B)
    assert sub.shape == cells.shape == (tabs.n_steps, 3, B)
    assert cells.dtype == torch.int32
    assert torch.equal(summed, sub[:, 0] + sub[:, 1] + sub[:, 2])
    a = np.asarray(active)
    tau = summed.sum(dim=0).double().numpy()
    assert (tau_ref[a] > 0.01).sum() > 100
    np.testing.assert_allclose(tau[a], tau_ref[a], rtol=2e-4, atol=1e-5)
    # every sub-step with optical depth has a leaf
    assert bool((cells[sub > 0] >= 0).all())


@pytest.mark.parametrize("C", [1, 2])
def test_deposit_and_interaction_match_scan_march(tree, C):
    _, grid = tree
    B = 512
    rmed, tabs, pos, d, opt, cell, sig = _setup(grid, C, B, 20 + C)
    active = cell >= 0
    jpos, jd = jnp.asarray(pos), jnp.asarray(d)
    cells_r, ds_r, dtau_r = ref_lc.march_record(grid, rmed, opt, jpos, jd,
                                                cell, grid.max_steps(),
                                                active)
    tau_before = jnp.cumsum(dtau_r, axis=0) - dtau_r
    tau_path = tau_before[-1] + dtau_r[-1]
    rf_ref = np.asarray(ref_lc.deposit_rf(
        jnp.zeros((grid.ncells, 1), jnp.float32), cells_r, ds_r, dtau_r,
        tau_before, jnp.ones((B,), jnp.float32), jnp.zeros((B,), jnp.int32),
        active, 1.0))[:, 0]
    tau_int = 0.7 * tau_path
    _, icell_r, found_r, _, _ = ref_lc.interaction_point(
        jpos, jd, cells_r, ds_r, dtau_r, tau_before, tau_int, active)

    a = np.asarray(active)
    tpos, td, tsig, tact, tti = _port(pos, d, sig, a, np.asarray(tau_int))
    sub, cells = ml.sweep_dtau(tabs, tpos, td, tsig, tact, want_sub=True)
    grp = sw.dominant_axis(tabs, td)
    tb, _ = sw.slab_prefix(sub.sum(dim=1),
                           td.gather(1, grp[:, None])[:, 0] > 0)
    rf, s_int, icell, found = ml.sweep_deposit(
        tabs, tpos, td, tact, sub, cells, tact.to(torch.float32), tti, tb,
        1.0)
    assert rf.shape == (1, grid.ncells)
    np.testing.assert_array_equal(found.numpy()[a], np.asarray(found_r)[a])
    hit = a & np.asarray(found_r)
    assert hit.sum() > B // 4
    np.testing.assert_array_equal(icell.numpy()[hit], np.asarray(icell_r)[hit])
    np.testing.assert_allclose(rf[0].numpy(), rf_ref, rtol=3e-3,
                               atol=3e-6 * rf_ref.sum())
    # the interaction alone, from the same record, as the no-RF branch
    # finds it
    s2, ic2, f2 = ml.resolve_interaction(tabs, tpos, td, tact, sub, tb, tti)
    assert torch.equal(f2, found) and torch.equal(ic2, icell)
    assert torch.equal(s2[found], s_int[found])


@pytest.mark.parametrize("C,hint", [(1, None), (2, None), (1, 2), (2, 0)],
                         ids=["C1", "C2", "C1-hint2", "C2-hint0"])
def test_total_and_prefix_match_reference(tree, C, hint):
    """`sweep_tau_total` and `sweep_dtau_prefix` (their plain versions on
    the CPU) against the reference's scan march (the totals, with the bounds
    of `test_dtau_matches_scan_march`) and its `slab_prefix` of the same
    step sums (the total and the prefix within 1e-6 of each lane's tau);
    the record, leaf ids and step sums those of `sweep_dtau`, the lane
    range `_lane_range`'s, bit for bit."""
    _, grid = tree
    B = 512
    rmed, tabs, pos, d, opt, cell, sig = _setup(grid, C, B, 50 + C, hint)
    active = cell >= 0
    tau_ref = np.asarray(ref_lc.trace_tau(grid, rmed, opt, jnp.asarray(pos),
                                          jnp.asarray(d), cell,
                                          grid.max_steps(), active))
    args = (*_port(pos, d, sig, np.asarray(active)), hint)
    kb.reset_launches()
    tot = ml.sweep_tau_total(tabs, *args)
    rec, cells, steps, tb, tot_c, lane = ml.sweep_dtau_prefix(tabs, *args)
    rec_n, cells_n, *_ = ml.sweep_dtau_prefix(tabs, *args, leaf_ids=False)
    assert all(v == 0 for v in kb.LAUNCHES.values())   # CPU: plain versions
    assert tot.shape == tot_c.shape == (B,)
    assert rec.shape == cells.shape == (tabs.n_steps, 3, B)
    assert steps.shape == tb.shape == (tabs.n_steps, B)
    a = np.asarray(active)
    assert (tau_ref[a] > 0.01).sum() > 100
    for t in (tot, tot_c):
        np.testing.assert_allclose(t.double().numpy()[a], tau_ref[a],
                                   rtol=2e-4, atol=1e-5)
    # the reference's slab_prefix of the same step sums
    g, smin, smax = sw._lane_range(tabs, args[0], args[1], args[3])
    g = sw._hinted(g, hint)
    up = args[1].gather(1, g.long()[:, None])[:, 0] > 0
    tb_r, tot_r = (torch.from_numpy(np.asarray(x)) for x in ref_sw.slab_prefix(
        jnp.asarray(steps.numpy()), jnp.asarray(up.numpy())))
    for t in (tot, tot_c):
        assert bool(((t - tot_r).abs() <= 1e-6 * tot_r).all())
    assert bool(((tb - tb_r).abs() <= 1e-6 * tot_r[None, :]).all())
    # one march: sweep_dtau's record and leaf ids, (d0 + d1) + d2
    rec_w, cells_w = ml.sweep_dtau(tabs, *args[:4], axis_hint=hint,
                                   want_sub=True)
    assert torch.equal(rec, rec_w) and torch.equal(cells, cells_w)
    assert torch.equal(rec_n, rec_w) and cells_n is None
    assert torch.equal(steps, (rec[:, 0] + rec[:, 1]) + rec[:, 2])
    for x, y in zip(lane, (g, smin, smax)):
        assert torch.equal(x, y)


def test_resolve_interaction_takes_pass1(tree):
    """`resolve_interaction` given pass 1's lane range and step sums (from
    `sweep_dtau_prefix`) equals the call that forms them itself, bit for
    bit, also on lanes that may not interact, with tau_int = 0 and tau_int
    past the lane's total."""
    _, grid = tree
    B = 512
    rmed, tabs, pos, d, opt, cell, sig = _setup(grid, 1, B, 60)
    tpos, td, tsig, tact = _port(pos, d, sig, np.asarray(cell >= 0))
    rec, _, steps, tb, tot, lane = ml.sweep_dtau_prefix(tabs, tpos, td, tsig,
                                                        tact)
    rs = np.random.default_rng(61)
    u = rs.uniform(0.0, 1.3, B)
    u[:B // 8] = 0.0
    tau_int = torch.from_numpy(u.astype(np.float32)) * tot
    act_int = tact & torch.from_numpy(rs.uniform(size=B) > 0.15) & (tot > 1e-6)
    got = ml.resolve_interaction(tabs, tpos, td, act_int, rec, tb, tau_int,
                                 lane=lane, dtau_step=steps)
    want = ml.resolve_interaction(tabs, tpos, td, act_int, rec, tb, tau_int)
    assert int(want[2].sum()) > B // 4
    assert int((tact & ~act_int).sum()) > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_leafmap_matches_reference(tree):
    _, grid = tree
    rmed = _medium(grid, 1, 0)
    tabs = ml.build_tables(bridge.grid(grid), bridge.medium(rmed))
    ref = ref_ml.build_tables(grid, rmed)
    assert tabs.n == ref.n and tabs.nmax == ref.nmax
    np.testing.assert_array_equal(tabs.leafmap.numpy(),
                                  np.asarray(ref.leafmap))
    assert int(tabs.leafmap.min()) == 0
    assert int(tabs.leafmap.max()) == grid.ncells - 1


def test_plan_tiles_the_fine_slabs(tree):
    """Steps tile [0, nmax) in order, each aligned to its granularity, and
    every level whose box the step crosses is at least 2^gs fine voxels wide
    on every axis (the exactness of one lookup per sub-step)."""
    _, grid = tree
    tabs = ml.build_tables(bridge.grid(grid), bridge.medium(_medium(grid, 1,
                                                                    0)))
    tlev, gs = tabs.step_tlev.numpy(), tabs.step_gs.numpy()
    assert len(tlev) == tabs.n_steps < tabs.nmax or tabs.nmax == tabs.n_steps
    t = 0
    for tl, g in zip(tlev.tolist(), gs.tolist()):
        t0 = tl << g
        assert t0 == t and t0 % (1 << g) == 0
        t = t0 + (1 << g)
        for lv in tabs.levels:
            for la in lv.ax:
                if (la.t0 << la.sht) < t and t0 < (la.t1 << la.sht):
                    assert min(lv.shift) >= g
    assert t == tabs.nmax
    # the reference's planner on the same levels gives the same steps
    segs, n_steps = ref_ml._make_plan(tabs.levels, tabs.nmax)
    assert n_steps == tabs.n_steps
    ref_steps = [((t0 >> g) + k, g) for t0, cnt, g, _ in segs
                 for k in range(cnt)]
    assert ref_steps == list(zip(tlev.tolist(), gs.tolist()))


def test_reference_sweep_in_interpret_mode(monkeypatch):
    """The reference's `mlsweep.sweep_dtau` (Pallas interpret mode) on the
    density octree, summed tau of 256 rays."""
    monkeypatch.setenv("SKIRT9_TPU_FORCE_SWEEP", "1")
    grid = reference_tree("octree")
    B = 256
    rmed, tabs, pos, d, opt, cell, sig = _setup(grid, 1, B, 30)
    active = cell >= 0
    ref = ref_ml.sweep_dtau(ref_ml.build_tables(grid, rmed), jnp.asarray(pos),
                            jnp.asarray(d), opt.sigma_ext.T, active)
    tau_ref = np.asarray(ref, np.float64).sum(axis=0)
    tau = ml.sweep_dtau(tabs, *_port(pos, d, sig, np.asarray(active))
                        ).sum(dim=0).double().numpy()
    a = np.asarray(active)
    assert (tau_ref[a] > 0.01).sum() > 50
    np.testing.assert_allclose(tau[a], tau_ref[a], rtol=2e-4, atol=1e-5)
