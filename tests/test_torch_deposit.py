"""Pass 2 from pass 1's prefix, and the tables' per-axis constants, on the CPU.

Kernel 2's `sweep_deposit_prefix` mode (`skirt9_tpu_torch.transport.sweep`)
through its plain version against the JAX package's `sweep_deposit` in
Pallas interpret mode, with scale = (lum * e^-tb) * inv_sqrt and rel =
tau_int - tb formed the same way for both, on C = 1, 2 components and 1, 4
lane groups; with a bin map the reference's group rows are folded into
bins in numpy (one group dropped, two sharing a bin). Bounds as in
tests/test_torch_sweep.py: `found` equal on >= 99.9% of lanes, `icell`
equal where both found, `s_int` within 1e-5 of a cell size, RF within 1e-4
of its maximum.

Kernel 5's plain version (`mlsweep.sweep_deposit`) with pass 1's lane
range passed in, against the reference's scan march as
tests/test_torch_mlsweep.py holds it (RF rtol 3e-3, atol 3e-6 of the
total; `found` and `icell` equal), and equal to its own lane set-up.

`sweep._lane_geometry`, `mlsweep.locate_cells` and `sweepxl.lane_order`
read per-axis constants built once with the tables (`sweep.axis_tables`)
instead of copying them from the host per call: bit for bit what the
per-call copies gave. CPU tensors take the plain versions: no kernel is
launched.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from skirt9_tpu.grids.cartesian import make_cartesian as ref_make_cartesian
from skirt9_tpu.grids.octree import build_octree as ref_build_octree
from skirt9_tpu.grids.octree import site_list_refine_fn as ref_site_list
from skirt9_tpu.media import system as ref_msys
from skirt9_tpu.transport import lifecycle as ref_lc
from skirt9_tpu.transport import sweep as ref_sw
from skirt9_tpu_torch import bridge
from skirt9_tpu_torch.grids.cartesian import make_cartesian
from skirt9_tpu_torch.kernels import build as kb
from skirt9_tpu_torch.media import system as msys
from skirt9_tpu_torch.transport import lifecycle as lc
from skirt9_tpu_torch.transport import mlsweep as ml
from skirt9_tpu_torch.transport import sweep as sw
from skirt9_tpu_torch.transport import sweepxl as xl

PC = 3.0857e16
SIGMA = 1e-24
EXT = ((-1.2 * PC, 1.2 * PC),) * 3


def _uniform(shape, C, B, seed):
    """The same uniform grid, densities and rays for both packages."""
    rs = np.random.default_rng(seed)
    rgrid = ref_make_cartesian(EXT, shape)
    grid = make_cartesian(EXT, shape)
    nd1 = ref_msys.uniform_density_sphere(rgrid, 1.0, SIGMA, PC)
    nd = np.stack([nd1 * (1.0 + 0.5 * rs.uniform(size=nd1.shape))
                   for _ in range(C)], axis=1).astype(np.float32)
    lam_t = np.array([0.4e-6, 0.7e-6])
    kw = dict(sigma_ext=np.full((C, 2), SIGMA), albedo=np.full((C, 2), 0.6),
              g=np.full((C, 2), 0.5))
    rmed = ref_msys.make_medium(rgrid, nd, lam_t, **kw)
    med = msys.make_medium(grid, nd, lam_t, **kw)
    pos = rs.uniform(-1.1 * PC, 1.1 * PC, (B, 3)).astype(np.float32)
    d = rs.normal(size=(B, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    sig = (SIGMA * rs.uniform(0.5, 1.5, (C, B))).astype(np.float32)
    active = np.asarray(rgrid.locate(jnp.asarray(pos))) >= 0
    ref = (ref_sw.build_tables(rgrid, rmed), jnp.asarray(pos), jnp.asarray(d),
           jnp.asarray(sig), jnp.asarray(active))
    port = (sw.build_tables(grid, med), torch.from_numpy(pos),
            torch.from_numpy(d), torch.from_numpy(sig),
            torch.from_numpy(active))
    return ref, port, rgrid, rs


# (C, n_groups, bin map over 2 bins): group 1 dropped, groups 0 and 3 share
# bin 1
CASES = [(1, 1, None), (2, 1, None), (1, 4, (1, -1, 0, 1)),
         (2, 4, (1, -1, 0, 1)), (2, 4, None)]
IDS = ["C1", "C2", "C1-g4-bins", "C2-g4-bins", "C2-g4"]


@pytest.mark.parametrize("C,n_groups,bins", CASES, ids=IDS)
def test_deposit_prefix_matches_reference(C, n_groups, bins):
    B = 128 * n_groups
    ref, port, rgrid, rs = _uniform((12, 16, 8), C, B, seed=60 + C)
    tabs, pos, d, sig, act = port
    tb, tot, lane = sw.sweep_dtau_prefix(*port)
    lum_half = torch.from_numpy(rs.uniform(0.5, 2.0, B).astype(np.float32))
    tau_int = torch.from_numpy(rs.uniform(size=B).astype(np.float32)) * tot
    inv_sqrt = 0.37
    bin_map = None if bins is None else torch.tensor(bins, dtype=torch.int32)
    kb.reset_launches()
    rf, s, ic, f = (x.numpy() for x in sw.sweep_deposit_prefix(
        tabs, pos, d, sig, act, lum_half, tau_int, tb, inv_sqrt, lane,
        n_groups=n_groups, bin_map=bin_map, nbins=2))
    assert sum(kb.LAUNCHES.values()) == 0          # CPU: plain version
    # the reference's contract on the same scale and rel
    scale = (lum_half[None, :] * torch.exp(-tb)) * inv_sqrt
    rel = tau_int[None, :] - tb
    out_r = ref_sw.sweep_deposit(*ref, jnp.asarray(scale.numpy()),
                                 jnp.asarray(rel.numpy()), n_groups=n_groups)
    rf_r, s_r, ic_r, f_r = (np.asarray(x) for x in out_r)
    if bins is not None:
        folded = np.zeros((2, rf_r.shape[1]), np.float64)
        for g, b in enumerate(bins):
            if b >= 0:
                folded[b] += rf_r[g]
        rf_r = folded
        assert np.abs(rf_r).sum(axis=1).min() > 0
    assert rf.shape == rf_r.shape
    assert f.sum() > B // 2 and (f == f_r).mean() >= 0.999
    both = f & f_r
    assert np.array_equal(ic[both], ic_r[both])
    h = float(np.asarray(rgrid.h)[0])
    assert np.abs(s[both] - s_r[both]).max() <= 1e-5 * h
    assert np.abs(rf - rf_r).max() <= 1e-4 * np.abs(rf_r).max()


def test_deposit_prefix_equals_tables_mode():
    """The prefix mode is the reference contract on the loop's own scale and
    rel tensors, row for row where no bin map folds them."""
    B = 512
    _, port, _, rs = _uniform((16, 12, 8), 2, B, seed=70)
    tabs, pos, d, sig, act = port
    tb, tot, lane = sw.sweep_dtau_prefix(*port)
    lum_half = torch.from_numpy(rs.uniform(0.5, 2.0, B).astype(np.float32))
    tau_int = 0.6 * tot
    got = sw.sweep_deposit_prefix(tabs, pos, d, sig, act, lum_half, tau_int,
                                  tb, 0.5, lane, n_groups=4)
    want = sw.sweep_deposit(tabs, pos, d, sig, act,
                            (lum_half[None, :] * torch.exp(-tb)) * 0.5,
                            tau_int[None, :] - tb, n_groups=4, lane=lane)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):     # a bin map must be int32
        sw.sweep_deposit_prefix(tabs, pos, d, sig, act, lum_half, tau_int,
                                tb, 0.5, lane, n_groups=4,
                                bin_map=torch.zeros(4, dtype=torch.int64),
                                nbins=2)


def test_deposit_prefix_drops_bins_out_of_range():
    """A bin map entry outside [0, nbins) drops its group as -1 does."""
    B, n_groups = 512, 4
    _, port, _, rs = _uniform((12, 16, 8), 1, B, seed=75)
    tabs, pos, d, sig, act = port
    tb, tot, lane = sw.sweep_dtau_prefix(*port)
    lum_half = torch.from_numpy(rs.uniform(0.5, 2.0, B).astype(np.float32))
    args = (tabs, pos, d, sig, act, lum_half, 0.5 * tot, tb, 0.5, lane,
            n_groups)
    got = sw.sweep_deposit_prefix(
        *args, bin_map=torch.tensor([1, 2, -3, 0], dtype=torch.int32),
        nbins=2)
    want = sw.sweep_deposit_prefix(
        *args, bin_map=torch.tensor([1, -1, -1, 0], dtype=torch.int32),
        nbins=2)
    assert float(got[0].abs().sum(dim=1).min()) > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_bin_map_and_add_rf():
    opts = lc.TransportOptions(max_steps=8, rf_strata=4,
                               rf_bin_map=(1, -1, 0, 1))
    rf = torch.zeros((6, 2))
    bm = lc._bin_map(opts, rf, 4, "cpu")
    assert bm.dtype == torch.int32 and bm.tolist() == [1, -1, 0, 1]
    assert lc._bin_map(opts, torch.zeros((6, 1)), 4, "cpu") is None
    with pytest.raises(ValueError):             # 4 map entries for 3 groups
        lc._bin_map(opts, rf, 3, "cpu")
    with pytest.raises(ValueError):             # bin 2 of 2 bins
        lc._bin_map(lc.TransportOptions(max_steps=8, rf_strata=4,
                                        rf_bin_map=(2, -1, 0, 1)),
                    rf, 4, "cpu")
    delta = torch.arange(12, dtype=torch.float32).reshape(2, 6)
    lc._add_rf(rf, delta, opts, 4)
    assert torch.equal(rf, delta.T)


# ------------------------------------------------------------ kernel 5 plain

def _dens(p):
    r = np.linalg.norm(p, axis=-1)
    return np.where(r < PC, (PC / np.maximum(r, 0.1 * PC)) ** 2, 0.0)


def _tree(kind):
    if kind == "octree":
        return ref_build_octree(EXT, _dens, max_level=4, min_level=1,
                                max_fraction=2e-2)
    sites = np.random.default_rng(5).uniform(-PC, PC, (100, 3))
    return ref_build_octree(EXT, lambda p: np.ones(len(p)), max_level=5,
                            min_level=1, refine_fn=ref_site_list(sites, 1))


@pytest.mark.parametrize("kind", ["octree", "sitelist"])
def test_tree_deposit_with_lane_range_matches_scan_march(kind):
    grid = _tree(kind)
    B = 512
    rs = np.random.default_rng(31)
    centers = np.asarray(grid.cell_centers(), np.float64)
    nd = (_dens(centers) * rs.uniform(0.5, 1.5, grid.ncells)
          / (SIGMA * PC))[:, None].astype(np.float32)
    rmed = ref_msys.make_medium(grid, nd, np.array([0.4e-6, 0.7e-6]),
                                sigma_ext=np.full((1, 2), SIGMA),
                                albedo=np.full((1, 2), 0.5),
                                g=np.full((1, 2), 0.3))
    tabs = ml.build_tables(bridge.grid(grid), bridge.medium(rmed))
    lo = np.asarray(grid.box_lo, np.float64)
    hi = np.asarray(grid.box_hi, np.float64)
    pos = rs.uniform(lo + 0.05 * (hi - lo), hi - 0.05 * (hi - lo),
                     (B, 3)).astype(np.float32)
    d = rs.normal(size=(B, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    opt = ref_msys.optics_at(rmed, jnp.full((B,), 0.55e-6))
    cell = grid.locate(jnp.asarray(pos))
    active = cell >= 0
    jpos, jd = jnp.asarray(pos), jnp.asarray(d)
    cells_r, ds_r, dtau_r = ref_lc.march_record(grid, rmed, opt, jpos, jd,
                                                cell, grid.max_steps(),
                                                active)
    tau_before = jnp.cumsum(dtau_r, axis=0) - dtau_r
    tau_int = 0.7 * (tau_before[-1] + dtau_r[-1])
    rf_ref = np.asarray(ref_lc.deposit_rf(
        jnp.zeros((grid.ncells, 1), jnp.float32), cells_r, ds_r, dtau_r,
        tau_before, jnp.ones((B,), jnp.float32), jnp.zeros((B,), jnp.int32),
        active, 1.0))[:, 0]
    _, icell_r, found_r, _, _ = ref_lc.interaction_point(
        jpos, jd, cells_r, ds_r, dtau_r, tau_before, tau_int, active)

    a = np.asarray(active)
    tpos, td, tact, tti = (torch.from_numpy(np.array(x)) for x in
                           (pos, d, a, np.asarray(tau_int)))
    tsig = torch.from_numpy(np.array(np.asarray(opt.sigma_ext).T))
    lane = sw._lane_range(tabs, tpos, td, tact)
    kb.reset_launches()
    sub, cells = ml.sweep_dtau(tabs, tpos, td, tsig, tact, want_sub=True)
    tb, _ = sw.slab_prefix(sub.sum(dim=1), td.gather(
        1, lane[0].to(torch.int64)[:, None])[:, 0] > 0)
    args = (tabs, tpos, td, tact, sub, cells, tact.to(torch.float32), tti,
            tb, 1.0)
    rf, s_int, icell, found = ml.sweep_deposit(*args, lane=lane)
    assert sum(kb.LAUNCHES.values()) == 0
    for x, y in zip((rf, s_int, icell, found), ml.sweep_deposit(*args)):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(found.numpy()[a], np.asarray(found_r)[a])
    hit = a & np.asarray(found_r)
    assert hit.sum() > B // 4
    np.testing.assert_array_equal(icell.numpy()[hit], np.asarray(icell_r)[hit])
    np.testing.assert_allclose(rf[0].numpy(), rf_ref, rtol=3e-3,
                               atol=3e-6 * rf_ref.sum())


# ------------------------------------------- per-axis constants, bit for bit

def _lane_geometry_copying(tabs, pos, dirn, group):
    """`sweep._lane_geometry` as it was, copying its constants per call."""
    dev = pos.device
    a = group.to(torch.int64)
    n_t = torch.tensor(tabs.n, dtype=torch.int64, device=dev)
    lo_t = torch.tensor(tabs.lo, dtype=torch.float32, device=dev)
    h_t = torch.tensor(tabs.h, dtype=torch.float32, device=dev)
    ua = torch.tensor([1, 0, 0], device=dev)[a]
    va = torch.tensor([2, 2, 1], device=dev)[a]
    sel = lambda x, ax: x.gather(1, ax[:, None])[:, 0]
    nx, ny, nz = tabs.n
    return dict(
        pa=sel(pos, a), da=sel(dirn, a), loa=lo_t[a], ha=h_t[a], na=n_t[a],
        pu=sel(pos, ua), du=sel(dirn, ua), lou=lo_t[ua], hu=h_t[ua],
        nu=n_t[ua],
        pv=sel(pos, va), dv=sel(dirn, va), lov=lo_t[va], hv=h_t[va],
        nv=n_t[va],
        t_stride=torch.tensor([ny * nz, nz, 1], device=dev)[a],
        u_stride=torch.tensor([nz, ny * nz, ny * nz], device=dev)[a],
        v_stride=torch.tensor([1, 1, nz], device=dev)[a])


def _locate_cells_copying(tabs, pos):
    dev = pos.device
    lo = torch.tensor(tabs.lo, dtype=torch.float32, device=dev)
    h = torch.tensor(tabs.h, dtype=torch.float32, device=dev)
    nf = torch.tensor(tabs.n, dtype=torch.int64, device=dev)
    ijk = torch.floor((pos - lo) / h).to(torch.int64)
    inside = torch.all((ijk >= 0) & (ijk < nf), dim=-1)
    ijk = torch.minimum(torch.clamp_min(ijk, 0), nf - 1)
    flat = (ijk[..., 0] * tabs.n[1] + ijk[..., 1]) * tabs.n[2] + ijk[..., 2]
    cell = tabs.leafmap[flat].to(torch.int64)
    return torch.where(inside, cell, torch.full_like(cell, -1))


def _lane_order_copying(tabs, pos, dirn, group):
    dev = pos.device
    lo = torch.tensor(tabs.lo, dtype=torch.float32, device=dev)[group]
    h = torch.tensor(tabs.h, dtype=torch.float32, device=dev)[group]
    pa = pos.gather(1, group[:, None])[:, 0]
    da = dirn.gather(1, group[:, None])[:, 0]
    t_ent = torch.clamp(((pa - lo) / h).to(torch.int32), 0, tabs.nmax - 1)
    key = (group * 2 + (da > 0).to(group.dtype)) * tabs.nmax + t_ent
    return torch.argsort(key, stable=True)


def _rays(B, seed, lo, hi):
    rs = np.random.default_rng(seed)
    pos = torch.from_numpy(rs.uniform(lo, hi, (B, 3)).astype(np.float32))
    d = rs.normal(size=(B, 3))
    d[::7, 1] = 0.0                      # axis-parallel components
    d = torch.from_numpy((d / np.linalg.norm(d, axis=-1, keepdims=True))
                         .astype(np.float32))
    return pos, d


@pytest.mark.parametrize("shape", [(8, 8, 8), (12, 16, 20)])
def test_axis_tables_uniform_bit_for_bit(shape):
    _, port, _, _ = _uniform(shape, 1, 8, seed=1)
    tabs = port[0]
    xtabs = xl.build_tables(make_cartesian(EXT, shape),
                            msys.make_medium(make_cartesian(EXT, shape),
                                             tabs.nd.numpy(),
                                             np.array([0.4e-6, 0.7e-6]),
                                             sigma_ext=np.full((1, 2), SIGMA),
                                             albedo=np.full((1, 2), 0.6),
                                             g=np.full((1, 2), 0.5)))
    assert xtabs.geom is not None
    pos, d = _rays(1000, 2, -1.3 * PC, 1.3 * PC)
    for t in (tabs, xtabs):
        group = sw.dominant_axis(t, d)
        got = sw._lane_geometry(t, pos, d, group)
        want = _lane_geometry_copying(t, pos, d, group)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                                 want[k]), k
    group = sw.dominant_axis(xtabs, d)
    assert torch.equal(xl.lane_order(xtabs, pos, d, group),
                       _lane_order_copying(xtabs, pos, d, group))


@pytest.mark.parametrize("kind", ["octree", "sitelist"])
def test_axis_tables_tree_bit_for_bit(kind):
    grid = _tree(kind)
    rmed = ref_msys.make_medium(grid, np.ones((grid.ncells, 1), np.float32),
                                np.array([0.4e-6, 0.7e-6]),
                                sigma_ext=np.full((1, 2), SIGMA),
                                albedo=np.full((1, 2), 0.5),
                                g=np.full((1, 2), 0.3))
    tabs = ml.build_tables(bridge.grid(grid), bridge.medium(rmed))
    pos, d = _rays(1000, 3, -1.3 * PC, 1.3 * PC)   # some outside the box
    got = ml.locate_cells(tabs, pos)
    assert bool((got == -1).any()) and bool((got >= 0).any())
    assert torch.equal(got, _locate_cells_copying(tabs, pos))
    group = sw.dominant_axis(tabs, d)
    got = sw._lane_geometry(tabs, pos, d, group)
    for k, v in _lane_geometry_copying(tabs, pos, d, group).items():
        assert torch.equal(got[k], v), k
