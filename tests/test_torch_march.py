"""The scan march (`skirt9_tpu_torch/transport/march.py`) and the grids'
`step` against the reference's (`skirt9_tpu/transport/lifecycle.py:
132-276`, `skirt9_tpu/grids/cartesian.py`, `voronoi.py`, `octree.py`,
`bintree.py`) on the CPU, on rays made from numpy seeds: random rays, rays
along an axis, diagonal rays started on cell corners (a tree's leaf
corners), and lanes outside the grid.

- `step` of a uniform, a meshed (SymPowMesh and a power-law axis) and a
  Voronoi grid: the next cells identical, the step lengths and positions
  within 2 f32 ulps (they agree bit for bit: the steps replay XLA's fused
  multiply-adds, without which a tenth of the lengths are off); of a
  density octree and bintree bit for bit (the exit move and the nudge are
  XLA's fused multiply-adds; each next leaf by descent from the root).
- `move_inside` of both Cartesian grids and both trees bit for bit on
  lanes that start outside (XLA fuses the move into a multiply-add on
  every axis of a Cartesian grid, on x and y only of a tree).
- A tree march with the fine leaf map attached takes the same cells: the
  step descends all the same.
- `march_geometry` (the plain loop) against the reference's jitted scan:
  the cells of the lanes in the mask identical, every step length within 2
  ulps; a masked lane records cell 0, length 0.
- `opacity_on_path` (the lanes' optics, per-cell Doppler wavelengths, the
  Lya Voigt opacity at each cell's temperature), `deposit_rf`,
  `interaction_point` and `march_record` with explicit absorption's
  scattering depths, at 1e-6 relative (they agree to ~1e-7).
- The plain march against the reference's `march_record` at 1e-4 relative
  on lanes with tau > 0.01 (ROADMAP item 8's gate).
- `ops.xlamath.cumsum` against `jnp.cumsum` bit for bit.
- The raster's resolution cap `SKIRT9_TPU_RASTER_MAX_N`, read as the
  reference reads it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skirt9_tpu.grids import bintree as ref_bt
from skirt9_tpu.grids import cartesian as ref_cart
from skirt9_tpu.grids import meshes as ref_meshes
from skirt9_tpu.grids import octree as ref_ot
from skirt9_tpu.grids import voronoi as ref_voronoi
from skirt9_tpu.media import system as ref_msys
from skirt9_tpu.transport import lifecycle as ref_lc
from skirt9_tpu.transport import raster as ref_raster
from skirt9_tpu_torch import bridge
from skirt9_tpu_torch.kernels import build as kb
from skirt9_tpu_torch.media import system as msys
from skirt9_tpu_torch.ops import xlamath as xm
from skirt9_tpu_torch.transport import march as mr
from skirt9_tpu_torch.transport import mlsweep as ml
from skirt9_tpu_torch.transport import raster

PC = 3.0857e16
EXT = ((-1.2 * PC, 1.2 * PC),) * 3
B = 1024


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dens(p):
    r = np.linalg.norm(p, axis=-1)
    return np.where(r < PC, (PC / np.maximum(r, 0.1 * PC)) ** 2, 0.0)


def _grids():
    rs = np.random.default_rng(5)
    sym = ref_meshes.scale(ref_meshes.sym_pow_mesh(12, 8.0), *EXT[0])
    powm = ref_meshes.scale(ref_meshes.pow_mesh(9, 20.0), *EXT[2])
    return {
        "uniform": ref_cart.make_cartesian(EXT, (16, 12, 10)),
        "mesh": ref_cart.make_cartesian(EXT, (12, 7, 9),
                                        meshes=[sym, None, powm]),
        "voronoi": ref_voronoi.build_voronoi(rs.uniform(-PC, PC, (200, 3)),
                                             EXT, lookup_res=8),
        "octree": ref_ot.build_octree(EXT, _dens, max_level=4, min_level=1,
                                      max_fraction=2e-2),
        "bintree": ref_bt.build_bintree(EXT, _dens, max_level=10,
                                        min_level=3, max_fraction=2e-2),
    }


GRIDS = _grids()
TREES = ("octree", "bintree")


def _rays(grid, seed: int, n: int = B):
    """Positions and unit directions (n, 3) f32: random, axis-aligned, and
    diagonal from cell corners (the meeting point of three borders)."""
    rs = np.random.default_rng(seed)
    pos = rs.uniform(-1.1 * PC, 1.1 * PC, (n, 3))
    d = rs.normal(size=(n, 3))
    k = n // 8
    d[:k] = 0.0
    d[np.arange(k), rs.integers(0, 3, k)] = rs.choice([-1.0, 1.0], k)
    d[k:2 * k] = rs.choice([-1.0, 1.0], (k, 3))
    if hasattr(grid, "xb"):
        b = [np.asarray(x, np.float64) for x in (grid.xb, grid.yb, grid.zb)]
        pos[k:2 * k] = np.stack([rs.choice(x[1:-1], k) for x in b], axis=1)
    if hasattr(grid, "cell_lo"):
        lo = np.asarray(grid.cell_lo, np.float64)
        pos[k:2 * k] = lo[rs.integers(0, lo.shape[0], k)]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return pos.astype(np.float32), d.astype(np.float32)


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    sp = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32))
    return np.where(a == b, 0.0, np.abs(a.astype(np.float64) - b) / sp)


@pytest.mark.parametrize("name", list(GRIDS))
def test_step_matches_reference(name):
    grid = GRIDS[name]
    port = bridge.grid(grid)
    pos, d = _rays(grid, 1)
    cell = np.array(grid.locate(jnp.asarray(pos)))
    cell[:16] = -1                                 # lanes outside the grid
    assert (cell >= 0).sum() > B // 2
    step = jax.jit(grid.step)
    p, c = pos, cell
    for _ in range(6):        # a few steps on, from the reference's states
        ds_r, nc_r, np_r = (np.asarray(x) for x in step(
            jnp.asarray(p), jnp.asarray(d), jnp.asarray(c)))
        ds, nc, np_ = port.step(torch.tensor(p), torch.tensor(d),
                                torch.tensor(c, dtype=torch.int64))
        assert np.array_equal(nc.numpy(), nc_r)
        assert _ulps(ds.numpy(), ds_r).max() <= 2
        assert _ulps(np_.numpy(), np_r).max() <= 2
        if name in TREES:
            assert np.array_equal(ds.numpy(), ds_r)
            assert np.array_equal(np_.numpy(), np_r)
        assert np.all(ds_r[:16] == 0) and np.all(nc_r[:16] == -1)
        p, c = np_r, nc_r


def _ref_march(grid, pos, d, cell, S, mask):
    f = jax.jit(lambda p, dd, c, m: ref_lc.march_geometry(grid, p, dd, c, S,
                                                          m))
    return (np.asarray(x) for x in f(jnp.asarray(pos), jnp.asarray(d),
                                     jnp.asarray(cell), jnp.asarray(mask)))


@pytest.mark.parametrize("name", list(GRIDS))
def test_march_geometry_matches_reference(name):
    grid = GRIDS[name]
    port = bridge.grid(grid)
    pos, d = _rays(grid, 2)
    cell = np.asarray(grid.locate(jnp.asarray(pos)))
    mask = np.random.default_rng(3).uniform(size=B) < 0.8
    S = min(grid.max_steps(), 256)
    cells_r, ds_r = _ref_march(grid, pos, d, cell, S, mask)
    kb.reset_launches()
    cells, ds = mr.march_geometry(port, torch.tensor(pos), torch.tensor(d),
                                  torch.tensor(cell, dtype=torch.int64), S,
                                  torch.tensor(mask))
    assert kb.LAUNCHES == {k: 0 for k in kb.LAUNCHES}
    assert cells.dtype == torch.int32 and cells.shape == (S, B)
    assert ds.dtype == torch.float32 and ds.shape == (S, B)
    assert np.array_equal(cells.numpy()[:, mask], cells_r[:, mask])
    assert np.all(cells.numpy()[:, ~mask] == 0)
    assert _ulps(ds.numpy(), ds_r).max() <= 2
    if name in TREES:
        assert np.array_equal(ds.numpy(), ds_r)
    # every walking lane leaves the grid within S steps
    assert np.all(ds_r[-1] == 0)
    assert (ds_r > 0).sum(axis=0).max() > 3


@pytest.mark.parametrize("name", TREES)
def test_tree_march_with_leaf_map(name):
    """The fine leaf map attached (as a Simulation attaches it on the
    sweeps) changes no cell of the march: its steps descend."""
    grid = GRIDS[name]
    port = bridge.grid(grid)
    med = bridge.medium(_media(grid, np.random.default_rng(4))[0])
    tabs = ml.build_tables(port, med)
    mapped = port._replace(leafmap=tabs.leafmap, fine_n=tabs.n)
    pos, d = _rays(grid, 6)
    cell = np.asarray(grid.locate(jnp.asarray(pos)))
    assert np.array_equal(mapped.locate(torch.tensor(pos)).numpy(), cell)
    mask = np.ones(B, bool)
    S = min(grid.max_steps(), 256)
    cells_r, ds_r = _ref_march(grid, pos, d, cell, S, mask)
    cells, ds = mr.march_geometry(mapped, torch.tensor(pos), torch.tensor(d),
                                  torch.tensor(cell, dtype=torch.int64), S,
                                  torch.tensor(mask))
    assert np.array_equal(cells.numpy(), cells_r)
    assert np.array_equal(ds.numpy(), ds_r)


@pytest.mark.parametrize("name", ["uniform", "mesh"] + list(TREES))
def test_move_inside_matches_reference(name):
    """Lanes launched outside the grid's box move onto it as the
    reference's do, bit for bit; lanes that miss it get -1."""
    grid = GRIDS[name]
    rs = np.random.default_rng(8)
    pos = rs.uniform(-3 * PC, 3 * PC, (B, 3)).astype(np.float32)
    d = rs.normal(size=(B, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pos[:8] = 0.0                                  # lanes already inside
    toward = -pos[8:] / np.linalg.norm(pos[8:], axis=1, keepdims=True)
    d[8:B // 2] = toward[:B // 2 - 8]              # lanes aimed at the box
    d = d.astype(np.float32)
    ref = [np.asarray(x) for x in jax.jit(grid.move_inside)(
        jnp.asarray(pos), jnp.asarray(d))]
    ours = [x.numpy() for x in bridge.grid(grid).move_inside(
        torch.tensor(pos), torch.tensor(d))]
    assert (ref[1] >= 0).sum() > B // 3 and (ref[1] < 0).sum() > B // 8
    for a, b in zip(ours, ref):
        assert np.array_equal(a, b)


def _media(grid, rs):
    """A two-component medium with wavelength-dependent cross sections,
    bulk velocities and gas temperatures, in both packages."""
    n = grid.ncells if hasattr(grid, "ncells") else grid.sites.shape[0]
    nd = rs.uniform(0.0, 2.0, (n, 2)).astype(np.float32) / (1e-24 * PC)
    lam = np.geomspace(0.1e-6, 10e-6, 12)
    ref = ref_msys.make_medium(
        grid, nd, lam, sigma_ext=np.stack([1e-24 * (lam / 1e-6) ** -1.2,
                                           3e-25 * (lam / 1e-6) ** -0.5]),
        albedo=np.full((2, 12), 0.6), g=np.full((2, 12), 0.3),
        bulk_v=rs.normal(0.0, 3e5, (n, 3)).astype(np.float32),
        temperature=rs.uniform(5e3, 2e4, n).astype(np.float32))
    return ref, bridge.medium(ref)


def _recorded(name, seed):
    """A recorded march of the reference: (grid, reference medium, port
    medium, pos, d, start cells, cells, ds, lam)."""
    grid = GRIDS[name]
    rs = np.random.default_rng(seed)
    med_r, med = _media(grid, rs)
    pos, d = _rays(grid, seed)
    cell = np.asarray(grid.locate(jnp.asarray(pos)))
    S = min(grid.max_steps(), 256)
    cells, ds = _ref_march(grid, pos, d, cell, S, np.ones(B, bool))
    lam = rs.uniform(0.3e-6, 3e-6, B).astype(np.float32)
    return grid, med_r, med, pos, d, cell, cells, ds, lam


def _close(a, b, rel=1e-6):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= rel * max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("mode", ["plain", "scattering", "kinematic",
                                  "lya"])
def test_opacity_on_path_matches_reference(mode):
    grid, med_r, med, pos, d, _, cells, ds, lam = _recorded("mesh", 7)
    lam_a = lam if mode in ("kinematic", "lya") else None
    if mode == "lya":
        lam = np.full(B, 1.21567e-7, np.float32) * np.random.default_rng(
            8).uniform(0.999, 1.001, B).astype(np.float32)
        lam_a = lam
    # both take the reference's optics at the lanes' wavelengths: the
    # log-log interpolation's ulps (XLA's log and exp against PyTorch's)
    # move a cross section by up to ~1e-5 of itself
    opt_r = ref_msys.optics_at(med_r, jnp.asarray(lam))
    ref = np.asarray(jax.jit(
        lambda c, s, dd, la: ref_lc.opacity_on_path(
            med_r, opt_r, c, s, dd, la, lya=mode == "lya",
            scattering=mode == "scattering"))(
        jnp.asarray(cells), jnp.asarray(ds), jnp.asarray(d),
        None if lam_a is None else jnp.asarray(lam_a)))
    opt = msys.Optics(*(torch.tensor(np.asarray(t)) for t in opt_r))
    ours = mr.opacity_on_path(
        med, opt, torch.tensor(cells),
        torch.tensor(ds), torch.tensor(d),
        None if lam_a is None else torch.tensor(lam_a), lya=mode == "lya",
        scattering=mode == "scattering")
    assert np.abs(ref).max() > 0
    _close(ours.numpy(), ref)


def test_march_record_explicit_absorption_matches_reference():
    """march_record with the scattering depths beside the extinction ones
    (explicit absorption), from the port's own march."""
    grid, med_r, med, pos, d, cell, _, _, lam = _recorded("voronoi", 9)
    S = grid.max_steps()
    # both take the reference's optics, here formed op by op outside a
    # jitted function: the port's `optics_at` replays them as the life
    # cycle's jitted code forms them (tests/test_torch_polar.py -k rf_gap),
    # whose fused interpolation is an ulp of log sigma away
    opt_r = ref_msys.optics_at(med_r, jnp.asarray(lam))
    ref = jax.jit(lambda p, dd, c: ref_lc.march_record(
        grid, med_r, opt_r, p, dd, c, S, jnp.ones(B, bool),
        record_sca=True))(jnp.asarray(pos), jnp.asarray(d),
                          jnp.asarray(cell))
    ours = mr.march_record(bridge.grid(grid), med,
                           msys.Optics(*(torch.tensor(np.asarray(t))
                                         for t in opt_r)),
                           torch.tensor(pos), torch.tensor(d),
                           torch.tensor(cell, dtype=torch.int64), S,
                           torch.ones(B, dtype=torch.bool), record_sca=True)
    assert np.array_equal(ours[0].numpy(), np.asarray(ref[0]))
    for a, b in zip(ours[1:], ref[1:]):
        _close(a.numpy(), b)
    assert float(ours[3].sum()) < float(ours[2].sum())


def test_march_matches_reference_march_record():
    """ROADMAP item 8's gate: the port's plain march against the
    reference's march_record, tau per lane at 1e-4 relative on the lanes
    with tau > 0.01 (on every grid kind)."""
    for name, grid in GRIDS.items():
        rs = np.random.default_rng(11)
        med_r, med = _media(grid, rs)
        pos, d = _rays(grid, 12)
        cell = np.asarray(grid.locate(jnp.asarray(pos)))
        lam = rs.uniform(0.3e-6, 3e-6, B).astype(np.float32)
        S = min(grid.max_steps(), 256)
        opt_r = ref_msys.optics_at(med_r, jnp.asarray(lam))
        _, _, dtau_r = jax.jit(lambda p, dd, c: ref_lc.march_record(
            grid, med_r, opt_r, p, dd, c, S, jnp.ones(B, bool)))(
            jnp.asarray(pos), jnp.asarray(d), jnp.asarray(cell))
        tau_r = np.asarray(dtau_r, np.float64).sum(axis=0)
        _, _, dtau = mr.march_record(
            bridge.grid(grid), med, msys.optics_at(med, torch.tensor(lam)),
            torch.tensor(pos), torch.tensor(d),
            torch.tensor(cell, dtype=torch.int64), S,
            torch.ones(B, dtype=torch.bool))
        tau = dtau.double().sum(dim=0).numpy()
        big = tau_r > 0.01
        assert big.sum() > B // 2, name
        assert np.all(np.abs(tau[big] - tau_r[big]) <= 1e-4 * tau_r[big]), \
            name


def test_deposit_rf_and_interaction_point_match_reference():
    grid, med_r, med, pos, d, _, cells, ds, lam = _recorded("uniform", 13)
    rs = np.random.default_rng(14)
    opt_r = ref_msys.optics_at(med_r, jnp.asarray(lam))
    dtau = np.asarray(jax.jit(lambda c, s: ref_lc.opacity_on_path(
        med_r, opt_r, c, s, None))(jnp.asarray(cells), jnp.asarray(ds)))
    tb = np.asarray(jnp.cumsum(jnp.asarray(dtau), axis=0)
                    - jnp.asarray(dtau))
    assert np.array_equal(mr.tau_before(torch.tensor(dtau)).numpy(), tb)
    lum = rs.uniform(0.5, 1.5, B).astype(np.float32)
    nrf = 3
    rf_bin = rs.integers(0, nrf, B).astype(np.int32)
    rf_mask = rs.uniform(size=B) < 0.9
    scale = 7.3e11
    rf_r = np.asarray(ref_lc.deposit_rf(
        jnp.zeros((grid.ncells, nrf), jnp.float32), jnp.asarray(cells),
        jnp.asarray(ds), jnp.asarray(dtau), jnp.asarray(tb),
        jnp.asarray(lum), jnp.asarray(rf_bin), jnp.asarray(rf_mask),
        scale))
    for dtype in (torch.float32, torch.float64):
        rf = torch.zeros((grid.ncells, nrf), dtype=dtype)
        mr.deposit_rf(rf, torch.tensor(cells), torch.tensor(ds),
                      torch.tensor(dtau), torch.tensor(tb), torch.tensor(lum),
                      torch.tensor(rf_bin, dtype=torch.int64),
                      torch.tensor(rf_mask), scale)
        assert rf_r.max() > 0
        _close(rf.numpy(), rf_r)
    tau_path = tb[-1] + dtau[-1]
    tau_int = (rs.uniform(size=B) * tau_path).astype(np.float32)
    int_mask = rs.uniform(size=B) < 0.9
    ref = jax.jit(ref_lc.interaction_point)(
        jnp.asarray(pos), jnp.asarray(d), jnp.asarray(cells),
        jnp.asarray(ds), jnp.asarray(dtau), jnp.asarray(tb),
        jnp.asarray(tau_int), jnp.asarray(int_mask))
    ours = mr.interaction_point(
        torch.tensor(pos), torch.tensor(d), torch.tensor(cells),
        torch.tensor(ds), torch.tensor(dtau), torch.tensor(tb),
        torch.tensor(tau_int), torch.tensor(int_mask))
    ipos_r, icell_r, found_r, idx_r, frac_r = (np.asarray(x) for x in ref)
    ipos, icell, found, idx, frac = (x.numpy() for x in ours)
    assert found_r.sum() > B // 2
    assert np.array_equal(found, found_r) and np.array_equal(idx, idx_r)
    assert np.array_equal(icell[found], icell_r[found])
    _close(frac, frac_r)
    _close(ipos, ipos_r)


@pytest.mark.parametrize("S", [5, 16, 17, 76, 99, 256])
def test_cumsum_is_xlas(S):
    rs = np.random.default_rng(S)
    x = (rs.exponential(size=(S, 300))
         * rs.uniform(0, 1, (S, 300)) ** 3).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=0))(x))
    assert np.array_equal(xm.cumsum(torch.tensor(x)).numpy(), ref)


def test_raster_reads_the_resolution_cap(monkeypatch):
    """SKIRT9_TPU_RASTER_MAX_N caps every axis of the Voronoi raster, in the
    port as in the reference; without it the cap is 256."""
    grid = GRIDS["voronoi"]
    port = bridge.grid(grid)
    nd = np.ones(grid.sites.shape[0], np.float32)
    med_r = ref_msys.make_medium(grid, nd, np.array([0.4e-6, 0.7e-6]),
                                 sigma_ext=np.full((1, 2), 1e-24),
                                 albedo=np.full((1, 2), 0.6),
                                 g=np.full((1, 2), 0.5))
    med = bridge.medium(med_r)
    monkeypatch.delenv("SKIRT9_TPU_RASTER_MAX_N", raising=False)
    assert raster.build_tables(port, med).n == (73, 73, 73)
    for cap in ("24", "40"):
        monkeypatch.setenv("SKIRT9_TPU_RASTER_MAX_N", cap)
        n = raster.build_tables(port, med).n
        assert n == (int(cap),) * 3
        assert n == tuple(ref_raster.build_tables(grid, med_r).n)
