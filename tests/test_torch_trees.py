"""The port's tree grids vs the reference's, and the engine choice for trees.

Host builds: the port's `build_octree`, `build_bintree` and
`site_list_refine_fn` give the reference's arrays exactly for the same
arguments and seed (the density octree of `tests/test_mlsweep.py`, a density
bintree, and the site-list octree of `bench.py`'s `bench_config3ism`, whose
per-level site counting the port vectorises). `locate` agrees with the
reference on 4,096 seeded points, by descent and through the fine leaf map.
The engine rule sends trees to the multi-level sweep (fine rasters up to
256), to the XL contracts on their voxel raster (up to 512, and the trees
whose options the multi-level sweep declines), and to the scan march where
neither takes them: a 1,024 fine raster, five components, cells that are
no power-of-two fraction of the root box, and on the XL tables the batches
and options their gate declines (kinematics and explicit absorption on a
batch of 256). Each of these marches draw for draw with the reference's
CPU run (its scan march), 256 packets, 3 events: the SED and frame within
1e-5 of their maxima.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skirt9_tpu.grids import bintree as ref_bt
from skirt9_tpu.grids import octree as ref_ot
from skirt9_tpu.instruments import distant as ref_dinst
from skirt9_tpu.media import system as ref_msys
from skirt9_tpu.simulation import Simulation as RefSimulation
from skirt9_tpu.sources.base import PointSource as RefPointSource
from skirt9_tpu.transport import lifecycle as ref_lc
from skirt9_tpu_torch import bridge
from skirt9_tpu_torch.grids import bintree as bt
from skirt9_tpu_torch.grids import octree as ot
from skirt9_tpu_torch.instruments.distant import DistantInstrumentCfg
from skirt9_tpu_torch.kernels import build as kb
from skirt9_tpu_torch.media import system as msys
from skirt9_tpu_torch.simulation import Simulation
from skirt9_tpu_torch.sources.base import PointSource
from skirt9_tpu_torch.transport import lifecycle as lc
from skirt9_tpu_torch.transport import march as mr
from skirt9_tpu_torch.transport import mlsweep as ml
from skirt9_tpu_torch.transport import sweepxl as xl

PC = 3.0857e16
EXT = ((-1.2 * PC, 1.2 * PC),) * 3


def _dens(p):
    r = np.linalg.norm(p, axis=-1)
    return np.where(r < PC, (PC / np.maximum(r, 0.1 * PC)) ** 2, 0.0)


def _ism_sites():
    """bench_config3ism's site list (bench.py:336-339)."""
    rs = np.random.default_rng(9)
    cc = rs.uniform(-0.85, 0.85, size=(46, 3)) * PC
    return np.concatenate(
        [c + rs.normal(scale=0.04 * PC, size=(26, 3)) for c in cc])


def _build(pkg_octree, pkg_bintree, kind):
    """The same tree through either package's builders."""
    if kind == "octree":
        return pkg_octree.build_octree(EXT, _dens, max_level=4, min_level=1,
                                       max_fraction=2e-2)
    if kind == "bintree":
        return pkg_bintree.build_bintree(EXT, _dens, max_level=10,
                                         min_level=3, max_fraction=2e-2)
    return pkg_octree.build_octree(
        ((-PC, PC),) * 3, lambda p: np.ones(len(p)), max_level=7, min_level=2,
        refine_fn=pkg_octree.site_list_refine_fn(_ism_sites(), 1))


KINDS = ("octree", "bintree", "ism_sitelist")


@pytest.fixture(scope="module", params=KINDS)
def trees(request):
    return (_build(ref_ot, ref_bt, request.param),
            _build(ot, bt, request.param))


def test_build_matches_reference(trees):
    ref, port = trees
    assert type(ref).__name__ == type(port).__name__
    for name in port._fields:
        if name in ("leafmap", "fine_n"):
            assert getattr(port, name) in (None, ())
            continue
        a, b = getattr(ref, name), getattr(port, name)
        if name == "levels":
            assert a == b
            continue
        a = np.asarray(a)
        b = b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_site_list_refine_matches_reference_loop():
    """The vectorised site count against the reference's per-node loop on
    every level of a seeded site-list tree, sites on node faces included."""
    rs = np.random.default_rng(3)
    sites = rs.uniform(-PC, PC, (300, 3))
    sites[:20] = np.round(sites[:20] / (PC / 8)) * (PC / 8)   # on faces
    grid = ot.build_octree(((-PC, PC),) * 3, lambda p: np.ones(len(p)),
                           max_level=5, min_level=1,
                           refine_fn=ot.site_list_refine_fn(sites, 1))
    lo, hi = grid.cell_lo.double().numpy(), grid.cell_hi.double().numpy()
    size = hi[:, 0] - lo[:, 0]
    for level_size in np.unique(size):
        m = size == level_size
        for k in (1, 2):
            np.testing.assert_array_equal(
                ot.site_list_refine_fn(sites, k)(lo[m], hi[m], 0),
                ref_ot.site_list_refine_fn(sites, k)(lo[m], hi[m], 0))


def test_locate_matches_reference(trees):
    ref, port = trees
    rs = np.random.default_rng(11)
    lo = np.asarray(ref.box_lo, np.float64)
    hi = np.asarray(ref.box_hi, np.float64)
    pos = rs.uniform(lo - 0.05 * (hi - lo), hi + 0.05 * (hi - lo),
                     (4096, 3)).astype(np.float32)
    want = np.asarray(ref.locate(jnp.asarray(pos)))
    assert (want < 0).any() and (want >= 0).sum() > 3000
    np.testing.assert_array_equal(port.locate(torch.from_numpy(pos)).numpy(),
                                  want)
    # through the fine leaf map, as a Simulation attaches it
    lm = ml.build_tables(port, _medium(port))
    fast = port._replace(leafmap=lm.leafmap, fine_n=lm.n)
    np.testing.assert_array_equal(fast.locate(torch.from_numpy(pos)).numpy(),
                                  want)
    np.testing.assert_array_equal(
        ml.locate_cells(lm, torch.from_numpy(pos)).numpy(), want)


def _medium(grid, ncomp=1):
    nd = np.ones((grid.ncells, ncomp), np.float32) / (1e-24 * PC)
    return msys.make_medium(grid, nd, np.array([0.4e-6, 0.7e-6]),
                            sigma_ext=np.full((ncomp, 2), 1e-24),
                            albedo=np.full((ncomp, 2), 0.5),
                            g=np.full((ncomp, 2), 0.3))


def _simulation(grid, ncomp=1, **opts):
    return Simulation(
        grid=grid, medium=_medium(grid, ncomp),
        sources=[PointSource(luminosity=1.0, lam0=0.55e-6)],
        instruments=[DistantInstrumentCfg(name="i", wave_borders=(0.5e-6,
                                                                  0.6e-6),
                                          distance=100 * PC)],
        options=lc.TransportOptions(max_steps=grid.max_steps(), max_events=2,
                                    **opts),
        num_packets=64, batch_size=64, device="cpu")


def test_trees_take_the_multilevel_sweep(trees):
    _, port = trees
    sim = _simulation(port)
    assert isinstance(sim._sweep_tabs, ml.MLTables)
    assert sim.grid.leafmap is not None and sim.grid.fine_n == sim._sweep_tabs.n
    assert sim._sweep_tabs.nd is sim.medium.nd


def _deep_octree(max_level):
    """An octree refined along one path only, down to max_level."""
    p = np.array([0.1, 0.2, 0.3]) * PC

    def refine(lo, hi, level):
        return np.all((lo <= p) & (p < hi), axis=-1)

    return ot.build_octree(EXT, None, max_level=max_level, min_level=1,
                           refine_fn=refine)


def _reference(ref_grid, ncomp=1, rf_borders=None, **opts):
    """A reference Simulation of a tree (its CPU engine: the scan march):
    a uniform medium of ncomp components (with random bulk velocities for
    kinematics), a point source at the centre, an 8x8 frame, 256 packets
    in one batch, 3 events."""
    n = ref_grid.ncells
    rs = np.random.default_rng(3)
    med = ref_msys.make_medium(
        ref_grid, np.ones((n, ncomp), np.float32) / (1e-24 * PC * ncomp),
        np.array([0.4e-6, 0.7e-6]), sigma_ext=np.full((ncomp, 2), 1e-24),
        albedo=np.full((ncomp, 2), 0.5), g=np.full((ncomp, 2), 0.3),
        bulk_v=(rs.normal(0.0, 3e6, (n, 3)).astype(np.float32)
                if opts.get("kinematics") else None))
    inst = ref_dinst.DistantInstrumentCfg(
        name="i", wave_borders=(0.5e-6, 0.6e-6), distance=100 * PC, npx=8,
        npy=8, fovx=3 * PC, fovy=3 * PC)
    return RefSimulation(
        grid=ref_grid, medium=med,
        sources=[RefPointSource(luminosity=1.0, lam0=0.55e-6)],
        instruments=[inst], options=ref_lc.TransportOptions(
            max_steps=min(ref_grid.max_steps(), 256), max_events=3, **opts),
        rf_borders=rf_borders, num_packets=256, batch_size=256, seed=2)


def marches_as_reference(ref, monkeypatch, engine=None):
    """The port's Simulation of a reference one, with its own engine
    choice (engine: the class of its tables, None for none), run beside
    the reference's CPU run: the port walks its tree on the scan march
    (a spy on the plain march), no kernel launches, and the RF, SED and
    frame agree within 1e-5 of their maxima. Returns the port's
    Simulation."""
    port = bridge.simulation(ref, "cpu")
    assert (port._sweep_tabs is None if engine is None
            else isinstance(port._sweep_tabs, engine))
    calls = []
    plain = mr.march_geometry_plain

    def spy(*args):
        calls.append(args[0])
        return plain(*args)

    monkeypatch.setattr(mr, "march_geometry_plain", spy)
    rf_r, accs_r = ref.run_primary(verbose=False)
    kb.reset_launches()
    rf_p, accs_p = port.run_primary(verbose=False)
    assert kb.LAUNCHES == {k: 0 for k in kb.LAUNCHES}
    assert calls and all(g is port.grid for g in calls)
    pairs = [(np.asarray(accs_r[0][k][j]), accs_p[0][k][j])
             for k in ("sed", "frame") for j in range(3)]
    if rf_r is not None:
        pairs.append((np.asarray(rf_r), rf_p))
    for a, b in pairs:
        a = a.astype(np.float64)
        assert np.abs(a).max() > 0
        assert np.abs(b.double().numpy() - a).max() <= 1e-5 * np.abs(a).max()
    return port


def test_fine_raster_cap(monkeypatch):
    """The multi-level sweep takes a 256 fine raster, the XL contracts a
    512 one on the tree's voxel raster (the rule alone here: its tables
    are 2 x 537 MB), nothing a 1024 one: that tree marches, as the
    reference's does."""
    assert isinstance(_simulation(_deep_octree(8))._sweep_tabs, ml.MLTables)
    deep = _deep_octree(9)
    med = msys.make_medium(deep, np.ones(deep.ncells, np.float32),
                           np.array([0.4e-6, 0.7e-6]),
                           sigma_ext=np.full((1, 2), 1e-24),
                           albedo=np.full((1, 2), 0.5),
                           g=np.full((1, 2), 0.0))
    assert not ml.supports(deep, med) and xl.supports_tree_xl(deep, med)
    assert _simulation(_deep_octree(10))._sweep_tabs is None
    p = np.array([0.1, 0.2, 0.3]) * PC
    ref = _reference(ref_ot.build_octree(
        EXT, None, max_level=10, min_level=1, refine_fn=lambda lo, hi, lv:
        np.all((lo <= p) & (p < hi), axis=-1)))
    assert ref.grid.levels == 11
    marches_as_reference(ref, monkeypatch)


def test_non_power_of_two_tree_raises(monkeypatch):
    """`_signature_levels` refuses a leaf that is no power-of-two fraction
    of the root box; such a tree takes no sweep and marches, as in the
    reference."""
    grid = _build(ot, bt, "octree")
    lo, hi = grid.cell_lo.clone(), grid.cell_hi.clone()
    hi[0] = lo[0] + 0.7 * (hi[0] - lo[0])
    with pytest.raises(ValueError, match="power-of-two"):
        ml._signature_levels(grid._replace(cell_hi=hi))
    assert _simulation(grid._replace(cell_hi=hi))._sweep_tabs is None
    ref_grid = _build(ref_ot, ref_bt, "octree")
    ref_grid = ref_grid._replace(cell_hi=jnp.asarray(hi.numpy()))
    marches_as_reference(_reference(ref_grid), monkeypatch)


@pytest.mark.parametrize("option", ["kinematics", "explicit_absorption"])
def test_unported_tree_options_raise(option, monkeypatch):
    """Kinematics and explicit absorption leave the multi-level sweep for
    the tree's voxel raster (XL tables, as the reference's chain builds
    them); a batch of 256 lanes (and explicit absorption on any batch)
    fails the XL gate, and the tree marches."""
    grid = _build(ot, bt, "octree")
    opts = lc.TransportOptions(max_steps=8, **{option: True})
    assert not ml.supports(grid, _medium(grid), opts)
    assert xl.supports_tree_xl(grid, _medium(grid))
    ref = _reference(_build(ref_ot, ref_bt, "octree"), **{option: True})
    port = marches_as_reference(ref, monkeypatch, xl.XLTables)
    gate = lc.sweep_gate(port.medium, port.options, port._sweep_tabs, None,
                         256)
    assert not gate.use_sweep
    assert ("explicitAbsorption" in gate.why) == (
        option == "explicit_absorption")


def test_five_components_raise(monkeypatch):
    """Five components: neither sweep takes the tree (<= 4), it marches."""
    grid = _build(ot, bt, "octree")
    assert _simulation(grid, ncomp=5)._sweep_tabs is None
    marches_as_reference(_reference(_build(ref_ot, ref_bt, "octree"),
                                    ncomp=5), monkeypatch)


def test_grid_helpers():
    grid = _build(ot, bt, "bintree")
    box = (grid.box_hi - grid.box_lo).double()
    assert grid.diagonal() == pytest.approx(float(box.norm()), rel=1e-7)
    assert grid.volumes().sum() == pytest.approx(float(box.prod()), rel=1e-6)
    moved, cell, dist = grid.move_inside(
        torch.tensor([[-2 * PC, 0.01 * PC, 0.02 * PC]], dtype=torch.float32),
        torch.tensor([[1.0, 0.0, 0.0]], dtype=torch.float32))
    assert int(cell[0]) >= 0 and float(dist[0]) > 0
    assert float(moved[0, 0]) >= float(grid.box_lo[0])
