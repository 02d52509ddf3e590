"""Trees on their exact voxel raster through the port's XL contracts, on
the CPU, against the reference.

- `sweepxl.build_tree_tables` (`parallel/domain.voxelize_for_dd`) array
  for array against the reference's `voxelize_for_dd` on the density
  octree and bintree of `tests/test_mlsweep.py` and a site-list octree:
  the voxel grid, the voxel density and the voxel -> leaf map equal.
- `supports_tree_xl` is the reference's rule alone: it takes a 256 or a
  512 raster (True each; the multi-level sweep, asked first, takes only
  the 256 one) and leaves a raster over 512 to nothing and a tree whose
  every leaf is a fine voxel (a uniform grid in disguise) to the
  uniform-grid engines (False each); the engine choice follows.
- Draw for draw: the density octree of `tests/test_mlsweep.py:30` on the
  reference's tree XL route (forced by its own `SKIRT9_TPU_ML_ENC_CAP=1`
  and `SKIRT9_TPU_FORCE_SWEEP=1`, as its test at `:190-232` does; its
  Pallas kernels in interpret mode) and on the port's (the tables put in
  place by `bridge.py`): the per-leaf RF, the SED and the frame within
  1e-5 of their maxima (they agree to ~2e-6: the reference's density
  planes are bf16 hi/lo pairs, exact to 2^-16 of each voxel).
- A monochromatic source in a three-bin RF on a tree raster deposits into
  its own bin what a one-bin RF over that bin holds; on the multi-level
  sweep the same seed agrees within 1e-5 (SEDs, RF).
"""

import numpy as np
import pytest
import torch

from skirt9_tpu.grids.cartesian import UniformCartesianGrid as RefUniform
from skirt9_tpu.instruments import distant as ref_dinst
from skirt9_tpu.parallel import domain as ref_dom
from skirt9_tpu.simulation import Simulation as RefSimulation
from skirt9_tpu.sources.base import PointSource as RefPointSource
from skirt9_tpu.transport import lifecycle as ref_lc
from skirt9_tpu.transport import sweepxl as ref_xl
from skirt9_tpu_torch import bridge
from skirt9_tpu_torch.grids.octree import build_octree, site_list_refine_fn
from skirt9_tpu_torch.instruments.distant import DistantInstrumentCfg
from skirt9_tpu_torch.kernels import build as kb
from skirt9_tpu_torch.media import system as msys
from skirt9_tpu_torch.simulation import Simulation
from skirt9_tpu_torch.sources.base import PointSource
from skirt9_tpu_torch.transport import lifecycle as lc
from skirt9_tpu_torch.transport import mlsweep as ml
from skirt9_tpu_torch.transport import sweepxl as xl
from test_torch_mlsweep import _medium, reference_tree

PC = 3.0857e16


@pytest.mark.parametrize("kind", ["octree", "bintree", "sites"])
def test_build_tree_tables_matches_reference(kind):
    rgrid = reference_tree(kind)
    rmed = _medium(rgrid, 2, 3)
    vox, rvmed, rmap = ref_dom.voxelize_for_dd(rgrid, rmed, 1)
    assert isinstance(vox, RefUniform)
    grid, med = bridge.grid(rgrid), bridge.medium(rmed)
    tabs = xl.build_tree_tables(grid, med)
    assert tabs.n == vox.shape and tabs.nmax == max(vox.shape)
    assert tabs.lo == tuple(float(v) for v in np.asarray(vox.lo, np.float64))
    assert tabs.h == tuple(float(v) for v in np.asarray(vox.h, np.float64))
    assert tabs.cellmap.dtype == torch.int32
    assert np.array_equal(tabs.cellmap.numpy(), np.asarray(rmap))
    assert np.array_equal(tabs.nd.numpy(), np.asarray(rvmed.nd))
    assert tabs.rf_cells == grid.ncells
    assert int(tabs.cellmap.min()) >= 0
    assert sorted(set(tabs.cellmap.tolist())) == list(range(grid.ncells))


def _site_tree(max_level, min_level=2):
    """An octree refined to max_level around two pairs of close sites."""
    sites = np.array([[0.1, 0.2, 0.3], [0.1005, 0.2005, 0.3005],
                      [-0.4, 0.1, -0.2], [-0.3995, 0.1005, -0.1995]]) * PC
    return build_octree(((-PC, PC),) * 3, lambda p: np.ones(len(p)),
                        max_level=max_level, min_level=min_level,
                        refine_fn=site_list_refine_fn(sites, 1))


class _Medium:
    """Stand-in medium: the engine rules read only the component count."""

    ncomp = 1


@pytest.mark.parametrize("case,want", [
    ("raster_512", True), ("raster_256", True), ("raster_1024", False),
    ("uniform_in_disguise", False), ("components_5", False)])
def test_supports_tree_xl(case, want):
    med = _Medium()
    if case == "uniform_in_disguise":
        # every leaf a fine voxel
        grid = build_octree(((-PC, PC),) * 3, lambda p: np.ones(len(p)),
                            max_level=2, min_level=2)
        assert grid.ncells == 64
    else:
        grid = _site_tree({"raster_512": 9, "raster_256": 8,
                           "raster_1024": 10, "components_5": 9}[case])
    if case == "components_5":
        med.ncomp = 5
    assert xl.supports_tree_xl(grid, med) is want
    if case in ("raster_256", "raster_512"):
        # the chain asks the multi-level sweep first: a 256 raster is its
        # own, a 512 raster the voxel raster's
        assert ml.supports(grid, med) is (case == "raster_256")


def test_engine_choice_for_trees(monkeypatch):
    """The port's order (the reference's, `skirt9_tpu/simulation.py:
    194-217`, without its backend tests): the multi-level sweep, then the
    tree's voxel raster; the grid's leaf map is then the tables' cell
    map. The multi-level sweep's raster cap is cut to 32 here, so that the
    voxel raster of a level-6 tree stands in for a level-9 tree's 512^3."""
    monkeypatch.setattr(ml, "NF_MAX", 32)
    for level, engine in ((5, ml.MLTables), (6, xl.XLTables)):
        grid = _site_tree(level)
        med = msys.make_medium(grid, np.ones(grid.ncells, np.float32),
                               np.array([0.4e-6, 0.7e-6]),
                               sigma_ext=np.full((1, 2), 1e-30),
                               albedo=np.full((1, 2), 0.5),
                               g=np.full((1, 2), 0.0))
        sim = Simulation(grid=grid, medium=med, sources=[PointSource()],
                         instruments=[],
                         options=lc.TransportOptions(
                             max_steps=grid.max_steps()), device="cpu")
        assert isinstance(sim._sweep_tabs, engine)
        if engine is xl.XLTables:
            tabs = sim._sweep_tabs
            assert tabs.n == (64,) * 3 and tabs.rf_cells == grid.ncells
            assert sim.grid.leafmap is tabs.cellmap
            pos = torch.tensor(np.random.default_rng(1).uniform(
                -PC, PC, (512, 3)), dtype=torch.float32)
            assert torch.equal(sim.grid.locate(pos),
                               grid.locate(pos))


def test_tree_xl_draw_for_draw(monkeypatch):
    from test_mlsweep import _problem
    monkeypatch.setenv("SKIRT9_TPU_FORCE_SWEEP", "1")
    monkeypatch.setenv("SKIRT9_TPU_ML_ENC_CAP", "1")
    grid, med = _problem()
    inst = ref_dinst.DistantInstrumentCfg(
        name="i", wave_borders=(0.5e-6, 0.6e-6), distance=100 * PC, npx=16,
        npy=16, fovx=3 * PC, fovy=3 * PC)
    ref = RefSimulation(grid=grid, medium=med,
                        sources=[RefPointSource(luminosity=1.0,
                                                lam0=0.55e-6)],
                        instruments=[inst], options=ref_lc.TransportOptions(
                            max_steps=grid.max_steps(), max_events=4),
                        rf_borders=np.array([0.5e-6, 0.6e-6]),
                        num_packets=1024, batch_size=1024, seed=4)
    assert isinstance(ref._sweep_tabs, ref_xl.XLTables)
    assert ref._sweep_tabs.cellmap is not None
    port = bridge.simulation(ref, "cpu")
    tabs = port._sweep_tabs
    assert isinstance(tabs, xl.XLTables) and tabs.cellmap is not None
    assert tabs.n == (16,) * 3 and tabs.rf_cells == grid.ncells
    rf_r, accs_r = ref.run_primary(verbose=False)
    kb.reset_launches()
    rf_p, accs_p = port.run_primary(verbose=False)
    assert kb.LAUNCHES == {k: 0 for k in kb.LAUNCHES}
    rf_r = np.asarray(rf_r, np.float64)
    assert rf_r.shape == tuple(rf_p.shape) == (grid.ncells, 1)
    assert rf_r.max() > 0
    assert np.abs(rf_p.double().numpy() - rf_r).max() <= 1e-5 * rf_r.max()
    for key in ("sed", "frame"):
        r = np.asarray(accs_r[0][key], np.float64)
        p = accs_p[0][key].double().numpy()
        for k in range(r.shape[0]):
            if r[k].max() > 0:
                assert np.abs(p[k] - r[k]).max() <= 1e-5 * r[k].max(), \
                    (key, k)


def _tree_sim(rf_borders, raster: bool, lam0=0.55e-6):
    grid = _site_tree(5, min_level=3)
    rs = np.random.default_rng(4)
    med = msys.make_medium(grid, rs.uniform(0.5, 1.5, grid.ncells).astype(
        np.float32) / (1e-24 * PC), np.array([0.1e-6, 2e-6]),
        sigma_ext=np.full((1, 2), 1e-24), albedo=np.full((1, 2), 0.6),
        g=np.full((1, 2), 0.5))
    sim = Simulation(grid=grid, medium=med,
                     sources=[PointSource(luminosity=1.0, lam0=lam0)],
                     instruments=[DistantInstrumentCfg(
                         name="i0", wave_borders=(0.5e-6, 0.6e-6),
                         distance=100 * PC)],
                     options=lc.TransportOptions(max_steps=grid.max_steps(),
                                                 max_events=4),
                     rf_borders=np.asarray(rf_borders), num_packets=2048,
                     batch_size=1024, device="cpu")
    if raster:
        sim._sweep_tabs = xl.build_tree_tables(sim.grid, sim.medium)
    return sim


def test_tree_raster_monochromatic_and_multilevel():
    multi = _tree_sim([0.1e-6, 0.3e-6, 0.5e-6, 0.6e-6, 2e-6], True)
    one = _tree_sim([0.5e-6, 0.6e-6], True)
    assert multi._mono_rf_bin(multi.sources[0], multi.options) == 2
    rf_m, accs_m = multi.run_primary(verbose=False)
    rf_1, accs_1 = one.run_primary(verbose=False)
    assert rf_m.shape == (multi.grid.ncells, 4) and float(rf_1.sum()) > 0
    assert torch.equal(rf_m[:, 2], rf_1[:, 0])
    assert float(rf_m[:, [0, 1, 3]].abs().sum()) == 0.0
    assert torch.equal(accs_m[0]["sed"], accs_1[0]["sed"])
    # the same seed on the multi-level sweep
    tree = _tree_sim([0.5e-6, 0.6e-6], False)
    assert isinstance(tree._sweep_tabs, ml.MLTables)
    rf_t, accs_t = tree.run_primary(verbose=False)
    assert float((rf_t - rf_1).abs().max()) <= 1e-5 * float(rf_t.max())
    st, s1 = accs_t[0]["sed"], accs_1[0]["sed"]
    for k in range(st.shape[0]):
        if float(st[k].abs().max()) > 0:
            assert float((s1[k] - st[k]).abs().max()) <= 1e-5 * float(
                st[k].abs().max())
