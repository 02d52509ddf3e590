"""The port's config-1 slice vs the reference, end to end on the CPU.

Config 1 of bench.py (point source, uniform dust sphere, forced scattering,
HG peel-off to one SED + frame instrument) at 16^3, 4096 packets in batches
of 1024, 8 events and a 16x16 frame. The reference Simulation is converted
through `skirt9_tpu_torch.bridge`; both run on the CPU (the reference on its
scan march, the port on the plain versions of its sweep kernels) and draw
the same random numbers. Bounds: each SED kind within 1e-4 relative, the
frame within 1e-3 of its brightest pixel, the statistics N within 0.1%, the
one-bin RF within 1e-4 of its maximum.

The same holds with the large-grid (XL) contracts put in place of the
resident sweep. At 80^3 the port picks the XL contracts by itself, and its
run matches the same seed on the resident sweep, at the CPU-vs-GPU
draw-for-draw bounds of chip_smoke.py (SEDs 1e-4, frame 1e-3 of its
maximum, RF total 1e-4).

On the density octree of `tests/test_mlsweep.py` (max_level 4) the port's
multi-level sweep runs against the reference's scan march (the reference
takes its tree sweep only on a TPU) at the reference's own sweep-against-march
bounds (`tests/test_mlsweep.py:182-187`: SEDs rtol 3e-3, RF rtol 5e-3 with
atol 1e-5 of its total) as the outer limit. It comes much closer (SEDs within
1.2e-6, the frame within 5e-12 of its brightest pixel, the RF per cell within
2.6e-7 of its total), so the test holds it to a small multiple of that: SEDs
1e-4, the frame 1e-5 of its brightest pixel, the RF per cell rtol 1e-4 with
atol 1e-6 of its total.

With explicit absorption the port takes the scan march, as the
reference's gate does, and agrees with the reference at the same bounds.

The port's sources import neither jax nor any module of the JAX package:
an `ast` scan of the package (the loader, probes, CLI, unit copies, trees,
adaptive meshes, polar grids, tetrahedral meshes, tree and XL sweeps, voxel
rasters, the scan march, the meshes, the imported snapshots and geometries
and the event loop among it), chip_smoke.py and `perf/*.py` finds no such
import. The subprocesses that run the port's paths and find no such module
loaded are `tests/test_torch_nojax_*.py`; the XL engine at 80^3 against the
resident sweep is `tests/test_torch_xl80.py`.
"""

import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

from skirt9_tpu.grids.cartesian import make_cartesian
from skirt9_tpu.grids.octree import build_octree as ref_build_octree
from skirt9_tpu.instruments import distant as ref_dinst
from skirt9_tpu.media import system as ref_msys
from skirt9_tpu.simulation import Simulation as RefSimulation
from skirt9_tpu.sources.base import PointSource as RefPointSource
from skirt9_tpu.transport import lifecycle as ref_lc
from skirt9_tpu_torch import bridge
from skirt9_tpu_torch.grids.cartesian import make_cartesian as port_cartesian
from skirt9_tpu_torch.instruments import distant as dinst
from skirt9_tpu_torch.kernels import build as kb
from skirt9_tpu_torch.media import system as msys
from skirt9_tpu_torch.simulation import Simulation
from skirt9_tpu_torch.sources.base import PointSource
from skirt9_tpu_torch.transport import lifecycle as lc
from skirt9_tpu_torch.transport import mlsweep as ml
from skirt9_tpu_torch.transport import sweep as sw
from skirt9_tpu_torch.transport import sweepxl as xl

PC = 3.0857e16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_config1(store_rf: bool, two_components: bool = False):
    box = 1.2 * PC
    grid = make_cartesian(((-box, box),) * 3, (16,) * 3)
    sigma = 1e-24
    nd = ref_msys.uniform_density_sphere(grid, 1.0, sigma, PC)
    kw = dict(sigma_ext=np.array([[sigma, sigma]]),
              albedo=np.full((1, 2), 0.6), g=np.full((1, 2), 0.5))
    if two_components:
        # the same optical depth split over two dust kinds with their own
        # albedo and asymmetry, unevenly across the sphere
        w = np.linspace(0.2, 0.8, nd.shape[0], dtype=np.float32)
        nd = np.stack([nd * w, nd * (1.0 - w)], axis=1)
        kw = dict(sigma_ext=np.full((2, 2), sigma),
                  albedo=np.array([[0.3, 0.3], [0.9, 0.9]]),
                  g=np.array([[0.1, 0.1], [0.7, 0.7]]))
    med = ref_msys.make_medium(grid, nd, np.array([0.4e-6, 0.7e-6]), **kw)
    inst = ref_dinst.DistantInstrumentCfg(
        name="i0", wave_borders=(0.5e-6, 0.6e-6), distance=100 * PC,
        npx=16, npy=16, fovx=4 * PC, fovy=4 * PC)
    opts = ref_lc.TransportOptions(max_steps=grid.max_steps(), max_events=8,
                                   store_rf=store_rf)
    return RefSimulation(
        grid=grid, medium=med,
        sources=[RefPointSource(luminosity=1.0, lam0=0.55e-6)],
        instruments=[inst], options=opts,
        rf_borders=np.array([0.5e-6, 0.6e-6]) if store_rf else None,
        num_packets=4096, batch_size=1024, seed=0)


def _compare(ref_sim, sim):
    rf_r, accs_r = ref_sim.run_primary(verbose=False)
    kb.reset_launches()
    rf, accs = sim.run_primary(verbose=False)
    assert all(v == 0 for v in kb.LAUNCHES.values())  # CPU: plain versions
    cfg_r, cfg = ref_sim.instruments[0], sim.instruments[0]
    sed_r = ref_dinst.calibrate_sed(cfg_r, {k: np.asarray(v)
                                            for k, v in accs_r[0].items()})
    sed = dinst.calibrate_sed(cfg, accs[0])
    for kind in ("transparent", "primarydirect", "primaryscattered",
                 "total"):
        assert sed_r[kind][0] > 0
        rel = abs(sed[kind][0] - sed_r[kind][0]) / sed_r[kind][0]
        assert rel <= 1e-4, (kind, rel)
    assert abs(sed["N"][0] - sed_r["N"][0]) <= 1e-3 * sed_r["N"][0]
    fr_r = np.asarray(accs_r[0]["frame"], np.float64)
    fr = accs[0]["frame"].numpy().astype(np.float64)
    assert np.abs(fr - fr_r).max() <= 1e-3 * np.abs(fr_r).max()
    return rf_r, rf


@pytest.fixture(scope="module")
def config1():
    ref_sim = _reference_config1(store_rf=False)
    return ref_sim, bridge.simulation(ref_sim, device="cpu")


def test_config1_matches_reference(config1):
    ref_sim, sim = config1
    rf_r, rf = _compare(ref_sim, sim)
    assert rf_r is None and rf is None


def test_config1_rf_matches_reference():
    ref_sim = _reference_config1(store_rf=True)
    sim = bridge.simulation(ref_sim, device="cpu")
    assert sim.rf_scale == pytest.approx(ref_sim.rf_scale, rel=1e-12)
    rf_r, rf = _compare(ref_sim, sim)
    rf_r = np.asarray(rf_r, np.float64)
    rf = rf.numpy().astype(np.float64)
    assert rf.shape == rf_r.shape == (16 ** 3, 1)
    assert np.abs(rf - rf_r).max() <= 1e-4 * np.abs(rf_r).max()


@pytest.mark.parametrize("store_rf", [False, True], ids=["no_rf", "rf"])
def test_config1_xl_matches_reference(store_rf):
    ref_sim = _reference_config1(store_rf=store_rf)
    sim = bridge.simulation(ref_sim, device="cpu")
    assert isinstance(sim._sweep_tabs, sw.SweepTables)
    sim._sweep_tabs = xl.build_tables(sim.grid, sim.medium)
    rf_r, rf = _compare(ref_sim, sim)
    if store_rf:
        rf_r = np.asarray(rf_r, np.float64)
        rf = rf.numpy().astype(np.float64)
        assert np.abs(rf - rf_r).max() <= 1e-4 * np.abs(rf_r).max()


def test_two_components_match_reference():
    ref_sim = _reference_config1(store_rf=False, two_components=True)
    sim = bridge.simulation(ref_sim, device="cpu")
    assert sim.medium.ncomp == 2
    _compare(ref_sim, sim)


def test_write_outputs(config1, tmp_path):
    from skirt9_tpu.utils.fits import read_fits
    _, sim = config1
    _, accs = sim.run_primary(verbose=False)
    paths = sim.write_outputs(accs, "c1", str(tmp_path))
    assert [os.path.basename(p) for p in paths] == ["c1_i0_sed.dat",
                                                    "c1_i0_total.fits"]
    cols = np.loadtxt(paths[0])
    assert cols.shape == (9,) and np.all(np.isfinite(cols))
    cube, _ = read_fits(paths[1])
    assert cube.shape == (1, 16, 16) and np.isfinite(cube).all()
    assert cube.max() > 0


def test_cuda_device_raises_without_cuda(config1):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        bridge.simulation(config1[0], device="cuda")


def test_device_must_be_named(config1, monkeypatch):
    """Only a named CPU runs on the CPU: an unnamed device means the card,
    which raises where there is none instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sim = config1[1]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dataclasses.replace(sim, device=None)


def test_unported_options_raise(config1):
    """Explicit absorption runs on the scan march (the reference's gate
    declines the sweep) and agrees with the reference's march at the
    slice's bounds; polarization and kinematics run on XL tables put in
    place (the gate passes them) and agree with the reference's march at
    the same bounds, and kinematics with wavelength-dependent cross
    sections takes the march."""
    ref_sim, sim = config1
    ref_abs = dataclasses.replace(ref_sim, options=dataclasses.replace(
        ref_sim.options, explicit_absorption=True))
    port_abs = bridge.simulation(ref_abs, device="cpu")
    assert isinstance(port_abs._sweep_tabs, sw.SweepTables)
    gate = lc.sweep_gate(port_abs.medium, port_abs.options,
                         port_abs._sweep_tabs, None, 1024)
    assert not gate.use_sweep and gate.why == ("explicitAbsorption",)
    _compare(ref_abs, port_abs)
    # polarization and kinematics ride the XL sweep as the resident one
    for name in ("polarization", "kinematics"):
        ref_on = dataclasses.replace(ref_sim, options=dataclasses.replace(
            ref_sim.options, **{name: True}))
        opts = bridge.options(ref_on.options)
        other = dataclasses.replace(sim, options=opts)
        other._sweep_tabs = xl.build_tables(other.grid, other.medium)
        assert lc.sweep_gate(other.medium, opts, other._sweep_tabs, None,
                             other.batch_size).use_sweep
        _compare(ref_on, other)
    varying = sim.medium._replace(
        sigma_ext=sim.medium.sigma_ext * torch.tensor([1.0, 2.0]))
    moving = dataclasses.replace(sim, medium=varying, options=opts)
    assert not lc.check_kinematics(moving.medium, moving.options, 0)
    assert not lc.sweep_gate(moving.medium, moving.options,
                             moving._sweep_tabs, None, 1024).use_sweep


def _reference_octree():
    """The density octree simulation of `tests/test_mlsweep.py:153-171`,
    with 2,048 packets and a 16x16 frame."""
    sigma = 1e-24

    def dens(p):
        r = np.linalg.norm(p, axis=-1)
        return np.where(r < PC, (PC / np.maximum(r, 0.1 * PC)) ** 2, 0.0)

    grid = ref_build_octree(((-1.2 * PC, 1.2 * PC),) * 3, dens, max_level=4,
                            min_level=1, max_fraction=2e-2)
    nd = dens(np.asarray(grid.cell_centers(), np.float64)) / (sigma * PC)
    med = ref_msys.make_medium(grid, nd.astype(np.float32),
                               np.array([0.4e-6, 0.7e-6]),
                               sigma_ext=np.full((1, 2), sigma),
                               albedo=np.full((1, 2), 0.5),
                               g=np.full((1, 2), 0.3))
    inst = ref_dinst.DistantInstrumentCfg(
        name="i", wave_borders=(0.5e-6, 0.6e-6), distance=100 * PC, npx=16,
        npy=16, fovx=4 * PC, fovy=4 * PC)
    return RefSimulation(
        grid=grid, medium=med,
        sources=[RefPointSource(luminosity=1.0, lam0=0.55e-6)],
        instruments=[inst],
        options=ref_lc.TransportOptions(max_steps=grid.max_steps(),
                                        max_events=4),
        rf_borders=np.array([0.5e-6, 0.6e-6]), num_packets=2048,
        batch_size=1024, seed=4)


def test_octree_matches_reference_scan_march():
    ref_sim = _reference_octree()
    rf_r, accs_r = ref_sim.run_primary(verbose=False)
    sim = bridge.simulation(ref_sim, device="cpu")
    assert isinstance(sim._sweep_tabs, ml.MLTables)
    assert sim.grid.leafmap is not None
    kb.reset_launches()
    rf, accs = sim.run_primary(verbose=False)
    assert all(v == 0 for v in kb.LAUNCHES.values())  # CPU: plain versions
    sed_r = ref_dinst.calibrate_sed(ref_sim.instruments[0],
                                    {k: np.asarray(v)
                                     for k, v in accs_r[0].items()})
    sed = dinst.calibrate_sed(sim.instruments[0], accs[0])
    for kind in ("transparent", "primarydirect", "primaryscattered",
                 "total"):
        assert sed_r[kind][0] > 0
        assert sed[kind][0] == pytest.approx(sed_r[kind][0], rel=1e-4), kind
    fr_r = np.asarray(accs_r[0]["frame"], np.float64)
    fr = accs[0]["frame"].numpy().astype(np.float64)
    assert np.abs(fr - fr_r).max() <= 1e-5 * np.abs(fr_r).max()
    rf_r = np.asarray(rf_r, np.float64)
    rf = rf.numpy().astype(np.float64)
    assert rf.shape == rf_r.shape == (ref_sim.grid.ncells, 1)
    np.testing.assert_allclose(rf, rf_r, rtol=1e-4, atol=1e-6 * rf_r.sum())


def _reference_imports(path: str) -> list[str]:
    """Modules of jax or the JAX package that a file imports, statically."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return [n for n in names if n.split(".")[0] in ("jax", "skirt9_tpu")]


def test_port_sources_import_no_reference():
    files = [os.path.join(REPO, "chip_smoke.py")]
    files += [os.path.join(REPO, "perf", n)
              for n in os.listdir(os.path.join(REPO, "perf"))
              if n.endswith(".py")]
    for root, _, names in os.walk(os.path.join(REPO, "skirt9_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    bad = {os.path.relpath(f, REPO): _reference_imports(f) for f in files}
    assert {os.path.join("skirt9_tpu_torch", *m.split("/")) for m in (
        "__main__.py", "config/ski.py", "probes/probes.py", "utils/units.py",
        "utils/filepaths.py", "utils/cosmology.py", "simulation.py",
        "bridge.py", "grids/octree.py", "grids/bintree.py",
        "transport/mlsweep.py", "transport/lifecycle.py",
        "transport/sweepxl.py", "parallel/domain.py",
        "sources/secondary.py", "tools/event_profile.py",
        "tools/kernel5_split.py", "ops/stokes.py",
        "geometries/vectorfield.py", "grids/voronoi.py",
        "transport/raster.py", "spectral/sedfamily.py",
        "imports/snapshots.py", "utils/storedtable.py",
        "transport/march.py", "grids/meshes.py", "grids/cartesian.py",
        "ops/xlamath.py", "emission/equilibrium.py",
        "geometries/analytic.py", "geometries/axial.py",
        "geometries/decorators.py", "grids/sphere.py", "grids/cylinder.py",
        "sources/base.py", "media/geometric.py", "grids/amr.py",
        "geometries/imported.py", "media/mixes.py",
        "media/system.py", "grids/polar.py", "grids/tetra.py")} <= set(bad)
    assert not {f: n for f, n in bad.items() if n}
