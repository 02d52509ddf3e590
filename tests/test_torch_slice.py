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

The port imports neither jax nor any module of the JAX package: a
subprocess runs a uniform-grid and an octree simulation, the octree on
its voxel raster through the XL contracts, a small config 2 with dust
emission (`chip_smoke.config2`) on the resident sweep and on XL tables
(a 4-bin RF in lane groups), the gather and row-lookup probes, a reduced config 3 (bench3.ski at maxLevel 4 with a 4-bin RF
through the loader, with and without merged iterations) and the CLI
(bench1.ski, and bench2.ski's set-up), imports the variant scripts of
kernels 8-9 (`perf/`), and then finds no such module loaded and no kernel
launched;
an `ast` scan of the package (the loader, probes, CLI, unit copies, trees,
tree and XL sweeps, voxel rasters and event loop among it), chip_smoke.py and `perf/*.py` finds
no such import.
"""

import ast
import dataclasses
import os
import subprocess
import sys

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


def _port_config1(n: int):
    """Config 1 with a one-bin RF on an n^3 grid, through the port's API."""
    grid = port_cartesian(((-1.2 * PC, 1.2 * PC),) * 3, (n,) * 3)
    nd = msys.uniform_density_sphere(grid, 1.0, 1e-24, PC)
    med = msys.make_medium(grid, nd, np.array([0.4e-6, 0.7e-6]),
                           sigma_ext=np.full((1, 2), 1e-24),
                           albedo=np.full((1, 2), 0.6), g=np.full((1, 2), 0.5))
    inst = dinst.DistantInstrumentCfg(
        name="i0", wave_borders=(0.5e-6, 0.6e-6), distance=100 * PC,
        npx=16, npy=16, fovx=4 * PC, fovy=4 * PC)
    return Simulation(grid=grid, medium=med,
                      sources=[PointSource(luminosity=1.0, lam0=0.55e-6)],
                      instruments=[inst],
                      options=lc.TransportOptions(max_steps=grid.max_steps(),
                                                  max_events=8),
                      rf_borders=np.array([0.5e-6, 0.6e-6]),
                      num_packets=2048, batch_size=1024, seed=0,
                      device="cpu")


def test_xl_engine_at_80_matches_resident():
    runs = []
    for engine in ("xl", "resident"):
        sim = _port_config1(80)
        assert isinstance(sim._sweep_tabs, xl.XLTables)
        if engine == "resident":
            sim._sweep_tabs = sw.build_tables(sim.grid, sim.medium)
        kb.reset_launches()
        runs.append(sim.run_primary(verbose=False))
        assert all(v == 0 for v in kb.LAUNCHES.values())
    (rf_x, accs_x), (rf_s, accs_s) = runs
    sed_x = dinst.calibrate_sed(sim.instruments[0], accs_x[0])
    sed_s = dinst.calibrate_sed(sim.instruments[0], accs_s[0])
    for kind in ("transparent", "primarydirect", "primaryscattered", "total"):
        assert sed_s[kind][0] > 0
        assert abs(sed_x[kind][0] - sed_s[kind][0]) <= 1e-4 * sed_s[kind][0]
    fx, fs = accs_x[0]["frame"].double(), accs_s[0]["frame"].double()
    assert float((fx - fs).abs().max()) <= 1e-3 * float(fs.abs().max())
    tx, ts = float(rf_x.double().sum()), float(rf_s.double().sum())
    assert ts > 0 and abs(tx - ts) <= 1e-4 * ts


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
    ref_sim = config1[0]
    for name in ("polarization", "kinematics", "explicit_absorption"):
        bad = dataclasses.replace(ref_sim.options, **{name: True})
        with pytest.raises(NotImplementedError, match=name):
            dataclasses.replace(config1[1], options=bridge.options(bad))


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


_NO_JAX = """
import sys
import numpy as np
from skirt9_tpu_torch.grids.cartesian import make_cartesian
from skirt9_tpu_torch.grids.octree import build_octree
from skirt9_tpu_torch.instruments.distant import DistantInstrumentCfg
from skirt9_tpu_torch.media import system as msys
from skirt9_tpu_torch.simulation import Simulation
from skirt9_tpu_torch.sources.base import PointSource
from skirt9_tpu_torch.transport.lifecycle import TransportOptions
from skirt9_tpu_torch.transport.mlsweep import MLTables
PC = 3.0857e16
ext = ((-1.2 * PC, 1.2 * PC),) * 3
inst = DistantInstrumentCfg(name="i0", wave_borders=(0.5e-6, 0.6e-6),
                            distance=100 * PC, npx=8, npy=8, fovx=4 * PC,
                            fovy=4 * PC)
octree = build_octree(ext, lambda p: np.exp(-np.sum((p / PC) ** 2, axis=-1)),
                      max_level=3, min_level=1, max_fraction=0.05)
for grid in (make_cartesian(ext, (6,) * 3), octree):
    nd = msys.uniform_density_sphere(grid, 1.0, 1e-24, PC)
    med = msys.make_medium(grid, nd, np.array([0.4e-6, 0.7e-6]),
                           sigma_ext=np.full((1, 2), 1e-24),
                           albedo=np.full((1, 2), 0.6), g=np.full((1, 2), 0.5))
    sim = Simulation(grid=grid, medium=med, sources=[PointSource()],
                     instruments=[inst],
                     options=TransportOptions(max_steps=grid.max_steps(),
                                              max_events=4),
                     rf_borders=np.array([0.5e-6, 0.6e-6]),
                     num_packets=256, batch_size=128, device="cpu")
    rf, accs = sim.run_primary(verbose=False)
    assert float(accs[0]["sed"].sum()) > 0 and float(rf.sum()) > 0
assert isinstance(sim._sweep_tabs, MLTables)
# the octree on its voxel raster (the XL contracts' tables put in place)
from skirt9_tpu_torch.transport import sweepxl as xl
sim._sweep_tabs = xl.build_tree_tables(sim.grid, sim.medium)
rf, accs = sim.run_primary(verbose=False)
assert rf.shape == (octree.ncells, 1) and float(rf.sum()) > 0
# config 2 (dust emission, a stratified 4-bin RF, one self-absorption
# iteration) through chip_smoke.config2, on the resident sweep and on XL
# tables, and the probes
import chip_smoke
sim = chip_smoke.config2("cpu", num_packets=4096, batch_size=4096, n=4,
                         n_rf=4, max_events=2, iterate_secondary=True,
                         max_iterations=1)
sim._sweep_tabs = xl.build_tables(sim.grid, sim.medium)
rf, accs, info = sim.run_with_dust_emission(verbose=False)
assert rf.shape == (64, 4) and float(rf.sum()) > 0 and info["L_dust"] > 0
from skirt9_tpu_torch.kernels import build as kb
from skirt9_tpu_torch.tools import gather_probe, sublane_gather
from perf import kernel8_variants, kernel9_variants
sim = chip_smoke.config2("cpu", num_packets=512, batch_size=128, n=4, n_rf=4,
                         max_events=2, iterate_secondary=True,
                         max_iterations=1)
rf, accs, info = sim.run_with_dust_emission(verbose=False)
assert rf.shape == (64, 4) and float(rf.sum()) > 0 and info["L_dust"] > 0
assert float(accs[0]["sed"][3].sum()) > 0     # secondary direct flux
nd, idx, vals = gather_probe.inputs("cpu", n=64, b=256)
assert float(gather_probe.scatter(idx, vals, 64).sum()) == 256.0
tab, ix = sublane_gather.inputs("cpu", r=8, s=2)
assert sublane_gather.lookup(tab, ix, iters=3, select=True).shape == (2, 128)
# the reduced config 3 (an octree from bench3.ski through the loader, its
# RF cut to 4 bins in lane groups, one self-absorption iteration), and its
# merged iterations
import os, tempfile
with tempfile.TemporaryDirectory() as tmp:
    path = chip_smoke.edited_ski("bench3", tmp, dict(
        chip_smoke.B3_SMALL, **{'numWavelengths="25"': 'numWavelengths="4"'}))
    for merged in (False, True):
        sim = chip_smoke.config3("cpu", num_packets=1024, batch_size=1024,
                                 max_events=2, path=path)
        sim.max_iterations, sim.include_primary = 1, merged
        rf, accs, info = sim.run_with_dust_emission(verbose=False)
        assert rf.shape == (2122, 4) and float(rf.sum()) > 0
        assert info["iterations"] == 1 and info["L_dust"] > 0
        assert float(accs[0]["sed"][3].sum()) > 0
# the CLI: bench1 through the ski loader, bench2's set-up with its probes
from skirt9_tpu_torch.__main__ import main
with tempfile.TemporaryDirectory() as tmp:
    assert main(["tests/golden/bench1.ski", "--device", "cpu", "-p", "256",
                 "-b", "128", "-o", tmp]) == 0
    assert main(["tests/golden/bench2.ski", "--device", "cpu", "-e",
                 "-o", tmp]) == 0
    assert sorted(os.listdir(tmp)) == ["bench1_i0_sed.dat",
                                       "bench1_i0_total.fits",
                                       "bench1_log.txt", "bench2_log.txt"]
assert kb.LAUNCHES == {k: 0 for k in kb.LAUNCHES}, kb.LAUNCHES
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
ref = sorted(m for m in sys.modules
             if m == "skirt9_tpu" or m.startswith("skirt9_tpu."))
assert not ref, ref
print("ok")
"""


def test_port_never_imports_jax():
    path = [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
        os.pathsep) if p]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(path))
    res = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


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
        "tools/kernel5_split.py")} <= set(bad)
    assert not {f: n for f, n in bad.items() if n}
