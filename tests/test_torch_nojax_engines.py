"""The port imports neither jax nor any module of the JAX package, and
launches no kernel on the CPU: the engines (`nojax_runner`).

- uniform_octree_raster: a uniform-grid and an octree simulation, the
  octree on its voxel raster through the XL contracts (and on the scan
  march where a batch of 128 lanes leaves those contracts);
- march: the scan march on a meshed Cartesian grid (bench1.ski with a
  SymPowMesh and explicit absorption) and on a tiny Voronoi grid walked
  exactly;
- config2_probes: a small config 2 with dust emission
  (`chip_smoke.config2`) on the resident sweep and on XL tables (a 4-bin
  RF in lane groups), the gather and row-lookup probes and the variant
  scripts of kernels 8-9 (`perf/`).
"""

import pytest

import nojax_runner

GROUPS = {
    "uniform_octree_raster": """
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
# the octree on its voxel raster (the XL contracts' tables put in place):
# a batch of 128 fails their 1,024-lane rows and marches the octree, a
# batch of 1,024 sweeps
from skirt9_tpu_torch.transport import march as mr
from skirt9_tpu_torch.transport import sweepxl as xl
sim._sweep_tabs = xl.build_tree_tables(sim.grid, sim.medium)
marched, plain = [], mr.march_geometry_plain
mr.march_geometry_plain = lambda *a: marched.append(a[0]) or plain(*a)
rf, accs = sim.run_primary(verbose=False)
assert marched and all(g is sim.grid for g in marched)
assert float(accs[0]["sed"].sum()) > 0 and float(rf.sum()) > 0
marched.clear()
sim.batch_size = 1024
rf, accs = sim.run_primary(verbose=False)
assert rf.shape == (octree.ncells, 1) and float(rf.sum()) > 0
assert not marched
mr.march_geometry_plain = plain
""",
    "march": """
from skirt9_tpu_torch.grids.cartesian import CartesianGrid
from skirt9_tpu_torch.grids.voronoi import build_voronoi
with tempfile.TemporaryDirectory() as tmp:
    path = chip_smoke.edited_ski("bench1", tmp, {
        '<LinMesh numBins="32"/>': '<SymPowMesh numBins="6" ratio="4"/>',
        'forceScattering="true"':
        'forceScattering="true" explicitAbsorption="true"'})
    sim = load_ski(path, num_packets=256, batch_size=128, max_events=3,
                   device="cpu")
    assert isinstance(sim.grid, CartesianGrid) and sim._sweep_tabs is None
    rf, accs = sim.run_primary(verbose=False)
    assert float(accs[0]["sed"][2].sum()) > 0
vgrid = build_voronoi(np.random.default_rng(4).uniform(-PC, PC, (40, 3)),
                      ext, lookup_res=8)
nd = np.full(40, 1.0 / (1e-24 * PC), np.float32)
vmed = msys.make_medium(vgrid, nd, np.array([0.4e-6, 0.7e-6]),
                        sigma_ext=np.full((1, 2), 1e-24),
                        albedo=np.full((1, 2), 0.6), g=np.full((1, 2), 0.5))
sim = Simulation(grid=vgrid, medium=vmed, sources=[PointSource()],
                 instruments=[inst],
                 options=TransportOptions(max_steps=vgrid.max_steps(),
                                          max_events=3,
                                          raster_fallback=False),
                 rf_borders=np.array([0.5e-6, 0.6e-6]), num_packets=256,
                 batch_size=128, device="cpu")
assert sim._sweep_tabs is None
rf, accs = sim.run_primary(verbose=False)
assert float(rf.sum()) > 0 and float(accs[0]["sed"][2].sum()) > 0
""",
    "config2_probes": """
from skirt9_tpu_torch.transport import sweepxl as xl
from skirt9_tpu_torch.tools import gather_probe, sublane_gather
from perf import kernel8_variants, kernel9_variants
sim = chip_smoke.config2("cpu", num_packets=4096, batch_size=4096, n=4,
                         n_rf=4, max_events=2, iterate_secondary=True,
                         max_iterations=1)
sim._sweep_tabs = xl.build_tables(sim.grid, sim.medium)
rf, accs, info = sim.run_with_dust_emission(verbose=False)
assert rf.shape == (64, 4) and float(rf.sum()) > 0 and info["L_dust"] > 0
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
""",
}


@pytest.mark.parametrize("group", list(GROUPS))
def test_port_never_imports_jax(group):
    nojax_runner.run(GROUPS[group])
