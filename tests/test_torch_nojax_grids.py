"""The port imports neither jax nor any module of the JAX package, and
launches no kernel on the CPU: the grids and the imports
(`nojax_runner`).

- config4: a tiny Voronoi grid on its raster (73^3, then 8 x 6 x 10) and
  bench4.ski's set-up through the CLI (the star particles, their SSP
  family and the imported Voronoi mesh);
- geometric_snapshots: a geometric source (an exponential disk and a
  flattened Sersic bulge) on the 2D cylinder march, the Ivezic shell's
  dust emission on the 1D sphere, and the reduced
  imported snapshots (an AMR galaxy on the tree sweep with dust emission
  and under a 3 3 3 root on the march, an SPH galaxy's octree);
- polar_tetra: the reduced configurations of the polar and unstructured
  grids (`chip_smoke.MESHES`): the AGN torus on the 2D sphere, the spiral
  galaxy on the 3D sphere and the 3D cylinder, the disk on a tetrahedral
  mesh of density-sampled sites on its raster and on the march, on a
  relaxed Voronoi mesh with dust emission, and the torus on the clumpy
  sphere.
"""

import pytest

import nojax_runner

GROUPS = {
    "config4": """
from skirt9_tpu_torch.grids.voronoi import build_voronoi
from skirt9_tpu_torch.transport import raster
rs = np.random.default_rng(4)
grid = build_voronoi(rs.uniform(-PC, PC, (40, 3)), ext, lookup_res=8)
nd = np.full(40, 1.0 / (1e-24 * PC), np.float32)
med = msys.make_medium(grid, nd, np.array([0.4e-6, 0.7e-6]),
                       sigma_ext=np.full((1, 2), 1e-24),
                       albedo=np.full((1, 2), 0.6), g=np.full((1, 2), 0.5))
sim = Simulation(grid=grid, medium=med, sources=[PointSource()],
                 instruments=[inst],
                 options=TransportOptions(max_steps=grid.max_steps(),
                                          max_events=3),
                 rf_borders=np.array([0.5e-6, 0.6e-6]), num_packets=256,
                 batch_size=128, device="cpu")
for n in ((73, 73, 73), (8, 6, 10)):
    assert isinstance(sim._sweep_tabs, MLTables) and sim._sweep_tabs.n == n
    rf, accs = sim.run_primary(verbose=False)
    assert rf.shape == (40, 1) and float(rf.sum()) > 0
    assert float(accs[0]["sed"][2].sum()) > 0
    sim._sweep_tabs = raster.build_tables(grid, med, resolution=(8, 6, 10))
with tempfile.TemporaryDirectory() as tmp:
    assert main(["tests/golden/bench4.ski", "--device", "cpu", "-e",
                 "-o", tmp]) == 0
""",
    "geometric_snapshots": """
from skirt9_tpu_torch.grids.amr import AMRGrid
with tempfile.TemporaryDirectory() as tmp:
    sim = load_ski(chip_smoke.geometric_ski("disk_cyl_small", tmp),
                   num_packets=128, batch_size=128, max_events=2,
                   device="cpu")
    rf, accs = sim.run_primary(verbose=False)
    assert float(rf.sum()) > 0 and float(accs[0]["sed"][1].sum()) > 0
    sim = load_ski(chip_smoke.geometric_ski("ivezic_dust_small", tmp),
                   num_packets=256, batch_size=256, max_events=2,
                   device="cpu")
    rf, accs, info = sim.run_with_dust_emission(verbose=False)
    assert info["L_dust"] > 0 and float(accs[0]["sed"][3].sum()) > 0
with tempfile.TemporaryDirectory() as tmp:
    for name in ("amr_galaxy_small", "amr_galaxy_march_small",
                 "sph_galaxy_small"):
        sim = chip_smoke.snapshot_config(name, "cpu", tmp, num_packets=128,
                                         batch_size=128, max_events=2)
        assert isinstance(sim.grid, AMRGrid) == name.startswith("amr")
        assert (sim._sweep_tabs is None) == ("march" in name)
        if sim.ems_borders is None:
            rf, accs = sim.run_primary(verbose=False)
        else:
            rf, accs, info = sim.run_with_dust_emission(verbose=False)
            assert info["L_dust"] > 0
        assert float(accs[0]["sed"][0].sum()) > 0
""",
    "polar_tetra": """
with tempfile.TemporaryDirectory() as tmp:
    for name in ("torus_sphere2d_small", "spiral_sphere3d_small",
                 "spiral_cylinder3d_small", "tetra_galaxy_small",
                 "tetra_galaxy_march_small", "voronoi_density_small",
                 "clumpy_torus_small"):
        sim = chip_smoke.mesh_config(name, "cpu", tmp, num_packets=128,
                                     batch_size=128, max_events=2)
        assert (sim._sweep_tabs is None) == ("sphere" in name or "cylinder"
                                             in name or "march" in name
                                             or "clumpy" in name)
        if sim.ems_borders is None:
            rf, accs = sim.run_primary(verbose=False)
        else:
            rf, accs, info = sim.run_with_dust_emission(verbose=False)
            assert info["L_dust"] > 0
        assert float(accs[0]["sed"][0].sum()) > 0
""",
}


@pytest.mark.parametrize("group", list(GROUPS))
def test_port_never_imports_jax(group):
    nojax_runner.run(GROUPS[group])
