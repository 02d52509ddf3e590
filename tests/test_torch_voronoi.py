"""The port's Voronoi grid against the reference's, on the CPU.

bench4's 2,895 imported sites (tests/golden/bench4_gas.txt) in its +-1.2 pc
box, built by both packages' `build_voronoi`:

- the Delaunay neighbour table and the locate lookup are identical; the
  exact clipped volumes and the cells' boxes are identical too (the same
  host arithmetic), held to 1e-6 relative; `cell_bounds` and `volumes()`
  equal the reference's, `diagonal` bit for bit (the f32 box taken to f64
  first, so that rf_scale is the reference's);
- `locate` is identical on 10^4 points drawn with numpy from a seed, some
  outside the box, and `move_inside` on rays from outside it;
- on a tiny tessellation with a wall cell that Qhull's region leaves
  open, the halfspace clipping gives the reference's volumes;
- the rasterized sweep's gates: a Voronoi grid takes it with <= 4
  components and none of the options it lacks; a grid it cannot take
  (here `raster_fallback` off) has no sweep tables and is walked exactly by
  the scan march, draw for draw with the reference's march on the CPU
  (SEDs and frames within 1e-5 of each maximum; they agree to ~1e-7).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skirt9_tpu.grids import voronoi as ref_voronoi
from skirt9_tpu_torch.grids import voronoi
from skirt9_tpu_torch.instruments.distant import DistantInstrumentCfg
from skirt9_tpu_torch.media import system as msys
from skirt9_tpu_torch.simulation import Simulation
from skirt9_tpu_torch.sources.base import PointSource
from skirt9_tpu_torch.transport import lifecycle as lc
from skirt9_tpu_torch.transport import raster

PC = 3.0857e16
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
EXT = ((-1.2 * PC, 1.2 * PC),) * 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def grids():
    sites = np.loadtxt(os.path.join(GOLDEN, "bench4_gas.txt"))[:, :3] * PC
    return (voronoi.build_voronoi(sites, EXT),
            ref_voronoi.build_voronoi(sites, EXT))


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_build_matches_reference(grids):
    port, ref = grids
    assert port.ncells == ref.ncells == 2895
    assert port.walk_steps == ref.walk_steps
    for f in ("sites", "neighbors", "lookup", "box_lo", "box_hi"):
        a, b = _np(getattr(port, f)), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("cell_volumes", "aabb_lo", "aabb_hi"):
        a = _np(getattr(port, f)).astype(np.float64)
        b = np.asarray(getattr(ref, f), np.float64)
        scale = np.abs(b) if f == "cell_volumes" else 2.4 * PC
        assert np.all(np.abs(a - b) <= 1e-6 * scale), f
    assert np.all(_np(port.cell_volumes) > 0)
    np.testing.assert_allclose(port.volumes(), ref.volumes(), rtol=1e-6)
    for a, b in zip(port.cell_bounds(), ref.cell_bounds()):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * PC)
    lo, hi = port.cell_bounds()
    sites = _np(port.sites)
    assert np.all((lo <= sites) & (sites <= hi))
    # the volumes tile the box
    assert port.volumes().sum() == pytest.approx((2.4 * PC) ** 3, rel=1e-6)
    assert port.diagonal() == ref.diagonal()
    assert port.max_steps() == ref.max_steps()
    assert torch.equal(port.cell_centers(), port.sites)


def test_locate_matches_reference(grids):
    port, ref = grids
    rs = np.random.default_rng(5)
    pts = rs.uniform(-1.25 * PC, 1.25 * PC, (10_000, 3)).astype(np.float32)
    cp = port.locate(torch.tensor(pts))
    cr = np.asarray(ref.locate(jnp.asarray(pts)))
    assert cp.dtype == torch.int64
    assert np.array_equal(cp.numpy(), cr)
    out = np.any(np.abs(pts) >= 1.2 * PC, axis=1)
    assert out.any() and np.all(cr[out] == -1) and np.all(cr[~out] >= 0)
    # the nearest site, as a k-d tree finds it
    from scipy.spatial import cKDTree
    _, near = cKDTree(_np(port.sites).astype(np.float64)).query(
        pts[~out].astype(np.float64))
    assert (cp.numpy()[~out] == near).mean() > 0.999


def test_move_inside_matches_reference(grids):
    port, ref = grids
    rs = np.random.default_rng(6)
    pos = rs.uniform(-2.0 * PC, 2.0 * PC, (4096, 3)).astype(np.float32)
    d = rs.normal(size=(4096, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    d[:8, 1:] = 0.0                       # axis-parallel rays
    p_pos, p_cell, p_t = port.move_inside(torch.tensor(pos), torch.tensor(d))
    r_pos, r_cell, r_t = ref.move_inside(jnp.asarray(pos), jnp.asarray(d))
    # a ray parallel to a face that misses the box: an infinite entry
    # distance, NaN positions on both sides
    assert np.array_equal(p_pos.numpy(), np.asarray(r_pos), equal_nan=True)
    assert np.array_equal(p_cell.numpy(), np.asarray(r_cell))
    assert np.array_equal(p_t.numpy(), np.asarray(r_t))
    assert (p_cell >= 0).sum() > 500 and (p_cell < 0).sum() > 500


def test_small_tessellation_wall_cells():
    """Eight sites: every cell is a wall cell, clipped by halfspaces."""
    rs = np.random.default_rng(3)
    sites = rs.uniform(-1.0 * PC, 1.0 * PC, (8, 3))
    port = voronoi.build_voronoi(sites, EXT, lookup_res=8)
    ref = ref_voronoi.build_voronoi(sites, EXT, lookup_res=8)
    np.testing.assert_allclose(port.volumes(), ref.volumes(), rtol=1e-6)
    assert port.volumes().sum() == pytest.approx((2.4 * PC) ** 3, rel=1e-6)
    assert np.array_equal(port.neighbors.numpy(), np.asarray(ref.neighbors))


def _voronoi_sim(grid, **opts):
    nd = np.full(grid.ncells, 1.0 / (1e-24 * PC), np.float32)
    med = msys.make_medium(grid, nd, np.array([0.4e-6, 0.7e-6]),
                           sigma_ext=np.full((1, 2), 1e-24),
                           albedo=np.full((1, 2), 0.6), g=np.full((1, 2), 0.5))
    inst = DistantInstrumentCfg(name="i0", wave_borders=(0.5e-6, 0.6e-6),
                                distance=100 * PC, npx=8, npy=8, fovx=4 * PC,
                                fovy=4 * PC)
    return Simulation(grid=grid, medium=med, sources=[PointSource()],
                      instruments=[inst],
                      options=lc.TransportOptions(
                          max_steps=grid.max_steps(), max_events=2, **opts),
                      rf_borders=np.array([0.5e-6, 0.6e-6]), num_packets=64,
                      batch_size=64, device="cpu")


def test_raster_gates():
    rs = np.random.default_rng(4)
    grid = voronoi.build_voronoi(rs.uniform(-PC, PC, (40, 3)), EXT,
                                 lookup_res=8)
    sim = _voronoi_sim(grid)
    assert raster.supports(grid, sim.medium, sim.options)
    assert sim._sweep_tabs.n == (73, 73, 73)
    assert sim.grid.diagonal() == pytest.approx(np.sqrt(3) * 2.4 * PC)
    for name in ("kinematics", "explicit_absorption", "raster_fallback"):
        bad = dataclasses.replace(sim.options,
                                  **{name: name != "raster_fallback"})
        assert not raster.supports(grid, sim.medium, bad), name
    five = sim.medium._replace(nd=sim.medium.nd.repeat(1, 5),
                               sigma_ext=sim.medium.sigma_ext.repeat(5, 1))
    assert not raster.supports(grid, five, sim.options)
    walk = _voronoi_sim(grid, raster_fallback=False)
    assert walk._sweep_tabs is None
    # the exact walk against the reference's march on the same sites
    from skirt9_tpu.instruments.distant import DistantInstrumentCfg as RefCfg
    from skirt9_tpu.media import system as ref_msys
    from skirt9_tpu.simulation import Simulation as RefSimulation
    from skirt9_tpu.sources.base import PointSource as RefPointSource
    from skirt9_tpu.transport import lifecycle as ref_lc
    from skirt9_tpu_torch import bridge
    ref_grid = ref_voronoi.build_voronoi(
        np.random.default_rng(4).uniform(-PC, PC, (40, 3)), EXT,
        lookup_res=8)
    med = ref_msys.make_medium(ref_grid, np.full(40, 1.0 / (1e-24 * PC)),
                               np.array([0.4e-6, 0.7e-6]),
                               sigma_ext=np.full((1, 2), 1e-24),
                               albedo=np.full((1, 2), 0.6),
                               g=np.full((1, 2), 0.5))
    ref = RefSimulation(
        grid=ref_grid, medium=med, sources=[RefPointSource()],
        instruments=[RefCfg(name="i0", wave_borders=(0.5e-6, 0.6e-6),
                            distance=100 * PC, npx=8, npy=8, fovx=4 * PC,
                            fovy=4 * PC)],
        options=ref_lc.TransportOptions(max_steps=ref_grid.max_steps(),
                                        max_events=4, raster_fallback=False),
        rf_borders=np.array([0.5e-6, 0.6e-6]), num_packets=512,
        batch_size=512)
    port = bridge.simulation(ref, "cpu")
    assert port._sweep_tabs is None
    rf_r, accs_r = ref.run_primary(verbose=False)
    rf_p, accs_p = port.run_primary(verbose=False)
    for a, b in ((rf_r, rf_p), (accs_r[0]["sed"], accs_p[0]["sed"]),
                 (accs_r[0]["frame"], accs_p[0]["frame"])):
        a = np.asarray(a, np.float64)
        assert np.abs(a).max() > 0
        assert np.abs(b.double().numpy() - a).max() <= 1e-5 * np.abs(a).max()
