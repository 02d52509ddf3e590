"""The tetrahedral grid, the unstructured grids' site policies and their
configurations against the reference, on the CPU with one torch thread.

- `build_tetra` from 300 sites table for table the reference's (the f64
  face planes cast to f32, Qhull's neighbours, the lookup, volumes,
  centroids); `locate` and `move_inside` bit for bit against the
  reference's inside `jax.jit` and its eager `locate` (its raster's owner
  map), and every step of a march against the reference's jitted march
  (`march_geometry`), cells identical and lengths bit for bit; the volumes
  tile the box to 1e-6 (the reference's `tests/test_tetra.py:20`).
- The tetrahedral raster: its owner map equal to the reference's (its
  own `locate`, chunked), and kernel 4's plain version on it against the
  reference's interpret-mode sweep on the same raster
  (`SKIRT9_TPU_FORCE_SWEEP=1`), as `tests/test_torch_config4.py` holds the
  Voronoi raster.
- `density_sites` and `lloyd_relax` array for array against the
  reference's, on a density function and on a geometry whose `density_np`
  is bit for bit the reference's.
- The loader's standalone `TetraMeshSpatialGrid` and
  `VoronoiMeshSpatialGrid` (DustDensity and Uniform sites, relaxed or not)
  on the spiral disk array for array against the reference's `load_ski` +
  `bridge.py` (the spiral disk's density is the reference's bit for bit on
  the candidates, so the density-sampled sites are too).
- Reduced tetra_galaxy on its raster and on the march draw for draw
  against the reference within 1e-5 of each maximum.
- DustEmission on a tetrahedral grid raises, naming itself, as do its cell
  bounds and planar cuts (the reference's fail on them).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skirt9_tpu.config.ski import load_ski as ref_load_ski
from skirt9_tpu.geometries import analytic as r_ga
from skirt9_tpu.grids import tetra as rt
from skirt9_tpu.grids import voronoi as rv
from skirt9_tpu.transport import lifecycle as ref_lc
from skirt9_tpu.transport import mlsweep as ref_ml
from skirt9_tpu.transport import raster as ref_raster
from skirt9_tpu_torch import bridge
from skirt9_tpu_torch.config.ski import load_ski
from skirt9_tpu_torch.geometries import analytic as ga
from skirt9_tpu_torch.grids import tetra as pt
from skirt9_tpu_torch.grids import voronoi as pv
from skirt9_tpu_torch.kernels import build as kb
from skirt9_tpu_torch.probes import probes
from skirt9_tpu_torch.sources import secondary as sec
from skirt9_tpu_torch.transport import march as mr
from skirt9_tpu_torch.transport import mlsweep as ml
from skirt9_tpu_torch.transport import raster

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

PC = 3.0857e16
EXACT = 1e-5
EXT = ((-PC, PC),) * 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def grids():
    sites = np.random.default_rng(4).uniform(-PC, PC, (300, 3))
    return (rt.build_tetra(sites, EXT, lookup_res=16),
            pt.build_tetra(sites, EXT, lookup_res=16))


def _rays(B=4096, seed=5, reach=2.5):
    rs = np.random.default_rng(seed)
    d = rs.normal(size=(B, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    p = rs.uniform(-1, 1, (B, 3)) * PC
    p[:B // 3] *= reach        # a third from outside the box
    return p.astype(np.float32), d.astype(np.float32)


def test_build_matches_reference(grids):
    rg, pg = grids
    for f in pt.TetraGrid._fields:
        a, b = getattr(rg, f), getattr(pg, f)
        if f == "walk_steps":
            assert a == b
        else:
            assert np.array_equal(np.asarray(a), b.numpy()), f
    np.testing.assert_array_equal(pg.volumes(), rg.volumes())
    assert pg.volumes().sum() == pytest.approx(8 * PC ** 3, rel=1e-6)
    assert (pg.volumes() > 0).all()
    assert pg.max_steps() == rg.max_steps()
    assert pg.diagonal() == rg.diagonal()


def test_grid_bit_for_bit(grids):
    rg, pg = grids
    p, d = _rays()
    P, D = torch.tensor(p), torch.tensor(d)
    loc = pg.locate(P).numpy()
    assert np.array_equal(np.asarray(jax.jit(lambda x: rg.locate(x))(p)), loc)
    assert np.array_equal(np.asarray(rg.locate(jnp.asarray(p))), loc)
    mi_r = jax.jit(lambda x, y: rg.move_inside(x, y))(p, d)
    mi_p = pg.move_inside(P, D)
    for a, b in zip(mi_r, mi_p):
        assert np.array_equal(np.asarray(a), b.numpy().astype(
            np.asarray(a).dtype))
    S = min(rg.max_steps(), 256)
    cr = np.asarray(mi_r[1])
    cells_r, ds_r = (np.asarray(a) for a in jax.jit(
        lambda a, b, c, m: ref_lc.march_geometry(rg, a, b, c, S, m))(
            np.asarray(mi_r[0]), d, cr, cr >= 0))
    cells_p, ds_p = mr.march_geometry_plain(pg, mi_p[0], D, mi_p[1], S,
                                            torch.tensor(cr >= 0))
    walked = ds_r > 0
    assert np.array_equal(ds_r, ds_p.numpy())
    assert np.array_equal(cells_r[walked], cells_p.numpy()[walked])
    assert walked.sum() > 4 * len(p)


def test_raster_matches_reference(grids, monkeypatch):
    """The tetrahedral raster's owner map and kernel 4's plain version on
    it against the reference's interpret-mode sweep on its own raster."""
    from skirt9_tpu.media import system as ref_msys
    rg, pg = grids
    nd = np.random.default_rng(6).uniform(0.1, 1.0, rg.ncells) / (1e-24 * PC)
    kw = dict(sigma_ext=np.full((1, 2), 1e-24), albedo=np.full((1, 2), 0.6),
              g=np.full((1, 2), 0.5))
    lam = np.array([0.4e-6, 0.7e-6])
    rmed = ref_msys.make_medium(rg, nd.astype(np.float32), lam, **kw)
    monkeypatch.setenv("SKIRT9_TPU_FORCE_SWEEP", "1")
    rtabs = ref_raster.build_tables(rg, rmed, resolution=(20, 16, 24))
    med = bridge.medium(rmed)
    tabs = raster.build_tables(pg, med, resolution=(20, 16, 24))
    assert np.array_equal(tabs.leafmap.numpy(), np.asarray(rtabs.leafmap))
    assert (tabs.leafmap.numpy() >= 0).all()
    p, d = _rays(512, seed=8, reach=1.0)
    p = p * np.float32(0.95)
    sig = np.full((1, 512), 1e-24, np.float32)
    active = np.ones(512, bool)
    tau_r = np.asarray(ref_ml.sweep_dtau(
        rtabs, jnp.asarray(p), jnp.asarray(d), jnp.asarray(sig),
        jnp.asarray(active)), np.float64).sum(axis=0)
    tau = ml.sweep_dtau(tabs, torch.tensor(p), torch.tensor(d),
                        torch.tensor(sig), torch.tensor(active)
                        ).sum(dim=0).double().numpy()
    assert (tau_r > 0.01).sum() > 400
    np.testing.assert_allclose(tau, tau_r, rtol=2e-4, atol=1e-5)


def test_site_policies_match_reference():
    rs = np.random.default_rng(2)
    fn = lambda p: np.exp(-np.sum((p / PC) ** 2, axis=-1))
    a = rv.density_sites(fn, EXT, 500, seed=3)
    b = pv.density_sites(fn, EXT, 500, seed=3)
    assert np.array_equal(a, b)
    geom_r, geom_p = r_ga.PlummerGeometry(b=0.3 * PC), \
        ga.PlummerGeometry(b=0.3 * PC)
    pts = rs.uniform(-PC, PC, (4096, 3))
    assert np.array_equal(geom_r.density_np(pts), geom_p.density_np(pts))
    a = rv.density_sites(geom_r.density_np, EXT, 400, seed=3)
    b = pv.density_sites(geom_p.density_np, EXT, 400, seed=3)
    assert np.array_equal(a, b)
    assert np.array_equal(rv.lloyd_relax(a, EXT, samples=20_000),
                          pv.lloyd_relax(b, EXT, samples=20_000))


RUN = dict(num_packets=1024, batch_size=1024, max_events=4)


def _site_ski(tmp_path, grid, policy, relax):
    """tetra_galaxy_small with the grid element's type, policy and
    relaxation replaced."""
    path = chip_smoke.mesh_ski("tetra_galaxy_small", tmp_path)
    text = open(path).read().replace(
        'TetraMeshSpatialGrid', grid).replace(
        'policy="DustDensity"', f'policy="{policy}"').replace(
        'relaxSites="false"', f'relaxSites="{str(relax).lower()}"')
    out = os.path.join(str(tmp_path), f"{grid}_{policy}_{relax}.ski")
    open(out, "w").write(text)
    return out


@pytest.mark.parametrize("grid, policy, relax", [
    ("TetraMeshSpatialGrid", "DustDensity", False),
    ("TetraMeshSpatialGrid", "Uniform", False),
    ("VoronoiMeshSpatialGrid", "DustDensity", True),
    ("VoronoiMeshSpatialGrid", "Uniform", False)])
def test_loader_matches_reference(grid, policy, relax, tmp_path):
    path = _site_ski(tmp_path, grid, policy, relax)
    ref = ref_load_ski(path, **RUN)
    port = load_ski(path, device="cpu", **RUN)
    conv = bridge.simulation(ref, "cpu")
    assert type(port.grid) is type(conv.grid)
    assert type(port.grid).__name__ == type(ref.grid).__name__
    for a, b in zip(port.grid, conv.grid):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b
    assert torch.equal(port.medium.nd, conv.medium.nd)
    assert port.options == conv.options
    assert port.options.max_steps == min(ref.grid.max_steps(), 256)
    for c, d in zip(port.instruments, conv.instruments):
        assert c == d


@pytest.mark.parametrize("name", ["tetra_galaxy_small",
                                  "tetra_galaxy_march_small"])
def test_draw_for_draw(name, tmp_path, monkeypatch):
    march = "march" in name
    monkeypatch.setenv("SKIRT9_TPU_FORCE_SWEEP", "1")
    monkeypatch.setenv("SKIRT9_TPU_RASTER_MAX_N", "24")
    ref = ref_load_ski(chip_smoke.mesh_ski(name, tmp_path), **RUN)
    if march:
        import dataclasses
        ref = dataclasses.replace(ref, options=dataclasses.replace(
            ref.options, raster_fallback=False))
        assert ref._sweep_tabs is None
    else:
        assert type(ref._sweep_tabs).__name__ == "MLTables"
    port = bridge.simulation(ref, "cpu", march=march)
    assert (port._sweep_tabs is None) == march
    out_r = ref.run_primary(verbose=False)
    kb.reset_launches()
    out_p = port.run_primary(verbose=False)
    assert kb.LAUNCHES == {k: 0 for k in kb.LAUNCHES}
    gaps = {}
    pairs = [("rf", out_r[0], out_p[0])]
    for k in ("sed", "frame"):
        for kind in range(np.asarray(out_r[1][0][k]).shape[0]):
            pairs.append((f"{k}{kind}", out_r[1][0][k][kind],
                          out_p[1][0][k][kind]))
    for key, a, b in pairs:
        a = np.asarray(a, np.float64)
        m = np.abs(a).max()
        gaps[key] = 0.0 if m == 0 else float(np.abs(
            a - b.double().numpy()).max() / m)
    assert max(gaps.values()) <= EXACT, gaps


def test_dust_emission_raises(tmp_path):
    path = chip_smoke.mesh_ski("tetra_galaxy_small", tmp_path)
    sim = load_ski(path, device="cpu", num_packets=128)
    assert isinstance(sim.grid, pt.TetraGrid)
    with pytest.raises(NotImplementedError, match="DustEmission on a "):
        sec.cell_bounds(sim.grid)
    with pytest.raises(NotImplementedError, match="planar cuts of a "):
        probes.planar_cut_form(str(tmp_path / "cut.fits"), sim.grid,
                               lambda p: p[:, 0])
    text = open(path).read()
    open(path, "w").write(text.replace('simulationMode="ExtinctionOnly"',
                                       'simulationMode="DustEmission"'))
    with pytest.raises(NotImplementedError,
                       match="DustEmission on a TetraMeshSpatialGrid"):
        load_ski(path, device="cpu", num_packets=128)
