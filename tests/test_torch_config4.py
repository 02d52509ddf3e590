"""Config 4 (bench4.ski: 40 imported SSP star particles, a 2,895-site
Voronoi mesh medium of MRN dust, a 25-bin RF and equilibrium dust
emission) through the port on the CPU.

- Loader: the port's `load_ski` of bench4.ski builds, array for array, what
  the reference's `load_ski` + `bridge.simulation` build: the Voronoi grid
  (sites, neighbours, lookup, volumes, boxes), the densities and optical
  tables, the particle source's launch tables and luminosity, the RF and
  emission borders, options, instruments and probes. What it does not port
  raises NotImplementedError naming itself.
- Raster (host only): the port's own 73^3 raster of bench4 equals the
  reference's `raster.build_tables`: the resolution, the owner map as the
  leaf map and the density of every voxel; one step per slab, shift 0.
- The slice: a reduced bench4 (8,192 packets in batches of 4,096, which
  the 32 lane groups round to one batch of 32,768 lanes a segment; 4
  events; at most 2 iterations, of which bench4 asks none) through
  `run_with_dust_emission` on both packages: the reference on its raster
  sweep in interpret mode (`SKIRT9_TPU_FORCE_SWEEP=1` and, for time,
  `SKIRT9_TPU_RASTER_MAX_N=24`: a 24^3 raster), the port on the plain
  versions of kernels 4-5 on its own raster at the reference's resolution
  (`bridge.simulation`), on the same random numbers. `iterations` equal;
  L_dust and L_abs_primary within 1e-5 relative; the RF, every SED kind,
  the frame and the statistics' power sums within 1e-5 of their largest
  values (they agree to ~5e-6), the detection counts within 1e-3 (a lane
  or two whose weight sits at the cutoff); the cells and temperature probe
  files against the reference's.
"""

import gzip
import os
import sys

import numpy as np
import pytest
import torch

from skirt9_tpu.config.ski import load_ski as ref_load_ski
from skirt9_tpu.probes import probes as ref_probes
from skirt9_tpu.transport import raster as ref_raster
from skirt9_tpu_torch import bridge
from skirt9_tpu_torch.config.ski import load_ski
from skirt9_tpu_torch.grids.voronoi import VoronoiGrid
from skirt9_tpu_torch.imports.snapshots import FamilyParticleSource
from skirt9_tpu_torch.kernels import build as kb
from skirt9_tpu_torch.transport import mlsweep as ml
from skirt9_tpu_torch.transport import raster

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden")
BENCH4 = os.path.join(GOLDEN, "bench4.ski")
sys.path.insert(0, os.path.dirname(HERE))
import chip_smoke  # noqa: E402

SMALL_RUN = dict(num_packets=8192, batch_size=4096, max_events=4)
PC = 3.0857e16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


@pytest.fixture(scope="module")
def reduced():
    """The reference's bench4 on its 24^3 raster and its run, the port's
    bridged Simulation and its run, the port's own load of bench4."""
    mp = pytest.MonkeyPatch()
    mp.setenv("SKIRT9_TPU_FORCE_SWEEP", "1")
    mp.setenv("SKIRT9_TPU_RASTER_MAX_N", "24")
    try:
        ref = ref_load_ski(BENCH4, **SMALL_RUN)
        ref.max_iterations = 2
        assert type(ref._sweep_tabs).__name__ == "MLTables"
        assert tuple(ref._sweep_tabs.n) == (24, 24, 24)
        bridged = bridge.simulation(ref, "cpu")
        out_r = ref.run_with_dust_emission(verbose=False)
    finally:
        mp.undo()
    kb.reset_launches()
    out_p = bridged.run_with_dust_emission(verbose=False)
    launches = dict(kb.LAUNCHES)
    own = load_ski(BENCH4, device="cpu", **SMALL_RUN)
    own.max_iterations = 2
    return ref, bridged, own, out_r, out_p, launches


def test_load_ski_matches_reference(reduced):
    ref, bridged, port, *_ = reduced
    assert isinstance(port.grid, VoronoiGrid)
    for f in VoronoiGrid._fields:
        a, b = getattr(port.grid, f), getattr(bridged.grid, f)
        assert (a == b) if f == "walk_steps" else torch.equal(a, b), f
    for f in ("nd", "lam_t", "sigma_ext", "sigma_sca", "g", "bulk_v",
              "temperature"):
        assert torch.equal(getattr(port.medium, f),
                           getattr(bridged.medium, f)), f
    assert port.medium.nd.shape == (2895, 1)
    np.testing.assert_array_equal(port.grid.volumes(), ref.grid.volumes())
    for f in ("rf_borders", "ems_borders"):
        assert np.array_equal(getattr(port, f), getattr(ref, f)), f
    (ps,), (rs,) = port.sources, ref.sources
    assert isinstance(ps, FamilyParticleSource)
    assert ps.luminosity == pytest.approx(rs.luminosity, rel=1e-12)
    assert ps.lam_range == rs.lam_range
    np.testing.assert_array_equal(ps.scales, rs.scales)
    np.testing.assert_array_equal(ps.params, rs.params)
    np.testing.assert_array_equal(ps.snapshot.positions, rs.snapshot.positions)
    tp, tr = port._src_tabs[0], ref._src_tabs[0]
    for k in set(tr) - {"v"}:
        assert np.array_equal(_np(tp[k]), np.asarray(tr[k])), k
    assert port.options == bridged.options
    assert port.options.max_steps == min(ref.grid.max_steps(), 256)
    assert port.instruments == bridged.instruments
    assert port.rf_scale == ref.rf_scale
    for f in ("num_packets", "batch_size", "seed", "source_bias",
              "spatial_bias", "iterate_secondary", "min_iterations",
              "max_fraction_of_primary", "max_fraction_of_previous",
              "dust_emission_type", "cmb_temperature"):
        assert getattr(port, f) == getattr(ref, f), f
    assert [(p.kind, p.name, p.when) for p in port.probes] == \
        [(p.kind, p.name, p.when) for p in ref.probes] == \
        [("cellprops", "cells", "Setup"), ("temperature", "T", "Run")]
    assert type(port.cosmology).__name__ == type(ref.cosmology).__name__
    # both packages take the same strata: 25 bins in 32 lane groups
    r = ref._strata_for(ref.sources[0], ref.options)
    p = port._strata_for(port.sources[0], port.options)
    assert np.array_equal(r[0], p[0]) and r[1] == p[1] and len(p[1]) == 32


def test_raster_matches_reference(reduced, monkeypatch):
    ref, _, port, *_ = reduced
    monkeypatch.delenv("SKIRT9_TPU_RASTER_MAX_N", raising=False)
    rt = ref_raster.build_tables(ref.grid, ref.medium)
    tabs = port._sweep_tabs
    assert isinstance(tabs, ml.MLTables)
    assert tabs.n == tuple(rt.n) == (73, 73, 73) and tabs.nmax == 73
    assert np.array_equal(_np(tabs.leafmap), np.asarray(rt.leafmap))
    assert tabs.lo == tuple(rt.lo) and tabs.h == tuple(rt.h)
    # the density of every voxel, from the reference's x-major slab table
    dens = _np(tabs.nd)[_np(tabs.leafmap), 0].reshape(73, 73 * 73)
    ref_dens = np.asarray(rt.rho[0])[0].reshape(73, -1)[:, :73 * 73]
    assert np.array_equal(dens, ref_dens)
    assert tabs.n_steps == 73 and not _np(tabs.step_gs).any()
    assert np.array_equal(_np(tabs.step_tlev), np.arange(73))
    assert len(tabs.levels) == 1 and tabs.levels[0].shift == (0, 0, 0)
    # the grid keeps its own locate: the raster's leaf map is not attached
    assert not hasattr(port.grid, "leafmap")
    frac = raster.boundary_fraction(_np(tabs.leafmap).reshape(73, 73, 73))
    assert frac == pytest.approx(ref_raster._boundary_fraction(
        np.asarray(rt.leafmap).reshape(73, 73, 73)))
    assert 0.3 < frac < 0.4


def test_config4_slice_draw_for_draw(reduced):
    ref, port, _, out_r, out_p, launches = reduced
    assert launches == {k: 0 for k in kb.LAUNCHES}
    assert port._sweep_tabs.n == (24, 24, 24)
    (rf_r, accs_r, info_r), (rf_p, accs_p, info_p) = out_r, out_p
    assert info_p["iterations"] == info_r["iterations"] == 0
    for k in ("L_dust", "L_abs_primary"):
        assert info_p[k] == pytest.approx(info_r[k], rel=1e-5), k
    rf_r = np.asarray(rf_r, np.float64)
    assert rf_r.shape == (2895, 25) and rf_r.max() > 0
    assert np.abs(_np(rf_p) - rf_r).max() <= 1e-5 * rf_r.max()
    for key in ("sed", "frame"):
        r = np.asarray(accs_r[0][key], np.float64)
        p = _np(accs_p[0][key]).astype(np.float64)
        assert r.shape == p.shape and r.shape[0] == 5
        for k in range(r.shape[0]):
            assert r[k].max() > 0, (key, k)
            assert np.abs(p[k] - r[k]).max() <= 1e-5 * np.abs(r[k]).max(), \
                (key, k)
    r = np.asarray(accs_r[0]["stats"], np.float64)
    p = _np(accs_p[0]["stats"]).astype(np.float64)
    assert np.abs(p[1] - r[1]).max() <= 1e-5 * np.abs(r[1]).max()
    assert np.abs(p[0] - r[0]).max() <= 1e-3 * r[0].max()
    assert [s[0] for s in port.last_stats["segments"]] == ["primary",
                                                           "secondary"]


def test_probe_files_match_reference(reduced, tmp_path):
    """The loader's probes (the bridge carries none) on the bridged
    Simulation, the temperature probe from the reference run's RF."""
    ref, port, own, out_r, _, _ = reduced
    (tmp_path / "r").mkdir()
    (tmp_path / "p").mkdir()
    ref_probes.run_probe_system(ref, "Setup", "b4", str(tmp_path / "r"))
    ref_probes.run_probe_system(ref, "Run", "b4", str(tmp_path / "r"),
                                rf=out_r[0])
    for spec in own.probes:
        spec.run(port, "b4", str(tmp_path / "p"),
                 rf=torch.tensor(np.asarray(out_r[0])))
    cells_r = np.loadtxt(tmp_path / "r" / "b4_cells_cellprops.dat")
    cells_p = np.loadtxt(tmp_path / "p" / "b4_cells_cellprops.dat")
    assert cells_p.shape == (2895, 5)
    assert np.array_equal(cells_p, cells_r)
    # the sites are the centres, the volumes the exact ones
    assert np.array_equal(cells_p[:, :3], _np(port.grid.sites))
    assert np.array_equal(cells_p[:, 3], port.grid.volumes())
    T_r = np.loadtxt(tmp_path / "r" / "b4_T_temperature.dat")
    T_p = np.loadtxt(tmp_path / "p" / "b4_T_temperature.dat")
    assert T_p.shape == T_r.shape == (2895, 4)
    np.testing.assert_allclose(T_p, T_r, rtol=1e-6)
    # SKIRT 9's cell-properties probe of the same tessellation: its cells
    # matched to the nearest site, as test_bench4_cell_volumes_match_
    # reference matches them, have the same volumes
    with gzip.open(os.path.join(GOLDEN, "bench4_cellprops.dat.gz"),
                   "rt") as f:
        golden = np.loadtxt(f)
    from scipy.spatial import cKDTree
    _, idx = cKDTree(cells_p[:, :3]).query(golden[:, 1:4] * PC)
    vr = cells_p[idx, 3] / (golden[:, 4] * PC ** 3)
    assert np.median(np.abs(vr - 1.0)) < 1e-3
    assert (np.abs(vr - 1.0) < 0.02).mean() > 0.99


@pytest.mark.parametrize("old,new,named", [
    ('<FileSSPSEDFamily filename="bench4_ssp.stab" '
     'hasIonizationParameter="false"/>', "<BruzualCharlotSEDFamily/>",
     "BruzualCharlotSEDFamily"),
    ('hasIonizationParameter="false"', 'hasIonizationParameter="true"',
     "hasIonizationParameter"),
    ("CubicSplineSmoothingKernel", "QuarticSplineSmoothingKernel",
     "QuarticSplineSmoothingKernel"),
    ('policy="ImportedMesh"', 'policy="DustDensity"', "DustDensity"),
    ('importVelocity="false" importVelocityDispersion',
     'importVelocity="true" importVelocityDispersion', "importVelocity"),
    ('importTemperature="false"', 'importTemperature="true"',
     "importTemperature"),
    ('useColumns="" sourceWeight', 'useColumns="x,y" sourceWeight',
     "useColumns"),
    ('massType="MassDensity"', 'massType="Mass"', "massType='Mass'"),
    ("</media>", '<VoronoiMeshMedium filename="bench4_gas.txt" minX="-1 pc" '
     'maxX="1 pc" minY="-1 pc" maxY="1 pc" minZ="-1 pc" maxZ="1 pc">'
     '<materialMix type="MaterialMix"><MeanFileDustMix '
     'filename="mrn_mean.txt"/></materialMix></VoronoiMeshMedium></media>',
     "mixing VoronoiMeshMedium"),
])
def test_unported_items_raise(tmp_path, old, new, named):
    edits = {old: new}
    if named == "importTemperature":
        # ported since: bench4's gas with a temperature column, the medium
        # held to the reference's loader below
        gas = np.loadtxt(os.path.join(GOLDEN, "bench4_gas.txt"))
        T = np.random.default_rng(3).uniform(1e3, 1e4, len(gas))
        np.savetxt(tmp_path / "gas_T.txt", np.column_stack([gas, T]))
        edits['filename="bench4_gas.txt"'] = 'filename="gas_T.txt"'
    path = chip_smoke.edited_ski("bench4", tmp_path, edits)
    if named in ("QuarticSplineSmoothingKernel", "importTemperature"):
        run = dict(num_packets=1024, batch_size=1024, max_events=2)
        ref = ref_load_ski(path, **run)
        port = load_ski(path, device="cpu", **run)
        conv = bridge.simulation(ref, "cpu")
        for f in ("nd", "temperature", "metallicity", "bulk_v"):
            assert torch.equal(getattr(port.medium, f),
                               getattr(conv.medium, f)), f
        if named == "importTemperature":
            assert float(port.medium.temperature.min()) >= 1e3
        (ps,), (rs,) = port.sources, ref.sources
        assert ps.kernel_kind == rs.kernel_kind == (
            "QuarticSplineSmoothingKernel" if named.startswith("Quartic")
            else "CubicSplineSmoothingKernel")
        tp, tr = ps.tables("cpu"), rs.tables()
        for k in set(tr) - {"v"}:
            assert np.array_equal(_np(tp[k]), np.asarray(tr[k])), k
        f_p = ps.launch(tp, *_keys_b4(2048, "port"))
        f_r = rs.launch(tr, *_keys_b4(2048, "ref"))
        for k in ("pos", "dir", "lam", "lum"):
            a, b = _np(f_p[k]).astype(np.float64), np.asarray(f_r[k],
                                                              np.float64)
            assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), k
        return
    with pytest.raises(NotImplementedError, match=named):
        load_ski(path, device="cpu")


def _keys_b4(n, side):
    """(launch keys, n) of n histories on one side."""
    if side == "ref":
        import jax
        import jax.numpy as jnp
        from skirt9_tpu.ops import rng as ref_rng
        return ref_rng.event_keys(ref_rng.history_keys(
            jax.random.PRNGKey(0), jnp.arange(n)), ref_rng.LAUNCH_EVENT), n
    from skirt9_tpu_torch.ops import rng
    return rng.event_keys(rng.history_keys(rng.seed_key(0, "cpu"),
                                           torch.arange(n)),
                          rng.LAUNCH_EVENT), n
