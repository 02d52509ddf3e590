"""The port's SED family, star-particle source and stored-table reader
against the reference's, on the CPU.

bench4's FileSSPSEDFamily (tests/golden/bench4_ssp.stab: 160 wavelengths
by 3 metallicities by 5 ages) clipped to bench4's source range, and its
40 star particles (tests/golden/bench4_stars.txt), built by both packages:

- `read_stored_table` returns the reference's axes and values, array-equal;
- the family's node arrays, cdfs and log spectra, the entity luminosities
  and the corner tables within 1e-6 relative (bit for bit expected: the
  same host arithmetic);
- from the same launch keys: the corner node each lane picks and the
  family bin each sampled wavelength falls in are identical (the same
  discrete outcomes), wavelengths and stratified weights within 1e-5
  relative to their maxima, and the importance weight exp(sum w ln L) /
  L_lin within 1e-5 (it may differ by f32 rounding);
- `FamilyParticleSource.launch` at 8,192 lanes, plain and stratified over
  32 strata: position, direction, wavelength and weight each within 1e-5
  of its maximum;
- the cubic-spline radius sampler and the column-file import equal the
  reference's; four snapshot names that raised before the module was
  ported whole are held to the reference's.
"""

import os
import xml.etree.ElementTree as ET

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skirt9_tpu.config.ski import build_particle_source as ref_particle_source
from skirt9_tpu.imports import snapshots as ref_snap
from skirt9_tpu.ops import rng as ref_rng
from skirt9_tpu.utils.storedtable import read_stored_table as ref_read
from skirt9_tpu_torch.config.ski import build_particle_source
from skirt9_tpu_torch.imports import snapshots as snap
from skirt9_tpu_torch.ops import rng
from skirt9_tpu_torch.utils.storedtable import read_stored_table

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden")
RANGE = (0.09e-6, 100e-6)           # bench4's source range
B = 8192


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sources():
    el = ET.parse(os.path.join(GOLDEN, "bench4.ski")).getroot().find(
        ".//ParticleSource")
    port = build_particle_source(el, GOLDEN, RANGE)
    ref = ref_particle_source(el, GOLDEN, RANGE)
    return port, ref, port.tables("cpu"), ref.tables()


def _keys(seed):
    """The same launch keys (B, 2) on both sides."""
    rk = ref_rng.event_keys(ref_rng.history_keys(
        jax.random.PRNGKey(seed), jnp.arange(B, dtype=jnp.int32)),
        ref_rng.LAUNCH_EVENT)
    pk = rng.event_keys(rng.history_keys(rng.seed_key(seed, "cpu"),
                                         torch.arange(B)), rng.LAUNCH_EVENT)
    assert np.array_equal(pk.numpy(), np.asarray(rk, np.int64))
    return rk, pk


def _close(p, r, tol, what):
    p = (p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)).astype(
        np.float64)
    r = np.asarray(r, np.float64)
    assert p.shape == r.shape, what
    assert np.abs(p - r).max() <= tol * np.abs(r).max(), what


def test_read_stored_table_matches_reference():
    path = os.path.join(GOLDEN, "bench4_ssp.stab")
    port, ref = read_stored_table(path), ref_read(path)
    for f in ("axes_names", "axes_units", "axes_scales", "quantity_names",
              "quantity_units", "quantity_scales"):
        assert getattr(port, f) == getattr(ref, f), f
    for a, b in zip(port.axes_points, ref.axes_points):
        assert np.array_equal(a, b)
    assert np.array_equal(port.values, ref.values)
    assert port.axes_names == ["lambda", "Z", "t"]


def test_family_tables_match_reference(sources):
    port, ref, pt, rt = sources
    pf, rf = port.family_tables, ref.family_tables
    assert pf.lam_range == rf.lam_range == RANGE
    for f in ("lam_np", "L_np", "Ltot_np"):
        np.testing.assert_allclose(getattr(pf, f), getattr(rf, f),
                                   rtol=1e-6, atol=0)
    lam, cdf, logL = pf._tensors("cpu")
    for a, b in ((lam, rf.lam), (cdf, rf.cdf), (logL, rf.logL)):
        _close(a, b, 1e-6, "device tables")
    assert np.array_equal(pf.family.L, rf.family.L)
    params = np.asarray(ref.params)
    np.testing.assert_allclose(
        pf.family.specific_luminosity_geometric(params),
        rf.family.specific_luminosity_geometric(params), rtol=1e-12)
    np.testing.assert_allclose(
        pf.entity_luminosities(port.scales, params),
        rf.entity_luminosities(np.asarray(ref.scales), params), rtol=1e-6)
    for a, b in zip(pf.corner_tables(params, "cpu"),
                    rf.corner_tables(params)):
        _close(a, b, 1e-6, "corner tables")
    assert port.luminosity == pytest.approx(ref.luminosity, rel=1e-12)
    assert 0.9e8 < port.luminosity / 3.846e26 < 1.2e8
    # the port's tables carry the kernel's radius cdf and no velocities
    # (particles with velocities are not ported)
    assert set(pt) == set(rt) - {"v"} | {"kq", "kc"}
    assert not np.asarray(rt["v"]).any()
    for k in set(rt) - {"v"}:
        _close(pt[k], rt[k], 1e-6, k)


def _ref_node(rt, entity, u_c):
    """The reference's corner pick, its compare-reduce on its tables."""
    ccdf = rt["corner_cdf"][entity]
    c = jnp.clip(jnp.sum((ccdf < u_c[:, None]).astype(jnp.int32), axis=1),
                 0, ccdf.shape[1] - 1)
    return np.asarray(jnp.take_along_axis(rt["corner_idx"][entity],
                                          c[:, None], axis=1)[:, 0])


def _bins(lam_table, lam):
    return np.searchsorted(np.asarray(lam_table, np.float64),
                           np.asarray(lam, np.float64), side="right")


def test_sampling_matches_reference(sources):
    port, ref, pt, rt = sources
    pf, rf = port.family_tables, ref.family_tables
    rk, pk = _keys(3)
    ent = np.random.default_rng(1).integers(0, 40, B)
    ent_r, ent_p = jnp.asarray(ent, jnp.int32), torch.tensor(ent)
    node_p = pf._node(pk, ent_p, pt["corner_idx"], pt["corner_cdf"])
    node_r = _ref_node(rt, ent_r, ref_rng.uniform(
        rk, ref_rng.LAUNCH_FAMILY_CORNER))
    assert np.array_equal(node_p.numpy(), node_r)
    assert len(np.unique(node_r)) > 10
    lam_r = rf.sample_wavelength(rk, ent_r, rt["corner_idx"],
                                 rt["corner_cdf"])
    lam_p = pf.sample_wavelength(pk, ent_p, pt["corner_idx"],
                                 pt["corner_cdf"])
    assert np.array_equal(_bins(rf.lam_np, lam_p), _bins(rf.lam_np, lam_r))
    _close(lam_p, lam_r, 1e-5, "wavelengths")
    borders = np.geomspace(*RANGE, 33)
    lam_r, w_r = rf.sample_wavelength_stratified(
        rk, ent_r, rt["corner_idx"], rt["corner_cdf"],
        jnp.asarray(borders, jnp.float32))
    lam_p, w_p = pf.sample_wavelength_stratified(
        pk, ent_p, pt["corner_idx"], pt["corner_cdf"],
        torch.tensor(borders.astype(np.float32)))
    assert np.array_equal(_bins(rf.lam_np, lam_p), _bins(rf.lam_np, lam_r))
    _close(lam_p, lam_r, 1e-5, "stratified wavelengths")
    _close(w_p, w_r, 1e-5, "stratified weights")
    # every lane inside its stratum
    s = np.arange(B) * 32 // B
    lp = lam_p.numpy()
    assert np.all((lp >= borders.astype(np.float32)[s])
                  & (lp < borders.astype(np.float32)[s + 1]))
    m_r = rf.mixture_weight(lam_r, ent_r, rt["corner_idx"], rt["corner_w"],
                            rt["lin_over_geo"])
    m_p = pf.mixture_weight(torch.tensor(np.asarray(lam_r)), ent_p,
                            pt["corner_idx"], pt["corner_w"],
                            pt["lin_over_geo"])
    _close(m_p, m_r, 1e-5, "mixture weights")
    assert 0.5 < float(m_p.mean()) < 2.0


@pytest.mark.parametrize("stratified", [False, True], ids=["plain", "strata"])
def test_launch_matches_reference(sources, stratified):
    port, ref, pt, rt = sources
    rk, pk = _keys(5)
    if stratified:
        borders = np.geomspace(*RANGE, 33)
        w = np.linspace(0.9, 1.1, 32)
        pt = dict(pt, strata=torch.tensor(borders.astype(np.float32)),
                  strata_w=torch.tensor(w.astype(np.float32)))
        rt = dict(rt, strata=jnp.asarray(borders, jnp.float32),
                  strata_w=jnp.asarray(w, jnp.float32))
    fp, fr = port.launch(pt, pk, B), ref.launch(rt, rk, B)
    for k in ("pos", "dir", "lam", "lum"):
        _close(fp[k], fr[k], 1e-5, k)
    # positions spread around the particles by the kernel (h = 0.08 pc)
    r = np.linalg.norm(fp["pos"].numpy()[:, None, :].astype(np.float64)
                       - port.snapshot.positions[None], axis=-1).min(axis=1)
    assert r.max() <= 0.0801 * 3.0857e16


def test_kernel_and_columns_match_reference():
    rs = np.random.default_rng(2)
    u = rs.uniform(size=4096).astype(np.float32)
    _close(snap.sample_kernel_radius(torch.tensor(u)),
           ref_snap.sample_kernel_radius(jnp.asarray(u)), 1e-6, "radius")
    assert np.array_equal(snap.cubic_spline_w(np.linspace(0, 1.2, 50)),
                          ref_snap.cubic_spline_w(np.linspace(0, 1.2, 50)))
    cols = [("x", "length", "pc"), ("y", "length", "pc"),
            ("z", "length", "pc"), ("h", "length", "pc"),
            ("Minit", "mass", "Msun"), ("Z", "", ""), ("t", "time", "yr")]
    path = os.path.join(GOLDEN, "bench4_stars.txt")
    a, b = snap.read_column_file(path, cols), ref_snap.read_column_file(
        path, cols)
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    with pytest.raises(ValueError, match="columns"):
        snap.read_column_file(path, cols * 2)


@pytest.mark.parametrize("name", ["imported_medium", "kernel_tables",
                                  "CellFamilySource", "CellSnapshot"])
def test_unported_snapshot_names_raise(name, sources):
    """These names raised until the snapshot module was ported whole; each
    is now held to the reference's: the smoothing kernels' radius tables
    equal, a cell snapshot's resampled densities and an imported medium's
    number densities within 1e-12 (f32 equal), a cell source's luminosity,
    tables and launch (1e-5 of each field's maximum) over bench4's
    family."""
    from skirt9_tpu.grids.cartesian import make_cartesian as ref_cartesian
    from skirt9_tpu_torch.grids.cartesian import make_cartesian
    pc = 3.0857e16
    rs = np.random.default_rng(5)
    ext = ((-pc, pc),) * 3
    lo = rs.uniform(-pc, 0.5 * pc, (20, 3))
    hi = lo + rs.uniform(0.2, 0.5, (20, 3)) * pc
    mass = rs.uniform(0.5, 2.0, 20)
    if name == "kernel_tables":
        for kind in ("CubicSplineSmoothingKernel",
                     "QuarticSplineSmoothingKernel",
                     "UniformSmoothingKernel",
                     "ScaledGaussianSmoothingKernel"):
            for a, b in zip(snap.kernel_tables(kind, "cpu"),
                            ref_snap.kernel_tables(kind)):
                assert np.array_equal(a.numpy(), np.asarray(b)), kind
    elif name in ("imported_medium", "CellSnapshot"):
        from skirt9_tpu_torch.media import mixes
        rg, pg = ref_cartesian(ext, (6, 5, 4)), make_cartesian(ext, (6, 5, 4))
        rss = ref_snap.CellSnapshot(lo=lo, hi=hi, mass=mass)
        pss = snap.CellSnapshot(lo=lo, hi=hi, mass=mass)
        want = rss.density_on_cells(rg)
        assert (want > 0).any()
        np.testing.assert_allclose(pss.density_on_cells(pg), want,
                                   rtol=1e-12, atol=0)
        if name == "imported_medium":
            mix = mixes.trivial_gas(1e-26, 1e-26, 0.0)
            mix = mixes.tabulated(mix.lam, mix.sigma_ext, mix.albedo, mix.g,
                                  mu=1e-27)
            med_r = ref_snap.imported_medium(rg, rss, mix)
            med_p = snap.imported_medium(pg, pss, mix)
            assert np.array_equal(med_p.nd.numpy(), np.asarray(med_r.nd))
    else:
        port, ref, _, _ = sources
        n = 20
        params = np.asarray(ref.params)[:n]
        scales = np.asarray(ref.scales)[:n]
        src_r = ref_snap.CellFamilySource(lo=lo, hi=hi,
                                          family_tables=ref.family_tables,
                                          scales=scales, params=params)
        src_p = snap.CellFamilySource(lo=lo, hi=hi,
                                      family_tables=port.family_tables,
                                      scales=scales, params=params)
        assert src_p.luminosity == pytest.approx(src_r.luminosity,
                                                 rel=1e-12)
        pt, rt = src_p.tables("cpu"), src_r.tables()
        for k in set(rt) - {"v"}:
            _close(pt[k], rt[k], 1e-6, k)
        rk, pk = _keys(7)
        fp, fr = src_p.launch(pt, pk, B), src_r.launch(rt, rk, B)
        for k in ("pos", "dir", "lam", "lum"):
            _close(fp[k], fr[k], 1e-5, k)
