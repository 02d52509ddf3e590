"""Imported snapshots, sources, media and geometries of the port
(`skirt9_tpu_torch/imports/snapshots.py`, `geometries/imported.py`, the ski
loader's imported items) against the reference's on the CPU, from numpy
inputs made from seeds.

- Snapshot densities: `ParticleSnapshot.density_at` (the port's vectorised
  kernel sum) against the reference's per-point loop within 1e-12 relative
  (particles of smoothing lengths over a factor 8, points on particles
  included), `density_on_cells` and `velocity_on_cells` on a Cartesian grid
  and an octree; the cell, cylindrical-cell, spherical-cell and mesh
  snapshots' densities; `imported_medium` of each, array for array.
- `kernel_tables` of the four smoothing kernels and the dimensionless
  Planck sampler equal to the reference's (the sampler within 2 ulps).
- Sources: the blackbody `ParticleSource`, a `FamilyParticleSource` with a
  quartic kernel, `CellFamilySource` and `EntityFamilySource` over AMR
  leaves and Voronoi cells, each launch from the same keys (the
  reference's op by op) within 1e-5 of each field's maximum (positions
  within 1e-6 of their norms).
- Imported geometries, all seven: `density_np` within 1e-12, sites and
  bounding radius equal, `sample` on 2^14 keys against the reference's
  jitted sample within 1e-6 of each position's norm, at least 95% of the
  lanes bit for bit (90% for the sectors, whose angles go through XLA's
  sine and cosine; 92.7-100% measured).
- The loader, array for array: `tests/test_imported_geometry.py`'s four ski
  templates (a ParticleGeometry source, a VoronoiMeshGeometry medium, a
  VoronoiMeshSource and an AdaptiveMeshSource), a CellSource, Cell,
  CylindricalCell and SphericalCell geometry media, ParticleMedium on a
  Cartesian grid and on a density octree, CellMedium, a VoronoiMeshMedium
  with its metallicity, temperature and velocity imports, an indexed SED
  family; the items it leaves out raise, naming themselves.
- The reduced sph_galaxy (`chip_smoke.SNAPSHOTS`, 1,000 gas and 100 star
  particles on a maxLevel-4 octree, a 1000-fold smaller galaxy) with dust
  emission through both packages' scan march: the RF and the primary SED
  and frame kinds within 1e-5 of their maxima (measured 1.1e-6), the kinds
  carrying the dust's emission by their sums within 1e-3 (chip_smoke's
  `MARCH_BOUNDS`; a secondary launch may pick a neighbouring cell), L_dust
  within 1e-5.
"""

import os
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skirt9_tpu.config.ski import load_ski as ref_load_ski
from skirt9_tpu.geometries import imported as r_ig
from skirt9_tpu.grids import amr as r_amr
from skirt9_tpu.grids import octree as r_ot
from skirt9_tpu.grids.cartesian import make_cartesian as r_cartesian
from skirt9_tpu.imports import snapshots as r_snap
from skirt9_tpu.media import mixes as r_mx
from skirt9_tpu.ops import rng as r_rng
from skirt9_tpu.spectral import sedfamily as r_sf
from skirt9_tpu_torch import bridge
from skirt9_tpu_torch.config.ski import load_ski
from skirt9_tpu_torch.geometries import imported as ig
from skirt9_tpu_torch.grids import amr
from skirt9_tpu_torch.grids import octree as ot
from skirt9_tpu_torch.grids.cartesian import make_cartesian
from skirt9_tpu_torch.imports import snapshots as snap
from skirt9_tpu_torch.media import mixes as mx
from skirt9_tpu_torch.media import system as msys
from skirt9_tpu_torch.ops import rng
from skirt9_tpu_torch.spectral import sedfamily as sf
from skirt9_tpu_torch.transport import march as mr
from skirt9_tpu_torch.utils.storedtable import write_stored_table

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden")
sys.path.insert(0, os.path.dirname(HERE))
import chip_smoke  # noqa: E402

PC = 3.0857e16
N = 1 << 14
EXT = ((-2 * PC, 2 * PC),) * 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys(n=N, seed=3):
    """The same launch keys on both sides."""
    rk = r_rng.event_keys(r_rng.history_keys(jax.random.PRNGKey(seed),
                                             jnp.arange(n)),
                          r_rng.LAUNCH_EVENT)
    pk = rng.event_keys(rng.history_keys(rng.seed_key(seed, "cpu"),
                                         torch.arange(n)), rng.LAUNCH_EVENT)
    assert np.array_equal(np.asarray(rk).astype(np.int64), pk.numpy())
    return rk, pk


def _snapshots():
    """name -> the same seeded snapshot's fields (np arrays)."""
    rs = np.random.default_rng(4)
    pos = rs.normal(size=(300, 3)) * 0.6 * PC
    h = 10.0 ** rs.uniform(np.log10(0.1), np.log10(0.8), 300) * PC
    lo = rs.uniform(-PC, PC, (60, 3))
    hi = lo + rs.uniform(0.1, 0.8, (60, 3)) * PC
    clo = np.stack([rs.uniform(0, PC, 40), rs.uniform(0, 5, 40),
                    rs.uniform(-PC, PC, 40)], 1)
    chi = clo + np.stack([rs.uniform(0.1, 0.5, 40) * PC,
                          rs.uniform(0.1, 1, 40),
                          rs.uniform(0.1, 0.5, 40) * PC], 1)
    slo = np.stack([rs.uniform(0, PC, 40), rs.uniform(0, 2.5, 40),
                    rs.uniform(0, 5, 40)], 1)
    shi = slo + np.stack([rs.uniform(0.1, 0.5, 40) * PC,
                          rs.uniform(0.1, 0.6, 40), rs.uniform(0.1, 1, 40)], 1)
    return {
        "ParticleSnapshot": dict(positions=pos, h=h,
                                 mass=rs.uniform(0.5, 2, 300),
                                 velocity=rs.normal(size=(300, 3)) * 1e5),
        "CellSnapshot": dict(lo=lo, hi=hi, mass=rs.uniform(0.5, 2, 60),
                             velocity=rs.normal(size=(60, 3)) * 1e5),
        "CylindricalCellSnapshot": dict(lo=clo, hi=chi,
                                        mass=rs.uniform(0.5, 2, 40)),
        "SphericalCellSnapshot": dict(lo=slo, hi=shi,
                                      mass=rs.uniform(0.5, 2, 40)),
        "MeshSnapshot": dict(lo=np.array([-PC, -PC, -PC]),
                             hi=np.array([PC, 2 * PC, PC]),
                             mass=rs.uniform(0.1, 1, (4, 5, 3))),
    }


SNAPS = _snapshots()


def _pair(name):
    kw = SNAPS[name]
    return getattr(r_snap, name)(**kw), getattr(snap, name)(**kw)


def _grids():
    """A Cartesian grid and a small density octree, in both packages."""
    dens = lambda p: np.exp(-np.sum((p / PC) ** 2, axis=-1))
    return [(r_cartesian(EXT, (9, 7, 8)), make_cartesian(EXT, (9, 7, 8))),
            (r_ot.build_octree(EXT, dens, max_level=4, min_level=1,
                               max_fraction=0.02),
             ot.build_octree(EXT, dens, max_level=4, min_level=1,
                             max_fraction=0.02))]


def test_kernel_sum_matches_reference_loop():
    """The vectorised kernel sum against the reference's per-point loop,
    points on particles included, within 1e-12 relative; and its host
    seconds for 10^5 points over 10^4 particles (printed)."""
    r, p = _pair("ParticleSnapshot")
    rs = np.random.default_rng(7)
    pts = np.concatenate([rs.normal(size=(2000, 3)) * 0.8 * PC,
                          r.positions[:50]])
    want, got = r.density_at(pts), p.density_at(pts)
    assert (want > 0).mean() > 0.5
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    big = snap.ParticleSnapshot(positions=rs.normal(size=(10_000, 3)) * PC,
                                h=rs.uniform(0.05, 0.4, 10_000) * PC,
                                mass=np.ones(10_000))
    t0 = time.perf_counter()
    rho = big.density_at(rs.normal(size=(100_000, 3)) * PC)
    print(f"kernel sum: 1e5 points, 1e4 particles: "
          f"{time.perf_counter() - t0:.2f} s")
    assert (rho > 0).mean() > 0.5


@pytest.mark.parametrize("name", list(SNAPS))
def test_snapshot_densities_match_reference(name):
    r, p = _pair(name)
    rs = np.random.default_rng(8)
    pts = rs.uniform(-1.5 * PC, 1.5 * PC, (3000, 3))
    if hasattr(r, "density_at"):
        np.testing.assert_allclose(p.density_at(pts), r.density_at(pts),
                                   rtol=1e-12, atol=0)
    for rg, pg in _grids():
        want = r.density_on_cells(rg)
        got = p.density_on_cells(pg)
        assert (want > 0).any()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
        if hasattr(r, "velocity_on_cells"):
            np.testing.assert_array_equal(p.velocity_on_cells(pg),
                                          r.velocity_on_cells(rg))
        mix_r, mix_p = (m.from_file(os.path.join(GOLDEN, "mrn_mean.txt"))
                        for m in (r_mx, mx))
        med_r = r_snap.imported_medium(rg, r, mix_r)
        med_p = snap.imported_medium(pg, p, mix_p)
        conv = bridge.medium(med_r)
        for f in msys.MediumTables._fields:
            assert torch.equal(getattr(med_p, f), getattr(conv, f)), f


@pytest.mark.parametrize("kind", ["CubicSplineSmoothingKernel",
                                  "QuarticSplineSmoothingKernel",
                                  "UniformSmoothingKernel",
                                  "ScaledGaussianSmoothingKernel"])
def test_kernel_tables_match_reference(kind):
    for a, b in zip(snap.kernel_tables(kind, "cpu"),
                    r_snap.kernel_tables(kind)):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_planck_sampler_matches_reference():
    rs = np.random.default_rng(9)
    u = rs.uniform(size=4096).astype(np.float32)
    T = rs.uniform(3000, 30000, 4096).astype(np.float32)
    want = np.asarray(jax.jit(r_snap.sample_planck_wavelength)(
        jnp.asarray(u), jnp.asarray(T)))
    got = snap.sample_planck_wavelength(torch.tensor(u),
                                        torch.tensor(T)).numpy()
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert np.abs(got.astype(np.float64) - want).max() <= 2 * ulp.max()
    assert np.all(np.abs(got - want) <= 2 * ulp)


# ------------------------------------------------------------------ sources

def _family(pkg, lam_range=(0.09e-6, 100e-6)):
    fam = pkg.load_ssp_family(os.path.join(GOLDEN, "bench4_ssp.stab"))
    return pkg.FamilyTables(fam, lam_range=lam_range)


def _amr_text(tmp_path):
    path = str(tmp_path / "src.amr")
    with open(path, "w") as f:
        f.write("! 2 2 2\n! 2 1 2\n" + "".join(
            f"{v}\n" for v in range(1, 12)))
    return path


def _sources(name, pkg, sn, ig_mod, amr_mod, tmp_path):
    """The same seeded source built by a package."""
    rs = np.random.default_rng(10)
    n = {"blackbody_particles": 300, "quartic_particles": 300,
         "cells": 60, "amr_leaves": 11, "voronoi_cells": 50}[name]
    params = np.stack([rs.uniform(0.004, 0.05, n),
                       np.exp(rs.uniform(np.log(1e6), np.log(1e10), n))], -1)
    scales = rs.uniform(1e3, 1e5, n)
    kw = SNAPS["ParticleSnapshot"]
    ss = sn.ParticleSnapshot(positions=kw["positions"], h=kw["h"],
                             mass=kw["mass"])
    if name == "blackbody_particles":
        return sn.ParticleSource(snapshot=ss,
                                 luminosities=rs.uniform(1, 2, n) * 1e26,
                                 temperatures=rs.uniform(3e3, 3e4, n))
    fam = _family(r_sf if pkg == "ref" else sf)
    if name == "quartic_particles":
        return sn.FamilyParticleSource(
            snapshot=ss, family_tables=fam, scales=scales, params=params,
            kernel_kind="QuarticSplineSmoothingKernel")
    if name == "cells":
        c = SNAPS["CellSnapshot"]
        return sn.CellFamilySource(lo=c["lo"], hi=c["hi"], family_tables=fam,
                                   scales=scales, params=params)
    if name == "amr_leaves":
        grid, _ = amr_mod.build_amr(_amr_text(tmp_path), EXT)
        sampler = ig_mod.AdaptiveMeshGeometry(grid=grid, mass=np.ones(n))
    else:
        sampler = ig_mod.VoronoiMeshGeometry(
            sites=rs.uniform(-PC, PC, (n, 3)), mass=np.ones(n), extent=EXT)
    return sn.EntityFamilySource(sampler=sampler, family_tables=fam,
                                 scales=scales, params=params)


@pytest.mark.parametrize("name", ["blackbody_particles", "quartic_particles",
                                  "cells", "amr_leaves", "voronoi_cells"])
def test_source_launch_matches_reference(name, tmp_path):
    ref = _sources(name, "ref", r_snap, r_ig, r_amr, tmp_path)
    port = bridge.source(ref)
    own = _sources(name, "port", snap, ig, amr, tmp_path)
    assert type(port) is type(own)
    assert port.luminosity == own.luminosity == pytest.approx(
        ref.luminosity, rel=1e-12)
    rk, pk = _keys(4096)
    fr = ref.launch(ref.tables(), rk, 4096)
    fp = own.launch(own.tables("cpu"), pk, 4096)
    for k in ("dir", "lam", "lum"):
        a, b = fp[k].double().numpy(), np.asarray(fr[k], np.float64)
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), k
    a, b = fp["pos"].double().numpy(), np.asarray(fr["pos"], np.float64)
    assert np.all(np.abs(a - b).max(axis=1)
                  <= 1e-6 * np.linalg.norm(b, axis=1) + 1e-6 * PC)
    assert np.all(np.asarray(fr["v_emit"]) == 0)


@pytest.mark.parametrize("kind", ["ParticleSource", "CellSource",
                                  "EntityFamilySource"])
def test_source_velocities_raise(kind):
    fam = _family(sf)
    v = np.zeros((4, 3))
    with pytest.raises(NotImplementedError, match="item 45"):
        if kind == "ParticleSource":
            snap.FamilyParticleSource(
                snapshot=snap.ParticleSnapshot(np.zeros((4, 3)), np.ones(4),
                                               np.ones(4), velocity=v),
                family_tables=fam, scales=np.ones(4),
                params=np.full((4, 2), [0.02, 1e8]))
        elif kind == "CellSource":
            snap.CellFamilySource(lo=np.zeros((4, 3)), hi=np.ones((4, 3)),
                                  family_tables=fam, scales=np.ones(4),
                                  params=np.full((4, 2), [0.02, 1e8]),
                                  velocity=v)
        else:
            snap.EntityFamilySource(sampler=None, family_tables=fam,
                                    scales=np.ones(4),
                                    params=np.full((4, 2), [0.02, 1e8]),
                                    velocity=v)


# --------------------------------------------------------------- geometries

def _geometries(mod, sn, amr_mod, tmp_path):
    rs = np.random.default_rng(12)
    grid, _ = amr_mod.build_amr(_amr_text(tmp_path), EXT)
    return {
        "particle": mod.ParticleGeometry(
            snapshot=sn.ParticleSnapshot(**{k: v for k, v in SNAPS[
                "ParticleSnapshot"].items() if k != "velocity"})),
        "particle_gaussian": mod.ParticleGeometry(
            snapshot=sn.ParticleSnapshot(**{k: v for k, v in SNAPS[
                "ParticleSnapshot"].items() if k != "velocity"}),
            kernel_kind="ScaledGaussianSmoothingKernel"),
        "cell": mod.CellGeometry(snapshot=sn.CellSnapshot(
            **{k: v for k, v in SNAPS["CellSnapshot"].items()
               if k != "velocity"})),
        "cylindrical": mod.CylindricalCellGeometry(
            snapshot=sn.CylindricalCellSnapshot(
                **SNAPS["CylindricalCellSnapshot"])),
        "spherical": mod.SphericalCellGeometry(
            snapshot=sn.SphericalCellSnapshot(
                **SNAPS["SphericalCellSnapshot"])),
        "mesh": mod.MeshGeometry(snapshot=sn.MeshSnapshot(
            **SNAPS["MeshSnapshot"])),
        "adaptive_mesh": mod.AdaptiveMeshGeometry(grid=grid,
                                                  mass=np.arange(1.0, 12.0)),
        "voronoi": mod.VoronoiMeshGeometry(
            sites=rs.uniform(-PC, PC, (50, 3)),
            mass_density=rs.uniform(0.5, 2, 50), extent=EXT),
    }


@pytest.fixture(scope="module")
def geometries(tmp_path_factory):
    d = tmp_path_factory.mktemp("geo")
    return (_geometries(r_ig, r_snap, r_amr, d),
            _geometries(ig, snap, amr, d))


@pytest.mark.parametrize("name", ["particle", "particle_gaussian", "cell",
                                  "cylindrical", "spherical", "mesh",
                                  "adaptive_mesh", "voronoi"])
def test_geometry_matches_reference(geometries, name):
    ref, port = geometries[0][name], geometries[1][name]
    conv = bridge.geometry(ref)
    assert type(conv) is type(port)
    rs = np.random.default_rng(13)
    pts = rs.uniform(-1.8 * PC, 1.8 * PC, (3000, 3))
    want = ref.density_np(pts)
    assert (want > 0).any()
    for g in (port, conv):
        np.testing.assert_allclose(g.density_np(pts), want, rtol=1e-12,
                                   atol=0)
        np.testing.assert_array_equal(g.sites_np(), ref.sites_np())
        assert g.rmax == ref.rmax and g.total_mass == ref.total_mass
    rk, pk = _keys()
    want = np.asarray(jax.jit(lambda k: ref.sample(k))(rk), np.float64)
    got = port.sample(pk).double().numpy()
    norm = np.linalg.norm(want, axis=1)
    assert np.all(np.abs(got - want).max(axis=1) <= 1e-6 * norm), name
    exact = np.all(got == want, axis=1).mean()
    # a sector's positions go through XLA's f32 sine and cosine, which
    # differ by an ulp from the correctly rounded ones on a few % of angles
    assert exact >= (0.9 if name in ("cylindrical", "spherical")
                     else 0.95), (name, exact)


# ------------------------------------------------------------------- loader

def _write(d, name, text):
    path = os.path.join(str(d), name)
    with open(path, "w") as f:
        f.write(textwrap.dedent(text))
    return path


def _templates():
    """tests/test_imported_geometry.py's ski template and its trivial
    medium."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "tig", os.path.join(HERE, "test_imported_geometry.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._SKI_TMPL, mod._TRIVIAL_MEDIUM


_SKI_TMPL, _TRIVIAL_MEDIUM = _templates()
_BB = ('<sed type="SED"><BlackBodySED temperature="5778 K"/></sed>'
       '<normalization type="LuminosityNormalization">'
       '<IntegratedLuminosityNormalization wavelengthRange="Source" '
       'integratedLuminosity="1 Lsun"/></normalization>')
_POINT = ('<PointSource positionX="0 pc" positionY="0 pc" positionZ="0 pc" '
          f'sourceWeight="1" wavelengthBias="0.5">{_BB}</PointSource>')
_BOX = ('minX="-2 pc" maxX="2 pc" minY="-2 pc" maxY="2 pc" minZ="-2 pc" '
        'maxZ="2 pc"')
_MRN = ('<materialMix type="MaterialMix"><MeanFileDustMix '
        'filename="mrn_mean.txt"/></materialMix>')
_GEO_MEDIUM = ('<GeometricMedium velocityMagnitude="0 km/s"><geometry '
               'type="Geometry">{}</geometry>' + _MRN +
               '<normalization type="MaterialNormalization">'
               '<OpticalDepthMaterialNormalization axis="Z" '
               'wavelength="0.55 micron" opticalDepth="0.5"/>'
               '</normalization></GeometricMedium>')
_GEO_MEDIUM_N = _GEO_MEDIUM.replace(
    '<OpticalDepthMaterialNormalization axis="Z" wavelength="0.55 micron" '
    'opticalDepth="0.5"/>', '<NumberMaterialNormalization number="1e55"/>')
_OCTREE = ('<PolicyTreeSpatialGrid ' + _BOX + ' treeType="OctTree"><policy '
           'type="TreePolicy"><DensityTreePolicy minLevel="1" maxLevel="4" '
           'maxDustFraction="1e-3"/></policy></PolicyTreeSpatialGrid>')


def _data_files(d):
    """The seeded input files of the loader cases."""
    rs = np.random.default_rng(14)
    pts = rs.uniform(-1.5, 1.5, (40, 3))
    rows = lambda a: "\n".join(" ".join(f"{v:.9g}" for v in r) for r in a)
    _write(d, "parts.txt", rows(np.column_stack([
        pts, rs.uniform(0.2, 0.5, 40), rs.uniform(0.5, 2, 40)])) + "\n")
    _write(d, "stars.txt", rows(np.column_stack([
        pts[:20], rs.uniform(0.2, 0.5, 20), rs.uniform(5e5, 2e6, 20),
        rs.uniform(4000, 9000, 20)])) + "\n")
    _write(d, "istars.txt", rows(np.column_stack([
        pts[:20], rs.uniform(0.2, 0.5, 20), rs.uniform(0.5, 2, 20) * 3.8e26,
        rs.integers(0, 3, 20)])) + "\n")
    lo = rs.uniform(-1.8, 1.2, (30, 3))
    cells = np.column_stack([lo, lo + rs.uniform(0.2, 0.6, (30, 3))])
    _write(d, "cells.txt", rows(np.column_stack([
        cells, rs.uniform(0.5, 2, 30), rs.uniform(0.004, 0.05, 30),
        rs.uniform(1e5, 1e5, 30), rs.normal(size=(30, 3))])) + "\n")
    _write(d, "csrc.txt", rows(np.column_stack([
        cells, rs.uniform(1e3, 1e5, 30), rs.uniform(0.004, 0.05, 30),
        np.exp(rs.uniform(np.log(1e6), np.log(1e10), 30))])) + "\n")
    cyl = np.column_stack([rs.uniform(0, 1, 20), rs.uniform(0, 300, 20),
                           rs.uniform(-1, 0.5, 20)])
    _write(d, "cyl.txt", rows(np.column_stack([
        cyl, cyl + np.column_stack([rs.uniform(0.2, 0.5, 20),
                                    rs.uniform(10, 60, 20),
                                    rs.uniform(0.2, 0.5, 20)]),
        rs.uniform(0.5, 2, 20)])) + "\n")
    sph = np.column_stack([rs.uniform(0, 1, 20), rs.uniform(0, 150, 20),
                           rs.uniform(0, 300, 20)])
    _write(d, "sph.txt", rows(np.column_stack([
        sph, sph + np.column_stack([rs.uniform(0.2, 0.5, 20),
                                    rs.uniform(5, 30, 20),
                                    rs.uniform(10, 60, 20)]),
        rs.uniform(0.5, 2, 20)])) + "\n")
    sites = rs.uniform(-1.5, 1.5, (32, 3))
    _write(d, "vsites.txt", rows(np.column_stack([
        sites, rs.uniform(0.5, 2, 32)])) + "\n")
    _write(d, "vgas.txt", rows(np.column_stack([
        sites, rs.uniform(0.5, 2, 32), rs.uniform(0.004, 0.05, 32),
        rs.uniform(1e3, 1e4, 32), rs.normal(size=(32, 3))])) + "\n")
    _write(d, "vsrc.txt", rows(np.column_stack([
        sites[:24], rs.uniform(5e5, 2e6, 24),
        rs.uniform(4000, 9000, 24)])) + "\n")
    _write(d, "asrc.txt", "! 2 1 1\n7e5 6000\n! 1 2 1\n7e5 4000\n"
           "5e5 9000\n")
    lam = np.geomspace(0.05e-6, 200e-6, 60)
    spec = np.stack([lam ** -k for k in (1.0, 2.0, 3.0)])
    write_stored_table(os.path.join(str(d), "indexed.stab"),
                       [("lambda", "m", "log", lam),
                        ("index", "1", "lin", np.arange(3.0))],
                       [("Llambda", "W/m", "log")],
                       (spec / np.trapezoid(spec, lam)[:, None])[..., None])
    import shutil
    for fn in ("mrn_mean.txt", "bench4_ssp.stab"):
        shutil.copy(os.path.join(GOLDEN, fn), str(d))


def _ssp(fn):
    return ('<sedFamily type="SEDFamily"><FileSSPSEDFamily filename='
            f'"{fn}" hasIonizationParameter="false"/></sedFamily>')


CASES = {
    "particle_geometry_source": (
        '<GeometricSource velocityMagnitude="0 km/s" sourceWeight="1" '
        'wavelengthBias="0.5"><geometry type="Geometry"><ParticleGeometry '
        'filename="parts.txt" importMetallicity="false" importTemperature='
        '"false"><smoothingKernel type="SmoothingKernel">'
        '<CubicSplineSmoothingKernel/></smoothingKernel></ParticleGeometry>'
        f'</geometry>{_BB}</GeometricSource>', _TRIVIAL_MEDIUM, None),
    "voronoi_geometry_medium": (
        _POINT, _GEO_MEDIUM.format(
            f'<VoronoiMeshGeometry filename="vsites.txt" {_BOX} '
            'massType="MassDensity"/>'), None),
    "voronoi_mesh_source": (
        f'<VoronoiMeshSource filename="vsrc.txt" {_BOX} importVelocity='
        '"false" sourceWeight="1" wavelengthBias="0.5"><sedFamily type='
        '"SEDFamily"><BlackBodySEDFamily/></sedFamily></VoronoiMeshSource>',
        _TRIVIAL_MEDIUM, None),
    "adaptive_mesh_source": (
        f'<AdaptiveMeshSource filename="asrc.txt" {_BOX} importVelocity='
        '"false" sourceWeight="1" wavelengthBias="0.5"><sedFamily type='
        '"SEDFamily"><BlackBodySEDFamily/></sedFamily></AdaptiveMeshSource>',
        _TRIVIAL_MEDIUM, None),
    "cell_source": (
        '<CellSource filename="csrc.txt" importVelocity="false" '
        f'sourceWeight="1" wavelengthBias="0.5">{_ssp("bench4_ssp.stab")}'
        '</CellSource>', _TRIVIAL_MEDIUM, None),
    "indexed_particle_source": (
        '<ParticleSource filename="istars.txt" importVelocity="false" '
        'sourceWeight="1" wavelengthBias="0.5"><smoothingKernel type='
        '"SmoothingKernel"><UniformSmoothingKernel/></smoothingKernel>'
        '<sedFamily type="SEDFamily"><FileIndexedSEDFamily filename='
        '"indexed.stab"/></sedFamily></ParticleSource>', _TRIVIAL_MEDIUM,
        None),
    "blackbody_particle_source": (
        '<ParticleSource filename="stars.txt" importVelocity="false" '
        'sourceWeight="1" wavelengthBias="0.5"><sedFamily type="SEDFamily">'
        '<BlackBodySEDFamily/></sedFamily></ParticleSource>',
        _TRIVIAL_MEDIUM, None),
    "cell_geometry_media": (
        _POINT, _GEO_MEDIUM.format(
            '<CellGeometry filename="cells.txt" massType="MassDensity" '
            'importMetallicity="true" importTemperature="true" '
            'maxTemperature="1e6 K"/>')
        + _GEO_MEDIUM_N.format(
            '<CylindricalCellGeometry filename="cyl.txt" '
            'importMetallicity="false" importTemperature="false"/>')
        + _GEO_MEDIUM_N.format(
            '<OffsetGeometryDecorator offsetX="0.1 pc" offsetY="0 pc" '
            'offsetZ="0 pc"><geometry type="Geometry">'
            '<SphericalCellGeometry filename="sph.txt" importMetallicity='
            '"false" importTemperature="false"/></geometry>'
            '</OffsetGeometryDecorator>'), None),
    "particle_medium_cartesian": (
        _POINT, '<ParticleMedium filename="parts.txt" massType="Mass" '
        'importMetallicity="false" importTemperature="false" '
        f'importVelocity="false">{_MRN}</ParticleMedium>', None),
    "particle_medium_octree": (
        _POINT, '<ParticleMedium filename="parts.txt" massType="Mass" '
        f'importMetallicity="false" importVelocity="false">{_MRN}'
        '</ParticleMedium>', _OCTREE),
    "cell_medium": (
        _POINT, '<CellMedium filename="cells.txt" massType="MassDensity" '
        'importMetallicity="true" importTemperature="false" '
        f'importVelocity="false">{_MRN}</CellMedium>', None),
    "voronoi_medium_imports": (
        _POINT, f'<VoronoiMeshMedium filename="vgas.txt" {_BOX} '
        'massType="MassDensity" importMetallicity="true" importTemperature='
        f'"true" importVelocity="true">{_MRN}</VoronoiMeshMedium>',
        f'<VoronoiMeshSpatialGrid {_BOX} policy="ImportedMesh"/>'),
}


def _case_ski(d, name):
    source, medium, grid = CASES[name]
    text = _SKI_TMPL.format(SOURCE=source, MEDIUM=medium)
    if grid is not None:
        i = text.index("<CartesianSpatialGrid")
        j = text.index("</CartesianSpatialGrid>") + len(
            "</CartesianSpatialGrid>")
        text = text[:i] + grid + text[j:]
    return _write(d, f"{name}.ski", text)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("imports")
    _data_files(d)
    return d


@pytest.mark.parametrize("name", list(CASES))
def test_load_ski_matches_reference(name, data_dir):
    path = _case_ski(data_dir, name)
    run = dict(num_packets=1024, batch_size=1024, max_events=4)
    ref = ref_load_ski(path, **run)
    port = load_ski(path, device="cpu", **run)
    conv = bridge.simulation(ref, "cpu")
    assert type(port.grid) is type(conv.grid)
    for f in port.grid._fields:
        a, b = getattr(port.grid, f), getattr(conv.grid, f)
        if f not in ("leafmap", "fine_n"):
            assert torch.equal(a, b) if torch.is_tensor(a) else a == b, f
    for f in msys.MediumTables._fields:
        assert torch.equal(getattr(port.medium, f),
                           getattr(conv.medium, f)), f
    assert port.options == conv.options
    assert port.rf_scale == ref.rf_scale
    for s, t, r in zip(port.sources, conv.sources, ref.sources,
                       strict=True):
        assert type(s) is type(t)
        assert s.luminosity == pytest.approx(r.luminosity, rel=1e-12)
        tp, tr = s.tables("cpu"), r.tables()
        for k in set(tr) - {"v", "sed"}:
            a, b = tp[k].numpy(), np.asarray(tr[k])
            assert a.shape == b.shape and np.array_equal(a, b), k
        if hasattr(s, "geometry"):
            pts = np.random.default_rng(1).uniform(-2 * PC, 2 * PC,
                                                   (500, 3))
            np.testing.assert_allclose(s.geometry.density_np(pts),
                                       r.geometry.density_np(pts),
                                       rtol=1e-12, atol=0)
    rf, accs = port.run_primary(verbose=False)
    assert float(accs[0]["sed"].sum()) > 0


@pytest.mark.parametrize("old,new,named", [
    ("<BlackBodySEDFamily/>", "<BruzualCharlotSEDFamily/>",
     "BruzualCharlotSEDFamily"),
    ('importVelocity="false"', 'importVelocity="true"',
     "importVelocity.*item 45"),
    ('sourceWeight="1"', 'useColumns="x,y" sourceWeight="1"', "useColumns"),
], ids=["named_family", "source_velocity", "useColumns"])
def test_unported_source_items_raise(old, new, named, data_dir):
    path = _case_ski(data_dir, "voronoi_mesh_source")
    text = open(path).read()
    assert old in text
    _write(data_dir, "edited.ski", text.replace(old, new))
    with pytest.raises(NotImplementedError, match=named):
        load_ski(os.path.join(str(data_dir), "edited.ski"), device="cpu")


@pytest.mark.parametrize("edit,named", [
    (('importVelocity="true">', 'importVelocity="true" '
      'importMagneticField="true">'), "importMagneticField.*item 32"),
    (('importVelocity="true">', 'importVelocity="true" '
      'importVariableMixParams="true">'), "importVariableMixParams.*item 31"),
    (('policy="ImportedMesh"', 'policy="DustDensity"'), "DustDensity"),
    (("<VoronoiMeshSpatialGrid", "<TetraMeshSpatialGrid"),
     "TetraMeshSpatialGrid"),
], ids=["importMagneticField", "importVariableMixParams", "DustDensity",
        "TetraMeshSpatialGrid"])
def test_unported_medium_items_raise(edit, named, data_dir):
    text = open(_case_ski(data_dir, "voronoi_medium_imports")).read()
    assert edit[0] in text
    path = _write(data_dir, "edited_medium.ski", text.replace(*edit))
    with pytest.raises(NotImplementedError, match=named):
        load_ski(path, device="cpu")


def test_particle_medium_temperature_raises(data_dir):
    text = open(_case_ski(data_dir, "particle_medium_cartesian")).read()
    path = _write(data_dir, "edited_pm.ski", text.replace(
        'importTemperature="false"', 'importTemperature="true"'))
    with pytest.raises(NotImplementedError,
                       match="ParticleMedium importTemperature"):
        load_ski(path, device="cpu")


# ---------------------------------------------------------------- the slice

def test_sph_galaxy_small_draw_for_draw(tmp_path):
    """The reduced sph_galaxy with dust emission through both packages'
    scan march (the reference's CPU engine)."""
    kw, run = chip_smoke.SNAPSHOTS["sph_galaxy_small"]
    path = chip_smoke.snapshot_ski(tmp_path, "sph_galaxy_small", **kw)
    ref = ref_load_ski(path, **run)
    port = load_ski(path, device="cpu", **run)
    conv = bridge.simulation(ref, "cpu", march=True)
    assert isinstance(port.grid, ot.OctreeGrid)
    for f in ("node_child", "node_center", "cell_lo", "cell_hi"):
        assert torch.equal(getattr(port.grid, f), getattr(conv.grid, f)), f
    assert torch.equal(port.medium.nd, conv.medium.nd)
    assert port.rf_scale == ref.rf_scale
    marched = []
    plain = mr.march_geometry_plain
    mr.march_geometry_plain = lambda *a: marched.append(a[0]) or plain(*a)
    try:
        out_r = ref.run_with_dust_emission(verbose=False)
        out_p = conv.run_with_dust_emission(verbose=False)
    finally:
        mr.march_geometry_plain = plain
    assert marched
    info_r, info_p = out_r[2], out_p[2]
    for k in ("L_dust", "L_abs_primary"):
        assert info_p[k] == pytest.approx(info_r[k], rel=1e-5), k
    assert info_p["L_dust"] == pytest.approx(info_p["L_abs_primary"],
                                             rel=1e-4)
    rf_r = np.asarray(out_r[0], np.float64)
    assert np.abs(out_p[0].double().numpy() - rf_r).max() \
        <= 1e-5 * rf_r.max()
    # the primary kinds lane for lane; the kinds that carry the dust's
    # emission by their sums within 1e-3, as chip_smoke's march_gaps holds
    # them (a secondary launch may pick the neighbouring cell where the
    # two packages' emission cdfs differ in the last bit)
    for key in ("sed", "frame"):
        r = np.asarray(out_r[1][0][key], np.float64)
        p = out_p[1][0][key].double().numpy()
        for k in range(r.shape[0]):
            m = np.abs(r[k]).max()
            assert m > 0, (key, k)
            if k in (1, 2):
                assert np.abs(p[k] - r[k]).max() <= 1e-5 * m, (key, k)
            else:
                assert abs(p[k].sum() / r[k].sum() - 1) <= 1e-3, (key, k)
