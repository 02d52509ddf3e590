"""Adaptive meshes (`skirt9_tpu_torch/grids/amr.py`) against the reference's
`skirt9_tpu/grids/amr.py` on the CPU, on meshes and rays made from numpy
seeds.

- The host build: the node tables, leaf boxes and leaf rows of
  `tests/test_amr.py`'s TWO_LEVEL mesh, of its `deep_mesh_text` mesh (a
  `3 3 3` root, `2 2 2` children, `2 1 2` grandchildren) and of the same
  generator under a `2 2 2` root, equal array for array (the port's stack
  where the reference recurses).
- `locate`, eight `step`s and `move_inside` bit for bit on 4,096 lanes
  (random, on leaf corners, axis-aligned and diagonal), lanes outside
  included; the plain march against the reference's jitted scan bit for bit,
  no kernel launched. The step and `move_inside` replay XLA's fused move on
  x and y.
- The engine chain: power-of-two meshes on the multi-level sweep, the
  `3 3 3` root on the march (with the reference's warning), a 512 fine
  raster on the XL contracts with the reference's cell map; kernel 4's
  plain version (tau and leaf ids) against the reference's interpret-mode
  sweep and its scan march, tau within 1e-5.
- The loader: `AdaptiveMeshMedium` + `AdaptiveMeshSpatialGrid` of
  `tests/test_amr.py`'s template array for array (massType MassDensity,
  Mass, NumberDensity and Number; importMetallicity, importTemperature and
  importVelocity), the items it leaves out raising, naming themselves.
- The reduced amr_galaxy (`chip_smoke.SNAPSHOTS`, a 1000-fold smaller
  galaxy: the reference's AMR step overflows past ~0.6 kpc) through both
  packages on the tree sweep (the reference in interpret mode, primary
  emission with a 4-bin RF), and with dust emission on both packages' scan
  march, and the reduced `3 3 3` amr_galaxy_march on the scan march: the
  RF, each SED kind and the frame within 1e-5 of their maxima, L_dust
  within 1e-5; the probes on AMR cells equal to the reference's.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skirt9_tpu.config.ski import load_ski as ref_load_ski
from skirt9_tpu.grids import amr as ref_amr
from skirt9_tpu.media import system as ref_msys
from skirt9_tpu.parallel import domain as ref_domain
from skirt9_tpu.probes import probes as ref_probes
from skirt9_tpu.transport import lifecycle as ref_lc
from skirt9_tpu.transport import mlsweep as ref_ml
from skirt9_tpu_torch import bridge
from skirt9_tpu_torch.config.ski import load_ski
from skirt9_tpu_torch.grids import amr
from skirt9_tpu_torch.kernels import build as kb
from skirt9_tpu_torch.media import system as msys
from skirt9_tpu_torch.probes import probes
from skirt9_tpu_torch.simulation import Simulation
from skirt9_tpu_torch.transport import march as mr
from skirt9_tpu_torch.transport import mlsweep as ml
from skirt9_tpu_torch.transport import sweepxl as xl

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
import chip_smoke  # noqa: E402

PC = 3.0857e16
B = 4096


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tests/test_amr.py's meshes, by value
TWO_LEVEL = ("# simple 2-level mesh\n! 2 2 2\n! 2 2 2\n"
             + "".join(f"{v}\n" for v in range(1, 16)))


def deep_mesh_text(rs, root=(3, 3, 3)):
    """tests/test_amr.py's random 3-level mesh (root refined 2x2x2 at
    random, grandchildren 2x1x2), under a chosen root."""
    lines = ["! %d %d %d" % root]
    for _ in range(int(np.prod(root))):
        if rs.random() < 0.4:
            lines.append("! 2 2 2")
            for _ in range(8):
                if rs.random() < 0.3:
                    lines.append("! 2 1 2")
                    lines.extend("0.5" for _ in range(4))
                else:
                    lines.append("0.5")
        else:
            lines.append("0.5")
    return "\n".join(lines) + "\n"


EXT = ((-PC, PC), (-1.2 * PC, 0.8 * PC), (-PC, 1.3 * PC))
MESHES = {
    "two_level": (TWO_LEVEL, ((-1, 1),) * 3),
    "deep": (deep_mesh_text(np.random.default_rng(5)), EXT),
    "deep_pow2": (deep_mesh_text(np.random.default_rng(6), (2, 2, 2)), EXT),
}


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """name -> (reference grid, its leaf rows, port grid, its rows)."""
    d = tmp_path_factory.mktemp("amr")
    out = {}
    for name, (text, ext) in MESHES.items():
        path = str(d / f"{name}.amr")
        with open(path, "w") as f:
            f.write(text)
        out[name] = (*ref_amr.build_amr(path, ext), *amr.build_amr(path, ext))
    return out


def _rays(grid, seed):
    """Lanes in and around the root box (a tenth outside), an eighth on
    leaf corners; an eighth axis-aligned, an eighth diagonal."""
    rs = np.random.default_rng(seed)
    lo, hi = grid.box_lo.double().numpy(), grid.box_hi.double().numpy()
    pos = lo + (hi - lo) * rs.uniform(-0.05, 1.05, (B, 3))
    k = B // 8
    clo = grid.cell_lo.double().numpy()
    pos[:k] = clo[rs.integers(0, len(clo), k)]
    d = rs.normal(size=(B, 3))
    d[k:2 * k] = 0.0
    d[np.arange(k, 2 * k), rs.integers(0, 3, k)] = rs.choice([-1.0, 1.0], k)
    d[2 * k:3 * k] = rs.choice([-1.0, 1.0], (k, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return pos.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("name", list(MESHES))
def test_build_matches_reference(meshes, name):
    rg, rv, pg, pv = meshes[name]
    assert np.array_equal(rv, pv)
    assert pg.depth == rg.depth
    for f in pg._fields:
        if f == "depth":
            continue
        a, b = np.asarray(getattr(rg, f)), getattr(pg, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a, b), f
    np.testing.assert_array_equal(pg.volumes(), rg.volumes())
    assert pg.diagonal() == rg.diagonal()
    assert pg.max_steps() == rg.max_steps()
    for a, b in zip(pg.cell_bounds(), rg.cell_bounds()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(MESHES))
def test_locate_step_move_inside_match_reference(meshes, name):
    rg, _, pg, _ = meshes[name]
    pos, d = _rays(pg, 1)
    cell_r = np.asarray(jax.jit(rg.locate)(jnp.asarray(pos)))
    cell = pg.locate(torch.tensor(pos)).numpy()
    assert np.array_equal(cell, cell_r)
    assert (cell_r < 0).sum() > B // 20 and (cell_r >= 0).sum() > B // 2
    step = jax.jit(rg.step)
    p, c = pos, cell_r
    for _ in range(8):
        want = [np.asarray(x) for x in step(jnp.asarray(p), jnp.asarray(d),
                                            jnp.asarray(c))]
        got = [x.numpy() for x in pg.step(torch.tensor(p), torch.tensor(d),
                                          torch.tensor(c, dtype=torch.int64))]
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
        p, c = want[2], want[1]
    rs = np.random.default_rng(8)
    lo, hi = pg.box_lo.double().numpy(), pg.box_hi.double().numpy()
    mid, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
    p2 = (mid + 3 * half * rs.uniform(-1, 1, (B, 3))).astype(np.float32)
    d2 = mid - p2.astype(np.float64)
    d2[::3] = rs.normal(size=d2[::3].shape)
    d2 = (d2 / np.linalg.norm(d2, axis=1, keepdims=True)).astype(np.float32)
    p2[:8] = mid
    want = [np.asarray(x) for x in jax.jit(rg.move_inside)(
        jnp.asarray(p2), jnp.asarray(d2))]
    got = [x.numpy() for x in pg.move_inside(torch.tensor(p2),
                                             torch.tensor(d2))]
    assert (want[1] >= 0).sum() > B // 3 and (want[1] < 0).sum() > B // 8
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name", list(MESHES))
def test_march_matches_reference(meshes, name):
    rg, _, pg, _ = meshes[name]
    pos, d = _rays(pg, 2)
    cell = np.asarray(rg.locate(jnp.asarray(pos)))
    mask = np.random.default_rng(3).uniform(size=B) < 0.9
    S = min(rg.max_steps(), 256)
    f = jax.jit(lambda p, dd, c, m: ref_lc.march_geometry(rg, p, dd, c, S, m))
    cells_r, ds_r = (np.asarray(x) for x in f(
        jnp.asarray(pos), jnp.asarray(d), jnp.asarray(cell),
        jnp.asarray(mask)))
    kb.reset_launches()
    cells, ds = mr.march_geometry(pg, torch.tensor(pos), torch.tensor(d),
                                  torch.tensor(cell, dtype=torch.int64), S,
                                  torch.tensor(mask))
    assert kb.LAUNCHES == {k: 0 for k in kb.LAUNCHES}
    assert cells.shape == (S, B) and cells.dtype == torch.int32
    assert np.array_equal(cells.numpy()[:, mask], cells_r[:, mask])
    assert np.all(cells.numpy()[:, ~mask] == 0)
    assert np.array_equal(ds.numpy(), ds_r)
    assert np.all(ds_r[-1] == 0) and (ds_r > 0).sum(axis=0).max() > 3


def _media(pg, rg, seed, ncomp=1):
    """The same seeded densities on both packages' medium tables, of tau
    ~1 across the root box."""
    size = float((pg.box_hi - pg.box_lo).double().max())
    nd = np.random.default_rng(seed).uniform(0.2, 2.0, (pg.ncells, ncomp)) \
        / (1e-24 * size)
    kw = dict(sigma_ext=np.full((ncomp, 2), 1e-24),
              albedo=np.full((ncomp, 2), 0.5), g=np.full((ncomp, 2), 0.3))
    lam = np.array([0.4e-6, 0.7e-6])
    return (msys.make_medium(pg, nd.astype(np.float32), lam, **kw),
            ref_msys.make_medium(rg, nd.astype(np.float32), lam, **kw))


def test_engine_chain(meshes, tmp_path, monkeypatch):
    """Power-of-two meshes on the multi-level sweep (no leaf map), the 3 3 3
    root on the march with the reference's warning, a 512 fine raster on
    the XL contracts with the reference's cell map."""
    from skirt9_tpu_torch.instruments.distant import DistantInstrumentCfg
    from skirt9_tpu_torch.sources.base import PointSource
    from skirt9_tpu_torch.transport.lifecycle import TransportOptions
    from skirt9_tpu_torch import simulation
    inst = DistantInstrumentCfg(name="i", wave_borders=(0.5e-6, 0.6e-6),
                                distance=100 * PC)
    said = []

    class Log:
        def info(self, msg):
            said.append(msg)
        warning = info
    monkeypatch.setattr(simulation, "_log", Log)

    def sim(pg, med):
        return Simulation(grid=pg, medium=med, sources=[PointSource()],
                          instruments=[inst], options=TransportOptions(
                              max_steps=min(pg.max_steps(), 256),
                              max_events=2), num_packets=256,
                          batch_size=128, device="cpu")
    for name, want in (("two_level", ml.MLTables), ("deep_pow2", ml.MLTables),
                       ("deep", type(None))):
        rg, _, pg, _ = meshes[name]
        med, _ = _media(pg, rg, 1)
        assert ml.supports(pg, med) == (want is ml.MLTables)
        s = sim(pg, med)
        assert type(s._sweep_tabs) is want
        assert not hasattr(s.grid, "leafmap")
    assert any("no sweep engine supports AMRGrid" in m for m in said)
    # a line of leaves halved along x to level 9: a 512 x 1 x 1 raster
    text = "! 2 1 1\n" * 9 + "1\n" * 10
    path = str(tmp_path / "line.amr")
    with open(path, "w") as f:
        f.write(text)
    rg, _ = ref_amr.build_amr(path, ((-PC, PC),) * 3)
    pg, _ = amr.build_amr(path, ((-PC, PC),) * 3)
    med, rmed = _media(pg, rg, 2)
    assert not ml.supports(pg, med) and xl.supports_tree_xl(pg, med)
    tabs = xl.build_tree_tables(pg, med)
    assert tabs.n == (512, 1, 1) and tabs.nleaves == pg.ncells == 10
    _, rmed_vox, rcellmap = ref_domain.voxelize_for_dd(rg, rmed, 1)
    assert np.array_equal(tabs.cellmap.numpy(), np.asarray(rcellmap))
    assert np.array_equal(tabs.nd.numpy(), np.asarray(rmed_vox.nd))
    assert isinstance(sim(pg, med)._sweep_tabs, xl.XLTables)


@pytest.mark.parametrize("name", ["two_level", "deep_pow2"])
def test_tree_sweep_tau_matches_reference(meshes, name, monkeypatch):
    """Kernel 4's plain version on AMR tables: tau and leaf ids against the
    reference's interpret-mode multi-level sweep (tau within 1e-5) and its
    scan march (within 1e-5 where tau > 0.01)."""
    monkeypatch.setenv("SKIRT9_TPU_FORCE_SWEEP", "1")
    rg, _, pg, _ = meshes[name]
    med, rmed = _media(pg, rg, 4)
    assert ref_ml.supports(rg, rmed)
    rtabs = ref_ml.build_tables(rg, rmed)
    tabs = ml.build_tables(pg, med)
    rs = np.random.default_rng(1)
    n = 256
    lo, hi = pg.box_lo.double().numpy(), pg.box_hi.double().numpy()
    pos = (lo + (hi - lo) * rs.uniform(0.05, 0.95, (n, 3))).astype(np.float32)
    d = rs.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    ropt = ref_msys.optics_at(rmed, jnp.full((n,), 0.55e-6))
    opt = msys.optics_at(med, torch.full((n,), 0.55e-6))
    cell = rg.locate(jnp.asarray(pos))
    active = np.asarray(cell) >= 0
    tau_ref = np.asarray(jnp.sum(ref_ml.sweep_dtau(
        rtabs, jnp.asarray(pos), jnp.asarray(d), ropt.sigma_ext.T,
        jnp.asarray(active)), axis=0))
    tau_march = np.asarray(ref_lc.trace_tau(
        rg, rmed, ropt, jnp.asarray(pos), jnp.asarray(d), cell,
        rg.max_steps(), jnp.asarray(active)))
    tau = ml.sweep_tau_total(tabs, torch.tensor(pos), torch.tensor(d),
                             opt.sigma_ext.T.contiguous(),
                             torch.tensor(active)).double().numpy()
    np.testing.assert_allclose(tau[active], tau_ref[active], rtol=1e-5,
                               atol=1e-7)
    big = active & (tau_march > 0.01)
    assert big.sum() > n // 2
    np.testing.assert_allclose(tau[big], tau_march[big], rtol=1e-4)


# ------------------------------------------------------------------- loader

def _amr_ski(tmp_path, medium_attrs="", mode="ExtinctionOnly"):
    """tests/test_amr.py's AdaptiveMeshMedium ski file, its medium's
    importVelocity attribute replaced by medium_attrs where given."""
    import inspect
    sys.path.insert(0, HERE)
    import test_amr
    src = inspect.getsource(test_amr.test_ski_adaptive_mesh_medium)
    text = src.split('ski = """')[1].split('"""')[0]
    if medium_attrs:
        text = text.replace('importVelocity="false">', f'{medium_attrs}>')
    text = text.replace('simulationMode="ExtinctionOnly"',
                        f'simulationMode="{mode}"')
    path = tmp_path / "amr.ski"
    path.write_text(text)
    return str(path)


def _same_sims(port, ref):
    conv = bridge.simulation(ref, "cpu")
    assert type(port.grid) is type(conv.grid)
    for f in port.grid._fields:
        a, b = getattr(port.grid, f), getattr(conv.grid, f)
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b, f
    for f in msys.MediumTables._fields:
        assert torch.equal(getattr(port.medium, f),
                           getattr(conv.medium, f)), f
    assert port.options == conv.options
    assert port.instruments == conv.instruments
    assert port.rf_scale == ref.rf_scale
    return conv


@pytest.mark.parametrize("case", ["MassDensity", "Mass", "NumberDensity",
                                  "Number", "flags"])
def test_load_ski_matches_reference(case, tmp_path):
    rs = np.random.default_rng(2)
    text = deep_mesh_text(rs)
    if case == "flags":
        # density, Z, T, vx vy vz per leaf
        rows = iter(np.random.default_rng(3).uniform(0.1, 2.0, (1000, 6)))
        text = "\n".join(" ".join(f"{v:.6g}" for v in next(rows))
                         if ln == "0.5" else ln for ln in text.splitlines())
        attrs = 'massType="MassDensity"'
        flags = ('importMetallicity="true" importTemperature="true" '
                 'importVelocity="true"')
    else:
        attrs, flags = f'massType="{case}"', ""
    (tmp_path / "gas.amr").write_text(text)
    path = _amr_ski(tmp_path, flags)
    path_text = open(path).read().replace('massType="MassDensity"', attrs)
    open(path, "w").write(path_text)
    port = load_ski(path, num_packets=1024, batch_size=512, device="cpu")
    ref = ref_load_ski(path, num_packets=1024, batch_size=512)
    _same_sims(port, ref)
    assert isinstance(port.grid, amr.AMRGrid) and port.grid.ncells > 27
    if case == "flags":
        for f in ("temperature", "metallicity", "bulk_v"):
            assert float(getattr(port.medium, f).abs().min()) > 0, f
    rf, accs = port.run_primary(verbose=False)
    assert float(accs[0]["sed"].sum()) > 0


@pytest.mark.parametrize("old,new,named", [
    ('importVelocity="false">',
     'importVelocity="false" importMagneticField="true">',
     "importMagneticField.*item 32"),
    ('importVelocity="false">',
     'importVelocity="false" importVariableMixParams="true">',
     "importVariableMixParams.*item 31"),
    ("<AdaptiveMeshSpatialGrid/>",
     '<CartesianSpatialGrid minX="-1 pc" maxX="1 pc" minY="-1 pc" '
     'maxY="1 pc" minZ="-1 pc" maxZ="1 pc"/>',
     "AdaptiveMeshMedium on a CartesianSpatialGrid"),
    ('massType="MassDensity"', 'massType="Volume"', "massType='Volume'"),
    ("</media>", '<GeometricMedium><geometry type="Geometry">'
     '<PlummerGeometry scaleLength="1 pc"/></geometry><materialMix '
     'type="MaterialMix"><MeanInterstellarDustMix/></materialMix>'
     '<normalization type="MaterialNormalization">'
     '<NumberMaterialNormalization number="1e50"/></normalization>'
     '</GeometricMedium></media>', "mixing AdaptiveMeshMedium"),
], ids=["importMagneticField", "importVariableMixParams", "grid", "massType",
        "mixing"])
def test_unported_items_raise(old, new, named, tmp_path):
    (tmp_path / "gas.amr").write_text(TWO_LEVEL)
    path = _amr_ski(tmp_path)
    text = open(path).read()
    assert old in text
    open(path, "w").write(text.replace(old, new))
    with pytest.raises(NotImplementedError, match=named):
        load_ski(path, device="cpu")


# --------------------------------------------------------------- the slices

def _gaps(out_r, out_p):
    """Each accumulator's largest difference over its largest value."""
    gaps = {}
    pairs = [("rf", out_r[0], out_p[0])] if out_r[0] is not None else []
    for k in ("sed", "frame"):
        for kind in range(np.asarray(out_r[1][0][k]).shape[0]):
            pairs.append((f"{k}{kind}", out_r[1][0][k][kind],
                          out_p[1][0][k][kind]))
    for name, a, b in pairs:
        a = np.asarray(a, np.float64)
        b = b.double().numpy()
        m = np.abs(a).max()
        gaps[name] = 0.0 if m == 0 else float(np.abs(a - b).max() / m)
        assert m > 0 or np.abs(b).max() == 0, name
    return gaps


@pytest.fixture(scope="module")
def amr_small(tmp_path_factory):
    """The reduced amr_galaxy's primary emission and 4-bin RF through both
    packages on the tree sweep (the reference's in interpret mode)."""
    d = tmp_path_factory.mktemp("amr_small")
    kw, run = chip_smoke.SNAPSHOTS["amr_galaxy_small"]
    path = chip_smoke.snapshot_ski(d, "amr_galaxy_small", **kw)
    mp = pytest.MonkeyPatch()
    mp.setenv("SKIRT9_TPU_FORCE_SWEEP", "1")
    try:
        ref = ref_load_ski(path, **run)
        assert type(ref._sweep_tabs).__name__ == "MLTables"
        port = load_ski(path, device="cpu", **run)
        out_r = ref.run_primary(verbose=False)
    finally:
        mp.undo()
    kb.reset_launches()
    out_p = port.run_primary(verbose=False)
    assert kb.LAUNCHES == {k: 0 for k in kb.LAUNCHES}
    return path, ref, port, out_r, out_p


def test_amr_galaxy_small_draw_for_draw(amr_small):
    _, ref, port, out_r, out_p = amr_small
    _same_sims(port, ref)
    assert isinstance(port._sweep_tabs, ml.MLTables)
    assert not hasattr(port.grid, "leafmap")
    assert out_r[0].shape == (port.grid.ncells, 4)
    gaps = _gaps(out_r, out_p)
    assert max(gaps.values()) <= 1e-5, gaps


def test_amr_galaxy_small_dust_emission_on_the_march(amr_small):
    """Dust emission on AMR leaves (the secondary source's launch tables
    take the leaf boxes) through both packages' scan march."""
    from skirt9_tpu_torch.sources import secondary as sec
    path, *_ = amr_small
    _, run = chip_smoke.SNAPSHOTS["amr_galaxy_small"]
    ref = ref_load_ski(path, **run)
    assert ref._sweep_tabs is None
    port = bridge.simulation(ref, "cpu", march=True)
    for a, b in zip(sec.cell_bounds(port.grid), ref.grid.cell_bounds()):
        np.testing.assert_array_equal(a, b)
    out_r = ref.run_with_dust_emission(verbose=False)
    out_p = port.run_with_dust_emission(verbose=False)
    info_r, info_p = out_r[2], out_p[2]
    assert info_p["iterations"] == info_r["iterations"]
    for k in ("L_dust", "L_abs_primary"):
        assert info_p[k] == pytest.approx(info_r[k], rel=1e-5), k
    assert info_p["L_dust"] == pytest.approx(info_p["L_abs_primary"],
                                             rel=1e-4)
    gaps = _gaps(out_r[:2], out_p[:2])
    assert max(gaps.values()) <= 1e-5, gaps
    assert float(out_p[1][0]["sed"][3].sum()) > 0     # secondary direct


def test_probes_on_amr_cells(amr_small, tmp_path):
    """The temperature and radiation-field probes and the cell properties
    on the AMR leaves, on a radiation field drawn from a seed, against the
    reference's."""
    _, ref, port, *_ = amr_small
    rs = np.random.default_rng(11)
    rf = (10.0 ** rs.uniform(-3, 1, (port.grid.ncells, 4))).astype(
        np.float32)
    for kind in ("temperature_probe", "radiation_field_probe"):
        want = getattr(ref_probes, kind)(ref, jnp.asarray(rf), "r",
                                         str(tmp_path))
        got = getattr(probes, kind)(port, torch.tensor(rf), "p",
                                    str(tmp_path))
        assert len(got) == len(want) > 0, kind
        for a, b in zip(got, want):
            if a.endswith(".dat"):
                np.testing.assert_allclose(np.loadtxt(a), np.loadtxt(b),
                                           rtol=1e-6, err_msg=kind)
    cells = np.loadtxt(probes.cell_properties_probe(port, None, "p",
                                                    str(tmp_path))[0])
    np.testing.assert_array_equal(cells[:, 3], ref.grid.volumes())
    np.testing.assert_array_equal(cells[:, 4], np.asarray(
        ref.medium.nd, np.float64)[:, 0])
    np.testing.assert_array_equal(cells[:, :3], np.asarray(
        ref.grid.cell_centers(), np.float64))


def test_amr_galaxy_march_small_draw_for_draw(tmp_path):
    """The 3 3 3 root through both packages' scan march."""
    kw, run = chip_smoke.SNAPSHOTS["amr_galaxy_march_small"]
    path = chip_smoke.snapshot_ski(tmp_path, "amr_galaxy_march_small", **kw)
    ref = ref_load_ski(path, **run)
    port = load_ski(path, device="cpu", **run)
    _same_sims(port, ref)
    assert port._sweep_tabs is None
    marched = []
    plain = mr.march_geometry_plain
    mr.march_geometry_plain = lambda *a: marched.append(a[0]) or plain(*a)
    try:
        out_r = ref.run_primary(verbose=False)
        out_p = port.run_primary(verbose=False)
    finally:
        mr.march_geometry_plain = plain
    assert marched and all(g is port.grid for g in marched)
    gaps = _gaps(out_r, out_p)
    assert max(gaps.values()) <= 1e-5, gaps
