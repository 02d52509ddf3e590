"""The 2D and 3D sphere and the 3D cylinder grids and their configurations
against the reference, on the CPU with one torch thread.

- `Sphere2DGrid`, `Sphere3DGrid`, `Cylinder3DGrid`: `locate`,
  `move_inside` bit for bit against the reference's inside `jax.jit`
  (its grid tables constants, as in its launch), and every `step` of a
  march against the reference's jitted march (`march_geometry`: its steps
  inside the scan, as its life cycle runs them), cells identical and
  lengths bit for bit, on seeded rays from inside and outside the grid,
  on linear
  meshes, power-law radial and cosine-spaced polar meshes, a sinh-spaced z
  mesh and an inner radius; past 2^60 m the port's exact power-of-two
  `shift` (the reference's squares overflow f32 there) equals the march of
  the grid scaled down, scaled back.
- `ops.xlamath.atan2` bit for bit against the reference's f32 arctan2 (a
  call of the C library's atan2f) on seeded pairs and the special values,
  and the grids' tabulated cosines and sines of their border angles
  against the reference's jitted cos and sin of them.
- The loader on the generated configurations (`chip_smoke.MESHES`: the
  AGN torus on the 2D sphere, the spiral galaxy on the 3D sphere and the
  3D cylinder) array for array against the reference's `load_ski` +
  `bridge.py`, and their runs draw for draw against the reference's march
  (the galaxies 1000-fold smaller: the reference's steps overflow past 0.6
  kpc): within 1e-5 of each maximum but the 3D sphere's RF per cell
  (`BOUNDS`, measured and explained there); every march of the
  reference's life cycle reproduced exactly on its own inputs.
- DustEmission on these grids raises, naming itself, as do their cell
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
from skirt9_tpu.grids import polar as rp
from skirt9_tpu.transport import lifecycle as ref_lc
from skirt9_tpu_torch import bridge
from skirt9_tpu_torch.config.ski import load_ski
from skirt9_tpu_torch.grids import polar as pp
from skirt9_tpu_torch.kernels import build as kb
from skirt9_tpu_torch.ops import xlamath as xm
from skirt9_tpu_torch.probes import probes
from skirt9_tpu_torch.sources import secondary as sec
from skirt9_tpu_torch.transport import march as mr

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

PC = 3.0857e16
EXACT = 1e-5
RB = np.concatenate([[0.0], np.geomspace(1e-3, 1.0, 30)]) * PC
TB = np.arccos(np.linspace(1, -1, 21))
ZB = np.sinh(np.linspace(-3, 3, 21)) / np.sinh(3) * 0.4 * PC


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GRIDS = {
    "sphere2d_lin": lambda m: m.make_sphere2d(PC, 20, 18),
    "sphere2d_pow": lambda m: m.make_sphere2d(PC, 30, 20, rb=RB, tb=TB),
    "sphere2d_rmin": lambda m: m.make_sphere2d(PC, 20, 18, r_min=0.1 * PC),
    "sphere3d_lin": lambda m: m.make_sphere3d(PC, 12, 10, 8),
    "sphere3d_pow": lambda m: m.make_sphere3d(PC, 30, 20, 7, rb=RB, tb=TB),
    "cylinder3d_lin": lambda m: m.make_cylinder3d(PC, -0.4 * PC, 0.4 * PC,
                                                  12, 8, 10),
    "cylinder3d_pow": lambda m: m.make_cylinder3d(PC, -0.4 * PC, 0.4 * PC,
                                                  30, 9, 20, rb=RB, zb=ZB),
}


def _rays(B=4096, seed=5, reach=2.5):
    rs = np.random.default_rng(seed)
    d = rs.normal(size=(B, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    p = rs.uniform(-1, 1, (B, 3)) * PC
    p[:B // 3] *= reach        # a third from outside the grid
    return p.astype(np.float32), d.astype(np.float32)


def _equal(a, b) -> bool:
    a = np.asarray(a)
    return np.array_equal(a, b.numpy().astype(a.dtype), equal_nan=True)


@pytest.mark.parametrize("name", list(GRIDS))
def test_grid_bit_for_bit(name):
    rg, pg = GRIDS[name](rp), GRIDS[name](pp)
    assert pg.shift == 0 and pg.ncells == rg.ncells
    p, d = _rays()
    P, D = torch.tensor(p), torch.tensor(d)
    assert _equal(jax.jit(lambda x: rg.locate(x))(p), pg.locate(P))
    mi_r = jax.jit(lambda x, y: rg.move_inside(x, y))(p, d)
    mi_p = pg.move_inside(P, D)
    for a, b in zip(mi_r, mi_p):
        assert _equal(a, b)
    # the march: the reference's steps inside its jitted scan
    # (`lifecycle.march_geometry`, where XLA fuses them as the life cycle
    # runs them), every step's cell and length
    S = min(rg.max_steps(), 256)
    pr, cr = np.asarray(mi_r[0]), np.asarray(mi_r[1])
    mask = cr >= 0
    cells_r, ds_r = (np.asarray(a) for a in jax.jit(
        lambda a, b, c, m: ref_lc.march_geometry(rg, a, b, c, S, m))(
            pr, d, cr, mask))
    cells_p, ds_p = mr.march_geometry_plain(pg, mi_p[0], D, mi_p[1], S,
                                            torch.tensor(mask))
    walked = ds_r > 0
    assert np.array_equal(ds_r, ds_p.numpy())
    assert np.array_equal(cells_r[walked], cells_p.numpy()[walked])
    assert walked.sum() > 2 * len(p)


def test_atan2_and_angle_tables():
    rs = np.random.default_rng(3)
    n = 1 << 20
    y = (rs.normal(size=n) * 10.0 ** rs.uniform(-12, 12, n)).astype(
        np.float32)
    x = (rs.normal(size=n) * 10.0 ** rs.uniform(-12, 12, n)).astype(
        np.float32)
    y[:64], x[64:128], x[128:192], y[192:256] = 0.0, 0.0, 1.0, -0.0
    x[256:320] = -0.0
    ref = np.asarray(jax.jit(jnp.arctan2)(y, x))
    got = xm.atan2(torch.tensor(y), torch.tensor(x)).numpy()
    assert np.array_equal(ref.view(np.int32), got.view(np.int32))
    g = pp.make_sphere3d(PC, 30, 20, 64, rb=RB, tb=TB)
    for ang, tab, fn in ((g.tb, g.cos_t, jnp.cos), (g.pb, g.cos_p, jnp.cos),
                         (g.pb, g.sin_p, jnp.sin)):
        want = np.asarray(jax.jit(fn)(ang.numpy()))
        assert np.array_equal(want, tab.numpy())


@pytest.mark.parametrize("kind", ["sphere2d", "sphere3d", "cylinder3d"])
def test_length_shift_is_exact(kind):
    """A 25 kpc grid (shift 10) marches as the same grid 2^10 times
    smaller, every length scaled back; its steps are finite where the
    reference's squares overflow."""
    kpc = 1e3 * PC
    make = {"sphere2d": lambda s: pp.make_sphere2d(25 * kpc * s, 24, 16),
            "sphere3d": lambda s: pp.make_sphere3d(25 * kpc * s, 16, 12, 9),
            "cylinder3d": lambda s: pp.make_cylinder3d(
                25 * kpc * s, -4 * kpc * s, 4 * kpc * s, 16, 8, 12)}[kind]
    big, small = make(1.0), make(2.0 ** -10)
    assert big.shift == 10 and small.shift == 0
    assert torch.equal(big.rb * 2.0 ** -10, small.rb)
    p, d = _rays(2048)
    P, D = torch.tensor(p) * 2.5e4, torch.tensor(d)
    pb, cb, tb = big.move_inside(P, D)
    ps, cs, ts = small.move_inside(P * 2.0 ** -10, D)
    hit = ts < 3e38
    assert torch.equal(cb, cs) and bool(torch.isfinite(pb[hit]).all())
    assert torch.equal(pb[hit], ps[hit] * 2.0 ** 10)
    assert torch.equal(tb[hit], ts[hit] * 2.0 ** 10)
    S = min(big.max_steps(), 256)
    mask = cb >= 0
    c1, d1 = mr.march_geometry_plain(big, pb, D, cb, S, mask)
    c2, d2 = mr.march_geometry_plain(small, ps, D, cs, S, mask)
    assert torch.equal(c1, c2) and torch.equal(d1, d2 * 2.0 ** 10)
    assert bool(torch.isfinite(d1).all()) and float(d1.sum()) > 0


CASES = ("torus_sphere2d_small", "spiral_sphere3d_small",
         "spiral_cylinder3d_small")
RUN = dict(num_packets=2048, batch_size=1024, max_events=6)


@pytest.mark.parametrize("name", CASES + ("torus_sphere2d",))
def test_loader_matches_reference(name, tmp_path):
    path = chip_smoke.mesh_ski(name, tmp_path)
    ref = ref_load_ski(path, **RUN)
    port = load_ski(path, device="cpu", **RUN)
    conv = bridge.simulation(ref, "cpu")
    assert type(port.grid) is type(conv.grid)
    assert type(port.grid).__name__ == type(ref.grid).__name__
    for a, b in zip(port.grid, conv.grid):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b
    np.testing.assert_array_equal(port.grid.volumes(), ref.grid.volumes())
    np.testing.assert_array_equal(port.grid.cell_centers().numpy(),
                                  np.asarray(ref.grid.cell_centers()))
    assert torch.equal(port.medium.nd, conv.medium.nd)
    assert port.options == conv.options
    assert port.options.max_steps == min(ref.grid.max_steps(), 256)
    assert port.rf_scale == ref.rf_scale
    for s, t in zip(port.sources, conv.sources):
        assert type(s) is type(t) and s.luminosity == t.luminosity
    for c, d in zip(port.instruments, conv.instruments):
        assert c == d


def _gaps(out_r, out_p):
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


# draw for draw: every quantity within 1e-5 of its maximum but the 3D
# sphere's RF per cell. The port's launch and scattering directions are the
# reference's bit for bit on every lane (glibc's cosf and sinf written out,
# XLA's fusions of the rotation, its scalar tail included:
# tests/test_torch_directions.py); the 3D sphere's RF per cell still parts
# by 2.2e-5 (its total 1.8e-7, its scattered frame 9.4e-6), the same with
# the tail replayed as without, so another ulp moves it (ROADMAP.md queue
# C); the torus's scattered frame 3.0e-7 (before the directions were
# exact: 9.0e-3 and 1.4e-2 on the 3D sphere, 1.9e-4 on the torus).
BOUNDS = {"torus_sphere2d_small": {},
          "spiral_sphere3d_small": {"rf": 5e-5},
          "spiral_cylinder3d_small": {}}


@pytest.mark.parametrize("name", CASES)
def test_draw_for_draw(name, tmp_path, monkeypatch):
    ref = ref_load_ski(chip_smoke.mesh_ski(name, tmp_path), **RUN)
    port = bridge.simulation(ref, "cpu", march=True)
    assert port._sweep_tabs is None
    marched = []
    plain = mr.march_geometry_plain
    monkeypatch.setattr(mr, "march_geometry_plain",
                        lambda *a: marched.append(a[0]) or plain(*a))
    out_r = ref.run_primary(verbose=False)
    kb.reset_launches()
    out_p = port.run_primary(verbose=False)
    assert kb.LAUNCHES == {k: 0 for k in kb.LAUNCHES}
    assert marched and all(g is port.grid for g in marched)
    gaps = _gaps(out_r, out_p)
    if out_r[0] is not None:
        gaps["rf_total"] = abs(float(out_p[0].double().sum())
                               / np.asarray(out_r[0], np.float64).sum() - 1)
    bounds = BOUNDS[name]
    for k, g in gaps.items():
        assert g <= bounds.get(k, EXACT), (k, gaps)


@pytest.mark.parametrize("name", CASES[1:2])
def test_life_cycle_marches_exact(name, tmp_path, monkeypatch):
    """Every march of the reference's jitted life cycle (its event marches
    and peel-offs, recorded with their inputs by a `jax.debug.callback`
    spy) reproduced exactly by the port's march on the same inputs: the
    cells of every walked step and every length."""
    ref = ref_load_ski(chip_smoke.mesh_ski(name, tmp_path), num_packets=512,
                       batch_size=512, max_events=4)
    port = bridge.simulation(ref, "cpu", march=True)
    rec = []
    orig = ref_lc.march_geometry

    def spy(grid, pos0, dirn, cell0, max_steps, mask):
        cells, ds = orig(grid, pos0, dirn, cell0, max_steps, mask)
        jax.debug.callback(lambda *a: rec.append([np.asarray(x) for x in a]),
                           pos0, dirn, cell0, mask, cells, ds)
        return cells, ds

    monkeypatch.setattr(ref_lc, "march_geometry", spy)
    ref.run_primary(verbose=False)
    assert len(rec) >= 8
    for pos0, dirn, cell0, mask, cells_r, ds_r in rec:
        dirn = np.broadcast_to(dirn, pos0.shape).copy()
        cells_p, ds_p = mr.march_geometry_plain(
            port.grid, torch.tensor(pos0), torch.tensor(dirn),
            torch.tensor(cell0).long(), cells_r.shape[0], torch.tensor(mask))
        walked = ds_r > 0
        assert np.array_equal(ds_r, ds_p.numpy())
        assert np.array_equal(cells_r[walked], cells_p.numpy()[walked])


@pytest.mark.parametrize("grid", ["Sphere2DSpatialGrid", "Sphere3DSpatialGrid",
                                  "Cylinder3DSpatialGrid"])
def test_dust_emission_raises(grid, tmp_path):
    name = {"Sphere2DSpatialGrid": "torus_sphere2d_small",
            "Sphere3DSpatialGrid": "spiral_sphere3d_small",
            "Cylinder3DSpatialGrid": "spiral_cylinder3d_small"}[grid]
    path = chip_smoke.mesh_ski(name, tmp_path)
    sim = load_ski(path, device="cpu", num_packets=128)
    assert type(sim.grid).__name__ == grid.replace("SpatialGrid", "Grid")
    with pytest.raises(NotImplementedError, match="DustEmission on a "):
        sec.cell_bounds(sim.grid)
    with pytest.raises(NotImplementedError, match="planar cuts of a "):
        probes.planar_cut_form(str(tmp_path / "cut.fits"), sim.grid,
                               lambda p: p[:, 0])
    text = open(path).read()
    open(path, "w").write(text.replace('simulationMode="ExtinctionOnly"',
                                       'simulationMode="DustEmission"'))
    with pytest.raises(NotImplementedError, match=f"DustEmission on a {grid}"):
        load_ski(path, device="cpu", num_packets=128)
