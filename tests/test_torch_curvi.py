"""The 1D sphere and 2D cylinder grids and the geometric configurations
against the reference, on the CPU with one torch thread.

- `Sphere1DGrid` and `Cylinder2DGrid`: `locate`, `move_inside` and every
  `step` of a march bit for bit against the reference's inside `jax.jit`
  (its grid tables constants, as in its launch), on seeded rays from
  inside and outside the grid, linear and power meshes; past 2^60 m the
  port's exact power-of-two `shift` (the reference's squares overflow f32
  there) equals the march of the grid scaled down, scaled back.
- The loader on the generated configurations of `chip_smoke.GEOMETRIC`
  array for array against the reference's `load_ski`.
- Draw for draw through `bridge.simulation` against the reference's run,
  within 1e-5 of each maximum: the galaxy of `disk_cyl_small` on its 16 x
  16 cylinder march and the Ivezic shell on its 40-shell sphere march
  (measured ~1e-6), the galaxy on a 16^3 uniform grid march, and on a
  maxLevel-4 density octree with a spiral dust disk on the tree sweep
  (the reference's in interpret mode, `SKIRT9_TPU_FORCE_SWEEP=1`). The
  reference's curvilinear steps overflow f32 past 0.6 kpc, so the cylinder
  configuration is held against it with every length 1000-fold smaller
  (`unit="pc"`); the uniform grid and the tree at their own size.
- DustEmission on the 2D cylinder raises, naming itself; on the 1D
  sphere it loads, its shells launching in their bounding cubes.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skirt9_tpu.config.ski import load_ski as ref_load_ski
from skirt9_tpu.grids import cylinder as r_cyl
from skirt9_tpu.grids import sphere as r_sph
from skirt9_tpu_torch import bridge
from skirt9_tpu_torch.config.ski import load_ski
from skirt9_tpu_torch.grids import cylinder as cyl
from skirt9_tpu_torch.grids import sphere as sph
from skirt9_tpu_torch.kernels import build as kb
from skirt9_tpu_torch.sources import secondary as sec
from skirt9_tpu_torch.transport import march as mr

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

PC = 3.0857e16
EXACT = 1e-5
RB_POW = np.concatenate([[0.0], np.geomspace(1e-3, 1.0, 60)])
ZB_POW = np.sinh(np.linspace(-3, 3, 41)) / np.sinh(3) * 0.4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GRIDS = {
    "sphere_lin": lambda m: m.make_sphere1d(PC, 40),
    "sphere_pow": lambda m: m.make_sphere1d(PC, 60, rb=RB_POW * PC),
    "sphere_rmin": lambda m: m.make_sphere1d(PC, 30, r_min=0.1 * PC),
    "cylinder_lin": lambda m: m.make_cylinder2d(PC, -0.3 * PC, 0.3 * PC, 30,
                                                20),
    "cylinder_pow": lambda m: m.make_cylinder2d(
        PC, -0.4 * PC, 0.4 * PC, 60, 40, rb=RB_POW * PC, zb=ZB_POW * PC),
}


def _rays(B=8192, seed=5, reach=2.5):
    rs = np.random.default_rng(seed)
    d = rs.normal(size=(B, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    p = rs.uniform(-1, 1, (B, 3)) * PC
    p[:B // 3] *= reach        # a third from outside the grid
    return p.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("name", list(GRIDS))
def test_grid_bit_for_bit(name):
    mod_r, mod_p = (r_sph, sph) if name.startswith("sphere") else \
        (r_cyl, cyl)
    rg, pg = GRIDS[name](mod_r), GRIDS[name](mod_p)
    assert pg.shift == 0
    p, d = _rays()
    P, D = torch.tensor(p), torch.tensor(d)
    loc = np.asarray(jax.jit(lambda x: rg.locate(x))(jnp.asarray(p)))
    assert np.array_equal(pg.locate(P).numpy(), loc)
    mi_r = jax.jit(lambda x, y: rg.move_inside(x, y))(jnp.asarray(p),
                                                      jnp.asarray(d))
    mi_p = pg.move_inside(P, D)
    for a, b in zip(mi_r, mi_p):
        assert np.array_equal(np.asarray(a), b.numpy().astype(
            np.asarray(a).dtype))
    step = jax.jit(lambda x, y, c: rg.step(x, y, c))
    pr, cr = mi_r[0], mi_r[1]
    pp, cp = mi_p[0], mi_p[1]
    dj = jnp.asarray(d)
    walked = 0
    for _ in range(rg.max_steps()):
        ds_r, cr, pr = step(pr, dj, cr)
        ds_p, cp, pp = pg.step(pp, D, cp)
        assert np.array_equal(ds_p.numpy(), np.asarray(ds_r))
        assert np.array_equal(cp.numpy(), np.asarray(cr))
        assert np.array_equal(pp.numpy(), np.asarray(pr))
        walked += int((ds_p > 0).sum())
        if bool((cp < 0).all()):
            break
    assert bool((cp < 0).all()) and walked > 2 * len(p)


@pytest.mark.parametrize("kind", ["sphere", "cylinder"])
def test_length_shift_is_exact(kind):
    """A 25 kpc grid (shift 10) marches as the same grid 2^10 times
    smaller, every length scaled back; its steps are finite where the
    reference's squares overflow."""
    kpc = 1e3 * PC
    if kind == "sphere":
        big = sph.make_sphere1d(25 * kpc, 50)
        small = sph.Sphere1DGrid(rb=big.rb * 2.0 ** -10)
    else:
        big = cyl.make_cylinder2d(25 * kpc, -4 * kpc, 4 * kpc, 64, 32)
        small = cyl.Cylinder2DGrid(rb=big.rb * 2.0 ** -10,
                                   zb=big.zb * 2.0 ** -10)
    assert big.shift == 10 and small.shift == 0
    p, d = _rays()
    P, D = torch.tensor(p) * 2.5e4, torch.tensor(d)
    pb, cb, tb = big.move_inside(P, D)
    ps, cs, ts = small.move_inside(P * 2.0 ** -10, D)
    # a miss keeps the sentinel distance 3e38 (and lands nowhere)
    hit = ts < 3e38
    assert torch.equal(cb, cs) and bool(torch.isfinite(pb).all())
    assert torch.equal(pb[hit], ps[hit] * 2.0 ** 10)
    assert torch.equal(tb[hit], ts[hit] * 2.0 ** 10)
    S = min(big.max_steps(), 256)
    mask = cb >= 0
    c1, d1 = mr.march_geometry_plain(big, pb, D, cb, S, mask)
    c2, d2 = mr.march_geometry_plain(small, ps, D, cs, S, mask)
    assert torch.equal(c1, c2) and torch.equal(d1, d2 * 2.0 ** 10)
    assert bool(torch.isfinite(d1).all()) and float(d1.sum()) > 0


CASES = ("disk_cyl_small", "ivezic_sphere1d", "geometric_cartesian",
         "disk_tree_small", "decorated_cyl")
RUN = dict(num_packets=4096, batch_size=4096, max_events=8)


def _path(name, tmp_path):
    over = {} if name in ("ivezic_sphere1d", "geometric_cartesian",
                          "disk_tree_small") else {"unit": "pc"}
    return chip_smoke.geometric_ski(name, tmp_path, **over)


@pytest.mark.parametrize("name", CASES)
def test_loader_matches_reference(name, tmp_path):
    path = _path(name, tmp_path)
    ref = ref_load_ski(path, **RUN)
    port = load_ski(path, device="cpu", **RUN)
    conv = bridge.simulation(ref, "cpu")
    assert type(port.grid) is type(conv.grid)
    for a, b in zip(port.grid, conv.grid):
        if torch.is_tensor(a):
            assert torch.equal(a, b)
        elif name != "disk_tree_small":
            assert a == b
    assert torch.equal(port.medium.nd, conv.medium.nd)
    assert port.options == conv.options
    assert len(port.sources) == len(conv.sources)
    for s, t in zip(port.sources, conv.sources):
        assert type(s) is type(t) and s.luminosity == t.luminosity
        if hasattr(s, "geometry"):
            assert s.geometry == t.geometry
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


@pytest.mark.parametrize("name", CASES[:4])
def test_draw_for_draw(name, tmp_path, monkeypatch):
    tree = name == "disk_tree_small"
    if tree:
        monkeypatch.setenv("SKIRT9_TPU_FORCE_SWEEP", "1")
    ref = ref_load_ski(_path(name, tmp_path), **RUN)
    port = bridge.simulation(ref, "cpu", march=not tree)
    if tree:
        assert type(port._sweep_tabs).__name__ == "MLTables"
        # the reference's f32 tree diagonal overflows at the galaxy's 50
        # kpc (its rf_scale is infinite and its RF 0); the port scales the
        # corners by a power of two: the reference runs at the port's scale
        assert not np.isfinite(ref.rf_scale)
        assert np.isfinite(port.rf_scale) and port.rf_scale > 0
        ref.rf_scale = port.rf_scale
        ref.options = dataclasses.replace(ref.options,
                                          rf_scale=port.rf_scale)
    else:
        assert port._sweep_tabs is None
    marched = []
    plain = mr.march_geometry_plain
    monkeypatch.setattr(mr, "march_geometry_plain",
                        lambda *a: marched.append(a[0]) or plain(*a))
    out_r = ref.run_primary(verbose=False)
    kb.reset_launches()
    out_p = port.run_primary(verbose=False)
    assert kb.LAUNCHES == {k: 0 for k in kb.LAUNCHES}
    assert bool(marched) != tree
    gaps = _gaps(out_r, out_p)
    assert max(gaps.values()) <= EXACT, gaps


def test_decorated_sources_run(tmp_path):
    """A combined, rotated and clipped source on the cylinder (the
    reference's clip rejects on the host and cannot run in its jitted
    launch): the light of every source reaches the instruments."""
    sim = load_ski(chip_smoke.geometric_ski("decorated_cyl", tmp_path),
                   device="cpu", num_packets=1024, batch_size=1024,
                   max_events=4)
    rf, accs = sim.run_primary(verbose=False)
    assert float(rf.sum()) > 0 and float(accs[0]["sed"][1].sum()) > 0
    assert bool(torch.isfinite(accs[1]["frame"]).all())


@pytest.mark.parametrize("grid", ["Sphere1DSpatialGrid",
                                  "Cylinder2DSpatialGrid"])
def test_dust_emission_on_new_grids_raises(grid, tmp_path):
    """DustEmission on the 2D cylinder raises, naming it (the reference has
    no cell bounds there); on the 1D sphere it loads and launches in each
    shell's bounding cube, as the reference does
    (tests/test_torch_dust1d.py runs it against the reference)."""
    if grid.startswith("Sphere"):
        sim = load_ski(chip_smoke.geometric_ski("ivezic_dust_small",
                                                tmp_path),
                       device="cpu", num_packets=128)
        assert type(sim.grid).__name__ == "Sphere1DGrid"
        assert sim.ems_borders is not None
        lo, hi = sec.cell_bounds(sim.grid)
        r = sim.grid.rb.double().numpy()[1:]
        assert np.array_equal(hi, np.stack([r] * 3, -1))
        assert np.array_equal(lo, -hi)
        return
    path = chip_smoke.geometric_ski("disk_cyl_small", tmp_path)
    text = open(path).read()
    mode = 'simulationMode="OligoExtinctionOnly"' if "Sphere" in grid else \
        'simulationMode="ExtinctionOnly"'
    open(path, "w").write(text.replace(mode,
                                       'simulationMode="DustEmission"'))
    with pytest.raises(NotImplementedError, match=f"DustEmission on a {grid}"):
        load_ski(path, device="cpu", num_packets=128)
