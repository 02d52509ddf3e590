"""The clumpy spherical grid (`grids/clumpy.py`, ClumpySphericalSpatialGrid)
against the reference, on the CPU with one torch thread.

- `locate`, `move_inside` bit for bit against the reference's inside
  `jax.jit` (its grid tables constants), and every step of a march against
  the reference's jitted march (`lifecycle.march_geometry`: its steps
  inside the scan, as its life cycle runs them), cells identical and
  lengths bit for bit, on seeded rays from inside and outside, on a grid
  of a few dozen clumps over 8 x 6 x 8 cells (tests/test_clumpy.py's
  size), with an inner radius and power-law meshes too; past 2^60 m the
  port's exact power-of-two shift equals the march of the grid scaled
  down, scaled back.
- The set-up: the retained clumps (inside the shell, no overlap with one
  kept before, first read wins, touching kept) and the Monte Carlo
  volumes equal to the reference's, with its 20,000 samples a clump.
- Its configurations: tests/test_torch_clumpy_runs.py.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from skirt9_tpu.grids import clumpy as rc
from skirt9_tpu.transport import lifecycle as ref_lc
from skirt9_tpu_torch.grids import clumpy as pc
from skirt9_tpu_torch.transport import march as mr


PC = 3.0857e16
RB = np.concatenate([[0.0], np.geomspace(1e-2, 1.0, 10)]) * PC
TB = np.arccos(np.linspace(1, -1, 9))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clumps(n=60, seed=11, lo=0.05, hi=0.2, reach=0.8):
    rs = np.random.default_rng(seed)
    return (rs.uniform(-reach, reach, (n, 3)) * PC,
            rs.uniform(lo, hi, n) * PC)


GRIDS = {
    "lin": lambda m: m.make_clumpy_spherical(PC, 8, 6, 8, *_clumps(),
                                             overlap_samples=500),
    "rmin_pow": lambda m: m.make_clumpy_spherical(
        PC, 10, 8, 7, *_clumps(seed=12), r_min=0.01 * PC, rb=RB, tb=TB,
        overlap_samples=500),
}


def _rays(B=2048, seed=5, reach=2.5):
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
    rg, pg = GRIDS[name](rc), GRIDS[name](pc)
    assert pg.shift == 0 and pg.ncells == rg.ncells and pg.n_clumps > 20
    assert np.array_equal(np.asarray(rg.ccen), pg.ccen.numpy())
    assert np.array_equal(np.asarray(rg.crad), pg.crad.numpy())
    np.testing.assert_array_equal(pg.volumes(), rg.volumes())
    assert pg.max_steps() == rg.max_steps()
    p, d = _rays()
    P, D = torch.tensor(p), torch.tensor(d)
    assert _equal(jax.jit(lambda x: rg.locate(x))(p), pg.locate(P))
    mi_r = jax.jit(lambda x, y: rg.move_inside(x, y))(p, d)
    mi_p = pg.move_inside(P, D)
    for a, b in zip(mi_r, mi_p):
        assert _equal(a, b)
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
    clump_steps = walked & (cells_r < rg.n_clumps)
    assert walked.sum() > 2 * len(p) and clump_steps.sum() > 100


def test_retention_and_volumes():
    """Clumps poking out of the shell or its inner hole dropped, an overlap
    with a kept clump dropped, touching clumps kept, in file order; the
    volumes with the reference's 20,000 samples a clump equal."""
    cen = np.array([[0.5, 0, 0], [-0.4, 0.3, 0], [0.52, 0.05, 0],
                    [0, 0, 0.99], [0.02, 0, 0], [0.5, 0.3, 0],
                    [-0.4, -0.3, 0.5]]) * PC
    rad = np.array([0.1, 0.08, 0.05, 0.05, 0.05, 0.2, 0.1]) * PC
    keep = pc.retained_clumps(cen, rad, 0.05 * PC, PC)
    # [0, 0.3] from clump 0 is 0.3 = 0.1 + 0.2 apart: touching, kept
    assert keep.tolist() == [0, 1, 5, 6]
    rg = rc.make_clumpy_spherical(PC, 8, 6, 8, cen, rad, r_min=0.05 * PC)
    pg = pc.make_clumpy_spherical(PC, 8, 6, 8, cen, rad, r_min=0.05 * PC)
    assert rg.n_clumps == pg.n_clumps == 4
    np.testing.assert_array_equal(pg.volumes(), rg.volumes())
    v = pg.volumes()
    assert (v >= 0).all() and abs(v.sum() / (4 / 3 * np.pi * (
        PC ** 3 - (0.05 * PC) ** 3)) - 1) < 5e-3


def test_length_shift_is_exact():
    """A 25 kpc grid (shift 10) marches as the same grid 2^10 times
    smaller, every length scaled back."""
    k = 2.5e4
    cen, rad = _clumps(30, seed=3)
    big = pc.make_clumpy_spherical(PC * k, 8, 6, 8, cen * k, rad * k,
                                   overlap_samples=200)
    small = pc.make_clumpy_spherical(PC * k * 2.0 ** -10, 8, 6, 8,
                                     cen * k * 2.0 ** -10,
                                     rad * k * 2.0 ** -10,
                                     overlap_samples=200)
    assert big.shift == 10 and small.shift == 0
    assert torch.equal(big.ccen * 2.0 ** -10, small.ccen)
    p, d = _rays(1024)
    P, D = torch.tensor(p) * k, torch.tensor(d)
    pb, cb, tb = big.move_inside(P, D)
    ps, cs, ts = small.move_inside(P * 2.0 ** -10, D)
    hit = ts < 3e38
    assert torch.equal(cb, cs) and torch.equal(pb[hit], ps[hit] * 2.0 ** 10)
    S = min(big.max_steps(), 256)
    mask = cb >= 0
    c1, d1 = mr.march_geometry_plain(big, pb, D, cb, S, mask)
    c2, d2 = mr.march_geometry_plain(small, ps, D, cs, S, mask)
    assert torch.equal(c1, c2) and torch.equal(d1, d2 * 2.0 ** 10)
    assert bool(torch.isfinite(d1).all()) and float(d1.sum()) > 0
