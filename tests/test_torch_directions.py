"""Directions and fused multiply-adds bit for bit with the reference, on the
CPU.

- `ops.xlamath.sincos`, glibc 2.36's sinf and cosf written out (the
  __sinf_fma and __cosf_fma variants that x86-64 glibc picks on a CPU with
  FMA and AVX2), bit for bit against the C library itself
  (`xlamath.libm_f32`) and the reference's jitted `jnp.sin`/`jnp.cos` on
  2^20 seeded f32 in [0, 4 pi] and the edge values of each branch;
  `xlamath.fma64` against exact rational arithmetic.
- Launch directions (`rng.isotropic_direction`) bit for bit against the
  reference's, jitted and op by op (`xlamath.eager()`), and scattering
  directions (`phase.hg_scatter`) bit for bit against those of the
  reference's life cycle, recorded by a `jax.debug.callback` spy, on every
  lane, the last 8 of the array included (the scalar tail of XLA's
  vectorised loop, which fuses the rotation's other product), at batches
  of 512 and 384 lanes.
- Every argument that the port's direction, geometry, Stokes and
  Lyman-alpha sites hand `sincos` lies inside [-4 pi, 4 pi], inside its
  exact range (|x| < 120); past it (the polarized azimuth sampler's Newton
  iterates) it is within an ulp of glibc's.
- The older grids' steps (`UniformCartesianGrid`, `CartesianGrid`,
  `OctreeGrid`, `Sphere1DGrid`, `Cylinder2DGrid`, `VoronoiGrid`,
  `AMRGrid`) fuse through `xlamath.fma_rn`, rounded once as the march
  kernel's fmaf, never `fma`, which rounds twice on seeded f32 midpoint
  cases.
"""

import math
import os
import sys
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skirt9_tpu.config.ski import load_ski as ref_load_ski
from skirt9_tpu.ops import rng as ref_rng
from skirt9_tpu.transport import lifecycle as ref_lc
from skirt9_tpu_torch.ops import phase as phs
from skirt9_tpu_torch.ops import rng
from skirt9_tpu_torch.ops import stokes as stk
from skirt9_tpu_torch.ops import xlamath as xm
from skirt9_tpu_torch.transport import lifecycle as lc
from skirt9_tpu_torch.transport import march as mr

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

F32 = np.float32


def _bits(a) -> np.ndarray:
    return np.asarray(a, F32).view(np.int32)


def _edges() -> np.ndarray:
    """0 and -0, subnormals, multiples of pi/4 up to 4 pi and their
    neighbours, and the ends of each branch: |x| = 2^-12 (t itself), 0.75
    (the polynomials alone), the quadrant switches at odd multiples of
    pi/4, and 120 (the last of reduce_fast)."""
    v = [0.0, -0.0, 1e-45, -1e-45, 1e-40, 1.1754942e-38, 2.0 ** -126]
    v += [k * math.pi / 4 for k in range(-16, 17)]
    v += [2.0 ** -12, 0.75, 119.99999, 100.0, 3.0 * math.pi, 2.0 ** -20]
    v = np.asarray(v, F32)
    up, down = np.nextafter(v, F32(np.inf)), np.nextafter(v, F32(-np.inf))
    out = np.concatenate([v, up, down, -v, -up, -down])
    return out[np.abs(out) < 120]


def test_sincos_equals_glibc_and_xla():
    rs = np.random.default_rng(21)
    y = np.concatenate([rs.uniform(0, 4 * math.pi, 1 << 20).astype(F32),
                        _edges()])
    s, c = xm.sincos(torch.tensor(y))
    assert np.array_equal(_bits(s), _bits(xm.libm_f32("sinf", y)))
    assert np.array_equal(_bits(c), _bits(xm.libm_f32("cosf", y)))
    assert np.array_equal(_bits(s), _bits(jax.jit(jnp.sin)(y)))
    assert np.array_equal(_bits(c), _bits(jax.jit(jnp.cos)(y)))
    # the parent's f64 rounding parts from glibc on some of them
    assert not np.array_equal(_bits(torch.tensor(y).double().cos().float()),
                              _bits(c))


def test_fma64_rounds_once():
    rs = np.random.default_rng(4)
    n = 3000
    a = rs.normal(size=n) * 2.0 ** rs.integers(-30, 30, n)
    b = rs.normal(size=n) * 2.0 ** rs.integers(-30, 30, n)
    c = -a * b * (1 + rs.normal(size=n) * 2.0 ** -rs.integers(20, 60, n))
    c[: n // 3] = rs.normal(size=n // 3)
    got = xm.fma64(*(torch.tensor(t) for t in (a, b, c))).numpy()
    want = [float(Fraction(x) * Fraction(y) + Fraction(z))
            for x, y, z in zip(a, b, c)]
    assert np.array_equal(got, np.asarray(want))
    assert not np.array_equal(got, a * b + c)


@pytest.fixture(scope="module")
def keys():
    hist = np.random.default_rng(0).integers(0, 2 ** 31 - 1, 1 << 16)
    hk_r = ref_rng.history_keys(jax.random.PRNGKey(7),
                                jnp.asarray(hist.astype(np.int32)))
    hk = rng.history_keys(rng.seed_key(7, "cpu"), torch.tensor(hist))
    return hk_r, hk


def test_launch_directions_bit_for_bit(keys):
    hk_r, hk = keys
    want = np.asarray(jax.jit(lambda k: ref_rng.isotropic_direction(k, 3))(
        hk_r))
    assert np.array_equal(_bits(rng.isotropic_direction(hk, 3)), _bits(want))
    # op by op, as the reference's set-up draws run
    want = np.asarray(ref_rng.isotropic_direction(hk_r, 3))
    with xm.eager():
        got = rng.isotropic_direction(hk, 3)
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("batch", [512, 384])
def test_scattering_directions_in_life_cycle(tmp_path, monkeypatch, batch):
    """The reference's HG scatterings as its jitted life cycle forms them,
    recorded with their inputs, against the port's on the same inputs,
    every lane."""
    rec = []
    orig = ref_lc.hg_scatter_direction

    def spy(keys, g_sel, dirn):
        out = orig(keys, g_sel, dirn)
        jax.debug.callback(lambda *a: rec.append([np.asarray(x) for x in a]),
                           keys, g_sel, dirn, out)
        return out

    monkeypatch.setattr(ref_lc, "hg_scatter_direction", spy)
    ref = ref_load_ski(chip_smoke.mesh_ski("torus_sphere2d_small", tmp_path),
                       num_packets=2 * batch, batch_size=batch,
                       max_events=3)
    ref.run_primary(verbose=False)
    assert len(rec) >= 4
    for k, g, dirn, want in rec:
        hk = torch.tensor(k.astype(np.int64))
        got = lc.hg_scatter_direction(
            rng.uniform(hk, ref_lc._TAG_SCATTER_CT),
            rng.uniform(hk, ref_lc._TAG_SCATTER_PHI), torch.tensor(g),
            torch.tensor(dirn)).numpy()
        assert got.shape == want.shape == (batch, 3)
        assert np.array_equal(_bits(got), _bits(want))


def test_sincos_sites_inside_exact_range(tmp_path, monkeypatch):
    """Each site's arguments, recorded by a spy on `xlamath.sincos`: the
    launch and scattering directions, the geometric sources' azimuths, the
    Stokes rotation, the polarized phase function and the Lyman-alpha
    velocity draw lie inside [-4 pi, 4 pi], well inside glibc's fast
    reduction (|x| < 120). The polarized azimuth sampler's Newton iterates
    run far past it at the most polarized packets (the reference's six
    Newton steps are chaotic there); past 120 `sincos` is f64's sine and
    cosine rounded to f32, within an ulp of glibc's."""
    seen = {}
    orig = xm.sincos

    def spy(t):
        f = sys._getframe(1)
        while f.f_code.co_filename.endswith("xlamath.py"):
            f = f.f_back
        site = f"{os.path.basename(f.f_code.co_filename)}:{f.f_code.co_name}"
        lo, hi = seen.get(site, (math.inf, -math.inf))
        if t.numel():
            seen[site] = (min(lo, float(t.min())), max(hi, float(t.max())))
        return orig(t)

    monkeypatch.setattr(xm, "sincos", spy)
    sim = chip_smoke.mesh_config("torus_sphere2d_small", "cpu", tmp_path,
                                 num_packets=512, batch_size=512)
    sim.run_primary(verbose=False)
    from skirt9_tpu_torch.geometries import analytic
    analytic.polar(torch.ones(8), torch.linspace(0, 2 * math.pi, 8),
                   torch.zeros(8))
    rs = np.random.default_rng(8)
    B = 4096
    u = torch.tensor(rs.random(B).astype(F32))
    st = torch.tensor(np.stack([np.ones(B), *rs.uniform(-1, 1, (2, B)),
                                np.zeros(B)], -1).astype(F32))
    st[:, 1:3] /= st[:, 1:3].norm(dim=1, keepdim=True)
    S11 = torch.ones(B)
    S12 = torch.tensor(rs.choice([-1.0, 1.0], B).astype(F32))
    phi = stk.sample_azimuth(S11, S12, st, u)
    stk.rotate_stokes(st, phi)
    stk.phase_value(S11, S12, st, u, phi - math.pi, torch.ones(B))
    xm.cos((2.0 * math.pi) * u)
    for site in ("rng.py:isotropic_direction", "phase.py:rotate_direction",
                 "analytic.py:polar", "stokes.py:sample_azimuth",
                 "stokes.py:rotate_stokes", "stokes.py:phase_value"):
        assert site in seen, (site, seen)
    for site, (lo, hi) in seen.items():
        if site != "stokes.py:sample_azimuth":
            assert -4 * math.pi <= lo and hi <= 4 * math.pi, (site, lo, hi)
    assert float(phi.min()) >= 0 and float(phi.max()) < 2 * math.pi
    big = np.concatenate([rs.uniform(120, 5e6, 4096),
                          -rs.uniform(120, 5e6, 4096)]).astype(F32)
    s, c = orig(torch.tensor(big))
    for got, name in ((s, "sinf"), (c, "cosf")):
        want = xm.libm_f32(name, big)
        ulp = np.spacing(np.abs(want).astype(F32))
        assert (np.abs(got.numpy().astype(np.float64) - want) <= ulp).all()


def _midpoints(n: int, seed: int):
    """Seeded f32 triples (a, b, c) whose a b + c lies just below an f32
    midpoint between an odd and an even neighbour, nearer than an f64 ulp:
    rounded once (fmaf) it goes down; through f64 (`xlamath.fma`) it lands
    on the midpoint and ties up to the even one."""
    m = np.random.default_rng(seed).integers(1, 200, n)
    e = np.random.default_rng(seed + 1).integers(-20, 20, n)
    scale = 2.0 ** e
    a = (2.0 ** -24 * (1 + m * 2.0 ** -23) * scale).astype(F32)
    b = (1 - m * 2.0 ** -23).astype(F32)
    c = ((1 + 2.0 ** -23) * scale).astype(F32)
    return a, b, c


def test_fma_rn_rounds_midpoints_once():
    a, b, c = _midpoints(512, 3)
    want = []
    for x, y, z in zip(a, b, c):
        v = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(v))
        lo = lo if Fraction(float(lo)) <= v else np.nextafter(
            lo, np.float32(-np.inf))
        hi = np.nextafter(lo, np.float32(np.inf))
        dl, dh = v - Fraction(float(lo)), Fraction(float(hi)) - v
        want.append(lo if dl < dh or (dl == dh and not (
            lo.view(np.int32) & 1)) else hi)
    want = np.asarray(want, F32)
    A, B, C = (torch.tensor(t) for t in (a, b, c))
    assert np.array_equal(_bits(xm.fma_rn(A, B, C)), _bits(want))
    assert (_bits(xm.fma(A, B, C)) != _bits(want)).all()
    # the moves of move_inside on x and y (the adaptive mesh's steps)
    t = torch.tensor(a)
    d = torch.tensor(np.stack([b, b, b], 1))
    pos = torch.tensor(np.stack([c, c, c], 1))
    moved = xm.move_xy_fused(pos, t, d)
    assert np.array_equal(_bits(moved[:, :2]), _bits(np.stack([want] * 2,
                                                              1)))


PC = 3.0857e16
EXT = ((-1.2 * PC, 1.2 * PC),) * 3


def _dens(p):
    r = np.linalg.norm(p, axis=-1)
    return np.where(r < PC, (PC / np.maximum(r, 0.1 * PC)) ** 2, 0.0)


def _older_grid(name):
    from skirt9_tpu_torch.grids import bintree, cartesian, cylinder, octree
    from skirt9_tpu_torch.grids import sphere, voronoi
    rs = np.random.default_rng(2)
    return {
        "uniform": lambda: cartesian.make_cartesian(EXT, (6, 5, 4)),
        "mesh": lambda: cartesian.make_cartesian(EXT, (6, 5, 4),
                                                 force_general=True),
        "voronoi": lambda: voronoi.build_voronoi(
            rs.uniform(-PC, PC, (60, 3)), EXT, lookup_res=8),
        "octree": lambda: octree.build_octree(EXT, _dens, max_level=3,
                                              min_level=1,
                                              max_fraction=2e-2),
        "bintree": lambda: bintree.build_bintree(EXT, _dens, max_level=6,
                                                 min_level=3,
                                                 max_fraction=2e-2),
        "sphere1d": lambda: sphere.make_sphere1d(PC, 8, r_min=0.1 * PC),
        "cylinder2d": lambda: cylinder.make_cylinder2d(PC, -PC, PC, 6, 6),
    }[name]()


@pytest.mark.parametrize("name", ["uniform", "mesh", "voronoi", "octree",
                                  "bintree", "sphere1d", "cylinder2d"])
def test_older_grid_steps_fuse_once(name, monkeypatch):
    """A march and a move_inside of each older grid run through
    `xlamath.fma_rn` and never call `fma`: the march kernel's fmaf and the
    plain version round the same on the midpoint cases above."""
    grid = _older_grid(name)
    calls = []
    rn = xm.fma_rn
    monkeypatch.setattr(xm, "fma_rn",
                        lambda *a: calls.append(1) or rn(*a))

    def no_fma(*a):
        raise AssertionError("a grid step called the twice-rounding fma")

    monkeypatch.setattr(xm, "fma", no_fma)
    rs = np.random.default_rng(9)
    d = rs.normal(size=(512, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    P = torch.tensor(rs.uniform(-1.5 * PC, 1.5 * PC, (512, 3)).astype(F32))
    D = torch.tensor(d.astype(F32))
    pos, cell, _ = grid.move_inside(P, D)
    moved = len(calls)
    cells, ds = mr.march_geometry_plain(grid, pos, D, cell,
                                        min(grid.max_steps(), 64),
                                        cell >= 0)
    assert len(calls) > moved and float(ds.sum()) > 0
