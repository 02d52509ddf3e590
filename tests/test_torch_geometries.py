"""The port's analytic geometries, decorators and GeometricSource against the
reference's, on the CPU with one torch thread.

- `density_np` of every geometry and decorator within 1e-12 relative of
  the reference's on seeded positions, but the two redistribution
  decorators: their norm is the mean weight of 16,384 set-up draws, ~2% of
  which differ from the reference's by an ulp of XLA's sine or cosine (XLA's
  are not correctly rounded, the port's are), so their densities agree to
  ~1e-10 (held at 1e-9).
- `sample` on 2^14 seeded keys, against the reference's inside `jax.jit`
  (as its launch runs it): each position within 1e-6 of its norm on all
  but 1e-3 of the lanes (measured: none off; 96-99% of the lanes bit for
  bit, the rest an ulp of sine or cosine apart; an offset of a rotated
  spheroid 50%, XLA fusing the nested products otherwise). A clip decorator rejects
  on the host in the reference, which its jitted launch cannot run, so it
  is held against the reference's op-by-op run, the port inside
  `xlamath.eager()`.
- `cell_densities` on a 2D cylinder with the reference's per-cell jitter
  extents, against the reference's, and unlike the isotropic jitter.
- `GeometricSource.launch` against the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skirt9_tpu.geometries import analytic as r_ga
from skirt9_tpu.geometries import axial as r_gax
from skirt9_tpu.geometries import decorators as r_dec
from skirt9_tpu.grids import cylinder as r_cyl
from skirt9_tpu.media import geometric as r_gm
from skirt9_tpu.ops import rng as r_rng
from skirt9_tpu.sources import base as r_src
from skirt9_tpu_torch import bridge
from skirt9_tpu_torch.geometries import analytic as ga
from skirt9_tpu_torch.geometries import decorators as dec
from skirt9_tpu_torch.grids import cylinder as cyl
from skirt9_tpu_torch.media import geometric as gm
from skirt9_tpu_torch.ops import rng, sampling
from skirt9_tpu_torch.ops import xlamath as xm

PC = 3.0857e16
N = 1 << 14


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _geometries(A, X, D):
    """name -> a geometry of the module set (analytic, axial, decorators)."""
    disk = lambda: A.ExpDiskGeometry(h_r=PC, h_z=0.1 * PC)
    return {
        "plummer": A.PlummerGeometry(b=PC),
        "gamma": A.GammaGeometry(b=PC, gamma=1.5),
        "shell": A.ShellGeometry(rmin=0.1 * PC, rmax=PC, p=1.5),
        "uniform_sphere": A.UniformSphereGeometry(rmax=PC),
        "gaussian": A.GaussianGeometry(sigma=PC),
        "expdisk": disk(),
        "sersic": A.SersicGeometry(reff=PC, m=4.0),
        "point": A.PointGeometry(),
        "einasto": A.EinastoGeometry(rs=PC, n=4.0),
        "pseudo_sersic": A.PseudoSersicGeometry(reff=PC, m=2.0),
        "uniform_box": A.UniformBoxGeometry(lx=2 * PC, ly=PC, lz=3 * PC,
                                            cx=0.1 * PC, cz=-PC),
        "mge": A.MultiGaussianExpansionGeometry(
            components=((1.0, PC, 0.5), (2.0, 2 * PC, 0.8))),
        "torus": X.TorusGeometry(rmin=0.05 * PC, rmax=PC, p=1.0, q=2.0,
                                 delta=0.5),
        "conical_shell": X.ConicalShellGeometry(rmin=0.1 * PC, rmax=PC),
        "ttauri": X.TTauriDiskGeometry(rinn=0.01 * PC, rout=PC, rd=0.5 * PC,
                                       zd=0.05 * PC),
        "ring": X.RingGeometry(r0=PC, width=0.2 * PC, hz=0.1 * PC),
        "annulus": X.AnnulusGeometry(rmin=0.5 * PC, rmax=PC,
                                     height=0.2 * PC),
        "donut": X.DonutGeometry(r0=PC, rc=0.25 * PC),
        "broken_expdisk": X.BrokenExpDiskGeometry(
            h_inn=PC, h_out=0.5 * PC, rb=2 * PC, hz=0.2 * PC),
        "paraboloid": X.ParaboloidGeometry(a=PC ** 0.5, zmax=PC),
        "paraboloid_shell": X.ParaboloidShellGeometry(
            a_in=0.7 * PC ** 0.5, a_out=PC ** 0.5, zmax=PC),
        "hyperboloid": X.HyperboloidGeometry(a=0.5 * PC, c=PC, zmax=PC),
        "hyperboloid_shell": X.HyperboloidShellGeometry(
            a_in=0.3 * PC, c_in=PC, a_out=0.5 * PC, c_out=PC, zmax=PC),
        "offset": D.OffsetDecorator(base=A.PlummerGeometry(b=PC),
                                    offset=(PC, -0.5 * PC, 0.2 * PC)),
        "rotate": D.RotateDecorator(base=disk(), alpha=0.3, beta=0.7,
                                    gamma=-0.4),
        "spheroidal": D.SpheroidalDecorator(
            base=A.SersicGeometry(reff=PC, m=4.0), q=0.6),
        "triaxial": D.TriaxialDecorator(base=A.GaussianGeometry(sigma=PC),
                                        p=0.8, q=0.5),
        "sphere_clip": D.SphereClipDecorator(
            base=A.PlummerGeometry(b=PC), radius=0.5 * PC,
            center=(0.1 * PC, 0.0, 0.0)),
        "box_clip": D.BoxClipDecorator(
            base=A.UniformSphereGeometry(rmax=PC), remove_inside=False,
            lo=(-0.5 * PC,) * 3, hi=(0.3 * PC,) * 3),
        "cylinder_clip": D.CylinderClipDecorator(base=disk(),
                                                 radius=0.5 * PC),
        "combine": D.CombineDecorator(first=disk(),
                                      second=A.PlummerGeometry(b=0.3 * PC),
                                      w1=1.0, w2=0.4),
        "clumpy": D.ClumpyDecorator(base=disk(), clump_fraction=0.4,
                                    num_clumps=50, clump_radius=0.05 * PC,
                                    seed=7),
        "spiral": D.SpiralStructureDecorator(
            base=disk(), num_arms=2, pitch_angle=0.314, radius_zero_point=PC,
            perturbation_weight=0.5),
        "spiral_ring": D.SpiralStructureDecorator(
            base=X.RingGeometry(r0=PC, width=0.3 * PC, hz=0.1 * PC),
            num_arms=3, pitch_angle=0.2, radius_zero_point=0.7 * PC,
            phase_zero_point=0.5, perturbation_weight=0.7, index=2),
        "sphe_redistribute": D.SphePowerLawRedistributeDecorator(
            base=A.UniformSphereGeometry(rmax=PC), exponent=1.5,
            min_radius=0.2 * PC),
        "ax_redistribute": D.AxPowerLawRedistributeDecorator(
            base=disk(), exponent=1.0, min_radius=0.3 * PC),
        "offset_spheroidal_rotate": D.OffsetDecorator(
            base=D.RotateDecorator(base=D.SpheroidalDecorator(
                base=disk(), q=0.5), alpha=1.0, beta=0.2), offset=(
                0.0, 0.0, 0.3 * PC)),
    }


NAMES = list(_geometries(r_ga, r_gax, r_dec))
_CACHE = {}


def _pair(name):
    if not _CACHE:
        from skirt9_tpu_torch.geometries import axial as gax
        ref = _geometries(r_ga, r_gax, r_dec)
        port = _geometries(ga, gax, dec)
        _CACHE.update({k: (ref[k], port[k]) for k in ref})
    return _CACHE[name]


def test_bridge_converts_every_geometry():
    for name in NAMES:
        ref, port = _pair(name)
        conv = bridge.geometry(ref)
        assert type(conv) is type(port), name
        assert conv == port, name


@pytest.mark.parametrize("name", NAMES)
def test_density_matches_reference(name):
    ref, port = _pair(name)
    pos = np.random.default_rng(1).normal(scale=PC, size=(4000, 3))
    want = ref.density_np(pos)
    got = port.density_np(pos)
    assert np.abs(want).max() > 0 or name == "point"
    tol = 1e-9 if name.endswith("redistribute") else 1e-12
    np.testing.assert_allclose(got, want, rtol=tol, atol=0.0)
    if hasattr(ref, "_centers"):
        # the clumps' centres, drawn at set-up: an ulp of sine or cosine
        np.testing.assert_allclose(port._centers, ref._centers, rtol=2e-7)


def _keys():
    hk = r_rng.history_keys(jax.random.PRNGKey(3), jnp.arange(N))
    k_ref = r_rng.event_keys(hk, r_rng.LAUNCH_EVENT)
    k = rng.event_keys(rng.history_keys(rng.seed_key(3, "cpu"),
                                        torch.arange(N)), rng.LAUNCH_EVENT)
    assert np.array_equal(np.asarray(k_ref).astype(np.int64), k.numpy())
    return k_ref, k


@pytest.mark.parametrize("name", NAMES)
def test_sample_matches_reference(name):
    ref, port = _pair(name)
    k_ref, k = _keys()
    if "clip" in name:
        want = np.asarray(ref.sample(k_ref), np.float64)
        with xm.eager():
            got = port.sample(k).numpy().astype(np.float64)
    else:
        want = np.asarray(jax.jit(lambda kk: ref.sample(kk))(k_ref),
                          np.float64)
        got = port.sample(k).numpy().astype(np.float64)
    assert got.shape == want.shape == (N, 3)
    norm = np.linalg.norm(want, axis=1)
    off = np.abs(got - want).max(axis=1) > 1e-6 * norm
    assert off.mean() <= 1e-3, (name, off.mean())
    exact = np.all(got == want, axis=1).mean()
    # 96-99% of the lanes bit for bit; the nested offset of a rotated
    # spheroid fuses its products otherwise (50%), still within 1e-6
    assert exact >= (0.4 if name == "offset_spheroidal_rotate" else 0.95), \
        (name, exact)


def test_clip_keeps_the_first_draw_of_a_lane_that_always_fails():
    base = ga.UniformSphereGeometry(rmax=PC)
    clip = dec.SphereClipDecorator(base=base, radius=0.999 * PC)
    _, k = _keys()
    first = base.sample(k)
    got = clip.sample(k)
    inside = torch.linalg.vector_norm(got.double(), dim=-1) < 0.999 * PC
    # nearly every lane fails all 16 rounds and keeps its first draw
    kept = torch.all(got == first, dim=1)
    assert bool(torch.all(kept | ~inside))
    assert float(kept.double().mean()) > 0.9


def test_interp_matches_jnp():
    rs = np.random.default_rng(2)
    xp = np.sort(rs.uniform(0, 1, 50)).astype(np.float32)
    fp = rs.normal(size=50).astype(np.float32)
    x = rs.uniform(-0.2, 1.2, 4096).astype(np.float32)
    want = np.asarray(jax.jit(jnp.interp)(x, xp, fp))
    got = sampling.interp_jnp(torch.tensor(x), torch.tensor(xp),
                              torch.tensor(fp)).numpy()
    assert np.array_equal(got, want)


def test_cell_densities_use_annular_jitter():
    kw = dict(r_max=PC, z_min=-0.3 * PC, z_max=0.3 * PC, nr=12, nz=8)
    rb = np.concatenate([[0.0], np.geomspace(0.01 * PC, PC, 12)])
    rg = r_cyl.make_cylinder2d(**kw, rb=rb)
    pg = cyl.make_cylinder2d(**kw, rb=rb)
    rgeo = r_gax.RingGeometry(r0=0.5 * PC, width=0.05 * PC, hz=0.02 * PC)
    pgeo = bridge.geometry(rgeo)
    want = r_gm.cell_densities(rg, rgeo, samples=8)
    got = gm.cell_densities(pg, pgeo, samples=8)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0.0)
    # the isotropic jitter samples an annular cell far outside itself
    iso = _isotropic(pg, pgeo)
    assert np.abs(iso - want).max() > 0.1 * np.abs(want).max()


def _isotropic(grid, geometry, samples=8):
    """cell_densities with the cube-root-of-volume jitter."""
    centers = grid.cell_centers().numpy().astype(np.float64)
    h = np.cbrt(grid.volumes())[:, None]
    n = 2
    mid = (np.arange(n) + 0.5) / n - 0.5
    off = np.stack([a.ravel() for a in np.meshgrid(mid, mid, mid,
                                                   indexing="ij")], axis=-1)
    return sum(geometry.density_np(centers + o * h) for o in off) / len(off)


def test_geometric_source_launch_matches_reference():
    from skirt9_tpu_torch.sources import base as src
    from skirt9_tpu.spectral import seds as r_seds
    sed = r_seds.blackbody(5000.0)
    ref = r_src.GeometricSource(
        geometry=r_dec.SpheroidalDecorator(
            base=r_ga.SersicGeometry(reff=PC, m=4.0), q=0.6),
        luminosity=3.0, sed=sed, wavelength_bias=0.5)
    port = bridge.source(ref)
    assert isinstance(port, src.GeometricSource)
    k_ref, k = _keys()
    f_ref = jax.jit(lambda kk: ref.launch(ref.tables(), kk, N))(k_ref)
    f = port.launch(port.tables("cpu"), k, N)
    for key in ("pos", "dir", "lam", "lum"):
        a = np.asarray(f_ref[key], np.float64)
        b = f[key].numpy().astype(np.float64)
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6 * np.abs(
            a).max(), err_msg=key)
    with pytest.raises(NotImplementedError, match="wavelengthBias"):
        dataclasses.replace(port, bias_dist=object())
