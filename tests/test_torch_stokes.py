"""The port's polarization and moving-medium modules against the reference's.

Inputs come from numpy seeds and go through both packages on the CPU:

- `ops/stokes`: the Mueller tables of `electron_mueller` and
  `rayleigh_like_mueller` bit for bit; `rotate_stokes`, `apply_mueller`,
  `normalize_stokes`, `rotate_normal_into_plane`, `mueller_at`,
  `phase_value` and `s11_norm` in float32 within 1e-6 (relative, or
  absolute for the angles and unit vectors: a few ulps of XLA's and
  PyTorch's transcendental functions apart); `sample_costheta` with the same
  cdf bracket for every lane and cos(theta) within 1e-6; `sample_azimuth`
  within 1e-5 rad where the linear polarization is at most 0.8 (above it
  the six Newton steps need not converge, and a one-ulp change of u moves
  the angle by up to pi: shown by `test_sample_azimuth_is_chaotic_near_
  full_polarization`).
- `geometries/vectorfield` (every field and both decorators),
  `ExpDiskGeometry`, `NumberNormalization` and `electron_mix` in float64,
  within 1e-12 relative.
- `detect_plain` with Stokes against the reference's `detect`, each
  accumulator within 1e-5 of its largest value, the transparent kind
  without Stokes frames; the CUDA wrapper's checks.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skirt9_tpu.geometries import analytic as ref_ga
from skirt9_tpu.geometries import vectorfield as ref_vf
from skirt9_tpu.instruments import distant as ref_dinst
from skirt9_tpu.media import geometric as ref_gm
from skirt9_tpu.media import mixes as ref_mx
from skirt9_tpu.ops import stokes as ref_stk
from skirt9_tpu_torch.geometries import analytic as ga
from skirt9_tpu_torch.geometries import vectorfield as vf
from skirt9_tpu_torch.instruments import distant as dinst
from skirt9_tpu_torch.kernels import build as kb
from skirt9_tpu_torch.media import geometric as gm
from skirt9_tpu_torch.media import mixes as mx
from skirt9_tpu_torch.ops import stokes as stk

PC = 3.0857e16
B = 4096


def _np(t):
    return (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t))


def _f32(rs, *shape, lo=-1.0, hi=1.0):
    return rs.uniform(lo, hi, shape).astype(np.float32)


def _close(ours, ref, tol, rel=True):
    ours, ref = _np(ours).astype(np.float64), _np(ref).astype(np.float64)
    assert ours.shape == ref.shape
    scale = np.maximum(np.abs(ref), 1.0) if rel else 1.0
    err = float(np.max(np.abs(ours - ref) / scale))
    assert err <= tol, err


def _unit(rs, n):
    v = rs.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _stokes(rs, n, pmax=1.0):
    """Normalised Stokes vectors (I = 1) of linear polarization <= pmax."""
    p = rs.uniform(0, pmax, n)
    chi = rs.uniform(0, np.pi, n)
    st = np.zeros((n, 4), np.float32)
    st[:, 0] = 1.0
    st[:, 1] = p * np.cos(2 * chi)
    st[:, 2] = p * np.sin(2 * chi)
    return st


@pytest.mark.parametrize("build", ["electron", "rayleigh"])
def test_mueller_tables_bit_for_bit(build):
    if build == "electron":
        ref, ours = ref_stk.electron_mueller(), stk.electron_mueller()
    else:
        ref = ref_stk.rayleigh_like_mueller(0.7, 91)
        ours = stk.rayleigh_like_mueller(0.7, 91)
    assert ours._fields == ref._fields
    for name in ref._fields:
        a, b = _np(getattr(ours, name)), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b), name
    assert _np(stk.s11_norm(ours)) == pytest.approx(
        np.asarray(ref_stk.s11_norm(ref)), rel=1e-6)


def test_stokes_algebra_matches_reference():
    rs = np.random.default_rng(1)
    st = _f32(rs, B, 4)
    phi = _f32(rs, B, lo=-7.0, hi=7.0)
    S = [_f32(rs, B) for _ in range(4)]
    t = torch.from_numpy
    _close(stk.rotate_stokes(t(st), t(phi)),
           ref_stk.rotate_stokes(jnp.asarray(st), jnp.asarray(phi)), 1e-6)
    _close(stk.apply_mueller(t(st), *map(t, S)),
           ref_stk.apply_mueller(jnp.asarray(st), *map(jnp.asarray, S)),
           1e-6)
    st[:, 0] = rs.uniform(0.1, 2.0, B)
    ours, I = stk.normalize_stokes(t(st))
    ref, I_r = ref_stk.normalize_stokes(jnp.asarray(st))
    _close(ours, ref, 1e-6)
    assert np.array_equal(_np(I), np.asarray(I_r))


def test_rotate_normal_into_plane_matches_reference():
    rs = np.random.default_rng(2)
    k, n0 = _unit(rs, B), _unit(rs, B)
    # normals perpendicular to k, as the scattering event keeps them, and
    # observer directions that include k itself (the degenerate plane)
    n0 = np.cross(k, n0)
    n0 = (n0 / np.linalg.norm(n0, axis=1, keepdims=True)).astype(np.float32)
    kobs = _unit(rs, B)
    # exactly parallel lanes, whose cross product rounds to exactly zero
    k[::17], n0[::17], kobs[::17] = (0, 0, 1), (1, 0, 0), (0, 0, 1)
    phi, pn = stk.rotate_normal_into_plane(*map(torch.from_numpy,
                                                (k, n0, kobs)))
    phi_r, pn_r = ref_stk.rotate_normal_into_plane(*map(jnp.asarray,
                                                        (k, n0, kobs)))
    assert np.all(_np(phi)[::17] == 0.0)
    _close(pn, pn_r, 1e-6, rel=False)
    d = np.abs(_np(phi).astype(np.float64) - np.asarray(phi_r))
    assert float(np.minimum(d, 2 * np.pi - d).max()) <= 1e-5


def test_mueller_at_and_phase_value_match_reference():
    rs = np.random.default_rng(3)
    ref, ours = ref_stk.electron_mueller(), stk.electron_mueller()
    ct = _f32(rs, B)
    ct[:4] = (-1.0, 1.0, 0.0, -0.0)
    h = np.zeros(B, np.int32)
    S = stk.mueller_at(ours, torch.from_numpy(h).long(), torch.from_numpy(ct))
    S_r = ref_stk.mueller_at(ref, jnp.asarray(h), jnp.asarray(ct))
    for a, b in zip(S, S_r):
        _close(a, b, 1e-6, rel=False)
    st = _stokes(rs, B)
    phi = _f32(rs, B, lo=0.0, hi=2 * np.pi)
    norm = np.float32(stk.s11_norm(ours)[0])
    _close(stk.phase_value(S[0], S[1], torch.from_numpy(st),
                           torch.from_numpy(ct), torch.from_numpy(phi),
                           torch.tensor(norm)),
           ref_stk.phase_value(S_r[0], S_r[1], jnp.asarray(st),
                               jnp.asarray(ct), jnp.asarray(phi),
                               jnp.asarray(norm)), 1e-6)


def test_sample_costheta_matches_reference():
    rs = np.random.default_rng(4)
    ref = ref_stk.build_mueller(
        np.linspace(0, np.pi, 61)[None, :].repeat(2, 0),
        np.stack([1 + np.cos(np.linspace(0, np.pi, 61)) ** 2,
                  np.exp(np.cos(np.linspace(0, np.pi, 61)))]),
        np.zeros((2, 61)), np.ones((2, 61)), np.zeros((2, 61)))
    ours = stk.MuellerTables(*(torch.from_numpy(np.asarray(t))
                               for t in ref))
    u = _f32(rs, B, lo=0.0, hi=1.0)
    h = rs.integers(0, 2, B).astype(np.int32)
    ct = stk.sample_costheta(ours, torch.from_numpy(h).long(),
                             torch.from_numpy(u))
    ct_r = ref_stk.sample_costheta(ref, jnp.asarray(h), jnp.asarray(u))
    _close(ct, ct_r, 1e-6, rel=False)
    # the same cdf bracket for every lane: the count of entries below u
    cdf = np.asarray(ref.ct_cdf)
    li = np.array([np.sum(cdf[hh] < uu) for hh, uu in zip(h, u)])
    for c in range(2):
        got = _np(torch.searchsorted(ours.ct_cdf[c],
                                     torch.from_numpy(u[h == c])))
        assert np.array_equal(got, li[h == c])


def test_sample_azimuth_matches_reference():
    """Within 1e-5 rad (modulo 2 pi) where PL <= 0.8."""
    rs = np.random.default_rng(5)
    st = _stokes(rs, B, pmax=0.8)
    ct = _f32(rs, B)
    S11 = (0.5 * (1 + ct * ct)).astype(np.float32)
    S12 = (0.5 * (ct * ct - 1)).astype(np.float32)
    u = _f32(rs, B, lo=0.0, hi=1.0)
    phi = _np(stk.sample_azimuth(*map(torch.from_numpy, (S11, S12, st, u))))
    phi_r = np.asarray(ref_stk.sample_azimuth(*map(jnp.asarray,
                                                    (S11, S12, st, u))))
    assert phi.min() >= 0.0 and phi.max() < 2 * np.pi
    d = np.abs(phi.astype(np.float64) - phi_r)
    assert float(np.minimum(d, 2 * np.pi - d).max()) <= 1e-5


def test_sample_azimuth_is_chaotic_near_full_polarization():
    """With PL at its 0.99 clamp (a fully polarized packet scattered near 90
    degrees) the fixed six Newton steps do not converge: a one-ulp change of
    u moves the azimuth by up to pi in a tenth of the lanes. This is why the
    draw-for-draw comparisons of config 5 hold the polarized sums at bounds
    set by this sensitivity (tests/test_torch_config5.py)."""
    n = 100_000
    g = torch.Generator().manual_seed(0)
    u = torch.rand(n, generator=g)
    st = torch.zeros(n, 4)
    st[:, 0] = st[:, 1] = 1.0
    S11, S12 = torch.full((n,), 0.5), torch.full((n,), -0.4995)
    a = stk.sample_azimuth(S11, S12, st, u)
    b = stk.sample_azimuth(S11, S12, st, torch.nextafter(u, torch.ones(n)))
    d = torch.abs(a - b)
    d = torch.minimum(d, 2 * math.pi - d)
    assert int((d > 1e-3).sum()) > n // 100 and float(d.max()) > 3.0


# -------------------------------------------------- vector fields and media

FIELDS = [
    ("RadialVectorField", dict(unity_radius=0.3 * PC, exponent=1.0)),
    ("RadialVectorField", dict(unity_radius=0.3 * PC, exponent=-0.5)),
    ("RadialVectorField", dict()),
    ("CylindricalVectorField", dict(unity_radius=0.2 * PC, exponent=2.0)),
    ("CylindricalVectorField", dict(unity_radius=0.2 * PC, exponent=-1.0)),
    ("HollowRadialVectorField", dict(zero_radius=0.4 * PC, exponent=0.5)),
    ("HubbleRadialVectorField", dict(turnover_radius=0.5 * PC,
                                     max_radius=1.0 * PC)),
    ("UnidirectionalVectorField", dict(direction=(1.0, -2.0, 0.5))),
]


@pytest.mark.parametrize("name,kw", FIELDS)
def test_vector_fields_match_reference(name, kw):
    rs = np.random.default_rng(6)
    pos = rs.uniform(-1.2 * PC, 1.2 * PC, (2000, 3))
    pos[0] = 0.0
    ours = getattr(vf, name)(**kw).field(pos)
    ref = getattr(ref_vf, name)(**kw).field(pos)
    np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=0.0)


def test_vector_field_decorators_match_reference():
    rs = np.random.default_rng(7)
    pos = rs.uniform(-1.2 * PC, 1.2 * PC, (2000, 3))
    for mod in (vf, ref_vf):
        child = mod.CylindricalVectorField(unity_radius=0.2 * PC,
                                           exponent=1.0)
        rot = mod.RotateVectorFieldDecorator(child=child, alpha=0.3,
                                             beta=1.1, gamma=-0.4)
        off = mod.OffsetVectorFieldDecorator(child=rot, offset=(
            0.1 * PC, -0.2 * PC, 0.05 * PC))
        if mod is vf:
            ours = off.field(pos)
        else:
            ref = off.field(pos)
    np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=0.0)


def test_expdisk_numbernorm_electrons_match_reference():
    rs = np.random.default_rng(8)
    pos = rs.uniform(-1.2 * PC, 1.2 * PC, (5000, 3))
    kw = dict(h_r=0.3 * PC, h_z=0.05 * PC)
    np.testing.assert_allclose(ga.ExpDiskGeometry(**kw).density_np(pos),
                               ref_ga.ExpDiskGeometry(**kw).density_np(pos),
                               rtol=1e-12, atol=0.0)
    # sampled as the reference's jitted launch samples it
    import jax
    from skirt9_tpu.ops import rng as ref_rng
    from skirt9_tpu_torch.ops import rng
    keys = rng.event_keys(rng.history_keys(rng.seed_key(5, "cpu"),
                                           torch.arange(B)), rng.LAUNCH_EVENT)
    want = np.asarray(jax.jit(ref_ga.ExpDiskGeometry(**kw).sample)(
        jnp.asarray(keys.numpy().astype(np.uint32))), np.float64)
    got = ga.ExpDiskGeometry(**kw).sample(keys).numpy().astype(np.float64)
    assert np.all(np.abs(got - want).max(axis=1)
                  <= 1e-6 * np.linalg.norm(want, axis=1))
    assert np.all(got == want, axis=1).mean() > 0.95
    assert ref_rng.LAUNCH_POSITION == rng.LAUNCH_POSITION
    ours, ref = mx.electron_mix(), ref_mx.electron_mix()
    for f in ("lam", "sigma_ext", "albedo", "g"):
        np.testing.assert_allclose(getattr(ours, f), getattr(ref, f),
                                   rtol=1e-12, atol=0.0)
    assert ours.mu == ref.mu
    geo = ga.ExpDiskGeometry(**kw)
    assert gm.NumberNormalization(1.35e60).number_factor(geo, ours) == \
        ref_gm.NumberNormalization(1.35e60).number_factor(
            ref_ga.ExpDiskGeometry(**kw), ref) == 1.35e60


# ------------------------------------------------------------ detection

def _instrument(ref: bool, nb: int, frame: bool):
    mod = ref_dinst if ref else dinst
    return mod.DistantInstrumentCfg(
        name="i", wave_borders=tuple(np.geomspace(0.4e-6, 0.8e-6, nb + 1)),
        distance=100 * PC, npx=16 if frame else 0, npy=12 if frame else 0,
        fovx=4 * PC, fovy=4 * PC, record_polarization=True, stats_scale=1e-3)


@pytest.mark.parametrize("kind,frame", [(2, True), (0, True), (1, False)])
def test_detect_stokes_matches_reference(kind, frame):
    rs = np.random.default_rng(10 + kind)
    nb = 40
    lam = np.exp(rs.uniform(np.log(0.38e-6), np.log(0.82e-6),
                            B)).astype(np.float32)
    pos = rs.uniform(-2.5 * PC, 2.5 * PC, (B, 3)).astype(np.float32)
    contrib = rs.uniform(0, 1e-3, B).astype(np.float32)
    contrib[::13] = 0.0
    active = rs.uniform(size=B) > 0.1
    quv = _f32(rs, B, 3)
    quv[:, 2] = 0.0
    cfg_r, cfg = _instrument(True, nb, frame), _instrument(False, nb, frame)
    acc_r = ref_dinst.detect(cfg_r, ref_dinst.device_tables(cfg_r),
                             ref_dinst.init_accumulators(cfg_r),
                             *(jnp.asarray(a) for a in (lam, pos, contrib)),
                             kind, jnp.asarray(active),
                             stokes_quv=jnp.asarray(quv))
    acc = dinst.init_accumulators(cfg, "cpu")
    kb.reset_launches()
    dinst.detect(cfg, dinst.device_tables(cfg, "cpu"), acc,
                 *(torch.from_numpy(a) for a in (lam, pos, contrib)), kind,
                 torch.from_numpy(active),
                 stokes_quv=torch.from_numpy(quv))
    assert sum(kb.LAUNCHES.values()) == 0
    assert set(acc) == set(acc_r)
    for key, ref in acc_r.items():
        ref = np.asarray(ref, np.float64)
        ours = _np(acc[key]).astype(np.float64)
        m = np.abs(ref).max()
        if key == "frame_stokes" and kind == dinst.KIND_TRANSPARENT:
            assert m == 0.0 and np.abs(ours).max() == 0.0
            continue
        assert m > 0, key
        assert np.abs(ours - ref).max() <= 1e-5 * m, key
    assert np.all(_np(acc["stokes"])[2] == 0.0)
    sed = dinst.calibrate_sed(cfg, acc)
    sed_r = ref_dinst.calibrate_sed(cfg_r, {k: np.asarray(v)
                                            for k, v in acc_r.items()})
    for k in ("Q", "U", "V"):
        np.testing.assert_allclose(sed[k], sed_r[k], rtol=0,
                                   atol=1e-5 * np.abs(sed_r[k]).max())
    if frame:
        qc = dinst.calibrate_stokes_frames(cfg, acc)
        qc_r = ref_dinst.calibrate_stokes_frames(
            cfg_r, {k: np.asarray(v) for k, v in acc_r.items()})
        assert qc.shape == (3, nb, 12, 16)
        np.testing.assert_allclose(qc, qc_r, rtol=0,
                                   atol=1e-5 * max(np.abs(qc_r).max(), 1e-300))


def test_detect_scratch_and_cuda_checks():
    """The scratch holds the Stokes rows and cubes; a CUDA detection of the
    wrong shape raises before any launch."""
    cfg = _instrument(False, 40, True)
    assert dinst.scratch_size(cfg) == 9 * 40 + 4 * 40 * 12 * 16
    plain = _instrument(False, 40, False)
    assert dinst.scratch_size(plain) == 9 * 40
    tabs = dinst.device_tables(cfg, "cpu")
    assert "scratch" not in tabs
    acc = dinst.init_accumulators(cfg, "cpu")
    assert acc["stokes"].shape == (3, 40)
    assert acc["frame_stokes"].shape == (3, 40, 12, 16)
    lam = torch.full((8,), 0.5e-6)
    with pytest.raises(ValueError, match="scratch"):
        dinst._detect_cuda(cfg, tabs, acc, lam, torch.zeros(8, 3),
                           torch.ones(8), 2, torch.ones(8, dtype=torch.bool),
                           torch.zeros(8, 3))
    with pytest.raises(ValueError, match="stokes_quv"):
        dinst._detect_cuda(cfg, tabs, acc, lam, torch.zeros(8, 3),
                           torch.ones(8), 2, torch.ones(8, dtype=torch.bool),
                           torch.zeros(8, 4))
