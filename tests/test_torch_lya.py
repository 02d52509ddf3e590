"""The port's Lyman-alpha and Compton physics against the reference.

- `rng.gauss` against `jax.random.normal` over 2^17 keys: XLA's f32
  normal is a uniform on [nextafter(-1, 0), 1) times sqrt(2) erf_inv, and
  XLA's erf_inv evaluates its log1p and Horner steps as fused multiply-adds
  in its own polynomials; `ops.xlamath` replays them operation for
  operation, so that every draw is equal (10^6 of 10^6 draws measured;
  the test allows 2 ulp and holds the exact share at 99.9%).
- `ops.xlamath`'s log, log1p, exp and erf_inv against XLA's bit for bit on
  their normal inputs.
- `ops.lya` function by function on the same inputs: thermal velocity,
  damping parameter, dimensionless frequency, Voigt function and cross
  section bit for bit (XLA's folded constants, single-rounding quotients,
  fused products), `scatter_wavelength` within 1e-6 relative (equal on
  99.99% of the lanes), and `sample_parallel_velocity` on the same keys
  within 1e-6 of max(|u|, |x|, 1) except on the lanes whose rejection test
  flips on an ulp of the C library's tan or atan, which XLA calls and
  PyTorch does not replay (1e-5 of 10^5 lanes measured; at most 1e-3 here).
- `ops.compton`: the Klein-Nishina angle sampler, shifted wavelength and
  x(lambda) bit for bit, the phase function within 1e-6 relative, the KN
  electron mix exactly, and a Compton run through the Python API
  (`tests/test_compton.py:45`'s electron sphere) against the reference's
  within 1e-5 of each SED row's maximum (they agree to ~6e-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skirt9_tpu.ops import compton as ref_co
from skirt9_tpu.ops import lya as ref_lya
from skirt9_tpu.ops import phase as ref_phs
from skirt9_tpu.ops import rng as ref_rng
from skirt9_tpu_torch import bridge
from skirt9_tpu_torch.ops import compton as co
from skirt9_tpu_torch.ops import lya
from skirt9_tpu_torch.ops import phase as phs
from skirt9_tpu_torch.ops import rng
from skirt9_tpu_torch.ops import xlamath as xm

PC = 3.0857e16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys(n: int, seed: int, event: int):
    ref = ref_rng.event_keys(ref_rng.history_keys(jax.random.PRNGKey(seed),
                                                  jnp.arange(n)), event)
    port = rng.event_keys(rng.history_keys(rng.seed_key(seed, "cpu"),
                                           torch.arange(n)), event)
    return ref, port


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


# --------------------------------------------------------------- the normal

@pytest.mark.parametrize("seed,tag", [(0, 65), (3, 1061)])
def test_gauss_matches_jax_normal(seed, tag):
    kr, kp = _keys(1 << 17, seed, 5)
    ref = np.asarray(ref_rng.gauss(kr, tag))
    ours = rng.gauss(kp, tag).numpy()
    assert np.all(np.isfinite(ours))
    assert _ulps(ours, ref).max() <= 2
    assert (ours == ref).mean() >= 0.999
    # a standard normal
    assert abs(ours.mean()) < 0.01 and abs(ours.std() - 1.0) < 0.01


def test_xla_math_replicas_are_bit_exact():
    rs = np.random.default_rng(1)
    n = 200_000
    pos = np.abs(rs.standard_normal(n) * np.exp(rs.uniform(-30, 30, n)))
    pos = pos.astype(np.float32)
    a = np.concatenate([rs.uniform(-0.999, 0.0, n // 2),
                        rs.uniform(-0.5, 3.0, n // 2)]).astype(np.float32)
    e = rs.uniform(-85.0, 85.0, n).astype(np.float32)
    u = rs.uniform(-0.9999999, 0.9999999, n).astype(np.float32)
    for ref_fn, fn, x in ((jnp.log, xm.log_xla, pos),
                          (jnp.log1p, xm.log1p_xla, a),
                          (jnp.exp, xm.exp_xla, e),
                          (jax.lax.erf_inv, xm.erf_inv, u)):
        ref = np.asarray(jax.jit(ref_fn)(x))
        ours = fn(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(ours, ref)


def test_three_uniforms_per_round_key_match_jax():
    """The rejection rounds draw `jax.random.uniform(k, (3,))` under the
    purpose keys tag + 13 i; the port draws them as elements 0-2 of each
    key, all rounds at once."""
    kr, kp = _keys(4096, 2, 7)
    tags = lya.round_tags(64)
    ref = np.stack([np.asarray(jax.vmap(
        lambda k: jax.random.uniform(k, (3,)))(ref_rng.purpose_key(kr, t)))
        for t in tags])
    pk = rng.fold_in(kp.unsqueeze(0), torch.tensor(tags).unsqueeze(1))
    ours = torch.stack([rng.bits_to_unit_exact(rng.draw(pk, j))
                        for j in range(3)], dim=-1).numpy()
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(
        rng.uniform_vec(kp, tags[0], 3).numpy(), ref[0])


# ---------------------------------------------------------------- Lyman-alpha

def _lya_inputs(n=100_000, seed=0):
    rs = np.random.default_rng(seed)
    lam = (ref_lya.LAM0 * (1 + rs.normal(0, 3e-4, n))).astype(np.float32)
    T = np.full(n, 1e4, np.float32)
    return lam, T


def test_lya_cross_section_matches_reference():
    lam, T = _lya_inputs()
    tl, tT = torch.from_numpy(lam), torch.from_numpy(T)
    cases = (
        (lambda l, t: ref_lya.thermal_velocity(t),
         lya.thermal_velocity(tT, tT)),
        (lambda l, t: ref_lya.damping_parameter(t),
         lya.damping_parameter(tT, tT)),
        (lambda l, t: ref_lya.dimensionless_x(l, t),
         lya.dimensionless_x(tl, tT)),
        (lambda l, t: ref_lya.dimensionless_x(l, 1e4),
         lya.dimensionless_x(tl, 1e4)),
        (lambda l, t: ref_lya.voigt_H(ref_lya.damping_parameter(t),
                                      ref_lya.dimensionless_x(l, t)),
         lya.voigt_H(lya.damping_parameter(tT, tT),
                     lya.dimensionless_x(tl, tT))),
        (lambda l, t: ref_lya.cross_section(l, t),
         lya.cross_section(tl, tT)),
        # the resident sweep's form: one uniform temperature as a float
        (lambda l, t: ref_lya.cross_section(l, 1e4),
         lya.cross_section(tl, 1e4)))
    for ref_fn, ours in cases:
        ref = np.asarray(jax.jit(ref_fn)(lam, T))
        np.testing.assert_array_equal(ours.numpy(), ref)
    # line centre: sigma0 H(a, 0) ~ 5.9e-18 m^2 at 1e4 K
    s0 = lya.cross_section(torch.tensor([lya.LAM0], dtype=torch.float32),
                           1e4)
    assert float(s0) == pytest.approx(5.898e-18, rel=2e-3)


def test_sample_parallel_velocity_matches_reference():
    lam, T = _lya_inputs()
    x = np.asarray(jax.jit(ref_lya.dimensionless_x)(lam, T))
    a = np.asarray(jax.jit(ref_lya.damping_parameter)(T))
    kr, kp = _keys(lam.shape[0], 0, 3)
    ref = np.asarray(jax.jit(
        lambda k, a, x: ref_lya.sample_parallel_velocity(k, 64, a, x))(
            kr, a, x))
    ours = lya.sample_parallel_velocity(kp, 64, torch.from_numpy(a.copy()),
                                        torch.from_numpy(x.copy())).numpy()
    scale = np.maximum(np.maximum(np.abs(ref), np.abs(x)), 1.0)
    off = np.abs(ours - ref) / scale > 1e-6
    assert off.mean() <= 1e-3, off.mean()
    assert (ours == ref).mean() > 0.5
    # the |x| >= 8 branch (a Gaussian around 1/x) takes no rejection test
    big = np.abs(x) >= 8.0
    assert big.sum() > 100 and not off[big].any()


def test_scatter_wavelength_matches_reference():
    lam, T = _lya_inputs()
    rs = np.random.default_rng(4)
    unit = lambda v: (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(
        np.float32)
    k_in = unit(rs.normal(size=(lam.shape[0], 3)))
    k_out = unit(rs.normal(size=(lam.shape[0], 3)))
    u_par = rs.normal(size=lam.shape[0]).astype(np.float32)
    u_perp = rs.normal(size=lam.shape[0]).astype(np.float32)
    args = (lam, k_in, k_out, u_par, u_perp, T)
    ref = np.asarray(jax.jit(ref_lya.scatter_wavelength)(*args))
    ours = lya.scatter_wavelength(*(torch.from_numpy(v) for v in args))
    rel = np.abs(ours.numpy() - ref) / ref
    assert rel.max() <= 1e-6 and (rel == 0).mean() > 0.999


def test_dipole_phase_function_matches_reference():
    u = np.random.default_rng(5).uniform(size=100_000).astype(np.float32)
    ref = np.asarray(jax.jit(ref_phs.dipole_sample_costheta)(u))
    ours = phs.dipole_sample_costheta(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-6)
    ct = 2.0 * u - 1.0
    np.testing.assert_allclose(phs.dipole_phase(torch.from_numpy(ct)).numpy(),
                               np.asarray(ref_phs.dipole_phase(ct)),
                               rtol=1e-6)


# ------------------------------------------------------------------ Compton

def test_compton_functions_match_reference():
    rs = np.random.default_rng(0)
    n = 200_000
    u = rs.uniform(size=n).astype(np.float32)
    lam = np.exp(rs.uniform(np.log(1e-12), np.log(1e-8), n)).astype(
        np.float32)
    mu = rs.uniform(-1, 1, n).astype(np.float32)
    tu, tl, tm = (torch.from_numpy(v) for v in (u, lam, mu))
    x = co.x_of_lambda(tl)
    xr = lambda l: ref_co.x_of_lambda(l)
    for ref_fn, args, ours in (
            (xr, (lam,), x),
            (lambda u, l: ref_co.sample_costheta(u, xr(l)), (u, lam),
             co.sample_costheta(tu, x)),
            (lambda l, m: ref_co.shifted_wavelength(l, xr(l), m), (lam, mu),
             co.shifted_wavelength(tl, x, tm))):
        np.testing.assert_array_equal(ours.numpy(),
                                      np.asarray(jax.jit(ref_fn)(*args)))
    ref = np.asarray(jax.jit(lambda l, m: ref_co.phase_value(xr(l), m))(
        lam, mu))
    np.testing.assert_allclose(co.phase_value(x, tm).numpy(), ref,
                               rtol=1e-6)
    ratio = co.sigma_kn_ratio(torch.tensor([1e-6, 1.0, 10.0]))
    np.testing.assert_allclose(ratio.numpy(), np.asarray(
        ref_co.sigma_kn_ratio(jnp.asarray([1e-6, 1.0, 10.0]))), rtol=1e-6)
    mix, ref_mix = co.electron_mix_kn(), ref_co.electron_mix_kn()
    for f in ("lam", "sigma_ext", "albedo", "g"):
        np.testing.assert_array_equal(getattr(mix, f), getattr(ref_mix, f))
    assert mix.mu == ref_mix.mu


def test_compton_run_matches_reference():
    """tests/test_compton.py:45's X-ray line through an electron sphere
    (x = 0.5, Thomson depth 0.6, 8^3, 8,192 packets, 10 events) in the port
    (through `bridge`) and the reference: the same SEDs, redward scattered
    light, nothing blueward of the line."""
    from skirt9_tpu.grids.cartesian import make_cartesian
    from skirt9_tpu.instruments import distant as ref_dinst
    from skirt9_tpu.media import system as ref_msys
    from skirt9_tpu.simulation import Simulation as RefSimulation
    from skirt9_tpu.sources.base import PointSource as RefPointSource
    from skirt9_tpu.transport import lifecycle as ref_lc
    from skirt9_tpu.utils import constants as c
    from skirt9_tpu_torch.instruments import distant as dinst
    from skirt9_tpu_torch.kernels import build as kb

    lam0 = ref_co.X_OF_LAM / 0.5
    grid = make_cartesian(((-PC, PC),) * 3, (8,) * 3)
    sigma = c.SIGMA_THOMSON * 0.6
    nd = ref_msys.uniform_density_sphere(grid, 1.0, sigma, 0.8 * PC)
    lam_t = np.geomspace(lam0 / 10, lam0 * 30, 60)
    med = ref_msys.make_medium(grid, nd, lam_t, np.full((1, 60), sigma),
                               np.ones((1, 60)), np.zeros((1, 60)))
    inst = ref_dinst.DistantInstrumentCfg(
        name="i", wave_borders=tuple(np.geomspace(lam0 * 0.5, lam0 * 20, 31)),
        distance=100 * PC)
    ref = RefSimulation(
        grid=grid, medium=med, sources=[RefPointSource(luminosity=1.0,
                                                       lam0=lam0)],
        instruments=[inst], rf_borders=None, num_packets=8192,
        batch_size=4096, seed=3,
        options=ref_lc.TransportOptions(max_steps=grid.max_steps(),
                                        max_events=10, compton=True,
                                        store_rf=False))
    port = bridge.simulation(ref, device="cpu")
    assert port.options.compton
    _, accs_r = ref.run_primary(verbose=False)
    kb.reset_launches()
    _, accs = port.run_primary(verbose=False)
    assert sum(kb.LAUNCHES.values()) == 0
    ours = accs[0]["sed"].double().numpy()
    theirs = np.asarray(accs_r[0]["sed"], np.float64)
    for k in range(3):
        m = np.abs(theirs[k]).max()
        assert m > 0 and np.abs(ours[k] - theirs[k]).max() <= 1e-5 * m, k
    sed = dinst.calibrate_sed(port.instruments[0], accs[0])
    w, scat = sed["wavelength"], sed["primaryscattered"]
    assert np.sum(w * scat) / scat.sum() > lam0 * 1.2
    assert scat[w < lam0 * 0.95].sum() == 0
