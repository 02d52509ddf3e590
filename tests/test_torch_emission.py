"""The port's config-2 modules against the JAX package, one by one, on the CPU.

Inputs come from numpy seeds and go through both packages; random draws use
the same threefry keys on both sides (the port's `ops/rng.py` is bit-exact
with `jax.random`). Bounds:
- copied host modules (`spectral/wavelengths`, `media/mixes`, the SED and
  cdf builds, `media/geometric`, `_strata_for`): identical arrays;
- the Planck function and the SED tables on tensors: 1e-6 relative;
- `_sample_wavelength` (plain and stratified): wavelengths within 1e-6
  relative; weights within 1e-5 of the larger of their own size and the
  mean weight, within 1e-4 relative on every lane, and their sum within
  1e-6. The weight interpolates the SED's pdf as a power law, exp of a
  log up to ~20 in size, so one ulp of difference between XLA's and
  PyTorch's CPU log and exp gives a few 1e-6 (2.6e-6 at the 99th
  percentile of config 2's strata), and up to 4.3e-5 on lanes deep in the
  Wien tail that carry 1e-10 of the mean weight;
- the equilibrium temperatures (1.7e-6 measured) and luminosities, and
  the secondary launch: 1e-5 relative (f32 products and sums run in other
  orders in XLA and PyTorch), the launch cdfs 1e-5 absolute (1.4e-6
  measured);
- the emission spectra: 1e-4 relative where they exceed 1e-6 of the
  cell's largest value. B_lambda(T) on the Wien side turns the
  temperatures' 1.7e-6 into x = hc / (lambda k T) (up to ~15 there) times
  as much: 4.8e-5 measured.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skirt9_tpu.emission import equilibrium as ref_eq
from skirt9_tpu.geometries import analytic as ref_ga
from skirt9_tpu.grids.cartesian import make_cartesian as ref_cartesian
from skirt9_tpu.media import geometric as ref_gm
from skirt9_tpu.media import mixes as ref_mx
from skirt9_tpu.ops import planck as ref_planck
from skirt9_tpu.ops import rng as ref_rng
from skirt9_tpu.sources import base as ref_src
from skirt9_tpu.sources import secondary as ref_sec
from skirt9_tpu.spectral import seds as ref_seds
from skirt9_tpu.spectral import wavelengths as ref_wl
from skirt9_tpu_torch import bridge
from skirt9_tpu_torch.emission import equilibrium as eq
from skirt9_tpu_torch.geometries import analytic as ga
from skirt9_tpu_torch.grids.cartesian import make_cartesian
from skirt9_tpu_torch.kernels import build as kb
from skirt9_tpu_torch.media import geometric as gm
from skirt9_tpu_torch.media import mixes as mx
from skirt9_tpu_torch.ops import planck
from skirt9_tpu_torch.ops import rng
from skirt9_tpu_torch.ops import xlamath as xm
from skirt9_tpu_torch.sources import base as src
from skirt9_tpu_torch.sources import secondary as sec
from skirt9_tpu_torch.spectral import seds
from skirt9_tpu_torch.spectral import wavelengths as wl

PC = 3.08567758149e16
UM = 1e-6
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
MRN = os.path.join(GOLDEN, "mrn_mean.txt")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _close(a, b, rtol, what="", floor=0.0):
    """max |a - b| / max(|b|, floor * max|b| of b's last axis) <= rtol."""
    a, b = np.asarray(_np(a), np.float64), np.asarray(_np(b), np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    top = np.max(np.abs(b), axis=-1, keepdims=True) if b.ndim else abs(b)
    scale = np.maximum(np.maximum(np.abs(b), floor * top), 1e-300)
    err = np.max(np.abs(a - b) / scale) if a.size else 0.0
    assert err <= rtol, (what, err)


def _close_weights(a, b, what="lum"):
    """Packet weights: 1e-5 of max(|b|, mean |b|), 1e-4 relative on every
    lane, sums 1e-6."""
    a, b = np.asarray(_np(a), np.float64), np.asarray(_np(b), np.float64)
    d = np.abs(a - b)
    assert (d / np.maximum(np.abs(b), np.abs(b).mean())).max() <= 1e-5, what
    assert (d / np.maximum(np.abs(b), 1e-300)).max() <= 1e-4, what
    assert abs(a.sum() / b.sum() - 1.0) <= 1e-6, what


def _keys(B, seed=0):
    """The same launch keys (B, 2) on both sides."""
    rk = ref_rng.event_keys(
        ref_rng.history_keys(jax.random.PRNGKey(seed),
                             jnp.arange(B, dtype=jnp.int32)),
        ref_rng.LAUNCH_EVENT)
    pk = rng.event_keys(rng.history_keys(rng.seed_key(seed, "cpu"),
                                         torch.arange(B)), rng.LAUNCH_EVENT)
    assert np.array_equal(_np(pk), np.asarray(rk, np.int64))
    return rk, pk


def _bench2_sed(ref: bool):
    mod = ref_seds if ref else seds
    return mod.clipped(mod.blackbody(5778.0), 0.09 * UM, 100 * UM)


# --------------------------------------------------------- host copies


@pytest.mark.parametrize("lo,hi,n", [(0.09 * UM, 100 * UM, 25),
                                     (1 * UM, 2000 * UM, 40),
                                     (0.5 * UM, 0.6 * UM, 1)])
def test_wavelength_borders_identical(lo, hi, n):
    assert np.array_equal(wl.log_borders_skirt(lo, hi, n),
                          ref_wl.log_borders_skirt(lo, hi, n))
    assert np.array_equal(wl.lin_borders_skirt(lo, hi, n),
                          ref_wl.lin_borders_skirt(lo, hi, n))


def test_mix_from_file_and_stack_identical():
    m, r = mx.from_file(MRN), ref_mx.from_file(MRN)
    for f in ("lam", "sigma_ext", "albedo", "g"):
        assert np.array_equal(getattr(m, f), getattr(r, f)), f
    assert m.mu == r.mu and m.at(0.55 * UM) == r.at(0.55 * UM)
    for a, b in zip(mx.stack([m]), ref_mx.stack([r])):
        assert np.array_equal(a, b)


def test_blackbody_sed_and_tables():
    p, r = _bench2_sed(False), _bench2_sed(True)
    assert np.array_equal(p.lam, r.lam) and np.array_equal(p.s, r.s)
    assert seds.integrate(p) == ref_seds.integrate(r)
    n_p, n_r = seds.normalized(p, 3.0), ref_seds.normalized(r, 3.0)
    assert np.array_equal(n_p.s, n_r.s)
    pt, rt = p.tables("cpu"), r.tables()
    for k in ("lam", "cdf", "pdf"):
        _close(pt[k], rt[k], 1e-6, k)
    T = torch.tensor([20.0, 300.0, 5778.0])[:, None]
    lam = torch.tensor(np.geomspace(0.1, 1000, 64) * UM, dtype=torch.float32)
    _close(planck.b_lambda(lam[None, :], T),
           ref_planck.b_lambda(jnp.asarray(_np(lam))[None, :],
                               jnp.asarray(_np(T))), 1e-6, "b_lambda")
    assert planck.integrated_b(300.0) == ref_planck.integrated_b(300.0)


# ----------------------------------------------------- wavelength sampling


@pytest.mark.parametrize("xi", [0.0, 0.5])
def test_sample_wavelength(xi):
    B = 4096
    rk, pk = _keys(B)
    p_src = src.PointSource(luminosity=3.0, sed=_bench2_sed(False),
                            wavelength_bias=xi)
    r_src = ref_src.PointSource(luminosity=3.0, sed=_bench2_sed(True),
                                wavelength_bias=xi)
    # the reference runs op by op here, outside jax.jit: so does the port
    with xm.eager():
        f_p = p_src.launch(p_src.tables("cpu"), pk, B)
    f_r = r_src.launch(r_src.tables(), rk, B)
    for k in ("lam", "dir"):
        _close(f_p[k], f_r[k], 1e-6, k)
    _close_weights(f_p["lum"], f_r["lum"])


@pytest.mark.parametrize("peel", [True, False])
def test_sample_wavelength_stratified(peel):
    """The bench2 source over config 2's 25-bin RF grid: the strata of
    `_strata_for`, padded to 32, and one partial batch's corrections."""
    from skirt9_tpu.simulation import Simulation as RefSimulation
    rf_b = wl.log_borders_skirt(0.09 * UM, 100 * UM, 25)
    sim = RefSimulation.__new__(RefSimulation)
    sim._sweep_tabs, sim.rf_borders = object(), rf_b
    r_src = ref_src.PointSource(luminosity=3.0, sed=_bench2_sed(True))

    class _Opts:
        store_rf, peel_off = True, peel

    borders, bin_map = sim._strata_for(r_src, _Opts)
    assert len(bin_map) == 32
    B, R = 4096, len(bin_map)
    w = np.random.default_rng(3).uniform(0.5, 2.0, R)
    rk, pk = _keys(B, seed=5)
    rt = dict(r_src.tables(), strata=jnp.asarray(borders, jnp.float32),
              strata_w=jnp.asarray(w, jnp.float32))
    p_src = src.PointSource(luminosity=3.0, sed=_bench2_sed(False))
    pt = dict(p_src.tables("cpu"),
              strata=torch.tensor(borders, dtype=torch.float32),
              strata_w=torch.tensor(w, dtype=torch.float32))
    f_p, f_r = p_src.launch(pt, pk, B), r_src.launch(rt, rk, B)
    _close(f_p["lam"], f_r["lam"], 1e-6, "lam")
    _close_weights(f_p["lum"], f_r["lum"])
    # the forward cdf the strata are built on
    x = torch.tensor(borders, dtype=torch.float32)
    _close(src._cdf_at(pt["sed"], x),
           ref_src._cdf_at(rt["sed"], jnp.asarray(borders, jnp.float32)),
           1e-6, "cdf_at")


# ------------------------------------------------------------ media


def _grids(n=8):
    ext = ((-1.2 * PC, 1.2 * PC),) * 3
    return make_cartesian(ext, (n,) * 3), ref_cartesian(ext, (n,) * 3)


def test_shell_medium_identical():
    pg, rg = _grids()
    args = dict(rmin=1e-6 * PC, rmax=1.0 * PC, p=0.0)
    pgeo, rgeo = ga.ShellGeometry(**args), ref_ga.ShellGeometry(**args)
    pts = np.random.default_rng(1).normal(size=(500, 3)) * PC
    assert np.array_equal(pgeo.density_np(pts), rgeo.density_np(pts))
    # sampled as the reference's jitted launch samples it
    keys = rng.event_keys(rng.history_keys(rng.seed_key(2, "cpu"),
                                           torch.arange(4096)),
                          rng.LAUNCH_EVENT)
    want = np.asarray(jax.jit(rgeo.sample)(
        jnp.asarray(keys.numpy().astype(np.uint32))), np.float64)
    got = pgeo.sample(keys).numpy().astype(np.float64)
    assert np.all(np.abs(got - want).max(axis=1)
                  <= 1e-6 * np.linalg.norm(want, axis=1))
    assert np.all(got == want, axis=1).mean() > 0.95
    assert np.array_equal(gm.cell_densities(pg, pgeo, samples=8),
                          ref_gm.cell_densities(rg, rgeo, samples=8))
    norm_p = gm.OpticalDepthNormalization(tau=2.0, lam=0.55 * UM, axis="z")
    norm_r = ref_gm.OpticalDepthNormalization(tau=2.0, lam=0.55 * UM, axis="z")
    pm = gm.build_medium(pg, [(pgeo, mx.from_file(MRN), norm_p)])
    rm = ref_gm.build_medium(rg, [(rgeo, ref_mx.from_file(MRN), norm_r)])
    for f in ("nd", "lam_t", "sigma_ext", "sigma_sca", "g"):
        assert np.array_equal(_np(getattr(pm, f)), np.asarray(getattr(rm, f))), f
    assert np.array_equal(pg.volumes(), rg.volumes())
    for a, b in zip(pg.cell_bounds(), rg.cell_bounds()):
        assert np.array_equal(a, b)


# ------------------------------------------------ emission and secondary


@pytest.fixture(scope="module")
def emission_case():
    """An 8^3 MRN medium, config 2's RF and emission grids, and a random
    RF of bench2's magnitude, on both sides."""
    pg, rg = _grids()
    rs = np.random.default_rng(7)
    nd = rs.uniform(0.0, 2e5, (pg.ncells, 1)).astype(np.float32)
    nd[::9] = 0.0
    lam, se, al, gg = ref_mx.stack([ref_mx.from_file(MRN)])
    from skirt9_tpu.media import system as ref_msys
    rm = ref_msys.make_medium(rg, nd, lam, se, al, gg)
    pm = bridge.medium(rm)
    rf_b = wl.log_borders_skirt(0.09 * UM, 100 * UM, 25)
    ems_b = wl.log_borders_skirt(1 * UM, 2000 * UM, 40)
    rf = (rs.uniform(0.0, 1.0, (pg.ncells, 25)) ** 3).astype(np.float32)
    return dict(pg=pg, rg=rg, pm=pm, rm=rm, rf_b=rf_b, ems_b=ems_b, rf=rf,
                rf_scale=4.696135667686701e42,
                pt=eq.build_emission_tables(pm, rf_b, ems_b),
                rt=ref_eq.build_emission_tables(rm, rf_b, ems_b))


def test_emission_tables(emission_case):
    c = emission_case
    for f in ref_eq.EmissionTables._fields:
        assert np.array_equal(_np(getattr(c["pt"], f)),
                              np.asarray(getattr(c["rt"], f))), f


def test_equilibrium_host(emission_case):
    c = emission_case
    vols = c["pg"].volumes()
    rf_t = torch.tensor(c["rf"])
    p_abs = eq.absorbed_power(c["pm"], c["pt"], rf_t, vols, c["rf_scale"])
    r_abs = ref_eq.absorbed_power(c["rm"], c["rt"], c["rf"], vols,
                                  c["rf_scale"])
    _close(p_abs, r_abs, 1e-12, "p_abs")
    p_cmb = eq.cmb_heating_power(c["pt"], 2.725)
    _close(p_cmb, ref_eq.cmb_heating_power(c["rt"], 2.725), 1e-12, "cmb")
    _close(eq.equilibrium_temperature(c["pt"], p_abs, p_cmb),
           ref_eq.equilibrium_temperature(c["rt"], r_abs, p_cmb), 1e-12, "T")
    _close(eq.dust_luminosities(c["pm"], c["pt"], rf_t, c["rf_scale"]),
           ref_eq.dust_luminosities(c["rm"], c["rt"], c["rf"], c["rf_scale"]),
           1e-12, "L_cell")
    _close(eq.total_absorbed_device(c["pm"], c["pt"], rf_t, c["rf_scale"]),
           ref_eq.total_absorbed_device(c["rm"], c["rt"], jnp.asarray(c["rf"]),
                                        c["rf_scale"]), 1e-5, "L_abs")


@pytest.mark.parametrize("cmb", [0.0, 2.725])
def test_emission_state_device(emission_case, cmb):
    c = emission_case
    vols = c["pg"].volumes()
    p_cmb = eq.cmb_heating_power(c["pt"], cmb) if cmb else None
    L_p, T_p, eps_p = eq.emission_state_device(
        c["pm"], c["pt"], torch.tensor(c["rf"]), vols, c["rf_scale"], p_cmb)
    L_r, T_r, eps_r = ref_eq.emission_state_device(
        c["rm"], c["rt"], jnp.asarray(c["rf"]), vols, c["rf_scale"], p_cmb)
    _close(L_p, L_r, 1e-5, "L_cell")
    _close(T_p, T_r, 1e-5, "T")
    _close(eps_p, eps_r, 1e-4, "eps", floor=1e-6)
    _close(eq.cell_emission_spectra(c["pm"], c["pt"], T_p),
           ref_eq.cell_emission_spectra(c["rm"], c["rt"], T_r), 1e-4, "spec",
           floor=1e-6)


@pytest.mark.parametrize("stratified", [False, True])
@pytest.mark.parametrize("on_device", [False, True])
def test_secondary_launch(emission_case, stratified, on_device):
    """prepare (host cdf) and prepare_device (device cdf) against the
    reference's, then a launch from the same keys and the reference's
    tables, with and without the strata of an RF-only secondary segment.
    (The tables alone differ by 1.4e-6: enough to move a lane whose
    uniform falls that close to a bin edge into the next emission bin.)"""
    c = emission_case
    vols = c["pg"].volumes()
    L_p, _, eps_p = eq.emission_state_device(
        c["pm"], c["pt"], torch.tensor(c["rf"]), vols, c["rf_scale"])
    L_r, _, eps_r = ref_eq.emission_state_device(
        c["rm"], c["rt"], jnp.asarray(c["rf"]), vols, c["rf_scale"])
    if on_device:
        s_p = sec.prepare_device(c["pg"], L_p, eps_p, c["ems_b"], 0.5)
        s_r = ref_sec.prepare_device(c["rg"], L_r, eps_r, c["ems_b"], 0.5)
    else:
        s_p = sec.prepare(c["pg"], _np(L_r), np.asarray(eps_r), c["ems_b"],
                          0.5)
        s_r = ref_sec.prepare(c["rg"], L_r, eps_r, c["ems_b"], 0.5)
    assert s_p.lam_range == s_r.lam_range
    _close(s_p.luminosity, s_r.luminosity, 1e-6, "luminosity")
    pt, rt = dict(s_p.tables()), dict(s_r.tables())
    for k in rt:
        # the cdfs absolutely (they run from 0 to 1), the rest relatively
        _close(pt[k], rt[k], 1e-5, k, floor=1.0 if "cdf" in k else 0.0)
    pt = {k: torch.tensor(np.asarray(v)) for k, v in rt.items()}
    B = 8192
    if stratified:
        borders = np.geomspace(s_p.lam_range[0], 100 * UM, 9)
        w = np.random.default_rng(2).uniform(0.5, 2.0, 8)
        pt.update(strata=torch.tensor(borders, dtype=torch.float32),
                  strata_w=torch.tensor(w, dtype=torch.float32))
        rt.update(strata=jnp.asarray(borders, jnp.float32),
                  strata_w=jnp.asarray(w, jnp.float32))
    rk, pk = _keys(B, seed=11)
    # the reference runs op by op here, outside jax.jit: so does the port
    with xm.eager():
        f_p = s_p.launch(pt, pk, B)
    f_r = s_r.launch(rt, rk, B)
    for k in ("lam", "lum", "pos", "dir"):
        _close(f_p[k], f_r[k], 1e-5, k)
    assert kb.LAUNCHES == {k: 0 for k in kb.LAUNCHES}


def test_uniform_vec_matches_jax():
    rk, pk = _keys(64)
    ref = jax.vmap(lambda k: jax.random.uniform(k, (3,)))(
        ref_rng.purpose_key(rk, ref_rng.LAUNCH_POSITION))
    assert np.array_equal(_np(rng.uniform_vec(pk, rng.LAUNCH_POSITION, 3)),
                          np.asarray(ref))
