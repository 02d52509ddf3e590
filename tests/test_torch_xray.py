"""The port's X-ray gas against the reference.

`skirt9_tpu_torch/media/xray.py` is the port's own copy of the reference's
host code (f64 numpy), so the tables agree to 1e-12 relative (they are
equal): the Verner et al. (1996) photo-absorption fit per shell, the
readers of the XRay_PA.txt / XRay_FL.txt resource formats on the golden
files, the built-in H, He and Fe K data, `build_xray_tables` (per-H-atom
absorption, Klein-Nishina electron scattering, the fluorescing part and
the line cdf) with both data sets and both scattering modes, the host
fluorescence sampler, `as_mix_tables` and the f32 device tables. Then the
life cycle's X-ray channel split (`lifecycle.xray_channels`: albedo and
the fluorescence share at the interaction wavelength, in XLA's
arithmetic) bit for bit against the reference's formula, compiled as its
life cycle is, on the same tables.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skirt9_tpu.media import xray as ref_xr
from skirt9_tpu.ops import sampling as ref_smp
from skirt9_tpu_torch.media import xray as xr
from skirt9_tpu_torch.transport import lifecycle as lc

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
LAM = np.geomspace(2e-11, 5e-7, 512)   # the loader's wavelength grid


def _assert_close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=1e-12,
                               atol=0.0)


def _data(kind: str):
    """The shells and lines of the golden resource files or the built-ins,
    each package's own."""
    if kind == "files":
        pa, fl = (os.path.join(GOLDEN, f) for f in ("XRay_PA.txt",
                                                   "XRay_FL.txt"))
        return ((xr.load_pa_file(pa), xr.load_fl_file(fl)),
                (ref_xr.load_pa_file(pa), ref_xr.load_fl_file(fl)))
    return ((list(xr.BUILTIN_SHELLS) + [xr.FE_K_SHELL], list(xr.FE_K_LINES)),
            (list(ref_xr.BUILTIN_SHELLS) + [ref_xr.FE_K_SHELL],
             list(ref_xr.FE_K_LINES)))


def test_resource_files_parse_as_the_reference():
    (shells, lines), (ref_shells, ref_lines) = _data("files")
    assert len(shells) == len(ref_shells) > 2 and len(lines) == len(ref_lines)
    for a, b in zip(shells + lines, ref_shells + ref_lines):
        assert type(a).__name__ == type(b).__name__
        for f in a.__dataclass_fields__:
            assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("kind", ["files", "builtin"])
def test_verner_sigma_matches_reference(kind):
    E = xr.HC_EV / LAM
    (shells, _), (ref_shells, _) = _data(kind)
    for p, rp in zip(shells, ref_shells):
        s = xr.verner_sigma(E, p)
        _assert_close(s, ref_xr.verner_sigma(E, rp))
    # H I at threshold: 6.30 Mb
    h = xr.BUILTIN_SHELLS[0]
    assert xr.verner_sigma(np.array([h.Eth * 1.0001]), h)[0] == \
        pytest.approx(6.30e-22, rel=0.01)


@pytest.mark.parametrize("kind,scatter", [("files", "Free"),
                                          ("builtin", "Free"),
                                          ("files", "None")])
def test_xray_tables_match_reference(kind, scatter):
    (shells, lines), (ref_shells, ref_lines) = _data(kind)
    tabs = xr.build_xray_tables(LAM, shells=shells, lines=lines,
                                scatter=scatter)
    ref = ref_xr.build_xray_tables(LAM, shells=ref_shells, lines=ref_lines,
                                   scatter=scatter)
    for f in ("lam", "sigma_abs", "sigma_sca", "sigma_fluor", "line_lam",
              "line_cdf", "sigma_ext"):
        _assert_close(getattr(tabs, f), getattr(ref, f))
    assert tabs.line_cdf.shape == (LAM.shape[0], len(lines))
    mix, ref_mix = xr.as_mix_tables(tabs), ref_xr.as_mix_tables(ref)
    for f in ("lam", "sigma_ext", "albedo", "g"):
        _assert_close(getattr(mix, f), getattr(ref_mix, f))
    assert mix.mu == pytest.approx(ref_mix.mu, rel=1e-12)
    dev = xr.device_tables(tabs, "cpu")
    ref_dev = ref_xr.device_tables(ref)
    assert sorted(dev) == sorted(ref_dev) == sorted(xr.DEVICE_KEYS)
    for k, v in dev.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref_dev[k]))


def test_fluorescence_sampler_matches_reference():
    (shells, lines), (ref_shells, ref_lines) = _data("files")
    tabs = xr.build_xray_tables(LAM, shells=shells, lines=lines)
    ref = ref_xr.build_xray_tables(LAM, shells=ref_shells, lines=ref_lines)
    rs = np.random.default_rng(0)
    lam_in = np.exp(rs.uniform(np.log(1e-10), np.log(2e-9), 5000))
    u = rs.uniform(size=5000)
    np.testing.assert_array_equal(xr.sample_fluorescence(tabs, lam_in, u),
                                  ref_xr.sample_fluorescence(ref, lam_in, u))


def test_xray_channels_match_reference_formula():
    (shells, lines), _ = _data("files")
    tabs = xr.build_xray_tables(LAM, shells=shells, lines=lines)
    dev = xr.device_tables(tabs, "cpu")
    rs = np.random.default_rng(1)
    lam = np.exp(rs.uniform(np.log(1.2e-10), np.log(4.3e-9),
                            20000)).astype(np.float32)
    albedo, p_fl = lc.xray_channels(dev, torch.from_numpy(lam))
    # the reference's inline formula (skirt9_tpu/transport/lifecycle.py:
    # 1015-1031), compiled as its life cycle is
    xt = {k: jnp.asarray(v.numpy()) for k, v in dev.items()}

    def ref_channels(lam, xt):
        e, f, ext = (ref_smp.interp_loglog(lam, xt["lam"], xt[k])
                     for k in ("sigma_sca", "sigma_fluor", "sigma_ext"))
        sca = e + f
        return (jnp.where(ext > 0, sca / jnp.maximum(ext, 1e-37), 0.0),
                jnp.where(sca > 0, f / jnp.maximum(sca, 1e-37), 0.0))

    ref_alb, ref_pfl = jax.jit(ref_channels)(lam, xt)
    np.testing.assert_array_equal(albedo.numpy(), np.asarray(ref_alb))
    np.testing.assert_array_equal(p_fl.numpy(), np.asarray(ref_pfl))
    # the Fe K edge: fluorescence above 7.112 keV only
    E_keV = xr.HC_EV / lam.astype(np.float64) / 1e3
    assert np.all(p_fl.numpy()[E_keV < 7.0] == 0)
    assert np.all(p_fl.numpy()[E_keV > 7.3] > 0)
