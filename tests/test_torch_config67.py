"""Configs 6 and 7 (tests/golden/bench6.ski, bench7.ski) in the port against
the reference.

bench6 is Lyman-alpha resonant line transfer: a LyaGaussianSED point source
in a uniform neutral-hydrogen sphere at 10^4 K (line-centre optical depth
10^5 from the centre, NumberColumnMaterialNormalization), the Constant
core-skipping scheme, a 75-bin linear SEDInstrument grid. bench7 is X-ray
atomic gas (XRayAtomicGasMix with the golden XRay_PA.txt / XRay_FL.txt
beside the ski: Verner photo-absorption, free-electron Compton scattering,
Fe K fluorescence) around a FileSED point source, a 60-bin logarithmic
grid. Both ride the resident sweep (kernels 1-2 and detect on the GPU).

- The loader on both files, array for array against the reference's
  `load_ski` + `bridge`: grid, medium (the gas temperatures filled with
  the Lya mix's default), options (Lya's Constant scheme and its
  path-length bias forced to 0; the X-ray flag), instrument, SED tables,
  the X-ray channel tables.
- The gates: Lya with a varying gas temperature, with two medium
  components or in a moving medium, and wavelength-changing physics with
  a multi-bin radiation field take the scan march, draw for draw with the
  reference's march (1,024 packets, 4 events: within 1e-5 of each
  maximum); Lya and X-ray physics take the large-grid (XL) contracts on a
  uniform grid with XL tables (draw for draw with the reference's XL
  sweep) and a tree's voxel raster.
- Both configs end to end at a small size (bench6: 4,096 packets, 12
  events; bench7: 2,048 packets, 16 events; one torch thread) draw for
  draw against the reference on the CPU (its scan march), each scattering
  detection compared lane by lane (a `jax.debug.callback` spy on the
  reference's `detect`). The transparent and direct SEDs agree within
  1e-5 of each maximum (to ~2e-7). The port replays XLA's arithmetic
  where an ulp decides a discrete outcome (`ops.xlamath`: the Gaussian
  draws, the rejection tests' exp and log, the launch wavelengths, the
  X-ray channel shares), but not the C library's tan and atan, which the
  Lya rejection sampler calls: an ulp there flips a lane's acceptance
  about once per 10^5 draws, and a flipped lane's wavelength and path
  then differ for the rest of its life. Measured over seeds 0-2, 0.13% to
  0.21% of the lit scattering detections of bench6 (12 to 16 events)
  differ by more than 1e-3 in contribution or 1e-5 in wavelength, which
  moves the scattered SED by at most 3.5e-3 of its maximum and its sum by
  1.2e-3; bench7 differs in at most one lane in 10^4. The bounds are about
  four times that: at most 1% of the lit detections off, the scattered
  SED within 1.5e-2 of its maximum and its sum within 5e-3.
- The SED files of the port's `write_outputs` against the reference's on
  those runs (the same header and columns, within the same bounds), and
  the CLI writing both files.
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
from skirt9_tpu.instruments import distant as ref_dinst
from skirt9_tpu_torch import bridge
from skirt9_tpu_torch.__main__ import main
from skirt9_tpu_torch.config.ski import load_ski
from skirt9_tpu_torch.instruments import distant as dinst
from skirt9_tpu_torch.kernels import build as kb
from skirt9_tpu_torch.transport import lifecycle as lc
from skirt9_tpu_torch.transport import sweep as sw
from skirt9_tpu_torch.transport import sweepxl as xl

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
RUNS = {"bench6": dict(num_packets=4096, batch_size=4096, max_events=12),
        "bench7": dict(num_packets=2048, batch_size=2048, max_events=16)}
EXACT = 1e-5            # transparent and direct light, of each maximum
LANES_OFF = 0.01        # share of the lit scattering detections
SCAT_OF_MAX = 1.5e-2    # the scattered SED, of its maximum
SCAT_SUM = 5e-3         # the scattered SED's sum, relative


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ski(name: str) -> str:
    return os.path.join(GOLDEN, f"{name}.ski")


# ------------------------------------------------------------------ loader

@pytest.mark.parametrize("name", ["bench6", "bench7"])
def test_load_ski_matches_reference(name):
    ref = bridge.simulation(ref_load_ski(_ski(name)), device="cpu")
    port = load_ski(_ski(name), device="cpu")
    for f in port.grid._fields:
        a, b = getattr(port.grid, f), getattr(ref.grid, f)
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b), f
    for f in port.medium._fields:
        assert torch.equal(getattr(port.medium, f),
                           getattr(ref.medium, f)), f
    assert port.options == ref.options
    assert port.instruments == ref.instruments
    cfg = port.instruments[0]
    assert not cfg.has_frame and cfg.nbins == (75 if name == "bench6" else 60)
    for f in ("lam", "s"):
        np.testing.assert_array_equal(getattr(port.sources[0].sed, f),
                                      getattr(ref.sources[0].sed, f))
    assert port.sources[0].luminosity == ref.sources[0].luminosity
    assert port.num_packets == ref.num_packets
    assert isinstance(port._sweep_tabs, sw.SweepTables)
    o = port.options
    if name == "bench6":
        assert o.lya and o.lya_xcrit == 3.0 and not o.lya_variable
        assert o.path_length_bias == 0.0 and port.xray_tabs is None
        occ = port.medium.nd[:, 0] > 0
        assert bool(torch.all(port.medium.temperature[occ] == 1e4))
        # line-centre optical depth 10^5 from the centre
        tau0 = 3.389e22 / 2 * 5.898e-18
        assert tau0 == pytest.approx(1e5, rel=1e-3)
    else:
        assert o.xray and not o.lya and o.path_length_bias == 0.5
        assert sorted(port.xray_tabs) == sorted(ref.xray_tabs)
        for k, v in port.xray_tabs.items():
            assert torch.equal(v, ref.xray_tabs[k]), k
        assert port.xray_tabs["line_lam"].shape[0] >= 2


# ------------------------------------------------------------------- gates

def _edited(tmp_path, name, edits, out="edited"):
    """An edited copy of the ski file, with the input files it reads beside
    it (bench7's SED and X-ray data)."""
    return chip_smoke.edited_ski(name, tmp_path, edits, out=out)


_MEDIUM6 = ('<GeometricMedium velocityMagnitude="0 km/s">',
            '</GeometricMedium>')


def _second_medium(name: str) -> dict:
    text = open(_ski(name)).read()
    start, end = text.index(_MEDIUM6[0]), text.index(_MEDIUM6[1])
    medium = text[start:end + len(_MEDIUM6[1])]
    return {medium: medium + medium}


def _march_agrees(ref, bound: float = EXACT) -> None:
    """The port on the scan march (no sweep tables where the reference has
    none) against the reference's march on the CPU: every SED kind and the
    RF within bound of each maximum, no kernel launched."""
    port = bridge.simulation(ref, "cpu", march=True)
    assert port._sweep_tabs is None
    rf_r, accs_r = ref.run_primary(verbose=False)
    kb.reset_launches()
    rf_p, accs_p = port.run_primary(verbose=False)
    assert kb.LAUNCHES == {k: 0 for k in kb.LAUNCHES}
    pairs = [(accs_r[0]["sed"][k], accs_p[0]["sed"][k]) for k in range(3)]
    if rf_r is not None:
        pairs.append((rf_r, rf_p))
    for a, b in pairs:
        a = np.asarray(a, np.float64)
        assert np.abs(a).max() > 0
        assert np.abs(b.double().numpy() - a).max() <= bound * np.abs(a).max()


SMALL67 = dict(num_packets=1024, batch_size=1024, max_events=4)


def test_lya_outside_the_sweep_raises(tmp_path):
    """Lya rides the resident sweep only in a static one-component medium
    at one gas temperature (the reference's `lya_sweep_ok`); with two
    medium components, in a moving medium and with a varying gas
    temperature it takes the scan march (the Voigt opacity at each cell's
    temperature and perceived wavelength), draw for draw with the
    reference's march within 1e-5 of each maximum."""
    two = ref_load_ski(_edited(tmp_path, "bench6", _second_medium("bench6")),
                       **SMALL67)
    moving = ref_load_ski(_edited(tmp_path, "bench6", {
        _MEDIUM6[0]: '<GeometricMedium velocityMagnitude="100 km/s">'
        '<velocityDistribution type="VectorField"><RadialVectorField '
        'unityRadius="0.1 pc" exponent="1"/></velocityDistribution>'},
        out="moving"), **SMALL67)
    warm = ref_load_ski(_ski("bench6"), **SMALL67)
    T = np.asarray(warm.medium.temperature).copy()
    occ = np.asarray(warm.medium.nd)[:, 0] > 0
    T[occ] *= np.linspace(1.0, 2.0, int(occ.sum()))
    warm.medium = warm.medium._replace(temperature=jnp.asarray(T))
    for ref in (two, moving, warm):
        port = bridge.simulation(ref, "cpu")
        assert lc.check_wavelength_changing(port.medium, port.options,
                                            0) is None
        assert isinstance(port._sweep_tabs, sw.SweepTables)
        assert not lc.sweep_gate(port.medium, port.options,
                                 port._sweep_tabs, None, 1024).use_sweep
        _march_agrees(ref)


@pytest.mark.parametrize("name", ["bench6", "bench7"])
def test_multi_bin_rf_raises(name):
    """Wavelength-changing physics with a multi-bin RF takes the scan
    march, which bins each deposit by the lane's current wavelength: the
    RF and SEDs agree with the reference's march within 1e-5 of each
    maximum; a one-bin RF still rides the sweep."""
    ref = ref_load_ski(_ski(name), **SMALL67)
    lam = float(ref.sources[0].sed.lam[0])
    multi = dataclasses.replace(
        ref, options=dataclasses.replace(ref.options, store_rf=True),
        rf_borders=np.geomspace(lam, 4 * lam, 4))
    port = bridge.simulation(multi, "cpu")
    assert not lc.sweep_gate(port.medium, port.options, port._sweep_tabs,
                             torch.zeros((1, 3)), 1024).use_sweep
    _march_agrees(multi)
    one = bridge.simulation(dataclasses.replace(
        multi, rf_borders=np.array([lam, 4 * lam])), "cpu")
    assert lc.sweep_gate(one.medium, one.options, one._sweep_tabs,
                         torch.zeros((1, 1)), 1024).use_sweep


@pytest.mark.parametrize("name,flag,named", [("bench6", "lya", "Lya"),
                                             ("bench7", "xray", "X-ray")])
def test_other_engines_raise(tmp_path, name, flag, named, monkeypatch):
    """On a density octree the engine choice is the tree's voxel raster (the
    multi-level sweep excludes these physics, the XL contracts take them;
    the runs: `tests/test_torch_tree_engines.py`); with XL tables put in
    place on the uniform grid, Lya or X-ray physics runs draw for draw with the
    reference's interpret-mode XL sweep (1,024 packets, 4 events;
    `test_torch_tree_engines.run_both`)."""
    from skirt9_tpu.transport import sweepxl as ref_xl
    from test_torch_tree_engines import load_reference, run_both
    monkeypatch.setenv("SKIRT9_TPU_FORCE_SWEEP", "1")
    path = _edited(tmp_path, name, chip_smoke.tree_edits(name, 3),
                   out="tree")
    sim = load_ski(path, device="cpu")
    assert type(sim.grid).__name__ == "OctreeGrid" and getattr(
        sim.options, flag)
    assert isinstance(sim._sweep_tabs, xl.XLTables), named
    assert sim._sweep_tabs.cellmap is not None
    ref = load_reference(name, tmp_path, {})
    ref._sweep_tabs = ref_xl.build_tables(ref.grid, ref.medium)
    port = bridge.simulation(ref, "cpu")
    assert isinstance(port._sweep_tabs, xl.XLTables)
    assert lc.sweep_gate(port.medium, port.options, port._sweep_tabs, None,
                         1024).use_sweep
    run_both(ref, port)


# ------------------------------------------------------- draw for draw

def _spied_runs(name):
    """The reference's and the port's primary runs, each with the inputs of
    its scattering detections logged per call."""
    logs = {"ref": [], "port": []}
    real_r, real_p = ref_dinst.detect, dinst.detect

    def spy_r(cfg, tabs, acc, lam, pos, contrib, kind, active, **kw):
        if kind == ref_dinst.KIND_PRIMARY_SCATTERED:
            # ordered: bench7's two scattering peel-offs per event must
            # log in the order they are issued
            jax.debug.callback(
                lambda *a: logs["ref"].append([np.asarray(x) for x in a]),
                lam, contrib, active, ordered=True)
        return real_r(cfg, tabs, acc, lam, pos, contrib, kind, active, **kw)

    def spy_p(cfg, tabs, acc, lam, pos, contrib, kind, active, **kw):
        if kind == dinst.KIND_PRIMARY_SCATTERED:
            logs["port"].append([t.numpy().copy()
                                 for t in (lam, contrib, active)])
        return real_p(cfg, tabs, acc, lam, pos, contrib, kind, active, **kw)

    ref = ref_load_ski(_ski(name), **RUNS[name])
    port = load_ski(_ski(name), device="cpu", **RUNS[name])
    ref_dinst.detect, dinst.detect = spy_r, spy_p
    try:
        _, accs_r = ref.run_primary(verbose=False)
        kb.reset_launches()
        _, accs = port.run_primary(verbose=False)
        assert sum(kb.LAUNCHES.values()) == 0       # CPU: plain versions
    finally:
        ref_dinst.detect, dinst.detect = real_r, real_p
    return ref, accs_r, port, accs, logs


@pytest.fixture(scope="module", params=["bench6", "bench7"])
def runs(request):
    return (request.param,) + _spied_runs(request.param)


def lanes_off(logs) -> tuple:
    """(detections active in one package only or off by more than 1e-5 in
    wavelength or 1e-3 in contribution, lit detections) over every
    scattering peel-off call."""
    assert len(logs["ref"]) == len(logs["port"]) > 0
    lit = off = 0
    for r, p in zip(logs["ref"], logs["port"]):
        off += int((r[2] != p[2]).sum())
        m = r[2] & p[2] & (r[1] > 0)
        lit += int(m.sum())
        dl = np.abs(p[0] - r[0])[m] / r[0][m]
        dc = np.abs(p[1] - r[1])[m] / r[1][m]
        off += int(((dl > 1e-5) | (dc > 1e-3)).sum())
    return off, lit


def assert_seds_agree(sed, sed_r):
    """Transparent and direct rows within EXACT of their maxima, the
    scattered row within SCAT_OF_MAX and its sum within SCAT_SUM, the
    secondary rows empty."""
    for k in range(5):
        m = np.abs(sed_r[k]).max()
        if k >= 3:
            assert m == 0 and np.abs(sed[k]).max() == 0
            continue
        assert m > 0, k
        err = np.abs(sed[k] - sed_r[k]).max() / m
        assert err <= (SCAT_OF_MAX if k == 2 else EXACT), (k, err)
    assert abs(sed[2].sum() / sed_r[2].sum() - 1.0) <= SCAT_SUM


def test_slice_draw_for_draw(runs):
    name, ref, accs_r, port, accs, logs = runs
    off, lit = lanes_off(logs)
    assert lit > 5000 and off <= LANES_OFF * lit, (off, lit)
    assert_seds_agree(accs[0]["sed"].double().numpy(),
                      np.asarray(accs_r[0]["sed"], np.float64))
    sed = dinst.calibrate_sed(port.instruments[0], accs[0])
    lam = sed["wavelength"]
    if name == "bench6":
        # the line centre is dark in the direct light (tau0 = 10^5) and the
        # scattered light leaves in two peaks around it
        i0 = int(np.argmin(np.abs(lam - 1215.67e-10)))
        assert sed["primarydirect"][i0] < 1e-6 * sed["transparent"].max()
        s = sed["primaryscattered"]
        assert s[:i0].max() > 10 * s[i0] and s[i0 + 1:].max() > 10 * s[i0]
    else:
        # the Fe K-alpha line (6.4 keV) stands above its neighbours
        E = 1.23984193e-6 / lam
        ika = int(np.argmin(np.abs(E - 6.4e3)))
        s = sed["primaryscattered"]
        assert s[ika] > 1.5 * 0.5 * (s[ika - 2] + s[ika + 2])


def test_write_outputs_and_cli(runs, tmp_path):
    """The port's SED file against the reference writer's on the same run
    (header lines and columns; the fluxes within the draw-for-draw
    bounds), and the CLI writing the ski file's SED."""
    name, ref, accs_r, port, accs, _ = runs
    ours = port.write_outputs(accs, "p", str(tmp_path))
    theirs = ref.write_outputs(accs_r, "r", str(tmp_path))
    path = [p for p in ours if p.endswith("_sed.dat")]
    path_r = [p for p in theirs if p.endswith("_sed.dat")]
    assert len(ours) == len(path) == len(path_r) == 1
    hdr = [ln for ln in open(path[0]) if ln.startswith("# column")]
    hdr_r = [ln for ln in open(path_r[0]) if ln.startswith("# column")]
    assert hdr == hdr_r
    cols, cols_r = np.loadtxt(path[0]), np.loadtxt(path_r[0])
    nb = 75 if name == "bench6" else 60
    assert cols.shape == cols_r.shape == (nb, 9)
    np.testing.assert_array_equal(cols[:, 0], cols_r[:, 0])
    # total (scattered included), transparent, direct, scattered
    assert_seds_agree(cols[:, [2, 3, 4, 5, 6]].T, cols_r[:, [2, 3, 4, 5, 6]].T)
    m = np.abs(cols_r[:, 1]).max()
    assert np.abs(cols[:, 1] - cols_r[:, 1]).max() <= SCAT_OF_MAX * m
    out = tmp_path / "cli"
    assert main([_ski(name), "--device", "cpu", "-p", "256", "-b", "128",
                 "-o", str(out)]) == 0
    assert sorted(os.listdir(out)) == [f"{name}_i0_sed.dat",
                                       f"{name}_log.txt"]
    cli = np.loadtxt(out / f"{name}_i0_sed.dat")
    assert cli.shape == (nb, 9) and np.all(np.isfinite(cli))
    assert cli[:, 4].max() > 0 and cli[:, 1].max() > 0
