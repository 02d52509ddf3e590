"""Config 5 (tests/golden/bench5.ski) in the port against the reference.

bench5 is polarized Thomson scattering by an electron disk
(ExpDiskGeometry, NumberMaterialNormalization) in a 2000 km/s radial
outflow (RadialVectorField): the port's loader, its polarized and
kinematic life cycle on the resident sweep, the Stokes detection and the
Stokes outputs.

- The loader on bench5.ski, array for array against the reference's
  `load_ski` + `bridge`: densities, bulk velocities, Mueller tables,
  options (kinematics, polarization, the path-length bias forced to 0) and
  the instrument; the static variant (velocityMagnitude 0) without
  kinematics.
- The gates: kinematics with wavelength-dependent cross sections or a
  multi-bin RF takes the scan march, draw for draw with the reference's;
  polarization and kinematics take the tree and XL engines (on a uniform
  grid with XL tables draw for draw with the reference's XL sweep);
  polarized and spheroidal emission raise.
- A reduced bench5 (16^3, 4,096 packets in batches of 1,024, 8 events),
  moving and static, draw for draw against the reference on the CPU (its
  scan march), the detections of every scattering peel-off compared lane
  by lane. The light that polarization never touches (transparent and
  direct SEDs and frames) agrees within 1e-5 of each accumulator's
  maximum (to ~2e-7). The scattered light does not, and cannot: a fully
  polarized packet scattered near 90 degrees takes its azimuth from six
  Newton steps that do not converge there (the reference's
  `sample_azimuth`), so an ulp of XLA's or PyTorch's sin, cos or atan2
  moves it by up to pi (`tests/test_torch_stokes.py::test_sample_azimuth_
  is_chaotic_near_full_polarization`). A one-ulp change of one azimuth in
  the port alone moves these sums by 7e-6 (scattered SED), 4e-5 (Q) and
  3e-4 (Stokes frames) of their maxima. So the lanes are held lane by
  lane (at most 1% of the lit lanes of a run active in one package only,
  or off by more than 1e-3, or 1e-5 in wavelength), and the scattered sums at bounds about three times
  the largest gaps over seeds 0-3 (5.4e-5, 5.3e-4, 6.0e-4 and 3.4e-3 of
  the maxima): the scattered SED 2e-4, Q and U 2e-3, the scattered frame
  2e-3, the Stokes frames 1e-2. V is identically 0 (Thomson scattering
  makes none).
- A refilled polarized run against the reference's refilled run, at the
  same bounds.
- `write_outputs` and the CLI against the reference's CLI (`python -m
  skirt9_tpu`): the SED file's columns (Q, U, V included) and the total and
  Stokes FITS cubes, at the same bounds on the same seed.

One torch thread; the reference runs on the CPU.
"""

import dataclasses
import os
import subprocess
import sys

import jax
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
from skirt9_tpu_torch.sources.base import PointSource
from skirt9_tpu_torch.transport import lifecycle as lc
from skirt9_tpu_torch.transport import sweep as sw
from skirt9_tpu_torch.transport import sweepxl as xl
from skirt9_tpu_torch.utils.fits import read_fits

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH5 = os.path.join(REPO, "tests", "golden", "bench5.ski")
SMALL = {'numBins="32"': 'numBins="16"'}
STATIC = {'velocityMagnitude="2000 km/s"': 'velocityMagnitude="0 km/s"'}
RUN = dict(num_packets=4096, batch_size=1024, max_events=8)
# bounds of each accumulator's error, as a share of its largest |value|
EXACT = 1e-5
BOUNDS = {("sed", 2): 2e-4, ("frame", 2): 2e-3, ("stokes", 0): 2e-3,
          ("stokes", 1): 2e-3, ("frame_stokes", 0): 1e-2,
          ("frame_stokes", 1): 1e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t)).astype(np.float64)


def _edited(tmp, edits):
    return chip_smoke.edited_ski("bench5", tmp, dict(SMALL, **edits))


def assert_accs_agree(acc, acc_r):
    """Each accumulator row within its bound of its largest |value|; the
    Stokes V rows identically 0."""
    worst = {}
    for key in ("sed", "frame", "stokes", "frame_stokes"):
        ours, ref = _np(acc[key]), _np(acc_r[key])
        assert ours.shape == ref.shape
        for j in range(ref.shape[0]):
            m = np.abs(ref[j]).max()
            if key in ("stokes", "frame_stokes") and j == 2:
                assert m == 0.0 and np.abs(ours[j]).max() == 0.0
                continue
            if key in ("sed", "frame") and j >= 3:
                continue        # no secondary light
            assert m > 0, (key, j)
            err = np.abs(ours[j] - ref[j]).max() / m
            assert err <= BOUNDS.get((key, j), EXACT), (key, j, err)
            worst[f"{key}{j}"] = err
    return worst


# ------------------------------------------------------------------ loader

def test_load_ski_matches_reference():
    ref = bridge.simulation(ref_load_ski(BENCH5), device="cpu")
    port = load_ski(BENCH5, device="cpu")
    for f in port.grid._fields:
        a, b = getattr(port.grid, f), getattr(ref.grid, f)
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b), f
    for f in port.medium._fields:
        assert torch.equal(getattr(port.medium, f),
                           getattr(ref.medium, f)), f
    for f in port.mueller._fields:
        assert torch.equal(getattr(port.mueller, f),
                           getattr(ref.mueller, f)), f
    assert port.options == ref.options
    o = port.options
    assert o.kinematics and o.polarization and o.path_length_bias == 0.0
    assert port.instruments == ref.instruments
    cfg = port.instruments[0]
    assert cfg.record_polarization and (cfg.npx, cfg.nbins) == (64, 40)
    assert len(port.sources) == 1
    for f in ("lam", "s"):
        np.testing.assert_array_equal(getattr(port.sources[0].sed, f),
                                      getattr(ref.sources[0].sed, f))
    assert port.num_packets == ref.num_packets == 2 * 10 ** 6
    v = port.medium.bulk_v.double().norm(dim=1)
    assert float(v.max()) == pytest.approx(2e6, rel=1e-3)
    assert isinstance(port._sweep_tabs, sw.SweepTables)


def test_static_variant_has_no_kinematics(tmp_path):
    path = chip_smoke.edited_ski("bench5", tmp_path, STATIC)
    sim = load_ski(path, device="cpu")
    ref = bridge.simulation(ref_load_ski(path), device="cpu")
    assert not sim.options.kinematics and sim.options.polarization
    assert sim.options.path_length_bias == 0.5 == ref.options.path_length_bias
    assert float(sim.medium.bulk_v.abs().max()) == 0.0
    assert torch.equal(sim.medium.bulk_v, ref.medium.bulk_v)


# ------------------------------------------------------------------- gates

def test_kinematics_outside_the_sweep_raises(tmp_path):
    """Where the reference's `kin_ok` declines the sweep, kinematics takes
    the scan march: bench5's outflow filled with the MRN dust mix
    (wavelength-dependent cross sections), and the electron outflow without
    polarization storing a 3-bin RF. Both agree with the reference's march
    on the CPU, SEDs, frames and RF within 1e-5 of each maximum (they agree
    to ~1e-6)."""
    kw = dict(num_packets=1024, batch_size=1024, max_events=4)
    mix = '<ElectronMix includePolarization="true"/>'
    dusty = _edited(tmp_path, {mix: '<MeanFileDustMix '
                               'filename="mrn_mean.txt"/>'})
    ref = ref_load_ski(dusty, **kw)
    unpolarized = chip_smoke.edited_ski("bench5", tmp_path, dict(SMALL, **{
        mix: '<ElectronMix includePolarization="false"/>'}), out="unpol")
    ref_u = ref_load_ski(unpolarized, **kw)
    ref_multi = dataclasses.replace(
        ref_u, options=dataclasses.replace(ref_u.options, store_rf=True),
        rf_borders=np.geomspace(0.4e-6, 0.8e-6, 4))
    for ref_sim, nbins in ((ref, 0), (ref_multi, 3)):
        assert ref_sim.options.kinematics
        port = bridge.simulation(ref_sim, "cpu", march=True)
        own = bridge.simulation(ref_sim, "cpu")
        gate = lc.sweep_gate(port.medium, port.options, own._sweep_tabs,
                             torch.zeros((1, nbins)) if nbins else None,
                             1024)
        assert not gate.use_sweep and not lc.check_kinematics(
            port.medium, port.options, nbins)
        rf_r, accs_r = ref_sim.run_primary(verbose=False)
        kb.reset_launches()
        rf_p, accs_p = port.run_primary(verbose=False)
        assert kb.LAUNCHES == {k: 0 for k in kb.LAUNCHES}
        pairs = [(accs_r[0][k], accs_p[0][k]) for k in ("sed", "frame")]
        if nbins:
            assert rf_p.shape[1] == nbins
            pairs.append((rf_r, rf_p))
        for a, b in pairs:
            a = np.asarray(a, np.float64)
            assert np.abs(a).max() > 0
            assert np.abs(b.double().numpy() - a).max() <= \
                1e-5 * np.abs(a).max()


@pytest.mark.parametrize("edits,engine", [({}, "XLTables"),
                                          (STATIC, "MLTables")],
                         ids=["edits0-kinematics on a OctreeGrid",
                              "edits1-polarization on the tree"])
def test_other_engines_raise(tmp_path, edits, engine, monkeypatch):
    """On a density octree the static variant takes the tree sweep and the
    moving one the tree's voxel raster (XL tables: the multi-level sweep
    declines kinematics), as the reference's chain gives them (their runs:
    `tests/test_torch_tree_engines.py`); on the uniform grid with XL
    tables put in place, polarization (and kinematics) run on the XL
    contracts draw for draw with the reference's interpret-mode XL sweep
    (1,024 packets, 4 events; `test_torch_tree_engines.run_both`)."""
    from skirt9_tpu.transport import sweepxl as ref_xl
    from test_torch_tree_engines import run_both
    monkeypatch.setenv("SKIRT9_TPU_FORCE_SWEEP", "1")
    tree = chip_smoke.tree_edits("bench5", 4)
    sim = load_ski(chip_smoke.edited_ski("bench5", tmp_path,
                                         dict(tree, **edits), out="tree"),
                   device="cpu")
    assert type(sim.grid).__name__ == "OctreeGrid"
    assert type(sim._sweep_tabs).__name__ == engine
    ref = ref_load_ski(_edited(tmp_path, edits), num_packets=1024,
                       batch_size=1024, max_events=4)
    assert ref.options.kinematics == (not edits)
    ref._sweep_tabs = ref_xl.build_tables(ref.grid, ref.medium)
    port = bridge.simulation(ref, "cpu")
    assert isinstance(port._sweep_tabs, xl.XLTables)
    assert lc.sweep_gate(port.medium, port.options, port._sweep_tabs, None,
                         1024).use_sweep
    run_both(ref, port)


def test_polarized_and_spheroidal_emission_raise():
    with pytest.raises(NotImplementedError, match="polarization"):
        PointSource(polarization=object())
    ref = ref_load_ski(BENCH5, num_packets=1024)
    ref.spheroidal = object()
    with pytest.raises(NotImplementedError, match="spheroidal"):
        bridge.simulation(ref, device="cpu")


# ------------------------------------------------------- draw for draw

def _spied_runs(path, refill=0):
    """The reference's and the port's primary runs of path, each with the
    inputs of its scattering detections logged per call."""
    logs = {"ref": [], "port": []}
    real_r, real_p = ref_dinst.detect, dinst.detect

    def spy_r(cfg, tabs, acc, lam, pos, contrib, kind, active,
              stokes_quv=None, **kw):
        if kind == ref_dinst.KIND_PRIMARY_SCATTERED:
            jax.debug.callback(
                lambda *a: logs["ref"].append([np.asarray(x) for x in a]),
                lam, pos, contrib, active, stokes_quv)
        return real_r(cfg, tabs, acc, lam, pos, contrib, kind, active,
                      stokes_quv=stokes_quv, **kw)

    def spy_p(cfg, tabs, acc, lam, pos, contrib, kind, active,
              stokes_quv=None):
        if kind == dinst.KIND_PRIMARY_SCATTERED:
            logs["port"].append([t.numpy().copy() for t in (
                lam, pos, contrib, active, stokes_quv)])
        return real_p(cfg, tabs, acc, lam, pos, contrib, kind, active,
                      stokes_quv=stokes_quv)

    ref = ref_load_ski(path, **RUN)
    port = load_ski(path, device="cpu", **RUN)
    ref.refill_events = port.refill_events = refill
    ref_dinst.detect, dinst.detect = spy_r, spy_p
    try:
        _, accs_r = ref.run_primary(verbose=False)
        kb.reset_launches()
        _, accs = port.run_primary(verbose=False)
        assert sum(kb.LAUNCHES.values()) == 0       # CPU: plain versions
    finally:
        ref_dinst.detect, dinst.detect = real_r, real_p
    return port, accs[0], {k: np.asarray(v) for k, v in accs_r[0].items()}, \
        logs


def assert_lanes_agree(logs):
    """Every scattering detection lane by lane: at most 1% of the lit lanes
    of the run active in one package only, or with a wavelength off by
    more than 1e-5 (a diverged lane's Doppler shift) or a contribution or
    a Stokes value off by more than 1e-3."""
    assert len(logs["ref"]) == len(logs["port"]) > 0
    lit = off = 0
    for r, p in zip(logs["ref"], logs["port"]):
        # a diverged lane may end at another event
        off += int((r[3] != p[3]).sum())
        m = r[3] & p[3] & (r[2] > 0)
        lit += int(m.sum())
        dl = np.abs(p[0] - r[0])[m] / r[0][m]
        dc = np.abs(p[2] - r[2])[m] / r[2][m]
        dq = np.abs(p[4] - r[4]).max(axis=1)[m]
        off += int(((dl > 1e-5) | (dc > 1e-3) | (dq > 1e-3)).sum())
    assert lit > 10_000 and off <= 0.01 * lit, (off, lit)


@pytest.fixture(scope="module", params=["moving", "static"])
def reduced(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"b5{request.param}")
    path = _edited(tmp, STATIC if request.param == "static" else {})
    return (request.param,) + _spied_runs(path)


def test_config5_slice_draw_for_draw(reduced):
    variant, sim, acc, acc_r, logs = reduced
    assert sim.options.kinematics == (variant == "moving")
    assert sim.options.polarization
    assert_lanes_agree(logs)
    assert_accs_agree(acc, acc_r)
    # the outflow redistributes the scattered light in wavelength only
    sed = dinst.calibrate_sed(sim.instruments[0], acc)
    assert np.all(sed["V"] == 0) and np.abs(sed["Q"]).max() > 0


def test_refilled_polarized_run_matches_reference(tmp_path):
    sim, acc, acc_r, logs = _spied_runs(_edited(tmp_path, {}), refill=3)
    assert sim.last_stats["generations"] > 4 and \
        sim.last_stats["abandoned"] == 0
    assert_lanes_agree(logs)
    assert_accs_agree(acc, acc_r)


# ----------------------------------------------------------------- outputs

def test_cli_matches_reference_writer(tmp_path):
    """The port's CLI (in process) and the reference's (a subprocess) on
    the reduced bench5 at the same seed and packets: the SED files' columns
    (wavelength, six flux kinds, Q, U, V, R, VOV) and the total and Stokes
    cubes, within the draw-for-draw bounds of their accumulators."""
    path = _edited(tmp_path, {})
    flags = ["-p", "2048", "-b", "1024"]
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO] + [p for p in os.environ.get(
                   "PYTHONPATH", "").split(os.pathsep) if p]))
    res = subprocess.run([sys.executable, "-m", "skirt9_tpu", path, *flags,
                          "-o", str(tmp_path / "ref")], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert main([path, "--device", "cpu", *flags, "-o",
                 str(tmp_path / "port")]) == 0
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == ["small_i0_sed.dat", "small_i0_stokesQ.fits",
                     "small_i0_stokesU.fits", "small_i0_stokesV.fits",
                     "small_i0_total.fits", "small_log.txt"]
    ours = np.loadtxt(tmp_path / "port" / "small_i0_sed.dat")
    ref = np.loadtxt(tmp_path / "ref" / "small_i0_sed.dat")
    hdr = [ln for ln in open(tmp_path / "port" / "small_i0_sed.dat")
           if ln.startswith("# column")]
    hdr_r = [ln for ln in open(tmp_path / "ref" / "small_i0_sed.dat")
             if ln.startswith("# column")]
    assert hdr == hdr_r and ours.shape == ref.shape == (40, 12)
    assert np.all(ours[:, 9] == 0) and np.all(ref[:, 9] == 0)
    # wavelength, total, transparent, direct, scattered, the secondary
    # kinds (zero), Q, U, V, R, VOV
    bounds = [EXACT, 2e-4, EXACT, EXACT, 2e-4, EXACT, EXACT, 2e-3, 2e-3,
              EXACT]
    for col, tol in enumerate(bounds):
        m = np.abs(ref[:, col]).max()
        assert np.abs(ours[:, col] - ref[:, col]).max() <= tol * max(
            m, 1e-300), col
    for name, tol in (("total", 2e-3), ("stokesQ", 1e-2), ("stokesU", 1e-2),
                      ("stokesV", 0.0)):
        cube, _ = read_fits(str(tmp_path / "port" / f"small_i0_{name}.fits"))
        cube_r, _ = read_fits(str(tmp_path / "ref" / f"small_i0_{name}.fits"))
        assert cube.shape == cube_r.shape == (40, 64, 64)
        m = np.abs(cube_r).max()
        assert np.abs(cube - cube_r).max() <= tol * m, name
        assert (m > 0) == (name != "stokesV")
