"""Spatial domain decomposition (`parallel/domain.py`, `Simulation(dd=True)`,
`--dd`) against the reference's, on the CPU.

The port runs every case in one 2-rank gloo subprocess (`tests/dd_runner.py`,
one torch thread a rank, its own time limit; each rank asserts that it
imported neither jax nor the JAX package); the reference runs `dd_segment`
or `Simulation` with `dd` on `Mesh(jax.devices()[:2])` (conftest's virtual
CPU devices), on its march route (`SKIRT9_TPU_FORCE_SWEEP` unset). Both
shard the grid into 2 x-slabs and launch the r-th block of each batch on
rank r, so the runs agree draw for draw: every quantity within 1e-5 of its
maximum (measured below 1e-6, but reduced bench3's secondary scattered
kind: 1.4e-6 on its SED, 7.2e-6 on its frame), L_dust and L_abs_primary
within 1e-5 relative.

- `decompose_slabs` array for array, uniform and meshed;
- `dd_segment`, one event with one and with two components, four events,
  and a meshed grid over three events (tests/test_domain.py's problems);
- reduced bench2 (8^3, a 4-bin RF) with dust emission and one secondary
  iteration (RF, SED, L_dust); reduced bench3 on its 16^3 voxel raster;
  bench1; bench5 refused, naming polarization and --dd;
- `-d 2 --dd` through the CLI against the API run of the same ski file,
  file for file. The XL route (`SKIRT9_TPU_FORCE_SWEEP=1`, one RF bin):
  tests/test_torch_domain_xl.py.
"""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from skirt9_tpu.config.ski import load_ski as ref_load_ski
from skirt9_tpu.parallel import domain as ref_dom
from skirt9_tpu.transport import lifecycle as ref_lc
from skirt9_tpu_torch.config.ski import load_ski
from skirt9_tpu_torch.parallel import domain as dom
from skirt9_tpu_torch.utils.fits import read_fits

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
import dd_runner  # noqa: E402
import test_domain as ref_cases  # noqa: E402

GOLDEN = os.path.join(REPO, "tests", "golden")
TIMEOUT = 600
EXACT = 1e-5
SEGMENTS = {"event1": (dict(), 1, 1024), "event1c2": (dict(ncomp=2), 1, 1024),
            "events4": (dict(), 4, 2048), "meshed": (None, 3, 1024)}
SKIS = ("bench1", "small2", "small3")


def _env():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    env.pop("SKIRT9_TPU_FORCE_SWEEP", None)
    return env


def _skis(d) -> dict:
    """The ski files of the cases, written into d: bench1, bench2 at 8^3
    with a 4-bin RF, bench3 at maxLevel 4 (a 16^3 raster), bench5."""
    paths = {"bench1": os.path.join(d, "bench1.ski"),
             "bench5": os.path.join(d, "bench5.ski")}
    shutil.copy(os.path.join(GOLDEN, "bench1.ski"), paths["bench1"])
    shutil.copy(os.path.join(GOLDEN, "bench5.ski"), paths["bench5"])
    text = open(os.path.join(GOLDEN, "bench2.ski")).read().replace(
        'numBins="32"', 'numBins="8"').replace('numWavelengths="25"',
                                               'numWavelengths="4"')
    paths["small2"] = os.path.join(d, "small2.ski")
    open(paths["small2"], "w").write(text)
    shutil.copy(os.path.join(GOLDEN, "mrn_mean.txt"), d)
    paths["small3"] = chip_smoke.edited_ski("bench3", d, chip_smoke.B3_SMALL,
                                            out="small3")
    return paths


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every port case in one 2-rank subprocess, then `-d 2 --dd` through
    the CLI on bench1: (the directory of their results, the ski paths)."""
    d = str(tmp_path_factory.mktemp("dd"))
    paths = _skis(d)
    cases = list(SEGMENTS) + [f"ski:{paths[k]}" for k in SKIS] + [
        f"refuse:{paths['bench5']}"]
    r = subprocess.run([sys.executable, os.path.join(REPO, "tests",
                                                     "dd_runner.py"), d, "2",
                        *cases], capture_output=True, text=True,
                       timeout=TIMEOUT, env=_env(), cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    run = dd_runner.SKI_RUN
    r = subprocess.run(
        [sys.executable, "-m", "skirt9_tpu_torch", paths["bench1"], "--device",
         "cpu", "-d", "2", "--dd", "-p", str(run["num_packets"]), "-b",
         str(run["batch_size"]), "--max-events", str(run["max_events"]),
         "-o", os.path.join(d, "cli")], capture_output=True, text=True,
        timeout=TIMEOUT, env=_env(), cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    return d, paths


def _gap(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


def _hold(rf, accs, got, bound=EXACT) -> dict:
    gaps = {}
    if rf is not None:
        gaps["rf"] = _gap(rf, got["rf"])
    for key, a in accs[0].items():
        a = np.asarray(a)
        for k in range(a.shape[0]):
            if np.abs(a[k]).max() > 0:
                gaps[f"{key}{k}"] = _gap(a[k], got[f"acc0_{key}"][k])
    assert max(gaps.values()) <= bound, gaps
    return gaps


def _ref_meshed():
    """tests/test_domain.py's meshed grid problem
    (`test_meshed_cartesian_decomposition`), as `dd_runner.problem(
    meshed=True)` builds it for the port."""
    import jax.numpy as jnp

    from skirt9_tpu.grids.cartesian import make_cartesian
    from skirt9_tpu.instruments import distant as dinst
    from skirt9_tpu.media import system as msys
    from skirt9_tpu.sources.base import PointSource
    PC, sigma = dd_runner.PC, 1e-24
    xb = np.concatenate([[-PC], -PC + 2 * PC * np.geomspace(0.05, 1.0, 16)])
    grid = make_cartesian(((-PC, PC),) * 3, (16, 8, 8),
                          meshes=(xb, None, None))
    r = np.linalg.norm(np.asarray(grid.cell_centers(), np.float64), axis=-1)
    nd = np.where(r < 0.8 * PC, 1.0 / (sigma * 0.8 * PC), 0.0)
    med = msys.make_medium(grid, nd.astype(np.float32),
                           np.array([0.4e-6, 0.7e-6]),
                           np.array([[sigma, sigma]]),
                           np.full((1, 2), 0.5), np.full((1, 2), 0.3))
    inst = dinst.DistantInstrumentCfg(name="i",
                                      wave_borders=(0.5e-6, 0.6e-6),
                                      distance=100 * PC)
    return (grid, med, PointSource(luminosity=1.0, lam0=0.55e-6), inst,
            jnp.asarray([0.5e-6, 0.6e-6], jnp.float32))


@pytest.mark.parametrize("meshed", [False, True])
def test_decompose_slabs_matches_reference(meshed):
    ref_grid, *_ = _ref_meshed() if meshed else ref_cases._problem()
    grid, *_ = dd_runner.problem(meshed=meshed)
    for n in (1, 2, 4):
        a, b = ref_dom.decompose_slabs(ref_grid, n), dom.decompose_slabs(
            grid, n)
        assert a._fields == b._fields
        for x, y in zip(a, b):
            if isinstance(x, np.ndarray):
                assert np.array_equal(x, y)
            else:
                assert x == y
        assert a.max_steps_local == b.max_steps_local
    with pytest.raises(ValueError, match="not divisible"):
        dom.decompose_slabs(grid, 3)


@pytest.mark.parametrize("name", list(SEGMENTS))
def test_segment_matches_reference(name, port, monkeypatch):
    monkeypatch.delenv("SKIRT9_TPU_FORCE_SWEEP", raising=False)
    kw, events, N = SEGMENTS[name]
    grid, med, source, inst, rfb = (_ref_meshed() if kw is None
                                    else ref_cases._problem(**kw))
    opts = ref_lc.TransportOptions(max_steps=grid.max_steps(),
                                   max_events=events, rf_scale=1.0)
    rf, accs = ref_cases._run_decomposed(grid, med, source, inst, rfb, opts,
                                         N, n_dev=2)
    got = np.load(os.path.join(port[0], f"{name}.npz"))
    print(name, _hold(rf, accs, got))
    # the port's collectives: the ranks shared no card, so nothing went
    # through a host copy
    assert int(got["host_trips"]) == 0


@pytest.mark.parametrize("name", SKIS)
def test_simulation_matches_reference(name, port, monkeypatch):
    monkeypatch.delenv("SKIRT9_TPU_FORCE_SWEEP", raising=False)
    ref = ref_load_ski(port[1][name], **dd_runner.SKI_RUN)
    ref.mesh = Mesh(np.array(jax.devices()[:2]), (ref.mesh_axis,))
    ref.dd = True
    ref._build_sweep_tables()
    got = np.load(os.path.join(port[0], f"ski_{name}.npz"))
    if ref.ems_borders is not None:
        ref.iterate_secondary, ref.max_iterations = True, 1
        rf, accs, info = ref.run_with_dust_emission(verbose=False)
        for k in ("L_dust", "L_abs_primary"):
            assert float(got[k]) == pytest.approx(info[k], rel=EXACT), k
    else:
        rf, accs = ref.run_primary(verbose=False)
    print(name, _hold(rf, accs, got))


def test_cli_matches_api(port):
    """`-d 2 --dd` through the CLI writes what the API run of the same ski
    file writes, file for file."""
    d = port[0]
    api = os.path.join(d, "bench1_api_i0")
    cli = os.path.join(d, "cli", "bench1_i0")
    assert open(cli + "_sed.dat").read().splitlines()[1:] == \
        open(api + "_sed.dat").read().splitlines()[1:]
    assert np.array_equal(read_fits(cli + "_total.fits")[0],
                          read_fits(api + "_total.fits")[0])
    log = open(os.path.join(d, "cli", "bench1_log.txt")).read()
    assert "spatial domain decomposition" in log


def test_outside_the_envelope_raises(port):
    msg = str(np.load(os.path.join(port[0], "refuse_bench5.npz"))["message"])
    assert "polarization" in msg and "--dd" in msg
    with pytest.raises(ValueError, match="group"):
        load_ski(port[1]["bench1"], device="cpu", dd=True, num_packets=256)
