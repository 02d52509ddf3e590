"""Spatial domain decomposition on the XL route (`parallel/domain.py`
`build_local_xl`, `dd_segment(xl_local=)`, `Simulation(dd=True)` under
`SKIRT9_TPU_FORCE_SWEEP=1`) against the reference's, on the CPU.

The port runs every case in one 2-rank gloo subprocess (`tests/dd_runner.py`,
one torch thread a rank; each rank asserts that it imported neither jax nor
the JAX package); the reference runs `dd_segment` with `build_local_xl`, or
`Simulation` with `dd`, on `Mesh(jax.devices()[:2])` (conftest's virtual
CPU devices) with `SKIRT9_TPU_FORCE_SWEEP=1`, its XL sweep in interpret
mode. The bound is the reference's own for its XL route against its march
route (`tests/test_domain.py::test_dd_xl_sweep_matches_march`), 1e-3 of
each maximum: the reference's slab tables are int8 or bf16 hi/lo splits of
the density, the port's its f32 rows. Measured: the RF within 2.2e-7 of its
maximum, the SED and the frame within 7e-8, on one and on two medium
components; the port's XL route against its own march route within 2.8e-7.

- `dd_segment` on the XL route, four events of 1,024 histories on 16^3, one
  and two components (tests/test_domain.py's problems), against the
  reference's 2-device DD-XL run, and against the port's march route;
- `load_ski(bench1.ski, dd=True)` (no RF stored) under
  `SKIRT9_TPU_FORCE_SWEEP=1`: the XL route taken, against the reference's
  `Simulation.dd` on the same variable (the SED and the frame within
  5.3e-7).
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
from skirt9_tpu.transport import lifecycle as ref_lc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
import dd_runner  # noqa: E402
import test_domain as ref_cases  # noqa: E402

GOLDEN = os.path.join(REPO, "tests", "golden")
TIMEOUT = 600
BOUND = 1e-3
COMPONENTS = (1, 2)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The port's cases in one 2-rank subprocess: (result directory, the
    bench1 ski path)."""
    d = str(tmp_path_factory.mktemp("ddxl"))
    ski = os.path.join(d, "bench1.ski")
    shutil.copy(os.path.join(GOLDEN, "bench1.ski"), ski)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    env.pop("SKIRT9_TPU_FORCE_SWEEP", None)
    cases = [f"{route}_c{c}" for route in ("xl", "march")
             for c in COMPONENTS] + [f"skixl:{ski}"]
    r = subprocess.run([sys.executable, os.path.join(REPO, "tests",
                                                     "dd_runner.py"), d, "2",
                        *cases], capture_output=True, text=True,
                       timeout=TIMEOUT, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    return d, ski


def _gaps(rf, accs, got) -> dict:
    """Each quantity's largest difference over its maximum: the RF and
    every nonzero kind of every accumulator."""
    g = lambda a, b: float(np.abs(np.asarray(a, np.float64) - b).max()
                           / np.abs(np.asarray(a, np.float64)).max())
    gaps = {} if rf is None else {"rf": g(rf, got["rf"])}
    for key, a in accs[0].items():
        a = np.asarray(a)
        for k in range(a.shape[0]):
            if np.abs(a[k]).max() > 0:
                gaps[f"{key}{k}"] = g(a[k], got[f"acc0_{key}"][k])
    return gaps


@pytest.mark.parametrize("ncomp", COMPONENTS)
def test_xl_segment_matches_reference(ncomp, port, monkeypatch):
    monkeypatch.setenv("SKIRT9_TPU_FORCE_SWEEP", "1")
    grid, med, source, inst, rfb = ref_cases._problem(ncomp=ncomp, nrf=1)
    opts = ref_lc.TransportOptions(max_steps=grid.max_steps(), max_events=4,
                                   rf_scale=1.0)
    rf, accs = ref_cases._run_decomposed(grid, med, source, inst, rfb, opts,
                                         1024, n_dev=2, xl=True)
    got = np.load(os.path.join(port[0], f"xl_c{ncomp}.npz"))
    gaps = _gaps(rf, accs, got)
    print(ncomp, gaps)
    assert {"rf", "sed2", "frame2"} <= set(gaps)
    assert max(gaps.values()) <= BOUND, gaps


@pytest.mark.parametrize("ncomp", COMPONENTS)
def test_xl_route_matches_march_route(ncomp, port):
    """The port's two routes on the same problem, as the reference's test
    holds its own: the slab march against the slabs' XL contracts."""
    d = port[0]
    xl, march = (np.load(os.path.join(d, f"{route}_c{ncomp}.npz"))
                 for route in ("xl", "march"))
    gaps = {k: float(np.abs(xl[k].astype(np.float64) - march[k]).max()
                     / np.abs(march[k].astype(np.float64)).max())
            for k in ("rf", "acc0_sed", "acc0_frame")}
    print(ncomp, gaps)
    assert max(gaps.values()) <= BOUND, gaps


def test_simulation_xl_route_matches_reference(port, monkeypatch):
    """`Simulation(dd=True)` on bench1 (32^3, one RF bin) under
    `SKIRT9_TPU_FORCE_SWEEP=1` takes the XL route, as the reference's
    does, and matches its 2-device run."""
    monkeypatch.setenv("SKIRT9_TPU_FORCE_SWEEP", "1")
    got = np.load(os.path.join(port[0], "skixl_bench1.npz"))
    assert bool(got["xl_route"])
    ref = ref_load_ski(port[1], **dd_runner.SKI_RUN)
    ref.mesh = Mesh(np.array(jax.devices()[:2]), (ref.mesh_axis,))
    ref.dd = True
    ref._build_sweep_tables()
    rf, accs = ref.run_primary(verbose=False)
    assert rf is None and "rf" not in got.files      # bench1 stores none
    gaps = _gaps(rf, accs, got)
    print(gaps)
    assert {"sed2", "frame2"} <= set(gaps)
    assert max(gaps.values()) <= BOUND, gaps
