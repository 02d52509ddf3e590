"""Packet data parallelism (`parallel/dp.py`) against the reference's
2-device mesh, on the CPU.

The port runs on 2 gloo ranks in a subprocess (`tests/dp_runner.py`, its
own time limit; each rank asserts that it imported neither jax nor the JAX
package, and that every rank holds the same RF after the segment's
all_reduce); the reference runs the same ski file on
`Mesh(jax.devices()[:2], ("pp",))` (conftest's eight virtual CPU devices),
its sweeps in interpret mode (`SKIRT9_TPU_FORCE_SWEEP=1`). Both lay the
lanes out alike: the batch rounded to 2 x 128 lanes (2 x 1024 R_g with
strata), each rank the r-th block of every batch with its own bin-pure
groups, a refilled rank its own history range.

- Reduced config 1 (bench1.ski, 8,192 packets in batches of 2,048): every
  accumulator within 1e-5 of its maximum (measured 1.9e-8: f32 rounding).
- Reduced config 2 (bench2.ski at 8^3 with a 4-bin RF: 4 strata per rank,
  dust emission with one secondary iteration): the RF and every
  accumulator within 1e-5 (measured 1.8e-7 and 9.1e-7), L_dust and
  L_abs_primary within 1e-5 relative.
- Reduced config 1h (bench1h.ski, refill generations of 16 events): within
  1e-5 but the scattered kind and the statistics' higher power sums
  (measured up to 8.6e-6), within 1e-4: one device alone already
  parts from the reference by 6.7e-5 there. Its packets scatter into the
  same directions at every event, bit for bit, but one peel-off lands in
  the pixel beside the reference's (the projection onto the frame, the
  reference's `pos @ ex` dot, an ulp apart at a pixel border); 2 ranks
  against 1 differ by 1.0e-5 at most (the transparent frame's f32 sums in
  another order).
- The CLI: tests/test_torch_dp_cli.py.
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
RUNNER = os.path.join(REPO, "tests", "dp_runner.py")
TIMEOUT = 600


def _env():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    env.pop("XLA_FLAGS", None)
    return env


def _port(ski, out, ranks, **kw):
    r = subprocess.run([sys.executable, RUNNER, ski, str(out), str(ranks)]
                       + [f"{k}={v}" for k, v in kw.items()],
                       capture_output=True, text=True, timeout=TIMEOUT,
                       env=_env(), cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    return np.load(out)


def _small_bench2(d) -> str:
    ski = open(os.path.join(GOLDEN, "bench2.ski")).read()
    ski = ski.replace('numBins="32"', 'numBins="8"').replace(
        'numWavelengths="25"', 'numWavelengths="4"')
    path = os.path.join(str(d), "small2.ski")
    open(path, "w").write(ski)
    shutil.copy(os.path.join(GOLDEN, "mrn_mean.txt"), str(d))
    return path


CASES = {
    "config1": (lambda d: os.path.join(GOLDEN, "bench1.ski"),
                dict(num_packets=8192, batch_size=2048, max_events=8), {},
                {}),
    "config2": (_small_bench2,
                dict(num_packets=8192, batch_size=4096, max_events=4),
                dict(dust=1, iterate=1), {}),
    "config1h": (lambda d: os.path.join(GOLDEN, "bench1h.ski"),
                 dict(num_packets=8192, batch_size=2048, max_events=64),
                 dict(refill_events=16), {("sed", 2): 1e-4,
                                          ("frame", 2): 1e-4,
                                          ("stats", 2): 1e-4,
                                          ("stats", 3): 1e-4,
                                          ("stats", 4): 1e-4}),
}


def _gap(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_match_reference_mesh(name, tmp_path, monkeypatch):
    monkeypatch.setenv("SKIRT9_TPU_FORCE_SWEEP", "1")
    make, kw, run, bounds = CASES[name]
    ski = make(tmp_path)
    got = _port(ski, tmp_path / "port.npz", 2, **kw, **run)
    ref = ref_load_ski(ski, **kw)
    ref.mesh = Mesh(np.array(jax.devices()[:2]), ("pp",))
    ref.refill_events = run.get("refill_events", 0)
    if run.get("iterate"):
        ref.iterate_secondary, ref.max_iterations = True, 1
    if run.get("dust"):
        rf, accs, info = ref.run_with_dust_emission(verbose=False)
        for k in ("L_dust", "L_abs_primary"):
            assert float(got[k]) == pytest.approx(info[k], rel=1e-5), k
    else:
        rf, accs = ref.run_primary(verbose=False)
    if rf is not None:
        assert _gap(rf, got["rf"]) <= 1e-5
    for key, a in accs[0].items():
        a = np.asarray(a)
        for k in range(a.shape[0]):
            if np.abs(a[k]).max() > 0:
                assert _gap(a[k], got[f"acc0_{key}"][k]) <= bounds.get(
                    (key, k), 1e-5), (key, k)
