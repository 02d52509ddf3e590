"""Packet data parallelism through the CLI (`python -m skirt9_tpu_torch
-d N`), on the CPU: `-d 2 --device cpu` on bench1 (two gloo ranks) against
`-d 1` within 1e-6 of each SED column's maximum (measured 9e-9), `-d 1`
(one rank) equal to the run without -d (text for text), the same files
written (rank 0 alone writes), and `--dd` exits 2 naming item 26. The
ranks' agreement with the reference: tests/test_torch_dp.py.
"""

import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
TIMEOUT = 600


def _env():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    env.pop("XLA_FLAGS", None)
    return env


def _cli(outdir, *extra):
    r = subprocess.run(
        [sys.executable, "-m", "skirt9_tpu_torch",
         os.path.join(GOLDEN, "bench1.ski"), "--device", "cpu", "-p", "8192",
         "-b", "2048", "--max-events", "8", "-o", str(outdir), *extra],
        capture_output=True, text=True, timeout=TIMEOUT, env=_env(),
        cwd=REPO)
    return r


def test_cli_data_parallel(tmp_path):
    runs = {}
    for name, extra in (("d2", ("-d", "2")), ("d1", ("-d", "1")),
                        ("plain", ())):
        r = _cli(tmp_path / name, *extra)
        assert r.returncode == 0, r.stderr[-3000:]
        runs[name] = tmp_path / name
    sed = {k: np.loadtxt(v / "bench1_i0_sed.dat") for k, v in runs.items()}
    assert sorted(os.listdir(runs["d2"])) == sorted(os.listdir(runs["plain"]))
    assert (runs["d1"] / "bench1_i0_sed.dat").read_text() == \
        (runs["plain"] / "bench1_i0_sed.dat").read_text()
    scale = np.abs(sed["d1"]).max(axis=0)
    assert (np.abs(sed["d2"] - sed["d1"]) <= 1e-6 * scale).all()
    r = _cli(tmp_path / "dd", "-d", "2", "--dd")
    assert r.returncode == 2 and "item 26" in r.stderr
