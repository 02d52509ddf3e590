"""Runs a group of the port's paths in a fresh interpreter and checks that
neither jax nor any module of the JAX package was imported, and that no
CUDA kernel was launched (the CPU takes the plain versions).

Each group is one subprocess with one OpenMP and one torch thread, so that
groups on parallel test workers do not oversubscribe the cores, and each
has its own time limit. The test files `tests/test_torch_nojax_*.py` hold
the groups, one parametrised `test_port_never_imports_jax` each.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300

PREAMBLE = """
import os, sys, tempfile
import numpy as np
import torch
torch.set_num_threads(1)
from skirt9_tpu_torch.grids.cartesian import make_cartesian
from skirt9_tpu_torch.grids.octree import build_octree
from skirt9_tpu_torch.instruments.distant import DistantInstrumentCfg
from skirt9_tpu_torch.kernels import build as kb
from skirt9_tpu_torch.media import system as msys
from skirt9_tpu_torch.simulation import Simulation
from skirt9_tpu_torch.sources.base import PointSource
from skirt9_tpu_torch.transport.lifecycle import TransportOptions
from skirt9_tpu_torch.transport.mlsweep import MLTables
from skirt9_tpu_torch.config.ski import load_ski
from skirt9_tpu_torch.__main__ import main
import chip_smoke
PC = 3.0857e16
ext = ((-1.2 * PC, 1.2 * PC),) * 3
inst = DistantInstrumentCfg(name="i0", wave_borders=(0.5e-6, 0.6e-6),
                            distance=100 * PC, npx=8, npy=8, fovx=4 * PC,
                            fovy=4 * PC)
"""

EPILOGUE = """
assert kb.LAUNCHES == {k: 0 for k in kb.LAUNCHES}, kb.LAUNCHES
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
ref = sorted(m for m in sys.modules
             if m == "skirt9_tpu" or m.startswith("skirt9_tpu."))
assert not ref, ref
print("ok")
"""


def run(code: str) -> None:
    """Run PREAMBLE + code + EPILOGUE in a subprocess from the repository
    root; it must exit 0 and print ok."""
    path = [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
        os.pathsep) if p]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(path),
               OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", PREAMBLE + code + EPILOGUE],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
