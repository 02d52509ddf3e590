"""The reference's dust on the grid against its normalization at the
full-width set-ups of `chip_smoke.MESHES` (the bounds of chip_smoke.py's
mass gate, `MASS_BOUNDS`), on the CPU:

    JAX_PLATFORMS=cpu python tests/reference_mass.py [name ...]

Each configuration goes through the reference's `load_ski`; the dust
entities on the grid (per-cell density times volume, f64) over the
normalization's number, minus 1, is printed with the grid's cell count.
"""

import os
import sys
import tempfile

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from skirt9_tpu.config.ski import load_ski  # noqa: E402


def deviation(name: str) -> tuple:
    with tempfile.TemporaryDirectory() as tmp:
        sim = load_ski(chip_smoke.mesh_ski(name, tmp), num_packets=1024,
                       batch_size=1024, max_events=1)
    nd = np.asarray(sim.medium.nd, np.float64)[:, 0]
    n_grid = float((nd * np.asarray(sim.grid.volumes(), np.float64)).sum())
    number = chip_smoke.torus_number() if "torus" in name else \
        chip_smoke.dust_disk_number()
    return sim.grid.ncells, n_grid / number - 1


if __name__ == "__main__":
    for name in sys.argv[1:] or list(chip_smoke.MASS_BOUNDS):
        cells, dev = deviation(name)
        print(f"{name}: {cells} cells, dust on the grid / normalization "
              f"- 1 = {dev:.6g}", flush=True)
