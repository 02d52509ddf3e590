"""DustEmission on the 1D sphere against the reference, on the CPU.

The reference's `Sphere1DGrid.cell_bounds` gives each shell the cube of its
outer radius, and its secondary launch is uniform in that cube: a dust
packet may start in another shell or outside the sphere, whence the
launch's `move_inside` carries it along its direction onto the outer shell
(or it misses the sphere and carries nothing). The port does the same.

The reduced Ivezic shell with dust emission (`chip_smoke.ivezic_ski(...,
dust=True)`, `ivezic_dust_small`: 12 shells, an 8-bin RF, 8 emission
bins, 4,096 packets in batches of 2,048, 8 events), run by the reference's
`run_with_dust_emission` on its scan march and by the port's, the same
seed: the RF and every SED kind and frame within 1e-5 of their maxima
(measured 2.8e-6 and 3.1e-7), L_dust and L_abs_primary within 1e-5
relative, and L_dust equal to L_abs_primary (no self-absorption
iterations) within 1e-5.
"""

import os
import sys

import numpy as np
import pytest
import torch

from skirt9_tpu.config.ski import load_ski as ref_load_ski
from skirt9_tpu_torch.config.ski import load_ski
from skirt9_tpu_torch.grids.sphere import Sphere1DGrid
from skirt9_tpu_torch.instruments import distant as dinst
from skirt9_tpu_torch.kernels import build as kb

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

RUN = dict(num_packets=4096, batch_size=2048, max_events=8)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _gap(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = b.double().numpy()
    return float(np.abs(a - b).max() / np.abs(a).max())


def test_dust_emission_on_sphere1d_draw_for_draw(tmp_path):
    path = chip_smoke.geometric_ski("ivezic_dust_small", tmp_path)
    ref = ref_load_ski(path, **RUN)
    port = load_ski(path, device="cpu", **RUN)
    assert isinstance(port.grid, Sphere1DGrid)
    assert port.ems_borders is not None and port._sweep_tabs is None
    lo, hi = port.grid.cell_bounds()
    r_lo, r_hi = ref.grid.cell_bounds()
    assert np.array_equal(lo, r_lo) and np.array_equal(hi, r_hi)
    rf_r, accs_r, info_r = ref.run_with_dust_emission(verbose=False)
    kb.reset_launches()
    rf_p, accs_p, info_p = port.run_with_dust_emission(verbose=False)
    assert kb.LAUNCHES == {k: 0 for k in kb.LAUNCHES}
    assert [s[0] for s in port.last_stats["segments"]] == ["primary",
                                                          "secondary"]
    for k in ("L_dust", "L_abs_primary"):
        assert info_p[k] == pytest.approx(info_r[k], rel=1e-5), k
    assert info_p["L_dust"] == pytest.approx(info_p["L_abs_primary"],
                                             rel=1e-5)
    assert _gap(rf_r, rf_p) <= 1e-5
    for key in ("sed", "frame"):
        a = np.asarray(accs_r[0][key])
        for k in range(a.shape[0]):
            if np.abs(a[k]).max() > 0:
                assert _gap(a[k], accs_p[0][key][k]) <= 1e-5, (key, k)
    # the secondary light reached the instrument
    assert float(accs_p[0]["sed"][dinst.KIND_SECONDARY_DIRECT].sum()) > 0
