"""Polarization, kinematics, Lyman-alpha and X-ray physics on the tree
(multi-level) and XL sweeps, draw for draw against the reference's own
sweeps in interpret mode (`SKIRT9_TPU_FORCE_SWEEP=1`, as
`tests/test_torch_treexl.py::test_tree_xl_draw_for_draw` runs them), on
the CPU, one torch thread.

The reference's chain (`skirt9_tpu/simulation.py:184-240`,
`lifecycle.py:566-608`) gives each case its engine, and the port's
`Simulation` takes the same one (held by `bridge.simulation`, which puts
the port's own tables in place where the reference builds XL tables):

- bench5's static disk on a maxLevel-3 density octree (288 leaves):
  polarization on the tree sweep (kernels 4-5's plain versions);
- bench5's moving disk on that octree: polarization and kinematics on the
  tree's 8^3 voxel raster (the multi-level sweep declines kinematics, the
  XL contracts take it: the cross sections are Thomson's, no RF);
- bench6 (Lyman-alpha at one gas temperature) and bench7 (X-ray gas) on
  a maxLevel-3 octree: the tree's voxel raster.

The same options on uniform grids with XL tables put in place are the
cases of the rewritten `test_other_engines_raise` of
`tests/test_torch_config5.py` and `tests/test_torch_config67.py`, through
`run_both` here. 1,024 packets in one batch, 4 events. The light that
polarization does not touch agrees within 1e-5 of each maximum (~3e-6
measured); the polarized sums within `chip_smoke.B5_BOUNDS` (ROADMAP C:
the reference's azimuth is chaotic to an ulp).
"""

import os
import sys

import numpy as np
import pytest
import torch

from skirt9_tpu.config.ski import load_ski as ref_load_ski
from skirt9_tpu_torch import bridge
from skirt9_tpu_torch.kernels import build as kb
from skirt9_tpu_torch.transport import lifecycle as lc
from skirt9_tpu_torch.transport import march as mr
from skirt9_tpu_torch.transport import mlsweep as ml
from skirt9_tpu_torch.transport import sweepxl as xl

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

EXACT = 1e-5
RUN = dict(num_packets=1024, batch_size=1024, max_events=4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_reference(name, directory, edits, **run):
    """The reference's load_ski of an edited golden ski file."""
    return ref_load_ski(chip_smoke.edited_ski(name, directory, edits),
                        **dict(RUN, **run))


def run_both(ref, port):
    """Both primary runs, the port's with no kernel launched and no march
    (a spy on the plain march); every SED, frame and Stokes row of the
    first instrument within 1e-5 of its maximum, the polarized rows within
    B5_BOUNDS. Returns the gaps."""
    calls = []

    def spy(*args):
        calls.append(args)
        raise AssertionError("the port marched")

    real = mr.march_geometry_plain
    mr.march_geometry_plain = spy
    try:
        _, accs_r = ref.run_primary(verbose=False)
        kb.reset_launches()
        _, accs_p = port.run_primary(verbose=False)
    finally:
        mr.march_geometry_plain = real
    assert not calls and kb.LAUNCHES == {k: 0 for k in kb.LAUNCHES}
    gaps = {}
    for key in ("sed", "frame", "stokes", "frame_stokes"):
        if key not in accs_r[0]:
            continue
        r = np.asarray(accs_r[0][key], np.float64)
        p = accs_p[0][key].double().numpy()
        assert r.shape == p.shape
        for j in range(min(r.shape[0], 3)):
            m = np.abs(r[j]).max()
            if key in ("stokes", "frame_stokes") and j == 2:
                assert m == 0.0 and np.abs(p[j]).max() == 0.0   # V
                continue
            assert m > 0, (key, j)
            gaps[f"{key}{j}"] = float(np.abs(p[j] - r[j]).max() / m)
    for k, e in gaps.items():
        assert e <= chip_smoke.B5_BOUNDS.get(k, EXACT), (k, e, gaps)
    return gaps


@pytest.mark.parametrize("case", ["bench5_static", "bench5_moving",
                                  "bench6", "bench7"])
def test_tree_engines_draw_for_draw(case, tmp_path, monkeypatch):
    monkeypatch.setenv("SKIRT9_TPU_FORCE_SWEEP", "1")
    name = case.split("_")[0]
    edits = chip_smoke.tree_edits(name, 3)
    if case == "bench5_static":
        edits.update(chip_smoke.B5_STATIC)
    ref = load_reference(name, tmp_path, edits)
    port = bridge.simulation(ref, "cpu")
    assert type(port.grid).__name__ == "OctreeGrid"
    engine = ml.MLTables if case == "bench5_static" else xl.XLTables
    assert type(ref._sweep_tabs).__name__ == engine.__name__
    assert isinstance(port._sweep_tabs, engine)
    if engine is xl.XLTables:
        assert port._sweep_tabs.cellmap is not None
    o = port.options
    on = {"bench5_static": o.polarization and not o.kinematics,
          "bench5_moving": o.polarization and o.kinematics,
          "bench6": o.lya, "bench7": o.xray}[case]
    assert on
    gate = lc.sweep_gate(port.medium, o, port._sweep_tabs, None,
                         port.batch_size)
    assert gate.use_sweep, gate.why
    run_both(ref, port)
