"""The clumpy spherical grid's configurations against the reference, on
the CPU with one torch thread (the grid itself: tests/test_torch_clumpy.py).

- The loader on the reference's own tests/test_clumpy.py ski file and on
  chip_smoke's reduced clumpy torus (its clump file written by the test)
  array for array against the reference's `load_ski` + `bridge.py`.
- The reduced torus draw for draw against the reference's march: the
  transparent and direct light within 1e-5 of each maximum, the scattered
  light by its sums within 1e-2 (measured 2.0e-3): a lane whose
  interaction point moves by an ulp (the ulps that XLA's and PyTorch's log
  and exp part by) can graze a clump on one side and miss it on the
  other, and one lane of 512 is 2e-3 of the scattered light; every march
  of the reference's life cycle reproduced exactly on its own inputs.
- DustEmission on it raises, naming the grid (the reference has no cell
  bounds for it).
- An off-centre point source on the reduced torus (chip_smoke's
  aimed_source, its rays through clumps at an angle): the direct light
  toward the 80-degree instrument equal to exp(-tau) of the cells'
  geometry (chip_smoke.walk_tau, f64 on the host) and of the step's own
  plain walk (chip_smoke.march_tau) within 1e-3, as chip_smoke gates it
  at full width.
"""

import inspect
import os
import sys

import jax
import numpy as np
import pytest
import torch

from skirt9_tpu.config.ski import load_ski as ref_load_ski
from skirt9_tpu.transport import lifecycle as ref_lc
from skirt9_tpu_torch import bridge
from skirt9_tpu_torch.config.ski import load_ski
from skirt9_tpu_torch.grids import clumpy as pc
from skirt9_tpu_torch.kernels import build as kb
from skirt9_tpu_torch.sources import secondary as sec
from skirt9_tpu_torch.transport import march as mr

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke  # noqa: E402
from test_torch_polar import _gaps  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ski_of_reference_test(directory) -> str:
    """tests/test_clumpy.py's test_clumpy_ski ski file and clump file."""
    import test_clumpy
    src = inspect.getsource(test_clumpy.test_clumpy_ski)
    text = src[src.index('"""\\\n') + 5:src.index('"""))')]
    with open(os.path.join(str(directory), "clumps.txt"), "w") as f:
        f.write("0.5 0 0 0.15\n-0.4 0.2 0 0.1\n")
    path = os.path.join(str(directory), "cl.ski")
    with open(path, "w") as f:
        f.write(text)
    return path


RUN = dict(num_packets=512, batch_size=512, max_events=2)
# the scattered light's sums, port against reference (measured 2.0e-3 at
# 2,048 packets and 3 events); per bin it parts by a lane's share
SCATTERED_SUM = 1e-2


@pytest.mark.parametrize("case", ["reference_test", "clumpy_torus_small"])
def test_loader_matches_reference(case, tmp_path):
    path = (_ski_of_reference_test(tmp_path) if case == "reference_test"
            else chip_smoke.mesh_ski(case, tmp_path))
    ref = ref_load_ski(path, **RUN)
    port = load_ski(path, device="cpu", **RUN)
    conv = bridge.simulation(ref, "cpu")
    assert type(port.grid) is type(conv.grid) is pc.ClumpySphericalGrid
    for a, b in zip(port.grid, conv.grid):
        if torch.is_tensor(a):
            assert torch.equal(a, b)
        else:
            assert all(torch.equal(x, y) if torch.is_tensor(x) else x == y
                       for x, y in zip(a, b))
    np.testing.assert_array_equal(port.grid.volumes(), ref.grid.volumes())
    np.testing.assert_array_equal(port.grid.cell_centers().numpy(),
                                  np.asarray(ref.grid.cell_centers()))
    assert torch.equal(port.medium.nd, conv.medium.nd)
    assert port.options == conv.options
    assert port.options.max_steps == min(ref.grid.max_steps(), 256)
    if case == "clumpy_torus_small":
        assert port.grid.n_clumps > 20


def test_draw_for_draw(tmp_path, monkeypatch):
    ref = ref_load_ski(chip_smoke.mesh_ski("clumpy_torus_small", tmp_path),
                       **RUN)
    port = bridge.simulation(ref, "cpu", march=True)
    marched = []
    plain = mr.march_geometry_plain
    monkeypatch.setattr(mr, "march_geometry_plain",
                        lambda *a: marched.append(a[0]) or plain(*a))
    out_r = ref.run_primary(verbose=False)
    kb.reset_launches()
    out_p = port.run_primary(verbose=False)
    assert kb.LAUNCHES == {k: 0 for k in kb.LAUNCHES}
    assert marched and all(g is port.grid for g in marched)
    gaps = _gaps(out_r, out_p)
    for k, g in gaps.items():
        if k[-1] != "2":
            assert g <= 1e-5, (k, gaps)
    for key in ("sed", "frame"):
        a = np.asarray(out_r[1][0][key], np.float64)[2].sum()
        b = float(out_p[1][0][key][2].double().sum())
        assert a > 0 and abs(b / a - 1) <= SCATTERED_SUM, (key, b / a - 1)


def test_life_cycle_marches_exact(tmp_path, monkeypatch):
    ref = ref_load_ski(chip_smoke.mesh_ski("clumpy_torus_small", tmp_path),
                       num_packets=128, batch_size=128, max_events=2)
    port = bridge.simulation(ref, "cpu", march=True)
    rec = []
    orig = ref_lc.march_geometry

    def spy(grid, pos0, dirn, cell0, max_steps, mask):
        cells, ds = orig(grid, pos0, dirn, cell0, max_steps, mask)
        jax.debug.callback(lambda *a: rec.append([np.asarray(x) for x in a]),
                           pos0, dirn, cell0, mask, cells, ds)
        return cells, ds

    monkeypatch.setattr(ref_lc, "march_geometry", spy)
    ref.run_primary(verbose=False)
    assert len(rec) >= 5
    for pos0, dirn, cell0, mask, cells_r, ds_r in rec:
        dirn = np.broadcast_to(dirn, pos0.shape).copy()
        cells_p, ds_p = mr.march_geometry_plain(
            port.grid, torch.tensor(pos0), torch.tensor(dirn),
            torch.tensor(cell0).long(), cells_r.shape[0], torch.tensor(mask))
        walked = ds_r > 0
        assert np.array_equal(ds_r, ds_p.numpy())
        assert np.array_equal(cells_r[walked], cells_p.numpy()[walked])


def test_dust_emission_raises(tmp_path):
    path = chip_smoke.mesh_ski("clumpy_torus_small", tmp_path)
    sim = load_ski(path, device="cpu", num_packets=128)
    with pytest.raises(NotImplementedError,
                       match="DustEmission on a ClumpySphericalGrid"):
        sec.cell_bounds(sim.grid)
    text = open(path).read()
    open(path, "w").write(text.replace('simulationMode="ExtinctionOnly"',
                                       'simulationMode="DustEmission"'))
    with pytest.raises(NotImplementedError,
                       match="DustEmission on a ClumpySphericalSpatialGrid"):
        load_ski(path, device="cpu", num_packets=128)


def test_off_centre_direct_light(tmp_path):
    sim = chip_smoke.mesh_config("clumpy_torus_small_point", "cpu", tmp_path,
                                 num_packets=256, batch_size=256,
                                 max_events=1)
    _, accs = sim.run_primary(verbose=False)
    sed = accs[1]["sed"].double()
    att = float(sed[1].sum() / sed[0].sum())
    tau = chip_smoke.walk_tau(sim, inst=1)
    tau_m, reach = chip_smoke.march_tau(sim, inst=1)
    src = np.asarray(sim.sources[0].position) / chip_smoke.PC
    assert np.linalg.norm(src) >= 1.0
    assert tau > 0.1 and reach == pytest.approx(1.0, abs=1e-6)
    assert att == pytest.approx(np.exp(-tau), rel=1e-3)
    assert att == pytest.approx(np.exp(-tau_m), rel=1e-3)
