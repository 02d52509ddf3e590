"""Lane refill in the port against the reference's refill, on the CPU.

The refilled configuration is `tests/test_refill.py`'s `_sim` (a 12^3 uniform
dust sphere, a monochromatic point source, 4,096 packets in batches of
1,024, refill generations of 6 events) with a 16x16 frame added, at tau 1 /
albedo 0.6 and tau 10 / albedo 0.9.

- Against the reference's refill (its resident sweep in interpret mode,
  `SKIRT9_TPU_FORCE_SWEEP=1`, as `tests/test_torch_config2.py` runs it): per
  lane RNG event counters make every packet's draws independent of its
  generation, so the two follow each other draw for draw. Every SED kind,
  the frame and the RF within 1e-5 of their largest values (they agree to
  ~3e-7: f32 rounding).
- Against the port's unrefilled run: `tests/test_refill.py`'s bounds (RF
  total 1e-4, SEDs rtol 1e-4); with refill 16 and max_events 16 the
  refilled run recovers the scattered flux that the event cap truncates.
- On the other engines, which refill wraps unchanged: the density octree of
  `tests/test_torch_slice.py` (the multi-level sweep) and config 1 at 80^3
  (the XL contracts), both against the reference's refill on its scan
  march, at the bounds of those slices.
- The emission peel-off fires only for the lanes of `emit_mask`.
"""

import os
import sys

import numpy as np
import pytest
import torch

from skirt9_tpu.grids.cartesian import make_cartesian
from skirt9_tpu.instruments import distant as ref_dinst
from skirt9_tpu.media import system as ref_msys
from skirt9_tpu.simulation import Simulation as RefSimulation
from skirt9_tpu.sources.base import PointSource as RefPointSource
from skirt9_tpu.transport import lifecycle as ref_lc
from skirt9_tpu_torch import bridge
from skirt9_tpu_torch.instruments import distant as dinst
from skirt9_tpu_torch.kernels import build as kb
from skirt9_tpu_torch.ops import rng
from skirt9_tpu_torch.sources import base as src
from skirt9_tpu_torch.transport import lifecycle as lc
from skirt9_tpu_torch.transport import mlsweep as ml
from skirt9_tpu_torch.transport import sweep as sw
from skirt9_tpu_torch.transport import sweepxl as xl

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_slice import _reference_octree  # noqa: E402

PC = 3.0857e16
CASES = [(1.0, 0.6), (10.0, 0.9)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for these small CPU runs, so that the suite's
    parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_sim(tau, albedo, refill_events, num_packets=4096, batch=1024,
             max_events=64, n=12, npix=16):
    """`tests/test_refill.py`'s `_sim` with an npix^2 frame of 4 pc."""
    grid = make_cartesian(((-1.2 * PC, 1.2 * PC),) * 3, (n,) * 3)
    sigma = 1e-24
    nd = ref_msys.uniform_density_sphere(grid, tau, sigma, PC)
    med = ref_msys.make_medium(grid, nd, np.array([0.4e-6, 0.7e-6]),
                               sigma_ext=np.array([[sigma, sigma]]),
                               albedo=np.full((1, 2), albedo),
                               g=np.full((1, 2), 0.5))
    inst = ref_dinst.DistantInstrumentCfg(
        name="i0", wave_borders=(0.5e-6, 0.6e-6), distance=100 * PC,
        npx=npix, npy=npix, fovx=4 * PC, fovy=4 * PC)
    opts = ref_lc.TransportOptions(max_steps=grid.max_steps(),
                                   max_events=max_events)
    return RefSimulation(grid=grid, medium=med,
                         sources=[RefPointSource(luminosity=1.0,
                                                 lam0=0.55e-6)],
                         instruments=[inst], options=opts,
                         rf_borders=np.array([0.5e-6, 0.6e-6]),
                         num_packets=num_packets, batch_size=batch, seed=5,
                         refill_events=refill_events)


def _np(t):
    return (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t)).astype(np.float64)


def _err_of_max(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _run_port(sim):
    kb.reset_launches()
    out = sim.run_primary(verbose=False)
    assert all(v == 0 for v in kb.LAUNCHES.values())  # CPU: plain versions
    return out


@pytest.mark.parametrize("tau,albedo", CASES)
def test_refill_matches_reference(tau, albedo, monkeypatch):
    monkeypatch.setenv("SKIRT9_TPU_FORCE_SWEEP", "1")
    ref_sim = _ref_sim(tau, albedo, refill_events=6)
    sim = bridge.simulation(ref_sim, device="cpu")
    assert sim.refill_events == 6
    assert isinstance(sim._sweep_tabs, sw.SweepTables)
    rf_r, accs_r = ref_sim.run_primary(verbose=False)
    rf, accs = _run_port(sim)
    stats = sim.last_stats
    assert stats["generations"] > 4096 // 1024 and stats["abandoned"] == 0
    # one sync per event and one per generation
    assert stats["syncs"] <= stats["events"] + 2 * stats["generations"]
    for key in ("sed", "frame"):
        assert _np(accs_r[0][key]).max() > 0, key
    for key in ("sed", "frame"):
        assert _err_of_max(accs[0][key], accs_r[0][key]) <= 1e-5, key
    assert _err_of_max(rf, rf_r) <= 1e-5


def _port_sim(tau, albedo, refill_events, **kw):
    return bridge.simulation(_ref_sim(tau, albedo, refill_events, **kw),
                             device="cpu")


@pytest.mark.parametrize("tau,albedo", CASES)
def test_refill_matches_unrefilled(tau, albedo):
    rf_a, accs_a = _run_port(_port_sim(tau, albedo, refill_events=0))
    rf_b, accs_b = _run_port(_port_sim(tau, albedo, refill_events=6))
    A, B = _np(rf_a), _np(rf_b)
    assert abs(B.sum() / A.sum() - 1.0) < 1e-4
    sa, sb = _np(accs_a[0]["sed"]), _np(accs_b[0]["sed"])
    assert np.allclose(sb, sa, rtol=1e-4, atol=1e-8 * max(sa.max(), 1e-30))


def test_refill_beyond_max_events():
    """At tau 10 / albedo 0.9 the weight cutoff needs ~80 events: a run
    capped at 16 events truncates the scattered flux, the refilled run in
    generations of 16 completes it."""
    kind = dinst.KIND_PRIMARY_SCATTERED
    scattered = []
    for refill in (0, 16):
        sim = _port_sim(10.0, 0.9, refill_events=refill, max_events=16,
                        num_packets=2048)
        _, accs = _run_port(sim)
        scattered.append(float(accs[0]["sed"][kind].double().sum()))
    assert sim.last_stats["abandoned"] == 0
    assert scattered[1] > scattered[0] * 1.02


def test_refill_octree_matches_reference():
    """The density octree slice (multi-level sweep) under refill against
    the reference's refill on its scan march, at the octree slice's bounds
    (`tests/test_torch_slice.py::test_octree_matches_reference_scan_march`)."""
    ref_sim = _reference_octree()
    ref_sim.refill_events = 2
    sim = bridge.simulation(ref_sim, device="cpu")
    assert sim.refill_events == 2 and isinstance(sim._sweep_tabs, ml.MLTables)
    rf_r, accs_r = ref_sim.run_primary(verbose=False)
    rf, accs = _run_port(sim)
    assert sim.last_stats["generations"] > 2
    sed_r = ref_dinst.calibrate_sed(ref_sim.instruments[0],
                                    {k: np.asarray(v)
                                     for k, v in accs_r[0].items()})
    sed = dinst.calibrate_sed(sim.instruments[0], accs[0])
    for kind in ("transparent", "primarydirect", "primaryscattered",
                 "total"):
        assert sed_r[kind][0] > 0
        assert sed[kind][0] == pytest.approx(sed_r[kind][0], rel=1e-4), kind
    assert _err_of_max(accs[0]["frame"], accs_r[0]["frame"]) <= 1e-5
    rf_r = _np(rf_r)
    np.testing.assert_allclose(_np(rf), rf_r, rtol=1e-4,
                               atol=1e-6 * rf_r.sum())


def test_refill_xl_matches_reference():
    """Config 1 at 80^3 with a one-bin RF, where the port picks the XL
    contracts, under refill against the reference's refill on its scan
    march, at `test_config1_xl_matches_reference`'s bounds: each SED kind
    within 1e-4 relative, the frame 1e-3 of its brightest pixel, N 0.1%,
    the RF 1e-4 of its maximum."""
    ref_sim = _ref_sim(1.0, 0.6, refill_events=4, num_packets=2048,
                       max_events=8, n=80)
    sim = bridge.simulation(ref_sim, device="cpu")
    assert isinstance(sim._sweep_tabs, xl.XLTables)
    rf_r, accs_r = ref_sim.run_primary(verbose=False)
    rf, accs = _run_port(sim)
    assert sim.last_stats["generations"] > 2
    sed_r = ref_dinst.calibrate_sed(ref_sim.instruments[0],
                                    {k: np.asarray(v)
                                     for k, v in accs_r[0].items()})
    sed = dinst.calibrate_sed(sim.instruments[0], accs[0])
    for kind in ("transparent", "primarydirect", "primaryscattered",
                 "total"):
        assert sed_r[kind][0] > 0
        assert abs(sed[kind][0] - sed_r[kind][0]) <= 1e-4 * sed_r[kind][0]
    assert abs(sed["N"][0] - sed_r["N"][0]) <= 1e-3 * sed_r["N"][0]
    assert _err_of_max(accs[0]["frame"], accs_r[0]["frame"]) <= 1e-3
    assert _err_of_max(rf, rf_r) <= 1e-4


def test_emit_mask_selects_emission_peel_off():
    """Only the lanes of emit_mask peel their emission off: half the lanes
    give half the transparent flux, none give none; the event loop and the
    returned state do not depend on the mask."""
    sim = _port_sim(1.0, 0.6, refill_events=0, num_packets=512, batch=512,
                    max_events=2)
    source, stabs = sim.sources[0], sim._src_tabs[0]
    key = rng.seed_key(sim.seed, sim.device)
    history = torch.arange(512, dtype=torch.int64)
    transparent, states = [], []
    for mask in (None, history % 2 == 0, torch.zeros(512, dtype=torch.bool)):
        pkt = src.launch_batch(source, stabs, sim.grid, key, history, 512)
        accs = [dinst.init_accumulators(c, sim.device)
                for c in sim.instruments]
        _, accs, out = lc.life_cycle(
            sim.medium, sim.options, sim.instruments, sim._inst_tabs,
            sim._rf_borders_dev, pkt, None, accs, sim._sweep_tabs,
            emit_mask=mask, return_state=True)
        transparent.append(float(accs[0]["sed"][dinst.KIND_TRANSPARENT].sum()))
        states.append(out)
    assert transparent[0] > 0 and transparent[2] == 0.0
    # f32 sums of 256 and 512 equal terms: within 512 * 2^-24 of each other
    assert transparent[1] == pytest.approx(transparent[0] / 2, rel=3e-5)
    for a, b in zip(states[0], states[2]):
        assert torch.equal(a, b)
