"""The port's XL engine at 80^3 against its resident sweep, on the CPU.

At 80^3 the port picks the large-grid (XL) contracts by itself, and its
run of config 1 (a point source in a uniform dust sphere, a one-bin RF)
matches the same seed on the resident sweep, at the CPU-vs-GPU
draw-for-draw bounds of chip_smoke.py (SEDs 1e-4, frame 1e-3 of its
maximum, RF total 1e-4). No kernel is launched: the CPU takes the plain
versions.
"""

import numpy as np

from skirt9_tpu_torch.grids.cartesian import make_cartesian as port_cartesian
from skirt9_tpu_torch.instruments import distant as dinst
from skirt9_tpu_torch.kernels import build as kb
from skirt9_tpu_torch.media import system as msys
from skirt9_tpu_torch.simulation import Simulation
from skirt9_tpu_torch.sources.base import PointSource
from skirt9_tpu_torch.transport import lifecycle as lc
from skirt9_tpu_torch.transport import sweep as sw
from skirt9_tpu_torch.transport import sweepxl as xl

PC = 3.0857e16


def _port_config1(n: int):
    """Config 1 with a one-bin RF on an n^3 grid, through the port's API."""
    grid = port_cartesian(((-1.2 * PC, 1.2 * PC),) * 3, (n,) * 3)
    nd = msys.uniform_density_sphere(grid, 1.0, 1e-24, PC)
    med = msys.make_medium(grid, nd, np.array([0.4e-6, 0.7e-6]),
                           sigma_ext=np.full((1, 2), 1e-24),
                           albedo=np.full((1, 2), 0.6), g=np.full((1, 2), 0.5))
    inst = dinst.DistantInstrumentCfg(
        name="i0", wave_borders=(0.5e-6, 0.6e-6), distance=100 * PC,
        npx=16, npy=16, fovx=4 * PC, fovy=4 * PC)
    return Simulation(grid=grid, medium=med,
                      sources=[PointSource(luminosity=1.0, lam0=0.55e-6)],
                      instruments=[inst],
                      options=lc.TransportOptions(max_steps=grid.max_steps(),
                                                  max_events=8),
                      rf_borders=np.array([0.5e-6, 0.6e-6]),
                      num_packets=2048, batch_size=1024, seed=0,
                      device="cpu")


def test_xl_engine_at_80_matches_resident():
    runs = []
    for engine in ("xl", "resident"):
        sim = _port_config1(80)
        assert isinstance(sim._sweep_tabs, xl.XLTables)
        if engine == "resident":
            sim._sweep_tabs = sw.build_tables(sim.grid, sim.medium)
        kb.reset_launches()
        runs.append(sim.run_primary(verbose=False))
        assert all(v == 0 for v in kb.LAUNCHES.values())
    (rf_x, accs_x), (rf_s, accs_s) = runs
    sed_x = dinst.calibrate_sed(sim.instruments[0], accs_x[0])
    sed_s = dinst.calibrate_sed(sim.instruments[0], accs_s[0])
    for kind in ("transparent", "primarydirect", "primaryscattered", "total"):
        assert sed_s[kind][0] > 0
        assert abs(sed_x[kind][0] - sed_s[kind][0]) <= 1e-4 * sed_s[kind][0]
    fx, fs = accs_x[0]["frame"].double(), accs_s[0]["frame"].double()
    assert float((fx - fs).abs().max()) <= 1e-3 * float(fs.abs().max())
    tx, ts = float(rf_x.double().sum()), float(rf_s.double().sum())
    assert ts > 0 and abs(tx - ts) <= 1e-4 * ts
