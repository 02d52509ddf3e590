"""The port's CUDA kernels vs their plain PyTorch versions, on the GPU.

Marked `cuda`: each test skips (inside its fixture) where no CUDA device is
present. The machine with the card has no JAX, so run them there without the
suite's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Small shapes (a 16x12x20 grid, a few thousand lanes). Bounds as in
chip_smoke.py: tau within 1e-5 relative, interaction points on the same
cells, RF within 1e-4 of its maximum, scatter sums within 1e-5 of the
largest bin; the XL pass 1's summed form within 1e-6 of its sub-step sum.

The tree kernels (4-5) run on the density octree of tests/test_mlsweep.py
(max_level 4) and a density bintree (anisotropic leaves): pass 1 equal to
its plain version bit for bit (leaf ids and tau, with and without the
record and the axis hint), pass 2's found and s_int equal and its RF within
1e-5 of its maximum (float atomics sum in another order). A tiny octree
simulation on the card launches kernels 4, 5 and 3 and no uniform-grid
sweep.

Kernel 2 also runs with config 2's 32 lane groups and kernel 3 on its
163,840-bin frame; a small config 2 with dust emission launches kernels
1-3 on the card and matches the same seed on the CPU within 1e-4 (SEDs and
RF, of their maxima). The probe kernels (8-9) are held against their plain
versions: gathers bit for bit, sums within 1e-6 relative.
"""

import numpy as np
import pytest
import torch

from skirt9_tpu_torch.grids.bintree import build_bintree
from skirt9_tpu_torch.grids.cartesian import make_cartesian
from skirt9_tpu_torch.grids.octree import build_octree
from skirt9_tpu_torch.instruments import distant as dinst
from skirt9_tpu_torch.kernels import build as kb
from skirt9_tpu_torch.media import system as msys
from skirt9_tpu_torch.ops import scatteradd as sca
from skirt9_tpu_torch.simulation import Simulation
from skirt9_tpu_torch.sources.base import PointSource
from skirt9_tpu_torch.transport import lifecycle as lc
from skirt9_tpu_torch.transport import mlsweep as ml
from skirt9_tpu_torch.transport import sweep as sw
from skirt9_tpu_torch.transport import sweepxl as xl

pytestmark = pytest.mark.cuda

PC = 3.0857e16


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kb.library()
    return torch.device("cuda")


def _inputs(dev, C, B, seed):
    rs = np.random.default_rng(seed)
    grid = make_cartesian(((-1.2 * PC, 1.2 * PC),) * 3, (16, 12, 20))
    nd1 = msys.uniform_density_sphere(grid, 1.0, 1e-24, PC)
    nd = np.stack([nd1 * rs.uniform(0.5, 1.5, nd1.shape) for _ in range(C)],
                  axis=1)
    med = msys.make_medium(grid, nd, np.array([0.4e-6, 0.7e-6]),
                           sigma_ext=np.full((C, 2), 1e-24),
                           albedo=np.full((C, 2), 0.6), g=np.full((C, 2), 0.5))
    tabs = sw.build_tables(grid.to(dev), med.to(dev))
    t32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    pos = t32(rs.uniform(-1.1 * PC, 1.1 * PC, (B, 3)))
    d = rs.normal(size=(B, 3))
    d = t32(d / np.linalg.norm(d, axis=1, keepdims=True))
    sig = t32(1e-24 * rs.uniform(0.5, 1.5, (C, B)))
    active = grid.to(dev).locate(pos) >= 0
    return tabs, pos, d, sig, active, rs


@pytest.mark.parametrize("C,hint", [(1, None), (2, None), (3, 2)])
def test_sweep_dtau_kernel(dev, C, hint):
    tabs, pos, d, sig, active, _ = _inputs(dev, C, 3000, seed=C)
    kb.reset_launches()
    k = sw.sweep_dtau(tabs, pos, d, sig, active, axis_hint=hint)
    assert kb.LAUNCHES["sweep_dtau"] == 1
    p = sw.sweep_dtau_plain(tabs, pos, d, sig, active, axis_hint=hint)
    tk, tp = k.sum(0), p.sum(0)
    assert int((tp > 0).sum()) > 1000
    rel = ((tk - tp).abs() / tp.clamp_min(1e-30))[tp > 0]
    assert float(rel.max()) <= 1e-5


@pytest.mark.parametrize("C,n_groups", [(1, 1), (2, 4), (1, 32)])
def test_sweep_deposit_kernel(dev, C, n_groups):
    B = 4096
    tabs, pos, d, sig, active, rs = _inputs(dev, C, B, seed=10 + C)
    dtau = sw.sweep_dtau_plain(tabs, pos, d, sig, active)
    grp = sw.dominant_axis(tabs, d)
    tb, tot = sw.slab_prefix(dtau, d.gather(1, grp[:, None])[:, 0] > 0)
    scale = torch.tensor(rs.uniform(0.5, 2, B), dtype=torch.float32,
                         device=dev)[None] * torch.exp(-tb)
    rel = torch.tensor(rs.uniform(size=B), dtype=torch.float32,
                       device=dev)[None] * tot - tb
    args = (tabs, pos, d, sig, active, scale, rel, n_groups)
    kb.reset_launches()
    rf_k, s_k, c_k, f_k = sw.sweep_deposit(*args)
    assert kb.LAUNCHES["sweep_deposit"] == 1
    rf_p, s_p, c_p, f_p = sw.sweep_deposit_plain(*args)
    assert float((f_k == f_p).float().mean()) >= 0.999
    both = f_k & f_p
    assert torch.equal(c_k[both], c_p[both])
    assert float((s_k[both] - s_p[both]).abs().max()) <= 1e-5 * tabs.h[0]
    assert float((rf_k - rf_p).abs().max()) <= 1e-4 * float(rf_p.abs().max())


def _xl_tables(tabs):
    return xl.XLTables(nd=tabs.nd, n=tabs.n, lo=tabs.lo, h=tabs.h,
                       nmax=tabs.nmax)


@pytest.mark.parametrize("C,hint", [(1, None), (2, None), (3, 2)])
def test_sweepxl_dtau_kernel(dev, C, hint):
    tabs, pos, d, sig, active, _ = _inputs(dev, C, 3000, seed=20 + C)
    args = (_xl_tables(tabs), pos, d, sig, active, hint)
    kb.reset_launches()
    k = xl.sweep_dtau(*args, want_sub=True)
    summed = xl.sweep_dtau(*args)
    assert kb.LAUNCHES["sweepxl_dtau"] == 2 and kb.LAUNCHES["sweep_dtau"] == 0
    p = xl.sweep_dtau_plain(*args, want_sub=True)
    assert k.shape == p.shape == (tabs.nmax, 3, 3000)
    tk, tp = k.sum(dim=(0, 1)), p.sum(dim=(0, 1))
    assert int((tp > 0).sum()) > 1000
    rel = ((tk - tp).abs() / tp.clamp_min(1e-30))[tp > 0]
    assert float(rel.max()) <= 1e-5
    scale = float(summed.abs().max())
    assert float((summed - k.sum(dim=1)).abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize("C,n_groups", [(1, 1), (2, 4)])
def test_sweepxl_deposit_kernel(dev, C, n_groups):
    B = 4096
    tabs, pos, d, sig, active, rs = _inputs(dev, C, B, seed=30 + C)
    xt = _xl_tables(tabs)
    sub = xl.sweep_dtau_plain(xt, pos, d, sig, active, want_sub=True)
    grp = sw.dominant_axis(tabs, d)
    tb, _ = sw.slab_prefix(sub.sum(dim=1),
                           d.gather(1, grp[:, None])[:, 0] > 0)
    scale = torch.tensor(rs.uniform(0.5, 2, B), dtype=torch.float32,
                         device=dev)[None] * torch.exp(-tb)
    args = (xt, pos, d, active, sub, scale, n_groups)
    kb.reset_launches()
    rf_k = xl.sweep_deposit(*args)
    assert kb.LAUNCHES["sweepxl_deposit"] == 1
    rf_p = xl.sweep_deposit_plain(*args)
    assert rf_k.shape == rf_p.shape == (n_groups, tabs.nd.shape[0])
    assert float(rf_p.min()) >= 0 and float(rf_p.max()) > 0
    assert float((rf_k - rf_p).abs().max()) <= 1e-4 * float(rf_p.abs().max())


@pytest.mark.parametrize("size", [1, 5, 4096, 50000, 163840])
def test_scatter_add_kernel(dev, size):
    rs = np.random.default_rng(size)
    n = 100003   # not a multiple of the block size: a ragged last warp
    idx = torch.tensor(rs.integers(0, size, n).astype(np.int32), device=dev)
    val = torch.tensor(rs.uniform(size=n).astype(np.float32), device=dev)
    kb.reset_launches()
    k = sca.scatter_add(idx, val, size)
    assert kb.LAUNCHES["scatter_add"] == 1
    p = sca.scatter_add_plain(idx, val, size)
    assert float((k - p).abs().max()) <= 1e-5 * float(p.abs().max())


def test_detect_on_cuda_matches_cpu(dev):
    cfg = dinst.DistantInstrumentCfg(name="i", wave_borders=(0.5e-6, 0.6e-6),
                                     distance=100 * PC, npx=32, npy=32,
                                     fovx=4 * PC, fovy=4 * PC,
                                     stats_scale=1e-3)
    rs = np.random.default_rng(3)
    B = 5000
    lam = np.full(B, 0.55e-6, np.float32)
    pos = rs.uniform(-2 * PC, 2 * PC, (B, 3)).astype(np.float32)
    contrib = rs.uniform(0, 1e-3, B).astype(np.float32)
    active = rs.uniform(size=B) > 0.1
    accs = {}
    for where in ("cpu", dev):
        acc = dinst.init_accumulators(cfg, where)
        tabs = dinst.device_tables(cfg, where)
        t = lambda a: torch.from_numpy(a).to(where)
        dinst.detect(cfg, tabs, acc, t(lam), t(pos), t(contrib),
                     dinst.KIND_PRIMARY_SCATTERED, t(active))
        accs[str(where)] = {k: v.cpu() for k, v in acc.items()}
    for key in ("sed", "stats", "frame"):
        c, g = accs["cpu"][key], accs[str(dev)][key]
        assert float((c - g).abs().max()) <= 1e-5 * float(c.abs().max())


def _dens(p):
    r = np.linalg.norm(p, axis=-1)
    return np.where(r < PC, (PC / np.maximum(r, 0.1 * PC)) ** 2, 0.0)


def _tree(kind):
    ext = ((-1.2 * PC, 1.2 * PC),) * 3
    if kind == "octree":
        return build_octree(ext, _dens, max_level=4, min_level=1,
                            max_fraction=2e-2)
    return build_bintree(ext, _dens, max_level=10, min_level=3,
                         max_fraction=2e-2)


def _tree_medium(grid, C, rs):
    nd = _dens(grid.cell_centers().double().numpy()) / (1e-24 * PC)
    nd = np.stack([nd * rs.uniform(0.5, 1.5, grid.ncells) for _ in range(C)],
                  axis=1)
    return msys.make_medium(grid, nd.astype(np.float32),
                            np.array([0.4e-6, 0.7e-6]),
                            sigma_ext=np.full((C, 2), 1e-24),
                            albedo=np.full((C, 2), 0.5),
                            g=np.full((C, 2), 0.3))


def _tree_inputs(dev, kind, C, B, seed):
    rs = np.random.default_rng(seed)
    grid = _tree(kind)
    tabs = ml.build_tables(grid.to(dev), _tree_medium(grid, C, rs).to(dev))
    t32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    pos = t32(rs.uniform(-1.1 * PC, 1.1 * PC, (B, 3)))
    d = rs.normal(size=(B, 3))
    d = t32(d / np.linalg.norm(d, axis=1, keepdims=True))
    sig = t32(1e-24 * rs.uniform(0.5, 1.5, (C, B)))
    active = grid.to(dev).locate(pos) >= 0
    return tabs, pos, d, sig, active, rs


@pytest.mark.parametrize("kind", ["octree", "bintree"])
@pytest.mark.parametrize("C,hint", [(1, None), (2, None), (1, 2)])
def test_mlsweep_dtau_kernel(dev, kind, C, hint):
    tabs, pos, d, sig, active, _ = _tree_inputs(dev, kind, C, 3000, seed=C)
    args = (tabs, pos, d, sig, active, hint)
    kb.reset_launches()
    sub, cells = ml.sweep_dtau(*args, want_sub=True)
    summed = ml.sweep_dtau(*args)
    assert kb.LAUNCHES["mlsweep_dtau"] == 2
    assert sum(kb.LAUNCHES.values()) == 2
    sub_p, cells_p = ml.sweep_dtau_plain(*args, want_sub=True)
    assert sub.shape == (tabs.n_steps, 3, 3000) and cells.dtype == torch.int32
    assert int((sub_p.sum(dim=(0, 1)) > 0).sum()) > 1000
    assert torch.equal(cells, cells_p) and torch.equal(sub, sub_p)
    assert torch.equal(summed, ml.sweep_dtau_plain(*args))


@pytest.mark.parametrize("kind", ["octree", "bintree"])
def test_mlsweep_deposit_kernel(dev, kind):
    B = 4096
    tabs, pos, d, sig, active, rs = _tree_inputs(dev, kind, 1, B, seed=7)
    sub, cells = ml.sweep_dtau_plain(tabs, pos, d, sig, active, want_sub=True)
    grp = sw.dominant_axis(tabs, d)
    tb, tot = sw.slab_prefix(sub.sum(dim=1),
                             d.gather(1, grp[:, None])[:, 0] > 0)
    lum = torch.tensor(rs.uniform(0.5, 2, B), dtype=torch.float32,
                       device=dev) * active
    tau_int = torch.tensor(rs.uniform(size=B), dtype=torch.float32,
                           device=dev) * tot
    args = (tabs, pos, d, active, sub, cells, lum, tau_int, tb, 0.7)
    kb.reset_launches()
    rf_k, s_k, c_k, f_k = ml.sweep_deposit(*args)
    assert kb.LAUNCHES["mlsweep_deposit"] == 1
    rf_p, s_p, c_p, f_p = ml.sweep_deposit_plain(*args)
    assert int(f_p.sum()) > B // 4
    assert torch.equal(f_k, f_p) and torch.equal(c_k, c_p)
    assert torch.equal(s_k, s_p)
    assert rf_k.shape == rf_p.shape == (1, tabs.nd.shape[0])
    assert float((rf_k - rf_p).abs().max()) <= 1e-5 * float(rf_p.abs().max())


def test_tree_simulation_launches(dev):
    grid = _tree("octree")
    med = _tree_medium(grid, 1, np.random.default_rng(0))
    sim = Simulation(
        grid=grid, medium=med,
        sources=[PointSource(luminosity=1.0, lam0=0.55e-6)],
        instruments=[dinst.DistantInstrumentCfg(
            name="i", wave_borders=(0.5e-6, 0.6e-6), distance=100 * PC,
            npx=16, npy=16, fovx=4 * PC, fovy=4 * PC)],
        options=lc.TransportOptions(max_steps=grid.max_steps(), max_events=4),
        rf_borders=np.array([0.5e-6, 0.6e-6]), num_packets=4096,
        batch_size=2048, seed=1, device=dev)
    assert isinstance(sim._sweep_tabs, ml.MLTables)
    kb.reset_launches()
    rf, accs = sim.run_primary(verbose=False)
    n = kb.LAUNCHES
    assert n["mlsweep_dtau"] > 0 and n["mlsweep_deposit"] > 0
    assert n["scatter_add"] > 0
    assert n["sweep_dtau"] == n["sweep_deposit"] == n["sweepxl_dtau"] == 0
    assert bool(torch.isfinite(rf).all()) and float(rf.sum()) > 0
    assert float(accs[0]["sed"].sum()) > 0


def test_config2_on_cuda_matches_cpu(dev):
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    out = {}
    for d in ("cpu", dev):
        sim = chip_smoke.config2(d, num_packets=4096, batch_size=4096, n=8,
                                 n_rf=8, max_events=4, iterate_secondary=True,
                                 max_iterations=1)
        kb.reset_launches()
        out[str(d)] = sim.run_with_dust_emission(verbose=False)
        launches = dict(kb.LAUNCHES)
    assert launches["sweep_dtau"] > 0 and launches["sweep_deposit"] > 0
    assert launches["scatter_add"] > 0 and launches["sweepxl_dtau"] == 0
    (rf_c, acc_c, info_c), (rf_g, acc_g, info_g) = out["cpu"], out[str(dev)]
    assert info_c["iterations"] == info_g["iterations"] == 1
    assert float((rf_g.cpu() - rf_c).abs().max()) <= 1e-4 * float(rf_c.max())
    sc, sg_ = acc_c[0]["sed"], acc_g[0]["sed"].cpu()
    for k in range(sc.shape[0]):
        assert float((sg_[k] - sc[k]).abs().max()) <= 1e-4 * float(
            sc[k].abs().max())


@pytest.mark.parametrize("variant", ["gather", "take", "gather_l2", "scatter"])
def test_gather_probe_kernels(dev, variant):
    from skirt9_tpu_torch.tools import gather_probe as gp
    nd, idx, vals = gp.inputs(dev)
    fn = {"gather": lambda: gp.gather(nd, idx),
          "take": lambda: gp.take(nd, idx),
          "gather_l2": lambda: gp.gather(nd, idx, staged=False),
          "scatter": lambda: gp.scatter(idx, vals * 0.5, gp.N)}[variant]
    counter = {"gather": "probe_gather_smem", "take": "probe_gather_smem",
               "gather_l2": "probe_gather_l2",
               "scatter": "probe_scatter_smem"}[variant]
    kb.reset_launches()
    got = fn()
    assert kb.LAUNCHES[counter] == 1
    if variant == "scatter":
        ref = gp.scatter_plain(idx, vals * 0.5, gp.N)
        assert float((got - ref).abs().max()) <= 1e-6 * float(ref.max())
    else:
        assert torch.equal(got, gp.gather_plain(nd, idx))


@pytest.mark.parametrize("select", [False, True])
def test_row_lookup_kernels(dev, select):
    from skirt9_tpu_torch.tools import sublane_gather as sg
    tab, idx = sg.inputs(dev)
    kb.reset_launches()
    got = sg.lookup(tab, idx, select=select)
    assert kb.LAUNCHES["row_lookup_select" if select
                       else "row_lookup_gather"] == 1
    ref = sg.lookup_plain(tab, idx)
    assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())
