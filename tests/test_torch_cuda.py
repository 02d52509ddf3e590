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
simulation on the card launches kernels 4, 5 and detect and no
uniform-grid sweep. Kernel 4's total and prefix modes: the total and the
prefix within 1e-6 of each lane's tau, the record, leaf ids, step sums and
lane range bit for bit; the tree event loop launches the prefix mode once
per event and the total once per peel-off, and calls no `slab_prefix`,
`_lane_range` or `torch.sum` over a record.

Kernel 1's three output modes: `sweep_dtau` bit for bit against its plain
version, `sweep_tau_total` and `sweep_dtau_prefix` within 1e-6 of each
lane's total tau, and the lane range the kernel forms equal to
`sweep._lane_range` bit for bit, also on axis-parallel rays and rays that
start on cell faces or outside an off-centre grid. The fused `detect`
kernel: one launch per call, every accumulator within 1e-5 of its maximum
of the plain `detect`'s terms summed exactly (in float64) on the same CUDA
tensors, added in place.

Kernel 6's four modes (the summed form and the record bit for bit, the
total and the prefix within 1e-6 of each lane's tau, the lane range it forms
equal to `_lane_range`) at 80^3 and at 97x80x64 (nmax off the run length),
with inactive lanes, lanes outside the box and tiny direction components;
the XL event loop launches the prefix mode once per event and the total
once per peel-off, and calls no `slab_prefix`, `_lane_range` or
`torch.sum` over a record. Kernel 7's prefix mode (pass 2 from the prefix
with the interaction search inside) at 80^3, 97x80x64 and 256^3: s_int,
icell and found bit for bit, the RF within 1e-4 of its maximum, with an RF,
with a zero luminosity and without an RF; the XL loop launches it once per
event with or without an RF and calls neither `resolve_interaction` nor
`sweep_deposit`.

Kernel 2 also runs with config 2's 32 lane groups and kernel 3 on its
163,840-bin frame; a small config 2 with dust emission launches kernels
1-3 on the card and matches the same seed on the CPU within 1e-4 (SEDs and
RF, of their maxima). The probe kernels (8-9) are held against their plain
versions: gathers bit for bit, sums within 1e-6 relative, also at table
sizes that are no multiple of the 16-byte staging loads, and against a
hand-built reference for indices outside the table (gather 0, scatter
nothing); the row-lookup select loop and row gather bit for bit, also off
their block grids.

Lane refill: bench1h through the port's `load_ski` (8,192 packets in
batches of 2,048, generations of 16 events) on the card launches kernels 1,
2 and detect and matches the same seed on the CPU, each SED kind within
2e-5 relative and the frame within 1e-3 of its brightest pixel; on a
refilled batch (dead, fresh and old lanes side by side) kernels 1, 2 and
detect hold their plain versions as chip_smoke.py's
`check_refilled_batch` does.
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


@pytest.mark.parametrize("C,hint", [(1, None), (2, None), (3, 2)])
def test_sweep_fused_modes_kernel(dev, C, hint):
    tabs, pos, d, sig, active, _ = _inputs(dev, C, 3000, seed=40 + C)
    args = (tabs, pos, d, sig, active, hint)
    kb.reset_launches()
    tau = sw.sweep_dtau(*args)
    tot = sw.sweep_tau_total(*args)
    tb, tot_c, lane = sw.sweep_dtau_prefix(*args)
    assert (kb.LAUNCHES["sweep_dtau"], kb.LAUNCHES["sweep_tau_total"],
            kb.LAUNCHES["sweep_dtau_prefix"]) == (1, 1, 1)
    assert sum(kb.LAUNCHES.values()) == 3
    assert torch.equal(tau, sw.sweep_dtau_plain(*args))
    tot_p = sw.sweep_tau_total_plain(*args)
    assert int((tot_p > 0).sum()) > 1000
    assert bool(((tot - tot_p).abs() <= 1e-6 * tot_p).all())
    assert torch.equal(tot, tot_c)
    tb_p, _, lane_p = sw.sweep_dtau_prefix_plain(*args)
    assert bool(((tb - tb_p).abs() <= 1e-6 * tot_p[None, :]).all())
    for a, b in zip(lane, lane_p):
        assert torch.equal(a, b)


def test_lane_range_kernel(dev):
    rs = np.random.default_rng(8)
    shape = (9, 5, 13)
    ext = ((0.3 * PC, 2.1 * PC), (-3 * PC, -0.5 * PC), (-1 * PC, 1.7 * PC))
    grid = make_cartesian(ext, shape)
    nd = rs.uniform(0.5, 1.5, grid.ncells) / (1e-24 * PC)
    med = msys.make_medium(grid, nd, np.array([0.4e-6, 0.7e-6]),
                           sigma_ext=np.full((1, 2), 1e-24),
                           albedo=np.full((1, 2), 0.6), g=np.full((1, 2), 0.5))
    tabs = sw.build_tables(grid.to(dev), med.to(dev))
    B, k = 4096, 1024
    lo, hi = np.array([e[0] for e in ext]), np.array([e[1] for e in ext])
    pos = rs.uniform(lo - 0.2 * (hi - lo), hi + 0.2 * (hi - lo), (B, 3))
    d = rs.normal(size=(B, 3))
    # axis-parallel rays, rays in a coordinate plane, starts on cell faces
    d[:k] = 0.0
    d[np.arange(k), rs.integers(0, 3, k)] = rs.choice([-1.0, 1.0], k)
    d[k:2 * k, 1] = 0.0
    h = (hi - lo) / np.array(shape)
    pos[2 * k:3 * k] = lo + h * rs.integers(0, np.array(shape) + 1, (k, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    pos, d = t32(pos), t32(d)
    sig = torch.full((1, B), 1e-24, device=dev)
    active = torch.tensor(rs.uniform(size=B) > 0.1, device=dev)
    _, _, lane = sw.sweep_dtau_prefix(tabs, pos, d, sig, active)
    for a, b in zip(lane, sw._lane_range(tabs, pos, d, active)):
        assert torch.equal(a, b)
    assert int((lane[2] > lane[1]).sum()) > B // 4
    tau = sw.sweep_dtau(tabs, pos, d, sig, active)
    assert int((tau.sum(0) > 0).sum()) > B // 4
    assert torch.equal(tau, sw.sweep_dtau_plain(tabs, pos, d, sig, active))


@pytest.mark.parametrize("nb,npix", [(1, 64), (40, 64), (40, 0)])
def test_detect_kernel(dev, nb, npix):
    rs = np.random.default_rng(nb + npix)
    borders = ((0.5e-6, 0.6e-6) if nb == 1
               else tuple(np.geomspace(0.09e-6, 1000e-6, nb + 1)))
    cfg = dinst.DistantInstrumentCfg(
        name="i", wave_borders=borders, inclination=0.4, azimuth=0.9,
        distance=100 * PC, npx=npix, npy=npix, fovx=4 * PC, fovy=4 * PC,
        stats_scale=1e-3)
    B = 20000
    lam = (np.full(B, 0.55e-6) if nb == 1 else
           np.exp(rs.uniform(np.log(0.05e-6), np.log(2000e-6), B)))
    pos = rs.uniform(-2.5 * PC, 2.5 * PC, (B, 3))
    pos[64:320] = pos[64]                      # whole warps on one pixel
    contrib = rs.uniform(0, 1e-3, B) * (rs.uniform(size=B) > 0.1)
    t32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    ins = (t32(lam), t32(pos), t32(contrib))
    active = torch.tensor(rs.uniform(size=B) > 0.1, device=dev)
    tabs = dinst.device_tables(cfg, dev)
    acc_k = dinst.init_accumulators(cfg, dev)
    acc_p = dinst.init_accumulators(cfg, dev)

    def scatter_f64(idx, val, size):
        out = torch.zeros(size, dtype=torch.float64, device=val.device)
        return out.index_add_(0, idx.long(), val.double()).float()

    for kind in range(dinst.NUM_KINDS):
        kb.reset_launches()
        dinst.detect(cfg, tabs, acc_k, *ins, kind, active)
        assert kb.LAUNCHES["detect"] == 1 and sum(kb.LAUNCHES.values()) == 1
        dinst.detect_plain(cfg, tabs, acc_p, *ins, kind, active,
                           scatter=scatter_f64)
    for key in acc_p:
        ref = acc_p[key]
        assert float(ref.abs().max()) > 0
        err = float((acc_k[key] - ref).abs().max())
        assert err <= 1e-5 * float(ref.abs().max()), (key, err)
    # each launch leaves its per-call sums and counters zeroed, and its
    # flags at most its own epoch
    sums, flags, _, counts = tabs["scratch"]
    assert float(sums.abs().max()) == 0 and int(counts.abs().max()) == 0
    assert 0 <= int(flags.min()) and int(flags.max()) <= tabs["epoch"]


def test_detect_kernel_subnormal_sums(dev):
    """Sums that global float atomics flush to zero: a quarter of the lanes
    add subnormal frame contributions (1e-40) and a quarter statistics
    powers cn^4 = 1e-44, in blocks before the ones that add normal values
    to the same pixel and bins. Each touched entry must still reach its
    accumulator once per call, unlost, also across the wrap of the calls'
    epochs: the frame pixel of calls 1-2 rests while calls 3-4 reach the
    epoch's maximum and wrap, and is hit again by call 5, whose epoch
    equals call 2's."""
    B, calls = 1 << 17, 5
    cfg = dinst.DistantInstrumentCfg(
        name="i", wave_borders=(0.5e-6, 0.6e-6, 0.7e-6), distance=100 * PC,
        npx=16, npy=16, fovx=4 * PC, fovy=4 * PC, stats_scale=1.0)
    rs = np.random.default_rng(5)
    lam = np.full(B, 0.65e-6)
    lam[B // 2:] = rs.choice([0.55e-6, 0.65e-6], B // 2)
    contrib = np.concatenate([np.full(B // 4, 1e-40), np.full(B // 4, 1e-11),
                              rs.uniform(0.5, 1.0, B // 2)])
    t32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    ins = [(t32(lam), t32(np.full((B, 3), x * PC)), t32(contrib))
           for x in (0.3, -0.5)]                  # two pixels
    assert 0 < float(ins[0][2][0]) < 1.2e-38       # a subnormal f32
    active = torch.ones(B, dtype=torch.bool, device=dev)
    tabs = dinst.device_tables(cfg, dev)
    acc_k = dinst.init_accumulators(cfg, dev)
    kb.reset_launches()
    for i in range(calls):
        if i == 2:
            tabs["epoch"] = 0x7FFFFFFF - 1     # the fourth call wraps to 1
        dinst.detect(cfg, tabs, acc_k, *ins[2 <= i <= 3],
                     dinst.KIND_PRIMARY_DIRECT, active)
    assert kb.LAUNCHES["detect"] == calls

    def scatter_f64(idx, val, size):
        out = torch.zeros(size, dtype=torch.float64, device=val.device)
        return out.index_add_(0, idx.long(), val.double()).float()

    acc_p = [dinst.detect_plain(cfg, tabs, dinst.init_accumulators(cfg, dev),
                                *x, dinst.KIND_PRIMARY_DIRECT, active,
                                scatter=scatter_f64) for x in ins]
    for key in acc_p[0]:
        ref = acc_p[0][key] * 3 + acc_p[1][key] * 2
        err = (acc_k[key] - ref).abs()
        assert float(err.max()) <= 1e-5 * float(ref.abs().max()), key
        # every row of the statistics, bin for bin, within 1e-5 of itself
        if key == "stats":
            assert bool((err[:4] <= 1e-5 * ref[:4].abs()).all())
    assert tabs["epoch"] == 2
    sums, flags, _, counts = tabs["scratch"]
    assert float(sums.abs().max()) == 0 and int(counts.abs().max()) == 0
    assert 0 <= int(flags.min()) and int(flags.max()) <= 2


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
    # pass 1's lane range in place of pass 2's own set-up: the same result
    lane = sw.sweep_dtau_prefix(tabs, pos, d, sig, active)[2]
    rf_l, s_l, c_l, f_l = sw.sweep_deposit(*args, lane=lane)
    assert torch.equal(s_l, s_k) and torch.equal(c_l, c_k)
    assert torch.equal(f_l, f_k)
    assert float((rf_l - rf_k).abs().max()) <= 1e-5 * float(rf_k.abs().max())
    assert float((f_k == f_p).float().mean()) >= 0.999
    both = f_k & f_p
    assert torch.equal(c_k[both], c_p[both])
    assert float((s_k[both] - s_p[both]).abs().max()) <= 1e-5 * tabs.h[0]
    assert float((rf_k - rf_p).abs().max()) <= 1e-4 * float(rf_p.abs().max())


@pytest.mark.parametrize("C,n_groups,bins", [(1, 1, None), (2, 4, None),
                                              (1, 32, 25)])
def test_sweep_deposit_prefix_kernel(dev, C, n_groups, bins):
    """Pass 2 from pass 1's prefix against its plain version on the card;
    with 32 groups folded into 25 bins by a map that drops one group and
    lets others share a bin."""
    B = 4096
    tabs, pos, d, sig, active, rs = _inputs(dev, C, B, seed=30 + C)
    tb, tot, lane = sw.sweep_dtau_prefix(tabs, pos, d, sig, active)
    lum = torch.tensor(rs.uniform(0.5, 2, B), dtype=torch.float32,
                       device=dev) * active
    tau_int = torch.tensor(rs.uniform(size=B), dtype=torch.float32,
                           device=dev) * tot
    bin_map, nbins = None, 0
    if bins is not None:
        m = rs.integers(0, bins, n_groups)
        m[:bins] = np.arange(bins)
        m[-1] = -1
        bin_map = torch.tensor(m, dtype=torch.int32, device=dev)
        nbins = bins
    args = (tabs, pos, d, sig, active, lum, tau_int, tb, 0.7, lane, n_groups,
            bin_map, nbins)
    kb.reset_launches()
    rf_k, s_k, c_k, f_k = sw.sweep_deposit_prefix(*args)
    assert kb.LAUNCHES["sweep_deposit_prefix"] == 1
    assert sum(kb.LAUNCHES.values()) == 1
    rf_p, s_p, c_p, f_p = sw.sweep_deposit_prefix_plain(*args)
    assert rf_k.shape == rf_p.shape == (nbins or n_groups, tabs.nd.shape[0])
    assert int(f_p.sum()) > B // 4
    assert float((f_k == f_p).float().mean()) >= 0.999
    both = f_k & f_p
    assert torch.equal(c_k[both], c_p[both])
    assert float((s_k[both] - s_p[both]).abs().max()) <= 1e-5 * tabs.h[0]
    assert float((rf_k - rf_p).abs().max()) <= 1e-4 * float(rf_p.abs().max())
    if bins is not None:
        assert int((rf_p.abs().sum(dim=1) > 0).sum()) == bins


def test_sweep_deposit_prefix_kernel_drops_bins_out_of_range(dev):
    """A bin map entry outside [0, nbins) drops its group's deposits on the
    card as -1 does, and writes nothing past the RF's rows."""
    B, n_groups, nbins = 4096, 8, 3
    tabs, pos, d, sig, active, rs = _inputs(dev, 1, B, seed=36)
    tb, tot, lane = sw.sweep_dtau_prefix(tabs, pos, d, sig, active)
    lum = torch.tensor(rs.uniform(0.5, 2, B), dtype=torch.float32,
                       device=dev) * active
    tau_int = torch.tensor(rs.uniform(size=B), dtype=torch.float32,
                           device=dev) * tot
    bins = torch.tensor([0, 1, 2, 3, 1 << 20, -7, 2, 0], dtype=torch.int32,
                        device=dev)
    dropped = torch.where((bins >= 0) & (bins < nbins), bins, -1)
    args = (tabs, pos, d, sig, active, lum, tau_int, tb, 0.7, lane, n_groups)
    rf_k, s_k, c_k, f_k = sw.sweep_deposit_prefix(*args, bins, nbins)
    rf_m = sw.sweep_deposit_prefix(*args, dropped, nbins)[0]
    rf_p = sw.sweep_deposit_prefix_plain(*args, bins, nbins)[0]
    assert rf_k.shape == (nbins, tabs.nd.shape[0])
    assert int((rf_p.abs().sum(dim=1) > 0).sum()) == nbins
    assert float((rf_k - rf_p).abs().max()) <= 1e-4 * float(rf_p.abs().max())
    assert float((rf_m - rf_p).abs().max()) <= 1e-4 * float(rf_p.abs().max())


def test_sweep_deposit_prefix_forms_scale_and_rel(dev):
    """scale and rel formed inside the kernel equal the event loop's torch
    expressions bit for bit: with one row per lane every RF entry takes one
    contribution, so the RF is the contributions themselves, and they and
    the interaction points equal those of the reference-contract mode fed
    the torch tensors."""
    B = 512
    tabs, pos, d, sig, active, rs = _inputs(dev, 2, B, seed=40)
    tb, tot, lane = sw.sweep_dtau_prefix(tabs, pos, d, sig, active)
    lum = torch.tensor(rs.uniform(0.5, 2, B), dtype=torch.float32,
                       device=dev) * active
    tau_int = torch.tensor(rs.uniform(size=B), dtype=torch.float32,
                           device=dev) * tot
    inv_sqrt = 1.0 / float(np.sqrt(37.0))
    got = sw.sweep_deposit_prefix(tabs, pos, d, sig, active, lum * inv_sqrt,
                                  tau_int, tb, inv_sqrt, lane, n_groups=B)
    scale = ((lum * inv_sqrt)[None, :] * torch.exp(-tb)) * inv_sqrt
    rel = tau_int[None, :] - tb
    want = sw.sweep_deposit(tabs, pos, d, sig, active, scale, rel,
                            n_groups=B, lane=lane)
    assert int(want[3].sum()) > B // 4 and float(want[0].max()) > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _xl_tables(tabs):
    return xl.XLTables(nd=tabs.nd, n=tabs.n, lo=tabs.lo, h=tabs.h,
                       nmax=tabs.nmax, axes=tabs.axes, geom=tabs.geom)


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


def _xl_inputs(dev, shape, C, B, seed, edge):
    """XL tables on an off-centre grid of the given shape and rays; with
    edge, an eighth of the rays start outside the box, an eighth have a
    direction component below 1e-30, an eighth run along -z, and a fifth
    of the lanes are inactive."""
    rs = np.random.default_rng(seed)
    grid = make_cartesian(((-1.1 * PC, 1.3 * PC), (-1.2 * PC, 1.2 * PC),
                           (-1.3 * PC, 1.0 * PC)), shape)
    nd1 = msys.uniform_density_sphere(grid, 1.0, 1e-24, PC)
    nd = np.stack([nd1 * rs.uniform(0.5, 1.5, nd1.shape) for _ in range(C)],
                  axis=1)
    med = msys.make_medium(grid, nd, np.array([0.4e-6, 0.7e-6]),
                           sigma_ext=np.full((C, 2), 1e-24),
                           albedo=np.full((C, 2), 0.6), g=np.full((C, 2), 0.5))
    tabs = _xl_tables(sw.build_tables(grid.to(dev), med.to(dev)))
    pos = rs.uniform(-1.0 * PC, 1.0 * PC, (B, 3))
    d = rs.normal(size=(B, 3))
    if edge:
        k = B // 8
        pos[:k] = rs.uniform(-2 * PC, 2 * PC, (k, 3))
        d[k:2 * k][np.arange(k), rs.integers(0, 3, k)] = 1e-35
        d[2 * k:3 * k] = [0.0, 0.0, -1.0]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    pos, d = t32(pos), t32(d)
    sig = t32(1e-24 * rs.uniform(0.5, 1.5, (C, B)))
    active = torch.tensor(rs.uniform(size=B) > (0.2 if edge else 0.0),
                          device=dev)
    return tabs, pos, d, sig, active


@pytest.mark.parametrize("shape,C,hint,edge", [
    ((80, 80, 80), 1, None, False), ((80, 80, 80), 2, 1, False),
    ((97, 80, 64), 1, None, False), ((97, 80, 64), 3, None, True),
    ((80, 80, 80), 1, 2, True)],
    ids=["80^3", "80^3-C2-hint", "97x80x64", "97x80x64-C3-edge",
         "80^3-hint-edge"])
def test_sweepxl_modes_kernel(dev, shape, C, hint, edge):
    """Kernel 6's four modes against their plain versions: the record and
    the summed form bit for bit, the total and the prefix within 1e-6 of
    each lane's tau, the lane range equal to `_lane_range`; one launch per
    call, each counted under its mode's name."""
    tabs, pos, d, sig, active = _xl_inputs(dev, shape, C, 4096, 60 + C, edge)
    args = (tabs, pos, d, sig, active, hint)
    kb.reset_launches()
    summed = xl.sweep_dtau(*args)
    sub = xl.sweep_dtau(*args, want_sub=True)
    tot = xl.sweep_tau_total(*args)
    rec, tb, tot_c, lane = xl.sweep_dtau_prefix(*args)
    assert (kb.LAUNCHES["sweepxl_dtau"], kb.LAUNCHES["sweepxl_tau_total"],
            kb.LAUNCHES["sweepxl_dtau_prefix"]) == (2, 1, 1)
    assert sum(kb.LAUNCHES.values()) == 4
    assert torch.equal(summed, xl.sweep_dtau_plain(*args))
    p_sub = xl.sweep_dtau_plain(*args, want_sub=True)
    assert torch.equal(sub, p_sub) and torch.equal(rec, p_sub)
    tot_p = xl.sweep_tau_total_plain(*args)
    assert int((tot_p > 0).sum()) > 1000
    for t in (tot, tot_c):
        assert bool(((t - tot_p).abs() <= 1e-6 * tot_p).all())
    _, tb_p, tot_pp, lane_p = xl.sweep_dtau_prefix_plain(*args)
    assert torch.equal(tot_pp, tot_p)
    assert bool(((tb - tb_p).abs() <= 1e-6 * tot_p[None, :]).all())
    for a, b in zip(lane, lane_p):
        assert torch.equal(a, b)
    if edge:
        assert int((lane[2] == lane[1]).sum()) > 4096 // 5


@pytest.mark.parametrize("store_rf", [False, True], ids=["no_rf", "rf"])
def test_xl_loop_launches(dev, store_rf, monkeypatch):
    """The XL event loop: one `sweepxl_dtau_prefix` launch per event, one
    `sweepxl_tau_total` per peel-off, one `sweepxl_deposit_prefix` per
    event with or without an RF, no other pass-1 or pass-2 form; no
    `slab_prefix`, no `_lane_range`, no `torch.sum` over a record and no
    `resolve_interaction` or `sweep_deposit` call."""
    grid = make_cartesian(((-1.2 * PC, 1.2 * PC),) * 3, (80, 80, 80))
    med = msys.make_medium(
        grid, msys.uniform_density_sphere(grid, 1.0, 1e-24, PC),
        np.array([0.4e-6, 0.7e-6]), sigma_ext=np.full((1, 2), 1e-24),
        albedo=np.full((1, 2), 0.6), g=np.full((1, 2), 0.5))
    sim = Simulation(
        grid=grid, medium=med,
        sources=[PointSource(luminosity=1.0, lam0=0.55e-6)],
        instruments=[dinst.DistantInstrumentCfg(
            name="i", wave_borders=(0.5e-6, 0.6e-6), distance=100 * PC,
            npx=16, npy=16, fovx=4 * PC, fovy=4 * PC)],
        options=lc.TransportOptions(max_steps=grid.max_steps(),
                                    max_events=4),
        rf_borders=np.array([0.5e-6, 0.6e-6]) if store_rf else None,
        num_packets=8192, batch_size=4096, seed=1, device=dev)
    assert isinstance(sim._sweep_tabs, xl.XLTables)
    nmax = sim._sweep_tabs.nmax

    def refuse(*a, **k):
        raise AssertionError("not on the XL loop")

    torch_sum = torch.sum

    def guarded_sum(x, *a, **k):
        if x.dim() == 3 and x.shape[:2] == (nmax, 3):
            raise AssertionError("torch.sum over the record")
        return torch_sum(x, *a, **k)

    monkeypatch.setattr(sw, "slab_prefix", refuse)
    monkeypatch.setattr(sw, "_lane_range", refuse)
    monkeypatch.setattr(xl, "resolve_interaction", refuse)
    monkeypatch.setattr(xl, "sweep_deposit", refuse)
    monkeypatch.setattr(torch, "sum", guarded_sum)
    kb.reset_launches()
    rf, accs = sim.run_primary(verbose=False)
    n = dict(kb.LAUNCHES)
    events = sim.last_stats["events"]
    assert events > 2
    assert n["sweepxl_dtau_prefix"] == events
    # the emission peel-off of each of the 2 batches, then one per event
    assert n["sweepxl_tau_total"] == 2 + events
    assert n["sweepxl_deposit_prefix"] == events
    assert n["sweepxl_deposit"] == n["sweepxl_dtau"] == 0
    assert n["detect"] > 0
    for name in ("sweep_dtau", "sweep_tau_total", "sweep_dtau_prefix",
                 "sweep_deposit", "sweep_deposit_prefix", "scatter_add"):
        assert n[name] == 0, name
    assert float(accs[0]["sed"].sum()) > 0
    if store_rf:
        assert bool(torch.isfinite(rf).all()) and float(rf.sum()) > 0


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


@pytest.mark.parametrize("shape,C,edge", [
    ((80, 80, 80), 1, False), ((97, 80, 64), 3, True), ((256,) * 3, 1, False)],
    ids=["80^3", "97x80x64-C3-edge", "256^3"])
def test_sweepxl_deposit_prefix_kernel(dev, shape, C, edge):
    """Kernel 7's prefix mode against its plain version on pass 1's record,
    prefix and lane range: s_int, icell and found bit for bit, the RF
    within 1e-4 of its maximum; with an RF, with lum_half = 0 (no deposit)
    and without an RF; tau_int 0 on some lanes and past the total on
    others, lanes that may not interact; one launch per call."""
    B = 4096
    tabs, pos, d, sig, active = _xl_inputs(dev, shape, C, B, 80 + C, edge)
    perm = xl.lane_order(tabs, pos, d, sw.dominant_axis(tabs, d))
    pos, d, sig, active = pos[perm], d[perm], sig[:, perm], active[perm]
    rec, tb, tot, lane = xl.sweep_dtau_prefix(tabs, pos, d, sig, active)
    rs = np.random.default_rng(7)
    u = rs.uniform(0.0, 1.2, B)
    u[:B // 8] = 0.0
    tau_int = torch.tensor(u, dtype=torch.float32, device=dev) * tot
    act_int = active & torch.tensor(rs.uniform(size=B) > 0.1, device=dev)
    lum = torch.tensor(rs.uniform(0.5, 2, B), dtype=torch.float32,
                       device=dev) * active
    for lm in (lum, torch.zeros_like(lum), None):
        args = (tabs, pos, d, act_int, rec, lm, tau_int, tb, 0.7, lane)
        kb.reset_launches()
        rf_k, *hit_k = xl.sweep_deposit_prefix(*args)
        assert kb.LAUNCHES["sweepxl_deposit_prefix"] == 1
        assert sum(kb.LAUNCHES.values()) == 1
        rf_p, *hit_p = xl.sweep_deposit_prefix_plain(*args)
        assert int(hit_p[2].sum()) > B // 4
        for a, b in zip(hit_k, hit_p):
            assert a.dtype == b.dtype and torch.equal(a, b)
        if lm is None:
            assert rf_k is None and rf_p is None
        elif lm is lum:
            assert rf_k.shape == rf_p.shape == (1, tabs.nd.shape[0])
            m = float(rf_p.abs().max())
            assert m > 0
            assert float((rf_k - rf_p).abs().max()) <= 1e-4 * m
        else:
            assert float(rf_k.abs().max()) == 0.0


@pytest.mark.parametrize("kind", ["octree", "bintree"])
@pytest.mark.parametrize("C,hint", [(1, None), (2, None), (1, 2)])
def test_mlsweep_modes_kernel(dev, kind, C, hint):
    """Kernel 4's total and prefix modes against their plain versions: the
    total and the prefix within 1e-6 of each lane's tau, the record, leaf
    ids, step sums and lane range bit for bit, no leaf ids where none are
    asked for; one launch per call, each counted under its mode's name."""
    tabs, pos, d, sig, active, _ = _tree_inputs(dev, kind, C, 3000,
                                                seed=40 + C)
    args = (tabs, pos, d, sig, active, hint)
    kb.reset_launches()
    tot = ml.sweep_tau_total(*args)
    rec, cells, steps, tb, tot_c, lane = ml.sweep_dtau_prefix(*args)
    rec_n, cells_n, *_ = ml.sweep_dtau_prefix(*args, leaf_ids=False)
    assert (kb.LAUNCHES["mlsweep_tau_total"],
            kb.LAUNCHES["mlsweep_dtau_prefix"]) == (1, 2)
    assert sum(kb.LAUNCHES.values()) == 3
    tot_p = ml.sweep_tau_total_plain(*args)
    assert int((tot_p > 0).sum()) > 1000
    for t in (tot, tot_c):
        assert bool(((t - tot_p).abs() <= 1e-6 * tot_p).all())
    rec_p, cells_p, steps_p, tb_p, _, lane_p = ml.sweep_dtau_prefix_plain(
        *args)
    assert torch.equal(rec, rec_p) and torch.equal(cells, cells_p)
    assert torch.equal(steps, steps_p) and torch.equal(rec_n, rec_p)
    assert cells_n is None
    assert bool(((tb - tb_p).abs() <= 1e-6 * tot_p[None, :]).all())
    for a, b in zip(lane, lane_p):
        assert torch.equal(a, b)


@pytest.mark.parametrize("store_rf", [False, True], ids=["no_rf", "rf"])
def test_tree_loop_launches(dev, store_rf, monkeypatch):
    """The tree event loop: one `mlsweep_dtau_prefix` launch per event, one
    `mlsweep_tau_total` per peel-off, kernel 5 per event with an RF, no
    reference-mode pass 1; no `slab_prefix`, no `_lane_range` and no
    `torch.sum` over a record."""
    grid = _tree("octree")
    med = _tree_medium(grid, 1, np.random.default_rng(0))
    sim = Simulation(
        grid=grid, medium=med,
        sources=[PointSource(luminosity=1.0, lam0=0.55e-6)],
        instruments=[dinst.DistantInstrumentCfg(
            name="i", wave_borders=(0.5e-6, 0.6e-6), distance=100 * PC,
            npx=16, npy=16, fovx=4 * PC, fovy=4 * PC)],
        options=lc.TransportOptions(max_steps=grid.max_steps(),
                                    max_events=4),
        rf_borders=np.array([0.5e-6, 0.6e-6]) if store_rf else None,
        num_packets=8192, batch_size=4096, seed=1, device=dev)
    assert isinstance(sim._sweep_tabs, ml.MLTables)
    n_steps = sim._sweep_tabs.n_steps

    def refuse(*a, **k):
        raise AssertionError("not on the tree loop")

    torch_sum = torch.sum

    def guarded_sum(x, *a, **k):
        if x.dim() == 3 and x.shape[:2] == (n_steps, 3):
            raise AssertionError("torch.sum over the record")
        return torch_sum(x, *a, **k)

    monkeypatch.setattr(sw, "slab_prefix", refuse)
    monkeypatch.setattr(sw, "_lane_range", refuse)
    monkeypatch.setattr(torch, "sum", guarded_sum)
    kb.reset_launches()
    rf, accs = sim.run_primary(verbose=False)
    n = dict(kb.LAUNCHES)
    events = sim.last_stats["events"]
    assert events > 2
    assert n["mlsweep_dtau_prefix"] == events
    # the emission peel-off of each of the 2 batches, then one per event
    assert n["mlsweep_tau_total"] == 2 + events
    assert n["mlsweep_deposit"] == (events if store_rf else 0)
    assert n["mlsweep_dtau"] == 0 and n["detect"] > 0
    assert float(accs[0]["sed"].sum()) > 0
    if store_rf:
        assert bool(torch.isfinite(rf).all()) and float(rf.sum()) > 0


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
        kb.reset_launches()
        dinst.detect(cfg, tabs, acc, t(lam), t(pos), t(contrib),
                     dinst.KIND_PRIMARY_SCATTERED, t(active))
        assert kb.LAUNCHES["detect"] == (where != "cpu")
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


@pytest.mark.parametrize("kind", ["octree", "bintree"])
def test_mlsweep_deposit_kernel_global(dev, kind, monkeypatch):
    """Pass 2 on trees whose leaves do not fit the block-private table: the
    kernel's global-atomic path (forced here by a zero leaf budget), with
    pass 1's lane range passed in."""
    monkeypatch.setattr(ml, "SHARED_LEAVES", 0)
    B = 4096
    tabs, pos, d, sig, active, rs = _tree_inputs(dev, kind, 1, B, seed=8)
    lane = sw._lane_range(tabs, pos, d, active)
    sub, cells = ml.sweep_dtau(tabs, pos, d, sig, active, want_sub=True)
    tb, tot = sw.slab_prefix(sub.sum(dim=1), d.gather(
        1, lane[0].long()[:, None])[:, 0] > 0)
    lum = torch.tensor(rs.uniform(0.5, 2, B), dtype=torch.float32,
                       device=dev) * active
    tau_int = torch.tensor(rs.uniform(size=B), dtype=torch.float32,
                           device=dev) * tot
    args = (tabs, pos, d, active, sub, cells, lum, tau_int, tb, 0.7)
    kb.reset_launches()
    rf_k, s_k, c_k, f_k = ml.sweep_deposit(*args, lane=lane)
    assert kb.LAUNCHES["mlsweep_deposit"] == 1
    rf_p, s_p, c_p, f_p = ml.sweep_deposit_plain(*args)
    assert int(f_p.sum()) > B // 4
    assert torch.equal(f_k, f_p) and torch.equal(c_k, c_p)
    assert torch.equal(s_k, s_p)
    assert float((rf_k - rf_p).abs().max()) <= 1e-5 * float(rf_p.abs().max())


@pytest.mark.parametrize("engine", ["tree", "tree_no_rf", "xl"])
def test_event_loop_copies_nothing_from_host(dev, engine):
    """Three profiled events of the tree loop (with an RF: pass 2 in kernel
    5; without: `resolve_interaction`) and of the XL loop: no host-to-device
    copy issued inside the loop's profiler range, and every device
    operation traced to the runtime call that issued it."""
    from skirt9_tpu_torch.tools import event_profile as ep
    if engine != "xl":
        grid = _tree("octree")
        med = _tree_medium(grid, 1, np.random.default_rng(0))
    else:
        grid = make_cartesian(((-1.2 * PC, 1.2 * PC),) * 3, (80, 80, 80))
        med = msys.make_medium(
            grid, msys.uniform_density_sphere(grid, 1.0, 1e-24, PC),
            np.array([0.4e-6, 0.7e-6]), sigma_ext=np.full((1, 2), 1e-24),
            albedo=np.full((1, 2), 0.6), g=np.full((1, 2), 0.5))
    sim = Simulation(
        grid=grid, medium=med,
        sources=[PointSource(luminosity=1.0, lam0=0.55e-6)],
        instruments=[dinst.DistantInstrumentCfg(
            name="i", wave_borders=(0.5e-6, 0.6e-6), distance=100 * PC,
            npx=16, npy=16, fovx=4 * PC, fovy=4 * PC)],
        options=lc.TransportOptions(max_steps=grid.max_steps(),
                                    max_events=3),
        rf_borders=(None if engine == "tree_no_rf"
                    else np.array([0.5e-6, 0.6e-6])),
        num_packets=4096, batch_size=4096, seed=1, device=dev)
    assert isinstance(sim._sweep_tabs, xl.XLTables if engine == "xl"
                      else ml.MLTables)
    sim.run_primary(verbose=False)
    prof = ep.profile_run(torch, lambda: sim.run_primary(verbose=False))
    assert ep._events(sim) > 0 and prof["loop_ranges"] == 1
    assert prof["unattributed"] == 0, prof
    assert prof["loop"]["device_ops"] > 0 and prof["loop"]["d2h_copies"] > 0
    assert prof["loop"]["h2d_copies"] == 0, prof["loop"]


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
    assert n["mlsweep_dtau_prefix"] > 0 and n["mlsweep_tau_total"] > 0
    assert n["mlsweep_deposit"] > 0 and n["mlsweep_dtau"] == 0
    assert n["detect"] > 0 and n["scatter_add"] == 0
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
    assert launches["sweep_dtau_prefix"] > 0
    assert launches["sweep_deposit_prefix"] > 0
    assert launches["sweep_deposit"] == 0
    assert launches["sweep_tau_total"] > 0 and launches["detect"] > 0
    assert launches["sweep_dtau"] == launches["scatter_add"] == 0
    assert launches["sweepxl_dtau"] == 0
    (rf_c, acc_c, info_c), (rf_g, acc_g, info_g) = out["cpu"], out[str(dev)]
    assert info_c["iterations"] == info_g["iterations"] == 1
    assert float((rf_g.cpu() - rf_c).abs().max()) <= 1e-4 * float(rf_c.max())
    sc, sg_ = acc_c[0]["sed"], acc_g[0]["sed"].cpu()
    for k in range(sc.shape[0]):
        assert float((sg_[k] - sc[k]).abs().max()) <= 1e-4 * float(
            sc[k].abs().max())


def _chip_smoke():
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    return chip_smoke


def test_refill_bench1h_on_cuda_matches_cpu(dev):
    cs = _chip_smoke()
    out = {}
    for d in ("cpu", dev):
        sim = cs.config1h(d, num_packets=8192, batch_size=2048)
        kb.reset_launches()
        _, accs = sim.run_primary(verbose=False)
        out[str(d)] = (sim, accs)
        launches = dict(kb.LAUNCHES)
        assert sim.last_stats["abandoned"] == 0
        assert sim.last_stats["generations"] > 8192 // 2048
    for name in ("sweep_tau_total", "sweep_dtau_prefix",
                 "sweep_deposit_prefix", "detect"):
        assert launches[name] > 0, name
    assert launches["sweep_dtau"] == launches["sweep_deposit"] == 0
    assert launches["scatter_add"] == launches["sweepxl_dtau"] == 0
    (sc, ac), (sg, ag) = out["cpu"], out[str(dev)]
    sed_c = dinst.calibrate_sed(sc.instruments[0], ac[0])
    sed_g = dinst.calibrate_sed(sg.instruments[0], ag[0])
    for kind in ("transparent", "primarydirect", "primaryscattered",
                 "total"):
        assert sed_c[kind][0] > 0
        assert abs(sed_g[kind][0] / sed_c[kind][0] - 1.0) <= 2e-5, kind
    fc, fg = ac[0]["frame"].double(), ag[0]["frame"].double().cpu()
    assert float((fg - fc).abs().max()) <= 1e-3 * float(fc.abs().max())


def test_kernels_on_a_refilled_batch(dev):
    cs = _chip_smoke()
    res = cs.check_refilled_batch(torch, cs.config1h(dev, num_packets=8192,
                                                     batch_size=2048))
    assert res["dead"] > 0 and res["fresh"] > 0 and res["old"] > 0
    assert res["kernel1_err_of_tau"] <= 1e-6
    assert res["kernel2"]["found_agreement"] >= 0.999


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


@pytest.mark.parametrize("R,S,W,iters", [(512, 64, 128, 256),
                                         (500, 37, 100, 300)],
                         ids=["probe", "off-grid"])
def test_row_lookup_select_exact(dev, R, S, W, iters):
    """The select loop equal to `lookup_plain` bit for bit, at the probe's
    shapes and at shapes off the kernel's block grid, from start rows below
    0 and past R."""
    from skirt9_tpu_torch.tools import sublane_gather as sg
    tab, idx = sg.inputs(dev, R, S, W)
    idx = idx * 3 - 700
    kb.reset_launches()
    got = sg.lookup(tab, idx, iters, select=True)
    assert kb.LAUNCHES["row_lookup_select"] == 1
    assert torch.equal(got, sg.lookup_plain(tab, idx, iters))


@pytest.mark.parametrize("R,S,W,iters", [(512, 64, 128, 256),
                                         (500, 37, 100, 300)],
                         ids=["probe", "off-grid"])
def test_row_lookup_gather_exact(dev, R, S, W, iters):
    """The row gather equal to `lookup_plain` bit for bit, at the probe's
    shapes and off its block grid, from start rows below 0 and past R."""
    from skirt9_tpu_torch.tools import sublane_gather as sg
    tab, idx = sg.inputs(dev, R, S, W)
    idx = idx * 3 - 700
    kb.reset_launches()
    got = sg.lookup(tab, idx, iters)
    assert kb.LAUNCHES["row_lookup_gather"] == 1
    assert kb.LAUNCHES["row_lookup_select"] == 0
    assert torch.equal(got, sg.lookup_plain(tab, idx, iters))


@pytest.mark.parametrize("n", [4099, 37])
@pytest.mark.parametrize("variant", ["gather", "take", "gather_l2", "scatter"])
def test_gather_probe_kernels_ragged(dev, n, variant):
    """Kernel 8 at table sizes that are no multiple of 16 bytes (the
    staging loads' ragged tail), and a B off the 16-byte index loads, against the plain
    versions; one launch on the variant's counter. At 37 bins each bin sums
    ~540 values, in an order the atomics pick, so the scatter and its plain
    version are each held to the f32 summation bound of the exact (f64)
    sum: m * 2^-24 * sum for a bin of m non-negative values."""
    from skirt9_tpu_torch.tools import gather_probe as gp
    nd, idx, _ = gp.inputs(dev, n=n, b=20001)
    vals = torch.tensor(np.random.default_rng(3).uniform(0, 1, 20001)
                        .astype(np.float32), device=dev)
    fn = {"gather": lambda: gp.gather(nd, idx),
          "take": lambda: gp.take(nd, idx),
          "gather_l2": lambda: gp.gather(nd, idx, staged=False),
          "scatter": lambda: gp.scatter(idx, vals, n)}[variant]
    counter = {"gather": "probe_gather_smem", "take": "probe_gather_smem",
               "gather_l2": "probe_gather_l2",
               "scatter": "probe_scatter_smem"}[variant]
    kb.reset_launches()
    got = fn()
    assert kb.LAUNCHES == {k: int(k == counter) for k in kb.LAUNCHES}
    if variant == "scatter":
        exact = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(
            0, idx.long(), vals.double())
        bound = torch.bincount(idx.long(), minlength=n) * 2.0**-24 * exact
        for out in (got, gp.scatter_plain(idx, vals, n)):
            assert bool(((out.double() - exact).abs() <= bound).all())
    else:
        assert torch.equal(got, gp.gather_plain(nd, idx))


@pytest.mark.parametrize("staged", [True, False])
def test_gather_probe_out_of_range(dev, staged):
    """Kernel 8's own rule for indices outside [0, n): a gather reads 0 and
    a scatter adds nothing (the plain versions wrap or raise there, so the
    reference is built by hand)."""
    from skirt9_tpu_torch.tools import gather_probe as gp
    n = 4099
    nd, idx, _ = gp.inputs(dev, n=n, b=5003)
    idx[::7] = -1
    idx[1::11] = n
    idx[2::13] = -(1 << 30)
    idx[3::17] = 1 << 30
    vals = torch.tensor(np.random.default_rng(4).uniform(0, 1, 5003)
                        .astype(np.float32), device=dev)
    ok = (idx >= 0) & (idx < n)
    want = torch.zeros(5003, device=dev)
    want[ok] = nd[idx[ok].long()]
    assert torch.equal(gp.gather(nd, idx, staged=staged), want)
    hist = torch.zeros(n, device=dev).index_add_(0, idx[ok].long(),
                                                 vals[ok])
    got = gp.scatter(idx, vals, n)
    assert float((got - hist).abs().max()) <= 1e-6 * float(hist.max())


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


# ---------------------------------------------- config 3: kernel 5's groups

def _grouped_check(tabs, pos, d, active, rec, cells, lum, tau_int, tb, lane,
                   n_groups, bin_map, nbins, inv2=0.7):
    """Kernel 5 in its grouped mode against its plain version: one launch,
    the RF within 1e-6 of its maximum, s_int, icell and found equal."""
    args = (tabs, pos, d, active, rec, cells, lum, tau_int, tb, inv2)
    kw = dict(n_groups=n_groups, lane=lane, nbins=nbins, bin_map=None
              if bin_map is None else torch.tensor(
                  bin_map, dtype=torch.int32, device=pos.device))
    kb.reset_launches()
    rf_k, s_k, c_k, f_k = ml.sweep_deposit(*args, **kw)
    assert kb.LAUNCHES["mlsweep_deposit"] == 1
    rf_p, s_p, c_p, f_p = ml.sweep_deposit_plain(*args, **kw)
    assert int(f_p.sum()) > pos.shape[0] // 4
    assert torch.equal(f_k, f_p) and torch.equal(c_k, c_p)
    assert torch.equal(s_k[f_k], s_p[f_p])
    assert rf_k.shape == rf_p.shape
    m = float(rf_p.abs().max())
    assert m > 0 and float((rf_k - rf_p).abs().max()) <= 1e-6 * m
    return rf_p


@pytest.mark.parametrize("n_groups,bin_map,nbins", [
    (8, (0, 1, 1, -1, 3, 3, 5, 7), 6), (8, None, 0), (1, (2,), 3),
    (1, (-1,), 3)], ids=["8-map", "8-rows", "1-shared-row2", "1-dropped"])
def test_mlsweep_deposit_grouped_kernel(dev, n_groups, bin_map, nbins):
    """The small density octree (its 1-group launches on the shared-memory
    table, its grouped ones on the global path): rows from the bin map (-1,
    repeats and a row past nbins dropped), rows per group without one."""
    B = 4096
    tabs, pos, d, sig, active, rs = _tree_inputs(dev, "octree", 1, B, seed=9)
    assert tabs.nd.shape[0] <= ml.SHARED_LEAVES
    rec, cells, _, tb, tot, lane = ml.sweep_dtau_prefix(tabs, pos, d, sig,
                                                        active)
    lum = torch.tensor(rs.uniform(0.5, 2, B), dtype=torch.float32,
                       device=dev) * active
    tau_int = torch.tensor(rs.uniform(size=B), dtype=torch.float32,
                           device=dev) * tot
    if bin_map == (-1,):
        kb.reset_launches()
        rf, *_ = ml.sweep_deposit(
            tabs, pos, d, active, rec, cells, lum, tau_int, tb, 0.7,
            lane=lane, bin_map=torch.tensor(bin_map, dtype=torch.int32,
                                            device=dev), nbins=nbins)
        assert kb.LAUNCHES["mlsweep_deposit"] == 1
        assert rf.shape == (3, tabs.nd.shape[0]) and float(rf.abs().sum()) == 0
        return
    rf = _grouped_check(tabs, pos, d, active, rec, cells, lum, tau_int, tb,
                        lane, n_groups, bin_map, nbins)
    rows = nbins if bin_map is not None else n_groups
    assert rf.shape == (rows, tabs.nd.shape[0])
    lit = (rf.abs().sum(dim=1) > 0).cpu().tolist()
    used = set(range(n_groups)) if bin_map is None else {
        r for r in bin_map if 0 <= r < rows}
    assert [r for r in range(rows) if lit[r]] == sorted(used)


def test_mlsweep_deposit_grouped_kernel_bench3(dev):
    """Config 3's first event on the full bench3 tree (the global path):
    its 32 lane groups folded into the 25 RF rows by the launch's bin
    map."""
    cs = _chip_smoke()
    sim = cs.config3(dev)
    assert sim._sweep_tabs.nd.shape[0] > ml.SHARED_LEAVES
    pkt, opts, (rec, cells, _, tb, tot, lane) = cs.first_event_b3(torch, sim)
    rs = np.random.default_rng(8)
    inv = 1.0 / float(np.sqrt(sim.rf_scale))
    rfb = sim._rf_borders_dev
    lum = (pkt.lum * (pkt.alive & (pkt.lam >= rfb[0])
                      & (pkt.lam < rfb[-1]))) * inv
    tau_int = torch.tensor(rs.uniform(size=pkt.lam.shape[0]),
                           dtype=torch.float32, device=dev) * tot
    assert opts.rf_strata == 32 and min(opts.rf_bin_map) == 0
    rf = _grouped_check(sim._sweep_tabs, pkt.pos, pkt.dir, pkt.alive, rec,
                        cells, lum, tau_int, tb, lane, 32, opts.rf_bin_map,
                        25, inv2=inv)
    assert int((rf.abs().sum(dim=1) > 0).sum()) == 25
    # groups 0 and 5 dropped (-1), the last group's row past the 25 rows
    drop = list(opts.rf_bin_map)
    drop[0] = drop[5] = -1
    drop[-1] = 25
    rf = _grouped_check(sim._sweep_tabs, pkt.pos, pkt.dir, pkt.alive, rec,
                        cells, lum, tau_int, tb, lane, 32, tuple(drop), 25,
                        inv2=inv)
    lit = (rf.abs().sum(dim=1) > 0).cpu().tolist()
    assert [r for r in range(25) if lit[r]] == sorted(
        {r for r in drop if 0 <= r < 25})


@pytest.fixture(scope="module")
def config3_runs(dev, tmp_path_factory):
    """The reduced config 3 (bench3.ski at maxLevel 4, 8,192 packets, 4
    events, at most 2 iterations) on the card and on the CPU, with the
    card's launches."""
    cs = _chip_smoke()
    path = cs.edited_ski("bench3", tmp_path_factory.mktemp("b3"),
                         cs.B3_SMALL)
    out = {}
    for d in ("cpu", dev):
        sim = cs.config3(d, num_packets=8192, batch_size=4096, max_events=4,
                         path=path)
        sim.max_iterations = 2
        kb.reset_launches()
        out[str(d)] = (sim, *sim.run_with_dust_emission(verbose=False))
    return out, dict(kb.LAUNCHES)


def test_config3_on_cuda_matches_cpu(dev, config3_runs):
    out, _ = config3_runs
    (_, rf_c, acc_c, info_c), (_, rf_g, acc_g, info_g) = (out["cpu"],
                                                          out[str(dev)])
    assert info_c["iterations"] == info_g["iterations"] >= 1
    assert info_g["L_dust"] == pytest.approx(info_c["L_dust"], rel=1e-4)
    assert float((rf_g.cpu() - rf_c).abs().max()) <= 2e-5 * float(rf_c.max())
    sc, sg_ = acc_c[0]["sed"], acc_g[0]["sed"].cpu()
    for k in range(sc.shape[0]):
        assert float((sg_[k] - sc[k]).abs().max()) <= 2e-5 * float(
            sc[k].abs().max())
    fc, fg = acc_c[0]["frame"].double(), acc_g[0]["frame"].double().cpu()
    assert float((fg - fc).abs().max()) <= 1e-3 * float(fc.abs().max())


def test_config3_tree_rf_loop_launches(dev, config3_runs):
    """Kernel 5 once per event of every segment that stores the RF (the
    primary and the iterations; the final secondary segment stores none),
    kernels 4 and detect on every segment, no resident or XL kernel."""
    out, n = config3_runs
    segs = out[str(dev)][0].last_stats["segments"]
    assert [s[0] for s in segs][-1] == "secondary" and len(segs) >= 3
    assert n["mlsweep_deposit"] == sum(s[3] for s in segs[:-1])
    assert n["mlsweep_dtau_prefix"] == sum(s[3] for s in segs)
    assert n["mlsweep_tau_total"] > 0 and n["detect"] > 0
    for k in ("sweep_dtau", "sweep_tau_total", "sweep_dtau_prefix",
              "sweep_deposit", "sweep_deposit_prefix", "sweepxl_dtau",
              "sweepxl_tau_total", "sweepxl_dtau_prefix", "sweepxl_deposit",
              "sweepxl_deposit_prefix", "mlsweep_dtau", "scatter_add"):
        assert n[k] == 0, k


def _xl_grouped_check(tabs, pos, d, act_int, rec, lum, tau_int, tb, lane,
                      n_groups, bin_map, nbins, rf=None):
    """Kernel 7's prefix mode with lane groups against its plain version:
    the RF within 1e-6 of its maximum (both sum in f64), s_int, icell and
    found equal; with rf, both add into copies of it."""
    bm = None if bin_map is None else torch.tensor(bin_map, dtype=torch.int32,
                                                   device=pos.device)
    args = (tabs, pos, d, act_int, rec, lum, tau_int, tb, 0.7, lane)
    kw = dict(n_groups=n_groups, bin_map=bm, nbins=nbins)
    kb.reset_launches()
    rf_k, *hit_k = xl.sweep_deposit_prefix(
        *args, **kw, rf=None if rf is None else rf.clone())
    assert kb.LAUNCHES["sweepxl_deposit_prefix"] == 1
    assert sum(kb.LAUNCHES.values()) == 1
    rf_p, *hit_p = xl.sweep_deposit_prefix_plain(
        *args, **kw, rf=None if rf is None else rf.clone())
    assert int(hit_p[2].sum()) > pos.shape[0] // 4
    for a, b in zip(hit_k, hit_p):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert rf_k.shape == rf_p.shape
    m = float(rf_p.abs().max())
    assert m > 0 and float((rf_k - rf_p).abs().max()) <= 1e-6 * m
    return rf_p


def _xl_grouped_inputs(dev, tabs, pos, d, sig, active, n_groups, seed):
    """Pass 1 on lanes sorted as the grouped XL loop sorts them, and pass
    2's per-lane inputs."""
    perm = xl.lane_order(tabs, pos, d, sw.dominant_axis(tabs, d), n_groups)
    pos, d, sig, active = pos[perm], d[perm], sig[:, perm], active[perm]
    rec, tb, tot, lane = xl.sweep_dtau_prefix(tabs, pos, d, sig, active)
    rs = np.random.default_rng(seed)
    B = pos.shape[0]
    tau_int = torch.tensor(rs.uniform(0.0, 1.1, B), dtype=torch.float32,
                           device=dev) * tot
    lum = torch.tensor(rs.uniform(0.5, 2, B), dtype=torch.float32,
                       device=dev) * active
    return pos, d, active & (tot > 1e-6), rec, lum, tau_int, tb, lane


@pytest.mark.parametrize("n_groups,bin_map,nbins,acc,source", [
    (8, (0, 1, 1, -1, 3, 3, 5, 7), 6, None, False),
    (8, (0, 1, 1, -1, 3, 3, 5, 7), 6, torch.float64, True),
    (8, None, 0, None, False), (4, (2, 0, 1, 1), 3, torch.float32, True),
    (1, (2,), 3, torch.float64, False), (1, (-1,), 3, None, False)],
    ids=["8-map", "8-map-acc64-source", "8-rows", "4-map-acc32-source",
         "1-mono-acc64", "1-dropped"])
def test_sweepxl_deposit_prefix_grouped_kernel(dev, n_groups, bin_map, nbins,
                                               acc, source):
    """Kernel 7's prefix mode with lane groups at 80^3: rows from the bin
    map (-1, repeats and a row past nbins dropped), rows per group without
    one, one group into a monochromatic source's bin, and added into an
    f32 or f64 accumulator that holds earlier deposits; with source, every
    ray starts at one point (an event leaving a point source)."""
    B = 4096
    tabs, pos, d, sig, active = _xl_inputs(dev, (80, 80, 80), 1, B, 5, False)
    if source:
        pos = torch.tensor([[0.1, -0.05, 0.2]], device=dev).expand(B, 3) * PC
        active = torch.ones(B, dtype=torch.bool, device=dev)
    ins = _xl_grouped_inputs(dev, tabs, pos, d, sig, active, n_groups, 6)
    rows = nbins if bin_map is not None else n_groups
    rf0 = None
    if acc is not None:
        rf0 = torch.rand((tabs.nd.shape[0], rows), dtype=acc,
                         device=dev) * 1e-3
    if bin_map == (-1,):
        rf, *_ = xl.sweep_deposit_prefix(
            tabs, *ins[:7], 0.7, ins[7], bin_map=torch.tensor(
                bin_map, dtype=torch.int32, device=dev), nbins=nbins)
        assert rf.shape == (3, tabs.nd.shape[0]) and float(rf.abs().sum()) == 0
        return
    rf = _xl_grouped_check(tabs, *ins, n_groups, bin_map, nbins, rf=rf0)
    assert rf.shape == (rows, tabs.nd.shape[0])
    if acc is not None:
        rf = rf - rf0.T
    lit = (rf.abs().sum(dim=1) > 0).cpu().tolist()
    used = set(range(n_groups)) if bin_map is None else {
        r for r in bin_map if 0 <= r < rows}
    assert [r for r in range(rows) if lit[r]] == sorted(used)


def _deep_octree():
    """An octree refined to level 9 around three pairs of close sites (a
    512 fine raster, which the multi-level sweep does not take), with a
    density."""
    from skirt9_tpu_torch.grids.octree import site_list_refine_fn
    rs = np.random.default_rng(3)
    centres = rs.normal(scale=0.3 * PC, size=(3, 3))
    sites = np.concatenate([centres, centres + 0.002 * PC])
    grid = build_octree(((-1.2 * PC, 1.2 * PC),) * 3,
                        lambda p: np.ones(len(p)), max_level=9, min_level=2,
                        refine_fn=site_list_refine_fn(sites, 1))
    return grid, _tree_medium(grid, 1, rs)


@pytest.mark.parametrize("n_groups,bin_map,nbins,source", [
    (1, None, 0, False), (4, (0, -1, 2, 2), 3, False),
    (4, (0, -1, 2, 2), 3, True)], ids=["1", "4-map", "4-map-source"])
def test_sweepxl_deposit_prefix_cellmap_kernel(dev, n_groups, bin_map,
                                               nbins, source):
    """Kernel 7's prefix mode on a level-9 octree's 512^3 voxel raster:
    the deposits land on the leaves through the cell map; with source,
    from one start point."""
    B = 4096
    grid, med = _deep_octree()
    assert xl.supports_tree_xl(grid, med)
    tabs = xl.build_tree_tables(grid.to(dev), med.to(dev))
    assert tabs.n == (512,) * 3 and tabs.rf_cells == grid.ncells
    rs = np.random.default_rng(8)
    t32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    pos = t32(rs.normal(scale=0.4 * PC, size=(B, 3)).clip(-1.1 * PC,
                                                          1.1 * PC))
    if source:
        pos = t32(np.broadcast_to([0.05 * PC, 0.1 * PC, -0.02 * PC], (B, 3)))
    d = rs.normal(size=(B, 3))
    d = t32(d / np.linalg.norm(d, axis=1, keepdims=True))
    sig = t32(np.full((1, B), 1e-24))
    active = torch.ones(B, dtype=torch.bool, device=dev)
    ins = _xl_grouped_inputs(dev, tabs, pos, d, sig, active, n_groups, 9)
    rf = _xl_grouped_check(tabs, *ins, n_groups, bin_map, nbins)
    assert rf.shape == (nbins or n_groups, grid.ncells)


def _small_tree_sim(device, rf_bins=None):
    """The density octree of tests/test_mlsweep.py with a one-bin or a
    multi-bin RF, on its voxel raster (the XL tables put in place)."""
    grid = _tree("octree")
    rs = np.random.default_rng(2)
    med = _tree_medium(grid, 1, rs)
    sim = Simulation(
        grid=grid, medium=med,
        sources=[PointSource(luminosity=1.0, lam0=0.55e-6)],
        instruments=[dinst.DistantInstrumentCfg(
            name="i", wave_borders=(0.5e-6, 0.6e-6), distance=100 * PC,
            npx=16, npy=16, fovx=3 * PC, fovy=3 * PC)],
        options=lc.TransportOptions(max_steps=grid.max_steps(),
                                    max_events=6),
        rf_borders=np.asarray(rf_bins or [0.5e-6, 0.6e-6]),
        num_packets=8192, batch_size=4096, seed=3, device=device)
    sim._sweep_tabs = xl.build_tree_tables(sim.grid, sim.medium)
    return sim


@pytest.mark.parametrize("rf_bins", [None, [0.1e-6, 0.5e-6, 0.6e-6, 2e-6]],
                         ids=["one-bin", "mono-in-3"])
def test_treexl_on_cuda_matches_cpu(dev, rf_bins):
    """A tree on its voxel raster on the card: kernels 6-7 and detect
    launched, no multi-level or resident kernel; the SED and the per-leaf
    RF within 1e-4 of the same seed's CPU run."""
    cpu = _small_tree_sim("cpu", rf_bins)
    rf_c, accs_c = cpu.run_primary(verbose=False)
    gpu = _small_tree_sim(dev, rf_bins)
    kb.reset_launches()
    rf_g, accs_g = gpu.run_primary(verbose=False)
    n = dict(kb.LAUNCHES)
    for name in ("sweepxl_dtau_prefix", "sweepxl_tau_total",
                 "sweepxl_deposit_prefix", "detect"):
        assert n[name] > 0, name
    for name in ("mlsweep_dtau", "mlsweep_tau_total", "mlsweep_dtau_prefix",
                 "mlsweep_deposit", "sweep_dtau_prefix", "sweep_tau_total",
                 "sweep_deposit_prefix", "sweepxl_deposit", "sweepxl_dtau"):
        assert n[name] == 0, name
    assert rf_g.shape == rf_c.shape == (cpu.grid.ncells, len(
        rf_bins or [0, 0]) - 1)
    m = float(rf_c.abs().max())
    assert m > 0 and float((rf_g.cpu() - rf_c).abs().max()) <= 1e-4 * m
    for key in ("sed", "frame"):
        c, g = accs_c[0][key], accs_g[0][key].cpu()
        assert float((g - c).abs().max()) <= 1e-4 * float(c.abs().max())


def test_xl_multibin_on_cuda_matches_cpu(dev):
    """A small config 2 on XL tables (put in place on a 16^3 grid): a
    4-bin RF in stratified lane groups and one self-absorption iteration on
    kernels 6-7 and detect, no resident kernel; the RF and the primary SED
    kinds within 1e-4 of the same seed's CPU run, the kinds with secondary
    light by their sums over the bins within 1e-3 (the secondary launch's
    cell cdf, built from the RF, differs between the devices in its last
    bits: a packet may start in the neighbouring cell; chip_smoke.py's
    draw_for_draw_xl_b2)."""
    runs = {}
    for device in ("cpu", dev):
        sim = _chip_smoke().config2(device, num_packets=8192, batch_size=4096,
                                    n=16, n_rf=4, max_events=6,
                                    iterate_secondary=True, max_iterations=1)
        sim._sweep_tabs = xl.build_tables(sim.grid, sim.medium)
        kb.reset_launches()
        runs[str(device)] = (*sim.run_with_dust_emission(verbose=False),
                             dict(kb.LAUNCHES))
    (rf_c, accs_c, info_c, _), (rf_g, accs_g, info_g, n) = runs.values()
    for name in ("sweepxl_dtau_prefix", "sweepxl_tau_total",
                 "sweepxl_deposit_prefix", "detect"):
        assert n[name] > 0, name
    for name in ("sweep_dtau_prefix", "sweep_tau_total",
                 "sweep_deposit_prefix", "mlsweep_deposit"):
        assert n[name] == 0, name
    assert info_c["iterations"] == info_g["iterations"] == 1
    m = float(rf_c.abs().max())
    assert m > 0 and float((rf_g.cpu() - rf_c).abs().max()) <= 1e-4 * m
    sed_c, sed_g = accs_c[0]["sed"].double(), accs_g[0]["sed"].double().cpu()
    for k in range(sed_c.shape[0]):
        mk = float(sed_c[k].abs().max())
        assert mk > 0
        if k in (dinst.KIND_PRIMARY_DIRECT, dinst.KIND_PRIMARY_SCATTERED):
            assert float((sed_g[k] - sed_c[k]).abs().max()) <= 1e-4 * mk
        else:
            tot = float(sed_c[k].sum())
            assert abs(float(sed_g[k].sum()) - tot) <= 1e-3 * tot
