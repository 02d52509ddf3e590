#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (skirt9_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Drives config 1 of bench.py (point source, uniform dust sphere, forced
scattering, HG peel-off to one SED + 64x64 frame instrument) through the
port's Python API on two paths: the 32^3 grid of bench.py config 1 (resident
sweep, kernels 1-2) and the 256^3 grid of bench.py `bench_config1x256`
(large-grid XL sweep, kernels 6-7); then bench.py's clumpy-ISM site-list
octrees `bench_config3ism` and `bench_config3ismxl` (multi-level tree sweep,
kernels 4-5); then config 2 (bench2.ski: panchromatic dust emission,
kernels 1-2 with a 25-bin stratified RF); and the gather and row-lookup
probes (kernels 8-9, and kernel 3) through their own entry points; then
config 3 (bench3.ski through the port's own ski loader: a density octree,
a 25-bin RF in lane groups and dust self-absorption iterations, kernels
4-5), config 1h (bench1h.ski, lane refill) and the CLI on bench1.ski,
bench2.ski and bench3.ski; then config 2 at 256^3 (bench2.ski with its
meshes at 256 bins: the XL contracts with the 25-bin RF in lane groups) and
bench_config3ismxl's recipe at max_level 9 (a tree on its 512^3 voxel
raster through the XL contracts). Every
path detects through the fused detect kernel (csrc/detect.cu), which took
kernel 3's place there. Each hand-written CUDA kernel is checked against
its plain PyTorch version.
Phases, one JSON line each:

  env               torch / CUDA / nvcc versions, the card, its power limit
  build             nvcc build of skirt9_tpu_torch/csrc/*.cu, one process per
                    source, all started together (cached by hash)
  kernels           at config-1 shapes (B = 131072, 32^3, C = 1), against
                    their plain versions, timed: kernel 1 in its three modes
                    (sweep_dtau bit-identical; sweep_tau_total and
                    sweep_dtau_prefix within 1e-6 of each lane's tau; the
                    lane range it forms equal to _lane_range bit for bit),
                    kernel 2 in its two modes (sweep_deposit on scale and
                    rel tables, sweep_deposit_prefix forming them from the
                    prefix: the same interactions bit for bit), kernel 3
                    (sizes 1 and 4096), and detect (one
                    bin, 64x64 frame) within 1e-5 of each accumulator's
                    maximum against the plain detect and the seven-call
                    form through kernel 3
  kernels_xl        kernels 6-7 vs their plain versions at 256^3, B = 131072,
                    C = 1, lanes sorted as the path sorts them: kernel 6's
                    record and summed form bit-identical, its total (the +z
                    peel-off) and prefix within 1e-6 of each lane's tau,
                    the lane range it forms equal to _lane_range bit for
                    bit; kernel 7's table mode, its RF within 1e-4 of its
                    maximum, and its prefix mode on kernel 6's prefix with
                    an RF, with lum_half = 0 and without an RF: s_int,
                    icell and found identical, the RF within 1e-4 of its
                    maximum; each mode timed, kernel 7's prefix mode beside
                    the parent's unfused form (scale_slab, the table mode,
                    resolve_interaction), kernel 6 also on unsorted lanes,
                    kernel 1 on the same rays, and the variants of
                    perf/kernel6_variants.py and perf/kernel7_variants.py
                    (other run lengths, other designs, the first designs,
                    splits)
  draw_for_draw     16,384 packets on the CPU (plain versions) and on the GPU
                    (kernels), same seed: SEDs within 1e-4, frame within 1e-3
                    of its brightest pixel; again with a one-bin RF, totals
                    1e-4
  draw_for_draw_xl  the same at 80^3, where the port picks the XL contracts
  full_width        config 1 at 2^20 packets in batches of 2^17, timed after a
                    warm-up: kernel 1's total and prefix modes, kernel 2's
                    prefix mode and detect launched; kernels 1 and 2 in
                    their reference modes, kernel 3 and kernels 6-7 not;
                    accumulators
                    finite, the transparent SED analytic within 1e-5,
                    direct/transparent = exp(-tau) within 1e-3, SED relative
                    error R < 0.01
  breakdown         host-sync and RNG shares of the timed run; one batch
                    under torch.profiler at event caps 24 and 2: device
                    launches, kernel launches, stream syncs and host-to-
                    device copies per event of the loop, busy and idle
                    shares
  full_width_xl     bench_config1x256 (256^3, 2^17 packets in one batch, 24
                    events, no RF), timed after a warm-up: the XL tables,
                    kernel 6's prefix and total modes, kernel 7's prefix
                    mode and detect launched, their reference modes and
                    kernels 1-5 not, the same gates
  rf_xl             the same with a one-bin RF: kernel 7's prefix mode
                    launched on pass 1's record, prefix and lane range, the
                    RF
                    finite and positive, its total within 1e-4 of the same
                    seed's run on the resident sweep (kernels 1-2)
  kernels_ml        kernels 4-5 (the multi-level tree sweep) vs their plain
                    versions through their public wrappers, B = 65536,
                    C = 1: kernel 4 on bench_config3ism's site-list octree
                    (a 128^3 fine raster) and on bench_config3ismxl's (256^3,
                    its leaf map beyond L2), with want_sub, summed and with
                    the +z peel-off hint, tau within 1e-5 relative
                    (bit-identical expected) and leaf ids identical, its
                    total (the +z peel-off and the event rays) and prefix
                    modes within 1e-6 of each lane's tau, their record,
                    leaf ids, step sums and lane range bit for bit; kernel
                    5 on both trees (config3ism's in its shared-memory leaf
                    table, config3ismxl's on its global path), its RF within
                    1e-5 of its maximum, s_int, found and the interaction
                    cells equal; timed, kernel 4's modes beside the unfused
                    forms the parent's loop ran and the variants of
                    perf/kernel4_variants.py (run lengths, the first
                    design, a split), resolve_interaction (the no-RF pass
                    2) as the parent called it and with pass 1's lane range
                    and step sums beside kernel 5
  draw_for_draw_ml  the density octree of tests/test_mlsweep.py (max_level
                    4) with a one-bin RF, 16,384 packets, CPU vs GPU: SEDs
                    within 1e-4, frame 1e-3 of its brightest pixel, RF total
                    1e-4
  full_width_ml     bench_config3ism (bench.py:317-367: 46 x 26 sites,
                    max_level 7, about 5,000 leaves, 2^17 packets in batches
                    of 2^16, 16 events, no RF), timed after a warm-up:
                    kernel 4's total and prefix modes and detect launched,
                    its reference modes and no uniform-grid sweep; the
                    transparent SED analytic within 1e-5, direct/transparent
                    = exp(-0.5) within 1e-3, R < 0.01
  full_width_ml_large  bench_config3ismxl's tree (bench.py:370-420: 400 x 96
                    sites, max_level 8, about 1.4e5 leaves on a 256^3 fine
                    raster), the same run and gates; the reference sends
                    this tree to its XL fine raster, the port's rule to
                    kernels 4-5
  breakdown_ml      one more full_width_ml run under torch.profiler: device
                    launches, stream syncs and host-to-device copies per
                    event, busy and idle shares, top kernels
  rf_ml             full_width_ml with a one-bin RF: kernel 5 launched too,
                    the RF finite and positive, packets/s against
                    full_width_ml
  kernels_probe     kernels 8-9 through their entry points
                    (skirt9_tpu_torch/tools/gather_probe.py, sublane_gather.py)
                    at the original probes' shapes, each variant against its
                    plain version (gathers and the row lookups bit-exact,
                    sums 1e-6 relative), timed with the plain and library
                    times and kernel 3 at the probe's scatter shape; the
                    parent's designs and the variants of
                    perf/kernel8_variants.py and perf/kernel9_variants.py
                    timed in turns with the package's kernels, the launch
                    floor, the rates of distributed shared memory and the
                    host cost of a per-call launch set-up
  kernels_b2        kernel 2 in both modes with config 2's 32 lane groups
                    (the prefix mode folding them into the 25 bins by the
                    launch's bin map), kernel 3 on its
                    163,840-bin frame and detect (40 bins, 40x64x64 frame),
                    on config 2's first event, against their plain versions
                    (RF 1e-4 of its maximum, sums 1e-5)
  draw_for_draw_b2  config 2 at 8^3 (8,192 packets, 8 events, one
                    self-absorption iteration), CPU vs GPU: SEDs and RF
                    within 1e-4 of their maxima, L_dust 1e-4
  full_width_b2     bench2.ski (bench.py:79-105) built through the port's API
                    at full width, 2^20 packets in batches of 2^17, timed after
                    a warm-up: packets/s as bench.py counts them, seconds and
                    events per segment; bench2's golden gates
                    (tests/test_reference_parity.py:72-141) and L_dust =
                    L_abs_primary within 1e-4
  breakdown_b2      config 2 with one batch per segment under torch.profiler,
                    as breakdown
  kernels_b3        kernel 5's grouped mode on config 3's first event (the
                    full bench3 tree, 55,574 leaves, its global path; 32
                    lane groups of a 2^16 batch folded into the 25 RF rows
                    by the launch's bin map) against its plain version: RF
                    within 1e-6 of its maximum, s_int, icell and found
                    equal; timed by CUDA events and device time, with its
                    bound and the plain version's time
  draw_for_draw_b3  the reduced config 3 (bench3.ski at maxLevel 4, 8,192
                    packets, 4 events, at most 2 iterations), CPU vs GPU:
                    iterations equal, SEDs and RF within 2e-5 of their
                    maxima, frame 1e-3 of its brightest pixel, L_dust 1e-4;
                    kernels 4-5 and detect launched, no other sweep
  full_width_b3     bench3.ski (bench.py:130-149) through the port's
                    load_ski at bench_config3's 2^18 packets in batches of
                    2^16, 24 events, timed after a warm-up: packets/s as
                    bench.py counts them, seconds and events per segment,
                    iterations, L_dust against L_abs_primary; kernels 4-5
                    and detect launched, kernels 1, 2, 6 and 7 not; every
                    gate of test_bench3_* (tests/test_reference_parity.py:
                    185-269)
  breakdown_b3      config 3 with one batch per segment under
                    torch.profiler, as breakdown
  refill_b1h        config 1h (bench.py:108-126): tests/golden/bench1h.ski
                    through the port's load_ski, 2^19 packets in batches of
                    2^17, in lane-refill generations of 16 events, timed
                    after a warm-up: kernels 1-2 and detect launched, no
                    lane abandoned at the generation cap, bench1h's golden
                    gates (tests/test_reference_parity.py:149-178);
                    packets/s, generations, events and host syncs per
                    generation; kernel 1's total and prefix modes, kernel
                    2's prefix mode and detect on a refilled batch (dead,
                    fresh and old lanes side by side) against their plain
                    versions; one batch profiled as breakdown (idle share)
  cli               the port's CLI (skirt9_tpu_torch.__main__.main) on
                    bench1.ski and bench2.ski at their 10^6 packets and
                    bench3.ski at 2^18 (-p), -b 131072, into a temporary
                    directory: kernels 1-2 and detect launched (kernels 4-5
                    for bench3); wall time each; the gates read back from
                    the written files (bench1's SED against
                    tests/test_reference_parity.py:26-49, bench2's and
                    bench3's SED, RF and dust temperature probe files
                    against their golden gates), the probe files one row
                    per cell, equal to the run's RF and dust temperature,
                    and bench3's cell-properties file its volumes and
                    densities
  kernels_xl_grouped  kernel 7's prefix mode with lane groups on config 2's
                    first event at 256^3 (B = 131,072, 32 groups folded
                    into the 25 RF rows by the launch's bin map) against
                    its plain version: RF within 1e-6 of its maximum,
                    s_int, icell and found identical; timed adding into an
                    accumulator (the path's form) and into a fresh zero
                    table, with its bound and the plain version's time
  kernels_treexl    bench_config3ismxl's recipe at max_level 9 (143,536
                    leaves, a 512^3 voxel raster) with a one-bin RF, its
                    first event: kernel 6's prefix mode at nmax = 512
                    (record and lane range bit for bit, prefix and total
                    within 1e-6 of each lane's tau) and kernel 7 with the
                    cell map (as kernels_xl_grouped), timed
  draw_for_draw_xl_b2  config 2 at 80^3 (XL, an 8-bin RF in 8 lane
                    groups, 16,384 packets, one self-absorption iteration),
                    CPU vs GPU: the primary segment's RF and SEDs within
                    2e-5, frame 1e-3; the dust emission run's L_dust
                    1e-4, its RF bins and SED kinds by their sums 1e-3
  full_width_b2x256 bench2.ski through load_ski with its meshes at 256 bins
                    (16.8 M cells, XL; 2^20 packets in batches of 2^17, 24
                    events), timed after a one-batch warm-up: kernels 6-7
                    and detect launched, no resident or tree kernel;
                    L_dust = L_abs_primary within 1e-4; packets/s, seconds
                    per segment, the emission layer timed apart, bench2's
                    golden ratios on the RF and temperature averaged onto
                    the goldens' 32^3 cells (reported)
  rf_xl_b2x256      its primary segment against the same seed on the
                    resident sweep put in place: RF totals within 1e-4
  full_width_treexl the level-9 tree at bench_config3ismxl's 2^17 packets
                    in batches of 2^16, 16 events, no RF: the XL tables
                    with the cell map, kernels 6-7 and detect launched, no
                    multi-level kernel; full_width_ml's gates
  rf_treexl         the same with a one-bin RF, per leaf, finite, positive
  treexl_vs_ml      bench_config3ismxl's level-8 tree on its voxel raster
                    (the XL tables put in place) against the multi-level
                    sweep, the same seed, a one-bin RF: SEDs and RF totals
                    within 1e-3

Each path is driven with the launch counts set to 0 just before it and read
just after; it names the kernels it must launch and those it must not. Then
the kernel summary line (each kernel's launches on its path, its error and
time against the plain version, its bound from this run's inputs and, where
one PyTorch call computes the same function, that call's time), the
nvidia-smi name/power line, and last {"ok": true, "device": {...}}. Any
failed check raises and the script exits non-zero without that line; so
does a machine without CUDA.
"""

from __future__ import annotations

import gzip
import json
import math
import os
import platform
import subprocess
import sys
import tempfile
import time

import numpy as np

PC = 3.0857e16
B_FULL = 1 << 17
HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden")
B_ML = 1 << 16            # bench_config3ism's batch
B_B3 = 1 << 16            # bench_config3's batch (bench.py:130-149)

# the H100 SXM's published peaks (NVIDIA's datasheet, at 700 W): HBM
# bytes/s and f32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations per active (slab or plan step, lane) thread, counted in
# csrc/sweep_common.cuh: entering the slab (29), one sub-step of the minor
# DDA (14), the opacity of C components (2C), a deposit's contribution with
# its segment factor and the interaction test (12); per lane, the set-up
# inside kernel 1 (csrc/sweep_dtau.cu lane_range and slab_range, 80), and
# per lane the detect kernel's bin search, powers and projection (40)
OPS_SLAB, OPS_SUB, OPS_DEP = 29, 14, 12
OPS_LANE, OPS_DETECT = 80, 40


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"check failed: {what}")


def nvidia_smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def config1(device, num_packets=1 << 20, batch_size=B_FULL, n=32,
            store_rf=False, npix=64):
    """Config 1 of bench.py (bench.py:39-76) through the port's API."""
    from skirt9_tpu_torch.grids.cartesian import make_cartesian
    from skirt9_tpu_torch.instruments.distant import DistantInstrumentCfg
    from skirt9_tpu_torch.media import system as msys
    from skirt9_tpu_torch.simulation import Simulation
    from skirt9_tpu_torch.sources.base import PointSource
    from skirt9_tpu_torch.transport.lifecycle import TransportOptions

    R = PC
    box = 1.2 * R
    grid = make_cartesian(((-box, box),) * 3, (n,) * 3)
    sigma = 1e-24
    nd = msys.uniform_density_sphere(grid, 1.0, sigma, R)
    med = msys.make_medium(grid, nd, np.array([0.4e-6, 0.7e-6]),
                           sigma_ext=np.array([[sigma, sigma]]),
                           albedo=np.full((1, 2), 0.6),
                           g=np.full((1, 2), 0.5))
    inst = DistantInstrumentCfg(name="i0", wave_borders=(0.5e-6, 0.6e-6),
                                distance=100 * PC, npx=npix, npy=npix,
                                fovx=4 * PC, fovy=4 * PC)
    opts = TransportOptions(max_steps=grid.max_steps(), max_events=24,
                            store_rf=store_rf)
    return Simulation(grid=grid, medium=med,
                      sources=[PointSource(luminosity=1.0, lam0=0.55e-6)],
                      instruments=[inst], options=opts,
                      rf_borders=(np.array([0.5e-6, 0.6e-6]) if store_rf
                                  else None),
                      num_packets=num_packets, batch_size=batch_size, seed=0,
                      device=device)


def config2(device, num_packets=1 << 20, batch_size=B_FULL, n=32, n_rf=25,
            max_events=24, iterate_secondary=False, max_iterations=10):
    """bench2.ski (tests/golden/bench2.ski, run by bench.py:79-105) through
    the port's API, with the arrays `load_ski` builds from it: a 5778 K
    blackbody point source of 1e5 Lsun clipped to 0.09-100 micron
    (wavelength bias 0.5), the MRN mean dust mix of mrn_mean.txt in a shell
    (1e-6 to 1 pc, flat profile) normalised to tau = 2 along z at 0.55
    micron, a uniform n^3 grid over +-1.2 pc, an n_rf-bin log RF grid over
    0.09-100 micron, a 40-bin log emission grid over 1-2000 micron, and one
    distant instrument at 100 pc: a 40-bin log SED over 0.09-1000 micron
    with statistics and a 64x64 frame of 4 pc. Equilibrium emission over
    all cells; by default no self-absorption iterations, as the ski file
    says. n, n_rf, max_events and the iteration options cut it down for
    small runs."""
    from skirt9_tpu_torch.grids.cartesian import make_cartesian
    from skirt9_tpu_torch.geometries.analytic import ShellGeometry
    from skirt9_tpu_torch.instruments.distant import DistantInstrumentCfg
    from skirt9_tpu_torch.media import geometric as gm
    from skirt9_tpu_torch.media import mixes as mx
    from skirt9_tpu_torch.simulation import Simulation
    from skirt9_tpu_torch.sources.base import PointSource
    from skirt9_tpu_torch.spectral import seds
    from skirt9_tpu_torch.spectral import wavelengths as wl
    from skirt9_tpu_torch.transport.lifecycle import TransportOptions
    from skirt9_tpu_torch.utils import constants as c

    um, pc = 1e-6, c.PARSEC
    src_range = (0.09 * um, 100 * um)
    sed = seds.clipped(seds.blackbody(5778.0), *src_range)
    source = PointSource(position=(0.0, 0.0, 0.0),
                         luminosity=1e5 * c.SOLAR_LUMINOSITY, sed=sed,
                         wavelength_bias=0.5)
    grid = make_cartesian(((-1.2 * pc, 1.2 * pc),) * 3, (n,) * 3)
    medium = gm.build_medium(grid, [(
        ShellGeometry(rmin=1e-6 * pc, rmax=1 * pc, p=0.0),
        mx.from_file(os.path.join(GOLDEN, "mrn_mean.txt")),
        gm.OpticalDepthNormalization(tau=2.0, lam=0.55 * um, axis="z"))])
    inst = DistantInstrumentCfg(
        name="i0", wave_borders=tuple(wl.log_borders_skirt(0.09 * um,
                                                           1000 * um, 40)),
        distance=100 * pc, npx=64, npy=64, fovx=4 * pc, fovy=4 * pc)
    opts = TransportOptions(max_steps=min(grid.max_steps(), 256),
                            max_events=max_events, store_rf=True)
    return Simulation(
        grid=grid, medium=medium, sources=[source], instruments=[inst],
        options=opts, rf_borders=wl.log_borders_skirt(*src_range, n_rf),
        ems_borders=wl.log_borders_skirt(1 * um, 2000 * um, 40),
        num_packets=num_packets, batch_size=batch_size, seed=0,
        iterate_secondary=iterate_secondary, max_iterations=max_iterations,
        device=device)


def drive(must: tuple, must_not: tuple, fn):
    """Run one path with the launch counts set to 0 just before it and read
    just after; require every kernel in `must` launched and none in
    `must_not`. Returns (fn's result, the counts)."""
    from skirt9_tpu_torch.kernels import build as kb
    kb.reset_launches()
    out = fn()
    launches = dict(kb.LAUNCHES)
    for name in must:
        require(launches[name] > 0,
                f"kernel {name} launched on the path ({launches[name]})")
    for name in must_not:
        require(launches[name] == 0,
                f"kernel {name} not launched on the path ({launches[name]})")
    return out, launches


def sphere_rays(torch, sim, rs, B):
    """B packets inside the dust sphere with isotropic directions, as events
    see them: pos, dir (B, 3), cross sections (1, B), in-grid mask."""
    r = PC * rs.uniform(size=B) ** (1.0 / 3.0)
    u = rs.normal(size=(B, 3))
    pos = (u / np.linalg.norm(u, axis=1, keepdims=True)) * r[:, None]
    d = rs.normal(size=(B, 3))
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    t32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=sim.device)
    pos, dirn = t32(pos), t32(d)
    sig = torch.full((1, B), 1e-24, dtype=torch.float32, device=sim.device)
    return pos, dirn, sig, sim.grid.locate(pos) >= 0


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn() in ms over reps back-to-back calls."""
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20) -> dict:
    """Device time per call of fn() from torch.profiler over reps calls
    after three warm-up calls: of the port's own kernels ("ours", named
    skirt9::) and of every kernel the call launches ("all"), and the device
    launches per call ("launches"). Beside the CUDA-event time of
    `cuda_ms`, which for a short kernel measures the host's launch rate,
    this is the time the card spent."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    total = lambda es: sum(e.self_device_time_total for e in es) / 1e3 / reps
    return {"ours": total([e for e in ev if "skirt9::" in e.key]),
            "all": total(ev), "launches": sum(e.count for e in ev) / reps}


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes moved
    (each input read once, each output written once) over the HBM rate and
    the f32 operations over the f32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def lane_bytes(B: int, C: int) -> int:
    """Per-lane inputs of a sweep kernel: pos, dir, axis, smin, smax, sig."""
    return B * (12 + 12 + 4 + 4 + 4 + 4 * C)


def ray_bytes(B: int, C: int) -> int:
    """Per-lane inputs of kernel 1, which forms the lane set-up itself: pos,
    dir, active (one byte), sig."""
    return B * (12 + 12 + 1 + 4 * C)


def scatter_f64(idx, val, size: int):
    """The plain scatter-add summed in float64, rounded once to float32:
    the exact sums of the plain detect's float32 terms."""
    import torch
    out = torch.zeros(size, dtype=torch.float64, device=val.device)
    return out.index_add_(0, idx.reshape(-1).long(),
                          val.reshape(-1).double()).float()


def check_detect(torch, cfg, tabs, lam, pos, contrib, active, kind) -> dict:
    """The detect kernel and the seven-call form (kernel 3 seven times)
    against the exact sums of the plain detect's terms (scatter_f64), on
    the same CUDA tensors, from zeroed accumulators: every accumulator
    within 1e-5 of its maximum, one kernel launch per call. The plain
    detect's own float32 index_add_ is reported beside them: with 131,072
    lanes in one bin its sequential atomics stray ~5e-5. Then each form's
    time per call, device time and device launches per call, and the
    kernel's bound (inputs read once, each accumulator entry that this
    call's lanes reach read and written once)."""
    from skirt9_tpu_torch.instruments import distant as dinst
    from skirt9_tpu_torch.kernels import build as kb
    from skirt9_tpu_torch.ops import scatteradd as sca
    dev = lam.device
    args = (lam, pos, contrib, kind, active)
    forms = {
        "kernel": lambda acc: dinst.detect(cfg, tabs, acc, *args),
        "plain": lambda acc: dinst.detect_plain(cfg, tabs, acc, *args),
        "seven": lambda acc: dinst.detect_plain(cfg, tabs, acc, *args,
                                                scatter=sca.scatter_add)}
    accs = {}
    for name, fn in forms.items():
        kb.reset_launches()
        accs[name] = fn(dinst.init_accumulators(cfg, dev))
        if name == "kernel":
            require(kb.LAUNCHES["detect"] == 1
                    and sum(kb.LAUNCHES.values()) == 1,
                    "detect: one kernel launch per call")
    exact = dinst.detect_plain(cfg, tabs, dinst.init_accumulators(cfg, dev),
                               *args, scatter=scatter_f64)
    torch.cuda.synchronize()
    err, rel = {}, {}
    for key, ref in exact.items():
        m = float(ref.abs().max())
        require(m > 0, f"detect test lanes light the {key}")
        for name in forms:
            e = float((accs[name][key] - ref).abs().max())
            err[f"{name}_{key}"] = e
            rel[f"{name}_{key}"] = e / m
            if name != "plain":
                require(e <= 1e-5 * m,
                        f"detect ({name}) {key} error {e} <= 1e-5 * {m}")
    acc = dinst.init_accumulators(cfg, dev)
    ms = {name: cuda_ms(lambda: fn(acc)) for name, fn in forms.items()}
    dev_t = {name: device_ms(lambda: fn(acc)) for name, fn in forms.items()}
    B, nb = lam.shape[0], cfg.nbins
    # the accumulator entries this call's lanes reach: the nonzero exact sums
    touched = sum(int((ref != 0).sum()) for ref in exact.values())
    # max_abs_err: of the SED and the frame against their exact sums; the
    # statistics rows, sums of powers up to c^4, in err_of_max
    return dict(
        max_abs_err=max(err["kernel_sed"], err.get("kernel_frame", 0.0)),
        max_err_of_max=max(v for k, v in rel.items()
                           if k.startswith("kernel")),
        err_of_max=rel, bins=nb, touched_entries=touched,
        frame_bins=nb * cfg.npy * cfg.npx if cfg.has_frame else 0,
        lit_lanes=int((active & (contrib > 0)).sum()),
        ms=ms["kernel"], plain_ms=ms["plain"], seven_call_ms=ms["seven"],
        library_ms=None, device_ms=dev_t["kernel"]["all"],
        device_launches=dev_t["kernel"]["launches"],
        plain_device_ms=dev_t["plain"]["all"],
        plain_device_launches=dev_t["plain"]["launches"],
        seven_call_device_ms=dev_t["seven"]["all"],
        seven_call_device_launches=dev_t["seven"]["launches"],
        **bound(B * (4 + 12 + 4 + 1) + (nb + 1) * 4 + 2 * 4 * touched,
                B * OPS_DETECT))


INV_SQRT = 0.7   # the tests' 1/sqrt(rf_scale): any value that rounds


def check_deposit(torch, name, kern, plain, args, h) -> dict:
    """Kernel 2 in one mode against its plain version on the same CUDA
    tensors: found agreement >= 0.999, icell identical where both found,
    s_int within 1e-5 h, RF within 1e-4 of its maximum; then its time per
    call, device time and the plain version's time."""
    rf_k, s_k, c_k, f_k = kern(*args)
    rf_p, s_p, c_p, f_p = plain(*args)
    torch.cuda.synchronize()
    B = s_k.shape[0]
    agree = float((f_k == f_p).float().mean())
    both = f_k & f_p
    require(int(f_p.sum()) > B // 2, f"{name} test rays interact")
    require(agree >= 0.999, f"{name} found agreement {agree} >= 0.999")
    require(bool(torch.equal(c_k[both], c_p[both])),
            f"{name} icell identical where both found")
    ds_err = float((s_k[both] - s_p[both]).abs().max())
    require(ds_err <= 1e-5 * h, f"{name} s_int error {ds_err} <= 1e-5 h")
    rf_err = float((rf_k - rf_p).abs().max())
    rf_max = float(rf_p.abs().max())
    require(rf_max > 0 and rf_err <= 1e-4 * rf_max,
            f"{name} rf error {rf_err} <= 1e-4 * {rf_max}")
    rows_lit = int((rf_p.abs().sum(dim=1) > 0).sum())
    return dict(max_abs_err=rf_err, rf_max=rf_max, found_agreement=agree,
                s_int_err=ds_err, rows=rf_k.shape[0], rf_rows_lit=rows_lit,
                outputs=(rf_k, s_k, c_k, f_k),
                ms=cuda_ms(lambda: kern(*args)),
                plain_ms=cuda_ms(lambda: plain(*args), reps=3),
                library_ms=None,
                device_ms=device_ms(lambda: kern(*args))["ours"])


def deposit_bound(name, tabs, B, n_act, rows) -> dict:
    """Kernel 2's bound from this run's inputs: the lane inputs, the
    density table, the per-(slab, lane) inputs at the crossed pairs only
    (scale and rel, or the prefix tb), lum and tau_int in the prefix mode,
    the RF rows and the per-lane outputs; the operations of the crossed
    pairs."""
    per_pair = 8 if name == "sweep_deposit" else 4
    per_lane = 0 if name == "sweep_deposit" else 8
    return bound(lane_bytes(B, tabs.ncomp) + tabs.nd.numel() * 4
                 + n_act * per_pair + B * per_lane
                 + rows * tabs.nd.shape[0] * 4 + B * 12,
                 n_act * (OPS_SLAB + 3 * (OPS_SUB + 2 * tabs.ncomp + OPS_DEP)))


def active_slabs(tabs, pos, dirn, g, smin, smax) -> int:
    """(slab, lane) pairs whose slab the ray crosses (uniform grids)."""
    from skirt9_tpu_torch.transport import sweep as sw
    return int(sw._slab_cells(tabs, pos, dirn, g, smin, smax)[1].sum())


# ------------------------------------------------------------------ phases

def phase_env(torch) -> str:
    from skirt9_tpu_torch.kernels import build as kb
    nvcc = subprocess.run([kb._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    smi = nvidia_smi_line()
    emit({"phase": "env", "python": platform.python_version(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc[-1], "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "nvidia_smi": smi})
    return smi


def phase_build() -> None:
    from skirt9_tpu_torch.kernels import build as kb
    t0 = time.perf_counter()
    kb.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "cached": kb.build_info.get("cached"),
          "flags": " ".join(kb.NVCC_FLAGS),
          "ptxas": [ln for ln in kb.build_info.get("ptxas", "").splitlines()
                    if "registers" in ln or "Compiling entry" in ln]})


def phase_kernels(torch) -> dict:
    """Each kernel against its plain version on the same CUDA tensors."""
    from skirt9_tpu_torch.ops import scatteradd as sca
    from skirt9_tpu_torch.transport import sweep as sw
    dev = torch.device("cuda")
    sim = config1(dev)
    tabs = sim._sweep_tabs
    h = float(tabs.h[0])
    B = B_FULL
    rs = np.random.default_rng(1)
    t32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    pos, dirn, sig, active = sphere_rays(torch, sim, rs, B)
    out = {}

    # kernel 1 in its three output modes, the lane set-up inside: the event
    # march (own dominant axes) and the peel-off march (+z, axis hint 2)
    kz = torch.zeros_like(dirn)
    kz[:, 2] = 1.0
    err1 = rel_tot = rel_pre = abs_tot = abs_pre = 0.0
    for d_, hint in ((dirn, None), (kz, 2)):
        args = (tabs, pos, d_, sig, active, hint)
        a_k, a_p = sw.sweep_dtau(*args), sw.sweep_dtau_plain(*args)
        t_k, t_p = sw.sweep_tau_total(*args), sw.sweep_tau_total_plain(*args)
        tb_k, tot_k, lane_k = sw.sweep_dtau_prefix(*args)
        tb_p, _, lane_p = sw.sweep_dtau_prefix_plain(*args)
        torch.cuda.synchronize()
        require(bool((t_p > 0).sum() > B // 2), "kernel 1 test rays see dust")
        err1 = max(err1, float((a_k - a_p).abs().max()))
        require(bool(torch.equal(a_k, a_p)),
                f"kernel 1 (sweep_dtau) bit-identical to its plain version "
                f"(hint {hint}: max error {err1})")
        scale = t_p.clamp_min(1e-30)
        rel_tot = max(rel_tot, float(((t_k - t_p).abs() / scale).max()),
                      float(((tot_k - t_p).abs() / scale).max()))
        rel_pre = max(rel_pre,
                      float(((tb_k - tb_p).abs() / scale[None, :]).max()))
        abs_tot = max(abs_tot, float((t_k - t_p).abs().max()))
        abs_pre = max(abs_pre, float((tb_k - tb_p).abs().max()))
        for a, b, name in zip(lane_k, lane_p, ("axis", "smin", "smax")):
            require(bool(torch.equal(a, b)),
                    f"kernel 1 lane {name} bit-identical to _lane_range")
    require(rel_tot <= 1e-6,
            f"kernel 1 totals within 1e-6 of each lane's tau ({rel_tot})")
    require(rel_pre <= 1e-6,
            f"kernel 1 prefix within 1e-6 of each lane's tau ({rel_pre})")
    g, smin, smax, sg = sw._prep(tabs, pos, dirn, sig, active)
    a_p = sw._dtau_plain(tabs, pos, dirn, g, smin, smax, sg)
    n_act = active_slabs(tabs, pos, dirn, g, smin, smax)
    tab_bytes = tabs.nd.numel() * 4
    ev = (tabs, pos, dirn, sig, active)
    march_ops = B * OPS_LANE + n_act * (OPS_SLAB + 3 * (OPS_SUB + 2) + 2)
    dmaj = dirn.gather(1, g.long()[:, None])[:, 0] > 0
    modes = {
        # mode: kernel, plain version, the unfused form on this kernel,
        # output bytes, extra operations, errors (absolute, of the lane's tau)
        "sweep_dtau": (sw.sweep_dtau, sw.sweep_dtau_plain, None,
                       tabs.nmax * B * 4, 0, err1, 0.0),
        "sweep_tau_total": (sw.sweep_tau_total, sw.sweep_tau_total_plain,
                            lambda: sw.sweep_dtau(*ev).sum(0), B * 4, n_act,
                            abs_tot, rel_tot),
        "sweep_dtau_prefix": (
            sw.sweep_dtau_prefix, sw.sweep_dtau_prefix_plain,
            lambda: sw.slab_prefix(sw.sweep_dtau(*ev), dmaj),
            tabs.nmax * B * 4 + 4 * B * 4, 2 * n_act, abs_pre, rel_pre)}
    for name, (fn, plain, unfused, out_bytes, ops, e_abs, e_rel) \
            in modes.items():
        out[name] = dict(
            max_abs_err=e_abs, max_err_of_tau=e_rel,
            ms=cuda_ms(lambda: fn(*ev)), plain_ms=cuda_ms(lambda: plain(*ev),
                                                         reps=5),
            library_ms=None, active_pairs=n_act,
            device_ms=device_ms(lambda: fn(*ev))["ours"],
            **bound(ray_bytes(B, 1) + tab_bytes + out_bytes, march_ops + ops))
        if unfused is not None:
            out[name]["unfused_ms"] = cuda_ms(unfused)
            out[name]["unfused_device_ms"] = device_ms(unfused)["all"]

    # kernel 2 in both modes: deposits with nonzero scale, interaction at a
    # random depth; the reference contract on the tables the prefix mode
    # forms inside
    tb, tot = sw.slab_prefix(a_p, dmaj)
    lum = t32(rs.uniform(0.5, 2.0, B))
    tau_int = t32(rs.uniform(size=B)) * tot
    scale = (lum[None, :] * torch.exp(-tb)) * INV_SQRT
    rel = tau_int[None, :] - tb
    dep = {"sweep_deposit": (sw._deposit_cuda, sw._deposit_plain, (
               tabs, pos, dirn, g, smin, smax, sg, scale, rel, 1)),
           "sweep_deposit_prefix": (
               sw._deposit_prefix_cuda, sw._deposit_prefix_plain, (
                   tabs, pos, dirn, g, smin, smax, sg, lum, tau_int, tb,
                   INV_SQRT, 1, None, 1))}
    n_act = active_slabs(tabs, pos, dirn, g, smin, smax)
    for name, (kern, plain, args) in dep.items():
        res = check_deposit(torch, name, kern, plain, args, h)
        # scale and rel formed inside equal the torch tensors: the same
        # interaction points as the reference contract fed those tensors
        if name == "sweep_deposit_prefix":
            require(all(bool(torch.equal(a, b)) for a, b in zip(
                res.pop("outputs")[1:], out["sweep_deposit"]["outputs"][1:])),
                "kernel 2's modes find the same interactions bit for bit")
        out[name] = res
        out[name].update(deposit_bound(name, tabs, B, n_act, res["rows"]))
    for name in dep:
        out[name].pop("outputs", None)
    # the full_width path stores no RF: every lane's scale is zero there
    no_rf = list(dep["sweep_deposit_prefix"][2])
    no_rf[7] = torch.zeros_like(lum)
    out["sweep_deposit_prefix"]["device_ms_no_rf"] = device_ms(
        lambda: sw._deposit_prefix_cuda(*no_rf))["ours"]

    # kernel 3: the SED / statistics bin (size 1) and the frame (size 4096)
    err3, times = 0.0, {}
    for size in (1, 4096):
        idx = torch.tensor(rs.integers(0, size, B).astype(np.int32),
                           device=dev)
        val = t32(rs.uniform(size=B) * (rs.uniform(size=B) > 0.2))
        k_ = sca.scatter_add(idx, val, size)
        p_ = sca.scatter_add_plain(idx, val, size)
        torch.cuda.synchronize()
        e = float((k_ - p_).abs().max())
        require(e <= 1e-5 * float(p_.abs().max()),
                f"kernel 3 size {size} error {e} <= 1e-5 relative")
        err3 = max(err3, e)
        # the library yardstick: one index_add_ call into a zeroed table
        acc, idx64 = torch.zeros(size, device=dev), idx.long()
        times[size] = (cuda_ms(lambda: sca.scatter_add(idx, val, size)),
                       cuda_ms(lambda: sca.scatter_add_plain(idx, val, size)),
                       cuda_ms(lambda: acc.index_add_(0, idx64, val)),
                       device_ms(lambda: sca.scatter_add(idx, val, size)),
                       device_ms(lambda: acc.index_add_(0, idx64, val)))
    out["scatter_add"] = dict(
        max_abs_err=err3, ms=times[4096][0], plain_ms=times[4096][1],
        library_ms=times[4096][2], ms_size1=times[1][0],
        plain_ms_size1=times[1][1], library_ms_size1=times[1][2],
        device_ms=times[4096][3]["ours"],
        library_device_ms=times[4096][4]["all"],
        device_ms_size1=times[1][3]["ours"],
        library_device_ms_size1=times[1][4]["all"],
        **bound(B * 8 + 4096 * 4, B))

    # the detect kernel at config 1's shapes (one SED bin, statistics, a
    # 64x64 frame): scattered peel-off from the test rays' positions
    lam = torch.full((B,), 0.55e-6, dtype=torch.float32, device=dev)
    contrib = t32(rs.uniform(0.0, 1e-3, B) * (rs.uniform(size=B) > 0.1))
    out["detect"] = check_detect(torch, sim.instruments[0], sim._inst_tabs[0],
                                 lam, pos, contrib, active, 2)
    emit({"phase": "kernels", "batch": B, "grid": list(tabs.n), **out})
    return out


def phase_kernels_xl(torch) -> dict:
    """Kernel 6 in its four modes and kernel 7 against their plain versions
    at bench_config1x256's shapes, on lanes sorted as the path sorts them
    (the peel-off toward +z in entry-slab order): the record and the summed
    form bit for bit, the total and the prefix within 1e-6 of each lane's
    tau, the lane range equal to `_lane_range` bit for bit; then timings,
    with kernel 6 on unsorted lanes, kernel 1 on the same rays, and the
    kernel-6 variants of perf/kernel6_variants.py (other run lengths, the
    lane-block and lane-tile designs, and the first design's split)."""
    from perf import kernel6_variants as k6v
    from perf import kernel7_variants as k7v
    from skirt9_tpu_torch.transport import sweep as sw
    from skirt9_tpu_torch.transport import sweepxl as xl
    sim = config1("cuda", num_packets=B_FULL, n=256)
    tabs = sim._sweep_tabs
    require(isinstance(tabs, xl.XLTables), "256^3 builds the XL tables")
    B = B_FULL
    rs = np.random.default_rng(2)
    pos_u, dir_u, sig, act_u = sphere_rays(torch, sim, rs, B)
    perm = xl.lane_order(tabs, pos_u, dir_u, sw.dominant_axis(tabs, dir_u))
    pos, dirn, active = pos_u[perm], dir_u[perm], act_u[perm]
    # peel-off toward +z: entry-slab order, one shared slab axis
    prm_z = xl.entry_order(tabs, pos_u, 2)
    kz = torch.zeros_like(dirn)
    kz[:, 2] = 1.0
    ev = (tabs, pos, dirn, sig, active, None)
    pl = (tabs, pos_u[prm_z], kz, sig, act_u[prm_z], 2)
    ev_u = (tabs, pos_u, dir_u, sig, act_u, None)
    out = {}

    # kernel 6: the record and summed forms bit for bit, the total and the
    # prefix within 1e-6 of each lane's tau, the lane range bit for bit
    rec_p, tb_p, tot_p, lane_p = xl.sweep_dtau_prefix_plain(*ev)
    sub_k = xl.sweep_dtau(*ev, want_sub=True)
    torch.cuda.synchronize()
    require(bool((tot_p > 0).sum() > B // 2), "kernel 6 test rays see dust")
    err6 = float((sub_k - rec_p).abs().max())
    require(bool(torch.equal(sub_k, rec_p)),
            f"kernel 6 record bit-identical ({err6})")
    del sub_k
    err_sum = 0.0
    for args in (ev, pl):
        sum_k, sum_p = xl.sweep_dtau(*args), xl.sweep_dtau_plain(*args)
        torch.cuda.synchronize()
        err_sum = max(err_sum, float((sum_k - sum_p).abs().max()))
        require(bool(torch.equal(sum_k, sum_p)),
                f"kernel 6 summed form bit-identical ({err_sum})")
    del sum_k, sum_p
    rel = lambda a, b, tau: float(((a - b).abs() / tau.clamp_min(1e-30)).max())
    tot_z_p = xl.sweep_tau_total_plain(*pl)
    tot_z = xl.sweep_tau_total(*pl)
    tot_e = xl.sweep_tau_total(*ev)
    rec_k, tb_k, tot_k, lane_k = xl.sweep_dtau_prefix(*ev)
    torch.cuda.synchronize()
    require(bool((tot_z_p > 0).sum() > B // 2), "peel-off rays see dust")
    rel_tot = max(rel(tot_z, tot_z_p, tot_z_p), rel(tot_e, tot_p, tot_p),
                  rel(tot_k, tot_p, tot_p))
    rel_pre = rel(tb_k, tb_p, tot_p[None, :])
    up = dirn.gather(1, lane_p[0].long()[:, None])[:, 0] > 0
    lane_err = ((tb_k - tb_p).abs() / tot_p.clamp_min(1e-30)).amax(0)
    require(rel_tot <= 1e-6,
            f"kernel 6 totals within 1e-6 of each lane's tau ({rel_tot})")
    require(rel_pre <= 1e-6,
            f"kernel 6 prefix within 1e-6 of each lane's tau ({rel_pre}; "
            f"along the slabs {float(lane_err[up].max())}, against them "
            f"{float(lane_err[~up].max())})")
    require(bool(torch.equal(rec_k, rec_p)), "kernel 6 prefix mode's record")
    for a, b, name in zip(lane_k, lane_p, ("axis", "smin", "smax")):
        require(bool(torch.equal(a, b)),
                f"kernel 6 lane {name} bit-identical to _lane_range")
    abs_tot = max(float((tot_z - tot_z_p).abs().max()),
                  float((tot_k - tot_p).abs().max()))
    abs_pre = float((tb_k - tb_p).abs().max())
    g, smin, smax = lane_p
    del rec_k, tb_k, rec_p

    # kernel 7: deposits from the record with a nonzero scale
    sub = xl.sweep_dtau(*ev, want_sub=True)
    lum = torch.tensor(rs.uniform(0.5, 2.0, B), dtype=torch.float32,
                       device=dirn.device)
    scale = lum[None, :] * torch.exp(-tb_p)
    dep = (tabs, pos, dirn, g, smin, smax, sub, scale, 1)
    rf_k = xl._deposit_cuda(*dep)
    rf_p = xl._deposit_plain(*dep)
    torch.cuda.synchronize()
    rf_err = float((rf_k - rf_p).abs().max())
    rf_max = float(rf_p.abs().max())
    require(rf_max > 0 and rf_err <= 1e-4 * rf_max,
            f"kernel 7 rf error {rf_err} <= 1e-4 * {rf_max}")
    del rf_k, rf_p

    # kernel 7's prefix mode on pass 1's record, prefix and lane range, as
    # the event loop calls it: with an RF, with lum_half = 0 and without an
    # RF; tau_int sampled up to 1.1 tau, a sixteenth of it 0
    u = rs.uniform(0.0, 1.1, B)
    u[:B // 16] = 0.0
    tau_int = torch.tensor(u, dtype=torch.float32, device=dirn.device) * tot_p
    act_int = active & (tot_p > 1e-6)
    lum_h = lum * active
    pre = lambda lm: (tabs, pos, dirn, act_int, sub, lm, tau_int, tb_p,
                      INV_SQRT, lane_p)
    pre_err = 0.0
    for what, lm in (("an RF", lum_h), ("lum_half = 0", torch.zeros_like(lum)),
                     ("no RF", None)):
        rf_k, *hit_k = xl.sweep_deposit_prefix(*pre(lm))
        rf_p, *hit_p = xl.sweep_deposit_prefix_plain(*pre(lm))
        torch.cuda.synchronize()
        require(int(hit_p[2].sum()) > B // 2, "kernel 7 test rays interact")
        for a, b, name in zip(hit_k, hit_p, ("s_int", "icell", "found")):
            require(bool(torch.equal(a, b)),
                    f"kernel 7 prefix mode's {name} identical ({what})")
        if lm is None:
            require(rf_k is None and rf_p is None, "no RF without lum_half")
            continue
        e = float((rf_k - rf_p).abs().max())
        m = float(rf_p.abs().max())
        require(e <= 1e-4 * m if lm is lum_h else (m == 0 and e == 0),
                f"kernel 7 prefix mode's rf error {e} <= 1e-4 * {m} ({what})")
        if lm is lum_h:
            pre_err, pre_max = e, m
    del rf_k, rf_p, hit_k, hit_p
    torch.cuda.empty_cache()

    # timings of kernel 6's modes: the event rays (record, summed, prefix),
    # the +z peel-off rays (summed, total)
    n_act = active_slabs(tabs, pos, dirn, g, smin, smax)
    gz, sminz, smaxz, _ = sw._prep(tabs, pl[1], kz, sig, pl[4])
    n_act_z = active_slabs(tabs, pl[1], kz, torch.full_like(gz, 2), sminz,
                           smaxz)
    rec = tabs.nmax * B * 4
    base = ray_bytes(B, 1) + tabs.nd.numel() * 4
    march = lambda n: B * OPS_LANE + n * (OPS_SLAB + 3 * (OPS_SUB + 2) + 2)
    dmaj = dirn.gather(1, g.long()[:, None])[:, 0] > 0
    modes = {
        # name: (kernel, plain version, the unfused form it replaces on the
        # path, rays, output bytes, operations, errors: absolute, of tau)
        "sweepxl_dtau": (
            lambda *a: xl.sweep_dtau(*a, want_sub=True),
            lambda *a: xl.sweep_dtau_plain(*a, want_sub=True), None, ev,
            3 * rec, march(n_act), err6, 0.0),
        "sweepxl_dtau_summed": (
            xl.sweep_dtau, xl.sweep_dtau_plain, None, pl, rec,
            march(n_act_z), err_sum, 0.0),
        "sweepxl_tau_total": (
            xl.sweep_tau_total, xl.sweep_tau_total_plain,
            lambda *a: xl.sweep_dtau(*a).sum(0), pl, B * 4,
            march(n_act_z) + n_act_z, abs_tot, rel_tot),
        "sweepxl_dtau_prefix": (
            xl.sweep_dtau_prefix, xl.sweep_dtau_prefix_plain,
            lambda *a: sw.slab_prefix(
                xl.sweep_dtau(*a, want_sub=True).sum(dim=1), dmaj),
            ev, 4 * rec + 4 * B * 4, march(n_act) + 2 * n_act, abs_pre,
            rel_pre)}
    for name, (fn, plain, unfused, args, out_bytes, ops, e_abs, e_rel) \
            in modes.items():
        out[name] = dict(
            max_abs_err=e_abs, max_err_of_tau=e_rel,
            ms=cuda_ms(lambda: fn(*args)),
            device_ms=device_ms(lambda: fn(*args))["ours"],
            plain_ms=cuda_ms(lambda: plain(*args), reps=3), library_ms=None,
            active_pairs=n_act_z if args is pl else n_act,
            **bound(base + out_bytes, ops))
        if unfused is not None:
            out[name]["unfused_ms"] = cuda_ms(lambda: unfused(*args))
            out[name]["unfused_device_ms"] = device_ms(
                lambda: unfused(*args))["all"]
        torch.cuda.empty_cache()
    k6 = out["sweepxl_dtau"]
    k6["ms_unsorted"] = cuda_ms(lambda: xl.sweep_dtau(*ev_u, want_sub=True))
    k6["prefix_ms_unsorted"] = cuda_ms(lambda: xl.sweep_dtau_prefix(*ev_u))
    k6["kernel1_ms_sorted"] = cuda_ms(lambda: sw.sweep_dtau(*ev))
    k6["kernel1_ms_unsorted"] = cuda_ms(lambda: sw.sweep_dtau(*ev_u))
    k6["variants"] = k6v.measure(torch, tabs, ev[1:5], ev_u[1:5], cuda_ms,
                                 device_ms)
    torch.cuda.empty_cache()
    ms7 = cuda_ms(lambda: xl._deposit_cuda(*dep))
    dms7 = device_ms(lambda: xl._deposit_cuda(*dep))["ours"]
    pms7 = cuda_ms(lambda: xl._deposit_plain(*dep), reps=3)
    ncells = tabs.nd.shape[0]
    out["sweepxl_deposit"] = dict(
        max_abs_err=rf_err, rf_max=rf_max, ms=ms7, device_ms=dms7,
        plain_ms=pms7, library_ms=None,
        **bound(lane_bytes(B, 0) + 4 * rec + ncells * 4,
                n_act * (OPS_SLAB + 3 * (OPS_SUB + OPS_DEP))))
    # the prefix mode against the parent's unfused form on the same inputs:
    # scale_slab, kernel 7's table mode and resolve_interaction
    kern = lambda lm: xl.sweep_deposit_prefix(*pre(lm))
    resolve = lambda: xl.resolve_interaction(tabs, pos, dirn, act_int, sub,
                                             tb_p, tau_int, lane=lane_p)
    unfused = lambda: (xl.sweep_deposit(
        tabs, pos, dirn, active, sub,
        (lum_h[None, :] * torch.exp(-tb_p)) * INV_SQRT, lane=lane_p),
        resolve())
    # bytes: the lane inputs, lum, tau_int and the mask, the prefix, the
    # record at the crossed pairs and at the hit slab, the RF and the
    # per-lane outputs; operations: the crossed pairs' deposits, pass B's
    # slab, the hit test per (slab, lane)
    in_b = lane_bytes(B, 0) + 9 * B + tabs.nmax * B * 4 + 12 * B + 13 * B
    ops_b = B * (OPS_SLAB + 3 * OPS_SUB + 12) + 3 * tabs.nmax * B
    d_rf, d_res = device_ms(lambda: kern(lum_h)), device_ms(resolve)
    out["sweepxl_deposit_prefix"] = dict(
        max_abs_err=pre_err, rf_max=pre_max,
        ms=cuda_ms(lambda: kern(lum_h)), device_ms=d_rf["ours"],
        device_ms_all=d_rf["all"], ms_no_rf=cuda_ms(lambda: kern(None)),
        device_ms_no_rf=device_ms(lambda: kern(None))["ours"],
        plain_ms=cuda_ms(lambda: xl.sweep_deposit_prefix_plain(
            *pre(lum_h)), reps=3),
        library_ms=None, unfused_ms=cuda_ms(unfused),
        unfused_device_ms=device_ms(unfused)["all"],
        unfused_no_rf_ms=cuda_ms(resolve),
        resolve_interaction_device_ms=d_res["all"],
        resolve_interaction_launches=d_res["launches"],
        bound_no_rf_ms=bound(in_b, ops_b)["bound_ms"],
        **bound(in_b + n_act * 12 + ncells * 4,
                ops_b + n_act * (OPS_SLAB + 3 * (OPS_SUB + OPS_DEP))))
    out["sweepxl_deposit"]["variants"] = k7v.measure(
        torch, tabs, (pos, dirn, lane_p, act_int, sub, lum_h, tau_int, tb_p,
                      INV_SQRT, scale), cuda_ms, device_ms)
    emit({"phase": "kernels_xl", "batch": B, "grid": list(tabs.n), **out})
    return out


def _sed(sim, accs):
    from skirt9_tpu_torch.instruments import distant as dinst
    return dinst.calibrate_sed(sim.instruments[0], accs[0])


def phase_draw_for_draw(torch, phase="draw_for_draw", n=32,
                        tables="SweepTables") -> None:
    res = {}
    for store_rf in (False, True):
        runs = {}
        for device in ("cpu", "cuda"):
            sim = config1(device, num_packets=16384, batch_size=4096, n=n,
                          store_rf=store_rf)
            require(type(sim._sweep_tabs).__name__ == tables,
                    f"{n}^3 builds {tables}")
            rf, accs = sim.run_primary(verbose=False)
            runs[device] = (sim, rf, accs)
        (sc, rfc, ac), (sg, rfg, ag) = runs["cpu"], runs["cuda"]
        sed_c, sed_g = _sed(sc, ac), _sed(sg, ag)
        worst = 0.0
        for kind in ("transparent", "primarydirect", "primaryscattered",
                     "total"):
            require(sed_c[kind][0] > 0, f"{kind} SED positive")
            e = abs(sed_g[kind][0] - sed_c[kind][0]) / sed_c[kind][0]
            require(e <= 1e-4, f"draw-for-draw {kind} SED {e} <= 1e-4")
            worst = max(worst, e)
        fc = ac[0]["frame"].double()
        fg = ag[0]["frame"].double().cpu()
        fe = float((fg - fc).abs().max() / fc.abs().max())
        require(fe <= 1e-3, f"draw-for-draw frame {fe} <= 1e-3 of max")
        entry = {"sed_rel_err": worst, "frame_err": fe}
        if store_rf:
            tc, tg = float(rfc.double().sum()), float(rfg.double().sum())
            e = abs(tg - tc) / tc
            require(tc > 0 and e <= 1e-4, f"draw-for-draw RF total {e}")
            entry["rf_total_rel_err"] = e
            entry["rf_cell_err"] = float((rfg.double().cpu() - rfc.double())
                                         .abs().max() / rfc.abs().max())
        res["rf" if store_rf else "no_rf"] = entry
    emit({"phase": phase, "grid": [n] * 3, "packets": 16384, "batch": 4096,
          **res})


# the resident sweep's path: kernel 1 as the tracer's total and pass 1's
# prefix, kernel 2 from that prefix (the reference contracts, modes
# sweep_dtau and sweep_deposit, on no path); the XL path likewise with
# kernel 6 and kernel 7 from its prefix, with or without an RF (their
# reference modes, counted as sweepxl_dtau and sweepxl_deposit, on no path)
RESIDENT = ("sweep_tau_total", "sweep_dtau_prefix", "sweep_deposit_prefix")
XL = ("sweepxl_tau_total", "sweepxl_dtau_prefix", "sweepxl_deposit_prefix")
# the tree path: kernel 4 as the tracer's total and pass 1's prefix (its
# reference modes, counted as mlsweep_dtau, on no path), kernel 5 with an RF
ML_PASS1 = ("mlsweep_tau_total", "mlsweep_dtau_prefix")
ML = ML_PASS1 + ("mlsweep_deposit",)
# every path detects through the fused kernel, never through kernel 3, and
# takes kernels 1, 2, 4, 6 and 7 in their fused modes, never in the
# reference's
DETECT = ("detect",)
NOT_PATH = ("sweep_dtau", "sweep_deposit", "sweepxl_dtau", "sweepxl_deposit",
            "mlsweep_dtau", "scatter_add")


def phase_full_width(torch, smi: str, phase="full_width", tables="SweepTables",
                     must=RESIDENT + DETECT, must_not=XL + ML + NOT_PATH,
                     **kw):
    """A config-1 path at full width, timed after one warm-up run, with the
    correctness gates. kw: config1's arguments (grid size, packets)."""
    from skirt9_tpu_torch.utils.fits import read_fits
    sim = config1("cuda", **kw)
    require(type(sim._sweep_tabs).__name__ == tables,
            f"{sim.grid.nx}^3 builds {tables}")
    sim.run_primary(verbose=False)          # warm-up
    (rf, accs), launches = drive(must, must_not,
                                 lambda: sim.run_primary(verbose=False))
    stats = dict(sim.last_stats)
    sed = _sed(sim, accs)
    cfg = sim.instruments[0]
    dlam = cfg.wave_borders[1] - cfg.wave_borders[0]
    expect = 1.0 / (4.0 * math.pi * cfg.distance ** 2 * dlam)
    e_tr = abs(sed["transparent"][0] - expect) / expect
    require(e_tr <= 1e-5, f"transparent SED {e_tr} <= 1e-5 of L/(4 pi d^2)")
    # optical depth of the +z ray from the source, summed in numpy over the
    # cells it crosses (the source sits on the corner of the central cells)
    n = sim.grid.nx
    nd = sim.medium.nd[:, 0].double().cpu().numpy().reshape(n, n, n)
    h = float(sim.grid.h[2])
    tau_grid = float(nd[n // 2, n // 2, n // 2:].sum() * 1e-24 * h)
    ratio = sed["primarydirect"][0] / sed["transparent"][0]
    e_dir = abs(ratio - math.exp(-tau_grid))
    require(e_dir <= 1e-3, f"direct/transparent {ratio} vs "
            f"exp(-{tau_grid}) within 1e-3")
    require(sed["R"][0] < 0.01, f"SED relative error R {sed['R'][0]} < 0.01")
    with tempfile.TemporaryDirectory() as tmp:
        paths = sim.write_outputs(accs, "config1", tmp)
        cube, _ = read_fits(paths[1])
        sed_cols = np.loadtxt(paths[0])
    require(cube.shape == (1, 64, 64) and bool(np.isfinite(cube).all())
            and cube.max() > 0, "frame FITS finite and lit")
    require(bool(np.all(np.isfinite(sed_cols))), "SED file finite")
    emit({"phase": phase, "grid": list(sim.grid.shape),
          "tables": tables, "packets": sim.num_packets,
          "batch": sim.batch_size, "packets_per_s": sim.last_rate,
          "seconds": stats["seconds"], "events": stats["events"],
          "launches": launches, "transparent_rel_err": e_tr,
          "direct_over_transparent": ratio, "exp_minus_tau": math.exp(-tau_grid),
          "R": float(sed["R"][0]), "scattered_over_transparent":
          float(sed["primaryscattered"][0] / sed["transparent"][0]),
          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    return sim, stats, launches


def host_per_event(torch, sim, run) -> dict:
    """One batch of a configuration profiled after a warm-up
    (event_profile.profile_run): device operations, kernel launches, stream
    syncs and copies per event of the loop and of the whole run, and the
    device's busy and idle shares."""
    from skirt9_tpu_torch.tools import event_profile as ep
    run(sim)                                     # warm-up
    prof = ep.profile_run(torch, lambda: run(sim))
    events = ep._events(sim)
    require(prof["loop_ranges"] > 0 and prof["loop"]["h2d_copies"] == 0,
            f"no host-to-device copy in the event loop: {prof['loop']}")
    return {"profiled_wall_s": prof["wall_s"], "device_busy_s": prof["busy_s"],
            "idle_share": prof["idle_share"], "events": events,
            "device_launches": prof["whole"]["device_ops"],
            "per_event": ep.per_event(prof, events),
            "unattributed": prof["unattributed"], "top": prof["top"]}


def phase_breakdown(torch, sim, stats) -> None:
    """Shares of the timed run spent blocked in the early-exit host sync and
    in threefry RNG (measured alone at the same width, times the draws the
    run made); then one batch under torch.profiler (host_per_event)."""
    from skirt9_tpu_torch.ops import rng
    from skirt9_tpu_torch.transport import lifecycle as lc
    dev = torch.device("cuda")
    B = sim.batch_size
    hist = torch.arange(B, dtype=torch.int64, device=dev)
    skey = rng.seed_key(0, dev)
    hkey = rng.history_keys(skey, hist)
    nscat = torch.zeros(B, dtype=torch.int64, device=dev)
    tags = lc._path_tags(sim.options) + (lc._TAG_SCATTER_CT,
                                         lc._TAG_SCATTER_PHI)
    ev_ms = cuda_ms(lambda: rng.uniforms(rng.event_keys(hkey, nscat), tags))
    launch_ms = cuda_ms(lambda: rng.isotropic_direction(
        rng.event_keys(rng.history_keys(skey, hist), rng.LAUNCH_EVENT),
        rng.LAUNCH_DIRECTION))
    batches = -(-sim.num_packets // B)
    rng_s = (stats["events"] * ev_ms + batches * launch_ms) / 1e3
    prof = host_per_event(
        torch, config1("cuda", num_packets=B),
        lambda s: s.run_primary(verbose=False))
    emit({"phase": "breakdown", "seconds": stats["seconds"],
          "events": stats["events"], "sync_wait_s": stats["sync_s"],
          "sync_share": stats["sync_s"] / stats["seconds"],
          "rng_ms_per_event": ev_ms, "rng_ms_per_launch": launch_ms,
          "rng_s": rng_s, "rng_share": rng_s / stats["seconds"],
          "profiled_batch": B, **prof})


def phase_rf_xl(torch) -> dict:
    """bench_config1x256 with a one-bin RF on the XL path (kernel 7), against
    the same seed on the resident sweep (kernels 1-2) put in place."""
    from skirt9_tpu_torch.transport import sweep as sw
    kw = dict(num_packets=B_FULL, n=256, store_rf=True)
    sim = config1("cuda", **kw)
    require(type(sim._sweep_tabs).__name__ == "XLTables", "256^3 builds XL")
    (rf, accs), launches = drive(XL + DETECT, RESIDENT + ML + NOT_PATH,
                                 lambda: sim.run_primary(verbose=False))
    stats = dict(sim.last_stats)
    require(bool(torch.isfinite(rf).all()) and float(rf.min()) >= 0
            and float(rf.sum()) > 0, "XL RF finite and positive")
    res = config1("cuda", **kw)
    res._sweep_tabs = sw.build_tables(res.grid, res.medium)
    rf_r, _ = res.run_primary(verbose=False)
    tx, tr = float(rf.double().sum()), float(rf_r.double().sum())
    e = abs(tx - tr) / tr
    require(e <= 1e-4, f"XL vs resident RF total {e} <= 1e-4")
    cell = float((rf.double() - rf_r.double()).abs().max()
                 / rf_r.double().abs().max())
    emit({"phase": "rf_xl", "grid": list(sim.grid.shape),
          "packets": sim.num_packets, "seconds": stats["seconds"],
          "events": stats["events"], "packets_per_s": sim.last_rate,
          "launches": launches, "rf_total_rel_err": e,
          "rf_cell_err_of_max": cell})
    return launches


# ------------------------------------------------------------ tree grids

# bench_config3ism (bench.py:336-342) and bench_config3ismxl (:390-396):
# clumps, sites per clump, clump scale [pc], max_level
ISM = {"config3ism": (46, 26, 0.04, 7), "config3ismxl": (400, 96, 0.03, 8),
       # the same recipe at max_level 9: a 512^3 fine raster, which only the
       # XL contracts take (on the tree's voxel raster)
       "config3ismxl9": (400, 96, 0.03, 9)}


def config3ism(device, name="config3ism", store_rf=False,
               num_packets=1 << 17, batch_size=B_ML):
    """bench.py's clumpy-ISM configuration through the port's API: a
    site-list octree over (-1 pc, 1 pc)^3, uniform nd = 1/(sigma 2 pc) with
    sigma = 1e-25 m^2, albedo 0.5, g = 0.3, one distant instrument with a
    64x64 frame, 16 events. Returns (sim, host seconds of the tree build,
    host seconds of the Simulation set-up, which builds the tables)."""
    from skirt9_tpu_torch.grids.octree import build_octree, site_list_refine_fn
    from skirt9_tpu_torch.instruments.distant import DistantInstrumentCfg
    from skirt9_tpu_torch.media import system as msys
    from skirt9_tpu_torch.simulation import Simulation
    from skirt9_tpu_torch.sources.base import PointSource
    from skirt9_tpu_torch.transport.lifecycle import TransportOptions

    n_clumps, n_sites, scale, max_level = ISM[name]
    sigma = 1e-25
    rs = np.random.default_rng(9)
    cc = rs.uniform(-0.85, 0.85, size=(n_clumps, 3)) * PC
    sites = np.concatenate(
        [c + rs.normal(scale=scale * PC, size=(n_sites, 3)) for c in cc])
    t0 = time.perf_counter()
    grid = build_octree(((-PC, PC),) * 3, lambda p: np.ones(len(p)),
                        max_level=max_level, min_level=2,
                        refine_fn=site_list_refine_fn(sites, 1))
    t_tree = time.perf_counter() - t0
    nd = (1.0 / (sigma * 2 * PC)) * np.ones(grid.ncells, np.float32)
    med = msys.make_medium(grid, nd, np.array([0.4e-6, 0.7e-6]),
                           sigma_ext=np.full((1, 2), sigma),
                           albedo=np.full((1, 2), 0.5), g=np.full((1, 2), 0.3))
    inst = DistantInstrumentCfg(name="i0", wave_borders=(0.5e-6, 0.6e-6),
                                distance=100 * PC, npx=64, npy=64,
                                fovx=4 * PC, fovy=4 * PC)
    opts = TransportOptions(max_steps=grid.max_steps(), max_events=16,
                            store_rf=store_rf)
    t0 = time.perf_counter()
    sim = Simulation(grid=grid, medium=med,
                     sources=[PointSource(luminosity=1.0, lam0=0.55e-6)],
                     instruments=[inst], options=opts,
                     rf_borders=(np.array([0.5e-6, 0.6e-6]) if store_rf
                                 else None),
                     num_packets=num_packets, batch_size=batch_size, seed=0,
                     device=device)
    return sim, t_tree, time.perf_counter() - t0


def box_rays(torch, sim, rs, B):
    """B packets uniform in the tree's box with isotropic directions: pos,
    dir (B, 3), cross sections (1, B), in-grid mask."""
    lo = sim.grid.box_lo.double().cpu().numpy()
    hi = sim.grid.box_hi.double().cpu().numpy()
    d = rs.normal(size=(B, 3))
    t32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=sim.device)
    pos = t32(rs.uniform(lo, hi, (B, 3)))
    dirn = t32(d / np.linalg.norm(d, axis=1, keepdims=True))
    sig = torch.full((1, B), 1e-25, dtype=torch.float32, device=sim.device)
    return pos, dirn, sig, sim.grid.locate(pos) >= 0


def _dtau_ml(torch, sim, rs):
    """Kernel 4 against its plain version on one tree at B = 65536, both
    through the public wrappers (`mlsweep.sweep_dtau`, `sweep_dtau_plain`):
    the event record (want_sub: tau and leaf ids), the summed form, and the
    +z peel-off march with its axis hint; tau within 1e-5 relative and the
    leaf ids identical; then its total mode (the tracer's) and prefix mode
    (the loop's pass 1): the totals and the prefix within 1e-6 of each
    lane's tau, the record, leaf ids, step sums and lane range bit for bit.
    Then the timings of each mode (the lane set-up inside) beside the
    unfused forms that the parent's loop ran, the variants of
    perf/kernel4_variants.py, and the bounds. Returns (the record mode's
    entry, the total and prefix modes' entries, rays, lane set-up, the
    kernel's and the plain version's record)."""
    from perf import kernel4_variants as k4v
    from skirt9_tpu_torch.transport import mlsweep as ml
    from skirt9_tpu_torch.transport import sweep as sw
    tabs = sim._sweep_tabs
    require(isinstance(tabs, ml.MLTables), "the tree builds MLTables")
    B = B_ML
    rays = box_rays(torch, sim, rs, B)
    pos, dirn, sig, active = rays
    kz = torch.zeros_like(dirn)
    kz[:, 2] = 1.0
    sub_k, cell_k = ml.sweep_dtau(tabs, pos, dirn, sig, active, want_sub=True)
    sub_p, cell_p = ml.sweep_dtau_plain(tabs, pos, dirn, sig, active,
                                        want_sub=True)
    sum_k = ml.sweep_dtau(tabs, pos, dirn, sig, active)
    sum_p = ml.sweep_dtau_plain(tabs, pos, dirn, sig, active)
    z_k = ml.sweep_dtau(tabs, pos, kz, sig, active, axis_hint=2)
    z_p = ml.sweep_dtau_plain(tabs, pos, kz, sig, active, axis_hint=2)
    torch.cuda.synchronize()
    rel = 0.0
    for tk, tp in ((sub_k.sum(dim=(0, 1)), sub_p.sum(dim=(0, 1))),
                   (sum_k.sum(0), sum_p.sum(0)), (z_k.sum(0), z_p.sum(0))):
        require(bool((tp > 0).sum() > B // 2), "kernel 4 test rays see dust")
        rel = max(rel, float(((tk - tp).abs()
                              / tp.clamp_min(1e-30))[tp > 0].max()))
    require(rel <= 1e-5, f"kernel 4 max relative tau error {rel} <= 1e-5 "
            f"({tabs.n[0]}^3 raster)")
    require(bool(torch.equal(cell_k, cell_p)),
            f"kernel 4 leaf ids identical ({tabs.n[0]}^3 raster)")
    err = max(float((a - b).abs().max()) for a, b in
              ((sub_k, sub_p), (sum_k, sum_p), (z_k, z_p)))
    identical = all(bool(torch.equal(a, b)) for a, b in
                    ((sub_k, sub_p), (sum_k, sum_p), (z_k, z_p)))
    del sum_k, sum_p, z_k, z_p

    # modes 2 and 3: the total (the +z peel-off, as the tracer runs it, and
    # the event rays) and the prefix within 1e-6 of each lane's tau, the
    # record, leaf ids and step sums bit for bit, the lane range equal to
    # _lane_range
    ev = (tabs, pos, dirn, sig, active)
    pl = (tabs, pos, kz, sig, active, 2)
    rel_tau = lambda a, b, tau: float(((a - b).abs()
                                       / tau.clamp_min(1e-30)).max())
    tot_z_p = ml.sweep_tau_total_plain(*pl)
    tot_p = ml.sweep_tau_total_plain(*ev)
    tot_z, tot_e = ml.sweep_tau_total(*pl), ml.sweep_tau_total(*ev)
    pre_k = ml.sweep_dtau_prefix(*ev)
    pre_p = ml.sweep_dtau_prefix_plain(*ev)
    rec_n = ml.sweep_dtau_prefix(*ev, leaf_ids=False)
    torch.cuda.synchronize()
    require(bool((tot_z_p > 0).sum() > B // 2), "peel-off rays see dust")
    rel_tot = max(rel_tau(tot_z, tot_z_p, tot_z_p),
                  rel_tau(tot_e, tot_p, tot_p),
                  rel_tau(pre_k[4], tot_p, tot_p))
    rel_pre = rel_tau(pre_k[3], pre_p[3], tot_p[None, :])
    what = f"({tabs.n[0]}^3 raster)"
    require(rel_tot <= 1e-6,
            f"kernel 4 totals within 1e-6 of each lane's tau {what}: "
            f"{rel_tot}")
    require(rel_pre <= 1e-6,
            f"kernel 4 prefix within 1e-6 of each lane's tau {what}: "
            f"{rel_pre}")
    for a, b, name in ((pre_k[0], pre_p[0], "record"),
                       (pre_k[1], pre_p[1], "leaf ids"),
                       (pre_k[2], pre_p[2], "step sums"),
                       (rec_n[0], pre_p[0], "record without leaf ids"),
                       *zip(pre_k[5], pre_p[5], ("axis", "smin", "smax"))):
        require(bool(torch.equal(a, b)),
                f"kernel 4 prefix mode's {name} bit-identical {what}")
    require(rec_n[1] is None, "kernel 4 prefix mode without leaf ids")
    abs_tot = max(float((tot_z - tot_z_p).abs().max()),
                  float((pre_k[4] - tot_p).abs().max()))
    abs_pre = float((pre_k[3] - pre_p[3]).abs().max())
    del pre_k, pre_p, rec_n

    lanes = sw._prep(tabs, pos, dirn, sig, active)
    g, smin, smax, sg = lanes
    pms = cuda_ms(lambda: ml.sweep_dtau_plain(*ev, want_sub=True), reps=3)
    torch.cuda.empty_cache()
    rec_mode = lambda: ml.sweep_dtau(*ev, want_sub=True)
    ms = cuda_ms(rec_mode)
    dms = device_ms(rec_mode)["ours"]
    ms_sum = cuda_ms(lambda: ml.sweep_dtau(*ev))
    ms_peel = cuda_ms(lambda: ml.sweep_dtau(*pl))
    # the rate of PyTorch's own gather on the leaf map (L2-resident on a
    # 128^3 raster, not on a 256^3 one)
    flat = torch.randint(0, tabs.leafmap.numel(), (1 << 24,),
                         device=dirn.device)
    gather_ms = cuda_ms(lambda: tabs.leafmap[flat])
    gathers_per_s = flat.numel() / (gather_ms * 1e-3)
    del flat
    n_live = int(ml._plan_substeps(tabs, pos, dirn, g, smin, smax)[3].sum())
    gz, sminz, smaxz = sw._lane_range(tabs, pos, kz, active)
    n_live_z = int(ml._plan_substeps(tabs, pos, kz, torch.full_like(gz, 2),
                                     sminz, smaxz)[3].sum())
    NS = tabs.n_steps
    rec = NS * 3 * B * 4
    # inputs read once: the rays, the density, the leaf map, the plan
    base = (ray_bytes(B, 1) + tabs.nd.numel() * 4 + tabs.leafmap.numel() * 4
            + 2 * NS * 4)
    march = lambda n: B * OPS_LANE + n * (OPS_SLAB + 3 * (OPS_SUB + 2 + 1))
    entry = dict(
        max_abs_err=err, bit_identical=identical, max_rel_tau_err=rel, ms=ms,
        device_ms=dms, plain_ms=pms, library_ms=None, ms_summed=ms_sum,
        ms_peel_z=ms_peel, live_pairs=n_live, fine_grid=list(tabs.n),
        n_steps=NS, leaves=tabs.nd.shape[0], torch_gather_per_s=gathers_per_s,
        gather_bound_ms=2 * 3 * n_live / gathers_per_s * 1e3,
        **bound(base + 2 * rec, march(n_live)))
    # the parent's tree loop formed the lane range, the sums and the prefix
    # in torch around the record mode (the kernel forms the same lane range
    # again, bit for bit)
    dmaj = dirn.gather(1, g.long()[:, None])[:, 0] > 0

    def unfused_prefix():
        sw._lane_range(tabs, pos, dirn, active)
        r, c = ml.sweep_dtau(*ev, want_sub=True)
        return r, c, sw.slab_prefix(torch.sum(r, dim=1), dmaj)

    def unfused_total():
        sw._lane_range(tabs, pos, kz, active)
        return torch.sum(ml.sweep_dtau(*pl), dim=0)

    modes = {
        "mlsweep_tau_total": (
            lambda: ml.sweep_tau_total(*pl),
            lambda: ml.sweep_tau_total_plain(*pl), unfused_total,
            B * 4, march(n_live_z), abs_tot, rel_tot, n_live_z),
        "mlsweep_dtau_prefix": (
            lambda: ml.sweep_dtau_prefix(*ev),
            lambda: ml.sweep_dtau_prefix_plain(*ev), unfused_prefix,
            2 * rec + 2 * NS * B * 4 + 4 * B * 4, march(n_live) + 2 * NS * B,
            abs_pre, rel_pre, n_live)}
    more = {}
    for name, (fn, plain, unfused, out_b, ops, e_abs, e_rel, live) \
            in modes.items():
        more[name] = dict(
            max_abs_err=e_abs, max_err_of_tau=e_rel, ms=cuda_ms(fn),
            device_ms=device_ms(fn)["ours"],
            plain_ms=cuda_ms(plain, reps=3), library_ms=None,
            unfused_ms=cuda_ms(unfused),
            unfused_device_ms=device_ms(unfused)["all"], live_pairs=live,
            **bound(base + out_b, ops))
        torch.cuda.empty_cache()
    no_ids = lambda: ml.sweep_dtau_prefix(*ev, leaf_ids=False)
    more["mlsweep_dtau_prefix"].update(
        ms_no_leaf_ids=cuda_ms(no_ids),
        device_ms_no_leaf_ids=device_ms(no_ids)["ours"],
        bound_no_leaf_ids_ms=bound(base + rec + 2 * NS * B * 4 + 16 * B,
                                   march(n_live) + 2 * NS * B)["bound_ms"])
    entry["variants"] = k4v.measure(torch, tabs, rays, cuda_ms, device_ms)
    return entry, more, rays, lanes, (sub_k, cell_k), (sub_p, cell_p)


def _deposit_ml(torch, sim, rs, k4, rays, lanes, rec_k, rec_p) -> dict:
    """Kernel 5 against its plain version on one tree at B = 65536 through
    the public wrappers, on kernel 4's record and pass 1's lane range:
    RF within 1e-5 of its maximum, s_int within 1e-5 h, found and the
    interaction cells equal. Then its timings on the launch alone, pass 2
    as the path calls it (with the cell lookup) and, for the path without
    an RF, resolve_interaction in torch ops; and its bound, counting the
    record at the live (step, lane) pairs it reads."""
    from skirt9_tpu_torch.transport import mlsweep as ml
    from skirt9_tpu_torch.transport import sweep as sw
    tabs = sim._sweep_tabs
    B = B_ML
    pos, dirn, _, active = rays
    g, smin, smax, _ = lanes
    lane = (g, smin, smax)
    (sub_k, cell_k), (sub_p, cell_p) = rec_k, rec_p
    dmaj = dirn.gather(1, g.long()[:, None])[:, 0]
    tb, tot = sw.slab_prefix(sub_p.sum(dim=1), dmaj > 0)
    lum = torch.tensor(rs.uniform(0.5, 2.0, B), dtype=torch.float32,
                       device=dirn.device) * active
    tau_int = torch.tensor(rs.uniform(size=B), dtype=torch.float32,
                           device=dirn.device) * tot
    rf_k, s_k, c_k, f_k = ml.sweep_deposit(tabs, pos, dirn, active, sub_p,
                                           cell_p, lum, tau_int, tb, 0.5,
                                           lane=lane)
    rf_p, s_p, c_p, f_p = ml.sweep_deposit_plain(tabs, pos, dirn, active,
                                                 sub_p, cell_p, lum, tau_int,
                                                 tb, 0.5)
    torch.cuda.synchronize()
    ncells = tabs.nd.shape[0]
    what = f"kernel 5 ({ncells} leaves)"
    require(int(f_p.sum()) > B // 2, f"{what} test rays interact")
    require(bool(torch.equal(f_k, f_p)), f"{what} found identical")
    s_err = float((s_k[f_k] - s_p[f_p]).abs().max())
    require(s_err <= 1e-5 * tabs.h[0], f"{what} s_int error {s_err}")
    require(bool(torch.equal(c_k, c_p)), f"{what} interaction cells equal")
    rf_err = float((rf_k - rf_p).abs().max())
    rf_max = float(rf_p.abs().max())
    require(rf_max > 0 and rf_err <= 1e-5 * rf_max,
            f"{what} rf error {rf_err} <= 1e-5 * {rf_max}")

    # timings on the launch alone: plain version first, then free its tensors
    dep = (tabs, pos, dirn, g, smin, smax, sub_p, cell_p, lum, tau_int, tb,
           0.5)
    pms5 = cuda_ms(lambda: ml._deposit_plain(*dep), reps=3)
    del sub_p, cell_p, rf_p, dep
    dep = (tabs, pos, dirn, g, smin, smax, sub_k, cell_k, lum, tau_int, tb,
           0.5)
    torch.cuda.empty_cache()
    ms5 = cuda_ms(lambda: ml._deposit_cuda(*dep))
    dms5 = device_ms(lambda: ml._deposit_cuda(*dep))["ours"]
    act_int = active & (tot > 1e-6)
    ms_pass2_rf = cuda_ms(lambda: ml.sweep_deposit(
        tabs, pos, dirn, active, sub_k, cell_k, lum, tau_int, tb, 0.5,
        lane=lane))
    # the no-RF pass 2 as the parent's loop called it, and with pass 1's
    # lane range and step sums
    resolve = lambda: ml.resolve_interaction(tabs, pos, dirn, act_int, sub_k,
                                             tb, tau_int)
    step_sums = torch.sum(sub_k, dim=1)
    resolve_lane = lambda: ml.resolve_interaction(
        tabs, pos, dirn, act_int, sub_k, tb, tau_int, lane=lane,
        dtau_step=step_sums)
    for a, b in zip(resolve(), resolve_lane()):
        require(bool(torch.equal(a, b)),
                "resolve_interaction with pass 1's lane and step sums")
    ms_resolve = cuda_ms(resolve)
    d_res, d_lane = device_ms(resolve), device_ms(resolve_lane)
    n_live = k4["live_pairs"]
    rec = tabs.n_steps * 3 * B * 4
    return dict(
        max_abs_err=rf_err, rf_max=rf_max, s_int_err=s_err, ms=ms5,
        device_ms=dms5, plain_ms=pms5, library_ms=None,
        ms_pass2_rf=ms_pass2_rf, ms_resolve_interaction=ms_resolve,
        resolve_interaction_device_ms=d_res["all"],
        resolve_interaction_launches=d_res["launches"],
        resolve_interaction_lane_ms=cuda_ms(resolve_lane),
        resolve_interaction_lane_device_ms=d_lane["all"],
        resolve_interaction_lane_launches=d_lane["launches"],
        leaves=ncells, shared_table=ncells <= ml.SHARED_LEAVES,
        live_pairs=n_live, live_share=n_live / (tabs.n_steps * B),
        # the whole record read, as the one-thread-per-pair design read it
        bound_full_record_ms=bound(
            lane_bytes(B, 0) + 8 * B + 2 * rec + rec // 3
            + 2 * tabs.n_steps * 4 + ncells * 4 + 8 * B, 0)["bound_ms"],
        **bound(lane_bytes(B, 0) + 8 * B + n_live * (3 * 4 + 3 * 4 + 4)
                + 2 * tabs.n_steps * 4 + ncells * 4 + 8 * B,
                n_live * (OPS_SLAB + 3 + 3 * (OPS_SUB + OPS_DEP))))


def phase_kernels_ml(torch) -> dict:
    """Kernels 4 and 5 against their plain versions at B = 65536 through
    their public wrappers: kernel 4 on bench_config3ism's tree (the
    full_width_ml path) and on bench_config3ismxl's (full_width_ml_large:
    a 256^3 raster whose leaf map exceeds L2), kernel 5 on both (rf_ml;
    the large tree's 138,447 leaves take the kernel's global path, the
    small tree's 5,230 its shared-memory table); then timings, with
    resolve_interaction (pass 2 of the path without an RF) beside kernel
    5."""
    sim_l, _, _ = config3ism("cuda", "config3ismxl")
    rs = np.random.default_rng(5)
    large, large_more, rays, lanes, rec_k, rec_p = _dtau_ml(torch, sim_l, rs)
    large5 = _deposit_ml(torch, sim_l, rs, large, rays, lanes, rec_k, rec_p)
    del sim_l, rays, lanes, rec_k, rec_p
    torch.cuda.empty_cache()
    sim, _, _ = config3ism("cuda")
    rs = np.random.default_rng(4)
    k4, more, rays, lanes, rec_k, rec_p = _dtau_ml(torch, sim, rs)
    k5 = _deposit_ml(torch, sim, rs, k4, rays, lanes, rec_k, rec_p)
    out = {"mlsweep_dtau": k4, "mlsweep_deposit": k5, **more}
    for name, big in (("mlsweep_dtau", large), ("mlsweep_deposit", large5),
                      *large_more.items()):
        out[name]["large_tree"] = big
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"],
                                       big["max_abs_err"])
    emit({"phase": "kernels_ml", "batch": B_ML, **out})
    return out


def ml_problem(device, num_packets=16384, batch_size=4096):
    """The density octree of tests/test_mlsweep.py:30-47 (max_level 4) with
    a one-bin RF and a 64x64 frame, through the port's API."""
    from skirt9_tpu_torch.grids.octree import build_octree
    from skirt9_tpu_torch.instruments.distant import DistantInstrumentCfg
    from skirt9_tpu_torch.media import system as msys
    from skirt9_tpu_torch.simulation import Simulation
    from skirt9_tpu_torch.sources.base import PointSource
    from skirt9_tpu_torch.transport.lifecycle import TransportOptions

    sigma = 1e-24

    def dens(p):
        r = np.linalg.norm(p, axis=-1)
        return np.where(r < PC, (PC / np.maximum(r, 0.1 * PC)) ** 2, 0.0)

    grid = build_octree(((-1.2 * PC, 1.2 * PC),) * 3, dens, max_level=4,
                        min_level=1, max_fraction=2e-2)
    nd = dens(grid.cell_centers().double().numpy()) / (sigma * PC)
    med = msys.make_medium(grid, nd.astype(np.float32),
                           np.array([0.4e-6, 0.7e-6]),
                           sigma_ext=np.full((1, 2), sigma),
                           albedo=np.full((1, 2), 0.5), g=np.full((1, 2), 0.3))
    inst = DistantInstrumentCfg(name="i", wave_borders=(0.5e-6, 0.6e-6),
                                distance=100 * PC, npx=64, npy=64,
                                fovx=4 * PC, fovy=4 * PC)
    return Simulation(grid=grid, medium=med,
                      sources=[PointSource(luminosity=1.0, lam0=0.55e-6)],
                      instruments=[inst],
                      options=TransportOptions(max_steps=grid.max_steps(),
                                               max_events=16),
                      rf_borders=np.array([0.5e-6, 0.6e-6]),
                      num_packets=num_packets, batch_size=batch_size, seed=4,
                      device=device)


def phase_draw_for_draw_ml(torch) -> None:
    """The port on the CPU (plain versions) against the port on the GPU
    (kernels 4-5), the same seed, on a density octree with a one-bin RF."""
    runs = {}
    for device in ("cpu", "cuda"):
        sim = ml_problem(device)
        require(type(sim._sweep_tabs).__name__ == "MLTables",
                "the density octree builds MLTables")
        rf, accs = sim.run_primary(verbose=False)
        runs[device] = (sim, rf, accs)
    (sc, rfc, ac), (sg, rfg, ag) = runs["cpu"], runs["cuda"]
    sed_c, sed_g = _sed(sc, ac), _sed(sg, ag)
    worst = 0.0
    for kind in ("transparent", "primarydirect", "primaryscattered", "total"):
        require(sed_c[kind][0] > 0, f"{kind} SED positive")
        e = abs(sed_g[kind][0] - sed_c[kind][0]) / sed_c[kind][0]
        require(e <= 1e-4, f"draw-for-draw (octree) {kind} SED {e} <= 1e-4")
        worst = max(worst, e)
    fc = ac[0]["frame"].double()
    fg = ag[0]["frame"].double().cpu()
    fe = float((fg - fc).abs().max() / fc.abs().max())
    require(fe <= 1e-3, f"draw-for-draw (octree) frame {fe} <= 1e-3 of max")
    tc, tg = float(rfc.double().sum()), float(rfg.double().sum())
    e_rf = abs(tg - tc) / tc
    require(tc > 0 and e_rf <= 1e-4, f"draw-for-draw (octree) RF total {e_rf}")
    emit({"phase": "draw_for_draw_ml", "leaves": sc.grid.ncells,
          "fine_grid": list(sc._sweep_tabs.n), "packets": sc.num_packets,
          "batch": sc.batch_size, "sed_rel_err": worst, "frame_err": fe,
          "rf_total_rel_err": e_rf,
          "rf_cell_err": float((rfg.double().cpu() - rfc.double()).abs().max()
                               / rfc.abs().max())})


def phase_full_width_ml(torch, smi: str, phase="full_width_ml",
                        name="config3ism", store_rf=False):
    """A clumpy-ISM tree at full width, timed after one warm-up run, with
    the correctness gates. The level-9 tree (`config3ismxl9`) runs on its
    voxel raster through the XL contracts (kernels 6-7 with the cell map),
    the others on the multi-level sweep (kernels 4-5)."""
    sim, t_tree, t_setup = config3ism("cuda", name, store_rf=store_rf)
    tabs = sim._sweep_tabs
    raster = name == "config3ismxl9"
    require(type(tabs).__name__ == ("XLTables" if raster else "MLTables")
            and (not raster or tabs.cellmap is not None),
            f"{name} builds its engine's tables")
    sim.run_primary(verbose=False)          # warm-up
    must = ML_PASS1 + DETECT + (("mlsweep_deposit",) if store_rf else ())
    must_not = RESIDENT + XL + NOT_PATH + (() if store_rf
                                           else ("mlsweep_deposit",))
    if raster:
        must, must_not = XL + DETECT, RESIDENT + ML + NOT_PATH
    (rf, accs), launches = drive(must, must_not,
                                 lambda: sim.run_primary(verbose=False))
    stats = dict(sim.last_stats)
    sed = _sed(sim, accs)
    cfg = sim.instruments[0]
    dlam = cfg.wave_borders[1] - cfg.wave_borders[0]
    expect = 1.0 / (4.0 * math.pi * cfg.distance ** 2 * dlam)
    e_tr = abs(sed["transparent"][0] - expect) / expect
    require(e_tr <= 1e-5, f"transparent SED {e_tr} <= 1e-5 of L/(4 pi d^2)")
    # tau from the centre to the box face along +z: nd sigma pc = 0.5
    ratio = sed["primarydirect"][0] / sed["transparent"][0]
    e_dir = abs(ratio - math.exp(-0.5))
    require(e_dir <= 1e-3, f"direct/transparent {ratio} vs exp(-0.5) "
            "within 1e-3")
    require(sed["R"][0] < 0.01, f"SED relative error R {sed['R'][0]} < 0.01")
    res = {"phase": phase, "config": name, "leaves": sim.grid.ncells,
           "fine_grid": list(tabs.n), "tables": type(tabs).__name__,
           "n_steps": getattr(tabs, "n_steps", None),
           "levels": len(getattr(tabs, "levels", ())), "tree_build_s": t_tree,
           "setup_s": t_setup, "packets": sim.num_packets,
           "batch": sim.batch_size, "packets_per_s": sim.last_rate,
           "seconds": stats["seconds"], "events": stats["events"],
           "sync_wait_s": stats["sync_s"], "launches": launches,
           "transparent_rel_err": e_tr, "direct_over_transparent": ratio,
           "exp_minus_tau": math.exp(-0.5), "R": float(sed["R"][0]),
           "scattered_over_transparent":
           float(sed["primaryscattered"][0] / sed["transparent"][0]),
           "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    if name == "config3ismxl":
        res["reference_engine"] = ("the XL fine raster "
                                   "(sweepxl.build_tree_tables)")
    if store_rf:
        require(bool(torch.isfinite(rf).all()) and float(rf.min()) >= 0
                and float(rf.sum()) > 0 and rf.shape == (sim.grid.ncells, 1),
                "tree RF per leaf, finite and positive")
        res["rf_total"] = float(rf.double().sum())
        res["leaves_lit"] = int((rf[:, 0] > 0).sum())
    emit(res)
    return sim, launches


def phase_breakdown_ml(torch, sim) -> None:
    """One more run of a tree path under torch.profiler: device kernels,
    their launches per event, stream syncs and host-to-device copies, the
    device's busy and idle shares of the wall, and the kernels that take the
    most device time."""
    from skirt9_tpu_torch.tools import event_profile as ep
    prof = ep.profile_run(torch, lambda: sim.run_primary(verbose=False))
    events = sim.last_stats["events"]
    require(prof["loop_ranges"] > 0 and prof["loop"]["h2d_copies"] == 0,
            f"no host-to-device copy in the event loop: {prof['loop']}")
    emit({"phase": "breakdown_ml", "profiled_wall_s": prof["wall_s"],
          "device_busy_s": prof["busy_s"], "idle_share": prof["idle_share"],
          "device_launches": prof["whole"]["device_ops"], "events": events,
          "per_event": ep.per_event(prof, events),
          "unattributed": prof["unattributed"], "top": prof["top"]})


# ------------------------------------------------------- config 2, probes

PROBE = ("probe_gather_smem", "probe_gather_l2", "probe_scatter_smem",
         "row_lookup_gather", "row_lookup_select")


def phase_kernels_probe(torch) -> dict:
    """Kernels 8-9 through their entry points (the tools' `run`, at the
    original scripts' shapes), then each variant once more against its
    plain version (gathers and the row lookups bit-exact, sums within 1e-6
    relative) with its bound; kernel 3 at the probe's scatter shape beside
    kernel 8's. Then the parent's designs and the variants of
    perf/kernel8_variants.py and perf/kernel9_variants.py in turns with the
    package's kernels, the launch floor (an empty kernel, plainly and as a
    cluster of one), gather and scatter-add rates through block-local and
    distributed shared memory and L2, and the host cost of the parent's
    per-call launch set-up."""
    from perf import kernel8_variants as k8v
    from perf import kernel9_variants as k9v
    from skirt9_tpu_torch.ops import scatteradd as sca
    from skirt9_tpu_torch.tools import gather_probe as gp
    from skirt9_tpu_torch.tools import sublane_gather as sg
    (r8, r9), launches = drive(PROBE + ("scatter_add",),
                               RESIDENT + XL + ML + DETECT, lambda: (
                                   gp.run("cuda"), sg.run("cuda")))
    dev = torch.device("cuda")
    nd, idx, vals = gp.inputs(dev)
    tab, ix = sg.inputs(dev)
    g_ref = gp.gather_plain(nd, idx)
    s_ref = gp.scatter_plain(idx, vals, gp.N)
    l_ref = sg.lookup_plain(tab, ix)
    checks = {
        "probe_gather_smem": (gp.gather(nd, idx), g_ref, True),
        "probe_take_smem": (gp.take(nd, idx), g_ref, True),
        "probe_gather_l2": (gp.gather(nd, idx, staged=False), g_ref, True),
        "probe_scatter_smem": (gp.scatter(idx, vals, gp.N), s_ref, False),
        "scatter_add_probe_shape": (sca.scatter_add(idx, vals, gp.N), s_ref,
                                    False),
        "row_lookup_gather": (sg.lookup(tab, ix), l_ref, True),
        "row_lookup_select": (sg.lookup(tab, ix, select=True), l_ref, False)}
    torch.cuda.synchronize()
    err = {}
    for name, (got, ref, exact) in checks.items():
        err[name] = float((got - ref).abs().max())
        if exact:
            require(bool(torch.equal(got, ref)), f"{name} bit-exact")
        else:
            require(err[name] <= 1e-6 * float(ref.abs().max()),
                    f"{name} error {err[name]} <= 1e-6 relative")
    dev_t = {name: device_ms(fn) for name, fn in {
        "probe_gather_smem": lambda: gp.gather(nd, idx),
        "probe_gather_l2": lambda: gp.gather(nd, idx, staged=False),
        "probe_scatter_smem": lambda: gp.scatter(idx, vals, gp.N),
        "scatter_add": lambda: sca.scatter_add(idx, vals, gp.N),
        "row_lookup_gather": lambda: sg.lookup(tab, ix),
        "row_lookup_select": lambda: sg.lookup(tab, ix, select=True),
        "gather_library": lambda: gp.gather_plain(nd, idx),
        "scatter_library": lambda: gp.scatter_plain(idx, vals, gp.N),
        "lookup_library": lambda: sg.lookup_library(tab, ix)}.items()}
    B, N = gp.B, gp.N
    io8 = N * 4 + B * 8                   # table or histogram, idx, out/vals
    R, S, W, IT = sg.R, sg.S, sg.W, sg.ITERS
    io9 = R * W * 4 + 2 * S * W * 4
    out = {
        "probe_gather_smem": dict(
            ms=r8["gather_smem"]["ms"], ms_take=r8["take_smem"]["ms"],
            plain_ms=r8["gather_plain_ms"], library_ms=r8["gather_plain_ms"],
            max_abs_err=max(err["probe_gather_smem"], err["probe_take_smem"]),
            **bound(io8, 0)),
        "probe_gather_l2": dict(
            ms=r8["gather_l2"]["ms"], plain_ms=r8["gather_plain_ms"],
            library_ms=r8["gather_plain_ms"],
            max_abs_err=err["probe_gather_l2"], **bound(io8, 0)),
        "probe_scatter_smem": dict(
            ms=r8["scatter_smem"]["ms"], plain_ms=r8["scatter_plain_ms"],
            library_ms=r8["scatter_plain_ms"],
            max_abs_err=err["probe_scatter_smem"],
            kernel3_ms=r8["scatter_kernel3"]["ms"],
            kernel3_max_abs_err=err["scatter_add_probe_shape"],
            **bound(io8, B)),
        "row_lookup_gather": dict(
            ms=r9["gather"]["ms"], plain_ms=r9["gather"]["plain_ms"],
            library_ms=r9["library_ms"], max_abs_err=err["row_lookup_gather"],
            **bound(io9, S * W * IT)),
        # a compare and an add per (lookup, row)
        "row_lookup_select": dict(
            ms=r9["select"]["ms"], plain_ms=r9["select"]["plain_ms"],
            library_ms=r9["library_ms"], max_abs_err=err["row_lookup_select"],
            **bound(io9, 2 * S * W * IT * R))}
    lib = {"probe_gather_smem": "gather_library",
           "probe_gather_l2": "gather_library",
           "probe_scatter_smem": "scatter_library",
           "row_lookup_gather": "lookup_library",
           "row_lookup_select": "lookup_library"}
    for name in PROBE:
        out[name].update(launches=launches[name],
                         device_ms=dev_t[name]["ours"],
                         device_ms_call=dev_t[name]["all"],
                         library_device_ms=dev_t[lib[name]]["all"])
    out["probe_scatter_smem"]["kernel3_device_ms"] = dev_t["scatter_add"][
        "ours"]
    # kernel 3 runs on no simulation path now, but in the probe's comparison
    out["probe_scatter_smem"]["kernel3_launches"] = launches["scatter_add"]
    k8 = k8v.measure(torch, cuda_ms, device_ms)
    out["row_lookup_gather"]["variants"] = k9v.measure(torch, tab, ix, IT,
                                                       cuda_ms, device_ms)
    out["probe_gather_smem"]["variants"] = k8["gather"]
    out["probe_scatter_smem"]["variants"] = k8["scatter"]
    for name in PROBE[:4]:
        out[name]["floor_ms"] = k8["floor"]["empty"]["device_ms"]
    emit({"phase": "kernels_probe", "table": N, "indices": B,
          "row_table": [R, W], "index_rows": S, "iters": IT,
          "floor": k8["floor"], "rates": k8["rates"],
          "rate_rounds": k8v.ROUNDS, "host": k8["host"], **out})
    return out


def first_event_b2(torch, sim):
    """Config 2's first event as the path sees it: the first stratified
    batch of the primary source launched, its cross sections, the lane
    set-up of the sweep and the pass-1 optical depths."""
    from skirt9_tpu_torch.media import system as msys
    from skirt9_tpu_torch.ops import rng
    from skirt9_tpu_torch.sources import base as src
    from skirt9_tpu_torch.transport import sweep as sw
    strata = sim._strata_for(sim.sources[0], sim.options)
    B, stabs, opts, lanes = sim._stratify(strata, sim._src_tabs[0],
                                          sim.options, sim.num_packets)
    pkt = src.launch_batch(sim.sources[0], stabs, sim.grid,
                           rng.seed_key(sim.seed, sim.device), lanes,
                           sim.num_packets)
    sig = msys.optics_at(sim.medium, pkt.lam).sigma_ext.T.contiguous()
    tabs = sim._sweep_tabs
    g, smin, smax, sg_ = sw._prep(tabs, pkt.pos, pkt.dir, sig, pkt.alive)
    dtau = sw._dtau_plain(tabs, pkt.pos, pkt.dir, g, smin, smax, sg_)
    return pkt, opts, (g, smin, smax, sg_), dtau


def phase_kernels_b2(torch) -> dict:
    """Kernel 2 with config 2's 32 lane groups and kernel 3 on its
    163,840-bin frame, each against its plain version on config 2's first
    event, timed, with their bounds."""
    from skirt9_tpu_torch.instruments import distant as dinst
    from skirt9_tpu_torch.ops import scatteradd as sca
    from skirt9_tpu_torch.transport import sweep as sw
    sim = config2("cuda")
    tabs = sim._sweep_tabs
    pkt, opts, (g, smin, smax, sg_), dtau = first_event_b2(torch, sim)
    B, n_groups = pkt.lam.shape[0], opts.rf_strata
    require(n_groups == 32 and B == B_FULL,
            f"config 2 runs 32 lane groups of a 2^17 batch ({n_groups}, {B})")
    rs = np.random.default_rng(6)
    grp = sw.dominant_axis(tabs, pkt.dir)
    tb, tot = sw.slab_prefix(dtau, pkt.dir.gather(1, grp[:, None])[:, 0] > 0)
    inv_sqrt = 1.0 / math.sqrt(sim.rf_scale)
    rfb = sim._rf_borders_dev
    in_rf = (pkt.lam >= rfb[0]) & (pkt.lam < rfb[-1])
    lum_half = (pkt.lum * (pkt.alive & in_rf)) * inv_sqrt
    u = torch.tensor(rs.uniform(size=B), dtype=torch.float32,
                     device=sim.device)
    tau_int = u * tot
    scale = (lum_half[None, :] * torch.exp(-tb)) * inv_sqrt
    rel = tau_int[None, :] - tb
    nbins = len(sim.rf_borders) - 1
    bin_map = torch.tensor(opts.rf_bin_map, dtype=torch.int32,
                           device=sim.device)
    dep = {"sweep_deposit": (sw._deposit_cuda, sw._deposit_plain, (
               tabs, pkt.pos, pkt.dir, g, smin, smax, sg_, scale, rel,
               n_groups)),
           "sweep_deposit_prefix": (
               sw._deposit_prefix_cuda, sw._deposit_prefix_plain, (
                   tabs, pkt.pos, pkt.dir, g, smin, smax, sg_, lum_half,
                   tau_int, tb, inv_sqrt, n_groups, bin_map, nbins))}
    n_act = active_slabs(tabs, pkt.pos, pkt.dir, g, smin, smax)
    out = {}
    for name, (kern, plain, args) in dep.items():
        res = check_deposit(torch, f"{name} (config 2)", kern, plain, args,
                            float(tabs.h[0]))
        rf_k = res.pop("outputs")[0]
        rows = nbins if name == "sweep_deposit_prefix" else n_groups
        require(rf_k.shape == (rows, tabs.nd.shape[0])
                and res["rf_rows_lit"] >= 25,
                f"{name} fills the 25 RF bins' rows ({res['rf_rows_lit']})")
        out[name] = dict(res, n_groups=n_groups,
                         **deposit_bound(name, tabs, B, n_act, rows))
    _, s_p, _, f_p = sw._deposit_plain(*dep["sweep_deposit"][2])

    # kernel 3: the frame bins of the first scattering peel-off, formed as
    # detect forms them from the interaction points found above
    cfg, itab = sim.instruments[0], sim._inst_tabs[0]
    nb = cfg.nbins
    ipos = pkt.pos + s_p[:, None] * pkt.dir
    b = torch.searchsorted(itab["wave_borders"], pkt.lam, right=True) - 1
    ok = f_p & (b >= 0) & (b < nb)
    xp = torch.sum(ipos * itab["ex"], dim=-1) - cfg.centerx
    yp = torch.sum(ipos * itab["ey"], dim=-1) - cfg.centery
    ix = torch.floor((xp / cfg.fovx + 0.5) * cfg.npx).clamp(0, cfg.npx - 1)
    iy = torch.floor((yp / cfg.fovy + 0.5) * cfg.npy).clamp(0, cfg.npy - 1)
    size = nb * cfg.npy * cfg.npx
    flat = ((b.clamp(0, nb - 1) * cfg.npy + iy.long()) * cfg.npx
            + ix.long()).to(torch.int32)
    val = torch.where(ok, pkt.lum, torch.zeros_like(pkt.lum))
    k_ = sca.scatter_add(flat, val, size)
    p_ = sca.scatter_add_plain(flat, val, size)
    torch.cuda.synchronize()
    e3 = float((k_ - p_).abs().max())
    require(size == 163840 and e3 <= 1e-5 * float(p_.abs().max()),
            f"kernel 3 at {size} bins error {e3} <= 1e-5 relative")
    acc, f64 = torch.zeros(size, device=sim.device), flat.long()
    out["scatter_add"] = dict(
        max_abs_err=e3, bins=size, distinct_bins=int(torch.unique(flat).numel()),
        ms=cuda_ms(lambda: sca.scatter_add(flat, val, size)),
        plain_ms=cuda_ms(lambda: sca.scatter_add_plain(flat, val, size)),
        library_ms=cuda_ms(lambda: acc.index_add_(0, f64, val)),
        device_ms=device_ms(lambda: sca.scatter_add(flat, val, size))["ours"],
        library_device_ms=device_ms(
            lambda: acc.index_add_(0, f64, val))["all"],
        **bound(B * 8 + size * 4, B))
    # the detect kernel at config 2's shapes (40 SED bins, statistics, a
    # 40 x 64 x 64 frame): the first scattering peel-off, as above
    contrib = torch.tensor(rs.uniform(0.0, 1e-3, B), dtype=torch.float32,
                           device=sim.device)
    out["detect"] = check_detect(torch, cfg, itab, pkt.lam, ipos, contrib,
                                 f_p, 2)
    emit({"phase": "kernels_b2", "batch": B, "grid": list(tabs.n), **out})
    return out


def phase_draw_for_draw_b2(torch) -> None:
    """A small config 2 (8^3, 8,192 packets, 8 events, one self-absorption
    iteration) through run_with_dust_emission on the CPU (plain versions)
    and on the GPU (kernels), the same seed: each SED kind within 1e-4 of
    its largest bin, the RF within 1e-4 of its maximum, L_dust 1e-4."""
    runs = {}
    for device in ("cpu", "cuda"):
        sim = config2(device, num_packets=8192, batch_size=4096, n=8,
                      max_events=8, iterate_secondary=True, max_iterations=1)
        rf, accs, info = sim.run_with_dust_emission(verbose=False)
        runs[device] = (sim, rf, accs, info)
    (sc, rfc, ac, ic), (sg, rfg, ag, ig) = runs["cpu"], runs["cuda"]
    worst = 0.0
    sed_c, sed_g = ac[0]["sed"].double(), ag[0]["sed"].double().cpu()
    for k in range(sed_c.shape[0]):
        m = float(sed_c[k].abs().max())
        require(m > 0, f"SED kind {k} lit")
        worst = max(worst, float((sed_g[k] - sed_c[k]).abs().max()) / m)
    require(worst <= 1e-4, f"draw-for-draw (config 2) SEDs {worst} <= 1e-4")
    rf_err = float((rfg.double().cpu() - rfc.double()).abs().max()
                   / rfc.double().abs().max())
    require(rf_err <= 1e-4, f"draw-for-draw (config 2) RF {rf_err} <= 1e-4")
    e_l = abs(ig["L_dust"] / ic["L_dust"] - 1.0)
    require(ic["iterations"] == ig["iterations"] == 1 and e_l <= 1e-4,
            f"draw-for-draw (config 2) L_dust {e_l} <= 1e-4")
    emit({"phase": "draw_for_draw_b2", "grid": [8] * 3, "packets": 8192,
          "batch": sc.batch_size, "rf_bins": rfc.shape[1],
          "sed_err_of_max": worst, "rf_err_of_max": rf_err,
          "L_dust_rel_err": e_l, "iterations": ic["iterations"]})


def _golden_gates(sim, rf, accs, tmp) -> dict:
    """bench2's golden gates (`bench2_gates`) on a run's written SED file,
    its radiation field as mean intensity per cell and bin [W/m2/m/sr] and
    its dust temperature."""
    paths = sim.write_outputs(accs, "b2", tmp)
    dlam = np.diff(np.asarray(sim.rf_borders, np.float64))
    J = (rf.double().cpu().numpy() * sim.rf_scale
         / (4 * np.pi * sim.grid.volumes()[:, None] * dlam[None, :]))
    return bench2_gates(np.loadtxt(paths[0]), J, dlam,
                        sim.dust_temperature(rf)[:, 0])


def bench2_gates(ours, J, dlam, T, strict: bool = True) -> dict:
    """bench2's golden thresholds (tests/test_reference_parity.py:72-141)
    against tests/golden/bench2_*: SED column medians, the integrated
    total, the RF per-bin medians and log correlation, the dust
    temperature median. ours: the SED file's columns; J: (ncells, nbins)
    mean intensity [W/m2/m/sr]; dlam: the RF bin widths [m]; T: (ncells,)
    dust temperature [K]. strict False lists the gates missed under
    "missed" instead of failing (the goldens are SKIRT's at 32^3)."""
    missed = []

    def check(cond, what):
        if strict:
            require(cond, what)
        elif not cond:
            missed.append(what)

    ref = np.loadtxt(os.path.join(GOLDEN, "bench2_i0_sed.dat"))
    require(ours.shape[0] == ref.shape[0], "40 SED rows")
    require(bool(np.allclose(ours[:, 0], ref[:, 0], rtol=1e-3)),
            "SED wavelengths")
    res = {}
    for col, name, tol in ((2, "transparent", 0.05), (3, "primarydirect", 0.1),
                           (4, "primaryscattered", 0.25),
                           (5, "secondarydirect", 0.25)):
        hi = ref[:, col] > 0.05 * ref[:, col].max()
        med = float(np.median(ours[hi, col] / ref[hi, col]))
        check(abs(med - 1.0) < tol, f"bench2 {name} median ratio {med}")
        res[f"{name}_median_ratio"] = med
    lam = ref[:, 0]
    tot = float(np.trapezoid(ours[:, 1], lam) / np.trapezoid(ref[:, 1], lam))
    check(abs(tot - 1.0) < 0.1, f"bench2 integrated total ratio {tot}")
    res["total_ratio"] = tot
    with gzip.open(os.path.join(GOLDEN, "bench2_rf_J.dat.gz"), "rt") as f:
        refJ = np.loadtxt(f)[:, 1:]
    oursJ = J * 1e-6                      # per micron, as the golden
    tr, to = refJ.sum(axis=0), oursJ.sum(axis=0)
    hi = tr > 0.02 * tr.max()
    med = float(np.median(to[hi] / tr[hi]))
    check(abs(med - 1.0) < 0.1, f"bench2 RF per-bin median ratio {med}")
    bol_r = (refJ * dlam[None, :] * 1e6).sum(axis=1)
    bol_o = (oursJ * dlam[None, :] * 1e6).sum(axis=1)
    sel = bol_r > np.percentile(bol_r, 50)
    cc = float(np.corrcoef(np.log(bol_r[sel]),
                           np.log(np.maximum(bol_o[sel], 1e-300)))[0, 1])
    check(cc > 0.93, f"bench2 RF log correlation {cc} > 0.93")
    T_ref = np.loadtxt(os.path.join(GOLDEN, "bench2_T_dust_T.dat"))[:, 1]
    t_med = float(np.median(T[T_ref > 1.0] / T_ref[T_ref > 1.0]))
    check(abs(t_med - 1.0) < 0.05, f"bench2 dust temperature median {t_med}")
    res.update(rf_median_ratio=med, rf_log_correlation=cc,
               T_median_ratio=t_med)
    if not strict:
        res["missed"] = missed
    return res


def phase_full_width_b2(torch, smi: str):
    """Config 2 at bench.py's full width (2^20 packets in batches of 2^17,
    24 events, seed 0), a warm-up run and a timed run on the same object:
    kernels 1-2 and detect launched, no tree or XL kernel and not kernel
    3; bench2's golden gates and L_dust = L_abs_primary within 1e-4 (no
    iterations)."""
    sim = config2("cuda")
    sim.run_with_dust_emission(verbose=False)            # warm-up
    t0 = time.perf_counter()
    (rf, accs, info), launches = drive(
        RESIDENT + DETECT, XL + ML + NOT_PATH,
        lambda: sim.run_with_dust_emission(verbose=False))
    dt = time.perf_counter() - t0
    stats = dict(sim.last_stats)
    n_pk = sim.num_packets
    packets = n_pk * (1 + info["iterations"] + (1 if info["L_dust"] > 0 else 0))
    e_l = abs(info["L_dust"] / info["L_abs_primary"] - 1.0)
    require(not sim.iterate_secondary and info["iterations"] == 0
            and e_l < 1e-4, f"L_dust / L_abs_primary - 1 = {e_l} (< 1e-4)")
    require(bool(torch.isfinite(rf).all()) and float(rf.min()) >= 0,
            "RF finite and non-negative")
    with tempfile.TemporaryDirectory() as tmp:
        gates = _golden_gates(sim, rf, accs, tmp)
    events = sum(seg[3] for seg in stats["segments"])
    res = {"phase": "full_width_b2", "grid": list(sim.grid.shape),
           "packets": n_pk, "batch": sim.batch_size, "rf_bins": rf.shape[1],
           "packets_per_s": packets / dt, "seconds": dt,
           "iterations": info["iterations"], "L_dust": info["L_dust"],
           "L_abs_primary": info["L_abs_primary"],
           "L_dust_rel_err": e_l,
           "segments": [{"name": n, "packets": p, "seconds": t, "events": e}
                        for n, p, t, e in stats["segments"]],
           "events": events, "launches": launches,
           "kernel_launches_per_event": sum(launches.values()) / events,
           **gates, "device": torch.cuda.get_device_name(0),
           "nvidia_smi": smi}
    emit(res)
    return sim, launches


def phase_breakdown_b2(torch) -> None:
    """Config 2 with one batch per segment (2^17 packets) under
    torch.profiler (host_per_event): launches, stream syncs and copies per
    event, busy and idle shares, the kernels that take the most device
    time."""
    prof = host_per_event(
        torch, config2("cuda", num_packets=B_FULL),
        lambda s: s.run_with_dust_emission(verbose=False))
    emit({"phase": "breakdown_b2", "packets": B_FULL, **prof})


def config1h(device, num_packets=1 << 19, batch_size=B_FULL):
    """bench.py's config 1h (bench.py:108-126): tests/golden/bench1h.ski
    (radial tau 10, albedo 0.9) through the port's `load_ski`, 16 events
    per batch, run in lane-refill generations of 16 events."""
    from skirt9_tpu_torch.config.ski import load_ski
    sim = load_ski(os.path.join(GOLDEN, "bench1h.ski"),
                   num_packets=num_packets, batch_size=batch_size,
                   max_events=16, device=device)
    sim.refill_events = 16
    return sim


def edited_ski(name: str, directory, edits: dict, out: str = "small") -> str:
    """tests/golden/<name>.ski with each `old` replaced by `new`, written
    into directory beside a copy of the dust mix file it reads."""
    import shutil
    with open(os.path.join(GOLDEN, f"{name}.ski")) as f:
        text = f.read()
    for old, new in edits.items():
        require(old in text, f"{old!r} in {name}.ski")
        text = text.replace(old, new)
    path = os.path.join(str(directory), f"{out}.ski")
    with open(path, "w") as f:
        f.write(text)
    shutil.copy(os.path.join(GOLDEN, "mrn_mean.txt"), str(directory))
    return path


# the reduced bench3: levels 2-4 (2,122 leaves on a 16^3 fine raster)
B3_SMALL = {'maxLevel="7"': 'maxLevel="4"'}


def config3(device, num_packets=1 << 18, batch_size=B_B3, max_events=24,
            path=None):
    """bench.py's config 3 (bench.py:130-149): tests/golden/bench3.ski
    through the port's `load_ski` (a tau_V = 10 r^-2 MRN shell on a
    density octree of levels 2-7, 55,574 leaves on a 128^3 fine raster; a
    25-bin RF in 32 lane groups, a 40-bin emission grid, self-absorption
    iterations), at bench_config3's 2^18 packets in batches of 2^16 and 24
    events. path: another ski file (the reduced one of `edited_ski`)."""
    from skirt9_tpu_torch.config.ski import load_ski
    return load_ski(path or os.path.join(GOLDEN, "bench3.ski"),
                    num_packets=num_packets, batch_size=batch_size,
                    max_events=max_events, device=device)


def golden_sed_gates(name, sed_um, gates) -> dict:
    """A one-bin SED [W/m2/micron] (transparent, primarydirect,
    primaryscattered) against tests/golden/<name>_i0_sed.dat: each entry of
    gates (kind, column, relative bound) as pytest.approx holds it."""
    golden = np.loadtxt(os.path.join(GOLDEN, f"{name}_i0_sed.dat"))
    res = {}
    for kind, col, tol in gates:
        ratio = sed_um[kind] / golden[col]
        require(abs(ratio - 1.0) <= tol,
                f"{name} {kind} {sed_um[kind]} vs golden {golden[col]} "
                f"within {tol}")
        res[f"{kind}_ratio"] = ratio
    return res


def bench1h_gates(sed) -> dict:
    """test_bench1h_high_tau_parity's gates
    (tests/test_reference_parity.py:149-178) on a calibrated SED."""
    sed_um = {k: float(sed[k][0]) * 1e-6 for k in (
        "transparent", "primarydirect", "primaryscattered")}
    res = golden_sed_gates("bench1h", sed_um, (
        ("transparent", 2, 2e-3), ("primarydirect", 3, 0.3),
        ("primaryscattered", 4, 0.1)))
    golden = np.loadtxt(os.path.join(GOLDEN, "bench1h_i0_sed.dat"))
    lr = math.log(sed_um["primarydirect"] / sed_um["transparent"])
    lr_g = math.log(golden[3] / golden[2])
    require(abs(lr / lr_g - 1.0) <= 0.02,
            f"bench1h log(direct/transparent) {lr} vs {lr_g} within 2%")
    res["log_direct_over_transparent"] = lr
    return res


def refilled_batch(torch, sim):
    """The packet batch that the refill path hands to life_cycle in the
    first generation with holes: dead lanes (histories used up) beside
    lanes launched in that generation (its emit mask) and lanes of earlier
    generations. The run stops there. Returns (pkt, emit mask)."""
    from skirt9_tpu_torch.transport import lifecycle as lc
    real, seen = lc.life_cycle, []

    class Found(Exception):
        pass

    def spy(*args, **kw):
        pkt, fresh = args[5], kw["emit_mask"]
        if not bool(pkt.alive.all()) and bool((fresh & pkt.alive).any()) \
                and bool((pkt.alive & ~fresh).any()):
            seen.append((pkt, fresh))
            raise Found
        return real(*args, **kw)

    lc.life_cycle = spy
    try:
        sim.run_primary(verbose=False)
    except Found:
        pass
    finally:
        lc.life_cycle = real
    require(len(seen) == 1, "a refill generation with dead, fresh and old "
            "lanes")
    return seen[0]


def check_refilled_batch(torch, sim) -> dict:
    """Kernels 1, 2 and detect on a refilled batch (`refilled_batch`)
    against their plain versions on the same CUDA tensors: kernel 1's total
    (the +z peel-off) and prefix modes within 1e-6 of each lane's tau and
    the lane range bit for bit, kernel 2's prefix mode as `check_deposit`
    holds it (with an RF, so that the deposits run), and detect on the
    emission peel-off of the fresh lanes as `check_detect` holds it."""
    from skirt9_tpu_torch.instruments import distant as dinst
    from skirt9_tpu_torch.media import system as msys
    from skirt9_tpu_torch.transport import sweep as sw
    pkt, fresh = refilled_batch(torch, sim)
    tabs = sim._sweep_tabs
    B = pkt.lam.shape[0]
    sig = msys.optics_at(sim.medium, pkt.lam).sigma_ext.T.contiguous()
    active = pkt.alive
    res = {"lanes": B, "dead": int((~active).sum()),
           "fresh": int((fresh & active).sum()),
           "old": int((active & ~fresh).sum())}
    kz = torch.zeros_like(pkt.dir)
    kz[:, 2] = 1.0
    rel_tot = rel_pre = 0.0
    for d_, hint in ((pkt.dir, None), (kz, 2)):
        args = (tabs, pkt.pos, d_, sig, active, hint)
        t_k, t_p = sw.sweep_tau_total(*args), sw.sweep_tau_total_plain(*args)
        tb_k, tot_k, lane_k = sw.sweep_dtau_prefix(*args)
        tb_p, _, lane_p = sw.sweep_dtau_prefix_plain(*args)
        torch.cuda.synchronize()
        scale = t_p.clamp_min(1e-30)
        rel_tot = max(rel_tot, float(((t_k - t_p).abs() / scale).max()),
                      float(((tot_k - t_p).abs() / scale).max()))
        rel_pre = max(rel_pre,
                      float(((tb_k - tb_p).abs() / scale[None, :]).max()))
        for a, b, name in zip(lane_k, lane_p, ("axis", "smin", "smax")):
            require(bool(torch.equal(a, b)),
                    f"refilled batch: kernel 1 lane {name} bit-identical")
        require(bool(torch.equal(t_p[~active], torch.zeros_like(
            t_p[~active]))), "refilled batch: dead lanes see no dust")
    require(rel_tot <= 1e-6 and rel_pre <= 1e-6,
            f"refilled batch: kernel 1 totals {rel_tot} and prefix "
            f"{rel_pre} within 1e-6 of each lane's tau")
    res.update(kernel1_err_of_tau=max(rel_tot, rel_pre))
    tb, tot, lane = sw.sweep_dtau_prefix(tabs, pkt.pos, pkt.dir, sig, active)
    rs = np.random.default_rng(11)
    tau_int = torch.tensor(rs.uniform(size=B).astype(np.float32),
                           device=tot.device) * tot
    # the event loop's RF scaling (the sim's rf_scale), as if it stored one
    inv_sqrt = 1.0 / math.sqrt(sim.rf_scale)
    lum_half = (pkt.lum * active) * inv_sqrt
    dep = check_deposit(
        torch, "refilled sweep_deposit_prefix",
        lambda *a: sw.sweep_deposit_prefix(*a, nbins=1),
        lambda *a: sw.sweep_deposit_prefix_plain(*a, nbins=1),
        (tabs, pkt.pos, pkt.dir, sig, active, lum_half, tau_int, tb,
         inv_sqrt, lane), float(tabs.h[0]))
    res["kernel2"] = {k: dep[k] for k in ("max_abs_err", "rf_max",
                                          "found_agreement", "s_int_err")}
    cfg = sim.instruments[0]
    det = check_detect(torch, cfg, sim._inst_tabs[0], pkt.lam, pkt.pos,
                       pkt.lum / (4 * math.pi), fresh & active,
                       dinst.KIND_TRANSPARENT)
    res["detect"] = {k: det[k] for k in ("max_abs_err", "max_err_of_max",
                                         "lit_lanes")}
    return res


def phase_refill_b1h(torch, smi: str) -> dict:
    """Config 1h (bench1h.ski at bench.py's size: 2^19 packets in batches
    of 2^17, refill generations of 16 events), timed after a warm-up:
    kernels 1-2 and detect launched, no tree or XL kernel; no lane
    abandoned at the generation cap; bench1h's golden gates; kernels 1, 2
    and detect on a refilled batch against their plain versions; one
    batch of 2^17 packets (all its generations) profiled (host_per_event)."""
    sim = config1h("cuda")
    require(type(sim._sweep_tabs).__name__ == "SweepTables",
            "bench1h builds SweepTables")
    sim.run_primary(verbose=False)                       # warm-up
    (_, accs), launches = drive(RESIDENT + DETECT, XL + ML + NOT_PATH,
                                lambda: sim.run_primary(verbose=False))
    st = dict(sim.last_stats)
    require(st["abandoned"] == 0, f"refill: {st['abandoned']} lanes "
            "abandoned at the generation cap")
    gates = bench1h_gates(_sed(sim, accs))
    kernels = check_refilled_batch(torch, config1h("cuda"))
    prof = host_per_event(torch, config1h("cuda", num_packets=B_FULL),
                          lambda s: s.run_primary(verbose=False))
    res = {"phase": "refill_b1h", "grid": list(sim.grid.shape),
           "packets": sim.num_packets, "batch": sim.batch_size,
           "refill_events": sim.refill_events,
           "packets_per_s": sim.last_rate, "seconds": st["seconds"],
           "generations": st["generations"], "events": st["events"],
           "events_per_generation": st["events"] / st["generations"],
           "syncs": st["syncs"],
           "syncs_per_generation": st["syncs"] / st["generations"],
           "sync_wait_s": st["sync_s"], "abandoned": st["abandoned"],
           "launches": launches, **gates, "refilled_batch": kernels,
           "profiled_batch": B_FULL, "profile": prof,
           "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    emit(res)
    return launches


# the CLI's packets for bench3.ski: bench_config3's 2^18 (the ski file says
# 10^6), so that the call stays well inside its time limit
CLI_B3_PACKETS = 1 << 18


def phase_cli(torch, smi: str) -> dict:
    """`skirt9_tpu_torch.__main__.main` on bench1.ski and bench2.ski at
    their own 10^6 packets and on bench3.ski at 2^18 packets
    (`CLI_B3_PACKETS`), in batches of 131,072, into a temporary directory,
    each driven with the launch counts set to 0: kernels 1-2 and detect
    launched for bench1 and bench2, kernels 4-5 and detect for bench3. The
    gates read the written files: bench1's SED against
    test_bench1_parity_with_reference's thresholds, bench2's SED, RF and
    temperature probe files against bench2_gates, bench3's against
    bench3_gates; the probe files hold one row per cell and equal the run's
    RF and dust temperature (and bench3's cell properties its volumes and
    densities)."""
    from skirt9_tpu_torch import __main__ as cli
    from skirt9_tpu_torch.probes import probes
    from skirt9_tpu_torch.utils.fits import read_fits
    real, runs = probes.run_probe_system, {}

    def spy(sim, when, prefix, outdir=".", rf=None):
        if when == "Run":
            runs[prefix] = (sim, rf)
        return real(sim, when, prefix, outdir, rf=rf)

    res = {"phase": "cli", "batch": 131072,
           "bench3_packets_flag": CLI_B3_PACKETS}
    launches = {}
    probes.run_probe_system = spy
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for name, must, extra in (
                    ("bench1", RESIDENT + DETECT, []),
                    ("bench2", RESIDENT + DETECT, []),
                    ("bench3", ML + DETECT, ["-p", str(CLI_B3_PACKETS)])):
                must_not = tuple(k for k in RESIDENT + XL + ML + NOT_PATH
                                 if k not in must)
                t0 = time.perf_counter()
                rc, launches[name] = drive(
                    must, must_not,
                    lambda: cli.main([os.path.join(GOLDEN, f"{name}.ski"),
                                      "-b", "131072", "-o", tmp, *extra]))
                require(rc == 0, f"CLI on {name}.ski exit code {rc}")
                res[f"{name}_wall_s"] = time.perf_counter() - t0
                sim = runs[name][0]
                res[f"{name}_packets"] = sim.num_packets
                res[f"{name}_run_s"] = sim.last_stats["seconds"]
                ours = np.loadtxt(os.path.join(tmp, f"{name}_i0_sed.dat"))
                cube, _ = read_fits(os.path.join(tmp,
                                                 f"{name}_i0_total.fits"))
                require(bool(np.isfinite(ours).all()
                             and np.isfinite(cube).all())
                        and cube.max() > 0, f"{name} outputs finite, lit")
            require(runs["bench1"][0].num_packets == 10 ** 6
                    and runs["bench2"][0].num_packets == 10 ** 6
                    and runs["bench3"][0].num_packets == CLI_B3_PACKETS,
                    "10^6 packets each for bench1 and bench2, as the ski "
                    "files say, and the flag's for bench3")
            b1 = np.loadtxt(os.path.join(tmp, "bench1_i0_sed.dat"))
            res["bench1"] = golden_sed_gates(
                "bench1", {"transparent": b1[2], "primarydirect": b1[3],
                           "primaryscattered": b1[4]},
                (("transparent", 2, 2e-3), ("primarydirect", 3, 0.02),
                 ("primaryscattered", 4, 0.05)))
            for name, rf_file, T_file in (
                    ("bench2", "bench2_rf_radiationfield.dat",
                     "bench2_T_temperature.dat"),
                    ("bench3", "bench3_rf_radiationfield.dat",
                     "bench3_T_temperature.dat")):
                sim, rf = runs[name]
                J = np.loadtxt(os.path.join(tmp, rf_file))
                T = np.loadtxt(os.path.join(tmp, T_file))
                n = sim.grid.ncells
                require(J.shape == (n, 3 + rf.shape[1]) and T.shape == (n, 4),
                        f"{name} probe files: one row per cell")
                require(bool(np.array_equal(J[:, 3:],
                                            mean_intensity(sim, rf))),
                        f"the {name} RF probe file holds the run's RF")
                require(bool(np.array_equal(T[:, 3],
                                            sim.dust_temperature(rf)[:, 0])),
                        f"the {name} temperature probe file holds the run's "
                        "dust temperature")
                sed = np.loadtxt(os.path.join(tmp, f"{name}_i0_sed.dat"))
                if name == "bench2":
                    dlam = np.diff(np.asarray(sim.rf_borders, np.float64))
                    res[name] = bench2_gates(sed, J[:, 3:], dlam, T[:, 3])
                else:
                    res[name] = bench3_gates(sim, sed, J[:, 3:], T[:, 3])
            sim = runs["bench3"][0]
            cells = np.loadtxt(os.path.join(tmp, "bench3_cells_cellprops.dat"))
            require(cells.shape == (sim.grid.ncells, 5)
                    and bool(np.array_equal(cells[:, 3], sim.grid.volumes()))
                    and bool(np.array_equal(
                        cells[:, 4], sim.medium.nd[:, 0].double().cpu()
                        .numpy())),
                    "bench3's cell-properties file holds the leaves' "
                    "volumes and densities")
    finally:
        probes.run_probe_system = real
    res.update(launches=launches, device=torch.cuda.get_device_name(0),
               nvidia_smi=smi)
    emit(res)
    return launches


# ------------------------------------------------------------- config 3

ML_NOT_PATH = RESIDENT + XL + NOT_PATH


def first_event_b3(torch, sim):
    """Config 3's first event as the tree path sees it: the first stratified
    batch of the primary source launched, and kernel 4's pass 1 on it (the
    record with leaf ids, step sums, prefix, total and lane range)."""
    from skirt9_tpu_torch.media import system as msys
    from skirt9_tpu_torch.ops import rng
    from skirt9_tpu_torch.sources import base as src
    from skirt9_tpu_torch.transport import mlsweep as ml
    strata = sim._strata_for(sim.sources[0], sim.options)
    B, stabs, opts, lanes = sim._stratify(strata, sim._src_tabs[0],
                                          sim.options, sim.num_packets)
    pkt = src.launch_batch(sim.sources[0], stabs, sim.grid,
                           rng.seed_key(sim.seed, sim.device), lanes,
                           sim.num_packets)
    sig = msys.optics_at(sim.medium, pkt.lam).sigma_ext.T.contiguous()
    return pkt, opts, ml.sweep_dtau_prefix(sim._sweep_tabs, pkt.pos, pkt.dir,
                                           sig, pkt.alive)


def phase_kernels_b3(torch) -> dict:
    """Kernel 5's grouped mode on config 3's first event (the full bench3
    tree, 55,574 leaves: the global path; 32 lane groups folded into the 25
    RF rows by the launch's bin map) against its plain version: the RF
    within 1e-6 of its maximum, s_int, icell and found equal. Timed by CUDA
    events and by device time, beside the plain version; its bound counts
    the lane inputs, the record at the (plan step, lane) pairs the rays
    cross, the plan, the bin map, the RF rows written and the first hits."""
    from skirt9_tpu_torch.transport import mlsweep as ml
    sim = config3("cuda")
    tabs = sim._sweep_tabs
    pkt, opts, (rec, cells, _, tb, tot, lane) = first_event_b3(torch, sim)
    B, n_groups = pkt.lam.shape[0], opts.rf_strata
    nbins = len(sim.rf_borders) - 1
    require(n_groups == 32 and B == B_B3 and nbins == 25,
            f"config 3 runs 32 lane groups of a 2^16 batch into 25 bins "
            f"({n_groups}, {B}, {nbins})")
    ncells = tabs.nd.shape[0]
    require(ncells > ml.SHARED_LEAVES, "bench3's tree takes the global path")
    rs = np.random.default_rng(8)
    inv_sqrt = 1.0 / math.sqrt(sim.rf_scale)
    rfb = sim._rf_borders_dev
    in_rf = (pkt.lam >= rfb[0]) & (pkt.lam < rfb[-1])
    lum_half = (pkt.lum * (pkt.alive & in_rf)) * inv_sqrt
    tau_int = torch.tensor(rs.uniform(size=B), dtype=torch.float32,
                           device=sim.device) * tot
    bin_map = torch.tensor(opts.rf_bin_map, dtype=torch.int32,
                           device=sim.device)
    args = (tabs, pkt.pos, pkt.dir, pkt.alive, rec, cells, lum_half, tau_int,
            tb, inv_sqrt)
    kw = dict(n_groups=n_groups, lane=lane, bin_map=bin_map, nbins=nbins)
    rf_k, s_k, c_k, f_k = ml.sweep_deposit(*args, **kw)
    rf_p, s_p, c_p, f_p = ml.sweep_deposit_plain(*args, **kw)
    torch.cuda.synchronize()
    what = f"kernel 5, 32 groups ({ncells} leaves)"
    require(int(f_p.sum()) > B // 2, f"{what} test rays interact")
    require(bool(torch.equal(f_k, f_p)), f"{what} found identical")
    require(bool(torch.equal(s_k[f_k], s_p[f_p])), f"{what} s_int identical")
    require(bool(torch.equal(c_k, c_p)), f"{what} interaction cells equal")
    require(rf_k.shape == rf_p.shape == (nbins, ncells), f"{what} RF rows")
    rf_err = float((rf_k - rf_p).abs().max())
    rf_max = float(rf_p.abs().max())
    require(rf_max > 0 and rf_err <= 1e-6 * rf_max,
            f"{what} rf error {rf_err} <= 1e-6 * {rf_max}")
    rows_lit = int((rf_p.abs().sum(dim=1) > 0).sum())
    require(rows_lit == nbins, f"{what} fills the 25 bins' rows ({rows_lit})")
    g, smin, smax = lane
    dep = (tabs, pkt.pos, pkt.dir, g, smin, smax, rec, cells, lum_half,
           tau_int, tb, inv_sqrt, n_groups, bin_map, nbins)
    del rf_p
    plain_ms = cuda_ms(lambda: ml._deposit_plain(*dep), reps=3)
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: ml._deposit_cuda(*dep))
    dev_ms = device_ms(lambda: ml._deposit_cuda(*dep))["ours"]
    n_live = int(ml._plan_substeps(tabs, pkt.pos, pkt.dir, g, smin,
                                   smax)[3].sum())
    res = dict(max_abs_err=rf_err, rf_max=rf_max, err_of_max=rf_err / rf_max,
               n_groups=n_groups, rows=nbins, rows_lit=rows_lit,
               leaves=ncells, shared_table=False, live_pairs=n_live,
               live_share=n_live / (tabs.n_steps * B), ms=ms,
               device_ms=dev_ms, plain_ms=plain_ms, library_ms=None,
               **bound(lane_bytes(B, 0) + 8 * B
                       + n_live * (3 * 4 + 3 * 4 + 4)
                       + 2 * tabs.n_steps * 4 + n_groups * 4
                       + nbins * ncells * 4 + 8 * B,
                       n_live * (OPS_SLAB + 3 + 3 * (OPS_SUB + OPS_DEP))))
    emit({"phase": "kernels_b3", "batch": B, "fine_grid": list(tabs.n),
          "n_steps": tabs.n_steps, "mlsweep_deposit": res})
    return res


def phase_draw_for_draw_b3(torch) -> dict:
    """The reduced config 3 (bench3.ski at maxLevel 4: 2,122 leaves; 8,192
    packets in batches of 4,096, which the 32 lane groups round to one
    batch of 32,768 lanes a segment; 4 events; at most 2 self-absorption
    iterations) through run_with_dust_emission on the CPU (plain versions)
    and on the GPU (kernels 4, 5 and detect launched, no other sweep), the
    same seed: iterations equal, each SED kind and the RF within 2e-5 of
    their maxima, the frame within 1e-3 of its brightest pixel, L_dust
    within 1e-4."""
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = edited_ski("bench3", tmp, B3_SMALL)
        for device in ("cpu", "cuda"):
            sim = config3(device, num_packets=8192, batch_size=4096,
                          max_events=4, path=path)
            sim.max_iterations = 2
            run = lambda: sim.run_with_dust_emission(verbose=False)
            if device == "cuda":
                out, launches = drive(ML + DETECT, ML_NOT_PATH, run)
            else:
                out = run()
            runs[device] = (sim, *out)
    (sc, rfc, ac, ic), (sg, rfg, ag, ig) = runs["cpu"], runs["cuda"]
    require(ic["iterations"] == ig["iterations"] >= 1,
            f"draw-for-draw (config 3) iterations {ic['iterations']}, "
            f"{ig['iterations']}")
    worst = 0.0
    sed_c, sed_g = ac[0]["sed"].double(), ag[0]["sed"].double().cpu()
    for k in range(sed_c.shape[0]):
        m = float(sed_c[k].abs().max())
        require(m > 0, f"SED kind {k} lit")
        worst = max(worst, float((sed_g[k] - sed_c[k]).abs().max()) / m)
    require(worst <= 2e-5, f"draw-for-draw (config 3) SEDs {worst} <= 2e-5")
    rf_err = float((rfg.double().cpu() - rfc.double()).abs().max()
                   / rfc.double().abs().max())
    require(rf_err <= 2e-5, f"draw-for-draw (config 3) RF {rf_err} <= 2e-5")
    fc = ac[0]["frame"].double()
    fg = ag[0]["frame"].double().cpu()
    fe = float((fg - fc).abs().max() / fc.abs().max())
    require(fe <= 1e-3, f"draw-for-draw (config 3) frame {fe} <= 1e-3")
    e_l = abs(ig["L_dust"] / ic["L_dust"] - 1.0)
    require(e_l <= 1e-4, f"draw-for-draw (config 3) L_dust {e_l} <= 1e-4")
    res = {"phase": "draw_for_draw_b3", "leaves": sc.grid.ncells,
           "packets": 8192, "lanes": 32768, "rf_bins": rfc.shape[1],
           "iterations": ic["iterations"], "sed_err_of_max": worst,
           "rf_err_of_max": rf_err, "frame_err": fe, "L_dust_rel_err": e_l,
           "segments": [s[0] for s in sg.last_stats["segments"]],
           "launches": launches}
    emit(res)
    return res


def bench3_gates(sim, sed, J, T) -> dict:
    """bench3's golden thresholds (tests/test_reference_parity.py:185-269)
    against tests/golden/bench3_*: the SED column medians and the
    integrated total; the dust temperature at the reference octree's cell
    centres, median and mass-weighted mean; the radiation field's volume
    integral per bin. sed: the SED file's columns; J: (ncells, nbins) mean
    intensity [W/m2/m/sr]; T: (ncells,) dust temperature [K]."""
    import torch
    ref = np.loadtxt(os.path.join(GOLDEN, "bench3_i0_sed.dat"))
    require(sed.shape[0] == ref.shape[0], "40 SED rows")
    require(bool(np.allclose(sed[:, 0], ref[:, 0], rtol=1e-3)),
            "SED wavelengths")
    res = {}
    for col, name, tol in ((2, "transparent", 0.05), (3, "primarydirect", 0.2),
                           (4, "primaryscattered", 0.25),
                           (5, "secondarydirect", 0.25)):
        hi = ref[:, col] > 0.05 * ref[:, col].max()
        med = float(np.median(sed[hi, col] / ref[hi, col]))
        require(abs(med - 1.0) < tol, f"bench3 {name} median ratio {med}")
        res[f"{name}_median_ratio"] = med
    lam = ref[:, 0]
    tot = float(np.trapezoid(sed[:, 1], lam) / np.trapezoid(ref[:, 1], lam))
    require(abs(tot - 1.0) < 0.15, f"bench3 integrated total ratio {tot}")
    res["total_ratio"] = tot
    with gzip.open(os.path.join(GOLDEN, "bench3_cellprops.dat.gz"),
                   "rt") as f:
        props = np.loadtxt(f)
    T_ref = np.loadtxt(os.path.join(GOLDEN, "bench3_T_dust_T.dat"))[:, 1]
    rho = props[:, 6]                      # dust mass density
    idx = sim.grid.locate(torch.tensor((props[:, 1:4] * PC).astype(
        np.float32), device=sim.device)).cpu().numpy()
    ok = (idx >= 0) & (rho > 0) & (T_ref > 1.0)
    T_at = T[idx[ok]]
    med = float(np.median(T_at / T_ref[ok]))
    require(abs(med - 1.0) < 0.08, f"bench3 temperature median ratio {med}")
    w = (rho * props[:, 4])[ok]
    mw = float(np.sum(T_at * w) / np.sum(T_ref[ok] * w))
    require(abs(mw - 1.0) < 0.08, f"bench3 mass-weighted temperature {mw}")
    with gzip.open(os.path.join(GOLDEN, "bench3_rf_J.dat.gz"), "rt") as f:
        refJ = np.loadtxt(f)[:, 1:]
    JV = (J * sim.grid.volumes()[:, None]).sum(axis=0) * 1e-6  # per micron
    JV_ref = (refJ * (props[:, 4] * PC ** 3)[:, None]).sum(axis=0)
    hi = JV_ref > 0.02 * JV_ref.max()
    rf_med = float(np.median(JV[hi] / JV_ref[hi]))
    require(abs(rf_med - 1.0) < 0.1, f"bench3 RF volume integral {rf_med}")
    res.update(T_median_ratio=med, T_mass_weighted_ratio=mw,
               rf_volume_integral_median_ratio=rf_med,
               reference_cells_compared=int(ok.sum()))
    return res


def mean_intensity(sim, rf) -> np.ndarray:
    """(ncells, nbins) mean intensity [W/m2/m/sr] of a run's RF."""
    dlam = np.diff(np.asarray(sim.rf_borders, np.float64))
    return (rf.double().cpu().numpy() * sim.rf_scale
            / (4 * np.pi * sim.grid.volumes()[:, None] * dlam[None, :]))


def phase_full_width_b3(torch, smi: str):
    """Config 3 at bench_config3's width (bench.py:130-149: 2^18 packets in
    batches of 2^16, 24 events, seed 0), a warm-up run and a timed run on
    the same object: kernels 4, 5 and detect launched, kernels 1, 2, 6 and
    7 not; packets/s as bench.py counts them, packets x (1 + iterations +
    [L_dust > 0]); each segment's seconds and events; every gate of
    test_bench3_*."""
    sim = config3("cuda")
    require(type(sim._sweep_tabs).__name__ == "MLTables",
            "bench3 builds MLTables")
    sim.run_with_dust_emission(verbose=False)            # warm-up
    t0 = time.perf_counter()
    (rf, accs, info), launches = drive(
        ML + DETECT, ML_NOT_PATH,
        lambda: sim.run_with_dust_emission(verbose=False))
    dt = time.perf_counter() - t0
    stats = dict(sim.last_stats)
    n_pk = sim.num_packets
    packets = n_pk * (1 + info["iterations"] + int(info["L_dust"] > 0))
    require(sim.iterate_secondary and info["iterations"] >= 1,
            f"bench3 iterates ({info['iterations']})")
    require(bool(torch.isfinite(rf).all()) and float(rf.min()) >= 0,
            "RF finite and non-negative")
    from skirt9_tpu_torch.utils.fits import read_fits
    with tempfile.TemporaryDirectory() as tmp:
        paths = sim.write_outputs(accs, "b3", tmp)
        sed = np.loadtxt(paths[0])
        cube, _ = read_fits(paths[1])
    require(cube.shape == (40, 64, 64) and bool(np.isfinite(cube).all())
            and cube.max() > 0, "frame FITS finite and lit")
    gates = bench3_gates(sim, sed, mean_intensity(sim, rf),
                         sim.dust_temperature(rf)[:, 0])
    events = sum(seg[3] for seg in stats["segments"])
    tabs = sim._sweep_tabs
    res = {"phase": "full_width_b3", "leaves": sim.grid.ncells,
           "fine_grid": list(tabs.n), "n_steps": tabs.n_steps,
           "packets": n_pk, "batch": sim.batch_size, "rf_bins": rf.shape[1],
           "packets_per_s": packets / dt, "seconds": dt,
           "iterations": info["iterations"], "L_dust": info["L_dust"],
           "L_abs_primary": info["L_abs_primary"],
           "L_dust_over_L_abs_primary": info["L_dust"] / info["L_abs_primary"],
           "segments": [{"name": n, "packets": p, "seconds": t, "events": e}
                        for n, p, t, e in stats["segments"]],
           "events": events, "launches": launches,
           "kernel_launches_per_event": sum(launches.values()) / events,
           **gates, "device": torch.cuda.get_device_name(0),
           "nvidia_smi": smi}
    emit(res)
    return sim, launches


def phase_breakdown_b3(torch) -> None:
    """Config 3 with one batch of 2^16 packets per segment under
    torch.profiler (host_per_event): device operations, stream syncs and
    host copies per event, busy and idle shares, the kernels that take the
    most device time."""
    prof = host_per_event(
        torch, config3("cuda", num_packets=B_B3),
        lambda s: s.run_with_dust_emission(verbose=False))
    emit({"phase": "breakdown_b3", "packets": B_B3, **prof})


# -------------------------- XL grids with lane groups, trees on voxel rasters

# bench2.ski at 256^3: its three LinMesh meshes at 256 bins
B2_256 = {'numBins="32"': 'numBins="256"'}


def config2x256(device, num_packets=1 << 20, batch_size=B_FULL,
                max_events=24):
    """bench2.ski (bench.py:79-105) through the port's `load_ski` with its
    three LinMesh numBins set to 256: config 2 on a 256^3 grid (16.8 M
    cells), past the resident sweep's ceiling, so on the XL contracts, its
    25-bin RF filled by 32 lane groups. Everything else as the ski file
    says; 2^20 packets in batches of 2^17 and 24 events, as config 2."""
    from skirt9_tpu_torch.config.ski import load_ski
    with tempfile.TemporaryDirectory() as tmp:
        return load_ski(edited_ski("bench2", tmp, B2_256),
                        num_packets=num_packets, batch_size=batch_size,
                        max_events=max_events, device=device)


def first_event_xl(torch, sim):
    """A configuration's first event as the XL path sees it: the first
    batch of the first source launched (stratified where the RF has several
    bins), its cross sections, the lanes sorted as the loop sorts them
    (`lane_order` with the lane groups) and kernel 6's prefix mode on them.
    Returns (pos, dir, lam, lum, alive, sig) sorted, the options, the lane
    groups and (record, prefix, total, lane range)."""
    from skirt9_tpu_torch.media import system as msys
    from skirt9_tpu_torch.ops import rng
    from skirt9_tpu_torch.sources import base as src
    from skirt9_tpu_torch.transport import sweep as sw
    from skirt9_tpu_torch.transport import sweepxl as xl
    strata = sim._strata_for(sim.sources[0], sim.options)
    opts, stabs = sim.options, sim._src_tabs[0]
    lanes = torch.arange(sim.batch_size, dtype=torch.int64, device=sim.device)
    if strata is not None:
        _, stabs, opts, lanes = sim._stratify(strata, stabs, opts,
                                              sim.num_packets)
    pkt = src.launch_batch(sim.sources[0], stabs, sim.grid,
                           rng.seed_key(sim.seed, sim.device), lanes,
                           sim.num_packets)
    tabs = sim._sweep_tabs
    n_groups = max(opts.rf_strata, 1)
    perm = xl.lane_order(tabs, pkt.pos, pkt.dir,
                         sw.dominant_axis(tabs, pkt.dir), n_groups)
    sig = msys.optics_at(sim.medium, pkt.lam).sigma_ext.T[:, perm]
    rays = (pkt.pos[perm], pkt.dir[perm], pkt.lam[perm], pkt.lum[perm],
            pkt.alive[perm], sig.contiguous())
    return rays, opts, n_groups, xl.sweep_dtau_prefix(
        tabs, rays[0], rays[1], rays[5], rays[4])


def check_grouped_xl(torch, what, sim, rays, pre, n_groups, bin_map,
                     nbins) -> dict:
    """Kernel 7's prefix mode with lane groups (and a cell map where the
    tables have one) against its plain version on one event: the RF
    within 1e-6 of its maximum (both sum in f64), s_int, icell and found
    identical. Then its time adding into an f64 accumulator, as the loop
    calls it, by CUDA events and device time; the device time of the form
    that sums into a fresh zero table and rounds it (what keeping a delta
    per event would cost); the plain version's time;
    the bound: the lane inputs, lum, tau_int and the mask, the prefix, the
    record at the crossed pairs of the depositing lanes and at the hit
    slab, the cell map there, the bin map, the RF entries this event
    reaches and the per-lane outputs."""
    from skirt9_tpu_torch.transport import sweep as sw
    from skirt9_tpu_torch.transport import sweepxl as xl
    tabs = sim._sweep_tabs
    pos, dirn, lam, lum, alive, _ = rays
    rec, tb, tot, lane = pre
    B = pos.shape[0]
    rs = np.random.default_rng(12)
    inv_sqrt = 1.0 / math.sqrt(sim.rf_scale)
    rfb = sim._rf_borders_dev
    lum_half = (lum * (alive & (lam >= rfb[0]) & (lam < rfb[-1]))) * inv_sqrt
    tau_int = torch.tensor(rs.uniform(size=B), dtype=torch.float32,
                           device=pos.device) * tot
    act_int = alive & (tot > 1e-6)
    args = (tabs, pos, dirn, act_int, rec, lum_half, tau_int, tb, inv_sqrt,
            lane)
    kw = dict(n_groups=n_groups, bin_map=bin_map, nbins=nbins)
    rf_k, *hit_k = xl.sweep_deposit_prefix(*args, **kw)
    rf_p, *hit_p = xl.sweep_deposit_prefix_plain(*args, **kw)
    torch.cuda.synchronize()
    require(int(hit_p[2].sum()) > B // 2, f"{what}: test rays interact")
    for a, b, name in zip(hit_k, hit_p, ("s_int", "icell", "found")):
        require(bool(torch.equal(a, b)), f"{what}: {name} identical")
    rows = nbins if bin_map is not None else n_groups
    require(rf_k.shape == rf_p.shape == (rows, tabs.rf_cells),
            f"{what}: RF rows {tuple(rf_k.shape)}")
    rf_err = float((rf_k - rf_p).abs().max())
    rf_max = float(rf_p.abs().max())
    require(rf_max > 0 and rf_err <= 1e-6 * rf_max,
            f"{what}: rf error {rf_err} <= 1e-6 * {rf_max}")
    rows_lit = int((rf_p.abs().sum(dim=1) > 0).sum())
    touched = int((rf_p != 0).sum())
    del rf_k, rf_p
    torch.cuda.empty_cache()
    g, smin, smax = lane
    dep = lum_half != 0
    n_act = active_slabs(tabs, pos[dep], dirn[dep], g[dep], smin[dep],
                         smax[dep])
    acc = torch.zeros((tabs.rf_cells, rows), dtype=torch.float64,
                      device=pos.device)
    kern = lambda: xl.sweep_deposit_prefix(*args, **kw, rf=acc)
    fresh = lambda: xl.sweep_deposit_prefix(*args, **kw)
    res = dict(max_abs_err=rf_err, rf_max=rf_max, err_of_max=rf_err / rf_max,
               n_groups=n_groups, rows=rows, rows_lit=rows_lit,
               rf_cells=tabs.rf_cells, voxels=tabs.nd.shape[0],
               cellmap=tabs.cellmap is not None, touched_entries=touched,
               crossed_pairs=n_act, ms=cuda_ms(kern),
               device_ms=device_ms(kern)["ours"],
               fresh_table_device_ms=device_ms(fresh)["all"],
               plain_ms=cuda_ms(lambda: xl.sweep_deposit_prefix_plain(
                   *args, **kw), reps=3),
               library_ms=None)
    del acc
    torch.cuda.empty_cache()
    res.update(bound(
        lane_bytes(B, 0) + 9 * B + tabs.nmax * B * 4 + n_act * 12
        + (n_act * 3 * 4 if tabs.cellmap is not None else 0) + 12 * B
        + 4 * n_groups + touched * 4 + 13 * B,
        B * (OPS_SLAB + 3 * OPS_SUB + 12) + 3 * tabs.nmax * B
        + n_act * (OPS_SLAB + 3 * (OPS_SUB + OPS_DEP))))
    return res


def phase_kernels_xl_grouped(torch) -> dict:
    """Kernel 7's grouped prefix mode on config 2's first event at 256^3
    (B = 131,072, 32 lane groups folded into the 25 RF rows by the
    launch's bin map) against its plain version (`check_grouped_xl`)."""
    from skirt9_tpu_torch.transport import sweepxl as xl
    sim = config2x256("cuda")
    require(isinstance(sim._sweep_tabs, xl.XLTables)
            and sim._sweep_tabs.n == (256,) * 3, "bench2 at 256^3 builds XL")
    rays, opts, n_groups, pre = first_event_xl(torch, sim)
    nbins = len(sim.rf_borders) - 1
    B = rays[0].shape[0]
    require(n_groups == 32 and nbins == 25 and B == B_FULL,
            f"config 2 at 256^3 runs 32 lane groups of a 2^17 batch into 25 "
            f"bins ({n_groups}, {nbins}, {B})")
    bin_map = torch.tensor(opts.rf_bin_map, dtype=torch.int32,
                           device=sim.device)
    res = check_grouped_xl(torch, "kernel 7, 32 groups at 256^3", sim, rays,
                           pre, n_groups, bin_map, nbins)
    require(res["rows_lit"] == nbins, f"kernel 7 fills the 25 bins' rows "
            f"({res['rows_lit']})")
    emit({"phase": "kernels_xl_grouped", "batch": B,
          "grid": list(sim._sweep_tabs.n),
          "sweepxl_deposit_prefix_grouped": res})
    return res


def phase_kernels_treexl(torch) -> dict:
    """On bench_config3ismxl's recipe at max_level 9 (a 512^3 voxel raster)
    with a one-bin RF, its first event: kernel 6's prefix mode at nmax =
    512 against its plain version (the record and lane range bit for bit,
    the prefix and total within 1e-6 of each lane's tau), and kernel 7's
    prefix mode with the cell map (`check_grouped_xl`)."""
    from skirt9_tpu_torch.transport import sweep as sw
    from skirt9_tpu_torch.transport import sweepxl as xl
    sim, t_tree, t_setup = config3ism("cuda", "config3ismxl9", store_rf=True)
    tabs = sim._sweep_tabs
    require(isinstance(tabs, xl.XLTables) and tabs.cellmap is not None
            and tabs.n == (512,) * 3, "the level-9 tree builds its 512^3 "
            "voxel raster")
    rays, _, _, pre = first_event_xl(torch, sim)
    pos, dirn, _, _, alive, sig = rays
    B = pos.shape[0]
    ev = (tabs, pos, dirn, sig, alive)
    rec_p, tb_p, tot_p, lane_p = xl.sweep_dtau_prefix_plain(*ev)
    rec_k, tb_k, tot_k, lane_k = pre
    torch.cuda.synchronize()
    require(bool((tot_p > 0).sum() > B // 2), "the tree's rays see dust")
    require(bool(torch.equal(rec_k, rec_p)), "kernel 6 record at 512^3")
    for a, b, name in zip(lane_k, lane_p, ("axis", "smin", "smax")):
        require(bool(torch.equal(a, b)), f"kernel 6 lane {name} at 512^3")
    rel = float(((tb_k - tb_p).abs() / tot_p.clamp_min(1e-30)).max())
    rel_t = float(((tot_k - tot_p).abs() / tot_p.clamp_min(1e-30)).max())
    require(max(rel, rel_t) <= 1e-6,
            f"kernel 6 prefix and total within 1e-6 of tau ({rel}, {rel_t})")
    del rec_p, tb_p
    g, smin, smax = lane_p
    n_act = active_slabs(tabs, pos, dirn, g, smin, smax)
    k6 = dict(max_abs_err=float((tot_k - tot_p).abs().max()),
              max_err_of_tau=max(rel, rel_t), active_pairs=n_act,
              ms=cuda_ms(lambda: xl.sweep_dtau_prefix(*ev)),
              device_ms=device_ms(lambda: xl.sweep_dtau_prefix(*ev))["ours"],
              plain_ms=cuda_ms(lambda: xl.sweep_dtau_prefix_plain(*ev),
                               reps=3), library_ms=None,
              **bound(ray_bytes(B, 1) + tabs.nd.numel() * 4
                      + 4 * tabs.nmax * B * 4 + 4 * B * 4,
                      B * OPS_LANE + n_act * (OPS_SLAB + 3 * (OPS_SUB + 2)
                                              + 4)))
    torch.cuda.empty_cache()
    k7 = check_grouped_xl(torch, "kernel 7 with the cell map", sim, rays,
                          pre, 1, None, 0)
    emit({"phase": "kernels_treexl", "batch": B, "leaves": sim.grid.ncells,
          "voxel_grid": list(tabs.n), "tree_build_s": t_tree,
          "setup_s": t_setup, "sweepxl_dtau_prefix_tree512": k6,
          "sweepxl_deposit_prefix_cellmap": k7})
    return {"sweepxl_dtau_prefix_tree512": k6,
            "sweepxl_deposit_prefix_cellmap": k7}


def phase_draw_for_draw_xl_b2(torch) -> None:
    """A reduced config 2 (80^3, an 8-bin RF in 8 lane groups, 16,384
    packets in batches of 8,192, 8 events, one self-absorption iteration)
    on the XL contracts, on the CPU (plain versions) and on the GPU
    (kernels 6-7 and detect), the same seed. Its primary segment draw for
    draw: the 8-bin RF and the SED kinds within 2e-5 of their maxima, the
    frame within 1e-3 of its brightest pixel. Then the dust emission run:
    iterations equal, L_dust within 1e-4, the RF's bins and the SED kinds
    with secondary light by their sums within 1e-3, their largest cell and
    bin differences reported. The secondary launch draws each packet's
    cell from a cdf over 512,000 cells built from the RF, whose f32 sums
    differ between the devices in their last bits, so a packet here and
    there starts in the neighbouring cell or emission bin: up to a few 1e-3
    of a cell or bin, so that the secondary light is held in sums."""
    from skirt9_tpu_torch.instruments import distant as dinst
    runs = {}
    for device in ("cpu", "cuda"):
        sim = config2(device, num_packets=16384, batch_size=8192, n=80,
                      n_rf=8, max_events=8, iterate_secondary=True,
                      max_iterations=1)
        require(type(sim._sweep_tabs).__name__ == "XLTables",
                "80^3 builds XLTables")
        prim = lambda: sim.run_primary(verbose=False)
        dust = lambda: sim.run_with_dust_emission(verbose=False)
        if device == "cuda":
            out, launches = drive(XL + DETECT, RESIDENT + ML + NOT_PATH, prim)
            out2, _ = drive(XL + DETECT, RESIDENT + ML + NOT_PATH, dust)
        else:
            out, out2 = prim(), dust()
        runs[device] = (sim, out, out2)
    (sc, (rfc, ac), (rtc, atc, ic)), (sg, (rfg, ag), (rtg, atg, ig)) = (
        runs["cpu"], runs["cuda"])
    rel = lambda g, c: float((g.double().cpu() - c.double()).abs().max()
                             / c.double().abs().max())
    rf_err = rel(rfg, rfc)
    require(rfc.shape[1] == 8 and rf_err <= 2e-5,
            f"draw-for-draw (XL config 2, primary) RF {rf_err} <= 2e-5")
    worst = 0.0
    for k in (dinst.KIND_TRANSPARENT, dinst.KIND_PRIMARY_DIRECT,
              dinst.KIND_PRIMARY_SCATTERED):
        require(float(ac[0]["sed"][k].abs().max()) > 0, f"SED kind {k} lit")
        worst = max(worst, rel(ag[0]["sed"][k], ac[0]["sed"][k]))
    require(worst <= 2e-5, f"draw-for-draw (XL config 2, primary) SEDs "
            f"{worst} <= 2e-5")
    fe = rel(ag[0]["frame"], ac[0]["frame"])
    require(fe <= 1e-3, f"draw-for-draw (XL config 2) frame {fe} <= 1e-3")
    e_l = abs(ig["L_dust"] / ic["L_dust"] - 1.0)
    require(ic["iterations"] == ig["iterations"] == 1 and e_l <= 1e-4,
            f"draw-for-draw (XL config 2) L_dust {e_l} <= 1e-4")
    sums = lambda a: a.double().cpu().sum(dim=0)
    bins_err = float(((sums(rtg) - sums(rtc)).abs() / sums(rtc)).max())
    require(bins_err <= 1e-3, f"draw-for-draw (XL config 2) RF bin sums "
            f"{bins_err} <= 1e-3")
    kinds = {}
    for k in range(atc[0]["sed"].shape[0]):
        c, g = atc[0]["sed"][k].double(), atg[0]["sed"][k].double().cpu()
        require(float(c.abs().max()) > 0, f"SED kind {k} lit")
        e_sum = abs(float(g.sum()) / float(c.sum()) - 1.0)
        kinds[dinst.KIND_NAMES[k]] = {"err_of_max": rel(g, c),
                                      "sum_rel_err": e_sum}
        require(e_sum <= 1e-3, f"draw-for-draw (XL config 2) "
                f"{dinst.KIND_NAMES[k]} SED sum {e_sum} <= 1e-3")
    emit({"phase": "draw_for_draw_xl_b2", "grid": [80] * 3, "packets": 16384,
          "batch": sc.batch_size, "rf_bins": rfc.shape[1],
          "primary_rf_err_of_max": rf_err, "primary_sed_err_of_max": worst,
          "frame_err": fe, "L_dust_rel_err": e_l,
          "rf_total_cell_err_of_max": rel(rtg, rtc),
          "rf_bin_sums_rel_err": bins_err, "sed_kinds": kinds,
          "launches": launches})


def coarse_mean(a: np.ndarray, n: int, m: int) -> np.ndarray:
    """(n^3, ...) per-cell values of an n^3 grid averaged over blocks of
    (n/m)^3 cells: the (m^3, ...) values of the m^3 grid over the same box
    (means of equal volumes)."""
    f = n // m
    tail = a.shape[1:]
    return a.reshape(m, f, m, f, m, f, *tail).mean(axis=(1, 3, 5)).reshape(
        m ** 3, *tail)


def phase_full_width_b2x256(torch, smi: str):
    """Config 2 at 256^3 (`config2x256`: bench2.ski through `load_ski` at
    2^20 packets in batches of 2^17, 24 events, the 25-bin RF and the
    40-bin emission grid), timed after a one-batch warm-up: kernels 6-7
    and detect launched, no resident or tree kernel; L_dust = L_abs_primary
    within 1e-4. Reported: packets/s as bench.py counts them, seconds and
    events per segment, the emission layer at 16.8 M cells timed apart
    (`emission_state_device`, and `prepare_device` with the luminosities'
    copy to the host), and bench2's golden ratios from the RF and the
    dust temperature averaged onto the goldens' 32^3 cells (SKIRT's, at
    32^3: a miss is listed, not required)."""
    from skirt9_tpu_torch.emission import equilibrium as eq
    from skirt9_tpu_torch.sources import secondary as sec
    from skirt9_tpu_torch.transport import sweepxl as xl
    t0 = time.perf_counter()
    sim = config2x256("cuda")
    t_setup = time.perf_counter() - t0
    require(isinstance(sim._sweep_tabs, xl.XLTables)
            and sim.grid.shape == (256,) * 3, "bench2 at 256^3 builds XL")
    n_pk = sim.num_packets
    sim.num_packets = sim.batch_size                    # warm-up: one batch
    sim.run_with_dust_emission(verbose=False)
    sim.num_packets = n_pk
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (rf, accs, info), launches = drive(
        XL + DETECT, RESIDENT + ML + NOT_PATH,
        lambda: sim.run_with_dust_emission(verbose=False))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    stats = dict(sim.last_stats)
    packets = n_pk * (1 + info["iterations"] + (1 if info["L_dust"] > 0 else 0))
    e_l = abs(info["L_dust"] / info["L_abs_primary"] - 1.0)
    require(info["iterations"] == 0 and e_l < 1e-4,
            f"L_dust / L_abs_primary - 1 = {e_l} (< 1e-4)")
    require(bool(torch.isfinite(rf).all()) and float(rf.min()) >= 0
            and rf.shape == (256 ** 3, 25), "RF finite, non-negative, "
            "(16.8 M, 25)")
    # the emission layer between the segments, timed apart
    etabs = sim._emission_tables()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    L_cell, _, eps = eq.emission_state_device(
        sim.medium, etabs, rf, sim.grid.volumes(), sim.rf_scale)
    torch.cuda.synchronize()
    t_state = time.perf_counter() - t0
    t0 = time.perf_counter()
    src2 = sec.prepare_device(sim.grid, L_cell, eps,
                              np.asarray(sim.ems_borders), sim.spatial_bias,
                              bounds_dev=sim._bounds_dev)
    torch.cuda.synchronize()
    t_prepare = time.perf_counter() - t0
    del L_cell, eps, src2
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        sed_cols = np.loadtxt(sim.write_outputs(accs, "b2x256", tmp)[0])
    J = coarse_mean(mean_intensity(sim, rf), 256, 32)
    T = coarse_mean(sim.dust_temperature(rf)[:, 0], 256, 32)
    gates = bench2_gates(sed_cols, J, np.diff(np.asarray(sim.rf_borders,
                                                         np.float64)), T,
                         strict=False)
    events = sum(seg[3] for seg in stats["segments"])
    seg_s = sum(seg[2] for seg in stats["segments"])
    emit({"phase": "full_width_b2x256", "grid": list(sim.grid.shape),
          "tables": "XLTables", "packets": n_pk, "batch": sim.batch_size,
          "rf_bins": rf.shape[1], "setup_s": t_setup,
          "packets_per_s": packets / dt, "seconds": dt,
          "iterations": info["iterations"], "L_dust": info["L_dust"],
          "L_abs_primary": info["L_abs_primary"], "L_dust_rel_err": e_l,
          "segments": [{"name": n, "packets": p, "seconds": t, "events": e}
                       for n, p, t, e in stats["segments"]],
          "between_segments_s": dt - seg_s,
          "emission_state_device_s": t_state,
          "prepare_device_s": t_prepare, "events": events,
          "launches": launches, "golden_at_32_cubed": gates,
          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    return sim, launches


def phase_rf_xl_b2x256(torch, sim) -> None:
    """The primary segment of config 2 at 256^3 on the XL contracts
    against the same seed on the resident sweep (kernels 1-2) put in place:
    RF totals within 1e-4, the largest per-cell difference reported."""
    from skirt9_tpu_torch.transport import sweep as sw
    rf, _ = sim.run_primary(verbose=False)
    tot_x = float(rf.double().sum())
    res = config2x256("cuda")
    res._sweep_tabs = sw.build_tables(res.grid, res.medium)
    (rf_r, _), launches = drive(("sweep_dtau_prefix", "sweep_deposit_prefix"),
                                XL, lambda: res.run_primary(verbose=False))
    tot_r = float(rf_r.double().sum())
    e = abs(tot_x - tot_r) / tot_r
    require(e <= 1e-4, f"XL vs resident RF total at 256^3 {e} <= 1e-4")
    cell = float((rf.double() - rf_r.double()).abs().max()
                 / rf_r.double().abs().max())
    emit({"phase": "rf_xl_b2x256", "packets": sim.num_packets,
          "rf_total_rel_err": e, "rf_cell_err_of_max": cell,
          "bins_total_rel_err": [float(v) for v in (
              (rf.double().sum(0) - rf_r.double().sum(0)).abs()
              / rf_r.double().sum(0).clamp_min(1e-300)).cpu()],
          "resident_launches": launches})


def phase_treexl_vs_ml(torch) -> dict:
    """bench_config3ismxl's level-8 tree (a 256^3 fine raster, which the
    port runs on the multi-level sweep) on its voxel raster through the
    XL contracts (the tables put in place) against the multi-level sweep,
    the same seed, with a one-bin RF: SEDs and RF totals within 1e-3, the
    per-leaf RF difference reported."""
    from skirt9_tpu_torch.transport import sweepxl as xl
    runs = {}
    for engine in ("ml", "xl"):
        sim = config3ism("cuda", "config3ismxl", store_rf=True,
                         num_packets=B_ML)[0]
        require(type(sim._sweep_tabs).__name__ == "MLTables",
                "config3ismxl builds MLTables")
        if engine == "xl":
            sim._sweep_tabs = xl.build_tree_tables(sim.grid, sim.medium)
            out, launches = drive(XL + DETECT, ML + RESIDENT + NOT_PATH,
                                  lambda: sim.run_primary(verbose=False))
        else:
            out, _ = drive(ML + DETECT, XL + RESIDENT + NOT_PATH,
                           lambda: sim.run_primary(verbose=False))
        runs[engine] = (sim, *out)
    (sm, rfm, am), (sx, rfx, ax) = runs["ml"], runs["xl"]
    sed_m, sed_x = _sed(sm, am), _sed(sx, ax)
    worst = 0.0
    for kind in ("transparent", "primarydirect", "primaryscattered",
                 "total"):
        require(sed_m[kind][0] > 0, f"{kind} SED positive")
        worst = max(worst, abs(sed_x[kind][0] - sed_m[kind][0])
                    / sed_m[kind][0])
    require(worst <= 1e-3, f"tree XL vs multi-level sweep SEDs {worst}")
    tm, tx = float(rfm.double().sum()), float(rfx.double().sum())
    e_rf = abs(tx - tm) / tm
    require(tm > 0 and e_rf <= 1e-3, f"tree XL vs multi-level RF total {e_rf}")
    res = {"phase": "treexl_vs_ml", "leaves": sm.grid.ncells,
           "fine_grid": list(sx._sweep_tabs.n), "packets": sm.num_packets,
           "sed_rel_err": worst, "rf_total_rel_err": e_rf,
           "rf_cell_err_of_max": float((rfx - rfm).abs().max()
                                       / rfm.abs().max()),
           "launches_xl": launches}
    emit(res)
    return res


def main() -> int:
    import torch
    from skirt9_tpu_torch import device  # fails outside the repository
    try:
        device.require_cuda()
    except RuntimeError as err:
        print(f"chip_smoke: {err}", file=sys.stderr)
        return 2
    smi = phase_env(torch)
    phase_build()
    kern = phase_kernels(torch)
    kern.update(phase_kernels_xl(torch))
    torch.cuda.empty_cache()
    kern.update(phase_kernels_probe(torch))
    kern_b2 = phase_kernels_b2(torch)
    torch.cuda.empty_cache()
    phase_draw_for_draw(torch)
    phase_draw_for_draw(torch, "draw_for_draw_xl", n=80, tables="XLTables")
    sim, stats, launches = phase_full_width(torch, smi)
    phase_breakdown(torch, sim, stats)
    del sim
    _, _, launches_xl = phase_full_width(
        torch, smi, "full_width_xl", "XLTables", XL + DETECT,
        RESIDENT + ML + NOT_PATH, num_packets=B_FULL, n=256)
    launches_rf = phase_rf_xl(torch)
    torch.cuda.empty_cache()
    kern.update(phase_kernels_ml(torch))
    torch.cuda.empty_cache()
    phase_draw_for_draw_ml(torch)
    sim, launches_ml = phase_full_width_ml(torch, smi)
    rate_ml = sim.last_rate
    phase_breakdown_ml(torch, sim)
    del sim
    phase_full_width_ml(torch, smi, "full_width_ml_large", "config3ismxl")
    sim, launches_rf_ml = phase_full_width_ml(torch, smi, "rf_ml",
                                              store_rf=True)
    emit({"phase": "rf_ml_vs_full_width_ml", "packets_per_s_rf":
          sim.last_rate, "packets_per_s": rate_ml,
          "ratio": sim.last_rate / rate_ml})
    del sim
    torch.cuda.empty_cache()
    phase_draw_for_draw_b2(torch)
    sim, launches_b2 = phase_full_width_b2(torch, smi)
    del sim
    phase_breakdown_b2(torch)
    torch.cuda.empty_cache()
    kern_b3 = phase_kernels_b3(torch)
    torch.cuda.empty_cache()
    phase_draw_for_draw_b3(torch)
    sim, launches_b3 = phase_full_width_b3(torch, smi)
    del sim
    phase_breakdown_b3(torch)
    torch.cuda.empty_cache()
    launches_1h = phase_refill_b1h(torch, smi)
    torch.cuda.empty_cache()
    phase_cli(torch, smi)
    torch.cuda.empty_cache()
    kern.update(sweepxl_deposit_prefix_grouped=phase_kernels_xl_grouped(torch))
    torch.cuda.empty_cache()
    kern.update(phase_kernels_treexl(torch))
    torch.cuda.empty_cache()
    phase_draw_for_draw_xl_b2(torch)
    sim, launches_b2x256 = phase_full_width_b2x256(torch, smi)
    torch.cuda.empty_cache()
    phase_rf_xl_b2x256(torch, sim)
    del sim
    torch.cuda.empty_cache()
    _, launches_treexl = phase_full_width_ml(torch, smi, "full_width_treexl",
                                             "config3ismxl9")
    torch.cuda.empty_cache()
    _, launches_rf_treexl = phase_full_width_ml(torch, smi, "rf_treexl",
                                                "config3ismxl9", store_rf=True)
    torch.cuda.empty_cache()
    phase_treexl_vs_ml(torch)
    rows = []
    k1 = "skirt9_tpu/transport/sweep.py:238"
    k6 = "skirt9_tpu/transport/sweepxl.py:392"
    k7 = "skirt9_tpu/transport/sweepxl.py:493"
    k4 = "skirt9_tpu/transport/mlsweep.py:635"
    k1_modes = ("sweep_dtau", "sweep_tau_total", "sweep_dtau_prefix")
    probe_k3 = {"scatter_add": kern["probe_scatter_smem"]["kernel3_launches"]}
    for name, src, ref, path, counts in (
            ("sweep_dtau", "sweep_dtau.cu", k1, "full_width", launches),
            ("sweep_tau_total", "sweep_dtau.cu", k1, "full_width", launches),
            ("sweep_dtau_prefix", "sweep_dtau.cu", k1, "full_width",
             launches),
            ("sweep_deposit", "sweep_deposit.cu",
             "skirt9_tpu/transport/sweep.py:275", "full_width", launches),
            ("sweep_deposit_prefix", "sweep_deposit.cu",
             "skirt9_tpu/transport/sweep.py:275", "full_width", launches),
            ("detect", "detect.cu", "skirt9_tpu/ops/scatteradd.py:32 (its "
             "seven calls per skirt9_tpu/instruments/distant.py:157 detect)",
             "full_width", launches),
            ("scatter_add", "scatter_add.cu", "skirt9_tpu/ops/scatteradd.py:32",
             "kernels_probe (the gather probe's entry point)", probe_k3),
            ("sweepxl_dtau", "sweepxl_dtau.cu", k6, "full_width_xl",
             launches_xl),
            ("sweepxl_dtau_summed", "sweepxl_dtau.cu", k6, "full_width_xl",
             launches_xl),
            ("sweepxl_tau_total", "sweepxl_dtau.cu", k6, "full_width_xl",
             launches_xl),
            ("sweepxl_dtau_prefix", "sweepxl_dtau.cu", k6, "full_width_xl",
             launches_xl),
            ("sweepxl_deposit", "sweepxl_deposit.cu", k7, "rf_xl",
             launches_rf),
            ("sweepxl_deposit_prefix", "sweepxl_deposit.cu", k7, "rf_xl",
             launches_rf),
            ("mlsweep_dtau", "mlsweep_dtau.cu", k4, "full_width_ml",
             launches_ml),
            ("mlsweep_tau_total", "mlsweep_dtau.cu", k4, "full_width_ml",
             launches_ml),
            ("mlsweep_dtau_prefix", "mlsweep_dtau.cu", k4, "full_width_ml",
             launches_ml),
            ("mlsweep_deposit", "mlsweep_deposit.cu",
             "skirt9_tpu/transport/mlsweep.py:719", "rf_ml",
             launches_rf_ml)):
        k = kern[name]
        # kernel 6's summed form counts under its record form's name
        counter = "sweepxl_dtau" if name == "sweepxl_dtau_summed" else name
        row = {"name": name, "route": "cuda",
               "source": f"skirt9_tpu_torch/csrc/{src}", "replaces": ref,
               "path": path, "launches": counts[counter],
               **{key: k[key] for key in (
                   "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                   "library_ms")}}
        for key in ("device_ms", "library_device_ms", "unfused_ms",
                    "unfused_device_ms", "seven_call_ms",
                    "seven_call_device_ms", "seven_call_device_launches",
                    "bound_full_record_ms", "device_ms_no_rf",
                    "max_err_of_tau", "ms_unsorted", "prefix_ms_unsorted",
                    "kernel1_ms_sorted", "kernel1_ms_unsorted", "variants",
                    "device_ms_all", "ms_no_rf", "bound_no_rf_ms",
                    "unfused_no_rf_ms", "resolve_interaction_device_ms",
                    "resolve_interaction_launches", "ms_no_leaf_ids",
                    "device_ms_no_leaf_ids", "bound_no_leaf_ids_ms",
                    "resolve_interaction_lane_device_ms"):
            if key in k:
                row[key] = k[key]
        if name == "sweep_dtau":
            # one CUDA kernel in three output modes: its launches on the
            # path are those of the two modes the path takes
            row["launches"] = sum(counts[m] for m in k1_modes)
            row["launches_by_mode"] = {m: counts[m] for m in k1_modes}
        if name.startswith("sweepxl_deposit"):
            # launched on the XL path without an RF too
            row["launches_full_width_xl"] = launches_xl[name]
        if "large_tree" in k:
            row["large_tree"] = {key: v for key, v in k["large_tree"].items()
                                 if key in (
                "max_abs_err", "max_err_of_tau", "ms", "device_ms",
                "plain_ms", "unfused_device_ms", "bound_ms", "bound_by",
                "leaves", "shared_table", "resolve_interaction_device_ms",
                "resolve_interaction_lane_device_ms", "variants")}
        if name in k1_modes + RESIDENT + DETECT + ("sweep_deposit",
                                                   "scatter_add"):
            # the config-2 path (full_width_b2) and, for kernels 2, 3 and
            # detect, their config-2 shapes (kernels_b2)
            row["launches_config2"] = (sum(launches_b2[m] for m in k1_modes)
                                       if name == "sweep_dtau"
                                       else launches_b2[name])
            if name in kern_b2:
                row["config2"] = {key: kern_b2[name][key] for key in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "device_ms", "seven_call_ms",
                    "seven_call_device_ms") if key in kern_b2[name]}
        if name in ("mlsweep_dtau",) + ML + DETECT:
            # the config-3 path (full_width_b3) and, for kernel 5, its
            # grouped mode at config 3's shapes (kernels_b3)
            row["launches_config3"] = launches_b3[name]
            if name == "mlsweep_deposit":
                row["config3"] = {key: kern_b3[key] for key in (
                    "max_abs_err", "err_of_max", "ms", "device_ms",
                    "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "n_groups", "rows", "leaves", "shared_table",
                    "live_share")}
        if name in k1_modes + RESIDENT + DETECT + ("sweep_deposit",):
            # config 1h's refill path (refill_b1h)
            row["launches_config1h"] = (sum(launches_1h[m] for m in k1_modes)
                                        if name == "sweep_dtau"
                                        else launches_1h[name])
        rows.append(row)
    # kernels 6-7 on this slice's paths: kernel 7's grouped mode (config 2
    # at 256^3), with the cell map and kernel 6 at a 512^3 tree raster (the
    # level-9 tree)
    for name, counter, ref, path, counts in (
            ("sweepxl_deposit_prefix_grouped", "sweepxl_deposit_prefix", k7,
             "full_width_b2x256", launches_b2x256),
            ("sweepxl_deposit_prefix_cellmap", "sweepxl_deposit_prefix", k7,
             "rf_treexl", launches_rf_treexl),
            ("sweepxl_dtau_prefix_tree512", "sweepxl_dtau_prefix", k6,
             "full_width_treexl", launches_treexl)):
        k = kern[name]
        src = "sweepxl_dtau.cu" if counter == "sweepxl_dtau_prefix" else \
            "sweepxl_deposit.cu"
        rows.append({"name": name, "route": "cuda",
                     "source": f"skirt9_tpu_torch/csrc/{src}",
                     "replaces": ref, "path": path,
                     "launches": counts[counter],
                     **{key: k[key] for key in (
                         "max_abs_err", "ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms", "device_ms",
                         "fresh_table_device_ms", "err_of_max",
                         "max_err_of_tau", "n_groups", "rows", "rf_cells",
                         "voxels", "touched_entries", "crossed_pairs",
                         "active_pairs") if key in k}})
    for name, src, ref in (
            ("probe_gather_smem", "probe_gather.cu",
             "tools/_pallas_probe.py:12 (gather_kernel) and :34 "
             "(take_kernel)"),
            ("probe_gather_l2", "probe_gather.cu",
             "tools/_pallas_probe.py:12 (gather_kernel)"),
            ("probe_scatter_smem", "probe_gather.cu",
             "tools/_pallas_probe.py:56 (scat_kernel)"),
            ("row_lookup_gather", "row_lookup.cu",
             "tools/bench_sublane_gather.py:26 (kern_gather)"),
            ("row_lookup_select", "row_lookup.cu",
             "tools/bench_sublane_gather.py:38 (kern_select)")):
        k = kern[name]
        rows.append({"name": name, "route": "cuda",
                     "source": f"skirt9_tpu_torch/csrc/{src}", "replaces": ref,
                     "path": "kernels_probe (the tool's entry point)",
                     **{key: k[key] for key in (
                         "launches", "max_abs_err", "ms", "plain_ms",
                         "bound_ms", "bound_by", "library_ms", "device_ms",
                         "library_device_ms", "floor_ms", "variants") if key in k}})
    emit({"kernels": rows})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
