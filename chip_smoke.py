#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (skirt9_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Drives config 1 of bench.py (point source, uniform dust sphere, forced
scattering, HG peel-off to one SED + 64x64 frame instrument) through the
port's Python API on two paths: the 32^3 grid of bench.py config 1 (resident
sweep, kernels 1-3) and the 256^3 grid of bench.py `bench_config1x256`
(large-grid XL sweep, kernels 6-7 and 3). Each hand-written CUDA kernel is
checked against its plain PyTorch version. Phases, one JSON line each:

  env               torch / CUDA / nvcc versions, the card, its power limit
  build             nvcc build of skirt9_tpu_torch/csrc/*.cu, one process per
                    source, all started together (cached by hash)
  kernels           kernels 1-3 vs their plain versions at config-1 shapes
                    (B = 131072, 32^3, C = 1; scatter sizes 1 and 4096), timed
  kernels_xl        kernels 6-7 vs their plain versions at 256^3, B = 131072,
                    C = 1, lanes sorted as the path sorts them: tau within
                    1e-5 relative, the summed form within 1e-6 of the
                    sub-step sum, RF within 1e-4 of its maximum; timed, with
                    kernel 6 on unsorted lanes and kernel 1 on the same rays
  draw_for_draw     16,384 packets on the CPU (plain versions) and on the GPU
                    (kernels), same seed: SEDs within 1e-4, frame within 1e-3
                    of its brightest pixel; again with a one-bin RF, totals
                    1e-4
  draw_for_draw_xl  the same at 80^3, where the port picks the XL contracts
  full_width        config 1 at 2^20 packets in batches of 2^17, timed after a
                    warm-up: kernels 1-3 launched and 6-7 not, accumulators
                    finite, the transparent SED analytic within 1e-5,
                    direct/transparent = exp(-tau) within 1e-3, SED relative
                    error R < 0.01
  breakdown         host-sync and RNG shares of the timed run
  full_width_xl     bench_config1x256 (256^3, 2^17 packets in one batch, 24
                    events, no RF), timed after a warm-up: the XL tables,
                    kernels 6 and 3 launched and 1-2 not, the same gates
  rf_xl             the same with a one-bin RF: kernel 7 launched, the RF
                    finite and positive, its total within 1e-4 of the same
                    seed's run on the resident sweep (kernels 1-2)

Each path is driven with the launch counts set to 0 just before it and read
just after; it names the kernels it must launch and those it must not. Then
the kernel summary line, the nvidia-smi name/power line, and last
{"ok": true, "device": {...}}. Any failed check raises and the script exits
non-zero without that line; so does a machine without CUDA.
"""

from __future__ import annotations

import json
import math
import platform
import subprocess
import sys
import tempfile
import time

import numpy as np

PC = 3.0857e16
B_FULL = 1 << 17


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
            store_rf=False, npix=64, max_events=24):
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
    opts = TransportOptions(max_steps=grid.max_steps(), max_events=max_events,
                            store_rf=store_rf)
    return Simulation(grid=grid, medium=med,
                      sources=[PointSource(luminosity=1.0, lam0=0.55e-6)],
                      instruments=[inst], options=opts,
                      rf_borders=(np.array([0.5e-6, 0.6e-6]) if store_rf
                                  else None),
                      num_packets=num_packets, batch_size=batch_size, seed=0,
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

    # kernel 1: event march (own dominant axes) and peel-off march (+z hint)
    g, smin, smax, sg = sw._prep(tabs, pos, dirn, sig, active)
    a_k = sw._dtau_cuda(tabs, pos, dirn, g, smin, smax, sg)
    a_p = sw._dtau_plain(tabs, pos, dirn, g, smin, smax, sg)
    kz = torch.zeros_like(dirn)
    kz[:, 2] = 1.0
    gz, sminz, smaxz, _ = sw._prep(tabs, pos, kz, sig, active)
    gz = torch.full_like(gz, 2)
    z_k = sw._dtau_cuda(tabs, pos, kz, gz, sminz, smaxz, sg)
    z_p = sw._dtau_plain(tabs, pos, kz, gz, sminz, smaxz, sg)
    torch.cuda.synchronize()
    rel1 = 0.0
    for k_, p_ in ((a_k, a_p), (z_k, z_p)):
        tk, tp = k_.sum(0), p_.sum(0)
        require(bool((tp > 0).sum() > B // 2), "kernel 1 test rays see dust")
        rel1 = max(rel1, float(((tk - tp).abs()
                                / tp.clamp_min(1e-30))[tp > 0].max()))
    err1 = max(float((a_k - a_p).abs().max()), float((z_k - z_p).abs().max()))
    require(rel1 <= 1e-5, f"kernel 1 max relative tau error {rel1} <= 1e-5")
    ms1 = cuda_ms(lambda: sw._dtau_cuda(tabs, pos, dirn, g, smin, smax, sg))
    pms1 = cuda_ms(lambda: sw._dtau_plain(tabs, pos, dirn, g, smin, smax, sg),
                   reps=5)
    out["sweep_dtau"] = dict(max_abs_err=err1, max_rel_tau_err=rel1, ms=ms1,
                             plain_ms=pms1)

    # kernel 2: deposits with nonzero scale, interaction at a random depth
    grp = sw.dominant_axis(tabs, dirn)
    dmaj = dirn.gather(1, grp[:, None])[:, 0]
    tb, tot = sw.slab_prefix(a_p, dmaj > 0)
    lum = t32(rs.uniform(0.5, 2.0, B))
    scale = lum[None, :] * torch.exp(-tb)
    rel = (t32(rs.uniform(size=B)) * tot)[None, :] - tb
    dep_args = (tabs, pos, dirn, g, smin, smax, sg, scale, rel, 1)
    rf_k, s_k, c_k, f_k = sw._deposit_cuda(*dep_args)
    rf_p, s_p, c_p, f_p = sw._deposit_plain(*dep_args)
    torch.cuda.synchronize()
    agree = float((f_k == f_p).float().mean())
    both = f_k & f_p
    require(int(f_p.sum()) > B // 2, "kernel 2 test rays interact")
    require(agree >= 0.999, f"kernel 2 found agreement {agree} >= 0.999")
    require(bool(torch.equal(c_k[both], c_p[both])),
            "kernel 2 icell identical where both found")
    ds_err = float((s_k[both] - s_p[both]).abs().max())
    require(ds_err <= 1e-5 * h, f"kernel 2 s_int error {ds_err} <= 1e-5 h")
    rf_err = float((rf_k - rf_p).abs().max())
    rf_max = float(rf_p.abs().max())
    require(rf_max > 0 and rf_err <= 1e-4 * rf_max,
            f"kernel 2 rf error {rf_err} <= 1e-4 * {rf_max}")
    ms2 = cuda_ms(lambda: sw._deposit_cuda(*dep_args))
    pms2 = cuda_ms(lambda: sw._deposit_plain(*dep_args), reps=5)
    out["sweep_deposit"] = dict(max_abs_err=rf_err, rf_max=rf_max,
                                found_agreement=agree, s_int_err=ds_err,
                                ms=ms2, plain_ms=pms2)

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
        times[size] = (cuda_ms(lambda: sca.scatter_add(idx, val, size)),
                       cuda_ms(lambda: sca.scatter_add_plain(idx, val, size)))
    out["scatter_add"] = dict(max_abs_err=err3, ms=times[4096][0],
                              plain_ms=times[4096][1], ms_size1=times[1][0],
                              plain_ms_size1=times[1][1])
    emit({"phase": "kernels", "batch": B, "grid": list(tabs.n), **out})
    return out


def phase_kernels_xl(torch) -> dict:
    """Kernels 6 and 7 against their plain versions at bench_config1x256's
    shapes, on lanes sorted as the path sorts them; then timings, with
    kernel 6 on unsorted lanes and kernel 1 on the same rays."""
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
    g, smin, smax, sg = sw._prep(tabs, pos, dirn, sig, active)
    # peel-off toward +z: entry-slab order, one shared slab axis
    prm_z = xl.entry_order(tabs, pos_u, 2)
    pz = pos_u[prm_z]
    kz = torch.zeros_like(dirn)
    kz[:, 2] = 1.0
    gz, sminz, smaxz, _ = sw._prep(tabs, pz, kz, sig, act_u[prm_z])
    gz = torch.full_like(gz, 2)
    ev = (tabs, pos, dirn, g, smin, smax, sg)
    pl = (tabs, pz, kz, gz, sminz, smaxz, sg)
    out = {}

    # kernel 6: the event record, the peel-off sums, the summed form
    sub_k = xl._dtau_cuda(*ev, True)
    sub_p = xl._dtau_plain(*ev, True)
    z_k = xl._dtau_cuda(*pl, False)
    z_p = xl._dtau_plain(*pl, False)
    sum_k = xl._dtau_cuda(*ev, False)
    torch.cuda.synchronize()
    rel6 = 0.0
    for tk, tp in ((sub_k.sum(dim=(0, 1)), sub_p.sum(dim=(0, 1))),
                   (z_k.sum(0), z_p.sum(0))):
        require(bool((tp > 0).sum() > B // 2), "kernel 6 test rays see dust")
        rel6 = max(rel6, float(((tk - tp).abs()
                                / tp.clamp_min(1e-30))[tp > 0].max()))
    require(rel6 <= 1e-5, f"kernel 6 max relative tau error {rel6} <= 1e-5")
    sum_err = float((sum_k - sub_k.sum(dim=1)).abs().max())
    sum_max = float(sum_k.abs().max())
    require(sum_err <= 1e-6 * sum_max,
            f"kernel 6 summed form {sum_err} <= 1e-6 * {sum_max}")
    err6 = max(float((sub_k - sub_p).abs().max()),
               float((z_k - z_p).abs().max()))
    del z_k, z_p, sum_k

    # kernel 7: deposits from the record with a nonzero scale
    tb, _ = sw.slab_prefix(sub_p.sum(dim=1),
                           dirn.gather(1, g.long()[:, None])[:, 0] > 0)
    lum = torch.tensor(rs.uniform(0.5, 2.0, B), dtype=torch.float32,
                       device=dirn.device)
    scale = lum[None, :] * torch.exp(-tb)
    del tb
    dep = (tabs, pos, dirn, g, smin, smax, sub_p, scale, 1)
    rf_k = xl._deposit_cuda(*dep)
    rf_p = xl._deposit_plain(*dep)
    torch.cuda.synchronize()
    rf_err = float((rf_k - rf_p).abs().max())
    rf_max = float(rf_p.abs().max())
    require(rf_max > 0 and rf_err <= 1e-4 * rf_max,
            f"kernel 7 rf error {rf_err} <= 1e-4 * {rf_max}")
    del rf_k, rf_p

    # timings: plain versions first, then free their tensors
    pms6 = cuda_ms(lambda: xl._dtau_plain(*ev, True), reps=3)
    pms7 = cuda_ms(lambda: xl._deposit_plain(*dep), reps=3)
    del sub_p
    sub = sub_k
    dep = (tabs, pos, dirn, g, smin, smax, sub, scale, 1)
    torch.cuda.empty_cache()
    ms6 = cuda_ms(lambda: xl._dtau_cuda(*ev, True))
    ms6_sum = cuda_ms(lambda: xl._dtau_cuda(*ev, False))
    ms6_peel = cuda_ms(lambda: xl._dtau_cuda(*pl, False))
    gu, sminu, smaxu, _ = sw._prep(tabs, pos_u, dir_u, sig, act_u)
    ev_u = (tabs, pos_u, dir_u, gu, sminu, smaxu, sg)
    ms6_unsorted = cuda_ms(lambda: xl._dtau_cuda(*ev_u, True))
    ms1_sorted = cuda_ms(lambda: sw._dtau_cuda(*ev))
    ms1_unsorted = cuda_ms(lambda: sw._dtau_cuda(*ev_u))
    ms7 = cuda_ms(lambda: xl._deposit_cuda(*dep))
    out["sweepxl_dtau"] = dict(
        max_abs_err=err6, max_rel_tau_err=rel6, summed_err=sum_err, ms=ms6,
        plain_ms=pms6, ms_summed=ms6_sum, ms_peel_z=ms6_peel,
        ms_unsorted=ms6_unsorted, kernel1_ms_sorted=ms1_sorted,
        kernel1_ms_unsorted=ms1_unsorted)
    out["sweepxl_deposit"] = dict(max_abs_err=rf_err, rf_max=rf_max, ms=ms7,
                                  plain_ms=pms7)
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


RESIDENT = ("sweep_dtau", "sweep_deposit")
XL = ("sweepxl_dtau", "sweepxl_deposit")


def phase_full_width(torch, smi: str, phase="full_width", tables="SweepTables",
                     must=RESIDENT + ("scatter_add",), must_not=XL, **kw):
    """A config-1 path at full width, timed after one warm-up run, with the
    correctness gates. kw: config1's arguments (grid size, packets)."""
    from skirt9_tpu.utils.fits import read_fits
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


def phase_breakdown(torch, sim, stats) -> None:
    """Shares of the timed run spent blocked in the early-exit host sync and
    in threefry RNG (measured alone at the same width, times the draws the
    run made)."""
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
    emit({"phase": "breakdown", "seconds": stats["seconds"],
          "events": stats["events"], "sync_wait_s": stats["sync_s"],
          "sync_share": stats["sync_s"] / stats["seconds"],
          "rng_ms_per_event": ev_ms, "rng_ms_per_launch": launch_ms,
          "rng_s": rng_s, "rng_share": rng_s / stats["seconds"]})


def phase_rf_xl(torch) -> dict:
    """bench_config1x256 with a one-bin RF on the XL path (kernel 7), against
    the same seed on the resident sweep (kernels 1-2) put in place."""
    from skirt9_tpu_torch.transport import sweep as sw
    kw = dict(num_packets=B_FULL, n=256, store_rf=True)
    sim = config1("cuda", **kw)
    require(type(sim._sweep_tabs).__name__ == "XLTables", "256^3 builds XL")
    (rf, accs), launches = drive(XL + ("scatter_add",), RESIDENT,
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
    phase_draw_for_draw(torch)
    phase_draw_for_draw(torch, "draw_for_draw_xl", n=80, tables="XLTables")
    sim, stats, launches = phase_full_width(torch, smi)
    phase_breakdown(torch, sim, stats)
    del sim
    _, _, launches_xl = phase_full_width(
        torch, smi, "full_width_xl", "XLTables",
        ("sweepxl_dtau", "scatter_add"), RESIDENT + ("sweepxl_deposit",),
        num_packets=B_FULL, n=256)
    launches_rf = phase_rf_xl(torch)
    rows = []
    for name, src, ref, path, counts in (
            ("sweep_dtau", "sweep_dtau.cu", "skirt9_tpu/transport/sweep.py:238",
             "full_width", launches),
            ("sweep_deposit", "sweep_deposit.cu",
             "skirt9_tpu/transport/sweep.py:275", "full_width", launches),
            ("scatter_add", "scatter_add.cu", "skirt9_tpu/ops/scatteradd.py:32",
             "full_width", launches),
            ("sweepxl_dtau", "sweepxl_dtau.cu",
             "skirt9_tpu/transport/sweepxl.py:392", "full_width_xl",
             launches_xl),
            ("sweepxl_deposit", "sweepxl_deposit.cu",
             "skirt9_tpu/transport/sweepxl.py:493", "rf_xl", launches_rf)):
        k = kern[name]
        rows.append({"name": name, "route": "cuda",
                     "source": f"skirt9_tpu_torch/csrc/{src}", "replaces": ref,
                     "path": path, "launches": counts[name],
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"]})
    emit({"kernels": rows})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
