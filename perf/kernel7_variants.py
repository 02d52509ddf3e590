"""Times of kernel 7's variants that the package does not ship, beside
the package's kernel (`skirt9_tpu_torch/csrc/sweepxl_deposit.cu`), at
bench_config1x256's shapes (256^3, B = 131072, the sphere rays of
`chip_smoke.py`'s kernels_xl phase, sorted by `sweepxl.lane_order` as the
event loop sorts them):

- the package's kernel in its prefix mode, with an RF and without, at runs
  of 4, 8, 16 and 32 slabs per thread (`sweepxl.DEPOSIT_RUN` is the one it
  ships);
- kernel 7 in its f32 design, one float atomic per contribution
  (`kernel7_variants.cu` `atomics_launch`; the package adds f64), and
  with the deposits of every warp summed per warp by cell before the
  atomic (`warp_sums_launch`), in both modes;
- the prefix mode with an RF split (`split_launch`): pass A in the f32 design,
  without its atomics, without its record reads, the hit search and lane
  set-up alone, and pass B alone;
- the first design of kernel 7 (`old_launch`, mode 0) beside the
  package's mode 0.

Each variant's interaction must equal the package kernel's bit for bit and
its RF lie within 1e-4 of the package's maximum. The variants are built
into their own library under build/perf/ with the package's nvcc flags.
Run from the repository root on a machine with a CUDA device:

    python3 perf/kernel7_variants.py

It prints one JSON line; `chip_smoke.py`'s kernels_xl phase calls
`measure` on its own inputs.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perf import kernel6_variants as k6v  # noqa: E402
from skirt9_tpu_torch.kernels import build as kb  # noqa: E402

SOURCE = os.path.join(HERE, "kernel7_variants.cu")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ENTRIES = {
    # pos, dir, axis, smin, smax, dsub, scale or tb, lum, tau_int, active,
    # rf, hitrun, s_int, icell, found, B, nx, ny, nz, nmax, n_groups, run,
    # mode, lox, loy, loz, hx, hy, hz, inv_sqrt, stream: the package's
    # arguments without the bin map, the cell map and the row count
    "atomics_launch": [_P] * 15 + [_I] * 8 + [_F] * 7 + [_P],
    "warp_sums_launch": [_P] * 15 + [_I] * 8 + [_F] * 7 + [_P],
    # pos, dir, axis, smin, smax, dsub, scale, rf, B, nx, ny, nz, nmax,
    # n_groups, lox, loy, loz, hx, hy, hz, stream
    "old_launch": [_P] * 8 + [_I] * 6 + [_F] * 6 + [_P],
    # variant, then sweepxl_deposit_launch's arguments without n_groups and
    # mode
    "split_launch": [_I] + [_P] * 15 + [_I] * 6 + [_F] * 7 + [_P],
}
SPLIT = ("full", "no_atomics", "no_record", "search_lane", "resolve")
RUNS = (4, 8, 16, 32)


def measure(torch, tabs, args, cuda_ms, device_ms) -> dict:
    """Each variant's time per call (CUDA events, `cuda_ms`) and device
    time (`device_ms`, all the call's kernels), in ms. args: (pos, dir,
    lane = (group, smin, smax), active, dtau_sub, lum, tau_int, tb_slab,
    inv_sqrt, scale_slab) on the card, lanes sorted as the event loop sorts
    them; scale_slab for mode 0."""
    from skirt9_tpu_torch.transport import sweep as sw
    from skirt9_tpu_torch.transport import sweepxl as xl
    lib = k6v.build_library(SOURCE, ENTRIES)
    pos, dirn, lane, active, rec, lum, tau_int, tb, inv_sqrt, scale = args
    g, smin, smax = lane
    B = pos.shape[0]
    dev = pos.device
    nx, ny, nz, nmax, *geo = sw._geometry_args(tabs)
    stream = kb.stream_of(pos)
    rf = torch.zeros(tabs.nd.shape[0], dtype=torch.float32, device=dev)
    # the package's prefix mode sums into an f64 table
    rf64 = torch.zeros(tabs.nd.shape[0], dtype=torch.float64, device=dev)
    s_int = torch.empty(B, dtype=torch.float32, device=dev)
    icell = torch.empty(B, dtype=torch.int64, device=dev)
    found = torch.empty(B, dtype=torch.bool, device=dev)
    hitrun = torch.empty((nmax, B), dtype=torch.int32, device=dev)
    act = active.to(torch.bool)
    ref = xl._deposit_prefix_cuda(tabs, pos, dirn, g, smin, smax, act, rec,
                                  lum, tau_int, tb, inv_sqrt, 1, None, 1,
                                  None)
    ref_rf = float(ref[0].abs().max())
    ref0 = xl._deposit_cuda(tabs, pos, dirn, g, smin, smax, rec, scale, 1)
    ptr = lambda t: None if t is None else t.data_ptr()
    res = {}

    def call(entry, run, mode, with_rf):
        slab = tb if mode == 1 else scale
        # the package's kernel also takes a bin map, a cell map (none here)
        # and its row count (one), and in its prefix mode an f64 RF
        ours = entry is package
        out = rf64 if ours and mode == 1 else rf
        k6v._call(entry, *(ptr(t) for t in (
            pos, dirn, g, smin, smax, rec, slab,
            lum if mode == 1 and with_rf else None,
            tau_int if mode == 1 else None, act if mode == 1 else None,
            *((None, None) if ours else ()),
            out if with_rf else None, hitrun if mode == 1 else None,
            *((s_int, icell, found) if mode == 1 else (None,) * 3))),
            B, nx, ny, nz, nmax, 1, *((1,) if ours else ()), run, mode,
            *geo, float(inv_sqrt), stream)

    def timed(name, fn, with_rf, want=None, f64=False):
        rf.zero_()
        rf64.zero_()
        fn()
        torch.cuda.synchronize()
        if want is not None:
            for a, b in zip((s_int, icell, found), ref[1:]):
                if not torch.equal(a, b):
                    raise AssertionError(f"kernel 7 variant {name}: "
                                         "interaction differs")
        if with_rf:
            w = ref[0][0] if want is not None else ref0[0]
            err = float(((rf64.float() if f64 else rf) - w).abs().max())
            if err > 1e-4 * float(w.abs().max()):
                raise AssertionError(f"kernel 7 variant {name}: RF error "
                                     f"{err}")
        res[name] = {"ms": cuda_ms(fn), "device_ms": device_ms(fn)["all"]}

    package = kb.library().sweepxl_deposit_launch
    for run in RUNS:
        for with_rf in (True, False):
            timed(f"run{run}_{'rf' if with_rf else 'no_rf'}",
                  lambda run=run, w=with_rf: call(package, run, 1, w),
                  with_rf, want=ref, f64=True)
    timed("atomics_rf", lambda: call(lib.atomics_launch,
                                     xl.DEPOSIT_RUN, 1, True), True,
          want=ref)
    timed("tables", lambda: call(package, xl.DEPOSIT_RUN, 0, True), True)
    timed("atomics_tables", lambda: call(lib.atomics_launch,
                                         xl.DEPOSIT_RUN, 0, True), True)
    timed("warp_sums_rf", lambda: call(lib.warp_sums_launch,
                                       xl.DEPOSIT_RUN, 1, True), True,
          want=ref)
    timed("warp_sums_tables", lambda: call(lib.warp_sums_launch,
                                           xl.DEPOSIT_RUN, 0, True), True)
    timed("old_tables", lambda: k6v._call(
        lib.old_launch, *(ptr(t) for t in (pos, dirn, g, smin, smax, rec,
                                           scale, rf)),
        B, nx, ny, nz, nmax, 1, *geo, stream), True)
    for v, name in enumerate(SPLIT):
        res[f"split_{name}"] = {
            key: f(lambda v=v: k6v._call(lib.split_launch, v, *(
                ptr(t) for t in (pos, dirn, g, smin, smax, rec, tb, lum,
                                 tau_int, act, rf, hitrun, s_int, icell,
                                 found)),
                B, nx, ny, nz, nmax, xl.DEPOSIT_RUN, *geo, float(inv_sqrt),
                stream))
            for key, f in (("ms", cuda_ms),
                           ("device_ms", lambda fn: device_ms(fn)["all"]))}
    res["rf_max"] = ref_rf
    return res


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from skirt9_tpu_torch.transport import sweep as sw
    from skirt9_tpu_torch.transport import sweepxl as xl
    sim = cs.config1("cuda", num_packets=cs.B_FULL, n=256)
    tabs = sim._sweep_tabs
    rs = np.random.default_rng(2)
    pos, dirn, sig, active = cs.sphere_rays(torch, sim, rs, cs.B_FULL)
    perm = xl.lane_order(tabs, pos, dirn, sw.dominant_axis(tabs, dirn))
    pos, dirn, active = pos[perm], dirn[perm], active[perm]
    rec, tb, tot, lane = xl.sweep_dtau_prefix(tabs, pos, dirn, sig, active)
    lum = torch.tensor(rs.uniform(0.5, 2.0, cs.B_FULL), dtype=torch.float32,
                       device=pos.device) * active
    tau_int = torch.tensor(rs.uniform(size=cs.B_FULL), dtype=torch.float32,
                           device=pos.device) * tot
    scale = (lum[None, :] * torch.exp(-tb)) * cs.INV_SQRT
    res = measure(torch, tabs, (pos, dirn, lane, active & (tot > 1e-6), rec,
                                lum, tau_int, tb, cs.INV_SQRT, scale),
                  cs.cuda_ms, cs.device_ms)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": cs.nvidia_smi_line(), **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
