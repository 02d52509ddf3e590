"""Times of kernel 4's variants that the package does not ship, beside
the package's kernel (`skirt9_tpu_torch/csrc/mlsweep_dtau.cu`), on the
trees of bench_config3ism (a 128^3 fine raster, its leaf map in L2) and
bench_config3ismxl (256^3, beyond L2), B = 65536 rays uniform in the box
(`chip_smoke.box_rays`), in launch order as the tree loop has them:

- the package's kernel in its want_sub and prefix modes at runs of 1, 4, 8,
  16 and 32 plan steps per thread (`mlsweep.RUN` is the one it ships; a run
  of 1 is one thread per (step, lane) with the lane set-up inside);
- the first design of kernel 4 (`kernel4_variants.cu` `old_launch`: one
  thread per (step, lane) loading the caller's lane range), want_sub;
- the package's want_sub mode split (`split_launch`): as shipped, without
  the leaf-map and density gathers, the lane set-up and stores alone, the
  stores alone.

Each variant's record and leaf ids must equal the package kernel's bit for
bit, but the split's, which leave parts out on purpose. The variant is built into its own library under build/perf/ with the
package's nvcc flags. Run from the repository root on a machine with a
CUDA device:

    python3 perf/kernel4_variants.py

It prints one JSON line; `chip_smoke.py`'s kernels_ml phase calls
`measure` on its own rays.
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

SOURCE = os.path.join(HERE, "kernel4_variants.cu")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ENTRIES = {
    # pos, dir, axis, smin, smax, sig, nd, leafmap, step_tlev, step_gs, out,
    # cells, B, C, nx, ny, nz, n_steps, want_sub, lox, loy, loz, hx, hy, hz,
    # stream
    "old_launch": [_P] * 12 + [_I] * 7 + [_F] * 6 + [_P],
    # variant, pos, dir, active, sig, nd, leafmap, step_tlev, step_gs, out,
    # cells, B, C, nx, ny, nz, n_steps, run, lox, loy, loz, hx, hy, hz, 1/hx,
    # 1/hy, 1/hz, stream
    "split_launch": [_I] + [_P] * 10 + [_I] * 7 + [_F] * 9 + [_P],
}
SPLIT = ("full", "no_gathers", "lane_stores", "stores_only")
RUNS = (1, 4, 8, 16, 32)


def measure(torch, tabs, rays, cuda_ms, device_ms) -> dict:
    """Each variant's time per call (CUDA events, `cuda_ms`) and device
    time (`device_ms`, all the call's kernels), in ms. rays: (pos, dir,
    sig, active) on the card."""
    from skirt9_tpu_torch.transport import mlsweep as ml
    from skirt9_tpu_torch.transport import sweep as sw
    lib = k6v.build_library(SOURCE, ENTRIES)
    pos, dirn, sig, active = rays
    B, C = pos.shape[0], sig.shape[0]
    dev = pos.device
    NS = tabs.n_steps
    nx, ny, nz, n_steps, *geo = ml._geometry_args(tabs)
    inv = [1.0 / v for v in tabs.h]
    stream = kb.stream_of(pos)
    ref, ref_cells = ml.sweep_dtau(tabs, pos, dirn, sig, active,
                                   want_sub=True)
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    out, cells = f32(NS, 3, B), torch.empty((NS, 3, B), dtype=torch.int32,
                                            device=dev)
    steps, prefix, total = f32(NS, B), f32(NS, B), f32(B)
    runsum = f32(NS, B)
    axis = torch.empty(B, dtype=torch.int32, device=dev)
    smin, smax = f32(B), f32(B)
    act = active.to(torch.bool)
    ptr = lambda t: None if t is None else t.data_ptr()
    res = {}

    def timed(name, fn):
        fn()
        torch.cuda.synchronize()
        if not (torch.equal(out, ref) and torch.equal(cells, ref_cells)):
            raise AssertionError(f"kernel 4 variant {name}: record differs")
        res[name] = {"ms": cuda_ms(fn), "device_ms": device_ms(fn)["all"]}

    package = kb.library().mlsweep_dtau_launch
    for run in RUNS:
        for mode, what in ((1, "want_sub"), (3, "prefix")):
            timed(f"run{run}_{what}", lambda mode=mode, run=run: k6v._call(
                package, *(ptr(t) for t in (
                    pos, dirn, act, sig, tabs.nd,
                    tabs.leafmap, tabs.step_tlev, tabs.step_gs, out, cells,
                    *((steps, prefix, total, runsum, axis, smin, smax)
                      if mode == 3 else (None,) * 7))),
                B, C, nx, ny, nz, n_steps, -1, mode, run, *geo, *inv,
                stream))
    g, lo, hi = sw._lane_range(tabs, pos, dirn, active)
    timed("old_want_sub", lambda: k6v._call(
        lib.old_launch, *(ptr(t) for t in (
            pos, dirn, g, lo, hi, sig, tabs.nd, tabs.leafmap,
            tabs.step_tlev, tabs.step_gs, out, cells)),
        B, C, nx, ny, nz, n_steps, 1, *geo, stream))
    for v, name in enumerate(SPLIT):
        split = lambda v=v: k6v._call(lib.split_launch, v, *(
            ptr(t) for t in (pos, dirn, act, sig, tabs.nd, tabs.leafmap,
                             tabs.step_tlev, tabs.step_gs, out, cells)),
            B, C, nx, ny, nz, n_steps, ml.RUN, *geo, *inv, stream)
        if name == "full":
            timed("split_full", split)
        else:
            res[f"split_{name}"] = {"ms": cuda_ms(split),
                                    "device_ms": device_ms(split)["all"]}
    return res


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    out = {}
    for name, seed in (("config3ism", 4), ("config3ismxl", 5)):
        sim, _, _ = cs.config3ism("cuda", name)
        rays = cs.box_rays(torch, sim, np.random.default_rng(seed), cs.B_ML)
        out[name] = measure(torch, sim._sweep_tabs, rays, cs.cuda_ms,
                            cs.device_ms)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": cs.nvidia_smi_line(), **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
