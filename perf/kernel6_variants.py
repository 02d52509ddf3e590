"""Times of kernel 6's variants that the package does not ship, beside
the package's kernel (`skirt9_tpu_torch/csrc/sweepxl_dtau.cu`), at
bench_config1x256's shapes (256^3, B = 131072, C = 1, the sphere rays of
`chip_smoke.py`'s kernels_xl phase, sorted by `sweepxl.lane_order` as the
event loop sorts them):

- the package's kernel in its record and prefix modes at runs of 4, 8, 16
  and 32 slabs per thread (`sweepxl.RUN` is the one it ships);
- the lane-block design (`kernel6_variants.cu` `block_launch`: a block per
  32 lanes and all their slabs, a warp per run) with 16 and 8 warps;
- the lane-tile design after kernel 1 (`tile_launch`), on sorted and
  unsorted lanes;
- the first design of kernel 6 (`old_launch`) and its split: with the lane
  read once per run of 8 slabs, without the density gathers, the lane
  set-up and stores only, stores only.

Each output that should equal the package kernel's is checked against it.
The variants are built into their own library under build/perf/ with the
package's nvcc flags. Run from the repository root on a machine with a
CUDA device:

    python3 perf/kernel6_variants.py

It prints one JSON line; `chip_smoke.py`'s kernels_xl phase calls
`measure` on its own rays.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from skirt9_tpu_torch.kernels import build as kb  # noqa: E402

CSRC = os.path.join(ROOT, "skirt9_tpu_torch", "csrc")
SOURCE = os.path.join(HERE, "kernel6_variants.cu")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ENTRIES = {
    # variant, pos, dir, axis, smin, smax, sig, nd, out, B, C, nx, ny, nz,
    # nmax, run, lox, loy, loz, hx, hy, hz, stream
    "old_launch": [_I] + [_P] * 8 + [_I] * 7 + [_F] * 6 + [_P],
    # pos, dir, active, sig, nd, out, B, C, nx, ny, nz, nmax, lox, loy, loz,
    # hx, hy, hz, 1/hx, 1/hy, 1/hz, stream
    "tile_launch": [_P] * 6 + [_I] * 6 + [_F] * 9 + [_P],
    # warps, pos, dir, active, sig, nd, out, prefix, total, axis, smin, smax,
    # B, C, nx, ny, nz, nmax, mode, lox, loy, loz, hx, hy, hz, 1/hx, 1/hy,
    # 1/hz, stream
    "block_launch": [_I] + [_P] * 11 + [_I] * 7 + [_F] * 9 + [_P],
}
OLD = ("full", "lane_once", "no_gathers", "lane_stores", "stores_only")
OLD_RUN = 8      # lane_once: slabs per thread


def build_library(source: str, entries: dict) -> ctypes.CDLL:
    """Compile one variant source with the package's nvcc flags and its
    csrc/ on the include path into build/perf/<hash>/ (or find it built
    there), load it and bind `entries` (name -> argtypes)."""
    flags = [*kb.NVCC_FLAGS, "-I", CSRC]
    h = hashlib.sha256(" ".join(flags).encode())
    for p in [source, *(os.path.join(CSRC, n)
                        for n in sorted(os.listdir(CSRC)))]:
        with open(p, "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(ROOT, "build", "perf", h.hexdigest()[:16])
    name = os.path.splitext(os.path.basename(source))[0]
    path = os.path.join(out_dir, name + ".so")
    if not os.path.exists(path):
        os.makedirs(out_dir, exist_ok=True)
        res = subprocess.run([kb._nvcc(), *flags, "-shared", "-o", path,
                              source], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{res.stderr}")
    lib = ctypes.CDLL(path)
    for entry, argtypes in entries.items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def build() -> ctypes.CDLL:
    """Compile the variants (or find them built) and load them."""
    return build_library(SOURCE, ENTRIES)


def _call(fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} refused: cudaError {err}")


def measure(torch, tabs, rays, rays_unsorted, cuda_ms, device_ms) -> dict:
    """Each variant's time per call (CUDA events, `cuda_ms`) and
    device time (`device_ms`), in ms. rays: (pos, dir, sig, active) as the
    event loop's pass 1 gets them; rays_unsorted: the same in launch
    order."""
    from skirt9_tpu_torch.transport import sweep as sw
    from skirt9_tpu_torch.transport import sweepxl as xl
    lib = build()
    pos, dirn, sig, active = rays
    B, C = pos.shape[0], sig.shape[0]
    nx, ny, nz, nmax, *geo = sw._geometry_args(tabs)
    inv = [1.0 / v for v in tabs.h]
    stream = kb.stream_of(pos)
    ref = xl.sweep_dtau(tabs, *rays, want_sub=True)
    out = torch.empty_like(ref)
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                     device=pos.device)
    prefix, total, smn, smx = f32(nmax, B), f32(B), f32(B), f32(B)
    axis = torch.empty(B, dtype=torch.int32, device=pos.device)
    runsum = f32(nmax, B)
    ptrs = lambda *ts: (t.data_ptr() for t in ts)
    res = {}

    def timed(name, fn, check=None):
        fn()
        torch.cuda.synchronize()
        if check is not None and not torch.equal(*check()):
            raise AssertionError(f"kernel 6 variant {name}: record differs")
        res[name] = {"ms": cuda_ms(fn), "device_ms": device_ms(fn)["all"]}

    for run in (4, 8, 16, 32):
        for mode, what in ((1, "want_sub"), (3, "prefix")):
            timed(f"run{run}_{what}", lambda mode=mode, run=run: _call(
                kb.library().sweepxl_dtau_launch, *ptrs(
                    pos, dirn, active, sig, tabs.nd, out, prefix, total,
                    runsum, axis, smn, smx),
                B, C, nx, ny, nz, nmax, -1, mode, run, *geo, *inv, stream),
                lambda: (out, ref))
    for warps in (16, 8):
        for mode, what in ((1, "want_sub"), (3, "prefix")):
            timed(f"block{warps}_{what}",
                  lambda mode=mode, warps=warps: _call(
                      lib.block_launch, warps, *ptrs(
                          pos, dirn, active, sig, tabs.nd, out, prefix,
                          total, axis, smn, smx),
                      B, C, nx, ny, nz, nmax, mode, *geo, *inv, stream),
                  lambda: (out, ref))
    for key, (p, d, s, a) in (("sorted", rays), ("unsorted", rays_unsorted)):
        timed(f"tile_{key}", lambda: _call(
            lib.tile_launch, *ptrs(p, d, a, s, tabs.nd, out),
            B, C, nx, ny, nz, nmax, *geo, *inv, stream),
            (lambda: (out, ref)) if key == "sorted" else None)
        timed(f"kernel_{key}",
              lambda: xl.sweep_dtau(tabs, p, d, s, a, want_sub=True))
    g, smin, smax = sw._lane_range(tabs, pos, dirn, active)
    for v, name in enumerate(OLD):
        timed(f"old_{name}", lambda v=v: _call(
            lib.old_launch, v, *ptrs(pos, dirn, g, smin, smax, sig, tabs.nd,
                                     out),
            B, C, nx, ny, nz, nmax, OLD_RUN, *geo, stream),
            (lambda: (out, ref)) if name in ("full", "lane_once") else None)
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
    res = measure(torch, tabs, (pos[perm], dirn[perm], sig, active[perm]),
                  (pos, dirn, sig, active), cs.cuda_ms, cs.device_ms)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": cs.nvidia_smi_line(), **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
