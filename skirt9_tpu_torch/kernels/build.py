"""Build, load and count the port's CUDA kernels.

The kernels are CUDA C++ sources in `skirt9_tpu_torch/csrc/`, compiled at
first use with `nvcc` for `sm_90a`, one process per source, all started
together, then linked into one shared library with a plain C interface, and
bound with `ctypes` (pointers and the stream as c_void_p).
The library lands in `build/skirt9_tpu_torch/<hash>/` at the repository root
and is reused while the hash of the sources and flags is unchanged.

Nothing here runs at import: `library()` builds on its first call. A missing
`nvcc` or a failed build raises; there is no fallback.

`LAUNCHES` counts kernel launches by name. Each wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its main path
went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "skirt9_tpu_torch"
_LIB_NAME = "libskirt9_kernels.so"

# -fmad=false: no contraction of a*b+c into FMA, so the kernels round like
# the plain PyTorch versions (one op per launch) and the JAX reference.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# one counter per contract, even where two share source through
# csrc/sweep_common.cuh or one entry point serves several (kernel 1's three
# output modes, kernels 4 and 6's summed and want_sub modes under one and
# their total and prefix modes, kernels 2 and 7's two input modes), so a run
# shows which contract its path went through
KERNELS = ("sweep_dtau", "sweep_tau_total", "sweep_dtau_prefix",
           "sweep_deposit", "sweep_deposit_prefix", "scatter_add", "detect",
           "sweepxl_dtau", "sweepxl_tau_total", "sweepxl_dtau_prefix",
           "sweepxl_deposit", "sweepxl_deposit_prefix", "mlsweep_dtau",
           "mlsweep_tau_total", "mlsweep_dtau_prefix", "mlsweep_deposit",
           # the scan march (csrc/march.cu), one counter per grid mode
           "march_uniform", "march_mesh", "march_voronoi", "march_octree",
           "march_bintree", "march_sphere1d", "march_cylinder2d",
           "march_amr", "march_tetra", "march_sphere2d", "march_sphere3d",
           "march_cylinder3d", "march_clumpy",
           # glibc's sinf and cosf of the directions, and the HG scattering
           # direction (csrc/sincos.cu)
           "sincos", "hg_direction",
           # the gather and row-lookup probes (tools/), one counter per
           # variant of their shared entry points
           "probe_gather_smem", "probe_gather_l2", "probe_scatter_smem",
           "row_lookup_gather", "row_lookup_select")
LAUNCHES = {name: 0 for name in KERNELS}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # pos, dir, active, sig, nd, out, total, axis, smin, smax, B, C, nx, ny,
    # nz, nmax, hint, mode, lox, loy, loz, hx, hy, hz, 1/hx, 1/hy, 1/hz,
    # stream
    "sweep_dtau_launch": [_P] * 10 + [_I] * 8 + [_F] * 9 + [_P],
    # pos, dir, axis, smin, smax, sig, scale or tb, rel, lum, tau_int,
    # bin_map, nd, rf, s_int, icell, found, B, C, nx, ny, nz, nmax,
    # n_groups, rows, mode, lox, loy, loz, hx, hy, hz, inv_sqrt, stream
    "sweep_deposit_launch": [_P] * 16 + [_I] * 9 + [_F] * 7 + [_P],
    # idx, val, out, n, size, stream
    "scatter_add_launch": [_P] * 3 + [_I] * 2 + [_P],
    # lam, pos, contrib, active, Stokes q/u/v (or null), borders, sed row,
    # stats, frame cube, Stokes rows, Stokes cubes, scratch sums, flags,
    # list, counts, B, nb, npx, npy, epoch, 1/stats_scale, ex (3), ey (3),
    # centerx, centery, 1/fovx, 1/fovy, stream
    "detect_launch": [_P] * 15 + [_I] * 5 + [_F] * 11 + [_P],
    # pos, dir, active, sig, nd, out, prefix, total, runsum, axis, smin,
    # smax, B, C, nx, ny, nz, nmax, hint, mode, run, lox, loy, loz, hx, hy,
    # hz, 1/hx, 1/hy, 1/hz, stream
    "sweepxl_dtau_launch": [_P] * 12 + [_I] * 9 + [_F] * 9 + [_P],
    # pos, dir, axis, smin, smax, dsub, scale or tb, lum, tau_int, active,
    # bin_map, cellmap, rf, hitrun, s_int, icell, found, B, nx, ny, nz,
    # nmax, n_groups, rows, run, mode, lox, loy, loz, hx, hy, hz, inv_sqrt,
    # stream
    "sweepxl_deposit_launch": [_P] * 17 + [_I] * 9 + [_F] * 7 + [_P],
    # pos, dir, active, sig, lane axis, smin, smax (or null), nd, leafmap,
    # step_tlev, step_gs, out, cells, steps, prefix, total, runsum, axis,
    # smin, smax, B, C, nx, ny, nz, n_steps, hint, mode, run, lox, loy, loz,
    # hx, hy, hz, 1/hx, 1/hy, 1/hz, stream
    "mlsweep_dtau_launch": [_P] * 17 + [_I] * 9 + [_F] * 9 + [_P],
    # pos, dir, axis, smin, smax, dsub, csub, lum, tau_int, tb, step_tlev,
    # step_gs, bin_map, rf, first_hit, B, nx, ny, nz, n_steps, ncells,
    # n_groups, rows, shared, lox, loy, loz, hx, hy, hz, inv2, stream
    "mlsweep_deposit_launch": [_P] * 15 + [_I] * 9 + [_F] * 7 + [_P],
    # pos, dir, cell0, mask, three tables, the six grid constants, cells,
    # ds, B, S, n0, n1, n2, degree, mode, stream
    "march_launch": [_P] * 10 + [_I] * 7 + [_P],
    # pos, dir, cell0, mask, node_child, node_axis, node_geom, node_cell,
    # cell_lo, cell_hi, box, cells, ds, B, S, levels, octree, stream
    "march_tree_launch": [_P] * 13 + [_I] * 4 + [_P],
    # pos, dir, cell0, mask, node_lo, node_span, node_div, node_child,
    # node_cell, child_flat, cell_lo, cell_hi, box, cells, ds, B, S, depth,
    # nudge, stream
    "march_amr_launch": [_P] * 15 + [_I] * 3 + [_F] + [_P],
    # pos, dir, cell0, mask, rb, zb (or null), cells, ds, B, S, nr, nz,
    # cylinder, shift, stream
    "march_curvi_launch": [_P] * 8 + [_I] * 6 + [_P],
    # pos, dir, cell0, mask, face_n, face_d, neighbors, cells, ds, B, S,
    # stream
    "march_tetra_launch": [_P] * 9 + [_I] * 2 + [_P],
    # pos, dir, cell0, mask, packed tables, cells, ds, B, S, nr, nt, nphi,
    # nz, kind, shift, stream
    "march_polar_launch": [_P] * 7 + [_I] * 8 + [_P],
    # pos, dir, cell0, mask, packed tables, cells, ds, B, S, nr, nt, nphi,
    # nc, shift, stream
    "march_clumpy_launch": [_P] * 7 + [_I] * 7 + [_P],
    # x, sin, cos, n, stream
    "sincos_launch": [_P] * 3 + [_I] + [_P],
    # dir, g, u_ct, u_phi, out, n, stream
    "hg_direction_launch": [_P] * 5 + [_I] + [_P],
    # nd, idx, out, n, B, staged, stream
    "probe_gather_launch": [_P] * 3 + [_I] * 3 + [_P],
    # idx, val, out, n, B, stream
    "probe_scatter_launch": [_P] * 3 + [_I] * 2 + [_P],
    # tab, idx, out, R, W, S, iters, select, stream
    "row_lookup_launch": [_P] * 3 + [_I] * 5 + [_P],
}

_lib = None
build_info: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sources() -> list[Path]:
    return sorted(p for p in _CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (searched PATH and "
                       f"{cuda_home}/bin): the CUDA kernels cannot be built")


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (or find the cached build); returns the .so."""
    sources = _sources()
    out_dir = _BUILD_ROOT / _digest(sources)
    lib_path = out_dir / _LIB_NAME
    if lib_path.exists():
        build_info.update(path=str(lib_path), cached=True)
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    log, ptxas = [], []

    def finish(cmd, proc):
        out, err = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            (out_dir / "build.log").write_text("\n".join(log))
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{err}")
        ptxas.append(err.strip())

    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        compiles = []
        for p in sources:
            if p.suffix == ".cu":
                cmd = [nvcc, *NVCC_FLAGS, "-c", "-o",
                       os.path.join(tmp, p.stem + ".o"), str(p)]
                compiles.append((cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)))
        try:
            for cmd, proc in compiles:
                finish(cmd, proc)
        finally:
            for _, proc in compiles:
                proc.kill()
                proc.wait()
        lib_tmp = os.path.join(tmp, _LIB_NAME)
        cmd = [nvcc, "-shared", "-o", lib_tmp,
               *sorted(str(p) for p in Path(tmp).glob("*.o"))]
        finish(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True))
        (out_dir / "build.log").write_text("\n".join(log))
        os.replace(lib_tmp, lib_path)
    build_info.update(path=str(lib_path), cached=False,
                      ptxas="\n".join(ptxas).strip())
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(name: str, *args, count_as: str | None = None) -> None:
    """Call `<name>_launch` of the library on the given arguments, count the
    launch (under `count_as` where one entry point serves several kernel
    variants), and raise if CUDA refused it (a nonzero cudaError)."""
    err = getattr(library(), f"{name}_launch")(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {count_as or name} failed to "
                           f"launch: cudaError {err}")
    LAUNCHES[count_as or name] += 1


def stream_of(t) -> int:
    """The current CUDA stream of a tensor's device, as an int for ctypes."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream

