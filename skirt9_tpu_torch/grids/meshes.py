"""The Mesh family: 1-D border distributions used by structured grids.

A copy of `skirt9_tpu/grids/meshes.py` (ref: SKIRT/core/Mesh.hpp, LinMesh,
PowMesh.cpp:11-20, SymPowMesh.cpp:11-33, LogMesh.cpp:11-20, FileMesh,
ListMesh; grid formulas in SKIRT/utils/NR.hpp:221-320), which imports only
numpy. Every builder returns normalized border points in [0, 1] as
float64; the grid maker scales them into physical coordinates. Meshes are
a one-time host-side setup computation.
"""

from __future__ import annotations

import numpy as np


def lin_mesh(n: int) -> np.ndarray:
    return np.linspace(0.0, 1.0, n + 1)


def pow_mesh(n: int, ratio: float) -> np.ndarray:
    """Power-law mesh: bin widths in geometric progression with the given
    outermost/innermost width ratio (ref: NR.hpp:221 buildPowerLawGrid)."""
    if n <= 1 or abs(ratio - 1.0) < 1e-3:
        return lin_mesh(max(n, 1))
    q = ratio ** (1.0 / (n - 1))
    i = np.arange(n + 1, dtype=np.float64)
    return (1.0 - q**i) / (1.0 - q**n)


def sym_pow_mesh(n: int, ratio: float) -> np.ndarray:
    """Symmetric power-law mesh: innermost bins at the centre, widths
    growing outward symmetrically (ref: NR.hpp:256)."""
    if n <= 2 or abs(ratio - 1.0) < 1e-3:
        return lin_mesh(max(n, 1))
    xv = np.empty(n + 1)
    if n % 2 == 0:
        M = n // 2
        q = ratio ** (1.0 / (M - 1.0))
        i = np.arange(1, M + 1, dtype=np.float64)
        dxi = (1.0 - q**i) / (1.0 - q**M) * 0.5
        xv[M] = 0.5
        xv[M + 1:] = 0.5 + dxi
        xv[M - 1::-1] = 0.5 - dxi
    else:
        M = (n + 1) // 2
        q = ratio ** (1.0 / (M - 1.0))
        i = np.arange(1, M + 1, dtype=np.float64)
        dxi = (0.5 + 0.5 * q - q**i) / (0.5 + 0.5 * q - q**M) * 0.5
        xv[M:] = 0.5 + dxi
        xv[M - 1::-1] = 0.5 - dxi
    return xv


def log_mesh(n: int, central_bin_fraction: float) -> np.ndarray:
    """Logarithmic mesh anchored at zero: first border 0, remaining borders
    log-spaced from central_bin_fraction to 1 (ref: NR.hpp:314
    buildZeroLogGrid via LogMesh.cpp:11-20)."""
    if n <= 1:
        return lin_mesh(max(n, 1))
    xv = np.zeros(n + 1)
    xv[1:] = np.geomspace(central_bin_fraction, 1.0, n)
    return xv


def list_mesh(points) -> np.ndarray:
    """Mesh from explicit points: sorted, deduplicated, scaled to [0,1]
    with an implicit 0 border (ref: ListMesh / TabulatedMesh.cpp)."""
    p = np.unique(np.asarray(points, np.float64))
    p = p[p > 0.0]
    if p.size == 0:
        return lin_mesh(1)
    return np.concatenate([[0.0], p / p[-1]])


def file_mesh(path: str) -> np.ndarray:
    """Mesh points from a one-column text file (ref: FileMesh)."""
    return list_mesh(np.loadtxt(path, ndmin=1))


def from_ski(el, base_dir: str = ".", default_bins: int = 16) -> np.ndarray:
    """Build normalized borders from a ski Mesh element."""
    if el is None:
        return lin_mesh(default_bins)
    a = el.attrib
    n = int(a.get("numBins", default_bins))
    t = el.tag
    if t == "LinMesh":
        return lin_mesh(n)
    if t == "PowMesh":
        return pow_mesh(n, float(a.get("ratio", 1.0)))
    if t == "SymPowMesh":
        return sym_pow_mesh(n, float(a.get("ratio", 1.0)))
    if t == "LogMesh":
        return log_mesh(n, float(a.get("centralBinFraction", 1e-3)))
    if t == "SymLogMesh":
        # symmetric log mesh: a central bin of width centralBinFraction
        # with log-refined bins approaching it from both sides
        # (ref: SymLogMesh.cpp)
        h = max(n // 2, 1)
        cf = float(a.get("centralBinFraction", 1e-3))
        d = np.geomspace(1.0, max(cf, 1e-12), h)       # 1 -> cf
        half = np.concatenate([[0.0], 0.5 * (1.0 - d)])
        b = np.concatenate([half, 1.0 - half[::-1]])
        return np.unique(b)
    if t == "SymCosMesh":
        # symmetric cosine mesh: bins compressed at center and edges
        # (ref: SymCosMesh — borders at (1 - cos(pi t))/2 over each half)
        h = n // 2
        tt = np.linspace(0.0, 1.0, max(h, 1) + 1)
        half = 0.5 * (1.0 - np.cos(np.pi * tt)) * 0.5
        b = np.concatenate([half, 1.0 - half[::-1][1:]])
        return np.unique(b)
    if t == "TabulatedMesh":
        # explicit normalized mesh points given inline
        # (ref: TabulatedMesh — like ListMesh but normalized to [0,1])
        pts = np.array([float(v.split()[0]) for v in a["points"].split(",")])
        pts = np.sort(np.unique(np.concatenate([[0.0], pts, [1.0]])))
        return (pts - pts[0]) / (pts[-1] - pts[0])
    if t == "ListMesh":
        return list_mesh([float(v.split()[0])
                          for v in a["points"].split(",")])
    if t == "FileMesh":
        import os
        fn = a["filename"]
        if not os.path.isabs(fn):
            fn = os.path.join(base_dir, fn)
        return file_mesh(fn)
    raise NotImplementedError(f"mesh '{t}' not supported yet")


def scale(borders: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """Scale normalized borders into [lo, hi]."""
    return lo + (hi - lo) * np.asarray(borders, np.float64)
