"""Wavelength grids: instrument/radiation-field binning meshes.

A copy of `skirt9_tpu/spectral/wavelengths.py` (host numpy, no jax).

Equivalent of the reference's DisjointWavelengthGrid family
(ref: SKIRT/core/WavelengthGrid.hpp:43, DisjointWavelengthGrid.hpp:36,
LogWavelengthGrid/LinWavelengthGrid/NestedLogWavelengthGrid/
ResolutionWavelengthGrid/FileWavelengthGrid/ListWavelengthGrid/
OligoWavelengthGrid). A grid is represented by its border array (nb+1,)
(characteristic wavelengths are the geometric/arithmetic bin centers);
device-side binning is a searchsorted, done in the instruments/transport.
"""

from __future__ import annotations

import numpy as np


def lin_borders(lam_min: float, lam_max: float, n: int) -> np.ndarray:
    """(ref: LinWavelengthGrid / LinBorderWavelengthGrid)"""
    return np.linspace(lam_min, lam_max, n + 1)


def log_borders(lam_min: float, lam_max: float, n: int) -> np.ndarray:
    """n+1 borders with lam_min/lam_max as OUTER borders (internal use)."""
    return np.geomspace(lam_min, lam_max, n + 1)


def log_borders_skirt(lam_min: float, lam_max: float, n: int) -> np.ndarray:
    """SKIRT LogWavelengthGrid semantics: lam_min/lam_max are the first and
    last CHARACTERISTIC wavelengths of n bins; borders sit at the log
    midpoints, with the outer borders extended half a step
    (ref: DisjointWavelengthGrid::setWavelengthRange, logScale branch,
    DisjointWavelengthGrid.cpp:47-58)."""
    lam = np.geomspace(lam_min, lam_max, n)
    if n == 1:
        return np.array([lam_min * 0.999, lam_min * 1.001])
    inner = np.sqrt(lam[:-1] * lam[1:])
    b0 = np.sqrt(lam[0] ** 3 / lam[1])
    bn = np.sqrt(lam[-1] ** 3 / lam[-2])
    return np.concatenate([[b0], inner, [bn]])


def lin_borders_skirt(lam_min: float, lam_max: float, n: int) -> np.ndarray:
    """SKIRT LinWavelengthGrid semantics (linear-midpoint borders,
    ref: DisjointWavelengthGrid.cpp:60-67)."""
    lam = np.linspace(lam_min, lam_max, n)
    if n == 1:
        return np.array([lam_min * 0.999, lam_min * 1.001])
    inner = 0.5 * (lam[:-1] + lam[1:])
    b0 = 1.5 * lam[0] - 0.5 * lam[1]
    bn = 1.5 * lam[-1] - 0.5 * lam[-2]
    return np.concatenate([[b0], inner, [bn]])


def resolution_borders(lam_min: float, lam_max: float, R: float) -> np.ndarray:
    """Constant spectral resolution R = lam/dlam
    (ref: ResolutionWavelengthGrid)."""
    n = max(1, int(np.ceil(np.log(lam_max / lam_min) / np.log1p(1.0 / R))))
    return np.geomspace(lam_min, lam_max, n + 1)


def nested_log_borders(lam_min: float, lam_max: float, n: int,
                       sub_min: float, sub_max: float, n_sub: int) -> np.ndarray:
    """Coarse log grid with a finer log subgrid nested inside
    (ref: NestedLogWavelengthGrid)."""
    coarse = np.geomspace(lam_min, lam_max, n + 1)
    fine = np.geomspace(sub_min, sub_max, n_sub + 1)
    keep = coarse[(coarse < sub_min) | (coarse > sub_max)]
    return np.unique(np.concatenate([keep, fine]))


def oligo_borders(wavelengths) -> np.ndarray:
    """Narrow disjoint bins (relative half-width 1e-3, i.e. width lam/500)
    around discrete wavelengths (ref: OligoWavelengthGrid.cpp:25
    setWavelengthBins(lams, 1e-3, true)).

    Note: disjoint narrow bins are represented as a border array with gap
    bins; callers using this must mask the gap bins at calibration.
    """
    ws = np.sort(np.asarray(wavelengths, np.float64))
    borders = []
    for w in ws:
        borders += [w * (1 - 1e-3), w * (1 + 1e-3)]
    return np.asarray(borders)


def list_borders(borders) -> np.ndarray:
    """(ref: ListBorderWavelengthGrid / FileBorderWavelengthGrid)"""
    b = np.sort(np.asarray(borders, np.float64))
    if len(b) < 2:
        raise ValueError("need at least two borders")
    return b


def centers(borders: np.ndarray, log: bool = True) -> np.ndarray:
    b = np.asarray(borders, np.float64)
    return np.sqrt(b[1:] * b[:-1]) if log else 0.5 * (b[1:] + b[:-1])
