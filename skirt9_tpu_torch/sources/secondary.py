"""Secondary (thermal dust) source: packets from the cells' emission spectra.

Port of `skirt9_tpu/sources/secondary.py:27-254`: packets are spread over
cells with the composite luminosity/uniform spatial bias, draw their
wavelength from their cell's emission-spectrum cdf (stratified over a
stratum's range when the launch carries strata, weighted by R times the
cell's spectral mass in the stratum), start at a uniform point inside the
cell and leave isotropically. The whole (ncells, L) cdf table lives on the
device. Aligned-spheroidal-grain polarised emission (`spheroidal`,
`skirt9_tpu/sources/secondary.py:260-425`) is not ported yet and raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import rng, sampling


@dataclasses.dataclass(frozen=True)
class DustSecondarySource:
    """Static configuration; all device state lives in the tables dict."""

    luminosity: float              # total dust luminosity [W]
    spatial_bias: float = 0.5
    # wavelength support of the emission spectra, for the strata of a
    # wavelength-binned RF (Simulation._strata_for)
    lam_range: tuple = None
    spheroidal: object = None
    _tables: dict = dataclasses.field(default=None, compare=False, hash=False,
                                      repr=False)

    def __post_init__(self):
        if self.spheroidal is not None:
            raise NotImplementedError("spheroidal (aligned-grain polarised) "
                                      "dust emission not ported yet")

    def tables(self, device=None) -> dict:
        return self._tables

    def launch(self, tabs: dict, keys: torch.Tensor, n_total: int) -> dict:
        # cell, with the bias correction
        cell_cdf = tabs["cell_cdf"]
        u_cell = rng.uniform(keys, rng.LAUNCH_CELL)
        cell = torch.clamp(sampling.searchsorted_right(cell_cdf, u_cell), 0,
                           cell_cdf.shape[0] - 1)
        lum = (tabs["lum_total"] / n_total) * tabs["cell_weight"][cell]

        # wavelength from the cell's emission-spectrum cdf
        rows = tabs["spec_cdf"][cell]                   # (B, L)
        L = rows.shape[1]
        u_lam = rng.uniform(keys, rng.EMISSION_LAMBDA)
        borders = tabs["lam_borders"]

        def row_at(j):
            return rows.gather(1, j[:, None])[:, 0]

        def row_before(j):
            c = row_at(torch.clamp_min(j - 1, 0))
            return torch.where(j > 0, c, torch.zeros_like(c))

        if "strata" in tabs:
            sb = tabs["strata"]
            B = u_lam.shape[0]
            R = sb.shape[0] - 1
            stratum = (torch.arange(B, device=keys.device) * R) // B
            lo = torch.clamp(sb[stratum], borders[0], borders[-1])
            hi = torch.clamp(sb[stratum + 1], borders[0], borders[-1])

            def cdf_at(lam):
                j = torch.clamp(sampling.searchsorted_right(borders, lam) - 1,
                                0, L - 1)
                c0, c1 = row_before(j), row_at(j)
                bj = borders[j]
                f = (lam - bj) / torch.clamp_min(borders[j + 1] - bj, 1e-30)
                return c0 + torch.clamp(f, 0.0, 1.0) * (c1 - c0)

            clo = cdf_at(lo)
            m = torch.clamp_min(cdf_at(hi) - clo, 0.0)
            u_lam = clo + u_lam * m
            w = R * m
            if "strata_w" in tabs:
                w = w * tabs["strata_w"][stratum]
            lum = lum * w
        li = torch.clamp(torch.sum(rows < u_lam[:, None], dim=1), 0, L - 1)
        c0, c1 = row_before(li), row_at(li)
        frac = torch.where(c1 > c0, (u_lam - c0) / torch.clamp_min(c1 - c0,
                                                                   1e-30),
                           torch.full_like(u_lam, 0.5))
        b0 = borders[li]
        lam = b0 + frac * (borders[li + 1] - b0)
        if "strata" in tabs:
            # keep strictly inside the stratum against rounding
            lam = torch.minimum(torch.maximum(lam, lo), hi * (1.0 - 1e-7))

        # uniform position inside the cell
        u3 = rng.uniform_vec(keys, rng.LAUNCH_POSITION, 3)
        lo_c = tabs["cell_lo"][cell]
        pos = lo_c + u3 * (tabs["cell_hi"][cell] - lo_c)
        dirn = rng.isotropic_direction(keys, rng.LAUNCH_DIRECTION)
        return {"lam": lam, "lum": lum, "pos": pos, "dir": dirn}


def _cell_launch_tables(L: torch.Tensor, spatial_bias: float) -> tuple:
    """The launch cdf over cells with the composite luminosity/uniform bias,
    and the per-cell weight that corrects it, in f64 tensor ops on L's
    device (the reference builds them in numpy on the host,
    `skirt9_tpu/sources/secondary.py:194-215`; a 256^3 grid's 16.8 M cells
    took about a second so); only the total crosses to the host. Returns
    (total, dict of f32 tables)."""
    L = L.to(torch.float64)
    total = float(L.sum())
    nonzero = L > 0
    n_nonzero = torch.clamp_min(nonzero.sum(), 1).to(torch.float64)
    wl = torch.where(nonzero, L / max(total, 1e-300), torch.zeros_like(L))
    xi = spatial_bias
    w = (1 - xi) * wl + xi * nonzero.to(torch.float64) / n_nonzero
    wsum = w.sum()
    w = torch.where(wsum > 0, w / torch.where(wsum > 0, wsum, 1.0),
                    torch.full_like(w, 1.0 / len(w)))
    weight = torch.where(w > 0, wl / torch.clamp_min(w, 1e-300),
                         torch.zeros_like(w))
    f32 = lambda t: t.to(torch.float32)
    return total, {"lum_total": torch.tensor(total, dtype=torch.float32,
                                             device=L.device),
                   "cell_cdf": f32(torch.cumsum(w, 0)),
                   "cell_weight": f32(weight)}


def _source(total, tables, ems_borders, spatial_bias):
    return DustSecondarySource(luminosity=total, spatial_bias=spatial_bias,
                               lam_range=(float(ems_borders[0]),
                                          float(ems_borders[-1])),
                               _tables=tables)


def prepare(grid, L_cell, eps, ems_borders, spatial_bias: float = 0.5,
            device="cpu") -> DustSecondarySource:
    """The secondary source from per-cell luminosities L_cell (ncells,) [W]
    and emission spectra eps (ncells, L) on ems_borders (L+1,), with the
    spectrum cdf built on the host in float64."""
    ems_borders = np.asarray(ems_borders, np.float64)
    total, tables = _cell_launch_tables(
        torch.tensor(np.asarray(L_cell, np.float64), device=device),
        spatial_bias)
    wspec = np.maximum(np.asarray(eps, np.float64), 0.0) \
        * np.diff(ems_borders)[None, :]
    spec_cdf = np.cumsum(wspec, axis=1) / np.maximum(
        wspec.sum(axis=1, keepdims=True), 1e-300)
    lo, hi = cell_bounds(grid)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    tables.update(lam_borders=f32(ems_borders), spec_cdf=f32(spec_cdf),
                  cell_lo=f32(lo), cell_hi=f32(hi))
    return _source(total, tables, ems_borders, spatial_bias)


def prepare_device(grid, L_cell: torch.Tensor, eps: torch.Tensor, ems_borders,
                   spatial_bias: float = 0.5,
                   bounds_dev=None) -> DustSecondarySource:
    """`prepare` with the luminosities and the emission spectra kept on
    their device (the reference brings the luminosities to the host for
    the launch cdf). bounds_dev: cached (cell_lo, cell_hi) tensors on that
    device."""
    dev = eps.device
    ems_borders = np.asarray(ems_borders, np.float64)
    total, tables = _cell_launch_tables(L_cell.detach(), spatial_bias)
    emsb = torch.tensor(ems_borders.astype(np.float32), device=dev)
    wspec = torch.clamp_min(eps, 0.0) * (emsb[1:] - emsb[:-1])[None, :]
    # the running sum along each cell's L bins, taken over the leading dim
    # of the transpose: the CUDA scan along a short innermost dim took ~0.1
    # s at 16.8 M cells, the outer-dim one runs each column in order
    spec_cdf = torch.cumsum(wspec.T.contiguous(), dim=0).T / torch.clamp_min(
        torch.sum(wspec, dim=1, keepdim=True), 1e-30)
    if bounds_dev is None:
        lo, hi = cell_bounds(grid)
        bounds_dev = tuple(torch.tensor(a.astype(np.float32), device=dev)
                           for a in (lo, hi))
    tables.update(lam_borders=emsb, spec_cdf=spec_cdf.contiguous(),
                  cell_lo=bounds_dev[0], cell_hi=bounds_dev[1])
    return _source(total, tables, ems_borders, spatial_bias)


def cell_bounds(grid):
    """Axis-aligned bounds (lo, hi) per cell, (ncells, 3) each, for
    position sampling: the voxels of a uniform grid, the leaves of a tree,
    a Voronoi cell's exact bounding box, a 1D sphere's shell's bounding
    cube. In a Voronoi cell's box and a shell's cube the launch is uniform,
    as in the reference (`skirt9_tpu/sources/secondary.py:177, 241-246`),
    so a packet may start in another cell, or outside the sphere, whence
    the launch's `move_inside` carries it along its direction to the outer
    shell (or it misses and carries nothing), as the reference's does. The
    reference has no cell bounds on the 2D cylinder, the 2D and 3D spheres,
    the 3D cylinder, the tetrahedral grid and the clumpy sphere, and its
    dust emission fails on them (`skirt9_tpu/sources/secondary.py:
    241-255`); the port raises, naming the grid."""
    if type(grid).__name__ in ("Cylinder2DGrid", "Sphere2DGrid",
                               "Sphere3DGrid", "Cylinder3DGrid", "TetraGrid",
                               "ClumpySphericalGrid"):
        raise NotImplementedError(f"DustEmission on a {type(grid).__name__} "
                                  "not ported yet")
    return grid.cell_bounds()
