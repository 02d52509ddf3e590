"""Probes: outputs of internal simulation state.

Port of the part of `skirt9_tpu/probes/probes.py` that bench2's,
bench3's and bench4's probes reach: the per-cell and planar-cut forms (on
uniform grids, trees and Voronoi grids, whose cells are centred on their
sites), `temperature_probe`, `radiation_field_probe`, the cell
properties (`cellprops`), `ProbeSpec` and `run_probe_system`. A probe is a
function of the simulation state that writes text or FITS files through a
form. Any other probe kind raises NotImplementedError naming itself.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..utils import fits as fitsio


# -------------------------------------------------------------------- forms

def _device(grid):
    """The device of a grid's tables: a Cartesian grid's, a tree's or a
    Voronoi grid's."""
    if hasattr(grid, "box_lo"):
        return grid.box_lo.device
    if hasattr(grid, "rb"):
        return grid.rb.device
    return grid.lo.device if hasattr(grid, "lo") else grid.xb.device


def per_cell_form(path: str, grid, quantities: dict[str, np.ndarray],
                  unit_note: str = "") -> str:
    """Text dump of per-cell values with cell centers
    (ref: PerCellForm / SpatialCellPropertiesProbe)."""
    centers = grid.cell_centers().cpu().numpy().astype(np.float64)
    cols = [centers[:, 0], centers[:, 1], centers[:, 2]]
    names = ["x", "y", "z"]
    for k, v in quantities.items():
        cols.append(np.asarray(v, np.float64))
        names.append(k)
    header = ("# skirt9_tpu_torch per-cell probe\n# columns: "
              + " ".join(names) + ("\n# " + unit_note if unit_note else ""))
    with open(path, "w") as f:
        f.write(header + "\n")
        np.savetxt(f, np.column_stack(cols))
    return path


def planar_cut_form(path: str, grid, values_fn, axis: str = "z",
                    offset: float = 0.0, npix: int = 256) -> str:
    """FITS image of a scalar field on a planar cut through the domain
    (ref: DefaultCutsForm / PlanarCutsForm): values_fn(pos (N, 3)) -> (N,).
    The cut spans the grid's borders, or a tree's or Voronoi grid's box."""
    if type(grid).__name__ in ("Sphere2DGrid", "Sphere3DGrid",
                               "Cylinder3DGrid", "TetraGrid",
                               "ClumpySphericalGrid"):
        raise NotImplementedError(f"planar cuts of a {type(grid).__name__} "
                                  "not ported yet")
    if hasattr(grid, "xb"):
        lo = [float(grid.xb[0]), float(grid.yb[0]), float(grid.zb[0])]
        hi = [float(grid.xb[-1]), float(grid.yb[-1]), float(grid.zb[-1])]
    elif not hasattr(grid, "box_lo"):
        raise NotImplementedError(f"planar cuts of a {type(grid).__name__} "
                                  "not ported yet")
    else:
        lo = grid.box_lo.cpu().numpy().astype(np.float64)
        hi = grid.box_hi.cpu().numpy().astype(np.float64)
    ax = {"x": 0, "y": 1, "z": 2}[axis]
    a1, a2 = [i for i in range(3) if i != ax]
    u = np.linspace(lo[a1], hi[a1], npix)
    v = np.linspace(lo[a2], hi[a2], npix)
    U, V = np.meshgrid(u, v)
    pos = np.zeros((npix * npix, 3))
    pos[:, a1] = U.ravel()
    pos[:, a2] = V.ravel()
    pos[:, ax] = offset
    pos_t = torch.tensor(pos.astype(np.float32), device=_device(grid))
    vals = values_fn(pos_t).cpu().numpy().astype(np.float64)
    fitsio.write_fits(path, vals.reshape(npix, npix).astype(np.float32),
                      {"CUTAXIS": axis, "CUTOFFS": offset})
    return path


def cell_scalar_fn(grid, per_cell: np.ndarray):
    """Lift a per-cell array to a position-valued function for cuts."""
    vals = torch.tensor(np.asarray(per_cell, np.float32),
                        device=_device(grid))

    def fn(pos):
        c = grid.locate(pos)
        return torch.where(c >= 0, vals[torch.clamp_min(c, 0)],
                           torch.zeros((), device=vals.device))
    return fn


# ------------------------------------------------------------------- probes

def temperature_probe(sim, rf, prefix: str, outdir: str = "."):
    """Indicative equilibrium dust temperature per cell + cuts
    (ref: TemperatureProbe)."""
    T = np.asarray(sim.dust_temperature(rf), np.float64)
    paths = [per_cell_form(os.path.join(outdir, f"{prefix}_temperature.dat"),
                           sim.grid, {f"T_{h}": T[:, h]
                                      for h in range(T.shape[1])},
                           "equilibrium dust temperature [K]")]
    fn = cell_scalar_fn(sim.grid, T[:, 0])
    paths.append(planar_cut_form(
        os.path.join(outdir, f"{prefix}_temperature_z.fits"), sim.grid, fn))
    return paths


def radiation_field_probe(sim, rf, prefix: str, outdir: str = "."):
    """Mean intensity J_lambda per cell per RF bin [W/m2/m/sr]
    (ref: RadiationFieldProbe)."""
    rf64 = rf.cpu().numpy().astype(np.float64) * sim.rf_scale
    vols = np.asarray(sim.grid.volumes(), np.float64)
    dlam = np.diff(np.asarray(sim.rf_borders, np.float64))
    J = rf64 / (4 * np.pi * vols[:, None] * dlam[None, :])
    q = {f"J_{i}": J[:, i] for i in range(J.shape[1])}
    return [per_cell_form(os.path.join(outdir, f"{prefix}_radiationfield.dat"),
                          sim.grid, q, "mean intensity [W/m2/m/sr]")]


def cell_properties_probe(sim, rf, prefix: str, outdir: str = "."):
    """Volume and number density of every component per cell
    (ref: SpatialCellPropertiesProbe; reference `probes.py:838-846`)."""
    nd = sim.medium.nd.cpu().numpy().astype(np.float64)
    q = {"volume": np.asarray(sim.grid.volumes(), np.float64)}
    for h in range(nd.shape[1]):
        q[f"nd_{h}"] = nd[:, h]
    return [per_cell_form(os.path.join(outdir, f"{prefix}_cellprops.dat"),
                          sim.grid, q,
                          "cell volume [m3], number densities [1/m3]")]


_KINDS = {"temperature": temperature_probe,
          "radiationfield": radiation_field_probe,
          "cellprops": cell_properties_probe}
# the kinds that read the radiation field, and write nothing without one
_NEEDS_RF = ("temperature", "radiationfield")


class ProbeSpec:
    """One configured probe: fires at a phase boundary (ref: Probe.hpp:40
    probeAfter Setup/Run + ProbeSystem hooks)."""

    def __init__(self, kind: str, name: str, when: str = "Setup"):
        if kind not in _KINDS:
            raise NotImplementedError(f"probe kind '{kind}' not ported yet "
                                      f"({', '.join(_KINDS)})")
        self.kind = kind
        self.name = name
        self.when = when  # "Setup" | "Run"

    def run(self, sim, prefix: str, outdir: str, rf=None):
        """The temperature and radiation-field probes read the radiation
        field: without one they write nothing."""
        if rf is None and self.kind in _NEEDS_RF:
            return []
        return _KINDS[self.kind](sim, rf, f"{prefix}_{self.name}", outdir)


def run_probe_system(sim, when: str, prefix: str, outdir: str = ".",
                     rf=None) -> list:
    """Fire every configured probe whose hook matches `when`
    (ref: ProbeSystem::probeSetup/probeRun, ProbeSystem.hpp:54-57)."""
    paths = []
    for spec in sim.probes:
        if spec.when == when:
            paths.extend(spec.run(sim, prefix, outdir, rf=rf))
    return paths
