"""Convert a reference `skirt9_tpu.simulation.Simulation` into port objects.

Used by the tests to run one configuration through both packages, on
uniform grids and on the trees the reference's loader builds. The
reference's arrays are read with `np.asarray`, and its classes are matched
by name, so this module never imports jax or the reference's jax modules.
Anything the port does not run yet raises NotImplementedError. Where the
reference runs the large-grid (XL) engine (its `_sweep_tabs`, also a tree
on its voxel raster), the port's Simulation gets its own XL tables of the
same kind, the cell map equal to the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .grids.bintree import BinTreeGrid
from .grids.cartesian import UniformCartesianGrid
from .grids.octree import OctreeGrid
from .instruments.distant import DistantInstrumentCfg
from .media.system import MediumTables
from .simulation import Simulation
from .sources.base import PointSource, TabulatedSED
from .transport import sweepxl as xl
from .transport.lifecycle import TransportOptions


def _f32(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _kind(obj, name: str) -> None:
    if type(obj).__name__ != name:
        raise NotImplementedError(f"{type(obj).__name__} not ported yet "
                                  f"(expected {name})")


def _tree(cls, ref_grid):
    """A tree grid field by field; a reference leaf map is left behind (the
    port's Simulation builds its own)."""
    fields = {}
    for name in cls._fields:
        if name in ("leafmap", "fine_n"):
            continue
        value = getattr(ref_grid, name)
        if name == "levels":
            fields[name] = int(value)
        else:
            arr = np.asarray(value)
            fields[name] = torch.tensor(
                arr.astype(np.int32 if arr.dtype.kind in "iu" else np.float32))
    return cls(**fields)


def grid(ref_grid):
    name = type(ref_grid).__name__
    if name == "OctreeGrid":
        return _tree(OctreeGrid, ref_grid)
    if name == "BinTreeGrid":
        return _tree(BinTreeGrid, ref_grid)
    _kind(ref_grid, "UniformCartesianGrid")
    return UniformCartesianGrid(
        lo=_f32(ref_grid.lo), hi=_f32(ref_grid.hi), inv_h=_f32(ref_grid.inv_h),
        h=_f32(ref_grid.h), nx=int(ref_grid.nx), ny=int(ref_grid.ny),
        nz=int(ref_grid.nz))


def medium(ref_med) -> MediumTables:
    _kind(ref_med, "MediumTables")
    for name in ("bulk_v", "magnetic_field"):
        arr = getattr(ref_med, name, None)
        if arr is not None and np.any(np.asarray(arr) != 0):
            raise NotImplementedError(f"medium {name} not ported yet")
    return MediumTables(nd=_f32(ref_med.nd), lam_t=_f32(ref_med.lam_t),
                        sigma_ext=_f32(ref_med.sigma_ext),
                        sigma_sca=_f32(ref_med.sigma_sca), g=_f32(ref_med.g))


def _same_fields(cls, ref_obj):
    return cls(**{f.name: getattr(ref_obj, f.name)
                  for f in dataclasses.fields(cls)})


def sed(ref_sed) -> TabulatedSED | None:
    if ref_sed is None:
        return None
    _kind(ref_sed, "TabulatedSED")
    return TabulatedSED(lam=np.asarray(ref_sed.lam, np.float64),
                        s=np.asarray(ref_sed.s, np.float64))


def source(ref_src) -> PointSource:
    _kind(ref_src, "PointSource")
    return dataclasses.replace(_same_fields(PointSource, ref_src),
                               sed=sed(ref_src.sed))


def instrument(ref_cfg) -> DistantInstrumentCfg:
    _kind(ref_cfg, "DistantInstrumentCfg")
    return _same_fields(DistantInstrumentCfg, ref_cfg)


def options(ref_opts) -> TransportOptions:
    _kind(ref_opts, "TransportOptions")
    return _same_fields(TransportOptions, ref_opts)


# reference Simulation fields the port does not run yet, with their
# inactive values
_INACTIVE = {"mueller": None, "spheroidal": None, "mesh": None, "dd": False,
             "xray_tabs": None, "phase_tabs": None, "dynamic_recipes": [],
             "gas_emitters": [], "custom_state": {}, "grain_tables": None}

# the reference's dust-emission fields, carried over as they are
_EMISSION = ("ems_borders", "spatial_bias", "iterate_secondary",
             "include_primary", "min_iterations", "max_iterations",
             "max_fraction_of_primary", "max_fraction_of_previous",
             "secondary_packets_multiplier", "dust_emission_type",
             "cell_library", "cmb_temperature", "checkpoint_path")


def simulation(ref_sim, device) -> Simulation:
    """The port's Simulation of a reference Simulation, on `device`."""
    active = [k for k, v in _INACTIVE.items()
              if getattr(ref_sim, k, v) not in (v, None)]
    if "dynamic_recipes" in active:
        # the merged and primary iterations run without them
        raise NotImplementedError("dynamic medium recipes (media/dynamic) "
                                  "not ported yet")
    if active:
        raise NotImplementedError(
            f"Simulation {', '.join(active)} not ported yet")
    rfb = ref_sim.rf_borders
    sim = Simulation(
        grid=grid(ref_sim.grid), medium=medium(ref_sim.medium),
        sources=[source(s) for s in ref_sim.sources],
        instruments=[instrument(c) for c in ref_sim.instruments],
        options=options(ref_sim.options),
        rf_borders=None if rfb is None else np.asarray(rfb, np.float64),
        num_packets=int(ref_sim.num_packets),
        batch_size=int(ref_sim.batch_size), seed=int(ref_sim.seed),
        source_bias=float(ref_sim.source_bias),
        refill_events=int(ref_sim.refill_events), device=device,
        **{k: getattr(ref_sim, k) for k in _EMISSION})
    ref_tabs = getattr(ref_sim, "_sweep_tabs", None)
    if type(ref_tabs).__name__ == "XLTables":
        _xl_tables(sim, ref_tabs)
    return sim


def _xl_tables(sim: Simulation, ref_tabs) -> None:
    """Put the port's XL tables in place where the reference runs its XL
    engine: on a tree's voxel raster (its cell map, checked equal to the
    reference's, also the grid's leaf map) or on the uniform grid."""
    if ref_tabs.cellmap is None:
        sim._sweep_tabs = xl.build_tables(sim.grid, sim.medium)
        return
    tabs = xl.build_tree_tables(sim.grid, sim.medium)
    if not np.array_equal(tabs.cellmap.cpu().numpy(),
                          np.asarray(ref_tabs.cellmap)):
        raise ValueError("the port's tree raster differs from the "
                         "reference's cell map")
    sim._sweep_tabs = tabs
    sim.grid = sim.grid._replace(leafmap=tabs.cellmap, fine_n=tabs.n)
