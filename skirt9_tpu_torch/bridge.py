"""Convert a reference `skirt9_tpu.simulation.Simulation` into port objects.

Used by the tests to run one configuration through both packages, on
uniform and meshed Cartesian grids, on the trees the reference's loader
builds, on adaptive meshes, on Voronoi grids with imported star particles,
and on 1D spheres and 2D cylinders with geometric sources (their
geometries and decorators converted class by class), and with the
imported snapshots, geometries and sources (particles with a blackbody or
an SED family, cells, AMR leaves and Voronoi cells). The reference's
arrays are read with `np.asarray`, and its classes are matched by name, so
this module never imports jax or the reference's jax modules. Anything the
port does not run yet raises NotImplementedError. Where the reference runs
the large-grid (XL) engine (its `_sweep_tabs`, also a tree on its voxel
raster), the port's Simulation gets its own XL tables of the same kind, the
cell map equal to the reference's; where it rasterizes a Voronoi grid, the
port's own raster at the reference's resolution, its leaf map equal to the
reference's owner map. With `simulation(..., march=True)` the port has no
sweep tables where the reference has none, which on the CPU is every
configuration (the reference sweeps only on its accelerator): both run the
scan march, and a tree keeps no leaf map, as the reference's CPU tree has
none.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .grids.bintree import BinTreeGrid
from .geometries import analytic, axial, decorators, imported
from .grids.amr import AMRGrid
from .grids.cartesian import CartesianGrid, UniformCartesianGrid
from .grids.clumpy import ClumpySphericalGrid
from .grids.cylinder import Cylinder2DGrid
from .grids.octree import OctreeGrid
from .grids import polar
from .grids.sphere import Sphere1DGrid, length_shift
from .grids.tetra import TetraGrid
from .grids.voronoi import VoronoiGrid
from .imports import snapshots as snaps
from .imports.snapshots import FamilyParticleSource, ParticleSnapshot
from .instruments.allsky import AllSkyInstrumentCfg
from .instruments.distant import DistantInstrumentCfg
from .instruments.perspective import PerspectiveInstrumentCfg
from .media.system import MediumTables
from .ops.stokes import MuellerTables
from .simulation import Simulation
from .sources.base import GeometricSource, PointSource, TabulatedSED
from .spectral.sedfamily import FamilyTables, SEDFamily
from .transport import raster
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
    if name == "AMRGrid":
        return AMRGrid(**{
            f: int(getattr(ref_grid, f)) if f == "depth" else
            torch.tensor(np.asarray(getattr(ref_grid, f)))
            for f in AMRGrid._fields})
    if name in ("VoronoiGrid", "TetraGrid"):
        cls = VoronoiGrid if name == "VoronoiGrid" else TetraGrid
        return cls(**{
            f: int(getattr(ref_grid, f)) if f == "walk_steps" else
            torch.tensor(np.asarray(getattr(ref_grid, f)))
            for f in cls._fields})
    if name == "ClumpySphericalGrid":
        # the sphere beneath, the retained clumps and the set-up volumes
        # as the reference holds them
        sph = polar.make_sphere3d(0.0, 0, 0, len(ref_grid.pb) - 1, **{
            f: np.asarray(getattr(ref_grid, f)) for f in ("rb", "tb", "pb")})
        return ClumpySphericalGrid(
            sph=sph, ccen=torch.tensor(np.asarray(ref_grid.ccen)),
            crad=torch.tensor(np.asarray(ref_grid.crad)),
            vols=torch.tensor(np.asarray(ref_grid.vols_np, np.float64)))
    if name in ("Sphere2DGrid", "Sphere3DGrid", "Cylinder3DGrid"):
        # the border tables as they are; the port tabulates their cosines
        # and sines
        b = {f: np.asarray(getattr(ref_grid, f))
             for f in ("rb", "tb", "pb", "zb") if hasattr(ref_grid, f)}
        if name == "Sphere2DGrid":
            return polar.make_sphere2d(0.0, 0, 0, **b)
        if name == "Sphere3DGrid":
            return polar.make_sphere3d(0.0, 0, 0, len(b["pb"]) - 1, **b)
        return polar.make_cylinder3d(0.0, 0.0, 0.0, 0, len(b["pb"]) - 1, 0,
                                     **b)
    if name == "CartesianGrid":
        return CartesianGrid(*(_f32(b) for b in (ref_grid.xb, ref_grid.yb,
                                                 ref_grid.zb)))
    if name == "Sphere1DGrid":
        return Sphere1DGrid(rb=_f32(ref_grid.rb),
                            shift=length_shift(ref_grid.rb))
    if name == "Cylinder2DGrid":
        return Cylinder2DGrid(rb=_f32(ref_grid.rb), zb=_f32(ref_grid.zb),
                              shift=length_shift(ref_grid.rb, ref_grid.zb))
    _kind(ref_grid, "UniformCartesianGrid")
    return UniformCartesianGrid(
        lo=_f32(ref_grid.lo), hi=_f32(ref_grid.hi), inv_h=_f32(ref_grid.inv_h),
        h=_f32(ref_grid.h), nx=int(ref_grid.nx), ny=int(ref_grid.ny),
        nz=int(ref_grid.nz))


def medium(ref_med) -> MediumTables:
    _kind(ref_med, "MediumTables")
    arr = getattr(ref_med, "magnetic_field", None)
    if arr is not None and np.any(np.asarray(arr) != 0):
        raise NotImplementedError("medium magnetic_field not ported yet")
    return MediumTables(nd=_f32(ref_med.nd), lam_t=_f32(ref_med.lam_t),
                        sigma_ext=_f32(ref_med.sigma_ext),
                        sigma_sca=_f32(ref_med.sigma_sca), g=_f32(ref_med.g),
                        bulk_v=_f32(ref_med.bulk_v),
                        temperature=_f32(ref_med.temperature),
                        metallicity=_f32(ref_med.metallicity))


def mueller(ref_tabs) -> MuellerTables | None:
    """The reference's Mueller tables, array for array."""
    if ref_tabs is None:
        return None
    _kind(ref_tabs, "MuellerTables")
    return MuellerTables(*(_f32(t) for t in ref_tabs))


def xray_tables(ref_tabs) -> dict | None:
    """The reference's X-ray channel tables, array for array (on the CPU;
    the Simulation moves them to its device)."""
    if ref_tabs is None:
        return None
    return {k: _f32(v) for k, v in ref_tabs.items()}


def _same_fields(cls, ref_obj):
    return cls(**{f.name: getattr(ref_obj, f.name)
                  for f in dataclasses.fields(cls)})


def sed(ref_sed) -> TabulatedSED | None:
    if ref_sed is None:
        return None
    _kind(ref_sed, "TabulatedSED")
    return TabulatedSED(lam=np.asarray(ref_sed.lam, np.float64),
                        s=np.asarray(ref_sed.s, np.float64))


def snapshot(ref_ss):
    """A reference snapshot, class by name and field by field."""
    cls = getattr(snaps, type(ref_ss).__name__, None)
    if cls is None or not dataclasses.is_dataclass(ref_ss):
        raise NotImplementedError(f"snapshot {type(ref_ss).__name__} not "
                                  "ported yet")
    return cls(**{f.name: getattr(ref_ss, f.name)
                  for f in dataclasses.fields(cls)})


def _family_tables(ft) -> FamilyTables:
    """The family tables rebuilt from a reference family over the same
    clip range."""
    fam = ft.family
    return FamilyTables(SEDFamily(lam=np.asarray(fam.lam),
                                  L=np.asarray(fam.L),
                                  param_axes=list(fam.param_axes),
                                  scale_name=fam.scale_name),
                        lam_range=ft.lam_range)


def _family_source(ref_src) -> FamilyParticleSource:
    """A reference FamilyParticleSource: its particles, and the family
    tables rebuilt from its family over the same clip range."""
    snap = ref_src.snapshot
    return FamilyParticleSource(
        snapshot=ParticleSnapshot(positions=snap.positions, h=snap.h,
                                  mass=snap.mass, velocity=snap.velocity),
        family_tables=_family_tables(ref_src.family_tables),
        scales=np.asarray(ref_src.scales), params=np.asarray(ref_src.params),
        kernel_kind=ref_src.kernel_kind)


def geometry(ref_geom):
    """A reference analytic geometry or decorator (nested ones too), class
    by name and field by field."""
    name = type(ref_geom).__name__
    cls = next((getattr(m, name) for m in (analytic, axial, decorators,
                                           imported)
                if hasattr(m, name)), None)
    if cls is None or not dataclasses.is_dataclass(ref_geom):
        raise NotImplementedError(f"geometry {name} not ported yet")

    def conv(v):
        if hasattr(v, "density_np"):
            return geometry(v)
        if type(v).__name__.endswith("Snapshot"):
            return snapshot(v)
        if type(v).__name__ == "AMRGrid":
            return grid(v)
        return v
    return cls(**{f.name: conv(getattr(ref_geom, f.name))
                  for f in dataclasses.fields(cls) if f.init})


def source(ref_src):
    name = type(ref_src).__name__
    if name == "FamilyParticleSource":
        return _family_source(ref_src)
    if name == "ParticleSource":
        return snaps.ParticleSource(
            snapshot=snapshot(ref_src.snapshot),
            luminosities=np.asarray(ref_src.luminosities),
            temperatures=np.asarray(ref_src.temperatures))
    if name == "CellFamilySource":
        return snaps.CellFamilySource(
            lo=np.asarray(ref_src.lo), hi=np.asarray(ref_src.hi),
            family_tables=_family_tables(ref_src.family_tables),
            scales=np.asarray(ref_src.scales),
            params=np.asarray(ref_src.params), velocity=ref_src.velocity)
    if name == "EntityFamilySource":
        return snaps.EntityFamilySource(
            sampler=geometry(ref_src.sampler),
            family_tables=_family_tables(ref_src.family_tables),
            scales=np.asarray(ref_src.scales),
            params=np.asarray(ref_src.params), velocity=ref_src.velocity)
    if type(ref_src).__name__ == "GeometricSource":
        return dataclasses.replace(_same_fields(GeometricSource, ref_src),
                                   geometry=geometry(ref_src.geometry),
                                   sed=sed(ref_src.sed))
    _kind(ref_src, "PointSource")
    return dataclasses.replace(_same_fields(PointSource, ref_src),
                               sed=sed(ref_src.sed))


def instrument(ref_cfg):
    """A distant, all-sky (HEALPix) or perspective instrument, field for
    field."""
    for cls in (DistantInstrumentCfg, AllSkyInstrumentCfg,
                PerspectiveInstrumentCfg):
        if type(ref_cfg).__name__ == cls.__name__:
            return _same_fields(cls, ref_cfg)
    _kind(ref_cfg, "DistantInstrumentCfg")


def options(ref_opts) -> TransportOptions:
    _kind(ref_opts, "TransportOptions")
    return _same_fields(TransportOptions, ref_opts)


# reference Simulation fields the port does not run yet, with their
# inactive values
_INACTIVE = {"spheroidal": None, "mesh": None, "dd": False,
             "phase_tabs": None, "dynamic_recipes": [],
             "gas_emitters": [], "custom_state": {}, "grain_tables": None}

# the reference's dust-emission fields, carried over as they are
_EMISSION = ("ems_borders", "spatial_bias", "iterate_secondary",
             "include_primary", "min_iterations", "max_iterations",
             "max_fraction_of_primary", "max_fraction_of_previous",
             "secondary_packets_multiplier", "dust_emission_type",
             "cell_library", "cmb_temperature", "checkpoint_path")


def simulation(ref_sim, device, march: bool = False) -> Simulation:
    """The port's Simulation of a reference Simulation, on `device`. march:
    leave the port's `_sweep_tabs` None where the reference's is None, so
    that the port runs the scan march where the reference does (by
    default the port keeps its own engine choice, without the reference's
    backend test)."""
    active = [k for k, v in _INACTIVE.items()
              if getattr(ref_sim, k, v) not in (v, None)]
    if "dynamic_recipes" in active:
        # the merged and primary iterations run without them
        raise NotImplementedError("dynamic medium recipes (media/dynamic) "
                                  "not ported yet")
    if "spheroidal" in active:
        raise NotImplementedError("spheroidal (aligned-grain polarized) "
                                  "emission not ported yet")
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
        refill_events=int(ref_sim.refill_events),
        mueller=mueller(getattr(ref_sim, "mueller", None)),
        xray_tabs=xray_tables(getattr(ref_sim, "xray_tabs", None)),
        device=device,
        **{k: getattr(ref_sim, k) for k in _EMISSION})
    ref_tabs = getattr(ref_sim, "_sweep_tabs", None)
    if march and ref_tabs is None:
        sim._sweep_tabs = None
        if isinstance(sim.grid, (OctreeGrid, BinTreeGrid)):
            # the reference's CPU tree has no leaf map: launches locate by
            # descent, as its march does
            sim.grid = sim.grid._replace(leafmap=None, fine_n=())
    elif type(ref_tabs).__name__ == "XLTables":
        _xl_tables(sim, ref_tabs)
    elif isinstance(sim.grid, (VoronoiGrid, TetraGrid)) \
            and ref_tabs is not None:
        _raster_tables(sim, ref_tabs)
    return sim


def _raster_tables(sim: Simulation, ref_tabs) -> None:
    """Put the port's raster at the reference's resolution in place where
    the reference rasterizes a Voronoi or tetrahedral grid; its leaf map is
    checked equal to the reference's owner map."""
    tabs = raster.build_tables(sim.grid, sim.medium,
                               resolution=tuple(ref_tabs.n))
    if not np.array_equal(tabs.leafmap.cpu().numpy(),
                          np.asarray(ref_tabs.leafmap)):
        raise ValueError("the port's raster differs from the reference's "
                         "owner map")
    sim._sweep_tabs = tabs


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
