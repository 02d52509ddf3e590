"""ski-file loader: build a port Simulation from a SKIRT 9 parameter file.

Port of `skirt9_tpu/config/ski.py` (`load_ski`, `_load_ski` and the
`build_*` functions) for the item types the port runs: primary emission
of point sources with a blackbody, file or Gaussian Lyman-alpha SED (or
oligochromatic, at one wavelength), of imported entities with a blackbody,
indexed or SSP family (`ParticleSource` with any of the four smoothing
kernels, `CellSource`, `VoronoiMeshSource`, `AdaptiveMeshSource`),
geometric sources (`GeometricSource`) and media of every analytic, axial,
imported and decorator geometry the reference's loader builds (the
imported ones: `ParticleGeometry`, `CellGeometry`,
`CylindricalCellGeometry`, `SphericalCellGeometry`, `VoronoiMeshGeometry`,
`AdaptiveMeshGeometry`), of trivial gas, mean-file dust, the reference's
mean interstellar dust, electron (with polarized Thomson
scattering), neutral-hydrogen Lyman-alpha (`LyaExtinctionOnly` with its
`LyaOptions`) or X-ray atomic gas mixes normalised by optical depth,
entity number or number column, moving media (a vector field times a
velocity magnitude, sampled at the cell centres), an imported Voronoi mesh
medium (`VoronoiMeshMedium`, one density per site) on its own
`VoronoiMeshSpatialGrid` (policy ImportedMesh), an imported adaptive mesh
(`AdaptiveMeshMedium`) on its own `AdaptiveMeshSpatialGrid`, imported
particle and cell media (`ParticleMedium`, `CellMedium`) resampled onto
any grid below (the media's metallicity, temperature and velocity
imports as the reference reads them), Cartesian grids (linear
meshes, or any of the reference's meshes: power-law, symmetric power-law,
logarithmic, symmetric logarithmic, symmetric cosine, tabulated, list and
file meshes, which the scan march walks), the 1D sphere and the 2D
cylinder (`Sphere1DSpatialGrid`, `Cylinder2DSpatialGrid`, on the march),
the polar grids (`Sphere2DSpatialGrid`, `Sphere3DSpatialGrid`,
`Cylinder3DSpatialGrid`, on the march), the clumpy sphere
(`ClumpySphericalSpatialGrid`, its clumps from a text file, on the
march), standalone Voronoi and
tetrahedral meshes (`VoronoiMeshSpatialGrid`, `TetraMeshSpatialGrid`)
with the DustDensity and Uniform site policies and Lloyd relaxation,
and density-policy octrees and bintrees
(`PolicyTreeSpatialGrid` with a `DensityTreePolicy`), full and SED
instruments (with polarization) on logarithmic or linear wavelength grids,
equilibrium dust emission over all cells with the iteration options (on
the 1D sphere too, its shells launched in their bounding cubes), and
the temperature, radiation-field and cell-properties probes. This is what
the golden ski files bench1, bench1h, bench2, bench3, bench4, bench5,
bench6 and bench7 use. Every item type outside `ITEMS`, and every property
outside `PROPERTIES`, raises NotImplementedError naming itself before
anything is built, so no element is dropped silently. The arrays are built
with numpy and torch by the port's own constructors, bit for bit as the
reference's loader builds them. The parameters.xml round trip is not ported.

Usage:
    sim = load_ski("model.ski", num_packets=..., device="cpu")
    rf, accs = sim.run_primary()      (or run_with_dust_emission)
"""

from __future__ import annotations

import dataclasses
import os
import xml.etree.ElementTree as ET

import numpy as np
import torch

from .. import device as dv
from ..geometries import analytic as ga
from ..geometries import axial as gax
from ..geometries import decorators as dec
from ..geometries import imported as ig
from ..geometries import vectorfield as vf
from ..grids import bintree, octree
from ..grids.amr import build_amr
from ..grids import meshes as msh
from ..grids.cartesian import make_cartesian
from ..grids.clumpy import ClumpySphericalGrid, make_clumpy_spherical
from ..grids import polar
from ..grids.cylinder import Cylinder2DGrid, make_cylinder2d
from ..grids.sphere import make_sphere1d
from ..grids.tetra import TetraGrid, build_tetra
from ..grids.voronoi import build_voronoi, density_sites, lloyd_relax
from ..imports import snapshots as snap
from ..instruments import distant as dinst
from ..media import geometric as gm
from ..media import mixes as mx
from ..media import system as msys
from ..media import xray as xr
from ..ops import stokes as stk
from ..probes.probes import ProbeSpec
from ..simulation import Simulation
from ..sources.base import GeometricSource, PointSource
from ..spectral import sedfamily as sf
from ..spectral import seds as sedlib
from ..spectral import wavelengths as wl
from ..transport import lifecycle as lc
from ..utils import constants as const
from ..utils import cosmology as cosmo
from ..utils import units as U
from ..utils import unitsystem

# the item types (capitalised elements) the port builds
ITEMS = frozenset((
    "MonteCarloSimulation", "Random", "SIUnits", "StellarUnits",
    "ExtragalacticUnits", "LocalUniverseCosmology", "FlatUniverseCosmology",
    "SourceSystem", "PointSource", "BlackBodySED", "FileSED",
    "LyaGaussianSED", "ParticleSource", "CubicSplineSmoothingKernel",
    "FileSSPSEDFamily",
    "IntegratedLuminosityNormalization",
    "MediumSystem", "PhotonPacketOptions", "RadiationFieldOptions",
    "DustEmissionOptions", "AllCellsLibrary", "LogWavelengthGrid",
    "GeometricMedium", "ShellGeometry", "ExpDiskGeometry", "TrivialGasMix",
    "MeanFileDustMix", "ElectronMix", "LyaNeutralHydrogenGasMix",
    "XRayAtomicGasMix", "LyaOptions", "OpticalDepthMaterialNormalization",
    "NumberMaterialNormalization", "NumberColumnMaterialNormalization",
    "LinWavelengthGrid", "RadialVectorField",
    "CylindricalVectorField", "HollowRadialVectorField",
    "HubbleRadialVectorField", "UnidirectionalVectorField",
    "RotateVectorFieldDecorator", "OffsetVectorFieldDecorator",
    "CartesianSpatialGrid", "LinMesh", "PowMesh", "SymPowMesh", "LogMesh",
    "SymLogMesh", "SymCosMesh", "TabulatedMesh", "ListMesh", "FileMesh",
    "VoronoiMeshMedium",
    "VoronoiMeshSpatialGrid",
    "PolicyTreeSpatialGrid", "DensityTreePolicy", "IterationOptions",
    "InstrumentSystem", "FullInstrument", "SEDInstrument",
    "ProbeSystem", "TemperatureProbe", "RadiationFieldProbe", "PerCellForm",
    "SpatialCellPropertiesProbe",
    # analytic geometries, their decorators and sources, and the 1D sphere
    # and 2D cylinder grids
    "GeometricSource", "PlummerGeometry", "GammaGeometry",
    "GaussianGeometry", "SersicGeometry", "UniformSphereGeometry",
    "EinastoGeometry", "PseudoSersicGeometry", "UniformBoxGeometry",
    "TorusGeometry", "ConicalShellGeometry", "TTauriDiskGeometry",
    "RingGeometry", "AnnulusGeometry", "DonutGeometry",
    "BrokenExpDiskGeometry", "OffsetGeometryDecorator",
    "RotateGeometryDecorator", "SpheroidalGeometryDecorator",
    "TriaxialGeometryDecorator", "SphericalClipGeometryDecorator",
    "SphePowerLawRedistributeGeometryDecorator",
    "AxPowerLawRedistributeGeometryDecorator", "BoxClipGeometryDecorator",
    "CylindricalClipGeometryDecorator", "CombineGeometryDecorator",
    "ClumpyGeometryDecorator", "SpiralStructureGeometryDecorator",
    "Sphere1DSpatialGrid", "Cylinder2DSpatialGrid",
    # the polar grids and the tetrahedral mesh (the unstructured grids' site
    # policies DustDensity and Uniform on VoronoiMeshSpatialGrid too)
    "Sphere2DSpatialGrid", "Sphere3DSpatialGrid", "Cylinder3DSpatialGrid",
    "TetraMeshSpatialGrid", "ClumpySphericalSpatialGrid",
    # imported snapshots: AMR meshes, particle and cell media, the mesh and
    # cell sources with their SED families, the imported geometries
    "AdaptiveMeshMedium", "AdaptiveMeshSpatialGrid", "ParticleMedium",
    "CellMedium", "CellSource", "VoronoiMeshSource", "AdaptiveMeshSource",
    "BlackBodySEDFamily", "FileIndexedSEDFamily",
    "QuarticSplineSmoothingKernel", "UniformSmoothingKernel",
    "ScaledGaussianSmoothingKernel", "MeanInterstellarDustMix",
    "ParticleGeometry", "CellGeometry", "CylindricalCellGeometry",
    "SphericalCellGeometry", "VoronoiMeshGeometry",
    "AdaptiveMeshGeometry"))

# the imported geometries (`build_imported_geometry`)
IMPORTED_GEOMETRIES = ("ParticleGeometry", "CellGeometry",
                       "CylindricalCellGeometry", "SphericalCellGeometry",
                       "VoronoiMeshGeometry", "AdaptiveMeshGeometry")

# the reference's AMR unit constants (`skirt9_tpu/config/ski.py:1944`)
_MSUN, _PC = 1.98892e30, 3.0857e16

# the properties (lower-case elements) that hold those items
PROPERTIES = frozenset((
    "random", "units", "cosmology", "sourceSystem", "sources", "sed",
    "smoothingKernel", "sedFamily",
    "normalization", "mediumSystem", "photonPacketOptions", "lyaOptions",
    "radiationFieldOptions", "radiationFieldWLG", "dustEmissionOptions",
    "cellLibrary", "dustEmissionWLG", "media", "geometry", "materialMix",
    "velocityDistribution", "vectorField", "grid", "meshX", "meshY", "meshZ", "policy", "iterationOptions",
    "instrumentSystem",
    "defaultWavelengthGrid", "instruments", "wavelengthGrid", "probeSystem",
    "probes", "form", "firstGeometry", "secondGeometry", "meshRadial",
    "meshPolar", "meshAzimuthal"))

# simulation modes of those items (the reference's `mode` branches)
MODES = ("ExtinctionOnly", "OligoExtinctionOnly", "DustEmission",
         "LyaExtinctionOnly")

# probe item -> (the reference's probe kind, its default hook)
PROBES = {"TemperatureProbe": ("temperature", "Run"),
          "RadiationFieldProbe": ("radiationfield", "Run"),
          "SpatialCellPropertiesProbe": ("cellprops", "Setup")}


def _q(attrs, name, qty, default=None):
    """Parse a unit-bearing attribute into SI."""
    if name not in attrs:
        if default is None:
            raise KeyError(f"missing attribute '{name}'")
        return default
    return U.parse(qty, attrs[name])


def _f(attrs, name, default=None):
    if name not in attrs:
        if default is None:
            raise KeyError(f"missing attribute '{name}'")
        return default
    return float(attrs[name])


def _child(el, tag):
    c = el.find(tag)
    return list(c)[0] if c is not None and len(c) else None


def check_items(root) -> None:
    """Raise NotImplementedError naming the first element outside ITEMS
    and PROPERTIES (the document root excepted)."""
    for el in root.iter():
        if el is root:
            continue
        if el.tag[:1].isupper() and el.tag not in ITEMS:
            raise NotImplementedError(
                f"ski item type '{el.tag}' not ported yet")
        if not el.tag[:1].isupper() and el.tag not in PROPERTIES:
            raise NotImplementedError(
                f"ski property '{el.tag}' not ported yet")


# ------------------------------------------------------- build functions

def build_geometry(el, base_dir: str = "."):
    """An analytic, axial or imported geometry or a decorator of one
    (`skirt9_tpu/config/ski.py:84-263`), with the reference's attributes,
    defaults and units; an imported geometry's file resolves against
    base_dir, also inside a decorator."""
    t, a = el.tag, el.attrib
    if t in IMPORTED_GEOMETRIES:
        return build_imported_geometry(el, base_dir)
    if t == "PlummerGeometry":
        return ga.PlummerGeometry(b=_q(a, "scaleLength", "length"))
    if t == "GammaGeometry":
        return ga.GammaGeometry(b=_q(a, "scaleLength", "length"),
                                gamma=_f(a, "gamma"))
    if t == "ShellGeometry":
        return ga.ShellGeometry(rmin=_q(a, "minRadius", "length"),
                                rmax=_q(a, "maxRadius", "length"),
                                p=_f(a, "exponent", 0.0))
    if t == "GaussianGeometry":
        return ga.GaussianGeometry(sigma=_q(a, "dispersion", "length"))
    if t == "ExpDiskGeometry":
        return ga.ExpDiskGeometry(h_r=_q(a, "scaleLength", "length"),
                                  h_z=_q(a, "scaleHeight", "length"))
    if t == "SersicGeometry":
        return ga.SersicGeometry(reff=_q(a, "effectiveRadius", "length"),
                                 m=_f(a, "index", 4.0))
    if t == "UniformSphereGeometry":
        return ga.UniformSphereGeometry(rmax=_q(a, "maxRadius", "length"))
    if t == "EinastoGeometry":
        # the reference's scale radius from the half-mass radius, on the
        # host: M(< rh) = M / 2 on a log grid to 30 rs
        rh = _q(a, "halfMassRadius", "length")
        n = _f(a, "index")
        x = np.geomspace(1e-4, 30.0, 8192)
        w = x ** 2 * np.exp(-2 * n * (x ** (1.0 / n) - 1.0))
        cum = np.cumsum(w * np.gradient(x))
        xh = x[int(np.searchsorted(cum, 0.5 * cum[-1]))]
        return ga.EinastoGeometry(rs=rh / xh, n=n)
    if t == "PseudoSersicGeometry":
        return ga.PseudoSersicGeometry(
            reff=_q(a, "effectiveRadius", "length"), m=_f(a, "index", 4.0))
    if t == "UniformBoxGeometry":
        x0, x1 = _q(a, "minX", "length"), _q(a, "maxX", "length")
        y0, y1 = _q(a, "minY", "length"), _q(a, "maxY", "length")
        z0, z1 = _q(a, "minZ", "length"), _q(a, "maxZ", "length")
        return ga.UniformBoxGeometry(lx=x1 - x0, ly=y1 - y0, lz=z1 - z0,
                                     cx=0.5 * (x0 + x1), cy=0.5 * (y0 + y1),
                                     cz=0.5 * (z0 + z1))
    if t == "TorusGeometry":
        return gax.TorusGeometry(
            p=_f(a, "exponent"), q=_f(a, "index"),
            delta=_q(a, "openingAngle", "posangle"),
            rmin=_q(a, "minRadius", "length"),
            rmax=_q(a, "maxRadius", "length"))
    if t == "ConicalShellGeometry":
        return gax.ConicalShellGeometry(
            p=_f(a, "exponent"), delta_in=_q(a, "minAngle", "posangle"),
            delta_out=_q(a, "maxAngle", "posangle"),
            rmin=_q(a, "minRadius", "length"),
            rmax=_q(a, "maxRadius", "length"))
    if t == "TTauriDiskGeometry":
        return gax.TTauriDiskGeometry(
            rd=_q(a, "scaleLength", "length"),
            zd=_q(a, "scaleHeight", "length"),
            rinn=_q(a, "minRadius", "length"),
            rout=_q(a, "maxRadius", "length"))
    if t == "RingGeometry":
        return gax.RingGeometry(r0=_q(a, "ringRadius", "length"),
                                width=_q(a, "width", "length"),
                                hz=_q(a, "height", "length"))
    if t == "AnnulusGeometry":
        return gax.AnnulusGeometry(rmin=_q(a, "minRadius", "length"),
                                   rmax=_q(a, "maxRadius", "length"),
                                   height=_q(a, "height", "length"))
    if t == "DonutGeometry":
        return gax.DonutGeometry(r0=_q(a, "largeRadius", "length"),
                                 rc=_q(a, "smallRadius", "length"))
    if t == "BrokenExpDiskGeometry":
        return gax.BrokenExpDiskGeometry(
            h_inn=_q(a, "scaleLengthInner", "length"),
            h_out=_q(a, "scaleLengthOuter", "length"),
            hz=_q(a, "scaleHeight", "length"),
            rb=_q(a, "breakRadius", "length"))
    return build_decorator(el, base_dir)


def build_decorator(el, base_dir: str = "."):
    """A geometry decorator wrapping the geometry of its nested item."""
    t, a = el.tag, el.attrib
    base = lambda: build_geometry(_child(el, "geometry"), base_dir)
    remove_inside = a.get("remove", "Inside") == "Inside"
    if t == "OffsetGeometryDecorator":
        return dec.OffsetDecorator(
            base=base(), offset=(_q(a, "offsetX", "length", 0.0),
                                 _q(a, "offsetY", "length", 0.0),
                                 _q(a, "offsetZ", "length", 0.0)))
    if t == "RotateGeometryDecorator":
        return dec.RotateDecorator(
            base=base(), alpha=_q(a, "eulerAlpha", "posangle", 0.0),
            beta=_q(a, "eulerBeta", "posangle", 0.0),
            gamma=_q(a, "eulerGamma", "posangle", 0.0))
    if t == "SpheroidalGeometryDecorator":
        return dec.SpheroidalDecorator(base=base(),
                                       q=_f(a, "flattening", 1.0))
    if t == "TriaxialGeometryDecorator":
        return dec.TriaxialDecorator(base=base(), p=_f(a, "flatteningY", 1.0),
                                     q=_f(a, "flatteningZ", 1.0))
    if t == "SphericalClipGeometryDecorator":
        return dec.SphereClipDecorator(
            base=base(), remove_inside=remove_inside,
            center=(_q(a, "centerX", "length", 0.0),
                    _q(a, "centerY", "length", 0.0),
                    _q(a, "centerZ", "length", 0.0)),
            radius=_q(a, "clipRadius", "length"))
    if t == "SphePowerLawRedistributeGeometryDecorator":
        return dec.SphePowerLawRedistributeDecorator(
            base=base(), exponent=_f(a, "exponent", 1.0),
            min_radius=_q(a, "minRadius", "length"))
    if t == "AxPowerLawRedistributeGeometryDecorator":
        return dec.AxPowerLawRedistributeDecorator(
            base=base(), exponent=_f(a, "exponent", 1.0),
            min_radius=_q(a, "minRadius", "length"))
    if t == "BoxClipGeometryDecorator":
        return dec.BoxClipDecorator(
            base=base(), remove_inside=remove_inside,
            lo=(_q(a, "minX", "length"), _q(a, "minY", "length"),
                _q(a, "minZ", "length")),
            hi=(_q(a, "maxX", "length"), _q(a, "maxY", "length"),
                _q(a, "maxZ", "length")))
    if t == "CylindricalClipGeometryDecorator":
        return dec.CylinderClipDecorator(
            base=base(), remove_inside=remove_inside,
            radius=_q(a, "clipRadius", "length"))
    if t == "CombineGeometryDecorator":
        return dec.CombineDecorator(
            first=build_geometry(_child(el, "firstGeometry"), base_dir),
            second=build_geometry(_child(el, "secondGeometry"), base_dir),
            w1=_f(a, "firstWeight", 1.0), w2=_f(a, "secondWeight", 1.0))
    if t == "ClumpyGeometryDecorator":
        return dec.ClumpyDecorator(
            base=base(), clump_fraction=_f(a, "clumpFraction", 0.3),
            num_clumps=int(_f(a, "numClumps", 100)),
            clump_radius=_q(a, "clumpRadius", "length"),
            seed=int(_f(a, "seed", 99)) or 99)
    if t == "SpiralStructureGeometryDecorator":
        return dec.SpiralStructureDecorator(
            base=base(), num_arms=int(_f(a, "numArms", 1)),
            pitch_angle=_q(a, "pitchAngle", "posangle", 0.1745),
            radius_zero_point=_q(a, "radiusZeroPoint", "length"),
            phase_zero_point=_q(a, "phaseZeroPoint", "posangle", 0.0),
            perturbation_weight=_f(a, "perturbationWeight", 0.25),
            index=int(_f(a, "index", 1)))
    raise NotImplementedError(f"geometry type '{t}' not ported yet")


def build_imported_geometry(el, base_dir: str):
    """Snapshot data as a normalized geometry (`skirt9_tpu/config/ski.py:
    263-392`; ref: ImportedGeometry.hpp:19): the snapshot's columns in the
    reference's order and units, an imported metallicity scaling each
    entity's mass, a positive maxTemperature dropping the hotter
    entities."""
    t, a = el.tag, el.attrib
    fn = _resolve(a["filename"], base_dir)
    import_z = a.get("importMetallicity", "false") == "true"
    import_t = a.get("importTemperature", "false") == "true"
    max_t = _q(a, "maxTemperature", "temperature", 0.0) if import_t else 0.0
    mt = a.get("massType", "MassDensity")

    def zt_cols(cols):
        if import_z:
            cols.append(("Z", "", ""))
        if import_t:
            cols.append(("T", "temperature", "K"))
        return cols

    def mass_post(mass, d):
        mass = np.asarray(mass, np.float64)
        if import_z:
            mass = mass * d["Z"]
        if import_t and max_t > 0:
            mass = np.where(d["T"] <= max_t, mass, 0.0)
        return mass

    if t == "ParticleGeometry":
        kern_el = _child(el, "smoothingKernel")
        d = snap.read_column_file(fn, zt_cols([
            ("x", "length", "pc"), ("y", "length", "pc"),
            ("z", "length", "pc"), ("h", "length", "pc"),
            ("M", "mass", "Msun")]))
        ss = snap.ParticleSnapshot(
            positions=np.stack([d["x"], d["y"], d["z"]], axis=-1),
            h=d["h"], mass=mass_post(d["M"], d))
        return ig.ParticleGeometry(
            snapshot=ss, kernel_kind=(kern_el.tag if kern_el is not None
                                      else "CubicSplineSmoothingKernel"))
    if t == "CellGeometry":
        cols = [(f"{x}{e}", "length", "pc") for e in ("min", "max")
                for x in "xyz"]
        cols.append(("rho", "massvolumedensity", "Msun/pc3")
                    if mt == "MassDensity" else ("M", "mass", "Msun"))
        d = snap.read_column_file(fn, zt_cols(cols))
        lo = np.stack([d["xmin"], d["ymin"], d["zmin"]], axis=-1)
        hi = np.stack([d["xmax"], d["ymax"], d["zmax"]], axis=-1)
        mass = (d["rho"] * np.prod(hi - lo, axis=-1)
                if mt == "MassDensity" else d["M"])
        return ig.CellGeometry(snapshot=snap.CellSnapshot(
            lo=lo, hi=hi, mass=mass_post(mass, d)))
    if t in ("CylindricalCellGeometry", "SphericalCellGeometry"):
        names = (("R", "phi", "z") if t == "CylindricalCellGeometry"
                 else ("r", "theta", "phi"))
        qty = {"R": ("length", "pc"), "r": ("length", "pc"),
               "z": ("length", "pc"), "phi": ("posangle", "deg"),
               "theta": ("posangle", "deg")}
        cols = [(f"{n}{e}", *qty[n]) for e in ("min", "max") for n in names]
        d = snap.read_column_file(fn, zt_cols(cols + [("M", "mass",
                                                       "Msun")]))
        lo = np.stack([d[f"{n}min"] for n in names], axis=-1)
        hi = np.stack([d[f"{n}max"] for n in names], axis=-1)
        if t == "CylindricalCellGeometry":
            return ig.CylindricalCellGeometry(
                snapshot=snap.CylindricalCellSnapshot(
                    lo=lo, hi=hi, mass=mass_post(d["M"], d)))
        return ig.SphericalCellGeometry(snapshot=snap.SphericalCellSnapshot(
            lo=lo, hi=hi, mass=mass_post(d["M"], d)))
    ext_box = _extent(a)
    if t == "VoronoiMeshGeometry":
        cols = [("x", "length", "pc"), ("y", "length", "pc"),
                ("z", "length", "pc")]
        cols.append(("rho", "massvolumedensity", "Msun/pc3")
                    if mt == "MassDensity" else ("M", "mass", "Msun"))
        d = snap.read_column_file(fn, zt_cols(cols))
        sites = np.stack([d["x"], d["y"], d["z"]], axis=-1)
        if mt == "MassDensity":
            return ig.VoronoiMeshGeometry(
                sites=sites, mass_density=mass_post(d["rho"], d),
                extent=ext_box)
        return ig.VoronoiMeshGeometry(sites=sites, mass=mass_post(d["M"], d),
                                      extent=ext_box)
    # AdaptiveMeshGeometry: leaf rows density or mass, [Z], [T]
    grid, leaf = build_amr(fn, ext_box)
    q = leaf[:, 0]
    if mt == "MassDensity":
        mass = q * (_MSUN / _PC ** 3) * grid.volumes()
    elif mt == "Mass":
        mass = q * _MSUN
    else:
        raise NotImplementedError(f"AdaptiveMeshGeometry massType='{mt}' "
                                  "not ported yet (MassDensity, Mass)")
    d, col = {}, 1
    for name, on in (("Z", import_z), ("T", import_t)):
        if on:
            d[name] = leaf[:, col]
            col += 1
    return ig.AdaptiveMeshGeometry(grid=grid, mass=mass_post(mass, d))


def build_sed(el, base_dir: str):
    a = el.attrib
    if el.tag == "FileSED":
        # wavelengths in micron; the file resolves against the ski file's
        # directory
        return sedlib.from_file(_resolve(a["filename"], base_dir),
                                lam_unit=1e-6)
    if el.tag == "LyaGaussianSED":
        return sedlib.lya_gaussian(_q(a, "dispersion", "velocity", 50e3))
    return sedlib.blackbody(_q(a, "temperature", "temperature"))


def source_luminosity(el) -> float:
    """The scalar luminosity the normalised SED is multiplied by: the
    IntegratedLuminosityNormalization's, or 1 without a normalization."""
    norm = _child(el, "normalization")
    if norm is None:
        return 1.0
    rng = norm.attrib.get("wavelengthRange", "Source")
    if rng != "Source":
        raise NotImplementedError(f"{norm.tag} wavelengthRange='{rng}' not "
                                  "ported yet (Source)")
    return _q(norm.attrib, "integratedLuminosity", "bolluminosity")


# why an import flag the port does not read is not ported yet
_FLAG_REASONS = {
    "importVelocity": "moving sources need emission Doppler shifts (ROADMAP "
                      "queue A item 45)",
    "importMagneticField": "the field serves the aligned spheroidal grains "
                           "(ROADMAP queue A item 32)",
    "importVariableMixParams": "variable material mixes (ROADMAP queue A "
                               "item 31)"}


def _import_flags(el, allowed=()) -> None:
    """Raise NotImplementedError naming an imported item's `import*` flag
    that is set and not in `allowed`, or its `useColumns`: the port reads
    the default columns only."""
    on = [k for k, v in el.attrib.items()
          if k.startswith("import") and v == "true" and k not in allowed]
    if el.attrib.get("useColumns"):
        on.append("useColumns")
    if on:
        why = [_FLAG_REASONS[k] for k in on if k in _FLAG_REASONS]
        raise NotImplementedError(
            f"{el.tag} {', '.join(on)} not ported yet"
            + (f": {'; '.join(why)}" if why else ""))


# the SED families of the imported sources and their parameter columns
# (ref: SEDFamily::parameterInfo; `skirt9_tpu/config/ski.py:693-710`)
FAMILY_COLUMNS = {
    "BlackBodySEDFamily": [("R", "length", "km"), ("T", "temperature", "K")],
    "FileIndexedSEDFamily": [("L", "", ""), ("index", "", "")],
    "FileSSPSEDFamily": [("Minit", "mass", "Msun"), ("Z", "", ""),
                         ("t", "time", "yr")]}


def _family_kind(el):
    """(family element, family type) of an imported source; BlackBody by
    default, as in the reference."""
    fam_el = _child(el, "sedFamily")
    ft = fam_el.tag if fam_el is not None else "BlackBodySEDFamily"
    if ft not in FAMILY_COLUMNS:
        raise NotImplementedError(
            f"SED family '{ft}' not ported yet ({', '.join(FAMILY_COLUMNS)};"
            " the named families need resource packs)")
    if fam_el is not None and \
            fam_el.attrib.get("hasIonizationParameter", "false") == "true":
        raise NotImplementedError(f"{ft} hasIonizationParameter not ported "
                                  "yet")
    return fam_el, ft


def _family_tables(ft, fam_el, base_dir: str, lam_range, d):
    """(FamilyTables over lam_range, scales, params) of an imported
    source's entities from their columns d (`skirt9_tpu/config/ski.py:
    661-690`): a blackbody family on a temperature grid spanning the
    entities' with area scales 4 pi R^2, an indexed family with luminosity
    scales, an SSP family per Msun of initial mass with ages in years (its
    table's units: the SI columns are scaled back, ref:
    FileSSPSEDFamily.cpp:44-47)."""
    if ft == "BlackBodySEDFamily":
        lam_grid = np.geomspace(max(lam_range[0] * 0.5, 1e-9),
                                lam_range[1] * 2.0, 600)
        Tgrid = np.geomspace(max(d["T"].min() * 0.9, 1.0),
                             d["T"].max() * 1.1, 48)
        fam = sf.blackbody_family(Tgrid, lam_grid)
        scales, params = 4.0 * np.pi * d["R"] ** 2, d["T"][:, None]
    elif ft == "FileIndexedSEDFamily":
        fam = sf.load_indexed_family(_resolve(fam_el.attrib["filename"],
                                              base_dir))
        scales, params = d["L"], d["index"][:, None]
    else:
        fam = sf.load_ssp_family(_resolve(fam_el.attrib["filename"],
                                          base_dir))
        scales = d["Minit"] / sf.M_SUN
        params = np.stack([d["Z"], d["t"] / const.YEAR], axis=-1)
    return sf.FamilyTables(fam, lam_range=lam_range), scales, params


def build_particle_source(el, base_dir: str, lam_range):
    """ParticleSource with a blackbody, indexed or SSP family (`skirt9_tpu/
    config/ski.py:754-860`): text columns x y z h (pc) and the family's
    columns; a smoothing kernel of any of the four kinds. The source's
    `wavelengthBias` and weight are read and ignored, as the reference
    ignores them."""
    _import_flags(el)
    fam_el, ft = _family_kind(el)
    kern_el = _child(el, "smoothingKernel")
    d = snap.read_column_file(_resolve(el.attrib["filename"], base_dir), [
        ("x", "length", "pc"), ("y", "length", "pc"), ("z", "length", "pc"),
        ("h", "length", "pc")] + FAMILY_COLUMNS[ft])
    pos = np.stack([d["x"], d["y"], d["z"]], axis=-1)
    ps = snap.ParticleSnapshot(positions=pos, h=d["h"],
                               mass=np.ones(len(pos)))
    tabs, scales, params = _family_tables(ft, fam_el, base_dir, lam_range, d)
    return snap.FamilyParticleSource(
        snapshot=ps, family_tables=tabs, scales=scales, params=params,
        kernel_kind=(kern_el.tag if kern_el is not None
                     else "CubicSplineSmoothingKernel"))


def build_cell_source(el, base_dir: str, lam_range):
    """CellSource (`skirt9_tpu/config/ski.py:865-930`): box cells xmin ymin
    zmin xmax ymax zmax (pc) and the family's columns, uniform in-cell
    launch positions."""
    _import_flags(el)
    fam_el, ft = _family_kind(el)
    d = snap.read_column_file(_resolve(el.attrib["filename"], base_dir), [
        (f"{x}{e}", "length", "pc") for e in ("min", "max") for x in "xyz"]
        + FAMILY_COLUMNS[ft])
    tabs, scales, params = _family_tables(ft, fam_el, base_dir, lam_range, d)
    return snap.CellFamilySource(
        lo=np.stack([d["xmin"], d["ymin"], d["zmin"]], axis=-1),
        hi=np.stack([d["xmax"], d["ymax"], d["zmax"]], axis=-1),
        family_tables=tabs, scales=scales, params=params)


def build_mesh_source(el, base_dir: str, lam_range):
    """VoronoiMeshSource (sites x y z (pc) and the family's columns) or
    AdaptiveMeshSource (a Morton-order AMR file whose leaf rows are the
    family's columns) in the item's box (`skirt9_tpu/config/ski.py:
    693-752`): every cell an emitting entity, positions uniform in the
    Voronoi cell or the leaf box through the imported geometry's
    sampler."""
    _import_flags(el)
    fam_el, ft = _family_kind(el)
    fn = _resolve(el.attrib["filename"], base_dir)
    ext_box = _extent(el.attrib)
    if el.tag == "VoronoiMeshSource":
        d = snap.read_column_file(fn, [("x", "length", "pc"),
                                       ("y", "length", "pc"),
                                       ("z", "length", "pc")]
                                  + FAMILY_COLUMNS[ft])
        sites = np.stack([d["x"], d["y"], d["z"]], axis=-1)
        sampler = ig.VoronoiMeshGeometry(sites=sites, mass=np.ones(len(sites)),
                                         extent=ext_box)
    else:
        grid, leaf = build_amr(fn, ext_box)
        d = {name: leaf[:, i] * (U.to_si(qty, 1.0, unit) if unit else 1.0)
             for i, (name, qty, unit) in enumerate(FAMILY_COLUMNS[ft])}
        sampler = ig.AdaptiveMeshGeometry(grid=grid, mass=np.ones(grid.ncells))
    tabs, scales, params = _family_tables(ft, fam_el, base_dir, lam_range, d)
    return snap.EntityFamilySource(sampler=sampler, family_tables=tabs,
                                   scales=scales, params=params)


def _resolve(fn: str, base_dir: str) -> str:
    """An input file name, resolved against the ski file's directory."""
    return fn if os.path.isabs(fn) else os.path.join(base_dir, fn)


_IMPORTED_SOURCES = {"ParticleSource": build_particle_source,
                     "CellSource": build_cell_source,
                     "VoronoiMeshSource": build_mesh_source,
                     "AdaptiveMeshSource": build_mesh_source}


def build_source(el, base_dir: str, lam_range=None):
    """A PointSource, a GeometricSource, or an imported source (particles,
    cells, a Voronoi or an adaptive mesh) over lam_range (the source range,
    else 1e-8 to 1e-3 m, as the reference takes it). A point or geometric
    source's velocity and weight are read and ignored, as the reference
    ignores them."""
    if el.tag in _IMPORTED_SOURCES:
        return _IMPORTED_SOURCES[el.tag](el, base_dir,
                                         lam_range or (1e-8, 1e-3))
    a = el.attrib
    if el.tag == "GeometricSource":
        # `skirt9_tpu/config/ski.py:608-616`
        sed_el = _child(el, "sed")
        kw = {}
        if "wavelengthBias" in a:
            kw["wavelength_bias"] = _f(a, "wavelengthBias", 0.5)
        return GeometricSource(
            geometry=build_geometry(_child(el, "geometry"), base_dir),
            luminosity=source_luminosity(el),
            sed=build_sed(sed_el, base_dir) if sed_el is not None else None,
            **kw)
    pos = (_q(a, "positionX", "length", 0.0),
           _q(a, "positionY", "length", 0.0),
           _q(a, "positionZ", "length", 0.0))
    sed_el = _child(el, "sed")
    kw = {}
    if "wavelengthBias" in a:
        kw["wavelength_bias"] = _f(a, "wavelengthBias", 0.5)
    return PointSource(position=pos, luminosity=source_luminosity(el),
                       sed=(build_sed(sed_el, base_dir) if sed_el is not None
                            else None),
                       **kw)


def build_mix(el, base_dir: str) -> mx.MixTables:
    if el.tag == "LyaNeutralHydrogenGasMix":
        # a zero-opacity marker: the life cycle forms the Voigt opacity per
        # wavelength and gas temperature; its polarization flag is read and
        # ignored, as the reference ignores it
        m_ = mx.MixTables(lam=np.array([1e-8, 1e-3]), sigma_ext=np.zeros(2),
                          albedo=np.zeros(2), g=np.zeros(2),
                          mu=1.67262e-27 + 9.10938e-31)  # m_p + m_e
        object.__setattr__(m_, "_lya", {"T_default": _q(
            el.attrib, "defaultTemperature", "temperature", 1e4)})
        return m_
    if el.tag == "XRayAtomicGasMix":
        return build_xray_mix(el, base_dir)
    if el.tag == "ElectronMix":
        emix = mx.electron_mix()
        if el.attrib.get("includePolarization", "false") == "true":
            # Thomson scattering's exact Mueller matrix rides on the mix,
            # as in the reference (ref: ElectronMix.hpp:60)
            object.__setattr__(emix, "_mueller", stk.electron_mueller())
        return emix
    if el.tag == "MeanInterstellarDustMix":
        return mx.mean_interstellar_approx()
    if el.tag == "TrivialGasMix":
        a = el.attrib
        return mx.trivial_gas(_q(a, "absorptionCrossSection", "section"),
                              _q(a, "scatteringCrossSection", "section"),
                              _f(a, "asymmetryParameter", 0.0))
    # MeanFileDustMix: input files resolve against the ski file's directory
    return mx.from_file(_resolve(el.attrib["filename"], base_dir))


def build_xray_mix(el, base_dir: str) -> mx.MixTables:
    """The X-ray atomic gas (`skirt9_tpu/config/ski.py:982-1011`): its
    tables on 512 wavelengths from 2e-11 to 5e-7 m, the shells and lines of
    XRay_PA.txt and XRay_FL.txt beside the ski file where they are there
    (else the built-in H, He and approximate Fe K data), every bound
    electron scattering as a free one. Its temperature and H2 fraction are
    read and ignored, as the reference ignores them."""
    a = el.attrib
    ab = None
    if a.get("abundancies"):
        ab = np.array([float(v) for v in
                       a["abundancies"].replace(",", " ").split()])
    lam = np.geomspace(2e-11, 5e-7, 512)
    scatter = {"None": "None", "Free": "Free", "FreeWithPolarization": "Free",
               "Good": "Free", "Exact": "Free"}.get(
                   a.get("scatterBoundElectrons", "Good"), "Free")
    shells = list(xr.BUILTIN_SHELLS) + [xr.FE_K_SHELL]
    lines = list(xr.FE_K_LINES)
    pa = os.path.join(base_dir, "XRay_PA.txt")
    fl = os.path.join(base_dir, "XRay_FL.txt")
    if os.path.exists(pa):
        shells = xr.load_pa_file(pa)
    if os.path.exists(fl):
        lines = xr.load_fl_file(fl)
    return xr.as_mix_tables(xr.build_xray_tables(
        lam, abundances=ab, scatter=scatter, shells=shells, lines=lines))


def build_medium_normalization(el):
    norm = _child(el, "normalization")
    if norm is None:
        raise ValueError("medium needs a normalization")
    a = norm.attrib
    axis = {"X": "x", "Y": "y", "Z": "z"}.get(a.get("axis", "Z"), "z")
    if norm.tag == "NumberMaterialNormalization":
        return gm.NumberNormalization(number=_f(a, "number"))
    if norm.tag == "NumberColumnMaterialNormalization":
        return gm.NumberColumnNormalization(
            column=U.parse("numbersurfacedensity", a["numberColumnDensity"]),
            axis=axis)
    return gm.OpticalDepthNormalization(
        tau=_f(a, "opticalDepth"), lam=_q(a, "wavelength", "wavelength"),
        axis=axis)


def build_vector_field(el):
    """A VectorField item (`skirt9_tpu/config/ski.py:1205-1245`), evaluated
    on the host at the cell centres during set-up."""
    t, a = el.tag, el.attrib
    if t == "RadialVectorField":
        return vf.RadialVectorField(
            unity_radius=_q(a, "unityRadius", "length", 0.0),
            exponent=_f(a, "exponent", 1.0))
    if t == "CylindricalVectorField":
        return vf.CylindricalVectorField(
            unity_radius=_q(a, "unityRadius", "length", 0.0),
            exponent=_f(a, "exponent", 1.0))
    if t == "HollowRadialVectorField":
        return vf.HollowRadialVectorField(
            zero_radius=_q(a, "zeroRadius", "length", 0.0),
            exponent=_f(a, "exponent", 0.0))
    if t == "HubbleRadialVectorField":
        return vf.HubbleRadialVectorField(
            turnover_radius=_q(a, "turnoverRadius", "length"),
            max_radius=_q(a, "maxRadius", "length"))
    if t == "UnidirectionalVectorField":
        return vf.UnidirectionalVectorField(
            direction=(_f(a, "fieldX", 0.0), _f(a, "fieldY", 0.0),
                       _f(a, "fieldZ", 1.0)))
    if t == "RotateVectorFieldDecorator":
        return vf.RotateVectorFieldDecorator(
            child=build_vector_field(_child(el, "vectorField")),
            alpha=_q(a, "eulerAlpha", "angle", 0.0),
            beta=_q(a, "eulerBeta", "angle", 0.0),
            gamma=_q(a, "eulerGamma", "angle", 0.0))
    # OffsetVectorFieldDecorator, the last vector field of ITEMS
    return vf.OffsetVectorFieldDecorator(
        child=build_vector_field(_child(el, "vectorField")),
        offset=(_q(a, "offsetX", "length", 0.0),
                _q(a, "offsetY", "length", 0.0),
                _q(a, "offsetZ", "length", 0.0)))


def build_voronoi_medium(media, grid_el, base_dir: str):
    """An imported Voronoi mesh medium on its own grid (`skirt9_tpu/config/
    ski.py:1763-1800, 1983-2000`): columns x y z (pc) and a mass (Msun/pc3)
    or number (1/cm3) density per site; the VoronoiMeshSpatialGrid with the
    ImportedMesh policy tessellates the medium's sites in the medium's box.
    The imported metallicity (which scales the density), temperature and
    velocity (km/s) follow in that order, as the reference reads them. The
    medium's massFraction and maxTemperature and the grid's numSites,
    filename and relaxSites are read and ignored, as the reference ignores
    them. Returns (grid, medium, mix)."""
    if len(media) != 1:
        raise NotImplementedError("mixing VoronoiMeshMedium with other media "
                                  "not ported yet")
    m_el = media[0]
    if grid_el.tag != "VoronoiMeshSpatialGrid":
        raise NotImplementedError(
            f"VoronoiMeshMedium on a {grid_el.tag} not ported yet (its own "
            "VoronoiMeshSpatialGrid)")
    policy = grid_el.attrib.get("policy", "DustDensity")
    if policy != "ImportedMesh":
        raise NotImplementedError(f"VoronoiMeshSpatialGrid policy='{policy}'"
                                  " not ported yet (ImportedMesh)")
    _import_flags(m_el, ("importMetallicity", "importTemperature",
                         "importVelocity"))
    a = m_el.attrib
    mass_type = a.get("massType", "MassDensity")
    density = {"MassDensity": ("massvolumedensity", "Msun/pc3"),
               "NumberDensity": ("numbervolumedensity", "1/cm3")}
    if mass_type not in density:
        raise NotImplementedError(f"VoronoiMeshMedium massType='{mass_type}'"
                                  " not ported yet")
    d = snap.read_column_file(_resolve(a["filename"], base_dir), [
        ("x", "length", "pc"), ("y", "length", "pc"), ("z", "length", "pc"),
        ("rho", *density[mass_type])] + _state_columns(a))
    mix = build_mix(_child(m_el, "materialMix"), base_dir)
    grid = build_voronoi(np.stack([d["x"], d["y"], d["z"]], axis=-1),
                         _extent(a))
    return grid, msys.site_medium(
        grid, d["rho"], mass_type, mix, metallicity=d.get("Z"),
        temperature=d.get("T"), bulk_v=_velocity(d)), mix


def _state_columns(a) -> list:
    """The columns of an imported medium's state after its density: [Z],
    [T (K)], [vx vy vz (km/s)], in the order the reference imports them
    (ref: ImportedMedium.cpp:18-24)."""
    cols = []
    if a.get("importMetallicity", "false") == "true":
        cols.append(("Z", "", ""))
    if a.get("importTemperature", "false") == "true":
        cols.append(("T", "temperature", "K"))
    if a.get("importVelocity", "false") == "true":
        cols += [(f"v{x}", "velocity", "km/s") for x in "xyz"]
    return cols


def _velocity(d):
    return (np.stack([d["vx"], d["vy"], d["vz"]], axis=-1) if "vx" in d
            else None)


def build_amr_medium(media, grid_el, base_dir: str):
    """An AdaptiveMeshMedium on its AdaptiveMeshSpatialGrid (`skirt9_tpu/
    config/ski.py:1733-1762, 1932-1977`): the Morton-order file's leaf rows
    hold the density as massType says (MassDensity in Msun/pc3, Mass in
    Msun, NumberDensity in 1/cm3, Number), then [Z] (which scales the
    density), [T (K)] and [vx vy vz (km/s)]. The medium's massFraction is
    read and ignored, as the reference ignores it. Returns (grid, medium,
    mix)."""
    if len(media) != 1:
        raise NotImplementedError("mixing AdaptiveMeshMedium with other "
                                  "media not ported yet")
    m_el = media[0]
    if grid_el.tag != "AdaptiveMeshSpatialGrid":
        raise NotImplementedError(
            f"AdaptiveMeshMedium on a {grid_el.tag} not ported yet (its own "
            "AdaptiveMeshSpatialGrid)")
    _import_flags(m_el, ("importMetallicity", "importTemperature",
                         "importVelocity"))
    a = m_el.attrib
    mix = build_mix(_child(m_el, "materialMix"), base_dir)
    grid, leaf = build_amr(_resolve(a["filename"], base_dir), _extent(a))
    vol = grid.volumes()
    q = leaf[:, 0]
    mtype = a.get("massType", "MassDensity")
    if mtype == "MassDensity":
        nd = q * (_MSUN / _PC ** 3) / mix.mu
    elif mtype == "Mass":
        nd = q * _MSUN / (mix.mu * vol)
    elif mtype == "NumberDensity":
        nd = q * 1e6
    elif mtype == "Number":
        nd = q / vol
    else:
        raise NotImplementedError(f"AdaptiveMeshMedium massType='{mtype}' "
                                  "not ported yet")
    d, col = {}, 1
    for name, qty, unit in _state_columns(a):
        d[name] = leaf[:, col] * (1e3 if qty == "velocity" else 1.0)
        col += 1
    if "Z" in d:
        nd = nd * d["Z"]
    lam, se, al, gg = mx.stack([mix])
    vel = _velocity(d)
    return grid, msys.make_medium(
        grid, nd.astype(np.float32), lam, se, al, gg,
        bulk_v=None if vel is None else vel.astype(np.float32),
        temperature=d.get("T"), metallicity=d.get("Z")), mix


class _SnapshotDensity:
    """A snapshot's mass density as the density_np of a grid-refinement
    policy (the reference's `_SnapGeom`, `skirt9_tpu/config/ski.py:
    1880-1897`)."""

    def __init__(self, ss):
        self.ss = ss

    def density_np(self, pts):
        if hasattr(self.ss, "density_at"):
            return self.ss.density_at(pts)
        return self.ss.box_density(pts)


def build_snapshot_medium(media, grid_el, base_dir: str):
    """A ParticleMedium (columns x y z h (pc), M (Msun)) or a CellMedium
    (xmin ymin zmin xmax ymax zmax (pc), a density in Msun/pc3 or a mass
    in Msun), then [Z] (which scales the mass) and [vx vy vz (km/s)],
    resampled onto the ski file's grid (`skirt9_tpu/config/ski.py:
    1828-1900, 2070-2088`): a density-policy tree refines on the
    snapshot's density, the cells take the kernel-smoothed density at
    their centres (particles) or the box density at 4 seeded points
    (cells), and the nearest particle's or the holding box's velocity.
    Returns (grid, medium, mix)."""
    if len(media) != 1:
        raise NotImplementedError(f"mixing {media[0].tag} with other media "
                                  "not ported yet")
    m_el = media[0]
    a = m_el.attrib
    if a.get("importTemperature", "false") == "true":
        raise NotImplementedError(
            f"{m_el.tag} importTemperature not ported yet (the reference "
            "stores the entities' temperatures as the cells')")
    _import_flags(m_el, ("importMetallicity", "importVelocity"))
    if m_el.tag == "ParticleMedium":
        cols = [("x", "length", "pc"), ("y", "length", "pc"),
                ("z", "length", "pc"), ("h", "length", "pc"),
                ("M", "mass", "Msun")]
    else:
        cols = [(f"{x}{e}", "length", "pc") for e in ("min", "max")
                for x in "xyz"]
        cols.append(("rho", "massvolumedensity", "Msun/pc3")
                    if a.get("massType", "MassDensity") == "MassDensity"
                    else ("M", "mass", "Msun"))
    d = snap.read_column_file(_resolve(a["filename"], base_dir),
                              cols + _state_columns(a))
    mix = build_mix(_child(m_el, "materialMix"), base_dir)
    zfac = d["Z"] if "Z" in d else 1.0
    if m_el.tag == "ParticleMedium":
        ss = snap.ParticleSnapshot(
            positions=np.stack([d["x"], d["y"], d["z"]], axis=-1), h=d["h"],
            mass=d["M"] * zfac, velocity=_velocity(d))
    else:
        lo = np.stack([d["xmin"], d["ymin"], d["zmin"]], axis=-1)
        hi = np.stack([d["xmax"], d["ymax"], d["zmax"]], axis=-1)
        mass = (d["rho"] * np.prod(hi - lo, axis=-1) if "rho" in d
                else d["M"]) * zfac
        ss = snap.CellSnapshot(lo=lo, hi=hi, mass=mass, velocity=_velocity(d))
    grid = build_grid(grid_el, _SnapshotDensity(ss), base_dir)
    nd = ss.density_on_cells(grid) / mix.mu
    vel = ss.velocity_on_cells(grid) if ss.velocity is not None else None
    lam, se, al, gg = mx.stack([mix])
    return grid, msys.make_medium(
        grid, nd.astype(np.float32), lam, se, al, gg,
        bulk_v=None if vel is None else vel.astype(np.float32)), mix


def bulk_velocities(grid, nd, velocity_fields) -> np.ndarray:
    """Per-cell bulk velocity: the number-density-weighted average over the
    moving components of magnitude x field at the cell centres
    (`skirt9_tpu/config/ski.py:2093-2109`; ref: MediumSystem.cpp:109-119,
    339). velocity_fields: [(component, field, magnitude [m/s])]."""
    centers = grid.cell_centers().cpu().numpy().astype(np.float64)
    nd_np = nd.cpu().numpy().astype(np.float64)
    vsum = np.zeros((len(centers), 3))
    nsum = np.zeros(len(centers))
    for h, fld, vmag in velocity_fields:
        vsum += nd_np[:, h:h + 1] * (vmag * fld.field(centers))
        nsum += nd_np[:, h]
    return np.where(nsum[:, None] > 0,
                    vsum / np.maximum(nsum, 1e-300)[:, None], 0.0)


def _extent(a) -> tuple:
    return tuple((_q(a, f"min{x}", "length"), _q(a, f"max{x}", "length"))
                 for x in "XYZ")


def build_grid(el, geometry, base_dir: str = ".", device="cpu"):
    """A CartesianSpatialGrid (32 linear bins where a mesh is absent; a
    `CartesianGrid` with the reference's borders, `grids.meshes.from_ski`,
    where any mesh is not a LinMesh, as the reference's
    `skirt9_tpu/config/ski.py:1274-1300` builds it), or a
    PolicyTreeSpatialGrid: an octree or a bintree refined by
    the DensityTreePolicy on the first medium's normalised density (the
    reference's non-nested branch, `skirt9_tpu/config/ski.py:1302-1316,
    2005-2049`). Tree levels in the ski file count octree levels, so a
    bintree's count three times. The curvilinear grids go to
    `build_curvilinear_grid`, the standalone Voronoi and tetrahedral
    meshes to `build_site_grid`."""
    a = el.attrib
    if el.tag in ("Sphere1DSpatialGrid", "Cylinder2DSpatialGrid",
                  "Sphere2DSpatialGrid", "Sphere3DSpatialGrid",
                  "Cylinder3DSpatialGrid", "ClumpySphericalSpatialGrid"):
        return build_curvilinear_grid(el, base_dir, device)
    if el.tag in ("VoronoiMeshSpatialGrid", "TetraMeshSpatialGrid"):
        return build_site_grid(el, geometry)
    if el.tag == "AdaptiveMeshSpatialGrid":
        raise NotImplementedError("AdaptiveMeshSpatialGrid without an "
                                  "AdaptiveMeshMedium not ported yet")
    if el.tag == "PolicyTreeSpatialGrid":
        pol = _child(el, "policy")
        pa = pol.attrib if pol is not None else {}
        binary = a.get("treeType", "OctTree") == "BinTree"
        mul = 3 if binary else 1
        # the policy's optical-depth, dispersion, electron and gas criteria
        # and its wavelength are read and ignored, as the reference ignores
        # them; maxDustFraction is floored at 1e-4
        frac = float(pa.get("maxDustFraction", 1e-6))
        builder = bintree.build_bintree if binary else octree.build_octree
        return builder(_extent(a), geometry.density_np,
                       max_level=int(pa.get("maxLevel", 6)) * mul,
                       min_level=int(pa.get("minLevel", 2)) * mul,
                       max_fraction=max(frac or 1e-4, 1e-4))
    ext = _extent(a)
    ns, borders = [], []
    for ax, mesh_name in enumerate(("meshX", "meshY", "meshZ")):
        m = _child(el, mesh_name)
        ns.append(32 if m is None else int(m.attrib.get("numBins", 32)))
        borders.append(None if m is None or m.tag == "LinMesh" else msh.scale(
            msh.from_ski(m, base_dir, default_bins=32), *ext[ax]))
    if any(b is not None for b in borders):
        return make_cartesian(ext, tuple(ns), meshes=borders)
    return make_cartesian(ext, tuple(ns))


def build_site_grid(el, geometry):
    """A standalone VoronoiMeshSpatialGrid or TetraMeshSpatialGrid (the
    reference's `skirt9_tpu/config/ski.py:1395-1407, 2050-2075`): numSites
    sites drawn from the first medium's density (policy DustDensity,
    `density_sites` with seed 3), else uniform in the box
    (`default_rng(3)`), moved to their cells' centroids by Lloyd
    relaxation where relaxSites is true, then tessellated. The
    ImportedMesh policy belongs to a VoronoiMeshMedium
    (`build_voronoi_medium`)."""
    a = el.attrib
    policy = a.get("policy", "DustDensity")
    if policy == "ImportedMesh":
        raise NotImplementedError(
            f"{el.tag} policy='ImportedMesh' without a VoronoiMeshMedium not "
            "ported yet")
    if policy not in ("DustDensity", "Uniform"):
        raise NotImplementedError(f"{el.tag} policy='{policy}' not ported "
                                  "yet (DustDensity, Uniform)")
    ext = _extent(a)
    n = int(_f(a, "numSites", 500))
    if policy == "DustDensity" and geometry is not None:
        sites = density_sites(geometry.density_np, ext, n, seed=3)
    else:
        lo = np.array([e[0] for e in ext])
        hi = np.array([e[1] for e in ext])
        sites = lo + np.random.default_rng(3).uniform(size=(n, 3)) * (hi - lo)
    if a.get("relaxSites", "false") == "true":
        sites = lloyd_relax(sites, ext)
    if el.tag == "TetraMeshSpatialGrid":
        return build_tetra(sites, ext)
    return build_voronoi(sites, ext)


def _grid_mesh(el, name: str, lo: float, hi: float, base_dir: str,
               default: int):
    """(bins, borders scaled onto [lo, hi], or None for a linear mesh) of
    a curvilinear grid's mesh child, default bins where it is absent."""
    m = _child(el, name)
    if m is None:
        return default, None
    n = int(m.attrib.get("numBins", default))
    if m.tag == "LinMesh":
        return n, None
    return n, msh.scale(msh.from_ski(m, base_dir, default_bins=default), lo,
                        hi)


def build_curvilinear_grid(el, base_dir: str = ".", device="cpu"):
    """A Sphere1DSpatialGrid, Cylinder2DSpatialGrid, Sphere2DSpatialGrid,
    Sphere3DSpatialGrid, Cylinder3DSpatialGrid or
    ClumpySphericalSpatialGrid with its radial, polar and z meshes (32
    radial and z bins, 16 polar and azimuthal ones where a mesh is absent;
    the azimuthal mesh is always linear, its bin count read), as
    `skirt9_tpu/config/ski.py:1338-1394` builds them; a clumpy sphere's
    set-up locates its overlap samples on device (the grid is built on
    the CPU)."""
    a = el.attrib
    mesh = lambda name, lo, hi, default=32: _grid_mesh(el, name, lo, hi,
                                                       base_dir, default)
    r_max = _q(a, "maxRadius", "length")
    if el.tag == "Sphere1DSpatialGrid":
        r_min = _q(a, "minRadius", "length") if "minRadius" in a else 0.0
        nr, rb = mesh("meshRadial", r_min, r_max)
        return make_sphere1d(r_max, nr, r_min=r_min, rb=rb)
    nphi = mesh("meshAzimuthal", -np.pi, np.pi, 16)[0]
    if el.tag == "ClumpySphericalSpatialGrid":
        # a Sphere3D grid and the clumps of a text file: columns x y z radius
        # in pc, extra columns ignored (`skirt9_tpu/config/ski.py:1361-1378`)
        r_min = _q(a, "minRadius", "length") if "minRadius" in a else 0.0
        nr, rb = mesh("meshRadial", r_min, r_max)
        nt, tb = mesh("meshPolar", 0.0, np.pi, 16)
        d = np.loadtxt(_resolve(a["filename"], base_dir), ndmin=2)
        return make_clumpy_spherical(r_max, nr, nt, nphi, d[:, :3] * _PC,
                                     d[:, 3] * _PC, r_min=r_min, rb=rb,
                                     tb=tb, device=dv.resolve(device))
    nr, rb = mesh("meshRadial", 0.0, r_max)
    if el.tag.startswith("Sphere"):
        nt, tb = mesh("meshPolar", 0.0, np.pi, 16)
        if el.tag == "Sphere2DSpatialGrid":
            return polar.make_sphere2d(r_max, nr, nt, rb=rb, tb=tb)
        return polar.make_sphere3d(r_max, nr, nt, nphi, rb=rb, tb=tb)
    z_min, z_max = _q(a, "minZ", "length"), _q(a, "maxZ", "length")
    nz, zb = mesh("meshZ", z_min, z_max)
    if el.tag == "Cylinder3DSpatialGrid":
        return polar.make_cylinder3d(r_max, z_min, z_max, nr, nphi, nz,
                                     rb=rb, zb=zb)
    return make_cylinder2d(r_max, z_min, z_max, nr, nz, rb=rb, zb=zb)


def build_wavelength_grid(el) -> np.ndarray:
    a = el.attrib
    borders = (wl.lin_borders_skirt if el.tag == "LinWavelengthGrid"
               else wl.log_borders_skirt)
    return borders(_q(a, "minWavelength", "wavelength"),
                   _q(a, "maxWavelength", "wavelength"),
                   int(a["numWavelengths"]))


def build_instrument(el, default_wlg) -> dinst.DistantInstrumentCfg:
    """A FullInstrument, or an SEDInstrument: a distant instrument without
    a frame, whose components and statistics flags are read and ignored,
    as the reference ignores them (`skirt9_tpu/config/ski.py:1560-1561`)."""
    a = el.attrib
    wlg_el = _child(el, "wavelengthGrid")
    borders = (build_wavelength_grid(wlg_el) if wlg_el is not None
               else default_wlg)
    common = dict(
        name=a.get("instrumentName", el.tag),
        wave_borders=tuple(borders),
        inclination=_q(a, "inclination", "angle", 0.0),
        azimuth=_q(a, "azimuth", "angle", 0.0),
        roll=_q(a, "roll", "angle", 0.0),
        distance=_q(a, "distance", "distance", 10 * 3.0857e16),
        record_polarization=a.get("recordPolarization", "false") == "true",
        aperture=_q(a, "radius", "length", 0.0))
    if el.tag == "SEDInstrument":
        return dinst.DistantInstrumentCfg(**common)
    kw = {}
    if a.get("recordComponents", "false") == "true":
        kw["num_scattering_levels"] = int(a.get("numScatteringLevels", 0))
    return dinst.DistantInstrumentCfg(
        **common, **kw,
        npx=int(a.get("numPixelsX", 250)),
        npy=int(a.get("numPixelsY", 250)),
        fovx=_q(a, "fieldOfViewX", "length"),
        fovy=_q(a, "fieldOfViewY", "length"),
        centerx=_q(a, "centerX", "length", 0.0),
        centery=_q(a, "centerY", "length", 0.0))


def build_probes(mcs) -> list[ProbeSpec]:
    probes = []
    plist = mcs.find("probeSystem/ProbeSystem/probes")
    for p_el in (list(plist) if plist is not None else []):
        kind, default_when = PROBES[p_el.tag]
        when = p_el.attrib.get("probeAfter", default_when)
        if when not in ("Setup", "Run"):
            raise NotImplementedError(
                f"{p_el.tag} probeAfter='{when}' not ported yet (Setup, Run)")
        probes.append(ProbeSpec(kind, p_el.attrib.get("probeName", kind),
                                when=when))
    return probes


# -------------------------------------------------------------------- loader

def load_ski(path: str, num_packets: int | None = None,
             batch_size: int = 16384, seed: int = 0, max_events: int = 64,
             device="cuda", group=None) -> Simulation:
    """Parse a .ski file into a runnable Simulation on `device` (the
    reference's `load_ski` flow, `skirt9_tpu/config/ski.py:1659`); group:
    this rank's `parallel.dp.Group` under packet data parallelism, whose
    device the simulation takes."""
    if group is not None:
        device = group.device
    base_dir = os.path.dirname(os.path.abspath(path))
    root = ET.parse(path).getroot()
    mcs = root.find("MonteCarloSimulation")
    if mcs is None:
        raise ValueError("not a SKIRT 9 ski file (no MonteCarloSimulation)")
    if mcs.find(".//dynamicStateOptions") is not None:
        raise NotImplementedError("dynamic medium state recipes (media/"
                                  "dynamic) not ported yet")
    check_items(root)
    mode = mcs.attrib.get("simulationMode", "ExtinctionOnly")
    if mode not in MODES:
        raise NotImplementedError(f"simulationMode '{mode}' not ported yet "
                                  f"({', '.join(MODES)})")
    # iteratePrimaryEmission iterates the dynamic medium recipes only: with
    # none (they raise above) it does nothing, as in the reference
    iterate_secondary = mcs.attrib.get("iterateSecondaryEmission",
                                       "false") == "true"
    oligo = mode.startswith("Oligo")
    n_pk = num_packets or int(float(mcs.attrib.get("numPackets", 1e6)))

    # sources
    # (the SourceSystem's sourceBias is read and ignored, as the reference
    # ignores it: the allocation bias is the Simulation's default)
    src_sys = mcs.find("sourceSystem/SourceSystem")
    src_range = None
    if src_sys is not None and "minWavelength" in src_sys.attrib:
        a = src_sys.attrib
        src_range = (U.parse("wavelength", a["minWavelength"]),
                     U.parse("wavelength", a["maxWavelength"]))
    sources = ([build_source(e, base_dir, src_range)
                for e in src_sys.find("sources")]
               if src_sys is not None else [])
    if oligo and any(not isinstance(s, (PointSource, GeometricSource))
                     for s in sources):
        raise NotImplementedError("imported sources in oligochromatic mode "
                                  "not ported yet")
    if oligo:
        # sources emit at the discrete wavelength with their luminosity
        lams = U.parse_list("wavelength", src_sys.attrib["wavelengths"])
        if len(lams) != 1:
            raise NotImplementedError(
                f"oligochromatic runs at {len(lams)} wavelengths not ported "
                "yet (one)")
        sources = [dataclasses.replace(s, sed=None, lam0=lams[0])
                   for s in sources]
    elif src_range is not None:
        # SEDs normalised and sampled over the source range
        sources = [dataclasses.replace(s, sed=sedlib.clipped(s.sed,
                                                             *src_range))
                   if getattr(s, "sed", None) is not None else s
                   for s in sources]

    # media + grid
    med_sys = mcs.find("mediumSystem/MediumSystem")
    if med_sys is None:
        raise NotImplementedError("a ski file without a medium system not "
                                  "ported yet")
    components = []
    velocity_fields = []    # (component, field, magnitude [m/s])
    media = list(med_sys.find("media"))
    grid_el = list(med_sys.find("grid"))[0]
    imported = {"VoronoiMeshMedium": build_voronoi_medium,
                "AdaptiveMeshMedium": build_amr_medium,
                "ParticleMedium": build_snapshot_medium,
                "CellMedium": build_snapshot_medium}
    kind = next((m.tag for m in media if m.tag in imported), None)
    if kind is not None:
        grid, medium, mix = imported[kind](media, grid_el, base_dir)
        components.append((None, mix, None))
    else:
        for m_el in media:
            vd_el = _child(m_el, "velocityDistribution")
            if vd_el is not None:
                vmag = _q(m_el.attrib, "velocityMagnitude", "velocity", 0.0)
                if vmag != 0.0:
                    velocity_fields.append((len(components),
                                            build_vector_field(vd_el), vmag))
            components.append((build_geometry(_child(m_el, "geometry"),
                                              base_dir),
                               build_mix(_child(m_el, "materialMix"),
                                         base_dir),
                               build_medium_normalization(m_el)))
        grid = build_grid(grid_el, components[0][0], base_dir, device)
        medium = gm.build_medium(grid, components)
    if mode == "DustEmission" and isinstance(grid, (
            Cylinder2DGrid, polar.Sphere2DGrid, polar.Sphere3DGrid,
            polar.Cylinder3DGrid, TetraGrid, ClumpySphericalGrid)):
        # the reference's fails on these grids (no cell bounds)
        raise NotImplementedError(
            f"DustEmission on a {grid_el.tag} not ported yet")
    if velocity_fields:
        medium = medium._replace(bulk_v=torch.tensor(bulk_velocities(
            grid, medium.nd, velocity_fields).astype(np.float32)))
    # polarization: the first mix that carries Mueller tables switches the
    # photon cycle to Stokes-tracking scattering (`skirt9_tpu/config/ski.py:
    # 2197-2201`)
    mueller = next((m._mueller for _, m, _ in components
                    if getattr(m, "_mueller", None) is not None), None)
    # X-ray gas: its channel tables switch the photon cycle to the X-ray
    # branch (`skirt9_tpu/config/ski.py:2215-2227`)
    xray_tabs = next((xr.device_tables(m._xray, "cpu") for _, m, _ in components
                      if getattr(m, "_xray", None) is not None), None)
    # Lyman-alpha: the marker mix switches the photon cycle to the resonant
    # branch, with the acceleration scheme of the medium system's
    # LyaOptions; the cells take the mix's default gas temperature
    # (`skirt9_tpu/config/ski.py:2229-2262`)
    lya_cfg = next((m._lya for _, m, _ in components
                    if getattr(m, "_lya", None) is not None), None)
    lya = {}
    if lya_cfg is not None:
        if mode != "LyaExtinctionOnly":
            raise ValueError("LyaNeutralHydrogenGasMix requires "
                             "simulationMode='LyaExtinctionOnly'")
        lo_el = med_sys.find("lyaOptions/LyaOptions")
        la = lo_el.attrib if lo_el is not None else {}
        # includeHubbleFlow is read and ignored, as the reference ignores it
        scheme = la.get("lyaAccelerationScheme", "Variable")
        lya = dict(lya=True,
                   lya_strength=_f(la, "lyaAccelerationStrength", 1.0))
        if scheme == "Constant":
            lya["lya_xcrit"] = 3.0 * lya["lya_strength"]
        elif scheme == "Variable":
            lya["lya_variable"] = True
        t = medium.temperature.numpy()
        medium = medium._replace(temperature=torch.tensor(
            np.where(t > 0, t, float(lya_cfg["T_default"])).astype(
                np.float32)))

    # instruments
    if oligo:
        default_wlg = wl.oligo_borders(lams)
    elif src_range is None:
        default_wlg = wl.log_borders_skirt(0.1e-6, 10e-6, 25)
    else:
        default_wlg = wl.log_borders_skirt(src_range[0], src_range[1], 25)
    inst_sys = mcs.find("instrumentSystem/InstrumentSystem")
    instruments = []
    if inst_sys is not None:
        dwlg_el = inst_sys.find("defaultWavelengthGrid")
        if dwlg_el is not None and len(dwlg_el):
            default_wlg = build_wavelength_grid(list(dwlg_el)[0])
        inst_list = inst_sys.find("instruments")
        for i_el in (list(inst_list) if inst_list is not None else []):
            instruments.append(build_instrument(i_el, default_wlg))

    # radiation-field and dust-emission wavelength grids: explicit items
    # override the defaults
    with_emission = mode == "DustEmission"
    rf_borders = ems_borders = None
    rf_el = mcs.find(".//radiationFieldOptions/RadiationFieldOptions/"
                     "radiationFieldWLG")
    if rf_el is not None and len(rf_el):
        rf_borders = build_wavelength_grid(list(rf_el)[0])
    de_wlg_el = mcs.find(".//dustEmissionOptions/DustEmissionOptions/"
                         "dustEmissionWLG")
    if de_wlg_el is not None and len(de_wlg_el):
        ems_borders = build_wavelength_grid(list(de_wlg_el)[0])
    if rf_borders is None and with_emission:
        rf_borders = wl.log_borders_skirt(*(src_range or (0.05e-6, 10e-6)),
                                          25)
    if ems_borders is None and with_emission:
        ems_borders = wl.log_borders_skirt(1e-6, 2000e-6, 40)
    de_opts = mcs.find(".//dustEmissionOptions/DustEmissionOptions")
    ems_type = "Equilibrium"
    if de_opts is not None and \
            de_opts.attrib.get("dustEmissionType") == "Stochastic":
        ems_type = "Stochastic"

    # photon-cycle knobs (PhotonPacketOptions defaults)
    pp_el = mcs.find(".//photonPacketOptions/PhotonPacketOptions")
    pa = pp_el.attrib if pp_el is not None else {}
    force_scattering = pa.get("forceScattering", "true") == "true"
    path_length_bias = _f(pa, "pathLengthBias", 0.5)
    kinematics = bool(velocity_fields) and not oligo
    if (kinematics or lya) and force_scattering:
        # a moving medium or resonant Lya scattering invalidates the
        # stretched path's opacities: the bias is forced off (ref:
        # Configuration.cpp:493-497; `skirt9_tpu/config/ski.py:2264-2275`)
        path_length_bias = 0.0
    opts = lc.TransportOptions(
        max_steps=min(grid.max_steps(), 256), max_events=max_events,
        store_rf=rf_borders is not None,
        force_scattering=force_scattering,
        path_length_bias=path_length_bias,
        kinematics=kinematics, polarization=mueller is not None,
        min_weight_reduction=_f(pa, "minWeightReduction", 1e4),
        min_scatt_events=int(_f(pa, "minScattEvents", 0)),
        explicit_absorption=pa.get("explicitAbsorption", "false") == "true",
        xray=xray_tabs is not None, **lya)

    # cosmology: redshifted observers are not ported
    cos = cosmo.from_ski(_child(mcs, "cosmology"))
    if cos.redshift > 0.0:
        raise NotImplementedError(f"{type(cos).__name__} at redshift "
                                  f"{cos.redshift} not ported yet")
    cmb_temperature = 0.0
    if de_opts is not None and \
            de_opts.attrib.get("includeHeatingByCMB", "false") == "true":
        cmb_temperature = 2.725 * (1.0 + cos.redshift)

    # secondary iterations; the primary-iteration attributes need dynamic
    # recipes and do nothing without them, and
    # secondaryIterationPacketsMultiplier keeps its default, as in the
    # reference
    it_el = mcs.find(".//iterationOptions/IterationOptions")
    ia = it_el.attrib if it_el is not None else {}

    return Simulation(
        grid=grid, medium=medium, sources=sources, instruments=instruments,
        options=opts, rf_borders=rf_borders, ems_borders=ems_borders,
        num_packets=n_pk, batch_size=batch_size, seed=seed,
        dust_emission_type=ems_type, iterate_secondary=iterate_secondary,
        min_iterations=int(_f(ia, "minSecondaryIterations", 1)),
        max_iterations=int(_f(ia, "maxSecondaryIterations", 10)),
        include_primary=ia.get("includePrimaryEmission", "false") == "true",
        cmb_temperature=cmb_temperature,
        units=unitsystem.from_ski(_child(mcs, "units")), cosmology=cos,
        probes=build_probes(mcs), mueller=mueller, xray_tabs=xray_tabs,
        device=device, group=group)
