"""Monte Carlo simulation orchestrator on PyTorch tensors.

Port of `skirt9_tpu/simulation.py` for primary emission on one device, on
uniform Cartesian grids, octrees and bintrees:
`run_primary` launches each source's history range in batches through
`transport.lifecycle.life_cycle` and accumulates the radiation field and
instrument records on the device; `write_outputs` calibrates and writes the
SED text files and frame FITS cubes in the reference's format.

The device is explicit (`Simulation(..., device="cuda")`): all tables move
there once, in `__post_init__`, and nothing falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from . import device as dv
from .grids.bintree import BinTreeGrid
from .grids.cartesian import UniformCartesianGrid
from .grids.octree import OctreeGrid
from .instruments import distant as dinst
from .media import system as msys
from .ops import rng
from .sources import base as src
from .transport import lifecycle as lc
from .transport import mlsweep as ml
from .transport import sweep as sw
from .transport import sweepxl as xl
from .utils import fits as fitsio
from .utils.guards import check_finite
from .utils.log import default as _log
from .utils.unitsystem import UnitSystem

_GRIDS = (UniformCartesianGrid, OctreeGrid, BinTreeGrid)


@dataclasses.dataclass
class Simulation:
    """A configured simulation: grid + medium + sources + instruments."""

    grid: UniformCartesianGrid | OctreeGrid | BinTreeGrid
    medium: msys.MediumTables
    sources: list
    instruments: list           # list[DistantInstrumentCfg]
    options: lc.TransportOptions
    rf_borders: np.ndarray | None = None   # radiation-field bin borders [m]
    num_packets: int = 100_000
    batch_size: int = 16_384
    seed: int = 0
    source_bias: float = 0.5
    device: object = dataclasses.field(kw_only=True)

    def __post_init__(self):
        self.device = dv.resolve(self.device)
        lc.check_supported(self.options)
        if not isinstance(self.grid, _GRIDS):
            raise NotImplementedError(
                f"grid {type(self.grid).__name__} not ported yet (uniform "
                "Cartesian grids, octrees and bintrees only)")
        if self.rf_borders is not None and self.options.store_rf \
                and len(self.rf_borders) != 2:
            raise NotImplementedError("multi-bin radiation field not ported "
                                      "yet (one RF bin only)")
        # statistics power sums normalised by the mean packet contribution
        # so that they stay inside f32
        L_tot = sum(float(getattr(s, "luminosity", 1.0)) for s in self.sources)
        sscale = max(L_tot / max(self.num_packets, 1), 1e-300)
        self.instruments = [
            dataclasses.replace(c, stats_scale=sscale)
            if c.stats_scale == 1.0 else c for c in self.instruments]
        dev = self.device
        self.grid = self.grid.to(dev)
        self.medium = self.medium.to(dev)
        self._inst_tabs = [dinst.device_tables(c, dev) for c in self.instruments]
        self._src_tabs = [s.tables(dev) for s in self.sources]
        self._rf_borders_dev = (
            torch.tensor(np.asarray(self.rf_borders, np.float32), device=dev)
            if self.rf_borders is not None else None)
        self._sweep_tabs = self._engine_tables()
        # RF accumulator unit [W m]: keeps f32 in range for luminous sources
        self.rf_scale = max(L_tot / max(self.num_packets, 1)
                            * self.grid.diagonal(), 1e-300)
        self.options = dataclasses.replace(self.options, rf_scale=self.rf_scale)
        self.last_stats: dict = {}

    # -------------------------------------------------------------- internals

    def _engine_tables(self):
        """The reference's engine choice (`skirt9_tpu/simulation.py:194-215`):
        the resident sweep while it supports the grid, then the multi-level
        sweep for trees, else the large-grid (XL) contracts. A tree on the
        multi-level sweep gets its fine leaf map attached, so that launch-time
        `locate` is one gather (`:199-202`)."""
        if sw.supports_sweep(self.grid, self.medium):
            return sw.build_tables(self.grid, self.medium)
        if ml.supports(self.grid, self.medium, self.options):
            tabs = ml.build_tables(self.grid, self.medium)
            if self.grid.leafmap is None:
                self.grid = self.grid._replace(leafmap=tabs.leafmap,
                                               fine_n=tabs.n)
            return tabs
        if isinstance(self.grid, (OctreeGrid, BinTreeGrid)):
            raise NotImplementedError(
                f"no transport engine for this {type(self.grid).__name__} "
                f"({self.grid.ncells} leaves, {self.medium.ncomp} components):"
                " the multi-level sweep takes power-of-two trees with fine "
                f"rasters <= {ml.NF_MAX} per axis, <= 4 components and none "
                "of kinematics, Lya, Compton, X-ray or explicit absorption; "
                "the tree XL raster and the scan march are not ported yet")
        if xl.supports_xl(self.grid, self.medium):
            _log().info("transport: large-grid (XL) sweep for "
                        f"{'x'.join(map(str, self.grid.shape))}")
            return xl.build_tables(self.grid, self.medium)
        raise NotImplementedError(
            f"no transport engine for a {'x'.join(map(str, self.grid.shape))} "
            f"grid with {self.medium.ncomp} components (the sweeps take axes "
            "<= 512 and <= 4 components; the scan march is not ported yet)")

    def _source_allocation(self, n: int) -> np.ndarray:
        """History counts per source with the composite luminosity/uniform
        bias. Each source normalises its packets by its own count, which
        compensates the biased allocation exactly (no further weights)."""
        ls = np.array([getattr(s, "luminosity", 1.0) for s in self.sources],
                      np.float64)
        m = len(self.sources)
        w = (1.0 - self.source_bias) * ls / ls.sum() + self.source_bias / m
        counts = np.floor(w * n).astype(np.int64)
        counts[0] += n - counts.sum()
        return counts

    def _init_rf(self):
        if self.rf_borders is None or not self.options.store_rf:
            return None
        # per cell on every engine: the tree kernels deposit straight into
        # leaf cells, where the reference accumulates in per-level plane
        # space and maps to cells once per segment (its finalize_rf)
        return torch.zeros((self.grid.ncells, len(self.rf_borders) - 1),
                           dtype=torch.float32, device=self.device)

    def _run_segment(self, source, stabs, opts, n_packets, seed_key, rf, accs,
                     hist_base=0):
        """Loop a source's history range through the life cycle, batch by
        batch; lanes past the range carry no weight."""
        B = self.batch_size
        hist_end = hist_base + n_packets
        lanes = torch.arange(B, dtype=torch.int64, device=self.device)
        for b in range(-(-n_packets // B)):
            history = hist_base + b * B + lanes
            pkt = src.launch_batch(source, stabs, self.grid, seed_key, history,
                                   n_packets, hist_end=hist_end)
            rf, accs = lc.life_cycle(self.medium, opts, self.instruments,
                                     self._inst_tabs, self._rf_borders_dev,
                                     pkt, rf, accs, self._sweep_tabs,
                                     stats=self.last_stats)
            _log().progress(min((b + 1) * B, n_packets), n_packets)
        return rf, accs

    def _block(self, rf, accs, phase: str):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        check_finite({"rf": rf, "accs": accs}, phase, _log())

    # ------------------------------------------------------------------- runs

    def run_primary(self, verbose: bool = True):
        """Primary-emission segment. Returns (rf, accs): the radiation field
        (ncells, nbins) path-length sums in units of rf_scale [W m], or None,
        and the instrument accumulators."""
        rf = self._init_rf()
        accs = [dinst.init_accumulators(c, self.device)
                for c in self.instruments]
        seed_key = rng.seed_key(self.seed, self.device)
        counts = self._source_allocation(self.num_packets)
        self.last_stats = {}
        t0 = time.perf_counter()
        launched = hist_base = 0
        for si, n_src in enumerate(counts):
            n_src = int(n_src)
            if n_src == 0:
                continue
            rf, accs = self._run_segment(
                self.sources[si], self._src_tabs[si], self.options, n_src,
                seed_key, rf, accs, hist_base=hist_base)
            launched += n_src
            hist_base += n_src
        self._block(rf, accs, phase="primary emission")
        dt = time.perf_counter() - t0
        if verbose:
            _log().success(f"primary emission: {launched:,} packets in "
                           f"{dt:.2f} s ({launched / dt:,.0f} packets/s)")
        self.last_rate = launched / dt
        self.last_stats["seconds"] = dt
        return rf, accs

    # ----------------------------------------------------------------- output

    def write_outputs(self, accs, prefix: str, outdir: str = ".") -> list[str]:
        """Calibrate and write instrument outputs: `<prefix>_<name>_sed.dat`
        and, for frame instruments, `<prefix>_<name>_total.fits`."""
        paths = []
        us = UnitSystem()
        names = [("total", "total flux"),
                 ("transparent", "transparent flux"),
                 ("primarydirect", "direct primary flux"),
                 ("primaryscattered", "scattered primary flux"),
                 ("secondarydirect", "direct secondary flux"),
                 ("secondaryscattered", "scattered secondary flux")]
        for cfg, acc in zip(self.instruments, accs):
            sed = dinst.calibrate_sed(cfg, acc)
            lam_m = np.asarray(sed["wavelength"], np.float64)
            cols = [us.out_wavelength(lam_m)]
            hdr = [f"# column 1: wavelength; lambda ({us.unit('wavelength')})"]
            for i, (key, desc) in enumerate(names):
                cols.append(us.out_flux(np.atleast_1d(sed[key]), lam_m))
                hdr.append(f"# column {i + 2}: {desc}; {us.flux_symbol} "
                           f"({us.flux_unit})")
            if "R" in sed:
                cols += [np.atleast_1d(sed["R"]), np.atleast_1d(sed["VOV"])]
                hdr.append(f"# column {len(cols) - 1}: relative error R (1)")
                hdr.append(f"# column {len(cols)}: variance of the variance "
                           "VOV (1)")
            p = os.path.join(outdir, f"{prefix}_{cfg.name}_sed.dat")
            with open(p, "w") as f:
                f.write("# skirt9_tpu_torch SED output\n" + "\n".join(hdr)
                        + "\n")
                np.savetxt(f, np.column_stack(cols))
            paths.append(p)
            if cfg.has_frame:
                cube = dinst.calibrate_frame(cfg, acc)
                p2 = os.path.join(outdir, f"{prefix}_{cfg.name}_total.fits")
                fitsio.write_fits(p2, cube.astype(np.float32), {
                    "BUNIT": "W/m2/m/sr",
                    "CDELT1": cfg.fovx / cfg.npx,
                    "CDELT2": cfg.fovy / cfg.npy,
                })
                paths.append(p2)
        return paths
