"""Monte Carlo simulation orchestrator on PyTorch tensors.

Port of `skirt9_tpu/simulation.py` on one device, on uniform Cartesian
grids, octrees and bintrees: `run_primary` launches each source's history
range in batches through `transport.lifecycle.life_cycle` and accumulates
the radiation field and instrument records on the device;
`run_with_dust_emission` adds equilibrium dust emission (the optional
self-absorption iterations, then a secondary segment with peel-off), and
`run_merged_iterations` its merged form (each iteration relaunches the
primary packets beside the secondary ones, `include_primary`);
`write_outputs` calibrates and writes the SED text files and frame FITS
cubes in the reference's format, in the ski file's unit system where the
loader set one.

With `refill_events` > 0 a segment runs in lane-refill generations
(`_run_segment_refilled`): each runs that many events on the resident
batch, then the dead lanes take the next histories, so no packet's life is
cut at an event cap. Segments with bin-pure strata do not refill, as in
the reference.

A multi-bin radiation field (RF) is filled from bin-pure lane groups: a
source with an SED launches stratified over the RF bins it covers
(`_strata_for`), a monochromatic one deposits into its own bin
(`_mono_rf_bin`), as in the reference, on every engine.

The device defaults to CUDA (`Simulation(..., device="cpu")` asks for the
CPU): all tables move there once, in `__post_init__`, and nothing falls
back to the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from . import device as dv
from .emission import equilibrium as eq
from .grids.bintree import BinTreeGrid
from .grids.cartesian import UniformCartesianGrid
from .grids.octree import OctreeGrid
from .instruments import distant as dinst
from .media import system as msys
from .ops import rng
from .sources import base as src
from .sources import secondary as sec
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
    # lane refill: > 0 runs each segment in generations of this many events,
    # relaunching dead lanes with the next histories (no lifetime cap)
    refill_events: int = 0
    # dust emission (the reference's fields, `skirt9_tpu/simulation.py:75-158`)
    ems_borders: np.ndarray | None = None
    spatial_bias: float = 0.5
    iterate_secondary: bool = False
    include_primary: bool = False
    min_iterations: int = 1
    max_iterations: int = 10
    max_fraction_of_primary: float = 0.01
    max_fraction_of_previous: float = 0.03
    secondary_packets_multiplier: float = 1.0
    dust_emission_type: str = "Equilibrium"
    cell_library: object = None
    cmb_temperature: float = 0.0
    checkpoint_path: str | None = None
    # set by the ski loader: the output unit system (default SI when None),
    # the cosmology and the probes (`probes.probes.ProbeSpec`)
    units: UnitSystem | None = None
    cosmology: object = None
    probes: list = dataclasses.field(default_factory=list)
    device: object = dataclasses.field(default="cuda", kw_only=True)

    def __post_init__(self):
        self.device = dv.resolve(self.device)
        lc.check_supported(self.options)
        if not isinstance(self.grid, _GRIDS):
            raise NotImplementedError(
                f"grid {type(self.grid).__name__} not ported yet (uniform "
                "Cartesian grids, octrees and bintrees only)")
        if self.dust_emission_type != "Equilibrium":
            raise NotImplementedError(f"{self.dust_emission_type} dust "
                                      "emission not ported yet (Equilibrium)")
        if self.cell_library is not None:
            raise NotImplementedError("spatial cell libraries not ported yet "
                                      "(all cells)")
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
        self._etabs_cache = None
        self._bounds_dev = None

    # -------------------------------------------------------------- internals

    def _engine_tables(self):
        """The reference's engine choice (`skirt9_tpu/simulation.py:194-217`)
        without its backend tests: the resident sweep while it supports the
        grid, then the multi-level sweep for trees, then trees on their
        voxel raster through the large-grid (XL) contracts, then uniform XL
        grids. A tree gets its fine leaf map (on the voxel raster: the
        tables' cell map, the same array) attached, so that launch-time
        `locate` is one gather (`:199-202`)."""
        if sw.supports_sweep(self.grid, self.medium):
            return sw.build_tables(self.grid, self.medium)
        tabs = None
        if ml.supports(self.grid, self.medium, self.options):
            tabs = ml.build_tables(self.grid, self.medium)
            leafmap = tabs.leafmap
        elif xl.supports_tree_xl(self.grid, self.medium):
            tabs = xl.build_tree_tables(self.grid, self.medium)
            leafmap = tabs.cellmap
            _log().info(
                f"transport: {type(self.grid).__name__} ({self.grid.ncells} "
                "leaves) on its exact "
                f"{'x'.join(map(str, tabs.n))} voxel raster (XL sweep)")
        if tabs is not None:
            if self.grid.leafmap is None:
                self.grid = self.grid._replace(leafmap=leafmap, fine_n=tabs.n)
            return tabs
        if isinstance(self.grid, (OctreeGrid, BinTreeGrid)):
            raise NotImplementedError(
                f"no transport engine for this {type(self.grid).__name__} "
                f"({self.grid.ncells} leaves, {self.medium.ncomp} components):"
                " the multi-level sweep takes power-of-two trees with fine "
                f"rasters <= {ml.NF_MAX} per axis, <= 4 components and none "
                "of kinematics, Lya, Compton, X-ray or explicit absorption, "
                "the XL sweep their voxel rasters up to "
                f"{xl.TREE_NF_MAX} per axis; the scan march is not ported yet")
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

    def _strata_for(self, source, opts):
        """Wavelength strata of a bin-pure launch, or None: (borders, bin
        map) over the source's SED support (or a secondary source's
        `lam_range`), one stratum per RF bin it covers plus edge strata
        outside the RF grid (bin -1), padded to a power of two by splitting
        the widest in-grid strata (`skirt9_tpu/simulation.py:396-465`)."""
        if self.rf_borders is None or not opts.store_rf:
            return None
        R = len(self.rf_borders) - 1
        if R <= 1:
            return None
        sed = getattr(source, "sed", None)
        if sed is not None:
            lmin, lmax = float(np.asarray(sed.lam)[0]), float(
                np.asarray(sed.lam)[-1])
        elif getattr(source, "lam_range", None) is not None:
            lmin, lmax = source.lam_range
        else:
            return None
        rb = np.asarray(self.rf_borders, np.float64)
        borders = [lmin]
        bin_map = []
        if lmin < rb[0]:
            borders.append(min(rb[0], lmax))
            bin_map.append(-1)
        for b in range(R):
            hi = min(rb[b + 1], lmax)
            if hi > borders[-1]:
                borders.append(hi)
                bin_map.append(b)
        if lmax > borders[-1]:
            borders.append(lmax)
            bin_map.append(-1)
        if not opts.peel_off:
            # RF-only segments: packets outside the RF grid deposit nothing
            # and reach no instrument, so the edge strata are dropped
            while bin_map and bin_map[0] == -1:
                bin_map.pop(0)
                borders.pop(0)
            while bin_map and bin_map[-1] == -1:
                bin_map.pop()
                borders.pop()
        if not 1 <= len(bin_map) <= 128:
            return None
        borders = np.asarray(borders, np.float64)
        target = 1
        while target < len(bin_map):
            target *= 2
        while len(bin_map) < target:
            widths = np.where(np.asarray(bin_map) >= 0,
                              np.log(borders[1:] / borders[:-1]), -1.0)
            i = int(np.argmax(widths))
            borders = np.insert(borders, i + 1,
                                np.sqrt(borders[i] * borders[i + 1]))
            bin_map.insert(i + 1, bin_map[i])
        return borders, tuple(bin_map)

    def _mono_rf_bin(self, source, opts) -> int:
        """RF bin of a monochromatic source in a multi-bin RF, else -1."""
        if self.rf_borders is None or not opts.store_rf:
            return -1
        R = len(self.rf_borders) - 1
        lam0 = getattr(source, "lam0", None)
        if R <= 1 or getattr(source, "sed", None) is not None or lam0 is None:
            return -1
        b = int(np.searchsorted(np.asarray(self.rf_borders), lam0,
                                side="right")) - 1
        return min(max(b, 0), R - 1)

    def _stratify(self, strata, stabs, opts, n_packets: int):
        """The reference's bin-pure batch layout (`skirt9_tpu/simulation.py:
        601-641`): the batch rounded to 1024-lane blocks per stratum, the
        strata and their valid-lane corrections in the source tables, and a
        history permutation that interleaves histories across strata, so a
        partial batch samples every stratum. Returns (B, stabs, opts,
        history permutation)."""
        borders, bin_map = strata
        R_g = len(bin_map)
        opts = dataclasses.replace(opts, rf_strata=R_g, rf_bin_map=bin_map)
        B = max(1, round(self.batch_size / (1024 * R_g))) * 1024 * R_g
        lanes = np.arange(B, dtype=np.int64)
        s_np = (lanes * R_g) // B
        hist_perm = (lanes - s_np * (B // R_g)) * R_g + s_np
        n_valid = np.zeros(R_g, np.int64)
        for b in range(-(-n_packets // B)):
            valid = (b * B + hist_perm) < n_packets
            n_valid += np.bincount(s_np[valid], minlength=R_g)
        corr = np.where(n_valid > 0,
                        (n_packets / R_g) / np.maximum(n_valid, 1), 0.0)
        f32 = lambda a: torch.tensor(np.asarray(a, np.float32),
                                     device=self.device)
        stabs = dict(stabs, strata=f32(borders), strata_w=f32(corr))
        return B, stabs, opts, torch.tensor(hist_perm, device=self.device)

    def _run_segment(self, source, stabs, opts, n_packets, seed_key, rf, accs,
                     hist_base=0):
        """Loop a source's history range through the life cycle, batch by
        batch; lanes past the range carry no weight. On the XL contracts
        the segment's deposits sum in an f64 table that the RF takes once,
        rounded, at its end: kernel 7 adds into it, and an event that
        leaves a point source puts 10^3-10^4 deposits into each hot cell."""
        if rf is not None and isinstance(self._sweep_tabs, xl.XLTables):
            rf_seg, accs = self._run_batches(
                source, stabs, opts, n_packets, seed_key,
                torch.zeros(rf.shape, dtype=torch.float64, device=rf.device),
                accs, hist_base)
            rf += rf_seg.float()
            return rf, accs
        return self._run_batches(source, stabs, opts, n_packets, seed_key, rf,
                                 accs, hist_base)

    def _run_batches(self, source, stabs, opts, n_packets, seed_key, rf, accs,
                     hist_base):
        B = self.batch_size
        lanes = torch.arange(B, dtype=torch.int64, device=self.device)
        strata = self._strata_for(source, opts)
        if strata is not None:
            B, stabs, opts, lanes = self._stratify(strata, stabs, opts,
                                                   n_packets)
        elif self._mono_rf_bin(source, opts) >= 0:
            opts = dataclasses.replace(
                opts, rf_mono_bin=self._mono_rf_bin(source, opts))
        if self.refill_events > 0 and strata is None:
            return self._run_segment_refilled(source, stabs, opts, n_packets,
                                              seed_key, rf, accs, hist_base)
        hist_end = hist_base + n_packets
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

    def _run_segment_refilled(self, source, stabs, opts, n_packets, seed_key,
                              rf, accs, hist_base):
        """Generation loop with in-place lane refill (the reference's
        `_run_segment_refilled`, `skirt9_tpu/simulation.py:685-846`, on one
        device). Each generation runs up to refill_events events on the
        resident batch, after its dead lanes took the next histories in lane
        order. Per-lane RNG event counters keep every packet's draws those
        of an unrefilled run, and the emission peel-off fires for the
        freshly launched lanes only. The refill runs on the device; the
        loop runs on the host, with one sync per generation (the count of
        alive lanes, from which the next history and the loop condition
        follow) beside the event loop's own."""
        B = self.batch_size
        K = self.refill_events
        hist_end = hist_base + n_packets
        # lanes die by the weight cutoff; allow generous but finite
        # lifetimes (a pure scatterer would otherwise spin forever)
        max_gens = (n_packets // B + 2) * (
            max(4 * self.options.max_events, 64) // K + 2)
        opts_k = dataclasses.replace(opts, max_events=K)
        launch = lambda history: src.launch_batch(
            source, stabs, self.grid, seed_key, history, n_packets,
            hist_end=hist_end)
        # every lane starts dead at the sentinel history, with weight 0
        pkt = launch(torch.full((B,), hist_end, dtype=torch.int64,
                                device=self.device))
        stats = self.last_stats
        next_hist, n_alive, gens = hist_base, 0, 0
        while (next_hist < hist_end or n_alive > 0) and gens < max_gens:
            dead = ~pkt.alive
            new_hist = next_hist + torch.cumsum(dead, 0) - 1
            refill = dead & (new_hist < hist_end)
            fresh = launch(torch.where(refill, new_hist, hist_end))
            pkt = type(pkt)(*(
                torch.where(refill.view((B,) + (1,) * (a.dim() - 1)), a, b)
                for a, b in zip(fresh, pkt)))
            rf, accs, pkt = lc.life_cycle(
                self.medium, opts_k, self.instruments, self._inst_tabs,
                self._rf_borders_dev, pkt, rf, accs, self._sweep_tabs,
                stats=stats, emit_mask=refill, return_state=True)
            next_hist += min(B - n_alive, hist_end - next_hist)
            n_alive = int(pkt.alive.sum())
            stats["syncs"] = stats.get("syncs", 0) + 1
            gens += 1
            _log().progress(next_hist - hist_base, n_packets)
        stats["generations"] = stats.get("generations", 0) + gens
        left = n_alive + (hist_end - next_hist)
        stats["abandoned"] = stats.get("abandoned", 0) + left
        if left:
            _log().warning(f"refill generation cap reached ({max_gens}); "
                           f"{n_alive} lanes abandoned, {hist_end - next_hist}"
                           " histories not launched")
        return rf, accs

    def _block(self, rf, accs, phase: str):
        self._sync()
        check_finite({"rf": rf, "accs": accs}, phase, _log())

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------- runs

    def _primary(self, opts, seed_key, accs):
        """Every source's history range through the life cycle with opts
        (the primary segment): (rf, accs)."""
        rf = self._init_rf()
        hist_base = 0
        for si, n_src in enumerate(self._source_allocation(self.num_packets)):
            n_src = int(n_src)
            if n_src == 0:
                continue
            rf, accs = self._run_segment(
                self.sources[si], self._src_tabs[si], opts, n_src, seed_key,
                rf, accs, hist_base=hist_base)
            hist_base += n_src
        return rf, accs

    def run_primary(self, verbose: bool = True):
        """Primary-emission segment. Returns (rf, accs): the radiation field
        (ncells, nbins) path-length sums in units of rf_scale [W m], or None,
        and the instrument accumulators."""
        accs = [dinst.init_accumulators(c, self.device)
                for c in self.instruments]
        self.last_stats = {}
        t0 = time.perf_counter()
        rf, accs = self._primary(self.options,
                                 rng.seed_key(self.seed, self.device), accs)
        self._block(rf, accs, phase="primary emission")
        dt = time.perf_counter() - t0
        if verbose:
            _log().success(f"primary emission: {self.num_packets:,} packets "
                           f"in {dt:.2f} s ({self.num_packets / dt:,.0f} "
                           "packets/s)")
        self.last_rate = self.num_packets / dt
        self.last_stats["seconds"] = dt
        return rf, accs

    def run_with_dust_emission(self, verbose: bool = True):
        """Primary emission, the self-absorption iterations when
        `iterate_secondary` is set (segments that store the RF, no
        peel-off), then a secondary segment with peel-off from the total
        field (`skirt9_tpu/simulation.py:984-1086`). Resumes from
        `checkpoint_path` when one is there.

        Returns (rf_total, accs, info) with info {"iterations", "L_dust",
        "L_abs_primary"}; `last_stats["segments"]` holds each segment's
        name, packets, seconds and events."""
        if self.ems_borders is None:
            raise ValueError("set ems_borders for dust emission")
        if self.iterate_secondary and self.include_primary:
            return self.run_merged_iterations(verbose=verbose)
        t_all = time.perf_counter()
        resume = self._load_checkpoint()
        med = self.medium
        etabs = self._emission_tables()
        if resume is None:
            rf_prim, accs = self.run_primary(verbose=verbose)
            segments = [("primary", self.num_packets, self.last_stats["seconds"],
                         self.last_stats.get("events", 0))]
            L_prim_abs = eq.total_absorbed_device(med, etabs, rf_prim,
                                                  self.rf_scale)
            rf_total = rf_prim
            L_abs_prev = 0.0
            iterations = 0
            self._save_checkpoint(rf_prim, rf_total, accs, 0.0, L_prim_abs, 0)
        else:
            rf_prim, rf_total, accs, L_abs_prev, L_prim_abs, iterations = resume
            segments = []
            if verbose:
                _log().info(f"resumed from checkpoint: {iterations} "
                            "iterations already done")
        n2 = int(self.num_packets * self.secondary_packets_multiplier)
        opts2 = dataclasses.replace(self.options, primary=False)
        opts2_nopeel = dataclasses.replace(opts2, peel_off=False)
        seed_key = rng.seed_key(self.seed + 1, self.device)

        def segment(name, src2, opts, key, rf, accs):
            events0 = self.last_stats.get("events", 0)
            t0 = time.perf_counter()
            rf, accs = self._run_segment(src2, src2.tables(), opts, n2, key,
                                         rf, accs)
            self._sync()
            segments.append((name, n2, time.perf_counter() - t0,
                             self.last_stats.get("events", 0) - events0))
            return rf, accs

        # self-absorption iterations (no peel-off)
        for it in range(iterations, self.max_iterations
                        if self.iterate_secondary else 0):
            src2 = self._make_secondary(etabs, rf_total)
            if src2.luminosity <= 0:
                break
            rf_seco, _ = segment(f"secondary iteration {it + 1}", src2,
                                 opts2_nopeel, rng.fold_in(seed_key, it),
                                 self._init_rf(), [])
            rf_total = rf_prim + rf_seco
            L_abs = eq.total_absorbed_device(med, etabs, rf_seco,
                                             self.rf_scale)
            iterations += 1
            self._save_checkpoint(rf_prim, rf_total, accs, L_abs, L_prim_abs,
                                  iterations)
            if verbose:
                _log().info(f"dust self-absorption iter {it + 1}: "
                            f"L_abs(seco)={L_abs:.4e} W "
                            f"(prim {L_prim_abs:.4e} W)")
            # convergence: secondary absorption small against the primary,
            # or stable against the previous iteration
            if it + 1 >= self.min_iterations:
                if L_abs <= self.max_fraction_of_primary * L_prim_abs:
                    break
                if L_abs_prev > 0 and abs(L_abs - L_abs_prev) <= \
                        self.max_fraction_of_previous * L_abs_prev:
                    break
            L_abs_prev = L_abs

        # final secondary segment with peel-off
        src2 = self._make_secondary(etabs, rf_total)
        info = {"iterations": iterations, "L_dust": src2.luminosity,
                "L_abs_primary": L_prim_abs}
        if src2.luminosity > 0:
            _, accs = segment("secondary", src2,
                              dataclasses.replace(opts2, store_rf=False),
                              rng.fold_in(seed_key, 777), None, accs)
        self._block(rf_total, accs, phase="dust emission")
        self._clear_checkpoint()
        self.last_stats["segments"] = segments
        if verbose:
            _log().success(f"dust emission done in "
                           f"{time.perf_counter() - t_all:.1f} s "
                           f"({iterations} iterations, "
                           f"L_dust={src2.luminosity:.4e} W)")
        return rf_total, accs, info

    def run_merged_iterations(self, verbose: bool = True):
        """Merged primary and secondary emission iterations
        (`include_primary` with `iterate_secondary`; the reference's
        `skirt9_tpu/simulation.py:1088-1211` without dynamic medium
        recipes): each iteration relaunches the primary packets without
        peel-off, then a secondary segment from the total field, until the
        dust-absorption test holds (after `min_iterations`) or
        `max_iterations` pass; then the final primary and secondary
        segments with peel-off.

        Returns (rf_total, accs, info) as `run_with_dust_emission` does,
        with each segment in `last_stats["segments"]`."""
        if self.ems_borders is None:
            raise ValueError("set ems_borders for dust emission")
        t_all = time.perf_counter()
        etabs = self._emission_tables()
        n2 = int(self.num_packets * self.secondary_packets_multiplier)
        opts_nopeel = dataclasses.replace(self.options, peel_off=False)
        opts2_nopeel = dataclasses.replace(opts_nopeel, primary=False)
        seed_key = rng.seed_key(self.seed + 1, self.device)
        segments = []
        self.last_stats = {}

        def timed(name, n, fn):
            events0 = self.last_stats.get("events", 0)
            t0 = time.perf_counter()
            out = fn()
            self._sync()
            segments.append((name, n, time.perf_counter() - t0,
                             self.last_stats.get("events", 0) - events0))
            return out

        rf_seco = self._init_rf()
        L_abs_prev, L_prim_abs, it = 0.0, 1.0, 0
        while True:
            it += 1
            rf_prim, _ = timed(f"merged primary {it}", self.num_packets,
                               lambda: self._primary(
                                   opts_nopeel,
                                   rng.fold_in(seed_key, 1000 + it), []))
            rf_total = rf_prim + rf_seco
            L_prim_abs = eq.total_absorbed_device(self.medium, etabs,
                                                  rf_prim, self.rf_scale)
            src2 = self._make_secondary(etabs, rf_total)
            if src2.luminosity <= 0:
                if verbose:
                    _log().warning("merged iterations: secondary luminosity "
                                   "is zero")
                break
            rf_seco, _ = timed(
                f"merged secondary {it}", n2,
                lambda: self._run_segment(
                    src2, src2.tables(), opts2_nopeel, n2,
                    rng.fold_in(seed_key, 2000 + it), self._init_rf(), []))
            L_abs = eq.total_absorbed_device(self.medium, etabs, rf_seco,
                                             self.rf_scale)
            if verbose:
                _log().info(f"merged iteration {it}: "
                            f"L_abs(seco)={L_abs:.4e} W "
                            f"(prim {L_prim_abs:.4e} W)")
            converged = (L_abs <= self.max_fraction_of_primary * L_prim_abs
                         or (L_abs_prev > 0
                             and abs(L_abs - L_abs_prev)
                             <= self.max_fraction_of_previous * L_abs_prev))
            L_abs_prev = L_abs
            if converged and it >= self.min_iterations:
                if verbose:
                    _log().success(f"merged iterations converged after {it}")
                break
            if not converged and it >= self.max_iterations:
                _log().warning(f"merged iterations NOT converged after {it}")
                break

        # final segments with peel-off: the primary one as run_primary's
        accs = [dinst.init_accumulators(c, self.device)
                for c in self.instruments]
        rf_prim, accs = timed(
            "primary", self.num_packets, lambda: self._primary(
                self.options, rng.seed_key(self.seed, self.device), accs))
        rf_total = rf_prim + rf_seco
        src2 = self._make_secondary(etabs, rf_total)
        info = {"iterations": it, "L_dust": src2.luminosity,
                "L_abs_primary": L_prim_abs}
        if src2.luminosity > 0:
            opts2 = dataclasses.replace(self.options, primary=False,
                                        store_rf=False)
            _, accs = timed("secondary", n2, lambda: self._run_segment(
                src2, src2.tables(), opts2, n2, rng.fold_in(seed_key, 777),
                None, accs))
        self._block(rf_total, accs, phase="merged emission")
        self.last_stats["segments"] = segments
        if verbose:
            _log().success(f"merged emission done in "
                           f"{time.perf_counter() - t_all:.1f} s "
                           f"({it} iterations, "
                           f"L_dust={src2.luminosity:.4e} W)")
        return rf_total, accs, info

    def _emission_tables(self):
        """Equilibrium emission tables, built once: they depend on the
        medium and the wavelength grids only."""
        if self._etabs_cache is None:
            self._etabs_cache = eq.build_emission_tables(
                self.medium, np.asarray(self.rf_borders),
                np.asarray(self.ems_borders))
        return self._etabs_cache

    def _make_secondary(self, etabs, rf) -> sec.DustSecondarySource:
        """The dust secondary source of the field rf: the emission state on
        the device (all cells, Equilibrium), the launch cdf on the host."""
        p_cmb = (eq.cmb_heating_power(etabs, self.cmb_temperature)
                 if self.cmb_temperature > 0 else None)
        L_cell, _, eps = eq.emission_state_device(
            self.medium, etabs, rf, self.grid.volumes(), self.rf_scale,
            p_cmb=p_cmb)
        if self._bounds_dev is None:
            self._bounds_dev = tuple(
                torch.tensor(a.astype(np.float32), device=self.device)
                for a in sec.cell_bounds(self.grid))
        return sec.prepare_device(self.grid, L_cell, eps,
                                  np.asarray(self.ems_borders),
                                  self.spatial_bias,
                                  bounds_dev=self._bounds_dev)

    def dust_temperature(self, rf) -> np.ndarray:
        """Indicative equilibrium dust temperature per cell (ncells, H) [K],
        host f64."""
        etabs = eq.build_emission_tables(
            self.medium, np.asarray(self.rf_borders),
            np.asarray(self.ems_borders if self.ems_borders is not None
                       else self.rf_borders))
        p_abs = eq.absorbed_power(self.medium, etabs, rf, self.grid.volumes(),
                                  self.rf_scale)
        return eq.equilibrium_temperature(etabs, p_abs)

    # ------------------------------------------------------- checkpointing

    def _acc_leaves(self, accs):
        return [(i, k, acc[k]) for i, acc in enumerate(accs)
                for k in sorted(acc)]

    def _save_checkpoint(self, rf_prim, rf_total, accs, L_abs_prev,
                         L_prim_abs, iterations):
        """Persist the state between emission segments (.npz, atomic
        swap)."""
        if not self.checkpoint_path:
            return
        host = lambda t: t.detach().cpu().numpy()
        payload = {f"acc{i}_{k}": host(t) for i, k, t in self._acc_leaves(accs)}
        tmp = self.checkpoint_path + ".tmp.npz"
        np.savez(tmp, rf_prim=host(rf_prim), rf_total=host(rf_total),
                 L_abs_prev=float(L_abs_prev), L_prim_abs=float(L_prim_abs),
                 it=int(iterations), seed=int(self.seed), **payload)
        os.replace(tmp, self.checkpoint_path)

    def _load_checkpoint(self):
        p = self.checkpoint_path
        if not p or not os.path.exists(p):
            return None
        d = np.load(p, allow_pickle=False)
        if int(d["seed"]) != int(self.seed):
            _log().warning("checkpoint seed differs from the run seed; "
                           "ignoring the checkpoint")
            return None
        dev = lambda a: torch.tensor(np.asarray(a), device=self.device)
        accs = [dinst.init_accumulators(c, self.device)
                for c in self.instruments]
        for i, k, t in self._acc_leaves(accs):
            t.copy_(dev(d[f"acc{i}_{k}"]))
        return (dev(d["rf_prim"]), dev(d["rf_total"]), accs,
                float(d["L_abs_prev"]), float(d["L_prim_abs"]), int(d["it"]))

    def _clear_checkpoint(self):
        if self.checkpoint_path and os.path.exists(self.checkpoint_path):
            os.remove(self.checkpoint_path)

    # ----------------------------------------------------------------- output

    def write_outputs(self, accs, prefix: str, outdir: str = ".") -> list[str]:
        """Calibrate and write instrument outputs: `<prefix>_<name>_sed.dat`
        and, for frame instruments, `<prefix>_<name>_total.fits`."""
        paths = []
        us = self.units or UnitSystem()
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
