"""Config 2 (bench2.ski: panchromatic dust emission) through the port on the CPU.

- The port's bench2 configuration (`chip_smoke.config2`, the port's own API)
  against the reference's `load_ski("tests/golden/bench2.ski")`: grid,
  medium, source, instrument, borders and options array for array, no
  transport run.
- The slice: a reduced bench2 (8^3 grid, a 4-bin RF, 8,192 packets in two
  batches of 4,096 lanes, 4 events, one self-absorption iteration) through
  `run_with_dust_emission` on both packages. The reference runs its
  stratified sweep (`SKIRT9_TPU_FORCE_SWEEP=1`, its Pallas kernels in
  interpret mode, as `tests/test_stratified.py:131` does), the port the
  plain versions of its kernels, on the same random numbers: every SED
  kind, the frame, the RF and `info` within 1e-5 of their largest values
  (they agree to 3e-7: f32 rounding).
- A monochromatic source in a multi-bin RF deposits into its own bin
  exactly what a one-bin RF over that bin holds; checkpoints resume a run;
  a tree whose fine raster is over 512 per axis takes the scan march, as
  in the reference (draw for draw with its CPU run, a two-bin RF); what is
  not ported raises (dynamic medium recipes, stochastic emission, cell
  libraries, spheroidal grains).
"""

import dataclasses
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from skirt9_tpu.config.ski import load_ski
from skirt9_tpu_torch import bridge
from skirt9_tpu_torch.grids.cartesian import make_cartesian
from skirt9_tpu_torch.instruments.distant import DistantInstrumentCfg
from skirt9_tpu_torch.kernels import build as kb
from skirt9_tpu_torch.media import system as msys
from skirt9_tpu_torch.simulation import Simulation
from skirt9_tpu_torch.sources.base import PointSource
from skirt9_tpu_torch.transport.lifecycle import TransportOptions

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

PC = 3.0857e16


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def test_bench2_config_matches_load_ski():
    ref = bridge.simulation(load_ski(os.path.join(GOLDEN, "bench2.ski"),
                                     batch_size=1 << 17, max_events=24,
                                     num_packets=1 << 20), "cpu")
    port = chip_smoke.config2("cpu")
    for f in ("lo", "hi", "h", "inv_h"):
        assert torch.equal(getattr(port.grid, f), getattr(ref.grid, f)), f
    assert port.grid.shape == ref.grid.shape == (32, 32, 32)
    for f in ("nd", "lam_t", "sigma_ext", "sigma_sca", "g"):
        assert torch.equal(getattr(port.medium, f), getattr(ref.medium, f)), f
    for f in ("rf_borders", "ems_borders"):
        assert np.array_equal(getattr(port, f), getattr(ref, f)), f
    ps, rs = port.sources[0], ref.sources[0]
    assert np.array_equal(ps.sed.lam, rs.sed.lam)
    assert np.array_equal(ps.sed.s, rs.sed.s)
    assert dataclasses.replace(ps, sed=None) == dataclasses.replace(rs, sed=None)
    assert port.instruments == ref.instruments
    assert port.options == ref.options
    for f in ("num_packets", "batch_size", "seed", "source_bias",
              "spatial_bias", "iterate_secondary", "min_iterations",
              "max_iterations", "max_fraction_of_primary",
              "max_fraction_of_previous", "secondary_packets_multiplier",
              "dust_emission_type", "cmb_temperature", "rf_scale"):
        assert getattr(port, f) == getattr(ref, f), f
    # 25 RF bins stratified into 32 bin-pure lane groups of a 2^17 batch
    borders, bin_map = port._strata_for(port.sources[0], port.options)
    assert len(bin_map) == 32 and sorted(set(bin_map)) == list(range(25))
    B, _, opts, _ = port._stratify((borders, bin_map), {}, port.options,
                                   port.num_packets)
    assert B == 1 << 17 and opts.rf_strata == 32


def _small_bench2(tmp_path):
    ski = open(os.path.join(GOLDEN, "bench2.ski")).read()
    ski = ski.replace('numBins="32"', 'numBins="8"').replace(
        'numWavelengths="25"', 'numWavelengths="4"')
    (tmp_path / "small.ski").write_text(ski)
    shutil.copy(os.path.join(GOLDEN, "mrn_mean.txt"), tmp_path)
    ref = load_ski(str(tmp_path / "small.ski"), batch_size=4096, max_events=4,
                   num_packets=8192)
    ref.iterate_secondary, ref.max_iterations = True, 1
    return ref


def test_config2_slice_draw_for_draw(tmp_path, monkeypatch):
    monkeypatch.setenv("SKIRT9_TPU_FORCE_SWEEP", "1")
    ref = _small_bench2(tmp_path)
    assert type(ref._sweep_tabs).__name__ == "SweepTables"
    port = bridge.simulation(ref, "cpu")
    # both packages take the same strata, hence the same batch layout
    for opts in (ref.options, dataclasses.replace(ref.options,
                                                  peel_off=False)):
        r = ref._strata_for(ref.sources[0], opts)
        p = port._strata_for(port.sources[0], opts)
        assert np.array_equal(r[0], p[0]) and r[1] == p[1]
    rf_r, accs_r, info_r = ref.run_with_dust_emission(verbose=False)
    kb.reset_launches()
    rf_p, accs_p, info_p = port.run_with_dust_emission(verbose=False)
    assert kb.LAUNCHES == {k: 0 for k in kb.LAUNCHES}
    assert info_p["iterations"] == info_r["iterations"] == 1
    for k in ("L_dust", "L_abs_primary"):
        assert info_p[k] == pytest.approx(info_r[k], rel=1e-5), k
    assert [s[0] for s in port.last_stats["segments"]] == [
        "primary", "secondary iteration 1", "secondary"]
    rf_r = np.asarray(rf_r, np.float64)
    assert rf_r.shape == (512, 4) and rf_r.max() > 0
    assert np.abs(_np(rf_p) - rf_r).max() <= 1e-5 * rf_r.max()
    for key in ("sed", "stats", "frame"):
        r = np.asarray(accs_r[0][key], np.float64)
        p = _np(accs_p[0][key]).astype(np.float64)
        if key == "stats":
            r, p = r[:2], p[:2]          # counts and first power sums
        for k in range(r.shape[0]):
            assert r[k].max() > 0, (key, k)
            assert np.abs(p[k] - r[k]).max() <= 1e-5 * np.abs(r[k]).max(), \
                (key, k)


def _mono_sim(rf_borders, lam0=0.55e-6):
    grid = make_cartesian(((-1.2 * PC, 1.2 * PC),) * 3, (8,) * 3)
    nd = msys.uniform_density_sphere(grid, 1.0, 1e-24, PC)
    med = msys.make_medium(grid, nd, np.array([0.1e-6, 2e-6]),
                           sigma_ext=np.full((1, 2), 1e-24),
                           albedo=np.full((1, 2), 0.6), g=np.full((1, 2), 0.5))
    inst = DistantInstrumentCfg(name="i0", wave_borders=(0.5e-6, 0.6e-6),
                                distance=100 * PC)
    return Simulation(grid=grid, medium=med,
                      sources=[PointSource(luminosity=1.0, lam0=lam0)],
                      instruments=[inst],
                      options=TransportOptions(max_steps=grid.max_steps(),
                                               max_events=4),
                      rf_borders=np.asarray(rf_borders), num_packets=2048,
                      batch_size=1024, device="cpu")


def test_monochromatic_source_in_multibin_rf():
    multi = _mono_sim([0.1e-6, 0.3e-6, 0.5e-6, 0.6e-6, 2e-6])
    assert multi._mono_rf_bin(multi.sources[0], multi.options) == 2
    one = _mono_sim([0.5e-6, 0.6e-6])
    rf_m, accs_m = multi.run_primary(verbose=False)
    rf_1, accs_1 = one.run_primary(verbose=False)
    assert float(rf_1.sum()) > 0
    assert torch.equal(rf_m[:, 2], rf_1[:, 0])
    assert float(rf_m[:, [0, 1, 3]].abs().sum()) == 0.0
    assert torch.equal(accs_m[0]["sed"], accs_1[0]["sed"])


def test_checkpoint_resume(tmp_path):
    """A run with a checkpoint path leaves none behind; a checkpoint saved
    after the primary segment resumes to the same result."""
    def sim(path=None):
        s = chip_smoke.config2("cpu", num_packets=1024, batch_size=1024, n=4,
                               n_rf=4, max_events=3)
        s.checkpoint_path = path
        return s
    path = str(tmp_path / "ck.npz")
    full = sim(path)
    rf, accs, info = full.run_with_dust_emission(verbose=False)
    assert not os.path.exists(path)
    part = sim(path)
    rf_prim, accs_prim = part.run_primary(verbose=False)
    part._save_checkpoint(rf_prim, rf_prim, accs_prim, 0.0,
                          info["L_abs_primary"], 0)
    rf2, accs2, info2 = sim(path).run_with_dust_emission(verbose=False)
    assert torch.equal(rf2, rf) and info2 == info
    assert torch.equal(accs2[0]["sed"], accs[0]["sed"])
    assert not os.path.exists(path)


@pytest.mark.parametrize("case", ["tree_over_512", "stochastic", "library",
                                  "merged_dynamic", "spheroidal"])
def test_not_ported_raises(case, tmp_path, monkeypatch):
    if case == "tree_over_512":
        # a level-10 octree (a 1024 fine raster): past the multi-level
        # sweep and the XL voxel raster, the scan march, as the reference's
        from skirt9_tpu.grids.octree import build_octree as ref_octree
        from skirt9_tpu.grids.octree import site_list_refine_fn as ref_sites
        from skirt9_tpu_torch.grids.octree import (build_octree,
                                                   site_list_refine_fn)
        from test_torch_trees import _reference, marches_as_reference
        sites = np.array([[0.1, 0.2, 0.3], [0.1005, 0.2005, 0.3005]]) * PC
        grid = build_octree(((-PC, PC),) * 3, lambda p: np.ones(len(p)),
                            max_level=10, min_level=1,
                            refine_fn=site_list_refine_fn(sites, 1))
        med = msys.make_medium(grid, np.ones(grid.ncells, np.float32),
                               np.array([0.1e-6, 2e-6]),
                               sigma_ext=np.full((1, 2), 1e-30),
                               albedo=np.full((1, 2), 0.5),
                               g=np.full((1, 2), 0.0))
        sim = Simulation(grid=grid, medium=med, sources=[PointSource()],
                         instruments=[],
                         options=TransportOptions(max_steps=grid.max_steps()),
                         rf_borders=np.array([0.1e-6, 0.5e-6, 2e-6]),
                         device="cpu")
        assert sim._sweep_tabs is None and sim.grid.leafmap is None
        ref = _reference(ref_octree(((-PC, PC),) * 3,
                                    lambda p: np.ones(len(p)), max_level=10,
                                    min_level=1,
                                    refine_fn=ref_sites(sites, 1)),
                         rf_borders=np.array([0.1e-6, 0.5e-6, 2e-6]))
        assert ref.grid.levels == 11
        marches_as_reference(ref, monkeypatch)
        return
    if case == "spheroidal":
        from skirt9_tpu_torch.sources.secondary import DustSecondarySource
        with pytest.raises(NotImplementedError, match="spheroidal"):
            DustSecondarySource(luminosity=1.0, spheroidal=object())
        return
    if case == "merged_dynamic":
        # merged iterations run without the dynamic medium recipes, which
        # are not ported: a ski file with them raises
        from skirt9_tpu_torch.config.ski import load_ski as port_load_ski
        ski = open(os.path.join(GOLDEN, "bench3.ski")).read().replace(
            "<media type=", '<dynamicStateOptions type="DynamicStateOptions">'
            "<DynamicStateOptions/></dynamicStateOptions><media type=")
        (tmp_path / "dyn.ski").write_text(ski)
        shutil.copy(os.path.join(GOLDEN, "mrn_mean.txt"), tmp_path)
        with pytest.raises(NotImplementedError, match="media/dynamic"):
            port_load_ski(str(tmp_path / "dyn.ski"), device="cpu")
        return
    kw = {"stochastic": dict(dust_emission_type="Stochastic"),
          "library": dict(cell_library=object())}[case]
    with pytest.raises(NotImplementedError):
        dataclasses.replace(chip_smoke.config2("cpu", n=4, n_rf=4), **kw)
