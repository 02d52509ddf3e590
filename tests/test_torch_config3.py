"""Config 3 (bench3.ski: a density octree, a 25-bin RF and dust
self-absorption iterations) through the port on the CPU.

- Loader: the port's `load_ski` of bench3.ski builds, array for array, what
  the reference's `load_ski` + `bridge.simulation` build (the octree with
  its leaf map, the densities, options, borders, iteration settings and
  probes), also for a BinTree variant at small levels; the nested and
  site-list tree policies raise, naming themselves.
- Probes on the reduced tree: `cell_bounds`, the `cellprops` probe, the
  radiation-field and temperature probes and the temperature cut against
  the reference's on a radiation field drawn from a seed; the dust
  secondary source's leaf bounds and one launch from the same keys
  (positions, directions, wavelengths, weights within 1e-5) against the
  reference's; checkpoints resume a tree run.
- The slice: a reduced bench3 (maxLevel 4, the 25-bin RF and 40-bin
  emission grids, 8,192 packets in batches of 4,096 -- one stratified batch
  of 32,768 lanes per segment, 32 lane groups -- 4 events, at most 2
  self-absorption iterations) through `run_with_dust_emission` on both
  packages: the reference on its tree sweep in interpret mode, the port on
  the plain versions of its kernels, on the same random numbers.
  `iterations` equal; L_dust and L_abs_primary within 1e-5 relative; the RF,
  every SED kind, the statistics and the frame within 1e-5 of their
  largest values (they agree to 1.6e-6).

Kernel 5's grouped contract and the merged iterations are
`tests/test_torch_config3_merged.py`'s, the CLI on the reduced bench3.ski
`tests/test_torch_ski.py`'s: three files, so that the suite's workers run
their interpret-mode reference runs side by side.
"""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skirt9_tpu.config.ski import load_ski as ref_load_ski
from skirt9_tpu.probes import probes as ref_probes
from skirt9_tpu.utils.fits import read_fits
from skirt9_tpu_torch import bridge
from skirt9_tpu_torch.config.ski import load_ski
from skirt9_tpu_torch.kernels import build as kb
from skirt9_tpu_torch.probes import probes

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH3 = os.path.join(HERE, "golden", "bench3.ski")
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)
import chip_smoke  # noqa: E402
from test_torch_emission import _keys  # noqa: E402

# the reduced bench3: levels 2-4 (2,122 leaves, a 16^3 fine raster)
SMALL = chip_smoke.B3_SMALL
SMALL_RUN = dict(num_packets=8192, batch_size=4096, max_events=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for these small CPU runs, so that the suite's
    parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def edited_bench3(directory, edits: dict) -> str:
    """bench3.ski with each `old` replaced by `new`, beside a copy of its
    dust mix file."""
    return chip_smoke.edited_ski("bench3", directory, edits)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def assert_same_tree_sim(port, ref):
    """Every array, table and option of two port Simulations on trees, bit
    for bit (the grids' leaf maps included)."""
    assert type(port.grid) is type(ref.grid)
    for f in port.grid._fields:
        a, b = getattr(port.grid, f), getattr(ref.grid, f)
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b), f
    for f in ("nd", "lam_t", "sigma_ext", "sigma_sca", "g"):
        assert torch.equal(getattr(port.medium, f), getattr(ref.medium, f)), f
    for f in ("rf_borders", "ems_borders"):
        assert np.array_equal(getattr(port, f), getattr(ref, f)), f
    for ps, rs in zip(port.sources, ref.sources, strict=True):
        assert np.array_equal(ps.sed.lam, rs.sed.lam)
        assert np.array_equal(ps.sed.s, rs.sed.s)
        assert dataclasses.replace(ps, sed=None) == \
            dataclasses.replace(rs, sed=None)
    assert port.instruments == ref.instruments
    assert port.options == ref.options
    for f in ("num_packets", "batch_size", "seed", "source_bias",
              "spatial_bias", "iterate_secondary", "include_primary",
              "min_iterations", "max_iterations", "max_fraction_of_primary",
              "max_fraction_of_previous", "secondary_packets_multiplier",
              "dust_emission_type", "cmb_temperature", "rf_scale"):
        assert getattr(port, f) == getattr(ref, f), f


@pytest.mark.parametrize("edits", [{}, {'treeType="OctTree"':
                                        'treeType="BinTree"',
                                        'minLevel="2"': 'minLevel="1"',
                                        'maxLevel="7"': 'maxLevel="2"'}],
                         ids=["octree", "bintree"])
def test_load_ski_matches_reference(tmp_path, edits):
    path = edited_bench3(tmp_path, edits) if edits else BENCH3
    kw = dict(num_packets=1 << 18, batch_size=1 << 16, max_events=24)
    ref_sim = ref_load_ski(path, **kw)
    port = load_ski(path, device="cpu", **kw)
    assert_same_tree_sim(port, bridge.simulation(ref_sim, "cpu"))
    assert [(p.kind, p.name, p.when) for p in port.probes] == \
        [(p.kind, p.name, p.when) for p in ref_sim.probes] == [
            ("cellprops", "cells", "Setup"), ("radiationfield", "rf", "Run"),
            ("temperature", "T", "Run")]
    assert (port.iterate_secondary, port.include_primary,
            port.min_iterations, port.max_iterations) == (True, False, 1, 10)
    assert len(port.rf_borders) == 26 and len(port.ems_borders) == 41
    assert type(port._sweep_tabs).__name__ == "MLTables"
    if edits:
        assert type(port.grid).__name__ == "BinTreeGrid"
        assert port.grid.ncells == ref_sim.grid.ncells > 8
    else:
        # levels 2-7: a 128^3 fine raster
        assert type(port.grid).__name__ == "OctreeGrid"
        assert port.grid.ncells == 55574 and port._sweep_tabs.n == (128,) * 3


@pytest.mark.parametrize("policy", ["NestedDensityTreePolicy",
                                    "SiteListTreePolicy"])
def test_other_tree_policies_raise(tmp_path, policy):
    path = edited_bench3(tmp_path, {"<DensityTreePolicy ": f"<{policy} "})
    with pytest.raises(NotImplementedError, match=policy):
        load_ski(path, device="cpu")


# ------------------------------------------------------------------- probes

def test_probes_match_reference_on_a_tree(tmp_path):
    """The reduced tree's leaf bounds, and bench3's three probes on a
    radiation field drawn from a seed, against the reference's: the same
    cell centres, volumes, densities and mean intensities, the temperature
    within 1e-6 relative, and the same temperature cut."""
    path = edited_bench3(tmp_path, SMALL)
    ref_sim = ref_load_ski(path, **SMALL_RUN)
    port = load_ski(path, device="cpu", **SMALL_RUN)
    for a, b in zip(port.grid.cell_bounds(), ref_sim.grid.cell_bounds(),
                    strict=True):
        assert a.dtype == np.float32 and np.array_equal(a, np.asarray(b))
    rs = np.random.default_rng(11)
    rf = (10.0 ** rs.uniform(-3, 1, (port.grid.ncells, 25))).astype(
        np.float32)
    out = {}
    for name, sim, run, field in (
            ("ref", ref_sim, ref_probes.run_probe_system, rf),
            ("port", port, probes.run_probe_system, torch.tensor(rf))):
        d = tmp_path / name
        d.mkdir()
        out[name] = (run(sim, "Setup", "b3", str(d))
                     + run(sim, "Run", "b3", str(d), rf=field))
    assert [os.path.basename(p) for p in out["port"]] == \
        [os.path.basename(p) for p in out["ref"]] == [
            "b3_cells_cellprops.dat", "b3_rf_radiationfield.dat",
            "b3_T_temperature.dat", "b3_T_temperature_z.fits"]
    n = port.grid.ncells
    cells_r, cells_p = (np.loadtxt(p[0]) for p in (out["ref"], out["port"]))
    assert cells_p.shape == (n, 5) and np.array_equal(cells_p, cells_r)
    J_r, J_p = (np.loadtxt(p[1]) for p in (out["ref"], out["port"]))
    assert J_p.shape == (n, 3 + 25) and np.array_equal(J_p, J_r)
    T_r, T_p = (np.loadtxt(p[2]) for p in (out["ref"], out["port"]))
    assert np.array_equal(T_p[:, :3], T_r[:, :3])
    np.testing.assert_allclose(T_p[:, 3], T_r[:, 3], rtol=1e-6)
    cut_r, _ = read_fits(out["ref"][3])
    cut_p, _ = read_fits(out["port"][3])
    assert cut_p.shape == cut_r.shape == (256, 256) and cut_r.max() > 0
    np.testing.assert_allclose(cut_p, cut_r, rtol=1e-6)


def test_secondary_launch_on_a_tree(tmp_path):
    """The dust secondary source on the reduced tree, from a radiation
    field drawn from a seed: the leaves' bounds in its tables equal the
    reference's, and a launch from the same keys and the reference's
    tables draws the same positions, directions and wavelengths (1e-5
    relative, as `tests/test_torch_emission.py` holds the uniform grid's)."""
    path = edited_bench3(tmp_path, SMALL)
    ref_sim = ref_load_ski(path, **SMALL_RUN)
    port = load_ski(path, device="cpu", **SMALL_RUN)
    rs = np.random.default_rng(12)
    rf = (rs.uniform(0.0, 1.0, (port.grid.ncells, 25)) ** 3).astype(
        np.float32)
    s_r = ref_sim._make_secondary(ref_sim._emission_tables(), jnp.asarray(rf))
    s_p = port._make_secondary(port._emission_tables(), torch.tensor(rf))
    pt, rt = dict(s_p.tables()), dict(s_r.tables())
    for k in ("cell_lo", "cell_hi"):
        assert np.array_equal(_np(pt[k]), np.asarray(rt[k])), k
    assert s_p.luminosity == pytest.approx(s_r.luminosity, rel=1e-6)
    pt = {k: torch.tensor(np.asarray(v)) for k, v in rt.items()}
    B = 8192
    rk, pk = _keys(B, seed=13)
    f_p, f_r = s_p.launch(pt, pk, B), s_r.launch(rt, rk, B)
    for k in ("lam", "lum", "pos", "dir"):
        a, b = _np(f_p[k]).astype(np.float64), np.asarray(f_r[k], np.float64)
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), k
    # every launch position lies in its leaf
    cell = port.grid.locate(f_p["pos"])
    assert bool((cell >= 0).all())


# ---------------------------------------------------------------- the slice

@pytest.fixture(scope="module")
def reduced(tmp_path_factory):
    """The reduced bench3 through both packages: (ref, port, their runs)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("SKIRT9_TPU_FORCE_SWEEP", "1")
    try:
        path = edited_bench3(tmp_path_factory.mktemp("b3"), SMALL)
        ref = ref_load_ski(path, **SMALL_RUN)
        ref.max_iterations = 2
        assert type(ref._sweep_tabs).__name__ == "MLTables"
        port = bridge.simulation(ref, "cpu")
        out_r = ref.run_with_dust_emission(verbose=False)
    finally:
        mp.undo()
    kb.reset_launches()
    out_p = port.run_with_dust_emission(verbose=False)
    launches = dict(kb.LAUNCHES)
    return path, ref, port, out_r, out_p, launches


def assert_runs_agree(out_r, out_p, iterations):
    """`info` within 1e-5 relative; the RF, each SED kind, the first two
    statistics rows and the frame within 1e-5 of their largest values."""
    (rf_r, accs_r, info_r), (rf_p, accs_p, info_p) = out_r, out_p
    assert info_p["iterations"] == info_r["iterations"] == iterations
    for k in ("L_dust", "L_abs_primary"):
        assert info_p[k] == pytest.approx(info_r[k], rel=1e-5), k
    rf_r = np.asarray(rf_r, np.float64)
    assert rf_r.shape[1] == 25 and rf_r.max() > 0
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


def test_config3_slice_draw_for_draw(reduced):
    _, ref, port, out_r, out_p, launches = reduced
    assert launches == {k: 0 for k in kb.LAUNCHES}
    # both packages take the same strata: 25 bins in 32 lane groups
    for opts in (ref.options, dataclasses.replace(ref.options,
                                                  peel_off=False)):
        r = ref._strata_for(ref.sources[0], opts)
        p = port._strata_for(port.sources[0], opts)
        assert np.array_equal(r[0], p[0]) and r[1] == p[1]
        assert len(p[1]) == 32
    assert_runs_agree(out_r, out_p, iterations=2)
    assert [s[0] for s in port.last_stats["segments"]] == [
        "primary", "secondary iteration 1", "secondary iteration 2",
        "secondary"]


def test_checkpoint_resume_on_a_tree(tmp_path):
    """A tree run with a checkpoint path leaves none behind; a checkpoint
    saved after the primary segment resumes to the same result (the
    reduced tree with its RF cut to 4 bins, one iteration)."""
    ski = edited_bench3(tmp_path, dict(SMALL, **{
        'numWavelengths="25"': 'numWavelengths="4"'}))

    def sim(path=None):
        s = load_ski(ski, num_packets=1024, batch_size=1024, max_events=3,
                     device="cpu")
        s.max_iterations, s.checkpoint_path = 1, path
        return s
    path = str(tmp_path / "ck.npz")
    rf, accs, info = sim(path).run_with_dust_emission(verbose=False)
    assert not os.path.exists(path) and info["iterations"] == 1
    assert rf.shape == (2122, 4)
    part = sim(path)
    rf_prim, accs_prim = part.run_primary(verbose=False)
    part._save_checkpoint(rf_prim, rf_prim, accs_prim, 0.0,
                          info["L_abs_primary"], 0)
    rf2, accs2, info2 = sim(path).run_with_dust_emission(verbose=False)
    assert torch.equal(rf2, rf) and info2 == info
    assert torch.equal(accs2[0]["sed"], accs[0]["sed"])
    assert not os.path.exists(path)
