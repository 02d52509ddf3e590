"""Config 3's lane groups on trees and its merged iterations, on the CPU.

- Kernel 5's grouped contract, plain version: on the density octree of
  `tests/test_torch_mlsweep.py` (max_level 4), C = 1, 4 and 8 lane groups
  with bin maps that hold -1, repeated rows and a row past the last,
  against the reference's `sweep_deposit(n_groups=...)` in Pallas
  interpret mode (`SKIRT9_TPU_FORCE_SWEEP=1`) followed by its
  `finalize_rf` and the fold of the groups into rows: RF within 1e-5 of
  its maximum, `found` equal on in-grid lanes and `icell` equal where found
  (as `tests/test_torch_mlsweep.py` holds the tree sweep). With every group
  in one row, and with one group and a one-row map, it equals the
  one-group call bit for bit; without a map row g holds group g.
- Merged iterations: the reduced bench3 of `tests/test_torch_config3.py`
  with `includePrimaryEmission="true"` (8,192 packets, 2 events, one
  merged iteration) through `run_merged_iterations` on both packages, the
  reference on its tree sweep in interpret mode: the same bounds as that
  file's slice (they agree to 1.7e-6), and the segments' names.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skirt9_tpu.config.ski import load_ski as ref_load_ski
from skirt9_tpu.transport import mlsweep as ref_ml
from skirt9_tpu.transport import sweep as ref_sw
from skirt9_tpu_torch import bridge
from skirt9_tpu_torch.kernels import build as kb
from skirt9_tpu_torch.transport import mlsweep as ml

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_config3 import (SMALL, SMALL_RUN,  # noqa: E402
                                assert_runs_agree, edited_bench3)
from test_torch_mlsweep import _port, _setup, reference_tree  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for these small CPU runs, so that the suite's
    parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n_groups,bin_map,rows", [
    (4, (2, -1, 0, 2), 3), (8, (0, 1, 1, -1, 3, 3, 5, 7), 6)],
    ids=["4-groups", "8-groups"])
def test_grouped_deposit_matches_reference(monkeypatch, n_groups, bin_map,
                                           rows):
    """Groups 2 and 3 of the 8 map to 1, and the last to 7, past the 6
    rows: dropped, as -1 is."""
    monkeypatch.setenv("SKIRT9_TPU_FORCE_SWEEP", "1")
    grid = reference_tree("octree")
    B = 2048
    rmed, tabs, pos, d, opt, cell, sig = _setup(grid, 1, B, 40 + n_groups)
    active = cell >= 0
    rs = np.random.default_rng(n_groups)
    lum = (rs.uniform(0.5, 2.0, B) * np.asarray(active)).astype(np.float32)
    u = rs.uniform(0.05, 0.95, B).astype(np.float32)
    inv2 = 0.7

    # the reference: its pass 1 record, the deposit planes per group, each
    # group's planes to cells (finalize_rf), then the groups into rows
    tabs_r = ref_ml.build_tables(grid, rmed)
    jpos, jd = jnp.asarray(pos), jnp.asarray(d)
    dsub_r, enc_r = ref_ml.sweep_dtau(tabs_r, jpos, jd, opt.sigma_ext.T,
                                      active, want_sub=True)
    grp = ref_sw.dominant_axis(tabs_r, jd)
    dmaj = jnp.take_along_axis(jd, grp[:, None], 1)[:, 0]
    tb_r, tot_r = ref_sw.slab_prefix(jnp.sum(dsub_r, axis=1), dmaj > 0)
    tau_int = u * np.asarray(tot_r)
    planes, s_r, icell_r, found_r = ref_ml.sweep_deposit(
        tabs_r, jpos, jd, active, dsub_r, enc_r, jnp.asarray(lum),
        jnp.asarray(tau_int), tb_r, inv2, n_groups=n_groups)
    per_group = np.asarray(ref_ml.finalize_rf(tabs_r, planes, grid.ncells),
                           np.float64)                     # (ncells, G)
    rf_ref = np.zeros((rows, grid.ncells))
    for g, r in enumerate(bin_map):
        if 0 <= r < rows:
            rf_ref[r] += per_group[:, g]

    a = np.asarray(active)
    tpos, td, tsig, tact, tlum, tti = _port(pos, d, sig, a, lum, tau_int)
    rec, cells, _, tb, _, lane = ml.sweep_dtau_prefix(tabs, tpos, td, tsig,
                                                      tact)
    tmap = torch.tensor(bin_map, dtype=torch.int32)
    kb.reset_launches()
    rf, s_int, icell, found = ml.sweep_deposit(
        tabs, tpos, td, tact, rec, cells, tlum, tti, tb, inv2,
        n_groups=n_groups, lane=lane, bin_map=tmap, nbins=rows)
    assert all(v == 0 for v in kb.LAUNCHES.values())   # CPU: plain versions
    assert rf.shape == (rows, grid.ncells) and rf.dtype == torch.float32
    assert rf_ref.max() > 0
    dropped = [r for r in range(rows) if r not in bin_map]
    assert float(rf[dropped].abs().sum()) == 0.0
    assert np.abs(rf.numpy() - rf_ref).max() <= 1e-5 * rf_ref.max()
    np.testing.assert_array_equal(found.numpy()[a], np.asarray(found_r)[a])
    hit = a & np.asarray(found_r)
    assert hit.sum() > B // 4
    np.testing.assert_array_equal(icell.numpy()[hit],
                                  np.asarray(icell_r)[hit])

    # the one-group path: every group in one row, or one group with a
    # one-row map, bit for bit the call without groups
    one = ml.sweep_deposit(tabs, tpos, td, tact, rec, cells, tlum, tti, tb,
                           inv2, lane=lane)
    assert one[0].shape == (1, grid.ncells)
    for g, m in ((n_groups, (0,) * n_groups), (1, (0,))):
        same = ml.sweep_deposit(
            tabs, tpos, td, tact, rec, cells, tlum, tti, tb, inv2,
            n_groups=g, lane=lane, bin_map=torch.tensor(m, dtype=torch.int32),
            nbins=1)
        for x, y in zip(same, one):
            assert torch.equal(x, y)
    # the groups' rows without a map: row g holds group g
    rows_g = ml.sweep_deposit(tabs, tpos, td, tact, rec, cells, tlum, tti,
                              tb, inv2, n_groups=n_groups, lane=lane)[0]
    assert rows_g.shape == (n_groups, grid.ncells)
    assert np.abs(rows_g.numpy().T - per_group).max() <= \
        1e-5 * per_group.max()


def test_grouped_deposit_checks_its_layout():
    grid = reference_tree("octree")
    _, tabs, pos, d, _, cell, sig = _setup(grid, 1, 256, 3)
    tpos, td, tsig, tact = _port(pos, d, sig, np.asarray(cell >= 0))
    rec, cells, _, tb, tot, lane = ml.sweep_dtau_prefix(tabs, tpos, td, tsig,
                                                        tact)
    args = (tabs, tpos, td, tact, rec, cells, tact.float(), 0.5 * tot, tb,
            1.0)
    with pytest.raises(ValueError, match="32-lane tiles"):
        ml.sweep_deposit(*args, n_groups=16, lane=lane)
    with pytest.raises(ValueError, match="bin_map"):
        ml.sweep_deposit(*args, n_groups=4, lane=lane,
                         bin_map=torch.zeros(3, dtype=torch.int32), nbins=2)


# ------------------------------------------------------ merged iterations

def test_merged_iterations_draw_for_draw(tmp_path, monkeypatch):
    monkeypatch.setenv("SKIRT9_TPU_FORCE_SWEEP", "1")
    path = edited_bench3(tmp_path, dict(SMALL, **{
        'secondaryIterationPacketsMultiplier="1"':
        'secondaryIterationPacketsMultiplier="1" '
        'includePrimaryEmission="true"'}))
    # two events a batch: the merged loop's control flow does not depend on
    # the event cap, and the interpret-mode reference costs ~3 s an event
    ref = ref_load_ski(path, **dict(SMALL_RUN, max_events=2))
    ref.max_iterations = 1
    assert ref.include_primary and ref.iterate_secondary
    assert type(ref._sweep_tabs).__name__ == "MLTables"
    port = bridge.simulation(ref, "cpu")
    assert port.include_primary and port.max_iterations == 1
    out_r = ref.run_with_dust_emission(verbose=False)
    kb.reset_launches()
    out_p = port.run_with_dust_emission(verbose=False)
    assert kb.LAUNCHES == {k: 0 for k in kb.LAUNCHES}
    assert_runs_agree(out_r, out_p, iterations=1)
    segs = port.last_stats["segments"]
    assert [s[0] for s in segs] == ["merged primary 1", "merged secondary 1",
                                    "primary", "secondary"]
    # the RF-storing segments run one stratified batch of 32,768 lanes, the
    # final secondary segment (no RF, no strata) two batches of 4,096
    assert [s[1] for s in segs] == [8192] * 4
    assert [s[3] for s in segs] == [2, 2, 2, 4]
