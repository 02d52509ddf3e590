"""Multi-bin radiation fields on the port's large-grid (XL) contracts, on
the CPU, against the reference.

- Kernel 7's grouped prefix mode (`sweepxl.sweep_deposit_prefix` with
  n_groups, a bin map and nbins; its plain version on the CPU) against the
  reference's composition: its interpret-mode `sweepxl.sweep_deposit(
  n_groups=...)` on the same scale, the groups folded into bins by the map
  (`lifecycle.py:962-978`), and its `resolve_interaction`. Bin maps with
  -1, repeated rows and a row past the last: the RF within 1e-5 of its
  maximum (the same f32 terms summed in another order), and added into an
  accumulator that holds earlier deposits; the interaction as the XL tests
  hold it (`found` equal on >= 99.9% of lanes, `icell` equal where both
  found, `s_int` within 1e-5 of a cell size: the reference tests the hit
  against each slab's sum, the port against the next slab's prefix).
- `sweepxl.lane_order` with lane groups against the reference's sort key
  (`skirt9_tpu/transport/lifecycle.py:817-836`, group-major term
  included), permutation for permutation.
- The lane layouts the reference sends to its scan march raise.
- A reduced config 2 (bench2.ski at 8^3 with a 4-bin RF in 4 lane groups,
  8,192 packets in one batch, 4 events, one self-absorption iteration) on
  XL tables (the reference's `_sweep_tabs` set to `sweepxl.build_tables`,
  its Pallas kernels in interpret mode under `SKIRT9_TPU_FORCE_SWEEP=1`;
  the port's put in place by `bridge.py`), draw for draw: every SED kind,
  the frame, the RF and `info` within 1e-5 of their largest values (they
  agree to ~6e-6: the reference's XL density planes are bf16 hi/lo pairs,
  exact to 2^-16 of each cell).
"""

import dataclasses
import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skirt9_tpu.config.ski import load_ski
from skirt9_tpu.transport import sweep as ref_sw
from skirt9_tpu.transport import sweepxl as ref_xl
from skirt9_tpu_torch import bridge
from skirt9_tpu_torch.kernels import build as kb
from skirt9_tpu_torch.transport import lifecycle as lc
from skirt9_tpu_torch.transport import sweep as sw
from skirt9_tpu_torch.transport import sweepxl as xl
from test_torch_sweepxl import _port, _prefix_inputs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


def _fold(rf_g, bin_map, nbins):
    """The reference's fold of group rows into bins: (n_groups, ncells) ->
    (nbins, ncells), rows outside [0, nbins) dropped."""
    out = np.zeros((nbins, rf_g.shape[1]), np.float64)
    for g, b in enumerate(bin_map):
        if 0 <= b < nbins:
            out[b] += rf_g[g]
    return out


@pytest.mark.parametrize("n_groups,bin_map,nbins,B", [
    (4, (0, -1, 2, 2), 3, 8192), (8, (0, 1, 1, -1, 3, 3, 5, 4), 5, 16384)],
    ids=["4-groups", "8-groups"])
def test_grouped_prefix_matches_reference(n_groups, bin_map, nbins, B):
    (rgrid, rmed, tabs, pos, d, act, (tpos, td, tact), (rec, tb, _, lane),
     lum, tau_int, _) = _prefix_inputs(1, B, 120 + n_groups, True)
    bm = torch.tensor(bin_map, dtype=torch.int32)
    args = (tabs, tpos, td, tact, rec, lum, tau_int, tb, 0.7, lane)
    kw = dict(n_groups=n_groups, bin_map=bm, nbins=nbins)
    kb.reset_launches()
    rf, s, ic, f = xl.sweep_deposit_prefix(*args, **kw)
    assert sum(kb.LAUNCHES.values()) == 0
    # the reference: sweep_deposit per group on the scale, the fold
    rtabs = ref_xl.build_tables(rgrid, rmed)
    scale = ((lum[None, :] * torch.exp(-tb)) * 0.7).numpy()
    rf_g = np.asarray(ref_xl.sweep_deposit(
        rtabs, jnp.asarray(pos), jnp.asarray(d), jnp.asarray(act),
        jnp.asarray(rec.numpy()), jnp.asarray(scale), n_groups=n_groups),
        np.float64)
    assert all(rf_g[g].max() > 0 for g in range(n_groups))
    rf_r = _fold(rf_g, bin_map, nbins)
    assert rf.shape == rf_r.shape == (nbins, tabs.nd.shape[0])
    m = np.abs(rf_r).max()
    assert np.abs(rf.double().numpy() - rf_r).max() <= 1e-5 * m
    lit = [r for r in range(nbins) if rf_r[r].max() > 0]
    assert lit == sorted({b for b in bin_map if 0 <= b < nbins})
    # added into an accumulator: the same deposits on top of what it held
    acc0 = torch.rand((tabs.nd.shape[0], nbins), dtype=torch.float32)
    acc = acc0.clone()
    out, *hit = xl.sweep_deposit_prefix(*args, **kw, rf=acc)
    assert out.data_ptr() == acc.data_ptr()
    assert torch.equal(acc, acc0 + rf.T)
    for a, b in zip(hit, (s, ic, f)):
        assert torch.equal(a, b)
    # the interaction: the reference's resolve_interaction
    s_r, ic_r, f_r = (np.asarray(x) for x in ref_xl.resolve_interaction(
        rtabs, jnp.asarray(pos), jnp.asarray(d), jnp.asarray(act),
        jnp.asarray(rec.numpy()), jnp.asarray(tb.numpy()),
        jnp.asarray(tau_int.numpy())))
    f, ic, s = f.numpy(), ic.numpy(), s.numpy()
    assert f.sum() > B // 4
    assert (f == f_r).mean() >= 0.999
    both = f & f_r
    assert np.array_equal(ic[both], ic_r[both])
    assert np.abs(s[both] - s_r[both]).max() <= 1e-5 * tabs.h[0]


@pytest.mark.parametrize("n_groups", [1, 4, 32])
def test_lane_order_matches_reference_key(n_groups):
    """The port's permutation equals the reference's `argsort` of its key
    (`lifecycle.py:817-836`): (group, axis, major sign, entry slab)."""
    B = 4096
    rgrid, rmed, tabs, pos, d, *_ = _prefix_inputs(1, B, 130 + n_groups,
                                                   False)
    rtabs = ref_xl.build_tables(rgrid, rmed)
    jp, jd = jnp.asarray(pos), jnp.asarray(d)
    grp = ref_sw.dominant_axis(rtabs, jd)
    nmax = rtabs.nmax
    pa = jnp.take_along_axis(jp, grp[:, None], 1)[:, 0]
    da = jnp.take_along_axis(jd, grp[:, None], 1)[:, 0]
    lo = jnp.asarray(rtabs.lo, jnp.float32)[grp]
    h = jnp.asarray(rtabs.h, jnp.float32)[grp]
    t_ent = jnp.clip(((pa - lo) / h).astype(jnp.int32), 0, nmax - 1)
    skey = (grp * 2 + (da > 0)) * nmax + t_ent
    if n_groups > 1:
        skey = (jnp.arange(B, dtype=jnp.int32) // (B // n_groups)) \
            * 6 * nmax + skey
    perm_r = np.asarray(jnp.argsort(skey))
    tp, td = _port(pos, d)
    perm = xl.lane_order(tabs, tp, td, sw.dominant_axis(tabs, td), n_groups)
    assert np.array_equal(perm.numpy(), perm_r)
    # every group stays where it was
    gsz = B // n_groups
    assert np.array_equal(perm.numpy() // gsz, np.arange(B) // gsz)


@pytest.mark.parametrize("B,ok", [(4096, True), (1536, False), (2560, False)],
                         ids=["4096", "1536", "2560"])
def test_xl_lane_groups_need_the_reference_layout(B, ok, tmp_path):
    """Four lane groups on XL grids need B a multiple of 4 x 128 lanes and
    B / 128 a multiple of 8 (`lifecycle.py:573-578` of the reference);
    elsewhere the batch takes the scan march, as in the reference. The
    resident sweep takes 1536. On the march a monochromatic source in a
    4-bin RF on XL tables (one lane group) runs draw for draw with the
    reference's march on the same tables: SEDs, frame and RF within 1e-5
    of each maximum."""
    opts = lc.TransportOptions(max_steps=8, rf_strata=4,
                               rf_bin_map=(0, 1, 2, 3))
    rf = torch.zeros((8, 4))
    grid = bridge.grid(_tiny_grid())
    med = bridge.medium(_tiny_medium())
    tabs = sw.build_tables(grid, med)
    tabs_xl = xl.build_tables(grid, med)
    gate = lc.sweep_gate(med, opts, tabs, rf, 1536)
    assert gate.use_sweep and gate.n_groups == 4
    gate = lc.sweep_gate(med, opts, tabs_xl, rf, B)
    assert gate.use_sweep == ok and gate.n_groups == 4
    if ok:
        return
    assert gate.why == (f"batch {B} not divisible into the XL engine's "
                        "1024-lane blocks",)
    path = chip_smoke.edited_ski("bench1", tmp_path,
                                 {'numBins="32"': 'numBins="8"'})
    ref = load_ski(path, num_packets=B, batch_size=B, max_events=3)
    ref = dataclasses.replace(
        ref, options=dataclasses.replace(ref.options, store_rf=True),
        rf_borders=np.geomspace(0.4e-6, 0.8e-6, 5))
    ref._sweep_tabs = ref_xl.build_tables(ref.grid, ref.medium)
    port = bridge.simulation(ref, "cpu")
    assert isinstance(port._sweep_tabs, xl.XLTables)
    assert port._mono_rf_bin(port.sources[0], port.options) >= 0
    rf_r, accs_r = ref.run_primary(verbose=False)
    kb.reset_launches()
    rf_p, accs_p = port.run_primary(verbose=False)
    assert kb.LAUNCHES == {k: 0 for k in kb.LAUNCHES}
    for a, b in ((rf_r, rf_p), (accs_r[0]["sed"], accs_p[0]["sed"]),
                 (accs_r[0]["frame"], accs_p[0]["frame"])):
        a = np.asarray(a, np.float64)
        assert np.abs(a).max() > 0
        assert np.abs(b.double().numpy() - a).max() <= 1e-5 * np.abs(a).max()


def _tiny_grid():
    from skirt9_tpu.grids.cartesian import make_cartesian
    return make_cartesian(((-1.0, 1.0),) * 3, (4, 4, 4))


def _tiny_medium():
    from skirt9_tpu.media import system as ref_msys
    return ref_msys.make_medium(_tiny_grid(), np.ones(64, np.float32),
                                np.array([0.4e-6, 0.7e-6]),
                                sigma_ext=np.full((1, 2), 0.1),
                                albedo=np.full((1, 2), 0.5),
                                g=np.full((1, 2), 0.0))


def test_reduced_config2_on_xl_draw_for_draw(tmp_path, monkeypatch):
    monkeypatch.setenv("SKIRT9_TPU_FORCE_SWEEP", "1")
    ski = open(os.path.join(GOLDEN, "bench2.ski")).read()
    ski = ski.replace('numBins="32"', 'numBins="8"').replace(
        'numWavelengths="25"', 'numWavelengths="4"')
    (tmp_path / "small.ski").write_text(ski)
    shutil.copy(os.path.join(GOLDEN, "mrn_mean.txt"), tmp_path)
    ref = load_ski(str(tmp_path / "small.ski"), batch_size=8192,
                   max_events=4, num_packets=8192)
    ref.iterate_secondary, ref.max_iterations = True, 1
    ref._sweep_tabs = ref_xl.build_tables(ref.grid, ref.medium)
    port = bridge.simulation(ref, "cpu")
    assert isinstance(port._sweep_tabs, xl.XLTables)
    assert port._sweep_tabs.cellmap is None
    strata = port._strata_for(port.sources[0], port.options)
    assert strata[1] == (0, 1, 2, 3)
    rf_r, accs_r, info_r = ref.run_with_dust_emission(verbose=False)
    kb.reset_launches()
    rf_p, accs_p, info_p = port.run_with_dust_emission(verbose=False)
    assert kb.LAUNCHES == {k: 0 for k in kb.LAUNCHES}
    assert info_p["iterations"] == info_r["iterations"] == 1
    for k in ("L_dust", "L_abs_primary"):
        assert info_p[k] == pytest.approx(info_r[k], rel=1e-5), k
    rf_r = np.asarray(rf_r, np.float64)
    assert rf_r.shape == (512, 4) and (rf_r.max(axis=0) > 0).all()
    assert np.abs(rf_p.double().numpy() - rf_r).max() <= 1e-5 * rf_r.max()
    for key in ("sed", "frame"):
        r = np.asarray(accs_r[0][key], np.float64)
        p = accs_p[0][key].double().numpy()
        for k in range(r.shape[0]):
            assert r[k].max() > 0, (key, k)
            assert np.abs(p[k] - r[k]).max() <= 1e-5 * np.abs(r[k]).max(), \
                (key, k)
