"""Port XL sweep (plain PyTorch) vs the reference, on a 16^3 grid.

The reference's `sweepxl.sweep_dtau`/`sweep_deposit` run in Pallas interpret
mode on the CPU, as `tests/test_sweepxl.py` runs them; the port's wrappers
take their plain PyTorch versions for CPU tensors. Same inputs, made with
numpy from a seed.

Bounds, and why:
- tau against the reference's scan march (`lifecycle.march_record`): 1e-4
  relative on lanes with tau > 0.01, 1e-5 absolute on every lane. The sweep
  starts each slab's sub-DDA at a point nudged 1e-4 of the slab's span
  inside, so a minor-axis crossing within the nudge moves up to that much
  path to the neighbouring cell; the reference's own resident sweep differs
  from its march by the same amount on these rays.
- tau against the reference's XL sweep: 2e-4 relative on lanes with
  tau > 0.01, 2e-4 of the largest tau on every lane; its density planes are
  int8 (|err| <= 3.1e-5 of a row's maximum, x1.5 density contrast here) on
  top of the nudge above.
- the port's XL pass 1 against its resident pass 1: identical (one march);
  its total and prefix modes against the plain march followed by
  `torch.sum` and `sweep.slab_prefix`: identical, and against the
  reference's record summed and run through its own `slab_prefix`: the XL
  bounds above, the prefix relative to its lane's tau.
- RF deposits: 1e-5 of the maximum (the same f32 terms summed in another
  order); interaction: `found` equal on >= 99.9% of lanes, `icell` equal
  where both found, `s_int` within 1e-5 of a cell size.
- pass 2 from the prefix (`sweep_deposit_prefix`) against the calls it
  replaces in the event loop (the scale formed from the prefix,
  `sweep_deposit_plain`, `resolve_interaction`): identical; against the
  reference: the deposit and interaction bounds above.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from skirt9_tpu.grids.cartesian import make_cartesian as ref_make_cartesian
from skirt9_tpu.media import system as ref_msys
from skirt9_tpu.transport import lifecycle as ref_lc
from skirt9_tpu.transport import sweep as ref_sw
from skirt9_tpu.transport import sweepxl as ref_xl
from skirt9_tpu_torch.grids.cartesian import make_cartesian
from skirt9_tpu_torch.kernels import build as kb
from skirt9_tpu_torch.media import system as msys
from skirt9_tpu_torch.transport import sweep as sw
from skirt9_tpu_torch.transport import sweepxl as xl

PC = 3.0857e16
N = 16
SIGMA = 1e-24
EXT = ((-1.2 * PC, 1.2 * PC),) * 3


def _setup(C, B, seed, hint=None):
    rs = np.random.default_rng(seed)
    rgrid = ref_make_cartesian(EXT, (N,) * 3)
    grid = make_cartesian(EXT, (N,) * 3)
    nd1 = np.asarray(ref_msys.uniform_density_sphere(rgrid, 1.0, SIGMA, PC))
    nd = np.stack([nd1 * (1.0 + 0.5 * rs.uniform(size=nd1.shape))
                   for _ in range(C)], axis=1).astype(np.float32)
    lam_t = np.array([0.4e-6, 0.7e-6])
    kw = dict(sigma_ext=SIGMA * np.arange(1, C + 1)[:, None] * np.ones(2),
              albedo=np.full((C, 2), 0.6), g=np.full((C, 2), 0.5))
    rmed = ref_msys.make_medium(rgrid, nd, lam_t, **kw)
    med = msys.make_medium(grid, nd, lam_t, **kw)
    pos = rs.uniform(-1.1 * PC, 1.1 * PC, (B, 3)).astype(np.float32)
    d = (rs.normal(size=(B, 3)) if hint is None
         else np.broadcast_to(np.array([0.3, -0.2, 0.93]), (B, 3)))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return rgrid, rmed, xl.build_tables(grid, med), pos, d


def _ref_march_tau(rgrid, rmed, pos, d):
    """Per-lane tau of the reference's scan march, its cross sections (C, B)
    and the in-grid mask."""
    B = pos.shape[0]
    opt = ref_msys.optics_at(rmed, jnp.full((B,), 0.55e-6))
    cell = rgrid.locate(jnp.asarray(pos))
    _, _, dtau = ref_lc.march_record(rgrid, rmed, opt, jnp.asarray(pos),
                                     jnp.asarray(d), cell, rgrid.max_steps(),
                                     cell >= 0)
    sig = np.ascontiguousarray(np.asarray(opt.sigma_ext).T)
    return np.asarray(jnp.sum(dtau, axis=0)), sig, np.asarray(cell) >= 0


def _port(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _assert_tau_close(tau, tau_ref, rel, atol, what):
    m = tau_ref > 0.01
    assert m.sum() > 200, what
    err = np.abs(tau - tau_ref)
    assert (err[m] / tau_ref[m]).max() <= rel, (what, err[m] / tau_ref[m])
    assert err.max() <= atol, (what, err.max())


@pytest.mark.parametrize("C,hint", [(1, None), (2, None), (1, 2)],
                         ids=["C1", "C2", "C1-hint"])
def test_dtau_matches_reference(C, hint):
    rgrid, rmed, tabs, pos, d = _setup(C, 1024, seed=30 + C, hint=hint)
    tau_march, sig, act = _ref_march_tau(rgrid, rmed, pos, d)
    kb.reset_launches()
    args = _port(pos, d, sig, act)
    sub = xl.sweep_dtau(tabs, *args, axis_hint=hint, want_sub=True)
    assert sub.shape == (N, 3, 1024)
    tau = sub.sum(dim=(0, 1)).double().numpy()
    _assert_tau_close(tau, tau_march, 1e-4, 1e-5, "vs scan march")
    ref_sub = ref_xl.sweep_dtau(ref_xl.build_tables(rgrid, rmed),
                                jnp.asarray(pos), jnp.asarray(d),
                                jnp.asarray(sig), jnp.asarray(act),
                                axis_hint=hint, want_sub=True)
    tau_xl = np.asarray(ref_sub, np.float64).sum(axis=(0, 1))
    _assert_tau_close(tau, tau_xl, 2e-4, 2e-4 * tau_xl.max(),
                      "vs reference XL")
    # the summed contract: the sub-step sum, and the resident pass 1 exactly
    summed = xl.sweep_dtau(tabs, *args, axis_hint=hint)
    assert summed.shape == (N, 1024)
    scale = float(summed.abs().max())
    assert float((summed - sub.sum(dim=1)).abs().max()) <= 1e-6 * scale
    assert torch.equal(summed, sw.sweep_dtau(tabs, *args, axis_hint=hint))
    assert all(v == 0 for v in kb.LAUNCHES.values())


@pytest.mark.parametrize("C,hint", [(1, None), (2, None), (1, 2), (2, 0)],
                         ids=["C1", "C2", "C1-hint", "C2-hint"])
def test_total_and_prefix_match_reference(C, hint):
    """`sweep_tau_total` and `sweep_dtau_prefix` against the reference's
    interpret-mode record summed over its sub-steps and its own
    `slab_prefix` (the bounds of `test_dtau_matches_reference`: 2e-4
    relative on lanes with tau > 0.01, the prefix relative to its lane's
    tau), and against the port's plain march followed by `torch.sum` and
    `sweep.slab_prefix` exactly; the lane range is `_lane_range`'s."""
    rgrid, rmed, tabs, pos, d = _setup(C, 1024, seed=70 + C, hint=hint)
    _, sig, act = _ref_march_tau(rgrid, rmed, pos, d)
    args = _port(pos, d, sig, act)
    kb.reset_launches()
    tot = xl.sweep_tau_total(tabs, *args, axis_hint=hint)
    rec, tb, tot_c, lane = xl.sweep_dtau_prefix(tabs, *args, axis_hint=hint)
    assert all(v == 0 for v in kb.LAUNCHES.values())
    assert tot.shape == tot_c.shape == (1024,)
    assert rec.shape == (N, 3, 1024) and tb.shape == (N, 1024)
    # the reference
    ref_sub = np.asarray(ref_xl.sweep_dtau(
        ref_xl.build_tables(rgrid, rmed), jnp.asarray(pos), jnp.asarray(d),
        jnp.asarray(sig), jnp.asarray(act), axis_hint=hint, want_sub=True))
    grp = (np.asarray(ref_sw.dominant_axis(rgrid, jnp.asarray(d)))
           if hint is None else np.full(1024, hint))
    up = d[np.arange(1024), grp] > 0
    tb_r, tot_r = (np.asarray(x, np.float64) for x in ref_sw.slab_prefix(
        jnp.asarray(ref_sub.sum(axis=1)), jnp.asarray(up)))
    for t in (tot, tot_c):
        _assert_tau_close(t.double().numpy(), tot_r, 2e-4,
                          2e-4 * tot_r.max(), "total vs reference")
    m = tot_r > 0.01
    err = np.abs(tb.double().numpy() - tb_r)
    assert (err[:, m] / tot_r[m]).max() <= 2e-4
    assert err.max() <= 2e-4 * tot_r.max()
    # the port's plain march, then torch.sum and slab_prefix, exactly
    summed = xl.sweep_dtau_plain(tabs, *args, axis_hint=hint)
    assert torch.equal(tot, torch.sum(summed, dim=0))
    assert torch.equal(rec, xl.sweep_dtau_plain(tabs, *args, axis_hint=hint,
                                                want_sub=True))
    g, smin, smax = sw._lane_range(tabs, args[0], args[1], args[3])
    g = sw._hinted(g, hint)
    tb_p, tot_p = sw.slab_prefix(
        summed, args[1].gather(1, g.long()[:, None])[:, 0] > 0)
    assert torch.equal(tb, tb_p) and torch.equal(tot_c, tot_p)
    for a, b in zip(lane, (g, smin, smax)):
        assert torch.equal(a, b)


def _record(C, B, seed):
    """Inputs of the deposit and the interaction search: the port's pass-1
    record, the ray-ordered prefix and a sampled tau_int, as numpy."""
    rgrid, rmed, tabs, pos, d = _setup(C, B, seed)
    rs = np.random.default_rng(seed + 100)
    _, sig, act = _ref_march_tau(rgrid, rmed, pos, d)
    tpos, td, tsig, tact = _port(pos, d, sig, act)
    sub = xl.sweep_dtau(tabs, tpos, td, tsig, tact, want_sub=True)
    grp = sw.dominant_axis(tabs, td)
    tb, total = sw.slab_prefix(sub.sum(dim=1),
                               td.gather(1, grp[:, None])[:, 0] > 0)
    lum = torch.from_numpy(rs.uniform(0.5, 2.0, B).astype(np.float32))
    scale = lum[None, :] * torch.exp(-tb)
    tau_int = torch.from_numpy(rs.uniform(size=B).astype(np.float32)) * total
    return ref_xl.build_tables(rgrid, rmed), tabs, pos, d, act, sub.numpy(), \
        scale.numpy(), tb.numpy(), tau_int.numpy()


@pytest.mark.parametrize("C,n_groups", [(1, 1), (2, 2)], ids=["C1", "C2-g2"])
def test_deposit_matches_reference(C, n_groups):
    # the reference's lane blocks of up to 16 rows of 128 must split into
    # n_groups
    B = 1024 if n_groups == 1 else 4096
    rtabs, tabs, pos, d, act, sub, scale, _, _ = _record(C, B, seed=40 + C)
    kb.reset_launches()
    rf = xl.sweep_deposit(tabs, *_port(pos, d, act, sub, scale),
                          n_groups=n_groups).numpy()
    assert kb.LAUNCHES["sweepxl_deposit"] == 0
    rf_r = np.asarray(ref_xl.sweep_deposit(
        rtabs, jnp.asarray(pos), jnp.asarray(d), jnp.asarray(act),
        jnp.asarray(sub), jnp.asarray(scale), n_groups=n_groups))
    assert rf.shape == rf_r.shape == (n_groups, N ** 3)
    for g in range(n_groups):
        assert rf_r[g].max() > 0
    assert np.abs(rf - rf_r).max() <= 1e-5 * np.abs(rf_r).max()


def test_resolve_interaction_matches_reference():
    B = 1024
    rtabs, tabs, pos, d, act, sub, _, tb, tau_int = _record(2, B, seed=50)
    s, ic, f = (x.numpy() for x in xl.resolve_interaction(
        tabs, *_port(pos, d, act, sub, tb, tau_int)))
    s_r, ic_r, f_r = (np.asarray(x) for x in ref_xl.resolve_interaction(
        rtabs, jnp.asarray(pos), jnp.asarray(d), jnp.asarray(act),
        jnp.asarray(sub), jnp.asarray(tb), jnp.asarray(tau_int)))
    assert f.sum() > B // 2
    assert (f == f_r).mean() >= 0.999
    both = f & f_r
    assert np.array_equal(ic[both], ic_r[both])
    assert np.abs(s[both] - s_r[both]).max() <= 1e-5 * tabs.h[0]


@pytest.mark.parametrize("what", ["resolve_interaction", "sweep_deposit"])
def test_pass1_lane_changes_nothing(what):
    """Pass 2 and the interaction search given pass 1's lane range (from
    `sweep_dtau_prefix`) give what they give when they form it themselves."""
    B = 1024
    _, tabs, pos, d, act, sub, scale, tb, tau_int = _record(1, B, seed=55)
    tpos, td, tact = _port(pos, d, act)
    _, _, _, lane = xl.sweep_dtau_prefix(
        tabs, tpos, td, torch.full((1, B), SIGMA), tact)
    if what == "resolve_interaction":
        call = lambda **kw: xl.resolve_interaction(
            tabs, tpos, td, tact, *_port(sub, tb, tau_int), **kw)
    else:
        call = lambda **kw: (xl.sweep_deposit(
            tabs, tpos, td, tact, *_port(sub, scale), **kw),)
    got, want = call(lane=lane), call()
    assert int(torch.count_nonzero(want[0])) > B // 4
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _prefix_inputs(C, B, seed, store_rf):
    """Pass 1's record, prefix and lane range on the port's plain version,
    and pass 2's per-lane inputs: tau_int up to 1.3 tau (0 on an eighth of
    the lanes, past the total on others), an interaction mask that drops
    some in-grid lanes, and lum_half (None without an RF)."""
    rgrid, rmed, tabs, pos, d = _setup(C, B, seed)
    rs = np.random.default_rng(seed + 1)
    _, sig, act = _ref_march_tau(rgrid, rmed, pos, d)
    tpos, td, tsig, tact = _port(pos, d, sig, act)
    rec, tb, tot, lane = xl.sweep_dtau_prefix(tabs, tpos, td, tsig, tact)
    u = rs.uniform(0.0, 1.3, B)
    u[:B // 8] = 0.0
    tau_int = torch.from_numpy(u.astype(np.float32)) * tot
    act_int = tact & torch.from_numpy(rs.uniform(size=B) > 0.15) & (tot > 1e-6)
    lum = None
    if store_rf:
        lum = torch.from_numpy(rs.uniform(0.5, 2.0, B).astype(np.float32))
        lum = lum * tact
    return (rgrid, rmed, tabs, pos, d, act, (tpos, td, tact),
            (rec, tb, tot, lane), lum, tau_int, act_int)


@pytest.mark.parametrize("store_rf", [True, False], ids=["rf", "no_rf"])
@pytest.mark.parametrize("C", [1, 2])
def test_deposit_prefix_is_the_old_composition(C, store_rf):
    """`sweep_deposit_prefix` (its plain version on the CPU) equals the
    calls it replaces in the XL event loop bit for bit: scale_slab =
    (lum_half * e^-tb) * inv_sqrt, `sweep_deposit_plain` on it and
    `resolve_interaction` with pass 1's lane range; on up- and down-going
    lanes, lanes that may not interact, tau_int = 0 and tau_int past the
    lane's total."""
    B = 1024
    (_, _, tabs, _, _, _, (tpos, td, tact), (rec, tb, tot, lane), lum,
     tau_int, act_int) = _prefix_inputs(C, B, 90 + C, store_rf)
    args = (tabs, tpos, td, act_int, rec, lum, tau_int, tb, 0.7, lane)
    kb.reset_launches()
    rf, *hit = xl.sweep_deposit_prefix(*args)
    assert sum(kb.LAUNCHES.values()) == 0
    rf_p, *hit_p = xl.sweep_deposit_prefix_plain(*args)
    want = xl.resolve_interaction(tabs, tpos, td, act_int, rec, tb, tau_int,
                                  lane=lane)
    for a, b, c in zip(hit, hit_p, want):
        assert torch.equal(a, c) and torch.equal(b, c)
    s_int, icell, found = hit
    assert icell.dtype == torch.int64 and found.dtype == torch.bool
    # the cases the search must get right are all there
    up = td.gather(1, lane[0].long()[:, None])[:, 0] > 0
    assert int((up & found).sum()) > B // 8
    assert int((~up & found).sum()) > B // 8
    assert int((found & (tau_int == 0)).sum()) > 0
    assert int((tact & ~act_int).sum()) > 0
    assert int((act_int & ~found & (tau_int > tot)).sum()) > 0
    assert bool((icell[~found] == -1).all())
    if store_rf:
        scale = (lum[None, :] * torch.exp(-tb)) * 0.7
        rf_old = xl.sweep_deposit_plain(tabs, tpos, td, tact, rec, scale)
        assert float(rf_old.max()) > 0
        assert torch.equal(rf, rf_old) and torch.equal(rf_p, rf_old)
    else:
        assert rf is None and rf_p is None


@pytest.mark.parametrize("C", [1, 2])
def test_deposit_prefix_matches_reference(C):
    """`sweep_deposit_prefix` against the reference's interpret-mode
    `sweep_deposit` on the same scale (RF within 1e-5 of its maximum, as
    `test_deposit_matches_reference`) and its `resolve_interaction` (as
    `test_resolve_interaction_matches_reference`)."""
    B = 1024
    (rgrid, rmed, tabs, pos, d, act, (tpos, td, tact), (rec, tb, _, lane),
     lum, tau_int, _) = _prefix_inputs(C, B, 96 + C, True)
    rf, s, ic, f = xl.sweep_deposit_prefix(tabs, tpos, td, tact, rec, lum,
                                           tau_int, tb, 0.7, lane)
    rtabs = ref_xl.build_tables(rgrid, rmed)
    scale = ((lum[None, :] * torch.exp(-tb)) * 0.7).numpy()
    rf_r = np.asarray(ref_xl.sweep_deposit(
        rtabs, jnp.asarray(pos), jnp.asarray(d), jnp.asarray(act),
        jnp.asarray(rec.numpy()), jnp.asarray(scale), n_groups=1))
    assert rf.shape == rf_r.shape == (1, N ** 3) and rf_r.max() > 0
    assert np.abs(rf.numpy() - rf_r).max() <= 1e-5 * np.abs(rf_r).max()
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


class _Medium:
    """Stand-in medium: the engine rules read only the component count."""

    ncomp = 1


@pytest.mark.parametrize("shape", [(32,) * 3, (73,) * 3, (74,) * 3,
                                   (4, 80, 80), (128,) * 3, (256,) * 3,
                                   (513, 8, 8)],
                         ids=lambda s: "x".join(map(str, s)))
def test_engine_choice_matches_reference(shape, monkeypatch):
    monkeypatch.setenv("SKIRT9_TPU_FORCE_SWEEP", "1")
    rgrid = ref_make_cartesian(EXT, shape)
    grid = make_cartesian(EXT, shape)
    med = _Medium()
    ref = (ref_sw.supports_sweep(rgrid, med), ref_xl.supports_xl(rgrid, med))
    assert (sw.supports_sweep(grid, med), xl.supports_xl(grid, med)) == ref
