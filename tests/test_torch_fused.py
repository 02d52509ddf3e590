"""Plain versions of the fused kernels vs the JAX package, on the CPU.

Pass 1's two output modes beside the reference's contract
(`skirt9_tpu_torch.transport.sweep`): `sweep_tau_total` (the lane's total
optical depth) and `sweep_dtau_prefix` (`slab_prefix` of pass 1 and the lane
range), against the reference's `sweep_dtau` in Pallas interpret mode
followed by its `slab_prefix`, with and without an axis hint. Bounds as in
tests/test_torch_sweep.py: tau (per slab, total, and the prefix end to end)
within 1e-5 relative plus 1e-6 absolute, since one slab's sub-step can move
a sliver of path between cells where the two packages round a minor
crossing apart (5e-7 of 0.04 in one lane here); the prefix arithmetic
within 1e-6 of the lane's total, against the reference's `slab_prefix` of
the same tau; the lane range equal to the reference's set-up.

The fused `detect` (one launch per instrument on the GPU) through its plain
version against `skirt9_tpu.instruments.distant.detect`: a 1-bin and a
40-bin SED with statistics and a 64x64 frame, every kind, each accumulator
within 1e-6 of its maximum. Pass 2 with pass 1's lane range (`lane=`) gives
what it gives with its own set-up. CPU tensors take the plain versions: no
kernel is launched.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from skirt9_tpu.grids.cartesian import make_cartesian as ref_make_cartesian
from skirt9_tpu.instruments import distant as ref_dinst
from skirt9_tpu.media import system as ref_msys
from skirt9_tpu.transport import sweep as ref_sw
from skirt9_tpu_torch.grids.cartesian import make_cartesian
from skirt9_tpu_torch.instruments import distant as dinst
from skirt9_tpu_torch.kernels import build as kb
from skirt9_tpu_torch.media import system as msys
from skirt9_tpu_torch.transport import sweep as sw

PC = 3.0857e16
SIGMA = 1e-24


def _setup(shape, C, B, seed, hint=None):
    """The same rays, densities and cross sections for both packages."""
    rs = np.random.default_rng(seed)
    ext = ((-1.2 * PC, 1.2 * PC),) * 3
    rgrid = ref_make_cartesian(ext, shape)
    grid = make_cartesian(ext, shape)
    nd1 = ref_msys.uniform_density_sphere(rgrid, 1.0, SIGMA, PC)
    nd = np.stack([nd1 * (1.0 + 0.5 * rs.uniform(size=nd1.shape))
                   for _ in range(C)], axis=1).astype(np.float32)
    lam_t = np.array([0.4e-6, 0.7e-6])
    kw = dict(sigma_ext=np.full((C, 2), SIGMA), albedo=np.full((C, 2), 0.6),
              g=np.full((C, 2), 0.5))
    rmed = ref_msys.make_medium(rgrid, nd, lam_t, **kw)
    med = msys.make_medium(grid, nd, lam_t, **kw)
    pos = rs.uniform(-1.1 * PC, 1.1 * PC, (B, 3)).astype(np.float32)
    if hint is None:
        d = rs.normal(size=(B, 3))
    else:
        d = np.broadcast_to(np.array([0.3, -0.2, 0.93]), (B, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    sig = (SIGMA * rs.uniform(0.5, 1.5, (C, B))).astype(np.float32)
    active = np.asarray(rgrid.locate(jnp.asarray(pos))) >= 0
    active[::5] = False
    ref = (ref_sw.build_tables(rgrid, rmed), jnp.asarray(pos), jnp.asarray(d),
           jnp.asarray(sig), jnp.asarray(active))
    port = (sw.build_tables(grid, med), torch.from_numpy(pos),
            torch.from_numpy(d), torch.from_numpy(sig),
            torch.from_numpy(active))
    return ref, port


CASES = [((8, 8, 8), 1, None), ((16, 16, 16), 2, None), ((12, 8, 16), 1, 2),
         ((16, 16, 16), 3, 2)]
IDS = ["8-C1", "16-C2", "aniso-C1-hint", "16-C3-hint"]


@pytest.mark.parametrize("shape,C,hint", CASES, ids=IDS)
def test_tau_total_matches_reference(shape, C, hint):
    B = 256
    ref, port = _setup(shape, C, B, seed=30 + C, hint=hint)
    tot_ref = np.asarray(ref_sw.sweep_dtau(*ref, axis_hint=hint)).sum(0)
    kb.reset_launches()
    tot = sw.sweep_tau_total(*port, axis_hint=hint).numpy()
    assert kb.LAUNCHES["sweep_tau_total"] == 0   # CPU tensors: plain version
    assert tot.shape == (B,) and (tot_ref > 0).sum() > B // 4
    np.testing.assert_allclose(tot, tot_ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        tot, sw.sweep_dtau(*port, axis_hint=hint).numpy().sum(0))
    assert np.all(tot[~port[4].numpy()] == 0)


@pytest.mark.parametrize("shape,C,hint", CASES, ids=IDS)
def test_dtau_prefix_matches_reference(shape, C, hint):
    B = 256
    ref, port = _setup(shape, C, B, seed=40 + C, hint=hint)
    tabs_r, pos_r, d_r = ref[:3]
    tau_ref = ref_sw.sweep_dtau(*ref, axis_hint=hint)
    grp_r = (ref_sw.dominant_axis(tabs_r, d_r) if hint is None
             else jnp.full((B,), hint, jnp.int32))
    dmaj = jnp.take_along_axis(d_r, grp_r[:, None], axis=1)[:, 0]
    tb_ref, tot_ref = (np.asarray(x) for x in ref_sw.slab_prefix(tau_ref,
                                                                 dmaj > 0))
    # the reference's lane set-up, untiled
    _, _, _, smin_r, smax_r, _, _ = ref_sw._prep(*ref)
    kb.reset_launches()
    tb, tot, (grp, smin, smax) = sw.sweep_dtau_prefix(*port, axis_hint=hint)
    assert kb.LAUNCHES["sweep_dtau_prefix"] == 0
    assert tb.shape == (max(shape), B) and grp.dtype == torch.int32
    np.testing.assert_array_equal(grp.numpy(), np.asarray(grp_r))
    np.testing.assert_allclose(smin.numpy(), np.asarray(smin_r).reshape(-1),
                               rtol=1e-6)
    np.testing.assert_allclose(smax.numpy(), np.asarray(smax_r).reshape(-1),
                               rtol=1e-6)
    tot = tot.numpy()
    assert (tot_ref > 0).sum() > B // 4
    np.testing.assert_allclose(tot, tot_ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tb.numpy(), tb_ref, rtol=1e-5, atol=1e-6)
    # the prefix arithmetic alone: the reference's slab_prefix of our tau
    tau = sw.sweep_dtau(*port, axis_hint=hint)
    tb_same, _ = ref_sw.slab_prefix(jnp.asarray(tau.numpy()), dmaj > 0)
    err = np.abs(tb.numpy() - np.asarray(tb_same)) / np.maximum(tot, 1e-30)
    assert err.max() <= 1e-6, err.max()
    # the lane range is the one the port's own set-up gives, bit for bit
    g2, s0, s1 = sw._lane_range(port[0], port[1], port[2], port[4])
    if hint is None:
        assert torch.equal(grp, g2)
    assert torch.equal(smin, s0) and torch.equal(smax, s1)


@pytest.mark.parametrize("n_groups", [1, 4])
def test_deposit_with_lane_range(n_groups):
    B = 512
    _, port = _setup((16, 12, 8), 2, B, seed=50 + n_groups)
    tabs, pos, d, sig, act = port
    tb, tot, lane = sw.sweep_dtau_prefix(*port)
    rs = np.random.default_rng(5)
    scale = torch.from_numpy(rs.uniform(0.5, 2, B).astype(np.float32))[None] \
        * torch.exp(-tb)
    rel = (0.6 * tot)[None, :] - tb
    own = sw.sweep_deposit(tabs, pos, d, sig, act, scale, rel, n_groups)
    given = sw.sweep_deposit(tabs, pos, d, sig, act, scale, rel, n_groups,
                             lane=lane)
    assert int(own[3].sum()) > B // 4
    for a, b in zip(own, given):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        sw.sweep_deposit(tabs, pos, d, sig, act, scale, rel, n_groups,
                         lane=(lane[0].long(), lane[1], lane[2]))


def _instrument(ref, nb):
    borders = ((0.5e-6, 0.6e-6) if nb == 1
               else tuple(np.geomspace(0.09e-6, 1000e-6, nb + 1)))
    cls = ref_dinst.DistantInstrumentCfg if ref else dinst.DistantInstrumentCfg
    return cls(name="i", wave_borders=borders, inclination=0.4, azimuth=0.9,
               distance=100 * PC, npx=64, npy=64, fovx=4 * PC, fovy=4 * PC,
               stats_scale=1e-3)


@pytest.mark.parametrize("nb", [1, 40])
@pytest.mark.parametrize("kind", range(dinst.NUM_KINDS))
def test_detect_matches_reference(nb, kind):
    rs = np.random.default_rng(nb * 10 + kind)
    B = 4096
    if nb == 1:
        lam = np.full(B, 0.55e-6, np.float32)
        lam[::9] = 0.7e-6                      # outside the SED grid
    else:
        lam = np.exp(rs.uniform(np.log(0.05e-6), np.log(2000e-6),
                                B)).astype(np.float32)
    pos = rs.uniform(-2.5 * PC, 2.5 * PC, (B, 3)).astype(np.float32)
    contrib = rs.uniform(0, 1e-3, B).astype(np.float32)
    contrib[::13] = 0.0
    active = rs.uniform(size=B) > 0.1
    cfg_r, cfg = _instrument(True, nb), _instrument(False, nb)
    acc_r = ref_dinst.detect(cfg_r, ref_dinst.device_tables(cfg_r),
                             ref_dinst.init_accumulators(cfg_r),
                             *(jnp.asarray(a) for a in (lam, pos, contrib)),
                             kind, jnp.asarray(active))
    acc = dinst.init_accumulators(cfg, "cpu")
    kb.reset_launches()
    dinst.detect(cfg, dinst.device_tables(cfg, "cpu"), acc,
                 *(torch.from_numpy(a) for a in (lam, pos, contrib)), kind,
                 torch.from_numpy(active))
    assert sum(kb.LAUNCHES.values()) == 0
    for key in ("sed", "stats", "frame"):
        ref = np.asarray(acc_r[key])
        assert ref.max() > 0
        err = np.abs(acc[key].numpy() - ref).max() / ref.max()
        assert err <= 1e-6, (key, err)
