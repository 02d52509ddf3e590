"""The local instruments (`instruments/allsky.py`, `instruments/perspective.py`,
`lifecycle.peel_off_local`, the loader's PerspectiveInstrument,
AllSkyInstrument and HEALPixSkyInstrument, `Simulation.write_outputs`)
against the reference, on the CPU.

- The cases of the reference's tests/test_allsky.py and
  tests/test_perspective.py, each run by the reference and, on the same
  configuration (`bridge.simulation(..., march=True)`: both march), by the
  port: every sky map within 1e-4 of its maximum (`BOUND`: the
  reference's f32 sums of a point source's direct light stray 3.2e-5 from
  their exact sum, the port's 2.3e-7; the rest agree within 3e-7), and the
  reference's own assertions on the port's maps. The HEALPix RING pixels of 400,000 directions equal the
  reference's `_healpix_ring_ij`, pixel for pixel.
- The loader: a ski file with all three instruments through both
  `load_ski`s, instrument for instrument, run draw for draw, and the
  written FITS files (names, headers, calibrated maps within 1e-4).
- The pixels (`sky_pixels`, `image_pixels`) against the reference's jitted
  `detect` (each lane in its own wavelength bin, so that its pixel can be
  read off the map): Mollweide and HEALPix with and without a crosshair,
  and a perspective camera. Measured on 2^16 seeded directions and
  positions (`python tests/test_torch_local_instruments.py`): no lane of
  any case parts; the test holds 2^12 of them to that share, 0.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skirt9_tpu.config.ski import load_ski as ref_load_ski
from skirt9_tpu.grids.cartesian import make_cartesian
from skirt9_tpu.instruments import allsky as ref_asky
from skirt9_tpu.instruments import distant as ref_dinst
from skirt9_tpu.instruments import perspective as ref_persp
from skirt9_tpu.media import system as ref_msys
from skirt9_tpu.simulation import Simulation as RefSimulation
from skirt9_tpu.sources.base import PointSource
from skirt9_tpu.transport import lifecycle as ref_lc
from skirt9_tpu.utils.fits import read_fits as ref_read_fits
from skirt9_tpu_torch import bridge
from skirt9_tpu_torch.config.ski import load_ski
from skirt9_tpu_torch.instruments import allsky as asky
from skirt9_tpu_torch.instruments import perspective as persp
from skirt9_tpu_torch.kernels import build as kb
from skirt9_tpu_torch.parallel import dp
from skirt9_tpu_torch.utils.fits import read_fits

PC = 3.0857e16
# each map within 1e-4 of its maximum: a point source's direct light puts
# thousands of equal contributions into one pixel, and the reference's f32
# scatter of 4,096 of them strays 3.2e-5 from their exact sum (the port's
# index_add_ 2.3e-7); elsewhere the maps agree within 3e-7
BOUND = 1e-4
BAND = (0.5e-6, 0.6e-6)
DIRECT = ref_dinst.KIND_PRIMARY_DIRECT


def _sim(insts, src_pos=(0.0, 0.0, 0.0), n=8, npackets=2048, events=2,
         medium=None, seed=0):
    """The reference's Simulation of tests/test_allsky.py and
    tests/test_perspective.py: a point source in an empty (or the given)
    medium on an n^3 grid."""
    grid = make_cartesian(((-PC, PC),) * 3, (n,) * 3)
    med = medium(grid) if medium else ref_msys.make_medium(
        grid, np.zeros(grid.ncells, np.float32), np.array([1e-7, 1e-5]),
        np.zeros((1, 2)), np.zeros((1, 2)), np.zeros((1, 2)))
    opts = ref_lc.TransportOptions(max_steps=grid.max_steps(),
                                   max_events=events, store_rf=False)
    return RefSimulation(grid=grid, medium=med,
                         sources=[PointSource(luminosity=1.0, lam0=0.55e-6,
                                              position=src_pos)],
                         instruments=insts, options=opts, rf_borders=None,
                         num_packets=npackets, batch_size=2048, seed=seed)


def _both(ref):
    """(the reference's accumulators, the port's) of one configuration,
    both marching; the port's in float64 numpy."""
    port = bridge.simulation(ref, "cpu", march=True)
    _, accs_r = ref.run_primary(verbose=False)
    kb.reset_launches()
    _, accs_p = port.run_primary(verbose=False)
    assert kb.LAUNCHES == {k: 0 for k in kb.LAUNCHES}
    accs_r = [{k: np.asarray(v, np.float64) for k, v in a.items()}
              for a in accs_r]
    accs_p = [{k: v.double().numpy() for k, v in a.items()} for a in accs_p]
    for a, b in zip(accs_r, accs_p):
        sky_r, sky_p = a["sky"], b["sky"]
        for k in range(sky_r.shape[0]):
            m = np.abs(sky_r[k]).max()
            gap = np.abs(sky_r[k] - sky_p[k]).max() / max(m, 1e-300)
            print(k, gap)
            assert gap <= BOUND, (k, gap)
            assert (m == 0) == (np.abs(sky_p[k]).max() == 0)
    return accs_r, accs_p, port


def _mollweide(**kw):
    return ref_asky.AllSkyInstrumentCfg(name="sky", wave_borders=BAND,
                                        position=(0.5 * PC, 0.0, 0.0),
                                        npx=64, **kw)


def test_allsky_point_source_direction_and_flux():
    _, accs, _ = _both(_sim([_mollweide()]))
    direct = accs[0]["sky"][DIRECT, 0]
    iy, ix = np.unravel_index(np.argmax(direct), direct.shape)
    assert abs(iy - direct.shape[0] // 2) <= 1
    assert ix <= 2 or ix >= direct.shape[1] - 3
    assert direct.sum() == pytest.approx(1.0 / (4 * np.pi * (0.5 * PC) ** 2),
                                         rel=1e-3)


def test_allsky_scattered_sky_with_medium(tmp_path):
    sigma = 1e-24

    def medium(grid):
        nd = ref_msys.uniform_density_sphere(grid, 1.0, sigma, 0.8 * PC)
        return ref_msys.make_medium(grid, nd, np.array([1e-7, 1e-5]),
                                    np.array([[sigma, sigma]]),
                                    np.full((1, 2), 0.7), np.zeros((1, 2)))

    ref = _sim([_mollweide()], n=12, npackets=4096, events=8, medium=medium,
               seed=1)
    _, accs, port = _both(ref)
    scat = accs[0]["sky"][ref_dinst.KIND_PRIMARY_SCATTERED, 0]
    assert (scat > 0).sum() > 100
    paths = port.write_outputs(
        [{k: torch.tensor(v, dtype=torch.float32) for k, v in a.items()}
         for a in accs], "t", str(tmp_path))
    cube, _ = read_fits(paths[0])
    assert paths[0].endswith("t_sky_allsky.fits")
    assert cube.shape == (1, 32, 64) and np.isfinite(cube).all()


def test_healpix_pixelization_matches_reference():
    """tests/test_allsky.py's equal-area case, pixel for pixel."""
    nside = 1 << 3
    v = np.random.default_rng(0).normal(size=(400_000, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    theta = np.arccos(np.clip(v[:, 2], -1, 1)).astype(np.float32)
    phi = np.mod(np.arctan2(v[:, 1], v[:, 0]), 2 * np.pi).astype(np.float32)
    i_r, j_r = jax.jit(lambda t, p: ref_asky._healpix_ring_ij(t, p, nside))(
        jnp.asarray(theta), jnp.asarray(phi))
    i, j = asky._healpix_ring_ij(torch.tensor(theta), torch.tensor(phi),
                                 nside)
    assert np.array_equal(np.asarray(i_r), i.numpy())
    assert np.array_equal(np.asarray(j_r), j.numpy())
    nx = 4 * nside
    counts = np.bincount(j.numpy() * nx + i.numpy(),
                         minlength=nx * (nx - 1))
    assert (counts > 0).sum() == 12 * nside * nside


def test_healpix_instrument_end_to_end():
    cfg_h = ref_asky.AllSkyInstrumentCfg(
        name="hp", wave_borders=BAND, position=(0.5 * PC, 0, 0),
        projection="healpix", order=3, crosshair=(0.0, 0.0, 0.0))
    _, accs, port = _both(_sim([cfg_h, _mollweide(crosshair=(0.0, 0.0,
                                                             0.0))]))
    assert accs[0]["sky"].sum() > 0
    np.testing.assert_allclose(accs[0]["sky"].sum(), accs[1]["sky"].sum(),
                               rtol=1e-5)
    img = asky.calibrate(port.instruments[0],
                         {"sky": torch.tensor(accs[0]["sky"])})
    assert np.isfinite(img).all()


def _cam(**kw):
    base = dict(name="cam", wave_borders=BAND, npx=64, npy=64, width=2 * PC,
                view=(0.9 * PC, 0, 0), cross=(0.0, 0.0, 0.0),
                up=(0.0, 0.0, 1.0), focal=0.5 * PC)
    base.update(kw)
    return ref_persp.PerspectiveInstrumentCfg(**base)


def test_center_source_lands_on_crosshair_pixel():
    _, accs, _ = _both(_sim([_cam()]))
    direct = accs[0]["sky"][DIRECT, 0]
    jy, ix = np.unravel_index(np.argmax(direct), direct.shape)
    assert abs(ix - 32) <= 1 and abs(jy - 32) <= 1
    assert direct.sum() == pytest.approx(1.0 / (4 * np.pi * (1.4 * PC) ** 2),
                                         rel=1e-3)


def test_offset_source_projects_with_perspective():
    dz = 0.4 * PC
    cfg = _cam()
    _, accs, _ = _both(_sim([cfg], src_pos=(0.0, 0.0, dz)))
    direct = accs[0]["sky"][DIRECT, 0]
    jy, ix = np.unravel_index(np.argmax(direct), direct.shape)
    expect_j = int(64 / 2 + (cfg.focal / cfg.pixel_size) * dz / (1.4 * PC))
    assert abs(int(jy) - expect_j) <= 1 and abs(ix - 32) <= 1
    # a source behind the eye is never recorded
    _, accs2, _ = _both(_sim([_cam(view=(0.5 * PC, 0, 0), focal=0.3 * PC)],
                             src_pos=(0.9 * PC, 0.0, 0.0)))
    assert accs2[0]["sky"].sum() == 0


SKI = """<?xml version='1.0' encoding='UTF-8'?>
<skirt-simulation-hierarchy type="MonteCarloSimulation" format="9">
  <MonteCarloSimulation simulationMode="OligoExtinctionOnly" numPackets="1e3">
    <random type="Random"><Random seed="0"/></random>
    <units type="Units"><ExtragalacticUnits/></units>
    <sourceSystem type="SourceSystem">
      <SourceSystem wavelengths="0.55 micron" sourceBias="0.5">
        <sources type="Source">
          <PointSource positionX="0 pc" positionY="0 pc" positionZ="0 pc">
            <sed type="SED"><BlackBodySED temperature="5778 K"/></sed>
            <normalization type="LuminosityNormalization">
              <IntegratedLuminosityNormalization wavelengthRange="Source" integratedLuminosity="1 Lsun"/>
            </normalization>
          </PointSource>
        </sources>
      </SourceSystem>
    </sourceSystem>
    <mediumSystem type="MediumSystem">
      <MediumSystem>
        <photonPacketOptions type="PhotonPacketOptions">
          <PhotonPacketOptions forceScattering="true" minWeightReduction="1e4" minScattEvents="0" pathLengthBias="0.5"/>
        </photonPacketOptions>
        <media type="Medium">
          <GeometricMedium velocityMagnitude="0 km/s">
            <geometry type="Geometry">
              <ShellGeometry minRadius="1e-6 pc" maxRadius="0.8 pc" exponent="0"/>
            </geometry>
            <materialMix type="MaterialMix">
              <TrivialGasMix absorptionCrossSection="4e-25 m2" scatteringCrossSection="6e-25 m2" asymmetryParameter="0.5"/>
            </materialMix>
            <normalization type="MaterialNormalization">
              <OpticalDepthMaterialNormalization axis="Z" wavelength="0.55 micron" opticalDepth="1.0"/>
            </normalization>
          </GeometricMedium>
        </media>
        <grid type="SpatialGrid">
          <CartesianSpatialGrid minX="-1 pc" maxX="1 pc" minY="-1 pc" maxY="1 pc" minZ="-1 pc" maxZ="1 pc">
            <meshX type="Mesh"><LinMesh numBins="8"/></meshX>
            <meshY type="Mesh"><LinMesh numBins="8"/></meshY>
            <meshZ type="Mesh"><LinMesh numBins="8"/></meshZ>
          </CartesianSpatialGrid>
        </grid>
      </MediumSystem>
    </mediumSystem>
    <instrumentSystem type="InstrumentSystem">
      <InstrumentSystem>
        <instruments type="Instrument">
          <PerspectiveInstrument instrumentName="cam" numPixelsX="32" numPixelsY="32" width="2 pc" viewX="1 pc" viewY="0 pc" viewZ="0 pc" crossX="0 pc" crossY="0 pc" crossZ="0 pc" upX="0" upY="0" upZ="1" focal="0.5 pc"/>
          <AllSkyInstrument instrumentName="sky" numPixelsY="20" observerX="0.4 pc" observerY="0.1 pc" observerZ="0 pc" crossX="0 pc" crossY="0 pc" crossZ="0 pc" upX="0" upY="0" upZ="1">
            <projection type="AllSkyProjection"><HammerAitoffProjection/></projection>
          </AllSkyInstrument>
          <HEALPixSkyInstrument instrumentName="hp" order="2" observerX="0 pc" observerY="-0.3 pc" observerZ="0.2 pc" crossX="0 pc" crossY="0 pc" crossZ="0 pc" upX="0" upY="0" upZ="1"/>
        </instruments>
      </InstrumentSystem>
    </instrumentSystem>
    <probeSystem type="ProbeSystem"><ProbeSystem/></probeSystem>
  </MonteCarloSimulation>
</skirt-simulation-hierarchy>
"""


def test_local_instruments_through_ski_loader(tmp_path):
    """tests/test_perspective.py's loader case with all three instruments:
    the port's `load_ski` builds the reference's configurations, the runs
    agree, and `write_outputs` writes the reference's files."""
    p = tmp_path / "local.ski"
    p.write_text(SKI)
    ref = ref_load_ski(str(p), num_packets=2000)
    sim = load_ski(str(p), num_packets=2000, device="cpu")
    assert ref._sweep_tabs is None
    sim._sweep_tabs = None              # both march (bridge's march=True)
    assert [type(c).__name__ for c in sim.instruments] == [
        "PerspectiveInstrumentCfg", "AllSkyInstrumentCfg",
        "AllSkyInstrumentCfg"]
    for a, b in zip(ref.instruments, sim.instruments):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert sim.instruments[1].projection == "hammer"
    _, accs_r = ref.run_primary(verbose=False)
    _, accs_p = sim.run_primary(verbose=False)
    assert all(float(a["sky"].sum()) > 0 for a in accs_p)
    d_r, d_p = tmp_path / "ref", tmp_path / "port"
    d_r.mkdir()
    d_p.mkdir()
    paths_r = ref.write_outputs(accs_r, "local", str(d_r))
    paths_p = sim.write_outputs(accs_p, "local", str(d_p))
    names = lambda ps: sorted(os.path.basename(x) for x in ps
                              if x.endswith(".fits"))
    assert names(paths_p) == names(paths_r) == [
        "local_cam_total.fits", "local_hp_allsky.fits",
        "local_sky_allsky.fits"]
    for name in names(paths_r):
        cube_r, hdr_r = ref_read_fits(str(d_r / name))
        cube_p, hdr_p = read_fits(str(d_p / name))
        assert hdr_p == hdr_r
        m = np.abs(cube_r).max()
        assert m > 0
        assert np.abs(np.asarray(cube_r, np.float64) - cube_p).max() \
            <= BOUND * m


def test_domain_decomposition_refuses_local_instruments(tmp_path):
    """The reference's `dd_segment` peels off to distant instruments only;
    the port's names the local ones and raises."""
    p = tmp_path / "local.ski"
    p.write_text(SKI)
    one = dp.Group(rank=0, size=1, device=torch.device("cpu"),
                   backend="gloo")
    sim = load_ski(str(p), num_packets=256, batch_size=256, max_events=2,
                   device="cpu", group=one, dd=True)
    with pytest.raises(NotImplementedError, match="local instruments.*cam"):
        sim.run_primary(verbose=False)


# ------------------------------------------------------------- the pixels

CHUNK = 16


def _ref_pixels(mod, cfg, call, inputs) -> np.ndarray:
    """The flat pixel (iy npx + ix) of each lane in the reference's jitted
    `detect`, or -1 where it records nothing: CHUNK lanes a call, each lane
    in its own wavelength bin."""
    c2 = dataclasses.replace(cfg, wave_borders=tuple(
        float(v) for v in np.arange(CHUNK + 1)))
    tabs, acc0 = mod.device_tables(c2), mod.init_accumulators(c2)

    def pix(acc, lam, *xs):
        nz = call(c2, tabs, acc, lam, *xs)["sky"][1].reshape(CHUNK, -1) != 0
        return jnp.where(jnp.any(nz, 1), jnp.argmax(nz, 1), -1)

    f = jax.jit(pix)
    lam = jnp.arange(CHUNK, dtype=jnp.float32) + 0.5
    n = inputs[0].shape[0]
    return np.concatenate([np.asarray(f(acc0, lam, *(
        jnp.asarray(x[s:s + CHUNK]) for x in inputs)))
        for s in range(0, n, CHUNK)])


def pixel_shares(n: int, seed: int = 7) -> dict:
    """The share of n seeded lanes whose pixel differs from the
    reference's, per case."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[:8] = [[0, 0, 1]] * 4 + [[0, 0, -1]] * 4        # the poles
    v = v.astype(np.float32)
    cross = dict(position=(1.0, 2.0, 3.0), crosshair=(4.0, -1.0, 2.5),
                 up=(0.2, 0.1, 1.0))
    skies = {"mollweide": dict(npx=250),
             "mollweide_cross": dict(npx=250, **cross),
             "healpix": dict(projection="healpix", order=5),
             "healpix_cross": dict(projection="healpix", order=5, **cross)}
    ones = lambda: (jnp.ones(CHUNK, jnp.float32), 1, jnp.ones(CHUNK, bool))
    shares = {}
    for name, kw in skies.items():
        cfg = ref_asky.AllSkyInstrumentCfg("a", (0.0, 1.0), **kw)
        got = _ref_pixels(ref_asky, cfg, lambda c, t, a, lam, k: ref_asky.
                          detect(c, t, a, lam, k, *ones()), [v])
        pc = bridge.instrument(cfg)
        ix, iy = asky.sky_pixels(pc, asky.device_tables(pc, "cpu"),
                                 torch.tensor(v))
        shares[name] = float(np.mean(got != (iy * pc.npx_eff + ix).numpy()))
    cfg = ref_persp.PerspectiveInstrumentCfg(
        "p", (0.0, 1.0), npx=250, npy=200, width=2.0, view=(0.5, 0.2, 0.1),
        cross=(3.0, 1.0, 0.5), up=(0.0, 0.1, 1.0), focal=1.5)
    pos = (rng.uniform(-1, 1, (n, 3)) * [1, 3, 3] + [4, 1, 0.5]).astype(
        np.float32)
    dist = np.linalg.norm(cfg.frame()[0] - pos, axis=1).astype(np.float32)
    got = _ref_pixels(ref_persp, cfg, lambda c, t, a, lam, p, d: ref_persp.
                      detect(c, t, a, lam, p, d, *ones()), [pos, dist])
    pc = bridge.instrument(cfg)
    i, j, ze = persp.image_pixels(pc, persp.device_tables(pc, "cpu"),
                                  torch.tensor(pos))
    seen = (ze > pc.pixel_size / 10) & (i >= 0) & (i < pc.npx) & (j >= 0) \
        & (j < pc.npy)
    flat = torch.where(seen, j * pc.npx + i, torch.full_like(i, -1))
    assert (got >= 0).mean() > 0.5
    shares["perspective"] = float(np.mean(got != flat.numpy()))
    return shares


def test_pixel_share_matches_reference():
    """No lane's pixel parts from the reference's (measured on 2^16 lanes
    by this module run as a script)."""
    shares = pixel_shares(1 << 12)
    print(shares)
    assert all(s == 0.0 for s in shares.values()), shares


if __name__ == "__main__":
    print(pixel_shares(1 << 16))
