"""The frame's pixel of every peel-off lane, the port's plain version
(`instruments.distant.frame_pixels`, inside `detect_plain`) against the
reference's jitted `detect`, lane by lane.

2^20 positions from a numpy seed at three orientations, fields of view and
frame centres. The reference's pixel index of each lane is taken from its
own jitted `detect`: a spy on its frame's `scatter_add` returns the index
array that the frame's sum receives, in the same jitted program, whose
frame is compared too. XLA's CPU code forms the projection `pos @ ex` as
fma(z, ex2, fma(y, ex1, x ex0)), the division by the field of view as a
product with the f32 reciprocal of the f32 field of view, fused with the
+ 0.5 into one multiply-add, and the product with the pixel count on its
own; each other order parts from it on a few lanes of 2^20 at a pixel
border.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skirt9_tpu.instruments import distant as rd
from skirt9_tpu_torch.instruments import distant as pd
from skirt9_tpu_torch.ops import scatteradd as sca

N = 1 << 20
# (inclination, azimuth [deg], field of view, pixels, centre x, centre y)
VIEWS = {
    "oblique": (30.0, 20.0, 2.1, 64, 0.0, 0.0),
    "edge_on_pc": (87.0, -45.0, 3.3e16, 100, 1e15, -2e15),
    "face_on": (0.0, 0.0, 1.7, 33, 0.1, 0.0),
}


def _cfgs(view):
    inc, az, fov, npx, cx, cy = VIEWS[view]
    kw = dict(name="i", wave_borders=(0.5e-6, 0.6e-6), distance=100.0,
              inclination=float(np.radians(inc)),
              azimuth=float(np.radians(az)), npx=npx, npy=npx + 3,
              fovx=fov, fovy=1.3 * fov, centerx=cx, centery=cy)
    return rd.DistantInstrumentCfg(**kw), pd.DistantInstrumentCfg(**kw)


def _reference(cfg, pos, monkeypatch):
    """(per-lane frame index, frame) of the reference's jitted detect."""
    tabs, acc = rd.device_tables(cfg), rd.init_accumulators(cfg)
    size = cfg.nbins * cfg.npy * cfg.npx
    seen, orig = [], rd.sca.scatter_add

    def spy(idx, val, n):
        if n == size:
            seen.append(idx)
        return orig(idx, val, n)

    monkeypatch.setattr(rd.sca, "scatter_add", spy)

    def run(pos, lam, c, act):
        seen.clear()
        out = rd.detect(cfg, tabs, acc, lam, pos, c, 0, act)
        return seen[-1], out["frame"][0]

    B = pos.shape[0]
    idx, frame = jax.jit(run)(jnp.asarray(pos),
                              jnp.full((B,), 0.55e-6, jnp.float32),
                              jnp.ones((B,), jnp.float32),
                              jnp.ones((B,), bool))
    return np.asarray(idx), np.asarray(frame)


@pytest.mark.parametrize("view", list(VIEWS))
def test_pixels_match_reference_on_every_lane(view, monkeypatch):
    ref_cfg, cfg = _cfgs(view)
    rs = np.random.default_rng(11)
    pos = (rs.uniform(-0.65, 0.65, (N, 3)) * cfg.fovx).astype(np.float32)
    idx_ref, frame_ref = _reference(ref_cfg, pos, monkeypatch)

    tabs = pd.device_tables(cfg, "cpu")
    ix, iy = pd.frame_pixels(cfg, tabs, torch.from_numpy(pos))
    inside = (ix >= 0) & (ix < cfg.npx) & (iy >= 0) & (iy < cfg.npy)
    assert 0.5 < float(inside.double().mean()) < 1.0
    flat = (iy.clamp(0, cfg.npy - 1).long() * cfg.npx
            + ix.clamp(0, cfg.npx - 1).long()).numpy()
    assert np.array_equal(flat, idx_ref), int((flat != idx_ref).sum())

    # the whole detection: each lane adds 1 to its pixel
    acc = pd.init_accumulators(cfg, "cpu")
    ones = torch.ones(N)
    pd.detect_plain(cfg, tabs, acc, torch.full((N,), 0.55e-6),
                    torch.from_numpy(pos), ones, 0,
                    torch.ones(N, dtype=torch.bool),
                    scatter=sca.scatter_add_plain)
    assert np.array_equal(acc["frame"][0].numpy(), frame_ref)
