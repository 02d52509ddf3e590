"""All-sky instruments: observers inside the model mapping the whole sky.

Port of `skirt9_tpu/instruments/allsky.py` (the reference's
AllSkyInstrument with its Mollweide projection, and HEALPixSkyInstrument's
RING-scheme `loc2pix` subset): the peel-off direction points from each
event to the observer; the arrival direction, rotated into the sky frame
(+x toward the crosshair, +z up), projects onto a sky pixel of an
equal-area map; each contribution carries the local instrument's 1/d^2
(the caller's, `transport/lifecycle.peel_off_local`). A Hammer-Aitoff
projection maps as the Mollweide one, as in the reference.

`detect` forms the bins and pixels in PyTorch ops, in the reference's XLA
arithmetic on the CPU (glibc's atan2f, sinf and cosf, `ops/xlamath.py`;
XLA's expansion of arcsin and arccos into atan2f), and sums the
contributions into the flattened (NUM_KINDS, nbins, npy, npx) sky through
`ops.scatteradd.scatter_add`: one launch of `csrc/scatter_add.cu` on the
card, `index_add_` on the CPU. The sky is updated in place; calibration
runs once on the host, in float64.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops import sampling
from ..ops import scatteradd as sca
from ..ops import xlamath as xm
from .distant import (KIND_PRIMARY_DIRECT, KIND_PRIMARY_SCATTERED,
                      KIND_SECONDARY_DIRECT, KIND_SECONDARY_SCATTERED,
                      NUM_KINDS)

_PI = xm.f32(math.pi)


@dataclasses.dataclass(frozen=True)
class AllSkyInstrumentCfg:
    """An all-sky map observer at `position` [m] (the reference's dataclass,
    field for field)."""

    name: str
    wave_borders: tuple
    position: tuple = (0.0, 0.0, 0.0)
    npx: int = 250                  # pixels in x (2:1 aspect)
    record_statistics: bool = False
    stats_scale: float = 1.0
    projection: str = "mollweide"   # or "hammer" / "healpix"
    order: int = 5                  # healpix only: Nside = 2^order
    crosshair: tuple | None = None  # orient +x toward this point [m]
    up: tuple = (0.0, 0.0, 1.0)

    @property
    def nside(self) -> int:
        return 1 << self.order

    @property
    def nbins(self) -> int:
        return len(self.wave_borders) - 1

    @property
    def npx_eff(self) -> int:
        return 4 * self.nside if self.projection == "healpix" else self.npx

    @property
    def npy(self) -> int:
        if self.projection == "healpix":
            return 4 * self.nside - 1
        return self.npx // 2

    @property
    def is_local(self) -> bool:
        return True


def _frame_matrix(cfg: AllSkyInstrumentCfg) -> np.ndarray:
    """Rows (ex, ey, ez): +x toward the crosshair, +z along the up direction
    made perpendicular to it (the reference's `_frame_matrix`)."""
    if cfg.crosshair is None:
        return np.eye(3)
    f = np.asarray(cfg.crosshair, np.float64) - np.asarray(cfg.position)
    if np.linalg.norm(f) < 1e-20:
        return np.eye(3)
    f = f / np.linalg.norm(f)
    up = np.asarray(cfg.up, np.float64)
    uz = up - (up @ f) * f
    if np.linalg.norm(uz) < 1e-12:
        alt = (np.array([1.0, 0, 0]) if abs(f[0]) < 0.9
               else np.array([0, 1.0, 0]))
        uz = alt - (alt @ f) * f
    uz = uz / np.linalg.norm(uz)
    return np.stack([f, np.cross(uz, f), uz])


def device_tables(cfg: AllSkyInstrumentCfg, device) -> dict:
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    return {"obs": f32(cfg.position), "wave_borders": f32(cfg.wave_borders),
            "frame": f32(_frame_matrix(cfg))}


def init_accumulators(cfg: AllSkyInstrumentCfg, device) -> dict:
    return {"sky": torch.zeros((NUM_KINDS, cfg.nbins, cfg.npy, cfg.npx_eff),
                               dtype=torch.float32, device=device)}


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_i a[..., i] b[..., i] over the last axis of 3 as XLA's CPU code
    reduces it: each product fused into the running sum, which starts at
    +0 (so that a sum of -0 products is +0: the sign decides atan2 at the
    map's seam)."""
    return xm.fma(a[..., 2], b[..., 2], xm.fma(a[..., 1], b[..., 1],
                                               xm.fma(a[..., 0], b[..., 0],
                                                      0.0)))


def observer_directions(tables: dict, pos: torch.Tensor):
    """(k_to_obs (B, 3), distance (B,)) from event positions to the
    observer."""
    d = tables["obs"] - pos
    dist = xm.sqrt(dot3(d, d))
    return d / torch.clamp_min(dist, 1e-30)[:, None], dist


def arcsin(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 arcsin: 2 atan2f(x, 1 + sqrt((1 - x)(1 + x)))."""
    return 2.0 * xm.atan2(x, xm.sqrt((1.0 - x) * (x + 1.0)) + 1.0)


def arccos(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 arccos: atan2f(sqrt((1 - x)(1 + x)), x)."""
    return xm.atan2(xm.sqrt((1.0 - x) * (x + 1.0)), x)


def _mollweide_xy(lon, lat, iters: int = 6):
    """Mollweide's projection to x in [-2, 2], y in [-1, 1]: six Newton
    steps on 2t + sin 2t = pi sin(lat)."""
    t = lat
    sin_lat = xm.sincos(lat)[0]
    for _ in range(iters):
        s2, c2 = xm.sincos(2.0 * t)
        f = xm.fma(-_PI, sin_lat, 2.0 * t + s2)
        df = xm.fma(2.0, c2, 2.0)
        t = t - f / torch.clamp_min(df, 1e-6)
    s, c = xm.sincos(t)
    return (xm.f32(2 / math.pi) * lon) * c, s


def _healpix_ring_ij(theta, phi, nside: int):
    """RING-scheme (ring, pixel in ring) of the HEALPix image layout (the
    reference's `_healpix_ring_ij`); phi in [0, 2 pi)."""
    z = xm.cos(theta)
    za = z.abs()
    tt = torch.remainder(2.0 * phi * xm.f32(1 / math.pi), 4.0)
    # the equatorial belt: 4 nside pixels a ring
    t1 = nside * (0.5 + tt)
    c = xm.f32(0.75 * nside)
    jp_e = torch.floor(xm.fma(-c, z, t1)).to(torch.int32)
    jm_e = torch.floor(xm.fma(c, z, t1)).to(torch.int32)
    j_e = nside + 1 + jp_e - jm_e
    kshift = 1 - (j_e & 1)
    i_e = ((jp_e + jm_e + kshift + 1 + 7 * nside) >> 1) & (4 * nside - 1)
    j_e = j_e + nside - 2
    # the polar caps: rings grow away from the pole
    tp = tt - torch.floor(tt)
    tmp = torch.where(
        za < 0.99, nside * xm.sqrt(3.0 * (1.0 - za)),
        nside * xm.sin(theta) / xm.sqrt(torch.clamp_min((1.0 + za) / 3.0,
                                                        1e-12)))
    jp_p = (tp * tmp).to(torch.int32)
    jm_p = ((1.0 - tp) * tmp).to(torch.int32)
    j_p = jp_p + jm_p + 1
    i_p = (tt * j_p.to(torch.float32)).to(torch.int32)
    j_p = torch.where(z < 0, 4 * nside - j_p - 1, j_p - 1)
    eq = za <= xm.f32(2.0 / 3.0)
    return torch.where(eq, i_e, i_p), torch.where(eq, j_e, j_p)


def sky_pixels(cfg: AllSkyInstrumentCfg, tables: dict,
               arrival_dir: torch.Tensor):
    """The sky pixel (ix, iy), int64, of arrival directions (B, 3) pointing
    from the observer toward the events."""
    fr = tables["frame"]
    k = dot3(arrival_dir[:, None, :], fr[None, :, :])        # (B, 3)
    kx, ky, kz = k.unbind(1)
    kz = torch.clamp(kz, -1.0, 1.0)
    if cfg.projection == "healpix":
        phi = xm.atan2(ky, kx) + _PI
        i, j = _healpix_ring_ij(arccos(kz), phi, cfg.nside)
        ix = torch.clamp(i, 0, cfg.npx_eff - 1)
        iy = torch.clamp(j, 0, cfg.npy - 1)
    else:
        x, y = _mollweide_xy(xm.atan2(ky, kx), arcsin(kz))
        ix = torch.clamp((xm.fma(x, 0.5, 1.0) * 0.5 * cfg.npx).to(
            torch.int32), 0, cfg.npx - 1)
        iy = torch.clamp(((y + 1.0) * 0.5 * cfg.npy).to(torch.int32), 0,
                         cfg.npy - 1)
    return ix.to(torch.int64), iy.to(torch.int64)


def detect(cfg: AllSkyInstrumentCfg, tables: dict, acc: dict,
           lam: torch.Tensor, arrival_dir: torch.Tensor,
           contrib: torch.Tensor, kind: int, active: torch.Tensor) -> dict:
    """Record contributions [W/sr/m^2] arriving from arrival_dir into
    acc["sky"] (in place): one `scatter_add` of the whole batch into the
    flattened sky."""
    nb = cfg.nbins
    b = sampling.searchsorted_right(tables["wave_borders"], lam) - 1
    ok = active & (b >= 0) & (b < nb) & (contrib > 0)
    bq = torch.clamp(b, 0, nb - 1)
    ix, iy = sky_pixels(cfg, tables, arrival_dir)
    flat = ((kind * nb + bq) * cfg.npy + iy) * cfg.npx_eff + ix
    c = torch.where(ok, contrib, torch.zeros_like(contrib))
    sky = acc["sky"]
    sky.view(-1).add_(sca.scatter_add(flat, c, sky.numel()))
    return acc


def calibrate(cfg: AllSkyInstrumentCfg, acc: dict) -> np.ndarray:
    """Surface brightness (nbins, npy, npx) [W/m^2/m/sr]: the contributions
    carry 1/d^2 already; divided by the bin width and the pixel's solid
    angle (4 pi over the useful pixels of an equal-area map)."""
    dlam = np.diff(np.asarray(cfg.wave_borders, np.float64))[:, None, None]
    if cfg.projection == "healpix":
        omega_pix = np.pi / (3 * cfg.nside ** 2)
    else:
        # the Mollweide ellipse fills pi/4 of its rectangle
        omega_pix = 4 * np.pi / (cfg.npx * cfg.npy * np.pi / 4)
    sky = acc["sky"].detach().cpu().numpy().astype(np.float64)
    total = sky[KIND_PRIMARY_DIRECT] + sky[KIND_PRIMARY_SCATTERED] \
        + sky[KIND_SECONDARY_DIRECT] + sky[KIND_SECONDARY_SCATTERED]
    return total / (dlam * omega_pix)
