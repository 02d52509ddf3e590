"""Perspective instrument: a camera inside the model.

Port of `skirt9_tpu/instruments/perspective.py` (the reference's
PerspectiveInstrument): the eye sits `focal` behind the viewport origin on
the crosshair's axis, the peel-off direction points from each event to the
eye, and the event projects through the eye onto the viewport's pixels.
Each detection is calibrated by the eye-frame depth z', as the reference
calibrates it: the caller's 1/d^2 becomes 1/z'^2.

`detect` forms the bins and pixels in PyTorch ops, in the reference's XLA
arithmetic on the CPU (its dot products fused), and sums the contributions
into the flattened (NUM_KINDS, nbins, npy, npx) image through
`ops.scatteradd.scatter_add`: one launch of `csrc/scatter_add.cu` on the
card, `index_add_` on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import sampling
from ..ops import scatteradd as sca
from ..ops import xlamath as xm
from .allsky import dot3
from .distant import (KIND_PRIMARY_DIRECT, KIND_PRIMARY_SCATTERED,
                      KIND_SECONDARY_DIRECT, KIND_SECONDARY_SCATTERED,
                      NUM_KINDS)


@dataclasses.dataclass(frozen=True)
class PerspectiveInstrumentCfg:
    """Viewport origin `view` aimed at `cross`, the eye `focal` behind the
    viewport (the reference's dataclass, field for field)."""

    name: str
    wave_borders: tuple
    npx: int = 250
    npy: int = 250
    width: float = 1.0              # viewport width [m]
    view: tuple = (0.0, 0.0, 0.0)   # viewport origin [m]
    cross: tuple = (1.0, 0.0, 0.0)  # crosshair [m]
    up: tuple = (0.0, 0.0, 1.0)
    focal: float = 1.0              # eye-to-viewport distance [m]
    record_statistics: bool = False
    stats_scale: float = 1.0

    @property
    def nbins(self) -> int:
        return len(self.wave_borders) - 1

    @property
    def is_local(self) -> bool:
        return True

    @property
    def is_perspective(self) -> bool:
        return True

    @property
    def pixel_size(self) -> float:
        return self.width / self.npx

    def frame(self):
        """(eye, ex, ey, ez): the eye's position and the camera's axes, ez
        from the eye toward the crosshair."""
        V = np.asarray(self.view, np.float64)
        C = np.asarray(self.cross, np.float64)
        kn = V - C
        n = np.linalg.norm(kn)
        if n < 1e-20:
            raise ValueError("crosshair too close to viewport origin")
        kn /= n
        E = V + self.focal * kn
        up = np.asarray(self.up, np.float64)
        ey = np.cross(kn, np.cross(up, kn))
        ny = np.linalg.norm(ey)
        if ny < 1e-20:
            raise ValueError("up direction parallel to viewing axis")
        ey /= ny
        ex = np.cross(ey, kn)
        return E, ex, ey, -kn


def device_tables(cfg: PerspectiveInstrumentCfg, device) -> dict:
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    E, ex, ey, ez = cfg.frame()
    return {"obs": f32(E), "ex": f32(ex), "ey": f32(ey), "ez": f32(ez),
            "wave_borders": f32(cfg.wave_borders)}


def init_accumulators(cfg: PerspectiveInstrumentCfg, device) -> dict:
    return {"sky": torch.zeros((NUM_KINDS, cfg.nbins, cfg.npy, cfg.npx),
                               dtype=torch.float32, device=device)}


def image_pixels(cfg: PerspectiveInstrumentCfg, tables: dict,
                 pos: torch.Tensor):
    """(i, j) int64 viewport pixels and the eye-frame depth z' (B,) of
    event positions (B, 3)."""
    q = pos - tables["obs"]
    xe, ye, ze = (dot3(q, tables[k][None, :]) for k in ("ex", "ey", "ez"))
    safe_z = torch.where(ze.abs() < 1e-30, torch.full_like(ze, 1e-30), ze)
    f = xm.f32(cfg.focal / cfg.pixel_size)
    i = torch.floor(cfg.npx / 2 + (f * xe) / safe_z).to(torch.int64)
    j = torch.floor(cfg.npy / 2 + (f * ye) / safe_z).to(torch.int64)
    return i, j, ze


def detect(cfg: PerspectiveInstrumentCfg, tables: dict, acc: dict,
           lam: torch.Tensor, pos: torch.Tensor, dist: torch.Tensor,
           contrib: torch.Tensor, kind: int, active: torch.Tensor) -> dict:
    """Project event positions through the eye onto the viewport and record
    their contributions into acc["sky"] (in place): contrib carries the
    caller's 1/dist^2, which becomes 1/z'^2 here, as the reference
    calibrates a perspective detection by the eye-frame depth."""
    nb = cfg.nbins
    b = sampling.searchsorted_right(tables["wave_borders"], lam) - 1
    i, j, ze = image_pixels(cfg, tables, pos)
    ok = (active & (b >= 0) & (b < nb) & (ze > cfg.pixel_size / 10)
          & (i >= 0) & (i < cfg.npx) & (j >= 0) & (j < cfg.npy))
    c = torch.where(ok, xm.ftz(contrib * (dist * dist)
                               / torch.clamp_min(ze * ze, 1e-30)),
                    torch.zeros_like(contrib))
    bq = torch.clamp(b, 0, nb - 1)
    flat = (((kind * nb + bq) * cfg.npy + torch.clamp(j, 0, cfg.npy - 1))
            * cfg.npx + torch.clamp(i, 0, cfg.npx - 1))
    sky = acc["sky"]
    sky.view(-1).add_(sca.scatter_add(flat, c, sky.numel()))
    return acc


def calibrate(cfg: PerspectiveInstrumentCfg, acc: dict) -> np.ndarray:
    """Surface brightness (nbins, npy, npx) [W/m^2/m/sr]: divided by the bin
    width and the central pixel's solid angle."""
    dlam = np.diff(np.asarray(cfg.wave_borders, np.float64))[:, None, None]
    alpha = 2.0 * np.arctan(0.5 * cfg.pixel_size / cfg.focal)
    sky = acc["sky"].detach().cpu().numpy().astype(np.float64)
    total = sky[KIND_PRIMARY_DIRECT] + sky[KIND_PRIMARY_SCATTERED] \
        + sky[KIND_SECONDARY_DIRECT] + sky[KIND_SECONDARY_SCATTERED]
    return total / (dlam * alpha * alpha)
