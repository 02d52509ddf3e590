"""Distant instruments: parallel-projection observers with SED and frames.

Port of `skirt9_tpu/instruments/distant.py` for SED, Monte Carlo statistics
(power sums of w^k, k = 0..4), frame and polarization (Stokes Q, U, V of
the SED and the frame) instruments. On the GPU `detect` is one launch of
the CUDA kernel in `csrc/detect.cu` (bin search, statistics powers, frame
projection and every sum, the Stokes sums with them, in place); its plain
version, `detect_plain`, forms the bins in PyTorch ops and scatters through
`ops.scatteradd` (the reference's seven scatter-adds per detection, ten
with Stokes). Accumulators are updated in place. Calibration runs once on
the host, in float64.

Bands, time axes, scattering levels, apertures and redshift are not ported
yet and raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import build as kb
from ..ops import sampling
from ..ops import scatteradd as sca

KIND_TRANSPARENT = 0
KIND_PRIMARY_DIRECT = 1
KIND_PRIMARY_SCATTERED = 2
KIND_SECONDARY_DIRECT = 3
KIND_SECONDARY_SCATTERED = 4
NUM_KINDS = 5

KIND_NAMES = ["transparent", "primarydirect", "primaryscattered",
              "secondarydirect", "secondaryscattered"]


@dataclasses.dataclass(frozen=True)
class DistantInstrumentCfg:
    """Static configuration of one distant instrument (the reference's
    dataclass, field for field; angles: inclination from +z, azimuth from
    +x, roll about the line of sight)."""

    name: str
    wave_borders: tuple
    inclination: float = 0.0
    azimuth: float = 0.0
    roll: float = 0.0
    distance: float = 3.0857e17
    npx: int = 0
    npy: int = 0
    fovx: float = 0.0
    fovy: float = 0.0
    centerx: float = 0.0
    centery: float = 0.0
    record_statistics: bool = True
    record_polarization: bool = False
    bands: tuple = ()
    stats_scale: float = 1.0
    aperture: float = 0.0
    num_scattering_levels: int = 0
    time_borders: tuple = ()
    redshift: float = 0.0
    angular_distance: float = 0.0

    @property
    def ntime(self) -> int:
        return max(len(self.time_borders) - 1, 0)

    @property
    def nbins(self) -> int:
        if self.bands:
            return len(self.bands)
        return len(self.wave_borders) - 1

    @property
    def has_frame(self) -> bool:
        return self.npx > 0 and self.npy > 0

    def frame_axes(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(k_obs, e_x, e_y): line of sight and image-plane axes."""
        ct, st = np.cos(self.inclination), np.sin(self.inclination)
        cp, sp = np.cos(self.azimuth), np.sin(self.azimuth)
        cw, sw = np.cos(self.roll), np.sin(self.roll)
        kobs = np.array([st * cp, st * sp, ct])
        ex0 = np.array([-sp, cp, 0.0])
        ey0 = np.cross(kobs, ex0)
        ex = cw * ex0 - sw * ey0
        ey = sw * ex0 + cw * ey0
        return kobs, ex, ey


def check_supported(cfg: DistantInstrumentCfg) -> None:
    """Raise NotImplementedError naming each instrument feature not ported."""
    missing = [name for name, on in (
        ("bands", bool(cfg.bands)),
        ("time_borders", cfg.ntime > 0),
        ("num_scattering_levels", cfg.num_scattering_levels > 0),
        ("aperture", cfg.aperture > 0.0),
        ("redshift", cfg.redshift > 0.0)) if on]
    if missing:
        raise NotImplementedError(
            f"instrument {cfg.name}: {', '.join(missing)} not ported yet")


def scratch_size(cfg: DistantInstrumentCfg) -> int:
    """Entries of the detect kernel's per-call scratch: the SED row and the
    five statistics rows (6 nb) and the frame cube, and with polarization
    the three Stokes rows (9 nb) and the three Stokes cubes beside it."""
    rows = 9 if cfg.record_polarization else 6
    cube = cfg.nbins * cfg.npy * cfg.npx if cfg.has_frame else 0
    return rows * cfg.nbins + (4 if cfg.record_polarization else 1) * cube


def device_tables(cfg: DistantInstrumentCfg, device) -> dict:
    """Device copies of (kobs, ex, ey, wave_borders); under "scalars" the
    detect kernel's host arguments: 1/stats_scale, ex, ey, the frame centre
    and 1/fovx, 1/fovy as PyTorch forms them on the card (the float
    reciprocal of the float field of view); on the GPU, under "scratch",
    the kernel's per-call sums, flags, touched-entry list and counters
    (`scratch_size` entries), and under "epoch" the last call's number,
    which marks the flags (the sums and counters are zeroed here and left
    zeroed by every launch, so one stream at a time detects through one
    set of tables)."""
    check_supported(cfg)
    kobs, ex, ey = cfg.frame_axes()
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    inv = lambda v: float(np.float32(1.0) / np.float32(v)) if v else 0.0
    scalars = (1.0 / cfg.stats_scale, *map(float, ex), *map(float, ey),
               cfg.centerx, cfg.centery, inv(cfg.fovx), inv(cfg.fovy))
    tabs = {"kobs": f32(kobs), "ex": f32(ex), "ey": f32(ey),
            "wave_borders": f32(cfg.wave_borders), "scalars": scalars}
    if torch.device(device).type == "cuda":
        n = scratch_size(cfg)
        zeros = lambda k, dtype: torch.zeros(k, dtype=dtype, device=device)
        tabs["scratch"] = (zeros(n, torch.float32), zeros(n, torch.int32),
                           zeros(n, torch.int32), zeros(2, torch.int32))
        tabs["epoch"] = 0
    return tabs


def init_accumulators(cfg: DistantInstrumentCfg, device) -> dict:
    check_supported(cfg)
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    nb = cfg.nbins
    acc = {"sed": z(NUM_KINDS, nb)}
    if cfg.record_statistics:
        acc["stats"] = z(5, nb)
    if cfg.record_polarization:
        # Stokes Q, U, V sums (I is the SED's)
        acc["stokes"] = z(3, nb)
    if cfg.has_frame:
        acc["frame"] = z(NUM_KINDS, nb, cfg.npy, cfg.npx)
        if cfg.record_polarization:
            acc["frame_stokes"] = z(3, nb, cfg.npy, cfg.npx)
    return acc


def detect(cfg: DistantInstrumentCfg, tables: dict, acc: dict,
           lam: torch.Tensor, pos: torch.Tensor, contrib: torch.Tensor,
           kind: int, active: torch.Tensor,
           stokes_quv: torch.Tensor | None = None) -> dict:
    """Record a batch of peel-off contributions [W/sr] into acc (in place):
    one kernel launch on the GPU, `detect_plain` on the CPU. stokes_quv
    (B, 3): the contributions' normalised Stokes Q, U, V in the instrument
    frame, recorded where the instrument records polarization."""
    if lam.device.type == "cpu":
        return detect_plain(cfg, tables, acc, lam, pos, contrib, kind, active,
                            stokes_quv=stokes_quv)
    if lam.device.type != "cuda":
        raise ValueError(f"no detect kernel for device {lam.device}")
    _detect_cuda(cfg, tables, acc, lam, pos, contrib, kind, active,
                 stokes_quv)
    return acc


def _detect_cuda(cfg, tables, acc, lam, pos, contrib, kind, active,
                 stokes_quv=None):
    B, nb, dev = lam.shape[0], cfg.nbins, lam.device
    lam, contrib = lam.contiguous(), contrib.contiguous()
    pos, active = pos.contiguous(), active.to(torch.bool).contiguous()
    quv = (stokes_quv.contiguous()
           if cfg.record_polarization and stokes_quv is not None else None)
    shaped = [(lam, (B,), "lam"), (pos, (B, 3), "pos"),
              (contrib, (B,), "contrib"), (active, (B,), None),
              (tables["wave_borders"], (nb + 1,), "wave_borders"),
              (acc["sed"], (NUM_KINDS, nb), "sed")]
    if cfg.record_statistics:
        shaped.append((acc["stats"], (5, nb), "stats"))
    if cfg.has_frame:
        shaped.append((acc["frame"], (NUM_KINDS, nb, cfg.npy, cfg.npx),
                       "frame"))
    if quv is not None:
        shaped += [(quv, (B, 3), "stokes_quv"),
                   (acc["stokes"], (3, nb), "stokes")]
        if cfg.has_frame:
            shaped.append((acc["frame_stokes"], (3, nb, cfg.npy, cfg.npx),
                           "frame_stokes"))
    for t, shape, name in shaped:
        # inputs were made contiguous above; the accumulators and borders
        # are written or read in place through raw pointers
        if tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{name or 'active'} {tuple(t.shape)} must be "
                             f"{shape} on {dev}")
        if name is not None and (t.dtype != torch.float32
                                 or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32")
    if not 0 <= kind < NUM_KINDS:
        raise ValueError(f"kind {kind} out of range")
    stats = acc["stats"] if cfg.record_statistics else None
    frame = acc["frame"][kind] if cfg.has_frame else None
    # the Stokes sums: the SED's rows, and the frame's cubes except for the
    # transparent kind, as in the reference
    sed_quv = acc["stokes"] if quv is not None else None
    frame_quv = (acc["frame_stokes"] if quv is not None and cfg.has_frame
                 and kind != KIND_TRANSPARENT else None)
    scratch = tables.get("scratch")
    size = scratch_size(cfg)
    if (scratch is None or any(t.device != dev for t in scratch)
            or scratch[0].numel() != size):
        raise ValueError(f"detect needs the tables' scratch of {size} "
                         f"entries on {dev}: device_tables(cfg, {dev})")
    # the call's epoch, 1 .. 2^31 - 1, which no flag holds: flags hold
    # earlier epochs, or 0 after a zeroing when the epochs wrap
    epoch = tables["epoch"] % 0x7FFFFFFF + 1
    if epoch == 1 and tables["epoch"]:
        scratch[1].zero_()
    tables["epoch"] = epoch
    ptr = lambda t: None if t is None else t.data_ptr()
    kb.launch("detect", *(ptr(t) for t in (
                  lam, pos, contrib, active, quv, tables["wave_borders"],
                  acc["sed"][kind], stats, frame, sed_quv, frame_quv,
                  *scratch)),
              B, nb, cfg.npx, cfg.npy, epoch, *tables["scalars"],
              kb.stream_of(lam))


def detect_plain(cfg: DistantInstrumentCfg, tables: dict, acc: dict,
                 lam: torch.Tensor, pos: torch.Tensor, contrib: torch.Tensor,
                 kind: int, active: torch.Tensor,
                 scatter=sca.scatter_add_plain,
                 stokes_quv: torch.Tensor | None = None) -> dict:
    """`detect` in PyTorch ops on any device, summing through `scatter`
    (`ops.scatteradd.scatter_add` gives the reference's seven scatter-add
    calls through TPU kernel 3's counterpart, ten with Stokes). With
    stokes_quv and record_polarization, the SED's Stokes rows take
    quv_i * c (c masked by ok) and, except for the transparent kind, the
    frame's Stokes cubes quv_i * contrib where the pixel is in the frame
    (`skirt9_tpu/instruments/distant.py:214-217, 240-247`)."""
    nb = cfg.nbins
    polarized = cfg.record_polarization and stokes_quv is not None
    b = sampling.searchsorted_right(tables["wave_borders"], lam) - 1
    ok = active & (b >= 0) & (b < nb) & (contrib > 0)
    bq = torch.clamp(b, 0, nb - 1)
    c = torch.where(ok, contrib, torch.zeros_like(contrib))
    acc["sed"][kind] += scatter(bq, c, nb)
    if polarized:
        acc["stokes"] += torch.stack([scatter(bq, stokes_quv[:, i] * c, nb)
                                      for i in range(3)])
    if cfg.record_statistics:
        # power sums of individual contributions, kinds merged; normalised by
        # stats_scale so that c^4 stays inside f32
        cn = c * (1.0 / cfg.stats_scale)
        cn2 = cn * cn
        powers = [ok.to(torch.float32), cn, cn2, cn * cn2, cn2 * cn2]
        acc["stats"] += torch.stack([scatter(bq, p, nb) for p in powers])
    if cfg.has_frame:
        # the dot products in the order of the CPU's three-term sum, which
        # the detect kernel follows (PyTorch's CUDA sum adds in another one)
        ex, ey = tables["ex"], tables["ey"]
        xp = (pos[:, 0] * ex[0] + pos[:, 1] * ex[1]) + pos[:, 2] * ex[2] \
            - cfg.centerx
        yp = (pos[:, 0] * ey[0] + pos[:, 1] * ey[1]) + pos[:, 2] * ey[2] \
            - cfg.centery
        ix = torch.floor((xp / cfg.fovx + 0.5) * cfg.npx)
        iy = torch.floor((yp / cfg.fovy + 0.5) * cfg.npy)
        okf = ok & (ix >= 0) & (ix < cfg.npx) & (iy >= 0) & (iy < cfg.npy)
        ixc = torch.clamp(ix, 0, cfg.npx - 1).to(torch.int64)
        iyc = torch.clamp(iy, 0, cfg.npy - 1).to(torch.int64)
        flat = (bq * cfg.npy + iyc) * cfg.npx + ixc
        cf = torch.where(okf, contrib, torch.zeros_like(contrib))
        size = nb * cfg.npy * cfg.npx
        acc["frame"][kind] += scatter(flat, cf, size).reshape(
            nb, cfg.npy, cfg.npx)
        if polarized and kind != KIND_TRANSPARENT:
            acc["frame_stokes"] += torch.stack(
                [scatter(flat, stokes_quv[:, i] * cf, size)
                 for i in range(3)]).reshape(3, nb, cfg.npy, cfg.npx)
    return acc


# ------------------------------------------------------------- calibration

def _host(acc: dict, key: str) -> np.ndarray:
    return acc[key].detach().cpu().numpy().astype(np.float64)


def calibrate_sed(cfg: DistantInstrumentCfg, acc: dict) -> dict:
    """Calibrated F_lambda [W/m^2/m] per kind and total, plus the Monte Carlo
    statistics R, VOV and N (Camps & Baes 2018)."""
    borders = np.asarray(cfg.wave_borders, np.float64)
    dlam = np.diff(borders)
    d2 = cfg.distance ** 2
    sed = _host(acc, "sed")
    out = {"wavelength": np.sqrt(borders[1:] * borders[:-1])}
    for k, name in enumerate(KIND_NAMES):
        out[name] = sed[k] / (d2 * dlam)
    out["total"] = (sed[KIND_PRIMARY_DIRECT] + sed[KIND_PRIMARY_SCATTERED]
                    + sed[KIND_SECONDARY_DIRECT]
                    + sed[KIND_SECONDARY_SCATTERED]) / (d2 * dlam)
    if cfg.record_polarization and "stokes" in acc:
        quv = _host(acc, "stokes")
        for i, name in enumerate(("Q", "U", "V")):
            out[name] = quv[i] / (d2 * dlam)
    if cfg.record_statistics and "stats" in acc:
        w = _host(acc, "stats")
        n = np.maximum(w[0], 1.0)
        w1, w2, w3, w4 = w[1], w[2], w[3], w[4]
        with np.errstate(divide="ignore", invalid="ignore"):
            rel = np.sqrt(np.maximum(
                w2 / np.maximum(w1, 1e-300) ** 2 - 1.0 / n, 0.0))
            m1 = w1 / n
            s2 = np.maximum(w2 - n * m1 ** 2, 0.0)
            s4 = (w4 - 4.0 * m1 * w3 + 6.0 * m1 ** 2 * w2
                  - 3.0 * n * m1 ** 4)
            vov = np.where(s2 > 0,
                           s4 / np.maximum(s2, 1e-300) ** 2 - 1.0 / n, 0.0)
        out["R"] = np.where(w1 > 0, rel, 0.0)
        out["VOV"] = np.where(w1 > 0, np.maximum(vov, 0.0), 0.0)
        out["N"] = w[0]
    return out


def _pixel_solid_angle(cfg: DistantInstrumentCfg) -> float:
    pix_x = cfg.fovx / cfg.npx
    pix_y = cfg.fovy / cfg.npy
    d_ang = cfg.angular_distance or cfg.distance
    return 4.0 * np.arctan(0.5 * pix_x / d_ang) * np.arctan(0.5 * pix_y / d_ang)


def calibrate_stokes_frames(cfg: DistantInstrumentCfg, acc: dict) -> np.ndarray:
    """Calibrated per-pixel Stokes Q, U, V cubes [W/m^2/m/sr], (3, nb, npy,
    npx), with the total cube's calibration."""
    dlam = np.diff(np.asarray(cfg.wave_borders, np.float64))[None, :, None,
                                                            None]
    return _host(acc, "frame_stokes") / (cfg.distance ** 2 * dlam
                                         * _pixel_solid_angle(cfg))


def calibrate_frame(cfg: DistantInstrumentCfg, acc: dict) -> np.ndarray:
    """Calibrated IFU cube [W/m^2/m/sr], (nb, npy, npx), summed over the
    non-transparent kinds."""
    dlam = np.diff(np.asarray(cfg.wave_borders, np.float64))[:, None, None]
    frame = _host(acc, "frame")
    total = frame[KIND_PRIMARY_DIRECT] + frame[KIND_PRIMARY_SCATTERED] \
        + frame[KIND_SECONDARY_DIRECT] + frame[KIND_SECONDARY_SCATTERED]
    return total / (cfg.distance ** 2 * dlam * _pixel_solid_angle(cfg))
