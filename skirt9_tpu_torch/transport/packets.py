"""Photon-packet batch state: a structure of tensors over the batch.

Port of `skirt9_tpu/transport/packets.py`, with the polarization state
(the Stokes vector and the reference normal). The emitter-velocity and
path-length fields serve features that the port does not run yet, so they
are not carried.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PacketBatch(NamedTuple):
    """A batch of photon packets (all tensors share leading dim B)."""

    lam: torch.Tensor    # (B,) wavelength [m]
    lum: torch.Tensor    # (B,) current luminosity [W]
    lum0: torch.Tensor   # (B,) launch luminosity (weight-cutoff reference)
    pos: torch.Tensor    # (B, 3) position [m]
    dir: torch.Tensor    # (B, 3) unit propagation direction
    cell: torch.Tensor   # (B,) int64 current cell, -1 = outside the grid
    nscat: torch.Tensor  # (B,) int64 scattering events so far
    alive: torch.Tensor  # (B,) bool, still propagating
    hkey: torch.Tensor   # (B, 2) per-history base RNG key (uint32 in int64)
    stokes: torch.Tensor  # (B, 4) Stokes (I, Q, U, V) with I normalised to 1
    normal: torch.Tensor  # (B, 3) reference normal for the Q/U orientation
