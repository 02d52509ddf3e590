"""Minimal FITS writer (no external deps).

Replaces the reference's embedded CFITSIO (ref: SKIRT/core/FITSInOut.hpp:16,
SKIRT/fitsio/ ~142k LoC) for the subset SKIRT produces: 2D/3D primary-HDU
images of float32/float64 with basic WCS-style keywords. The FITS format is
2880-byte header blocks of 80-char cards + big-endian data payload.
"""

from __future__ import annotations

import numpy as np

_BLOCK = 2880


def _card(key: str, value, comment: str = "") -> str:
    if isinstance(value, bool):
        v = "T" if value else "F"
        body = f"{key:<8}= {v:>20}"
    elif isinstance(value, (int, np.integer)):
        body = f"{key:<8}= {value:>20d}"
    elif isinstance(value, (float, np.floating)):
        body = f"{key:<8}= {value:>20.14E}"
    elif value is None:
        body = f"{key:<8}"
    else:
        body = f"{key:<8}= '{str(value):<8}'"
    if comment:
        body += f" / {comment}"
    return body[:80].ljust(80)


def write_fits(path: str, data: np.ndarray, header_extra: dict | None = None) -> None:
    """Write a numpy array (2D or 3D) as a simple FITS primary HDU.

    Axis order: data[..., ny, nx] maps to NAXIS1=nx (fastest) etc., matching
    the reference's frame output convention (ref: FITSInOut::write).
    """
    data = np.asarray(data)
    if data.dtype not in (np.float32, np.float64):
        data = data.astype(np.float32)
    bitpix = -32 if data.dtype == np.float32 else -64
    shape = data.shape[::-1]  # FITS axes are fortran-ordered
    cards = [
        _card("SIMPLE", True, "file conforms to FITS standard"),
        _card("BITPIX", bitpix),
        _card("NAXIS", len(shape)),
    ]
    for i, n in enumerate(shape):
        cards.append(_card(f"NAXIS{i+1}", int(n)))
    for k, v in (header_extra or {}).items():
        cards.append(_card(k[:8].upper(), v))
    cards.append("END".ljust(80))
    header = "".join(cards)
    header += " " * (-len(header) % _BLOCK)

    payload = data.astype(data.dtype.newbyteorder(">")).tobytes()
    payload += b"\x00" * (-len(payload) % _BLOCK)

    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(payload)


def read_fits(path: str) -> tuple[np.ndarray, dict]:
    """Read back a simple primary-HDU FITS file written by write_fits."""
    with open(path, "rb") as f:
        raw = f.read()
    header = {}
    pos = 0
    while True:
        block = raw[pos:pos + _BLOCK].decode("ascii", errors="replace")
        pos += _BLOCK
        done = False
        for i in range(0, _BLOCK, 80):
            card = block[i:i + 80]
            key = card[:8].strip()
            if key == "END":
                done = True
                break
            if "=" in card[8:10]:
                val = card[10:].split("/")[0].strip()
                header[key] = val
        if done:
            break
    bitpix = int(header["BITPIX"])
    naxis = int(header["NAXIS"])
    shape = tuple(int(header[f"NAXIS{i+1}"]) for i in range(naxis))[::-1]
    dtype = {-32: ">f4", -64: ">f8"}[bitpix]
    count = int(np.prod(shape))
    data = np.frombuffer(raw[pos:pos + count * abs(bitpix) // 8], dtype=dtype)
    return data.reshape(shape).astype(np.float64), header
