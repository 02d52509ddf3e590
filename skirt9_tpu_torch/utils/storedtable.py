"""SKIRT stored-table (.stab) resource file reader.

Implements the documented binary layout (ref: SKIRT/core/StoredTable.hpp:19-54
— 8-byte items: padded ASCII strings, little-endian uint64 counts, f64
values; values ordered quantity-fastest then first-axis-next) so that users
who have SKIRT resource packs can use them directly with this framework
(dust optical properties, SED template libraries, enthalpies, ...).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class StoredTable:
    axes_names: list
    axes_units: list
    axes_scales: list        # 'lin' or 'log' interpolation hints
    axes_points: list        # list of 1D f64 arrays (SI)
    quantity_names: list
    quantity_units: list
    quantity_scales: list
    values: np.ndarray       # shape (npoints_N, ..., npoints_1, nquantities)

    def quantity(self, name: str) -> np.ndarray:
        """Tabulated values for one quantity, axes ordered first-axis-last
        (i.e. result[..., i1] with axis-1 index last, matching `values`)."""
        qi = self.quantity_names.index(name)
        return self.values[..., qi]

    def interp(self, name: str, **axis_values) -> float:
        """Multilinear interpolation (log-scaled per the axis hints) at a
        point given by axis-name keyword arguments (SI)."""
        q = self.quantity(name)
        # iterate axes from last dim (axis 1) to first dim (axis N)
        for ax_i in range(len(self.axes_names)):
            ax_name = self.axes_names[ax_i]
            pts = self.axes_points[ax_i]
            x = float(axis_values[ax_name])
            if self.axes_scales[ax_i] == "log":
                pts_i = np.log(pts)
                xi = np.log(max(x, 1e-300))
            else:
                pts_i = pts
                xi = x
            j = int(np.clip(np.searchsorted(pts_i, xi) - 1, 0, len(pts) - 2))
            f = np.clip((xi - pts_i[j]) / max(pts_i[j + 1] - pts_i[j], 1e-300),
                        0.0, 1.0)
            # axis ax_i varies along dimension (ndim-1-ax_i) of q
            dim = q.ndim - 1 - ax_i
            lo = np.take(q, j, axis=dim)
            hi = np.take(q, j + 1, axis=dim)
            q = lo + f * (hi - lo)
        return float(q)


def read_stored_table(path: str) -> StoredTable:
    raw = np.fromfile(path, dtype=np.uint64)
    pos = 0

    def item_str(i):
        return raw[i:i + 1].tobytes().decode("ascii", errors="replace").strip()

    def item_int(i):
        return int(raw[i])

    def item_f64(i, n):
        return raw[i:i + n].view(np.float64).copy()

    name_tag = raw[0:1].tobytes().decode("ascii", errors="replace")
    pos += 1
    endian = item_int(pos); pos += 1
    if not name_tag.startswith("SKIRT"):
        raise ValueError(f"not a SKIRT stored table: tag '{name_tag}'")
    if endian != 0x010203040A0BFEFF:
        raise ValueError("stored table endianness tag mismatch "
                         f"(got {endian:#x}; big-endian files unsupported)")

    num_axes = item_int(pos); pos += 1
    axes_names = [item_str(pos + i) for i in range(num_axes)]; pos += num_axes
    axes_units = [item_str(pos + i) for i in range(num_axes)]; pos += num_axes
    axes_scales = [item_str(pos + i) for i in range(num_axes)]; pos += num_axes
    axes_points = []
    for _ in range(num_axes):
        n = item_int(pos); pos += 1
        axes_points.append(item_f64(pos, n)); pos += n

    num_q = item_int(pos); pos += 1
    q_names = [item_str(pos + i) for i in range(num_q)]; pos += num_q
    q_units = [item_str(pos + i) for i in range(num_q)]; pos += num_q
    q_scales = [item_str(pos + i) for i in range(num_q)]; pos += num_q

    counts = [len(p) for p in axes_points]
    total = int(np.prod(counts)) * num_q
    vals = item_f64(pos, total); pos += total
    eof = item_str(pos)
    if eof != "STABEND":
        raise ValueError(f"stored table end tag missing (got '{eof}')")

    # value order: quantity fastest, then axis 1, ..., axis N slowest
    values = vals.reshape(tuple(reversed(counts)) + (num_q,))
    return StoredTable(axes_names, axes_units, axes_scales, axes_points,
                       q_names, q_units, q_scales, values)


def write_stored_table(path: str, axes: list, quantities: list,
                       values: np.ndarray) -> None:
    """Write a stored table (round-trip/testing; axes = [(name, unit, scale,
    points)], quantities = [(name, unit, scale)], values shaped
    (nN, ..., n1, nq))."""
    items = []

    def put_str(s):
        b = s.encode("ascii")[:8].ljust(8)
        items.append(np.frombuffer(b, dtype=np.uint64)[0])

    def put_int(v):
        items.append(np.uint64(v))

    def put_f64(arr):
        items.extend(np.asarray(arr, np.float64).view(np.uint64))

    items.append(np.frombuffer(b"SKIRT X\n", dtype=np.uint64)[0])
    put_int(0x010203040A0BFEFF)
    put_int(len(axes))
    for name, _, _, _ in axes:
        put_str(name)
    for _, unit, _, _ in axes:
        put_str(unit)
    for _, _, scale, _ in axes:
        put_str(scale)
    for _, _, _, pts in axes:
        put_int(len(pts))
        put_f64(pts)
    put_int(len(quantities))
    for name, _, _ in quantities:
        put_str(name)
    for _, unit, _ in quantities:
        put_str(unit)
    for _, _, scale in quantities:
        put_str(scale)
    put_f64(values.reshape(-1))
    put_str("STABEND")
    np.asarray(items, np.uint64).tofile(path)
