"""SED families: parameterized SED template grids, sampled on tensors.

Port of `skirt9_tpu/spectral/sedfamily.py` (ref: SKIRT/core/SEDFamily.hpp,
FileSSPSEDFamily.hpp). A family maps per-entity parameters (initial mass,
metallicity, age) to a specific luminosity spectrum L_lambda; an imported
source allocates luminosity between its entities and samples each packet's
wavelength through it.

The family keeps one dense cdf per parameter-grid node, and an entity's
spectrum is sampled as the multilinear mixture of its 2^P surrounding
nodes: pick a corner node with probability (weight x corner luminosity
share), invert that node's cdf. The reference interpolates the parameters
geometrically (log L), so each packet carries the importance factor
L_geo / L_lin of its wavelength (`FamilyTables.mixture_weight`).

What the reference shapes for the TPU becomes plain tensor ops here: its
dense compare-reduce row searches are `torch.searchsorted` and its takes
indexing. Where an ulp decides a discrete outcome (the node-cdf inversion
at a stratum's edge picks a cdf row) the sums that XLA fuses with their
product are `ops.xlamath.fma`, so the same row comes out; the importance
weight exp(sum w ln L) may differ by f32 rounding. The families are the
stored-table SSP family (`FileSSPSEDFamily`), the indexed family
(`FileIndexedSEDFamily`) and the blackbody family on a temperature grid
(`BlackBodySEDFamily`); the named resource families are not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import rng, sampling
from ..ops import xlamath as xm
from ..ops.planck import b_lambda_np
from ..utils.storedtable import read_stored_table

M_SUN = 1.98892e30  # kg (reference Constants::Msun)


@dataclasses.dataclass(frozen=True)
class SEDFamily:
    """A tabulated SED family on a rectilinear parameter grid.

    lam: (T,) wavelength grid [m], increasing
    L: (M, T) specific luminosity [W/m] at each of the M = prod(n_p)
       parameter nodes (C-order flattening of the parameter axes, first
       parameter axis slowest)
    param_axes: list of (name, points, 'lin'|'log') for each non-wavelength
       parameter, in stored-table order
    scale_name: name of the leading linear scale parameter ('Minit' for SSP
       families: L scales with initial mass in Msun)
    """

    lam: np.ndarray
    L: np.ndarray
    param_axes: list
    scale_name: str = "Minit"

    @property
    def nparams(self) -> int:
        return len(self.param_axes)

    def specific_luminosity_geometric(self, params: np.ndarray) -> np.ndarray:
        """Geometric (log-value) parameter interpolation of L_lambda for
        unit scale (ref: StoredTable.hpp value interpolation; FamilySED.cpp:
        31). Zero nodes floor to a tiny positive value and round back to
        zero on output."""
        idx, w = self._corners(params)
        floor = max(float(self.L.max()) * 1e-35, 1e-300)
        logL = np.log(np.maximum(self.L[idx], floor))
        out = np.exp(np.einsum("nc,nct->nt", w, logL))
        return np.where(out <= floor * 1.01, 0.0, out)

    def _corners(self, params: np.ndarray):
        """Multilinear corner indices (N, 2^P) into the flattened node axis
        and their weights (N, 2^P), host f64, parameters clamped to the
        grid."""
        params = np.atleast_2d(np.asarray(params, np.float64))
        n = len(params)
        dims = [len(pts) for (_, pts, _) in self.param_axes]
        strides = np.cumprod([1] + dims[::-1])[::-1][1:]  # C-order strides
        j0s, fs = [], []
        for p, (_, pts, scale) in enumerate(self.param_axes):
            x = params[:, p]
            if scale == "log":
                xs = np.log(np.maximum(x, 1e-300))
                ps = np.log(np.maximum(pts, 1e-300))
            else:
                xs, ps = x, pts
            if len(pts) == 1:
                j0s.append(np.zeros(n, np.int64))
                fs.append(np.zeros(n))
                continue
            j = np.clip(np.searchsorted(ps, xs) - 1, 0, len(pts) - 2)
            f = np.clip((xs - ps[j]) / np.maximum(ps[j + 1] - ps[j], 1e-300),
                        0.0, 1.0)
            j0s.append(j)
            fs.append(f)
        P = self.nparams
        idx = np.zeros((n, 1 << P), np.int64)
        w = np.ones((n, 1 << P))
        for c in range(1 << P):
            for p in range(P):
                hi = (c >> (P - 1 - p)) & 1
                dim = len(self.param_axes[p][1])
                jj = np.minimum(j0s[p] + hi, dim - 1)
                idx[:, c] += jj * strides[p]
                w[:, c] *= fs[p] if hi else (1.0 - fs[p])
        return idx, w


def load_ssp_family(path: str) -> SEDFamily:
    """FileSSPSEDFamily: .stab with axes lambda(m), Z(1), t(yr) [, U(1)] and
    quantity Llambda(W/m) per Msun of initial mass
    (ref: FileSSPSEDFamily.hpp:20-43)."""
    return load_family_stab(path, scale_name="Minit")


def load_family_stab(path: str, scale_name: str = "Minit") -> SEDFamily:
    """Stored-table family: axes lambda(m), p2, p3, ... and one per-unit-scale
    spectral quantity, whose values come first-axis-last; the parameter
    axes are transposed to (p2, p3, ..., lambda) and flattened in C order."""
    tab = read_stored_table(path)
    if tab.axes_names[0] != "lambda":
        raise ValueError("family stored table must have lambda as first axis")
    lam = tab.axes_points[0]
    q = tab.quantity(tab.quantity_names[0])
    nax = len(tab.axes_names)
    perm = tuple(range(nax - 2, -1, -1)) + (nax - 1,)
    qp = np.transpose(q, perm) if nax > 1 else q[None, :]
    L = qp.reshape(-1, len(lam))
    param_axes = [(tab.axes_names[i], tab.axes_points[i],
                   tab.axes_scales[i]) for i in range(1, nax)]
    return SEDFamily(lam=lam, L=L, param_axes=param_axes,
                     scale_name=scale_name)


def load_indexed_family(path: str) -> SEDFamily:
    """FileIndexedSEDFamily: .stab with axes lambda(m), index(1); entities
    carry (luminosity, index) (ref: FileIndexedSEDFamily.hpp). The
    per-index spectra are normalized shapes scaled by the entity's
    luminosity."""
    tab = read_stored_table(path)
    q = tab.quantity(tab.quantity_names[0])  # (nindex, nlam)
    return SEDFamily(lam=tab.axes_points[0], L=np.atleast_2d(q),
                     param_axes=[("index", tab.axes_points[1], "lin")],
                     scale_name="L")


def blackbody_family(temperatures: np.ndarray,
                     lam: np.ndarray) -> SEDFamily:
    """BlackBodySEDFamily as a tabulated family on a temperature grid
    (ref: BlackBodySEDFamily.hpp; the scale parameter is the emitting
    area 4 pi R^2)."""
    T = np.asarray(temperatures, np.float64)
    return SEDFamily(lam=lam, L=np.pi * b_lambda_np(lam[None, :], T[:, None]),
                     param_axes=[("T", T, "log")], scale_name="area")


def _take(rows: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return rows.gather(1, k[:, None])[:, 0]


def _row_before(rows: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """rows[k - 1], or 0 where k is 0 (the cdf's implicit leading zero)."""
    c0 = _take(rows, torch.clamp_min(k - 1, 0))
    return torch.where(k > 0, c0, torch.zeros_like(c0))


class FamilyTables:
    """Sampling tables for one family over a wavelength clip range (the
    source range; ref: SEDFamily::cdf clipping): host f64 arrays, and their
    f32 tensors on each device that asks for them."""

    def __init__(self, family: SEDFamily, lam_range=None):
        lam = family.lam
        L = family.L
        if lam_range is not None:
            lo, hi = lam_range
            # keep the grid points inside, and the exact clip borders
            keep = (lam >= lo) & (lam <= hi)
            if keep.sum() < 2:
                raise ValueError("family grid has <2 points in source range")
            lam_c = np.unique(np.concatenate([[lo], lam[keep], [hi]]))
            Lc = np.stack([np.interp(lam_c, lam, row) for row in L])
            lam, L = lam_c, Lc
        # trapezoid cdf per node
        dl = np.diff(lam)
        seg = 0.5 * (L[:, 1:] + L[:, :-1]) * dl
        cum = np.cumsum(seg, axis=1)
        tot = np.maximum(cum[:, -1], 1e-300)
        self.family = family
        self.lam_np = lam
        self.L_np = L
        self.Ltot_np = cum[:, -1]  # integrated L_lambda per unit scale [W]
        self.cdf_np = cum / tot[:, None]
        # node log-spectra for the geometric parameter mixture
        floor = np.maximum(L.max() * 1e-35, 1e-300)
        self.logL_np = np.log(np.maximum(L, floor))
        self._on = {}

    def _tensors(self, device) -> tuple:
        """(lam (T,), cdf (M, T-1), logL (M, T)) f32 on `device`."""
        key = str(torch.device(device))
        if key not in self._on:
            f32 = lambda a: torch.tensor(np.asarray(a, np.float32),
                                         device=device)
            self._on[key] = (f32(self.lam_np), f32(self.cdf_np),
                             f32(self.logL_np))
        return self._on[key]

    @property
    def lam_range(self) -> tuple:
        """Clip-range support (for Simulation._strata_for)."""
        return (float(self.lam_np[0]), float(self.lam_np[-1]))

    # ---------------------------------------------------------------- host

    def entity_luminosities(self, scales: np.ndarray, params: np.ndarray,
                            chunk: int = 8192) -> np.ndarray:
        """(N,) integrated luminosity [W] of each entity over the clip
        range: scale * integral of the geometric corner mixture."""
        idx, w = self.family._corners(params)
        n = len(idx)
        out = np.empty(n)
        for a in range(0, n, chunk):
            b = min(a + chunk, n)
            Lg = np.exp(np.einsum("nc,nct->nt", w[a:b],
                                  self.logL_np[idx[a:b]]))
            out[a:b] = np.trapezoid(Lg, self.lam_np, axis=1)
        return np.asarray(scales, np.float64) * out

    def entity_linear_luminosities(self, params: np.ndarray) -> np.ndarray:
        """(N,) integral of the linear corner mixture per unit scale (the
        proposal distribution's normalization for importance weights)."""
        idx, w = self.family._corners(params)
        return (w * self.Ltot_np[idx]).sum(1)

    def corner_tables(self, params: np.ndarray, device):
        """Launch tables on `device`: corner node indices (N, C) int32, the
        corner-selection cdf (N, C) proportional to weight x corner
        integrated luminosity, the raw multilinear weights (N, C), and the
        per-entity ratio I_lin / I_geo of the importance correction."""
        idx, w = self.family._corners(params)
        p = w * self.Ltot_np[idx]
        p = p / np.maximum(p.sum(1, keepdims=True), 1e-300)
        Ilin = self.entity_linear_luminosities(params)
        Igeo = self.entity_luminosities(np.ones(len(idx)), params)
        ratio = Ilin / np.maximum(Igeo, 1e-300)
        f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
        return (torch.tensor(idx.astype(np.int32), device=device),
                f32(np.cumsum(p, axis=1)), f32(w), f32(ratio))

    # ------------------------------------------------------------- tensors

    def mixture_weight(self, lam, entity, corner_idx, corner_w,
                       lin_over_geo) -> torch.Tensor:
        """Importance factor making linear-mixture samples follow the
        geometric mixture: [L_geo(lam) / L_lin(lam)] * [I_lin / I_geo]."""
        lamt, _, logL = self._tensors(lam.device)
        k = sampling.locate_clip(lamt, lam)
        f = (lam - lamt[k]) / torch.clamp_min(lamt[k + 1] - lamt[k], 1e-30)
        nodes = corner_idx[entity].to(torch.int64)       # (B, C)
        lo = logL[nodes, k[:, None]]
        hi = logL[nodes, k[:, None] + 1]
        logLc = xm.fma(f[:, None], hi - lo, lo)
        w = corner_w[entity]
        lnLgeo = torch.sum(w * logLc, dim=1)
        Llin = torch.sum(w * torch.exp(logLc), dim=1)
        return torch.exp(lnLgeo) / torch.clamp_min(Llin, 1e-37) \
            * lin_over_geo[entity]

    def _node(self, keys, entity, corner_idx, corner_cdf) -> torch.Tensor:
        """The corner node each lane samples from (B,) int64: the first
        corner whose cumulative share is not below the lane's uniform."""
        u_c = rng.uniform(keys, rng.LAUNCH_FAMILY_CORNER)
        ccdf = corner_cdf[entity]
        c = torch.searchsorted(ccdf, u_c[:, None].contiguous())[:, 0]
        c = torch.clamp(c, 0, ccdf.shape[1] - 1)
        return _take(corner_idx[entity].to(torch.int64), c)

    def _invert_node_cdf(self, rows, u) -> torch.Tensor:
        """Wavelength at cdf value u of each lane's node row (B, T-1),
        linear in lambda within the row's bin."""
        lamt = self._tensors(u.device)[0]
        k = torch.searchsorted(rows, u[:, None].contiguous())[:, 0]
        k = torch.clamp(k, 0, rows.shape[1] - 1)
        c0, c1 = _row_before(rows, k), _take(rows, k)
        f = torch.where(c1 > c0, (u - c0) / torch.clamp_min(c1 - c0, 1e-30),
                        torch.full_like(u, 0.5))
        lo, hi = lamt[k], lamt[k + 1]
        return xm.fma(f, hi - lo, lo)

    def _node_cdf_at(self, rows, x) -> torch.Tensor:
        """Each lane's node cdf at wavelength x (piecewise linear in lambda,
        the exact inverse of `_invert_node_cdf`)."""
        lamt = self._tensors(x.device)[0]
        k = sampling.locate_clip(lamt, x)
        c1, c0 = _take(rows, k), _row_before(rows, k)
        lo, hi = lamt[k], lamt[k + 1]
        f = torch.clamp((x - lo) / torch.clamp_min(hi - lo, 1e-30), 0.0, 1.0)
        S = xm.fma(f, c1 - c0, c0)
        return torch.where(x <= lamt[0], torch.zeros_like(S),
                           torch.where(x >= lamt[-1], torch.ones_like(S), S))

    def sample_wavelength(self, keys, entity, corner_idx,
                          corner_cdf) -> torch.Tensor:
        """entity (B,) -> lam (B,): a corner node from the entity's mixture,
        then that node's wavelength cdf inverted."""
        node = self._node(keys, entity, corner_idx, corner_cdf)
        u = rng.uniform(keys, rng.LAUNCH_WAVELENGTH)
        return self._invert_node_cdf(self._tensors(keys.device)[1][node], u)

    def sample_wavelength_stratified(self, keys, entity, corner_idx,
                                     corner_cdf, borders, strata_w=None):
        """Stratified family sampling: lane i draws its wavelength inside
        stratum (i * R) // B of `borders` and carries the weight R * Q (Q:
        the node's probability mass in the stratum), so contiguous lane
        groups are bin-pure while the estimator keeps its expectation.
        strata_w: (R,) per-stratum valid-lane corrections. Returns (lam,
        weight)."""
        B = entity.shape[0]
        R = borders.shape[0] - 1
        stratum = (torch.arange(B, device=entity.device) * R) // B
        lo, hi = borders[stratum], borders[stratum + 1]
        node = self._node(keys, entity, corner_idx, corner_cdf)
        rows = self._tensors(keys.device)[1][node]        # (B, T-1)
        S_lo = self._node_cdf_at(rows, lo)
        S_hi = self._node_cdf_at(rows, hi)
        Q = torch.clamp_min(S_hi - S_lo, 0.0)
        u = rng.uniform(keys, rng.LAUNCH_WAVELENGTH)
        lam = self._invert_node_cdf(rows, xm.fma(u, Q, S_lo))
        lam = torch.minimum(torch.maximum(lam, lo), hi * (1.0 - 1e-7))
        w = torch.where(Q > 0, R * Q, torch.zeros_like(Q))
        if strata_w is not None:
            w = w * strata_w[stratum]
        return lam, w
