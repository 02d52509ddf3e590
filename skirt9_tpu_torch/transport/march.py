"""The scan march: a bounded walk through the grid's cells per lane.

Port of the ray marches of `skirt9_tpu/transport/lifecycle.py:132-276`,
the engine the reference runs wherever no sweep takes the grid or the
options (every configuration on its CPU): one march records the path as
(S, B) tables of the cell and the length of each step, and everything
downstream, the optical depths, the radiation-field deposits and the
interaction point, is dense tensor math on those tables.

`march_geometry` is the walk itself. On a CUDA tensor it is one launch of
the march kernel (`csrc/march.cu`, one thread per lane, in the mode of the
grid: `march_uniform`, `march_mesh`, `march_voronoi`, `march_octree`,
`march_bintree`, `march_sphere1d`, `march_cylinder2d`, `march_amr`,
`march_tetra`, `march_sphere2d`, `march_sphere3d`, `march_cylinder3d` or
`march_clumpy`;
a tree's or an adaptive mesh's node tables go in whole, and each step
descends from the root, as the reference's does, whether or not a leaf map
is attached; a curvilinear or polar grid's border tables are staged in
shared memory, a polar grid's with the cosines and sines of its angles,
the clumpy sphere's with its clumps beside them);
on a CPU tensor its
plain version, a loop of the grid's `step` over the steps. Both follow
the reference's f32 operations, with XLA's CPU fusions replayed, so that
each step lands in the reference's cell. A lane masked off, or outside the
grid, records cell 0 and length 0 for every step: the reference records the
cell a masked lane would have walked, which nothing downstream reads (its
length is 0).

The cumulative sums follow XLA's CPU cumsum (`ops.xlamath.cumsum`), whose
order decides in the last bit which step holds the interaction.
"""

from __future__ import annotations

import numpy as np
import torch

from ..grids.amr import AMRGrid
from ..grids.bintree import BinTreeGrid
from ..grids.cartesian import CartesianGrid, UniformCartesianGrid
from ..grids.clumpy import ClumpySphericalGrid
from ..grids.cylinder import Cylinder2DGrid
from ..grids.octree import OctreeGrid
from ..grids.polar import Cylinder3DGrid, Sphere2DGrid, Sphere3DGrid
from ..grids.sphere import Sphere1DGrid
from ..grids.tetra import TetraGrid
from ..grids.voronoi import VoronoiGrid
from ..kernels import build as kb
from ..media import system as msys
from ..ops import lya as lyo
from ..ops import xlamath as xm

_INV_C = 1.0 / 2.99792458e8  # inverse speed of light [s/m]

# the kernel's mode per grid class, each its own launch counter
MODES = {UniformCartesianGrid: "march_uniform", CartesianGrid: "march_mesh",
         VoronoiGrid: "march_voronoi", OctreeGrid: "march_octree",
         BinTreeGrid: "march_bintree", Sphere1DGrid: "march_sphere1d",
         Cylinder2DGrid: "march_cylinder2d", AMRGrid: "march_amr",
         TetraGrid: "march_tetra", Sphere2DGrid: "march_sphere2d",
         Sphere3DGrid: "march_sphere3d", Cylinder3DGrid: "march_cylinder3d",
         ClumpySphericalGrid: "march_clumpy"}
# the polar modes' kind in march_polar_launch
_POLAR = {"march_sphere2d": 0, "march_sphere3d": 1, "march_cylinder3d": 2}
_MODE_IDS = {"march_uniform": 0, "march_mesh": 1, "march_voronoi": 2}


def _check(grid, pos0, dirn, cell0, max_steps: int, mask) -> None:
    B = pos0.shape[0]
    if type(grid) not in MODES:
        raise NotImplementedError(
            f"the scan march on a {type(grid).__name__} is not ported yet "
            "(it walks Cartesian grids, octrees, bintrees, adaptive meshes, "
            "Voronoi and tetrahedral grids, spheres, cylinders and the "
            "clumpy sphere)")
    if pos0.shape != (B, 3) or dirn.shape != (B, 3) or cell0.shape != (B,) \
            or mask.shape != (B,):
        raise ValueError(f"pos0 {tuple(pos0.shape)}, dirn "
                         f"{tuple(dirn.shape)}, cell0 {tuple(cell0.shape)} "
                         f"and mask {tuple(mask.shape)} must be (B, 3) and "
                         "(B,)")
    if not 1 <= max_steps or max_steps * max(B, 1) >= 2 ** 31:
        raise ValueError(f"{max_steps} steps of {B} lanes out of range")


def march_geometry_plain(grid, pos0, dirn, cell0, max_steps: int, mask):
    """The plain version of `march_geometry`: the grid's `step` per step on
    the lanes still inside the grid (a step is lane by lane), ending once
    every lane has left it."""
    _check(grid, pos0, dirn, cell0, max_steps, mask)
    B = pos0.shape[0]
    cells = torch.zeros((max_steps, B), dtype=torch.int32,
                        device=pos0.device)
    ds = torch.zeros((max_steps, B), dtype=torch.float32, device=pos0.device)
    p = pos0.clone()
    c = torch.where(mask, cell0.to(torch.int64), -1)
    for s in range(max_steps):
        live = torch.nonzero(c >= 0).squeeze(1)
        if live.numel() == 0:
            break
        step, nc, np_ = grid.step(p[live], dirn[live], c[live])
        cells[s, live] = c[live].to(torch.int32)
        ds[s, live] = step
        p[live], c[live] = np_, nc
    return cells, ds


def _march_cuda(grid, pos0, dirn, cell0, max_steps: int, mask):
    _check(grid, pos0, dirn, cell0, max_steps, mask)
    mode = MODES[type(grid)]
    B = pos0.shape[0]
    dev = pos0.device
    cells = torch.empty((max_steps, B), dtype=torch.int32, device=dev)
    ds = torch.empty((max_steps, B), dtype=torch.float32, device=dev)
    pos0 = pos0.to(torch.float32).contiguous()
    dirn = dirn.to(torch.float32).contiguous()
    cell0 = cell0.to(torch.int32).contiguous()
    mask = mask.to(torch.uint8).contiguous()
    f32 = lambda t: t.to(device=dev, dtype=torch.float32).contiguous()
    ptr = lambda t: None if t is None else t.data_ptr()
    if mode in ("march_sphere1d", "march_cylinder2d"):
        cyl = mode == "march_cylinder2d"
        rb = f32(grid.rb)
        zb = f32(grid.zb) if cyl else None
        kb.launch("march_curvi", pos0.data_ptr(), dirn.data_ptr(),
                  cell0.data_ptr(), mask.data_ptr(), rb.data_ptr(), ptr(zb),
                  cells.data_ptr(), ds.data_ptr(), B, max_steps,
                  rb.shape[0] - 1, 0 if zb is None else zb.shape[0] - 1,
                  int(cyl), grid.shift, kb.stream_of(pos0), count_as=mode)
        return cells, ds
    if mode == "march_tetra":
        nbrs = grid.neighbors.to(device=dev, dtype=torch.int32).contiguous()
        face_n, face_d = f32(grid.face_n), f32(grid.face_d)
        kb.launch("march_tetra", pos0.data_ptr(), dirn.data_ptr(),
                  cell0.data_ptr(), mask.data_ptr(), face_n.data_ptr(),
                  face_d.data_ptr(), nbrs.data_ptr(), cells.data_ptr(),
                  ds.data_ptr(), B, max_steps, kb.stream_of(pos0),
                  count_as=mode)
        return cells, ds
    if mode in _POLAR:
        # rb, tb, cos_t, pb, cos_p, sin_p, zb, the lengths times 2^-shift
        s = 2.0 ** -grid.shift
        parts = [grid.rb * s] + [getattr(grid, f) for f in (
            "tb", "cos_t", "pb", "cos_p", "sin_p") if hasattr(grid, f)]
        if hasattr(grid, "zb"):
            parts.append(grid.zb * s)
        tabs = f32(torch.cat([t.to(dev) for t in parts]))
        counts = (grid.nt if hasattr(grid, "tb") else 0,
                  grid.nphi if hasattr(grid, "pb") else 0,
                  grid.nz if hasattr(grid, "zb") else 0)
        kb.launch("march_polar", pos0.data_ptr(), dirn.data_ptr(),
                  cell0.data_ptr(), mask.data_ptr(), tabs.data_ptr(),
                  cells.data_ptr(), ds.data_ptr(), B, max_steps, grid.nr,
                  *counts, _POLAR[mode], grid.shift, kb.stream_of(pos0),
                  count_as=mode)
        return cells, ds
    if mode == "march_clumpy":
        # the Sphere3D tables as march_polar packs them, then the clumps
        # (x, y, z, r), every length times 2^-shift
        sph, s = grid.sph, 2.0 ** -grid.shift
        clumps = torch.cat([grid.ccen, grid.crad[:, None]], dim=1) * s
        tabs = f32(torch.cat([t.to(dev).reshape(-1) for t in (
            sph.rb * s, sph.tb, sph.cos_t, sph.pb, sph.cos_p, sph.sin_p,
            clumps)]))
        kb.launch("march_clumpy", pos0.data_ptr(), dirn.data_ptr(),
                  cell0.data_ptr(), mask.data_ptr(), tabs.data_ptr(),
                  cells.data_ptr(), ds.data_ptr(), B, max_steps, sph.nr,
                  sph.nt, sph.nphi, grid.n_clumps, grid.shift,
                  kb.stream_of(pos0), count_as=mode)
        return cells, ds
    if mode == "march_amr":
        i32 = lambda t: t.to(device=dev, dtype=torch.int32).contiguous()
        tabs = (f32(grid.node_lo), f32(grid.node_span), i32(grid.node_div),
                i32(grid.node_child), i32(grid.node_cell),
                i32(grid.child_flat), f32(grid.cell_lo), f32(grid.cell_hi),
                f32(torch.cat([grid.box_lo, grid.box_hi])))
        kb.launch("march_amr", pos0.data_ptr(), dirn.data_ptr(),
                  cell0.data_ptr(), mask.data_ptr(),
                  *(t.data_ptr() for t in tabs),
                  cells.data_ptr(), ds.data_ptr(), B, max_steps, grid.depth,
                  grid.nudge(), kb.stream_of(pos0), count_as=mode)
        return cells, ds
    if mode in ("march_octree", "march_bintree"):
        i32 = lambda t: t.to(device=dev, dtype=torch.int32).contiguous()
        octree = mode == "march_octree"
        tabs = (i32(grid.node_child),
                None if octree else i32(grid.node_axis),
                f32(grid.node_center if octree else grid.node_split),
                i32(grid.node_cell), f32(grid.cell_lo), f32(grid.cell_hi),
                f32(torch.cat([grid.box_lo, grid.box_hi])))
        kb.launch("march_tree", pos0.data_ptr(), dirn.data_ptr(),
                  cell0.data_ptr(), mask.data_ptr(), *(ptr(t) for t in tabs),
                  cells.data_ptr(), ds.data_ptr(), B, max_steps, grid.levels,
                  int(octree), kb.stream_of(pos0), count_as=mode)
        return cells, ds
    tabs, consts, degree = (None, None, None), None, 0
    n = (grid.ncells, 0, 0) if mode == "march_voronoi" else grid.shape
    if mode == "march_uniform":
        consts = f32(torch.cat([grid.lo, grid.h]))
    elif mode == "march_mesh":
        tabs = tuple(f32(b) for b in grid)
    else:
        nbrs = grid.neighbors.to(device=dev, dtype=torch.int32).contiguous()
        tabs = (f32(grid.sites), nbrs, None)
        consts = f32(torch.cat([grid.box_lo, grid.box_hi]))
        degree = nbrs.shape[1]
    kb.launch("march", pos0.data_ptr(), dirn.data_ptr(), cell0.data_ptr(),
              mask.data_ptr(), *(ptr(t) for t in tabs), ptr(consts),
              cells.data_ptr(), ds.data_ptr(), B, max_steps, *n, degree,
              _MODE_IDS[mode], kb.stream_of(pos0), count_as=mode)
    return cells, ds


def march_geometry(grid, pos0, dirn, cell0, max_steps: int, mask):
    """The geometric march (the reference's `lifecycle.py:132-150`): per
    step s and lane b the cell walked (int32) and the step's length (f32),
    (S, B) each with S = max_steps, from the positions pos0 (B, 3), the
    directions dirn (B, 3) and the start cells cell0 (B,) of the lanes in
    mask (B,) bool. One launch of the march kernel on the card, the plain
    loop on the CPU."""
    if pos0.device.type == "cpu":
        return march_geometry_plain(grid, pos0, dirn, cell0, max_steps, mask)
    if pos0.device.type != "cuda":
        raise ValueError(f"no march kernel for device {pos0.device}")
    return _march_cuda(grid, pos0, dirn, cell0, max_steps, mask)


def _doppler(lam, dirn, v):
    """The wavelengths (S, B) that the cells' bulk velocities v (S, B, 3)
    perceive of lanes at lam (B,) moving along dirn (B, 3)."""
    p = dirn[None, :, :] * v
    return lam[None, :] / (1.0 - ((p[..., 0] + p[..., 1]) + p[..., 2])
                           * _INV_C)


def comp_sum(nd, sig):
    """sum_h nd[..., h] * sig[..., h] with each product fused into the sum,
    as XLA forms the reference's einsum and sum over components."""
    out = nd[..., 0] * sig[..., 0]
    for h in range(1, nd.shape[-1]):
        out = xm.fma(nd[..., h], sig[..., h], out)
    return out


def step_tau(nd, sig, ds):
    """The optical depth of each step, comp_sum(nd, sig) * ds, with the
    subnormal sum and product flushed to zero as XLA's CPU code flushes
    them: a cell of density ~1e-12 at a cross section ~1e-27 gives a
    subnormal nd sig, so the reference's step there has depth 0 and can
    hold no interaction."""
    return xm.ftz(xm.ftz(comp_sum(nd, sig)) * ds)


def opacity_on_path(med: msys.MediumTables, opt: msys.Optics, cells, ds,
                    dirn, lam=None, lya: bool = False,
                    scattering: bool = False):
    """Per-step optical depths (S, B) of a recorded march (the reference's
    `lifecycle.py:153-181`): the lanes' cross sections at their own
    wavelengths, or with lam (B,) the cells' perceived wavelengths
    (kinematics), or with lya the Voigt cross section at each cell's gas
    temperature and perceived wavelength on component 0. A step of length 0
    adds nothing."""
    c = cells.to(torch.int64)
    if lya:
        lam_c = _doppler(lam, dirn, med.bulk_v[c])
        T = torch.clamp_min(med.temperature[c], 1.0)
        return med.nd[c, 0] * lyo.cross_section(lam_c, T) * ds
    nd = med.nd[c]                                           # (S, B, H)
    if lam is None:
        sig = opt.sigma_sca if scattering else opt.sigma_ext  # (B, H)
        return step_tau(nd, sig[None].expand_as(nd), ds)
    lam_c = _doppler(lam, dirn, med.bulk_v[c])
    o = msys.optics_at(med, lam_c.reshape(-1))
    sig = (o.sigma_sca if scattering else o.sigma_ext).reshape(nd.shape)
    return step_tau(nd, sig, ds)


def trace_tau(grid, med: msys.MediumTables, opt: msys.Optics, pos, dirn,
              cell, max_steps: int, active, lam=None, lya: bool = False):
    """The extinction optical depth (B,) from pos along dirn to the grid's
    edge (the reference's `lifecycle.py:184-196`): the peel-off's."""
    cells, ds = march_geometry(grid, pos, dirn, cell, max_steps, active)
    return torch.sum(opacity_on_path(med, opt, cells, ds, dirn, lam, lya),
                     dim=0)


def march_record(grid, med: msys.MediumTables, opt: msys.Optics, pos0, dirn,
                 cell0, max_steps: int, mask, record_sca: bool = False,
                 lam=None, lya: bool = False):
    """One march recording (cells, ds, dtau) per step, (S, B) each, and the
    scattering optical depths too with record_sca (explicit absorption;
    the reference's `lifecycle.py:199-219`)."""
    cells, ds = march_geometry(grid, pos0, dirn, cell0, max_steps, mask)
    dtau = opacity_on_path(med, opt, cells, ds, dirn, lam, lya)
    if record_sca:
        return cells, ds, dtau, opacity_on_path(med, opt, cells, ds, dirn,
                                                lam, lya, scattering=True)
    return cells, ds, dtau


def tau_before(dtau):
    """The optical depth (S, B) before each step, in XLA's cumsum order
    (the reference's `jnp.cumsum(dtau, axis=0) - dtau`)."""
    return xm.cumsum(dtau) - dtau


def deposit_factor(ds, dtau):
    """(1 - e^-dtau) ds / dtau per step, ds (1 - dtau / 2) below dtau 1e-4:
    the path integral of e^-tau ds over a step in units of its entry's
    attenuation, as the reference forms it (`lifecycle.py:239-242`), in
    XLA's expm1. On CUDA tensors one launch of `csrc/xla_math.cu`'s
    deposit_factor kernel, on the CPU `deposit_factor_plain`, bit for bit
    the same."""
    if ds.device.type == "cpu":
        return deposit_factor_plain(ds, dtau)
    if ds.device.type != "cuda":
        raise ValueError(f"no deposit factor kernel for device {ds.device}")
    from ..kernels import build as kb
    ds, dtau = ds.contiguous(), dtau.contiguous()
    if ds.dtype != torch.float32 or dtau.shape != ds.shape \
            or dtau.dtype != torch.float32:
        raise ValueError("deposit_factor takes f32 ds and dtau of one shape")
    out = torch.empty_like(ds)
    kb.launch("deposit_factor", ds.data_ptr(), dtau.data_ptr(),
              out.data_ptr(), ds.numel(), kb.stream_of(ds))
    return out


def deposit_factor_plain(ds, dtau):
    """`deposit_factor` in PyTorch operations on any device, on the walked
    steps only (an empty step's factor is +0 in either branch)."""
    out = torch.zeros_like(ds)
    walked = ds > 0
    s, d = ds[walked], dtau[walked]
    out[walked] = torch.where(d < 1e-4, s * xm.fma(-0.5, d, 1.0),
                              -xm.expm1_xla(-d) * s
                              / torch.clamp_min(d, 1e-37))
    return out


def deposit_rf(rf, cells, ds, dtau, tau_b, lum, rf_bin, rf_mask,
               rf_scale: float) -> None:
    """Add a recorded march's radiation-field deposits into rf (ncells,
    nbins), in place (the reference's `lifecycle.py:222-247`): per step
    L e^-tau0 (1 - e^-dtau) / k, the path integral of L e^-tau ds over the
    step (L e^-tau0 ds (1 - dtau / 2) below dtau 1e-4), into the bin rf_bin
    (B,) of each lane in rf_mask, in units of rf_scale, as one index_add_
    into rf's own dtype (f64 on the card's segments). The two square-root
    factors of 1 / rf_scale go on different tensors, as in the reference,
    whose f32 would underflow their product. 1 - e^-dtau is XLA's expm1
    (`xlamath.expm1_xla`), which parts from PyTorch's in the last bit on
    ~40% of the steps."""
    inv_sqrt = 1.0 / float(np.sqrt(rf_scale))
    lum_half = (lum * rf_mask) * inv_sqrt                      # (B,)
    contrib = (lum_half * torch.exp(-tau_b)) * (deposit_factor(ds, dtau)
                                                * inv_sqrt)
    flat = cells.to(torch.int64) * rf.shape[1] + rf_bin[None, :]
    rf.view(-1).index_add_(0, flat.reshape(-1),
                           contrib.reshape(-1).to(rf.dtype))


def _take(a, idx):
    return a.gather(0, idx[None, :])[0]


def interaction_point(pos0, dirn, cells, ds, dtau, tau_b, tau_int, int_mask):
    """The interaction on a recorded march (the reference's
    `lifecycle.py:250-276`): the first step where the cumulative depth
    reaches tau_int, linear in tau inside it. Returns (ipos (B, 3), icell
    int64, found, idx, frac); idx and frac place any other cumulative
    quantity at the interaction."""
    hit = ((tau_b + dtau) >= tau_int[None, :]) & (dtau > 0)
    found = torch.any(hit, dim=0) & int_mask
    idx = torch.argmax(hit.to(torch.uint8), dim=0)           # first hit
    ds_i, dtau_i, tb_i = _take(ds, idx), _take(dtau, idx), _take(tau_b, idx)
    sb_i = _take(xm.cumsum(ds) - ds, idx)
    frac = torch.clamp((tau_int - tb_i) / torch.clamp_min(dtau_i, 1e-37),
                       0.0, 1.0)
    s_total = xm.fma(frac, ds_i, sb_i)
    ipos = xm.fma(s_total[:, None], dirn, pos0)
    return ipos, _take(cells, idx).to(torch.int64), found, idx, frac
