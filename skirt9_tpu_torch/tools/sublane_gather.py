"""Chained per-lane row lookups (TPU kernel 9).

Port of `tools/bench_sublane_gather.py`: at its shapes (a table of R = 512
rows by 128 lanes, S = 64 index rows, 256 chained iterations) it computes
`out[s, l] = sum_i tab[(idx[s, l] + i) % R, l]` twice through its CUDA
kernel (`csrc/row_lookup.cu`): by gather (`kern_gather`,
take_along_axis over axis 0) and by a compare-select loop over the R rows
(`kern_select`, about 1.07e9 compare-selects). Each is checked against the
plain PyTorch version, and one line per probe gives its time and rate, as
the original prints them. The inputs come from numpy `default_rng(0)` (the
table) and `default_rng(1)` (the indices); the original draws them
unseeded.

Run on the card (the default) or, with the plain versions, on the CPU:

    python -m skirt9_tpu_torch.tools.sublane_gather [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import device as dv
from ..kernels import build as kb
from .gather_probe import time_ms

R = 512          # table rows
S = 64           # index rows (lanes = S * 128)
W = 128          # lanes per row
ITERS = 256      # chained iterations


def inputs(device, r: int = R, s: int = S, w: int = W):
    tab = np.random.default_rng(0).random((r, w)).astype(np.float32)
    idx = np.random.default_rng(1).integers(0, r, (s, w)).astype(np.int32)
    return torch.tensor(tab, device=device), torch.tensor(idx, device=device)


def lookup_plain(tab: torch.Tensor, idx: torch.Tensor, iters: int = ITERS,
                 select: bool = False) -> torch.Tensor:
    """The chain in i order: a gather per step, or (select) the
    compare-select sum over all rows, which holds exactly the same value."""
    r = tab.shape[0]
    acc = torch.zeros(idx.shape, dtype=torch.float32, device=tab.device)
    rows = torch.arange(r, device=tab.device)[:, None, None]
    for i in range(iters):
        ix = torch.remainder(idx.long() + i, r)
        if select:
            v = torch.where(ix[None] == rows, tab[:, None, :],
                            torch.zeros((), device=tab.device)).sum(0)
        else:
            v = torch.gather(tab, 0, ix)
        acc = acc + v
    return acc


def lookup_library(tab: torch.Tensor, idx: torch.Tensor,
                   iters: int = ITERS) -> torch.Tensor:
    """The same sums from one torch.gather over every (i, s) row and one
    sum over i (another order of the adds): the library yardstick."""
    r = tab.shape[0]
    steps = torch.arange(iters, device=tab.device)[:, None, None]
    ix = torch.remainder(idx.long()[None] + steps, r).reshape(-1, tab.shape[1])
    return torch.gather(tab, 0, ix).reshape(iters, *idx.shape).sum(0)


def lookup(tab: torch.Tensor, idx: torch.Tensor, iters: int = ITERS,
           select: bool = False) -> torch.Tensor:
    """The chained lookups: the plain version on the CPU, the kernel on the
    card (by gather from the staged column slice, or by the select loop)."""
    if tab.dim() != 2 or idx.dim() != 2 or idx.shape[1] != tab.shape[1] \
            or tab.dtype != torch.float32 or idx.dtype != torch.int32 \
            or tab.device != idx.device:
        raise ValueError("tab (R, W) f32 and idx (S, W) int32 on one device")
    if tab.device.type == "cpu":
        return lookup_plain(tab, idx, iters, select)
    if tab.device.type != "cuda":
        raise ValueError(f"no row-lookup kernel for device {tab.device}")
    tab, idx = tab.contiguous(), idx.contiguous()
    out = torch.empty(idx.shape, dtype=torch.float32, device=tab.device)
    kb.launch("row_lookup", tab.data_ptr(), idx.data_ptr(), out.data_ptr(),
              tab.shape[0], tab.shape[1], idx.shape[0], iters, int(select),
              kb.stream_of(tab),
              count_as="row_lookup_select" if select else "row_lookup_gather")
    return out


def run(device=None, reps: int = 20, verbose: bool = True) -> dict:
    """Both variants against the plain version, then timed. Returns
    {name: {"max_abs_err", "ok", "ms", "plain_ms"}} and the library time."""
    dev = dv.resolve(device)
    tab, idx = inputs(dev)
    ref = lookup_plain(tab, idx)
    n_lookup = S * W * ITERS
    res = {}
    for name, select in (("gather", False), ("select", True)):
        got = lookup(tab, idx, select=select)
        err = float((got - ref).abs().max())
        res[name] = {
            "max_abs_err": err, "ok": err <= 1e-6 * float(ref.abs().max()),
            "ms": time_ms(lambda: lookup(tab, idx, select=select), dev, reps),
            "plain_ms": time_ms(lambda: lookup_plain(tab, idx, select=select),
                                dev, 1 if select else 3)}
    res["library_ms"] = time_ms(lambda: lookup_library(tab, idx), dev, reps)
    if verbose:
        for name, what in (("gather", f"row gather (R={R})"),
                           ("select", f"select-loop (R={R})")):
            r = res[name]
            print(f"{what}: correct={r['ok']} {r['ms']:.3f} ms for {n_lookup} "
                  f"gathers -> {n_lookup / r['ms'] / 1e6:.2f} Ge/s "
                  f"({dev.type})", flush=True)
        print(f"torch.gather baseline: {res['library_ms']:.3f} ms ({dev.type})",
              flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    res = run(args.device, args.reps)
    return 0 if res["gather"]["ok"] and res["select"]["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
