"""Gather and scatter-add probes against an on-chip table (TPU kernel 8).

Port of `tools/_pallas_probe.py`: at its shapes and seeds (a 32,768-entry
f32 table `nd` from numpy `default_rng(0)`, 131,072 int32 indices from
`default_rng(1)`, unit values), it gathers `out = nd[idx]` and scatter-adds
the values into a 32,768-bin accumulator, each through its CUDA kernel
(`csrc/probe_gather.cu`), checks the result against the plain PyTorch
version, and prints one line per probe with its time:

  shared-memory gather   the whole table staged in each block's shared
                         memory, one block per SM; the
                         `gather_kernel` and `take_kernel` contracts
                         (`nd[idx]`, `jnp.take(nd, idx, axis=0)`) are one
                         function and go through the same kernel
  L2 gather              the table read through L2 (`__ldg`), no staging
  scatter                `scat_kernel`'s `.at[idx].add`: at four indices
                         per bin a private accumulator buys nothing, so one
                         global atomic per index
  kernel 3 scatter       `ops.scatteradd.scatter_add` at the same shape
  torch gather           `nd[idx]`, the baseline of the original's last line

Run on the card (the default) or, with the plain versions, on the CPU:

    python -m skirt9_tpu_torch.tools.gather_probe [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import device as dv
from ..kernels import build as kb
from ..ops import scatteradd as sca

N = 32768
B = 131072


def inputs(device, n: int = N, b: int = B):
    """The probe's table, indices and values (numpy seeds 0 and 1)."""
    nd = np.random.default_rng(0).uniform(1, 2, n).astype(np.float32)
    idx = np.random.default_rng(1).integers(0, n, b).astype(np.int32)
    return (torch.tensor(nd, device=device), torch.tensor(idx, device=device),
            torch.ones(b, dtype=torch.float32, device=device))


def _check(nd, idx):
    if nd.dim() != 1 or idx.dim() != 1 or nd.dtype != torch.float32 \
            or idx.dtype != torch.int32 or nd.device != idx.device:
        raise ValueError("nd must be 1-D f32 and idx 1-D int32, on one device")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and starting on 16 bytes: the kernels load the table,
    the indices and the values 16 bytes at a time."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def gather_plain(nd: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out = nd[idx]."""
    return nd[idx.long()]


def scatter_plain(idx: torch.Tensor, vals: torch.Tensor, n: int):
    """A fresh (n,) accumulator with vals added at idx (`index_add_`)."""
    return torch.zeros(n, dtype=torch.float32, device=vals.device).index_add_(
        0, idx.long(), vals)


def gather(nd: torch.Tensor, idx: torch.Tensor,
           staged: bool = True) -> torch.Tensor:
    """out = nd[idx]: the plain version on the CPU; on the card the kernel
    with the table staged in each block's shared memory (staged) or read
    through L2."""
    _check(nd, idx)
    if nd.device.type == "cpu":
        return gather_plain(nd, idx)
    if nd.device.type != "cuda":
        raise ValueError(f"no gather probe kernel for device {nd.device}")
    nd, idx = _aligned(nd), _aligned(idx)
    out = torch.empty(idx.shape[0], dtype=torch.float32, device=nd.device)
    kb.launch("probe_gather", nd.data_ptr(), idx.data_ptr(), out.data_ptr(),
              nd.shape[0], idx.shape[0], int(staged), kb.stream_of(nd),
              count_as="probe_gather_smem" if staged else "probe_gather_l2")
    return out


def take(nd: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The `take_kernel` contract, jnp.take(nd, idx, axis=0): the same
    function as `gather`, through the same staged kernel."""
    return gather(nd, idx, staged=True)


def scatter(idx: torch.Tensor, vals: torch.Tensor, n: int) -> torch.Tensor:
    """A fresh (n,) accumulator with vals added at idx: the plain version on
    the CPU; on the card one global float atomic per index."""
    if idx.shape != vals.shape or idx.dim() != 1 \
            or idx.dtype != torch.int32 or vals.dtype != torch.float32 \
            or idx.device != vals.device:
        raise ValueError("idx (int32) and vals (f32) must be equal 1-D shapes "
                         "on one device")
    if vals.device.type == "cpu":
        return scatter_plain(idx, vals, n)
    if vals.device.type != "cuda":
        raise ValueError(f"no scatter probe kernel for device {vals.device}")
    idx, vals = _aligned(idx), _aligned(vals)
    out = torch.zeros(n, dtype=torch.float32, device=vals.device)
    kb.launch("probe_scatter", idx.data_ptr(), vals.data_ptr(), out.data_ptr(),
              n, idx.shape[0], kb.stream_of(vals),
              count_as="probe_scatter_smem")
    return out


def time_ms(fn, device, reps: int = 20) -> float:
    """Mean time of fn() in ms over reps calls after three warm-up calls:
    CUDA events on the card, the host clock on the CPU."""
    for _ in range(3):
        fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def run(device=None, reps: int = 20, verbose: bool = True) -> dict:
    """Every probe once against its plain version, then timed. Returns
    {name: {"max_abs_err", "ok", "ms"}} with the plain and library times
    beside each."""
    dev = dv.resolve(device)
    nd, idx, vals = inputs(dev)
    ref_g = gather_plain(nd, idx)
    ref_s = scatter_plain(idx, vals, N)
    res = {}
    for name, fn, ref, exact in (
            ("gather_smem", lambda: gather(nd, idx), ref_g, True),
            ("take_smem", lambda: take(nd, idx), ref_g, True),
            ("gather_l2", lambda: gather(nd, idx, staged=False), ref_g, True),
            ("scatter_smem", lambda: scatter(idx, vals, N), ref_s, False),
            ("scatter_kernel3", lambda: sca.scatter_add(idx, vals, N), ref_s,
             False)):
        got = fn()
        err = float((got - ref).abs().max())
        ok = (bool(torch.equal(got, ref)) if exact
              else err <= 1e-6 * float(ref.abs().max()))
        res[name] = {"max_abs_err": err, "ok": ok, "ms": time_ms(fn, dev, reps)}
    res["gather_plain_ms"] = time_ms(lambda: gather_plain(nd, idx), dev, reps)
    res["scatter_plain_ms"] = time_ms(lambda: scatter_plain(idx, vals, N), dev,
                                      reps)
    if verbose:
        for name, what in (("gather_smem", "shared-memory gather (gather_kernel)"),
                           ("take_smem", "shared-memory gather (take_kernel)"),
                           ("gather_l2", "L2 gather (__ldg)"),
                           ("scatter_smem", "scatter-add (global atomics)"),
                           ("scatter_kernel3", "kernel 3 scatter-add")):
            r = res[name]
            print(f"{what}: correct={r['ok']} max_abs_err={r['max_abs_err']:.3g}"
                  f"  {r['ms'] * 1e3:.1f} us for {B} elems ({dev.type})",
                  flush=True)
        print(f"torch nd[idx] baseline: {res['gather_plain_ms'] * 1e3:.1f} us; "
              f"index_add_ baseline: {res['scatter_plain_ms'] * 1e3:.1f} us "
              f"({dev.type})", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    res = run(args.device, args.reps)
    return 0 if all(r["ok"] for r in res.values() if isinstance(r, dict)) else 1


if __name__ == "__main__":
    raise SystemExit(main())
