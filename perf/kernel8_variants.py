"""Kernel 8's variants that the package does not ship, the parent's design,
the launch floor, the rates of distributed shared memory and the host cost
of the parent's per-call set-up, beside the package's kernels
(`skirt9_tpu_torch/csrc/probe_gather.cu`), at the probe's shapes (a
32,768-entry f32 table, 131,072 int32 indices, unit values; the inputs of
`skirt9_tpu_torch.tools.gather_probe.inputs`):

- gathers: the parent's whole-table-per-block design (`old_smem`) and its
  one-index-per-thread L2 gather (`old_l2`), the cluster gather through
  distributed shared memory at cluster sizes 2-16 (`dsmem<k>`; `dsmemx<k>`
  with the loads as mapa and ld.shared::cluster), the whole
  table per block by TMA bulk copies, multicast over a cluster of k
  (`mcast<k>`; k = 1 is one bulk-copied table per block), and the
  package's two
  (`shipped_smem`, `shipped_l2`); each must equal `gather_plain` bit for
  bit;
- scatters: the parent's per-block histogram (`old_smem`), the histogram
  split over a cluster (`split<k>`) and the package's (`shipped`); each
  within 1e-6 of `scatter_plain`'s maximum;
- the floor: an empty one-block kernel launched plainly and as a cluster
  of one, through the same ctypes path;
- rates (lookups per second, `rates`): each index looked up 8 and 32
  times in block-local shared memory, in distributed shared memory
  (`dsmemx`: spelled as mapa and ld.shared::cluster) and in L2, as a
  gather and as a scatter-add, at cluster sizes 1-16: 32 lookups over the
  kernel's time, and the marginal rate between 8 and 32;
- host cost: the time per call of the parent's staged launcher with its
  per-call set-up and with that set-up done once, of the package's C
  entries, and of the set-up alone in C.

The parent's designs and the package's are timed in turns (parent,
package, package, parent). A cluster size that the card refuses is
recorded with its error where it is a measurement (the rates, the
variants); the package's own launches raise. Run from the repository root
on a machine with a CUDA device:

    python3 perf/kernel8_variants.py

It prints one JSON line; `chip_smoke.py`'s kernels_probe phase calls
`measure`.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perf import kernel6_variants as k6v  # noqa: E402
from skirt9_tpu_torch.kernels import build as kb  # noqa: E402

SOURCE = os.path.join(HERE, "kernel8_variants.cu")
_P, _I = ctypes.c_void_p, ctypes.c_int
ENTRIES = {
    # nd, idx, out, n, B, staged, stream
    "old_gather_launch": [_P] * 3 + [_I] * 3 + [_P],
    # idx, val, out, n, B, stream
    "old_scatter_launch": [_P] * 3 + [_I] * 2 + [_P],
    # nd, idx, out, n, B, stream
    "old_gather_cached_launch": [_P] * 3 + [_I] * 2 + [_P],
    # k, then nd, idx, out (or idx, val, out), n, B, stream
    "dsmem_gather_launch": [_I] + [_P] * 3 + [_I] * 2 + [_P],
    "dsmemx_gather_launch": [_I] + [_P] * 3 + [_I] * 2 + [_P],
    "mcast_gather_launch": [_I] + [_P] * 3 + [_I] * 2 + [_P],
    "scatter_split_launch": [_I] + [_P] * 3 + [_I] * 2 + [_P],
    "empty_launch": [_P],
    "empty_cluster_launch": [_I, _P],
    # mode, k, nd, idx, out, hist, n, B, rounds, stream
    "rates_launch": [_I, _I] + [_P] * 4 + [_I] * 3 + [_P],
    "setup_cost_ns": [_I, ctypes.POINTER(ctypes.c_double)],
}
CLUSTERS = (2, 4, 8, 16)
ROUNDS = 32
ROUNDS_LOW = 8
RATE_MODES = ("local_gather", "dsmem_gather", "l2_gather", "local_scatter",
              "dsmem_scatter", "l2_scatter", "dsmemx_gather")
HOST_CALLS = 500
HOST_ROUNDS = 5


def build() -> ctypes.CDLL:
    """Compile the variants (or find them built) and load them."""
    return k6v.build_library(SOURCE, ENTRIES)


def measure(torch, cuda_ms, device_ms) -> dict:
    """Every variant checked and timed (`cuda_ms`: CUDA events per call;
    `device_ms`: torch.profiler), the floor, the rates and the host
    cost. Times in ms, rates in lookups per second."""
    from skirt9_tpu_torch.tools import gather_probe as gp
    lib = build()
    dev = torch.device("cuda")
    nd, idx, vals = gp.inputs(dev)
    n, B = gp.N, gp.B
    ref_g = gp.gather_plain(nd, idx)
    ref_s = gp.scatter_plain(idx, vals, n)
    out = torch.empty_like(ref_g)
    hist = torch.zeros(n, dtype=torch.float32, device=dev)
    stream = kb.stream_of(nd)
    p = lambda *ts: [t.data_ptr() for t in ts]
    res = {"gather": {}, "scatter": {}, "floor": {}, "rates": {},
           "host": {}}

    def timed(table, name, fn, check):
        """fn returns the tensor it filled, or the cudaError of a refused
        launch (recorded)."""
        got = fn()
        if not torch.is_tensor(got):
            table[name] = {"refused": got}
            return
        torch.cuda.synchronize()
        check(name, got)
        entry = {"ms": cuda_ms(fn), "device_ms": device_ms(fn)["all"]}
        if name in table:
            table[name]["again"] = entry
        else:
            table[name] = entry

    def gather_ok(name, got):
        if not torch.equal(got, ref_g):
            raise AssertionError(f"kernel 8 gather {name} differs")

    def scatter_ok(name, got):
        err = float((got - ref_s).abs().max())
        if err > 1e-6 * float(ref_s.max()):
            raise AssertionError(f"kernel 8 scatter {name}: error {err}")

    old_smem = lambda: lib.old_gather_launch(*p(nd, idx, out), n, B, 1,
                                             stream) or out
    old_l2 = lambda: lib.old_gather_launch(*p(nd, idx, out), n, B, 0,
                                           stream) or out
    smem = lambda: gp.gather(nd, idx)
    l2 = lambda: gp.gather(nd, idx, staged=False)
    g = res["gather"]
    for name, fn in (("old_smem", old_smem), ("shipped_smem", smem),
                     ("shipped_smem", smem), ("old_smem", old_smem),
                     ("old_l2", old_l2), ("shipped_l2", l2),
                     ("shipped_l2", l2), ("old_l2", old_l2)):
        timed(g, name, fn, gather_ok)
    for k in CLUSTERS:
        timed(g, f"dsmem{k}", lambda k=k: lib.dsmem_gather_launch(
            k, *p(nd, idx, out), n, B, stream) or out, gather_ok)
        timed(g, f"dsmemx{k}", lambda k=k: lib.dsmemx_gather_launch(
            k, *p(nd, idx, out), n, B, stream) or out, gather_ok)
    for k in (1, *CLUSTERS):
        timed(g, f"mcast{k}", lambda k=k: lib.mcast_gather_launch(
            k, *p(nd, idx, out), n, B, stream) or out, gather_ok)

    def zeroed(launch):
        """A scatter variant on a zeroed accumulator (the package's wrapper
        allocates it with torch.zeros): one fill launch in each time."""
        def fn():
            hist.zero_()
            return launch() or hist
        return fn

    old_scatter = zeroed(lambda: lib.old_scatter_launch(
        *p(idx, vals, hist), n, B, stream))
    shipped = lambda: gp.scatter(idx, vals, n)
    s = res["scatter"]
    for name, fn in (("old_smem", old_scatter), ("shipped", shipped),
                     ("shipped", shipped), ("old_smem", old_scatter)):
        timed(s, name, fn, scatter_ok)
    for k in CLUSTERS:
        timed(s, f"split{k}", zeroed(lambda k=k: lib.scatter_split_launch(
            k, *p(idx, vals, hist), n, B, stream)), scatter_ok)
    s["zero_fill"] = {"device_ms": device_ms(lambda: hist.zero_())["all"]}

    f = res["floor"]
    for name, fn in (("empty", lambda: lib.empty_launch(stream) or out),
                     ("empty_cluster1",
                      lambda: lib.empty_cluster_launch(1, stream) or out)):
        timed(f, name, fn, lambda name, got: None)

    # each rate at ROUNDS lookups per index over the kernel's time, and the
    # marginal rate between ROUNDS_LOW and ROUNDS (the staging, the syncs
    # and the launch taken out); device time, or CUDA events where the
    # profiler dropped the kernel's events
    for k in (1, *CLUSTERS):
        for mode, what in enumerate(RATE_MODES):
            if k == 1 and "dsmem" in what:
                continue
            t = {}
            for rounds in (ROUNDS_LOW, ROUNDS):
                fn = lambda mode=mode, k=k, rounds=rounds: lib.rates_launch(
                    mode, k, *p(nd, idx, out, hist), n, B, rounds, stream)
                err = fn()
                if err:
                    break
                dev_ms, ms = device_ms(fn)["all"], cuda_ms(fn)
                t[rounds] = dev_ms if dev_ms > 0 else ms
            if err:
                res["rates"][f"{what}{k}"] = {"refused": err}
                continue
            res["rates"][f"{what}{k}"] = {
                "ms": t[ROUNDS], "ms_low": t[ROUNDS_LOW],
                "per_s": B * ROUNDS / (t[ROUNDS] * 1e-3),
                "marginal_per_s": B * (ROUNDS - ROUNDS_LOW) / max(
                    (t[ROUNDS] - t[ROUNDS_LOW]) * 1e-3, 1e-12)}

    # the host's time per call of the parent's staged gather launcher with
    # its per-call set-up and with the set-up done once (the same kernel
    # and launch), and of the package's C entries: HOST_ROUNDS rounds in
    # turns, HOST_CALLS calls each; the median round per name
    pkg = kb.library()
    launchers = {
        "old": old_smem,
        "old_cached": lambda: lib.old_gather_cached_launch(
            *p(nd, idx, out), n, B, stream),
        "package_smem": lambda: pkg.probe_gather_launch(
            *p(nd, idx, out), n, B, 1, stream),
        "package_l2": lambda: pkg.probe_gather_launch(
            *p(nd, idx, out), n, B, 0, stream),
        "old_l2": old_l2}
    rounds = {name: [] for name in launchers}
    for _ in range(HOST_ROUNDS):
        for name, fn in launchers.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn()
            rounds[name].append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
            torch.cuda.synchronize()
    h = res["host"]
    for name, us in rounds.items():
        h[f"{name}_us_per_call"] = sorted(us)[len(us) // 2]
        h[f"{name}_us_rounds"] = us
    ns = ctypes.c_double()
    err = lib.setup_cost_ns(HOST_CALLS, ctypes.byref(ns))
    if err:
        raise RuntimeError(f"setup_cost_ns: cudaError {err}")
    h["setup_alone_us"] = ns.value / 1e3
    return res


def main() -> int:
    import torch
    from chip_smoke import cuda_ms, device_ms
    res = measure(torch, cuda_ms, device_ms)
    print(json.dumps({"kernel8_variants": res,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
