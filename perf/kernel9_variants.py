"""Times of kernel 9's row-gather variants that the package does not ship,
beside the package's kernel (`skirt9_tpu_torch/csrc/row_lookup.cu`,
`row_gather_kernel`), at the probe's shapes (a table of R = 512 rows by
W = 128 lanes, S = 64 index rows, 256 chained steps; the inputs of
`skirt9_tpu_torch.tools.sublane_gather.inputs`):

- `old`: the parent's design (16 blocks, a signed `%` by R at every step);
- `inc`: the same with the row stepped by a wrap-around increment;
- `wide`: one thread per lane, 256 blocks of 32, the 16 KB slice staged;
- `ldg`: one thread per lane, 256 blocks, the table read through L1;
- `cluster`: the package's layout with the slice split over a cluster of
  4 blocks and read through distributed shared memory;
- `group_first`: the package's kernel as first measured (the start row
  loaded after the staging, the staging loop not unrolled);
- `group4`, `group16`: the package's design with 4 threads of 64 steps
  and 16 threads of 16 steps per lane;
- `shipped`: the package's kernel through its wrapper (`lookup`).

Each must equal `lookup_plain` bit for bit. The parent's design and the
package's kernel are timed first and again last (parent, shipped, the
other variants, shipped, parent). The variants are built into their own
library under build/perf/ with the package's nvcc flags. Run from the
repository root on a machine with a CUDA device:

    python3 perf/kernel9_variants.py

It prints one JSON line; `chip_smoke.py`'s kernels_probe phase calls
`measure` on the probe's inputs.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perf import kernel6_variants as k6v  # noqa: E402
from skirt9_tpu_torch.kernels import build as kb  # noqa: E402

SOURCE = os.path.join(HERE, "kernel9_variants.cu")
_P, _I = ctypes.c_void_p, ctypes.c_int
ENTRIES = {
    # variant, tab, idx, out, R, W, S, iters, stream
    "k9_variant_launch": [_I] + [_P] * 3 + [_I] * 4 + [_P],
}
VARIANTS = ("old", "inc", "wide", "ldg", "cluster", "group_first", "group4",
            "group16")


def build() -> ctypes.CDLL:
    """Compile the variants (or find them built) and load them."""
    return k6v.build_library(SOURCE, ENTRIES)


def measure(torch, tab, idx, iters, cuda_ms, device_ms) -> dict:
    """Each variant's time per call (CUDA events, `cuda_ms`) and device
    time (`device_ms`), in ms, after a check against `lookup_plain`."""
    from skirt9_tpu_torch.tools import sublane_gather as sg
    lib = build()
    ref = sg.lookup_plain(tab, idx, iters)
    out = torch.empty_like(ref)
    R, W = tab.shape
    S = idx.shape[0]
    stream = kb.stream_of(tab)

    def variant(v):
        def fn():
            k6v._call(lib.k9_variant_launch, v, tab.data_ptr(),
                      idx.data_ptr(), out.data_ptr(), R, W, S, iters, stream)
            return out
        return fn

    res = {}

    def timed(name, fn):
        """fn launches and returns the tensor it filled."""
        out.fill_(float("nan"))
        if not torch.equal(fn(), ref):
            raise AssertionError(f"kernel 9 variant {name} differs from "
                                 "lookup_plain")
        entry = {"ms": cuda_ms(fn), "device_ms": device_ms(fn)["all"]}
        if name in res:
            res[name]["again"] = entry
        else:
            res[name] = entry

    shipped = lambda: sg.lookup(tab, idx, iters)
    for name in ("old", "shipped", *VARIANTS[1:], "shipped", "old"):
        timed(name, shipped if name == "shipped"
              else variant(VARIANTS.index(name)))
    return res


def main() -> int:
    import torch
    from chip_smoke import cuda_ms, device_ms
    from skirt9_tpu_torch.tools import sublane_gather as sg
    tab, idx = sg.inputs(torch.device("cuda"))
    res = measure(torch, tab, idx, sg.ITERS, cuda_ms, device_ms)
    # off the block grid, from start rows below 0 and past R
    tab2, idx2 = sg.inputs(torch.device("cuda"), 500, 37, 100)
    res["off_grid"] = measure(torch, tab2, idx2 * 3 - 700, 300, cuda_ms,
                              device_ms)
    print(json.dumps({"kernel9_variants": res,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
