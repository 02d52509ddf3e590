"""Where the time of the tree deposit kernel (kernel 5) goes.

The script builds variants of a kernel source with one part taken out,
each into its own library outside the package's build, and times them on
bench_config3ism's tree at B = 65536 with the event loop's inputs (kernel
4's record of box-uniform rays). The variants give wrong RFs on purpose;
only their times are read.

The package's lane-tiled kernel (`csrc/mlsweep_deposit.cu`), always:

  tile_full              the kernel as it is (shared-memory leaf table);
  tile_global            the same launch on its global-atomic path;
  tile_no_table_atomics  no shared-table adds (so nothing to flush);
  tile_no_flush          the shared-table adds, no flush into the RF;
  tile_no_grouping       no warp sums: every lane adds to the table;
  tile_setup_only        the tiles' set-up and loops, no item's work.

With `--source`, a copy of the first design (`csrc/mlsweep_deposit.cu`
before its lane tile, e.g. from `git archive` of that commit), which ran
one thread per (plan step, lane), live or not, with three warp rounds of
__match_any_sync, a 32-step f64 shuffle sum per round and one global f64
atomicAdd per group:

  full          the kernel as it was;
  no_atomics    the group sums are kept but never added to the RF;
  no_peer_sum   each group's first lane adds its own value only;
  no_grouping   no __match_any_sync and no shuffles: every lane adds its
                own contribution;
  all_dead      every thread dead (it sets up its lane and enters its slab,
                then runs the warp rounds with nothing to add): the cost
                each dead thread pays, to be scaled by the dead share.

Run from the repository root on a machine with a CUDA device:

    python3 skirt9_tpu_torch/tools/kernel5_split.py [--source OLD.cu]

It prints one JSON line with the live share, then one per variant.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

# text edits of the old kernel, each taking one part out
_FULL_ADD = "atomicAdd(rf + key, sum);"
_PEER = "const double sum = peer_sum(peers, (double)contrib);"
_MATCH = "const unsigned peers = __match_any_sync(kFull, key);"
_LIVE = "live = S.act;"
VARIANTS = {
    "full": [],
    "no_atomics": [(_FULL_ADD, "if (sum < 0.0) rf[key] = sum;")],
    "no_peer_sum": [(_PEER, "const double sum = (double)contrib;")],
    "no_grouping": [
        (_MATCH, "const unsigned peers = 1u << (threadIdx.x & 31);"),
        (_PEER, "const double sum = (double)contrib;")],
    "all_dead": [(_LIVE, "live = S.act && tlev < 0;")],
}
# the old launch signature: pos, dir, axis, smin, smax, dsub, csub, lum,
# tau_int, tb, step_tlev, step_gs, rf, first_hit, B, nx, ny, nz, n_steps,
# lox, loy, loz, hx, hy, hz, inv2, stream
_ARGS = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [ctypes.c_float] * 7
         + [ctypes.c_void_p])
# text edits of the lane-tiled kernel, each taking one part out
_TABLE = "} else if (atomicAdd(table + key, v) == 0.0) {"
_FLUSH = "atomicAdd(rf_row + c, table[c]);"
_GROUP = "warp_add(key[j], val[j], scratch[y], add);"
_ITEMS = "if (w < T.items) {"
TILE_VARIANTS = {
    "tile_full": [],
    "tile_no_table_atomics": [(_TABLE, "} else if (v < 0.0) {")],
    "tile_no_flush": [(_FLUSH,
                       "if (table[c] < 0.0) rf_row[c] = table[c];")],
    "tile_no_grouping": [(_GROUP, "if (key[j] >= 0) add(key[j], val[j]);")],
    "tile_setup_only": [(_ITEMS, "if (w < 0) {")],
}


def build_variants(source: str, variants: dict, argtypes: list,
                   out_dir: str) -> dict:
    """One shared library per variant, nvcc processes started together."""
    from skirt9_tpu_torch.kernels import build as kb
    text = open(source).read()
    procs = {}
    for name, edits in variants.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise ValueError(f"{name}: {old!r} not found once in {source}")
            src = src.replace(old, new)
        cu = os.path.join(out_dir, f"k5_{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        lib = os.path.join(out_dir, f"k5_{name}.so")
        cmd = [kb._nvcc(), *kb.NVCC_FLAGS, "-shared", "-I",
               os.path.dirname(os.path.abspath(source)), "-o", lib, cu]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.PIPE,
                                             text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        fn = ctypes.CDLL(lib).mlsweep_deposit_launch
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[name] = fn
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source",
                    help="the first design's csrc/mlsweep_deposit.cu (its "
                         "directory must hold the sweep_common.cuh it "
                         "includes)")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel5_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from skirt9_tpu_torch.kernels import build as kb
    from skirt9_tpu_torch.transport import mlsweep as ml
    from skirt9_tpu_torch.transport import sweep as sw

    sim, _, _ = cs.config3ism("cuda")
    tabs = sim._sweep_tabs
    B = cs.B_ML
    rs = np.random.default_rng(4)
    pos, dirn, sig, active = cs.box_rays(torch, sim, rs, B)
    g, smin, smax = sw._lane_range(tabs, pos, dirn, active)
    sub, cells = ml.sweep_dtau(tabs, pos, dirn, sig, active, want_sub=True)
    tb, tot = sw.slab_prefix(sub.sum(dim=1), dirn.gather(
        1, g.long()[:, None])[:, 0] > 0)
    lum = torch.tensor(rs.uniform(0.5, 2.0, B), dtype=torch.float32,
                       device=dirn.device) * active
    tau_int = torch.tensor(rs.uniform(size=B), dtype=torch.float32,
                           device=dirn.device) * tot
    live = int(ml._plan_substeps(tabs, pos, dirn, g, smin, smax)[3].sum())
    smi = cs.nvidia_smi_line()
    print(json.dumps({"config": "config3ism", "batch": B,
                      "n_steps": tabs.n_steps, "leaves": tabs.nd.shape[0],
                      "live_pairs": live,
                      "live_share": live / (tabs.n_steps * B),
                      "nvidia_smi": smi}), flush=True)

    ncells = tabs.nd.shape[0]
    rf = torch.zeros(ncells, dtype=torch.float64, device=dirn.device)
    first = torch.empty(B, dtype=torch.int64, device=dirn.device)
    nx, ny, nz, n_steps, *geo = ml._geometry_args(tabs)
    stream = kb.stream_of(pos)
    ptrs = [t.data_ptr() for t in (pos, dirn, g, smin, smax, sub, cells, lum,
                                   tau_int, tb, tabs.step_tlev, tabs.step_gs)]
    old_ptrs = ptrs + [rf.data_ptr(), first.data_ptr()]
    # one lane group, no bin map
    ptrs = ptrs + [None, rf.data_ptr(), first.data_ptr()]
    shared = int(ncells <= ml.SHARED_LEAVES)
    runs = [(str(kb._CSRC / "mlsweep_deposit.cu"), TILE_VARIANTS,
             kb._SIGNATURES["mlsweep_deposit_launch"],
             lambda fn, sh=shared: fn(*ptrs, B, nx, ny, nz, n_steps, ncells,
                                      1, 1, sh, *geo, 0.5, stream))]
    if args.source:
        runs.append((args.source, VARIANTS, _ARGS,
                     lambda fn: fn(*old_ptrs, B, nx, ny, nz, n_steps, *geo,
                                   0.5, stream)))
    with tempfile.TemporaryDirectory() as tmp:
        built = [(build_variants(src, variants, argtypes, tmp), call)
                 for src, variants, argtypes, call in runs]
        for fns, call in built:
            for name, fn in fns.items():
                def run(fn=fn, call=call, name=name):
                    rf.zero_()
                    first.fill_(-1)
                    err = call(fn)
                    if err:
                        raise RuntimeError(f"{name}: cudaError {err}")
                print(json.dumps({"variant": name, "ms": cs.cuda_ms(run),
                                  "device_ms": cs.device_ms(run)["ours"]}),
                      flush=True)
                if name == "tile_full":
                    glob = lambda fn=fn: call(fn, 0)
                    print(json.dumps({
                        "variant": "tile_global", "ms": cs.cuda_ms(glob),
                        "device_ms": cs.device_ms(glob)["ours"]}),
                        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
