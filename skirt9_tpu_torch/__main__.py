"""Command-line entry point: run a ski file.

Port of `skirt9_tpu/__main__.py` (ref: SKIRT/main/SkirtMain.cpp:15,
SkirtCommandLineHandler.cpp:31 flags). Usage:

    python -m skirt9_tpu_torch model.ski [more.ski ...] [-o outdir] [-s seed]
        [-p packets] [-b batch] [--max-events N] [-e] [-d N]
        [--device cuda|cpu]

The run is on the card unless `--device cpu` asks for the CPU; without a GPU
the default exits with an error. `--max-events` caps each packet's
scattering events (64 by default, the loader's default; a resonant line
such as bench6.ski's Lyman-alpha needs 128 for its escaping light). `-d N`
runs N packet-parallel ranks (`parallel/dp.py`), one process group even
at N = 1: on the card one per GPU under NCCL (N past the GPUs present
exits 2), with `--device cpu` N gloo ranks on the CPU; `-d 0` takes every
GPU (one rank on the CPU); rank 0 alone writes the output files and the
log. Without -d the run is on one device, with no process group. With an
indexed card (`--device cuda:0`) the N ranks share it over gloo. `--dd`
with `-d N`, N > 1, shards the grid's tables into N x-slabs, one per rank
(spatial domain decomposition, `parallel/domain.py`); with `-d 1` it is
inert, as in the reference, whose mesh needs two devices, and without -d
the command exits 2. Accepted for compatibility but inert: -t, -m, -v.
Not ported (the command exits non-zero and names them): --export-schema
and the no-argument ski wizard.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="skirt9_tpu_torch",
        description="Monte Carlo radiative transfer on PyTorch/CUDA (the "
                    "port of skirt9_tpu)")
    ap.add_argument("skifiles", nargs="*", help=".ski parameter files")
    ap.add_argument("-o", "--outdir", default=".", help="output directory")
    ap.add_argument("-s", "--seed", type=int, default=0, help="RNG seed")
    ap.add_argument("-p", "--packets", type=int, default=None,
                    help="override number of photon packets")
    ap.add_argument("-b", "--batch", type=int, default=16384,
                    help="packet batch size")
    ap.add_argument("--max-events", type=int, default=64,
                    help="scattering events per packet (default 64)")
    ap.add_argument("-e", "--emulate", action="store_true",
                    help="setup only, zero packets (ref: emulation mode)")
    ap.add_argument("-t", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("-m", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("-v", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("-d", "--devices", type=int, default=None,
                    help="packet data parallelism over N ranks (0 = every "
                    "GPU), even 1: one rank per GPU under NCCL, or N gloo "
                    "ranks with --device cpu; rank 0 writes the files "
                    "(without -d: one device, no process group)")
    ap.add_argument("--export-schema", metavar="FILE", default=None,
                    help="not ported")
    ap.add_argument("--dd", action="store_true",
                    help="spatial domain decomposition over the -d N ranks "
                    "(N > 1): the grid's tables in one x-slab per rank")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu asks "
                    "for the CPU)")
    args = ap.parse_args(argv)

    missing = []
    if args.export_schema:
        missing.append("--export-schema (the SMILE schema export)")
    if not args.skifiles:
        missing.append("the no-argument ski wizard")
    if missing:
        print(f"skirt9_tpu_torch: not ported yet: {'; '.join(missing)}",
              file=sys.stderr)
        return 2
    if args.dd and args.devices is None:
        print("skirt9_tpu_torch: -d/--dd: spatial domain decomposition runs "
              "over the ranks of -d N (N > 1)", file=sys.stderr)
        return 2

    from . import device as dv

    try:
        device = dv.resolve(args.device)
    except RuntimeError as err:
        print(f"skirt9_tpu_torch: {err}", file=sys.stderr)
        return 2
    os.makedirs(args.outdir, exist_ok=True)
    if args.devices is None:
        _run(args, device)
        return 0
    import torch
    backend = None
    if device.type == "cuda" and device.index is not None:
        # ranks sharing one card: gloo (NCCL refuses two ranks on one card)
        n, backend = max(args.devices, 1), "gloo"
        from .kernels import build as kb
        kb.build()
    elif device.type == "cuda":
        n = torch.cuda.device_count() if args.devices == 0 else args.devices
        if n > torch.cuda.device_count() or n < 1:
            print(f"skirt9_tpu_torch: -d {args.devices} needs {n} GPUs, "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        # build the kernels once, before the ranks load them
        from .kernels import build as kb
        kb.build()
    else:
        n = 1 if args.devices == 0 else args.devices
        if n < 1:
            print(f"skirt9_tpu_torch: -d {args.devices}", file=sys.stderr)
            return 2
    from .parallel import dp
    # the ranks import this module by its package name (run as __main__,
    # its functions do not pickle)
    from . import __main__ as cli
    dp.spawn(cli._rank, n, args=(args,),
             device=str(device) if backend else device.type, backend=backend)
    return 0


def _rank(group, args) -> None:
    _run(args, group.device, group)


def _run(args, device, group=None) -> None:
    """Every ski file of the command line on device, as one rank of group
    (None: alone); only a rank that writes keeps the log file and writes
    the outputs."""
    from .config.ski import load_ski
    from .probes.probes import run_probe_system
    from .utils import log as logmod

    writes = group is None or group.writes
    for ski in args.skifiles:
        prefix = os.path.splitext(os.path.basename(ski))[0]
        # file log next to the outputs (ref: FileLog; <prefix>_log.txt)
        log = logmod.configure(prefix, args.outdir if writes else None)
        dd = args.dd and group is not None and group.size > 1
        if group is not None:
            what = ("spatial domain decomposition" if dd
                    else "packet data parallelism")
            log.info(f"{what}: rank {group.rank} of {group.size} on "
                     f"{group.device} ({group.backend})")
        t0 = time.perf_counter()
        log.info(f"Constructing a simulation from ski file {ski}...")
        with log.timed("setup"):
            sim = load_ski(ski, num_packets=args.packets,
                           batch_size=args.batch, seed=args.seed,
                           max_events=args.max_events, device=device,
                           group=group, dd=dd)
        if args.emulate:
            log.success(f"emulation: setup OK, {sim.grid.ncells} cells, "
                        f"{len(sim.sources)} sources, "
                        f"{len(sim.instruments)} instruments")
            continue
        probe_paths = (run_probe_system(sim, "Setup", prefix, args.outdir)
                       if writes else [])
        with log.timed(f"simulation {prefix}"):
            if sim.ems_borders is not None:
                rf, accs, _ = sim.run_with_dust_emission()
            else:
                rf, accs = sim.run_primary()
        paths = []
        if writes:
            with log.timed("final output"):
                paths = sim.write_outputs(accs, prefix, args.outdir)
                paths += run_probe_system(sim, "Run", prefix, args.outdir,
                                          rf=rf)
                paths += probe_paths
        log.success(f"finished {ski} in {time.perf_counter() - t0:.1f} s")
        for p in paths:
            log.info(f"  wrote {p}")
        log.memory()


if __name__ == "__main__":
    sys.exit(main())
