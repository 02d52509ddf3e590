"""Time the port's CPU runs (the plain versions, as chip_smoke.py's
draw-for-draw phases run them beside the card) at several torch thread
counts, on the machine that runs it.

    python3 perf/cpu_threads.py [THREADS ...]      # default 1 2 4 8

Config 1 at 32^3 (chip_smoke.config1, 2^14 packets in one batch) on the
resident sweep's plain versions and on the scan march, each timed after a
warm-up run; then the SPH galaxy's set-up on the CPU
(chip_smoke.snapshot_config("sph_galaxy"): 10^5 gas particles on a
maxLevel-8 octree, 2x10^4 star particles). One JSON line per thread
count with the seconds and the machine's CPU count.
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def main() -> int:
    counts = [int(a) for a in sys.argv[1:]] or [1, 2, 4, 8]
    for n in counts:
        torch.set_num_threads(n)
        sim = cs.config1("cpu", num_packets=1 << 14, batch_size=1 << 14)
        sim.run_primary(verbose=False)
        sweep = timed(lambda: sim.run_primary(verbose=False))
        sim._sweep_tabs = None
        march = timed(lambda: sim.run_primary(verbose=False))
        with tempfile.TemporaryDirectory() as tmp:
            setup = timed(lambda: cs.snapshot_config("sph_galaxy", "cpu",
                                                     tmp))
        print(json.dumps({"threads": n, "cpus": os.cpu_count(),
                          "config1_sweep_s": sweep, "config1_march_s": march,
                          "sph_setup_s": setup}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
