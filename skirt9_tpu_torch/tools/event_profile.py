"""Host work per event of the simulation's event loop, read from torch.profiler.

`profile_run` runs a callable once under torch.profiler (CPU and CUDA
activity) and counts what the host asked of the card: device operations
(kernels, copies, sets), runtime kernel launches, `cudaStreamSynchronize`
calls and host-to-device and device-to-host copies, with the device's busy
and idle shares of the wall. `per_event` takes two runs of one
configuration that differ only in their event cap and divides the
differences by the difference in events: what each event of the loop costs,
without the per-batch set-up (launch, emission peel-off) that both runs pay.

As a script it measures the configurations of a checkout's `chip_smoke.py`
(config 1 and config 2 at full width) through that checkout's own package,
so that two trees can be compared inside one call on one card:

    python3 skirt9_tpu_torch/tools/event_profile.py --root DIR [--root DIR2 ...]

It prints one JSON line per (tree, configuration): packets/s of a timed run
after a warm-up, and the profiler's counts per event. It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# the runtime calls that launch a kernel
_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx")


def profile_run(torch, run) -> dict:
    """run() once under torch.profiler, after a device sync: its wall
    seconds, the device's busy seconds and idle share, and the counts of
    device operations, kernel launches, stream syncs and copies by
    direction; the ten device kernels that take the most time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = prof.key_averages()
    on_dev = [e for e in ev
              if e.device_type == torch.autograd.DeviceType.CUDA]
    count = lambda pred: sum(e.count for e in ev if pred(e.key))
    busy = sum(e.self_device_time_total for e in on_dev) / 1e6
    top = sorted(on_dev, key=lambda e: e.self_device_time_total,
                 reverse=True)[:10]
    return {"wall_s": wall, "busy_s": busy, "idle_share": 1.0 - busy / wall,
            "device_ops": sum(e.count for e in on_dev),
            "kernel_launches": count(lambda k: k in _LAUNCH_CALLS),
            "stream_syncs": count(lambda k: k == "cudaStreamSynchronize"),
            "h2d_copies": count(lambda k: k.startswith("Memcpy HtoD")),
            "d2h_copies": count(lambda k: k.startswith("Memcpy DtoH")),
            "top": [[e.key[:70], e.self_device_time_total / 1e3, e.count]
                    for e in top]}


_COUNTS = ("device_ops", "kernel_launches", "stream_syncs", "h2d_copies",
           "d2h_copies")


def per_event(long: dict, short: dict, events_long: int,
              events_short: int) -> dict:
    """Counts per event of the loop: the differences of two profiled runs
    that differ only in their event cap, over the difference in events."""
    d = events_long - events_short
    if d <= 0:
        raise ValueError(f"the runs differ by {d} events")
    return {k: (long[k] - short[k]) / d for k in _COUNTS}


def _events(sim) -> int:
    st = sim.last_stats
    if "segments" in st:
        return sum(seg[3] for seg in st["segments"])
    return st["events"]


def measure(torch, smoke, config: str, batch: int) -> dict:
    """Packets/s of config 1 or 2 at full width (timed after a warm-up), and
    one batch per segment profiled with the event cap at 24 and at 2."""
    build = smoke.config1 if config == "config1" else smoke.config2
    dust = config == "config2"

    def run(sim):
        if dust:
            return sim.run_with_dust_emission(verbose=False)
        return sim.run_primary(verbose=False)

    sim = build("cuda")
    run(sim)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run(sim)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    packets = sim.num_packets
    if dust:
        info = out[2]
        packets *= 1 + info["iterations"] + (1 if info["L_dust"] > 0 else 0)
    res = {"config": config, "packets_per_s": packets / dt, "seconds": dt,
           "events": _events(sim)}
    prof, events = {}, {}
    for cap in (24, 2):
        small = build("cuda", num_packets=batch, max_events=cap)
        run(small)
        prof[cap] = profile_run(torch, lambda: run(small))
        events[cap] = _events(small)
    long = prof[24]
    res.update(profiled=long, profiled_events=events[24],
               device_ops_per_event=long["device_ops"] / events[24],
               per_event=per_event(long, prof[2], events[24], events[2]))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", required=True,
                    help="checkout whose chip_smoke.py and package to run")
    ap.add_argument("--config", action="append",
                    choices=("config1", "config2"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("event_profile: no CUDA device", file=sys.stderr)
        return 2
    for root in args.root:
        root = os.path.abspath(root)
        # this tree's package and chip_smoke.py, fresh
        for name in [m for m in sys.modules
                     if m == "chip_smoke" or m.startswith("skirt9_tpu_torch")]:
            del sys.modules[name]
        sys.path.insert(0, root)
        import chip_smoke
        for config in args.config or ("config1", "config2"):
            res = measure(torch, chip_smoke, config, chip_smoke.B_FULL)
            print(json.dumps({"root": root, **res}), flush=True)
        sys.path.remove(root)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
