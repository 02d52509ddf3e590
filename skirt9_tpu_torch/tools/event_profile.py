"""Host work per event of the simulation's event loop, read from torch.profiler.

`profile_run` runs a callable once under torch.profiler (CPU and CUDA
activity) and counts what the host asked of the card: device operations
(kernels, copies, sets), runtime kernel launches,
`cudaStreamSynchronize` calls and host-to-device and device-to-host copies,
with the device's busy and idle shares of the wall. It counts them for the
whole run and, apart, for the work the host issued inside the event loop's
profiler range (`lifecycle.EVENT_LOOP_RANGE`): a device operation belongs to
the loop when the runtime call that issued it started inside the range. So
the loop's counts leave out the batch's set-up (launch, emission peel-off)
without differencing two runs.

As a script it measures the configurations of a checkout's `chip_smoke.py`
through that checkout's own package, so that two trees can be compared
inside one call on one card: config 1 and config 2 at full width (the
resident loop), `config3ism` and `config3ism_rf` (bench_config3ism without
and with a one-bin RF: the tree loop with pass 2 in torch ops or in its
kernel), `config1x256` (bench_config1x256: the XL loop) and `config1h`
(bench1h.ski through the ski loader: the resident loop in lane-refill
generations; a checkout from before the loader has no such
configuration) and `config3` (bench3.ski through the ski loader: the tree
loop with a 25-bin RF in 32 lane groups and dust self-absorption
iterations; a checkout from before config 3 has none), `config2x256`
(bench2.ski at 256^3: the XL loop with the 25-bin RF in 32 lane groups)
and `config3ismxl9` (bench_config3ismxl's recipe at max_level 9: the XL
loop on a tree's 512^3 voxel raster); a checkout from before them has
neither:

    python3 skirt9_tpu_torch/tools/event_profile.py --root DIR [--root DIR2 ...]
        [--config NAME ...]

It prints one JSON line per (tree, configuration): packets/s of a timed run
after a warm-up, and the profiler's counts of one batch with the
configuration's own event cap, per event of the loop and of the whole run.
A tree from before the loop had its range counts nothing in the loop; its
whole-run counts compare. It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

# the runtime calls that launch a kernel
_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx")
# lifecycle.EVENT_LOOP_RANGE, kept here so that the script reads older trees
_LOOP_RANGE = "life_cycle.events"
_COUNTS = ("device_ops", "kernel_launches", "stream_syncs", "h2d_copies",
           "d2h_copies")


def profile_run(torch, run) -> dict:
    """run() once under torch.profiler, after a device sync: its wall
    seconds, the device's busy seconds and idle share, the counts of device
    operations, kernel launches, stream syncs and copies by direction for
    the whole run (`whole`) and inside the event loop's range (`loop`,
    with `loop_ranges` ranges), the device operations whose runtime call
    the profile lacks (`unattributed`), and the ten device kernels that
    take the most time."""
    from torch.profiler import ProfilerActivity, profile
    cpu = torch.autograd.DeviceType.CPU
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = list(prof.events())
    ranges = [(e.time_range.start, e.time_range.end) for e in events
              if e.device_type == cpu and e.name == _LOOP_RANGE]
    in_loop = lambda t: any(a <= t <= b for a, b in ranges)
    # CPU-side runtime and driver calls, by the correlation id that their
    # device operations carry
    runtime = {e.id: e for e in events if e.device_type == cpu
               and e.name.startswith("cu") and "::" not in e.name
               and "(" not in e.name}
    device = [e for e in events if e.device_type != cpu
              and e.name != _LOOP_RANGE
              and not getattr(e, "is_user_annotation", False)]
    whole = dict.fromkeys(_COUNTS, 0)
    loop = dict.fromkeys(_COUNTS, 0)
    unattributed = 0
    for e in device:
        call = runtime.get(e.id)
        unattributed += call is None
        for counts, on in ((whole, True),
                           (loop, call and in_loop(call.time_range.start))):
            if on:
                counts["device_ops"] += 1
                counts["h2d_copies"] += e.name.startswith("Memcpy HtoD")
                counts["d2h_copies"] += e.name.startswith("Memcpy DtoH")
    for e in runtime.values():
        key = ("kernel_launches" if e.name in _LAUNCH_CALLS else
               "stream_syncs" if e.name == "cudaStreamSynchronize" else None)
        if key:
            whole[key] += 1
            loop[key] += in_loop(e.time_range.start)
    busy_by = collections.defaultdict(lambda: [0.0, 0])
    for e in device:
        busy_by[e.name][0] += e.time_range.end - e.time_range.start
        busy_by[e.name][1] += 1
    busy = sum(t for t, _ in busy_by.values()) / 1e6
    top = sorted(busy_by.items(), key=lambda kv: kv[1][0], reverse=True)[:10]
    return {"wall_s": wall, "busy_s": busy, "idle_share": 1.0 - busy / wall,
            "whole": whole, "loop": loop, "loop_ranges": len(ranges),
            "unattributed": unattributed,
            "top": [[k[:70], t / 1e3, n] for k, (t, n) in top]}


def per_event(prof: dict, events: int) -> dict:
    """The counts of a profiled run per event: the loop's, and the whole
    run's (set-up included; the only ones of a tree without the range)."""
    if events <= 0:
        raise ValueError(f"the run made {events} events")
    return {part: {k: prof[part][k] / events for k in _COUNTS}
            for part in ("loop", "whole")}


def _events(sim) -> int:
    st = sim.last_stats
    if "segments" in st:
        return sum(seg[3] for seg in st["segments"])
    return st["events"]


# configuration -> (how a checkout's chip_smoke builds it, its batch, whether
# it runs dust emission)
CONFIGS = {
    "config1": (lambda cs, dev, **kw: cs.config1(dev, **kw), "B_FULL", False),
    "config2": (lambda cs, dev, **kw: cs.config2(dev, **kw), "B_FULL", True),
    "config3ism": (lambda cs, dev, **kw: cs.config3ism(dev, **kw)[0], "B_ML",
                   False),
    "config3ism_rf": (lambda cs, dev, **kw: cs.config3ism(
        dev, store_rf=True, **kw)[0], "B_ML", False),
    "config1x256": (lambda cs, dev, **kw: cs.config1(
        dev, n=256, **{"num_packets": cs.B_FULL, **kw}), "B_FULL", False),
    "config1h": (lambda cs, dev, **kw: cs.config1h(dev, **kw), "B_FULL",
                 False),
    "config3": (lambda cs, dev, **kw: cs.config3(dev, **kw), "B_B3", True),
    "config2x256": (lambda cs, dev, **kw: cs.config2x256(dev, **kw),
                    "B_FULL", True),
    "config3ismxl9": (lambda cs, dev, **kw: cs.config3ism(
        dev, "config3ismxl9", **kw)[0], "B_ML", False),
}


def measure(torch, smoke, config: str) -> dict:
    """Packets/s of a configuration at full width (timed after a warm-up),
    and one batch profiled with the configuration's event cap."""
    build, batch_name, dust = CONFIGS[config]
    batch = getattr(smoke, batch_name)

    def run(sim):
        if dust:
            return sim.run_with_dust_emission(verbose=False)
        return sim.run_primary(verbose=False)

    sim = build(smoke, "cuda")
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
           "events": _events(sim), "engine": type(sim._sweep_tabs).__name__}
    small = build(smoke, "cuda", num_packets=batch, batch_size=batch)
    run(small)
    prof = profile_run(torch, lambda: run(small))
    events = _events(small)
    res.update(profiled=prof, profiled_events=events,
               per_event=per_event(prof, events))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", required=True,
                    help="checkout whose chip_smoke.py and package to run")
    ap.add_argument("--config", action="append", choices=tuple(CONFIGS))
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
        for config in args.config or tuple(CONFIGS):
            res = measure(torch, chip_smoke, config)
            print(json.dumps({"root": root, **res}), flush=True)
        sys.path.remove(root)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
