"""Run-to-run spread of the CLI's outputs, detect's sums on fixed inputs,
and the event loops' packets/s with and without the XLA-math kernels.

    python3 perf/spread_and_speed.py cli [--runs 4] [--rounds 2]
    python3 perf/spread_and_speed.py detect [--calls 200]
    python3 perf/spread_and_speed.py speed [--variants] [--reps 3]

Every mode imports `skirt9_tpu_torch` and `chip_smoke` from the current
directory, so the same script measures another checkout of the repository
when run from its root (`cd <tree> && python3 <this file> ...`). Each
prints one JSON line per reading. It needs a CUDA device.

- `cli`: bench1.ski (2^18 packets) through the CLI, `--runs` processes at
  once (as chip_smoke's `dp` phase starts its three), `--rounds` times;
  every run's SED and frame against the first run's: the largest gap per
  SED column and over the frame, relative to each maximum, and how many
  runs differ from the first at all.
- `detect`: `instruments/distant.detect` on one fixed batch (2^17 lanes,
  one wavelength bin, a frame; contributions spread over six decades, as a
  scattering peel-off's are), `--calls` times, each into fresh
  accumulators: how many distinct SED values and frames the calls give.
- `speed`: config 1 (32^3, 2^20 packets), config 6 (bench6, 2^17 packets,
  128 events) and the 3D sphere's march (spiral_sphere3d, 2^19 packets,
  its RF stored) after a one-batch warm-up each, `--reps` timed runs of
  the same object: packets/s of each run and their median, events, and
  the launches of the interaction-depth and deposit-factor kernels. With
  `--variants` the runs of each configuration take turns between three
  variants in one process: as shipped (`kernels`), the plain versions of
  those two kernels (`plain_xla`: `lifecycle.
  sample_interaction_tau_plain`, `march.deposit_factor_plain`, PyTorch
  operations on the card) in their place, and PyTorch's log and exp in
  `media.system.optics_at` (`torch_optics`: the interpolation before
  XLA's arithmetic was replayed there).
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402


def show(**kw):
    print(json.dumps(kw, default=float), flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()


def cli(runs: int, rounds: int) -> None:
    from skirt9_tpu_torch.utils import fits
    golden = os.path.join("tests", "golden", "bench1.ski")
    files = []
    with tempfile.TemporaryDirectory() as tmp:
        for r in range(rounds):
            procs = []
            t0 = time.perf_counter()
            for k in range(runs):
                out = os.path.join(tmp, f"r{r}_{k}")
                procs.append((out, subprocess.Popen(
                    [sys.executable, "-m", "skirt9_tpu_torch", golden, "-o",
                     out, "-p", str(1 << 18)], stdout=subprocess.DEVNULL,
                    stderr=subprocess.PIPE, text=True)))
            for out, proc in procs:
                _, err = proc.communicate(timeout=600)
                if proc.returncode != 0:
                    raise SystemExit(f"the CLI failed: {err[-800:]}")
                stem = os.path.join(out, "bench1_i0")
                files.append({"sed": np.loadtxt(stem + "_sed.dat",
                                                ndmin=2),
                              "frame": fits.read_fits(stem
                                                      + "_total.fits")[0]})
            show(round=r, runs=runs, seconds=time.perf_counter() - t0)
    ref = files[0]
    m = np.abs(ref["sed"]).max(axis=0).clip(1e-300)
    gaps = []
    for f in files[1:]:
        gaps.append({
            "sed": float((np.abs(f["sed"] - ref["sed"]).max(axis=0)
                          / m).max()),
            "sed_columns": [float(g) for g in np.abs(f["sed"] - ref["sed"])
                            .max(axis=0) / m],
            "frame": float(np.abs(f["frame"] - ref["frame"]).max()
                           / np.abs(ref["frame"]).max())})
    show(mode="cli", tree=os.getcwd(), runs=len(files),
         sed_differs=sum(g["sed"] > 0 for g in gaps),
         frame_differs=sum(g["frame"] > 0 for g in gaps),
         max_sed_gap=max(g["sed"] for g in gaps),
         max_frame_gap=max(g["frame"] for g in gaps), gaps=gaps,
         nvidia_smi=smi())


def detect(calls: int) -> None:
    from skirt9_tpu_torch.instruments import distant as dinst
    pc = 3.0857e16
    cfg = dinst.DistantInstrumentCfg(
        name="i", wave_borders=(0.5e-6, 0.6e-6), distance=100 * pc, npx=64,
        npy=64, fovx=4 * pc, fovy=4 * pc, stats_scale=1e-3)
    rs = np.random.default_rng(0)
    B = 1 << 17
    t32 = lambda a: torch.tensor(np.asarray(a, np.float32), device="cuda")
    lam = t32(np.full(B, 0.55e-6))
    pos = t32(rs.normal(0, 0.5 * pc, (B, 3)))
    contrib = t32(10.0 ** rs.uniform(-9, -3, B))
    active = torch.ones(B, dtype=torch.bool, device="cuda")
    tabs = dinst.device_tables(cfg, "cuda")
    seds, frames = set(), set()
    for _ in range(calls):
        acc = dinst.init_accumulators(cfg, "cuda")
        dinst.detect(cfg, tabs, acc, lam, pos, contrib,
                     dinst.KIND_PRIMARY_SCATTERED, active)
        seds.add(acc["sed"].cpu().numpy().tobytes())
        frames.add(acc["frame"].cpu().numpy().tobytes())
    exact = float(contrib.double().sum())
    show(mode="detect", tree=os.getcwd(), calls=calls,
         distinct_seds=len(seds), distinct_frames=len(frames),
         sed_rel_to_f64=float(acc["sed"][dinst.KIND_PRIMARY_SCATTERED, 0])
         / exact - 1, nvidia_smi=smi())


def _torch_optics(med, lam):
    """optics_at with PyTorch's log and exp (the interpolation before XLA's
    arithmetic was replayed in it)."""
    from skirt9_tpu_torch.media import system as msys
    from skirt9_tpu_torch.ops import sampling
    se, ss, gg = [], [], []
    for h in range(med.ncomp):
        se.append(sampling.interp_loglog(lam, med.lam_t, med.sigma_ext[h]))
        ss.append(sampling.interp_loglog(lam, med.lam_t, med.sigma_sca[h]))
        gg.append(sampling.interp_linlin(lam, med.lam_t, med.g[h]))
    return msys.Optics(sigma_ext=torch.stack(se, dim=1),
                       sigma_sca=torch.stack(ss, dim=1),
                       g=torch.stack(gg, dim=1))


def speed(variants: bool, reps: int) -> None:
    import chip_smoke as cs
    from skirt9_tpu_torch.kernels import build as kb
    from skirt9_tpu_torch.media import system as msys
    from skirt9_tpu_torch.transport import lifecycle as lc
    from skirt9_tpu_torch.transport import march as mr
    shipped = (lc.sample_interaction_tau, getattr(mr, "deposit_factor", None),
               msys.optics_at)

    def use(variant):
        lc.sample_interaction_tau, mr.deposit_factor, msys.optics_at = \
            shipped
        if variant == "plain_xla":
            lc.sample_interaction_tau = lc.sample_interaction_tau_plain
            mr.deposit_factor = mr.deposit_factor_plain
        elif variant == "torch_optics":
            msys.optics_at = _torch_optics
    names = ("kernels", "plain_xla", "torch_optics") if variants else (
        "kernels",)
    torch.set_num_threads(min(4, torch.get_num_threads()))
    with tempfile.TemporaryDirectory() as tmp:
        builds = {"config1": lambda: cs.config1("cuda"),
                  "config6": lambda: cs.config6("cuda"),
                  "spiral_sphere3d": lambda: cs.mesh_config(
                      "spiral_sphere3d", "cuda", tmp)}
        for name, build in builds.items():
            sim = build()
            cs.one_batch(sim, sim.run_primary)          # warm-up
            rates = {v: [] for v in names}
            launches = {}
            for _ in range(reps):
                for v in names:
                    use(v)
                    torch.cuda.synchronize()
                    kb.reset_launches()
                    t0 = time.perf_counter()
                    sim.run_primary(verbose=False)
                    torch.cuda.synchronize()
                    rates[v].append(sim.num_packets
                                    / (time.perf_counter() - t0))
                    launches[v] = {k: kb.LAUNCHES.get(k, 0) for k in (
                        "interaction_depth", "deposit_factor")}
            use("kernels")
            for v in names:
                show(mode="speed", tree=os.getcwd(), config=name, variant=v,
                     packets=sim.num_packets, packets_per_s=rates[v],
                     median=float(np.median(rates[v])),
                     events=sim.last_stats.get("events"),
                     launches=launches[v], nvidia_smi=smi())
            del sim
            torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("cli", "detect", "speed"))
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("spread_and_speed: no CUDA device", file=sys.stderr)
        return 2
    if a.mode == "cli":
        cli(a.runs, a.rounds)
    elif a.mode == "detect":
        detect(a.calls)
    else:
        speed(a.variants, a.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
