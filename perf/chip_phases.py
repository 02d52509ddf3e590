"""Run chosen phases of chip_smoke.py alone on the card, and two probes of
its clumpy-sphere gates.

    python3 perf/chip_phases.py [sincos] [clumpy] [mesh] [dp] [fw]
                                [readings] [aimed]

Each phase named runs after the environment and build phases, caught: a
failed phase prints its traceback and a line {"phase_run": name, "ok":
false}, and the next one runs. The probes:

- `readings`: chip_smoke's clumpy_torus_small on the CPU and on the card
  at seeds 1-3 (tests/test_torch_cuda.py runs seed 0), the gaps
  `march_gaps` reads, which set MESH_BOUNDS["clumpy_torus_small"];
- `aimed`: clumpy_torus_point (the off-centre `aimed_source`, 256
  packets, one event) on the card and on the CPU: the plain march and
  the kernel's toward the 80-degree instrument, the lanes' launch cells,
  the peel-off's optical depth, and for each instrument the direct light
  against the cells' geometry (walk_tau) and the plain march
  (march_tau).

With no name it runs sincos, clumpy, mesh, dp and fw. It needs a CUDA
device.
"""

import json
import math
import os
import sys
import tempfile
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def show(**kw):
    print(json.dumps(kw, default=float), flush=True)


def readings():
    with tempfile.TemporaryDirectory() as tmp:
        for seed in (1, 2, 3):
            outs = {}
            for dev in ("cpu", "cuda"):
                sim = cs.mesh_config("clumpy_torus_small", dev, tmp)
                sim.seed = seed
                outs[dev] = sim.run_primary(verbose=False)
            show(clumpy_torus_small_seed=seed, gaps=cs.march_gaps(
                outs["cpu"], outs["cuda"], False,
                {f"sed{k}": 1.0 for k in range(8)}))


def aimed():
    from skirt9_tpu_torch.media import system as msys
    from skirt9_tpu_torch.transport import march as mr
    for dev in ("cuda", "cpu"):
        with tempfile.TemporaryDirectory() as tmp:
            sim = cs.mesh_config("clumpy_torus_point", dev, tmp,
                                 num_packets=256, batch_size=256,
                                 max_events=1)
        g, S = sim.grid, sim.options.max_steps
        k = sim._inst_tabs[1]["kobs"].reshape(1, 3).float().contiguous()
        p0 = torch.tensor([sim.sources[0].position], dtype=torch.float32,
                          device=k.device)
        c0 = g.locate(p0)
        cp, dp = mr.march_geometry_plain(g, p0, k, c0, S, c0 >= 0)
        cm, dm = mr.march_geometry(g, p0, k, c0, S, c0 >= 0)
        show(dev=dev, c0=int(c0), S=S, plain_steps=int((dp > 0).sum()),
             plain_pc=float(dp.double().sum()) / cs.PC,
             march_steps=int((dm > 0).sum()),
             march_pc=float(dm.double().sum()) / cs.PC,
             same=bool(torch.equal(cp, cm) and torch.equal(dp, dm)))
        pos, _, cell, alive = cs._first_event_lanes(torch, sim, 256)
        opt = msys.optics_at(sim.medium, torch.full((256,), 0.55e-6,
                                                    device=k.device))
        tau = mr.trace_tau(g, sim.medium, opt, pos, k.expand(256, 3), cell,
                           S, alive)
        show(dev=dev, launch_at_source=bool((pos == p0).all()),
             launch_cells=torch.unique(cell).tolist(),
             peel_tau=[float(tau.min()), float(tau.max())])
        _, accs = sim.run_primary(verbose=False)
        for i in range(len(accs)):
            sed = accs[i]["sed"].double()
            att = float(sed[1].sum() / sed[0].sum())
            show(dev=dev, inst=i, minus_log_direct=-math.log(att),
                 walk_tau=cs.walk_tau(sim, inst=i),
                 march_tau=cs.march_tau(sim, inst=i))


def main() -> int:
    smi = cs.phase_env(torch)
    cs.phase_build()
    phases = {
        "sincos": lambda: cs.phase_kernels_sincos(torch),
        "clumpy": lambda: cs.phase_kernels_march_clumpy(torch),
        "mesh": lambda: cs.phase_full_width_mesh(torch, smi, "clumpy_torus"),
        "dp": lambda: cs.phase_dp(torch, smi),
        "fw": lambda: cs.phase_full_width(torch, smi),
        "readings": readings, "aimed": aimed}
    ok = True
    for name in sys.argv[1:] or ["sincos", "clumpy", "mesh", "dp", "fw"]:
        t0 = time.perf_counter()
        try:
            phases[name]()
            good = True
        except Exception:
            traceback.print_exc()
            good = ok = False
        cs._MESH_SIMS.clear()
        torch.cuda.empty_cache()
        show(phase_run=name, ok=good, seconds=time.perf_counter() - t0)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
