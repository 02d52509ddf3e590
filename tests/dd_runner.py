"""Runs the port's spatial domain decomposition cases on N ranks in fresh
processes (`parallel.dp.spawn`, gloo on the CPU, one torch thread a rank)
and saves rank 0's results, one .npz a case, in OUTDIR; every rank checks
that neither jax nor any module of the JAX package was imported, and rank
0 that every rank holds the same RF after each run.

    python tests/dd_runner.py OUTDIR RANKS CASE[:ARG]...

Cases (the problems of tests/test_domain.py, built with the port's own
builders):
  event1 / event1c2   `dd_segment`, one event, one and two components
  events4             four events
  xl_c1 / xl_c2       `dd_segment` on the XL route (`build_local_xl`), four
                      events of 1,024 histories, one and two components
  march_c1 / march_c2 the same on the march route
  meshed              a meshed Cartesian grid, three events
  ski:PATH            `load_ski(PATH, dd=True)` with dust emission and one
                      secondary iteration where the ski file has it
  skixl:PATH          the same with SKIRT9_TPU_FORCE_SWEEP=1: the XL route
  refuse:PATH         the NotImplementedError of `run_primary`
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PC = 3.0857e16
# the ski cases' run (packets, batch, events)
SKI_RUN = dict(num_packets=2048, batch_size=2048, max_events=4)


def problem(ncomp=1, nrf=1, meshed=False):
    """tests/test_domain.py's `_problem` (and its meshed grid) with the
    port's builders: (grid, medium, source, instrument, RF borders)."""
    import numpy as np
    from skirt9_tpu_torch.grids.cartesian import make_cartesian
    from skirt9_tpu_torch.instruments import distant as dinst
    from skirt9_tpu_torch.media import system as msys
    from skirt9_tpu_torch.sources import base as src
    sigma = 1e-24
    if meshed:
        xb = np.concatenate([[-PC], -PC + 2 * PC * np.geomspace(0.05, 1.0,
                                                                 16)])
        grid = make_cartesian(((-PC, PC),) * 3, (16, 8, 8),
                              meshes=(xb, None, None))
        r = np.linalg.norm(grid.cell_centers().double().numpy(), axis=-1)
        nd = np.where(r < 0.8 * PC, 1.0 / (sigma * 0.8 * PC), 0.0)
        med = msys.make_medium(grid, nd.astype(np.float32),
                               np.array([0.4e-6, 0.7e-6]),
                               np.array([[sigma, sigma]]),
                               np.full((1, 2), 0.5), np.full((1, 2), 0.3))
        inst = dinst.DistantInstrumentCfg(name="i",
                                          wave_borders=(0.5e-6, 0.6e-6),
                                          distance=100 * PC)
        source = src.PointSource(luminosity=1.0, lam0=0.55e-6)
        return grid, med, source, inst, np.array([0.5e-6, 0.6e-6])
    box = 1.2 * PC
    grid = make_cartesian(((-box, box),) * 3, (16,) * 3)
    nd = msys.uniform_density_sphere(grid, 1.0, sigma, PC)
    lam_t = np.array([0.4e-6, 0.7e-6])
    if ncomp == 1:
        med = msys.make_medium(grid, nd, lam_t,
                               sigma_ext=np.array([[sigma, sigma]]),
                               albedo=np.full((1, 2), 0.6),
                               g=np.full((1, 2), 0.5))
    else:
        nd2 = np.stack([nd, 0.5 * nd[::-1]], axis=1)
        med = msys.make_medium(grid, nd2, lam_t,
                               sigma_ext=np.array([[sigma, sigma],
                                                   [0.5 * sigma, 2 * sigma]]),
                               albedo=np.array([[0.6, 0.6], [0.3, 0.3]]),
                               g=np.array([[0.5, 0.5], [-0.2, -0.2]]))
    inst = dinst.DistantInstrumentCfg(
        name="i0", wave_borders=tuple(np.linspace(0.5e-6, 0.6e-6, nrf + 1)),
        distance=100 * PC, npx=8, npy=8, fovx=4 * PC, fovy=4 * PC)
    source = src.PointSource(position=(0.3 * PC, 0.1 * PC, -0.2 * PC),
                             luminosity=1.0, lam0=0.55e-6)
    return grid, med, source, inst, np.linspace(0.5e-6, 0.6e-6, nrf + 1)


def same_on_every_rank(group, t, what: str) -> None:
    import torch
    got = group.all_gather([t[None]])[0]
    assert all(torch.equal(g, t) for g in got), f"the ranks' {what} differ"


def segment(group, events: int, N: int, xl: bool = False, **kw) -> dict:
    """One `dd_segment` batch of N histories over the ranks (the
    reference's `_run_decomposed`), on the XL route with xl: the RF
    gathered from the slabs, the accumulators summed."""
    import numpy as np
    import torch
    from skirt9_tpu_torch.instruments import distant as dinst
    from skirt9_tpu_torch.ops import rng
    from skirt9_tpu_torch.parallel import domain as dom
    from skirt9_tpu_torch.transport import lifecycle as lc
    grid, med, source, inst, rfb = problem(**kw)
    D, r = group.size, group.rank
    opts = lc.TransportOptions(max_steps=grid.max_steps(), max_events=events,
                               rf_scale=1.0)
    dec = dom.decompose_slabs(grid, D)
    nd_local, rf_local = dom.shard_tables(dec, med, len(rfb) - 1, r)
    accs = [dinst.init_accumulators(inst, "cpu")]
    run = dom.dd_segment(group, dec, grid, nd_local, med, opts, (inst,),
                         [dinst.device_tables(inst, "cpu")],
                         torch.tensor(rfb.astype(np.float32)), source, N,
                         xl_local=dom.build_local_xl(dec, med) if xl
                         else None)
    Bd = N // D
    run(rng.seed_key(0, "cpu"), torch.arange(r * Bd, (r + 1) * Bd),
        source.tables("cpu"), rf_local, accs)
    group.all_reduce(list(accs[0].values()))
    rf = group.all_gather([rf_local])[0]
    same_on_every_rank(group, rf, "RFs")
    out = {f"acc0_{k}": v.numpy() for k, v in accs[0].items()}
    out["rf"] = rf.numpy()
    out["host_trips"] = np.int64(group.host_trips)
    return out


def ski_run(group, path: str) -> dict:
    import numpy as np
    from skirt9_tpu_torch.config.ski import load_ski
    sim = load_ski(path, device="cpu", group=group, dd=True, **SKI_RUN)
    out = {}
    if sim.ems_borders is not None:
        sim.iterate_secondary, sim.max_iterations = True, 1
        rf, accs, info = sim.run_with_dust_emission(verbose=False)
        out.update({k: np.float64(v) for k, v in info.items()
                    if isinstance(v, float)})
    else:
        rf, accs = sim.run_primary(verbose=False)
    if rf is not None:
        same_on_every_rank(group, rf, "RFs")
        out["rf"] = rf.numpy()
    out["xl_route"] = np.bool_("xl_local" in sim._dd_state)
    out.update({f"acc0_{k}": v.numpy() for k, v in accs[0].items()})
    if group.writes:
        prefix = os.path.splitext(os.path.basename(path))[0]
        sim.write_outputs(accs, prefix + "_api", os.path.dirname(path))
    return out


def refuse(group, path: str) -> dict:
    import numpy as np
    from skirt9_tpu_torch.config.ski import load_ski
    sim = load_ski(path, device="cpu", group=group, dd=True,
                   num_packets=256, batch_size=256, max_events=2)
    try:
        sim.run_primary(verbose=False)
    except NotImplementedError as err:
        return {"message": np.array(str(err))}
    raise AssertionError("the run outside the envelope did not raise")


def rank_main(group, outdir, cases):
    import numpy as np
    import torch
    torch.set_num_threads(1)
    for case in cases:
        name, _, arg = case.partition(":")
        if name == "event1":
            out = segment(group, 1, 1024)
        elif name == "event1c2":
            out = segment(group, 1, 1024, ncomp=2)
        elif name == "events4":
            out = segment(group, 4, 2048)
        elif name in ("xl_c1", "xl_c2", "march_c1", "march_c2"):
            out = segment(group, 4, 1024, xl=name.startswith("xl"),
                          ncomp=int(name[-1]))
        elif name == "meshed":
            out = segment(group, 3, 1024, meshed=True)
        elif name in ("ski", "skixl"):
            if name == "skixl":
                os.environ["SKIRT9_TPU_FORCE_SWEEP"] = "1"
            out = ski_run(group, arg)
            os.environ.pop("SKIRT9_TPU_FORCE_SWEEP", None)
            name += "_" + os.path.splitext(os.path.basename(arg))[0]
        elif name == "refuse":
            out = refuse(group, arg)
            name = "refuse_" + os.path.splitext(os.path.basename(arg))[0]
        else:
            raise ValueError(f"unknown case {case}")
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "skirt9_tpu"))
        assert not bad, f"rank {group.rank} imported {bad[:5]}"
        if group.writes:
            np.savez(os.path.join(outdir, name + ".npz"), **out)


if __name__ == "__main__":
    from skirt9_tpu_torch.parallel import dp
    outdir, ranks = sys.argv[1], int(sys.argv[2])
    dp.spawn(rank_main, ranks, args=(outdir, sys.argv[3:]), device="cpu")
