"""Runs a ski file on N packet-parallel ranks of the port in fresh
processes (`parallel.dp.spawn`, gloo on the CPU) and saves rank 0's RF and
accumulators; every rank checks that neither jax nor any module of the JAX
package was imported, and rank 0 that every rank holds the same RF.

    python tests/dp_runner.py SKI OUT.npz RANKS KEY=VALUE...

KEY=VALUE: num_packets, batch_size, max_events, refill_events (ints),
dust (0/1: run_with_dust_emission), iterate (0/1: one secondary
iteration).
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def rank_main(group, ski, out, kw):
    import numpy as np
    import torch
    from skirt9_tpu_torch.config.ski import load_ski
    run = {k: kw.pop(k) for k in ("refill_events", "dust", "iterate")
           if k in kw}
    sim = load_ski(ski, device="cpu", group=group, **kw)
    sim.refill_events = run.get("refill_events", 0)
    if run.get("iterate"):
        sim.iterate_secondary, sim.max_iterations = True, 1
    if run.get("dust"):
        rf, accs, info = sim.run_with_dust_emission(verbose=False)
    else:
        (rf, accs), info = sim.run_primary(verbose=False), {}
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "skirt9_tpu"))
    assert not bad, f"rank {group.rank} imported {bad[:5]}"
    if rf is not None:
        rfs = [torch.zeros_like(rf) for _ in range(group.size)]
        torch.distributed.all_gather(rfs, rf)
        assert all(torch.equal(r, rf) for r in rfs), "the ranks' RFs differ"
    if group.writes:
        payload = {f"acc{i}_{k}": v.numpy() for i, a in enumerate(accs)
                   for k, v in a.items()}
        payload.update({k: np.float64(v) for k, v in info.items()
                        if isinstance(v, float)})
        if rf is not None:
            payload["rf"] = rf.numpy()
        np.savez(out, **payload)


if __name__ == "__main__":
    from skirt9_tpu_torch.parallel import dp
    ski, out, ranks = sys.argv[1], sys.argv[2], int(sys.argv[3])
    kw = {k: int(v) for k, v in (a.split("=") for a in sys.argv[4:])}
    dp.spawn(rank_main, ranks, args=(ski, out, kw), device="cpu")
