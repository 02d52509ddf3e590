"""Packet data parallelism over torch.distributed.

Port of the reference's packet data parallelism (`skirt9_tpu/simulation.py:
119-128`, the `mesh` of every flow): the histories of a segment shard over
D ranks, one process each, every rank holding the whole grid and medium;
each rank runs its own lanes into partial accumulators that start from
zero, and one all_reduce(SUM) per segment joins the radiation field and
every instrument accumulator, so that after it every rank holds the same
RF (the reference's per-segment cross-device sum, `:652-667`; the
original's MPI_Allreduce, MediumSystem.cpp:1304). The lane layout is the
reference's: `Simulation._run_segment` rounds the batch to D 128-lane
blocks (D 1024 R_g with bin-pure strata), rank r takes the r-th block of
each batch (its own R_g groups), and a refilled segment gives each rank
its own contiguous history range.

A `Group` is one rank's view: its rank, the world size, its device and
the process group; a group of one rank needs no process group (its
collectives copy). On the card the backend is NCCL, rank r on `cuda:r`;
on the CPU it is gloo. Several ranks may share one card over gloo (NCCL
refuses two ranks on one device); gloo's collectives then run on host
copies of their tensors, copied back after each, by design: the
simulation itself never leaves the card. That host round trip is the
one-card route's cost: once per segment for packet data parallelism, and
for spatial domain decomposition (`parallel/domain.py`, whose all_gather
and all_to_all serve every event) four or more per event, counted in
`Group.host_trips`. Under NCCL every collective runs on the device. The
store is TCP on 127.0.0.1. A failed set-up or collective raises; nothing
falls back to one device.

`spawn` starts the ranks (`python -m skirt9_tpu_torch -d N`); only rank 0
writes files.
"""

from __future__ import annotations

import dataclasses
import datetime
import socket

import torch
import torch.distributed as dist

# how long a rank waits for the others at set-up and in a collective
TIMEOUT = datetime.timedelta(seconds=600)


@dataclasses.dataclass
class Group:
    """One rank of a packet-parallel run."""

    rank: int
    size: int
    device: torch.device
    backend: str
    # collectives that went through a host copy
    host_trips: int = 0

    @property
    def writes(self) -> bool:
        """Whether this rank writes the run's files (rank 0 only)."""
        return self.rank == 0

    def _buffer(self, flat: torch.Tensor):
        """The collective's buffer: flat itself, or its host copy under
        gloo with a CUDA tensor (one copy each way, counted)."""
        if self.backend == "gloo" and flat.device.type == "cuda":
            self.host_trips += 1
            return flat.cpu()
        return flat

    def all_reduce(self, tensors) -> None:
        """Sum the tensors over the ranks, in place: flattened into one
        buffer of each dtype and device, one collective a buffer (one per
        segment where the partials share a dtype), on the device under
        NCCL, on a host copy under gloo with CUDA tensors."""
        if self.size == 1:
            return
        groups: dict = {}
        for t in tensors:
            groups.setdefault((t.dtype, t.device), []).append(t)
        for ts in groups.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            buf = self._buffer(flat)
            dist.all_reduce(buf, op=dist.ReduceOp.SUM)
            if buf is not flat:
                flat.copy_(buf)
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(part.view(t.shape))

    def all_gather(self, tensors) -> list:
        """Every rank's copy of each tensor, concatenated along dim 0 in
        rank order ((D B, ...) from (B, ...), the reference's tiled
        all_gather): one collective for the tensors of each dtype and
        device, packed into one buffer."""
        if self.size == 1:
            return [t.clone() for t in tensors]
        out: list = [None] * len(tensors)
        groups: dict = {}
        for i, t in enumerate(tensors):
            groups.setdefault((t.dtype, t.device), []).append(i)
        for (_, dev), idx in groups.items():
            ts = [tensors[i] for i in idx]
            flat = torch.cat([t.reshape(-1) for t in ts])
            buf = self._buffer(flat)
            got = buf.new_empty((self.size, buf.numel()))
            if self.backend == "nccl":
                dist.all_gather_into_tensor(got, buf)
            else:
                dist.all_gather(list(got.unbind(0)), buf)
            got = got.to(dev)
            for i, t, part in zip(idx, ts, got.split(
                    [t.numel() for t in ts], dim=1)):
                out[i] = part.reshape((self.size * t.shape[0],)
                                      + tuple(t.shape[1:]))
        return out

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Split t (D k, ...) along dim 0 into D blocks, send block j to
        rank j, and return the blocks received, concatenated along dim 0 in
        rank order (the reference's all_to_all with split and concat axis
        0)."""
        if t.shape[0] % self.size:
            raise ValueError(f"all_to_all of {t.shape[0]} rows over "
                             f"{self.size} ranks")
        if self.size == 1:
            return t.clone()
        flat = t.contiguous()
        buf = self._buffer(flat)
        got = torch.empty_like(buf)
        dist.all_to_all_single(got, buf)
        return got.to(t.device)

    def barrier(self) -> None:
        dist.barrier()

    def close(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()


def free_port() -> int:
    """A free TCP port on 127.0.0.1 (the store's address)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init(rank: int, size: int, port: int, device="cuda",
         backend: str | None = None) -> Group:
    """Join the process group of `size` ranks as `rank`, through a TCP store
    on 127.0.0.1:port. device "cuda" puts rank r on cuda:r under NCCL; an
    explicit "cuda:i" with backend "gloo" lets ranks share card i; "cpu"
    runs gloo on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("packet data parallelism on the card needs "
                               "CUDA")
        if dev.index is None:
            if size > torch.cuda.device_count():
                raise RuntimeError(
                    f"{size} ranks need {size} GPUs, found "
                    f"{torch.cuda.device_count()}")
            dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        backend = backend or "nccl"
    elif dev.type == "cpu":
        backend = backend or "gloo"
    else:
        raise ValueError(f"unsupported device {dev}")
    if backend not in ("nccl", "gloo") or (backend == "nccl"
                                            and dev.type != "cuda"):
        raise ValueError(f"backend {backend} on {dev}")
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=size, timeout=TIMEOUT)
    return Group(rank=rank, size=size, device=dev, backend=backend)


def _rank_main(rank, fn, size, port, device, backend, threads, args):
    if threads:
        torch.set_num_threads(threads)
    group = init(rank, size, port, device, backend)
    try:
        fn(group, *args)
    finally:
        group.close()


def spawn(fn, size: int, args=(), device="cuda", backend=None) -> None:
    """Run fn(group, *args) in `size` fresh processes, one per rank, and
    wait for them; raises if any rank fails. On the CPU each rank takes an
    equal share of the caller's torch threads."""
    import torch.multiprocessing as mp
    threads = 0
    if torch.device(device).type == "cpu":
        threads = max(1, torch.get_num_threads() // size)
    mp.start_processes(_rank_main, args=(fn, size, free_port(), device,
                                         backend, threads, args),
                       nprocs=size, join=True, start_method="spawn")
