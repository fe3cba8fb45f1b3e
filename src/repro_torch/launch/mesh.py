"""The stage process group: one process per pipeline stage (the port's
counterpart of ``repro/launch/mesh.py``, whose mesh has a ``stage`` axis
that ``shard_map`` runs over).

A group is set up from ``torchrun``'s environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, the rendezvous in
``MASTER_ADDR``/``MASTER_PORT``) or from an explicit rank, world size and
store or ``init_method``.  The backend is always the caller's choice:
``nccl`` keeps each rank on a card of its own and raises, before any
group is set up, when there are more ranks than cards (NCCL cannot put
two ranks on one device); ``gloo`` runs any number of ranks on the CPU or
on one card, its messages staged through host memory
(:class:`repro_torch.pipeline.comm.Transport`).  Every group waits at
most :data:`GROUP_TIMEOUT` for a peer, so a hang fails instead of
stalling.

:func:`spawn_ranks` runs a function on ``world`` fresh processes (the
spawn start method) over a ``FileStore`` in a temporary directory, so no
port is opened and concurrent runs never meet.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.pipeline.comm import GROUP_TIMEOUT

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class StageMesh:
    """This process's place in the stage group: its rank is its stage."""
    group: object                   # the torch.distributed process group
    rank: int
    world: int
    backend: str
    device: torch.device


def rank_device(device_type: str, local_rank: int) -> torch.device:
    """``cuda:{local_rank % cards}``, or the CPU when asked for."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"device {device_type!r}: expected cuda or cpu")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("a cuda rank needs a CUDA card; pass device "
                           "'cpu' to run the ranks on the CPU")
    return torch.device("cuda", local_rank % n)


def check_backend(backend: str, device_type: str, local_world: int) -> None:
    """Refuse a backend that cannot run ``local_world`` ranks of this host
    on ``device_type``, before any group is set up."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    if backend == "nccl":
        if device_type != "cuda":
            raise ValueError("nccl runs ranks on CUDA cards; on the CPU use "
                             "backend 'gloo'")
        cards = torch.cuda.device_count()
        if local_world > cards:
            raise ValueError(
                f"nccl with {local_world} ranks on {cards} card(s): NCCL "
                f"cannot put two ranks on one device; use backend 'gloo' to "
                f"run them on one card (messages staged through host "
                f"memory), or one card per rank")


def check_world(n_stages: int, world: int) -> None:
    """Refuse a plan whose stage count is not the world size (one process
    runs one stage), before any group is set up."""
    if n_stages != world:
        raise ValueError(
            f"{n_stages} stages on {world} ranks: one process runs one "
            f"stage, so --stages (or the planner's stage count) must equal "
            f"the world size")


def init_stage_group(backend: str, device_type: str = "cuda", *,
                     rank: int | None = None, world: int | None = None,
                     init_method: str | None = None,
                     store=None) -> StageMesh:
    """Set up the default process group and return this rank's
    :class:`StageMesh`.  With ``rank`` None every figure comes from
    ``torchrun``'s environment (``init_method`` ``env://``); otherwise
    from the arguments, with ``store`` or ``init_method`` as the
    rendezvous (one host: the local rank is the rank)."""
    if rank is None:
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        init_method = init_method or "env://"
    elif world is None:
        raise ValueError("an explicit rank needs its world size")
    else:
        local_rank, local_world = rank, world
    check_backend(backend, device_type, local_world)
    device = rank_device(device_type, local_rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = dict(store=store) if store is not None else dict(
        init_method=init_method)
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=GROUP_TIMEOUT, **kw)
    return StageMesh(group=dist.group.WORLD, rank=rank, world=world,
                     backend=backend, device=device)


def gather(obj, mesh: StageMesh) -> list:
    """Every rank's ``obj`` (a small Python object), in rank order."""
    out = [None] * mesh.world
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def _rank_main(rank: int, fn, world: int, backend: str, device_type: str,
               tmp: str, args: tuple) -> None:
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    mesh = init_stage_group(backend, device_type, rank=rank, world=world,
                            store=store)
    try:
        out = fn(mesh, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, backend: str, *args,
                device: str = "cpu") -> list:
    """Run ``fn(mesh, *args)`` on ``world`` spawned processes, one a rank,
    each with its :class:`StageMesh` on ``device`` ('cpu', or 'cuda':
    card ``rank % cards``), and return their results in rank order.
    ``fn`` and ``args`` are pickled (``fn`` by its import path); each
    result goes back through ``torch.save`` (its tensors land on the
    CPU).  A rank that raises ends the
    others and the call raises; a rank that waits on a dead peer fails
    after :data:`GROUP_TIMEOUT`."""
    import torch.multiprocessing as mp
    check_backend(backend, device, world)
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main,
                           args=(fn, world, backend, device, tmp, args),
                           nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world)]
