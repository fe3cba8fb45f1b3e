"""The (data, stage) grid of processes: one process per pipeline stage of
each data-parallel replica (the port's counterpart of
``repro/launch/mesh.py``, whose ``("data", "stage", "tensor")`` mesh
``shard_map`` runs over).

Global rank ``r = d * S + s`` runs stage ``s`` of replica ``d`` (data
major, the JAX mesh's axis order).  :func:`make_grid` builds, with
``dist.new_group`` on every rank in the same order, one stage group per
replica (its ranks by stage: the rings' peers), one data group per stage
(its ranks by replica: the gradient sync and the serve step's logits)
and, where the embedding is shared by the first and the last stage of a
replica of more than two stages, one tied-embedding group per replica.
At data 1 no group is made: the stage group is the whole world, as
before the data axis.

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
    """This process's place on the (data, stage) grid: global rank
    ``rank = data_rank * stages + stage``.  ``group`` is this replica's
    stage group (the world at data 1), ``data_group`` this stage's
    replicas (None at data 1) and ``tie_group`` stages 0 and S-1 of this
    replica (the stage group itself at two stages; None at one stage and
    on a middle stage); ``stage_ranks`` and ``data_ranks`` their global
    ranks, by stage and by replica."""
    group: object                   # this replica's stage group
    rank: int                       # global rank
    world: int
    backend: str
    device: torch.device
    data: int = 1
    data_rank: int = 0
    stage: int = 0
    data_group: object = None
    tie_group: object = None
    stage_ranks: tuple = ()
    data_ranks: tuple = ()

    @property
    def stages(self) -> int:
        return self.world // self.data


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


def check_world(n_stages: int, world: int, data: int = 1) -> None:
    """Refuse a grid whose data x stages is not the world size (one
    process runs one stage of one replica), before any group is set
    up."""
    if data < 1 or n_stages * data != world:
        raise ValueError(
            f"data {data} x {n_stages} stages on {world} ranks: one "
            f"process runs one stage of one replica, so --data x --stages "
            f"(or the planner's) must equal the world size")


def make_grid(data: int, backend: str, device: torch.device) -> StageMesh:
    """This rank's :class:`StageMesh` on a data x stages grid over the
    default process group (already set up; every rank calls this, and
    every rank makes every group, in the same order)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    check_world(world // max(data, 1), world, data)
    S = world // data
    d, s = divmod(rank, S)
    if data == 1:
        stage_ranks, data_ranks = tuple(range(world)), (rank,)
        group, data_group = dist.group.WORLD, None
    else:
        new = lambda ranks: dist.new_group(list(ranks),
                                           timeout=GROUP_TIMEOUT)
        stage_groups = [new(range(r * S, (r + 1) * S)) for r in range(data)]
        data_groups = [new(range(j, world, S)) for j in range(S)]
        group, data_group = stage_groups[d], data_groups[s]
        stage_ranks = tuple(range(d * S, (d + 1) * S))
        data_ranks = tuple(range(s, world, S))
    tie = {1: None, 2: group}.get(S)
    if S > 2:
        ties = [dist.new_group([r * S, r * S + S - 1], timeout=GROUP_TIMEOUT)
                for r in range(data)]
        tie = ties[d] if s in (0, S - 1) else None
    return StageMesh(group=group, rank=rank, world=world, backend=backend,
                     device=device, data=data, data_rank=d, stage=s,
                     data_group=data_group, tie_group=tie,
                     stage_ranks=stage_ranks, data_ranks=data_ranks)


def init_stage_group(backend: str, device_type: str = "cuda", *,
                     rank: int | None = None, world: int | None = None,
                     init_method: str | None = None, store=None,
                     data: int = 1) -> StageMesh:
    """Set up the default process group and the grid's groups
    (:func:`make_grid`, ``data`` replicas) and return this rank's
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
    check_world(world // max(data, 1), world, data)
    device = rank_device(device_type, local_rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = dict(store=store) if store is not None else dict(
        init_method=init_method)
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=GROUP_TIMEOUT, **kw)
    return make_grid(data, backend, device)


def gather(obj, mesh: StageMesh) -> list:
    """Every rank's ``obj`` (a small Python object), in global rank
    order."""
    out = [None] * mesh.world
    dist.all_gather_object(out, obj)
    return out


def _rank_main(rank: int, fn, world: int, backend: str, device_type: str,
               tmp: str, args: tuple, data: int) -> None:
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    mesh = init_stage_group(backend, device_type, rank=rank, world=world,
                            store=store, data=data)
    try:
        out = fn(mesh, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, backend: str, *args,
                device: str = "cpu", data: int = 1) -> list:
    """Run ``fn(mesh, *args)`` on ``world`` spawned processes, one a rank,
    each with its :class:`StageMesh` (``data`` replicas of ``world //
    data`` stages) on ``device`` ('cpu', or 'cuda': card ``rank %
    cards``), and return their results in rank order.
    ``fn`` and ``args`` are pickled (``fn`` by its import path); each
    result goes back through ``torch.save`` (its tensors land on the
    CPU).  A rank that raises ends the
    others and the call raises; a rank that waits on a dead peer fails
    after :data:`GROUP_TIMEOUT`."""
    import torch.multiprocessing as mp
    check_backend(backend, device, world)
    check_world(world // max(data, 1), world, data)
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main,
                           args=(fn, world, backend, device, tmp, args, data),
                           nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world)]
