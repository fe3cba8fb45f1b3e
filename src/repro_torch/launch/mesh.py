"""The (data, stage, tensor) grid of processes: one process per tensor
shard of each pipeline stage of each data-parallel replica (the port's
counterpart of ``repro/launch/mesh.py``, whose ``("data", "stage",
"tensor")`` mesh ``shard_map`` runs over).

Global rank ``r = (d * S + s) * T + t`` runs tensor shard ``t`` of stage
``s`` of replica ``d`` (the JAX mesh's axis order, tensor fastest).
:func:`make_grid` builds, with ``dist.new_group`` on every rank in the
same order, one stage group per (replica, tensor shard) (its ranks by
stage: the rings' peers; shard t of stage s talks to shard t of s+1),
one data group per (stage, tensor shard) (its ranks by replica: the
gradient sync and the serve step's logits), one tensor group per
(replica, stage) (its ranks by shard: the Megatron all-reduces inside
every block, the vocab-parallel embedding and loss) and, where the
embedding is shared by the first and the last stage of a replica of
more than two stages, one tied-embedding group per (replica, tensor
shard).  At data 1 and tensor 1 no group is made: the stage group is
the whole world, as before the data and tensor axes.

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
import gc
import math
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.pipeline.comm import GROUP_TIMEOUT

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class StageMesh:
    """This process's place on the (data, stage, tensor) grid: global
    rank ``rank = (data_rank * stages + stage) * tensor + tensor_rank``.
    ``group`` is the stage group of this replica's tensor shard (the
    world at data 1 and tensor 1), ``data_group`` this stage's and
    shard's replicas (None at data 1), ``tensor_group`` this stage's
    shards (None at tensor 1) and ``tie_group`` stages 0 and S-1 of this
    replica's shard (the stage group itself at two stages; None at one
    stage and on a middle stage); ``stage_ranks``, ``data_ranks`` and
    ``tensor_ranks`` their global ranks, by stage, by replica and by
    shard."""
    group: object                   # this replica's and shard's stages
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
    tensor: int = 1
    tensor_rank: int = 0
    tensor_group: object = None
    tensor_ranks: tuple = ()

    @property
    def stages(self) -> int:
        return self.world // (self.data * self.tensor)


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


def check_world(n_stages: int, world: int, data: int = 1,
                tensor: int = 1) -> None:
    """Refuse a grid whose data x stages x tensor is not the world size
    (one process runs one tensor shard of one stage of one replica),
    before any group is set up."""
    if data < 1 or tensor < 1 or n_stages * data * tensor != world:
        tp = f" x tensor {tensor}" if tensor != 1 else ""
        raise ValueError(
            f"data {data} x {n_stages} stages{tp} on {world} ranks: one "
            f"process runs one {'tensor shard of one ' if tp else ''}stage "
            f"of one replica, so --data x --stages"
            f"{' x --tensor' if tp else ''} (or the planner's) must equal "
            f"the world size")


def grid_ranks(data: int, stages: int, tensor: int) -> dict:
    """The grid's groups as lists of global ranks, in the order
    :func:`make_grid` makes them: ``stage`` (one a (replica, shard),
    ranks by stage), ``data`` (one a (stage, shard), ranks by replica),
    ``tensor`` (one a (replica, stage), ranks by shard) and ``tie`` (one
    a (replica, shard): its first and last stage, when S > 2)."""
    D, S, T = data, stages, tensor
    at = lambda d, s, t: (d * S + s) * T + t
    return dict(
        stage=[[at(d, s, t) for s in range(S)]
               for d in range(D) for t in range(T)],
        data=[[at(d, s, t) for d in range(D)]
              for s in range(S) for t in range(T)],
        tensor=[[at(d, s, t) for t in range(T)]
                for d in range(D) for s in range(S)],
        tie=[[at(d, 0, t), at(d, S - 1, t)]
             for d in range(D) for t in range(T)] if S > 2 else [])


def make_grid(data: int, backend: str, device: torch.device,
              tensor: int = 1) -> StageMesh:
    """This rank's :class:`StageMesh` on a data x stages x tensor grid
    over the default process group (already set up; every rank calls
    this, and every rank makes every group, in the same order)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    D, T = max(data, 1), max(tensor, 1)
    check_world(world // (D * T), world, data, tensor)
    S = world // (D * T)
    ranks = grid_ranks(D, S, T)
    mine = {kind: next((rs for rs in lines if rank in rs), None)
            for kind, lines in ranks.items()}

    def made(kind):
        """Every group of ``kind`` made, in order; this rank's."""
        own = None
        for rs in ranks[kind]:
            g = dist.new_group(rs, timeout=GROUP_TIMEOUT)
            own = g if rs is mine[kind] else own
        return own

    group = dist.group.WORLD if D == 1 and T == 1 else made("stage")
    data_group = made("data") if D > 1 else None
    tensor_group = made("tensor") if T > 1 else None
    tie = made("tie") if S > 2 else {1: None, 2: group}[S]
    return StageMesh(group=group, rank=rank, world=world, backend=backend,
                     device=device, data=D, data_rank=rank // (S * T),
                     stage=rank // T % S, data_group=data_group,
                     tie_group=tie, stage_ranks=tuple(mine["stage"]),
                     data_ranks=tuple(mine["data"]), tensor=T,
                     tensor_rank=rank % T, tensor_group=tensor_group,
                     tensor_ranks=tuple(mine["tensor"]))


def init_stage_group(backend: str, device_type: str = "cuda", *,
                     rank: int | None = None, world: int | None = None,
                     init_method: str | None = None, store=None,
                     data: int = 1, tensor: int = 1) -> StageMesh:
    """Set up the default process group and the grid's groups
    (:func:`make_grid`, ``data`` replicas of ``tensor`` shards) and
    return this rank's
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
    check_world(world // max(data * tensor, 1), world, data, tensor)
    device = rank_device(device_type, local_rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = dict(store=store) if store is not None else dict(
        init_method=init_method)
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=GROUP_TIMEOUT, **kw)
    return make_grid(data, backend, device, tensor)


def destroy_groups(wait: bool = True) -> None:
    """Tear down this process's groups once its run is over.  The
    caller drops its own references to the mesh and to anything that
    holds a group first.  With ``wait`` (the run ended well on every
    rank) a barrier keeps any rank from closing its connections while a
    peer still uses them; the collection frees the step functions, which
    hold their :class:`repro_torch.pipeline.comm.Transport` (and so the
    groups) in reference cycles, so that each group is destroyed here,
    with the interpreter alive: a gloo group left to the interpreter's
    exit could abort the process ("terminate called without an active
    exception") after a run that had ended."""
    if wait:
        dist.barrier()
    gc.collect()
    dist.destroy_process_group()


def gather(obj, mesh: StageMesh) -> list:
    """Every rank's ``obj`` (a small Python object), in global rank
    order."""
    out = [None] * mesh.world
    dist.all_gather_object(out, obj)
    return out


def _leaves(tree: dict, path: tuple = ()) -> dict:
    """``{key path: leaf}`` of a nested dict."""
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, path + (k,)) if isinstance(v, dict)
                   else {path + (k,): v})
    return out


def gather_leaves(share: dict, mesh: StageMesh, holders):
    """Replica 0's shares of a tree, leaf by leaf, at global rank 0 (a
    checkpoint's save on ranks: :func:`repro_torch.checkpoint.ckpt.
    save_rank_shares`).  A generator every rank runs to its end: for
    each leaf path of the replica's shares, in sorted order, each rank
    that ``holders(path)`` names (its (stage, tensor shard) pairs, of
    replica 0) sends its share of the leaf to rank 0, which yields
    ``(path, {(stage, shard): share on the CPU})`` before the next leaf
    moves, so that it holds no more than one leaf of the others'.  The
    other ranks yield nothing.  Each message is the leaf's bytes (any
    dtype), over the host under gloo and from the card under nccl;
    shapes and dtypes cross first, in one small gather."""
    mine = _leaves(share)
    every = gather({p: (tuple(a.shape), str(a.dtype).removeprefix("torch."))
                    for p, a in mine.items()}, mesh)
    S, T = mesh.stages, mesh.tensor
    paths = sorted({p for r in range(S * T) for p in every[r]})
    via = torch.device("cpu") if mesh.backend == "gloo" else mesh.device
    for path in paths:
        pieces = {}
        for s, t in holders(path):
            src = s * T + t                 # rank (replica 0, s, t)
            if src == mesh.rank == 0:
                pieces[(s, t)] = mine[path].detach().cpu()
            elif src == mesh.rank:
                a = mine[path].detach().to(via).contiguous()
                dist.send(a.reshape(-1).view(torch.uint8), dst=0)
            elif mesh.rank == 0:
                shape, dtype = every[src][path]
                dtype = getattr(torch, dtype)
                n = math.prod(shape) * dtype.itemsize
                buf = torch.empty(n, dtype=torch.uint8, device=via)
                dist.recv(buf, src=src)
                pieces[(s, t)] = buf.view(dtype).reshape(shape).cpu()
        if mesh.rank == 0:
            yield path, pieces


def _rank_main(rank: int, fn, world: int, backend: str, device_type: str,
               tmp: str, args: tuple, data: int, tensor: int) -> None:
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    mesh = init_stage_group(backend, device_type, rank=rank, world=world,
                            store=store, data=data, tensor=tensor)
    ok = False
    try:
        out = fn(mesh, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
        ok = True
    finally:
        mesh = out = None       # the groups' last references here
        destroy_groups(wait=ok)


def spawn_ranks(fn, world: int, backend: str, *args,
                device: str = "cpu", data: int = 1, tensor: int = 1) -> list:
    """Run ``fn(mesh, *args)`` on ``world`` spawned processes, one a rank,
    each with its :class:`StageMesh` (``data`` replicas of ``world /
    (data tensor)`` stages of ``tensor`` shards) on ``device`` ('cpu',
    or 'cuda': card ``rank % cards``), and return their results in rank
    order.
    ``fn`` and ``args`` are pickled (``fn`` by its import path); each
    result goes back through ``torch.save`` (its tensors land on the
    CPU).  A rank that raises ends the
    others and the call raises; a rank that waits on a dead peer fails
    after :data:`GROUP_TIMEOUT`."""
    import torch.multiprocessing as mp
    check_backend(backend, device, world)
    check_world(world // max(data * tensor, 1), world, data, tensor)
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main,
                           args=(fn, world, backend, device, tmp, args, data,
                                 tensor),
                           nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world)]
