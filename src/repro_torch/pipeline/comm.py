"""What the ranks of a pipeline send each other: the port's counterpart
of the JAX runtime's ``ppermute`` rings and ``psum``s over the ``stage``
axis (``repro/pipeline/runtime.py``), as ``torch.distributed`` messages.

:func:`ring_hops` derives, from a ``lower_to_ticks`` table alone, which
stage sends which ring's output to which neighbour between two ticks;
:func:`serve_hops` does the same for the serve step's ``lower_to_ring``
table (a forward ring only).  Every rank derives the same list, so the
sends and receives pair up.  A :class:`Transport` moves them, one
``batch_isend_irecv`` a tick, and carries the step's few collectives
(the loss, the gradient-norm partials, the tied embedding's gradient,
the serve step's logits) and the V > 1 serving handoff's layers.  Under
gloo on a CUDA device every message goes device -> pinned host -> device
in plain sight (gloo's send and recv take CPU tensors only); under NCCL
the device tensors go as they are.  Each message's bytes and host time
are counted by kind.
"""
from __future__ import annotations

import datetime
import time

import torch
import torch.distributed as dist

from repro_torch.core import schedplan as SP

FWD, BWD = 0, 1          # the two rings; also the messages' tags
#: how long any collective or message waits for a peer before it fails
GROUP_TIMEOUT = datetime.timedelta(seconds=60)


def ring_hops(lo: SP.TickLowering) -> tuple:
    """``hops[t]``: the (ring, src, dst) messages that arrive at tick t,
    sent by ``src`` after its tick t-1.  A forward output hops to stage
    s+1 (cyclic: at V > 1 stage S-1's chunk-v output is stage 0's
    chunk-(v+1) input) only where that stage consumes it on arrival
    (``fsrc == 1``) or parks it (``fpark``); a backward output hops to
    stage s-1 where ``bsrc == 1`` or ``bpark`` says so.  Nothing else
    moves: idle, W and loss-head ticks send nothing the table does not
    read."""
    S = lo.N
    out = []
    for t in range(lo.n_ticks):
        hops = []
        for d in range(S):
            if lo.fpark[d][t] >= 0 or (lo.kind[d][t] == SP.TICK_F
                                       and lo.fsrc[d][t] == 1):
                hops.append((FWD, (d - 1) % S, d))
            if lo.bpark[d][t] >= 0 or (lo.kind[d][t] == SP.TICK_B
                                       and lo.bsrc[d][t] == 1):
                hops.append((BWD, (d + 1) % S, d))
        out.append(tuple(hops))
    return tuple(out)


def serve_hops(lo: SP.RingLowering) -> tuple:
    """``hops[t]``: the (src, dst) forward messages that arrive at tick t
    of the serve ring, sent by ``src`` after its tick t-1 (stage s runs
    element ``t - s`` at tick t).  Stage s hops to s+1 wherever s+1 has
    an element at tick t (it reads that element's output of stage s);
    stage S-1 hops to stage 0 only where stage 0 reads the ring return:
    element ``t - S``'s output is parked (``park``) or is the input of
    stage 0's element t (``direct``).  A collected final output stays on
    the last stage.  At V = 1 nothing wraps."""
    S, MV = lo.N, lo.M * lo.V
    out = []
    for t in range(lo.n_ticks):
        hops = [(s, s + 1) for s in range(S - 1) if 0 <= t - s - 1 < MV]
        back = ((0 <= t - S < MV and lo.park[t - S])
                or (t < MV and not lo.fresh[t] and lo.direct[t]))
        if back:
            hops.append((S - 1, 0))
        out.append(tuple(hops))
    return tuple(out)


class Transport:
    """One rank's messages over ``group``: the ring hops and the step's
    collectives.  ``stats[kind] = [messages, bytes, seconds, copy
    seconds]`` for the kinds ``hop`` (activations and cotangents),
    ``embed_allreduce`` (the tied embedding's gradient), ``scalars``
    (the loss and the norm partials), ``logits`` (the serve step's
    broadcast from the last rank) and ``handoff`` (the layers the V > 1
    serving handoff moves between ranks); bytes count what this rank
    sends; seconds are the host's wall time of the calls, waiting for the
    peers included (under NCCL, where nothing waits, the enqueue); copy
    seconds the staging copies' share of it (device -> pinned host ->
    device, each ending in a sync).  :meth:`reset` zeroes them."""

    KINDS = ("hop", "embed_allreduce", "scalars", "logits", "handoff")

    def __init__(self, group):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = dist.get_backend(group)
        self.reset()

    def reset(self) -> None:
        self.stats = {k: [0, 0, 0.0, 0.0] for k in self.KINDS}

    def _staged(self, device: torch.device) -> bool:
        return self.backend == "gloo" and device.type == "cuda"

    def _count(self, kind: str, nbytes: int, t0: float,
               copy_s: float = 0.0) -> None:
        st = self.stats[kind]
        st[0] += 1
        st[1] += nbytes
        st[2] += time.perf_counter() - t0
        st[3] += copy_s

    def _to_host(self, x: torch.Tensor) -> tuple:
        """``x`` in pinned host memory, and the copy's seconds (the work
        queued before it has drained first, outside the count)."""
        torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        return host, time.perf_counter() - t0

    @staticmethod
    def _to_device(host: torch.Tensor, dst: torch.Tensor) -> float:
        """Copy ``host`` into ``dst`` on its device; the copy's seconds."""
        t0 = time.perf_counter()
        dst.copy_(host)
        torch.cuda.synchronize(dst.device)
        return time.perf_counter() - t0

    def _peer(self, r: int) -> int:
        return dist.get_global_rank(self.group, r)

    def exchange(self, sends: list, recvs: list, like: torch.Tensor) -> dict:
        """Post every (tag, dst, tensor) of ``sends`` and every (tag, src)
        of ``recvs`` in one ``batch_isend_irecv`` and wait for them;
        returns ``{tag: tensor}`` of what arrived, each shaped and typed
        as ``like`` on its device.  A message to this rank itself is
        handed over as it is."""
        out = {tag: x for tag, dst, x in sends if dst == self.rank}
        recvs = [(tag, src, torch.empty_like(like))
                 for tag, src in recvs if src != self.rank]
        self.exchange_into(
            [m for m in sends if m[1] != self.rank], recvs, "hop",
            like.device)
        out.update({tag: buf for tag, _, buf in recvs})
        return out

    def exchange_into(self, sends: list, recvs: list, kind: str,
                      device: torch.device) -> None:
        """Post every (tag, dst, tensor) of ``sends`` and every (tag, src,
        buffer) of ``recvs`` (tensors on ``device``; a peer other than
        this rank) in one ``batch_isend_irecv``, wait for them and leave
        each message in its buffer; counted under ``kind``."""
        if not sends and not recvs:
            return
        staged = self._staged(device)
        if staged:      # the queued work is compute, not transport
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        ops, landed, nbytes, copy_s = [], [], 0, 0.0
        for tag, dst, x in sends:
            if x is None:
                raise RuntimeError(f"message {tag}: rank {self.rank} has no "
                                   f"output to send to rank {dst}")
            if staged:
                x, c = self._to_host(x)
                copy_s += c
            ops.append(dist.P2POp(dist.isend, x.contiguous(),
                                  self._peer(dst), self.group, tag))
            nbytes += x.numel() * x.element_size()
        for tag, src, buf in recvs:
            land = (torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
                    if staged else buf)
            landed.append((land, buf))
            ops.append(dist.P2POp(dist.irecv, land, self._peer(src),
                                  self.group, tag))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if staged:
            for land, buf in landed:
                copy_s += self._to_device(land, buf)
        self._count(kind, nbytes, t0, copy_s)

    def broadcast(self, x: torch.Tensor, src: int,
                  kind: str = "scalars") -> torch.Tensor:
        """``x`` from rank ``src`` on every rank (a new tensor on ``x``'s
        device; ``x`` is only read on ``src``, elsewhere it gives the
        shape and type); counted under ``kind``."""
        if self.size == 1:
            return x
        t0 = time.perf_counter()
        mine = self.rank == src
        buf = x.detach().clone() if mine else torch.empty_like(x)
        copy_s = 0.0
        if self._staged(x.device):
            if mine:
                host, copy_s = self._to_host(buf)
            else:
                host = torch.empty(buf.shape, dtype=buf.dtype,
                                   pin_memory=True)
            dist.broadcast(host, self._peer(src), group=self.group)
            copy_s += self._to_device(host, buf)
        else:
            dist.broadcast(buf, self._peer(src), group=self.group)
        self._count(kind, buf.numel() * buf.element_size() if mine else 0,
                    t0, copy_s)
        return buf

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[size, *x.shape]``: every rank's ``x``, in rank order."""
        t0 = time.perf_counter()
        staged, copy_s = self._staged(x.device), 0.0
        if staged:
            src, copy_s = self._to_host(x.detach())
        else:
            src = x.detach().contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        out = torch.stack(parts)
        if staged:
            dev = torch.empty(out.shape, dtype=out.dtype, device=x.device)
            copy_s += self._to_device(out, dev)
            out = dev
        self._count("scalars", src.numel() * src.element_size(), t0, copy_s)
        return out

    def all_reduce_sum(self, x: torch.Tensor, group) -> torch.Tensor:
        """``x`` summed IN PLACE over ``group`` (the tied embedding's two
        ranks); returns ``x``."""
        if self._staged(x.device):
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        copy_s = 0.0
        if self._staged(x.device):
            host, copy_s = self._to_host(x)
            dist.all_reduce(host, group=group)
            copy_s += self._to_device(host, x)
        else:
            dist.all_reduce(x, group=group)
        self._count("embed_allreduce", x.numel() * x.element_size(), t0,
                    copy_s)
        return x
