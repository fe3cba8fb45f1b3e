"""What the ranks of a pipeline send each other: the port's counterpart
of the JAX runtime's ``ppermute`` rings and ``psum``s over the ``stage``
and ``data`` axes (``repro/pipeline/runtime.py``), as
``torch.distributed`` messages.

:func:`ring_hops` derives, from a ``lower_to_ticks`` table alone, which
stage sends which ring's output to which neighbour between two ticks;
:func:`serve_hops` does the same for the serve step's ``lower_to_ring``
table (a forward ring only).  Every rank derives the same list, so the
sends and receives pair up.  A :class:`Transport` moves them: for the
tick executors one ``batch_isend_irecv`` a tick, waited for at once
(:meth:`Transport.exchange`); for the stream runtime posted without
waiting (:meth:`Transport.post`, a :class:`Posted` handle a message),
each receive waited for by the tick that reads it and the sends at the
step's end (:meth:`Transport.drain`).  Both sides post a (peer, ring)
pair's messages in slot order, so gloo and NCCL pair them by tag and
order.  A rank's peers are addressed by their rank in its stage group
(their stage), mapped to global ranks where torch.distributed wants
them.  It also carries the step's few collectives (the loss, the
gradient-norm partials, the tied embedding's gradient, the serve step's
logits), the V > 1 serving handoff's layers and, over the data group,
the gradient sync (:meth:`Transport.reduce_bucket`: one bucket
flattened per dtype, reduce-scattered and all-gathered, posted without
waiting) and the replicas' logits.  Over the tensor group it carries
the Megatron collectives (:class:`TensorAxis`: the two autograd
operators ``copy_to_tensor`` and ``reduce_from_tensor``, the
vocab-parallel loss's max and sums, the serve step's logits gathered
from the vocab shards) in place of the JAX runtime's ``psum`` / ``pmax``
over ``tensor``.  A hop of the audio family carries a pair ``{h_enc, h_dec}`` of two
shapes: :func:`pack` lays it out as one flat buffer, sent as one
message and counted under the same kind, and :func:`unpack` views the
arrival as the pair again.  Under gloo on a CUDA
device every message goes device -> pinned host -> device in plain
sight (gloo's send and recv take CPU tensors only); under NCCL the
device tensors go as they are.  Each message's bytes and host time are
counted by kind, the time split into posting, waits and staging copies.
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


#: the audio family's carry: its two hidden states, in buffer order
PAIR = ("h_enc", "h_dec")


def pack(x):
    """A hop's value as one tensor: a hidden state as it is, the audio
    family's pair ``{h_enc, h_dec}`` flattened into one buffer (a copy),
    ``h_enc`` first."""
    if isinstance(x, dict):
        return torch.cat([x[k].reshape(-1) for k in PAIR])
    return x


def flat_like(like):
    """The buffer :func:`pack` makes of a carry shaped as ``like`` (a
    tensor, or a pair of tensors), to receive into; ``like`` itself for a
    tensor."""
    if isinstance(like, dict):
        return like["h_dec"].new_empty((sum(like[k].numel() for k in PAIR),))
    return like


def unpack(x, like):
    """An arrival as the carry ``like`` describes: a flat buffer split
    into views of the pair's shapes when ``like`` is a pair; anything
    else (a hidden state, or a pair handed over in process) as it is."""
    if not isinstance(like, dict) or isinstance(x, dict) or x is None:
        return x
    n = like["h_enc"].numel()
    return dict(h_enc=x[:n].view(like["h_enc"].shape),
                h_dec=x[n:].view(like["h_dec"].shape))


class Posted:
    """One message :meth:`Transport.post` put in flight, a send or a
    receive.  :meth:`wait` blocks until it is done and returns what
    arrived (a receive's tensor, on the device it was posted for) or None
    (a send).  Under gloo on a CUDA device a send holds its pinned host
    copy and a receive its pinned landing buffer until waited."""

    __slots__ = ("tp", "kind", "recv", "buf", "works", "device", "out")

    def __init__(self, tp, kind: str, recv: bool, buf=None, device=None,
                 out=None):
        self.tp, self.kind, self.recv, self.buf = tp, kind, recv, buf
        self.device, self.works, self.out = device, (), out

    def wait(self):
        if self.buf is not None:
            self.tp._settle(self)
        return self.out


class Transport:
    """One rank's messages over ``group`` (its stage group; ``rank`` is
    its stage), ``data_group`` (its stage's replicas, or None) and
    ``tensor_group`` (its stage's tensor shards, or None): the ring hops
    and the step's collectives.  ``stats[kind] = [messages,
    bytes, seconds, copy seconds, post seconds, receive-wait seconds,
    send-wait seconds]`` for the kinds ``hop`` (activations and
    cotangents), ``embed_allreduce`` (the tied embedding's gradient),
    ``scalars`` (the loss and the norm partials), ``logits`` (the serve
    step's broadcast from the last rank, and its gather over the
    replicas), ``handoff`` (the layers the V > 1 serving handoff moves
    between ranks), ``grad_sync`` (the gradient buckets summed over
    the replicas: a reduce-scatter and an all-gather per bucket and
    dtype, each a message; bytes the bucket's; the wait under receive
    waits) and ``tensor`` (the collectives over the tensor group:
    :class:`TensorAxis`).  A message between two ranks counts at both
    its ends, a collective once a call; bytes count what this rank
    sends; seconds
    are the host's wall time of the calls, waiting for the peers
    included (under NCCL, where nothing waits, the enqueue); of them,
    copy seconds are the staging copies (device -> pinned host ->
    device, each ending in a sync), post seconds the posting of messages,
    and the two waits the time blocked on receives and on sends (a
    collective's time is in none of the three, but for the gradient
    buckets').  :meth:`reset` zeroes them."""

    KINDS = ("hop", "embed_allreduce", "scalars", "logits", "handoff",
             "grad_sync", "tensor")

    def __init__(self, group, data_group=None, tensor_group=None):
        self.group, self.data_group = group, data_group
        self.tensor_group = tensor_group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = dist.get_backend(group)
        self._loop: dict = {}       # tag -> messages to this rank itself
        self._sends: list = []      # posted sends not waited yet
        self.reset()

    def reset(self) -> None:
        self.stats = {k: [0, 0] + [0.0] * 5 for k in self.KINDS}

    def _staged(self, device: torch.device) -> bool:
        return self.backend == "gloo" and device.type == "cuda"

    def _count(self, kind: str, nbytes: int, t0: float, copy_s: float = 0.0,
               msgs: int = 1, post_s: float = 0.0, recv_wait_s: float = 0.0,
               send_wait_s: float = 0.0) -> None:
        st = self.stats[kind]
        st[0] += msgs
        st[1] += nbytes
        st[2] += time.perf_counter() - t0
        st[3] += copy_s
        st[4] += post_s
        st[5] += recv_wait_s
        st[6] += send_wait_s

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
        this rank) in one ``batch_isend_irecv``, wait for them (the
        receives first) and leave each message in its buffer; counted
        under ``kind``."""
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
        send_copy_s = copy_s
        works = dist.batch_isend_irecv(ops)
        t1 = time.perf_counter()
        # one work an op (gloo), or one for the batch (NCCL's coalescing)
        split = len(works) == len(ops)
        rworks = works[len(sends):] if split else works
        for w in rworks:
            w.wait()
        t2 = time.perf_counter()
        for w in works[:len(sends)] if split else ():
            w.wait()
        t3 = time.perf_counter()
        if staged:
            for land, buf in landed:
                copy_s += self._to_device(land, buf)
        self._count(kind, nbytes, t0, copy_s, msgs=len(ops),
                    post_s=t1 - t0 - send_copy_s, recv_wait_s=t2 - t1,
                    send_wait_s=t3 - t2)

    # ---- the stream runtime: posted messages, waited where read --------

    def post(self, sends: list, recvs: list, like: torch.Tensor,
             kind: str = "hop") -> list:
        """Post every (tag, dst, tensor) of ``sends`` and a receive for
        every (tag, src) of ``recvs`` (each shaped and typed as ``like``,
        on its device) in one ``batch_isend_irecv``, waiting for none of
        them; returns the receives' :class:`Posted` handles, in order.
        The sends are kept until :meth:`drain`.  Under gloo on a CUDA
        device each send is staged into pinned host memory here and each
        receive lands there, copied to the device when waited.  A
        message to this rank itself is handed over as it is (a rank's
        receives from itself follow its sends to itself, tag by tag).
        Counted under ``kind``: the post's seconds here, the waits' and
        copies' when waited."""
        if not sends and not recvs:
            return []
        dev = like.device
        staged = self._staged(dev)
        if staged and sends:    # the queued work is compute, not transport
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        ops, posted, nbytes, copy_s = [], [], 0, 0.0
        for tag, dst, x in sends:
            if x is None:
                raise RuntimeError(f"message {tag}: rank {self.rank} has no "
                                   f"output to send to rank {dst}")
            if dst == self.rank:
                self._loop.setdefault(tag, []).append(x)
                continue
            if staged:
                x, c = self._to_host(x)
                copy_s += c
            else:
                x = x.contiguous()
            ops.append(dist.P2POp(dist.isend, x, self._peer(dst),
                                  self.group, tag))
            posted.append(Posted(self, kind, False, x, dev))
            nbytes += x.numel() * x.element_size()
        self._sends += posted
        out = []
        for tag, src in recvs:
            if src == self.rank:
                out.append(Posted(self, kind, True,
                                  out=self._loop[tag].pop(0)))
                continue
            land = (torch.empty(like.shape, dtype=like.dtype,
                                pin_memory=True) if staged
                    else torch.empty_like(like))
            ops.append(dist.P2POp(dist.irecv, land, self._peer(src),
                                  self.group, tag))
            h = Posted(self, kind, True, land, dev)
            posted.append(h)
            out.append(h)
        if ops:
            works = dist.batch_isend_irecv(ops)
            # one work an op (gloo), or one for the batch (NCCL's
            # coalescing): a handle then waits for its whole batch
            for i, h in enumerate(posted):
                h.works = (works[i],) if len(works) == len(ops) else works
        self._count(kind, nbytes, t0, copy_s, msgs=len(ops),
                    post_s=time.perf_counter() - t0 - copy_s)
        return out

    def _settle(self, h: Posted) -> None:
        """Wait for a posted message; a receive's tensor lands in
        ``h.out`` (copied to its device when staged)."""
        staged = h.device is not None and self._staged(h.device)
        if staged:      # the queued work is compute, not transport
            torch.cuda.synchronize(h.device)
        t0 = time.perf_counter()
        for w in h.works:
            w.wait()
        waited = time.perf_counter() - t0
        copy_s = 0.0
        if h.recv:
            if staged:
                h.out = torch.empty(h.buf.shape, dtype=h.buf.dtype,
                                    device=h.device)
                copy_s = self._to_device(h.buf, h.out)
            else:
                h.out = h.buf
        h.buf, h.works = None, ()
        self._count(h.kind, 0, t0, copy_s, msgs=0,
                    recv_wait_s=waited if h.recv else 0.0,
                    send_wait_s=0.0 if h.recv else waited)

    def drain(self) -> None:
        """Wait for every send :meth:`post` put in flight."""
        sends, self._sends = self._sends, []
        for h in sends:
            h.wait()

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

    def all_gather(self, x: torch.Tensor, group=None,
                   kind: str = "scalars") -> torch.Tensor:
        """``[n, *x.shape]``: every rank's ``x`` over ``group`` (this
        rank's stage group by default), in group rank order."""
        group = self.group if group is None else group
        t0 = time.perf_counter()
        staged, copy_s = self._staged(x.device), 0.0
        if staged:
            src, copy_s = self._to_host(x.detach())
        else:
            src = x.detach().contiguous()
        parts = [torch.empty_like(src)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, src, group=group)
        out = torch.stack(parts)
        if staged:
            dev = torch.empty(out.shape, dtype=out.dtype, device=x.device)
            copy_s += self._to_device(out, dev)
            out = dev
        self._count(kind, src.numel() * src.element_size(), t0, copy_s)
        return out

    def reduce_bucket(self, leaves: list) -> "Reduction":
        """Post the sum of ``leaves`` (tensors of any shapes, each
        written back IN PLACE when the returned handle is waited) over
        the data group, as the JAX runtime's gradient sync does
        (``runtime.py`` ``ar_fn``): the leaves are flattened into one
        buffer per dtype, padded to a multiple of the replicas, reduced
        with ``reduce_scatter_tensor`` posted without waiting
        (``async_op=True``); :meth:`Reduction.wait` waits for it,
        all-gathers the reduced shards with ``all_gather_into_tensor``
        and copies the result back into the leaves.  Under gloo on a
        CUDA device the buffers live in pinned host memory.  Every
        replica must post the same buckets in the same order."""
        group, D = self.data_group, dist.get_world_size(self.data_group)
        dev = leaves[0].device
        staged = self._staged(dev)
        if staged:      # the queued work is compute, not transport
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        by_dt: dict = {}
        for x in leaves:
            by_dt.setdefault(x.dtype, []).append(x)
        parts, nbytes, copy_s = [], 0, 0.0
        for dt, xs in by_dt.items():
            n = sum(x.numel() for x in xs)
            total = n + (-n) % D
            t1 = time.perf_counter()
            if staged:
                flat = torch.empty((total,), dtype=dt, pin_memory=True)
                off = 0
                for x in xs:
                    flat[off:off + x.numel()].copy_(x.reshape(-1))
                    off += x.numel()
                flat[n:].zero_()
                copy_s += time.perf_counter() - t1
            else:
                flat = torch.cat([x.reshape(-1) for x in xs] + [
                    torch.zeros((total - n,), dtype=dt, device=dev)])
            shard = flat.new_empty((total // D,))
            work = dist.reduce_scatter_tensor(shard, flat, group=group,
                                              async_op=True)
            parts.append((xs, flat, shard, work))
            nbytes += n * flat.element_size()
        self._count("grad_sync", nbytes, t0, copy_s, msgs=len(parts),
                    post_s=time.perf_counter() - t0 - copy_s)
        return Reduction(self, parts, staged)

    def _finish(self, r: "Reduction") -> None:
        """Wait for a posted reduction, all-gather its shards and copy
        the sums back into its leaves."""
        t0 = time.perf_counter()
        copy_s = 0.0
        for xs, flat, shard, work in r.parts:
            work.wait()
            dist.all_gather_into_tensor(flat, shard, group=self.data_group)
            t1 = time.perf_counter()
            off = 0
            for x in xs:
                x.copy_(flat[off:off + x.numel()].view(x.shape))
                off += x.numel()
            if r.staged:
                torch.cuda.synchronize(xs[0].device)
            copy_s += time.perf_counter() - t1
        waited = time.perf_counter() - t0 - copy_s
        self._count("grad_sync", 0, t0, copy_s, msgs=len(r.parts),
                    recv_wait_s=waited)
        r.parts = ()

    def all_reduce(self, x: torch.Tensor, group,
                   kind: str = "embed_allreduce",
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``x`` reduced by ``op`` (a sum unless told otherwise) IN PLACE
        over ``group`` (the tied embedding's two ranks, a replica's loss
        over the data group, a tensor group's partial products or its
        logits' max); returns ``x``."""
        if self._staged(x.device):
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        copy_s = 0.0
        if self._staged(x.device):
            host, copy_s = self._to_host(x)
            dist.all_reduce(host, op=op, group=group)
            copy_s += self._to_device(host, x)
        else:
            dist.all_reduce(x, op=op, group=group)
        self._count(kind, x.numel() * x.element_size(), t0, copy_s)
        return x


class Reduction:
    """A gradient bucket :meth:`Transport.reduce_bucket` posted.
    :meth:`wait` finishes it: the leaves then hold their sums over the
    replicas."""

    __slots__ = ("tp", "parts", "staged")

    def __init__(self, tp: Transport, parts: list, staged: bool):
        self.tp, self.parts, self.staged = tp, parts, staged

    def wait(self) -> None:
        if self.parts:
            self.tp._finish(self)


class TensorAxis:
    """One rank's place on the tensor axis: ``size`` shards, this rank's
    ``index``, and the collectives over its tensor group (the JAX
    layers' ``tp_axis`` / ``tp_index``), each counted under the
    :class:`Transport`'s kind ``tensor``.  Every rank of a tensor group
    issues them in the same order: the blocks' and the loss's, forward
    and backward alike (a B or W tick re-runs the chunk's forward, and
    with it its forward collectives, before its backward's)."""

    def __init__(self, tp: Transport):
        self.tp, self.group = tp, tp.tensor_group
        self.size = dist.get_world_size(self.group)
        self.index = dist.get_rank(self.group)

    def all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM
                   ) -> torch.Tensor:
        """A new tensor: ``x`` reduced over the tensor group."""
        return self.tp.all_reduce(x.detach().clone(), self.group,
                                  kind="tensor", op=op)

    def copy_to_tensor(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's ``f``: ``x`` as it is (the same on every shard),
        its gradient summed over the shards (each shard's
        column-parallel products give a part of it): the input of every
        column-parallel block and of the vocab-parallel head."""
        return _CopyToTensor.apply(x, self)

    def reduce_from_tensor(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's ``g``: the shards' partial ``x`` summed (a
        row-parallel product, the masked embedding gather, the loss's
        sums), its gradient handed to each shard as it is (the JAX
        layers' ``_maybe_psum``)."""
        return _ReduceFromTensor.apply(x, self)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the group, outside autograd (the
        vocab-parallel loss's ``stop_gradient``-ed max)."""
        return self.all_reduce(x, dist.ReduceOp.MAX)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every shard's ``x`` concatenated along the last dim in rank
        order, outside autograd (the serve step's vocab shards)."""
        parts = self.tp.all_gather(x, self.group, kind="tensor")
        return torch.cat(parts.unbind(0), dim=-1)


class _CopyToTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce(g), None


class _ReduceFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return axis.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None
