"""Discrete-event simulator for intra-batch pipeline schedules (the port's
copy of ``repro/core/simulator.py``).

Every FP/BP of every micro-batch on every stage is a task; stage-boundary
transfers are tasks too.  Three communication models:

* ``free``     — transfers are instantaneous (paper's async figures omit SR:
                 "complete overlap by asynchronous execution").
* ``latency``  — transfers take SR on a dedicated comm engine, overlapping
                 compute (1F1B-SO's doubled warm-up makes this hideable).
* ``blocking`` — a transfer occupies *both* end-point devices for SR
                 (1F1B-SNO: synchronous execution, no overlap).

Op orders come from the schedule-plan IR (:mod:`repro_torch.core.
schedplan`): ``simulate`` builds the per-device op table once and replays
it.  Interleaved 1F1B (``1F1B-I``) runs V *virtual stages* per device
(virtual stage ``v*N + n`` is chunk v of device n); per-chunk compute
time is the device time divided by V.  For zero-bubble plans (``zb-h1``,
``zb-h2``, ``zb-auto``) the backward splits into an input-gradient ``B``
op and a weight-gradient ``W`` op (``w_frac`` of the full backward, no
transfer).  Cost- or cap-parameterised ``zb-auto`` tables are replayed by
passing the prebuilt :class:`~repro_torch.core.schedplan.SchedPlan` as
``schedule``; :func:`repro_torch.core.schedplan.build_zb_auto` does so
for its portfolio steps.

The simulator also tracks the peak number of live micro-batch activations
per device — the paper's "features memory" column; for W-bearing
(zero-bubble) plans this is read off the IR's ``peak_live()`` symbolic
replay, the same quantity the runtime's residual stash allocates — plus
each device's active window (``t_start``/``t_end``/``busy``), whose
``internal_idle`` is the schedule bubble with the fill/drain ramp
excluded (zero everywhere == bubble-free).

The gradient sync is replayable too: ``grad_sync=True`` appends the
schedule-plan AR ops (one bucketed data-parallel reduce-scatter/
all-gather per device chunk, ready when the bucket's last B/W retires)
and ``ar`` gives the per-device bucket duration.  AR ops serialize on a
single shared data-axis fabric, so the overlapped makespan is never
worse than the sync-at-end baseline ``makespan + sum(ar)``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core import schedplan as SP


@dataclasses.dataclass
class SimResult:
    makespan: float
    peak_live: list[int]          # per device: peak resident activations
    idle: list[float]             # per device: total idle (bubble) time
    t_start: list[float] = dataclasses.field(default_factory=list)
    t_end: list[float] = dataclasses.field(default_factory=list)
    busy: list[float] = dataclasses.field(default_factory=list)
    # per-op event log, one ``(start, end, kind, m, vstage)`` tuple per
    # compute op in start order
    events: list[tuple] = dataclasses.field(default_factory=list)
    # per-stage device widths (dp*tp chips behind each pipeline stage)
    # when the replay was costed from a width-annotated StageCosts —
    # annotation only, the durations already price the sharding
    widths: tuple = ()

    def bubble_fraction(self, stage: int = 0) -> float:
        return self.idle[stage] / self.makespan if self.makespan else 0.0

    @property
    def internal_idle(self) -> list[float]:
        """Per-device idle *inside* the device's own active window (first
        op start to last op end) — the schedule bubble proper, excluding
        the unavoidable pipeline fill/drain ramp.  A schedule is
        bubble-free exactly when this is zero everywhere (zb-h2 and
        unbounded zb-auto, for M >= 2N)."""
        return [(e - s) - b
                for s, e, b in zip(self.t_start, self.t_end, self.busy)]


# default communication model per schedule-table name (the paper's async
# figures omit SR; SNO pays it blocking, SO hides it behind compute)
_DEFAULT_COMM = {
    "gpipe": "free",
    "1F1B-AS": "free",
    # FBP-AS: FPGA spatial dataflow — FP and BP *timeshare* the DSP array,
    # so a (F, B) pair still costs F+B of device time (paper Table 1 keeps
    # the makespan equal to 1F1B-AS); what changes is the pipeline depth of
    # BP behind FP — doubled warm-up — hence 2x live activations and the
    # gentler 2a/(F+B) bandwidth demand.
    "FBP-AS": "free",
    "1F1B-SNO": "blocking",
    "1F1B-SO": "latency",
    "1F1B-I": "free",
    "1F1B-I-ML": "free",
    "1f1b": "free",
    "1f1b-2x": "free",
    "1f1b-interleaved": "free",
    "1f1b-interleaved-memlean": "free",
    # DAPPLE's early-backward order (== sync 1F1B) and the zero-bubble
    # family: all rely on overlapped boundary transfers
    "dapple": "free",
    "DAPPLE": "free",
    "zb-h1": "free",
    "zb_h1": "free",
    "ZB-H1": "free",
    "zb-h2": "free",
    "zb_h2": "free",
    "ZB-H2": "free",
    "zb-auto": "free",
    "zb_auto": "free",
    "ZB-AUTO": "free",
}


def op_durations(N: int, V: int, Fs: Sequence[float], Bs: Sequence[float],
                 wfs: Sequence[float], has_w: bool,
                 ars: Sequence[float] | None = None,
                 ar_groups: int = 1) -> dict:
    """Per-virtual-stage op durations.  For W-bearing plans the full
    backward ``Bs`` splits into an input-gradient ``B`` op
    (``1 - w_frac``) and a weight-gradient ``W`` op (``w_frac``); V > 1
    divides device time evenly across the device's chunks.  ``ars`` is
    the per-device gradient-sync time (the device's whole stage bucket
    crossing the data axis); each of the V chunk buckets costs an even
    1/V share, and each of a chunk's ``ar_groups`` layer-group
    sub-buckets an even share of that."""
    NS = N * V
    dur = {"F": [Fs[vs % N] / V for vs in range(NS)],
           "B": [Bs[vs % N] / V
                 * ((1.0 - wfs[vs % N]) if has_w else 1.0)
                 for vs in range(NS)],
           "W": [Bs[vs % N] / V * wfs[vs % N] for vs in range(NS)]}
    if ars is not None:
        dur["AR"] = [ars[vs % N] / V / ar_groups for vs in range(NS)]
    return dur


def simulate(schedule: str | SP.SchedPlan, M: int, N: int,
             F: float | Sequence[float], B: float | Sequence[float],
             SR: float | Sequence[float] = 0.0, V: int = 1,
             comm: str | None = None,
             w_frac: float | Sequence[float] = 0.5,
             ar: float | Sequence[float] | None = None,
             grad_sync: bool | int = False) -> SimResult:
    """Simulate one mini-batch of M micro-batches through N devices.

    ``schedule`` is a schedule name (the op table is built via
    :func:`repro_torch.core.schedplan.build_schedule`) or a prebuilt
    :class:`~repro_torch.core.schedplan.SchedPlan`.  ``V`` (>1 only for
    the interleaved schedules) interleaves V virtual stages per device.
    ``comm`` overrides the schedule's default communication model.

    Every duration knob takes a scalar or a vector: ``F``/``B`` per
    device (length N), ``SR`` per *hop* — length ``N*V - 1``, one entry
    per virtual-stage boundary — and ``w_frac`` per device (length N).
    For zero-bubble plans the ``B`` argument is the FULL per-micro-batch
    backward time of a device; ``w_frac`` is the fraction of it spent in
    the weight-gradient ``W`` op, the rest in the input-gradient ``B`` op.

    ``grad_sync=True`` appends the data-parallel gradient-sync AR ops
    (:func:`repro_torch.core.schedplan.add_grad_sync`) before replay;
    ``ar`` is the per-device sync duration (scalar or length-N, default
    0).  AR ops serialize on one fabric resource (at most one bucket in
    flight, ready buckets granted highest-device-first) and are
    unaffected by the stage-boundary ``comm`` model.  An integer
    ``grad_sync=G`` emits G per-layer-group sub-buckets per (device,
    chunk), each costing an even ``ar/V/G`` share."""
    Fs = list(F) if not isinstance(F, (int, float)) else [float(F)] * N
    Bs = list(B) if not isinstance(B, (int, float)) else [float(B)] * N
    if not len(Fs) == len(Bs) == N:
        raise ValueError(f"F and B need one entry per device ({N}), got "
                         f"{len(Fs)} and {len(Bs)}")
    wfs = (list(w_frac) if not isinstance(w_frac, (int, float))
           else [float(w_frac)] * N)
    if len(wfs) != N:
        raise ValueError(f"w_frac needs one entry per device ({N}), "
                         f"got {len(wfs)}")
    if not all(0.0 < wf < 1.0 for wf in wfs):
        raise ValueError(f"w_frac must be in (0, 1), got {w_frac}")
    n_hops = max(0, N * V - 1)
    SRs = (list(SR) if not isinstance(SR, (int, float))
           else [float(SR)] * n_hops)
    if len(SRs) != n_hops:
        raise ValueError(f"SR needs one entry per virtual-stage hop "
                         f"({n_hops}), got {len(SRs)}")
    if any(s < 0 for s in SRs):
        raise ValueError(f"SR must be >= 0, got {SR}")
    ars = None
    if ar is not None:
        ars = (list(ar) if not isinstance(ar, (int, float))
               else [float(ar)] * N)
        if len(ars) != N:
            raise ValueError(f"ar needs one entry per device ({N}), "
                             f"got {len(ars)}")
        if any(a < 0 for a in ars):
            raise ValueError(f"ar must be >= 0, got {ar}")

    if isinstance(schedule, SP.SchedPlan):
        plan = schedule
        if (plan.M, plan.N, plan.V) != (M, N, V):
            raise ValueError(
                f"plan {plan.name!r} is (M={plan.M}, N={plan.N}, "
                f"V={plan.V}); simulate() was asked for ({M}, {N}, {V})")
        if grad_sync:
            plan = SP.add_grad_sync(
                plan, groups=1 if grad_sync is True else int(grad_sync))
        default_comm = _DEFAULT_COMM.get(plan.name, "free")
    else:
        default_comm = _DEFAULT_COMM.get(schedule)
        if default_comm is None:
            raise ValueError(schedule)
        plan = SP.build_schedule(schedule, M, N, V, grad_sync=grad_sync)
    if plan.has_grad_sync and ars is None:
        ars = [0.0] * N
    has_w = plan.has_w
    orders = [[(op.kind, op.m, op.vstage) for op in ops]
              for ops in plan.device_ops]
    comm = comm or default_comm
    if comm not in ("free", "latency", "blocking"):
        raise ValueError(comm)

    NS = N * V                                 # virtual stages
    dur = op_durations(N, V, Fs, Bs, wfs, has_w, ars,
                       ar_groups=plan.grad_sync_groups or 1)

    # --- task state ------------------------------------------------------
    f_done = [[-1.0] * NS for _ in range(M)]   # completion time of F[m][vs]
    b_done = [[-1.0] * NS for _ in range(M)]
    w_done = [[-1.0] * NS for _ in range(M)]
    f_ready = [[-1.0] * NS for _ in range(M)]  # input-activation arrival
    b_ready = [[-1.0] * NS for _ in range(M)]  # error arrival
    for m in range(M):
        f_ready[m][0] = 0.0                    # stage 0 reads local data
    dev_free = [0.0] * N
    busy = [0.0] * N                           # accumulated busy time
    t_start: list = [None] * N                 # first compute-op start
    t_end = [0.0] * N                          # last compute-op end
    ptr = [0] * N                              # next op index
    n_done = 0
    total_ops = sum(len(o) for o in orders)
    event_log: list[tuple] = []

    def deliver(kind: str, m: int, vs_from: int, t_prod: float):
        """The (m, vstage, kind) an op's output is transferred to, or
        None (W and AR ops and the chain ends transfer nothing)."""
        if kind in ("W", "AR"):
            return None
        if kind == "F":
            if vs_from == NS - 1:
                b_ready[m][NS - 1] = t_prod    # loss: error available locally
                return None
            return (m, vs_from + 1, "F")
        if vs_from == 0:
            return None
        return (m, vs_from - 1, "B")

    pending_xfer: list[tuple[float, int, str, int, int]] = []

    def try_transfers():
        """Fire every pending transfer, eagerly, in ready order.  Under
        ``blocking`` a transfer seizes both end-point devices for SR as
        soon as it is ready — the conservative no-overlap model: devices
        never defer a ready transfer in favour of compute."""
        nonlocal pending_xfer
        for (rdy, m, kind, src, dst) in sorted(pending_xfer):
            sd, dd = src % N, dst % N
            sr = SRs[min(src, dst)]         # the hop's own link time
            if comm == "free" or sd == dd:
                (f_ready if kind == "F" else b_ready)[m][dst] = rdy
            elif comm == "latency":
                (f_ready if kind == "F" else b_ready)[m][dst] = rdy + sr
            else:                           # blocking: both devices busy SR
                start = max(rdy, dev_free[sd], dev_free[dd])
                dev_free[sd] = start + sr
                dev_free[dd] = start + sr
                busy[sd] += sr
                busy[dd] += sr
                (f_ready if kind == "F" else b_ready)[m][dst] = start + sr
        pending_xfer = []

    # --- main loop: repeatedly start the globally-earliest runnable op ----
    # AR ops share one data-axis fabric: at most one gradient bucket in
    # flight at a time; among equally-ready buckets the highest device
    # (deepest stage, first to drain) goes first, as the tick lowering
    # grants them
    fabric_free = 0.0
    ar_end = 0.0
    while n_done < total_ops:
        try_transfers()
        best = None                            # (key, n, kind, m, vs)
        for n in range(N):
            if ptr[n] >= len(orders[n]):
                continue
            kind, m, vs = orders[n][ptr[n]]
            if kind == "F" and f_ready[m][vs] >= 0:
                s = max(dev_free[n], f_ready[m][vs])
            elif kind == "B" and b_ready[m][vs] >= 0 and f_done[m][vs] >= 0:
                s = max(dev_free[n], b_ready[m][vs], f_done[m][vs])
            elif kind == "W" and b_done[m][vs] >= 0:
                s = max(dev_free[n], b_done[m][vs])
            elif kind == "AR":
                s = max(dev_free[n], fabric_free)
            else:
                continue
            key = (s, -n if kind == "AR" else 0)
            if best is None or key < best[0]:
                best = (key, n, kind, m, vs)
        if best is None:
            raise ValueError(f"{plan.name}: pipeline deadlock (bad op "
                             f"order)")
        (s, _), n, kind, m, vs = best
        d = dur[kind][vs]
        end = s + d
        event_log.append((s, end, kind, m, vs))
        dev_free[n] = end
        busy[n] += d
        if t_start[n] is None:
            t_start[n] = s
        t_end[n] = end
        if kind == "F":
            f_done[m][vs] = end
        elif kind == "B":
            b_done[m][vs] = end
        elif kind == "W":
            w_done[m][vs] = end
        else:
            fabric_free = end
            ar_end = max(ar_end, end)
        ptr[n] += 1
        tgt = deliver(kind, m, vs, end)
        if tgt is not None:
            tm, tvs, tkind = tgt
            pending_xfer.append((end, tm, tkind, vs, tvs))
        n_done += 1

    try_transfers()
    done_rows = w_done if has_w else b_done
    makespan = max(ar_end, max(max(r) for r in done_rows))

    # peak live activations per device.  W-bearing plans take the row
    # straight from the IR's symbolic replay — the schedule-plan table is
    # the single source of truth for what the runtime's residual stash
    # allocates; the event-time reconstruction below is kept for two-op
    # plans.
    if has_w:
        peak = plan.peak_live()
    else:
        peak = []
        for n in range(N):
            events = []
            for vs in range(n, NS, N):
                events += [(f_done[m][vs] - dur["F"][vs], +1)
                           for m in range(M)]
                events += [(done_rows[m][vs], -1) for m in range(M)]
            events.sort()
            live = pk = 0
            for _, delta in events:
                live += delta
                pk = max(pk, live)
            peak.append(pk)
    idle = [makespan - busy[n] for n in range(N)]
    return SimResult(makespan=makespan, peak_live=peak, idle=idle,
                     t_start=[0.0 if s is None else s for s in t_start],
                     t_end=t_end, busy=list(busy), events=event_log)


def simulate_costs(schedule: str | SP.SchedPlan, M: int, N: int,
                   costs: SP.StageCosts,
                   comm: str | None = None,
                   ar: float | Sequence[float] | None = None,
                   grad_sync: bool | int = False) -> SimResult:
    """Replay a (V == 1) schedule under a first-class
    :class:`~repro_torch.core.schedplan.StageCosts` vector: per-device F
    and full-backward durations, per-device ``w_frac`` split, per-hop SR.
    The default comm model is ``latency`` when any hop has a nonzero SR,
    ``free`` otherwise — matching the cost-shaped ``zb-auto`` builder's
    arrival model, so a builder's internal makespan and this replay
    agree.  The costs' per-stage ``width`` annotation is carried onto the
    result."""
    if costs.n != N:
        raise ValueError(f"costs are for {costs.n} devices, "
                         f"simulate_costs was asked for N={N}")
    sr = list(costs.sr_hops)
    if comm is None:
        comm = "latency" if any(s > 0 for s in sr) else "free"
    res = simulate(schedule, M, N, list(costs.F), list(costs.B_full),
                   sr, V=1, comm=comm, w_frac=list(costs.w_frac),
                   ar=ar, grad_sync=grad_sync)
    res.widths = tuple(costs.widths)
    return res
