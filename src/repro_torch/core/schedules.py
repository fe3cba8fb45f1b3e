"""Closed-form pipeline-schedule cost models — paper Tables 1 and 2,
extended with interleaved virtual-stage, early-backward and zero-bubble
schedules (the port's copy of ``repro/core/schedules.py``).

Ten schedules:

* ``1F1B-AS`` — async (FPGA-style) one-forward-one-backward.
* ``FBP-AS``  — async, FP and BP computed in parallel on each accelerator
  (FPDeep).  Same makespan, double activation memory, lower bandwidth demand.
* ``1F1B-SNO`` — synchronous, communication NOT overlapped with compute.
* ``1F1B-SO``  — synchronous, overlapped via doubled warm-up micro-batches
  (the paper's contribution). Double activation memory vs SNO.
* ``1F1B-I``  — async interleaved 1F1B over V *virtual stages* per device
  (beyond-paper; the Megatron/DAPPLE interleaving direction in PAPERS.md).
* ``1F1B-I-ML`` — memory-lean interleaved 1F1B (Megatron ordering from
  "Memory-Efficient Pipeline-Parallel DNN Training"): micro-batches advance
  in groups of N with warm-up ``2(N-n-1) + (V-1)N``, cutting the resident
  features term from ``(V-1)M`` to ``(V-1)N`` at the same makespan.
* ``DAPPLE`` — DAPPLE's early-backward synchronous schedule (arXiv
  2007.01045): warm-up ``N - i + 1`` then strict 1F1B alternation.  Same
  rows as 1F1B-AS; kept as its own entry because the runtime now executes
  its backward order as first-class ticks.
* ``ZB-H1`` — zero-bubble H1 (arXiv 2211.05953): every backward splits
  into an input-gradient op (B/2) that propagates the error and a
  weight-gradient op (B/2) that fills drain bubbles.  Makespan
  ``M(F+B) + (N-1)(F + B/2)`` — the ``(N-1)B/2`` saved is exactly the
  weight-grad work pulled off the critical path — at 1F1B's
  ``N - i + 1`` features row.
* ``ZB-H2`` — zero-bubble H2: warm-up deepens to ``2(N-i+1) - 1`` and
  weight-gradients bank past the drain, removing the whole flush bubble:
  makespan ``M(F+B) + (N-1)F`` (exact at the even-split design point
  ``B = 2F``; the work-and-fill floor elsewhere) at ~2x 1F1B's memory.
* ``ZB-AUTO`` — the automatic zero-bubble scheduler: a cost-driven list
  scheduler over F/B/W placement under a peak-live ``mem_limit`` knob;
  reports the scheduled (replayed) makespan, interpolating ZB-H1 (1F1B
  cap) through ZB-H2 to fully bubble-free (unbounded cap, M-deep memory).

The op orders behind these rows live in :mod:`repro_torch.core.schedplan` (the
schedule-plan IR); the features rows here are the algebraic form of
``SchedPlan.peak_live()``'s symbolic table replay, and the differential
suite pins the two (and the discrete-event simulator) together.

Symbols (paper):  M = micro-batches per mini-batch, N = pipeline stages,
F/B = per-micro-batch FP/BP compute time of one (balanced) stage,
SR = send/receive time of one stage boundary, a = activation bytes of one
stage boundary (per micro-batch), w = weight bytes of one stage,
i = stage index 1..N.

1F1B-I symbols and formulas (V = virtual-stage interleave depth):

* Each device owns V non-contiguous layer chunks; chunk v of device n is
  *virtual stage* v*N + n, so one micro-batch loops the device daisy chain
  V times.  A chunk costs F/V (FP) and B/V (BP).
* Makespan      t = (M*V + N - 1) * (F + B) / V
                  = M*(F+B) + (N-1)*(F+B)/V  — the flush bubble shrinks
  by the interleave depth V (requires M >= N so every chunk pass streams
  without stalling; the explorer gates candidates on this).
* Bubble        (N - 1) / (M*V + N - 1)   — strictly below 1F1B-AS's
                (N - 1) / (M + N - 1) for V > 1.
* Features      min(M*V, (V-1)*M + N - i + 1) live chunk activations on
  device i: the first V-1 passes of every micro-batch stay resident until
  their backward returns, plus the usual 1F1B (N - i + 1) in-flight window.
  V = 1 reduces exactly to the 1F1B-AS row.
* Bandwidth     V*a/F — the boundary is crossed once per chunk, i.e. V
  times more traffic per micro-batch in the same compute time.
"""
from __future__ import annotations

import dataclasses
import functools
import math

from repro_torch.core.schedplan import StageCosts


@dataclasses.dataclass(frozen=True)
class ScheduleEval:
    name: str
    minibatch_time: float
    bubble_fraction: float
    features_memory: tuple[float, ...]   # per stage i=1..N
    weights_memory: float                # per stage (2w: weights + grads)
    bandwidth_demand: float              # bytes/s needed to fully overlap
    V: int = 1                           # virtual-stage interleave depth


def _feat(mult: int, N: int, a: float) -> tuple[float, ...]:
    return tuple(float(mult * (N - i + 1)) * a for i in range(1, N + 1))


def eval_1f1b_as(M: int, N: int, F: float, B: float, SR: float,
                 a: float, w: float) -> ScheduleEval:
    t = (M + N - 1) * (F + B)
    return ScheduleEval(
        name="1F1B-AS", minibatch_time=t,
        bubble_fraction=(N - 1) / (M + N - 1),
        features_memory=_feat(1, N, a), weights_memory=2 * w,
        bandwidth_demand=(a / F) if F > 0 else float("inf"))


def eval_fbp_as(M: int, N: int, F: float, B: float, SR: float,
                a: float, w: float) -> ScheduleEval:
    t = (M + N - 1) * (F + B)
    return ScheduleEval(
        name="FBP-AS", minibatch_time=t,
        bubble_fraction=(N - 1) / (M + N - 1),
        features_memory=_feat(2, N, a), weights_memory=2 * w,
        bandwidth_demand=(2 * a / (F + B)) if F + B > 0 else float("inf"))


def eval_1f1b_sno(M: int, N: int, F: float, B: float, SR: float,
                  a: float, w: float) -> ScheduleEval:
    extra = (N + M - 2 - math.ceil((M - 1) / N)) * 2 * SR
    t = (M + N - 1) * (F + B) + extra
    bubble = ((N - 1) * (F + B + 2 * SR)
              + (M - 1 - math.ceil((M - 1) / N)) * 2 * SR) / t if t else 0.0
    return ScheduleEval(
        name="1F1B-SNO", minibatch_time=t, bubble_fraction=bubble,
        features_memory=_feat(1, N, a), weights_memory=2 * w,
        bandwidth_demand=(a / F) if F > 0 else float("inf"))


def eval_1f1b_so(M: int, N: int, F: float, B: float, SR: float,
                 a: float, w: float) -> ScheduleEval:
    t = (M + N - 1) * (F + B) + (N - 1) * 2 * SR
    bubble = (N - 1) * (F + B + 2 * SR) / t if t else 0.0
    return ScheduleEval(
        name="1F1B-SO", minibatch_time=t, bubble_fraction=bubble,
        features_memory=_feat(2, N, a), weights_memory=2 * w,
        bandwidth_demand=(a / F) if F > 0 else float("inf"))


def eval_dapple(M: int, N: int, F: float, B: float, SR: float,
                a: float, w: float) -> ScheduleEval:
    """DAPPLE early-backward schedule (arXiv 2007.01045): warm-up
    ``N - i + 1`` forwards then strict 1F1B alternation.  The rows ARE
    1F1B-AS's (derived, so they can never diverge) — the point of the
    entry is that the runtime now *executes* the early-backward order
    (first-class B ticks), so the row names the schedule it actually
    runs."""
    return dataclasses.replace(eval_1f1b_as(M, N, F, B, SR, a, w),
                               name="DAPPLE")


def eval_zb_h1(M: int, N: int, F: float, B: float, SR: float,
               a: float, w: float) -> ScheduleEval:
    """Zero-bubble H1 (arXiv 2211.05953): the backward splits evenly into
    an input-gradient op ``b = B/2`` (sends the error upstream) and a
    weight-gradient op ``w = B/2`` (no boundary edges; fills what would
    otherwise be drain bubbles).

    Makespan ``M(F + B) + (N-1)(F + B/2)`` — differentially pinned against
    the op-table replay in the simulator: errors propagate upstream at
    ``b = B/2`` per hop instead of the full ``B``, and each drain wait is
    filled by exactly one W, so ``(N-1) B/2`` of weight-grad work leaves
    the critical path.  Peak resident features stay at 1F1B's
    ``N - i + 1`` row (each W directly follows its B).  Bubble strictly
    below 1F1B-AS for N > 1."""
    b = B / 2.0
    t = M * (F + B) + (N - 1) * (F + b)
    bubble = (N - 1) * (F + b) / t if t else 0.0
    return ScheduleEval(
        name="ZB-H1", minibatch_time=t, bubble_fraction=bubble,
        features_memory=_feat(1, N, a), weights_memory=2 * w,
        bandwidth_demand=(a / F) if F > 0 else float("inf"))


def eval_zb_h2(M: int, N: int, F: float, B: float, SR: float,
               a: float, w: float) -> ScheduleEval:
    """Zero-bubble H2 (arXiv 2211.05953): the bubble-free hand-crafted
    point.  Warm-up deepens to ``2(N-i+1) - 1`` forwards and the
    downstream devices bank weight-gradients past the drain, so after the
    unavoidable ``(N-1)F`` fill ramp no device idles:

        makespan  t = M(F + B) + (N-1) F

    — the whole ``(N-1)(F + B)`` 1F1B flush bubble is gone, paid for with
    the ``max(2(N-i+1)-1, i-1+ceil((N+1)/2))`` features row (~2x 1F1B's
    warm-up memory; ZB-H1 keeps 1F1B's row but only halves the drain
    term).  The reported makespan is the op-table *replay* (so the
    explorer ranks an achievable number): it EQUALS the closed form above
    at the even-split design point ``B == 2F`` for ``M >= 2N - 1`` —
    differentially pinned — while at other cost ratios the closed form is
    only the work-and-fill *floor* (a strict lower bound any V=1 schedule
    obeys) that the static table's unit-cost W weave may miss; the
    cost-adaptive ``ZB-AUTO`` entry adapts the weave instead."""
    from repro_torch.core.schedplan import build_zb_h2, live_activation_counts
    from repro_torch.core.simulator import simulate
    t = simulate(build_zb_h2(M, N), M, N, F, B, 0.0).makespan
    bubble = 1.0 - M * (F + B) / t if t else 0.0
    feats = tuple(float(c) * a
                  for c in live_activation_counts("ZB-H2", M, N))
    return ScheduleEval(
        name="ZB-H2", minibatch_time=t, bubble_fraction=bubble,
        features_memory=feats, weights_memory=2 * w,
        bandwidth_demand=(a / F) if F > 0 else float("inf"))


def eval_zb_auto(M: int, N: int, F: float, B: float, SR: float,
                 a: float, w: float, mem_limit=None,
                 w_frac: float = 0.5) -> ScheduleEval:
    """Automatic zero-bubble scheduler (arXiv 2211.05953's heuristic):
    :func:`repro_torch.core.schedplan.build_zb_auto` places F/B/W ops under the
    ``mem_limit`` peak-live cap with the actual op costs, and this entry
    reports the *scheduled* makespan — the discrete-event replay of the
    emitted table, not a formula — plus the peak-live row from the IR's
    symbolic replay.  ``B`` is the full backward; ``w_frac`` of it is the
    weight-gradient half.  With an unbounded cap the steady state is
    bubble-free (only the fill/drain ramp remains; peak-live climbs to
    M); under the 1F1B cap the table IS ZB-H1's, so this entry always
    interpolates the zero-bubble family along the memory axis."""
    from repro_torch.core.schedplan import build_zb_auto
    from repro_torch.core.simulator import simulate
    plan = build_zb_auto(M, N, costs=(F, B * (1 - w_frac), B * w_frac),
                         mem_limit=mem_limit)
    sim = simulate(plan, M, N, F, B, 0.0, w_frac=w_frac)
    t = sim.makespan
    feats = tuple(float(c) * a for c in plan.peak_live())
    return ScheduleEval(
        name="ZB-AUTO", minibatch_time=t,
        bubble_fraction=1.0 - M * (F + B) / t if t else 0.0,
        features_memory=feats, weights_memory=2 * w,
        bandwidth_demand=(a / F) if F > 0 else float("inf"))


# ---------------------------------------------------------------------------
# Heterogeneous per-device cost forms (the StageCosts vector interface).
#
# BaPipe's §V clusters are heterogeneous; the scalar forms above see only
# the bottleneck device.  Each ``eval_*_hetero`` takes the full
# :class:`~repro_torch.core.schedplan.StageCosts` vector and reports the
# *scheduled* makespan — the discrete-event replay of the schedule's op
# table under per-device durations, free comm (the same async-overlap
# premise as the uniform Table-1 forms; per-hop SR is carried for the
# SR-aware builder/simulator path).  A uniform vector delegates to the
# scalar closed form, so the reduction is bit-exact; elsewhere the
# analytic generalisation :func:`hetero_makespan_floor` brackets the
# replay from below (exact again at each form's design point), the same
# premise-plus-bracket contract as the 1F1B-I latency form.
# ---------------------------------------------------------------------------

def hetero_makespan_floor(M: int, costs: StageCosts,
                          drain: str = "full") -> float:
    """Generalised bottleneck lower bound for a heterogeneous chain —
    every path is forced by device serialisation plus chain
    dependencies, so each variant bounds its schedule's replay from
    below at ANY cost vector and recovers the uniform closed form
    exactly at its design point.

    * ``"none"``  — work-and-fill, valid for every V=1 schedule:
      ``max_n [ sum_{k<n} F_k + M (F_n + B_n + W_n) ]`` (micro-batch 0
      cannot reach device n before the upstream forwards run once, and
      the device serialises all its own work).  Uniform:
      ``M(F+B) + (N-1)F`` — the ZB-H2 / unbounded-zb-auto form.
    * ``"full"``  — two-op schedules (1F1B/DAPPLE): after device n's
      last backward the error recrosses the upstream devices at the
      FULL backward per hop:
      ``max_n [ sum_{k<n} F_k + M (F_n + B_n + W_n) + sum_{k<n} (B_k
      + W_k) ]``.  Uniform: ``(M+N-1)(F+B)``.
    * ``"input"`` — the ZB-H1 drain shape: device n's last
      input-gradient comes after M forwards, M input-gradients and
      M-1 interleaved weight-gradients; the error then recrosses
      upstream at the input-gradient half per hop, and stage 0 still
      owes its final weight-gradient:
      ``max_n [ sum_{k<n} F_k + M (F_n + B_n) + (M-1) W_n
      + sum_{k<n} B_k + W_0 ]``.  Uniform even split:
      ``M(F+B) + (N-1)(F + B/2)``."""
    if drain not in ("full", "input", "none"):
        raise ValueError(f"drain must be full|input|none, got {drain!r}")
    F, W, Bf, Bi = costs.F, costs.W, costs.B_full, costs.B
    best = 0.0
    for n in range(costs.n):
        if drain == "input":
            t = (sum(F[:n]) + M * (F[n] + Bi[n]) + (M - 1) * W[n]
                 + sum(Bi[:n]) + W[0])
        else:
            t = sum(F[:n]) + M * (F[n] + Bf[n])
            if drain == "full":
                t += sum(Bf[:n])
        best = max(best, t)
    return best


@functools.lru_cache(maxsize=256)
def _replay_hetero(name: str, M: int, N: int, costs: StageCosts,
                   mem_limit=None, V: int = 1, comm: str | None = None):
    """(plan, SimResult) of a builder's table under per-device durations
    — the scheduled heterogeneous makespan the hetero evals report.
    ``zb-auto`` builds the cost-shaped table from the vector; ``V > 1``
    replays the interleaved builders' chunked tables; ``comm`` selects
    the simulator's communication model (the sync forms replay under
    ``blocking``/``latency`` with the vector's own per-hop SR; the
    default ``None`` keeps the schedule's free-comm async premise, SR
    stripped).  Cached: the explorer evaluates several schedules per
    candidate partition and DAPPLE shares 1F1B's table, so identical
    (table, costs) replays recur (StageCosts is frozen, so the key is
    by value)."""
    from repro_torch.core import schedplan as SP
    from repro_torch.core.simulator import simulate
    if name == "zb-auto":
        plan = SP.build_zb_auto(
            M, N, costs=(list(costs.F), list(costs.B), list(costs.W)),
            mem_limit=mem_limit)
    else:
        plan = SP.build_schedule(name, M, N, V)
    SR = (list(costs.sr_hops) if comm in ("latency", "blocking")
          else 0.0)
    sim = simulate(plan, M, N, list(costs.F), list(costs.B_full), SR,
                   V=V, comm=comm, w_frac=list(costs.w_frac))
    return plan, sim


def _hetero_eval(name: str, M: int, N: int, costs: StageCosts,
                 a: float, w: float, sim, feats) -> ScheduleEval:
    work = max(f + b for f, b in zip(costs.F, costs.B_full))
    t = sim.makespan
    return ScheduleEval(
        name=name, minibatch_time=t,
        bubble_fraction=1.0 - M * work / t if t else 0.0,
        features_memory=feats, weights_memory=2 * w,
        bandwidth_demand=(a / min(costs.F)) if min(costs.F) > 0
        else float("inf"))


def eval_1f1b_as_hetero(M: int, N: int, costs: StageCosts,
                        a: float, w: float) -> ScheduleEval:
    """1F1B-AS under a per-device cost vector: the replayed op-table
    makespan (>= :func:`hetero_makespan_floor` with the full-backward
    drain; equal to it for uniform vectors, where this delegates)."""
    if costs.uniform:
        return eval_1f1b_as(M, N, costs.F[0], costs.B_full[0],
                            max(costs.sr_hops, default=0.0), a, w)
    _, sim = _replay_hetero("1f1b", M, N, costs)
    return _hetero_eval("1F1B-AS", M, N, costs, a, w, sim, _feat(1, N, a))


def eval_fbp_as_hetero(M: int, N: int, costs: StageCosts,
                       a: float, w: float) -> ScheduleEval:
    """FBP-AS (doubled warm-up) under a per-device cost vector: same
    replayed makespan story as 1F1B-AS at the 2x features row and the
    gentler ``2a/(F+B)`` bandwidth demand."""
    if costs.uniform:
        return eval_fbp_as(M, N, costs.F[0], costs.B_full[0],
                           max(costs.sr_hops, default=0.0), a, w)
    _, sim = _replay_hetero("1f1b-2x", M, N, costs)
    ev = _hetero_eval("FBP-AS", M, N, costs, a, w, sim, _feat(2, N, a))
    fb = min(f + b for f, b in zip(costs.F, costs.B_full))
    return dataclasses.replace(
        ev, bandwidth_demand=(2 * a / fb) if fb > 0 else float("inf"))


def eval_dapple_hetero(M: int, N: int, costs: StageCosts,
                       a: float, w: float) -> ScheduleEval:
    """DAPPLE == synchronous 1F1B (derived, as in the scalar forms)."""
    return dataclasses.replace(eval_1f1b_as_hetero(M, N, costs, a, w),
                               name="DAPPLE")


def eval_zb_h1_hetero(M: int, N: int, costs: StageCosts,
                      a: float, w: float) -> ScheduleEval:
    """Zero-bubble H1 under a per-device cost vector: the split-backward
    table replayed at each device's own (F, B, W) — errors cross hop k
    after only ``B_k`` (not ``B_k + W_k``) of work.  Uniform even-split
    vectors delegate to the exact ``M(F+B) + (N-1)(F + B/2)`` form."""
    if costs.uniform and costs.even_split:
        return eval_zb_h1(M, N, costs.F[0], costs.B_full[0],
                          max(costs.sr_hops, default=0.0), a, w)
    _, sim = _replay_hetero("zb-h1", M, N, costs)
    return _hetero_eval("ZB-H1", M, N, costs, a, w, sim, _feat(1, N, a))


def eval_zb_h2_hetero(M: int, N: int, costs: StageCosts,
                      a: float, w: float) -> ScheduleEval:
    """Zero-bubble H2 under a per-device cost vector: the hand-crafted
    bubble-free table replayed at per-device durations, bracketed below
    by the work-and-fill floor (``drain="none"``); uniform even-split
    vectors delegate to :func:`eval_zb_h2`."""
    if costs.uniform and costs.even_split:
        return eval_zb_h2(M, N, costs.F[0], costs.B_full[0],
                          max(costs.sr_hops, default=0.0), a, w)
    from repro_torch.core.schedplan import live_activation_counts
    _, sim = _replay_hetero("zb-h2", M, N, costs)
    feats = tuple(float(c) * a
                  for c in live_activation_counts("ZB-H2", M, N))
    return _hetero_eval("ZB-H2", M, N, costs, a, w, sim, feats)


def eval_zb_auto_hetero(M: int, N: int, costs: StageCosts,
                        a: float, w: float,
                        mem_limit=None) -> ScheduleEval:
    """The automatic zero-bubble scheduler fed the *vector*: the greedy
    shapes its F/B/W table by each device's measured costs (and the
    builder's scalar-collapse portfolio guarantees the result is never
    worse than the table the old ``max``-collapsed interface would have
    produced, replayed at the true costs).  Reports the scheduled
    makespan plus the emitted table's peak-live row.  Uniform vectors
    delegate to :func:`eval_zb_auto` (any per-device ``w_frac``)."""
    if costs.uniform:
        return eval_zb_auto(M, N, costs.F[0], costs.B_full[0],
                            max(costs.sr_hops, default=0.0), a, w,
                            mem_limit=mem_limit, w_frac=costs.w_frac[0])
    if mem_limit is not None and not isinstance(mem_limit, (int, float)):
        mem_limit = tuple(mem_limit)     # hashable for the replay cache
    plan, sim = _replay_hetero("zb-auto", M, N, costs,
                               mem_limit=mem_limit)
    feats = tuple(float(c) * a for c in plan.peak_live())
    return _hetero_eval("ZB-AUTO", M, N, costs, a, w, sim, feats)


def eval_1f1b_interleaved(M: int, N: int, F: float, B: float, SR: float,
                          a: float, w: float, V: int = 2) -> ScheduleEval:
    """Interleaved 1F1B (see module docstring).  ``F``/``B``/``a``/``w`` are
    whole-device quantities (summed over the device's V chunks); the bubble
    shrinks by V while boundary traffic grows by V."""
    if V < 1:
        raise ValueError(f"V must be >= 1, got {V}")
    if M < N:
        # same precondition the simulator enforces: with fewer micro-batches
        # than devices the chunk passes cannot stream and this closed form
        # is an unachievable lower bound
        raise ValueError(f"1F1B-I needs M >= N to stream chunk passes "
                         f"(got M={M}, N={N})")
    t = (M * V + N - 1) * (F + B) / V
    feats = tuple(
        float(min(M * V, (V - 1) * M + (N - i + 1))) * a
        for i in range(1, N + 1))
    return ScheduleEval(
        name="1F1B-I", minibatch_time=t,
        bubble_fraction=(N - 1) / (M * V + N - 1),
        features_memory=feats, weights_memory=2 * w,
        bandwidth_demand=(V * a / F) if F > 0 else float("inf"),
        V=V)


def eval_1f1b_interleaved_memlean(M: int, N: int, F: float, B: float,
                                  SR: float, a: float, w: float,
                                  V: int = 2) -> ScheduleEval:
    """Memory-lean interleaved 1F1B (Megatron ordering; see
    :func:`repro_torch.core.schedplan.build_1f1b_interleaved_memlean`).

    Micro-batches advance in groups of N, cycling the V chunks inside each
    group, with warm-up ``2(N - n - 1) + (V-1)N``.  Makespan and bubble are
    identical to the streaming ``1F1B-I`` order, but the per-device peak
    resident features — derived by replaying the op table symbolically —
    drop to ``min(M*V, 2(N-i) + (V-1)N + 1)`` chunk activations: the
    ``(V-1)M`` term becomes ``(V-1)N``, so the row no longer grows with
    the micro-batch count.  Requires ``M % N == 0`` (Megatron's group
    constraint, which is also what lets the runtime consume every ring
    return the tick it arrives, deleting the [M, ...] park buffer)."""
    if V < 1:
        raise ValueError(f"V must be >= 1, got {V}")
    if M < N or M % N != 0:
        raise ValueError(
            f"1F1B-I-ML needs M % N == 0 (micro-batch groups of the "
            f"pipeline depth), got M={M}, N={N}")
    from repro_torch.core.schedplan import live_activation_counts
    t = (M * V + N - 1) * (F + B) / V
    feats = tuple(float(c) * a for c in
                  live_activation_counts("1F1B-I-ML", M, N, V))
    return ScheduleEval(
        name="1F1B-I-ML", minibatch_time=t,
        bubble_fraction=(N - 1) / (M * V + N - 1),
        features_memory=feats, weights_memory=2 * w,
        bandwidth_demand=(V * a / F) if F > 0 else float("inf"),
        V=V)


def latency_hops_1f1b_interleaved(M: int, N: int, V: int = 1) -> int:
    """Number of SR-latency hops on the 1F1B-I critical path under the
    ``latency`` comm model (transfers on a dedicated engine, SR each):

    ``2(N-1)`` fill/drain hops plus a warm-up->steady handover that
    zigzags between neighbouring saturated devices, collecting two hops
    per micro-batch except once every N micro-batches when the 1F1B
    phase realigns — ``2(M - 2 - floor((M-2)/N))`` in total.  At
    ``M == N`` (V > 1) the stream is tight: every one of the ``N(V-1)``
    chunk ring-returns sits on the critical path too (2 hops each).

    Exact (differentially pinned over randomized sweeps) whenever the
    per-hop latency is hideable: ``SR <= hideable_sr_1f1b_interleaved``.
    """
    if N <= 1:
        return 0
    hops = 2 * (M + N - 3 - (M - 2) // N)
    if M == N:
        hops += 2 * N * (V - 1)
    return hops


def hideable_sr_1f1b_interleaved(M: int, N: int, V: int, F: float,
                                 B: float) -> float:
    """Largest per-hop SR for which :func:`eval_1f1b_interleaved_latency`
    is exact (the paper-style "comm hideable" premise, as the seed suite's
    1F1B-SO pin clamps ``SR <= min(F, B)/2``): the zigzag critical path
    tolerates ``min(F, B)/(3V)`` per hop, and for V > 1 the chunk ring
    return must come back within its ``(M - N)``-element slack,
    ``(M - N) min(F, B)/(NV)``."""
    cap = min(F, B) / (3.0 * V)
    if V > 1 and M > N:
        cap = min(cap, (M - N) * min(F, B) / (N * V))
    return cap


def eval_1f1b_interleaved_latency(M: int, N: int, F: float, B: float,
                                  SR: float, a: float, w: float,
                                  V: int = 2) -> ScheduleEval:
    """1F1B-I under the ``latency`` comm model: the free-comm makespan
    plus ``SR`` per critical-path hop (:func:`latency_hops_1f1b_interleaved`).
    Exact for ``SR <= hideable_sr_1f1b_interleaved(M, N, V, F, B)``;
    beyond it transfers stall the stream and the value is a lower bound
    (the ``blocking`` model brackets from above)."""
    ev = eval_1f1b_interleaved(M, N, F, B, SR, a, w, V=V)
    t = ev.minibatch_time + latency_hops_1f1b_interleaved(M, N, V) * SR
    return dataclasses.replace(
        ev, minibatch_time=t,
        bubble_fraction=1.0 - M * V * (F + B) / V / t if t else 0.0)


def blocking_stall_1f1b_interleaved(M: int, N: int) -> float:
    """Rendezvous stalls on the 1F1B-I (V = 1) critical path under the
    ``blocking`` comm model, in units of the op cost ``c`` at the
    ``F == B == c`` design point.

    A blocking send has no transfer engine: the producer WAITS until its
    consumer posts the matching recv, so even as ``SR -> 0`` the warm-up
    wavefront serializes device by device and the steady-state zigzag
    collects one extra rendezvous per micro-batch.  Fitted and then
    differentially pinned per-M (dense sweeps over ``N <= 8``,
    ``M <= 5N``), the stall count is affine in M with a
    triangular-number offset::

        g(M, N) = M + N(N - 1)/2 - 2        (N >= 2, N != 3)
        g(M, 3) = 2M - 2                    (the depth-3 anomaly)
        g(M, N <= 1) = 0

    At N == 3 the ring is short enough that BOTH neighbours of the
    middle device rendezvous with it every cycle — the stall count
    doubles its M slope instead of gaining the triangular offset."""
    if N <= 1:
        return 0.0
    if N == 3:
        return 2.0 * M - 2.0
    return float(M + N * (N - 1) // 2 - 2)


def blocking_hops_1f1b_interleaved(M: int, N: int) -> int:
    """Number of SR-latency hops on the 1F1B-I (V = 1) critical path
    under the ``blocking`` comm model — the coefficient of SR in the
    affine makespan, companion to :func:`blocking_stall_1f1b_interleaved`::

        h(M, N) = 2M + (N + 1)(N + 2)/2 - 6     (N >= 2, N != 3)
        h(M, 3) = 3M + 1
        h(M, N <= 1) = 0

    Blocking transfers put MORE hops on the path than the latency
    model's :func:`latency_hops_1f1b_interleaved` (compare ``~2M + N^2/2``
    against ``~2(M + N)``): with no engine to overlap into, every
    rendezvous the stall count ``g`` serializes also pays its wire time."""
    if N <= 1:
        return 0
    if N == 3:
        return 3 * M + 1
    return 2 * M + (N + 1) * (N + 2) // 2 - 6


def blockable_sr_1f1b_interleaved(M: int, N: int, F: float,
                                  B: float) -> float:
    """Largest per-hop SR for which :func:`eval_1f1b_interleaved_blocking`
    is exact (the blocking twin of :func:`hideable_sr_1f1b_interleaved`).
    The affine region's breakpoint was binary-searched per (M, N): depth
    1-2 rings are affine for ALL SR, depth 3 up to ``min(F, B)``, and
    deeper rings shrink like 1/M — ``min(F, B)/(M - 2)`` at N == 4 and
    ``min(F, B)/(2M - 6)`` for N >= 5 (exact integer reciprocals at
    every probed (M, N); past them a second rendezvous chain overtakes
    the pinned one and the makespan leaves the affine piece)."""
    if N <= 2:
        return float("inf")
    if N == 3:
        return min(F, B)
    if N == 4:
        return min(F, B) / (M - 2)
    return min(F, B) / (2 * M - 6)


def eval_1f1b_interleaved_blocking(M: int, N: int, F: float, B: float,
                                   SR: float, a: float,
                                   w: float) -> ScheduleEval:
    """1F1B-I under the ``blocking`` comm model (V = 1): the free-comm
    makespan plus ``g`` rendezvous stalls of ``min(F, B)`` each
    (:func:`blocking_stall_1f1b_interleaved`) plus ``SR`` per
    critical-path hop (:func:`blocking_hops_1f1b_interleaved`).

    Exact at the ``F == B`` design point for
    ``SR <= blockable_sr_1f1b_interleaved(M, N, F, B)`` —
    differentially pinned over randomized (M, N, c, SR) sweeps up to
    N = 10 — and a lower bound beyond the SR premise.  Off the
    ``F == B`` point the stall pattern is irregular; the value remains
    a lower bound for N != 3 (the depth-3 anomaly can overshoot)."""
    ev = eval_1f1b_interleaved(M, N, F, B, SR, a, w, V=1)
    t = (ev.minibatch_time
         + blocking_stall_1f1b_interleaved(M, N) * min(F, B)
         + blocking_hops_1f1b_interleaved(M, N) * SR)
    return dataclasses.replace(
        ev, minibatch_time=t,
        bubble_fraction=1.0 - M * (F + B) / t if t else 0.0)


def eval_1f1b_interleaved_hetero(M: int, N: int, costs: StageCosts,
                                 a: float, w: float,
                                 V: int = 2) -> ScheduleEval:
    """Interleaved 1F1B under a per-device cost vector: the V-chunk op
    table replayed at each device's own whole-device (F, B) — every
    chunk op costs 1/V of its device's row, so a slow device stretches
    all V of its passes and the stall surfaces in the scheduled
    makespan instead of vanishing into the bottleneck collapse (the
    bug this form fixes: the explorer used to feed V > 1 candidates
    the scalar closed form even on heterogeneous clusters).  Uniform
    vectors delegate to the exact :func:`eval_1f1b_interleaved`."""
    if costs.uniform:
        return eval_1f1b_interleaved(M, N, costs.F[0], costs.B_full[0],
                                     max(costs.sr_hops, default=0.0),
                                     a, w, V=V)
    _, sim = _replay_hetero("1f1b-interleaved", M, N, costs, V=V)
    feats = tuple(float(min(M * V, (V - 1) * M + (N - i + 1))) * a
                  for i in range(1, N + 1))
    ev = _hetero_eval("1F1B-I", M, N, costs, a, w, sim, feats)
    return dataclasses.replace(
        ev, V=V, bandwidth_demand=(V * a / min(costs.F))
        if min(costs.F) > 0 else float("inf"))


def eval_1f1b_interleaved_memlean_hetero(M: int, N: int,
                                         costs: StageCosts,
                                         a: float, w: float,
                                         V: int = 2) -> ScheduleEval:
    """Memory-lean interleaved 1F1B under a per-device cost vector:
    Megatron's grouped op table replayed at per-device durations, with
    the memlean ``min(M*V, 2(N-i) + (V-1)N + 1)`` features row.  Same
    preconditions as the scalar form (``M % N == 0``); uniform vectors
    delegate to :func:`eval_1f1b_interleaved_memlean`."""
    if costs.uniform:
        return eval_1f1b_interleaved_memlean(
            M, N, costs.F[0], costs.B_full[0],
            max(costs.sr_hops, default=0.0), a, w, V=V)
    if M < N or M % N != 0:
        raise ValueError(
            f"1F1B-I-ML needs M % N == 0 (micro-batch groups of the "
            f"pipeline depth), got M={M}, N={N}")
    from repro_torch.core.schedplan import live_activation_counts
    _, sim = _replay_hetero("1f1b-interleaved-memlean", M, N, costs, V=V)
    feats = tuple(float(c) * a for c in
                  live_activation_counts("1F1B-I-ML", M, N, V))
    ev = _hetero_eval("1F1B-I-ML", M, N, costs, a, w, sim, feats)
    return dataclasses.replace(
        ev, V=V, bandwidth_demand=(V * a / min(costs.F))
        if min(costs.F) > 0 else float("inf"))


def eval_1f1b_sno_hetero(M: int, N: int, costs: StageCosts,
                         a: float, w: float) -> ScheduleEval:
    """Synchronous no-overlap 1F1B under a per-device cost vector: the
    1F1B table replayed under the ``blocking`` comm model with each
    hop's OWN SR — every transfer occupies both endpoint devices, as on
    sync-only hardware without a comm engine.  This replaces the old
    routing bug where heterogeneous sync candidates fell through to the
    scalar closed form at the worst-hop SR (double-counting the slow
    link on every hop).  Uniform vectors delegate to the exact
    :func:`eval_1f1b_sno` closed form."""
    if costs.uniform:
        return eval_1f1b_sno(M, N, costs.F[0], costs.B_full[0],
                             max(costs.sr_hops, default=0.0), a, w)
    _, sim = _replay_hetero("1f1b", M, N, costs, comm="blocking")
    return _hetero_eval("1F1B-SNO", M, N, costs, a, w, sim,
                        _feat(1, N, a))


def eval_1f1b_so_hetero(M: int, N: int, costs: StageCosts,
                        a: float, w: float) -> ScheduleEval:
    """Synchronous overlapped 1F1B under a per-device cost vector: the
    1F1B table replayed under the ``latency`` comm model (dedicated
    comm engine, each hop paying its own SR on the wire but off the
    devices), keeping the scalar form's doubled features row (overlap
    needs the send buffer double-buffered).  Uniform vectors delegate
    to the exact :func:`eval_1f1b_so` closed form."""
    if costs.uniform:
        return eval_1f1b_so(M, N, costs.F[0], costs.B_full[0],
                            max(costs.sr_hops, default=0.0), a, w)
    _, sim = _replay_hetero("1f1b", M, N, costs, comm="latency")
    return _hetero_eval("1F1B-SO", M, N, costs, a, w, sim,
                        _feat(2, N, a))


#: Schedules with a heterogeneous vector form (the explorer feeds these
#: the partition's per-device StageCosts instead of the bottleneck
#: collapse; ZB-AUTO additionally takes ``mem_limit``, the interleaved
#: forms ``V``).
HETERO_SCHEDULES = {
    "1F1B-AS": eval_1f1b_as_hetero,
    "FBP-AS": eval_fbp_as_hetero,
    "1F1B-SNO": eval_1f1b_sno_hetero,
    "1F1B-SO": eval_1f1b_so_hetero,
    "1F1B-I": eval_1f1b_interleaved_hetero,
    "1F1B-I-ML": eval_1f1b_interleaved_memlean_hetero,
    "DAPPLE": eval_dapple_hetero,
    "ZB-H1": eval_zb_h1_hetero,
    "ZB-H2": eval_zb_h2_hetero,
    "ZB-AUTO": eval_zb_auto_hetero,
}


SCHEDULES = {
    "1F1B-AS": eval_1f1b_as,
    "FBP-AS": eval_fbp_as,
    "1F1B-SNO": eval_1f1b_sno,
    "1F1B-SO": eval_1f1b_so,
    "1F1B-I": eval_1f1b_interleaved,
    "1F1B-I-ML": eval_1f1b_interleaved_memlean,
    "DAPPLE": eval_dapple,
    "ZB-H1": eval_zb_h1,
    "ZB-H2": eval_zb_h2,
    "ZB-AUTO": eval_zb_auto,
}

ASYNC_SCHEDULES = ("1F1B-AS", "FBP-AS", "DAPPLE", "ZB-H1", "ZB-H2",
                   "ZB-AUTO", "1F1B-I", "1F1B-I-ML")
SYNC_SCHEDULES = ("1F1B-SNO", "1F1B-SO")


def schedules_for(async_capable: bool) -> tuple[str, ...]:
    """Hardware gating (paper §3.2): FPGA-like devices stream asynchronously,
    GPU-like devices must use the synchronous schedules.  The interleaved
    schedules (``1F1B-I``/``1F1B-I-ML``) rely on overlapping the
    V-times-denser boundary traffic, so they are offered to async-capable
    clusters only."""
    return ASYNC_SCHEDULES if async_capable else SYNC_SCHEDULES


# ---------------------------------------------------------------------------
# Overlapped data-parallel gradient synchronisation (the AR op kind).
#
# With pipeline x data parallelism every stage group runs its own
# gradient all-reduce over the data axis, and all of them cross the SAME
# data-axis links — DAPPLE's contention argument — so the fabric is one
# shared serial resource.  The sync-at-end baseline (the monolithic
# trailing all-reduce) releases every device's bucket at the drain barrier:
#
#     sequential = T + sum_n ar_n,        T = max_n T_n
#
# where T_n is device n's compute end and ar_n its bucket's fabric time.
# Scheduling each AR at its own release T_n instead (the schedule-plan
# AR ops) makes the sync a single-machine schedule with release times,
# whose makespan has a closed form: sort the ends ascending,
#
#     overlapped = max_j ( T_(j) + sum_{k >= j} ar_(k) )
#
# (any work-conserving grant order gives the same value).  Since every
# release is <= T, overlapped <= sequential ALWAYS, with equality
# exactly when every device drains at the same instant (zero tail
# stagger) — any bubbled builder's staggered drain strictly wins, and
# the schedules that already erased their bubble (the zero-bubble
# family) have the least stagger left to hide the sync in.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GradSyncEval:
    """Overlap-aware gradient-sync cost of one (schedule, ar) pair.
    ``exposed`` is the non-hidden sync time the mini-batch actually
    pays beyond the compute makespan; ``hidden`` is what the bubble
    absorbed versus the sync-at-end baseline."""
    name: str
    compute_makespan: float        # T: drain end without any sync
    overlapped: float              # makespan with scheduled AR ops
    sequential: float              # sync-at-end baseline: T + sum(ar)
    t_ends: tuple[float, ...]      # per-device compute end times
    ars: tuple[float, ...]         # per-device bucket fabric times
    groups: int = 1                # layer-group sub-buckets per device

    @property
    def exposed(self) -> float:
        return self.overlapped - self.compute_makespan

    @property
    def hidden(self) -> float:
        return self.sequential - self.overlapped


def grad_sync_fifo(t_ends, ars) -> float:
    """Makespan of the per-stage gradient buckets on the shared
    data-axis fabric: bucket n is released at its device's compute end
    ``t_ends[n]`` and occupies the fabric for ``ars[n]``.  Serves in
    release order (highest device first on ties, matching the tick
    lowering); the makespan is grant-order independent for any
    work-conserving order, and equals the closed form
    ``max_j (T_(j) + sum_{k>=j} ar_(k))`` over ascending-sorted ends."""
    busy = 0.0
    for end, _, a in sorted(
            (e, -n, a) for n, (e, a) in enumerate(zip(t_ends, ars))):
        busy = max(busy, end) + a
    return busy


def _grouped_releases(t_ends, ars, drains, groups: int):
    """Expand per-device buckets into ``groups`` layer-group sub-buckets.

    Splitting a bucket WITHOUT moving its release cannot reduce the
    work-conserving serial-fabric makespan (the closed form is invariant
    under same-release subdivision).  The win comes from EARLIER
    releases: the device's final drain op (duration ``drains[n]``)
    produces its layer gradients progressively in reverse-layer order,
    so layer group ``g`` of ``G`` retires at

        t(n, g) = T_n - drains[n] * (G - 1 - g) / G

    — the last group at the compute end, the first a full drain-op
    earlier — each carrying ``ar_n / G`` of the fabric time.  With
    ``groups == 1`` this is exactly the ungrouped release list."""
    if groups < 1:
        raise ValueError(f"groups must be >= 1, got {groups}")
    rel, sub = [], []
    for T_n, a, D in zip(t_ends, ars, drains):
        for g in range(groups):
            rel.append(T_n - D * (groups - 1 - g) / groups)
            sub.append(a / groups)
    return rel, sub


def _drain_durations(events, N: int) -> tuple[float, ...]:
    """Per-device duration of the LAST compute op, from a simulator
    event log (``(start, end, kind, m, vstage)``; device = vstage %
    N).  This is the op whose progressive completion the grouped
    sub-releases model."""
    dur = [0.0] * N
    last = [-1.0] * N
    for s, e, _kind, _m, vs in events:
        n = vs % N
        if e >= last[n]:
            last[n] = e
            dur[n] = e - s
    return tuple(dur)


def _uniform_drain_durs(name: str, B: float, w_frac: float,
                        N: int) -> tuple[float, ...] | None:
    """Closed-form final-drain-op durations matching
    :func:`_uniform_drain_ends`: the two-op schedules end on a full
    backward, zb-h1 tucks the final W (the ``w_frac`` share) behind the
    drain hop."""
    from repro_torch.core.schedplan import canonical_name
    cname = canonical_name(name)
    if cname in ("gpipe", "1f1b", "dapple"):
        return (B,) * N
    if cname == "zb-h1":
        return (B * w_frac,) * N
    return None


def _uniform_drain_ends(name: str, M: int, N: int, F: float, B: float,
                        w_frac: float) -> tuple[float, ...] | None:
    """Closed-form per-device compute end times under uniform costs.

    The last op of device n in every early-backward V=1 schedule is the
    tail of micro-batch M-1's backward chain, which recrosses the
    stages at the full backward per hop (gpipe/1f1b/dapple) or at the
    input-gradient half per hop with the final W tucked right behind
    it (zb-h1), so the drain is staggered: ``T_n = T - n * stagger``.  Returns None
    for schedules whose drain has no simple uniform form (the zb-h2 /
    zb-auto banked-W tables, interleaved chunk passes) — callers fall
    back to the discrete-event replay."""
    from repro_torch.core.schedplan import canonical_name
    cname = canonical_name(name)
    if cname in ("gpipe", "1f1b", "dapple"):
        T = (M + N - 1) * (F + B)
        return tuple(T - n * B for n in range(N))
    if cname == "zb-h1":
        Bx = B * (1.0 - w_frac)    # input-gradient half: the drain hop
        T = M * (F + B) + (N - 1) * (F + Bx)
        return tuple(T - n * Bx for n in range(N))
    return None


def eval_grad_sync(name: str, M: int, N: int, F: float, B: float,
                   ar, w_frac: float = 0.5, V: int = 1,
                   mem_limit=None, groups: int = 1) -> GradSyncEval:
    """Overlap-aware closed form for the exposed gradient-sync time of
    a schedule under uniform per-device costs.  ``ar`` is the
    per-device bucket fabric time (scalar or length-N).  Uses the
    analytic drain ends where the uniform form exists
    (:func:`_uniform_drain_ends`) and the discrete-event replay
    otherwise; the two agree for every builder (differentially
    tested).  ``groups > 1`` splits each device's bucket into
    per-layer-group sub-buckets released progressively through the
    final drain op (:func:`_grouped_releases`) — exposed sync is
    non-increasing in ``groups``."""
    if groups < 1:
        raise ValueError(f"groups must be >= 1, got {groups}")
    ars = tuple([float(ar)] * N if isinstance(ar, (int, float))
                else [float(a) for a in ar])
    if len(ars) != N:
        raise ValueError(f"ar needs one entry per device ({N}), "
                         f"got {len(ars)}")
    ends = _uniform_drain_ends(name, M, N, F, B, w_frac) if V == 1 else None
    drains = _uniform_drain_durs(name, B, w_frac, N) if ends else None
    if ends is None:
        from repro_torch.core.schedplan import build_schedule
        from repro_torch.core.simulator import simulate
        plan = build_schedule(name, M, N, V, mem_limit=mem_limit)
        sim = simulate(plan, M, N, F, B, 0.0, V=V, w_frac=w_frac)
        ends = tuple(sim.t_end)
        drains = _drain_durations(sim.events, N)
    rel, sub = _grouped_releases(ends, ars, drains, groups)
    T = max(ends)
    return GradSyncEval(
        name=name, compute_makespan=T,
        overlapped=grad_sync_fifo(rel, sub),
        sequential=T + sum(ars), t_ends=ends, ars=ars, groups=groups)


def eval_grad_sync_costs(name: str, M: int, N: int, costs: StageCosts,
                         ar, mem_limit=None, groups: int = 1) -> GradSyncEval:
    """Heterogeneous form of :func:`eval_grad_sync`: per-device drain
    ends from the cost-shaped replay (:func:`_replay_hetero`), so the
    exposed sync the explorer ranks by matches what the simulator pins
    on skewed clusters.  ``groups`` as in :func:`eval_grad_sync`, with
    the drain-op durations read off the replay's event log."""
    if groups < 1:
        raise ValueError(f"groups must be >= 1, got {groups}")
    ars = tuple([float(ar)] * N if isinstance(ar, (int, float))
                else [float(a) for a in ar])
    if len(ars) != N:
        raise ValueError(f"ar needs one entry per device ({N}), "
                         f"got {len(ars)}")
    _, sim = _replay_hetero(canonical_replay_name(name), M, N, costs,
                            mem_limit=mem_limit)
    ends = tuple(sim.t_end)
    rel, sub = _grouped_releases(ends, ars, _drain_durations(sim.events, N),
                                 groups)
    T = max(ends)
    return GradSyncEval(
        name=name, compute_makespan=T,
        overlapped=grad_sync_fifo(rel, sub),
        sequential=T + sum(ars), t_ends=ends, ars=ars, groups=groups)


def eval_grad_sync_2bw(name: str, M: int, N: int, F: float, B: float,
                       ar, w_frac: float = 0.5, V: int = 1,
                       mem_limit=None) -> GradSyncEval:
    """Steady-state sync cost under PipeDream-2BW double-buffered
    weights: step k's gradient all-reduce is consumed only at step
    k+1's weight apply, so the collective has a full step of slack and
    is never on the critical path — ``overlapped == compute_makespan``
    (exposed == 0) whenever the fabric can drain ``sum(ar)`` within one
    step, i.e. ``sum(ar) <= compute_makespan``.  Beyond that the
    fabric itself is the bottleneck and the step pays the excess."""
    sync = eval_grad_sync(name, M, N, F, B, ar, w_frac=w_frac, V=V,
                          mem_limit=mem_limit)
    T = sync.compute_makespan
    total_ar = sum(sync.ars)
    return GradSyncEval(
        name=name, compute_makespan=T,
        overlapped=max(T, total_ar),
        sequential=sync.sequential, t_ends=sync.t_ends, ars=sync.ars)


def canonical_replay_name(name: str) -> str:
    """Builder name for a schedule-table name (the grad-sync evals
    accept both the Table-1 names and the canonical builder names)."""
    from repro_torch.core.schedplan import canonical_name
    return canonical_name(name)
