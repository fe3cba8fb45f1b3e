"""BaPipe automatic exploration (paper Fig. 3; the port's copy of
``repro/core/explorer.py``).

Profile -> balanced partition -> schedule selection, with data parallelism
evaluated as a first-class alternative (the paper's ResNet-50 result: the
explorer must be able to answer "don't pipeline, use DP").
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

from repro_torch.core.hardware import ClusterSpec, FleetSpec
from repro_torch.core.partition import (PartitionPlan, comm_bound, coarse_partition,
                                  dp_partition, interleaved_partition,
                                  intra_layer_refine, memory_fine_tune,
                                  plan_costs_3d, stage_memory,
                                  stage_memory_3d)
from repro_torch.core.profiler import NetworkProfile, bwd_time, fwd_time
from repro_torch.core.schedules import (GradSyncEval, HETERO_SCHEDULES, SCHEDULES,
                                  ScheduleEval, eval_1f1b_interleaved,
                                  eval_1f1b_interleaved_hetero,
                                  eval_1f1b_interleaved_memlean,
                                  eval_1f1b_interleaved_memlean_hetero,
                                  eval_grad_sync, eval_grad_sync_costs,
                                  eval_zb_auto, eval_zb_auto_hetero,
                                  schedules_for)

FEAT_MULT = {"1F1B-AS": 1, "FBP-AS": 2, "1F1B-SNO": 1, "1F1B-SO": 2,
             "1F1B-I": 1, "1F1B-I-ML": 1, "DAPPLE": 1, "ZB-H1": 1,
             "ZB-H2": 1, "ZB-AUTO": 1}

INTERLEAVED_SCHEDULES = ("1F1B-I", "1F1B-I-ML")


@dataclasses.dataclass
class ExplorationResult:
    mode: str                       # "pipeline" | "data_parallel"
    schedule: Optional[str]
    M: int                          # micro-batches per mini-batch
    microbatch: int                 # units per micro-batch
    plan: Optional[PartitionPlan]
    minibatch_time: float
    per_stage_memory: list[float]
    feasible: bool
    sched_eval: Optional[ScheduleEval] = None
    dp_time: float = float("inf")
    dp_feasible: bool = False
    V: int = 1                      # virtual-stage interleave depth (1F1B-I)
    dp_degree: int = 1              # data replicas of the candidate mesh
    # overlap-aware gradient-sync cost of the winning candidate (dp > 1
    # only): minibatch_time already includes ``grad_sync_eval.exposed``
    grad_sync_eval: Optional[GradSyncEval] = None

    @property
    def speedup_over_dp(self) -> float:
        return self.dp_time / self.minibatch_time if self.minibatch_time else 0.0


# ---------------------------------------------------------------------------
# Data-parallel baseline model (synchronous ring all-reduce).
# ---------------------------------------------------------------------------

def dp_time_and_memory(prof: NetworkProfile, cluster: ClusterSpec,
                       minibatch: int) -> tuple[float, float, bool]:
    N = cluster.n
    per_dev = max(1, minibatch // N)
    slowest = 0.0
    for dev in cluster.devices:
        t = sum(fwd_time(l, dev, per_dev) + bwd_time(l, dev, per_dev)
                for l in prof.layers)
        if prof.embed is not None:
            t += fwd_time(prof.embed, dev, per_dev) + bwd_time(prof.embed, dev, per_dev)
        if prof.head is not None:
            t += fwd_time(prof.head, dev, per_dev) + bwd_time(prof.head, dev, per_dev)
        slowest = max(slowest, t)
    wbytes = prof.total_bytes_weights()
    if prof.embed is not None:
        wbytes += prof.embed.bytes_weights
    if prof.head is not None:
        wbytes += prof.head.bytes_weights
    # the gradient buckets ride the data-axis links, not the pipeline
    # boundary (per-axis bandwidth table in hardware.py)
    link = cluster.axis_bandwidth("data")
    allreduce = 2.0 * (N - 1) / N * wbytes / link if N > 1 else 0.0
    t_total = slowest + allreduce
    act = sum(l.bytes_act_out for l in prof.layers) * per_dev
    mem = 2.0 * wbytes + act
    feasible = all(mem <= d.memory_capacity for d in cluster.devices)
    return t_total, mem, feasible


# ---------------------------------------------------------------------------
# The exploration loop.
# ---------------------------------------------------------------------------

def _candidate_Ms(minibatch: int, n_stages: int) -> list[int]:
    ms = []
    m = 1
    while m <= minibatch:
        ms.append(m)
        m *= 2
    # always consider M = 2N and 4N (enough to hide the bubble)
    for extra in (2 * n_stages, 4 * n_stages):
        if extra <= minibatch and extra not in ms:
            ms.append(extra)
    return sorted(ms)


def explore(prof: NetworkProfile, cluster: ClusterSpec, minibatch: int,
            candidate_Ms: Optional[Sequence[int]] = None,
            consider_dp: bool = True,
            candidate_Vs: Sequence[int] = (2, 4),
            mem_limit: Optional[int] = None,
            hetero: bool = True,
            dp_degree: int = 1) -> ExplorationResult:
    """Run the full BaPipe exploration and return the chosen plan.

    With ``hetero`` (the default) the V=1 async candidates are ranked by
    the *scheduled heterogeneous makespan*: the partition's per-device
    cost vector (``PartitionPlan.cost_vector()`` — per-device F and the
    profiled B/W backward split) feeds the ``eval_*_hetero`` forms,
    which replay the schedule's op table under per-device durations
    instead of collapsing ``plan.stage_costs`` to bottleneck scalars;
    the ``ZB-AUTO`` entry's table is *shaped* by the vector (and
    structurally never worse than the table the scalar collapse would
    build).  Uniform vectors reduce bit-exactly to the scalar forms.
    The vector also carries per-hop SR_n from each boundary's actual
    link bandwidth; the ranking itself keeps the async free-comm
    premise (as every Table-1 form does), while the SR-aware path —
    ``build_zb_auto(costs=StageCosts)`` + ``simulate_costs`` — consumes
    the hops directly.  ``hetero=False`` keeps the legacy scalar
    collapse — the uniform-cost baseline the differential tests and the
    skewed-cluster benchmark compare against.

    ``candidate_Vs`` are the interleave depths tried for the interleaved
    schedules (``1F1B-I`` and its memory-lean order ``1F1B-I-ML``; async
    clusters only); V=1 of 1F1B-I is identical to 1F1B-AS, which is always
    searched, so only V > 1 is explored here.  ``1F1B-I-ML`` matches
    1F1B-I's makespan with a smaller resident-features term, so it wins
    exactly when memory gates the streaming order (ties prefer the
    schedule found first).

    ``mem_limit`` caps the ``ZB-AUTO`` entry's peak-live row (None =
    unbounded).  The zero-bubble family degrades gracefully along the
    memory axis: unbounded ZB-AUTO is fully bubble-free at M resident
    activations, ZB-H2 keeps only the fill ramp at ~2x 1F1B's window,
    ZB-H1 halves the drain term at exactly 1F1B's window — so the
    explorer lands on the fastest entry whose features row fits the
    devices.

    ``dp_degree`` is the number of data replicas of the candidate mesh
    (``minibatch`` stays per-replica).  With ``dp_degree > 1`` every
    candidate additionally pays its gradient synchronisation over the
    ``data`` axis — but only the *exposed* part: the per-stage buckets
    are scheduled into the drain bubble (:func:`eval_grad_sync` /
    :func:`eval_grad_sync_costs`, the AR op model the simulator
    replays), so a bubbled schedule hides most of its sync and the DP
    degree enters the ranking honestly instead of as a flat
    ``sum(ar)`` tax.
    """
    N = cluster.n
    if dp_degree < 1:
        raise ValueError(f"dp_degree must be >= 1, got {dp_degree}")
    dp_t, dp_mem, dp_ok = dp_time_and_memory(prof, cluster, minibatch)
    async_ok = all(d.async_capable for d in cluster.devices)
    scheds = schedules_for(async_ok)
    best: Optional[ExplorationResult] = None
    Ms = list(candidate_Ms) if candidate_Ms else _candidate_Ms(minibatch, N)
    for sched in scheds:
        feat_mult = FEAT_MULT[sched]
        # async schedules fully overlap comm; sync-overlap hides comm too,
        # sync-no-overlap pays it on the critical path.
        overlap = sched != "1F1B-SNO"
        if sched in INTERLEAVED_SCHEDULES:
            # a device must own V chunks of >= 1 layer each
            Vs = tuple(v for v in candidate_Vs
                       if v > 1 and N * v <= prof.n_layers)
        else:
            Vs = (1,)
        for V in Vs:
            for M in Ms:
                if M < 1 or minibatch // M < 1:
                    continue
                if V > 1 and M < N:
                    continue       # interleave streaming constraint (M >= N)
                if sched == "1F1B-I-ML" and M % N != 0:
                    continue       # Megatron group constraint (M % N == 0)
                mb = minibatch // M
                plan = interleaved_partition(prof, cluster, mb, V,
                                             overlap=overlap)
                if comm_bound(plan):
                    plan = coarse_partition(prof, cluster, mb, overlap, V=V)
                plan, mem_ok = memory_fine_tune(prof, cluster, plan, mb,
                                                feat_mult, M, schedule=sched,
                                                mem_limit=mem_limit)
                if not comm_bound(plan) and V == 1:
                    # intra-layer (fractional) balancing LAST — memory
                    # fine-tuning re-finalises integer bounds and would
                    # discard the fractional shifts
                    plan = intra_layer_refine(prof, cluster, plan, mb)
                F, B = plan.bottleneck_FB()
                # sync/interleaved scalar forms keep the conservative
                # worst-hop SR; the hetero path carries the per-hop
                # SR_n vector inside plan.cost_vector() instead
                SR = max((max(c.comm_in, c.comm_out)
                          for c in plan.stage_costs), default=0.0)
                a = plan.max_boundary_act()
                w = max(c.weight_bytes for c in plan.device_costs())
                costs = plan.cost_vector() if hetero else None
                if V > 1 and sched == "1F1B-I-ML":
                    # hetero V > 1 replays the chunked table at per-device
                    # costs (used to fall through to the scalar closed form
                    # even on skewed clusters — the routing gap this fixes)
                    ev = (eval_1f1b_interleaved_memlean_hetero(
                              M, N, costs, a, w, V=V) if hetero
                          else eval_1f1b_interleaved_memlean(
                              M, N, F, B, SR, a, w, V=V))
                elif V > 1:
                    ev = (eval_1f1b_interleaved_hetero(M, N, costs, a, w,
                                                       V=V) if hetero
                          else eval_1f1b_interleaved(M, N, F, B, SR, a, w,
                                                     V=V))
                elif hetero and sched in HETERO_SCHEDULES:
                    # the sync schedules route here too now: replayed under
                    # blocking (SNO) / latency (SO) comm with per-hop SR
                    if sched == "ZB-AUTO":
                        ev = eval_zb_auto_hetero(M, N, costs, a, w,
                                                 mem_limit=mem_limit)
                    else:
                        ev = HETERO_SCHEDULES[sched](M, N, costs, a, w)
                elif sched == "ZB-AUTO":
                    ev = eval_zb_auto(M, N, F, B, SR, a, w,
                                      mem_limit=mem_limit)
                else:
                    ev = SCHEDULES[sched](M, N, F, B, SR, a, w)
                mem = stage_memory(plan, feat_mult, M, schedule=sched,
                                   mem_limit=mem_limit)
                t = ev.minibatch_time
                if not mem_ok:
                    # paper §4.3: weights kept on-chip "as much as
                    # possible"; the remainder streams from the spill tier
                    # every micro-batch
                    spill_bw = min(d.spill_bandwidth for d in cluster.devices)
                    if spill_bw <= 0:
                        continue
                    spill = max(m - d.memory_capacity
                                for m, d in zip(mem, cluster.devices))
                    t += M * spill / spill_bw
                gs = None
                if dp_degree > 1:
                    # per-stage bucket time: ring RS+AG of the stage's
                    # gradient bytes over the data-axis links
                    data_bw = cluster.axis_bandwidth("data")
                    ar_vec = [2.0 * (dp_degree - 1) / dp_degree
                              * c.weight_bytes / data_bw
                              for c in plan.device_costs()]
                    ml = mem_limit if sched == "ZB-AUTO" else None
                    if hetero and V == 1 and costs is not None:
                        gs = eval_grad_sync_costs(sched, M, N, costs,
                                                  ar_vec, mem_limit=ml)
                    else:
                        gs = eval_grad_sync(sched, M, N, F, B, ar_vec,
                                            V=V, mem_limit=ml)
                    t += gs.exposed
                cand = ExplorationResult(
                    mode="pipeline", schedule=sched, M=M, microbatch=mb,
                    plan=plan, minibatch_time=t,
                    per_stage_memory=mem, feasible=True, sched_eval=ev,
                    dp_time=dp_t, dp_feasible=dp_ok, V=V,
                    dp_degree=dp_degree, grad_sync_eval=gs)
                if best is None or cand.minibatch_time < best.minibatch_time \
                        * 0.999:
                    best = cand
                elif (cand.minibatch_time < best.minibatch_time * 1.001
                      and best.sched_eval is not None
                      and ev.bandwidth_demand
                      < best.sched_eval.bandwidth_demand):
                    # tie-break on demanded link bandwidth (paper §3.2.1:
                    # FPGAs pick FBP-AS when times tie — gentler 2a/(F+B)
                    # demand)
                    best = cand
    if best is None:
        best = ExplorationResult(
            mode="pipeline", schedule=scheds[0], M=1, microbatch=minibatch,
            plan=None, minibatch_time=float("inf"), per_stage_memory=[],
            feasible=False, dp_time=dp_t, dp_feasible=dp_ok)
    if consider_dp and dp_ok and dp_t < best.minibatch_time:
        return ExplorationResult(
            mode="data_parallel", schedule=None, M=1, microbatch=minibatch,
            plan=None, minibatch_time=dp_t, per_stage_memory=[dp_mem] * N,
            feasible=True, dp_time=dp_t, dp_feasible=True)
    return best


# ---------------------------------------------------------------------------
# 3D exploration: per-stage (dp, tp) degrees over a device pool.
# ---------------------------------------------------------------------------

# canonical builder names the cost-shaped replay accepts — the 3D
# candidates are ranked by simulator replay, so only replayable
# schedules participate
PLAN3D_SCHEDULES = ("1f1b", "zb-h1")


@dataclasses.dataclass(frozen=True)
class Plan3D:
    """One point of the 3D search space: a layer partition plus a
    per-stage ``(dp, tp)`` chip grid, ranked by the cost-shaped
    simulator replay of its schedule (makespan + exposed grad sync)."""
    bounds: tuple[tuple[int, int], ...]   # per-stage [start, end) layers
    shards: tuple[tuple[int, int], ...]   # per-stage (dp, tp)
    schedule: str
    M: int                                # micro-batches per mini-batch
    microbatch: int                       # units per micro-batch
    costs: object                         # TP-aware StageCosts (width-annotated)
    predicted_time: float                 # replay makespan + exposed sync
    sim_makespan: float                   # replay makespan, sync-free
    sync_exposed: float
    per_chip_memory: tuple[float, ...] = ()

    @property
    def n_stages(self) -> int:
        return len(self.bounds)

    @property
    def devices_used(self) -> int:
        return sum(d * t for d, t in self.shards)

    @property
    def uniform(self) -> bool:
        """All stages share one (dp, tp) — the plan maps onto a regular
        ``(data, stage, tensor)`` mesh and is directly executable; a
        non-uniform plan is ranked analytically (simulator replay)
        until the runtime grows ragged-mesh support."""
        return len(set(self.shards)) == 1

    @property
    def pipeline_only(self) -> bool:
        return all(s == (1, 1) for s in self.shards)


@dataclasses.dataclass
class Exploration3DResult:
    best: Plan3D
    incumbent: Plan3D                     # best pipeline-only plan
    candidates: list                      # all feasible plans, ranked

    @property
    def speedup_over_1d(self) -> float:
        return (self.incumbent.predicted_time / self.best.predicted_time
                if self.best.predicted_time else 0.0)


def _rank_3d(prof: NetworkProfile, fleet: FleetSpec, bounds, shards,
             schedule: str, M: int, mb: int, mem_limit,
             enforce_memory: bool) -> Optional[Plan3D]:
    """Cost one (bounds, shards, schedule, M) point and replay it."""
    from repro_torch.core.schedules import eval_grad_sync_costs
    base = fleet.base
    S = len(bounds)
    costs = plan_costs_3d(prof, base, bounds, mb, shards)
    mem = stage_memory_3d(prof, bounds, shards, mb)
    if enforce_memory and any(m > base.memory_capacity for m in mem):
        return None
    data_bw = base.axis_bandwidth("data")
    ar_vec = []
    for (s, e), (dp, tp) in zip(bounds, shards):
        wbytes = sum(prof.layers[k].bytes_weights for k in range(s, e))
        ar_vec.append(0.0 if dp <= 1 else
                      2.0 * (dp - 1) / dp * (wbytes / tp) / data_bw)
    gs = eval_grad_sync_costs(schedule, M, S, costs, ar_vec,
                              mem_limit=mem_limit)
    return Plan3D(
        bounds=tuple(tuple(b) for b in bounds),
        shards=tuple(tuple(s) for s in shards),
        schedule=schedule, M=M, microbatch=mb, costs=costs,
        predicted_time=gs.overlapped, sim_makespan=gs.compute_makespan,
        sync_exposed=gs.exposed, per_chip_memory=tuple(mem))


def _uniform_factorisations(chips: int) -> list[tuple[int, int]]:
    """All (dp, tp) integer factorisations of a stage's chip count."""
    return [(d, chips // d) for d in range(1, chips + 1)
            if chips % d == 0]


def explore3d(prof: NetworkProfile, fleet: FleetSpec, minibatch: int,
              candidate_Ms: Optional[Sequence[int]] = None,
              schedules: Sequence[str] = PLAN3D_SCHEDULES,
              candidate_stage_counts: Optional[Sequence[int]] = None,
              mem_limit: Optional[int] = None,
              enforce_memory: bool = False) -> Exploration3DResult:
    """BaPipe's balanced-partition exploration generalized to 3D: each
    pipeline stage gets a ``(dp, tp)`` chip grid carved from the
    ``fleet`` pool, under the pool's device budget.

    The space has three candidate families, all ranked by the SAME
    cost-shaped simulator replay (makespan of the schedule's op table
    under the TP-aware per-stage durations, plus the exposed part of
    the dp gradient sync — :func:`eval_grad_sync_costs`):

    * **pipeline-only** (every stage ``(1, 1)``): the incumbent 1D
      space — one plan per stage count.  Always searched, so the 3D
      result is structurally never worse than the 1D explorer's
      ranking of the same schedules.
    * **uniform (dp, tp)**: for every stage count S dividing the pool
      and every factorisation ``dp * tp = budget // S``.  These map
      onto a regular ``(data, stage, tensor)`` mesh and are directly
      executable by the runtime.
    * **non-uniform tp** (greedy width promotion): starting from width
      1 everywhere, repeatedly double the TP width of the
      bottleneck-time stage while the budget allows, re-balancing the
      layer split against the widened chain each step.  These let a
      fat stage buy width where depth can't split it; they are ranked
      analytically (the runtime executes uniform plans only).

    Layer bounds come from the existing balanced partitioner run
    against the width-fused chain (``fleet.chain``); the exact TP
    costing — collectives, reshard SR, width-sharded memory — is then
    applied by :func:`repro_torch.core.partition.plan_costs_3d`.
    ``enforce_memory`` drops candidates whose per-chip memory exceeds
    the base device's capacity (off by default: the analytic fixtures
    probe time, not capacity)."""
    P = fleet.n_devices
    base = fleet.base
    if not fleet.homogeneous:
        raise ValueError("explore3d plans over homogeneous pools; "
                         "heterogeneous chains go through explore()")
    for s in schedules:
        if s not in PLAN3D_SCHEDULES:
            raise ValueError(f"schedule {s!r} not replayable; "
                             f"pick from {PLAN3D_SCHEDULES}")
    Ss = (list(candidate_stage_counts) if candidate_stage_counts
          else [S for S in range(1, P + 1) if S <= prof.n_layers])
    candidates: list[Plan3D] = []

    def bounds_for(widths) -> tuple:
        chain = fleet.chain(widths)
        if chain.n == 1:
            return ((0, prof.n_layers),)
        return dp_partition(prof, chain, max(1, minibatch),
                            overlap=True).bounds

    def rank_all(bounds, shards, S):
        mbs = candidate_Ms or sorted({min(2 * S, minibatch),
                                      min(4 * S, minibatch),
                                      min(8 * S, minibatch)})
        for sched in schedules:
            for M in mbs:
                if M < 1 or minibatch // M < 1:
                    continue
                mb = minibatch // M
                # every dp replica needs a whole number of units
                if any(mb % dp for dp, _ in shards):
                    continue
                cand = _rank_3d(prof, fleet, bounds, shards, sched, M, mb,
                                mem_limit, enforce_memory)
                if cand is not None:
                    candidates.append(cand)

    for S in Ss:
        # pipeline-only + uniform (dp, tp): need S * dp * tp == P
        if P % S == 0:
            chips = P // S
            for dp, tp in _uniform_factorisations(chips):
                widths = [tp] * S      # dp replicates the chain, tp fuses
                bounds = bounds_for(widths)
                rank_all(bounds, [(dp, tp)] * S, S)
        elif S <= P:
            # budget doesn't divide: pipeline-only on S chips still valid
            bounds = bounds_for([1] * S)
            rank_all(bounds, [(1, 1)] * S, S)
        # greedy non-uniform width promotion (tp only, dp = 1)
        if S < 2 or S >= P:
            continue
        widths = [1] * S
        while True:
            costs = plan_costs_3d(prof, base, bounds_for(widths),
                                  max(1, minibatch), [(1, w) for w in widths])
            totals = [f + b + w for f, b, w
                      in zip(costs.F, costs.B, costs.W)]
            order = sorted(range(S), key=lambda i: -totals[i])
            bumped = False
            for i in order:
                if sum(widths) + widths[i] <= P:
                    widths[i] *= 2
                    bumped = True
                    break
            if not bumped:
                break
            shards = [(1, w) for w in widths]
            if len(set(shards)) > 1:          # uniform handled above
                rank_all(bounds_for(widths), shards, S)

    if not candidates:
        raise ValueError(f"no feasible 3D candidate for {P} devices / "
                         f"{prof.n_layers} layers / minibatch {minibatch}")
    candidates.sort(key=lambda c: c.predicted_time)
    pipeline_only = [c for c in candidates if c.pipeline_only]
    if not pipeline_only:
        raise AssertionError("incumbent pipeline-only plan missing from "
                             "the 3D space")  # structurally impossible
    return Exploration3DResult(best=candidates[0],
                               incumbent=pipeline_only[0],
                               candidates=candidates)


# ---------------------------------------------------------------------------
# Baseline frameworks for Table 3 / Table 4 (analytic counterparts).
# ---------------------------------------------------------------------------

def gpipe_time(prof: NetworkProfile, cluster: ClusterSpec, minibatch: int,
               M: int) -> tuple[float, list[float]]:
    """GPipe: all-FP then all-BP; stores ALL M micro-batch activations
    (no recompute, as in the paper's comparison); uses BaPipe's partition."""
    mb = max(1, minibatch // M)
    plan = dp_partition(prof, cluster, mb, overlap=False)
    F, B = plan.balanced_F(), plan.balanced_B()
    SR = max((max(c.comm_in, c.comm_out) for c in plan.stage_costs), default=0.0)
    N = cluster.n
    t = (M + N - 1) * (F + B) + (N + M - 2) * 2 * SR
    mem = [2.0 * c.weight_bytes + M * c.act_out_bytes for c in plan.stage_costs]
    return t, mem


def pipedream_time(prof: NetworkProfile, cluster: ClusterSpec, minibatch: int
                   ) -> tuple[float, list[float]]:
    """PipeDream: inter-batch 1F1B, no bubble in steady state, but weight
    stashing keeps up to N weight versions per stage."""
    mb = minibatch                 # PipeDream pipelines whole minibatches
    plan = dp_partition(prof, cluster, mb, overlap=False)
    F, B = plan.balanced_F(), plan.balanced_B()
    SR = max((max(c.comm_in, c.comm_out) for c in plan.stage_costs), default=0.0)
    N = cluster.n
    t = (F + B) + 2 * SR           # steady-state per mini-batch
    mem = [(N - i) * 2.0 * c.weight_bytes + (N - i) * c.act_out_bytes
           for i, c in enumerate(plan.stage_costs)]
    return t, mem
