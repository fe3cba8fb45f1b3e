"""Auto-planning: BaPipe's explorer drives the runtime configuration (the
port's copy of ``repro/core/autoplan.py``; it plans for the port's
:data:`~repro_torch.core.hardware.H100` unless told otherwise).

Closes the loop the paper describes in Fig. 3: profile the architecture,
explore (stage x tensor) factorisations of the mesh model axis and
micro-batch counts with the schedule cost models, and emit the runtime
``PipelineConfig`` + stage plan that the train/serve launchers consume
(``--auto-plan``).

A stage backed by T tensor-parallel chips is modelled as one BaPipe
"accelerator" with T x compute and T x HBM bandwidth but per-link
bandwidth (tensor-parallel all-reduces are accounted as an activation-size
communication term on top of the boundary transfer).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

from repro_torch.configs.base import ArchConfig
from repro_torch.core.explorer import explore, explore3d
from repro_torch.core.hardware import (DeviceSpec, H100, fused_device,
                                 heterogeneous_cluster, homogeneous_cluster,
                                 homogeneous_fleet)
from repro_torch.core.profiler import profile_arch


@dataclasses.dataclass(frozen=True)
class AutoPlan:
    stages: int
    tensor: int
    n_microbatches: int
    schedule: str
    predicted_step_time: float
    predicted_speedup_over_dp: float
    virtual: int = 1                 # 1F1B-I interleave depth (V)
    mem_limit: int = 0               # zb-auto peak-live cap (0 = unbounded)
    data_axis: int = 1               # DP degree the prediction assumed
    # non-hidden gradient-sync time inside predicted_step_time: the
    # part of the data-axis all-reduce the drain bubble could NOT
    # absorb (0.0 when data_axis == 1 or fully hidden)
    predicted_sync_exposed: float = 0.0
    # per-stage chip widths (dp*tp) of a 3D plan; () = flat 1D plan.
    # Uniform widths are what ``apply`` maps onto the regular mesh; a
    # non-uniform vector is carried for reporting only (the analytic
    # ranking's winner — the runtime executes uniform plans)
    stage_widths: tuple = ()

    def apply(self, cfg: ArchConfig) -> ArchConfig:
        from repro_torch.core.schedplan import canonical_name
        try:
            sched = canonical_name(self.schedule)
        except ValueError:
            # schedule may be None/unknown (e.g. a data-parallel
            # ExplorationResult carries no pipeline schedule)
            sched = "auto"
        return dataclasses.replace(cfg, stages=self.stages,
                                   tensor=self.tensor,
                                   virtual=self.virtual,
                                   schedule=sched,
                                   mem_limit=self.mem_limit
                                   if sched == "zb-auto" else 0)


def _stage_device(base: DeviceSpec, tensor: int) -> DeviceSpec:
    return fused_device(base, tensor)


def _valid_factorisations(cfg: ArchConfig, model_axis: int):
    t = 1
    while t <= model_axis:
        s = model_axis // t
        if model_axis % t == 0 and s <= cfg.n_layers:
            # tensor must divide the sharded dims (heads may replicate kv)
            heads_ok = cfg.n_heads % t == 0 or t == 1
            ssm_ok = cfg.ssm is None or t == 1
            ff_ok = (cfg.d_ff % t == 0) if cfg.d_ff else True
            if heads_ok and ssm_ok and ff_ok:
                yield s, t
        t *= 2


def auto_plan(cfg: ArchConfig, *, global_batch: int, seq_len: int,
              model_axis: int = 16, data_axis: int = 16,
              device: DeviceSpec = H100,
              devices: Optional[Sequence[DeviceSpec]] = None,
              max_microbatches: Optional[int] = None,
              mem_limit: Optional[int] = None) -> AutoPlan:
    """Pick (stages, tensor, M, schedule) minimising the predicted
    mini-batch time subject to per-chip memory.  ``mem_limit`` caps the
    ZB-AUTO candidate's peak-live row (and is carried into the runtime
    config when that schedule wins).

    ``devices`` plans a *heterogeneous* pod: an explicit per-stage
    device list (paper §V's mixed-FPGA clusters) that fixes the stage
    count to ``len(devices)`` — only tensor sizes with
    ``s == len(devices)`` are searched, and the explorer ranks the
    candidates by the scheduled heterogeneous makespan of the
    per-device cost vector (uneven layer split + cost-shaped zb-auto
    tables).

    With ``data_axis > 1`` candidates are ranked by the *overlapped*
    makespan: compute plus only the exposed (non-bubble-hidden) part
    of the data-parallel gradient sync, per-stage buckets scheduled
    into the drain the way the AR-op runtime executes them
    (``predicted_sync_exposed`` reports that part)."""
    prof = profile_arch(cfg, seq=seq_len)
    # per-stage workload unit = tokens per data shard
    local_batch_tokens = max(1, global_batch // data_axis) * seq_len
    best: Optional[AutoPlan] = None
    for s, t in _valid_factorisations(cfg, model_axis):
        if devices is not None:
            if s != len(devices):
                continue
            cluster = heterogeneous_cluster(
                [_stage_device(d, t) for d in devices])
        else:
            cluster = homogeneous_cluster(_stage_device(device, t), s)
        b_loc = max(1, global_batch // data_axis)
        ms = [m for m in (1, 2, 4, 8, 16, 32) if m <= b_loc and b_loc % m == 0]
        if max_microbatches:
            ms = [m for m in ms if m <= max_microbatches] or ms[:1]
        r = explore(prof, cluster, local_batch_tokens,
                    candidate_Ms=[m for m in ms], consider_dp=False,
                    mem_limit=mem_limit, dp_degree=data_axis)
        if r.plan is None:
            continue
        cand = AutoPlan(stages=s, tensor=t, n_microbatches=max(1, r.M),
                        schedule=r.schedule or "1F1B-AS",
                        predicted_step_time=r.minibatch_time,
                        predicted_speedup_over_dp=r.speedup_over_dp,
                        virtual=r.V, mem_limit=mem_limit or 0,
                        data_axis=data_axis,
                        predicted_sync_exposed=(
                            r.grad_sync_eval.exposed
                            if r.grad_sync_eval else 0.0))
        if best is None or cand.predicted_step_time < best.predicted_step_time:
            best = cand
    if best is None:
        raise ValueError(f"no feasible (stage, tensor) factorisation for "
                         f"{cfg.arch_id} on model_axis={model_axis}")
    return best


def _tp_valid(cfg: ArchConfig, t: int) -> bool:
    """Can the architecture's sharded dims split ``t`` ways?"""
    if t == 1:
        return True
    heads_ok = cfg.n_heads % t == 0
    ssm_ok = cfg.ssm is None
    ff_ok = (cfg.d_ff % t == 0) if cfg.d_ff else True
    return heads_ok and ssm_ok and ff_ok


def auto_plan3d(cfg: ArchConfig, *, global_batch: int, seq_len: int,
                n_devices: int, device: DeviceSpec = H100,
                mem_limit: Optional[int] = None) -> AutoPlan:
    """3D auto-planning: search per-stage (dp, tp) degrees over an
    ``n_devices`` homogeneous pool (:func:`repro_torch.core.explorer.explore3d`)
    and emit the runtime config of the best EXECUTABLE — uniform
    (dp, tp) — candidate, which maps onto the regular ``(data, stage,
    tensor)`` mesh: ``stages = S``, ``tensor = tp``, ``data_axis = dp``.
    ``stage_widths`` carries the overall winner's per-stage chip
    widths; when the analytic best is non-uniform its predicted time
    still appears through ``predicted_speedup_over_dp``'s denominator
    being the executable candidate (the uniform plan is what ships).

    Unlike :func:`auto_plan` (which fixes the mesh split up front and
    explores inside it), the device budget is the only constraint here
    — the planner chooses how deep and how wide every stage is."""
    prof = profile_arch(cfg, seq=seq_len)
    gb = max(1, global_batch)
    batch_tokens = gb * seq_len
    # Ms the runtime can actually slice: divisors of the global batch
    # (the executable filter below additionally requires the per-replica
    # batch gb/dp to split into M microbatches)
    ms = [m for m in (1, 2, 4, 8, 16, 32) if m <= gb and gb % m == 0]
    res = explore3d(prof, homogeneous_fleet(device, n_devices),
                    batch_tokens, candidate_Ms=ms or None,
                    mem_limit=mem_limit)

    def _runnable(c) -> bool:
        dp = c.shards[0][0]
        return gb % dp == 0 and (gb // dp) % c.M == 0

    executable = [c for c in res.candidates
                  if c.uniform and c.n_stages <= cfg.n_layers
                  and _tp_valid(cfg, c.shards[0][1]) and _runnable(c)]
    if not executable:
        raise ValueError(
            f"no executable uniform 3D candidate for {cfg.arch_id} "
            f"on {n_devices} devices")
    win = executable[0]                 # candidates are ranked
    dp, tp = win.shards[0]
    return AutoPlan(
        stages=win.n_stages, tensor=tp, n_microbatches=win.M,
        schedule=win.schedule,
        predicted_step_time=win.predicted_time,
        predicted_speedup_over_dp=(
            res.incumbent.predicted_time / win.predicted_time
            if win.predicted_time else 0.0),
        mem_limit=mem_limit or 0, data_axis=dp,
        predicted_sync_exposed=win.sync_exposed,
        stage_widths=tuple(d * t for d, t in res.best.shards))


def _derated(base: DeviceSpec, factor: float) -> DeviceSpec:
    """``base`` slowed down by ``factor`` (>1 = slower): the drift
    monitor's per-stage slowdown becomes a cost-model derating of both
    compute and HBM streaming."""
    if factor <= 0:
        raise ValueError(f"slowdown factor must be positive, got {factor}")
    return dataclasses.replace(
        base,
        name=f"{base.name}~{factor:.2f}x",
        peak_flops=base.peak_flops / factor,
        hbm_bandwidth=base.hbm_bandwidth / factor)


def _same_config(a: AutoPlan, b: AutoPlan) -> bool:
    if (a.stages, a.tensor, a.n_microbatches, a.virtual) != \
            (b.stages, b.tensor, b.n_microbatches, b.virtual):
        return False
    from repro_torch.core.schedplan import canonical_name
    try:
        return canonical_name(a.schedule) == canonical_name(b.schedule)
    except ValueError:
        return a.schedule == b.schedule


def replan(cfg: ArchConfig, incumbent: AutoPlan, *, budget_s: float,
           global_batch: int, seq_len: int,
           device: DeviceSpec = H100,
           devices: Optional[Sequence[DeviceSpec]] = None,
           slowdown: Optional[Sequence[float]] = None,
           max_microbatches: Optional[int] = None,
           mem_limit: Optional[int] = None,
           clock=None) -> AutoPlan:
    """Deadline-bounded re-search around a running plan.

    Triggered by the drift monitor: the fleet the incumbent was planned
    for no longer matches reality, so re-run the (stages, tensor, M, V,
    schedule) exploration under the CURRENT cost model and return the
    winner — or the ``incumbent`` itself when the search runs out of
    ``budget_s`` seconds before evaluating anything, or when the best
    configuration found IS the incumbent's (identity-testable: callers
    compare ``replan(...) is plan`` to skip a no-op restart).

    The current cost model comes from either an explicit per-stage
    ``devices`` list or a ``slowdown`` vector (the drift monitor's
    measured/planned ratios, length ``incumbent.stages``), which derates
    the baseline ``device`` per stage.  Either pins the stage count to
    the incumbent's — live replanning moves micro-batching, layer cuts,
    virtual chunking, and the schedule; CHANGING the device count is the
    restart path (kill, reshard the checkpoint with
    :func:`repro_torch.checkpoint.reshard_checkpoint`, relaunch: the
    train CLI's ``--resume`` does the reshard).

    Never-worse guarantee: the incumbent's (stages, tensor)
    factorisation is evaluated FIRST (before any deadline check can
    exhaust the budget) with the incumbent's micro-batch count forced
    into the candidate set, and the explorer's schedule space contains
    the incumbent's schedule — so the returned plan's predicted step
    time under the new cost model is <= the incumbent config's.  The
    deadline is checked between candidates (search work is not
    preempted mid-candidate); ``budget_s <= 0`` returns the incumbent
    immediately.

    ``clock`` is injectable for tests (defaults to
    ``time.monotonic``)."""
    import time as _time
    clock = clock or _time.monotonic
    if budget_s <= 0:
        return incumbent
    if slowdown is not None:
        if devices is not None:
            raise ValueError("pass either devices or slowdown, not both")
        if len(slowdown) != incumbent.stages:
            raise ValueError(
                f"slowdown vector has {len(slowdown)} entries, incumbent "
                f"runs {incumbent.stages} stages")
        devices = [_derated(device, f) for f in slowdown]

    model_axis = incumbent.stages * incumbent.tensor
    data_axis = incumbent.data_axis
    prof = profile_arch(cfg, seq=seq_len)
    local_batch_tokens = max(1, global_batch // data_axis) * seq_len
    b_loc = max(1, global_batch // data_axis)

    facts = list(_valid_factorisations(cfg, model_axis))
    inc_key = (incumbent.stages, incumbent.tensor)
    facts.sort(key=lambda st: st != inc_key)   # incumbent's (s, t) first

    t0 = clock()
    best: Optional[AutoPlan] = None
    for i, (s, t) in enumerate(facts):
        if i > 0 and clock() - t0 >= budget_s:
            break
        if devices is not None:
            if s != len(devices):
                continue
            cluster = heterogeneous_cluster(
                [_stage_device(d, t) for d in devices])
        else:
            cluster = homogeneous_cluster(_stage_device(device, t), s)
        ms = [m for m in (1, 2, 4, 8, 16, 32)
              if m <= b_loc and b_loc % m == 0]
        if max_microbatches:
            ms = [m for m in ms if m <= max_microbatches] or ms[:1]
        if (incumbent.n_microbatches <= b_loc
                and b_loc % incumbent.n_microbatches == 0
                and incumbent.n_microbatches not in ms):
            ms.append(incumbent.n_microbatches)
        r = explore(prof, cluster, local_batch_tokens,
                    candidate_Ms=sorted(ms), consider_dp=False,
                    mem_limit=mem_limit, dp_degree=data_axis)
        if r.plan is None:
            continue
        cand = AutoPlan(stages=s, tensor=t, n_microbatches=max(1, r.M),
                        schedule=r.schedule or "1F1B-AS",
                        predicted_step_time=r.minibatch_time,
                        predicted_speedup_over_dp=r.speedup_over_dp,
                        virtual=r.V, mem_limit=mem_limit or 0,
                        data_axis=data_axis,
                        predicted_sync_exposed=(
                            r.grad_sync_eval.exposed
                            if r.grad_sync_eval else 0.0))
        if best is None or cand.predicted_step_time < best.predicted_step_time:
            best = cand
    if best is None:
        return incumbent
    if _same_config(best, incumbent):
        return incumbent
    return best
