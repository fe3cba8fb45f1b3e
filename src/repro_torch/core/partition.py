"""BaPipe balanced-partition exploration (paper §3.3; the port's copy of
``repro/core/partition.py``).

Pipeline of refinements:

1. **Inter-layer partition** — Eq.(1) harmonic initialisation followed by
   iterative load balancing.  We implement the iteration's fixed point
   exactly: an O(L²·N) dynamic program over contiguous layer ranges that
   minimises the bottleneck stage time on a (possibly heterogeneous) device
   chain.
2. **Coarse-grained partition on communication** — when a stage's boundary
   transfer time exceeds its compute time, restrict cut points to layer
   boundaries whose activation size is ≤ a_th (merge the rest into
   super-layers) and re-run the DP.
3. **Intra-layer partition** — fractional split of the boundary layer
   between adjacent stages (FPDeep-style); only applied when communication
   is not the bottleneck.  Realised as tensor-parallel sharding.
4. **Memory fine-tuning** — shift boundary layers away from stages whose
   schedule-dependent memory requirement exceeds device capacity.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core.hardware import ClusterSpec, DeviceSpec
from repro_torch.core.profiler import (LayerProfile, NetworkProfile, bwd_time,
                                 bwd_split_time_tp, comm_time, fwd_time,
                                 fwd_time_tp)


@dataclasses.dataclass
class StageCost:
    fwd: float
    bwd: float
    comm_in: float
    comm_out: float
    weight_bytes: float
    act_out_bytes: float     # per micro-batch boundary activation
    bwd_w: float = 0.0       # weight-gradient share of bwd (seconds),
                             # from the layers' profiled w_frac; 0 =>
                             # unknown, treated as the even split

    def compute(self) -> float:
        return self.fwd + self.bwd

    def total(self, overlap: bool) -> float:
        c = max(self.comm_in, self.comm_out)
        return max(self.compute(), 2 * c) if overlap else self.compute() + 2 * c

    def bw_split(self) -> tuple[float, float]:
        """(input-gradient, weight-gradient) split of ``bwd`` — the
        profiled split when known, else the even split."""
        if 0.0 < self.bwd_w < self.bwd:
            return self.bwd - self.bwd_w, self.bwd_w
        return self.bwd / 2.0, self.bwd / 2.0


@dataclasses.dataclass
class PartitionPlan:
    """``bounds``/``stage_costs`` have one entry per *chunk*: N entries for
    the contiguous schedules (V == 1), N*V entries for interleaved plans
    where chunk (virtual stage) ``v*N + n`` runs on physical device n."""

    bounds: tuple[tuple[int, int], ...]     # per-chunk [start, end) layer range
    stage_costs: tuple[StageCost, ...]
    bottleneck: float                        # max per-stage total time
    overlap: bool
    frac_shift: tuple[float, ...] = ()       # intra-layer fractional refinement
    V: int = 1                               # virtual-stage interleave depth

    @property
    def n_stages(self) -> int:
        """Number of physical devices (pipeline stages)."""
        return len(self.bounds) // self.V

    def layers_per_stage(self) -> list[int]:
        return [e - s for s, e in self.bounds]

    def device_chunks(self, n: int) -> list[int]:
        """Chunk indices owned by device n (Megatron-style assignment)."""
        return [v * self.n_stages + n for v in range(self.V)]

    def device_costs(self) -> tuple[StageCost, ...]:
        """Per-physical-device costs: a device's V chunks aggregated
        (compute and weights sum; boundary terms take the worst chunk)."""
        if self.V == 1:
            return self.stage_costs
        out = []
        for n in range(self.n_stages):
            cs = [self.stage_costs[j] for j in self.device_chunks(n)]
            out.append(StageCost(
                fwd=sum(c.fwd for c in cs),
                bwd=sum(c.bwd for c in cs),
                comm_in=max(c.comm_in for c in cs),
                comm_out=max(c.comm_out for c in cs),
                weight_bytes=sum(c.weight_bytes for c in cs),
                act_out_bytes=max(c.act_out_bytes for c in cs),
                bwd_w=sum(c.bwd_w for c in cs)))
        return tuple(out)

    def cost_vector(self):
        """The partition's first-class per-device cost vector
        (:class:`repro_torch.core.schedplan.StageCosts`): per-device forward
        time, the profiled input-/weight-gradient backward split, and
        per-*hop* SR from each boundary's actual link bandwidth — the
        interface the cost-shaped schedules consume instead of the
        bottleneck scalar collapse ``(max F, max B, max SR)``."""
        from repro_torch.core.schedplan import StageCosts
        cs = self.device_costs()
        F, B, W = [], [], []
        for c in cs:
            b, bw = c.bw_split()
            F.append(c.fwd)
            B.append(b)
            W.append(bw)
        # degenerate stages (zero-compute profiles) get an epsilon floor
        # so the vector stays a valid schedule-cost input
        eps = max(max(F + B + W, default=1.0), 1.0) * 1e-12
        return StageCosts(
            F=tuple(max(f, eps) for f in F),
            B=tuple(max(b, eps) for b in B),
            W=tuple(max(w, eps) for w in W),
            SR=tuple(cs[i].comm_out for i in range(len(cs) - 1)))

    def balanced_F(self) -> float:
        return max(c.fwd for c in self.device_costs())

    def balanced_B(self) -> float:
        return max(c.bwd for c in self.device_costs())

    def bottleneck_FB(self) -> tuple[float, float]:
        """(fwd, bwd) of the bottleneck-compute device (the pair the
        schedule formulas should see — independent maxima overcount)."""
        c = max(self.device_costs(), key=lambda c: c.compute())
        return c.fwd, c.bwd

    def max_boundary_act(self) -> float:
        return max((c.act_out_bytes for c in self.stage_costs[:-1]), default=0.0)


# ---------------------------------------------------------------------------
# Cost of a contiguous layer range on a given device.
# ---------------------------------------------------------------------------

def _range_cost(prof: NetworkProfile, cluster: ClusterSpec, n: int,
                s: int, e: int, mb: int, include_embed_head: bool) -> StageCost:
    dev = cluster.devices[n]
    fwd = sum(fwd_time(prof.layers[k], dev, mb) for k in range(s, e))
    bwd = sum(bwd_time(prof.layers[k], dev, mb) for k in range(s, e))
    bwd_w = sum(bwd_time(prof.layers[k], dev, mb) * prof.layers[k].w_frac
                for k in range(s, e))
    wbytes = sum(prof.layers[k].bytes_weights for k in range(s, e))
    if include_embed_head:
        if n == 0 and prof.embed is not None:
            fwd += fwd_time(prof.embed, dev, mb)
            bwd += bwd_time(prof.embed, dev, mb)
            bwd_w += bwd_time(prof.embed, dev, mb) * prof.embed.w_frac
            wbytes += prof.embed.bytes_weights
        if n == cluster.n - 1 and prof.head is not None:
            fwd += fwd_time(prof.head, dev, mb)
            bwd += bwd_time(prof.head, dev, mb)
            bwd_w += bwd_time(prof.head, dev, mb) * prof.head.w_frac
            wbytes += prof.head.bytes_weights
    act_in = prof.layers[s - 1].bytes_act_out * mb if s > 0 else 0.0
    act_out = prof.layers[e - 1].bytes_act_out * mb if e < prof.n_layers else 0.0
    ci = comm_time(act_in, cluster.link_bandwidth(n - 1)) if n > 0 else 0.0
    co = comm_time(act_out, cluster.link_bandwidth(n)) if n < cluster.n - 1 else 0.0
    return StageCost(fwd=fwd, bwd=bwd, comm_in=ci, comm_out=co,
                     weight_bytes=wbytes,
                     act_out_bytes=prof.layers[e - 1].bytes_act_out * mb
                     if e - 1 < prof.n_layers else 0.0,
                     bwd_w=bwd_w)


# ---------------------------------------------------------------------------
# Eq.(1) initialisation.
# ---------------------------------------------------------------------------

def eq1_targets(prof: NetworkProfile, cluster: ClusterSpec, mb: int) -> list[float]:
    """Per-stage target times from T = 1 / sum(1/T_n) (paper Eq. 1)."""
    T_n = []
    for dev in cluster.devices:
        T_n.append(sum(fwd_time(l, dev, mb) + bwd_time(l, dev, mb)
                       for l in prof.layers))
    T = 1.0 / sum(1.0 / t for t in T_n)
    return [T] * cluster.n


def eq1_partition(prof: NetworkProfile, cluster: ClusterSpec, mb: int,
                  overlap: bool = True) -> PartitionPlan:
    """Greedy sweep to the Eq.(1) harmonic target (the paper's init step)."""
    T_n = [sum(fwd_time(l, d, mb) + bwd_time(l, d, mb) for l in prof.layers)
           for d in cluster.devices]
    T = 1.0 / sum(1.0 / t for t in T_n)
    bounds, s = [], 0
    L, N = prof.n_layers, cluster.n
    for n in range(N):
        if n == N - 1:
            e = L
        else:
            acc, e = 0.0, s
            dev = cluster.devices[n]
            while e < L - (N - 1 - n):        # leave >=1 layer per later stage
                step = (fwd_time(prof.layers[e], dev, mb)
                        + bwd_time(prof.layers[e], dev, mb))
                if acc + step > T and e > s:
                    break
                acc += step
                e += 1
            e = max(e, s + 1)
        bounds.append((s, e))
        s = e
    return _finalize(prof, cluster, tuple(bounds), mb, overlap)


# ---------------------------------------------------------------------------
# Exact contiguous-partition DP (the load-balancing iteration's fixed point).
# ---------------------------------------------------------------------------

def dp_partition(prof: NetworkProfile, cluster: ClusterSpec, mb: int,
                 overlap: bool = True,
                 allowed_cuts: Optional[set[int]] = None,
                 include_embed_head: bool = True) -> PartitionPlan:
    """Minimise the bottleneck stage time over contiguous partitions.

    ``allowed_cuts``: set of layer indices where a stage boundary may be
    placed (coarse-grained communication partition restricts this).
    """
    L, N = prof.n_layers, cluster.n
    if N > L:
        raise ValueError(f"more stages ({N}) than layers ({L})")
    cuts = allowed_cuts if allowed_cuts is not None else set(range(1, L))
    # O(1) range costs via per-device prefix sums
    pre_f = []   # pre_f[n][i] = sum of fwd+bwd time of layers [0, i) on dev n
    for dev in cluster.devices:
        acc, arr = 0.0, [0.0]
        for l in prof.layers:
            acc += fwd_time(l, dev, mb) + bwd_time(l, dev, mb)
            arr.append(acc)
        pre_f.append(arr)

    def rc(n: int, s: int, e: int) -> float:
        dev = cluster.devices[n]
        t = pre_f[n][e] - pre_f[n][s]
        if include_embed_head:
            if n == 0 and prof.embed is not None:
                t += fwd_time(prof.embed, dev, mb) + bwd_time(prof.embed, dev, mb)
            if n == N - 1 and prof.head is not None:
                t += fwd_time(prof.head, dev, mb) + bwd_time(prof.head, dev, mb)
        act_in = prof.layers[s - 1].bytes_act_out * mb if s > 0 else 0.0
        act_out = prof.layers[e - 1].bytes_act_out * mb if e < L else 0.0
        ci = comm_time(act_in, cluster.link_bandwidth(n - 1)) if n > 0 else 0.0
        co = comm_time(act_out, cluster.link_bandwidth(n)) if n < N - 1 else 0.0
        c = max(ci, co)
        return max(t, 2 * c) if overlap else t + 2 * c

    INF = float("inf")
    # best[n][e] = minimal bottleneck assigning layers [0,e) to stages [0,n]
    best = [[INF] * (L + 1) for _ in range(N)]
    arg = [[-1] * (L + 1) for _ in range(N)]
    for e in range(1, L + 1):
        if e == L or e in cuts:
            best[0][e] = rc(0, 0, e)
    for n in range(1, N):
        for e in range(n + 1, L + 1):
            if e != L and e not in cuts:
                continue
            for s in range(n, e):
                if s != 0 and s not in cuts:
                    continue
                if best[n - 1][s] == INF:
                    continue
                v = max(best[n - 1][s], rc(n, s, e))
                if v < best[n][e]:
                    best[n][e] = v
                    arg[n][e] = s
    if best[N - 1][L] == INF:
        raise ValueError("no feasible partition under allowed cuts")
    bounds, e = [], L
    for n in range(N - 1, 0, -1):
        s = arg[n][e]
        bounds.append((s, e))
        e = s
    bounds.append((0, e))
    bounds.reverse()
    return _finalize(prof, cluster, tuple(bounds), mb, overlap,
                     include_embed_head)


def _finalize(prof: NetworkProfile, cluster: ClusterSpec,
              bounds: tuple[tuple[int, int], ...], mb: int, overlap: bool,
              include_embed_head: bool = True) -> PartitionPlan:
    costs = tuple(_range_cost(prof, cluster, n, s, e, mb, include_embed_head)
                  for n, (s, e) in enumerate(bounds))
    bott = max(c.total(overlap) for c in costs)
    return PartitionPlan(bounds=bounds, stage_costs=costs, bottleneck=bott,
                         overlap=overlap)


# ---------------------------------------------------------------------------
# Interleaved (virtual-stage) partition: a device owns V non-contiguous
# layer chunks; chunk v*N + n runs on device n.
# ---------------------------------------------------------------------------

def virtual_cluster(cluster: ClusterSpec, V: int) -> ClusterSpec:
    """Expand an N-device chain into the N*V virtual-stage chain; virtual
    stage i runs on device ``i % N``, so boundary link bandwidths between
    consecutive virtual stages land on the right physical links (including
    the device N-1 -> device 0 wrap links between chunk passes)."""
    if V == 1:
        return cluster
    return ClusterSpec(devices=tuple(
        cluster.devices[i % cluster.n] for i in range(cluster.n * V)))


def interleaved_partition(prof: NetworkProfile, cluster: ClusterSpec,
                          mb: int, V: int, overlap: bool = True,
                          allowed_cuts: Optional[set[int]] = None
                          ) -> PartitionPlan:
    """Balanced partition of L layers into N*V virtual-stage chunks for the
    interleaved ``1F1B-I`` schedule.  Runs the same bottleneck DP over the
    expanded virtual-device chain, then tags the plan with V so device-level
    accessors (``device_costs``/``bottleneck_FB``/``stage_memory``) aggregate
    each device's V chunks."""
    if V == 1:
        return dp_partition(prof, cluster, mb, overlap, allowed_cuts)
    if cluster.n * V > prof.n_layers:
        raise ValueError(f"{cluster.n}x{V} virtual stages exceed "
                         f"{prof.n_layers} layers")
    vcl = virtual_cluster(cluster, V)
    plan = dp_partition(prof, vcl, mb, overlap, allowed_cuts)
    return dataclasses.replace(plan, V=V)


# ---------------------------------------------------------------------------
# Coarse-grained partition based on communication (paper §3.3.3).
# ---------------------------------------------------------------------------

def comm_bound(plan: PartitionPlan) -> bool:
    """Is any stage's boundary transfer longer than its compute?"""
    return any(max(c.comm_in, c.comm_out) * 2 > c.compute()
               for c in plan.stage_costs)


def coarse_cuts(prof: NetworkProfile, a_th: float) -> set[int]:
    """Cut points whose boundary activation is small enough to overlap."""
    return {k for k in range(1, prof.n_layers)
            if prof.layers[k - 1].bytes_act_out <= a_th}


def coarse_partition(prof: NetworkProfile, cluster: ClusterSpec, mb: int,
                     overlap: bool, V: int = 1) -> PartitionPlan:
    """Lower a_th from the max activation until comm is no longer the
    bottleneck (or no finer threshold is feasible).  With ``V > 1`` the
    coarse cuts restrict the interleaved virtual-stage partition instead."""
    sizes = sorted({l.bytes_act_out for l in prof.layers}, reverse=True)
    plan = interleaved_partition(prof, cluster, mb, V, overlap)
    for a_th in sizes:
        cuts = coarse_cuts(prof, a_th)
        if len(cuts) + 1 < cluster.n * V:
            break                              # too coarse to form N*V chunks
        try:
            cand = interleaved_partition(prof, cluster, mb, V, overlap,
                                         allowed_cuts=cuts)
        except ValueError:
            break
        plan = cand
        if not comm_bound(cand):
            return cand
    return plan


# ---------------------------------------------------------------------------
# Intra-layer fractional refinement (paper §3.3.2, FPDeep-style).
# ---------------------------------------------------------------------------

def intra_layer_refine(prof: NetworkProfile, cluster: ClusterSpec,
                       plan: PartitionPlan, mb: int) -> PartitionPlan:
    """Fractionally shift boundary-layer work toward under-loaded
    neighbours.  Analytic (a runtime realises it as tensor-parallel
    sharding of the boundary layer).  Only valid when comm is not the
    bottleneck — intra-layer splits add communication.
    """
    if comm_bound(plan):
        return plan
    times = [c.compute() for c in plan.stage_costs]
    fracs = [0.0] * plan.n_stages
    # smoothing sweeps: move fractions of boundary layers from slower
    # stages to faster neighbours until the bottleneck stops improving
    # (FPDeep's fine-grained workload balancing, applied analytically).
    for _ in range(8 * plan.n_stages):
        before = max(times)
        for n in range(plan.n_stages - 1):
            s, e = plan.bounds[n]
            s2, e2 = plan.bounds[n + 1]
            dev_a, dev_b = cluster.devices[n], cluster.devices[n + 1]
            if times[n] > times[n + 1] and e - s > 1:
                lay = prof.layers[e - 1]
                t_a = fwd_time(lay, dev_a, mb) + bwd_time(lay, dev_a, mb)
                t_b = fwd_time(lay, dev_b, mb) + bwd_time(lay, dev_b, mb)
                # move fraction x: times[n]-x*t_a == times[n+1]+x*t_b
                x = (times[n] - times[n + 1]) / (t_a + t_b)
                x = max(0.0, min(1.0, x))
                times[n] -= x * t_a
                times[n + 1] += x * t_b
                fracs[n] -= x
            elif times[n + 1] > times[n] and e2 - s2 > 1:
                lay = prof.layers[s2]
                t_a = fwd_time(lay, dev_a, mb) + bwd_time(lay, dev_a, mb)
                t_b = fwd_time(lay, dev_b, mb) + bwd_time(lay, dev_b, mb)
                x = (times[n + 1] - times[n]) / (t_a + t_b)
                x = max(0.0, min(1.0, x))
                times[n + 1] -= x * t_b
                times[n] += x * t_a
                fracs[n] += x
        if max(times) > before - 1e-12:
            break
    new_bott = max(max(t, 2 * max(c.comm_in, c.comm_out))
                   if plan.overlap else t + 2 * max(c.comm_in, c.comm_out)
                   for t, c in zip(times, plan.stage_costs))
    # scale each stage's (fwd, bwd) to the refined compute total so the
    # schedule evaluator sees post-refinement bottleneck times (the B/W
    # split scales with the bwd it was profiled from)
    new_costs = tuple(
        dataclasses.replace(c, fwd=c.fwd * (t / c.compute()),
                            bwd=c.bwd * (t / c.compute()),
                            bwd_w=c.bwd_w * (t / c.compute()))
        if c.compute() > 0 else c
        for t, c in zip(times, plan.stage_costs))
    return dataclasses.replace(plan, frac_shift=tuple(fracs),
                               stage_costs=new_costs,
                               bottleneck=min(plan.bottleneck, new_bott))


# ---------------------------------------------------------------------------
# Memory fine-tuning (paper §3.3, final step).
# ---------------------------------------------------------------------------

def stage_memory(plan: PartitionPlan, feat_mult: int, M: int,
                 schedule: Optional[str] = None,
                 mem_limit=None) -> list[float]:
    """Schedule-dependent per-device memory: 2w (weights+grads) plus the
    live micro-batch boundary activations.  The live counts come from the
    schedule-plan IR (:func:`repro_torch.core.schedplan.live_activation_counts`,
    the algebraic form of the op-table replay): feat_mult*(N-i+1) for the
    contiguous schedules, ``(V-1)*M + N - i + 1`` chunk activations for a
    streaming interleaved plan, ``2(N-i) + (V-1)N + 1`` for the memory-lean
    interleaved order, the zero-bubble rows for the ``zb-*`` family
    (``mem_limit`` caps the zb-auto row; unbounded zb-auto pays M).
    ``schedule`` defaults to the plan's natural schedule (1F1B for
    V == 1, streaming 1F1B-I for V > 1)."""
    from repro_torch.core.schedplan import live_activation_counts
    N = plan.n_stages
    if schedule is None:
        schedule = "1f1b" if plan.V == 1 else "1f1b-interleaved"
    live = live_activation_counts(schedule, M, N, plan.V, feat_mult,
                                  mem_limit=mem_limit)
    return [2.0 * c.weight_bytes + lv * c.act_out_bytes
            for lv, c in zip(live, plan.device_costs())]


def memory_fine_tune(prof: NetworkProfile, cluster: ClusterSpec,
                     plan: PartitionPlan, mb: int, feat_mult: int,
                     M: int, max_iters: int = 64,
                     schedule: Optional[str] = None,
                     mem_limit=None
                     ) -> tuple[PartitionPlan, bool]:
    """Shift boundary layers off over-capacity devices.  Returns
    (plan, feasible).  ``schedule`` picks the live-activation row used to
    judge capacity (defaults to the plan's natural schedule).  For an
    interleaved plan (V > 1) memory is judged per device but layers move
    across *chunk* boundaries, so the donor chunk's neighbour belongs to a
    different device."""
    V = plan.V
    vcl = virtual_cluster(cluster, V)
    bounds = [list(b) for b in plan.bounds]
    N = plan.n_stages
    NC = len(bounds)                           # chunks = N*V

    def finalize() -> PartitionPlan:
        cur = _finalize(prof, vcl, tuple(tuple(b) for b in bounds), mb,
                        plan.overlap)
        return dataclasses.replace(cur, V=V) if V > 1 else cur

    for _ in range(max_iters):
        cur = finalize()
        mem = stage_memory(cur, feat_mult, M, schedule, mem_limit)
        caps = [d.memory_capacity for d in cluster.devices]
        over = [i for i in range(N) if mem[i] > caps[i]]
        if not over:
            return cur, True
        moved = False
        for i in over:
            # candidate donations: last layer of a chunk to the next chunk,
            # or first layer to the previous chunk; judged by the headroom
            # of the *device* that owns the receiving chunk.
            best = None                        # (headroom, chunk, dir)
            for j in cur.device_chunks(i):
                s, e = bounds[j]
                if e - s <= 1:
                    continue
                if j < NC - 1:
                    tgt = (j + 1) % N
                    head = caps[tgt] - mem[tgt]
                    if best is None or head >= best[0]:
                        best = (head, j, +1)
                if j > 0:
                    tgt = (j - 1) % N
                    head = caps[tgt] - mem[tgt]
                    if best is None or head > best[0]:
                        best = (head, j, -1)
            if best is None:
                continue
            _, j, d = best
            if d > 0:
                bounds[j][1] -= 1
                bounds[j + 1][0] -= 1
            else:
                bounds[j][0] += 1
                bounds[j - 1][1] += 1
            moved = True
        if not moved:
            return cur, False
    cur = finalize()
    mem = stage_memory(cur, feat_mult, M, schedule, mem_limit)
    ok = all(m <= d.memory_capacity for m, d in zip(mem, cluster.devices))
    return cur, ok


# ---------------------------------------------------------------------------
# 3D stage costing: per-stage (dp, tp) shards over a device pool.
#
# The 1D partitioner above balances layers across a FIXED device chain.
# The 3D explorer instead hands each pipeline stage a (dp, tp) chip
# grid carved from a FleetSpec pool: dp replicas each see mb/dp of the
# micro-batch, tp shards split every GEMM 1/tp at the price of the
# per-layer tensor collective.  The functions below turn one such
# assignment into the same first-class StageCosts vector the builders,
# simulator and eval_*_hetero forms already consume — width is priced
# INTO the durations, the `width` field is annotation only.
# ---------------------------------------------------------------------------

def reshard_sr(act_bytes: float, shard_a: tuple[int, int],
               shard_b: tuple[int, int], bandwidth: float) -> float:
    """Boundary transfer time between adjacent stages sharded
    ``shard_a = (dp_a, tp_a)`` and ``shard_b = (dp_b, tp_b)``.

    When the layouts agree, each of the ``min(tp)`` aligned link pairs
    carries its own 1/tp activation slice concurrently — the transfer
    rides ``min(tp_a, tp_b)`` links.  When they differ (a boundary
    RESHARD), the activation must additionally be regathered and
    resliced to the consumer's grid — charged as one extra
    full-activation pass over a single link, the conservative
    store-and-forward bound."""
    if act_bytes <= 0.0:
        return 0.0
    base = act_bytes / (min(shard_a[1], shard_b[1]) * bandwidth)
    if tuple(shard_a) != tuple(shard_b):
        base += act_bytes / bandwidth
    return base


def plan_costs_3d(prof: NetworkProfile, dev: DeviceSpec,
                  bounds, mb: int, shards,
                  include_embed_head: bool = True):
    """Cost a layer partition under per-stage (dp, tp) shards.

    ``bounds`` is the per-stage [start, end) layer ranges, ``shards``
    one ``(dp, tp)`` pair per stage, ``dev`` the (homogeneous) pool's
    base chip.  Each stage's dp replicas process ``mb / dp`` of the
    micro-batch; its GEMMs shard 1/tp with the Megatron collective
    priced at the chip's ``tensor`` axis bandwidth
    (:func:`repro_torch.core.profiler.fwd_time_tp`); stage hops pay the
    :func:`reshard_sr` boundary term at the ``stage`` axis bandwidth.
    Returns :class:`repro_torch.core.schedplan.StageCosts` with the
    ``width = dp*tp`` annotation."""
    from repro_torch.core.schedplan import StageCosts
    bounds = [tuple(b) for b in bounds]
    shards = [(int(d), int(t)) for d, t in shards]
    if len(bounds) != len(shards):
        raise ValueError(f"{len(bounds)} stages but {len(shards)} shards")
    if any(d < 1 or t < 1 for d, t in shards):
        raise ValueError(f"shards must be >= (1, 1), got {shards}")
    N = len(bounds)
    F, B, W = [], [], []
    for i, ((s, e), (dp, tp)) in enumerate(zip(bounds, shards)):
        units = mb / dp
        lays = [prof.layers[k] for k in range(s, e)]
        if include_embed_head:
            if i == 0 and prof.embed is not None:
                lays.append(prof.embed)
            if i == N - 1 and prof.head is not None:
                lays.append(prof.head)
        f = b = w = 0.0
        for lay in lays:
            f += fwd_time_tp(lay, dev, units, tp)
            bi, wi = bwd_split_time_tp(lay, dev, units, tp)
            b += bi
            w += wi
        F.append(f)
        B.append(b)
        W.append(w)
    bw = dev.axis_bandwidth("stage")
    SR = tuple(
        reshard_sr(prof.layers[bounds[i][1] - 1].bytes_act_out * mb,
                   shards[i], shards[i + 1], bw)
        for i in range(N - 1))
    eps = max(max(F + B + W, default=1.0), 1.0) * 1e-12
    return StageCosts(
        F=tuple(max(f, eps) for f in F),
        B=tuple(max(b, eps) for b in B),
        W=tuple(max(w, eps) for w in W),
        SR=SR,
        width=tuple(d * t for d, t in shards))


def stage_memory_3d(prof: NetworkProfile, bounds, shards, mb: int,
                    live=None, include_embed_head: bool = True
                    ) -> list[float]:
    """Per-CHIP memory of each 3D stage: weights+grads shard 1/tp
    (Megatron splits the parameter matrices), live boundary
    activations shard across BOTH axes (each chip holds ``mb/dp``
    samples of a 1/tp hidden slice) — the 'fat stages buy width' lever.
    ``live`` is the per-stage live-activation count (default the 1F1B
    ``N - i`` ramp)."""
    N = len(bounds)
    if live is None:
        live = [N - i for i in range(N)]
    out = []
    for i, ((s, e), (dp, tp)) in enumerate(zip(bounds, shards)):
        wbytes = sum(prof.layers[k].bytes_weights for k in range(s, e))
        if include_embed_head:
            if i == 0 and prof.embed is not None:
                wbytes += prof.embed.bytes_weights
            if i == N - 1 and prof.head is not None:
                wbytes += prof.head.bytes_weights
        act = prof.layers[e - 1].bytes_act_out * mb if e - 1 < prof.n_layers \
            else 0.0
        out.append(2.0 * wbytes / tp + live[i] * act / (dp * tp))
    return out
