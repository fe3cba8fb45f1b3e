"""Schedule-plan IR (the port's copy of ``repro/core/schedplan.py``
without the gradient-sync AR ops and the instruction lowering).

A :class:`SchedPlan` holds, per physical device, the exact sequence of
``F``/``B`` (and, for zero-bubble plans, ``W``) ops tagged with
micro-batch ``m`` and virtual chunk ``v``.  Two lowerings compile it:

* :func:`lower_to_ring` — the forward order as the per-element lookup
  tables the pipelined serve step executes (``e = tick - stage``);
* :func:`lower_to_ticks` — the full mixed F/B(/W) table as the per-device
  per-tick lookup tables the training executor replays, with the residual
  stash, the inbox slots and the zero-bubble cotangent stash allocated
  statically from the table.

Builders (:data:`BUILDER_NAMES`): ``gpipe``, ``1f1b`` (``1f1b-2x`` with
the doubled warm-up), ``dapple``, ``zb-h1``, ``zb-h2``, ``zb-auto`` (the
greedy zero-bubble scheduler under a peak-live ``mem_limit`` cap, with
its portfolio steps replayed by :mod:`repro_torch.core.simulator`),
``1f1b-interleaved`` and ``1f1b-interleaved-memlean`` (V chunks per
device).  :meth:`SchedPlan.peak_live` and :func:`live_activation_counts`
give each device's resident-activation row.  The gradient-sync AR ops
(``grad_sync``) and the instruction lowering stay in the JAX package
until they are ported (ROADMAP "Still to port");
:func:`build_schedule` names them and raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union


@dataclasses.dataclass(frozen=True)
class StageCosts:
    """First-class per-device cost vector — the heterogeneous
    generalisation of the scalar ``(F, B, SR)`` interface (BaPipe's §V
    FPGA clusters are heterogeneous; collapsing the partitioner's
    per-stage times into bottleneck scalars before the schedule sees
    them throws the balance information away).

    ``F[n]`` / ``B[n]`` / ``W[n]`` are device n's forward,
    input-gradient and weight-gradient times per micro-batch (the full
    backward is ``B[n] + W[n]``; two-op schedules simply run the full
    backward, zero-bubble schedules split it).  ``SR[k]`` is the
    send/receive time of the boundary between devices k and k+1 —
    per *hop*, from that boundary's actual link bandwidth, not a
    ``max`` over the chain.

    Consumers: :func:`build_zb_auto` shapes its table by the vector,
    :func:`repro_torch.core.simulator.simulate` replays any plan under
    per-device durations, and the JAX package's ``eval_*_hetero``
    closed forms (``core/schedules.py``, not ported yet) reduce to the
    uniform forms exactly when :attr:`uniform` holds.

    ``width[n]`` annotates how many chips device n's stage actually
    occupies (its ``dp * tp`` shard of the 3D plan; empty = all 1).
    The times already price the sharding — width changes no replay
    duration — but the annotation travels with the vector so the
    simulator and the hetero evals can report device-seconds and
    budget-normalised makespans for non-uniform candidates."""
    F: tuple[float, ...]
    B: tuple[float, ...]
    W: tuple[float, ...]
    SR: tuple[float, ...] = ()
    width: tuple[int, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "F", tuple(float(x) for x in self.F))
        object.__setattr__(self, "B", tuple(float(x) for x in self.B))
        object.__setattr__(self, "W", tuple(float(x) for x in self.W))
        object.__setattr__(self, "SR", tuple(float(x) for x in self.SR))
        object.__setattr__(self, "width",
                           tuple(int(w) for w in self.width))
        n = len(self.F)
        if not (len(self.B) == len(self.W) == n):
            raise ValueError(f"StageCosts vectors disagree on N: "
                             f"F={len(self.F)} B={len(self.B)} "
                             f"W={len(self.W)}")
        if self.SR and len(self.SR) != n - 1:
            raise ValueError(f"StageCosts.SR needs one entry per hop "
                             f"({n - 1}), got {len(self.SR)}")
        if any(x <= 0 for x in self.F + self.B + self.W):
            raise ValueError(f"StageCosts times must be positive: {self}")
        if any(x < 0 for x in self.SR):
            raise ValueError(f"StageCosts.SR must be >= 0: {self.SR}")
        if self.width:
            if len(self.width) != n:
                raise ValueError(f"StageCosts.width needs one entry per "
                                 f"device ({n}), got {len(self.width)}")
            if any(w < 1 for w in self.width):
                raise ValueError(f"StageCosts.width must be >= 1: "
                                 f"{self.width}")

    @property
    def n(self) -> int:
        return len(self.F)

    @property
    def widths(self) -> tuple[int, ...]:
        """Per-device chip widths, materialised (ones when unannotated)."""
        return self.width if self.width else (1,) * self.n

    @property
    def uniform_width(self) -> bool:
        """All stages occupy the same chip width — the regime the SPMD
        runtime can execute directly on a rectangular mesh; non-uniform
        widths stay analytic (simulator-ranked)."""
        return len(set(self.widths)) == 1

    def devices_used(self) -> int:
        """Total chips the annotated plan occupies."""
        return sum(self.widths)

    @property
    def B_full(self) -> tuple[float, ...]:
        """Per-device full backward time (input-grad + weight-grad)."""
        return tuple(b + w for b, w in zip(self.B, self.W))

    @property
    def w_frac(self) -> tuple[float, ...]:
        """Per-device weight-gradient fraction of the full backward."""
        return tuple(w / (b + w) for b, w in zip(self.B, self.W))

    @property
    def sr_hops(self) -> tuple[float, ...]:
        """Per-hop SR, materialised (zeros when unspecified)."""
        return self.SR if self.SR else (0.0,) * max(0, self.n - 1)

    @property
    def uniform(self) -> bool:
        """All devices share one (F, B, W) and all hops one SR — the
        regime where every hetero form must reduce to the uniform one."""
        return (len(set(self.F)) == 1 and len(set(self.B)) == 1
                and len(set(self.W)) == 1 and len(set(self.sr_hops)) <= 1)

    @property
    def even_split(self) -> bool:
        """Every device's backward splits evenly (B == W) — the design
        point the uniform zero-bubble closed forms assume."""
        return all(b == w for b, w in zip(self.B, self.W))

    def bottleneck(self) -> tuple[float, float, float]:
        """The legacy scalar collapse ``(max F, max B_full, max SR)`` —
        what the explorer fed the schedule formulas before costs were
        first-class.  Kept for the uniform-scalar portfolio/baselines."""
        return (max(self.F), max(self.B_full),
                max(self.sr_hops, default=0.0))

    def max_scalar(self) -> "StageCosts":
        """Uniform collapse: every device pays the bottleneck device's
        times (and every hop the worst hop) — the cost vector the old
        scalar interface implied.  The width annotation is preserved:
        collapsing times says nothing about chip occupancy."""
        return StageCosts(F=(max(self.F),) * self.n,
                          B=(max(self.B),) * self.n,
                          W=(max(self.W),) * self.n,
                          SR=(max(self.sr_hops, default=0.0),)
                          * max(0, self.n - 1),
                          width=self.width)

    @classmethod
    def uniform_costs(cls, N: int, F: float, B_full: float,
                      SR: float = 0.0, w_frac: float = 0.5
                      ) -> "StageCosts":
        """Lift the scalar interface into a (trivially uniform) vector."""
        return cls(F=(float(F),) * N,
                   B=(B_full * (1.0 - w_frac),) * N,
                   W=(B_full * w_frac,) * N,
                   SR=(float(SR),) * max(0, N - 1))


CostVec = Union[float, Sequence[float]]


def _cost_vec(x: CostVec, N: int, what: str) -> list[float]:
    """Normalise a scalar-or-sequence cost knob to a length-N list."""
    if isinstance(x, (int, float)):
        return [float(x)] * N
    xs = [float(v) for v in x]
    if len(xs) != N:
        raise ValueError(f"{what} needs one entry per device ({N}), "
                         f"got {len(xs)}")
    return xs


@dataclasses.dataclass(frozen=True)
class Op:
    """One unit of pipeline work: the F, B (input-gradient) or W
    (weight-gradient, zero-bubble split) of micro-batch ``m`` on chunk
    ``v`` of physical device ``device``.  ``vstage`` is the global
    virtual-stage index."""
    kind: str                       # "F" | "B" | "W"
    m: int                          # micro-batch index
    v: int                          # chunk index on this device (0..V-1)
    device: int                     # physical device n (0..N-1)
    n_stages: int                   # N
    n_chunks: int                   # V

    @property
    def vstage(self) -> int:
        return self.v * self.n_stages + self.device


@dataclasses.dataclass(frozen=True)
class SchedPlan:
    """Compiled per-device op table for one mini-batch of M micro-batches
    through N devices with V virtual chunks per device."""
    name: str
    M: int
    N: int
    V: int
    device_ops: tuple[tuple[Op, ...], ...]   # [N] tuples, issue order

    @property
    def has_w(self) -> bool:
        """True for zero-bubble plans whose backward is split into
        input-gradient (B) and weight-gradient (W) ops."""
        return any(op.kind == "W" for op in self.device_ops[0])

    def validate(self) -> "SchedPlan":
        """Every (m, chunk) F and B — and W, for zero-bubble plans —
        appears exactly once per device, and the per-(m, v) order is F
        before B before W."""
        has_w = self.has_w
        per_mv = 3 if has_w else 2
        for n, ops in enumerate(self.device_ops):
            seen: dict[tuple[str, int, int], int] = {}
            for i, op in enumerate(ops):
                key = (op.kind, op.m, op.v)
                if op.kind not in ("F", "B", "W"):
                    raise ValueError(f"{self.name}: op kind {op.kind!r} is "
                                     f"not ported (device {n})")
                if key in seen:
                    raise ValueError(f"{self.name}: duplicate {key} on "
                                     f"device {n}")
                seen[key] = i
            if len(ops) != per_mv * self.M * self.V:
                raise ValueError(
                    f"{self.name}: device {n} has {len(ops)} compute ops, "
                    f"expected {per_mv * self.M * self.V}")
            for (kind, m, v), i in seen.items():
                if kind == "B" and seen[("F", m, v)] > i:
                    raise ValueError(f"{self.name}: B({m},{v}) before its F "
                                     f"on device {n}")
                if kind == "W" and seen[("B", m, v)] > i:
                    raise ValueError(f"{self.name}: W({m},{v}) before its B "
                                     f"on device {n}")
            if has_w:
                for (kind, m, v) in list(seen):
                    if kind == "B" and ("W", m, v) not in seen:
                        raise ValueError(f"{self.name}: B({m},{v}) has no W "
                                         f"on device {n}")
        return self

    def forward_sequence(self, device: int = 0) -> list[tuple[int, int]]:
        """(m, v) of the device's forwards in issue order."""
        return [(op.m, op.v) for op in self.device_ops[device]
                if op.kind == "F"]


    def peak_live(self) -> list[int]:
        """Symbolic replay: per-device peak count of resident chunk
        activations (F issued, residual not yet released) — the
        features-memory row the closed forms tabulate, derived directly
        from the table.  The residual is released by the op that last
        reads it: B for two-op plans, W for zero-bubble plans (the
        weight gradient still needs the stage input)."""
        release = "W" if self.has_w else "B"
        peaks = []
        for ops in self.device_ops:
            live = peak = 0
            for op in ops:
                if op.kind == "F":
                    live += 1
                elif op.kind == release:
                    live -= 1
                peak = max(peak, live)
            peaks.append(peak)
        return peaks



# ---------------------------------------------------------------------------
# Builders.
# ---------------------------------------------------------------------------

def _ops_from_seqs(name: str, M: int, N: int, V: int,
                   fwd_seqs, bwd_seqs, warmups) -> SchedPlan:
    """Assemble the 1F1B skeleton: per device, ``warmup`` forwards, then
    alternate (B, F) until the forwards drain, then the remaining
    backwards."""
    device_ops = []
    for n in range(N):
        fwd, bwd = fwd_seqs[n], bwd_seqs[n]
        total = len(fwd)
        warmup = max(1, min(total, warmups[n]))
        mk = lambda kind, mv: Op(kind, mv[0], mv[1], n, N, V)
        ops = [mk("F", mv) for mv in fwd[:warmup]]
        nf, nb = warmup, 0
        while nb < total:
            ops.append(mk("B", bwd[nb])); nb += 1
            if nf < total:
                ops.append(mk("F", fwd[nf])); nf += 1
        device_ops.append(tuple(ops))
    return SchedPlan(name=name, M=M, N=N, V=V,
                     device_ops=tuple(device_ops)).validate()


def build_gpipe(M: int, N: int) -> SchedPlan:
    """All forwards, then all backwards (no interleave)."""
    fwd = [[(m, 0) for m in range(M)]] * N
    bwd = [[(m, 0) for m in range(M)]] * N
    return _ops_from_seqs("gpipe", M, N, 1, fwd, bwd, [M] * N)


def build_1f1b(M: int, N: int, *, double_warmup: bool = False) -> SchedPlan:
    """1F1B with warm-up ``N - n`` per device (``2(N-n) - 1`` when
    ``double_warmup`` — the FBP-AS / 1F1B-SO pipelining depth)."""
    fwd = [[(m, 0) for m in range(M)]] * N
    bwd = [[(m, 0) for m in range(M)]] * N
    warm = [2 * (N - n) - 1 if double_warmup else N - n for n in range(N)]
    name = "1f1b-2x" if double_warmup else "1f1b"
    return _ops_from_seqs(name, M, N, 1, fwd, bwd, warm)


def build_1f1b_interleaved(M: int, N: int, V: int) -> SchedPlan:
    """Streaming chunk passes (PR 1's circular-ppermute order): forward
    element ``e`` on every device is micro-batch ``e % M`` chunk
    ``e // M``; backwards mirror (last chunk first).  Warm-up must cover
    the full first V-1 passes plus the 1F1B ``N - n`` window, hence the
    ``(V-1)M`` resident-features term.  Requires ``M >= N`` so chunk
    passes stream through the ring without stalling."""
    if V < 1:
        raise ValueError(f"V must be >= 1, got {V}")
    if M < N:
        raise ValueError(f"1F1B-I needs M >= N to stream chunk passes "
                         f"(got M={M}, N={N})")
    MV = M * V
    fwd = [[(e % M, e // M) for e in range(MV)]] * N
    bwd = [[(e % M, V - 1 - e // M) for e in range(MV)]] * N
    warm = [(V - 1) * M + (N - n) for n in range(N)]
    return _ops_from_seqs("1f1b-interleaved", M, N, V, fwd, bwd, warm)


def build_dapple(M: int, N: int) -> SchedPlan:
    """DAPPLE early-backward schedule (arXiv 2007.01045): warm-up
    ``N - n`` forwards per device, then strict one-backward-one-forward
    alternation.  The table coincides with synchronous 1F1B; it is a
    distinct builder so the runtime executes the early-backward order
    under its own name — derived from :func:`build_1f1b` so the two
    tables can never diverge."""
    return dataclasses.replace(build_1f1b(M, N), name="dapple")


def build_zb_h1(M: int, N: int) -> SchedPlan:
    """Zero-bubble H1 (arXiv 2211.05953): split every backward into an
    input-gradient op ``B`` (propagates the error to the previous stage)
    and a weight-gradient op ``W`` (no boundary edges, schedulable any
    time after its B).  Per device: warm-up ``N - n`` forwards, steady
    ``B, W, F`` cycles while forwards remain, then ``B, W`` drain pairs."""
    device_ops = []
    for n in range(N):
        mk = lambda kind, m: Op(kind, m, 0, n, N, 1)
        warm = max(1, min(M, N - n))
        ops = [mk("F", m) for m in range(warm)]
        nf, nb = warm, 0
        while nf < M:                       # steady: B, W, F
            ops += [mk("B", nb), mk("W", nb), mk("F", nf)]
            nb += 1
            nf += 1
        while nb < M:                       # drain: B, W pairs
            ops += [mk("B", nb), mk("W", nb)]
            nb += 1
        device_ops.append(tuple(ops))
    return SchedPlan(name="zb-h1", M=M, N=N, V=1,
                     device_ops=tuple(device_ops)).validate()


def zb_h2_mem_caps(M: int, N: int) -> list[int]:
    """ZB-H2's per-device peak-live row ``max(2(N-n)-1, n + ceil((N+1)/2))``
    — which is also the cap under which :func:`build_zb_auto` emits the
    ZB-H2 table.

    Two constraints meet: device n admits ``2(N-n) - 1`` warm-up forwards
    (double 1F1B's depth, so the error of micro-batch 0 arrives exactly
    when the deepened fill ends), and the zero-bubble *drain* needs the
    downstream devices to bank weight gradients past their last
    input-gradient — each hop the error travels upstream exposes ``F + b``
    of downstream wait that only postponed W ops can cover, growing the
    resident-residual count to ``n + ceil((N+1)/2)``.  Both are bounded by
    ``2N - 1``: the "~2x 1F1B warm-up memory" the zero-bubble paper
    (arXiv 2211.05953) quotes for ZB-H2."""
    return [max(1, min(M, max(2 * (N - n) - 1, n + (N + 2) // 2)))
            for n in range(N)]


def _normalize_caps(mem_limit, M: int, N: int) -> list[int]:
    """Resolve a ``mem_limit`` knob to per-device peak-live caps in
    [1, M]: falsy (None or 0) = unbounded, int = uniform, length-N
    sequence = per-device (0 entries = that device unbounded)."""
    if not mem_limit:
        caps = [M] * N
    elif isinstance(mem_limit, (int, float)):
        caps = [int(mem_limit)] * N
    else:
        caps = [int(c) or M for c in mem_limit]
        if len(caps) != N:
            raise ValueError(f"mem_limit needs one cap per device "
                             f"({N}), got {len(caps)}")
    return [max(1, min(M, c)) for c in caps]


def _replay_makespan(plan: SchedPlan, F_cs: Sequence[float],
                     B_cs: Sequence[float], W_cs: Sequence[float],
                     sr: Optional[Sequence[float]] = None) -> float:
    """Makespan of a fixed op table at per-device per-op costs
    (F, input-grad B, weight-grad W) — the discrete-event simulator's
    replay, with the full backward re-expressed as its per-device
    ``w_frac`` split and per-hop SR under the latency model (free comm
    when every hop is zero).  Imported lazily: the simulator imports
    this module at load time, but only calls back in here at run
    time."""
    from repro_torch.core.simulator import simulate
    B_full = [b + w for b, w in zip(B_cs, W_cs)]
    wf = [w / bf for w, bf in zip(W_cs, B_full)]
    if sr is not None and any(s > 0 for s in sr):
        return simulate(plan, plan.M, plan.N, list(F_cs), B_full,
                        list(sr), w_frac=wf, comm="latency").makespan
    return simulate(plan, plan.M, plan.N, list(F_cs), B_full, 0.0,
                    w_frac=wf).makespan


def build_zb_auto(M: int, N: int, costs=(1.0, 1.0, 1.0),
                  mem_limit=None, *, name: str = "zb-auto") -> SchedPlan:
    """Automatic zero-bubble scheduler (arXiv 2211.05953's heuristic,
    adapted to the IR): an event-driven greedy list scheduler over F/B/W
    op placement that fills device idle slots with W ops subject to a
    per-device peak-live cap.

    Each device always has at most three candidate next ops — its next
    backward ``B`` (ready once its own F ran and the downstream error
    arrived), its next forward ``F`` (admissible only while the resident
    activation count is below the cap; the residual is released at W), and
    its oldest banked weight-gradient ``W`` (always startable).  The
    device picks the candidate with the earliest start time, breaking
    ties ``B > F > W`` — with one guard: once the next B's arrival time is
    known, an F or W is only admissible if it *fits entirely before* that
    arrival.  Errors are the critical path (every upstream device transits
    them), so the device would rather idle briefly than start a long op in
    front of an imminent backward; W ops are pure filler.  Devices commit
    ops in global start-time order, so the emitted per-device op list is
    exactly the order a work-conserving runtime would execute.

    ``costs`` is ``(F, B, W)`` — forward, input-gradient and
    weight-gradient durations (the closed forms' even split is
    ``B = W =`` half the full backward) — where each entry may be a
    scalar (uniform devices, today's interface) or a length-N sequence
    (heterogeneous devices), or a :class:`StageCosts` vector, whose
    per-hop ``SR`` then also delays cross-device arrivals (latency
    model), so the emitted table is genuinely *cost-shaped*: the greedy
    sees each device's real F/B/W and each boundary's real transfer
    time when it decides what fits before the next backward.  Uniform
    vectors reproduce the scalar interface's tables exactly (pinned).
    ``mem_limit`` is the peak-live cap: ``None``/``0`` (unbounded: peak
    climbs to M while every bubble after the fill ramp vanishes), an
    int (uniform), or a length-N sequence.
    The cap reproduces the hand-written tables as special cases — the
    1F1B window ``N - n`` yields exactly :func:`build_zb_h1`'s table, and
    :func:`zb_h2_mem_caps` yields ZB-H2 (:func:`build_zb_h2`) — pinned in
    the JAX package's ``tests/test_schedplan_properties.py``.

    A greedy list scheduler can still lose to a hand-written order at
    adversarial cost ratios, so the builder ends with a portfolio step:
    whenever the ZB-H1 table fits the cap, both tables are replayed at
    ``costs`` and the cheaper one is returned (ties keep the greedy, so
    the special-case reproductions above are exact table equalities).
    That makes ``zb-auto <= zb-h1`` *structural* for any cap that admits
    the 1F1B window — the property the randomized differential sweep in
    the JAX package's ``tests/test_simulator_vs_closed_form.py`` pins.  For heterogeneous
    vectors a second portfolio member is the table the *scalar collapse*
    ``(max F, max B, max W)`` would have built, replayed at the true
    vector costs — so ``zb-auto(vector) <= zb-auto(max-scalar)`` is
    structural too (the cost-shaped table can only win)."""
    if isinstance(costs, StageCosts):
        if costs.n != N:
            raise ValueError(f"costs are for {costs.n} devices, "
                             f"build_zb_auto was asked for N={N}")
        F_cs, B_cs, W_cs = list(costs.F), list(costs.B), list(costs.W)
        sr = list(costs.sr_hops)
    else:
        F_c, B_c, W_c = costs
        F_cs = _cost_vec(F_c, N, "zb-auto F costs")
        B_cs = _cost_vec(B_c, N, "zb-auto B costs")
        W_cs = _cost_vec(W_c, N, "zb-auto W costs")
        sr = [0.0] * max(0, N - 1)
    if any(c <= 0 for c in F_cs + B_cs + W_cs):
        raise ValueError(f"zb-auto op costs must be positive, got {costs}")
    hetero = (len(set(F_cs)) > 1 or len(set(B_cs)) > 1
              or len(set(W_cs)) > 1)
    caps = _normalize_caps(mem_limit, M, N)
    f_done = [[None] * N for _ in range(M)]
    b_done = [[None] * N for _ in range(M)]
    dev_free = [0.0] * N
    nf = [0] * N                    # next F micro-batch per device
    nb = [0] * N                    # next B micro-batch per device
    nw = [0] * N                    # next W micro-batch per device
    live = [0] * N                  # resident activations (F issued, W not)
    ops: list[list[Op]] = [[] for _ in range(N)]
    makespan = 0.0
    eps = 1e-9
    for _ in range(3 * M * N):
        best = None                 # (start, prio, device, kind)
        for n in range(N):
            cands = []
            t_b = None              # known start of the next backward
            m = nb[n]
            if m < M and f_done[m][n] is not None:
                if n == N - 1:
                    arr = f_done[m][n]
                else:
                    arr = b_done[m][n + 1]
                    if arr is not None:
                        arr += sr[n]
                if arr is not None:
                    t_b = max(dev_free[n], arr)
                    cands.append((t_b, 0, "B"))
            m = nf[n]
            if m < M and live[n] < caps[n]:
                arr = 0.0 if n == 0 else f_done[m][n - 1]
                if arr is not None:
                    if n > 0:
                        arr += sr[n - 1]
                    s = max(dev_free[n], arr)
                    if t_b is None or s + F_cs[n] <= t_b + eps:
                        cands.append((s, 1, "F"))
            if nw[n] < nb[n]:
                s = dev_free[n]
                # the fits-before-B guard is waived when the cap binds: a
                # W then gates the next F admission (it releases the
                # residual slot), so it is on the forward-supply critical
                # path, not filler
                if (t_b is None or s + W_cs[n] <= t_b + eps
                        or (nf[n] < M and live[n] >= caps[n])):
                    cands.append((s, 2, "W"))
            if cands:
                s, p, k = min(cands)
                if best is None or (s, p, n) < best[:3]:
                    best = (s, p, n, k)
        assert best is not None, "zb-auto scheduler stalled (internal bug)"
        s, _, n, kind = best
        if kind == "F":
            m = nf[n]
            end = s + F_cs[n]
            f_done[m][n] = end
            nf[n] += 1
            live[n] += 1
        elif kind == "B":
            m = nb[n]
            end = s + B_cs[n]
            b_done[m][n] = end
            nb[n] += 1
        else:
            m = nw[n]
            end = s + W_cs[n]
            nw[n] += 1
            live[n] -= 1
        dev_free[n] = end
        makespan = max(makespan, end)
        ops[n].append(Op(kind, m, 0, n, N, 1))
    plan = SchedPlan(name=name, M=M, N=N, V=1,
                     device_ops=tuple(tuple(o) for o in ops)).validate()
    # portfolio step: never lose to the hand-written ZB-H1 order when it
    # fits the cap (strict improvement required, so exact special-case
    # reproductions keep the greedy's table)
    h1 = build_zb_h1(M, N)
    if all(p <= c for p, c in zip(h1.peak_live(), caps)):
        h1_ms = _replay_makespan(h1, F_cs, B_cs, W_cs, sr)
        if h1_ms < makespan - 1e-12:
            plan = dataclasses.replace(h1, name=name)
            makespan = h1_ms
    # heterogeneous portfolio step: the table the legacy scalar collapse
    # (max F, max B, max W) would have built, replayed at the TRUE vector
    # costs — makes zb-auto(vector) <= zb-auto(max-scalar) structural
    # (again strict, so uniform vectors keep the greedy's table)
    if hetero:
        scal = build_zb_auto(M, N, costs=(max(F_cs), max(B_cs), max(W_cs)),
                             mem_limit=mem_limit)
        if _replay_makespan(scal, F_cs, B_cs, W_cs, sr) < makespan - 1e-12:
            plan = dataclasses.replace(scal, name=name)
    return plan


def build_zb_h2(M: int, N: int) -> SchedPlan:
    """Zero-bubble H2 (arXiv 2211.05953): the bubble-free hand-crafted
    point — warm-up ``2(N-n) - 1`` forwards (double 1F1B's pipelining
    depth) and weight-gradients banked past the drain downstream, so
    after the unavoidable ``(N-1)F`` fill ramp the makespan-carrying
    device never idles: makespan ``M(F+B) + (N-1)F`` (the whole
    ``(N-1)(F + B)`` 1F1B flush bubble is gone) at
    ``max(2(N-n)-1, n + ceil((N+1)/2))`` resident activations
    (:func:`zb_h2_mem_caps`) — the "~2x 1F1B memory" trade.  Derived as
    the :func:`build_zb_auto` table under that cap at unit costs, so H2
    *is* a special case of the automatic scheduler's cap."""
    return dataclasses.replace(
        build_zb_auto(M, N, mem_limit=zb_h2_mem_caps(M, N)), name="zb-h2")


def build_1f1b_interleaved_memlean(M: int, N: int, V: int) -> SchedPlan:
    """Megatron-style memory-lean interleaved 1F1B: micro-batches advance
    in groups of N, cycling the V chunks inside each group, with warm-up
    ``2(N - n - 1) + (V-1)N``.  Peak resident features fall from
    ``(V-1)M + N - n`` (streaming) to ``2(N - n - 1) + (V-1)N`` while the
    makespan is unchanged.  Requires ``M % N == 0`` (Megatron's
    constraint): with group size N, micro-batch m's pass v+1 is issued
    exactly N elements after pass v, which is also the tick count for the
    ring return to travel the daisy chain back to stage 0."""
    if V < 1:
        raise ValueError(f"V must be >= 1, got {V}")
    if M < N or M % N != 0:
        raise ValueError(
            f"1f1b-interleaved-memlean needs M % N == 0 (micro-batch "
            f"groups of the pipeline depth), got M={M}, N={N}")
    fwd_seq = [(g * N + r, v)
               for g in range(M // N) for v in range(V) for r in range(N)]
    bwd_seq = [(g * N + r, V - 1 - vv)
               for g in range(M // N) for vv in range(V) for r in range(N)]
    fwd = [fwd_seq] * N
    bwd = [bwd_seq] * N
    # Megatron counts warm-up forwards before the first steady-state
    # *forward* (F-then-B iterations); our skeleton alternates B-first, so
    # its warm-up is one deeper.  Peak resident features are identical:
    # 2(N-n-1) + (V-1)N + 1.
    warm = [2 * (N - n - 1) + (V - 1) * N + 1 for n in range(N)]
    return _ops_from_seqs("1f1b-interleaved-memlean", M, N, V, fwd, bwd, warm)


# canonical builder names + legacy schedule-table aliases -------------------
_ALIASES = {
    "gpipe": ("gpipe", {}),
    "1f1b": ("1f1b", {}),
    "1f1b-2x": ("1f1b", {"double_warmup": True}),
    "1f1b-interleaved": ("1f1b-interleaved", {}),
    "1f1b-interleaved-memlean": ("1f1b-interleaved-memlean", {}),
    "dapple": ("dapple", {}),
    "zb-h1": ("zb-h1", {}),
    "zb_h1": ("zb-h1", {}),
    "zb-h2": ("zb-h2", {}),
    "zb_h2": ("zb-h2", {}),
    "zb-auto": ("zb-auto", {}),
    "zb_auto": ("zb-auto", {}),
    # legacy closed-form/simulator names
    "1F1B-AS": ("1f1b", {}),
    "1F1B-SNO": ("1f1b", {}),
    "FBP-AS": ("1f1b", {"double_warmup": True}),
    "1F1B-SO": ("1f1b", {"double_warmup": True}),
    "1F1B-I": ("1f1b-interleaved", {}),
    "1F1B-I-ML": ("1f1b-interleaved-memlean", {}),
    "DAPPLE": ("dapple", {}),
    "ZB-H1": ("zb-h1", {}),
    "ZB-H2": ("zb-h2", {}),
    "ZB-AUTO": ("zb-auto", {}),
}

_BUILDERS = {
    "gpipe": lambda M, N, V, **kw: build_gpipe(M, N),
    "1f1b": lambda M, N, V, **kw: build_1f1b(M, N, **kw),
    "1f1b-interleaved": lambda M, N, V, **kw: build_1f1b_interleaved(M, N, V),
    "1f1b-interleaved-memlean":
        lambda M, N, V, **kw: build_1f1b_interleaved_memlean(M, N, V),
    "dapple": lambda M, N, V, **kw: build_dapple(M, N),
    "zb-h1": lambda M, N, V, **kw: build_zb_h1(M, N),
    "zb-h2": lambda M, N, V, **kw: build_zb_h2(M, N),
    "zb-auto": lambda M, N, V, **kw: build_zb_auto(M, N, **kw),
}

INTERLEAVED = ("1f1b-interleaved", "1f1b-interleaved-memlean")

#: every canonical builder name
BUILDER_NAMES = ("gpipe", "1f1b", "dapple", "zb-h1", "zb-h2", "zb-auto",
                 "1f1b-interleaved", "1f1b-interleaved-memlean")


def canonical_name(name: str) -> str:
    """Map a legacy schedule-table name (or canonical name) to the
    canonical builder name."""
    if name not in _ALIASES:
        raise ValueError(f"unknown schedule {name!r}")
    return _ALIASES[name][0]


def build_schedule(name: str, M: int, N: int, V: int = 1,
                   mem_limit=None,
                   grad_sync: Union[bool, int] = False) -> SchedPlan:
    """Build the op table for a schedule by canonical or legacy name.
    ``mem_limit`` is the automatic zero-bubble scheduler's peak-live cap
    (``zb-auto`` only: None = unbounded, int = uniform, sequence =
    per-device); other schedules' memory behaviour is fixed by their
    table and the knob is rejected.  ``grad_sync`` (the data-parallel
    gradient-sync AR ops) is not ported and raises."""
    builder, kw = _ALIASES.get(name, (None, None))
    if builder is None:
        raise ValueError(name)
    if V != 1 and canonical_name(name) not in INTERLEAVED:
        raise ValueError(f"V={V} only supported for interleaved schedules "
                         f"(got {name})")
    if mem_limit is not None:
        if builder != "zb-auto":
            raise ValueError(f"mem_limit only applies to zb-auto "
                             f"(got {name})")
        kw = dict(kw, mem_limit=mem_limit)
    if grad_sync:
        raise NotImplementedError(
            f"grad_sync={grad_sync!r}: the gradient-sync AR ops are not "
            f"ported yet (ROADMAP 'Still to port': tensor and data "
            f"parallel over NCCL)")
    return _BUILDERS[builder](M, N, V, **kw)


def resolve_ring_schedule(schedule: str, V: int) -> str:
    """Resolve ``PipelineConfig.schedule`` to a canonical builder name:
    ``auto`` is the plain 1F1B ring for V == 1 and the streaming
    interleave for V > 1."""
    if schedule in ("auto", "", None):
        return "1f1b" if V == 1 else "1f1b-interleaved"
    name = canonical_name(schedule)
    if V > 1 and name not in INTERLEAVED:
        raise ValueError(f"schedule {schedule!r} cannot run virtual={V} "
                         f"chunks; pick an interleaved schedule")
    return name


# ---------------------------------------------------------------------------
# Closed-form resident-features counts (validated against peak_live()).
# ---------------------------------------------------------------------------

def live_activation_counts(name: str, M: int, N: int, V: int = 1,
                           feat_mult: int = 1, mem_limit=None) -> list[int]:
    """Per-device peak resident chunk-activation counts — the algebraic
    form of :meth:`SchedPlan.peak_live`, O(1) per device so the explorer
    can sweep huge M without materialising tables.  ``feat_mult`` doubles
    the 1F1B window (FBP-AS / 1F1B-SO); ``mem_limit`` is the zb-auto
    peak-live cap (None = unbounded, where the cost of a fully bubble-free
    schedule is GPipe-like M resident activations).  Differentially tested
    against the symbolic replay in ``tests/test_torch_schedules.py``."""
    cname = canonical_name(name)
    caps = _normalize_caps(mem_limit, M, N) if cname == "zb-auto" else None
    out = []
    for n in range(N):
        if cname == "gpipe":
            w = M * V
        elif cname == "1f1b":
            # feat_mult=2 is the doubled-warm-up window (FBP-AS/1F1B-SO);
            # the symbolic replay gives 2(N-n)-1, the schedule tables round
            # up to 2(N-n) — kept here so partition.stage_memory is
            # bit-identical to the pre-IR arithmetic.
            w = feat_mult * (N - n)
        elif cname in ("dapple", "zb-h1"):
            # dapple == synchronous 1F1B; ZB-H1 keeps the same warm-up and
            # its W directly follows each B, so both hold the 1F1B window
            w = N - n
        elif cname == "zb-h2":
            # deep warm-up upstream, postponed weight-grads downstream
            # (see zb_h2_mem_caps)
            w = max(2 * (N - n) - 1, n + (N + 2) // 2)
        elif cname == "zb-auto":
            # the greedy fills to its cap (unbounded: every residual is
            # held until the drain's W sweep, so the row is M)
            w = caps[n]
        elif cname == "1f1b-interleaved":
            w = (V - 1) * M + (N - n)
        else:                          # 1f1b-interleaved-memlean
            w = 2 * (N - n - 1) + (V - 1) * N + 1
        out.append(max(1, min(M * V, w)))
    return out


# ---------------------------------------------------------------------------
# Ring lowering: compile the forward order into the serve executor's lookup
# tables.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RingLowering:
    """Per-element lookup tables for the synchronous tick executor.

    The executor runs ``n_ticks = M*V + N - 1`` ticks; at tick t, device s
    processes forward element ``e = t - s`` of the shared per-device
    forward sequence.  All arrays have length M*V and are indexed by e:

    * ``m_of_e`` / ``v_of_e`` — micro-batch and chunk of element e.
    * ``fresh``   — stage 0 injects fresh data (chunk-0 pass) at e.
    * ``direct``  — element e's input is the ring return arriving this
      very tick (produced by the last stage exactly N ticks earlier).
    * ``park``    — the ring return of element e must be parked in the
      stage-0 return buffer (slot ``m_of_e[e]``) until its next pass.
    * ``collect`` — element e's output on the last stage is a final
      (chunk V-1) output, written to ``outbuf[m_of_e[e]]``.
    """
    schedule: str
    M: int
    N: int
    V: int
    m_of_e: tuple[int, ...]
    v_of_e: tuple[int, ...]
    fresh: tuple[bool, ...]
    direct: tuple[bool, ...]
    park: tuple[bool, ...]
    collect: tuple[bool, ...]

    @property
    def n_ticks(self) -> int:
        return self.M * self.V + self.N - 1


def lower_to_ring(plan: SchedPlan) -> RingLowering:
    """Lower a schedule plan onto the ring executor.

    Validates that the plan is ring-executable:

    1. every device issues the same forward (m, v) sequence (device n's
       element e runs at tick e + n);
    2. chunk pass v+1 of a micro-batch is issued at least N elements
       after pass v, so its ring return has arrived.
    """
    M, N, V = plan.M, plan.N, plan.V
    seq0 = plan.forward_sequence(0)
    for n in range(1, N):
        if plan.forward_sequence(n) != seq0:
            raise ValueError(
                f"{plan.name}: devices disagree on the forward issue "
                f"order; not executable on the synchronous ring")
    index_of = {mv: e for e, mv in enumerate(seq0)}
    MV = M * V
    m_of_e = tuple(m for m, _ in seq0)
    v_of_e = tuple(v for _, v in seq0)
    fresh = tuple(v == 0 for v in v_of_e)
    direct = [False] * MV
    park = [False] * MV
    for e, (m, v) in enumerate(seq0):
        if v == 0:
            continue
        prev = index_of[(m, v - 1)]
        gap = e - prev
        if gap < N:
            raise ValueError(
                f"{plan.name}: pass {v} of micro-batch {m} issued only "
                f"{gap} elements after pass {v - 1}; the ring return "
                f"needs {N} ticks (M={M}, N={N}, V={V})")
        if gap == N:
            direct[e] = True
        else:
            park[prev] = True
    collect = tuple(v == V - 1 for v in v_of_e)
    return RingLowering(schedule=plan.name, M=M, N=N, V=V,
                        m_of_e=m_of_e, v_of_e=v_of_e, fresh=fresh,
                        direct=tuple(direct), park=tuple(park),
                        collect=collect)


# Tick lowering: compile the FULL mixed F/B(/W) table into the training
# runtime's per-device per-tick lookup arrays.
# ---------------------------------------------------------------------------

# op-kind codes of the tick tables (the executor's branch; TICK_AR, the
# data-parallel gradient sync, keeps its code but no port plan emits it)
TICK_IDLE, TICK_F, TICK_B, TICK_B_SEED, TICK_W, TICK_AR = range(6)


@dataclasses.dataclass(frozen=True)
class TickLowering:
    """Per-device per-tick lookup tables for the mixed F/B(/W) tick scan.

    The runtime runs ``n_ticks`` synchronous ticks; at tick t, device n
    executes op ``kind[n][t]`` on micro-batch ``m[n][t]`` chunk
    ``v[n][t]``.  Stage-boundary transfers are one-tick neighbour hops on
    two rings (forward ``n -> n+1``, backward ``n -> n-1``); an
    arrival the consuming op is not ready for is parked into a statically
    allocated inbox slot.  All buffers are register-allocated from the op
    table, so the residual stash size ``n_x`` IS the schedule's peak-live
    row — the runtime's memory follows the IR's features-memory claim by
    construction.

    Tables (each ``[N][n_ticks]``; -1 = not applicable this tick):

    * ``kind``  — TICK_IDLE / TICK_F / TICK_B / TICK_B_SEED / TICK_W.
      TICK_B_SEED sits on the last virtual stage: its cotangent is
      seeded by the per-micro-batch loss head, not the ring.
    * ``m`` / ``v`` — micro-batch and chunk of the tick's op.
    * ``xw`` — residual-stash slot an F writes its stage input to.
    * ``xr`` — residual-stash slot a B/W reads (released by the last
      reader: B for two-op plans, W for zero-bubble plans).
    * ``fsrc`` — F input source: 0 fresh injection (stage 0, chunk-0
      pass), 1 the forward ring carry arriving this very tick, 2 a
      forward-inbox slot (``fr``).
    * ``fpark`` — forward-inbox slot the tick's *arriving* forward carry
      must be parked into (independent of the device's own op).
    * ``bsrc`` / ``br`` / ``bpark`` — same for backward cotangents
      (0 = loss-seeded, never read from the ring).
    * ``cw`` / ``cr`` — zero-bubble cotangent stash: a B stores its
      output-cotangent for the matching W (``cw``: the ring error, or —
      on the seeded last virtual stage — the loss head's y-cotangent);
      the W reads it back (``cr``).
    * ``dinj`` — True where a B's input-cotangent is the gradient of the
      fresh injection (virtual stage 0): written to the d_inj buffer for
      the embedding backward instead of the ring.
    """
    schedule: str
    M: int
    N: int
    V: int
    n_ticks: int
    has_w: bool
    kind: tuple[tuple[int, ...], ...]
    m: tuple[tuple[int, ...], ...]
    v: tuple[tuple[int, ...], ...]
    xw: tuple[tuple[int, ...], ...]
    xr: tuple[tuple[int, ...], ...]
    fsrc: tuple[tuple[int, ...], ...]
    fr: tuple[tuple[int, ...], ...]
    fpark: tuple[tuple[int, ...], ...]
    bsrc: tuple[tuple[int, ...], ...]
    br: tuple[tuple[int, ...], ...]
    bpark: tuple[tuple[int, ...], ...]
    cw: tuple[tuple[int, ...], ...]
    cr: tuple[tuple[int, ...], ...]
    dinj: tuple[tuple[bool, ...], ...]
    n_x: int
    n_f: int
    n_b: int
    n_c: int


def _assign_ticks(plan: SchedPlan):
    """Greedy in-order synchronous scheduling: at each tick every device
    runs its next op if the op's inputs were produced at a strictly
    earlier tick (one-tick neighbour hops), else stalls.  Returns
    (f_tick, b_tick, w_tick, n_ticks) keyed by (m, vstage).  Devices are
    scanned highest-first, as in the JAX package; the scan order cannot
    change placement because an op placed at tick t never enables
    another op at the same tick."""
    M, N, NS = plan.M, plan.N, plan.N * plan.V
    f_tick: dict = {}
    b_tick: dict = {}
    w_tick: dict = {}
    ptr = [0] * N
    total = sum(len(ops) for ops in plan.device_ops)
    placed = 0
    t = 0
    while placed < total:
        progressed = False
        for n in reversed(range(N)):
            if ptr[n] >= len(plan.device_ops[n]):
                continue
            op = plan.device_ops[n][ptr[n]]
            key = (op.m, op.vstage)
            if op.kind == "F":
                ok = op.vstage == 0 or (
                    (op.m, op.vstage - 1) in f_tick
                    and f_tick[(op.m, op.vstage - 1)] + 1 <= t)
            elif op.kind == "B":
                if op.vstage == NS - 1:
                    ok = key in f_tick and f_tick[key] + 1 <= t
                else:
                    ok = (key in f_tick
                          and (op.m, op.vstage + 1) in b_tick
                          and b_tick[(op.m, op.vstage + 1)] + 1 <= t)
            else:                       # W: any time after its own B
                ok = key in b_tick and b_tick[key] + 1 <= t
            if ok:
                tick_of = {"F": f_tick, "B": b_tick, "W": w_tick}[op.kind]
                tick_of[key] = t
                ptr[n] += 1
                placed += 1
                progressed = True
        if not progressed:
            raise ValueError(
                f"{plan.name}: tick lowering deadlocked at tick {t} with "
                f"{total - placed} ops unplaced (pointers {ptr}) — the op "
                f"table has a cyclic cross-device dependency")
        t += 1
    return f_tick, b_tick, w_tick, t


def _alloc_slots(intervals):
    """Linear-scan register allocation of [start, end]-inclusive lifetime
    intervals onto the fewest slots (a slot is reusable from end+1).
    Returns ({key: slot}, n_slots)."""
    import heapq
    out: dict = {}
    free: list = []
    inuse: list = []
    n_slots = 0
    for start, end, key in sorted(intervals):
        while inuse and inuse[0][0] < start:
            heapq.heappush(free, heapq.heappop(inuse)[1])
        slot = heapq.heappop(free) if free else n_slots
        n_slots = max(n_slots, slot + 1)
        out[key] = slot
        heapq.heappush(inuse, (end, slot))
    return out, n_slots


def lower_to_ticks(plan: SchedPlan) -> TickLowering:
    """Compile the full mixed F/B(/W) op table onto the synchronous
    two-ring executor (see :class:`TickLowering`)."""
    M, N, V = plan.M, plan.N, plan.V
    NS = N * V
    has_w = plan.has_w
    f_tick, b_tick, w_tick, n_ticks = _assign_ticks(plan)
    release = w_tick if has_w else b_tick

    def dev_of(vs: int) -> int:
        return vs % N

    # --- per-device slot allocation ------------------------------------
    n_x = n_f = n_b = n_c = 0
    xslot: dict = {}
    fslot: dict = {}
    bslot: dict = {}
    cslot: dict = {}
    for n in range(N):
        xs = [(f_tick[k], release[k], k) for k in f_tick
              if dev_of(k[1]) == n]
        s, c = _alloc_slots(xs)
        xslot.update(s)
        n_x = max(n_x, c)
        fs = []
        for (m, vs), t in f_tick.items():
            if dev_of(vs) != n or vs == 0:
                continue
            arr = f_tick[(m, vs - 1)] + 1
            if arr < t:                      # not consumed on arrival
                fs.append((arr, t, (m, vs)))
        s, c = _alloc_slots(fs)
        fslot.update(s)
        n_f = max(n_f, c)
        bs = []
        for (m, vs), t in b_tick.items():
            if dev_of(vs) != n or vs == NS - 1:
                continue
            arr = b_tick[(m, vs + 1)] + 1
            if arr < t:
                bs.append((arr, t, (m, vs)))
        s, c = _alloc_slots(bs)
        bslot.update(s)
        n_b = max(n_b, c)
        if has_w:
            cs = [(b_tick[k], w_tick[k], k) for k in b_tick
                  if dev_of(k[1]) == n]
            s, c = _alloc_slots(cs)
            cslot.update(s)
            n_c = max(n_c, c)

    # --- table emission -------------------------------------------------
    def tab(fill):
        return [[fill] * n_ticks for _ in range(N)]

    kind = tab(TICK_IDLE)
    m_t = tab(0)
    v_t = tab(0)
    xw = tab(-1)
    xr = tab(-1)
    fsrc = tab(0)
    fr = tab(-1)
    fpark = tab(-1)
    bsrc = tab(0)
    br = tab(-1)
    bpark = tab(-1)
    cw = tab(-1)
    cr = tab(-1)
    dinj = tab(False)

    for (m, vs), t in f_tick.items():
        n = dev_of(vs)
        kind[n][t] = TICK_F
        m_t[n][t] = m
        v_t[n][t] = vs // N
        xw[n][t] = xslot[(m, vs)]
        if vs == 0:
            fsrc[n][t] = 0
        elif (m, vs) in fslot:
            fsrc[n][t] = 2
            fr[n][t] = fslot[(m, vs)]
            fpark[n][f_tick[(m, vs - 1)] + 1] = fslot[(m, vs)]
        else:
            fsrc[n][t] = 1
    for (m, vs), t in b_tick.items():
        n = dev_of(vs)
        seed = vs == NS - 1
        kind[n][t] = TICK_B_SEED if seed else TICK_B
        m_t[n][t] = m
        v_t[n][t] = vs // N
        xr[n][t] = xslot[(m, vs)]
        if not seed:
            if (m, vs) in bslot:
                bsrc[n][t] = 2
                br[n][t] = bslot[(m, vs)]
                bpark[n][b_tick[(m, vs + 1)] + 1] = bslot[(m, vs)]
            else:
                bsrc[n][t] = 1
        if has_w:
            cw[n][t] = cslot[(m, vs)]
        if vs == 0:
            dinj[n][t] = True
    for (m, vs), t in w_tick.items():
        n = dev_of(vs)
        kind[n][t] = TICK_W
        m_t[n][t] = m
        v_t[n][t] = vs // N
        xr[n][t] = xslot[(m, vs)]
        cr[n][t] = cslot[(m, vs)]
    frz = lambda rows: tuple(tuple(r) for r in rows)
    return TickLowering(
        schedule=plan.name, M=M, N=N, V=V, n_ticks=n_ticks, has_w=has_w,
        kind=frz(kind), m=frz(m_t), v=frz(v_t), xw=frz(xw), xr=frz(xr),
        fsrc=frz(fsrc), fr=frz(fr), fpark=frz(fpark),
        bsrc=frz(bsrc), br=frz(br), bpark=frz(bpark),
        cw=frz(cw), cr=frz(cr), dinj=frz(dinj),
        n_x=n_x, n_f=n_f, n_b=n_b, n_c=n_c)
