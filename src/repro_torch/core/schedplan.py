"""Schedule-plan IR (the port's copy of the parts of ``repro/core/
schedplan.py`` that serving and V = 1 training run).

A :class:`SchedPlan` holds, per physical device, the exact sequence of
``F``/``B`` (and, for zero-bubble plans, ``W``) ops tagged with
micro-batch ``m`` and virtual chunk ``v``.  Two lowerings compile it:

* :func:`lower_to_ring` — the forward order as the per-element lookup
  tables the pipelined serve step executes (``e = tick - stage``);
* :func:`lower_to_ticks` — the full mixed F/B(/W) table as the per-device
  per-tick lookup tables the training executor replays, with the residual
  stash, the inbox slots and the zero-bubble cotangent stash allocated
  statically from the table.

Ported builders: ``gpipe``, ``1f1b`` (``1f1b-2x`` with the doubled
warm-up), ``dapple`` and ``zb-h1``.  ``zb-h2``, ``zb-auto``, the
interleaved builders, the gradient-sync AR ops and the instruction
lowering stay in the JAX package until they are ported (ROADMAP "Still to
port"); :func:`build_schedule` names them and raises.
"""
from __future__ import annotations

import dataclasses


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
    "dapple": lambda M, N, V, **kw: build_dapple(M, N),
    "zb-h1": lambda M, N, V, **kw: build_zb_h1(M, N),
}

INTERLEAVED = ("1f1b-interleaved", "1f1b-interleaved-memlean")


def canonical_name(name: str) -> str:
    """Map a legacy schedule-table name (or canonical name) to the
    canonical builder name."""
    if name not in _ALIASES:
        raise ValueError(f"unknown schedule {name!r}")
    return _ALIASES[name][0]


def build_schedule(name: str, M: int, N: int, V: int = 1) -> SchedPlan:
    """Build the op table for a schedule by canonical or legacy name."""
    builder, kw = _ALIASES.get(name, (None, None))
    if builder is None:
        raise ValueError(name)
    if V != 1 and canonical_name(name) not in INTERLEAVED:
        raise ValueError(f"V={V} only supported for interleaved schedules "
                         f"(got {name})")
    if builder not in _BUILDERS:
        raise NotImplementedError(
            f"schedule {name!r} ({builder}) is not ported yet (ROADMAP "
            f"'Still to port': zb-h2/zb-auto/interleaved training); the "
            f"port builds {sorted(_BUILDERS)}")
    return _BUILDERS[builder](M, N, V, **kw)


def resolve_ring_schedule(schedule: str, V: int) -> str:
    """Resolve ``PipelineConfig.schedule`` to a canonical builder name:
    ``auto`` is the plain 1F1B ring (V == 1; interleaved serving is not
    ported yet)."""
    if V != 1:
        raise NotImplementedError(f"virtual={V} serving is not ported yet")
    if schedule in ("auto", "", None):
        return "1f1b"
    return canonical_name(schedule)


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
