"""Schedule-plan IR, the serve ring's share (the port's copy of the parts of
``repro/core/schedplan.py`` that forward-only serving runs).

A :class:`SchedPlan` holds, per physical device, the exact sequence of
``F``/``B`` ops tagged with micro-batch ``m`` and virtual chunk ``v``.
Serving replays only its forward order: :func:`lower_to_ring` compiles
that order into the per-element lookup tables the pipelined serve step
executes (``e = tick - stage``).

Ported builders: ``gpipe`` and ``1f1b`` (``1f1b-2x`` with the doubled
warm-up).  Both issue the same forward order on every device, which is all
the ring needs.  The zero-bubble, DAPPLE and interleaved builders stay in
the JAX package until training and V > 1 serving are ported;
:func:`build_schedule` names them and raises.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Op:
    """One unit of pipeline work: the F (forward) or B (backward) of
    micro-batch ``m`` on chunk ``v`` of physical device ``device``."""
    kind: str                       # "F" | "B"
    m: int                          # micro-batch index
    v: int                          # chunk index on this device (0..V-1)
    device: int                     # physical device n (0..N-1)
    n_stages: int                   # N
    n_chunks: int                   # V


@dataclasses.dataclass(frozen=True)
class SchedPlan:
    """Compiled per-device op table for one mini-batch of M micro-batches
    through N devices with V virtual chunks per device."""
    name: str
    M: int
    N: int
    V: int
    device_ops: tuple[tuple[Op, ...], ...]   # [N] tuples, issue order

    def validate(self) -> "SchedPlan":
        """Every (m, chunk) F and B appears exactly once per device, and
        each B comes after its F."""
        for n, ops in enumerate(self.device_ops):
            seen: dict[tuple[str, int, int], int] = {}
            for i, op in enumerate(ops):
                key = (op.kind, op.m, op.v)
                if op.kind not in ("F", "B"):
                    raise ValueError(f"{self.name}: op kind {op.kind!r} is "
                                     f"not ported (device {n})")
                if key in seen:
                    raise ValueError(f"{self.name}: duplicate {key} on "
                                     f"device {n}")
                seen[key] = i
            if len(ops) != 2 * self.M * self.V:
                raise ValueError(
                    f"{self.name}: device {n} has {len(ops)} compute ops, "
                    f"expected {2 * self.M * self.V}")
            for (kind, m, v), i in seen.items():
                if kind == "B" and seen[("F", m, v)] > i:
                    raise ValueError(f"{self.name}: B({m},{v}) before its F "
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
            f"schedule {name!r} ({builder}) is not ported yet; the port "
            f"builds {sorted(_BUILDERS)}")
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
