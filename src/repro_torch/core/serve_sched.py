"""Continuous-batching request scheduler over the slot-based KV cache (the
port's copy of ``repro/core/serve_sched.py``).

Requests arrive at different times, have different prompt lengths and
finish at different times, yet the pipeline runs one fixed-shape step.
The decode cache's batch rows are *slots*, each with its own per-layer
``len`` offset, so requests at different positions share one batch.
Every engine step processes ``chunk`` columns of every slot; a per-slot
``n_valid`` count (0 = idle, 1 = decode tick, up to ``chunk`` = a chunked
prefill bite, Sarathi-style) says how many columns are real.  Admitting,
retiring or switching a slot from prefill to decode changes only data.

The host half (:class:`ServeScheduler`, :func:`mixed_op_table`, the slot
budget) touches no tensor and equals the JAX package's output exactly.
:class:`ContinuousEngine` closes the loop against a serve step: the
pipelined :func:`repro_torch.pipeline.runtime.make_serve_step` or the
single-device :func:`make_local_serve_step`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import schedplan as SP
from repro_torch.models import model as M
from repro_torch.pipeline import runtime as RT

IDLE, PREFILL, DECODE = "idle", "prefill", "decode"


# ---------------------------------------------------------------------------
# Requests and per-step work descriptions.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    """One generation request: prompt tokens in, ``max_new`` tokens out."""
    rid: int
    prompt: list[int]
    max_new: int
    arrival: int = 0          # engine step at which the request arrives

    # runtime state (managed by the scheduler)
    slot: int = -1
    pos: int = 0              # prompt tokens already prefilled into the cache
    generated: list[int] = dataclasses.field(default_factory=list)
    t_admit: int = -1
    t_first: int = -1         # step that produced the first output token
    t_done: int = -1

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new


@dataclasses.dataclass(frozen=True)
class SlotWork:
    """What one cache slot does during one engine step."""
    slot: int
    kind: str                 # idle | prefill | decode
    n_valid: int
    rid: int = -1


@dataclasses.dataclass
class StepPlan:
    """Inputs of one engine step (static shapes)."""
    tokens: np.ndarray        # [n_slots, chunk] int32
    n_valid: np.ndarray       # [n_slots] int32
    work: list[SlotWork]

    @property
    def busy(self) -> int:
        return int(np.sum(self.n_valid > 0))


# ---------------------------------------------------------------------------
# Scheduler: admission + per-step role assignment.
# ---------------------------------------------------------------------------

class ServeScheduler:
    """Greedy continuous-batching scheduler.

    Admission: first free slot, FIFO over arrivals.  A slot runs its
    request's chunked prefill to completion (one ``chunk``-column bite per
    step), then decodes one token per step until ``max_new`` tokens exist,
    then frees.  Prefill chunks and decode ticks of different slots ride
    the same step, so a new request's prefill never stalls running
    decodes.
    """

    def __init__(self, n_slots: int, chunk: int):
        if n_slots < 1 or chunk < 1:
            raise ValueError(f"n_slots={n_slots}, chunk={chunk}: both must "
                             f"be >= 1")
        self.n_slots = n_slots
        self.chunk = chunk
        self.slots: list[Optional[Request]] = [None] * n_slots
        self.retired: list[Request] = []

    def free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    def active(self) -> bool:
        return any(r is not None for r in self.slots)

    def admit(self, req: Request, t: int = 0) -> bool:
        """Place ``req`` into the lowest free slot; False when full."""
        free = self.free_slots()
        if not free:
            return False
        req.slot = free[0]
        req.pos = 0
        req.t_admit = t
        self.slots[req.slot] = req
        return True

    def plan_step(self) -> StepPlan:
        """Assign this step's per-slot roles and build its inputs."""
        C = self.chunk
        tokens = np.zeros((self.n_slots, C), np.int32)
        n_valid = np.zeros((self.n_slots,), np.int32)
        work: list[SlotWork] = []
        for s, req in enumerate(self.slots):
            if req is None:
                work.append(SlotWork(s, IDLE, 0))
                continue
            if req.pos < len(req.prompt):
                nv = min(C, len(req.prompt) - req.pos)
                tokens[s, :nv] = req.prompt[req.pos:req.pos + nv]
                n_valid[s] = nv
                work.append(SlotWork(s, PREFILL, nv, req.rid))
            else:
                tokens[s, 0] = req.generated[-1]
                n_valid[s] = 1
                work.append(SlotWork(s, DECODE, 1, req.rid))
        return StepPlan(tokens=tokens, n_valid=n_valid, work=work)

    def observe(self, sp: StepPlan, next_tokens: np.ndarray, t: int = 0
                ) -> list[Request]:
        """Fold one step's sampled tokens back into the request states.
        Returns the requests retired by this step (their slots are free
        for the next admission round)."""
        finished: list[Request] = []
        for w in sp.work:
            req = self.slots[w.slot]
            if w.kind == IDLE:
                continue
            if req is None or req.rid != w.rid:
                raise RuntimeError(f"slot {w.slot} holds "
                                   f"{None if req is None else req.rid}, "
                                   f"the step planned request {w.rid}")
            tok = int(next_tokens[w.slot])
            if w.kind == PREFILL:
                req.pos += w.n_valid
                if req.pos < len(req.prompt):
                    continue          # mid-prompt chunk: logits discarded
            # prompt just completed (its last logit IS the first new
            # token) or a decode tick: either way ``tok`` is output.
            req.generated.append(tok)
            if req.t_first < 0:
                req.t_first = t
            if req.done:
                req.t_done = t
                req.slot = -1
                self.slots[w.slot] = None
                self.retired.append(req)
                finished.append(req)
        return finished


# ---------------------------------------------------------------------------
# Mixed prefill/decode op tables (schedplan IR view of one engine step).
# ---------------------------------------------------------------------------

def mixed_op_table(work: Sequence[SlotWork], M: int, N: int, V: int = 1,
                   schedule: str = "auto"):
    """Lower one engine step to the schedplan IR: the ring schedule's op
    table from :func:`schedplan.build_schedule` plus the per-micro-batch
    slot roles it carries (micro-batch ``m`` = slots ``[m*mb, (m+1)*mb)``).

    Returns ``(plan, roles)`` where ``roles[m]`` is the tuple of slot
    kinds bundled into micro-batch ``m``: the table's F op for ``m`` is a
    mixed prefill/decode bundle exactly when the tuple mixes kinds."""
    name = SP.resolve_ring_schedule(schedule, V)
    plan = SP.build_schedule(name, M, N, V)
    n_slots = len(work)
    if n_slots % M:
        raise ValueError(f"{n_slots} slots do not split into M={M} "
                         f"micro-batches")
    mb = n_slots // M
    roles = {m: tuple(w.kind for w in work[m * mb:(m + 1) * mb])
             for m in range(M)}
    return plan, roles


def format_mixed_table(plan, roles) -> str:
    """Human-readable mixed table: one line per device, F ops annotated
    with the role letters (P/D/-) of the slots their micro-batch holds."""
    tag = {PREFILL: "P", DECODE: "D", IDLE: "-"}
    lines = []
    for dev, ops in enumerate(plan.device_ops):
        cells = []
        for op in ops:
            if op.kind != "F":
                continue
            r = "".join(tag[k] for k in roles[op.m])
            cells.append(f"F{op.m}" + (f".{op.v}" if plan.V > 1 else "")
                         + f"[{r}]")
        lines.append(f"dev{dev}: " + " ".join(cells))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Explorer-style memory gating: how many slots fit a device?
# ---------------------------------------------------------------------------

def kv_bytes_per_slot(cfg: ArchConfig, max_len: int, itemsize: int = 4
                      ) -> int:
    """Cache bytes one slot pins across ALL layers (model total)."""
    if cfg.attn_kind == "mla":
        per_tok = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim
    else:
        per_tok = 2 * max(1, cfg.n_kv_heads) * cfg.resolved_head_dim
    return cfg.n_layers * max_len * per_tok * itemsize


def serve_slot_budget(cfg: ArchConfig, max_len: int, mem_limit_bytes: float,
                      *, n_stages: int = 0, weight_bytes: float = 0.0,
                      itemsize: int = 4, microbatches: int = 1) -> int:
    """Largest slot count whose per-stage cache footprint (plus resident
    stage weights) fits under ``mem_limit_bytes``: serving's analogue of
    the explorer's activation-memory gate, trading concurrent requests for
    pinned KV rows.  Floored to a multiple of ``microbatches`` (the ring
    splits slots evenly)."""
    stages = max(1, n_stages or cfg.stages)
    layers_per_stage = math.ceil(cfg.n_layers / stages)
    per_slot = kv_bytes_per_slot(cfg, max_len, itemsize) \
        * layers_per_stage / cfg.n_layers
    free = mem_limit_bytes - weight_bytes
    if free < per_slot:
        return 0
    slots = int(free // per_slot)
    return (slots // microbatches) * microbatches


# ---------------------------------------------------------------------------
# The engine: admission, step and observe in an open loop.
# ---------------------------------------------------------------------------

def reset_slot_offsets(cache: dict, mask) -> dict:
    """Zero the per-slot kv ``len`` offsets where ``mask`` [n_slots] is
    True (slot admission or reuse), IN PLACE; only the ``kv`` subtree's
    ``len`` leaves move."""
    for a in RT._kv_len_leaves(cache):
        a[..., torch.as_tensor(mask, dtype=torch.bool, device=a.device)] = 0
    return cache


def _device_of(tree: dict) -> torch.device:
    a = next(iter(tree.values()))
    return _device_of(a) if isinstance(a, dict) else a.device


class ContinuousEngine:
    """Drives admission -> step -> observe over a serve step.

    ``step(params, cache, dict(tokens, n_valid)) -> (logits, cache)`` with
    ``logits`` ``[n_slots, 1, vocab]`` gathered at each slot's last valid
    column; ``tokens`` [n_slots, chunk] and ``n_valid`` [n_slots] reach it
    as int32 tensors on the cache's device.  Sampling is greedy argmax
    (bit-stable across runs, which the invariance tests pin).  The clock
    is the engine-step counter: arrivals are admitted when their
    ``arrival`` step has passed and a slot is free.

    The cache needs ``max_len >= longest prompt + max_new + chunk``:
    every step writes ``chunk`` columns at each slot's offset, and a write
    that would run past the end is clamped to start at ``max_len -
    chunk`` (as ``lax.dynamic_update_slice`` clamps in the JAX package),
    so padding columns near the end would overwrite real keys.
    """

    def __init__(self, cfg: ArchConfig, step: Callable, params, cache,
                 n_slots: int, chunk: int):
        if cfg.family in ("ssm", "hybrid", "audio"):
            raise ValueError(
                f"continuous batching is attention-family only (gqa/mla); "
                f"{cfg.family} carries recurrent state that padded slot "
                f"columns would pollute")
        self.cfg = cfg
        self.step = step
        self.params = params
        self.cache = cache
        self.device = _device_of(cache)
        self.sched = ServeScheduler(n_slots, chunk)
        self.steps_run = 0
        self.step_log: list[StepPlan] = []

    def _reset_slots(self, slot_ids: list[int]):
        """Rewind freed/reused slots' kv offsets to 0.  Stale K/V rows are
        harmless: positions below the new request's write head get
        overwritten, positions above it stay causally masked."""
        mask = np.zeros((self.sched.n_slots,), bool)
        mask[slot_ids] = True
        self.cache = reset_slot_offsets(self.cache, mask)

    def run(self, requests: Sequence[Request], max_steps: int = 10_000
            ) -> list[Request]:
        """Open loop: admit each request at its ``arrival`` step, run
        until every request retired.  Returns the requests retired by
        THIS call (the engine keeps the full history in
        ``sched.retired``)."""
        pending = sorted(requests, key=lambda r: (r.arrival, r.rid))
        n0 = len(self.sched.retired)
        t = self.steps_run
        while pending or self.sched.active():
            admitted = []
            while pending and pending[0].arrival <= t:
                if not self.sched.admit(pending[0], t):
                    break
                admitted.append(pending.pop(0).slot)
            if admitted:
                self._reset_slots(admitted)
            sp = self.sched.plan_step()
            if sp.busy == 0:
                # nothing in flight: jump the clock to the next arrival
                t = max(t + 1, pending[0].arrival)
                continue
            logits, self.cache = self.step(
                self.params, self.cache,
                dict(tokens=torch.from_numpy(sp.tokens).to(self.device),
                     n_valid=torch.from_numpy(sp.n_valid).to(self.device)))
            toks = logits[:, 0, :self.cfg.vocab].argmax(dim=-1).cpu().numpy()
            self.sched.observe(sp, toks, t)
            self.step_log.append(sp)
            self.steps_run += 1
            t += 1
            if self.steps_run > max_steps:
                raise RuntimeError("engine did not drain "
                                   f"within {max_steps} steps")
        return self.sched.retired[n0:]


# ---------------------------------------------------------------------------
# Single-device reference step (tests + baselines).
# ---------------------------------------------------------------------------

def make_local_serve_step(cfg: ArchConfig):
    """Single-device serve step with the pipelined step's contract: mixed
    per-slot prefill/decode over the per-slot-offset cache ([L, B, ...]
    leaves, ``model.init_cache``), logits gathered at each slot's last
    valid column, offsets advanced by ``n_valid``.  The cache is updated
    in place."""

    def step(params: dict, cache: dict, batch: dict):
        tokens = batch["tokens"]
        B, T = tokens.shape
        nv = torch.as_tensor(batch["n_valid"], dtype=torch.int32,
                             device=tokens.device)
        lens = [a.clone() for a in RT._kv_len_leaves(cache)]
        x, _, cache = M.forward(cfg, params, dict(tokens=tokens), cache=cache)
        # forward advanced every row by the full chunk width; rewind and
        # re-advance by each slot's valid count
        for a, a0 in zip(RT._kv_len_leaves(cache), lens):
            a.copy_(a0)
        RT._advance_len(cache, nv)
        col = nv.long().clamp(1, T) - 1
        h = x[torch.arange(B, device=tokens.device), col][:, None]
        table = params.get("head", params["embed"])
        return (h @ table.T).float(), cache

    return step
