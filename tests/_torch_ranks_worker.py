"""The rank side of ``tests/test_torch_ranks.py``, and the in-process
runs it is held to.  Every spawned rank imports this module, so it
imports neither JAX nor the JAX package.

A case is a dict: ``name``; ``arch`` (``llama3.2-1b`` reduced to 4
layers, d_model 64, 4/2 heads, as ``tests/test_torch_train.py``, or
``mamba2-2.7b`` reduced to 2 layers); ``tied``; ``V``; ``pcfg`` (a
``PipelineConfig``); ``rows`` and ``seq`` of the batches; ``steps`` (0:
one loss and gradients; else that many AdamW steps); ``weights`` (None:
the seed-0 weights, drawn by ``init_stage_params`` on a rank and
``init_stacked_params`` in process; else a stacked numpy tree).  A
case may also hold ``ref`` (the name of the in-process case it is held
to, which then does not run again in process), ``hold`` (seconds rank 1
sleeps before its step, both ranks leaving a barrier together; the run
is traced: :func:`_traced`) or ``cli`` (``launch.train.main``'s argv:
with ``--runtime stream`` added on the ranks, as it is in process).
"""
import dataclasses
import time

import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch import train
from repro_torch.optim import adamw as OPT
from repro_torch.pipeline import comm as C
from repro_torch.pipeline import runtime as RT
from repro_torch.pipeline import stage as ST

LR = 1e-2


def config(arch: str, S: int, V: int = 1, tied: bool = True):
    if arch == "mamba2-2.7b":
        cfg = get_config(arch).reduced(n_layers=2, d_model=64)
        kw = {}
    else:
        cfg = get_config(arch).reduced(n_layers=4, d_model=64)
        kw = dict(n_kv_heads=2)
    return dataclasses.replace(cfg, stages=S, tensor=1, virtual=V,
                               tie_embeddings=tied, **kw)


def _traced(fn) -> tuple:
    """``fn()`` and its trace: each tick's start and end (``("tick" |
    "ticked", slot, time)``) and each wait for a posted message
    (``("recv" | "send", slot of the tick running then or -1, time)``)."""
    events, cur = [], [-1]
    tick, settle = RT._StageRun.tick, C.Transport._settle

    def traced_tick(self, t, f_arr, b_arr):
        cur[0] = t
        events.append(("tick", t, time.time()))
        try:
            return tick(self, t, f_arr, b_arr)
        finally:
            events.append(("ticked", t, time.time()))
            cur[0] = -1

    def traced_settle(self, h):
        events.append(("recv" if h.recv else "send", cur[0], time.time()))
        return settle(self, h)

    RT._StageRun.tick, C.Transport._settle = traced_tick, traced_settle
    try:
        return fn(), events
    finally:
        RT._StageRun.tick, C.Transport._settle = tick, settle


def _run_cli(case: dict, mesh=None) -> dict:
    """``launch.train.main`` as the case's ``cli`` says: in process, or
    with ``--runtime stream`` as this rank of ``mesh``."""
    if mesh is None:
        out = train.main(case["cli"])
    else:
        out = train.main(case["cli"] + ["--runtime", "stream"], mesh=mesh)
    return dict(losses=out["losses"], stash=out["stash_slots"],
                live=out["live_registers"], runtime=out["runtime"])


def _run(case: dict, S: int, rank=None, group=None) -> dict:
    """One case at S stages: on rank ``rank`` of ``group``, or in process
    (``rank`` None).  Returns the loss(es), the gradients or the trained
    parameters and moments, the stash count(s), the most registers held
    live and (on a rank) the hop messages, bytes and a traced run's
    events."""
    cfg = config(case["arch"], S, case["V"], case["tied"])
    plan = ST.plan_stages(cfg)
    opt = (OPT.AdamW(lr=OPT.warmup_cosine(LR, 20, case["steps"]),
                     weight_decay=0.01) if case["steps"] else None)
    step = RT.make_train_step(cfg, plan, case["pcfg"], optimizer=opt,
                              group=group)
    if case["weights"] is not None:
        params = convert.from_jax(case["weights"], device="cpu")
        if rank is not None:
            params = ST.stage_share(params, plan, rank)
    elif rank is None:
        params = ST.init_stacked_params(cfg, 0, plan, device="cpu")
    else:
        params = ST.init_stage_params(cfg, 0, plan, rank, device="cpu")
    data = SyntheticLM(cfg.vocab, case["seq"], case["rows"], device="cpu")
    extra = {}
    if not case["steps"]:
        if case.get("hold") is None:
            loss, grads = step(params, data.batch(0))
        else:
            batch = data.batch(0)
            dist.barrier(group)
            if rank == 1:
                time.sleep(case["hold"])
            (loss, grads), extra["events"] = _traced(
                lambda: step(params, batch))
        out = dict(loss=loss, grads=grads)
    else:
        state, losses = opt.init(params), []
        for i in range(case["steps"]):
            params, state, metrics = step(params, state, data.batch(i))
            losses.append(metrics["loss"])
        out = dict(losses=losses, params=params, m=state["m"], v=state["v"])
    if rank is not None:
        extra["hop"] = step.transport.stats["hop"][:2]
    return dict(out, stash=step.stash_slots, live=step.live_registers,
                **extra)


def in_process_cases(mesh, cases: dict, one_rank: list) -> dict:
    """``{S: {name: each case at S stages on the in-process executor}}``
    (a case held to another, ``ref``, skipped), in this 1-rank process,
    one torch thread; under ``"one rank"`` each case of ``one_rank`` at 1
    stage on the rank executor over this 1-rank group (at V > 1 the ring
    wraps to the rank itself) and in process."""
    torch.set_num_threads(1)
    out = {S: {c["name"]: _run_cli(c) if "cli" in c else _run(c, S)
               for c in cs if "ref" not in c}
           for S, cs in cases.items()}
    out["one rank"] = {c["name"]: (_run(c, 1, 0, mesh.group), _run(c, 1))
                       for c in one_rank}
    return out


def run_cases(mesh, cases: list) -> dict:
    """Every case on this rank (one torch thread, as the in-process runs
    it is compared with)."""
    torch.set_num_threads(1)
    return {c["name"]: _run_cli(c, mesh) if "cli" in c
            else _run(c, mesh.world, mesh.rank, mesh.group)
            for c in cases}
