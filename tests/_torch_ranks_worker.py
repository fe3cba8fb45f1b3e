"""The rank side of ``tests/test_torch_ranks.py``, and the in-process
runs it is held to.  Every spawned rank imports this module, so it
imports neither JAX nor the JAX package.

A case is a dict: ``name``; ``arch`` (``llama3.2-1b`` reduced to 4
layers, d_model 64, 4/2 heads, as ``tests/test_torch_train.py``, or
``mamba2-2.7b`` reduced to 2 layers); ``tied``; ``V``; ``pcfg`` (a
``PipelineConfig``); ``rows`` and ``seq`` of the batches; ``steps`` (0:
one loss and gradients; else that many AdamW steps); ``weights`` (None:
the seed-0 weights, drawn by ``init_stage_params`` on a rank and
``init_stacked_params`` in process; else a stacked numpy tree).
"""
import dataclasses

import torch

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.optim import adamw as OPT
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


def _run(case: dict, S: int, rank=None, group=None) -> dict:
    """One case at S stages: on rank ``rank`` of ``group``, or in process
    (``rank`` None).  Returns the loss(es), the gradients or the trained
    parameters and moments, and the stash count(s)."""
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
    if not case["steps"]:
        loss, grads = step(params, data.batch(0))
        return dict(loss=loss, grads=grads, stash=step.stash_slots)
    state, losses = opt.init(params), []
    for i in range(case["steps"]):
        params, state, metrics = step(params, state, data.batch(i))
        losses.append(metrics["loss"])
    return dict(losses=losses, params=params, m=state["m"], v=state["v"],
                stash=step.stash_slots)


def in_process_cases(mesh, cases: dict, one_rank: list) -> dict:
    """``{S: [each case at S stages on the in-process executor]}``, in
    this 1-rank process, one torch thread; under ``"one rank"`` each case
    of ``one_rank`` at 1 stage on the rank executor over this 1-rank
    group (at V > 1 the ring wraps to the rank itself) and in process."""
    torch.set_num_threads(1)
    out = {S: [_run(c, S) for c in cs] for S, cs in cases.items()}
    out["one rank"] = {c["name"]: (_run(c, 1, 0, mesh.group), _run(c, 1))
                       for c in one_rank}
    return out


def run_cases(mesh, cases: list) -> dict:
    """Every case on this rank (one torch thread, as the in-process runs
    it is compared with)."""
    torch.set_num_threads(1)
    return {c["name"]: _run(c, mesh.world, mesh.rank, mesh.group)
            for c in cases}
