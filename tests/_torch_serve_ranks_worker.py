"""The rank side of ``tests/test_torch_serve_ranks.py``, and the
in-process runs it is held to.  Every spawned rank imports this module,
so it imports neither JAX nor the JAX package.

A case is a dict: ``name``; ``arch`` (``tests/_torch_ranks_worker.config``:
llama3.2-1b at 4 layers, d_model 64, or mamba2-2.7b at 2 layers); ``S``
ranks; ``V`` of the prefill plan (decode runs V = 1 after the handoff);
``M`` micro-batches; ``B`` rows; ``forced`` (None: greedy decode; else
numpy tokens [B, GEN] fed instead); ``weights`` (None: the seed-0
weights, drawn by ``init_stage_params`` on a rank and
``init_stacked_params`` in process; else a stacked numpy tree);
``engine`` (None; else ``(n_slots, chunk, max_len, requests)``, each
request ``(rid, prompt, max_new, arrival)``: a ``ContinuousEngine`` run
instead of prefill and decode).
"""
import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.core import serve_sched as SS
from repro_torch.pipeline import comm as C
from repro_torch.pipeline import runtime as RT
from repro_torch.pipeline import stage as ST

from _torch_ranks_worker import config

PROMPT, GEN = 8, 4


def prompt(B: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(3).integers(0, vocab, (B, PROMPT))


def _clone(tree: dict) -> dict:
    return ST._map_layers(torch.clone, tree)


def _stats(step) -> dict:
    return {k: list(v) for k, v in step.transport.stats.items()}


def _engine(case: dict, cfg, plan, params, rank, group) -> dict:
    n_slots, chunk, max_len, reqs = case["engine"]
    step = RT.make_serve_step(cfg, plan, RT.PipelineConfig(
        n_microbatches=case["M"]), q_len=chunk, group=group)
    cache = (RT.init_pipeline_cache(cfg, plan, n_slots, max_len, device="cpu")
             if rank is None else
             RT.init_stage_cache(cfg, plan, rank, n_slots, max_len,
                                 device="cpu"))
    eng = SS.ContinuousEngine(cfg, step, params, cache, n_slots, chunk)
    done = eng.run([SS.Request(rid, list(p), n, arrival)
                    for rid, p, n, arrival in reqs])
    return dict(
        plans=[(sp.tokens, sp.n_valid, [tuple(vars(w).values())
                                        for w in sp.work])
               for sp in eng.step_log],
        retired=[(r.rid, r.generated, r.t_admit, r.t_first, r.t_done)
                 for r in done],
        cache=eng.cache)


def run(case: dict, rank=None, group=None) -> dict:
    """One case on rank ``rank`` of ``group``, or in process (``rank``
    None): every step's logits, the tokens fed, the cache at the end
    and, at V > 1, the layers and the cache just after the handoff; on a
    rank each step's transport counts and the handoff's."""
    cfg = config(case["arch"], case["S"], case["V"])
    plan_p, plan = ST.plan_stages(cfg), ST.plan_stages(cfg, virtual=1)
    if case["weights"] is not None:
        params = convert.from_jax(case["weights"], device="cpu")
        if rank is not None:
            params = ST.stage_share(params, plan_p, rank)
    elif rank is None:
        params = ST.init_stacked_params(cfg, 0, plan_p, device="cpu")
    else:
        params = ST.init_stage_params(cfg, 0, plan_p, rank, device="cpu")
    if case["engine"] is not None:
        return _engine(case, cfg, plan, params, rank, group)
    B = case["B"]
    prefill = RT.make_serve_step(cfg, plan_p, RT.PipelineConfig(
        n_microbatches=case["M"]), q_len=PROMPT, group=group)
    decode = RT.make_serve_step(cfg, plan, RT.PipelineConfig(
        n_microbatches=case["M"]), q_len=1, group=group)
    cache = (RT.init_pipeline_cache(cfg, plan_p, B, PROMPT + GEN,
                                    device="cpu") if rank is None else
             RT.init_stage_cache(cfg, plan_p, rank, B, PROMPT + GEN,
                                 device="cpu"))
    out = dict(logits=[], fed=[], transport=[])
    lg, cache = prefill(params, cache,
                        dict(tokens=torch.from_numpy(prompt(B, cfg.vocab))))
    out["logits"].append(lg)
    if rank is not None:
        out["transport"].append(_stats(prefill))
    if case["V"] > 1:
        if rank is None:
            ST.restack_tree_(params["layers"], plan_p, plan, cfg.n_layers)
            ST.restack_tree_(cache, plan_p, plan, cfg.n_layers)
        else:
            tp = C.Transport(group)
            ST.restack_share_(params["layers"], plan_p, plan, cfg.n_layers,
                              rank, tp)
            ST.restack_share_(cache, plan_p, plan, cfg.n_layers, rank, tp)
            out["handoff_transport"] = {k: list(v)
                                        for k, v in tp.stats.items()}
        out["handoff"] = dict(layers=params["layers"], cache=_clone(cache))
    for t in range(GEN):
        tok = (torch.argmax(lg[:, 0, :cfg.vocab], dim=-1)[:, None]
               if case["forced"] is None
               else torch.from_numpy(case["forced"][:, t:t + 1]))
        out["fed"].append(tok)
        lg, cache = decode(params, cache, dict(tokens=tok))
        out["logits"].append(lg)
        if rank is not None:
            out["transport"].append(_stats(decode))
    out["cache"] = cache
    if cfg.family == "ssm":
        # continuous batching stays refused for the recurrent family
        try:
            decode(params, cache, dict(tokens=tok, n_valid=torch.ones(
                B, dtype=torch.int32)))
        except ValueError as e:
            out["n_valid_refusal"] = str(e)
    return out


def in_process_cases(mesh, cases: list) -> dict:
    """Every case on the in-process executor, in this 1-rank process, one
    torch thread."""
    torch.set_num_threads(1)
    return {c["name"]: run(c) for c in cases}


def run_cases(mesh, cases: list) -> dict:
    """Every case on its ranks, one torch thread (as the in-process runs
    it is compared with): the cases of ``mesh.world`` ranks on the whole
    group, those of fewer on a subgroup of the first ranks (the others
    wait), each case's ranks the first ``case["S"]``."""
    torch.set_num_threads(1)
    out = {}
    for S in sorted({c["S"] for c in cases}):
        group = (mesh.group if S == mesh.world else
                 dist.new_group(list(range(S)), timeout=C.GROUP_TIMEOUT))
        if mesh.rank < S:
            out.update({c["name"]: run(c, mesh.rank, group)
                        for c in cases if c["S"] == S})
    return out
