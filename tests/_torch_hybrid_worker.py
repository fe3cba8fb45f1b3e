"""The rank side of ``tests/test_torch_hybrid.py``: every rank case of
the hybrid family on one world of 4 gloo ranks.  Every spawned rank
imports this module, so it imports neither JAX nor the JAX package.

The world is spawned as stages 2 x tensor 2 (``"S2T2"``); data 2 x
stages 2 (``"D2S2"``) is made on the same ranks, and each of its
replicas' stage groups, handed over bare, is a 2-rank world of its own
(``"S2"``: both replicas run the same case, side by side).  The model is
hymba-1.5b reduced to 3 layers (:func:`config`: 4/4 heads of 64, window
32 with layer 0 global, the SSM's 16 heads of 32, d_state 16, chunk 16);
the batches are ``SyntheticLM``'s; the weights are the numpy tree the
test hands over (layers unstaged, ``[L, ...]``), stacked here for each
plan and cut into this rank's share by ``repro_torch.convert``.  The
in-process runs the cases are held to are the test's own
(:func:`train_case`, :func:`serve_case` with ``mesh=None``).
"""
import dataclasses

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch import mesh as MESH
from repro_torch.pipeline import runtime as RT
from repro_torch.pipeline import stage as ST

L, B, SEQ = 3, 4, 48            # SEQ: 3 SSD chunks, past the window
PROMPT, GEN = 32, 16            # decode feeds positions 32-47, past it too


def config(S: int = 1, T: int = 1, V: int = 1):
    return dataclasses.replace(get_config("hymba-1.5b").reduced(n_layers=L),
                               stages=S, tensor=T, virtual=V)


def builder_case(name: str) -> tuple:
    """(V, M) of a builder: V 2 for the interleaved ones, M 4 for the
    zero-bubble ones, M 2 otherwise."""
    V = 2 if "interleaved" in name else 1
    return V, 4 if name.startswith("zb") else 2


def stacked_np(weights: dict, plan) -> dict:
    return dict(weights, layers=ST._map_layers(
        lambda a: ST._stack_chunks(np.concatenate(
            [a] + [a[-1:]] * (plan.n_layers_padded - a.shape[0])), plan),
        weights["layers"]))


def batch(cfg, k: int = 0) -> dict:
    return SyntheticLM(cfg.vocab, SEQ, B, device="cpu").batch(k)


def prompt(cfg) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (B, PROMPT)))


def _share(weights, cfg, plan, mesh, stage: int):
    tree = stacked_np(weights, plan)
    if mesh is None:
        return convert.from_jax(tree, device="cpu")
    t = getattr(mesh, "tensor_rank", 0)
    return convert.to_rank_share(tree, cfg, plan, stage, t, device="cpu")


def train_case(weights: dict, sched: str = "1f1b", runtime: str = "ticks",
               *, S: int = 2, T: int = 1, remat: str = "stage",
               mesh=None, stage: int = 0) -> dict:
    """One step's loss and gradients: in process (``mesh`` None), or
    this rank's share on ``mesh`` (a ``StageMesh`` or a bare stage
    group whose rank ``stage`` is)."""
    V, M = builder_case(sched)
    cfg = config(S, T, V)
    plan = ST.plan_stages(cfg)
    step = RT.make_train_step(cfg, plan, RT.PipelineConfig(
        n_microbatches=M, schedule=sched, runtime=runtime, remat=remat),
        group=mesh)
    loss, grads = step(_share(weights, cfg, plan, mesh, stage), batch(cfg))
    out = dict(loss=loss, grads=grads)
    if mesh is not None:
        out["stats"] = {k: list(v[:2])
                        for k, v in step.transport.stats.items()}
    return out


def serve_case(weights: dict, *, S: int = 2, T: int = 1, V: int = 1,
               M: int = 2, mesh=None, stage: int = 0, data: int = 1
               ) -> dict:
    """Prefill (``V`` chunks a stage, then the handoff to V 1) and
    greedy decode (``GEN`` steps) of :func:`prompt`: every step's logits,
    the tokens fed, the cache's leaf shapes and its final offsets."""
    cfg = config(S, T, V)
    plan_p, plan = ST.plan_stages(cfg), ST.plan_stages(cfg, virtual=1)
    steps = [RT.make_serve_step(cfg, p, RT.PipelineConfig(n_microbatches=M),
                                q_len=q, group=mesh)
             for p, q in ((plan_p, PROMPT), (plan, 1))]
    params = _share(weights, cfg, plan_p, mesh, stage)
    if mesh is None:
        cache = RT.init_pipeline_cache(cfg, plan_p, B, PROMPT + GEN,
                                       device="cpu")
    else:
        cache = RT.init_stage_cache(cfg, plan_p, stage, B, PROMPT + GEN,
                                    data=data, device="cpu")
    tok = prompt(cfg)
    out = dict(logits=[], tokens=[tok], shapes={
        "/".join(p): tuple(ST._leaf_at(cache, p).shape)
        for p in ST.leaf_paths(cache)})
    for k in range(GEN + 1):
        if k == 1 and V > 1:        # the handoff
            if mesh is None:
                for tree in (params["layers"], cache):
                    ST.restack_tree_(tree, plan_p, plan, cfg.n_layers)
            else:
                for tree in (params["layers"], cache):
                    ST.restack_share_(tree, plan_p, plan, cfg.n_layers,
                                      stage, steps[0].transport)
        lg, cache = steps[min(k, 1)](params, cache, dict(tokens=tok))
        out["logits"].append(lg)
        tok = torch.argmax(lg[:, 0, :cfg.vocab], dim=-1)[:, None]
        out["tokens"].append(tok)
    n = cache["kv"]["len"]
    out["len"] = n.reshape(-1, n.shape[-1])[0].clone()
    return out


def run_cases(mesh, weights: dict) -> dict:
    """Every rank case (one torch thread throughout).  Every rank makes
    every grid, in one order."""
    torch.set_num_threads(1)
    d2 = MESH.make_grid(2, mesh.backend, mesh.device)
    out = dict(grid=dict(rank=mesh.rank, stage=mesh.stage,
                         tensor_rank=mesh.tensor_rank, d2_stage=d2.stage,
                         d2_data_rank=d2.data_rank))
    for runtime in ("ticks", "stream"):
        out[f"tensor 1f1b {runtime}"] = train_case(
            weights, "1f1b", runtime, T=2, mesh=mesh, stage=mesh.stage)
    out["tensor serve"] = serve_case(weights, T=2, mesh=mesh,
                                     stage=mesh.stage)
    # each replica's stage group alone: 2 ranks, no data axis
    for sched, runtime in (("1f1b", "ticks"), ("zb-h1", "stream")):
        out[f"S2 {sched} {runtime}"] = train_case(
            weights, sched, runtime, mesh=d2.group, stage=d2.stage)
    out["S2 serve V2"] = serve_case(weights, V=2, mesh=d2.group,
                                    stage=d2.stage)
    out["data2 1f1b"] = train_case(weights, mesh=d2, stage=d2.stage)
    out["data2 serve"] = serve_case(weights, M=1, mesh=d2, stage=d2.stage,
                                    data=2)
    return out
