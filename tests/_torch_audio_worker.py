"""The rank side of ``tests/test_torch_audio.py``: every rank case of the
audio family on one world of 4 gloo ranks, and the in-process runs the
test holds them to.  Every spawned rank imports this module, so it
imports neither JAX nor the JAX package.

The world is spawned as stages 2 x tensor 2 (``"S2T2"``); data 2 x
stages 2 (``"D2S2"``) is made on the same ranks, and each of its
replicas' stage groups, handed over bare, is a 2-rank world of its own
(``"S2"``: both replicas run the same case, side by side).  The model is
whisper-base reduced to d 128 and 6 layers, 3 encoder and 3 decoder
(:func:`config`: 4/4 heads of 32, d_ff 256, vocab 1024); the batches are
``SyntheticLM``'s tokens beside seeded frames (:func:`batch`); the
weights are the numpy tree the test hands over (layers unstaged,
``[L, ...]``), stacked here for each plan and cut into this rank's share
by ``repro_torch.convert``.  Serving teacher-forces :func:`tokens` over
the cross keys and values the test computed once
(``model.prefill_audio_cache``), each rank laying its share into its
cache (``runtime.lay_cross_cache``).
"""
import dataclasses

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch import mesh as MESH
from repro_torch.launch import train
from repro_torch.pipeline import runtime as RT
from repro_torch.pipeline import stage as ST

L, D_MODEL = 6, 128
B, SEQ, SF = 12, 16, 12         # training: batch, decoder tokens, frames
SB, PROMPT, GEN = 4, 8, 4       # serving: batch, prompt, decode steps
#: the train CLI's flags (its stub frames: zeros [batch, 64, d])
TRAIN_CLI = ["--arch", "whisper-base", "--reduced", "--layers", str(L),
             "--d-model", str(D_MODEL), "--stages", "2", "--batch", "8",
             "--seq", "16", "--steps", "2", "--log-every", "100",
             "--device", "cpu"]


def config(S: int = 1, T: int = 1, V: int = 1):
    return dataclasses.replace(
        get_config("whisper-base").reduced(n_layers=L, d_model=D_MODEL),
        stages=S, tensor=T, virtual=V)


def builder_case(name: str, S: int = 2) -> tuple:
    """(V, M) of a builder at S stages: V 2 for the interleaved ones
    (M = S: memlean needs M % S == 0), M 2S for the zero-bubble ones, M S
    otherwise."""
    V = 2 if "interleaved" in name else 1
    return V, 2 * S if name.startswith("zb") else S


def stacked_np(weights: dict, plan) -> dict:
    return dict(weights, layers=ST._map_layers(
        lambda a: ST._stack_chunks(np.concatenate(
            [a] + [a[-1:]] * (plan.n_layers_padded - a.shape[0])), plan),
        weights["layers"]))


def frames(n: int = B, seed: int = 5) -> np.ndarray:
    """Seeded stub-frontend frames [n, SF, d]."""
    return np.random.default_rng(seed).standard_normal(
        (n, SF, D_MODEL)).astype(np.float32)


def batch(cfg) -> dict:
    b = SyntheticLM(cfg.vocab, SEQ, B, device="cpu").batch(0)
    b["frames"] = torch.from_numpy(frames())
    return b


def tokens(cfg) -> np.ndarray:
    """The serve prompt and the forced decode tokens, [SB, PROMPT + GEN]."""
    return np.random.default_rng(3).integers(0, cfg.vocab,
                                             (SB, PROMPT + GEN))


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
    V, M = builder_case(sched, S)
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


def serve_case(weights: dict, cross: dict, *, S: int = 2, T: int = 1,
               V: int = 1, M: int = 2, mesh=None, stage: int = 0,
               data: int = 1, data_rank: int = 0) -> dict:
    """Prefill of the prompt (``V`` chunks a stage, then the handoff to
    V 1) and ``GEN`` teacher-forced decode steps over the cross keys and
    values ``cross`` ({xk, xv} [L, SB, SF, H, D], numpy): every step's
    logits, the cache's leaf shapes and its final offsets."""
    cfg = config(S, T, V)
    plan_p, plan = ST.plan_stages(cfg), ST.plan_stages(cfg, virtual=1)
    steps = [RT.make_serve_step(cfg, p, RT.PipelineConfig(n_microbatches=M),
                                q_len=q, group=mesh)
             for p, q in ((plan_p, PROMPT), (plan, 1))]
    params = _share(weights, cfg, plan_p, mesh, stage)
    kw = dict(enc_len=SF, device="cpu")
    if mesh is None:
        cache = RT.init_pipeline_cache(cfg, plan_p, SB, PROMPT + GEN, **kw)
        RT.lay_cross_cache(cfg, plan_p, cache, convert.from_jax(
            cross, device="cpu"))
    else:
        cache = RT.init_stage_cache(cfg, plan_p, stage, SB, PROMPT + GEN,
                                    data=data, **kw)
        RT.lay_cross_cache(cfg, plan_p, cache, convert.from_jax(
            cross, device="cpu"), stage=stage,
            tensor_rank=getattr(mesh, "tensor_rank", 0), data=data,
            data_rank=data_rank)
    tok = torch.from_numpy(tokens(cfg))
    out = dict(logits=[], shapes={
        "/".join(p): tuple(ST._leaf_at(cache, p).shape)
        for p in ST.leaf_paths(cache)})
    feeds = [tok[:, :PROMPT]] + [tok[:, PROMPT + k:PROMPT + k + 1]
                                 for k in range(GEN)]
    for k, feed in enumerate(feeds):
        if k == 1 and V > 1:        # the handoff
            if mesh is None:
                for tree in (params["layers"], cache):
                    ST.restack_tree_(tree, plan_p, plan, cfg.n_layers)
            else:
                for tree in (params["layers"], cache):
                    ST.restack_share_(tree, plan_p, plan, cfg.n_layers,
                                      stage, steps[0].transport)
        lg, cache = steps[min(k, 1)](params, cache, dict(tokens=feed))
        out["logits"].append(lg)
    n = cache["kv"]["len"]
    out["len"] = n.reshape(-1, n.shape[-1]).amax(0).clone()
    return out


def _cli(out: dict) -> dict:
    return dict(losses=out["losses"])


def run_cases(mesh, weights: dict, cross: dict) -> dict:
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
    out["tensor serve"] = serve_case(weights, cross, T=2, mesh=mesh,
                                     stage=mesh.stage)
    # each replica's stage group alone: 2 ranks, no data axis
    for sched, runtime in (("1f1b", "ticks"), ("zb-h1", "stream")):
        out[f"S2 {sched} {runtime}"] = train_case(
            weights, sched, runtime, mesh=d2.group, stage=d2.stage)
    out["S2 serve V2"] = serve_case(weights, cross, V=2, mesh=d2.group,
                                    stage=d2.stage)
    out["data2 1f1b"] = train_case(weights, mesh=d2, stage=d2.stage)
    out["data2 serve"] = serve_case(weights, cross, M=1, mesh=d2,
                                    stage=d2.stage, data=2,
                                    data_rank=d2.data_rank)
    out["train cli data2"] = _cli(train.main(
        TRAIN_CLI + ["--data", "2", "--microbatches", "2"], mesh=d2))
    return out
