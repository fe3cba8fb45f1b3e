"""The rank side of ``tests/test_torch_data.py``: every case of the data
axis on one world of 4 gloo ranks, data 2 x stages 2.  Every spawned rank
imports this module, so it imports neither JAX nor the JAX package.

The model is ``llama3.2-1b`` reduced to 4 layers, d_model 128
(:func:`config`); the batches are ``SyntheticLM``'s (8 rows, seq 32);
the weights are the numpy tree the test hands over (layers unstaged,
``[L, ...]``), stacked here for each plan and carried over by
``repro_torch.convert``.  Each rank returns its own results; the
in-process (data 1) references of the serving, engine and CLI cases are
computed after the rank cases, one a rank, so that they run side by
side.
"""
import dataclasses

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import schedplan as SP
from repro_torch.core import serve_sched as SS
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch import mesh as MESH
from repro_torch.launch import serve, train
from repro_torch.optim import adamw as OPT
from repro_torch.pipeline import runtime as RT
from repro_torch.pipeline import stage as ST

B, SEQ, LR = 8, 32, 1e-2
#: the reference's builder list (``tests/harness_pipe.py:336-338``)
BUILDERS = ("gpipe", "1f1b", "dapple", "zb-h1", "zb-h2", "zb-auto",
            "1f1b-interleaved", "1f1b-interleaved-memlean")
PROMPT, GEN = 8, 4
#: the serve CLI's and the train CLI's flags on the ranks and in process
SERVE_CLI = ["--arch", "llama3.2-1b", "--reduced", "--stages", "2",
             "--batch", "8", "--prompt-len", "8", "--gen", "4", "--device",
             "cpu"]
TRAIN_CLI = ["--arch", "llama3.2-1b", "--reduced", "--layers", "4",
             "--d-model", "64", "--stages", "2", "--batch", "8", "--seq",
             "16", "--steps", "3", "--device", "cpu"]
PLAN_CLI = ["--arch", "llama3.2-1b", "--reduced", "--layers", "4",
            "--d-model", "64", "--batch", "8", "--seq", "32", "--steps",
            "2", "--device", "cpu"]
#: the engine's requests: (rid, prompt length, max_new, arrival)
ENGINE = [(0, 5, 4, 0), (1, 9, 3, 0), (2, 3, 5, 1), (3, 7, 2, 1),
          (4, 11, 4, 2), (5, 4, 3, 4)]
N_SLOTS, CHUNK, MAX_LEN = 4, 4, 32


def config(S: int, V: int = 1, tied: bool = True):
    cfg = get_config("llama3.2-1b").reduced(n_layers=4, d_model=128)
    return dataclasses.replace(cfg, stages=S, tensor=1, virtual=V,
                               tie_embeddings=tied)


def builder_case(name: str) -> tuple:
    """(V, M a replica) of a builder: V 2 for the interleaved two, M 4
    for the zero-bubble ones, M 2 otherwise (4 rows a replica)."""
    V = 2 if "interleaved" in name else 1
    return V, 4 if name.startswith("zb") else 2


def stacked(weights: dict, plan) -> dict:
    """The unstaged numpy weights stacked for ``plan``, as tensors."""
    return convert.from_jax(dict(weights, layers=ST._map_layers(
        lambda a: ST._stack_chunks(a, plan), weights["layers"])),
        device="cpu")


def batch(cfg, k: int = 0) -> dict:
    return SyntheticLM(cfg.vocab, SEQ, B, device="cpu").batch(k)


def _grads(mesh, weights, name, grad_sync, *, groups=1, tied=True):
    """Loss, gradient share and grad_sync counts of one step."""
    V, M = builder_case(name)
    cfg = config(2, V, tied)
    plan = ST.plan_stages(cfg)
    pcfg = RT.PipelineConfig(n_microbatches=M, schedule=name,
                             runtime="stream", grad_sync=grad_sync,
                             ar_groups=groups)
    step = RT.make_train_step(cfg, plan, pcfg, group=mesh)
    params = ST.stage_share(stacked(weights[tied], plan), plan, mesh.stage)
    loss, grads = step(params, batch(cfg))
    return dict(loss=loss, grads=grads,
                grad_sync=step.transport.stats["grad_sync"][:2],
                ar_slots=sum(i.op == SP.INSTR_AR for i in
                             step.instructions.streams[mesh.stage]))


def _two_bw(mesh, weights, steps: int = 3) -> dict:
    """``steps`` AdamW steps under 2bw (1f1b, stream): this rank's
    parameters and ``pending`` after each, and the losses."""
    cfg = config(2)
    plan = ST.plan_stages(cfg)
    opt = OPT.AdamW(lr=LR)
    step = RT.make_train_step(cfg, plan, RT.PipelineConfig(
        n_microbatches=2, schedule="1f1b", runtime="stream",
        grad_sync="2bw"), optimizer=opt, group=mesh)
    params = ST.stage_share(stacked(weights[True], plan), plan, mesh.stage)
    state = RT.init_2bw_state(opt.init(params), params)
    out = dict(losses=[], params=[], pending=[])
    for k in range(steps):
        params, state, metrics = step(params, state, batch(cfg, k))
        out["losses"].append(metrics["loss"])
        out["params"].append(ST._map_layers(torch.clone, params))
        out["pending"].append(ST._map_layers(torch.clone, state["pending"]))
    return out


def _serve(mesh, weights, data: int) -> dict:
    """Prefill and greedy decode (``GEN`` steps), llama 4 layers, V 1,
    M 2 a replica (data 1: M 4, the same micro-batch rows): every step's
    logits and the tokens."""
    cfg = config(2)
    plan = ST.plan_stages(cfg)
    M = 2 if data > 1 else 4
    steps = [RT.make_serve_step(cfg, plan, RT.PipelineConfig(
        n_microbatches=M), q_len=q, group=mesh if data > 1 else None)
        for q in (PROMPT, 1)]
    params = stacked(weights[True], plan)
    if data > 1:
        params = ST.stage_share(params, plan, mesh.stage)
        cache = RT.init_stage_cache(cfg, plan, mesh.stage, B, PROMPT + GEN,
                                    data=data, device="cpu")
    else:
        cache = RT.init_pipeline_cache(cfg, plan, B, PROMPT + GEN,
                                       device="cpu")
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (B, PROMPT)))
    out = dict(logits=[], tokens=[tok])
    for k in range(GEN + 1):
        lg, cache = steps[min(k, 1)](params, cache, dict(tokens=tok))
        out["logits"].append(lg)
        tok = torch.argmax(lg[:, 0, :cfg.vocab], dim=-1)[:, None]
        out["tokens"].append(tok)
    if data > 1:
        out["transport"] = {k: list(v)
                            for k, v in steps[1].transport.stats.items()}
    return out


def _engine(mesh, weights, data: int) -> dict:
    """A ``ContinuousEngine`` run over the pipelined step: the retired
    requests (id, tokens) and the step count."""
    cfg = config(2)
    plan = ST.plan_stages(cfg)
    step = RT.make_serve_step(cfg, plan, RT.PipelineConfig(
        n_microbatches=1 if data > 1 else 2), q_len=CHUNK,
        group=mesh if data > 1 else None)
    params = stacked(weights[True], plan)
    if data > 1:
        params = ST.stage_share(params, plan, mesh.stage)
        cache = RT.init_stage_cache(cfg, plan, mesh.stage, N_SLOTS, MAX_LEN,
                                    data=data, device="cpu")
    else:
        cache = RT.init_pipeline_cache(cfg, plan, N_SLOTS, MAX_LEN,
                                       device="cpu")
    rng = np.random.default_rng(7)
    eng = SS.ContinuousEngine(cfg, step, params, cache, N_SLOTS, CHUNK)
    done = eng.run([SS.Request(rid, list(rng.integers(0, cfg.vocab, n)),
                               new, arrival)
                    for rid, n, new, arrival in ENGINE])
    return dict(retired=sorted((r.rid, list(r.generated)) for r in done),
                steps=eng.steps_run)


def _cli(out: dict) -> dict:
    return {k: out[k] for k in ("losses", "plan", "stages") if k in out}


def run_cases(mesh, weights: dict) -> dict:
    """Every rank case, then this rank's in-process reference (one torch
    thread throughout)."""
    torch.set_num_threads(1)
    out = {}
    for name in BUILDERS:
        for gs in ("end", "overlap"):
            out[f"{name} {gs}"] = _grads(mesh, weights, name, gs)
    for name in ("1f1b", "zb-h1"):
        out[f"{name} overlap G2"] = _grads(mesh, weights, name, "overlap",
                                           groups=2)
    for gs in ("end", "overlap"):
        out[f"untied 1f1b {gs}"] = _grads(mesh, weights, "1f1b", gs,
                                          tied=False)
    out["2bw"] = _two_bw(mesh, weights)
    out["serve"] = _serve(mesh, weights, 2)
    out["engine"] = _engine(mesh, weights, 2)
    out["train cli"] = _cli(train.main(
        TRAIN_CLI + ["--microbatches", "2", "--data", "2", "--runtime",
                     "stream", "--grad-sync", "overlap", "--ar-groups", "2"],
        mesh=mesh))
    s = serve.main(SERVE_CLI + ["--microbatches", "2", "--data", "2"],
                   mesh=mesh, keep_logits=True)
    out["serve cli"] = dict(tokens=s["tokens"], transport=s["transport"],
                            logits=s["step_logits"])
    out["grid"] = dict(rank=mesh.rank, stage=mesh.stage,
                       data_rank=mesh.data_rank, stages=mesh.stages,
                       stage_ranks=mesh.stage_ranks,
                       data_ranks=mesh.data_ranks)
    # the planner's data 4 plan on a data 4 x stages 1 grid of this world
    grid4 = MESH.make_grid(4, mesh.backend, mesh.device)
    out["plan cli"] = _cli(train.main(PLAN_CLI + ["--auto-plan3d", "--pool",
                                                  "4"], mesh=grid4))
    # the in-process references, one a rank
    if mesh.rank == 0:
        out["ref serve"] = _serve(mesh, weights, 1)
    elif mesh.rank == 1:
        out["ref engine"] = _engine(mesh, weights, 1)
    elif mesh.rank == 2:
        out["ref train cli"] = _cli(train.main(TRAIN_CLI + [
            "--microbatches", "4"]))
        ref = serve.main(SERVE_CLI + ["--microbatches", "4"],
                         keep_logits=True)
        out["ref serve cli"] = dict(tokens=ref["tokens"],
                                    logits=ref["step_logits"])
    else:
        out["ref plan cli"] = _cli(train.main(PLAN_CLI + [
            "--stages", "1", "--microbatches", "4", "--schedule", "1f1b"]))
    return out
