"""The rank side of ``tests/test_torch_tensor.py``: every case of the
tensor axis on one world of 4 gloo ranks.  Every spawned rank imports
this module, so it imports neither JAX nor the JAX package.

The world is spawned as stages 2 x tensor 2 (:func:`grid`'s ``"S2T2"``);
the other grids are made on the same ranks (``"S1T4"``: stages 1 x tensor
4; ``"D2T2"``: data 2 x stages 1 x tensor 2).  The models are reduced
(:func:`config`); the batches are ``SyntheticLM``'s (``B`` rows, seq
``SEQ``); the weights are the numpy trees the test hands over (layers
unstaged, ``[L, ...]``, the embedding of ``padded_vocab(1)`` rows),
stacked here for each plan and cut into this rank's share by
``repro_torch.convert.to_rank_share``.  Each rank returns its own
results; the in-process (tensor 1) references of the engine and CLI
cases are computed after the rank cases, one a rank, side by side.
"""
import dataclasses

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import serve_sched as SS
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch import mesh as MESH
from repro_torch.launch import serve, train
from repro_torch.optim import adamw as OPT
from repro_torch.pipeline import runtime as RT
from repro_torch.pipeline import stage as ST

B, SEQ, LR, STEPS = 4, 32, 1e-2, 3
ADAM_SEQ = 16       # the optimizer case's (tests/test_torch_train.py's)
#: the reference's builder list (``tests/harness_pipe.py:336-338``)
BUILDERS = ("gpipe", "1f1b", "dapple", "zb-h1", "zb-h2", "zb-auto",
            "1f1b-interleaved", "1f1b-interleaved-memlean")
#: (arch, grid, stages, tensor) of the model cases
MODELS = {"llama": ("llama3.2-1b", "S2T2", 2, 2),
          "llama kv2": ("llama3.2-1b", "S2T2", 2, 2),
          "gemma3": ("gemma3-1b", "S1T4", 1, 4),
          "qwen3": ("qwen3-1.7b", "S1T4", 1, 4),
          "mamba2": ("mamba2-2.7b", "S2T2", 2, 2)}
PROMPT, GEN = 8, 4
SERVE_CLI = ["--arch", "llama3.2-1b", "--reduced", "--stages", "2",
             "--microbatches", "2", "--batch", "4", "--prompt-len", "8",
             "--gen", "4", "--device", "cpu"]
TRAIN_CLI = ["--arch", "llama3.2-1b", "--reduced", "--layers", "4",
             "--d-model", "64", "--stages", "2", "--microbatches", "2",
             "--batch", "4", "--seq", "16", "--steps", "3", "--device",
             "cpu"]
MAMBA_CLI = ["--arch", "mamba2-2.7b", "--reduced", "--layers", "2",
             "--d-model", "64", "--stages", "2", "--microbatches", "2",
             "--batch", "4", "--seq", "32", "--steps", "2", "--device",
             "cpu"]
PLAN_CLI = ["--arch", "llama3.2-1b", "--reduced", "--layers", "4",
            "--d-model", "64", "--batch", "8", "--seq", "32", "--steps",
            "2", "--device", "cpu"]
#: the engine's requests: (rid, prompt length, max_new, arrival)
ENGINE = [(0, 5, 4, 0), (1, 9, 3, 0), (2, 3, 5, 1), (3, 7, 2, 1),
          (4, 11, 4, 2)]
N_SLOTS, CHUNK, MAX_LEN = 4, 4, 32


def config(name: str, S: int = 1, T: int = 1, V: int = 1):
    """The reduced model of case ``name`` (4 layers, d_model 64): llama
    tied (``"llama kv2"``: two kv heads, the optimizer case's model, as
    tests/test_torch_train.py's); gemma3 with a window of 16 and one
    global layer in four; qwen3 untied with a vocab of 600
    (``padded_vocab`` 640 at tensor 1, 1024 at tensor 4); mamba2 tied,
    its SSM blocks replicated over tensor."""
    arch = MODELS[name][0]
    cfg = get_config(arch).reduced(n_layers=4, d_model=64, seq=SEQ)
    if name == "llama kv2":
        cfg = dataclasses.replace(cfg, n_kv_heads=2)
    if name == "qwen3":
        cfg = dataclasses.replace(cfg, vocab=600, tie_embeddings=False)
    return dataclasses.replace(cfg, stages=S, tensor=T, virtual=V)


def builder_case(name: str) -> tuple:
    """(V, M) of a builder: V 2 for the interleaved two, M 4 for the
    zero-bubble ones, M 2 otherwise."""
    V = 2 if "interleaved" in name else 1
    return V, 4 if name.startswith("zb") else 2


def stacked_np(weights: dict, plan) -> dict:
    return dict(weights, layers=ST._map_layers(
        lambda a: ST._stack_chunks(a, plan), weights["layers"]))


def batch(cfg, k: int = 0, seq: int = SEQ) -> dict:
    return SyntheticLM(cfg.vocab, seq, B, device="cpu").batch(k)


def _train(mesh, weights, name, sched="1f1b", runtime="ticks", V=None,
           M=None) -> dict:
    """One step's loss and this rank's gradient share."""
    _, _, S, T = MODELS[name]
    v, m = builder_case(sched)
    cfg = config(name, S, T, V or v)
    plan = ST.plan_stages(cfg)
    step = RT.make_train_step(cfg, plan, RT.PipelineConfig(
        n_microbatches=M or m, schedule=sched, runtime=runtime),
        group=mesh)
    params = convert.to_rank_share(stacked_np(weights[name], plan), cfg,
                                   plan, mesh.stage, mesh.tensor_rank,
                                   device="cpu")
    loss, grads = step(params, batch(cfg))
    return dict(loss=loss, grads=grads,
                tensor=step.transport.stats["tensor"][:2])


def _adamw(mesh, weights) -> dict:
    """``STEPS`` AdamW steps of the ``"llama kv2"`` case (1f1b, seq
    ``ADAM_SEQ``): the losses and this rank's final parameters and
    moments."""
    cfg = config("llama kv2", 2, 2)
    plan = ST.plan_stages(cfg)
    opt = OPT.AdamW(lr=OPT.warmup_cosine(LR, 20, STEPS), weight_decay=0.01)
    step = RT.make_train_step(cfg, plan, RT.PipelineConfig(
        n_microbatches=2, schedule="1f1b"), optimizer=opt, group=mesh)
    params = convert.to_rank_share(stacked_np(weights["llama kv2"], plan),
                                   cfg, plan, mesh.stage, mesh.tensor_rank,
                                   device="cpu")
    state = opt.init(params)
    losses = []
    for k in range(STEPS):
        params, state, metrics = step(params, state,
                                      batch(cfg, k, ADAM_SEQ))
        losses.append(float(metrics["loss"]))
    return dict(losses=losses, params=params, m=state["m"], v=state["v"])


def _data2(mesh, weights) -> dict:
    """Data 2 x stages 1 x tensor 2 under ``grad_sync='overlap'`` (the
    stream runtime), llama at one stage: loss and gradient share."""
    cfg = config("llama", 1, 2)
    plan = ST.plan_stages(cfg)
    step = RT.make_train_step(cfg, plan, RT.PipelineConfig(
        n_microbatches=1, schedule="1f1b", runtime="stream",
        grad_sync="overlap"), group=mesh)
    params = convert.to_rank_share(stacked_np(weights["llama"], plan), cfg,
                                   plan, 0, mesh.tensor_rank, device="cpu")
    loss, grads = step(params, batch(cfg))
    return dict(loss=loss, grads=grads,
                grad_sync=step.transport.stats["grad_sync"][:2])


def _serve(mesh, weights, name: str, V: int = 1) -> dict:
    """Prefill (V chunks a stage, then the handoff to V = 1) and greedy
    decode (``GEN`` steps), M 2: every step's logits, the tokens and
    this rank's cache's k shape."""
    _, _, S, T = MODELS[name]
    cfg = config(name, S, T, V)
    plan_p, plan = ST.plan_stages(cfg), ST.plan_stages(cfg, virtual=1)
    steps = [RT.make_serve_step(cfg, p, RT.PipelineConfig(n_microbatches=2),
                                q_len=q, group=mesh)
             for p, q in ((plan_p, PROMPT), (plan, 1))]
    params = convert.to_rank_share(stacked_np(weights[name], plan_p), cfg,
                                   plan_p, mesh.stage, mesh.tensor_rank,
                                   device="cpu")
    cache = RT.init_stage_cache(cfg, plan_p, mesh.stage, B, PROMPT + GEN,
                                device="cpu")
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (B, PROMPT)))
    out = dict(logits=[], tokens=[tok], k_shape=tuple(cache["kv"]["k"].shape))
    for k in range(GEN + 1):
        if k == 1 and V > 1:        # the handoff, each shard its own
            tp = steps[0].transport
            for tree in (params["layers"], cache):
                ST.restack_share_(tree, plan_p, plan, cfg.n_layers,
                                  mesh.stage, tp)
        lg, cache = steps[min(k, 1)](params, cache, dict(tokens=tok))
        out["logits"].append(lg)
        tok = torch.argmax(lg[:, 0, :cfg.vocab], dim=-1)[:, None]
        out["tokens"].append(tok)
    out["transport"] = {k: list(v)
                        for k, v in steps[1].transport.stats.items()}
    return out


def _engine(mesh, weights, ranks: bool) -> dict:
    """A ``ContinuousEngine`` run over the llama case's serve step (M 1):
    on the ranks at tensor 2, or in process at tensor 1."""
    cfg = config("llama", 2, 2 if ranks else 1)
    plan = ST.plan_stages(cfg)
    step = RT.make_serve_step(cfg, plan, RT.PipelineConfig(n_microbatches=1),
                              q_len=CHUNK, group=mesh if ranks else None)
    if ranks:
        params = convert.to_rank_share(stacked_np(weights["llama"], plan),
                                       cfg, plan, mesh.stage,
                                       mesh.tensor_rank, device="cpu")
        cache = RT.init_stage_cache(cfg, plan, mesh.stage, N_SLOTS, MAX_LEN,
                                    device="cpu")
    else:
        params = convert.from_jax(stacked_np(weights["llama"], plan),
                                  device="cpu")
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
    return {k: out[k] for k in ("losses", "plan", "stages", "tensor",
                                "schedule", "microbatches") if k in out}


def grid(mesh, name: str):
    """The spawned mesh (``"S2T2"``) or a new grid of the same world."""
    if name == "S2T2":
        return mesh
    data, tensor = {"S1T4": (1, 4), "D2T2": (2, 2)}[name]
    return MESH.make_grid(data, mesh.backend, mesh.device, tensor)


def run_cases(mesh, weights: dict) -> dict:
    """Every rank case, then this rank's in-process reference (one torch
    thread throughout).  Every rank makes every grid, in one order."""
    torch.set_num_threads(1)
    grids = {g: grid(mesh, g) for g in ("S2T2", "S1T4", "D2T2")}
    out = dict(grid={g: dict(rank=m.rank, stage=m.stage, data_rank=m.data_rank,
                             tensor_rank=m.tensor_rank,
                             stage_ranks=m.stage_ranks,
                             data_ranks=m.data_ranks,
                             tensor_ranks=m.tensor_ranks)
                     for g, m in grids.items()})
    llama = grids["S2T2"]
    for sched in BUILDERS:
        for runtime in ("ticks", "stream"):
            out[f"llama {sched} {runtime}"] = _train(llama, weights, "llama",
                                                     sched, runtime)
    for name in ("gemma3", "qwen3"):
        out[f"{name} 1f1b ticks"] = _train(grids["S1T4"], weights, name)
    out["qwen3 zb-h1 stream"] = _train(grids["S1T4"], weights, "qwen3",
                                       "zb-h1", "stream")
    for runtime in ("ticks", "stream"):
        out[f"mamba2 1f1b {runtime}"] = _train(llama, weights, "mamba2",
                                               runtime=runtime)
    out["data2"] = _data2(grids["D2T2"], weights)
    out["adamw"] = _adamw(llama, weights)
    for V in (1, 2):
        out[f"serve llama V{V}"] = _serve(llama, weights, "llama", V)
    out["serve gemma3"] = _serve(grids["S1T4"], weights, "gemma3")
    out["engine"] = _engine(llama, weights, True)
    out["train cli"] = _cli(train.main(TRAIN_CLI + ["--tensor", "2"],
                                       mesh=llama))
    s = serve.main(SERVE_CLI + ["--tensor", "2"], mesh=llama,
                   keep_logits=True)
    out["serve cli"] = dict(tokens=s["tokens"], logits=s["step_logits"],
                            transport=s["transport"])
    out["mamba cli"] = _cli(train.main(MAMBA_CLI + ["--tensor", "2"],
                                       mesh=llama))
    out["plan cli"] = _cli(train.main(PLAN_CLI + ["--stages", "4",
                                                  "--auto-plan"],
                                      mesh=grids["S1T4"]))
    # the in-process references, one a rank
    if mesh.rank == 0:
        out["ref engine"] = _engine(None, weights, False)
    elif mesh.rank == 1:
        out["ref train cli"] = _cli(train.main(TRAIN_CLI + ["--tensor",
                                                            "1"]))
        ref = serve.main(SERVE_CLI + ["--tensor", "1"], keep_logits=True)
        out["ref serve cli"] = dict(tokens=ref["tokens"],
                                    logits=ref["step_logits"])
    elif mesh.rank == 2:
        out["ref mamba cli"] = _cli(train.main(MAMBA_CLI + ["--tensor",
                                                            "1"]))
    else:
        got = out["plan cli"]
        out["ref plan cli"] = _cli(train.main(PLAN_CLI + [
            "--stages", str(got["stages"]), "--tensor", "1",
            "--microbatches", str(got["microbatches"]), "--schedule",
            got["schedule"]]))
    return out
