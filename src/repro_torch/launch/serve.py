"""Pipelined serving entry point: batched prefill + greedy decode, every
stage in one process on one card or, under ``torchrun``, one process per
stage.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch llama3.2-1b --tensor 1 --stages 8 --microbatches 2 \\
        --batch 8 --prompt-len 512 --gen 32

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch mamba2-2.7b --stages 16 --microbatches 2 \\
        --batch 8 --prompt-len 512 --gen 32

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch gemma3-1b --tensor 1 --stages 2 --microbatches 2 \\
        --batch 8 --prompt-len 1024 --gen 32

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen3-1.7b --tensor 1 --stages 4 --microbatches 2 \\
        --batch 8 --prompt-len 512 --gen 32

whisper-base (the audio family) is refused before any group is set up:
this CLI takes no encoder frames.  ``--device cpu`` runs the same path on the CPU with the kernels' plain
versions (add ``--reduced`` for a small model).  ``--tensor`` sets the
tensor degree (0 keeps the config's own: llama3.2-1b's is 2, gemma3-1b's
and qwen3-1.7b's 4); a degree above 1 runs only as ranks and raises in
one process, naming the world it needs, as in the training CLI.
gemma3-1b's local layers attend over a sliding window of 512 keys and its
every sixth layer globally, all through the same flash kernel.  For mamba2 the prompt
length must be a multiple of the SSD chunk (256; 16 reduced) or shorter
than it.

``--virtual V`` (V > 1) runs the *prefill* on the interleaved plan of V
chunks a stage (``--schedule`` picks its op order; ``--microbatches`` must
be at least ``--stages``), then re-folds the parameters and the
[S, V, Lc, ...] prefill cache to the contiguous [S, Lps, ...] layout
(the handoff, timed and printed), leaf by leaf so that no more than one
leaf is ever held twice.  Decode always runs the V = 1 plan under the
default ring schedule, whatever ``--schedule`` says:

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch llama3.2-1b --tensor 1 --stages 4 --virtual 2 \\
        --microbatches 4 --batch 8 --prompt-len 512 --gen 32

With ``WORLD_SIZE`` above 1 (``torchrun``) each process is one stage of
the plan (:mod:`repro_torch.launch.mesh`; ``--stages`` must equal the
world size), as in the training CLI: it draws only its share of the
weights (:func:`repro_torch.pipeline.stage.init_stage_params`) and its
own cache (:func:`repro_torch.pipeline.runtime.init_stage_cache`), runs
its row of the same ring table (``make_serve_step(..., group=...)``) and
takes the logits the last rank broadcasts; at V > 1 the handoff sends
each layer to the rank that holds it next
(:func:`repro_torch.pipeline.stage.restack_share_`).  ``--dist-backend``
is ``nccl`` (one card per rank; more ranks than cards raise) by default
on ``--device cuda`` and ``gloo`` on ``--device cpu``; ``--dist-backend
gloo`` runs every rank on one card, each message staged through pinned
host memory.  Rank 0 alone prints the generations, prefill and decode
tok/s (the slowest rank's times), the handoff's ms, the kernel launches
summed over ranks, each rank's peak memory and its transport by kind:

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \\
        -m repro_torch.launch.serve --arch llama3.2-1b --reduced \\
        --stages 2 --batch 4 --prompt-len 8 --gen 4 --device cpu

``--data D`` (D > 1, ranks only: data x stages processes) serves each
replica's ``batch / D`` rows on its own stage ring, with its own cache
rows; the replicas' logits are gathered in row order, so every rank
greedy-decodes the same tokens as one replica serving the whole batch:

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
        -m repro_torch.launch.serve --arch llama3.2-1b --tensor 1 \\
        --stages 2 --data 2 --microbatches 2 --batch 8 --prompt-len 512 \\
        --gen 32 --dist-backend gloo

A tensor degree T above 1 (ranks only: data x stages x T processes)
runs each stage's blocks over its T shards (Megatron: the heads and the
MLP's hidden units split, the kv cache holding each shard's kv heads,
the embedding and the head split over the vocab; the last stage's
shards gather their logits in shard order):

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
        -m repro_torch.launch.serve --arch llama3.2-1b --stages 2 \\
        --microbatches 2 --batch 8 --prompt-len 512 --gen 32 \\
        --dist-backend gloo

Timing discipline: every phase ends in ``torch.cuda.synchronize()``.
Warm-up (building the CUDA kernels, first cuBLAS use) is reported apart
from prefill throughput and steady-state decode throughput.  Warm-up runs
no model step, so in a call of :func:`main` llama3.2-1b launches the
flash-attention kernel exactly ``layers x microbatches x gen`` times
(prefill and every decode step), and mamba2-2.7b launches the SSD kernel
exactly ``layers x microbatches`` times (prefill only: decode is the
recurrent update in plain torch).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.kernels import build, launch_counters
from repro_torch.launch import with_tensor
from repro_torch.launch import mesh as MESH
from repro_torch.pipeline import comm as C
from repro_torch.pipeline import runtime as RT
from repro_torch.pipeline import stage as ST


def _fence(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _tree_bytes(tree: dict) -> tuple[int, int]:
    """(total bytes, largest leaf's bytes) of a nested dict of tensors."""
    sizes = [a.numel() * a.element_size() for a in ST.tree_leaves(tree)]
    return sum(sizes), max(sizes)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--stages", type=int, default=0)
    ap.add_argument("--tensor", type=int, default=0)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--virtual", type=int, default=0,
                    help="interleave the PREFILL over V chunks/device "
                         "(decode always runs the contiguous V=1 plan)")
    ap.add_argument("--schedule", default="auto",
                    help="prefill op order (schedplan name); memlean needs "
                         "--microbatches %% stages == 0")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dist-backend", default="", choices=("", *MESH.BACKENDS),
                    help="under torchrun: nccl (the default on cuda; one "
                         "card per rank) or gloo (the default on cpu; on "
                         "cuda every rank may share one card)")
    ap.add_argument("--tokens-out", default="",
                    help="write {tokens} JSON here (rank 0 under torchrun)")
    return ap


def main(argv=None, mesh: MESH.StageMesh = None, *,
         keep_logits: bool = False) -> dict:
    """Serve as ``argv`` says, in one process, or as this process's stage
    of ``mesh`` (a group already set up, e.g. by
    :func:`repro_torch.launch.mesh.spawn_ranks`) or of the group that
    ``torchrun``'s environment describes (``WORLD_SIZE`` above 1).  With
    ``keep_logits`` the result also holds every step's logits
    (``step_logits``, on the host)."""
    args = _parser().parse_args(argv)
    if args.gen < 1:
        raise ValueError("--gen must be >= 1")

    cfg = get_config(args.arch)
    if cfg.family == "audio":
        raise ValueError(
            f"{cfg.arch_id}: this serve CLI takes tokens only, no encoder "
            f"frames, so it does not serve the audio family (the JAX "
            f"package's serve CLI does not serve it either); serve it "
            f"through repro_torch.models.model.prefill_audio_cache (the "
            f"encoder's cross keys and values, laid into the cache by "
            f"repro_torch.pipeline.runtime.lay_cross_cache) and "
            f"repro_torch.pipeline.runtime.make_serve_step")
    if args.reduced:
        cfg = cfg.reduced(n_layers=4, d_model=256)
    cfg = with_tensor(cfg, args.tensor)
    if args.stages:
        cfg = dataclasses.replace(cfg, stages=args.stages)
    if args.virtual:
        cfg = dataclasses.replace(cfg, virtual=args.virtual)
    device = torch.device(args.device)
    kw = dict(microbatches=args.microbatches, schedule=args.schedule,
              batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
              seed=args.seed)
    if mesh is None and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        MESH.check_world(cfg.stages, int(os.environ["WORLD_SIZE"]),
                         args.data, cfg.tensor)
        mesh = MESH.init_stage_group(
            args.dist_backend or ("nccl" if device.type == "cuda"
                                  else "gloo"), device.type, data=args.data,
            tensor=cfg.tensor)
        ok = False
        try:
            out = serve(cfg, device=device, mesh=mesh, data=args.data,
                        keep_logits=keep_logits, **kw)
            ok = True
        finally:
            mesh = None         # the groups' last reference here
            MESH.destroy_groups(wait=ok)
    else:
        out = serve(cfg, device=device, mesh=mesh, data=args.data,
                    keep_logits=keep_logits, **kw)
    if args.tokens_out and out.get("rank", 0) == 0:
        with open(args.tokens_out, "w") as f:
            json.dump(dict(tokens=out["tokens"].tolist()), f)
    return out


def _add_stats(total: dict, stats: dict) -> None:
    for k, st in stats.items():
        total[k] = [a + b for a, b in zip(total.get(k, [0] * len(st)), st)]


def serve(cfg, *, microbatches: int, schedule: str, batch: int,
          prompt_len: int, gen: int, seed: int, device: torch.device = None,
          mesh: MESH.StageMesh = None, data: int = 1,
          keep_logits: bool = False) -> dict:
    """Prefill on ``plan_stages(cfg)`` (interleaved when ``cfg.virtual``
    > 1, under ``schedule``), the restack handoff to the contiguous V = 1
    layout where the prefill interleaved, then greedy decode on the V = 1
    plan under the default ring schedule.  What :func:`main` runs once its
    flags are read into ``cfg``: in one process on ``device``, or as
    stage ``mesh.rank`` of the rank executor (its share of the weights
    and the cache, the same prompt on every rank, the handoff across
    ranks, the same logits and tokens on every rank; rank 0 alone
    prints, the times the slowest rank's).  On a mesh of D > 1 replicas
    each serves its rows of the batch (``data`` must be the mesh's); on
    a mesh of tensor degree T (``cfg.tensor``, which must be the mesh's)
    each rank holds its tensor shard of its stage.  In one process a
    data or tensor degree above 1 raises, naming the world it needs,
    before anything is allocated."""
    rank = stage = None
    if mesh is None and cfg.tensor > 1:
        raise ValueError(RT.tensor_needs_ranks(cfg.tensor, cfg.stages, data))
    if mesh is not None:
        MESH.check_world(cfg.stages, mesh.world, mesh.data, cfg.tensor)
        if data != mesh.data:
            raise ValueError(f"--data {data} on a grid of {mesh.data} "
                             f"replicas")
        device, rank, stage = mesh.device, mesh.rank, mesh.stage
    lead = not rank
    # decode always runs the contiguous plan; prefill may interleave
    plan = ST.plan_stages(cfg, virtual=1)
    plan_p = ST.plan_stages(cfg) if cfg.virtual > 1 else plan
    max_len = prompt_len + gen
    prefill = RT.make_serve_step(
        cfg, plan_p, RT.PipelineConfig(n_microbatches=microbatches,
                                       schedule=schedule),
        q_len=prompt_len, group=mesh, data=data)
    decode = RT.make_serve_step(
        cfg, plan, RT.PipelineConfig(n_microbatches=microbatches), q_len=1,
        group=mesh, data=data)
    if mesh is None:
        params = ST.init_stacked_params(cfg, seed, plan_p, device=device)
        cache = RT.init_pipeline_cache(cfg, plan_p, batch, max_len,
                                       device=device)
    else:
        params = ST.init_stage_params(cfg, seed, plan_p, stage,
                                      tensor_rank=mesh.tensor_rank,
                                      device=device)
        cache = RT.init_stage_cache(cfg, plan_p, stage, batch, max_len,
                                    data=mesh.data, device=device)
    g = torch.Generator().manual_seed(seed + 1)
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len),
                           generator=g).to(device)
    if lead:
        print((f"device: {device} ({torch.cuda.get_device_name(device)})"
               if device.type == "cuda" else f"device: {device}")
              + ("" if mesh is None else
                 f" ranks={mesh.world} backend={mesh.backend} (data "
                 f"{mesh.data} x stages {mesh.stages} x tensor "
                 f"{mesh.tensor})"), flush=True)

    def start() -> float:
        """The phase starts with the queued work done (on every rank)."""
        _fence(device)
        if mesh is not None:
            dist.barrier()
        return time.perf_counter()

    # ---- warm-up: build every kernel (rank 0; the other ranks load what
    # it built), first cuBLAS call; no model step, so the kernels' launch
    # counts cover prefill and decode alone ---------------------------------
    t0 = start()
    if device.type == "cuda":
        if lead:
            build.build_all()
        if mesh is not None:
            dist.barrier()
        w = torch.ones((8, cfg.d_model), device=device)
        torch.matmul(w, w.T)
    _fence(device)
    t_warm = time.perf_counter() - t0
    counters = launch_counters()
    before = {k: getattr(fn, a) for k, (fn, a) in counters.items()}
    transport = {}

    # ---- prefill ----------------------------------------------------------
    t0 = start()
    logits, cache = prefill(params, cache, dict(tokens=prompt))
    _fence(device)
    t_prefill = time.perf_counter() - t0
    if mesh is not None:
        transport["prefill"] = {k: list(v) for k, v in
                                prefill.transport.stats.items()}
    prefill_logits = logits
    next_tok = torch.argmax(logits[:, 0, :cfg.vocab], dim=-1)
    generated = [next_tok]
    kept = [logits.clone()] if keep_logits else None

    # ---- prefill -> decode handoff: re-fold the V-chunk parameters and the
    # [V, Lc, ...] prefill cache to the contiguous [Lps, ...] layout, leaf
    # by leaf, each old leaf dropped as its new one is made; on ranks each
    # layer goes to the rank that holds it next --------------------------
    handoff = None
    if cfg.virtual > 1:
        old_bytes, old_largest = _tree_bytes(
            dict(layers=params["layers"], cache=cache))
        mem = {}
        if device.type == "cuda":
            mem["peak_before"] = torch.cuda.max_memory_allocated(device)
            mem["allocated_before"] = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        t0 = start()
        if mesh is None:
            ST.restack_tree_(params["layers"], plan_p, plan, cfg.n_layers)
            ST.restack_tree_(cache, plan_p, plan, cfg.n_layers)
        else:
            tp = C.Transport(mesh.group)
            for tree in (params["layers"], cache):
                ST.restack_share_(tree, plan_p, plan, cfg.n_layers, stage,
                                  tp)
            transport["handoff"] = {k: list(v) for k, v in tp.stats.items()}
        _fence(device)
        t_handoff = time.perf_counter() - t0
        if device.type == "cuda":
            mem["peak_during"] = torch.cuda.max_memory_allocated(device)
            mem["allocated_after"] = torch.cuda.memory_allocated(device)
        new_bytes, new_largest = _tree_bytes(
            dict(layers=params["layers"], cache=cache))
        # bytes of the layers and the cache in each layout, the largest
        # leaf of either, and the card's allocator figures around it
        handoff = dict(seconds=t_handoff, bytes_before=old_bytes,
                       bytes_after=new_bytes,
                       largest_leaf_bytes=max(old_largest, new_largest),
                       **mem)

    # ---- steady-state decode: tokens stay on the device -------------------
    t0 = start()
    dec = {}
    for _ in range(gen - 1):
        logits, cache = decode(params, cache, dict(tokens=next_tok[:, None]))
        if mesh is not None:
            _add_stats(dec, decode.transport.stats)
        next_tok = torch.argmax(logits[:, 0, :cfg.vocab], dim=-1)
        generated.append(next_tok)
        if keep_logits:
            kept.append(logits.clone())
    _fence(device)
    t_decode = time.perf_counter() - t0
    launches = {k: getattr(fn, a) - before[k]
                for k, (fn, a) in counters.items()}

    ranks = {}
    if mesh is not None:
        transport["decode"] = dec
        peak = None
        if device.type == "cuda":   # the handoff restarted the count
            peak = max(torch.cuda.max_memory_allocated(device),
                       (handoff or {}).get("peak_before", 0)) / 2**30
        per = MESH.gather(dict(prefill_s=t_prefill, decode_s=t_decode,
                           handoff=handoff, launches=launches,
                           peak_gib=peak, transport=transport), mesh)
        t_prefill = max(p["prefill_s"] for p in per)
        t_decode = max(p["decode_s"] for p in per)
        launches = {k: sum(p["launches"][k] for p in per) for k in launches}
        if handoff is not None:
            handoff = dict(handoff, by_rank=[p["handoff"] for p in per],
                           seconds=max(p["handoff"]["seconds"] for p in per))
        ranks = dict(rank=rank, world=mesh.world, data=mesh.data,
                     tensor=mesh.tensor, backend=mesh.backend,
                     peak_gib_by_rank=[p["peak_gib"] for p in per],
                     transport=[p["transport"] for p in per])
    toks = torch.stack(generated, 1).cpu()
    pre_toks = batch * prompt_len
    dec_toks = (gen - 1) * batch
    if lead:
        slow = "" if mesh is None else ", the slowest rank's time"
        print(f"warm-up: {t_warm*1e3:.1f}ms (kernel build + first cuBLAS "
              f"call; excluded from all phases)")
        print(f"prefill: {batch}x{prompt_len} in {t_prefill*1e3:.1f}ms "
              f"({pre_toks / max(t_prefill, 1e-9):.0f} tok/s{slow})")
        if handoff is not None:
            print(f"handoff: V={cfg.virtual} restack (leaf by leaf"
                  f"{'' if mesh is None else ', across ranks'}) in "
                  f"{handoff['seconds']*1e3:.1f}ms")
        print(f"decode:  {gen - 1} steps x batch {batch} in "
              f"{t_decode*1e3:.1f}ms "
              f"({dec_toks / max(t_decode, 1e-9):.0f} tok/s steady-state"
              f"{slow})")
        print(f"kernel launches{'' if mesh is None else ' summed over ranks'}"
              f" {json.dumps(launches)}")
        if mesh is not None:
            print("peak device memory per rank " + (
                ", ".join(f"{p:.2f} GiB" for p in ranks["peak_gib_by_rank"])
                if device.type == "cuda" else "not measured (cpu)"))
            how = mesh.backend + (", host-staged" if mesh.backend == "gloo"
                                  and device.type == "cuda" else "")
            for r, tr in enumerate(ranks["transport"]):
                for phase, stats in tr.items():
                    print(f"transport rank {r} ({how}) {phase}: " + (
                        ", ".join(f"{k} {c} msgs {b} B {sec * 1e3:.1f} ms "
                                  f"(copies {cp * 1e3:.1f} ms)"
                                  for k, (c, b, sec, cp, *_) in
                                  stats.items()
                                  if c) or "no messages"))
        print("sample generations (first 3 rows):")
        for row in toks[:3]:
            print("  ", row.tolist(), flush=True)
    kept = dict(step_logits=[x.cpu() for x in kept]) if keep_logits else {}
    return dict(tokens=toks, last_logits=logits,
                prefill_logits=prefill_logits, warmup_s=t_warm,
                prefill_s=t_prefill, decode_s=t_decode, handoff=handoff,
                lowerings=dict(prefill=prefill.lowering,
                               decode=decode.lowering),
                prefill_tok_s=pre_toks / max(t_prefill, 1e-9),
                decode_tok_s=dec_toks / max(t_decode, 1e-9),
                launches=launches, **ranks, **kept)

if __name__ == "__main__":
    main()
