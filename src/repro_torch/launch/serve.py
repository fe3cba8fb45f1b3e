"""Pipelined serving entry point: batched prefill + greedy decode, one card.

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

``--device cpu`` runs the same path on the CPU with the kernels' plain
versions (add ``--reduced`` for a small model).  A config whose tensor
degree is above 1 (llama3.2-1b's is 2, gemma3-1b's and qwen3-1.7b's 4) is
refused unless ``--tensor 1`` is given, as in the training CLI.
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
import time

import torch

from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.launch import one_card
from repro_torch.pipeline import runtime as RT
from repro_torch.pipeline import stage as ST


def _fence(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _tree_bytes(tree: dict) -> tuple[int, int]:
    """(total bytes, largest leaf's bytes) of a nested dict of tensors."""
    sizes = [a.numel() * a.element_size() for a in ST.tree_leaves(tree)]
    return sum(sizes), max(sizes)


def main(argv=None) -> dict:
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
    args = ap.parse_args(argv)
    if args.gen < 1:
        raise ValueError("--gen must be >= 1")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(n_layers=4, d_model=256)
    cfg = one_card(cfg, args.tensor)
    if args.stages:
        cfg = dataclasses.replace(cfg, stages=args.stages)
    if args.virtual:
        cfg = dataclasses.replace(cfg, virtual=args.virtual)
    return serve(cfg, microbatches=args.microbatches,
                 schedule=args.schedule, batch=args.batch,
                 prompt_len=args.prompt_len, gen=args.gen, seed=args.seed,
                 device=torch.device(args.device), data=args.data)


def serve(cfg, *, microbatches: int, schedule: str, batch: int,
          prompt_len: int, gen: int, seed: int, device: torch.device,
          data: int = 1) -> dict:
    """Prefill on ``plan_stages(cfg)`` (interleaved when ``cfg.virtual``
    > 1, under ``schedule``), the restack handoff to the contiguous V = 1
    layout where the prefill interleaved, then greedy decode on the V = 1
    plan under the default ring schedule.  What :func:`main` runs once its
    flags are read into ``cfg``."""
    # decode always runs the contiguous plan; prefill may interleave
    plan = ST.plan_stages(cfg, virtual=1)
    plan_p = ST.plan_stages(cfg) if cfg.virtual > 1 else plan
    max_len = prompt_len + gen
    prefill = RT.make_serve_step(
        cfg, plan_p, RT.PipelineConfig(n_microbatches=microbatches,
                                       schedule=schedule),
        q_len=prompt_len, data=data)
    decode = RT.make_serve_step(
        cfg, plan, RT.PipelineConfig(n_microbatches=microbatches), q_len=1,
        data=data)
    params = ST.init_stacked_params(cfg, seed, plan_p, device=device)
    cache = RT.init_pipeline_cache(cfg, plan_p, batch, max_len,
                                   device=device)
    g = torch.Generator().manual_seed(seed + 1)
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len),
                           generator=g).to(device)
    print(f"device: {device} ({torch.cuda.get_device_name(device)})"
          if device.type == "cuda" else f"device: {device}")

    # ---- warm-up: build every kernel, first cuBLAS call; no model step,
    # so the kernels' launch counts cover prefill and decode alone --------
    _fence(device)
    t0 = time.perf_counter()
    if device.type == "cuda":
        build.build_all()
        w = params["embed"][:8]
        torch.matmul(w, w.T)
    _fence(device)
    t_warm = time.perf_counter() - t0

    # ---- prefill ----------------------------------------------------------
    t0 = time.perf_counter()
    logits, cache = prefill(params, cache, dict(tokens=prompt))
    _fence(device)
    t_prefill = time.perf_counter() - t0
    prefill_logits = logits
    next_tok = torch.argmax(logits[:, 0, :cfg.vocab], dim=-1)
    generated = [next_tok]

    # ---- prefill -> decode handoff: re-fold the V-chunk parameters and the
    # [S, V, Lc, ...] prefill cache to the contiguous [S, Lps, ...] layout,
    # leaf by leaf, each old leaf dropped as its new one is made ----------
    handoff = None
    if cfg.virtual > 1:
        old_bytes, old_largest = _tree_bytes(
            dict(layers=params["layers"], cache=cache))
        mem = {}
        if device.type == "cuda":
            mem["peak_before"] = torch.cuda.max_memory_allocated(device)
            mem["allocated_before"] = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        ST.restack_tree_(params["layers"], plan_p, plan, cfg.n_layers)
        ST.restack_tree_(cache, plan_p, plan, cfg.n_layers)
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
    _fence(device)
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = decode(params, cache, dict(tokens=next_tok[:, None]))
        next_tok = torch.argmax(logits[:, 0, :cfg.vocab], dim=-1)
        generated.append(next_tok)
    _fence(device)
    t_decode = time.perf_counter() - t0

    toks = torch.stack(generated, 1).cpu()
    pre_toks = batch * prompt_len
    dec_toks = (gen - 1) * batch
    print(f"warm-up: {t_warm*1e3:.1f}ms (kernel build + first cuBLAS call; "
          f"excluded from all phases)")
    print(f"prefill: {batch}x{prompt_len} in {t_prefill*1e3:.1f}ms "
          f"({pre_toks / max(t_prefill, 1e-9):.0f} tok/s)")
    if handoff is not None:
        print(f"handoff: V={cfg.virtual} restack (leaf by leaf) in "
              f"{handoff['seconds']*1e3:.1f}ms")
    print(f"decode:  {gen - 1} steps x batch {batch} in "
          f"{t_decode*1e3:.1f}ms "
          f"({dec_toks / max(t_decode, 1e-9):.0f} tok/s steady-state)")
    print("sample generations (first 3 rows):")
    for row in toks[:3]:
        print("  ", row.tolist())
    return dict(tokens=toks, last_logits=logits,
                prefill_logits=prefill_logits, warmup_s=t_warm,
                prefill_s=t_prefill, decode_s=t_decode, handoff=handoff,
                lowerings=dict(prefill=prefill.lowering,
                               decode=decode.lowering),
                prefill_tok_s=pre_toks / max(t_prefill, 1e-9),
                decode_tok_s=dec_toks / max(t_decode, 1e-9))


if __name__ == "__main__":
    main()
