"""Pipelined serving entry point: batched prefill + greedy decode, one card.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch llama3.2-1b --tensor 1 --stages 8 --microbatches 2 \\
        --batch 8 --prompt-len 512 --gen 32

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch mamba2-2.7b --stages 16 --microbatches 2 \\
        --batch 8 --prompt-len 512 --gen 32

``--device cpu`` runs the same path on the CPU with the kernels' plain
versions (add ``--reduced`` for a small model).  A config whose tensor
degree is above 1 (llama3.2-1b's is 2) is refused unless ``--tensor 1``
is given, as in the training CLI.  For mamba2 the prompt
length must be a multiple of the SSD chunk (256; 16 reduced) or shorter
than it.

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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--stages", type=int, default=0)
    ap.add_argument("--tensor", type=int, default=0)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--virtual", type=int, default=0,
                    help="interleaved prefill; not ported yet (must be <= 1)")
    ap.add_argument("--schedule", default="auto",
                    help="op order (schedplan name): auto | gpipe | 1f1b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.virtual > 1:
        raise NotImplementedError("--virtual > 1 (interleaved prefill and "
                                  "the restack handoff) is not ported yet")
    if args.gen < 1:
        raise ValueError("--gen must be >= 1")

    device = torch.device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(n_layers=4, d_model=256)
    cfg = one_card(cfg, args.tensor)
    if args.stages:
        cfg = dataclasses.replace(cfg, stages=args.stages)
    plan = ST.plan_stages(cfg, virtual=1)
    max_len = args.prompt_len + args.gen
    pcfg = RT.PipelineConfig(n_microbatches=args.microbatches,
                             schedule=args.schedule)
    prefill = RT.make_serve_step(cfg, plan, pcfg, q_len=args.prompt_len,
                                 data=args.data)
    decode = RT.make_serve_step(cfg, plan, pcfg, q_len=1, data=args.data)
    params = ST.init_stacked_params(cfg, args.seed, plan, device=device)
    cache = RT.init_pipeline_cache(cfg, plan, args.batch, max_len,
                                   device=device)
    gen = torch.Generator().manual_seed(args.seed + 1)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen).to(device)
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
    next_tok = torch.argmax(logits[:, 0, :cfg.vocab], dim=-1)
    generated = [next_tok]

    # ---- steady-state decode: tokens stay on the device -------------------
    _fence(device)
    t0 = time.perf_counter()
    for _ in range(args.gen - 1):
        logits, cache = decode(params, cache, dict(tokens=next_tok[:, None]))
        next_tok = torch.argmax(logits[:, 0, :cfg.vocab], dim=-1)
        generated.append(next_tok)
    _fence(device)
    t_decode = time.perf_counter() - t0

    toks = torch.stack(generated, 1).cpu()
    pre_toks = args.batch * args.prompt_len
    dec_toks = (args.gen - 1) * args.batch
    print(f"warm-up: {t_warm*1e3:.1f}ms (kernel build + first cuBLAS call; "
          f"excluded from all phases)")
    print(f"prefill: {args.batch}x{args.prompt_len} in {t_prefill*1e3:.1f}ms "
          f"({pre_toks / max(t_prefill, 1e-9):.0f} tok/s)")
    print(f"decode:  {args.gen - 1} steps x batch {args.batch} in "
          f"{t_decode*1e3:.1f}ms "
          f"({dec_toks / max(t_decode, 1e-9):.0f} tok/s steady-state)")
    print("sample generations (first 3 rows):")
    for row in toks[:3]:
        print("  ", row.tolist())
    return dict(tokens=toks, last_logits=logits, warmup_s=t_warm,
                prefill_s=t_prefill, decode_s=t_decode,
                prefill_tok_s=pre_toks / max(t_prefill, 1e-9),
                decode_tok_s=dec_toks / max(t_decode, 1e-9))


if __name__ == "__main__":
    main()
