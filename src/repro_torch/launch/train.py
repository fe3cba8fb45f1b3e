"""Pipelined training entry point: llama-style models through the BaPipe
stage plan and a compiled F/B(/W) schedule, on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --tensor 1 --stages 4 --schedule 1f1b --microbatches 4 --batch 8 \\
        --seq 1024 --steps 3

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --reduced --layers 2 --d-model 64 --stages 2 --microbatches 2 \\
        --batch 4 --seq 32 --steps 30 --lr 6e-3 --device cpu

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --tensor 1 --stages 4 --virtual 2 --schedule 1f1b-interleaved \\
        --microbatches 4 --batch 8 --seq 1024 --steps 3

``--schedule`` takes any of the eight builders of
:data:`repro_torch.core.schedplan.BUILDER_NAMES` (``--virtual V`` chunks
per stage for the interleaved two); ``--mem-limit`` caps ``zb-auto``'s
resident residuals and, as in the JAX CLI, is an error with any other
schedule; ``--remat full`` recomputes each layer inside the backward.
``--device cpu`` runs the same path on the CPU with the kernels' plain
versions.  As in the JAX CLI, ``--layers``/``--d-model`` apply only
under ``--reduced``, and a config whose tensor degree is above 1
(llama3.2-1b's is 2) is refused unless ``--tensor 1`` is given.  Data
come from :class:`repro_torch.data.synthetic.SyntheticLM`
(the JAX package's generator, bit-identical tokens); the optimizer is
AdamW with the reference settings (``warmup_cosine(lr, 20, steps)``,
weight decay 0.01, b2 0.95, clip 1.0).  Each step prints its loss and
tok/s; the run prints the peak device memory, the residual stash slots
per stage and each kernel's launches per step.  Flags of the JAX CLI that
the port does not run yet are accepted and refused with the ROADMAP item
that ports them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core import schedplan as SP
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_attend
from repro_torch.kernels.ssd_scan import ssd_chunked
from repro_torch.launch import PAR_ITEM as _PAR_ITEM, one_card
from repro_torch.optim.adamw import AdamW, warmup_cosine
from repro_torch.pipeline import runtime as RT
from repro_torch.pipeline import stage as ST

_CKPT_ITEM = "ROADMAP 'Still to port': checkpoints, reshard and elastic"
_PLAN_ITEM = "ROADMAP 'Still to port': the analytic planner stack"
_STREAM_ITEM = "ROADMAP 'Still to port': the stream runtime"

#: flags of the JAX CLI the port does not run yet: (flag, accepted
#: values, ROADMAP item); any other value raises NotImplementedError
#: (``--tensor`` is held by :func:`repro_torch.launch.one_card`)
_REFUSED = (
    ("data", (1,), _PAR_ITEM),
    ("runtime", ("", "ticks"), _STREAM_ITEM),
    ("grad_sync", ("", "auto", "end"), _PAR_ITEM),
    ("ar_groups", (1,), _PAR_ITEM),
    ("ckpt", ("",), _CKPT_ITEM),
    ("ckpt_every", (0,), _CKPT_ITEM),
    ("resume", ("",), _CKPT_ITEM),
    ("die_at", (0,), _CKPT_ITEM),
    ("drift_every", (0,), _CKPT_ITEM),
    ("drift_threshold", (None,), _CKPT_ITEM),
    ("drift_inject", ("",), _CKPT_ITEM),
    ("replan_budget", (None,), _CKPT_ITEM),
    ("auto_plan", (False,), _PLAN_ITEM),
    ("auto_plan3d", (False,), _PLAN_ITEM),
    ("pool", (0,), _PLAN_ITEM),
    ("cluster", ("",), _PLAN_ITEM),
)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--stages", type=int, default=0)
    ap.add_argument("--schedule", default="",
                    help="op order: auto | gpipe | 1f1b | 1f1b-2x | dapple "
                         "| zb-h1 | zb-h2 | zb-auto | 1f1b-interleaved | "
                         "1f1b-interleaved-memlean")
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--losses-out", default="",
                    help="write {start, losses} JSON here")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--virtual", type=int, default=0,
                    help="chunks per stage (V) for the interleaved "
                         "schedules")
    ap.add_argument("--mem-limit", type=int, default=0,
                    help="zb-auto peak-live cap per stage (0 = unbounded)")
    ap.add_argument("--remat", default="stage",
                    help="none | stage | stage_save_moe | full")
    # the JAX CLI's other flags: accepted, refused unless at their default
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--tensor", type=int, default=0)
    ap.add_argument("--runtime", default="")
    ap.add_argument("--grad-sync", default="")
    ap.add_argument("--ar-groups", type=int, default=1)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", default="")
    ap.add_argument("--die-at", type=int, default=0)
    ap.add_argument("--drift-every", type=int, default=0)
    ap.add_argument("--drift-threshold", type=float, default=None)
    ap.add_argument("--drift-inject", default="")
    ap.add_argument("--replan-budget", type=float, default=None)
    ap.add_argument("--auto-plan", action="store_true")
    ap.add_argument("--auto-plan3d", action="store_true")
    ap.add_argument("--pool", type=int, default=0)
    ap.add_argument("--cluster", default="")
    return ap


def _counters() -> dict:
    """Every kernel launch counter: ``name`` or ``name.route``."""
    out = {}
    for name, fn in (("flash_attention", flash_attend),
                     ("ssd_scan", ssd_chunked)):
        for attr in sorted(vars(fn)):
            if attr == "launches":
                out[name] = (fn, attr)
            elif attr.startswith("launches_"):
                out[f"{name}.{attr[len('launches_'):]}"] = (fn, attr)
    return out


def build_config(args: argparse.Namespace):
    """The model the CLI trains, as the JAX CLI builds it from the same
    argv: ``--layers``/``--d-model`` cut the model only under
    ``--reduced``; the config's tensor degree must be 1 or be overridden
    by ``--tensor 1`` (:func:`repro_torch.launch.one_card`);
    ``--mem-limit`` without ``--schedule zb-auto`` is a usage error
    (SystemExit 2), as in the JAX CLI.  Refused flags raise
    NotImplementedError by their ROADMAP item."""
    for flag, ok, item in _REFUSED:
        val = getattr(args, flag)
        if val not in ok:
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} {val}: not ported yet ({item})")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(n_layers=args.layers or 4,
                          d_model=args.d_model or 256, seq=args.seq)
    cfg = one_card(cfg, args.tensor)
    cfg = dataclasses.replace(cfg, virtual=args.virtual or cfg.virtual,
                              stages=args.stages or cfg.stages,
                              schedule=args.schedule or cfg.schedule)
    if args.mem_limit:
        sched = cfg.schedule if cfg.schedule not in ("auto", "") else "1f1b"
        if SP.canonical_name(sched) != "zb-auto":
            _parser().error(f"--mem-limit only applies to --schedule "
                            f"zb-auto (or --auto-plan); got --schedule "
                            f"{sched}")
        cfg = dataclasses.replace(cfg, mem_limit=args.mem_limit)
    return cfg


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)

    device = torch.device(args.device)
    cfg = build_config(args)
    plan = ST.plan_stages(cfg)
    opt = AdamW(lr=warmup_cosine(args.lr, 20, args.steps), weight_decay=0.01)
    pcfg = RT.PipelineConfig(n_microbatches=args.microbatches,
                             schedule=cfg.schedule, mem_limit=cfg.mem_limit,
                             remat=args.remat)
    step_fn = RT.make_train_step(cfg, plan, pcfg, optimizer=opt)
    params = ST.init_stacked_params(cfg, args.seed, plan, device=device)
    opt_state = opt.init(params)
    n_params = sum(x.numel() for x in ST.tree_leaves(params))
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"arch={cfg.arch_id} layers={cfg.n_layers} d={cfg.d_model} "
          f"stages={plan.n_stages}x{plan.layers_per_stage} V={plan.virtual} "
          f"schedule={step_fn.lowering.schedule} M={args.microbatches} "
          f"params={n_params / 1e6:.1f}M device={device} ({name})",
          flush=True)
    if device.type == "cuda":
        build.build_all()       # kernel builds before the first step
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq,
                       global_batch=args.batch, seed=args.seed,
                       device=str(device))
    counters = _counters()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses, step_s, launches = [], [], []
    t_start = time.perf_counter()
    for step in range(args.steps):
        batch = data.batch(step)
        before = {k: getattr(fn, a) for k, (fn, a) in counters.items()}
        if device.type == "cuda":       # the step's time alone
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))       # syncs the device
        step_s.append(time.perf_counter() - t0)
        launches.append({k: getattr(fn, a) - before[k]
                         for k, (fn, a) in counters.items()})
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"({args.batch * args.seq / step_s[-1]:.0f} tok/s, "
                  f"{step_s[-1] * 1e3:.1f} ms)", flush=True)
    wall = time.perf_counter() - t_start
    peak = (torch.cuda.max_memory_allocated(device) / 2**30
            if device.type == "cuda" else None)
    n = min(10, max(1, len(losses)))
    print(f"first-{n} mean loss {sum(losses[:n]) / n:.4f} -> "
          f"last-{n} mean loss {sum(losses[-n:]) / n:.4f}")
    print(f"stash slots per stage {step_fn.stash_slots} "
          f"(lower_to_ticks n_x = {step_fn.lowering.n_x})")
    print(f"kernel launches per step {json.dumps(launches[-1])}")
    print("peak device memory " + (f"{peak:.2f} GiB" if peak is not None
                                   else "not measured (cpu)"))
    if args.losses_out:
        with open(args.losses_out, "w") as f:
            json.dump(dict(start=0, losses=losses), f)
    return dict(losses=losses, step_s=step_s, wall_s=wall,
                tok_per_step=args.batch * args.seq, launches=launches,
                stash_slots=step_fn.stash_slots, n_x=step_fn.lowering.n_x,
                peak_gib=peak, params=params, opt_state=opt_state)


if __name__ == "__main__":
    main()
