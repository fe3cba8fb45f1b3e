"""Pipelined training entry point: dense GQA models (llama3.2-1b,
gemma3-1b, qwen3-1.7b) and mamba2-2.7b through the BaPipe stage plan and
a compiled F/B(/W) schedule: every stage in one process on one card, or,
under ``torchrun``, one process per stage.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --tensor 1 --stages 4 --schedule 1f1b --microbatches 4 --batch 8 \\
        --seq 1024 --steps 3

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --reduced --layers 2 --d-model 64 --stages 2 --microbatches 2 \\
        --batch 4 --seq 32 --steps 30 --lr 6e-3 --device cpu

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --tensor 1 --stages 4 --virtual 2 --schedule 1f1b-interleaved \\
        --microbatches 4 --batch 8 --seq 1024 --steps 3

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --tensor 1 --stages 4 --auto-plan --cluster h100,h100,h100,h100 \\
        --batch 8 --seq 1024 --steps 3

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
        --tensor 1 --stages 4 --schedule 1f1b --microbatches 4 --batch 8 \\
        --seq 1024 --steps 3

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --tensor 1 --stages 4 --schedule 1f1b --microbatches 4 --batch 8 \\
        --seq 1024 --steps 3

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \\
        -m repro_torch.launch.train --arch llama3.2-1b --reduced \\
        --layers 2 --d-model 64 --stages 2 --microbatches 2 --batch 4 \\
        --seq 32 --steps 3 --device cpu

With ``WORLD_SIZE`` above 1 (``torchrun``) each process is one stage of
the plan (:mod:`repro_torch.launch.mesh`; ``--stages``, or the planner's
stage count, must equal the world size): it draws only its share of the
weights (:func:`repro_torch.pipeline.stage.init_stage_params`) and runs
its row of the same table (``make_train_step(..., group=...)``), the
rings as ``torch.distributed`` messages.  ``--dist-backend`` is ``nccl``
(one card per rank; more ranks than cards raise) by default on
``--device cuda`` and ``gloo`` on ``--device cpu``; ``--dist-backend
gloo`` runs every rank on one card, each message staged through pinned
host memory.  Every rank makes the same batches; rank 0 alone prints
the losses, the step time (the slowest rank's), the launches summed over
ranks, each rank's stash slots, most registers held live at once and
peak memory, and the transport's messages, bytes and ms a step
(activation hops apart from the tied embedding's all-reduce; the ms
split into posting, receive waits, send waits and staging copies).
``--runtime stream`` (in one process or as ranks) runs each stage's own
RUN/SEND/RECV/FREE instruction stream instead of the lockstep tick
replay: a rank waits only where a tick reads an arrival; the losses are
the tick runtime's, bit for bit.

``--schedule`` takes any of the eight builders of
:data:`repro_torch.core.schedplan.BUILDER_NAMES` (``--virtual V`` chunks
per stage for the interleaved two); ``--mem-limit`` caps ``zb-auto``'s
resident residuals and, as in the JAX CLI, is an error with any other
schedule; ``--remat full`` recomputes each layer inside the backward.
``--auto-plan`` (with ``--cluster`` naming one catalogue device a stage,
and ``--mem-limit``) and ``--auto-plan3d`` (over ``--pool`` devices, the
cards present by default) let BaPipe's planner
(:mod:`repro_torch.core.autoplan`, planning for the port's ``H100``)
pick the stages, tensor degree, micro-batches, schedule and V, as the
JAX CLI does; a plan that needs tensor or data parallelism is printed,
then refused.  ``--device cpu`` runs the same path on the CPU with the
kernels' plain versions.  As in the JAX CLI, ``--layers``/``--d-model``
apply only under ``--reduced``, and a config whose tensor degree is above 1
(llama3.2-1b's is 2, gemma3-1b's and qwen3-1.7b's 4) is refused unless
``--tensor 1`` is given.  Data
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
import os
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core import schedplan as SP
from repro_torch.core.autoplan import auto_plan, auto_plan3d
from repro_torch.core.hardware import CATALOGUE, H100
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.kernels import build, launch_counters
from repro_torch.launch import PAR_ITEM as _PAR_ITEM, one_card
from repro_torch.launch import mesh as MESH
from repro_torch.optim.adamw import AdamW, warmup_cosine
from repro_torch.pipeline import runtime as RT
from repro_torch.pipeline import stage as ST

_CKPT_ITEM = "ROADMAP 'Still to port': checkpoints, reshard and elastic"

#: flags of the JAX CLI the port does not run yet: (flag, accepted
#: values, ROADMAP item); any other value raises NotImplementedError
#: (``--tensor`` is held by :func:`repro_torch.launch.one_card`)
_REFUSED = (
    ("data", (1,), _PAR_ITEM),
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
    ap.add_argument("--dist-backend", default="", choices=("", *MESH.BACKENDS),
                    help="under torchrun: nccl (the default on cuda; one "
                         "card per rank) or gloo (the default on cpu; on "
                         "cuda every rank may share one card)")
    ap.add_argument("--virtual", type=int, default=0,
                    help="chunks per stage (V) for the interleaved "
                         "schedules")
    ap.add_argument("--mem-limit", type=int, default=0,
                    help="zb-auto peak-live cap per stage (0 = unbounded)")
    ap.add_argument("--remat", default="stage",
                    help="none | stage | stage_save_moe | full")
    ap.add_argument("--runtime", default="", choices=("", "ticks", "stream"),
                    help="training executor: ticks (every stage in lockstep "
                         "over the tick table; the config's default) or "
                         "stream (each stage walks its own RUN/SEND/RECV/"
                         "FREE instruction stream)")
    ap.add_argument("--auto-plan", action="store_true",
                    help="let the BaPipe explorer pick stages/tensor/M")
    ap.add_argument("--auto-plan3d", action="store_true",
                    help="search per-stage (data, tensor) degrees over "
                         "--pool devices and adopt the best uniform plan")
    ap.add_argument("--pool", type=int, default=0,
                    help="device-pool size for --auto-plan3d (default: "
                         "the CUDA cards present)")
    ap.add_argument("--cluster", default="",
                    help="comma-separated per-stage device names for "
                         "--auto-plan (" + "|".join(CATALOGUE) + "); "
                         "fixes the stage count to the list length")
    # the JAX CLI's other flags: accepted, refused unless at their default
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--tensor", type=int, default=0)
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
    ap.set_defaults(plan=None)          # the adopted AutoPlan, if any
    return ap


def build_config(args: argparse.Namespace):
    """The model the CLI trains, as the JAX CLI builds it from the same
    argv: ``--layers``/``--d-model`` cut the model only under
    ``--reduced``; the config's tensor degree must be 1 or be overridden
    by ``--tensor 1`` (:func:`repro_torch.launch.one_card`);
    ``--mem-limit`` without ``--schedule zb-auto`` (or ``--auto-plan``),
    ``--cluster`` without ``--auto-plan``, and ``--auto-plan`` with
    ``--auto-plan3d`` are usage errors (SystemExit 2), as in the JAX CLI.
    Under a planner flag the plan is printed and applied
    (``args.microbatches`` takes its M), or refused when it needs tensor
    or data parallelism.  Refused flags raise NotImplementedError by
    their ROADMAP item."""
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
                              schedule=args.schedule or cfg.schedule,
                              runtime=args.runtime or cfg.runtime)
    if args.mem_limit:
        sched = cfg.schedule if cfg.schedule not in ("auto", "") else "1f1b"
        if not args.auto_plan and SP.canonical_name(sched) != "zb-auto":
            _parser().error(f"--mem-limit only applies to --schedule "
                            f"zb-auto (or --auto-plan); got --schedule "
                            f"{sched}")
        cfg = dataclasses.replace(cfg, mem_limit=args.mem_limit)
    if args.cluster and not args.auto_plan:
        _parser().error("--cluster only applies to --auto-plan")
    if args.auto_plan and args.auto_plan3d:
        _parser().error("--auto-plan and --auto-plan3d are mutually "
                        "exclusive")
    if args.auto_plan3d:
        pool = args.pool or (torch.cuda.device_count()
                             if torch.device(args.device).type == "cuda"
                             else 0)
        if pool < 1:
            _parser().error("--auto-plan3d needs --pool N (no CUDA card "
                            "to count)")
        plan_ = auto_plan3d(cfg, global_batch=args.batch, seq_len=args.seq,
                            n_devices=pool, device=H100,
                            mem_limit=args.mem_limit or None)
        widths = "x".join(str(w) for w in plan_.stage_widths)
        print(f"auto-plan3d: stages={plan_.stages} data={plan_.data_axis} "
              f"tensor={plan_.tensor} M={plan_.n_microbatches} "
              f"sched={plan_.schedule} widths={widths} "
              f"(predicted {plan_.predicted_step_time*1e3:.2f} ms/step, "
              f"{plan_.predicted_speedup_over_dp:.2f}x over best "
              f"pipeline-only)", flush=True)
    elif args.auto_plan:
        devices = None
        if args.cluster:
            try:
                devices = [CATALOGUE[s.strip()]
                           for s in args.cluster.split(",")]
            except KeyError as e:
                _parser().error(f"unknown device {e.args[0]!r} in --cluster "
                                f"(know: {', '.join(sorted(CATALOGUE))})")
        plan_ = auto_plan(cfg, global_batch=args.batch, seq_len=args.seq,
                          model_axis=cfg.stages * cfg.tensor,
                          data_axis=args.data, device=H100, devices=devices,
                          mem_limit=args.mem_limit or None)
        print(f"auto-plan: stages={plan_.stages} tensor={plan_.tensor} "
              f"M={plan_.n_microbatches} sched={plan_.schedule} "
              f"V={plan_.virtual} "
              f"(predicted {plan_.predicted_step_time*1e3:.2f} ms/step)",
              flush=True)
    else:
        return cfg
    if plan_.tensor != 1 or plan_.data_axis != 1:
        raise NotImplementedError(
            f"the plan needs tensor={plan_.tensor} x data="
            f"{plan_.data_axis}: not ported yet ({_PAR_ITEM}); the port "
            f"runs tensor = data = 1")
    args.microbatches = plan_.n_microbatches
    args.plan = plan_
    return plan_.apply(cfg)


def main(argv=None, mesh: MESH.StageMesh = None) -> dict:
    """Train as ``argv`` says, in one process, or as this process's stage
    of ``mesh`` (a group already set up, e.g. by
    :func:`repro_torch.launch.mesh.spawn_ranks`) or of the group that
    ``torchrun``'s environment describes (``WORLD_SIZE`` above 1)."""
    args = _parser().parse_args(argv)

    device = torch.device(args.device)
    cfg = build_config(args)
    plan = ST.plan_stages(cfg)
    opt = AdamW(lr=warmup_cosine(args.lr, 20, args.steps), weight_decay=0.01)
    pcfg = RT.PipelineConfig(n_microbatches=args.microbatches,
                             schedule=cfg.schedule, mem_limit=cfg.mem_limit,
                             remat=args.remat, runtime=cfg.runtime)
    own_group = False
    if mesh is None and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        MESH.check_world(plan.n_stages, int(os.environ["WORLD_SIZE"]))
        mesh = MESH.init_stage_group(
            args.dist_backend or ("nccl" if device.type == "cuda"
                                  else "gloo"), device.type)
        own_group = True
    if mesh is not None:
        try:
            return _main_ranks(args, cfg, plan, opt, pcfg, mesh)
        finally:
            if own_group:
                dist.destroy_process_group()
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
    counters = launch_counters()
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
          f"(lower_to_ticks n_x = {step_fn.lowering.n_x}); registers live "
          f"at most per stage {step_fn.live_registers} (runtime "
          f"{pcfg.runtime})")
    print(f"kernel launches per step {json.dumps(launches[-1])}")
    print("peak device memory " + (f"{peak:.2f} GiB" if peak is not None
                                   else "not measured (cpu)"))
    if args.losses_out:
        with open(args.losses_out, "w") as f:
            json.dump(dict(start=0, losses=losses), f)
    return dict(plan=args.plan, schedule=step_fn.lowering.schedule,
                stages=plan.n_stages, virtual=plan.virtual,
                microbatches=args.microbatches,
                losses=losses, step_s=step_s, wall_s=wall,
                tok_per_step=args.batch * args.seq, launches=launches,
                stash_slots=step_fn.stash_slots, n_x=step_fn.lowering.n_x,
                live_registers=step_fn.live_registers, runtime=pcfg.runtime,
                peak_gib=peak, params=params, opt_state=opt_state)


def _main_ranks(args, cfg, plan: ST.StagePlan, opt: AdamW,
                pcfg: RT.PipelineConfig, mesh: MESH.StageMesh) -> dict:
    """:func:`main` as stage ``mesh.rank`` of the rank executor."""
    MESH.check_world(plan.n_stages, mesh.world)
    device, rank, group = mesh.device, mesh.rank, mesh.group
    lead = rank == 0
    gather = lambda obj: MESH.gather(obj, mesh)
    step_fn = RT.make_train_step(cfg, plan, pcfg, optimizer=opt, group=group)
    params = ST.init_stage_params(cfg, args.seed, plan, rank, device=device)
    opt_state = opt.init(params)
    n_params = gather(sum(x.numel() for x in ST.tree_leaves(params)))
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    if lead:
        print(f"arch={cfg.arch_id} layers={cfg.n_layers} d={cfg.d_model} "
              f"stages={plan.n_stages}x{plan.layers_per_stage} "
              f"V={plan.virtual} schedule={step_fn.lowering.schedule} "
              f"M={args.microbatches} ranks={mesh.world} "
              f"backend={mesh.backend} params per rank "
              f"{[round(n / 1e6, 1) for n in n_params]}M device={device} "
              f"({name})", flush=True)
    if device.type == "cuda":
        if lead:
            build.build_all()   # kernel builds before the first step
        dist.barrier(group)     # the other ranks load what rank 0 built
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq,
                       global_batch=args.batch, seed=args.seed,
                       device=str(device))
    counters = launch_counters()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses, step_s, launches, transport = [], [], [], []
    t_start = time.perf_counter()
    for step in range(args.steps):
        batch = data.batch(step)
        before = {k: getattr(fn, a) for k, (fn, a) in counters.items()}
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dist.barrier(group)     # every rank starts the step together
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))       # syncs the device
        mine = (time.perf_counter() - t0,
                {k: getattr(fn, a) - before[k]
                 for k, (fn, a) in counters.items()},
                {k: list(v) for k, v in step_fn.transport.stats.items()})
        per = gather(mine)
        step_s.append(max(p[0] for p in per))
        launches.append({k: sum(p[1][k] for p in per) for k in counters})
        transport.append([p[2] for p in per])
        if lead and (step % args.log_every == 0 or step == args.steps - 1):
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"({args.batch * args.seq / step_s[-1]:.0f} tok/s, "
                  f"{step_s[-1] * 1e3:.1f} ms, the slowest rank's)",
                  flush=True)
    wall = time.perf_counter() - t_start
    peak = gather(torch.cuda.max_memory_allocated(device) / 2**30
                  if device.type == "cuda" else None)
    stash = gather(step_fn.stash_slots)
    live = gather(step_fn.live_registers)
    if lead:
        n = min(10, max(1, len(losses)))
        print(f"first-{n} mean loss {sum(losses[:n]) / n:.4f} -> "
              f"last-{n} mean loss {sum(losses[-n:]) / n:.4f}")
        print(f"stash slots per rank {stash} "
              f"(lower_to_ticks n_x = {step_fn.lowering.n_x}); registers "
              f"live at most per rank {live} (runtime {pcfg.runtime})")
        print(f"kernel launches per step, summed over ranks "
              f"{json.dumps(launches[-1])}")
        print("peak device memory per rank " + (
            ", ".join(f"{p:.2f} GiB" for p in peak) if device.type == "cuda"
            else "not measured (cpu)"))
        how = mesh.backend + (", host-staged" if mesh.backend == "gloo"
                              and device.type == "cuda" else "")
        for r, st in enumerate(transport[-1]):
            print(f"transport rank {r} ({how}) last step: " + ", ".join(
                      f"{k} {c} msgs {b} B {sec * 1e3:.1f} ms (post "
                      f"{post * 1e3:.1f}, receive waits {rw * 1e3:.1f}, send "
                      f"waits {sw * 1e3:.1f}, copies {cp * 1e3:.1f} ms)"
                      for k, (c, b, sec, cp, post, rw, sw) in st.items()
                      if c), flush=True)
        if args.losses_out:
            with open(args.losses_out, "w") as f:
                json.dump(dict(start=0, losses=losses), f)
    return dict(plan=args.plan, schedule=step_fn.lowering.schedule,
                stages=plan.n_stages, virtual=plan.virtual,
                microbatches=args.microbatches, rank=rank, world=mesh.world,
                backend=mesh.backend, losses=losses, step_s=step_s,
                wall_s=wall, tok_per_step=args.batch * args.seq,
                launches=launches, stash_slots=stash,
                n_x=step_fn.lowering.n_x, live_registers=live,
                runtime=pcfg.runtime,
                peak_gib=None if peak[0] is None else max(peak),
                peak_gib_by_rank=peak, transport=transport,
                params=params, opt_state=opt_state)


if __name__ == "__main__":
    main()
