"""Pipelined training entry point: dense GQA models (llama3.2-1b,
gemma3-1b, qwen3-1.7b), mamba2-2.7b, hymba-1.5b and whisper-base through
the BaPipe stage plan and a compiled F/B(/W) schedule: every stage in one
process on one card, or, under ``torchrun``, one process per stage.
whisper-base trains on the stub frontend's frames, zeros ``[batch, 64,
d_model]`` beside each batch's tokens, as the JAX CLI feeds them:

    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-base \
        --reduced --layers 6 --d-model 128 --stages 3 --microbatches 2 \
        --batch 4 --seq 32 --steps 3 --device cpu

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

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
        -m repro_torch.launch.train --arch llama3.2-1b --tensor 1 \\
        --stages 2 --data 2 --dist-backend gloo --runtime stream \\
        --grad-sync overlap --schedule 1f1b --microbatches 2 --batch 8 \\
        --seq 1024 --steps 2

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
        -m repro_torch.launch.train --arch llama3.2-1b --stages 2 \\
        --dist-backend gloo --schedule 1f1b --microbatches 4 --batch 8 \\
        --seq 1024 --steps 2

With ``WORLD_SIZE`` above 1 (``torchrun``) each process is one tensor
shard of one stage of one replica on a ``--data`` x ``--stages`` x
``--tensor`` grid (:mod:`repro_torch.launch.mesh`; data x stages x
tensor, or the planner's, must equal the world size): it draws only its
share of the weights (:func:`repro_torch.pipeline.stage.
init_stage_params`, its tensor shard of its stage's), runs its row of
the same table on its replica's rows of the batch (``make_train_step(...,
group=mesh)``), the rings as ``torch.distributed`` messages, the blocks
Megatron-style over its tensor group, and the gradients are summed over
the replicas as ``--grad-sync`` says (``end`` after the walk;
``overlap``, the default under ``--runtime stream``, at the ARSYNC slots
of each rank's stream, ``--ar-groups`` buckets a chunk; ``2bw``,
PipeDream-2BW: each step applies the previous step's gradients).
``--data`` and a tensor degree above 1 (``--tensor``, 0 keeping the
config's own: llama3.2-1b's is 2, gemma3-1b's and qwen3-1.7b's 4) need
ranks: in one process they raise before anything is allocated, naming
the world they need.  ``--dist-backend`` is ``nccl``
(one card per rank; more ranks than cards raise) by default on
``--device cuda`` and ``gloo`` on ``--device cpu``; ``--dist-backend
gloo`` runs every rank on one card, each message staged through pinned
host memory.  Every rank makes the same batches; rank 0 alone prints
the losses, the step time (the slowest rank's), the launches summed over
ranks, each rank's stash slots, most registers held live at once and
peak memory, and the transport's messages, bytes and ms a step
(activation hops apart from the tied embedding's all-reduce and the
tensor group's collectives; the ms split into posting, receive waits,
send waits and staging copies).
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
pick the stages, tensor degree, micro-batches, schedule and V (and, for
``--auto-plan3d``, the data degree), as the JAX CLI does, and train that
plan (a data or tensor degree above 1 as ranks).  ``--device cpu``
runs the same path on the CPU with the kernels' plain versions.  As in
the JAX CLI, ``--layers``/``--d-model`` apply only under ``--reduced``.
Data
come from :class:`repro_torch.data.synthetic.SyntheticLM`
(the JAX package's generator, bit-identical tokens); the optimizer is
AdamW with the reference settings (``warmup_cosine(lr, 20, steps)``,
weight decay 0.01, b2 0.95, clip 1.0).  Each step prints its loss and
tok/s; the run prints the peak device memory, the residual stash slots
per stage and each kernel's launches per step.

The elastic loop runs as in the JAX CLI, in one process and as ranks.
``--ckpt PATH`` saves ``{params, opt}``, the step and the stage layout
(:mod:`repro_torch.checkpoint`, the JAX package's npz + msgpack format)
at every ``--ckpt-every`` boundary and at the end; on ranks replica 0's
ranks send their shares leaf by leaf to rank 0, which writes the whole
stacked tree.  ``--die-at N`` exits with status 17 after step N without
saving.  ``--resume PATH`` restores the saved state and runs the steps
from the saved one on; a checkpoint of another (stages, virtual) layout
is first resharded on the host into ``PATH.to{S}v{V}`` (on ranks by rank
0, the others waiting), a change of tensor degree raises
:class:`repro_torch.checkpoint.CheckpointMismatch`.  ``--drift-every N``
feeds the drift monitor the measured stage times (times the
``--drift-inject`` factors) every N steps; once it trips, the re-planner
(under ``--replan-budget`` seconds) prints its recommendation, which a
``--resume`` adopts (on ranks rank 0 alone measures and prints).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import ckpt as CK
from repro_torch.checkpoint import reshard as RS
from repro_torch.configs import get_config
from repro_torch.core import profiler as PF
from repro_torch.core import schedplan as SP
from repro_torch.core.autoplan import AutoPlan, auto_plan, auto_plan3d, replan
from repro_torch.core.hardware import CATALOGUE, H100
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.kernels import build, launch_counters
from repro_torch.launch import with_tensor
from repro_torch.launch import mesh as MESH
from repro_torch.optim.adamw import AdamW, warmup_cosine
from repro_torch.pipeline import runtime as RT
from repro_torch.pipeline import stage as ST

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
    ap.add_argument("--data", type=int, default=1,
                    help="data-parallel replicas (ranks: data x stages "
                         "processes under torchrun)")
    ap.add_argument("--grad-sync", default="",
                    choices=("", "auto", "end", "overlap", "2bw"),
                    help="where the replicas' gradients are summed: end "
                         "(after the walk) | overlap (at the ARSYNC slots "
                         "of each rank's stream; needs --runtime stream) | "
                         "2bw (PipeDream-2BW: step k applies step k-1's "
                         "gradients) | auto (overlap iff --runtime stream)")
    ap.add_argument("--ar-groups", type=int, default=1,
                    help="with overlapped sync: AR buckets a chunk, one "
                         "per layer group (must divide its layers)")
    ap.add_argument("--tensor", type=int, default=0,
                    help="tensor-parallel degree (0: the config's own; "
                         "above 1, ranks: data x stages x tensor "
                         "processes under torchrun)")
    ap.add_argument("--ckpt", default="",
                    help="checkpoint base path: saves {params, opt}, the "
                         "step and the stage layout (PATH.npz, PATH.meta)")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="with --ckpt: also save every N steps (0: only "
                         "at the end)")
    ap.add_argument("--resume", default="",
                    help="checkpoint base path to resume from; another "
                         "(stages, virtual) layout is resharded on the "
                         "host first")
    ap.add_argument("--die-at", type=int, default=0,
                    help="fault injection: exit 17 after step N without "
                         "saving")
    ap.add_argument("--drift-every", type=int, default=0,
                    help="feed the drift monitor measured stage times "
                         "every N steps (0: off)")
    ap.add_argument("--drift-threshold", type=float, default=0.25,
                    help="largest relative stage-share error before the "
                         "monitor asks for a replan")
    ap.add_argument("--drift-inject", default="",
                    help="comma-separated per-stage factors multiplied "
                         "into the measured times")
    ap.add_argument("--replan-budget", type=float, default=5.0,
                    help="seconds the drift-triggered re-search may take")
    ap.set_defaults(plan=None)          # the adopted AutoPlan, if any
    return ap


def build_config(args: argparse.Namespace):
    """The model the CLI trains, as the JAX CLI builds it from the same
    argv: ``--layers``/``--d-model`` cut the model only under
    ``--reduced``; ``--tensor`` sets the tensor degree (0 keeps the
    config's: :func:`repro_torch.launch.with_tensor`); ``--mem-limit``
    without ``--schedule zb-auto`` (or ``--auto-plan``), ``--cluster``
    without ``--auto-plan``, and ``--auto-plan`` with
    ``--auto-plan3d`` are usage errors (SystemExit 2), as in the JAX CLI.
    Under a planner flag the plan is printed and applied
    (``args.microbatches`` takes its M, ``args.data`` its data degree,
    the config its stages, tensor degree, schedule and V)."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(n_layers=args.layers or 4,
                          d_model=args.d_model or 256, seq=args.seq)
    cfg = with_tensor(cfg, args.tensor)
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
    args.microbatches = plan_.n_microbatches
    args.data = plan_.data_axis
    args.plan = plan_
    return plan_.apply(cfg)


def _resume_layout(args, layout: dict) -> dict:
    """The layout ``--resume``'s checkpoint records (read before anything
    is allocated or any group set up).  A checkpoint with no layout, or
    of another tensor degree (its vocab padding and shards differ; the
    reshard moves stage boundaries only), raises CheckpointMismatch."""
    src = (CK.checkpoint_meta(args.resume).get("extra") or {}).get("layout")
    if src is None:
        raise CK.CheckpointMismatch(
            f"checkpoint {args.resume!r} records no layout in its meta; "
            f"--resume needs the layout the CLI saves")
    if src["tensor"] != layout["tensor"]:
        raise CK.CheckpointMismatch(
            f"checkpoint {args.resume!r} is at tensor {src['tensor']}, the "
            f"run at tensor {layout['tensor']}: a tensor degree change "
            f"would re-pad the vocab; reshard only moves stage boundaries "
            f"and virtual chunks")
    return src


def _resharded(args, src: dict, plan: ST.StagePlan, layout: dict,
               lead: bool = True) -> tuple:
    """The checkpoint to restore: ``--resume``'s, or, when its (stages,
    virtual) layout differs from the run's, its reshard into
    ``{resume}.to{S}v{V}`` (written here when ``lead``); and the
    reshard's seconds (None without one)."""
    if all(src.get(k) == layout[k] for k in (
            "stages", "virtual", "layers_per_stage", "n_layers_padded")):
        return args.resume, None
    path = f"{args.resume}.to{plan.n_stages}v{plan.virtual}"
    if not lead:
        return path, None
    t0 = time.perf_counter()
    RS.reshard_checkpoint(args.resume, path, plan)
    secs = time.perf_counter() - t0
    print(f"resharded checkpoint: stages{src['stages']} x virtual"
          f"{src.get('virtual', 1)} -> stages{plan.n_stages} x virtual"
          f"{plan.virtual} ({secs * 1e3:.1f} ms, {path})", flush=True)
    return path, secs


def _host_primed(opt_state: dict) -> dict:
    """2bw's ``primed`` back on the host, where the step reads it."""
    if "primed" in opt_state:
        opt_state["primed"] = opt_state["primed"].cpu()
    return opt_state


def _io_line(what: str, path: str, step: int, st: dict) -> str:
    gb = st["bytes"] / 1e9
    disk = st.get("write_s", st.get("read_s", 0.0))
    return (f"{what} {path} at step {step}: {st['bytes']} B, "
            f"{'device to host' if what == 'saved' else 'host to device'} "
            f"{st['copy_s'] * 1e3:.1f} ms, "
            f"{'disk write' if what == 'saved' else 'disk read'} "
            f"{disk * 1e3:.1f} ms ({gb / max(disk, 1e-9):.2f} GB/s)")


def _drift_inject(args, plan: ST.StagePlan):
    """``--drift-inject``'s factors (one a stage), or None; a wrong count
    is a usage error (SystemExit 2), as in the JAX CLI."""
    if not (args.drift_every and args.drift_inject):
        return None
    inject = [float(x) for x in args.drift_inject.split(",")]
    if len(inject) != plan.n_stages:
        _parser().error(f"--drift-inject needs {plan.n_stages} factors, "
                        f"got {len(inject)}")
    return inject


class _Drift:
    """``--drift-every``: every N steps the monitor
    (:class:`repro_torch.core.profiler.DriftMonitor` against
    ``planned_stage_costs``) gets ``measure_stage_times`` on ``device``,
    times the injected factors; once it trips, ``replan`` (under
    ``--replan-budget``) runs and its recommendation is printed, once,
    as the JAX CLI prints it.  The run itself goes on unchanged."""

    def __init__(self, args, cfg, plan: ST.StagePlan, inject, device):
        self.args, self.cfg, self.plan = args, cfg, plan
        self.inject, self.device = inject, device
        self.monitor = PF.DriftMonitor(
            planned=tuple(PF.planned_stage_costs(cfg, plan, seq=args.seq)),
            threshold=args.drift_threshold)
        self.drifts, self.line = [], None

    def after(self, step: int) -> None:
        args, cfg = self.args, self.cfg
        if self.line is not None or (step + 1) % args.drift_every:
            return
        measured = PF.measure_stage_times(cfg, self.plan,
                                          seq=min(args.seq, 64), iters=2,
                                          device=self.device)
        if measured is None:    # no proxy timing: no live signal
            measured = list(self.monitor.planned)
        if self.inject:
            measured = [m * f for m, f in zip(measured, self.inject)]
        drift = self.monitor.update(measured)
        self.drifts.append((step, drift))
        if not self.monitor.should_replan():
            return
        incumbent = AutoPlan(
            stages=cfg.stages, tensor=cfg.tensor,
            n_microbatches=args.microbatches, schedule=cfg.schedule,
            predicted_step_time=float("inf"), predicted_speedup_over_dp=1.0,
            virtual=cfg.virtual, mem_limit=cfg.mem_limit,
            data_axis=args.data)
        new = replan(cfg, incumbent, budget_s=args.replan_budget,
                     global_batch=args.batch, seq_len=args.seq,
                     slowdown=list(self.monitor.slowdown()))
        if new is incumbent:
            self.line = (f"drift {drift:.2f} at step {step}: replan kept "
                         f"the incumbent plan")
        else:
            self.line = (f"drift {drift:.2f} at step {step}: replan -> "
                         f"stages={new.stages} tensor={new.tensor} "
                         f"M={new.n_microbatches} sched={new.schedule} "
                         f"V={new.virtual} (predicted "
                         f"{new.predicted_step_time * 1e3:.2f} ms/step); "
                         f"restart with --resume to adopt")
        print(self.line, flush=True)

    def report(self) -> dict:
        return dict(drifts=self.drifts, replan=self.line)


#: the stub audio frontend's frames a batch row, as the JAX CLI feeds them
STUB_FRAMES = 64


def _batch(data: SyntheticLM, step: int, cfg, args, device) -> dict:
    """Step ``step``'s batch; for the audio family (whisper) with the
    stub frontend's frames, zeros ``[batch, 64, d_model]``, as the JAX
    CLI feeds them."""
    batch = data.batch(step)
    if cfg.family == "audio":
        batch["frames"] = torch.zeros((args.batch, STUB_FRAMES, cfg.d_model),
                                      device=device)
    return batch


def _dump_losses(args, start: int, losses: list) -> None:
    if args.losses_out:
        with open(args.losses_out, "w") as f:
            json.dump(dict(start=start, losses=losses), f)


def main(argv=None, mesh: MESH.StageMesh = None) -> dict:
    """Train as ``argv`` says, in one process, or as this process's stage
    of ``mesh`` (a group already set up, e.g. by
    :func:`repro_torch.launch.mesh.spawn_ranks`) or of the group that
    ``torchrun``'s environment describes (``WORLD_SIZE`` above 1)."""
    args = _parser().parse_args(argv)

    device = torch.device(args.device)
    cfg = build_config(args)
    under_ranks = mesh is not None or int(os.environ.get("WORLD_SIZE",
                                                         "1")) > 1
    if cfg.tensor > 1 and not under_ranks:
        raise ValueError(RT.tensor_needs_ranks(cfg.tensor, cfg.stages,
                                               args.data))
    if args.data > 1 and not under_ranks:
        raise ValueError(RT.data_needs_ranks(args.data, cfg.stages))
    plan = ST.plan_stages(cfg)
    layout = RS.layout_dict(plan, cfg.n_layers)
    src = _resume_layout(args, layout) if args.resume else None
    inject = _drift_inject(args, plan)
    opt = AdamW(lr=warmup_cosine(args.lr, 20, args.steps), weight_decay=0.01)
    pcfg = RT.PipelineConfig(n_microbatches=args.microbatches,
                             schedule=cfg.schedule, mem_limit=cfg.mem_limit,
                             remat=args.remat, runtime=cfg.runtime,
                             grad_sync=args.grad_sync or "auto",
                             ar_groups=args.ar_groups)
    elastic = (layout, src, inject)
    if mesh is None and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        MESH.check_world(plan.n_stages, int(os.environ["WORLD_SIZE"]),
                         args.data, plan.tensor)
        mesh = MESH.init_stage_group(
            args.dist_backend or ("nccl" if device.type == "cuda"
                                  else "gloo"), device.type, data=args.data,
            tensor=plan.tensor)
        ok = False
        try:
            out = _main_ranks(args, cfg, plan, opt, pcfg, mesh, elastic)
            ok = True
            return out
        finally:
            mesh = None         # the groups' last reference here
            MESH.destroy_groups(wait=ok)
    if mesh is not None:
        return _main_ranks(args, cfg, plan, opt, pcfg, mesh, elastic)
    step_fn = RT.make_train_step(cfg, plan, pcfg, optimizer=opt)
    params = ST.init_stacked_params(cfg, args.seed, plan, device=device)
    opt_state = opt.init(params)
    if pcfg.grad_sync == "2bw":
        opt_state = RT.init_2bw_state(opt_state, params)
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
    start, io = 0, dict(saves=[])
    if src is not None:
        path, io["reshard_s"] = _resharded(args, src, plan, layout)
        io["restore"] = {}
        state = CK.restore_checkpoint(path, dict(params=params,
                                                 opt=opt_state),
                                      device=device, stats=io["restore"])
        del params, opt_state       # the fresh state, before the steps
        params, opt_state = state["params"], _host_primed(state["opt"])
        del state
        start = CK.checkpoint_step(path)
        print(f"resumed from {path} at step {start}; "
              + _io_line("restored", path, start, io["restore"]),
              flush=True)
    drift = _Drift(args, cfg, plan, inject, device) if args.drift_every \
        else None
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq,
                       global_batch=args.batch, seed=args.seed,
                       device=str(device))
    counters = launch_counters()
    if device.type == "cuda":
        io["peak_setup_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
        torch.cuda.reset_peak_memory_stats(device)
    extra, saved = dict(layout=layout, arch=cfg.arch_id), [None]

    def save(step_done: int) -> None:
        st = CK.save_checkpoint(args.ckpt, dict(params=params, opt=opt_state),
                                step=step_done, extra=extra)
        saved[0] = step_done
        io["saves"].append(dict(st, step=step_done))
        print(_io_line("saved", args.ckpt, step_done, st), flush=True)

    losses, step_s, launches = [], [], []
    t_start = time.perf_counter()
    for step in range(start, args.steps):
        batch = _batch(data, step, cfg, args, device)
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
        if drift is not None:
            drift.after(step)
        if args.ckpt and args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            save(step + 1)
        if args.die_at and step + 1 >= args.die_at:
            _dump_losses(args, start, losses)
            print(f"fault injection: dying after step {step + 1}",
                  flush=True)
            raise SystemExit(17)
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
    print(f"kernel launches per step "
          f"{json.dumps(launches[-1] if launches else {})}")
    print("peak device memory " + (f"{peak:.2f} GiB" if peak is not None
                                   else "not measured (cpu)"))
    _dump_losses(args, start, losses)
    if args.ckpt and saved[0] != args.steps:    # unless just saved
        save(args.steps)
    return dict(plan=args.plan, schedule=step_fn.lowering.schedule,
                stages=plan.n_stages, virtual=plan.virtual,
                microbatches=args.microbatches, start=start,
                losses=losses, step_s=step_s, wall_s=wall,
                tok_per_step=args.batch * args.seq, launches=launches,
                stash_slots=step_fn.stash_slots, n_x=step_fn.lowering.n_x,
                live_registers=step_fn.live_registers, runtime=pcfg.runtime,
                peak_gib=peak, io=io,
                drift=None if drift is None else drift.report(),
                params=params, opt_state=opt_state)


def _main_ranks(args, cfg, plan: ST.StagePlan, opt: AdamW,
                pcfg: RT.PipelineConfig, mesh: MESH.StageMesh,
                elastic: tuple) -> dict:
    """:func:`main` as stage ``mesh.stage`` of replica ``mesh.data_rank``
    of the rank executor."""
    MESH.check_world(plan.n_stages, mesh.world, mesh.data, plan.tensor)
    if args.data != mesh.data:
        raise ValueError(f"--data {args.data} on a grid of {mesh.data} "
                         f"replicas")
    if plan.tensor != mesh.tensor:
        raise ValueError(f"tensor {plan.tensor} on a grid of tensor "
                         f"{mesh.tensor}")
    layout, src, inject = elastic
    device, rank = mesh.device, mesh.rank
    lead = rank == 0
    gather = lambda obj: MESH.gather(obj, mesh)
    step_fn = RT.make_train_step(cfg, plan, pcfg, optimizer=opt, group=mesh)
    params = ST.init_stage_params(cfg, args.seed, plan, mesh.stage,
                                  tensor_rank=mesh.tensor_rank, device=device)
    opt_state = opt.init(params)
    if pcfg.grad_sync == "2bw":
        opt_state = RT.init_2bw_state(opt_state, params)
    n_params = gather(sum(x.numel() for x in ST.tree_leaves(params)))
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    if lead:
        print(f"arch={cfg.arch_id} layers={cfg.n_layers} d={cfg.d_model} "
              f"stages={plan.n_stages}x{plan.layers_per_stage} "
              f"V={plan.virtual} schedule={step_fn.lowering.schedule} "
              f"M={args.microbatches} ranks={mesh.world} "
              f"backend={mesh.backend} (data {mesh.data} x stages "
              f"{plan.n_stages} x tensor {plan.tensor}, grad_sync "
              f"{pcfg.grad_sync}) params per rank "
              f"{[round(n / 1e6, 1) for n in n_params]}M device={device} "
              f"({name})", flush=True)
    if device.type == "cuda":
        if lead:
            build.build_all()   # kernel builds before the first step
        dist.barrier()          # the other ranks load what rank 0 built
    start, io = 0, dict(saves=[])
    if src is not None:
        # rank 0 reshards (when the layout moved); every rank then cuts
        # its own share from the file
        path, io["reshard_s"] = _resharded(args, src, plan, layout, lead)
        if path != args.resume:
            dist.barrier()
        io["restore"] = {}
        state = CK.restore_rank_share(path, dict(params=params,
                                                 opt=opt_state),
                                      mesh, cfg, plan, device=device,
                                      stats=io["restore"])
        del params, opt_state
        params, opt_state = state["params"], _host_primed(state["opt"])
        del state
        start = CK.checkpoint_step(path)
        restored = gather(io["restore"])
        if lead:
            print(f"resumed from {path} at step {start}; per rank: "
                  + "; ".join(_io_line("restored", path, start, st)
                              for st in restored), flush=True)
    drift = (_Drift(args, cfg, plan, inject, device)
             if args.drift_every and lead else None)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq,
                       global_batch=args.batch, seed=args.seed,
                       device=str(device))
    counters = launch_counters()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    extra, saved = dict(layout=layout, arch=cfg.arch_id), [None]

    def save(step_done: int) -> None:
        st = CK.save_rank_shares(args.ckpt, dict(params=params,
                                                 opt=opt_state),
                                 mesh, cfg, plan, step=step_done,
                                 extra=extra)
        saved[0] = step_done
        if lead:
            io["saves"].append(dict(st, step=step_done))
            print(_io_line("saved", args.ckpt, step_done, st)
                  + f", {st['total_s'] * 1e3:.1f} ms in all (gathered "
                    f"leaf by leaf from {mesh.world // mesh.data} ranks)",
                  flush=True)

    losses, step_s, launches, transport = [], [], [], []
    t_start = time.perf_counter()
    for step in range(start, args.steps):
        batch = _batch(data, step, cfg, args, device)
        before = {k: getattr(fn, a) for k, (fn, a) in counters.items()}
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dist.barrier()          # every rank starts the step together
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
        if drift is not None:
            drift.after(step)
        if args.ckpt and args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            save(step + 1)
        if args.die_at and step + 1 >= args.die_at:
            if lead:
                _dump_losses(args, start, losses)
                print(f"fault injection: dying after step {step + 1}",
                      flush=True)
            raise SystemExit(17)
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
              f"{json.dumps(launches[-1] if launches else {})}")
        print("peak device memory per rank " + (
            ", ".join(f"{p:.2f} GiB" for p in peak) if device.type == "cuda"
            else "not measured (cpu)"))
        how = mesh.backend + (", host-staged" if mesh.backend == "gloo"
                              and device.type == "cuda" else "")
        for r, st in enumerate(transport[-1] if transport else []):
            print(f"transport rank {r} ({how}) last step: " + ", ".join(
                      f"{k} {c} msgs {b} B {sec * 1e3:.1f} ms (post "
                      f"{post * 1e3:.1f}, receive waits {rw * 1e3:.1f}, send "
                      f"waits {sw * 1e3:.1f}, copies {cp * 1e3:.1f} ms)"
                      for k, (c, b, sec, cp, post, rw, sw) in st.items()
                      if c), flush=True)
        _dump_losses(args, start, losses)
    if args.ckpt and saved[0] != args.steps:    # unless just saved
        save(args.steps)
    return dict(plan=args.plan, schedule=step_fn.lowering.schedule,
                stages=plan.n_stages, virtual=plan.virtual,
                microbatches=args.microbatches, rank=rank, world=mesh.world,
                data=mesh.data, tensor=mesh.tensor, grad_sync=pcfg.grad_sync,
                backend=mesh.backend, start=start, losses=losses,
                step_s=step_s, wall_s=wall,
                tok_per_step=args.batch * args.seq,
                launches=launches, stash_slots=stash,
                n_x=step_fn.lowering.n_x, live_registers=live,
                runtime=pcfg.runtime,
                peak_gib=None if peak[0] is None else max(peak),
                peak_gib_by_rank=peak, transport=transport, io=io,
                drift=None if drift is None else drift.report(),
                params=params, opt_state=opt_state)


if __name__ == "__main__":
    main()
