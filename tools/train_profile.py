#!/usr/bin/env python3
"""Where a pipelined training step's time goes, on one card.

    python3 tools/train_profile.py            # llama3.2-1b, full width
    python3 tools/train_profile.py --schedule zb-h1
    python3 tools/train_profile.py --schedule 1f1b-interleaved --virtual 2
    python3 tools/train_profile.py --arch mamba2-2.7b   # SSD fwd + bwd

Builds the training path of ``repro_torch.launch.train`` (full published
width unless ``--layers`` cuts the depth; random weights from seed 0;
SyntheticLM batches; AdamW), runs one warm-up step, then measures one step
three ways:

* host wall time of the step (ending in ``torch.cuda.synchronize()``);
* CUDA-event spans around each kind of work, recorded on the stream by
  wrappers around the functions the executor calls: the stage forward of
  the F ticks (``apply_stage`` without grad), the stage recompute of the
  B/W ticks (``apply_stage`` under grad), the loss head's forward
  (``logits_and_xent``), every backward (``torch.autograd.grad``: the
  stage backwards with their flash backward launches, the head's, the
  embedding's) and the optimizer update.  A span is device time between
  its two events, idle gaps inside it included;
* ``torch.profiler`` over a second step: device time per CUDA kernel,
  summed into GEMMs (cuBLAS), the flash forward and backward, the SSD
  forward and backward and everything else, and the device's busy share
  of the step's wall time;
* the peak device memory over the measured step.

It also times the loss head (final norm, logits over the whole vocab,
cross-entropy, forward and backward) alone on one micro-batch.  One JSON
line per measurement; the last line names the card.
"""
import argparse
import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def kernel_category(name: str) -> str:
    if name.startswith("flash_bwd"):
        return "flash backward"
    if re.match(r"flash_(prefill|decode|combine)", name):
        return "flash forward"
    # the SSD backward's kernels, its readout state (the chunk-states
    # kernel's GRAD form) included
    if name.startswith("ssd_bwd") or re.match(r"ssd_states_kernel<.*true>",
                                              name):
        return "SSD backward"
    if name.startswith("ssd_"):
        return "SSD forward"
    if re.search(r"gemm|xmma|cutlass|sm90_|Kernel2", name, re.I):
        return "GEMM (cuBLAS)"
    return "other (elementwise, reductions, gathers, copies)"


class Spans:
    """CUDA-event spans per label, recorded around wrapped calls."""

    def __init__(self):
        self.events: dict = {}
        self.on = False

    @contextlib.contextmanager
    def span(self, label: str):
        if not self.on:
            yield
            return
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        try:
            yield
        finally:
            t1.record()
            self.events.setdefault(label, []).append((t0, t1))

    def wrap(self, fn, label):
        def wrapped(*a, **kw):
            lab = label(*a, **kw) if callable(label) else label
            with self.span(lab):
                return fn(*a, **kw)
        return wrapped

    def totals(self) -> dict:
        torch.cuda.synchronize()
        return {k: dict(ms=sum(a.elapsed_time(b) for a, b in v), calls=len(v))
                for k, v in self.events.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--schedule", default="1f1b")
    ap.add_argument("--virtual", type=int, default=1)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("tools/train_profile.py: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import build
    from repro_torch.models import layers as LYR
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamW, warmup_cosine
    from repro_torch.pipeline import runtime as RT
    from repro_torch.pipeline import stage as ST

    cfg = get_config(args.arch)
    cfg = dataclasses.replace(cfg, n_layers=args.layers or cfg.n_layers,
                              stages=args.stages, tensor=1,
                              virtual=args.virtual)
    plan = ST.plan_stages(cfg)
    dev = torch.device("cuda")
    spans = Spans()
    # wrap what the executor calls (module attributes, looked up per call)
    RT.apply_stage = spans.wrap(
        RT.apply_stage, lambda *a, **k: "stage recompute (B/W ticks)"
        if torch.is_grad_enabled() else "stage forward (F ticks)")
    M.logits_and_xent = spans.wrap(M.logits_and_xent, "head forward")
    grad = torch.autograd.grad
    torch.autograd.grad = spans.wrap(grad, "backward (autograd.grad)")
    opt = AdamW(lr=warmup_cosine(3e-3, 20, 100), weight_decay=0.01)
    opt_update = opt.update
    object.__setattr__(opt, "update", spans.wrap(opt_update, "AdamW update"))
    step = RT.make_train_step(cfg, plan, RT.PipelineConfig(
        n_microbatches=args.microbatches, schedule=args.schedule),
        optimizer=opt)
    params = ST.init_stacked_params(cfg, 0, plan, device=dev)
    state = opt.init(params)
    data = SyntheticLM(cfg.vocab, args.seq, args.batch, device="cuda")
    build.build_all()
    params, state, m = step(params, state, data.batch(0))     # warm-up
    torch.cuda.synchronize()

    spans.on = True
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, state, m = step(params, state, data.batch(1))
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    spans.on = False
    tot = spans.totals()
    print(json.dumps(dict(
        what="step", schedule=args.schedule, stages=args.stages,
        virtual=args.virtual,
        layers=cfg.n_layers, microbatches=args.microbatches,
        batch=args.batch, seq=args.seq, wall_ms=wall,
        tok_s=args.batch * args.seq / wall * 1e3, loss=float(m["loss"]),
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        spans=tot, spans_sum_ms=sum(v["ms"] for v in tot.values()))),
        flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, m = step(params, state, data.batch(2))
        torch.cuda.synchronize()
        wall2 = 1e3 * (time.perf_counter() - t0)
    kern: dict = {}
    for e in prof.events():             # device events only: kernels, copies
        if e.device_type == DeviceType.CUDA:
            name = re.sub(r"^void |\(anonymous namespace\)::", "", e.name)
            kern[name] = kern.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    cats: dict = {}
    for name, ms in kern.items():
        c = kernel_category(name)
        cats[c] = cats.get(c, 0.0) + ms
    busy = sum(kern.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:15]
    print(json.dumps(dict(
        what="kernels", wall_ms_profiled=wall2, device_busy_ms=busy,
        device_idle_share=1 - busy / wall2, by_category_ms=cats,
        top=[dict(kernel=k[:90], ms=v) for k, v in top])), flush=True)

    # the loss head alone, one micro-batch, forward and backward
    mb = args.batch // args.microbatches
    x = torch.randn(mb, args.seq, cfg.d_model, device=dev)
    labels = data.batch(3)["labels"][:mb]
    head = params.get("head", params["embed"])

    def head_fb():
        xx = x.detach().requires_grad_()
        hd = head.detach().requires_grad_()
        fn = params["final_norm"].detach().requires_grad_()
        h = LYR.rms_norm(xx, fn, cfg.norm_eps)
        loss = M.logits_and_xent(cfg, {"embed": hd}, h, labels)
        return grad(loss, [xx, hd, fn])

    for _ in range(2):
        head_fb()
    e0, e1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(5):
        head_fb()
    e1.record()
    torch.cuda.synchronize()
    per = e0.elapsed_time(e1) / 5
    print(json.dumps(dict(what="loss head alone", microbatch=mb,
                          vocab=head.shape[0], fwd_bwd_ms=per,
                          per_step_ms=per * args.microbatches)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(json.dumps({"card": smi.stdout.strip(),
                      "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
