#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each reported on its own lines:

1. the card's name and power limit (``nvidia-smi``);
2. building every CUDA kernel of the serving path from ``src/repro_torch/
   kernels/csrc`` with nvcc (one compiler per source, all started together),
   then reading the libraries' machine code (``cuobjdump -sass``): every
   flash prefill-route kernel must issue tensor-core products (HMMA, from
   mma.sync) and both routes' kernels must load through cp.async
   (LDGSTS); so must the backward's dK/dV and dQ kernels of the f32 and
   bf16 builds at D = 64, and every SSD product kernel (scores, chunk
   states, chunk outputs) of the f32 and bf16 builds at P = 64;
3. each kernel against its plain PyTorch version on the card, at the
   shapes of the JAX kernel tests and at the serving path's shapes, with
   the kernel's device time (``ms``, CUDA-graph replay), its eager
   per-call time (``call_ms``, host issue included), the plain version's
   and one library call's device time (``scaled_dot_product_attention``,
   a yardstick the port never calls) and the least time the card could
   take (``bound_ms``: f32 operations at 67 TFLOP/s outside the tensor
   cores; ``bound_tc_ms``: f32 operations at 495/3 TFLOP/s, the 3xTF32
   tensor-core rate; bf16 at 989 in both).  Each flash row names the
   route its shapes take (``decode`` for T * Hq / Hkv <= 16, else
   ``prefill``); the decode route is also run over S = 4096, many splits;
   the training path's forward (batch 2, T = S = 1024, 32/8 heads, D 64,
   causal) is timed without and with the per-row statistics, and checked
   at phase 13's one-row micro-batch as well;
4. ``repro_torch.launch.serve.main`` at the full width of llama3.2-1b
   (16 layers, 8 stages, 2 micro-batches, batch 8, prompt 512, 32 tokens,
   f32), with each kernel's launch count over that run (flash attention
   exactly 1024: 32 on the prefill route and 992 on the decode route; the
   SSD scan 0);
5. the whole llama path, kernel against plain: the same serve at full
   width and 2 layers on the card and on the CPU with the same weights and
   teacher-forced tokens, logits of every step compared; the card's
   decode steps run with synchronizing calls made errors;
6. the SSD scan against its plain version on the card (as phase 3: the
   JAX kernel tests' shapes, a nonzero initial state with y and the final
   state checked, and the serving path's shape in f32 and bf16; no single
   PyTorch call computes the scan, so no library time); the serving
   path's rows add the device time of each of the scan's four CUDA
   kernels (``kernel_us``, ``torch.profiler``);
7. ``repro_torch.launch.serve.main`` at the full width of mamba2-2.7b
   (64 layers, 16 stages, 2 micro-batches, batch 8, prompt 512 = two SSD
   chunks, 32 tokens, f32): the SSD scan exactly 128 launches (prefill
   only), flash attention 0 (on either route);
8. the whole mamba2 path, kernel against plain, as phase 5 (2 layers, 2
   stages, batch 4, prompt 512, 8 teacher-forced steps);
9. the flash-attention backward kernel against its plain version
   (``attend_bwd_ref``) and against torch autograd of ``attend_ref``, at
   phase 3's shapes (through a head axis of one), the per-row cases with
   an idle row, and the training shapes (batch 2 and 1, T = S = 1024, 32/8
   heads, D 64, causal), in f32 and bf16 (relative to max |ref|: 1e-4, 3e-2); a
   second call must give the same bits; the library time is the backward
   of ``scaled_dot_product_attention`` (eager, CUDA events); the training
   shape's rows add the device time of each of the backward's three CUDA
   kernels (``kernel_us``, ``torch.profiler``);
10. ``repro_torch.launch.train.main`` at the full width of llama3.2-1b
   (16 layers, 4 stages x 4 layers, 1f1b, 4 micro-batches, batch 8, seq
   1024, f32, 3 steps): finite losses, step 0's loss against a
   non-pipelined ``loss_fn`` on the card with the same weights (1e-4),
   exactly 128 forward (prefill route) and 64 backward flash launches a
   step, and the residual stash at ``lower_to_ticks(...).n_x``;
11. training parity: at full width and 3 layers, gpipe / 1f1b / dapple /
   zb-h1 / 1f1b-interleaved-memlean (V 2) / zb-auto (mem_limit 2, M 4) /
   1f1b under remat 'full' agree with each other (loss and gradients,
   1e-5 relative) and with one non-pipelined autograd pass of the
   plain-attention model on the card (the JAX harness's bar: loss 1e-4,
   gradients 1e-4), each with exactly the flash launches its table and
   remat imply; whether remat 'full' equals the stage recompute bit for
   bit is recorded; then a reduced model (3 layers, d 256) trains one step
   on the card and on the CPU with the same weights (loss 1e-4, gradients
   1e-4) under 1f1b, the memlean interleave, the capped zb-auto and remat
   'full';
12. as phase 10 under 1f1b-interleaved with 2 chunks a stage (4 stages x
   2 chunks x 2 layers, 4 micro-batches): exactly 128 forward (64 of them
   with statistics) and 64 backward flash launches a step;
13. as phase 10 under zb-h2 with 8 micro-batches (its caps 7/5/5/6
   resident residuals; at 4 micro-batches every cap would be 4 = M and
   zb-h2 the unbounded zb-auto): exactly 384 forward (256 with
   statistics: the B and W ticks each re-run the stage) and 256 backward
   flash launches a step.

Every kernel's launch counters (``launches`` and, for flash attention,
``launches_prefill`` / ``launches_decode`` / ``launches_bwd``) are set to
0 just before each driven path (phases 4, 7, 10, 12 and 13, and each run
of phase 11) and read just after it.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``, printed only when every phase passed.
Exits non-zero without a CUDA card or outside a checkout.
"""
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PEAK_BYTES_S = 3.35e12                         # H100 SXM HBM3, data sheet
PEAK_OPS_S = {torch.float32: 67e12,            # f32 outside tensor cores
              torch.bfloat16: 989e12}          # bf16 dense tensor cores
# f32 products on the tensor cores as split-precision TF32 (three TF32
# products per f32 product: 495 / 3 TFLOP/s); bf16 as above
PEAK_OPS_TC_S = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}   # the JAX kernel tests'
# the backward, relative to max |ref|: f32 at the JAX harness's gradient
# bar; bf16 as the forward
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# whole-path parity, card vs CPU, f32: cuBLAS and the CPU sum the d_ff=8192
# and vocab-wide products in another order; the error stays ~1e-6 relative
# per layer, so 2e-4 (the port-vs-JAX CPU tolerance) leaves a wide margin
PATH_TOL = 2e-4


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def time_ms(fn, iters: int = 20) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in a
    CUDA graph, replayed between two CUDA events, so the host's cost of
    issuing the launches (Python, the wrapper's checks) is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):           # lazy set-up outside capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def call_ms(fn, iters: int = 20) -> float:
    """Time of one eager call of ``fn`` back to back, host issue included
    (what the serving loop pays per call)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def bounds(nbytes: float, ops: float, dtype) -> dict:
    """Least time (ms) for ``nbytes`` moved and ``ops`` done on the card:
    ``bound_ms`` at PEAK_OPS_S, ``bound_tc_ms`` at PEAK_OPS_TC_S, and which
    of bytes or operations sets ``bound_ms``."""
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops, t_tc = ops / PEAK_OPS_S[dtype], ops / PEAK_OPS_TC_S[dtype]
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_tc_ms=1e3 * max(t_bytes, t_tc))


def attention_bound(q, k, q_start, kv_len, causal) -> dict:
    """Least time (ms) for attention of these inputs on the card
    (:func:`bounds`).  Bytes: q read and the output written once, K/V
    read once for the keys some row of the batch row can see.  Operations:
    4*D per visible query-key pair (q.k and p.v), counted for this data;
    a row that sees no key averages V over all S keys."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    qs, kl = q_start.cpu().long(), kv_len.cpu().long().clamp(max=S)
    qpos = qs[:, None] + torch.arange(T)[None]
    seen = kl[:, None].expand(B, T)
    if causal:
        seen = torch.minimum(seen, qpos + 1)
    seen = torch.where(seen <= 0, torch.full_like(seen, S), seen)
    el = q.element_size()
    keys = seen.max(dim=1).values.sum().item()
    nbytes = 2 * q.numel() * el + 2 * keys * Hkv * D * el
    ops = 4 * D * Hq * seen.sum().item()
    return bounds(nbytes, ops, q.dtype)


def library_attention(q, k, v, q_start, kv_len, causal, scale):
    """scaled_dot_product_attention on the same work (mask built here,
    outside the timed call); the yardstick, never used by the port."""
    B, T, Hq, D = q.shape
    S = k.shape[1]
    kpos = torch.arange(S, device=q.device)
    qpos = q_start.long()[:, None] + torch.arange(T, device=q.device)[None]
    mask = kpos[None, None, :] < kv_len.long()[:, None, None]
    if causal:
        mask = mask & (kpos[None, None, :] <= qpos[:, :, None])
    mask = mask[:, None]                               # [B,1,T,S]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qt, kt, vt, attn_mask=mask, scale=scale,
                        enable_gqa=True)


def event_ms(fn, iters: int = 10) -> float:
    """Time of one eager call of ``fn`` between two CUDA events over
    ``iters`` calls (for calls that a CUDA graph should not capture, such
    as an autograd backward)."""
    for _ in range(3):
        fn()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def backward_bound(q, k, q_start, kv_len, causal) -> dict:
    """Least time (ms) for the attention backward of these inputs
    (:func:`bounds`).  Bytes: q, the output and its gradient read once and
    dq written once; k and v read once for the keys some row of the batch
    row sees, dk and dv written once for all S keys; the f32 statistics
    read once.  Operations, counted for this data: 10*D per visible
    query-key pair (the scores recomputed, dP, dV, dQ, dK: a multiply-add
    over D each), 2*D per key for a row that sees no key (its dV share)."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    qs, kl = q_start.cpu().long(), kv_len.cpu().long().clamp(max=S)
    qpos = qs[:, None] + torch.arange(T)[None]
    seen = kl[:, None].expand(B, T)
    if causal:
        seen = torch.minimum(seen, qpos + 1)
    idle = seen <= 0
    el = q.element_size()
    keys = torch.where(idle.any(1), S, seen.max(1).values).sum().item()
    nbytes = (4 * q.numel() * el + 2 * keys * Hkv * D * el
              + 2 * B * S * Hkv * D * el + B * Hq * T * 4)
    ops = Hq * D * (10 * seen.clamp(min=0).sum().item()
                    + 2 * S * idle.sum().item())
    return bounds(nbytes, ops, q.dtype)


def library_attention_bwd(q, k, v, dout, q_start, kv_len, causal, scale):
    """The backward of scaled_dot_product_attention on the same work
    (``is_causal`` where the mask is the plain causal one, else the mask
    built here); the yardstick, never used by the port."""
    B, T, Hq, D = q.shape
    S = k.shape[1]
    leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    plain_causal = (causal and T == S and bool((q_start == 0).all())
                    and bool((kv_len >= S).all()))
    if plain_causal:
        out = sdpa(*leaves, is_causal=True, scale=scale, enable_gqa=True)
    else:
        kpos = torch.arange(S, device=q.device)
        qpos = q_start.long()[:, None] + torch.arange(T, device=q.device)[None]
        mask = kpos[None, None, :] < kv_len.long()[:, None, None]
        if causal:
            mask = mask & (kpos[None, None, :] <= qpos[:, :, None])
        out = sdpa(*leaves, attn_mask=mask[:, None], scale=scale,
                   enable_gqa=True)
    dot = dout.transpose(1, 2)
    return lambda: torch.autograd.grad(out, leaves, dot, retain_graph=True)


def sass_counts(build, name: str, prefix: str, dim: str) -> dict:
    """Counts of tensor-core products (HMMA) and cp.async loads (LDGSTS) in
    each kernel ``<prefix>_<kind>_kernel<dtype[, size]>`` of the built
    library ``name``, keyed ``kind dtype <dim>=size`` (``kind dtype`` for a
    kernel with no size); None when the toolkit has no cuobjdump."""
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        fn = re.search(rf"Function : \S*{prefix}_(\w+?)_kernel"
                       r"(?:I(f|13__nv_bfloat16)(?:Li(\d+)E)?)?", line)
        if fn:
            cur = " ".join(
                [fn[1]] + ([f"{'f32' if fn[2] == 'f' else 'bf16'}"]
                           if fn[2] else [])
                + ([f"{dim}={fn[3]}"] if fn[3] else []))
            counts[cur] = dict(HMMA=0, LDGSTS=0)
        elif "Function : " in line:
            cur = None
        elif cur:
            for op in ("HMMA", "LDGSTS"):
                counts[cur][op] += bool(re.search(rf"\b{op}\b", line))
    return counts


def kernel_us(fn, calls: int = 50) -> dict:
    """Mean device time (us) per call of each CUDA kernel that ``fn``
    launches (``torch.profiler``), keyed by the kernel's name with its
    template arguments."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        total = getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0))
        if total > 0:
            key = re.sub(r"^void |\(anonymous namespace\)::", "", e.key)
            out[key.split("(")[0][:60]] = total / calls
    return out


def phase_kernels(FA, results: list) -> list:
    """Phase 3: the flash kernel against its plain version."""
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    rnd = lambda *s, dt: torch.randn(*s, generator=g).to(dev, dt)
    bad = []

    def run(label, q, k, v, q_start, kv_len, causal, kern, plain, dtype):
        scale = q.shape[-1] ** -0.5
        out = kern()
        torch.cuda.synchronize()
        ref = plain()
        err = (out.float() - ref.float()).abs().max().item()
        ok = err <= TOL[dtype] and bool(torch.isfinite(out).all())
        q4 = q if q.dim() == 4 else q.unsqueeze(2)
        k4 = k if k.dim() == 4 else k.unsqueeze(2)
        v4 = v if v.dim() == 4 else v.unsqueeze(2)
        row = dict(label=label, dtype=str(dtype).replace("torch.", ""),
                   route=FA.route(q4.shape[1], q4.shape[2], k4.shape[2]),
                   max_abs_err=err, tol=TOL[dtype], ms=time_ms(kern),
                   call_ms=call_ms(kern), plain_ms=time_ms(plain),
                   library_ms=time_ms(library_attention(
                       q4, k4, v4, q_start, kv_len, causal, scale)),
                   **attention_bound(q4, k4, q_start, kv_len, causal),
                   ok=ok)
        print("kernel " + json.dumps(row), flush=True)
        results.append(row)
        if not ok:
            bad.append(label)

    for dtype in (torch.float32, torch.bfloat16):
        # the shapes of tests/test_kernels.py, through the Pallas-signature
        # wrapper [BH, T, D]; then its kv_len case
        for BH, T, S, D, causal in ((4, 128, 128, 64, True),
                                    (2, 256, 256, 64, True),
                                    (2, 100, 100, 32, True),
                                    (3, 64, 256, 128, False),
                                    (2, 1, 256, 64, False),
                                    (1, 512, 512, 128, True)):
            q, k, v = rnd(BH, T, D, dt=dtype), rnd(BH, S, D, dt=dtype), \
                rnd(BH, S, D, dt=dtype)
            zs = torch.zeros(BH, dtype=torch.int32, device=dev)
            fs = torch.full((BH,), S, dtype=torch.int32, device=dev)
            kw = dict(scale=D ** -0.5, causal=causal)
            run(f"test_kernels BH={BH} T={T} S={S} D={D} causal={causal}",
                q, k, v, zs, fs, causal,
                lambda: FA.flash_attention(q, k, v, **kw),
                lambda: FA.flash_attention_ref(q, k, v, **kw), dtype)
        q, k, v = rnd(2, 1, 64, dt=dtype), rnd(2, 128, 64, dt=dtype), \
            rnd(2, 128, 64, dt=dtype)
        kw = dict(scale=0.125, causal=False, kv_len=40)
        run("test_kernels kv_len=40", q, k, v,
            torch.zeros(2, dtype=torch.int32, device=dev),
            torch.full((2,), 40, dtype=torch.int32, device=dev), False,
            lambda: FA.flash_attention(q, k, v, **kw),
            lambda: FA.flash_attention_ref(q, k, v, **kw), dtype)

    # the serving path's shapes (llama3.2-1b: 32 q heads, 8 kv heads, D 64)
    # at batch 8 and at the main path's micro-batch of 4 rows; then per-row
    # offsets with an idle row (kv_len = 0: averages V over all S keys),
    # and the decode route over a long cache (16 splits of 256 keys)
    for label, B, T, S, q_start, kv_len in (
            ("prefill B=8", 8, 512, 544, [0] * 8, [512] * 8),
            ("main-path prefill B=4", 4, 512, 544, [0] * 4, [512] * 4),
            ("main-path decode B=4 per-row", 4, 1, 544, [527, 520, 300, 543],
             [528, 521, 301, 544]),
            ("idle row B=3 per-row", 3, 4, 544, [0, 9, 3], [4, 13, 0]),
            ("long decode B=4 per-row", 4, 1, 4096, [4095, 4000, 2500, 1000],
             [4096, 4001, 2501, 1001]),
            ("train B=2", 2, 1024, 1024, [0, 0], [1024, 1024]),
            ("train B=2 with statistics", 2, 1024, 1024, [0, 0],
             [1024, 1024]),
            # phase 13's micro-batch (zb-h2, M 8: one row)
            ("train B=1", 1, 1024, 1024, [0], [1024]),
            ("train B=1 with statistics", 1, 1024, 1024, [0], [1024])):
        for dtype in (torch.float32, torch.bfloat16):
            q = rnd(B, T, 32, 64, dt=dtype)
            k, v = rnd(B, S, 8, 64, dt=dtype), rnd(B, S, 8, 64, dt=dtype)
            qs = torch.tensor(q_start, dtype=torch.int32, device=dev)
            kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
            kw = dict(scale=0.125, causal=True, q_start=qs, kv_len=kl)
            # the training path's forward saves the statistics (a template
            # variant of the prefill route)
            lse = dict(return_lse=True) if "statistics" in label else {}
            run(f"{label} T={T} S={S} Hq=32 Hkv=8 D=64", q, k, v, qs, kl,
                True, lambda: (FA.flash_attend(q, k, v, **lse, **kw)[0]
                               if lse else FA.flash_attend(q, k, v, **kw)),
                lambda: FA.attend_ref(q, k, v, **kw), dtype)
    return bad


def phase_backward(FA, results: list) -> list:
    """Phase 9: the flash backward kernel against its plain version
    (attend_bwd_ref, from the kernel forward's output and statistics) and
    against torch autograd of attend_ref; a second call must give the same
    bits.  Errors are max |got - ref| / max |ref| over dq, dk and dv."""
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    rnd = lambda *s, dt: torch.randn(*s, generator=g).to(dev, dt)
    rel = lambda a, b: ((a.float() - b.float()).abs().max()
                        / (b.float().abs().max() + 1e-12)).item()
    # (label, B, T, S, Hq, Hkv, D, causal, q_start, kv_len)
    cases = [(f"test_kernels BH={BH} T={T} S={S} D={D} causal={c}",
              BH, T, S, 1, 1, D, c, [0] * BH, [S] * BH)
             for BH, T, S, D, c in ((4, 128, 128, 64, True),
                                    (2, 256, 256, 64, True),
                                    (2, 100, 100, 32, True),
                                    (3, 64, 256, 128, False),
                                    (2, 1, 256, 64, False),
                                    (1, 512, 512, 128, True))]
    cases += [("test_kernels kv_len=40", 2, 1, 128, 1, 1, 64, False, [0, 0],
               [40, 40]),
              ("decode B=4 per-row", 4, 1, 544, 32, 8, 64, True,
               [527, 520, 300, 543], [528, 521, 301, 544]),
              ("idle row B=3 per-row", 3, 4, 544, 32, 8, 64, True,
               [0, 9, 3], [4, 13, 0]),
              ("train B=2 T=S=1024", 2, 1024, 1024, 32, 8, 64, True,
               [0, 0], [1024, 1024]),
              ("train B=1 T=S=1024", 1, 1024, 1024, 32, 8, 64, True,
               [0], [1024])]
    bad = []
    for label, B, T, S, Hq, Hkv, D, causal, q_start, kv_len in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, do = rnd(B, T, Hq, D, dt=dtype), rnd(B, T, Hq, D, dt=dtype)
            k, v = rnd(B, S, Hkv, D, dt=dtype), rnd(B, S, Hkv, D, dt=dtype)
            qs = torch.tensor(q_start, dtype=torch.int32, device=dev)
            kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
            kw = dict(scale=D ** -0.5, causal=causal, q_start=qs, kv_len=kl)
            out, lse = FA.flash_attend(q, k, v, return_lse=True, **kw)
            kern = lambda: FA.flash_attend_bwd(q, k, v, out, lse, do, **kw)
            plain = lambda: FA.attend_bwd_ref(q, k, v, out, lse, do, **kw)
            got = kern()
            again = kern()
            torch.cuda.synchronize()
            bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
            want = plain()
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            auto = torch.autograd.grad(FA.attend_ref(*leaves, **kw), leaves,
                                       do)
            err = max(rel(a, b) for a, b in zip(got, want))
            err_auto = max(rel(a, b) for a, b in zip(got, auto))
            ok = (max(err, err_auto) <= BWD_TOL[dtype] and bitwise
                  and all(bool(torch.isfinite(x.float()).all()) for x in got))
            row = dict(label=f"{label} Hq={Hq} Hkv={Hkv}",
                       dtype=str(dtype).replace("torch.", ""),
                       max_abs_err=max((a.float() - b.float()).abs().max()
                                       .item() for a, b in zip(got, want)),
                       rel_err=err, rel_err_autograd=err_auto,
                       tol=BWD_TOL[dtype], bitwise=bitwise,
                       ms=time_ms(kern), call_ms=call_ms(kern),
                       plain_ms=time_ms(plain),
                       library_ms=event_ms(library_attention_bwd(
                           q, k, v, do, qs, kl, causal, D ** -0.5)),
                       **backward_bound(q, k, qs, kl, causal), ok=ok)
            if label.startswith("train"):
                # device time of each of the backward's CUDA kernels
                row["kernel_us"] = us = kernel_us(kern)
                if sorted(k_.split("<")[0] for k_ in us) != [
                        "flash_bwd_delta_kernel", "flash_bwd_dkdv_kernel",
                        "flash_bwd_dq_kernel"]:
                    fail(f"flash backward at the training shape: profiler "
                         f"shows {us}")
            print("kernel " + json.dumps(row), flush=True)
            results.append(row)
            if not ok:
                bad.append(f"{row['label']} {row['dtype']}")
            del q, k, v, do, out, lse, got, again, want, auto, leaves
    return bad


def ssd_bound(x, N: int, chunk: int, init_state: bool) -> dict:
    """Least time (ms) for the SSD scan of these inputs on the card
    (:func:`bounds`).  Bytes: x, dt, Bm, Cm read and y written once;
    the initial state read (when given) and the final state written (f32).
    Operations: the chunked decomposition's products at this chunk size,
    2 flops per multiply-add: per (row, chunk, head) the intra-chunk
    product over the c(c+1)/2 causal pairs x P, the chunk state c x P x N
    and the carried-state readout c x N x P; per (row, chunk) the scores
    C.B^T over the c(c+1)/2 causal pairs x N (shared by all heads)."""
    B, T, H, P = x.shape
    el, nc, c = x.element_size(), T // chunk, chunk
    pairs = c * (c + 1) // 2
    state = B * H * P * N * 4
    nbytes = (2 * x.numel() * el + B * T * H * 4 + 2 * B * T * N * el
              + state * (2 if init_state else 1))
    ops = 2 * B * nc * (H * (pairs * P + 2 * c * P * N) + pairs * N)
    return bounds(nbytes, ops, x.dtype)


def phase_ssd(SSD, results: list) -> list:
    """Phase 6: the SSD kernel against its plain version (ssd_chunked_ref)
    on the card.  Error is the JAX kernel tests' measure, max |y - y_ref|
    / max |y_ref| (and the same for the final state)."""
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=g)
    bad = []
    rel = lambda a, b: ((a.float() - b.float()).abs().max()
                        / (b.float().abs().max() + 1e-9)).item()
    cases = [(f"test_kernels {s}", s, False)
             for s in ((2, 64, 8, 32, 16, 16), (1, 128, 4, 64, 32, 32),
                       (2, 256, 8, 32, 128, 64), (2, 32, 6, 16, 8, 32))]
    cases.append(("init_state (2, 256, 8, 32, 128, 64)",
                  (2, 256, 8, 32, 128, 64), True))
    # the serving path's call: mamba2-2.7b, a micro-batch of 4 rows, prompt
    # 512, seeded with the cache's state
    cases.append(("main-path prefill B=4 T=512 H=80 P=64 N=128 chunk=256",
                  (4, 512, 80, 64, 128, 256), True))
    for label, (B, T, H, P, N, chunk), with_init in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x = rnd(B, T, H, P).to(dev, dtype)
            dt = torch.nn.functional.softplus(rnd(B, T, H)).to(dev)
            A = -torch.exp(rnd(H) * 0.5).to(dev)
            Bm, Cm = rnd(B, T, N).to(dev, dtype), rnd(B, T, N).to(dev, dtype)
            kw = dict(chunk=chunk, init_state=rnd(B, H, P, N).to(dev)
                      if with_init else None)
            kern = lambda: SSD.ssd_chunked(x, dt, A, Bm, Cm, **kw)
            plain = lambda: SSD.ssd_chunked_ref(x, dt, A, Bm, Cm, **kw)
            y, fin = kern()
            torch.cuda.synchronize()
            yr, fr = plain()
            err_y, err_s = rel(y, yr), rel(fin, fr)
            ok = (max(err_y, err_s) < TOL[dtype]
                  and bool(torch.isfinite(y.float()).all()))
            row = dict(label=label, dtype=str(dtype).replace("torch.", ""),
                       max_abs_err=(y.float() - yr.float()).abs().max().item(),
                       rel_err=err_y, state_rel_err=err_s, tol=TOL[dtype],
                       ms=time_ms(kern), call_ms=call_ms(kern),
                       plain_ms=time_ms(plain), library_ms=None,
                       **ssd_bound(x, N, chunk, with_init), ok=ok)
            if label.startswith("main-path"):
                # device time of each of the scan's CUDA kernels
                row["kernel_us"] = us = kernel_us(kern)
                if sorted(k.split("<")[0] for k in us) != [
                        "ssd_out_kernel", "ssd_pass_kernel",
                        "ssd_scores_kernel", "ssd_states_kernel"]:
                    fail(f"SSD main-path call: profiler shows {us}")
            print("kernel " + json.dumps(row), flush=True)
            results.append(row)
            if not ok:
                bad.append(f"{label} {row['dtype']}")
            del x, Bm, Cm, y, yr, fin, fr
    return bad


def launch_counters(counters: dict) -> dict:
    """Every launch counter of every kernel wrapper: ``name`` for its
    ``launches``, ``name.route`` for each ``launches_<route>``."""
    return {(name if a == "launches" else f"{name}.{a[len('launches_'):]}"):
            (fn, a)
            for name, fn in counters.items() for a in sorted(vars(fn))
            if a == "launches" or a.startswith("launches_")}


def serve_main_path(serve, argv: list, counters: dict, want: dict,
                    vocab: int) -> dict:
    """Drive ``serve.main(argv)`` once with every kernel's launch counters
    set to 0 just before and read just after; fail unless each count is
    the one wanted and the tokens and logits are sane."""
    print(f"serve: python -m repro_torch.launch.serve {' '.join(argv)}",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    every = launch_counters(counters)
    for fn, attr in every.values():
        setattr(fn, attr, 0)
    out = serve.main(argv)
    launches = {key: getattr(fn, attr) for key, (fn, attr) in every.items()}
    batch, gen = int(argv[argv.index("--batch") + 1]), \
        int(argv[argv.index("--gen") + 1])
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"serve: prefill {out['prefill_tok_s']:.1f} tok/s, decode "
          f"{out['decode_tok_s']:.1f} tok/s, warm-up {out['warmup_s']:.3f}s, "
          f"peak memory {peak:.2f} GiB, launches {json.dumps(launches)} "
          f"(want {json.dumps(want)})", flush=True)
    if launches != want:
        fail(f"kernel launches {launches}, want {want}")
    toks = out["tokens"]
    if tuple(toks.shape) != (batch, gen) or not ((toks >= 0) & (toks < vocab)).all():
        fail(f"serve tokens {tuple(toks.shape)} out of range")
    if not torch.isfinite(out["last_logits"]).all():
        fail("serve logits are not finite")
    res = dict(launches=launches, peak_gib=peak,
               **{k: out[k] for k in ("prefill_tok_s", "decode_tok_s",
                                      "warmup_s")})
    del out
    torch.cuda.empty_cache()
    return res


def phase_parity(serve_mods, arch: str, prompt_len: int) -> float:
    """Phases 5 and 8: the full width of ``arch`` cut to 2 layers and 2
    stages, served on the card (the kernels) and on the CPU (their plain
    versions) with the same weights and teacher-forced tokens.  Returns
    the largest logit difference."""
    get_config, RT, ST = serve_mods
    cfg = dataclasses.replace(get_config(arch), n_layers=2, stages=2,
                              tensor=1)
    B, gen = 4, 8
    plan = ST.plan_stages(cfg)
    pcfg = RT.PipelineConfig(n_microbatches=2)
    prefill = RT.make_serve_step(cfg, plan, pcfg, q_len=prompt_len)
    decode = RT.make_serve_step(cfg, plan, pcfg, q_len=1)
    params = ST.init_stacked_params(cfg, 0, plan, device="cuda")
    g = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (B, prompt_len), generator=g)
    forced = torch.randint(0, cfg.vocab, (B, gen - 1), generator=g)
    to = lambda tree, dev: {k: to(v, dev) if isinstance(v, dict)
                            else v.to(dev) for k, v in tree.items()}
    logits = {}
    for dev in ("cuda", "cpu"):
        p = to(params, dev)
        cache = RT.init_pipeline_cache(cfg, plan, B, prompt_len + gen,
                                       device=dev)
        toks = forced.to(dev)
        lg, cache = prefill(p, cache, dict(tokens=prompt.to(dev)))
        steps = [lg[:, 0]]
        # on the card, a decode step must not wait for the device: any
        # synchronizing call inside it raises here
        guard = dev == "cuda"
        if guard:
            torch.cuda.set_sync_debug_mode("error")
        try:
            for t in range(gen - 1):
                lg, cache = decode(p, cache, dict(tokens=toks[:, t:t + 1]))
                steps.append(lg[:, 0])
        finally:
            if guard:
                torch.cuda.set_sync_debug_mode("default")
        logits[dev] = torch.stack(steps).cpu()
        del p, cache
    a, b = logits["cuda"], logits["cpu"]
    if a.shape != (gen, B, cfg.padded_vocab(1)) or not torch.isfinite(a).all():
        fail(f"parity {arch}: logits {tuple(a.shape)} "
             f"finite={torch.isfinite(a).all()}")
    err = (a - b).abs().max().item()
    rel = ((a - b).abs() / (PATH_TOL + PATH_TOL * b.abs())).max().item()
    print(f"parity {arch}: prompt {prompt_len}, {gen} steps x batch {B}, "
          f"logits [{B}, 1, "
          f"{cfg.padded_vocab(1)}] card vs CPU (card decode steps free of "
          f"host syncs): max |diff| {err:.3e} "
          f"(|a-b| <= {PATH_TOL} + {PATH_TOL}|b|: worst ratio {rel:.3f})",
          flush=True)
    if rel > 1.0:
        fail(f"parity {arch}: card and CPU logits differ by {err:.3e}")
    return err


def _to(tree: dict, dev) -> dict:
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def _unstage(params: dict, plan, n_layers: int, ST) -> dict:
    """Stacked [S, Lps, ...] or [S, V, Lc, ...] parameters -> the
    unstaged tree loss_fn takes (layers [L, ...])."""
    return dict(params, layers=ST._map_layers(
        lambda a: ST.unstack_chunks(a, plan)[:n_layers], params["layers"]))


def train_launches(n_layers: int, M: int, has_w: bool, full: bool) -> dict:
    """Each kernel's launches in one train step: an F tick runs each
    layer's attention once without statistics; a B tick once with them
    (twice under remat 'full': the layer's forward re-runs inside the
    backward) and one backward; a W tick (zero-bubble plans) the same
    again.  Every forward call takes the prefill route."""
    fwd_stats = n_layers * M * (1 + has_w) * (1 + full)
    fwd = n_layers * M + fwd_stats
    return {"flash_attention": fwd, "flash_attention.prefill": fwd,
            "flash_attention.decode": 0,
            "flash_attention.bwd": n_layers * M * (1 + has_w),
            "ssd_scan": 0}


def phase_train(train, counters: dict, mods, *, schedule: str = "1f1b",
                virtual: int = 1, M_: int = 4) -> dict:
    """Phases 10, 12 and 13: ``train.main`` at full width (llama3.2-1b,
    16 layers on 4 stages, as ``virtual`` chunks a stage, batch 8, seq
    1024, f32, 3 steps) under ``schedule`` with ``M_`` micro-batches, with
    every launch counter set to 0 just before and read just after; then
    step 0's loss against a non-pipelined loss_fn on the card with the
    same weights."""
    get_config, RT, ST, M, SP, SyntheticLM = mods
    steps, stages, batch, seq = 3, 4, 8, 1024
    argv = ["--arch", "llama3.2-1b", "--tensor", "1", "--stages",
            str(stages), "--virtual", str(virtual), "--schedule", schedule,
            "--microbatches", str(M_), "--batch", str(batch),
            "--seq", str(seq), "--steps", str(steps), "--log-every", "1",
            "--device", "cuda"]
    tag = f"train {schedule} V={virtual} M={M_}"
    print(f"{tag}: python -m repro_torch.launch.train {' '.join(argv)}",
          flush=True)
    every = launch_counters(counters)
    for fn, attr in every.values():
        setattr(fn, attr, 0)
    out = train.main(argv)
    launches = {key: getattr(fn, attr) for key, (fn, attr) in every.items()}
    L = 16
    lowering = SP.lower_to_ticks(SP.build_schedule(schedule, M_, stages,
                                                   virtual))
    per_step = train_launches(L, M_, lowering.has_w, False)
    want = {k: steps * v for k, v in per_step.items()}
    losses = out["losses"]
    n_x = lowering.n_x
    after_first = sum(out["step_s"][1:]) / (steps - 1)
    res = dict(schedule=schedule, virtual=virtual, microbatches=M_,
               losses=losses, step_s=out["step_s"],
               step_ms_after_first=1e3 * after_first,
               tok_s=out["tok_per_step"] / after_first,
               peak_gib=out["peak_gib"], launches=launches,
               launches_per_step=out["launches"],
               stash_slots=out["stash_slots"], n_x=n_x)
    del out
    torch.cuda.empty_cache()
    print(f"{tag}: losses {losses}, step {res['step_ms_after_first']:.1f} "
          f"ms after the first ({res['tok_s']:.0f} tok/s), peak memory "
          f"{res['peak_gib']:.2f} GiB, stash slots {res['stash_slots']} "
          f"(n_x {n_x}), launches {json.dumps(launches)} (want "
          f"{json.dumps(want)})", flush=True)
    if launches != want or any(d != per_step for d in res["launches_per_step"]):
        fail(f"{tag} launches {launches} / {res['launches_per_step']}, want "
             f"{want} ({per_step} a step)")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{tag} losses are not finite: {losses}")
    if max(res["stash_slots"]) != n_x:
        fail(f"{tag} stash slots {res['stash_slots']}, lower_to_ticks n_x "
             f"{n_x}")
    # step 0's loss: the same weights (the seed), one non-pipelined pass
    cfg = dataclasses.replace(get_config("llama3.2-1b"), stages=stages,
                              tensor=1, virtual=virtual)
    plan = ST.plan_stages(cfg)
    params = _unstage(ST.init_stacked_params(cfg, 0, plan, device="cuda"),
                      plan, cfg.n_layers, ST)
    b0 = SyntheticLM(cfg.vocab, seq, batch, seed=0, device="cuda").batch(0)
    with torch.no_grad():
        ref = M.loss_fn(cfg, params, b0).item()
    res["step0_ref_loss"] = ref
    print(f"{tag}: step 0 loss {losses[0]:.6f}, non-pipelined loss_fn "
          f"{ref:.6f} (|diff| {abs(losses[0] - ref):.2e}, bar 1e-4)",
          flush=True)
    if abs(losses[0] - ref) > 1e-4:
        fail(f"{tag} step 0 loss {losses[0]} != loss_fn {ref}")
    del params, b0
    torch.cuda.empty_cache()
    return res


def _grad_errs(grads: dict, ref: dict) -> dict:
    """The JAX harness's measures: per layer leaf max |a-b| / max |b|
    (worst), embed max |a-b| / (max |b| + 1), final_norm relative."""
    from repro_torch.pipeline.stage import tree_leaves
    rel = lambda a, b: ((a.float() - b.float()).abs().max()
                        / (b.float().abs().max() + 1e-9)).item()
    return dict(
        layers=max(rel(a, b) for a, b in zip(tree_leaves(grads["layers"]),
                                             tree_leaves(ref["layers"]))),
        embed=((grads["embed"] - ref["embed"]).abs().max()
               / (ref["embed"].abs().max() + 1)).item(),
        final_norm=rel(grads["final_norm"], ref["final_norm"]))


#: phase 11's runs: (label, schedule, V, M, mem_limit, remat)
PARITY_RUNS = (
    ("gpipe", "gpipe", 1, 2, 0, "stage"),
    ("1f1b", "1f1b", 1, 2, 0, "stage"),
    ("dapple", "dapple", 1, 2, 0, "stage"),
    ("zb-h1", "zb-h1", 1, 2, 0, "stage"),
    ("1f1b-interleaved-memlean V=2", "1f1b-interleaved-memlean", 2, 2, 0,
     "stage"),
    ("zb-auto mem_limit=2 M=4", "zb-auto", 1, 4, 2, "stage"),
    ("1f1b remat=full", "1f1b", 1, 2, 0, "full"),
)
#: the runs of PARITY_RUNS also held card against CPU on a reduced model
CARD_VS_CPU = ("1f1b", "1f1b-interleaved-memlean V=2",
               "zb-auto mem_limit=2 M=4", "1f1b remat=full")


def phase_train_parity(FA, counters: dict, mods) -> dict:
    """Phase 11: the schedules of ``PARITY_RUNS`` against each other and
    against one non-pipelined autograd pass with the plain attention (full
    width, 3 layers, 2 stages, batch 4, seq 512; every plan pads the 3
    layers to 4 slots: at V = 2 stage 0's chunk 1 holds layer 2, so the
    wrapped rings carry live values both ways, and stage 1's chunk 1 is
    padding), each run's launches exactly
    :func:`train_launches`; remat 'full' against the stage recompute
    (bitwise equality recorded); then a reduced model on the card and on
    the CPU with the same weights, for the runs of ``CARD_VS_CPU``."""
    get_config, RT, ST, M, SP, SyntheticLM = mods
    from repro_torch.models import layers as LYR
    base_cfg = dataclasses.replace(get_config("llama3.2-1b"), n_layers=3,
                                   stages=2, tensor=1)
    batch = SyntheticLM(base_cfg.vocab, 512, 4, seed=1,
                        device="cuda").batch(0)
    every = launch_counters(counters)
    out, params1 = {}, None
    for label, sched, V, M_, ml, remat in PARITY_RUNS:
        cfg = dataclasses.replace(base_cfg, virtual=V)
        plan = ST.plan_stages(cfg)
        # the same seed draws the same first layers for any plan
        params = ST.init_stacked_params(cfg, 0, plan, device="cuda")
        unst = _unstage(params, plan, cfg.n_layers, ST)
        if params1 is None:
            params1 = unst
        elif not all(torch.equal(a, b) for a, b in zip(
                ST.tree_leaves(unst), ST.tree_leaves(params1))):
            fail(f"train parity {label}: the weights differ from gpipe's")
        step = RT.make_train_step(cfg, plan, RT.PipelineConfig(
            n_microbatches=M_, schedule=sched, mem_limit=ml, remat=remat))
        for fn, attr in every.values():
            setattr(fn, attr, 0)
        loss, grads = step(params, batch)
        launches = {k: getattr(fn, a) for k, (fn, a) in every.items()}
        want = train_launches(cfg.n_layers, M_, step.lowering.has_w,
                              remat == "full")
        if launches != want:
            fail(f"train parity {label}: launches {launches}, want {want}")
        full = ST._map_layers(lambda a: ST.unstack_chunks(a, plan),
                              grads["layers"])
        if any(a[cfg.n_layers:].any() for a in ST.tree_leaves(full)):
            fail(f"train parity {label}: padded slots got gradients")
        out[label] = (loss.item(), _unstage(grads, plan, cfg.n_layers, ST),
                      launches, max(step.stash_slots), step.lowering.n_x)
        del params, grads, full
    # the reference: one autograd pass of the unstaged model, attention in
    # its plain version (layers.attend swapped for attend_ref)
    leaves = dict(embed=params1["embed"].detach().requires_grad_(),
                  final_norm=params1["final_norm"].detach().requires_grad_(),
                  layers=ST._map_layers(
                      lambda a: a.detach().requires_grad_(),
                      params1["layers"]))
    kernel_attend = LYR.attend

    def plain_attend(q, k, v, *, scale, causal=True, q_start=0, kv_len=None,
                     window=None):
        B, S = q.shape[0], k.shape[1]
        return FA.attend_ref(q, k, v, scale=scale, causal=causal,
                             q_start=LYR._per_row(q_start, B, q.device),
                             kv_len=LYR._per_row(S if kv_len is None
                                                 else kv_len, B, q.device))
    LYR.attend = plain_attend
    try:
        ref_loss = M.loss_fn(base_cfg, leaves, batch)
        g = torch.autograd.grad(ref_loss, [leaves["embed"],
                                           leaves["final_norm"]]
                                + ST.tree_leaves(leaves["layers"]))
    finally:
        LYR.attend = kernel_attend
    n_lay = len(ST.tree_leaves(leaves["layers"]))
    ref = dict(embed=g[0], final_norm=g[1], layers=dict(
        zip(range(n_lay), g[2:])))
    res = {}
    base_loss, base = out["1f1b"][:2]
    for label, (loss, unst, launches, slots, n_x) in out.items():
        errs = _grad_errs(unst, ref)
        same = _grad_errs(unst, base)
        res[label] = dict(loss=loss, ref_loss=ref_loss.item(),
                          errs_vs_autograd=errs, errs_vs_1f1b=same,
                          launches=launches, stash_slots=slots, n_x=n_x)
        print(f"train parity {label}: loss {loss:.6f} (autograd "
              f"{ref_loss.item():.6f}), vs autograd {json.dumps(errs)}, vs "
              f"1f1b {json.dumps(same)}, launches {json.dumps(launches)}, "
              f"stash {slots} (n_x {n_x})", flush=True)
        if (abs(loss - ref_loss.item()) > 1e-4 or max(errs.values()) > 1e-4
                or abs(loss - base_loss) > 1e-5 * abs(base_loss)
                or max(same.values()) > 1e-5 or slots != n_x):
            fail(f"train parity {label}: {res[label]}")
    full_loss, full_g = out["1f1b remat=full"][:2]
    bitwise = full_loss == base_loss and all(
        torch.equal(a, b) for a, b in zip(ST.tree_leaves(full_g),
                                          ST.tree_leaves(base)))
    res["remat_full_bitwise_equal_stage"] = bitwise
    print(f"train parity: remat full vs stage (1f1b) bitwise equal: "
          f"{bitwise}", flush=True)
    del out, params1, leaves, g, ref, base, full_g
    torch.cuda.empty_cache()

    # a reduced model on the card and on the CPU, the same weights
    rcfg = dataclasses.replace(
        get_config("llama3.2-1b").reduced(n_layers=3, d_model=256), stages=2)
    b_cpu = SyntheticLM(rcfg.vocab, 128, 4, seed=2, device="cpu").batch(0)
    res["reduced_card_vs_cpu"] = {}
    for label, sched, V, M_, ml, remat in PARITY_RUNS:
        if label not in CARD_VS_CPU:
            continue
        cfg = dataclasses.replace(rcfg, virtual=V)
        rplan = ST.plan_stages(cfg)
        step = RT.make_train_step(cfg, rplan, RT.PipelineConfig(
            n_microbatches=M_, schedule=sched, mem_limit=ml, remat=remat))
        p_cpu = ST.init_stacked_params(cfg, 0, rplan, device="cpu")
        loss_g, grads_g = step(_to(p_cpu, "cuda"), _to(b_cpu, "cuda"))
        loss_c, grads_c = step(p_cpu, b_cpu)
        errs = _grad_errs(_to(grads_g, "cpu"), grads_c)
        res["reduced_card_vs_cpu"][label] = dict(
            loss_card=loss_g.item(), loss_cpu=loss_c.item(), errs=errs)
        print(f"train parity reduced (3 layers, d 256) {label} card vs CPU: "
              f"loss {loss_g.item():.6f} / {loss_c.item():.6f}, "
              f"{json.dumps(errs)}", flush=True)
        if (abs(loss_g.item() - loss_c.item()) > 1e-4
                or max(errs.values()) > 1e-4):
            fail(f"train parity card vs CPU {label}: "
                 f"{res['reduced_card_vs_cpu'][label]}")
    return res


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the port's kernels need a "
             "CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.core import schedplan as SP
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch import serve, train
    from repro_torch.models import model as M
    from repro_torch.pipeline import runtime as RT
    from repro_torch.pipeline import stage as ST

    # ---- 1. the card ------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    secs = build.build_all()
    print(f"build: {json.dumps(secs)} in {time.perf_counter() - t0:.1f}s "
          f"wall (nvcc, sm_90a)", flush=True)
    for name, log in build.BUILD_LOGS.items():
        for line in log.splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill")):
                print(f"  {name}: {line.strip()}", flush=True)
    sass = sass_counts(build, "flash_attention", "flash", "D")
    print(f"sass {json.dumps(sass)}", flush=True)
    if sass is None:
        print("sass: no cuobjdump beside nvcc; machine code not read",
              flush=True)
    elif not sass or any(
            (k.startswith("prefill") and v["HMMA"] == 0)
            or (k.split()[0] in ("prefill", "decode") and v["LDGSTS"] == 0)
            for k, v in sass.items()) or any(
            k not in sass or sass[k]["HMMA"] == 0 or sass[k]["LDGSTS"] == 0
            for k in (f"bwd_{kind} {d} D=64" for kind in ("dkdv", "dq")
                      for d in ("f32", "bf16"))):
        fail(f"flash kernels lack tensor-core products or cp.async: {sass}")
    # every SSD product kernel of both dtypes at P = 64 (the main path's)
    ssd_sass = sass_counts(build, "ssd_scan", "ssd", "P")
    print(f"sass ssd_scan {json.dumps(ssd_sass)}", flush=True)
    if ssd_sass is not None:
        want = [f"scores {d}" for d in ("f32", "bf16")] + [
            f"{k} {d} P=64" for k in ("states", "out") for d in ("f32", "bf16")]
        if any(k not in ssd_sass or ssd_sass[k]["HMMA"] == 0
               or ssd_sass[k]["LDGSTS"] == 0 for k in want):
            fail(f"SSD product kernels lack tensor-core products or "
                 f"cp.async: {ssd_sass}")

    # ---- 3. kernels against their plain versions --------------------------
    rows: list = []
    bad = phase_kernels(FA, rows)
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")

    # ---- 4. the llama3.2-1b path at full width ---------------------------
    counters = dict(flash_attention=FA.flash_attend, ssd_scan=SSD.ssd_chunked)
    llama = serve_main_path(
        serve, ["--arch", "llama3.2-1b", "--stages", "8", "--tensor", "1",
                "--microbatches", "2", "--batch", "8", "--prompt-len", "512",
                "--gen", "32", "--device", "cuda"],
        counters, {"flash_attention": 16 * 2 * (1 + 31),
                   "flash_attention.prefill": 16 * 2,
                   "flash_attention.decode": 16 * 2 * 31,
                   "flash_attention.bwd": 0, "ssd_scan": 0},
        128256)

    # ---- 5. whole llama path, kernel vs plain -----------------------------
    serve_mods = (get_config, RT, ST)
    path_err = phase_parity(serve_mods, "llama3.2-1b", 128)

    # ---- 6. the SSD scan against its plain version ------------------------
    ssd_rows: list = []
    bad = phase_ssd(SSD, ssd_rows)
    if bad:
        fail(f"ssd_scan disagrees with its plain version: {bad}")

    # ---- 7. the mamba2-2.7b path at full width ----------------------------
    mamba = serve_main_path(
        serve, ["--arch", "mamba2-2.7b", "--stages", "16", "--tensor", "1",
                "--microbatches", "2", "--batch", "8", "--prompt-len", "512",
                "--gen", "32", "--device", "cuda"],
        counters, {"flash_attention": 0, "flash_attention.prefill": 0,
                   "flash_attention.decode": 0, "flash_attention.bwd": 0,
                   "ssd_scan": 64 * 2}, 50280)

    # ---- 8. whole mamba2 path, kernel vs plain ----------------------------
    ssd_path_err = phase_parity(serve_mods, "mamba2-2.7b", 512)

    # ---- 9. the flash backward against its plain version ------------------
    bwd_rows: list = []
    bad = phase_backward(FA, bwd_rows)
    if bad:
        fail(f"flash backward disagrees with its plain version or is not "
             f"bitwise reproducible: {bad}")

    # ---- 10. llama3.2-1b training at full width ---------------------------
    train_mods = (get_config, RT, ST, M, SP, SyntheticLM)
    trained = phase_train(train, counters, train_mods)

    # ---- 11. schedules, non-pipelined autograd, card vs CPU ---------------
    train_parity = phase_train_parity(FA, counters, train_mods)

    # ---- 12. interleaved training (V = 2) at full width -------------------
    interleaved = phase_train(train, counters, train_mods,
                              schedule="1f1b-interleaved", virtual=2, M_=4)

    # ---- 13. zero-bubble H2 training at full width ------------------------
    zb_h2 = phase_train(train, counters, train_mods, schedule="zb-h2",
                        M_=8)
    train_paths = {f"train {r['schedule']} V={r['virtual']} "
                   f"M={r['microbatches']}": r["launches"]
                   for r in (trained, interleaved, zb_h2)}

    pick = lambda rs, prefix, dtype="float32": next(
        r for r in rs if r["label"].startswith(prefix) and r["dtype"] == dtype)
    main_row = pick(rows, "main-path prefill")
    keys = ("label", "dtype", "ms", "call_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "bound_tc_ms", "max_abs_err")
    flash = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:84",
        launches=llama["launches"]["flash_attention"],
        launches_train=trained["launches"]["flash_attention"],
        launches_by_path=dict({"serve llama3.2-1b": llama["launches"][
            "flash_attention"]}, **{k: v["flash_attention"]
                                    for k, v in train_paths.items()}),
        max_abs_err=main_row["max_abs_err"],
        ms=main_row["ms"], call_ms=main_row["call_ms"],
        plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        bound_tc_ms=main_row["bound_tc_ms"],
        library_ms=main_row["library_ms"],
        shape=main_row["label"] + " f32",
        # per kernel route: the main path's launches and the phase-3 rows
        routes={name: dict(
            launches=llama["launches"][f"flash_attention.{name}"],
            rows=[{k: r[k] for k in keys} for r in picked])
            for name, picked in (
                ("prefill", [main_row, pick(rows, "main-path prefill",
                                            "bfloat16")]),
                ("decode", [pick(rows, "main-path decode"),
                            pick(rows, "main-path decode", "bfloat16"),
                            pick(rows, "long decode")]))},
        # the training path's forward, without and with the statistics
        train_rows=[{k: r[k] for k in keys}
                    for r in rows if r["label"].startswith("train")],
        sass=sass, path_parity_max_abs_err=path_err)
    ssd_row = pick(ssd_rows, "main-path prefill")
    ssd_bf16 = next(r for r in ssd_rows if r["label"].startswith(
        "main-path prefill") and r["dtype"] == "bfloat16")
    ssd = dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:70",
        launches=mamba["launches"]["ssd_scan"],
        max_abs_err=ssd_row["max_abs_err"], rel_err=ssd_row["rel_err"],
        ms=ssd_row["ms"], call_ms=ssd_row["call_ms"],
        plain_ms=ssd_row["plain_ms"],
        bound_ms=ssd_row["bound_ms"], bound_by=ssd_row["bound_by"],
        bound_tc_ms=ssd_row["bound_tc_ms"],
        library_ms=None, shape=ssd_row["label"] + " f32",
        kernel_us=ssd_row["kernel_us"],
        bf16=dict((k, ssd_bf16[k]) for k in
                  ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                   "bound_tc_ms", "rel_err", "kernel_us")),
        sass=ssd_sass, path_parity_max_abs_err=ssd_path_err)
    bwd_row = pick(bwd_rows, "train")
    bwd_keys = ("label", "dtype", "ms", "call_ms", "plain_ms", "library_ms",
                "bound_ms", "bound_by", "bound_tc_ms", "rel_err", "bitwise",
                "kernel_us")
    flash_bwd = dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        # the gradient of that TPU kernel's function; the Pallas kernel has
        # no backward (the JAX model differentiates layers.attend, XLA)
        replaces="src/repro/kernels/flash_attention.py:84",
        launches=trained["launches"]["flash_attention.bwd"],
        launches_by_path={k: v["flash_attention.bwd"]
                          for k, v in train_paths.items()},
        max_abs_err=bwd_row["max_abs_err"], rel_err=bwd_row["rel_err"],
        ms=bwd_row["ms"], call_ms=bwd_row["call_ms"],
        plain_ms=bwd_row["plain_ms"], bound_ms=bwd_row["bound_ms"],
        bound_by=bwd_row["bound_by"], bound_tc_ms=bwd_row["bound_tc_ms"],
        library_ms=bwd_row["library_ms"], shape=bwd_row["label"] + " f32",
        kernel_us=bwd_row["kernel_us"],
        bitwise=all(r["bitwise"] for r in bwd_rows),
        bf16={k: v for k, v in pick(bwd_rows, "train", "bfloat16").items()
              if k in bwd_keys})
    print(json.dumps({"serve": {"llama3.2-1b": llama,
                                "mamba2-2.7b": mamba}}), flush=True)
    print(json.dumps({"train": {"llama3.2-1b": trained,
                                "interleaved": interleaved, "zb-h2": zb_h2,
                                "parity": train_parity}}), flush=True)
    print(json.dumps({"kernels": [flash, ssd, flash_bwd]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
