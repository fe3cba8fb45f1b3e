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
   (LDGSTS); so must the prefill route's kernels at D = 256, the
   backward's dK/dV and dQ kernels of the f32 and bf16 builds at D = 64
   and D = 128's and 256's own kernel (``bwd_wg``, dK/dV and dQ in one
   launch: mma.sync, cp.async and warpgroup products, HGMMA from wgmma),
   and every SSD product kernel
   (scores, chunk states, chunk outputs; the backward's dG, dx and dB/dC
   kernels) of the f32 and bf16 builds at P = 64;
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
   at phase 13's one-row micro-batch as well; so are gemma3-1b's training
   shapes (batch 2, T = S = 1024, 4/1 heads, D 256) on its global layers
   and its local ones (sliding window 512), its serving shapes (batch 4:
   the 1024-token prompt's prefill into a 1056-key cache and the decode
   over it, window 512 and global) and qwen3-1.7b's (16/8 heads, D 128:
   training, and serving's prefill of a 512-token prompt into a 544-key
   cache and per-row decode); the windowed prefill at T = S = 4096 (window 512:
   0.23x the operations) must take at most half the global call's device
   time in f32;
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
   heads, D 64, causal), gemma3-1b's global and local (window 512) and
   qwen3-1.7b's training shapes, a windowed per-row case with idle
   rows, and the D = 256 and D = 128 kernels' edges (T = S = 1000, 4/2
   heads, window 96, rows that see no key before, past and everywhere), in
   f32 and bf16
   (relative to max |ref|: 1e-4, 3e-2); a second call must give the same
   bits; the library time is the backward of
   ``scaled_dot_product_attention`` (eager, CUDA events; ``is_causal`` for
   the plain causal mask, else an explicit mask, a window's band
   included); the training shapes' rows add the device time of each of
   the backward's CUDA kernels (``kernel_us``, ``torch.profiler``: the
   pre-pass, dK/dV, dQ; at D = 128 the pre-pass and one kernel for dK/dV
   and dQ; at D = 256 those and the sum of the dK/dV parts); then the
   D = 128 kernels' registers and spills (``-Xptxas -v``) and their
   tensor-core and cp.async instruction counts (``sass_counts``);
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
   flash launches a step;
14. BaPipe's planner on the card: the card's f32 cuBLAS rate over one
   training layer's GEMMs, a device copy's bandwidth and its memory
   (``device_rates``) beside ``repro_torch.core.hardware.H100``; the
   measured B/W split (``measure_w_frac``, ``profile_arch`` in its
   measured mode) against the analytic one; ``measure_stage_times``
   against ``planned_stage_costs`` for 4 and 3 stages, with the
   ``DriftMonitor`` drift between them; then ``train.main`` at phase 10's
   width and data under ``--stages 4 --auto-plan --cluster
   h100,h100,h100,h100`` and ``--stages 4 --auto-plan3d --pool 4``: each
   plan first computed by the port's planner on the same inputs, a plan
   that needs tensor parallelism (the homogeneous ``--auto-plan``:
   stages 1 x tensor 4, trained as ranks in phase 35) or data
   parallelism (pool 4: data 4, phase 32 runs the data axis) printed and
   refused in this one process with the ranks it needs, before anything
   is allocated, and, where
   pool 4's plan is refused, the largest smaller pool whose plan runs on
   one card trained instead; each trained plan gets phase 10's checks
   (launches exactly :func:`train_launches` of its table, stash
   ``n_x``, step 0's loss against ``loss_fn``), the adopted stages,
   schedule, M and V equal to the planner's, and its predicted step time
   beside the measured one;
15. ``repro_torch.launch.serve.main`` at the full width of gemma3-1b (26
   layers: 22 with a sliding window of 512 keys, 4 global; d_model 1152,
   4/1 heads of 256, vocab 262144; 2 stages, 2 micro-batches, batch 8,
   prompt 1024, 32 tokens, f32): flash attention exactly 1664 launches, 52
   on the prefill route and 1612 on the decode route;
16. the whole gemma3 path, kernel against plain, as phase 5: full width
   cut to 2 layers, the first local (window 512) and the second global,
   prompt 640;
17. ``repro_torch.launch.serve.main`` at the full width of qwen3-1.7b (28
   layers, d_model 2048, 16/8 heads of 128, vocab 151936; 4 stages,
   prompt 512, as phase 4): exactly 1792 launches, 56 prefill and 1736
   decode; then the whole qwen3 path, kernel against plain, as phase 5
   (2 layers, prompt 512);
18. as phase 10 for gemma3-1b (26 layers on 4 stages of 7 slots, the last
   2 padded) and qwen3-1.7b (28 layers, 4 x 7): exactly 208 + 104 and
   224 + 112 flash launches a step;
19. as phase 11 for gemma3-1b at full width and 3 layers (the last global,
   the others window 512) and qwen3-1.7b at full width and 3 layers, seq
   1024, under 1f1b and zb-h1, against autograd of the plain-attention
   model;
20. the SSD scan's backward kernel against its plain version
   (``ssd_chunked_bwd_ref``) and against torch autograd of
   ``ssd_chunked_ref``, from the forward kernel's scratch: phase 6's
   shapes, an initial state with a nonzero final-state gradient, one
   chunk, 8 chunks at P = 128, a chunk of 100 with N = 24, a chunk of 6
   with N = 12 (plain loads), 13 heads (two head groups of the dG and
   dB/dC kernels, the last ragged), and the training path's call
   (mamba2-2.7b: batch 2, T 1024, 80 heads of 64, N 128, chunk 256), in
   f32 and bf16 (every gradient relative to max |ref|: 1e-4, 3e-2); a
   second call must give the same bits; no single PyTorch call computes
   it, so no library time; the training shape's rows add the device time
   of each of the backward's eight CUDA kernels;
21. as phase 10 for mamba2-2.7b (64 layers on 4 stages of 16): exactly 512
   forward and 256 backward SSD launches a step and no flash launch;
22. as phase 19 for mamba2-2.7b at full width and 3 layers, seq 1024,
   under 1f1b and zb-h1, against autograd of the model with the plain SSD
   scan (``ssd_chunked_ref``) in float64; a layer leaf is held to 1e-4 or,
   where the same model with the plain SSD in f32 (the JAX model's
   arithmetic) itself misses 1e-4 (a_log, whose gradient cancels to ~1e-4
   of its terms), to that model's own distance; both are printed;
23. ``repro_torch.launch.serve.main`` for llama3.2-1b at full width (4
   stages, 4 micro-batches, batch 8, prompt 512, 32 tokens) with
   ``--virtual 2`` (interleaved prefill, the restack handoff, V = 1
   decode) and without: tokens identical, prefill logits within 1e-6 of
   max |logit|, exactly 2048 flash launches each (64 prefill, 1984
   decode), the handoff's time and its peak memory, which must stay at or
   below what was resident before it plus its largest leaf; then
   mamba2-2.7b at full width and 8 layers (2 stages x 2 chunks x 2
   layers, M 2, prompt 512) at V = 2 and 1: tokens identical, exactly 16
   SSD launches;
24. continuous batching: llama3.2-1b at full width, 4 stages, 8 slots,
   M 2, chunk 64, ``max_len`` 640; 16 requests (prompts of 16-512 tokens
   from ``numpy.random.default_rng(7)``, 16 new tokens, one arrival every
   2 steps) through ``ContinuousEngine`` over the pipelined step, then
   under the sequential policy (one request at a time, the same step):
   each request's tokens bit-identical, some step mixing prefill and
   decode, exactly 16 x 2 flash launches a step; generated tok/s and
   p50/p99 latency in steps and ms printed for both;
25. as phase 24 at chunk 4 (the decode route; 8 requests, prompts of
   8-40 tokens, ``max_len`` 64) and at 4 stages x 2 chunks with 4
   micro-batches (chunk 64, 8 requests);
26. the first-layer attention of a mixed step of phases 24 and 25 (a
   first micro-batch holding prefill and decode slots), captured from
   the engine's run, against ``attend_ref`` (phase 3's tolerance) with
   the kernel's, the plain version's and SDPA's times and the bound;
   then a gemma3-1b mixed step (full width, 2 layers: window 512 and
   global; slots at offsets past the window) card vs CPU within 2e-4;
27. stages on separate ranks (``repro_torch.launch.mesh.spawn_ranks``:
   gloo ranks sharing the one card, each message staged device -> pinned
   host -> device; NCCL cannot put two ranks on one device): at full
   width, batch 4, seq 512, llama3.2-1b (3 layers) over 2 ranks under
   1f1b, zb-h1 and 1f1b-interleaved (V 2, M 4), over 3 ranks under 1f1b
   (4 layers: 6 slots, 2 padded), and mamba2-2.7b (3 layers) over 2 ranks
   under 1f1b, each rank's loss and gradient share against the
   in-process executor run in that rank's process with the same weights
   (the seed) and batch: bit for bit, the ranks' launches summing to the
   in-process run's exactly, each rank's stash its stage's;
28. ``repro_torch.launch.train.main`` as 4 gloo ranks on the one card
   (phase 10's run: llama3.2-1b at full width, 4 stages x 4 layers, 1f1b,
   M 4, batch 8, seq 1024, f32, 3 steps, ``--dist-backend gloo``): the
   three losses equal phase 10's bit for bit, exactly 128 forward and 64
   backward flash launches a step summed over ranks, each rank's stash
   its stage's peak-live count; it prints each rank's peak memory, the
   step ms (the slowest rank's) beside phase 10's and the transport's
   bytes and ms a step, activation hops apart from the tied embedding's
   all-reduce (128256 x 2048 f32 each way).  No step time of this phase
   is a pipeline's: the ranks time-slice one card;
29. serving on separate ranks (2 gloo ranks sharing the card; full
   width, batch 8, prompt 512, 8 tokens): llama3.2-1b at 4 layers, V 1
   M 2 and V 2 M 4 prefill (ring returns parked) with the handoff across
   ranks (``stage.restack_share_``), then V 1 decode; mamba2-2.7b at 3
   layers; each rank's logits of every step, its cache share and, after
   the handoff, its layers and cache against the in-process serve step
   in that rank's process, bit for bit, the ranks' launches summing to
   the in-process run's exactly; then one ``ContinuousEngine`` run
   (llama3.2-1b, 4 layers, 4 slots, chunk 32, 6 requests) on each rank
   over the rank step: the step plans, the retired requests and the
   cache shares of the in-process engine;
30. ``repro_torch.launch.serve.main`` as 4 gloo ranks on the one card
   with phase 23's flags (llama3.2-1b at full width, 16 layers on 4
   stages, ``--virtual 2``, M 4, batch 8, prompt 512, 32 tokens, f32,
   ``--dist-backend gloo``): the tokens equal phase 23's in-process V 2
   run bit for bit, exactly phase 23's 2048 flash launches summed over
   ranks, each rank's handoff peak at most what it held before plus its
   largest leaf; it prints prefill and decode tok/s (the slowest rank's
   times), the handoff's ms and bytes, each rank's peak memory and the
   transport by kind (ring hops, the logits broadcast from the last
   rank, the handoff's layers).  No time of this phase is a pipeline's;
31. phase 28's run under ``--runtime stream`` (each rank walks its own
   instruction stream): the losses equal phase 10's bit for bit, the hop
   messages and bytes a step equal phase 28's;
32. the data axis: ``repro_torch.launch.train.main`` as 4 gloo ranks on
   the card on a data 2 x stages 2 grid (llama3.2-1b at full width, 16
   layers on 2 stages, 1f1b, M 2 a replica, batch 8, seq 1024, f32,
   ``--runtime stream``, 2 steps) under ``--grad-sync end`` and then
   ``overlap`` (each gradient bucket posted at its ARSYNC slot): the two
   runs' losses bitwise equal, step 0's within 1e-5 relative of phase
   10's (the same weights and batch), exactly phase 10's 128 + 64 flash
   launches a step summed over ranks; it prints the step ms (the slowest
   rank's), each rank's peak memory and its ``grad_sync`` messages,
   bytes and ms; then 2bw through the rank step for 2 steps (at full
   depth if the card has room for one more gradient copy a rank, else
   at 8 layers, which it prints), step 0's loss equal to end's;
33. ``repro_torch.launch.serve.main`` as 4 gloo ranks at data 2 x stages
   2 (llama3.2-1b at full width, V 1, M 2 a replica, batch 8, prompt
   512, 32 tokens, f32) against the in-process serve of the same weights
   and prompts at data 1 (M 4, the same micro-batch rows): the tokens
   equal, every step's logits within 2e-4, the flash launches summed
   over ranks the in-process run's; it prints prefill and decode tok/s
   (the slowest rank's), the transport by kind and each rank's peak.
   No time of phases 32-33 is a data-parallel one: the ranks
   time-slice one card and every gradient byte crosses host memory;
34. the tensor axis (Megatron tensor parallelism, one spawn of 4 gloo
   ranks on the card for phases 34-36): llama3.2-1b at full width and 3
   layers as stages 2 x tensor 2 (1f1b and zb-h1, ticks and stream) and
   gemma3-1b at 2 layers (one local, one global; its one kv head
   replicated over the shards and sliced) as stages 1 x tensor 4,
   against the in-process tensor-1 executor on the same weights and
   batch: the loss within 1e-5 relative, every gradient leaf (its shards
   gathered back) within 1e-4, the flash launches summed over ranks T
   times the in-process run's; the kernel rows of phases 3 and 9 hold
   the flash kernel at each shard's heads (llama 16/4, qwen3 4/2 at
   D 128, gemma3 1/1 at D 256, window 512 and global) against its plain
   version;
35. ``repro_torch.launch.train.main`` as stages 2 x tensor 2 (llama3.2-1b
   at full width and depth, 1f1b, M 4, batch 8, seq 1024, f32, 2 steps):
   step 0's loss within 1e-5 of phase 10's, the launches summed over
   ranks twice phase 28's a step; it prints each rank's ``tensor``
   messages, bytes and ms a step, the slowest rank's step and each
   rank's peak; then phase 14's homogeneous ``--auto-plan`` at
   ``--stages 4`` trains its stages 1 x tensor 4 plan one step (under
   ``--remat full``), its loss within 1e-5 of phase 10's step 0;
36. serving at stages 2 x tensor 2 (llama3.2-1b at full width, batch 8,
   prompt 512, 32 tokens) and, at 2 layers, gemma3-1b at stages 1 x
   tensor 4 (one kv slot a shard), teacher-forced on the in-process
   tensor-1 serve's tokens: every step's logits within 2e-4 of its, the
   greedy tokens that agree, prefill and decode tok/s of the slowest
   rank, each rank's peak and kv heads; then a ``ContinuousEngine`` run
   at stages 2 x tensor 2 (2 layers) retiring the in-process engine's
   tokens.  No time of phases 34-36 is a tensor-parallel one: the ranks
   time-slice one card and every collective crosses host memory.

Every kernel's launch counters (``launches`` and, for flash attention,
``launches_prefill`` / ``launches_decode`` / ``launches_bwd``; for the
SSD scan ``launches_bwd``) are set to 0 just before each driven path
(phases 4, 7, 10, 12, 13, 15, 17, 18 and 21, and each run of phases 11,
14, 19, 22, 23, 24 and 25; in phases 27-33 in each rank's process,
the rank executor's and the in-process runs apart; in phases 34-36 in
each rank's process for each run) and read just after it.  Every process
runs with TF32 off and one cuBLAS workspace setting (``card_flags``).
Each phase prints the second it starts at (``mark``).

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``, printed only when every phase passed.
Exits non-zero without a CUDA card or outside a checkout.
"""
import concurrent.futures
import contextlib
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
# the D = 128 and 256 backward kernels in sass_counts' keys
BWD_WG_KEYS = [f"bwd_wg {d} D={D}" for D in (128, 256) for d in ("f32", "bf16")]
# whole-path parity, card vs CPU, f32: cuBLAS and the CPU sum the d_ff=8192
# and vocab-wide products in another order; the error stays ~1e-6 relative
# per layer, so 2e-4 (the port-vs-JAX CPU tolerance) leaves a wide margin
PATH_TOL = 2e-4


def fail(msg: str) -> None:
    """Report a failed check on both streams (a caller that keeps only the
    end of standard error still sees why) and exit 1."""
    print(f"FAIL: {msg}", flush=True)
    print(f"chip_smoke.py FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


#: the script's start, for :func:`mark`
T_START = time.perf_counter()


def mark(phase: str) -> None:
    """Print the seconds since the script started as phase ``phase``
    starts (the phases' costs against the run's time limit)."""
    print(f"phase {phase} starts at {time.perf_counter() - T_START:.1f} s",
          flush=True)


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


def visible_keys(T: int, S: int, q_start, kv_len, causal: bool,
                 window: int = 0):
    """Per row (b, i) the range [start, end) of keys it sees, as int64 [B,
    T] tensors on the CPU, and whether it sees none (it then averages V over
    all S keys)."""
    qs, kl = q_start.cpu().long(), kv_len.cpu().long().clamp(max=S)
    qpos = qs[:, None] + torch.arange(T)[None]
    end = kl[:, None].expand(qpos.shape)
    if causal:
        end = torch.minimum(end, qpos + 1)
    start = ((qpos - window + 1).clamp(min=0) if window
             else torch.zeros_like(end))
    return start, end, start >= end


def attention_bound(q, k, q_start, kv_len, causal, window: int = 0) -> dict:
    """Least time (ms) for attention of these inputs on the card
    (:func:`bounds`).  Bytes: q read and the output written once, K/V
    read once for the keys some row of the batch row can see.  Operations:
    4*D per visible query-key pair (q.k and p.v), counted for this data
    (a sliding ``window`` included); a row that sees no key averages V over
    all S keys."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    start, end, idle = visible_keys(T, S, q_start, kv_len, causal, window)
    start = torch.where(idle, 0, start)
    end = torch.where(idle, S, end)
    el = q.element_size()
    keys = (end.max(dim=1).values - start.min(dim=1).values).sum().item()
    nbytes = 2 * q.numel() * el + 2 * keys * Hkv * D * el
    ops = 4 * D * Hq * (end - start).sum().item()
    return bounds(nbytes, ops, q.dtype)


def attention_mask(T: int, S: int, q_start, kv_len, causal: bool,
                   window: int = 0):
    """The boolean visibility mask [B, 1, T, S] on q_start's device (the
    band of a sliding window included)."""
    dev = q_start.device
    kpos = torch.arange(S, device=dev)
    qpos = q_start.long()[:, None] + torch.arange(T, device=dev)[None]
    mask = kpos[None, None, :] < kv_len.long()[:, None, None]
    if causal:
        mask = mask & (kpos[None, None, :] <= qpos[:, :, None])
    if window:
        mask = mask & (kpos[None, None, :] > qpos[:, :, None] - window)
    return mask[:, None]


def plain_causal(T: int, S: int, q_start, kv_len, causal: bool,
                 window: int) -> bool:
    """Whether the mask is the plain causal one (``is_causal``)."""
    return (causal and not window and T == S and bool((q_start == 0).all())
            and bool((kv_len >= S).all()))


def library_attention(q, k, v, q_start, kv_len, causal, scale,
                      window: int = 0):
    """scaled_dot_product_attention on the same work (``is_causal`` where
    the mask is the plain causal one, else the mask, a window's band
    included, built here outside the timed call); the yardstick, never used
    by the port."""
    B, T, Hq, D = q.shape
    S = k.shape[1]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if plain_causal(T, S, q_start, kv_len, causal, window):
        return lambda: sdpa(qt, kt, vt, is_causal=True, scale=scale,
                            enable_gqa=True)
    mask = attention_mask(T, S, q_start, kv_len, causal, window)
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


def backward_bound(q, k, q_start, kv_len, causal, window: int = 0) -> dict:
    """Least time (ms) for the attention backward of these inputs
    (:func:`bounds`).  Bytes: q, the output and its gradient read once and
    dq written once; k and v read once for the keys some row of the batch
    row sees, dk and dv written once for all S keys; the f32 statistics
    read once.  Operations, counted for this data (a sliding ``window``
    included): 10*D per visible query-key pair (the scores recomputed, dP,
    dV, dQ, dK: a multiply-add over D each), 2*D per key for a row that
    sees no key (its dV share)."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    start, end, idle = visible_keys(T, S, q_start, kv_len, causal, window)
    seen = torch.where(idle, 0, end - start)
    el = q.element_size()
    lo = torch.where(idle, 0, start).min(1).values
    hi = torch.where(idle, S, end).max(1).values
    keys = (hi - lo).sum().item()
    nbytes = (4 * q.numel() * el + 2 * keys * Hkv * D * el
              + 2 * B * S * Hkv * D * el + B * Hq * T * 4)
    ops = Hq * D * (10 * seen.sum().item() + 2 * S * idle.sum().item())
    return bounds(nbytes, ops, q.dtype)


def library_attention_bwd(q, k, v, dout, q_start, kv_len, causal, scale,
                          window: int = 0):
    """The backward of scaled_dot_product_attention on the same work
    (``is_causal`` where the mask is the plain causal one, else the mask,
    a window's band included, built here); the yardstick, never used by
    the port."""
    B, T, Hq, D = q.shape
    S = k.shape[1]
    leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if plain_causal(T, S, q_start, kv_len, causal, window):
        out = sdpa(*leaves, is_causal=True, scale=scale, enable_gqa=True)
    else:
        out = sdpa(*leaves, attn_mask=attention_mask(
            T, S, q_start, kv_len, causal, window), scale=scale,
            enable_gqa=True)
    dot = dout.transpose(1, 2)
    return lambda: torch.autograd.grad(out, leaves, dot, retain_graph=True)


def sass_counts(build, name: str, prefix: str, dim: str) -> dict:
    """Counts of tensor-core products (HMMA from mma.sync, HGMMA from
    wgmma) and cp.async loads (LDGSTS) in
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
            counts[cur] = dict(HMMA=0, HGMMA=0, LDGSTS=0)
        elif "Function : " in line:
            cur = None
        elif cur:
            for op in ("HMMA", "HGMMA", "LDGSTS"):
                counts[cur][op] += bool(re.search(rf"\b{op}\b", line))
    return counts


def ptxas_kernels(log: str, pattern: str) -> dict:
    """Registers and spill bytes (stores + loads) of each kernel whose
    mangled name matches ``pattern`` in nvcc's ``-Xptxas -v`` output,
    keyed ``dtype WIN=0|1`` (its template arguments)."""
    out, cur = {}, None
    for line in log.splitlines():
        fn = re.search(r"Compiling entry function '(\S+)'", line)
        if fn:
            args = re.search(r"I(f|13__nv_bfloat16)Li\d+ELb([01])E", fn[1])
            cur = (f"{'f32' if args[1] == 'f' else 'bf16'} WIN={args[2]}"
                   if args and re.search(pattern, fn[1]) else None)
        elif cur and "spill stores" in line:
            out.setdefault(cur, {})["spill_bytes"] = sum(
                int(n) for n in re.findall(r"(\d+) bytes spill", line))
        elif cur and "registers" in line:
            out.setdefault(cur, {})["registers"] = int(
                re.search(r"Used (\d+) registers", line)[1])
    return out


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


def attention_row(FA, label, q, k, v, q_start, kv_len, causal, kern, plain,
                  dtype, window=0) -> dict:
    """One flash call against its plain version on the same inputs: the
    largest difference, the kernel's, the plain version's and one library
    call's device times and the bound, printed as a ``kernel`` line."""
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
                   q4, k4, v4, q_start, kv_len, causal, scale, window)),
               **attention_bound(q4, k4, q_start, kv_len, causal, window),
               ok=ok)
    print("kernel " + json.dumps(row), flush=True)
    return row


def phase_kernels(FA, results: list) -> list:
    """Phase 3: the flash kernel against its plain version."""
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    rnd = lambda *s, dt: torch.randn(*s, generator=g).to(dev, dt)
    bad = []

    def run(label, *args, **kw):
        row = attention_row(FA, label, *args, **kw)
        results.append(row)
        if not row["ok"]:
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

    # the dense variants' paths: gemma3-1b (4/1 heads, D 256) trained at a
    # micro-batch of 2 rows, T = S = 1024, on its global layers and its
    # local ones (window 512), and served (a micro-batch of 4 rows: the
    # 1024-token prompt's prefill into the 1056-key cache of the prompt and
    # 32 tokens, then decode over it, local and global); qwen3-1.7b (16/8
    # heads, D 128) trained and served (prefill of a 512-token prompt into
    # a 544-key cache, decode per row); then the windowed prefill at
    # T = S = 4096 beside the global one
    tr, dq_ = ([0, 0], [1024, 1024]), ([1055, 1040, 1030, 1024],
                                        [1056, 1041, 1031, 1025])
    gp, qp = ([0] * 4, [1024] * 4), ([0] * 4, [512] * 4)
    qd = ([527, 520, 300, 543], [528, 521, 301, 544])
    for label, B, T, S, Hq, Hkv, D, (q_start, kv_len), window in (
            ("gemma3 train global", 2, 1024, 1024, 4, 1, 256, tr, 0),
            ("gemma3 train global with statistics", 2, 1024, 1024, 4, 1,
             256, tr, 0),
            ("gemma3 train local", 2, 1024, 1024, 4, 1, 256, tr, 512),
            ("gemma3 train local with statistics", 2, 1024, 1024, 4, 1,
             256, tr, 512),
            ("gemma3 serve prefill local", 4, 1024, 1056, 4, 1, 256, gp,
             512),
            ("gemma3 serve prefill global", 4, 1024, 1056, 4, 1, 256, gp, 0),
            ("gemma3 decode local per-row", 4, 1, 1056, 4, 1, 256, dq_, 512),
            ("gemma3 decode global per-row", 4, 1, 1056, 4, 1, 256, dq_, 0),
            ("qwen3 train", 2, 1024, 1024, 16, 8, 128, tr, 0),
            ("qwen3 train with statistics", 2, 1024, 1024, 16, 8, 128, tr,
             0),
            ("qwen3 serve prefill", 4, 512, 544, 16, 8, 128, qp, 0),
            ("qwen3 decode per-row", 4, 1, 544, 16, 8, 128, qd, 0),
            ("long prefill global", 1, 4096, 4096, 4, 1, 256, ([0], [4096]),
             0),
            ("long prefill local", 1, 4096, 4096, 4, 1, 256, ([0], [4096]),
             512),
            # one tensor shard's heads (phases 34-36, f32): llama3.2-1b at
            # tensor 2 (16/8 -> 16/4 heads a shard), qwen3-1.7b at tensor
            # 4 (4/2, D 128), gemma3-1b at tensor 4 (its one kv head
            # replicated and sliced: 1/1, G = 1, D 256), each trained
            # (with the statistics), its prompt prefilled and decoded
            ("llama tensor 2 train with statistics", 2, 1024, 1024, 16, 4,
             64, tr, 0),
            ("llama tensor 2 serve prefill", 4, 512, 544, 16, 4, 64, qp, 0),
            ("llama tensor 2 decode per-row", 4, 1, 544, 16, 4, 64, qd, 0),
            ("qwen3 tensor 4 train with statistics", 2, 1024, 1024, 4, 2,
             128, tr, 0),
            ("qwen3 tensor 4 serve prefill", 4, 512, 544, 4, 2, 128, qp, 0),
            ("qwen3 tensor 4 decode per-row", 4, 1, 544, 4, 2, 128, qd, 0),
            ("gemma3 tensor 4 train global with statistics", 2, 1024, 1024,
             1, 1, 256, tr, 0),
            ("gemma3 tensor 4 train local with statistics", 2, 1024, 1024,
             1, 1, 256, tr, 512),
            ("gemma3 tensor 4 serve prefill local", 4, 1024, 1056, 1, 1, 256,
             gp, 512),
            ("gemma3 tensor 4 serve prefill global", 4, 1024, 1056, 1, 1,
             256, gp, 0),
            ("gemma3 tensor 4 decode local per-row", 4, 1, 1056, 1, 1, 256,
             dq_, 512),
            ("gemma3 tensor 4 decode global per-row", 4, 1, 1056, 1, 1, 256,
             dq_, 0)):
        for dtype in (torch.float32, torch.bfloat16):
            if "tensor" in label and dtype != torch.float32:
                continue
            q = rnd(B, T, Hq, D, dt=dtype)
            k, v = rnd(B, S, Hkv, D, dt=dtype), rnd(B, S, Hkv, D, dt=dtype)
            qs = torch.tensor(q_start, dtype=torch.int32, device=dev)
            kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
            kw = dict(scale=D ** -0.5, causal=True, q_start=qs, kv_len=kl,
                      window=window)
            lse = dict(return_lse=True) if "statistics" in label else {}
            run(f"{label} B={B} T={T} S={S} Hq={Hq} Hkv={Hkv} D={D} "
                f"window={window}", q, k, v, qs, kl, True,
                lambda: (FA.flash_attend(q, k, v, **lse, **kw)[0]
                         if lse else FA.flash_attend(q, k, v, **kw)),
                lambda: FA.attend_ref(q, k, v, **kw), dtype, window)
            del q, k, v
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
    # (label, B, T, S, Hq, Hkv, D, causal, q_start, kv_len[, window])
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
               [0], [1024]),
              # the dense variants' training shapes: gemma3-1b's global and
              # local (window 512) layers, qwen3-1.7b's layers
              ("gemma3 train global T=S=1024", 2, 1024, 1024, 4, 1, 256,
               True, [0, 0], [1024, 1024], 0),
              ("gemma3 train local T=S=1024 window=512", 2, 1024, 1024, 4, 1,
               256, True, [0, 0], [1024, 1024], 512),
              ("qwen3 train T=S=1024", 2, 1024, 1024, 16, 8, 128, True,
               [0, 0], [1024, 1024], 0),
              ("window=8 per-row with idle rows", 4, 40, 96, 4, 1, 256,
               True, [0, 30, 0, 90], [40, 70, 0, 20], 8),
              # the D = 256 kernels' edges: T = S = 1000 cuts the 32-row
              # tiles, G = 2 parts, a window of 96 (3 tiles), rows that
              # see no key before (q_start < 0), past the window's reach
              # (kv_len 801) and everywhere (kv_len 0)
              ("D=256 edges T=S=1000 window=96 per-row with idle rows", 4,
               1000, 1000, 4, 2, 256, True, [0, 37, 0, -50],
               [1000, 801, 0, 1000], 96),
              # the D = 128 kernels' edges: the same rows and window over
              # 64-row tiles, G = 2 query heads a kv head's block walks
              ("D=128 edges T=S=1000 window=96 per-row with idle rows", 4,
               1000, 1000, 4, 2, 128, True, [0, 37, 0, -50],
               [1000, 801, 0, 1000], 96),
              # one tensor shard's heads (phases 34-35, f32): llama3.2-1b
              # at tensor 2, qwen3-1.7b at tensor 4, gemma3-1b at tensor 4
              # (G = 1: one f32 part a kv head at D = 256)
              ("llama tensor 2 train T=S=1024", 2, 1024, 1024, 16, 4, 64,
               True, [0, 0], [1024, 1024], 0),
              ("qwen3 tensor 4 train T=S=1024", 2, 1024, 1024, 4, 2, 128,
               True, [0, 0], [1024, 1024], 0),
              ("gemma3 tensor 4 train global T=S=1024", 2, 1024, 1024, 1, 1,
               256, True, [0, 0], [1024, 1024], 0),
              ("gemma3 tensor 4 train local T=S=1024 window=512", 2, 1024,
               1024, 1, 1, 256, True, [0, 0], [1024, 1024], 512)]
    bad = []
    for label, B, T, S, Hq, Hkv, D, causal, q_start, kv_len, *w in cases:
        window = w[0] if w else 0
        for dtype in (torch.float32, torch.bfloat16):
            if "tensor" in label and dtype != torch.float32:
                continue
            q, do = rnd(B, T, Hq, D, dt=dtype), rnd(B, T, Hq, D, dt=dtype)
            k, v = rnd(B, S, Hkv, D, dt=dtype), rnd(B, S, Hkv, D, dt=dtype)
            qs = torch.tensor(q_start, dtype=torch.int32, device=dev)
            kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
            kw = dict(scale=D ** -0.5, causal=causal, q_start=qs, kv_len=kl,
                      window=window)
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
                           q, k, v, do, qs, kl, causal, D ** -0.5, window)),
                       **backward_bound(q, k, qs, kl, causal, window), ok=ok)
            if "train" in label:
                # device time of each of the backward's CUDA kernels
                row["kernel_us"] = us = kernel_us(kern)
                want_k = (["flash_bwd_delta_kernel", "flash_bwd_dkdv_kernel",
                           "flash_bwd_dq_kernel"] if D <= 64 else
                          ["flash_bwd_delta_kernel", "flash_bwd_wg_kernel"]
                          + (["flash_bwd_sum_kernel"] if D == 256 else []))
                if sorted(k_.split("<")[0] for k_ in us) != sorted(want_k):
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


def ssd_bwd_bound(x, N: int, chunk: int, init_state: bool,
                  dfinal: bool) -> dict:
    """Least time (ms) for the SSD scan's backward of these inputs
    (:func:`bounds`).  Bytes: x, dy, dt, Bm, Cm read and dx, ddt, dBm, dCm
    written once; the initial state read and its gradient written (when
    given), the final state's gradient read (when given).  Operations, 2
    flops per multiply-add, counted as :func:`ssd_bound` counts the
    forward's: per (row, chunk, head) dW = dy.x^T and W^T.dy over the
    c(c+1)/2 causal pairs x P, and four c x P x N products (the gradient's
    readout state, dS_own.B, dS_own^T.x, S_in^T.dy); per (row, chunk) the
    scores C.B^T and the products of their gradient summed over heads
    with C and with B, each over the causal pairs x N."""
    B, T, H, P = x.shape
    el, nc, c = x.element_size(), T // chunk, chunk
    pairs = c * (c + 1) // 2
    state = B * H * P * N * 4
    nbytes = (3 * x.numel() * el + 2 * B * T * H * 4 + 4 * B * T * N * el
              + state * (2 * init_state + dfinal))
    ops = 2 * B * nc * (H * (2 * pairs * P + 4 * c * P * N) + 3 * pairs * N)
    return bounds(nbytes, ops, x.dtype)


#: the backward's CUDA kernels (the gradient's readout state is the
#: forward's chunk-states kernel in its GRAD form)
SSD_BWD_KERNELS = sorted(["ssd_states_kernel", "ssd_bwd_pass_kernel",
                          "ssd_bwd_dg_kernel", "ssd_bwd_dgsum_kernel",
                          "ssd_bwd_dx_kernel", "ssd_bwd_dbc_kernel",
                          "ssd_bwd_fin_kernel", "ssd_bwd_sum_kernel"])


def phase_ssd_bwd(SSD, results: list) -> list:
    """Phase 20: the SSD backward kernel against its plain version
    (ssd_chunked_bwd_ref) and against torch autograd of ssd_chunked_ref,
    from the forward kernel's scratch of the same inputs; a second call
    must give the same bits.  Errors are max over the six gradients of
    max |got - ref| / max |ref|."""
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=g)
    rel = lambda a, b: ((a.float() - b.float()).abs().max()
                        / (b.float().abs().max() + 1e-12)).item()
    # (label, (B, T, H, P, N, chunk), initial state and final gradient)
    cases = [(f"test_kernels {s}", s, False)
             for s in ((2, 64, 8, 32, 16, 16), (1, 128, 4, 64, 32, 32),
                       (2, 256, 8, 32, 128, 64), (2, 32, 6, 16, 8, 32))]
    cases += [("init_state dfinal (2, 256, 8, 32, 128, 64)",
               (2, 256, 8, 32, 128, 64), True),
              # one chunk; many chunks at P 128; a chunk of 100 (ragged
              # 64-row tiles) with N 24; chunk 6 and N 12 (plain loads)
              ("one chunk (1, 256, 4, 64, 128, 256)",
               (1, 256, 4, 64, 128, 256), True),
              ("8 chunks P=128 (1, 512, 4, 128, 64, 64)",
               (1, 512, 4, 128, 64, 64), True),
              ("chunk=100 N=24 (2, 300, 3, 32, 24, 100)",
               (2, 300, 3, 32, 24, 100), True),
              ("chunk=6 N=12 (1, 24, 2, 16, 12, 6)", (1, 24, 2, 16, 12, 6),
               True),
              # 13 heads: two head groups of the dG and dB/dC kernels, the
              # last of them ragged (3 of 10 heads)
              ("ragged head group (1, 256, 13, 64, 128, 128)",
               (1, 256, 13, 64, 128, 128), True),
              # the training path's call: mamba2-2.7b, a micro-batch of 2
              # rows, seq 1024 (4 chunks), no state in or out
              ("train B=2 T=1024 H=80 P=64 N=128 chunk=256",
               (2, 1024, 80, 64, 128, 256), False)]
    bad = []
    for label, (B, T, H, P, N, chunk), seeded in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x = rnd(B, T, H, P).to(dev, dtype)
            dt = torch.nn.functional.softplus(rnd(B, T, H)).to(dev)
            A = -torch.exp(rnd(H) * 0.5).to(dev)
            Bm, Cm = rnd(B, T, N).to(dev, dtype), rnd(B, T, N).to(dev, dtype)
            dy = rnd(B, T, H, P).to(dev, dtype)
            init = rnd(B, H, P, N).to(dev) if seeded else None
            dfinal = rnd(B, H, P, N).to(dev) if seeded else None
            kw = dict(chunk=chunk, init_state=init)
            saved = SSD.ssd_chunked_saved(x, dt, A, Bm, Cm, **kw)[2]
            kern = lambda: SSD.ssd_chunked_bwd(x, dt, A, Bm, Cm, dy, dfinal,
                                               saved=saved, **kw)
            plain = lambda: SSD.ssd_chunked_bwd_ref(x, dt, A, Bm, Cm, dy,
                                                    dfinal, **kw)
            got = kern()
            again = kern()
            torch.cuda.synchronize()
            got = [t for t in got if t is not None]
            bitwise = all(torch.equal(a, b) for a, b in
                          zip(got, [t for t in again if t is not None]))
            want = [t for t in plain() if t is not None]
            leaves = [t.detach().requires_grad_()
                      for t in (x, dt, A, Bm, Cm, init) if t is not None]
            y, fin = SSD.ssd_chunked_ref(*leaves[:5], chunk=chunk,
                                         init_state=leaves[5] if seeded
                                         else None)
            auto = torch.autograd.grad(
                (y, fin), leaves,
                (dy, dfinal if seeded else torch.zeros_like(fin)))
            err = max(rel(a, b) for a, b in zip(got, want))
            err_auto = max(rel(a, b) for a, b in zip(got, auto))
            ok = (max(err, err_auto) <= BWD_TOL[dtype] and bitwise
                  and all(bool(torch.isfinite(t.float()).all()) for t in got))
            row = dict(label=label, dtype=str(dtype).replace("torch.", ""),
                       max_abs_err=max((a.float() - b.float()).abs().max()
                                       .item() for a, b in zip(got, want)),
                       rel_err=err, rel_err_autograd=err_auto,
                       rel_errs={n: rel(a, b) for n, a, b in zip(
                           ("dx", "ddt", "dA", "dB", "dC", "dinit"), got,
                           want)},
                       tol=BWD_TOL[dtype], bitwise=bitwise,
                       ms=time_ms(kern), call_ms=call_ms(kern),
                       plain_ms=time_ms(plain), library_ms=None,
                       **ssd_bwd_bound(x, N, chunk, seeded, seeded), ok=ok)
            if label.startswith("train"):
                # device time of each of the backward's CUDA kernels
                row["kernel_us"] = us = kernel_us(kern)
                if sorted(k.split("<")[0] for k in us) != SSD_BWD_KERNELS:
                    fail(f"SSD backward at the training shape: profiler "
                         f"shows {us}")
            print("kernel " + json.dumps(row), flush=True)
            results.append(row)
            if not ok:
                bad.append(f"{label} {row['dtype']}")
            del x, Bm, Cm, dy, saved, got, again, want, auto, leaves, y, fin
    return bad


def launch_counters(counters: dict) -> dict:
    """Every launch counter of every kernel wrapper: ``name`` for its
    ``launches``, ``name.route`` for each ``launches_<route>``."""
    return {(name if a == "launches" else f"{name}.{a[len('launches_'):]}"):
            (fn, a)
            for name, fn in counters.items() for a in sorted(vars(fn))
            if a == "launches" or a.startswith("launches_")}


def counted(counters: dict, fn):
    """``fn()`` with every kernel's launch counters set to 0 just before it
    and read just after: (its result, the counts)."""
    every = launch_counters(counters)
    for f, attr in every.values():
        setattr(f, attr, 0)
    out = fn()
    return out, {key: getattr(f, attr) for key, (f, attr) in every.items()}


def serve_main_path(serve, argv: list, counters: dict, want: dict,
                    vocab: int, keep: bool = False):
    """Drive ``serve.main(argv)`` once with every kernel's launch counters
    set to 0 just before and read just after; fail unless each count is
    the one wanted and the tokens and logits are sane.  Returns the
    figures, and with ``keep`` also what ``serve.main`` returned."""
    print(f"serve: python -m repro_torch.launch.serve {' '.join(argv)}",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    out, launches = counted(counters, lambda: serve.main(argv))
    batch, gen = int(argv[argv.index("--batch") + 1]), \
        int(argv[argv.index("--gen") + 1])
    # a V > 1 run's handoff restarts the count: its figure before it too
    peak = max(torch.cuda.max_memory_allocated(),
               (out["handoff"] or {}).get("peak_before", 0)) / 2**30
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
    if keep:
        return res, out
    del out
    torch.cuda.empty_cache()
    return res


def phase_parity(serve_mods, arch: str, prompt_len: int, **over) -> float:
    """Phases 5, 8, 16 and 17: the full width of ``arch`` cut to 2 layers and
    2 stages (and the fields ``over``), served on the card (the kernels)
    and on the CPU (their plain versions) with the same weights and
    teacher-forced tokens.  Returns the largest logit difference."""
    get_config, RT, ST = serve_mods
    cfg = dataclasses.replace(get_config(arch), n_layers=2, stages=2,
                              tensor=1, **over)
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

    def served(dev: str) -> torch.Tensor:
        """The prefill's and every decode step's logits on ``dev``."""
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
        return torch.stack(steps).cpu()

    logits = {dev: served(dev) for dev in ("cuda", "cpu")}
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
        # which side moved: each served once more, against its first run
        again = {dev: served(dev) for dev in ("cuda", "cpu")}
        print(f"parity {arch}: over the bar; served again, bit for bit "
              f"equal to the first run: card "
              f"{bool(torch.equal(again['cuda'], a))}, CPU "
              f"{bool(torch.equal(again['cpu'], b))}; the repeats' max "
              f"|diff| {(again['cuda'] - again['cpu']).abs().max().item():.3e}",
              flush=True)
        ratio = (a - b).abs() / (PATH_TOL + PATH_TOL * b.abs())
        at = [int(i) for i in torch.unravel_index(ratio.argmax(), ratio.shape)]
        fail(f"parity {arch}: card and CPU logits differ by {err:.3e}; "
             f"worst at [step, row, column] {at}: card "
             f"{a[tuple(at)].item():.6e}, CPU {b[tuple(at)].item():.6e}; "
             f"{int((ratio > 1).sum())} of {ratio.numel()} logits over "
             f"the bar; CPU logits finite: {bool(torch.isfinite(b).all())}")
    return err


def _to(tree: dict, dev) -> dict:
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def _unstage(params: dict, plan, n_layers: int, ST) -> dict:
    """Stacked [S, Lps, ...] or [S, V, Lc, ...] parameters -> the
    unstaged tree loss_fn takes (layers [L, ...])."""
    return dict(params, layers=ST._map_layers(
        lambda a: ST.unstack_chunks(a, plan)[:n_layers], params["layers"]))


def train_launches(n_layers: int, M: int, has_w: bool, full: bool,
                   ssm: bool = False) -> dict:
    """Each kernel's launches in one train step: an F tick runs each
    layer's attention (or SSD scan) once, attention without statistics; a
    B tick once more, attention with them (twice under remat 'full': the
    layer's forward re-runs inside the backward), and one backward; a W
    tick (zero-bubble plans) the same again.  Every attention forward
    takes the prefill route.  ``ssm``: the layers are SSD scans, not
    attention."""
    fwd = n_layers * M * (1 + (1 + has_w) * (1 + full))
    bwd = n_layers * M * (1 + has_w)
    fa_f, fa_b = (0, 0) if ssm else (fwd, bwd)
    return {"flash_attention": fa_f, "flash_attention.prefill": fa_f,
            "flash_attention.decode": 0, "flash_attention.bwd": fa_b,
            "ssd_scan": fwd - fa_f, "ssd_scan.bwd": bwd - fa_b}


def phase_train(train, counters: dict, mods, *, schedule: str = "1f1b",
                virtual: int = 1, M_: int = 4, stages: int = 4,
                planner: list = None, arch: str = "llama3.2-1b") -> dict:
    """Phases 10, 12, 13, 14 and 17: ``train.main`` at full width (``arch``,
    llama3.2-1b's 16 layers by default, on ``stages`` stages, as
    ``virtual`` chunks a stage, batch 8, seq 1024, f32, 3 steps) under
    ``schedule`` with ``M_`` micro-batches, with every launch counter set
    to 0 just before and read just after; then step 0's loss against a
    non-pipelined loss_fn on the card with the same weights.  With
    ``planner`` (phase 14: ``--stages 4`` and the planner's flags in place
    of the plan's) the CLI must adopt exactly that plan."""
    get_config, RT, ST, M, SP, SyntheticLM = mods
    steps, batch, seq = 3, 8, 1024
    plan_flags = (["--stages", "4"] + planner if planner else
                  ["--stages", str(stages), "--virtual", str(virtual),
                   "--schedule", schedule, "--microbatches", str(M_)])
    argv = (["--arch", arch, "--tensor", "1"] + plan_flags
            + ["--batch", str(batch), "--seq", str(seq), "--steps",
               str(steps), "--log-every", "1", "--device", "cuda"])
    tag = (f"train {' '.join(planner)}" if planner else
           f"train {arch} {schedule} V={virtual} M={M_}")
    print(f"{tag}: python -m repro_torch.launch.train {' '.join(argv)}",
          flush=True)
    every = launch_counters(counters)
    for fn, attr in every.values():
        setattr(fn, attr, 0)
    out = train.main(argv)
    launches = {key: getattr(fn, attr) for key, (fn, attr) in every.items()}
    L = get_config(arch).n_layers
    lowering = SP.lower_to_ticks(SP.build_schedule(schedule, M_, stages,
                                                   virtual))
    adopted = (out["stages"], out["virtual"], out["schedule"],
               out["microbatches"])
    if adopted != (stages, virtual, lowering.schedule, M_):
        fail(f"{tag} ran stages/V/schedule/M {adopted}, want "
             f"{(stages, virtual, lowering.schedule, M_)}")
    per_step = train_launches(L, M_, lowering.has_w, False,
                              get_config(arch).family == "ssm")
    want = {k: steps * v for k, v in per_step.items()}
    losses = out["losses"]
    n_x = lowering.n_x
    after_first = sum(out["step_s"][1:]) / (steps - 1)
    res = dict(arch=arch, schedule=lowering.schedule, virtual=virtual,
               microbatches=M_, stages=stages,
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
    cfg = dataclasses.replace(get_config(arch), stages=stages,
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


def _leaf_errs(grads: dict, ref: dict) -> list:
    """Each layer leaf's max |a-b| / max |b|, in tree order."""
    from repro_torch.pipeline.stage import tree_leaves
    return [((a.float() - b.float()).abs().max()
             / (b.float().abs().max() + 1e-9)).item()
            for a, b in zip(tree_leaves(grads["layers"]),
                            tree_leaves(ref["layers"]))]


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


def phase_train_parity(FA, counters: dict, mods, arch: str = "llama3.2-1b",
                       over: dict = None, runs=None, card_vs_cpu=None,
                       seq: int = 512) -> dict:
    """Phases 11 and 18: the schedules of ``runs`` (``PARITY_RUNS``)
    against each other and against one non-pipelined autograd pass with
    the plain attention (``arch`` at full width, 3 layers and the fields
    ``over``, 2 stages, batch 4, ``seq`` tokens; every plan pads the 3
    layers to 4 slots: at V = 2 stage 0's chunk 1 holds layer 2, so the
    wrapped rings carry live values both ways, and stage 1's chunk 1 is
    padding), each run's launches exactly :func:`train_launches`; remat
    'full' against the stage recompute (bitwise equality recorded); then a
    reduced model on the card and on the CPU with the same weights, for
    the runs of ``card_vs_cpu`` (``CARD_VS_CPU``)."""
    get_config, RT, ST, M, SP, SyntheticLM = mods
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.models import layers as LYR
    runs = PARITY_RUNS if runs is None else runs
    card_vs_cpu = CARD_VS_CPU if card_vs_cpu is None else card_vs_cpu
    base_cfg = dataclasses.replace(get_config(arch), n_layers=3,
                                   stages=2, tensor=1, **(over or {}))
    batch = SyntheticLM(base_cfg.vocab, seq, 4, seed=1,
                        device="cuda").batch(0)
    every = launch_counters(counters)
    out, params1 = {}, None
    for label, sched, V, M_, ml, remat in runs:
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
                              remat == "full", cfg.family == "ssm")
        if launches != want:
            fail(f"train parity {arch} {label}: launches {launches}, want "
                 f"{want}")
        full = ST._map_layers(lambda a: ST.unstack_chunks(a, plan),
                              grads["layers"])
        if any(a[cfg.n_layers:].any() for a in ST.tree_leaves(full)):
            fail(f"train parity {label}: padded slots got gradients")
        out[label] = (loss.item(), _unstage(grads, plan, cfg.n_layers, ST),
                      launches, max(step.stash_slots), step.lowering.n_x)
        del params, grads, full
    # the reference: one autograd pass of the unstaged model, attention and
    # the SSD scan in their plain versions (layers.attend swapped for
    # attend_ref, layers._ssd_chunked for ssd_chunked_ref).  The plain SSD
    # runs in float64: in f32 its in-chunk sums of dt*A reach thousands at
    # mamba2's magnitudes (A down to -16).  The same model with the plain
    # SSD in f32 (as the JAX model computes it) is run too: a_log's
    # gradient cancels to ~1e-4 of the size of its terms, and that f32
    # model itself lands ~2e-4 from the float64 one there, so a layer leaf
    # is held to 1e-4 or, where the plain f32 model misses 1e-4, to the
    # plain f32 model's own distance.
    leaves = dict(embed=params1["embed"].detach().requires_grad_(),
                  final_norm=params1["final_norm"].detach().requires_grad_(),
                  layers=ST._map_layers(
                      lambda a: a.detach().requires_grad_(),
                      params1["layers"]))
    kernel_attend, kernel_ssd = LYR.attend, LYR._ssd_chunked
    ssd_dtype = torch.float64

    def plain_attend(q, k, v, *, scale, causal=True, q_start=0, kv_len=None,
                     window=None):
        B, S = q.shape[0], k.shape[1]
        return FA.attend_ref(q, k, v, scale=scale, causal=causal,
                             q_start=LYR._per_row(q_start, B, q.device),
                             kv_len=LYR._per_row(S if kv_len is None
                                                 else kv_len, B, q.device),
                             window=window or 0)
    def plain_ssd(xh, dt, A, Bm, Cm, chunk, init_state=None):
        cast = lambda t: None if t is None else t.to(ssd_dtype)
        y, fin = SSD.ssd_chunked_ref(cast(xh), cast(dt), cast(A), cast(Bm),
                                     cast(Cm), chunk=chunk,
                                     init_state=cast(init_state))
        return y.to(xh.dtype), fin.float()

    def reference():
        LYR.attend, LYR._ssd_chunked = plain_attend, plain_ssd
        try:
            ref_loss = M.loss_fn(base_cfg, leaves, batch)
            g = torch.autograd.grad(ref_loss, [leaves["embed"],
                                               leaves["final_norm"]]
                                    + ST.tree_leaves(leaves["layers"]))
        finally:
            LYR.attend, LYR._ssd_chunked = kernel_attend, kernel_ssd
        n_lay = len(ST.tree_leaves(leaves["layers"]))
        return ref_loss, dict(embed=g[0], final_norm=g[1], layers=dict(
            zip(range(n_lay), g[2:])))
    ref_loss, ref = reference()
    ref32 = None
    if base_cfg.family == "ssm":
        ssd_dtype = torch.float32
        ref32 = reference()[1]
    res = {}
    base_loss, base = out["1f1b"][:2]
    for label, (loss, unst, launches, slots, n_x) in out.items():
        errs = _grad_errs(unst, ref)
        same = _grad_errs(unst, base)
        res[label] = dict(loss=loss, ref_loss=ref_loss.item(),
                          errs_vs_autograd=errs, errs_vs_1f1b=same,
                          launches=launches, stash_slots=slots, n_x=n_x)
        layers_ok = errs["layers"] <= 1e-4
        if ref32 is not None:
            res[label]["errs_vs_autograd_f32_ssd"] = _grad_errs(unst, ref32)
            mine, plain = _leaf_errs(unst, ref), _leaf_errs(ref32, ref)
            res[label]["leaf_errs"] = mine
            res[label]["leaf_errs_f32_plain_model"] = plain
            layers_ok = all(m <= max(1e-4, q) for m, q in zip(mine, plain))
        print(f"train parity {arch} {label}: loss {loss:.6f} (autograd "
              f"{ref_loss.item():.6f}), vs autograd {json.dumps(errs)}"
              + (f" (f32 plain SSD: "
                 f"{json.dumps(res[label]['errs_vs_autograd_f32_ssd'])})"
                 if ref32 is not None else "")
              + f", vs 1f1b {json.dumps(same)}, launches "
              f"{json.dumps(launches)}, stash {slots} (n_x {n_x})",
              flush=True)
        if (abs(loss - ref_loss.item()) > 1e-4 or not layers_ok
                or max(errs["embed"], errs["final_norm"]) > 1e-4
                or abs(loss - base_loss) > 1e-5 * abs(base_loss)
                or max(same.values()) > 1e-5 or slots != n_x):
            fail(f"train parity {arch} {label}: {res[label]}")
    if "1f1b remat=full" in out:
        full_loss, full_g = out["1f1b remat=full"][:2]
        bitwise = full_loss == base_loss and all(
            torch.equal(a, b) for a, b in zip(ST.tree_leaves(full_g),
                                              ST.tree_leaves(base)))
        res["remat_full_bitwise_equal_stage"] = bitwise
        print(f"train parity: remat full vs stage (1f1b) bitwise equal: "
              f"{bitwise}", flush=True)
    del out, params1, leaves, ref, ref32, base
    torch.cuda.empty_cache()
    if not card_vs_cpu:
        return res

    # a reduced model on the card and on the CPU, the same weights
    rcfg = dataclasses.replace(
        get_config(arch).reduced(n_layers=3, d_model=256), stages=2)
    b_cpu = SyntheticLM(rcfg.vocab, 128, 4, seed=2, device="cpu").batch(0)
    res["reduced_card_vs_cpu"] = {}
    for label, sched, V, M_, ml, remat in runs:
        if label not in card_vs_cpu:
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


def _refused(train, argv: list, tag: str, plan) -> None:
    """``train.main(argv)`` must print its plan and, in this one process,
    refuse it before allocating anything, naming the ranks it needs: a
    plan with tensor above 1 (it trains as ranks: phase 35) or with data
    above 1 (phase 32 runs the data axis)."""
    tensor = plan.tensor > 1
    err, why = ValueError, ("tensor parallelism runs only as ranks" if tensor
                            else "the data axis runs only as ranks")
    before = torch.cuda.memory_allocated()
    try:
        train.main(argv)
    except err as e:
        if why not in str(e):
            fail(f"{tag}: refused for another reason: {e}")
    else:
        fail(f"{tag}: a plan that needs more than one card was run")
    if torch.cuda.memory_allocated() != before:
        fail(f"{tag}: the CLI allocated before refusing")
    print(f"{tag}: refused before allocating ({why})", flush=True)


def phase_planner(train, counters: dict, mods) -> dict:
    """Phase 14: BaPipe's planner on the card.  The card's own rates
    beside the ``H100`` constants; the measured B/W split against the
    analytic one; the measured per-stage cost vector against the planned
    one, and the drift monitor between them; then ``train.main`` under
    ``--auto-plan --cluster h100 x 4`` and ``--auto-plan3d --pool 4``
    (and the homogeneous ``--auto-plan``): each plan is first computed by
    the port's planner on the same inputs; a one-card plan is trained
    (phase 10's checks, plus the adopted plan), any other must be
    printed and refused before allocating.  When pool 4's plan needs
    more cards, the largest smaller pool whose plan runs on one card is
    trained instead."""
    from repro_torch.core import autoplan as AP
    from repro_torch.core import explorer as EX
    from repro_torch.core import hardware as HW
    from repro_torch.core import profiler as PR
    get_config, RT, ST, M, SP, SyntheticLM = mods
    H = HW.H100
    rates = device_rates()
    by_shape = {k: round(v, 2) for k, v in
                rates["gemm_tflops_by_shape"].items()}
    print(f"planner: H100 constants: effective {H.effective_flops / 1e12:.2f}"
          f" TFLOP/s (peak {H.peak_flops / 1e12:.0f} x efficiency "
          f"{H.efficiency}), HBM {H.hbm_bandwidth / 1e9:.0f} GB/s, memory "
          f"{H.memory_capacity} B; measured now: f32 GEMMs "
          f"{rates['layer_gemm_tflops']:.2f} TFLOP/s over a layer "
          f"({json.dumps(by_shape)}, head {rates['head_gemm_tflops']:.2f}), copy "
          f"{rates['copy_bytes_s'] / 1e9:.1f} GB/s, memory "
          f"{rates['memory_capacity']} B", flush=True)
    cfg = dataclasses.replace(get_config("llama3.2-1b"), tensor=1, stages=4)
    batch, seq = 8, 1024
    # the B/W split: measured on the card against the analytic model
    w_meas = [PR.measure_w_frac(cfg, seq=128) for _ in range(3)]
    prof_m = PR.profile_arch(dataclasses.replace(
        cfg, profile_w_frac="measured"), seq=seq)
    prof_a = PR.profile_arch(cfg, seq=seq)
    res = dict(rates=rates, w_frac_measured=w_meas,
               w_frac_profile_measured=prof_m.layers[0].w_frac,
               w_frac_analytic=prof_a.layers[0].w_frac)
    print(f"planner: w_frac measured {w_meas} (profile_arch 'measured' "
          f"{prof_m.layers[0].w_frac}), analytic "
          f"{prof_a.layers[0].w_frac}", flush=True)
    # the measured per-stage cost vector against the planned one
    for S in (4, 3):
        plan = ST.plan_stages(cfg, S)
        measured = PR.measure_stage_times(cfg, plan)
        planned = PR.planned_stage_costs(cfg, plan, seq=seq)
        mon = PR.DriftMonitor(planned=tuple(planned))
        drift = mon.update(measured)
        res[f"stage_costs_{S}"] = dict(measured_s=measured, planned=planned,
                                       drift=drift, slowdown=mon.slowdown())
        print(f"planner: {S} stages x {plan.layers_per_stage} layers: "
              f"measured {measured} s, planned {planned} flops, drift "
              f"{drift:.3e}, slowdown {mon.slowdown()}", flush=True)
        if (measured is None or len(measured) != S
                or not all(t > 0 for t in measured)):
            fail(f"planner: measured stage costs {measured}")
    base = ["--arch", "llama3.2-1b", "--tensor", "1", "--stages", "4",
            "--batch", str(batch), "--seq", str(seq), "--steps", "1",
            "--device", "cuda"]
    kw = dict(global_batch=batch, seq_len=seq)
    homog = AP.auto_plan(cfg, model_axis=4, data_axis=1, device=H, **kw)
    print(f"planner: homogeneous auto_plan {homog}", flush=True)
    if homog.tensor > 1 or homog.data_axis > 1:
        _refused(train, base + ["--auto-plan"], "train --auto-plan", homog)
    runs = []
    t0 = time.perf_counter()
    cluster = AP.auto_plan(cfg, model_axis=4, data_axis=1, device=H,
                           devices=[H] * 4, **kw)
    res["plan_s"] = {"cluster": time.perf_counter() - t0}
    runs.append((["--auto-plan", "--cluster", "h100,h100,h100,h100"],
                 cluster))
    for pool in (4, 3, 2, 1):
        t0 = time.perf_counter()
        p3 = AP.auto_plan3d(cfg, n_devices=pool, device=H, **kw)
        res["plan_s"][f"pool {pool}"] = time.perf_counter() - t0
        print(f"planner: auto_plan3d pool {pool}: {p3}", flush=True)
        if p3.tensor == 1 and p3.data_axis == 1:
            runs.append((["--auto-plan3d", "--pool", str(pool)], p3))
            break
        _refused(train, base + ["--auto-plan3d", "--pool", str(pool)],
                 f"train --auto-plan3d --pool {pool}", p3)
    print(f"planner: host seconds to plan {json.dumps(res['plan_s'])}",
          flush=True)
    # the model's memory (bf16 weights, grads and boundary activations)
    # beside the f32 runs' measured peak
    prof = PR.profile_arch(cfg, seq=seq)
    res["runs"] = []
    for flags, want in runs:
        applied = want.apply(cfg)
        r = phase_train(train, counters, mods, schedule=applied.schedule,
                        virtual=applied.virtual, M_=want.n_microbatches,
                        stages=applied.stages, planner=flags)
        ex = EX.explore(prof, HW.homogeneous_cluster(H, want.stages),
                        batch * seq, candidate_Ms=[want.n_microbatches],
                        consider_dp=False)
        r.update(flags=flags, plan=dataclasses.asdict(want),
                 predicted_ms=1e3 * want.predicted_step_time,
                 measured_over_predicted=r["step_ms_after_first"]
                 / (1e3 * want.predicted_step_time),
                 model_stage_memory_gib=[m / 2**30
                                         for m in ex.per_stage_memory])
        print(f"train {' '.join(flags)}: plan stages={want.stages} "
              f"M={want.n_microbatches} sched={want.schedule} "
              f"V={want.virtual}, predicted {r['predicted_ms']:.2f} ms a "
              f"step (per-device makespan), measured "
              f"{r['step_ms_after_first']:.1f} ms (every stage on one "
              f"card), ratio {r['measured_over_predicted']:.3f}; model "
              f"memory per stage {r['model_stage_memory_gib']} GiB (bf16) "
              f"against a measured peak of {r['peak_gib']:.2f} GiB (f32, "
              f"all stages)", flush=True)
        res["runs"].append(r)
    return res


# ---------------------------------------------------------------------------
# Phases 23-26: interleaved serving, continuous batching, the mixed step.
# ---------------------------------------------------------------------------

#: V = 2 against V = 1 prefill logits, relative to max |logit|: the same
#: layer calls run at the same shapes, so any gap is a finding
V2_PREFILL_REL = 1e-6
#: what the handoff's gather allocates beside the new leaf: its index
#: vector, and each block rounded up to 512 bytes by the allocator
HANDOFF_SLACK = 4096


def same_generation(label: str, a: dict, b: dict, bar=None) -> dict:
    """Tokens of two serve runs, and their prefill logits relative to
    max |logit| (failing above ``bar`` where one is given)."""
    la, lb = a["prefill_logits"].float(), b["prefill_logits"].float()
    gap = ((la - lb).abs().max() / la.abs().max()).item()
    res = dict(tokens_identical=torch.equal(a["tokens"], b["tokens"]),
               prefill_rel_gap=gap, prefill_bitwise=torch.equal(la, lb))
    print(f"{label}: V=2 against V=1: {json.dumps(res)} (prefill bar "
          f"{bar})", flush=True)
    if not res["tokens_identical"]:
        fail(f"{label}: V = 2 tokens differ from V = 1's")
    if bar is not None and gap > bar:
        fail(f"{label}: V = 2 prefill logits {gap:.3e} of max |logit| from "
             f"V = 1's (bar {bar})")
    return res


def handoff_memory(label: str, h: dict) -> dict:
    """The handoff's figures; fail if its peak passed what was resident
    before it plus its largest leaf."""
    bar = h["allocated_before"] + h["largest_leaf_bytes"] + HANDOFF_SLACK
    gib = {k: h[k] / 2**30 for k in ("peak_before", "allocated_before",
                                      "peak_during", "allocated_after",
                                      "bytes_before", "largest_leaf_bytes")}
    res = dict(handoff_ms=1e3 * h["seconds"], bar_gib=bar / 2**30,
               **{k + "_gib": v for k, v in gib.items()})
    print(f"{label}: handoff {json.dumps(res)}", flush=True)
    if h["peak_during"] > bar:
        fail(f"{label}: the handoff's peak {h['peak_during']} B passed "
             f"what was resident before it plus its largest leaf ({bar} B)")
    return res


def phase_interleaved(serve, counters: dict, get_config) -> dict:
    """Phase 23: llama3.2-1b through ``serve.main`` at V = 2 and V = 1
    (4 stages, M 4), then mamba2-2.7b at 8 layers through ``serve.serve``
    at V = 2 and V = 1 (2 stages, M 2)."""
    argv = ["--arch", "llama3.2-1b", "--tensor", "1", "--stages", "4",
            "--microbatches", "4", "--batch", "8", "--prompt-len", "512",
            "--gen", "32", "--device", "cuda"]
    want = {"flash_attention": 16 * 4 * 32,
            "flash_attention.prefill": 16 * 4,
            "flash_attention.decode": 16 * 4 * 31,
            "flash_attention.bwd": 0, "ssd_scan": 0, "ssd_scan.bwd": 0}
    # each run starts with the allocator's cache empty, as every serve run
    # of this script does
    torch.cuda.empty_cache()
    v2, o2 = serve_main_path(serve, argv + ["--virtual", "2"], counters,
                             want, 128256, keep=True)
    torch.cuda.empty_cache()
    v1, o1 = serve_main_path(serve, argv, counters, want, 128256, keep=True)
    res = dict(llama_v2=v2, llama_v1=v1,
               llama=same_generation("llama3.2-1b", o2, o1, V2_PREFILL_REL),
               llama_handoff=handoff_memory("llama3.2-1b", o2["handoff"]),
               llama_v2_tokens=o2["tokens"].tolist())
    del o1, o2
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(get_config("mamba2-2.7b"), n_layers=8,
                              stages=2, tensor=1)
    want = {"flash_attention": 0, "flash_attention.prefill": 0,
            "flash_attention.decode": 0, "flash_attention.bwd": 0,
            "ssd_scan": 8 * 2, "ssd_scan.bwd": 0}
    outs = {}
    for V in (2, 1):
        torch.cuda.empty_cache()
        print(f"serve: mamba2-2.7b at full width, 8 layers, 2 stages, "
              f"V={V}, M 2, batch 8, prompt 512, 32 tokens", flush=True)
        out, launches = counted(counters, lambda: serve.serve(
            dataclasses.replace(cfg, virtual=V), microbatches=2,
            schedule="auto", batch=8, prompt_len=512, gen=32, seed=0,
            device=torch.device("cuda")))
        print(f"serve: prefill {out['prefill_tok_s']:.1f} tok/s, decode "
              f"{out['decode_tok_s']:.1f} tok/s, launches "
              f"{json.dumps(launches)} (want {json.dumps(want)})",
              flush=True)
        if launches != want:
            fail(f"mamba2 V={V}: kernel launches {launches}, want {want}")
        outs[V] = out
        res[f"mamba_v{V}"] = dict(launches=launches, **{
            k: out[k] for k in ("prefill_tok_s", "decode_tok_s")})
    res["mamba"] = same_generation("mamba2-2.7b 8 layers", outs[2], outs[1])
    res["mamba_handoff"] = handoff_memory("mamba2-2.7b 8 layers",
                                          outs[2]["handoff"])
    del outs
    torch.cuda.empty_cache()
    return res


class AttentionCapture:
    """While entered, records clones of the inputs of the first
    ``flash_attend`` call ``models/layers.attend`` makes (it looks the
    wrapper up at call time); the call itself runs, and counts, as ever."""

    def __init__(self, LYR):
        self.LYR, self.orig, self.args = LYR, LYR.flash_attend, None

    def __enter__(self):
        def rec(q, k, v, **kw):
            if self.args is None:
                self.args = (q.clone(), k.clone(), v.clone(), {
                    n: a.clone() if isinstance(a, torch.Tensor) else a
                    for n, a in kw.items()})
            return self.orig(q, k, v, **kw)
        self.LYR.flash_attend = rec
        return self

    def __exit__(self, *exc):
        self.LYR.flash_attend = self.orig


def engine_requests(SS, vocab: int, n: int, lo: int, hi: int,
                    max_new: int = 16, gap: int = 2) -> list:
    """``n`` requests, prompt lengths in [lo, hi] and tokens from
    ``numpy.random.default_rng(7)``, one arrival every ``gap`` steps."""
    import numpy as np
    rng = np.random.default_rng(7)
    lens = rng.integers(lo, hi + 1, n)
    return [SS.Request(rid=i, prompt=rng.integers(0, vocab, int(m)).tolist(),
                       max_new=max_new, arrival=gap * i)
            for i, m in enumerate(lens)]


def percentile(xs, q: float) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(xs, dtype=float), q))


def phase_engine(mods, counters: dict, label: str, reqs: list, *,
                 chunk: int, max_len: int, virtual: int = 1, M_: int = 2,
                 capture=None) -> dict:
    """Phases 24 and 25: ``reqs`` through ``ContinuousEngine`` over the
    pipelined step of llama3.2-1b at full width (4 stages, 8 slots), then
    under the sequential policy (one request in flight at a time, over the
    same step, as ``benchmarks/serve_bench.py`` runs it).  Each request's
    tokens must be bit-identical between the two, some continuous step
    must mix prefill and decode, and each run must launch the flash kernel
    exactly 16 x M a step.  With ``capture`` (an
    :class:`AttentionCapture`), the continuous run's first step whose
    first micro-batch mixes prefill and decode records its first
    attention call's inputs."""
    import copy
    get_config, RT, ST, SS, FA = mods
    cfg = dataclasses.replace(get_config("llama3.2-1b"), stages=4, tensor=1,
                              virtual=virtual)
    plan = ST.plan_stages(cfg)
    n_slots = 8
    mb = n_slots // M_
    params = ST.init_stacked_params(cfg, 0, plan, device="cuda")
    step = RT.make_serve_step(cfg, plan, RT.PipelineConfig(n_microbatches=M_),
                              q_len=chunk)
    route = FA.route(chunk, cfg.n_heads, cfg.n_kv_heads)
    arrival = {r.rid: r.arrival for r in reqs}
    # one step on a throwaway cache first, so that both policies start with
    # the allocator and cuBLAS warm (its launches are not counted)
    step(params, RT.init_pipeline_cache(cfg, plan, n_slots, max_len,
                                        device="cuda"),
         dict(tokens=torch.zeros(n_slots, chunk, dtype=torch.long,
                                 device="cuda"),
              n_valid=torch.ones(n_slots, dtype=torch.int32, device="cuda")))
    res, tokens = {}, {}
    for policy in ("continuous", "sequential"):
        stamps = []

        def fenced(p, c, b):
            arm = (capture is not None and capture.args is None
                   and policy == "continuous")
            if arm:
                nv = b["n_valid"][:mb].cpu()
                arm = bool((nv > 1).any() and (nv == 1).any())
            with capture if arm else contextlib.nullcontext():
                lg, c = step(p, c, b)
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            return lg, c

        cache = RT.init_pipeline_cache(cfg, plan, n_slots, max_len,
                                       device="cuda")
        eng = SS.ContinuousEngine(cfg, fenced, params, cache, n_slots, chunk)
        rs = copy.deepcopy(reqs)

        def run():
            if policy == "continuous":
                return eng.run(rs)
            done = []
            for r in sorted(rs, key=lambda q: q.arrival):
                r.arrival = eng.steps_run    # admit after the previous one
                done += eng.run([r])
            return done

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done, launches = counted(counters, run)
        wall = time.perf_counter() - t0
        n = 16 * M_ * eng.steps_run
        want = {"flash_attention": n,
                "flash_attention.prefill": n if route == "prefill" else 0,
                "flash_attention.decode": n if route == "decode" else 0,
                "flash_attention.bwd": 0, "ssd_scan": 0, "ssd_scan.bwd": 0}
        if launches != want:
            fail(f"{label} {policy}: kernel launches {launches}, want "
                 f"{want} (16 layers x M {M_} x {eng.steps_run} steps)")
        at = lambda i: stamps[min(i, len(stamps) - 1)] - t0
        lat_steps = [r.t_done - arrival[r.rid] + 1 for r in done]
        lat_ms = [1e3 * (at(r.t_done) - (at(arrival[r.rid] - 1)
                                         if arrival[r.rid] > 0 else 0.0))
                  for r in done]
        gen = sum(len(r.generated) for r in done)
        mixed = sum(1 for sp in eng.step_log
                    if {"prefill", "decode"} <= {w.kind for w in sp.work})
        res[policy] = dict(
            steps=eng.steps_run, wall_s=wall, generated=gen,
            tok_s=gen / wall, mixed_steps=mixed, launches=launches,
            latency_steps_p50=percentile(lat_steps, 50),
            latency_steps_p99=percentile(lat_steps, 99),
            latency_ms_p50=percentile(lat_ms, 50),
            latency_ms_p99=percentile(lat_ms, 99))
        print(f"{label} {policy}: {json.dumps(res[policy])}", flush=True)
        if len(done) != len(reqs):
            fail(f"{label} {policy}: {len(done)} of {len(reqs)} retired")
        tokens[policy] = {r.rid: r.generated for r in done}
        del eng, cache
    if tokens["continuous"] != tokens["sequential"]:
        bad = [i for i in tokens["sequential"]
               if tokens["continuous"][i] != tokens["sequential"][i]]
        fail(f"{label}: continuous tokens differ from the sequential "
             f"policy's for requests {bad}")
    if not res["continuous"]["mixed_steps"]:
        fail(f"{label}: no continuous step mixed prefill and decode")
    print(f"{label}: tokens bit-identical between the policies over "
          f"{len(reqs)} requests", flush=True)
    del params, step
    torch.cuda.empty_cache()
    return res


def phase_mixed_attention(FA, captures: dict, launches: dict) -> list:
    """Phase 26: the captured first-layer attention of a mixed step against
    ``attend_ref`` (f32, phase 3's tolerance), with the kernel's, the plain
    version's and SDPA's device times, the bound, and the launches of the
    engine run it came from."""
    rows = []
    for label, (q, k, v, kw) in captures.items():
        row = attention_row(
            FA, f"mixed step {label} B={q.shape[0]} T={q.shape[1]} "
            f"S={k.shape[1]} Hq={q.shape[2]} Hkv={k.shape[2]} "
            f"D={q.shape[3]} q_start={kw['q_start'].tolist()}",
            q, k, v, kw["q_start"], kw["kv_len"], kw["causal"],
            lambda: FA.flash_attend(q, k, v, **kw),
            lambda: FA.attend_ref(q, k, v, **kw), q.dtype, kw["window"])
        row["launches"] = launches[label]
        rows.append(row)
        if not row["ok"]:
            fail(f"mixed step {label}: the kernel is {row['max_abs_err']:.3e} "
                 f"from its plain version (bar {row['tol']})")
    return rows


def phase_gemma_mixed(serve_mods) -> float:
    """Phase 26, then: gemma3-1b at full width and 2 layers (the first
    local, window 512; the second global), a prefill step of 544 columns
    with per-slot ``n_valid`` (544, 544, 520, idle), then a mixed step of
    64 columns (a prefill chunk, two decodes past the window, an idle
    slot), on the card and on the CPU with the same weights; busy slots'
    logits compared as in phase 5.  Returns the largest difference."""
    get_config, RT, ST = serve_mods
    cfg = dataclasses.replace(get_config("gemma3-1b"), n_layers=2, stages=2,
                              tensor=1, global_every=2)
    plan = ST.plan_stages(cfg)
    B, P, C, max_len = 4, 544, 64, 640
    pcfg = RT.PipelineConfig(n_microbatches=2)
    steps = [(RT.make_serve_step(cfg, plan, pcfg, q_len=P), [P, P, 520, 0]),
             (RT.make_serve_step(cfg, plan, pcfg, q_len=C), [C, 1, 1, 0])]
    params = ST.init_stacked_params(cfg, 0, plan, device="cuda")
    g = torch.Generator().manual_seed(2)
    toks = [torch.randint(0, cfg.vocab, (B, q), generator=g) for q in (P, C)]
    logits = {}
    for dev in ("cuda", "cpu"):
        p = _to(params, dev)
        cache = RT.init_pipeline_cache(cfg, plan, B, max_len, device=dev)
        out = []
        for (step, nv), tk in zip(steps, toks):
            lg, cache = step(p, cache, dict(
                tokens=tk.to(dev),
                n_valid=torch.tensor(nv, dtype=torch.int32, device=dev)))
            out.append(lg[:3, 0])             # the busy slots
        logits[dev] = torch.stack(out).cpu()
        del p, cache
    a, b = logits["cuda"], logits["cpu"]
    err = (a - b).abs().max().item()
    rel = ((a - b).abs() / (PATH_TOL + PATH_TOL * b.abs())).max().item()
    print(f"parity gemma3-1b mixed step: 2 layers (window 512, global), "
          f"slots at offsets 544 / 544 / 520 / idle past the window, card "
          f"vs CPU: max |diff| {err:.3e} (|a-b| <= {PATH_TOL} + "
          f"{PATH_TOL}|b|: worst ratio {rel:.3f})", flush=True)
    if rel > 1.0 or not torch.isfinite(a).all():
        fail(f"gemma3-1b mixed step: card and CPU logits differ by {err:.3e}")
    del params
    torch.cuda.empty_cache()
    return err


# ---------------------------------------------------------------------------
# Phases 27-28: stages on separate ranks (gloo on the one card).
# ---------------------------------------------------------------------------

#: phase 27's runs: (label, arch, ranks, layers, schedule, V, M); batch 4,
#: seq 512, full width; 3 layers pad to 4 slots on 2 ranks, 4 layers to
#: 6 on 3 ranks
RANK_RUNS = (
    ("llama3.2-1b 2 ranks 1f1b", "llama3.2-1b", 2, 3, "1f1b", 1, 2),
    ("llama3.2-1b 2 ranks zb-h1", "llama3.2-1b", 2, 3, "zb-h1", 1, 2),
    ("llama3.2-1b 2 ranks 1f1b-interleaved V=2 M=4", "llama3.2-1b", 2, 3,
     "1f1b-interleaved", 2, 4),
    ("llama3.2-1b 3 ranks 1f1b", "llama3.2-1b", 3, 4, "1f1b", 1, 2),
    ("mamba2-2.7b 2 ranks 1f1b", "mamba2-2.7b", 2, 3, "1f1b", 1, 2),
)
RANK_BATCH, RANK_SEQ = 4, 512


def card_flags() -> None:
    """The numerics every process of this script runs with: f32 products
    in f32 (no TF32) and one cuBLAS workspace configuration (its
    algorithm choice, hence its bits, may depend on the workspace), set
    before the first cuBLAS call; spawned ranks inherit the variable and
    call this too."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rank_parity(mesh, runs) -> list:
    """Phase 27 on one rank (a spawned process): each run of ``runs`` for
    this world size through the rank executor under ``runtime='ticks'``
    and ``'stream'``, then on the in-process (ticks) executor in this
    process with the same weights (the seed) and batch; this rank's loss
    and gradient share of each rank run against the in-process run's,
    every run's launch counts (set to 0 just before each, read just
    after), stash counts, most registers held live and transport."""
    card_flags()
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.pipeline import runtime as RT
    from repro_torch.pipeline import stage as ST
    counters = dict(flash_attention=FA.flash_attend, ssd_scan=SSD.ssd_chunked)
    out = []
    for label, arch, S, L, schedule, V, M_ in runs:
        if S != mesh.world:
            continue
        cfg = dataclasses.replace(get_config(arch), n_layers=L, stages=S,
                                  tensor=1, virtual=V)
        plan = ST.plan_stages(cfg)
        batch = SyntheticLM(cfg.vocab, RANK_SEQ, RANK_BATCH, seed=0,
                            device=str(mesh.device)).batch(0)
        got = {}
        for runtime in ("ticks", "stream"):
            step = RT.make_train_step(cfg, plan, RT.PipelineConfig(
                n_microbatches=M_, schedule=schedule, runtime=runtime),
                group=mesh.group)
            params = ST.init_stage_params(cfg, 0, plan, mesh.rank,
                                          device=mesh.device)
            (loss, grads), launches = counted(counters,
                                              lambda: step(params, batch))
            torch.cuda.synchronize()
            got[runtime] = dict(
                loss=loss, grads=grads, launches=launches,
                stash=step.stash_slots, live=step.live_registers,
                transport={k: list(v)
                           for k, v in step.transport.stats.items()})
            del params, step
        ref_step = RT.make_train_step(cfg, plan, RT.PipelineConfig(
            n_microbatches=M_, schedule=schedule))
        full = ST.init_stacked_params(cfg, 0, plan, device=mesh.device)
        (ref_loss, ref_grads), ref_launches = counted(
            counters, lambda: ref_step(full, batch))
        want = ST.stage_share(ref_grads, plan, mesh.rank)
        row = dict(label=label, rank=mesh.rank, ref_loss=ref_loss.item(),
                   ref_launches=ref_launches,
                   ref_stash=ref_step.stash_slots)
        for runtime, g in got.items():
            leaves = []
            for (path, a), b in zip(_named_leaves(g["grads"]),
                                    ST.tree_leaves(want)):
                leaves.append(dict(
                    leaf=path, bitwise=bool(torch.equal(a, b)),
                    max_abs_diff=(a.float() - b.float()).abs().max().item(),
                    max_abs_ref=b.float().abs().max().item()))
            row[runtime] = dict(
                keys=sorted(g["grads"]) == sorted(want),
                loss=g["loss"].item(),
                loss_bitwise=bool(torch.equal(g["loss"], ref_loss)),
                leaves=leaves, launches=g["launches"], stash=g["stash"],
                live=g["live"], transport=g["transport"])
        out.append(row)
        del got, full, ref_grads, want, batch
        torch.cuda.empty_cache()
    return out


def _named_leaves(tree: dict, prefix: str = "") -> list:
    """(path, leaf) in ``tree_leaves`` order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}{k}"
        out += (_named_leaves(v, path + "/") if isinstance(v, dict)
                else [(path, v)])
    return out


def phase_rank_parity(mesh_mod) -> dict:
    """Phase 27: :data:`RANK_RUNS` on gloo ranks sharing the one card
    (one spawn per world size), each under the tick and the stream
    runtime, against the in-process executor on the card; bit for bit,
    each rank's launches summing to the in-process run's exactly, and
    the stream run's hop messages and bytes on every rank equal to the
    tick run's."""
    res, t0 = {}, time.perf_counter()
    worlds = sorted({r[2] for r in RANK_RUNS})
    # the world sizes' spawns at once (nothing here is timed): each
    # thread waits on its processes
    with concurrent.futures.ThreadPoolExecutor(len(worlds)) as pool:
        spawned = {w: pool.submit(mesh_mod.spawn_ranks, rank_parity, w,
                                  "gloo", RANK_RUNS, device="cuda")
                   for w in worlds}
        done = {w: f.result() for w, f in spawned.items()}
    print(f"ranks: {' and '.join(map(str, worlds))} gloo ranks on one card, "
          f"ticks and stream, spawned at once and run in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    for world, per_rank in done.items():
        for i, run in enumerate(per_rank[0]):
            ref = run["ref_launches"]
            for runtime in ("ticks", "stream"):
                rows = [pr[i][runtime] | dict(rank=pr[i]["rank"],
                                              ref_stash=pr[i]["ref_stash"],
                                              ref_launches=pr[i][
                                                  "ref_launches"])
                        for pr in per_rank]
                label = run["label"] + (" stream" if runtime == "stream"
                                        else "")
                summed = {k: sum(r["launches"][k] for r in rows)
                          for k in ref}
                gaps = [dict(rank=r["rank"], **lf) for r in rows
                        for lf in r["leaves"] if not lf["bitwise"]]
                bitwise = (all(r["loss_bitwise"] and r["keys"]
                               for r in rows) and not gaps)
                stash_ok = all(r["stash"] == r["ref_stash"][r["rank"]]
                               for r in rows)
                hop = [r["transport"]["hop"] for r in rows]
                res[label] = dict(
                    ranks=world, runtime=runtime, loss=rows[0]["loss"],
                    ref_loss=run["ref_loss"], bitwise=bitwise,
                    n_leaves=sum(len(r["leaves"]) for r in rows),
                    launches_summed=summed, ref_launches=ref,
                    stash=[r["stash"] for r in rows],
                    ref_stash=run["ref_stash"],
                    live_registers=[r["live"] for r in rows],
                    hop_messages=[h[0] for h in hop],
                    hop_bytes=[h[1] for h in hop],
                    hop_recv_wait_ms=[h[5] * 1e3 for h in hop],
                    hop_post_ms=[h[4] * 1e3 for h in hop],
                    transport=[r["transport"] for r in rows])
                print(f"ranks {label}: loss {rows[0]['loss']!r} (in-process "
                      f"{run['ref_loss']!r}), loss and "
                      f"{res[label]['n_leaves']} gradient leaves bit for "
                      f"bit: {bitwise}; launches summed over ranks "
                      f"{json.dumps(summed)} (in-process {json.dumps(ref)}); "
                      f"stash per rank {res[label]['stash']} (in-process "
                      f"{run['ref_stash']}); registers live at most per rank "
                      f"{res[label]['live_registers']}; hop messages / bytes "
                      f"/ receive-wait ms per rank "
                      f"{res[label]['hop_messages']} / "
                      f"{res[label]['hop_bytes']} / "
                      f"{[round(x, 1) for x in res[label]['hop_recv_wait_ms']]}"
                      f"; transport {json.dumps(res[label]['transport'])}",
                      flush=True)
                if not bitwise:
                    worst = sorted(gaps, key=lambda g: -g["max_abs_diff"]
                                   / (g["max_abs_ref"] + 1e-30))[:8]
                    fail(f"ranks {label}: not bit for bit against the "
                         f"in-process executor; losses "
                         f"{[r['loss'] for r in rows]} vs {run['ref_loss']}; "
                         f"{len(gaps)} leaves differ, worst "
                         f"{json.dumps(worst)}")
                if summed != ref or any(r["ref_launches"] != ref
                                        for r in rows):
                    fail(f"ranks {label}: launches summed over ranks "
                         f"{summed}, in-process {ref}")
                if not stash_ok:
                    fail(f"ranks {label}: stash per rank "
                         f"{res[label]['stash']}, in-process "
                         f"{run['ref_stash']}")
            ticks, stream = res[run["label"]], res[run["label"] + " stream"]
            if (stream["hop_messages"], stream["hop_bytes"]) != (
                    ticks["hop_messages"], ticks["hop_bytes"]):
                fail(f"ranks {run['label']}: stream hop messages / bytes "
                     f"{stream['hop_messages']} / {stream['hop_bytes']}, "
                     f"ticks {ticks['hop_messages']} / "
                     f"{ticks['hop_bytes']}")
    return res


def rank_train(mesh, argv: list) -> dict:
    """Phase 28 on one rank: ``launch.train.main`` as this rank's stage;
    what it returned, without the parameters."""
    card_flags()
    from repro_torch.launch import train
    out = train.main(argv, mesh=mesh)
    return {k: v for k, v in out.items()
            if k not in ("params", "opt_state", "plan")}


def phase_rank_train(mesh_mod, SP, trained: dict, runtime: str = "ticks",
                     ticks_run: dict = None) -> dict:
    """Phase 28 (``runtime='ticks'``) and 31 (``'stream'``, beside phase
    28's ``ticks_run``): llama3.2-1b at full width as 4 gloo ranks on the
    one card through ``launch.train.main`` (phase 10's run: 4 stages x 4
    layers, 1f1b, M 4, batch 8, seq 1024, f32, 3 steps): the losses equal
    phase 10's to the bit, the launches summed over ranks are phase 10's
    a step, each rank's stash is its stage's peak-live count; under
    stream the hop messages and bytes a step equal phase 28's."""
    from repro_torch.pipeline import comm as C
    steps, M_, S = 3, 4, 4
    argv = ["--arch", "llama3.2-1b", "--tensor", "1", "--stages", str(S),
            "--schedule", "1f1b", "--microbatches", str(M_), "--batch", "8",
            "--seq", "1024", "--steps", str(steps), "--log-every", "1",
            "--device", "cuda", "--dist-backend", "gloo",
            "--runtime", runtime]
    tag = f"ranks train llama3.2-1b 4 ranks 1f1b M=4 {runtime}"
    print(f"{tag}: spawn_ranks(train.main, 4, 'gloo') of python -m "
          f"repro_torch.launch.train {' '.join(argv)}", flush=True)
    t0 = time.perf_counter()
    outs = mesh_mod.spawn_ranks(rank_train, S, "gloo", argv, device="cuda")
    wall = time.perf_counter() - t0
    out = outs[0]
    lo = SP.lower_to_ticks(SP.build_schedule("1f1b", M_, S))
    per_step = train_launches(16, M_, False, False)
    want_stash = [max(row) + 1 for row in lo.xw]
    after_first = sum(out["step_s"][1:]) / (steps - 1)
    last = out["transport"][-1]
    res = dict(runtime=runtime, losses=out["losses"],
               phase10_losses=trained["losses"],
               step_s=out["step_s"], step_ms_after_first=1e3 * after_first,
               phase10_step_ms_after_first=trained["step_ms_after_first"],
               launches_per_step=out["launches"], stash=out["stash_slots"],
               live_registers=out["live_registers"],
               peak_gib_by_rank=out["peak_gib_by_rank"],
               hop_messages_per_step=[sum(st["hop"][0] for st in tr)
                                      for tr in out["transport"]],
               hop_bytes_per_step=[sum(st["hop"][1] for st in tr)
                                   for tr in out["transport"]],
               # the slowest rank's, each step after the first
               max_rank_recv_wait_ms=[max(st["hop"][5] for st in tr) * 1e3
                                      for tr in out["transport"][1:]],
               max_rank_post_ms=[max(st["hop"][4] for st in tr) * 1e3
                                 for tr in out["transport"][1:]],
               transport_last_step=last, wall_s=wall)
    by_kind = {k: dict(
        messages=sum(st[k][0] for st in last),
        bytes=sum(st[k][1] for st in last),
        max_rank_ms=max(st[k][2] for st in last) * 1e3,
        max_rank_copy_ms=max(st[k][3] for st in last) * 1e3,
        max_rank_post_ms=max(st[k][4] for st in last) * 1e3,
        max_rank_recv_wait_ms=max(st[k][5] for st in last) * 1e3,
        max_rank_send_wait_ms=max(st[k][6] for st in last) * 1e3)
        for k in ("hop", "embed_allreduce", "scalars")}
    res["transport_by_kind_last_step"] = by_kind
    beside = ("" if ticks_run is None else
              f" (phase 28, ticks, in this run: "
              f"{ticks_run['step_ms_after_first']:.1f} ms, peak "
              f"{[round(p, 2) for p in ticks_run['peak_gib_by_rank']]} GiB, "
              f"slowest rank's receive waits "
              f"{[round(x, 1) for x in ticks_run['max_rank_recv_wait_ms']]} "
              f"ms and posts "
              f"{[round(x, 1) for x in ticks_run['max_rank_post_ms']]} ms)")
    print(f"{tag}: losses {out['losses']} (phase 10 {trained['losses']}), "
          f"step {res['step_ms_after_first']:.1f} ms after the first, the "
          f"slowest rank's (phase 10, one process: "
          f"{trained['step_ms_after_first']:.1f} ms), peak memory per rank "
          f"{[round(p, 2) for p in out['peak_gib_by_rank']]} GiB, slowest "
          f"rank's receive waits "
          f"{[round(x, 1) for x in res['max_rank_recv_wait_ms']]} ms and "
          f"posts {[round(x, 1) for x in res['max_rank_post_ms']]} ms a "
          f"step after the first{beside}; stash per rank "
          f"{out['stash_slots']} (want {want_stash}, n_x {lo.n_x}), "
          f"registers live at most per rank {out['live_registers']}, "
          f"launches per step summed over ranks {json.dumps(out['launches'])} "
          f"(want {json.dumps(per_step)}), hop messages per step "
          f"{res['hop_messages_per_step']} (each counted at both ends), "
          f"transport last step (over all ranks; ms of the slowest rank) "
          f"{json.dumps(by_kind)}; spawn to exit {wall:.1f}s", flush=True)
    if out["losses"] != trained["losses"]:
        fail(f"{tag}: losses {out['losses']} != phase 10's "
             f"{trained['losses']}")
    if any(d != per_step for d in out["launches"]):
        fail(f"{tag}: launches per step {out['launches']}, want {per_step}")
    if out["stash_slots"] != want_stash or max(want_stash) != lo.n_x:
        fail(f"{tag}: stash per rank {out['stash_slots']}, want "
             f"{want_stash} (n_x {lo.n_x})")
    # every ring hop of the table, counted at its sender and its receiver
    n_hops = sum(len(h) for h in C.ring_hops(lo))
    if any(n != 2 * n_hops for n in res["hop_messages_per_step"]):
        fail(f"{tag}: hop messages per step {res['hop_messages_per_step']}, "
             f"want {2 * n_hops} ({n_hops} ring hops at both ends)")
    if ticks_run is not None and (
            res["hop_messages_per_step"], res["hop_bytes_per_step"]) != (
            ticks_run["hop_messages_per_step"],
            ticks_run["hop_bytes_per_step"]):
        fail(f"{tag}: hop messages / bytes per step "
             f"{res['hop_messages_per_step']} / {res['hop_bytes_per_step']}, "
             f"phase 28's {ticks_run['hop_messages_per_step']} / "
             f"{ticks_run['hop_bytes_per_step']}")
    return res


# ---------------------------------------------------------------------------
# Phases 29-30: serving on separate ranks (gloo on the one card).
# ---------------------------------------------------------------------------

#: phase 29's runs: (label, arch, layers, V of the prefill, M); 2 ranks,
#: batch 8, prompt 512, 8 tokens, full width; at V 2 M 4 stage 0 parks
#: each ring return for its next pass, then the handoff moves layers 1
#: and 2 between the ranks
SERVE_RANK_RUNS = (
    ("llama3.2-1b 2 ranks V=1 M=2", "llama3.2-1b", 4, 1, 2),
    ("llama3.2-1b 2 ranks V=2 M=4 + handoff", "llama3.2-1b", 4, 2, 4),
    ("mamba2-2.7b 2 ranks V=1 M=2", "mamba2-2.7b", 3, 1, 2),
)
SERVE_RANK_BATCH, SERVE_RANK_PROMPT, SERVE_RANK_GEN = 8, 512, 8
#: phase 29's engine: llama3.2-1b, 4 layers, 2 ranks, M 2, 4 slots,
#: chunk 32; 6 requests (prompts of 16-128 tokens, 8 new tokens, one
#: arrival every 2 steps)
SERVE_RANK_ENGINE = dict(n_slots=4, chunk=32, max_len=128 + 8 + 32)


def _bitwise_tree(got: dict, want: dict) -> bool:
    a, b = _named_leaves(got), _named_leaves(want)
    return ([k for k, _ in a] == [k for k, _ in b]
            and all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b)))


def rank_serve_parity(mesh) -> list:
    """Phase 29 on one rank (a spawned process): each run of
    :data:`SERVE_RANK_RUNS` through the rank serve step, then on the
    in-process serve step in this process with the same weights (the
    seed) and prompt; every step's logits, the tokens, this rank's cache
    share and (V > 1) its layers and cache after the handoff against the
    in-process run's, both runs' launch counts (set to 0 just before
    each, read just after); then the engine run both ways."""
    card_flags()
    from repro_torch.configs import get_config
    from repro_torch.core import serve_sched as SS
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.pipeline import comm as C
    from repro_torch.pipeline import runtime as RT
    from repro_torch.pipeline import stage as ST
    counters = dict(flash_attention=FA.flash_attend, ssd_scan=SSD.ssd_chunked)
    dev, rank, group = mesh.device, mesh.rank, mesh.group
    row = lambda tree: ST._map_layers(lambda a: a[rank], tree)
    B, P, G = SERVE_RANK_BATCH, SERVE_RANK_PROMPT, SERVE_RANK_GEN
    out = []
    for label, arch, L, V, M_ in SERVE_RANK_RUNS:
        cfg = dataclasses.replace(get_config(arch), n_layers=L,
                                  stages=mesh.world, tensor=1, virtual=V)
        plan_p, plan = ST.plan_stages(cfg), ST.plan_stages(cfg, virtual=1)
        g = torch.Generator().manual_seed(1)
        prompt = torch.randint(0, cfg.vocab, (B, P), generator=g).to(dev)

        def serve(grp):
            """Prefill, the handoff at V > 1, G - 1 greedy decode steps."""
            steps = [RT.make_serve_step(cfg, pl, RT.PipelineConfig(
                n_microbatches=M_), q_len=q, group=grp)
                for pl, q in ((plan_p, P), (plan, 1))]
            if grp is None:
                params = ST.init_stacked_params(cfg, 0, plan_p, device=dev)
                cache = RT.init_pipeline_cache(cfg, plan_p, B, P + G,
                                               device=dev)
            else:
                params = ST.init_stage_params(cfg, 0, plan_p, rank,
                                              device=dev)
                cache = RT.init_stage_cache(cfg, plan_p, rank, B, P + G,
                                            device=dev)
            logits, tok, res = [], prompt, {}
            for i in range(G):
                lg, cache = steps[min(i, 1)](params, cache,
                                             dict(tokens=tok))
                logits.append(lg)
                tok = torch.argmax(lg[:, 0, :cfg.vocab], dim=-1)[:, None]
                if i == 0 and V > 1:
                    if grp is None:
                        ST.restack_tree_(params["layers"], plan_p, plan, L)
                        ST.restack_tree_(cache, plan_p, plan, L)
                    else:
                        tp = C.Transport(grp)
                        ST.restack_share_(params["layers"], plan_p, plan, L,
                                          rank, tp)
                        ST.restack_share_(cache, plan_p, plan, L, rank, tp)
                        res["handoff_transport"] = tp.stats
                    res["handoff"] = dict(
                        layers=params["layers"],
                        cache=ST._map_layers(torch.clone, cache))
            torch.cuda.synchronize()
            if grp is not None:
                res["transport"] = steps[1].transport.stats
            return dict(res, logits=logits, cache=cache)

        mine, launches = counted(counters, lambda: serve(group))
        ref, ref_launches = counted(counters, lambda: serve(None))
        ok = dict(
            logits=all(torch.equal(a, b) for a, b in zip(mine["logits"],
                                                          ref["logits"])),
            cache=_bitwise_tree(mine["cache"], row(ref["cache"])))
        if V > 1:
            ok["handoff_layers"] = _bitwise_tree(
                mine["handoff"]["layers"], row(ref["handoff"]["layers"]))
            ok["handoff_cache"] = _bitwise_tree(
                mine["handoff"]["cache"], row(ref["handoff"]["cache"]))
        gap = max((a - b).abs().max().item()
                  for a, b in zip(mine["logits"], ref["logits"]))
        out.append(dict(
            label=label, rank=rank, ok=ok, max_abs_logit_gap=gap,
            launches=launches, ref_launches=ref_launches,
            **{k: {kind: list(v) for kind, v in mine[k].items()}
               for k in ("transport", "handoff_transport") if k in mine}))
        del mine, ref
        torch.cuda.empty_cache()

    # the engine: every rank runs its own scheduler over the rank step
    cfg = dataclasses.replace(get_config("llama3.2-1b"), n_layers=4,
                              stages=mesh.world, tensor=1)
    plan = ST.plan_stages(cfg)
    e = SERVE_RANK_ENGINE
    runs = {}
    for grp in (group, None):
        step = RT.make_serve_step(cfg, plan, RT.PipelineConfig(
            n_microbatches=2), q_len=e["chunk"], group=grp)
        if grp is None:
            params = ST.init_stacked_params(cfg, 0, plan, device=dev)
            cache = RT.init_pipeline_cache(cfg, plan, e["n_slots"],
                                           e["max_len"], device=dev)
        else:
            params = ST.init_stage_params(cfg, 0, plan, rank, device=dev)
            cache = RT.init_stage_cache(cfg, plan, rank, e["n_slots"],
                                        e["max_len"], device=dev)
        eng = SS.ContinuousEngine(cfg, step, params, cache, e["n_slots"],
                                  e["chunk"])
        reqs = engine_requests(SS, cfg.vocab, 6, 16, 128, max_new=8)
        done, n = counted(counters, lambda: eng.run(reqs))
        torch.cuda.synchronize()
        runs[grp is None] = dict(
            launches=n, steps=eng.steps_run, cache=eng.cache,
            plans=[(sp.tokens.tolist(), sp.n_valid.tolist(),
                    [(w.kind, w.n_valid, w.rid) for w in sp.work])
                   for sp in eng.step_log],
            retired=[(r.rid, r.generated, r.t_first, r.t_done)
                     for r in done])
        del eng, params, cache, step
    mine, ref = runs[False], runs[True]
    out.append(dict(
        label="llama3.2-1b 2 ranks engine chunk 32", rank=rank,
        ok=dict(plans=mine["plans"] == ref["plans"],
                retired=mine["retired"] == ref["retired"],
                cache=_bitwise_tree(mine["cache"], row(ref["cache"]))),
        steps=mine["steps"], retired=len(mine["retired"]),
        mixed_steps=sum(1 for p in mine["plans"]
                        if {"prefill", "decode"} <= {w[0] for w in p[2]}),
        launches=mine["launches"], ref_launches=ref["launches"]))
    del runs
    torch.cuda.empty_cache()
    return out


def phase_rank_serve_parity(mesh_mod) -> dict:
    """Phase 29: :data:`SERVE_RANK_RUNS` and the engine on 2 gloo ranks
    sharing the one card against the in-process serve step on the card;
    bit for bit, and the ranks' launches summing to the in-process run's
    exactly."""
    t0 = time.perf_counter()
    per_rank = mesh_mod.spawn_ranks(rank_serve_parity, 2, "gloo",
                                    device="cuda")
    print(f"ranks serve: 2 gloo ranks on one card, run in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    res = {}
    for i, run in enumerate(per_rank[0]):
        rows = [pr[i] for pr in per_rank]
        label = run["label"]
        summed = {k: sum(r["launches"][k] for r in rows)
                  for k in run["launches"]}
        ref = run["ref_launches"]
        bitwise = all(all(r["ok"].values()) for r in rows)
        res[label] = dict(bitwise=bitwise, checks=[r["ok"] for r in rows],
                          launches_summed=summed, ref_launches=ref,
                          **{k: run[k] for k in ("steps", "retired",
                                                 "mixed_steps",
                                                 "max_abs_logit_gap")
                             if k in run},
                          **{k: [r[k] for r in rows]
                             for k in ("transport", "handoff_transport")
                             if k in run})
        print(f"ranks serve {label}: bit for bit against the in-process "
              f"step: {bitwise} {json.dumps([r['ok'] for r in rows])}; "
              f"launches summed over ranks {json.dumps(summed)} "
              f"(in-process {json.dumps(ref)}); "
              + json.dumps({k: v for k, v in res[label].items()
                            if k not in ("bitwise", "checks",
                                         "launches_summed",
                                         "ref_launches")}), flush=True)
        if not bitwise:
            fail(f"ranks serve {label}: not bit for bit against the "
                 f"in-process serve step: {[r['ok'] for r in rows]}")
        if summed != ref or any(r["ref_launches"] != ref for r in rows) \
                or not any(summed.values()):
            fail(f"ranks serve {label}: launches summed over ranks "
                 f"{summed}, in-process {ref}")
        if "mixed_steps" in run and not run["mixed_steps"]:
            fail(f"ranks serve {label}: no step mixed prefill and decode")
    return res


def rank_serve(mesh, argv: list) -> dict:
    """Phase 30 on one rank: ``launch.serve.main`` as this rank's stage,
    every kernel's launch counters set to 0 just before it and read just
    after; what it returned, without the logits."""
    card_flags()
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.launch import serve
    out, launches = counted(
        dict(flash_attention=FA.flash_attend, ssd_scan=SSD.ssd_chunked),
        lambda: serve.main(argv, mesh=mesh))
    keep = {k: v for k, v in out.items()
            if k not in ("last_logits", "prefill_logits", "lowerings")}
    return dict(keep, own_launches=launches)


def phase_rank_serve(mesh_mod, interleaved: dict) -> dict:
    """Phase 30: llama3.2-1b at full width as 4 gloo ranks on the one card
    through ``launch.serve.main`` with phase 23's flags (16 layers on 4
    stages, ``--virtual 2``, M 4, batch 8, prompt 512, 32 tokens, f32):
    the tokens equal phase 23's in-process V = 2 run bit for bit, the
    flash launches summed over ranks are phase 23's, each rank's
    handoff peak stays at or below what it held before plus its largest
    leaf."""
    argv = ["--arch", "llama3.2-1b", "--tensor", "1", "--stages", "4",
            "--microbatches", "4", "--batch", "8", "--prompt-len", "512",
            "--gen", "32", "--device", "cuda", "--virtual", "2",
            "--dist-backend", "gloo"]
    tag = "ranks serve llama3.2-1b 4 ranks V=2 M=4"
    print(f"{tag}: spawn_ranks(serve.main, 4, 'gloo') of python -m "
          f"repro_torch.launch.serve {' '.join(argv)}", flush=True)
    t0 = time.perf_counter()
    outs = mesh_mod.spawn_ranks(rank_serve, 4, "gloo", argv, device="cuda")
    wall = time.perf_counter() - t0
    out = outs[0]
    want = interleaved["llama_v2"]["launches"]
    summed = {k: sum(o["own_launches"][k] for o in outs) for k in want}
    h = out["handoff"]
    handoff = [handoff_memory(f"{tag} rank {r}", hr)
               for r, hr in enumerate(h["by_rank"])]
    by_kind = {}
    for phase in ("prefill", "handoff", "decode"):
        by_kind[phase] = {k: dict(
            messages=sum(t[phase][k][0] for t in out["transport"]),
            bytes=sum(t[phase][k][1] for t in out["transport"]),
            max_rank_ms=max(t[phase][k][2] for t in out["transport"]) * 1e3,
            max_rank_copy_ms=max(t[phase][k][3]
                                 for t in out["transport"]) * 1e3)
            for k in out["transport"][0][phase]
            if any(t[phase][k][0] for t in out["transport"])}
    res = dict(tokens_equal_phase23=out["tokens"].tolist()
               == interleaved["llama_v2_tokens"],
               prefill_tok_s=out["prefill_tok_s"],
               decode_tok_s=out["decode_tok_s"],
               phase23_prefill_tok_s=interleaved["llama_v2"]["prefill_tok_s"],
               phase23_decode_tok_s=interleaved["llama_v2"]["decode_tok_s"],
               handoff_ms=1e3 * h["seconds"],
               handoff_bytes_moved=by_kind["handoff"].get(
                   "handoff", {}).get("bytes", 0),
               handoff_by_rank=handoff,
               peak_gib_by_rank=out["peak_gib_by_rank"],
               launches_summed=summed, launches_by_serve=out["launches"],
               transport_by_kind=by_kind, wall_s=wall)
    print(f"{tag}: {json.dumps(res)} (phase 23 launches "
          f"{json.dumps(want)})", flush=True)
    if not res["tokens_equal_phase23"]:
        fail(f"{tag}: tokens differ from phase 23's in-process V = 2 run")
    if summed != want or out["launches"] != want:
        fail(f"{tag}: launches summed over ranks {summed} (serve.main "
             f"{out['launches']}), want phase 23's {want}")
    if any(o["tokens"].tolist() != out["tokens"].tolist() for o in outs):
        fail(f"{tag}: the ranks' tokens differ")
    return res


# ---------------------------------------------------------------------------
# Phases 32-33: the data axis (data 2 x stages 2 as 4 gloo ranks).
# ---------------------------------------------------------------------------

#: phase 32's run: llama3.2-1b at full width, data 2 x stages 2 (16 layers
#: on 2 stages), 1f1b, M 2 a replica (2-row micro-batches, phase 10's),
#: batch 8, seq 1024, f32, 2 steps, the stream runtime
DATA_TRAIN = ["--arch", "llama3.2-1b", "--tensor", "1", "--stages", "2",
              "--data", "2", "--schedule", "1f1b", "--microbatches", "2",
              "--batch", "8", "--seq", "1024", "--steps", "2",
              "--log-every", "1", "--device", "cuda", "--dist-backend",
              "gloo", "--runtime", "stream"]
#: 2bw's depth when the card has no room for it at full depth
TWO_BW_LAYERS = 8


def _tree_bytes(tree: dict, ST) -> int:
    return sum(x.numel() * x.element_size() for x in ST.tree_leaves(tree))


def rank_data_train(mesh) -> dict:
    """Phase 32 on one rank: ``train.main`` with phase 32's flags under
    ``--grad-sync end``, then ``overlap``; then 2bw through the rank step
    for 2 steps, at full depth if the card has room for one more
    gradient copy on every rank after the first two (else at
    ``TWO_BW_LAYERS`` layers, with an end step at that depth to hold step
    0's loss to)."""
    card_flags()
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import train
    from repro_torch.optim.adamw import AdamW, warmup_cosine
    from repro_torch.pipeline import runtime as RT
    from repro_torch.pipeline import stage as ST
    out, share = {}, 0
    for gs in ("end", "overlap"):
        r = train.main(DATA_TRAIN + ["--grad-sync", gs], mesh=mesh)
        share = _tree_bytes(r["params"], ST)
        out[gs] = {k: v for k, v in r.items()
                   if k not in ("params", "opt_state", "plan")}
        del r
        torch.cuda.empty_cache()
    # room for 2bw: every rank's peak so far plus one more gradient copy
    # (its parameters' bytes), against the card's free memory now
    dist.barrier()
    free = torch.cuda.mem_get_info(mesh.device)[0]
    peak = torch.cuda.max_memory_allocated(mesh.device)
    per = MESH.gather((free, peak + share), mesh)
    need, have = sum(p[1] for p in per), min(p[0] for p in per)
    L = (get_config("llama3.2-1b").n_layers if need + 4 * 2**30 < have
         else TWO_BW_LAYERS)
    cfg = dataclasses.replace(get_config("llama3.2-1b"), tensor=1, stages=2,
                              n_layers=L)
    plan = ST.plan_stages(cfg)
    data = SyntheticLM(cfg.vocab, 1024, 8, seed=0, device=str(mesh.device))
    params = ST.init_stage_params(cfg, 0, plan, mesh.stage,
                                  device=mesh.device)
    kw = dict(n_microbatches=2, schedule="1f1b", runtime="stream")
    if L == get_config("llama3.2-1b").n_layers:
        end_loss0 = out["end"]["losses"][0]
    else:
        step = RT.make_train_step(cfg, plan, RT.PipelineConfig(
            grad_sync="end", **kw), group=mesh)
        end_loss0 = float(step(params, data.batch(0))[0])
        del step
    opt = AdamW(lr=warmup_cosine(3e-3, 20, 2), weight_decay=0.01)
    step = RT.make_train_step(cfg, plan, RT.PipelineConfig(
        grad_sync="2bw", **kw), optimizer=opt, group=mesh)
    state = RT.init_2bw_state(opt.init(params), params)
    torch.cuda.reset_peak_memory_stats(mesh.device)
    losses, step_s = [], []
    for k in range(2):
        torch.cuda.synchronize(mesh.device)
        dist.barrier()
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, data.batch(k))
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t0)
    out["2bw"] = dict(
        layers=L, free_gib=have / 2**30, need_gib=need / 2**30,
        losses=losses, end_loss0=end_loss0, step_s=step_s,
        peak_gib=torch.cuda.max_memory_allocated(mesh.device) / 2**30,
        grad_sync=list(step.transport.stats["grad_sync"]))
    del params, state, step
    torch.cuda.empty_cache()
    return out


def phase_data_train(mesh_mod, trained: dict) -> dict:
    """Phase 32: llama3.2-1b at full width as data 2 x stages 2 (4 gloo
    ranks on the one card) through ``launch.train.main``: the end and
    overlap losses bitwise equal, step 0's within 1e-5 relative of phase
    10's (the same weights and batch), the flash launches summed over
    ranks phase 10's a step; 2bw's step 0 loss equal to end's."""
    tag = "ranks train llama3.2-1b data 2 x stages 2 1f1b M=2"
    print(f"{tag}: spawn_ranks(train.main, 4, 'gloo', data=2) of python -m "
          f"repro_torch.launch.train {' '.join(DATA_TRAIN)} --grad-sync "
          f"end | overlap, then 2bw", flush=True)
    t0 = time.perf_counter()
    outs = mesh_mod.spawn_ranks(rank_data_train, 4, "gloo", device="cuda",
                                data=2)
    wall = time.perf_counter() - t0
    per_step = train_launches(16, 4, False, False)   # phase 10's a step
    res = dict(wall_s=wall)
    for gs in ("end", "overlap"):
        o = outs[0][gs]
        last = o["transport"][-1]
        res[gs] = dict(
            losses=o["losses"], step_ms=[1e3 * s for s in o["step_s"]],
            launches_per_step=o["launches"],
            peak_gib_by_rank=o["peak_gib_by_rank"],
            # each rank's last step: messages, bytes, ms (of them copies,
            # posts, waits)
            grad_sync_by_rank=[dict(
                messages=st["grad_sync"][0], bytes=st["grad_sync"][1],
                ms=1e3 * st["grad_sync"][2], copy_ms=1e3 * st["grad_sync"][3],
                post_ms=1e3 * st["grad_sync"][4],
                wait_ms=1e3 * st["grad_sync"][5]) for st in last],
            transport_ms_by_rank={k: [round(1e3 * st[k][2], 1) for st in last]
                                  for k in last[0] if any(st[k][0]
                                                          for st in last)})
        print(f"{tag} {gs}: losses {o['losses']} (phase 10 step 0 "
              f"{trained['losses'][0]}), step ms {res[gs]['step_ms']} (the "
              f"slowest rank's), peak per rank "
              f"{[round(p, 2) for p in o['peak_gib_by_rank']]} GiB, flash "
              f"launches per step summed over ranks "
              f"{json.dumps(o['launches'])} (want {json.dumps(per_step)}), "
              f"grad_sync by rank {json.dumps(res[gs]['grad_sync_by_rank'])},"
              f" transport ms by kind and rank "
              f"{json.dumps(res[gs]['transport_ms_by_rank'])}", flush=True)
        if any(d != per_step for d in o["launches"]):
            fail(f"{tag} {gs}: launches per step {o['launches']}, want "
                 f"{per_step}")
        ref0 = trained["losses"][0]
        if abs(o["losses"][0] - ref0) > 1e-5 * abs(ref0):
            fail(f"{tag} {gs}: step 0 loss {o['losses'][0]} not within 1e-5 "
                 f"of phase 10's {ref0}")
        if not all(math.isfinite(x) for x in o["losses"]):
            fail(f"{tag} {gs}: losses not finite {o['losses']}")
    if res["end"]["losses"] != res["overlap"]["losses"]:
        fail(f"{tag}: overlap losses {res['overlap']['losses']} != end's "
             f"{res['end']['losses']}")
    tb = [o["2bw"] for o in outs]
    res["2bw"] = dict(layers=tb[0]["layers"], losses=tb[0]["losses"],
                      end_loss0=tb[0]["end_loss0"],
                      step_ms=[1e3 * max(t["step_s"][k] for t in tb)
                               for k in range(2)],
                      peak_gib_by_rank=[t["peak_gib"] for t in tb],
                      free_gib=tb[0]["free_gib"], need_gib=tb[0]["need_gib"],
                      grad_sync_bytes_by_rank=[t["grad_sync"][1] for t in tb])
    print(f"{tag} 2bw: {tb[0]['layers']} layers ("
          f"{'full depth' if tb[0]['layers'] == 16 else 'reduced depth'}: "
          f"{tb[0]['need_gib']:.1f} GiB wanted of {tb[0]['free_gib']:.1f} "
          f"free), {json.dumps(res['2bw'])}", flush=True)
    if any(t["losses"] != tb[0]["losses"] for t in tb):
        fail(f"{tag} 2bw: the ranks' losses differ")
    if tb[0]["losses"][0] != tb[0]["end_loss0"]:
        fail(f"{tag} 2bw: step 0 loss {tb[0]['losses'][0]} != end's "
             f"{tb[0]['end_loss0']}")
    print(f"{tag}: spawn to exit {wall:.1f}s", flush=True)
    return res


#: phase 33's flags: llama3.2-1b at full width on 2 stages, V 1, batch 8,
#: prompt 512, 32 tokens, f32 (the ranks add --data 2 and M 2 a replica;
#: the in-process run M 4: the same 2-row micro-batches)
DATA_SERVE = ["--arch", "llama3.2-1b", "--tensor", "1", "--stages", "2",
              "--batch", "8", "--prompt-len", "512", "--gen", "32",
              "--device", "cuda", "--dist-backend", "gloo"]


def rank_data_serve(mesh) -> dict:
    """Phase 33 on one rank: ``launch.serve.main`` at data 2, every
    kernel's launch counters set to 0 just before and read just after;
    rank 0 keeps every step's logits."""
    card_flags()
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.launch import serve
    out, launches = counted(
        dict(flash_attention=FA.flash_attend, ssd_scan=SSD.ssd_chunked),
        lambda: serve.main(DATA_SERVE + ["--data", "2", "--microbatches",
                                         "2"], mesh=mesh,
                           keep_logits=mesh.rank == 0))
    keep = {k: v for k, v in out.items()
            if k not in ("last_logits", "prefill_logits", "lowerings")}
    return dict(keep, own_launches=launches)


def phase_data_serve(mesh_mod, serve, counters: dict) -> dict:
    """Phase 33: ``serve.main`` at data 2 x stages 2 (4 gloo ranks on the
    one card) against the in-process serve of the same weights and
    prompts at data 1 (M 4): the greedy tokens equal, every step's logits
    within 2e-4, the flash launches summed over ranks the in-process
    run's."""
    tag = "ranks serve llama3.2-1b data 2 x stages 2 M=2"
    ref, ref_launches = counted(counters, lambda: serve.main(
        DATA_SERVE + ["--microbatches", "4"], keep_logits=True))
    torch.cuda.empty_cache()
    print(f"{tag}: spawn_ranks(serve.main, 4, 'gloo', data=2) of python -m "
          f"repro_torch.launch.serve {' '.join(DATA_SERVE)} --data 2 "
          f"--microbatches 2", flush=True)
    t0 = time.perf_counter()
    outs = mesh_mod.spawn_ranks(rank_data_serve, 4, "gloo", device="cuda",
                                data=2)
    wall = time.perf_counter() - t0
    out = outs[0]
    summed = {k: sum(o["own_launches"][k] for o in outs) for k in ref_launches}
    errs = [float((a - b).abs().max()) for a, b in zip(out["step_logits"],
                                                        ref["step_logits"])]
    ok = all(torch.allclose(a, b, atol=PATH_TOL, rtol=PATH_TOL)
             for a, b in zip(out["step_logits"], ref["step_logits"]))
    by_kind = {phase: {k: dict(
        messages=sum(t[phase][k][0] for t in out["transport"]),
        bytes=sum(t[phase][k][1] for t in out["transport"]),
        max_rank_ms=max(t[phase][k][2] for t in out["transport"]) * 1e3,
        max_rank_copy_ms=max(t[phase][k][3] for t in out["transport"]) * 1e3)
        for k in out["transport"][0][phase]
        if any(t[phase][k][0] for t in out["transport"])}
        for phase in ("prefill", "decode")}
    res = dict(tokens_equal_data1=out["tokens"].tolist()
               == ref["tokens"].tolist(),
               logits_max_abs_err=max(errs), steps=len(errs),
               prefill_tok_s=out["prefill_tok_s"],
               decode_tok_s=out["decode_tok_s"],
               data1_prefill_tok_s=ref["prefill_tok_s"],
               data1_decode_tok_s=ref["decode_tok_s"],
               peak_gib_by_rank=out["peak_gib_by_rank"],
               launches_summed=summed, launches_data1=ref_launches,
               transport_by_kind=by_kind, wall_s=wall)
    print(f"{tag}: {json.dumps(res)}", flush=True)
    if not res["tokens_equal_data1"]:
        fail(f"{tag}: tokens differ from the in-process data-1 serve")
    if not ok or len(errs) != 32:
        fail(f"{tag}: logits differ from the in-process data-1 serve by "
             f"{max(errs)} (bar {PATH_TOL}) over {len(errs)} steps")
    if summed != ref_launches or out["launches"] != ref_launches:
        fail(f"{tag}: launches summed over ranks {summed} (serve.main "
             f"{out['launches']}), want the in-process run's {ref_launches}")
    if any(o["tokens"].tolist() != out["tokens"].tolist() for o in outs):
        fail(f"{tag}: the ranks' tokens differ")
    return res


# ---------------------------------------------------------------------------
# Phases 34-36: the tensor axis (Megatron tensor parallelism on gloo ranks
# sharing the one card; one spawn of 4 ranks for the three phases).
# ---------------------------------------------------------------------------

#: phase 34's runs: (label, arch, grid, layers, schedule, runtime, batch,
#: seq, M, config changes); full width; the grid "S2T2" is stages 2 x
#: tensor 2, "S1T4" stages 1 x tensor 4 (gemma3's one kv head replicated
#: over the shards and sliced; one local layer, window 512, and one
#: global)
TENSOR_PARITY_RUNS = (
    ("llama3.2-1b S2T2 1f1b ticks", "llama3.2-1b", "S2T2", 3, "1f1b",
     "ticks", 4, 512, 2, {}),
    ("llama3.2-1b S2T2 1f1b stream", "llama3.2-1b", "S2T2", 3, "1f1b",
     "stream", 4, 512, 2, {}),
    ("llama3.2-1b S2T2 zb-h1 ticks", "llama3.2-1b", "S2T2", 3, "zb-h1",
     "ticks", 4, 512, 2, {}),
    ("llama3.2-1b S2T2 zb-h1 stream", "llama3.2-1b", "S2T2", 3, "zb-h1",
     "stream", 4, 512, 2, {}),
    ("gemma3-1b S1T4 1f1b ticks", "gemma3-1b", "S1T4", 2, "1f1b", "ticks",
     4, 1024, 2, dict(global_every=2)),
)
#: the grids of the 4 ranks: (data, stages, tensor)
TENSOR_GRIDS = {"S2T2": (1, 2, 2), "S1T4": (1, 1, 4)}
#: phase 35's run: llama3.2-1b at full width and depth on stages 2 x
#: tensor 2 (its config's tensor degree), phase 10's schedule, M, batch,
#: seq and weights, 2 steps
TENSOR_TRAIN = ["--arch", "llama3.2-1b", "--stages", "2", "--schedule",
                "1f1b", "--microbatches", "4", "--batch", "8", "--seq",
                "1024", "--steps", "2", "--log-every", "1", "--device",
                "cuda", "--dist-backend", "gloo"]
#: phase 35's planner run: phase 14's homogeneous --auto-plan at --stages
#: 4 (its plan: stages 1 x tensor 4, M 1, one micro-batch of 8 rows), one
#: step, each layer recomputed in the backward (--remat full: the one
#: micro-batch's 16 layers of activations would not fit four ranks)
TENSOR_AUTO_PLAN = ["--arch", "llama3.2-1b", "--tensor", "1", "--stages",
                    "4", "--batch", "8", "--seq", "1024", "--steps", "1",
                    "--device", "cuda", "--dist-backend", "gloo",
                    "--auto-plan", "--remat", "full"]
#: phase 36's runs: (label, arch, grid, layers, batch, prompt, tokens, M,
#: config changes); llama3.2-1b at full width and depth, gemma3-1b at 2
#: layers (one local, one global) with a prompt past its window
TENSOR_SERVE_RUNS = (
    ("llama3.2-1b S2T2", "llama3.2-1b", "S2T2", 16, 8, 512, 32, 2, {}),
    ("gemma3-1b S1T4 2 layers", "gemma3-1b", "S1T4", 2, 4, 640, 8, 1,
     dict(global_every=2)),
)
#: phase 36's engine: llama3.2-1b at full width, 2 layers, stages 2 x
#: tensor 2, M 1, 4 slots, chunk 32, 6 requests
TENSOR_ENGINE = dict(layers=2, n_slots=4, chunk=32, max_len=128 + 8 + 32,
                     n_req=6)


def _tensor_cfg(get_config, arch: str, grid: str, layers: int, over: dict):
    _, S, T = TENSOR_GRIDS[grid]
    return dataclasses.replace(get_config(arch), n_layers=layers, stages=S,
                               tensor=T, virtual=1, **over)


def serve_forced(RT, ST, cfg, plan, M_: int, params: dict, cache: dict,
                 prompt, gen: int, forced=None, mesh=None) -> dict:
    """Prefill ``prompt``, then ``gen - 1`` decode steps, each fed
    ``forced[:, k]`` (teacher forcing) or, without ``forced``, the greedy
    token; every step's f32 logits over the vocab (on the host), the
    greedy tokens, and the prefill's and decode's seconds (each phase
    starting with the card idle and, on ranks, every rank at a
    barrier)."""
    import torch.distributed as dist
    steps = [RT.make_serve_step(cfg, plan, RT.PipelineConfig(
        n_microbatches=M_), q_len=q, group=mesh)
        for q in (prompt.shape[1], 1)]

    def start():
        torch.cuda.synchronize()
        if mesh is not None:
            dist.barrier()
        return time.perf_counter()

    logits, toks, secs, tok = [], [], [], prompt
    for phase in (0, 1):
        t0 = start()
        for k in range(1 if phase == 0 else gen - 1):
            lg, cache = steps[phase](params, cache, dict(tokens=tok))
            lg = lg[:, 0, :cfg.vocab]
            logits.append(lg.cpu())
            toks.append(torch.argmax(lg, dim=-1))
            nxt = len(toks) - 1
            tok = (toks[-1] if forced is None else forced[:, nxt])[:, None]
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return dict(logits=logits, tokens=torch.stack(toks, 1).cpu(),
                prefill_s=secs[0], decode_s=secs[1],
                transport=None if mesh is None else {
                    k: list(v) for k, v in steps[1].transport.stats.items()})


def tensor_parity(mesh, run) -> dict:
    """One phase-34 run on this rank: the rank executor's loss and
    gradient share, then the in-process tensor-1 executor's on the same
    weights (the seed) and batch in this process; per gradient leaf the
    largest difference of this rank's share from the in-process
    gradient's slice and that slice's largest value, both runs' launch
    counts (set to 0 just before each, read just after)."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.pipeline import runtime as RT
    from repro_torch.pipeline import stage as ST
    counters = dict(flash_attention=FA.flash_attend, ssd_scan=SSD.ssd_chunked)
    label, arch, grid, L, schedule, runtime, B, seq, M_, over = run
    cfg = _tensor_cfg(get_config, arch, grid, L, over)
    plan = ST.plan_stages(cfg)
    batch = SyntheticLM(cfg.vocab, seq, B, seed=0,
                        device=str(mesh.device)).batch(0)
    step = RT.make_train_step(cfg, plan, RT.PipelineConfig(
        n_microbatches=M_, schedule=schedule, runtime=runtime), group=mesh)
    params = ST.init_stage_params(cfg, 0, plan, mesh.stage,
                                  tensor_rank=mesh.tensor_rank,
                                  device=mesh.device)
    (loss, grads), launches = counted(counters, lambda: step(params, batch))
    torch.cuda.synchronize()
    tensor_stats = list(step.transport.stats["tensor"])
    del params, step
    cfg1 = dataclasses.replace(cfg, tensor=1)
    plan1 = ST.plan_stages(cfg1)
    ref_step = RT.make_train_step(cfg1, plan1, RT.PipelineConfig(
        n_microbatches=M_, schedule=schedule))
    full = ST.init_stacked_params(cfg1, 0, plan1, device=mesh.device)
    (ref_loss, ref_grads), ref_launches = counted(
        counters, lambda: ref_step(full, batch))
    del full
    want = ST.tensor_share(ST.stage_share(ref_grads, plan1, mesh.stage), cfg,
                           plan, mesh.tensor_rank)
    leaves = [dict(leaf="/".join(p),
                   diff=(ST._leaf_at(grads, p).float()
                         - ST._leaf_at(want, p).float()).abs().max().item(),
                   ref=ST._leaf_at(want, p).float().abs().max().item())
              for p in ST.leaf_paths(want)]
    out = dict(label=label, rank=mesh.rank, stage=mesh.stage,
               tensor_rank=mesh.tensor_rank, loss=loss.item(),
               ref_loss=ref_loss.item(), launches=launches,
               ref_launches=ref_launches, leaves=leaves,
               keys=sorted(ST.leaf_paths(grads)) == sorted(
                   ST.leaf_paths(want)), tensor=tensor_stats)
    del grads, ref_grads, want, batch, ref_step
    torch.cuda.empty_cache()
    return out


def tensor_serve(mesh, run, prompt, forced) -> dict:
    """One phase-36 run on this rank: the rank serve step teacher-forced
    on the in-process tensor-1 run's tokens (``forced``), every kernel's
    launch counters set to 0 just before and read just after; rank 0
    keeps every step's logits."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.pipeline import runtime as RT
    from repro_torch.pipeline import stage as ST
    label, arch, grid, L, B, P, G, M_, over = run
    cfg = _tensor_cfg(get_config, arch, grid, L, over)
    plan = ST.plan_stages(cfg)
    params = ST.init_stage_params(cfg, 0, plan, mesh.stage,
                                  tensor_rank=mesh.tensor_rank,
                                  device=mesh.device)
    cache = RT.init_stage_cache(cfg, plan, mesh.stage, B, P + G,
                                device=mesh.device)
    torch.cuda.reset_peak_memory_stats(mesh.device)
    out, launches = counted(
        dict(flash_attention=FA.flash_attend, ssd_scan=SSD.ssd_chunked),
        lambda: serve_forced(RT, ST, cfg, plan, M_, params, cache,
                             prompt.to(mesh.device), G,
                             forced.to(mesh.device), mesh))
    out.update(launches=launches, peak_gib=torch.cuda.max_memory_allocated(
        mesh.device) / 2**30, k_heads=cache["kv"]["k"].shape[-2])
    if mesh.rank != 0:
        out["logits"] = None
    del params, cache
    torch.cuda.empty_cache()
    return out


def tensor_engine(mesh, reqs) -> dict:
    """Phase 36's engine on this rank: :data:`TENSOR_ENGINE` over the
    stages 2 x tensor 2 serve step; the retired requests' tokens."""
    from repro_torch.configs import get_config
    from repro_torch.core import serve_sched as SS
    from repro_torch.pipeline import runtime as RT
    from repro_torch.pipeline import stage as ST
    e = TENSOR_ENGINE
    cfg = _tensor_cfg(get_config, "llama3.2-1b", "S2T2", e["layers"], {})
    plan = ST.plan_stages(cfg)
    step = RT.make_serve_step(cfg, plan, RT.PipelineConfig(n_microbatches=1),
                              q_len=e["chunk"], group=mesh)
    params = ST.init_stage_params(cfg, 0, plan, mesh.stage,
                                  tensor_rank=mesh.tensor_rank,
                                  device=mesh.device)
    cache = RT.init_stage_cache(cfg, plan, mesh.stage, e["n_slots"],
                                e["max_len"], device=mesh.device)
    eng = SS.ContinuousEngine(cfg, step, params, cache, e["n_slots"],
                              e["chunk"])
    done = eng.run(reqs)
    return dict(retired=sorted((r.rid, list(r.generated)) for r in done),
                steps=eng.steps_run)


def rank_tensor(mesh, serve_work: dict) -> dict:
    """Phases 34-36 on one rank of the stages 2 x tensor 2 world (the
    stages 1 x tensor 4 grid made on the same ranks): phase 34's runs,
    phase 35's ``train.main`` runs, phase 36's serving runs (each
    teacher-forced on ``serve_work``'s prompt and tokens) and engine."""
    card_flags()
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import train
    grids = {"S2T2": mesh, "S1T4": MESH.make_grid(1, mesh.backend,
                                                  mesh.device, 4)}
    out = dict(parity=[tensor_parity(grids[r[2]], r)
                       for r in TENSOR_PARITY_RUNS])
    drop = ("params", "opt_state", "plan")
    for key, argv, grid in (("train", TENSOR_TRAIN, "S2T2"),
                            ("auto plan", TENSOR_AUTO_PLAN, "S1T4")):
        r = train.main(argv, mesh=grids[grid])
        out[key] = {k: v for k, v in r.items() if k not in drop}
        if r["plan"] is not None:
            p = r["plan"]
            out[key]["planned"] = dict(stages=p.stages, tensor=p.tensor,
                                       data=p.data_axis,
                                       microbatches=p.n_microbatches,
                                       schedule=p.schedule)
        del r
        torch.cuda.empty_cache()
    out["serve"] = {run[0]: tensor_serve(grids[run[2]], run,
                                         *serve_work[run[0]])
                    for run in TENSOR_SERVE_RUNS}
    out["engine"] = tensor_engine(grids["S2T2"], serve_work["engine"])
    return out


def phase_tensor(mesh_mod, mods, trained: dict) -> dict:
    """Phases 34-36: the tensor axis as 4 gloo ranks on the one card (one
    spawn), against the in-process tensor-1 executors on the card.

    34. :data:`TENSOR_PARITY_RUNS` (llama3.2-1b at 3 layers as stages 2 x
        tensor 2, 1f1b and zb-h1, ticks and stream; gemma3-1b at 2
        layers as stages 1 x tensor 4): the loss within 1e-5 relative,
        every gradient leaf, its shards gathered back, within the
        harness's 1e-4 relative; the flash launches summed over ranks T
        times the in-process run's (each shard attends its heads).
    35. :data:`TENSOR_TRAIN` through ``train.main``: step 0's loss within
        1e-5 relative of phase 10's, the launches summed over ranks twice
        phase 28's a step; then :data:`TENSOR_AUTO_PLAN`, whose plan
        (stages 1 x tensor 4) trains one step, its loss within 1e-5 of
        phase 10's step 0.
    36. :data:`TENSOR_SERVE_RUNS`: the prefill logits within 2e-4 of the
        in-process tensor-1 serve's, every decode step (fed the tensor-1
        run's tokens) too; the greedy tokens that agree are reported;
        the kv heads a rank holds; the flash launches summed over ranks
        T times the in-process run's; then :data:`TENSOR_ENGINE` against
        the in-process engine (tokens equal)."""
    get_config, RT, ST, SS, FA, SSD = mods
    counters = dict(flash_attention=FA.flash_attend, ssd_scan=SSD.ssd_chunked)
    # the in-process tensor-1 references of phase 36, here before the spawn
    work, refs = {}, {}
    for run in TENSOR_SERVE_RUNS:
        label, arch, grid, L, B, P, G, M_, over = run
        cfg = dataclasses.replace(_tensor_cfg(get_config, arch, grid, L,
                                              over), tensor=1)
        plan = ST.plan_stages(cfg)
        g = torch.Generator().manual_seed(1)
        prompt = torch.randint(0, cfg.vocab, (B, P), generator=g)
        params = ST.init_stacked_params(cfg, 0, plan, device="cuda")
        cache = RT.init_pipeline_cache(cfg, plan, B, P + G, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        ref, launches = counted(counters, lambda: serve_forced(
            RT, ST, cfg, plan, M_, params, cache, prompt.cuda(), G))
        ref.update(launches=launches,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        refs[label] = ref
        work[label] = (prompt, ref["tokens"])
        del params, cache
    e = TENSOR_ENGINE
    reqs = lambda: engine_requests(SS, get_config("llama3.2-1b").vocab,
                                   e["n_req"], 16, 128, max_new=8)
    cfg = dataclasses.replace(_tensor_cfg(get_config, "llama3.2-1b", "S2T2",
                                          e["layers"], {}), tensor=1)
    plan = ST.plan_stages(cfg)
    eng = SS.ContinuousEngine(
        cfg, RT.make_serve_step(cfg, plan, RT.PipelineConfig(
            n_microbatches=1), q_len=e["chunk"]),
        ST.init_stacked_params(cfg, 0, plan, device="cuda"),
        RT.init_pipeline_cache(cfg, plan, e["n_slots"], e["max_len"],
                               device="cuda"), e["n_slots"], e["chunk"])
    ref_engine = sorted((r.rid, list(r.generated)) for r in eng.run(reqs()))
    work["engine"] = reqs()         # fresh requests (a run fills them)
    del eng
    torch.cuda.empty_cache()
    print("tensor: spawn_ranks(rank_tensor, 4, 'gloo', tensor=2): phases "
          "34-36 as 4 ranks on one card", flush=True)
    t0 = time.perf_counter()
    outs = mesh_mod.spawn_ranks(rank_tensor, 4, "gloo", work, device="cuda",
                                tensor=2)
    wall = time.perf_counter() - t0
    res = dict(wall_s=wall, parity={}, serve={})

    # ---- 34. training parity ------------------------------------------------
    for i, run in enumerate(TENSOR_PARITY_RUNS):
        label, grid, T = run[0], run[2], TENSOR_GRIDS[run[2]][2]
        rows = [o["parity"][i] for o in outs]
        ref_launches = rows[0]["ref_launches"]
        summed = {k: sum(r["launches"][k] for r in rows) for k in ref_launches}
        want = {k: T * v for k, v in ref_launches.items()}
        worst = {}
        for r in rows:          # each leaf's shards gathered back
            for lf in r["leaves"]:
                d, m = worst.get(lf["leaf"], (0.0, 0.0))
                worst[lf["leaf"]] = (max(d, lf["diff"]), max(m, lf["ref"]))
        rel = {k: d / (m + 1e-30) for k, (d, m) in worst.items()}
        loss_rel = max(abs(r["loss"] - r["ref_loss"]) / abs(r["ref_loss"])
                       for r in rows)
        tensor_by_rank = [dict(messages=r["tensor"][0], bytes=r["tensor"][1],
                               ms=1e3 * r["tensor"][2],
                               copy_ms=1e3 * r["tensor"][3]) for r in rows]
        res["parity"][label] = dict(
            loss=rows[0]["loss"], ref_loss=rows[0]["ref_loss"],
            loss_rel=loss_rel, worst_leaf_rel=max(rel.values()),
            n_leaves=len(rel), launches_summed=summed,
            ref_launches=ref_launches, tensor_by_rank=tensor_by_rank)
        print(f"tensor parity {label}: {json.dumps(res['parity'][label])}",
              flush=True)
        if loss_rel > 1e-5 or not all(r["keys"] for r in rows):
            fail(f"tensor parity {label}: losses "
                 f"{[r['loss'] for r in rows]} against the in-process "
                 f"tensor-1 {rows[0]['ref_loss']} (bar 1e-5 relative)")
        if max(rel.values()) > 1e-4:
            bad = sorted(rel.items(), key=lambda kv: -kv[1])[:6]
            fail(f"tensor parity {label}: gradient leaves past 1e-4: {bad}")
        if summed != want:
            fail(f"tensor parity {label}: launches summed over ranks "
                 f"{summed}, want {T} x the in-process run's {ref_launches}")

    # ---- 35. training at full width -----------------------------------------
    tag = "tensor train llama3.2-1b stages 2 x tensor 2 1f1b M=4"
    o = outs[0]["train"]
    per_step = {k: 2 * v for k, v in train_launches(16, 4, False,
                                                    False).items()}
    steps = o["transport"]
    res["train"] = dict(
        losses=o["losses"], phase10_step0=trained["losses"][0],
        step_ms=[1e3 * s for s in o["step_s"]],
        launches_per_step=o["launches"], peak_gib_by_rank=o["peak_gib_by_rank"],
        # the tensor kind per rank per step: messages, bytes, ms, copies
        tensor_by_rank_step=[[dict(messages=st["tensor"][0],
                                   bytes=st["tensor"][1],
                                   ms=1e3 * st["tensor"][2],
                                   copy_ms=1e3 * st["tensor"][3])
                              for st in tr] for tr in steps],
        transport_ms_last_step={k: [round(1e3 * st[k][2], 1)
                                    for st in steps[-1]]
                                for k in steps[-1][0]
                                if any(st[k][0] for st in steps[-1])})
    print(f"{tag}: {json.dumps(res['train'])} (want launches "
          f"{json.dumps(per_step)} a step)", flush=True)
    ref0 = trained["losses"][0]
    if abs(o["losses"][0] - ref0) > 1e-5 * abs(ref0):
        fail(f"{tag}: step 0 loss {o['losses'][0]} not within 1e-5 of "
             f"phase 10's {ref0}")
    if not all(math.isfinite(x) for x in o["losses"]):
        fail(f"{tag}: losses not finite {o['losses']}")
    if any(d != per_step for d in o["launches"]):
        fail(f"{tag}: launches per step {o['launches']}, want {per_step}")
    a = outs[0]["auto plan"]
    res["auto plan"] = dict(planned=a["planned"], losses=a["losses"],
                            step_ms=[1e3 * s for s in a["step_s"]],
                            launches=a["launches"],
                            peak_gib_by_rank=a["peak_gib_by_rank"],
                            tensor_by_rank=[dict(
                                messages=st["tensor"][0],
                                bytes=st["tensor"][1],
                                ms=1e3 * st["tensor"][2])
                                for st in a["transport"][-1]])
    print(f"tensor train {' '.join(TENSOR_AUTO_PLAN)}: "
          f"{json.dumps(res['auto plan'])}", flush=True)
    if (a["planned"]["stages"], a["planned"]["tensor"]) != (1, 4):
        fail(f"tensor train --auto-plan: plan {a['planned']}, want stages 1 "
             f"x tensor 4")
    if abs(a["losses"][0] - ref0) > 1e-5 * abs(ref0):
        fail(f"tensor train --auto-plan: step 0 loss {a['losses'][0]} not "
             f"within 1e-5 of phase 10's {ref0}")

    # ---- 36. serving ----------------------------------------------------------
    for run in TENSOR_SERVE_RUNS:
        label, arch, grid, L, B, P, G, M_, over = run
        T = TENSOR_GRIDS[grid][2]
        ref, rows = refs[label], [o["serve"][label] for o in outs]
        got = rows[0]
        errs = [float((a - b).abs().max())
                for a, b in zip(got["logits"], ref["logits"])]
        agree = int((got["tokens"] == ref["tokens"]).sum())
        summed = {k: sum(r["launches"][k] for r in rows)
                  for k in ref["launches"]}
        want = {k: T * v for k, v in ref["launches"].items()}
        slow_p = max(r["prefill_s"] for r in rows)
        slow_d = max(r["decode_s"] for r in rows)
        res["serve"][label] = dict(
            prefill_max_abs_err=errs[0], decode_max_abs_err=max(errs[1:]),
            steps=len(errs), greedy_tokens_agree=agree,
            tokens=int(ref["tokens"].numel()),
            prefill_tok_s=B * P / slow_p, decode_tok_s=B * (G - 1) / slow_d,
            ref_prefill_tok_s=B * P / ref["prefill_s"],
            ref_decode_tok_s=B * (G - 1) / ref["decode_s"],
            peak_gib_by_rank=[r["peak_gib"] for r in rows],
            ref_peak_gib=ref["peak_gib"],
            kv_heads_by_rank=[r["k_heads"] for r in rows],
            launches_summed=summed, ref_launches=ref["launches"],
            tensor_by_rank_last_decode_step=[dict(
                messages=r["transport"]["tensor"][0],
                bytes=r["transport"]["tensor"][1],
                ms=1e3 * r["transport"]["tensor"][2]) for r in rows])
        print(f"tensor serve {label}: {json.dumps(res['serve'][label])}",
              flush=True)
        if max(errs) > PATH_TOL or len(errs) != G:
            fail(f"tensor serve {label}: logits differ from the in-process "
                 f"tensor-1 serve by {max(errs)} (bar {PATH_TOL}) over "
                 f"{len(errs)} steps")
        if summed != want:
            fail(f"tensor serve {label}: launches summed over ranks "
                 f"{summed}, want {T} x the in-process run's "
                 f"{ref['launches']}")
    res["engine"] = dict(equal=all(o["engine"]["retired"] == ref_engine
                                   for o in outs),
                         steps=outs[0]["engine"]["steps"],
                         requests=len(ref_engine))
    print(f"tensor engine stages 2 x tensor 2: {json.dumps(res['engine'])}",
          flush=True)
    if not res["engine"]["equal"]:
        fail("tensor engine: the ranks' retired tokens differ from the "
             "in-process tensor-1 engine's")
    print(f"tensor: spawn to exit {wall:.1f}s", flush=True)
    return res


#: the f32 GEMMs of one llama3.2-1b layer's forward at a micro-batch of
#: 2048 tokens (batch 8 x seq 1024 in 4 micro-batches): (m, k, n, count)
#: for q and o, k and v, the gate and up projections, the down projection
LAYER_GEMMS = ((2048, 2048, 2048, 2), (2048, 2048, 512, 2),
               (2048, 2048, 8192, 2), (2048, 8192, 2048, 1))


def device_rates() -> dict:
    """The card's own numbers behind ``repro_torch.core.hardware.H100``:
    the f32 cuBLAS GEMM rate over one training layer's GEMMs
    (:data:`LAYER_GEMMS`, tf32 off) and at the loss head's shape, a
    device-to-device copy's bandwidth (bytes read + written over time),
    and the memory ``get_device_properties`` reports."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    rand = lambda *s: torch.randn(*s, device="cuda", generator=g)
    flops = ms = 0.0
    per_shape = {}
    for m, k, n, count in LAYER_GEMMS:
        a, b = rand(m, k), rand(k, n)
        t = event_ms(lambda: a @ b, iters=20)
        per_shape[f"{m}x{k}x{n}"] = 2 * m * k * n / t / 1e9
        flops += count * 2 * m * k * n
        ms += count * t
        del a, b
    a, b = rand(2048, 2048), rand(2048, 128256)
    head_ms = event_ms(lambda: a @ b, iters=10)
    head_tflops = 2 * 2048 * 2048 * 128256 / head_ms / 1e9
    del a, b
    src = torch.empty(2**29, device="cuda")                 # 2 GiB of f32
    dst = torch.empty_like(src)
    copy_ms = event_ms(lambda: dst.copy_(src), iters=10)
    copy_bw = 2 * src.numel() * 4 / (copy_ms / 1e3)
    del src, dst
    torch.cuda.empty_cache()
    layer_tflops = flops / ms / 1e9
    return dict(gemm_tflops_by_shape=per_shape, layer_gemm_tflops=layer_tflops,
                efficiency_vs_67=layer_tflops / 67.0,
                head_gemm_tflops=head_tflops, copy_bytes_s=copy_bw,
                memory_capacity=torch.cuda.get_device_properties(0)
                .total_memory)


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the port's kernels need a "
             "CUDA card")
    card_flags()
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.core import schedplan as SP
    from repro_torch.core import serve_sched as SS
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import serve, train
    from repro_torch.models import layers as LYR
    from repro_torch.models import model as M
    from repro_torch.pipeline import runtime as RT
    from repro_torch.pipeline import stage as ST

    # ---- 1. the card ------------------------------------------------------
    mark("1")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # ---- 2. build ---------------------------------------------------------
    mark("2")
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
            for k in [f"bwd_{kind} {d} D=64" for kind in ("dkdv", "dq")
                      for d in ("f32", "bf16")]
            # the D = 128 and 256 backward's own kernel (dK/dV and dQ)
            + BWD_WG_KEYS
            + [f"prefill {d} D=256" for d in ("f32", "bf16")]) or any(
            k not in sass or sass[k]["HGMMA"] == 0
            # its sums over a step's rows (phase B) on wgmma
            for k in BWD_WG_KEYS):
        fail(f"flash kernels lack tensor-core products or cp.async: {sass}")
    # every SSD product kernel of both dtypes at P = 64 (the main path's)
    ssd_sass = sass_counts(build, "ssd_scan", "ssd", "P")
    print(f"sass ssd_scan {json.dumps(ssd_sass)}", flush=True)
    if ssd_sass is not None:
        want = [f"{k} {d}" for k in ("scores", "bwd_dg", "bwd_dbc")
                for d in ("f32", "bf16")] + [
            f"{k} {d} P=64" for k in ("states", "out", "bwd_dx")
            for d in ("f32", "bf16")]
        if any(k not in ssd_sass or ssd_sass[k]["HMMA"] == 0
               or ssd_sass[k]["LDGSTS"] == 0 for k in want):
            fail(f"SSD product kernels lack tensor-core products or "
                 f"cp.async: {ssd_sass}")

    # ---- 3. kernels against their plain versions --------------------------
    mark("3")
    rows: list = []
    bad = phase_kernels(FA, rows)
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")
    pick = lambda rs, prefix, dtype="float32": next(
        r for r in rs if r["label"].startswith(prefix) and r["dtype"] == dtype)
    # the window skips work: T = S = 4096, window 512 does 0.23x the
    # global call's operations
    window_ratio = {dt: pick(rows, "long prefill local", dt)["ms"]
                    / pick(rows, "long prefill global", dt)["ms"]
                    for dt in ("float32", "bfloat16")}
    print(f"window: prefill T=S=4096 window 512 over global, device time "
          f"{json.dumps(window_ratio)} (bar 0.5 in f32)", flush=True)
    if window_ratio["float32"] > 0.5:
        fail(f"the windowed prefill takes {window_ratio} of the global "
             f"call's time")

    # ---- 4. the llama3.2-1b path at full width ---------------------------
    mark("4")
    counters = dict(flash_attention=FA.flash_attend, ssd_scan=SSD.ssd_chunked)
    llama = serve_main_path(
        serve, ["--arch", "llama3.2-1b", "--stages", "8", "--tensor", "1",
                "--microbatches", "2", "--batch", "8", "--prompt-len", "512",
                "--gen", "32", "--device", "cuda"],
        counters, {"flash_attention": 16 * 2 * (1 + 31),
                   "flash_attention.prefill": 16 * 2,
                   "flash_attention.decode": 16 * 2 * 31,
                   "flash_attention.bwd": 0, "ssd_scan": 0,
                   "ssd_scan.bwd": 0},
        128256)

    # ---- 5. whole llama path, kernel vs plain -----------------------------
    mark("5")
    serve_mods = (get_config, RT, ST)
    path_err = phase_parity(serve_mods, "llama3.2-1b", 128)

    # ---- 6. the SSD scan against its plain version ------------------------
    mark("6")
    ssd_rows: list = []
    bad = phase_ssd(SSD, ssd_rows)
    if bad:
        fail(f"ssd_scan disagrees with its plain version: {bad}")

    # ---- 7. the mamba2-2.7b path at full width ----------------------------
    mark("7")
    mamba = serve_main_path(
        serve, ["--arch", "mamba2-2.7b", "--stages", "16", "--tensor", "1",
                "--microbatches", "2", "--batch", "8", "--prompt-len", "512",
                "--gen", "32", "--device", "cuda"],
        counters, {"flash_attention": 0, "flash_attention.prefill": 0,
                   "flash_attention.decode": 0, "flash_attention.bwd": 0,
                   "ssd_scan": 64 * 2, "ssd_scan.bwd": 0}, 50280)

    # ---- 8. whole mamba2 path, kernel vs plain ----------------------------
    mark("8")
    ssd_path_err = phase_parity(serve_mods, "mamba2-2.7b", 512)

    # ---- 9. the flash backward against its plain version ------------------
    mark("9")
    bwd_rows: list = []
    bad = phase_backward(FA, bwd_rows)
    if bad:
        fail(f"flash backward disagrees with its plain version or is not "
             f"bitwise reproducible: {bad}")
    # the D = 128 kernels: registers and spills of each instantiation, and
    # their tensor-core and cp.async instructions
    bwd128 = dict(
        ptxas=ptxas_kernels(build.BUILD_LOGS.get("flash_attention", ""),
                            r"flash_bwd_wg_kernelI\w+Li128E"),
        sass=None if sass is None else {
            k: sass[k] for k in BWD_WG_KEYS if k.endswith("D=128")})
    print(f"bwd D=128 kernels: {json.dumps(bwd128)}", flush=True)

    # ---- 10. llama3.2-1b training at full width ---------------------------
    mark("10")
    train_mods = (get_config, RT, ST, M, SP, SyntheticLM)
    trained = phase_train(train, counters, train_mods)

    # ---- 11. schedules, non-pipelined autograd, card vs CPU ---------------
    mark("11")
    train_parity = phase_train_parity(FA, counters, train_mods)

    # ---- 12. interleaved training (V = 2) at full width -------------------
    mark("12")
    interleaved = phase_train(train, counters, train_mods,
                              schedule="1f1b-interleaved", virtual=2, M_=4)

    # ---- 13. zero-bubble H2 training at full width ------------------------
    mark("13")
    zb_h2 = phase_train(train, counters, train_mods, schedule="zb-h2",
                        M_=8)

    # ---- 14. the planner: --auto-plan, --cluster, --auto-plan3d ----------
    mark("14")
    planner = phase_planner(train, counters, train_mods)

    # ---- 15. the gemma3-1b path at full width -----------------------------
    mark("15")
    # 26 layers (22 local, window 512; 4 global), head_dim 256, 2 stages of
    # 13 layers; every decode step on the decode route (T * 4 / 1 <= 16)
    gemma = serve_main_path(
        serve, ["--arch", "gemma3-1b", "--stages", "2", "--tensor", "1",
                "--microbatches", "2", "--batch", "8", "--prompt-len", "1024",
                "--gen", "32", "--device", "cuda"],
        counters, {"flash_attention": 26 * 2 * 32,
                   "flash_attention.prefill": 26 * 2,
                   "flash_attention.decode": 26 * 2 * 31,
                   "flash_attention.bwd": 0, "ssd_scan": 0,
                   "ssd_scan.bwd": 0}, 262144)

    # ---- 16. whole gemma3 path, kernel vs plain ---------------------------
    mark("16")
    # one local layer (window 512) and one global, a prompt past the window
    gemma_path_err = phase_parity(serve_mods, "gemma3-1b", 640,
                                  global_every=2)

    # ---- 17. the qwen3-1.7b path at full width ----------------------------
    mark("17")
    qwen = serve_main_path(
        serve, ["--arch", "qwen3-1.7b", "--stages", "4", "--tensor", "1",
                "--microbatches", "2", "--batch", "8", "--prompt-len", "512",
                "--gen", "32", "--device", "cuda"],
        counters, {"flash_attention": 28 * 2 * 32,
                   "flash_attention.prefill": 28 * 2,
                   "flash_attention.decode": 28 * 2 * 31,
                   "flash_attention.bwd": 0, "ssd_scan": 0,
                   "ssd_scan.bwd": 0}, 151936)

    # whole qwen3 path, kernel vs plain: 2 layers, the served prompt length
    qwen_path_err = phase_parity(serve_mods, "qwen3-1.7b", 512)

    # ---- 18. gemma3-1b and qwen3-1.7b training at full width --------------
    mark("18")
    dense_trained = {arch: phase_train(train, counters, train_mods, arch=arch)
                     for arch in ("gemma3-1b", "qwen3-1.7b")}

    # ---- 19. gemma3 and qwen3 training parity: 3 layers -------------------
    mark("19")
    gemma_parity = phase_train_parity(
        FA, counters, train_mods, arch="gemma3-1b", over=dict(global_every=3),
        runs=[r for r in PARITY_RUNS if r[0] in ("1f1b", "zb-h1")],
        card_vs_cpu=(), seq=1024)
    qwen_parity = phase_train_parity(
        FA, counters, train_mods, arch="qwen3-1.7b",
        runs=[r for r in PARITY_RUNS if r[0] in ("1f1b", "zb-h1")],
        card_vs_cpu=(), seq=1024)

    # ---- 20. the SSD backward against its plain version ------------------
    mark("20")
    ssd_bwd_rows: list = []
    bad = phase_ssd_bwd(SSD, ssd_bwd_rows)
    if bad:
        fail(f"SSD backward disagrees with its plain version or is not "
             f"bitwise reproducible: {bad}")

    # ---- 21. mamba2-2.7b training at full width ---------------------------
    mark("21")
    mamba_trained = phase_train(train, counters, train_mods,
                                arch="mamba2-2.7b")

    # ---- 22. mamba2 training parity: 3 layers -----------------------------
    mark("22")
    mamba_parity = phase_train_parity(
        FA, counters, train_mods, arch="mamba2-2.7b",
        runs=[r for r in PARITY_RUNS if r[0] in ("1f1b", "zb-h1")],
        card_vs_cpu=(), seq=1024)

    # ---- 23. interleaved serving: V = 2 prefill, the handoff, V = 1 -------
    mark("23")
    interleaved_serve = phase_interleaved(serve, counters, get_config)

    # ---- 24. continuous batching at chunk 64 ------------------------------
    mark("24")
    engine_mods = (get_config, RT, ST, SS, FA)
    vocab = get_config("llama3.2-1b").vocab
    captures, cap = {}, AttentionCapture(LYR)
    engine = {"chunk 64": phase_engine(
        engine_mods, counters, "engine chunk 64",
        engine_requests(SS, vocab, 16, 16, 512), chunk=64, max_len=640,
        capture=cap)}
    captures["chunk 64"] = cap.args

    # ---- 25. the same engine on other shapes ------------------------------
    mark("25")
    cap = AttentionCapture(LYR)
    engine["chunk 4"] = phase_engine(
        engine_mods, counters, "engine chunk 4",
        engine_requests(SS, vocab, 8, 8, 40), chunk=4, max_len=64,
        capture=cap)
    captures["chunk 4"] = cap.args
    engine["chunk 64 V=2 M=4"] = phase_engine(
        engine_mods, counters, "engine chunk 64 V=2 M=4",
        engine_requests(SS, vocab, 8, 16, 512), chunk=64, max_len=640,
        virtual=2, M_=4)
    if None in captures.values():
        fail(f"no mixed first micro-batch to capture: "
             f"{[k for k, v in captures.items() if v is None]}")

    # ---- 26. the mixed step's attention against its plain version --------
    mark("26")
    mixed_rows = phase_mixed_attention(
        FA, captures, {k: engine[k]["continuous"]["launches"][
            "flash_attention"] for k in captures})
    gemma_mixed_err = phase_gemma_mixed(serve_mods)

    # ---- 27. stages on separate ranks: parity at full width, 3 layers ----
    mark("27")
    rank_parity_res = phase_rank_parity(MESH)

    # ---- 28. llama3.2-1b at full width as 4 ranks on the one card --------
    mark("28")
    rank_trained = phase_rank_train(MESH, SP, trained)

    # ---- 29. serving on separate ranks: parity at full width, few layers -
    mark("29")
    rank_serve_res = phase_rank_serve_parity(MESH)

    # ---- 30. llama3.2-1b served at full width as 4 ranks ------------------
    mark("30")
    rank_served = phase_rank_serve(MESH, interleaved_serve)

    # ---- 31. phase 28's run under the stream runtime ----------------------
    mark("31")
    rank_streamed = phase_rank_train(MESH, SP, trained, runtime="stream",
                                     ticks_run=rank_trained)

    # ---- 32. the data axis: data 2 x stages 2, end / overlap / 2bw -------
    mark("32")
    data_trained = phase_data_train(MESH, trained)

    # ---- 33. serving at data 2 x stages 2 ---------------------------------
    mark("33")
    data_served = phase_data_serve(MESH, serve, counters)

    # ---- 34-36. the tensor axis: parity, training, serving ----------------
    mark("34-36")
    tensor_res = phase_tensor(MESH, (get_config, RT, ST, SS, FA, SSD), trained)

    mark("done")
    train_paths = {f"train {r['schedule']} V={r['virtual']} "
                   f"M={r['microbatches']}": r["launches"]
                   for r in (trained, interleaved, zb_h2)}
    train_paths.update({f"train {' '.join(r['flags'])}": r["launches"]
                        for r in planner["runs"]})
    train_paths.update({f"train {arch} 1f1b M=4": r["launches"]
                        for arch, r in dict(
                            dense_trained,
                            **{"mamba2-2.7b": mamba_trained}).items()})

    # the rank runs: each kernel's launches summed over the ranks
    train_paths.update({f"ranks {k}": r["launches_summed"]
                        for k, r in rank_parity_res.items()})
    for suffix, r in (("", rank_trained), (" stream", rank_streamed)):
        train_paths[f"ranks train llama3.2-1b 4 ranks 1f1b M=4{suffix}"] = {
            k: sum(d[k] for d in r["launches_per_step"])
            for k in r["launches_per_step"][0]}
    for gs in ("end", "overlap"):
        steps = data_trained[gs]["launches_per_step"]
        train_paths[f"ranks train llama3.2-1b data 2 x stages 2 1f1b M=2 "
                    f"{gs}"] = {k: sum(d[k] for d in steps) for k in steps[0]}
    # the tensor axis: each kernel's launches summed over the ranks
    train_paths.update({f"ranks tensor {k}": r["launches_summed"]
                        for k, r in tensor_res["parity"].items()})
    for key, label in (("train", "stages 2 x tensor 2 1f1b M=4"),
                       ("auto plan", "--auto-plan stages 1 x tensor 4")):
        steps = tensor_res[key]["launches_per_step" if key == "train"
                                else "launches"]
        train_paths[f"ranks train llama3.2-1b {label}"] = {
            k: sum(d[k] for d in steps) for k in steps[0]}

    main_row = pick(rows, "main-path prefill")
    keys = ("label", "dtype", "ms", "call_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "bound_tc_ms", "max_abs_err")
    flash = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:84",
        launches=llama["launches"]["flash_attention"],
        launches_train=trained["launches"]["flash_attention"],
        launches_by_path=dict({
            f"serve {name}": r["launches"]["flash_attention"]
            for name, r in (("llama3.2-1b", llama), ("gemma3-1b", gemma),
                            ("qwen3-1.7b", qwen))},
            **{k: v["flash_attention"] for k, v in train_paths.items()},
            **{f"serve llama3.2-1b 4 stages M 4 V={V}":
               interleaved_serve[f"llama_v{V}"]["launches"]["flash_attention"]
               for V in (2, 1)},
            **{f"engine {k} {policy}": r[policy]["launches"]["flash_attention"]
               for k, r in engine.items()
               for policy in ("continuous", "sequential")},
            **{f"ranks serve {k}": r["launches_summed"]["flash_attention"]
               for k, r in rank_serve_res.items()
               if k.startswith("llama")},
            **{"ranks serve llama3.2-1b 4 ranks V=2 M=4":
               rank_served["launches_summed"]["flash_attention"],
               "ranks serve llama3.2-1b data 2 x stages 2 M=2":
               data_served["launches_summed"]["flash_attention"]},
            **{f"ranks tensor serve {k}": r["launches_summed"][
                "flash_attention"]
               for k, r in tensor_res["serve"].items()}),
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
        # gemma3-1b (window 512 and global, D 256), qwen3-1.7b, and the
        # long windowed prefill beside the global one
        dense_variant_rows=[{k: r[k] for k in keys} for r in rows
                            if r["label"].startswith(("gemma3", "qwen3",
                                                      "long prefill"))
                            and "tensor" not in r["label"]],
        # one tensor shard's heads (phases 34-36)
        tensor_rows=[{k: r[k] for k in keys + ("route",)} for r in rows
                     if "tensor" in r["label"]],
        window_prefill_ratio=window_ratio,
        # the continuous-batching step's first-layer attention (phase 26)
        mixed_rows=[{k: r[k] for k in keys + ("route", "launches")}
                    for r in mixed_rows],
        gemma3_mixed_parity_max_abs_err=gemma_mixed_err,
        sass=sass, path_parity_max_abs_err=path_err,
        gemma3_path_parity_max_abs_err=gemma_path_err,
        qwen3_path_parity_max_abs_err=qwen_path_err)
    ssd_row = pick(ssd_rows, "main-path prefill")
    ssd_bf16 = next(r for r in ssd_rows if r["label"].startswith(
        "main-path prefill") and r["dtype"] == "bfloat16")
    ssd = dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:70",
        launches=mamba["launches"]["ssd_scan"],
        launches_train=mamba_trained["launches"]["ssd_scan"],
        launches_by_path=dict({
            f"serve mamba2-2.7b 8 layers V={V}":
            interleaved_serve[f"mamba_v{V}"]["launches"]["ssd_scan"]
            for V in (2, 1)}, **{
            k: v["ssd_scan"] for k, v in train_paths.items()
            if k.startswith("ranks mamba2")}, **{
            f"ranks serve {k}": r["launches_summed"]["ssd_scan"]
            for k, r in rank_serve_res.items() if k.startswith("mamba2")}),
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
              if k in bwd_keys},
        dense_variant_rows=[{k: r[k] for k in bwd_keys} for r in bwd_rows
                            if r["label"].startswith(("gemma3", "qwen3"))
                            and "tensor" not in r["label"]],
        tensor_rows=[{k: r[k] for k in bwd_keys} for r in bwd_rows
                     if "tensor" in r["label"]],
        d128_kernels=bwd128)
    sbwd_row = pick(ssd_bwd_rows, "train")
    ssd_bwd = dict(
        name="ssd_scan_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="no Pallas counterpart: XLA's gradient of "
                 "repro/models/layers.py::_ssd_chunked",
        launches=mamba_trained["launches"]["ssd_scan.bwd"],
        launches_by_path={k: v["ssd_scan.bwd"]
                          for k, v in train_paths.items()},
        max_abs_err=sbwd_row["max_abs_err"], rel_err=sbwd_row["rel_err"],
        ms=sbwd_row["ms"], call_ms=sbwd_row["call_ms"],
        plain_ms=sbwd_row["plain_ms"], bound_ms=sbwd_row["bound_ms"],
        bound_by=sbwd_row["bound_by"], bound_tc_ms=sbwd_row["bound_tc_ms"],
        library_ms=None, shape=sbwd_row["label"] + " f32",
        kernel_us=sbwd_row["kernel_us"],
        bitwise=all(r["bitwise"] for r in ssd_bwd_rows),
        bf16={k: v for k, v in pick(ssd_bwd_rows, "train",
                                    "bfloat16").items() if k in bwd_keys})
    print(json.dumps({"serve": {"llama3.2-1b": llama,
                                "mamba2-2.7b": mamba, "gemma3-1b": gemma,
                                "qwen3-1.7b": qwen,
                                "interleaved": interleaved_serve,
                                "engine": engine,
                                "ranks parity": rank_serve_res,
                                "ranks llama3.2-1b": rank_served,
                                "ranks data 2 x stages 2": data_served,
                                "ranks tensor": tensor_res["serve"],
                                "ranks tensor engine": tensor_res["engine"]}}),
          flush=True)
    print(json.dumps({"train": {"llama3.2-1b": trained,
                                "interleaved": interleaved, "zb-h2": zb_h2,
                                "parity": train_parity,
                                "planner": planner, **dense_trained,
                                "gemma3-1b parity": gemma_parity,
                                "qwen3-1.7b parity": qwen_parity,
                                "mamba2-2.7b": mamba_trained,
                                "mamba2-2.7b parity": mamba_parity,
                                "ranks parity": rank_parity_res,
                                "ranks llama3.2-1b": rank_trained,
                                "ranks llama3.2-1b stream": rank_streamed,
                                "ranks data 2 x stages 2": data_trained,
                                "ranks tensor parity": tensor_res["parity"],
                                "ranks tensor": tensor_res["train"],
                                "ranks tensor auto plan":
                                    tensor_res["auto plan"]}}),
          flush=True)
    print(json.dumps({"kernels": [flash, ssd, flash_bwd, ssd_bwd]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
