#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each reported on its own lines:

1. the card's name and power limit (``nvidia-smi``);
2. building every CUDA kernel of the serving path from ``src/repro_torch/
   kernels/csrc`` with nvcc (one compiler per source, all started together);
3. each kernel against its plain PyTorch version on the card, at the
   shapes of the JAX kernel tests and at the serving path's shapes, with
   the kernel's device time (``ms``, CUDA-graph replay), its eager
   per-call time (``call_ms``, host issue included), the plain version's
   and one library call's device time (``scaled_dot_product_attention``,
   a yardstick the port never calls) and the least time the card could
   take (``bound_ms``);
4. ``repro_torch.launch.serve.main`` at the full width of llama3.2-1b
   (16 layers, 8 stages, 2 micro-batches, batch 8, prompt 512, 32 tokens,
   f32), with each kernel's launch count over that run;
5. the whole path, kernel against plain: the same serve at full width and
   2 layers on the card and on the CPU with the same weights and
   teacher-forced tokens, logits of every step compared; the card's
   decode steps run with synchronizing calls made errors.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``, printed only when every phase passed.
Exits non-zero without a CUDA card or outside a checkout.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PEAK_BYTES_S = 3.35e12                         # H100 SXM HBM3, data sheet
PEAK_OPS_S = {torch.float32: 67e12,            # f32 outside tensor cores
              torch.bfloat16: 989e12}          # bf16 dense tensor cores
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}   # the JAX kernel tests'
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


def attention_bound(q, k, q_start, kv_len, causal):
    """Least time (ms) for attention of these inputs on the card, and
    which bound sets it.  Bytes: q read and the output written once, K/V
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
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S[q.dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


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
        bound, by = attention_bound(q4, k4, q_start, kv_len, causal)
        row = dict(label=label, dtype=str(dtype).replace("torch.", ""),
                   max_abs_err=err, tol=TOL[dtype], ms=time_ms(kern),
                   call_ms=call_ms(kern), plain_ms=time_ms(plain),
                   library_ms=time_ms(library_attention(
                       q4, k4, v4, q_start, kv_len, causal, scale)),
                   bound_ms=bound, bound_by=by, ok=ok)
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
    # offsets with an idle row (kv_len = 0: averages V over all S keys)
    for label, B, T, q_start, kv_len in (
            ("prefill B=8", 8, 512, [0] * 8, [512] * 8),
            ("main-path prefill B=4", 4, 512, [0] * 4, [512] * 4),
            ("main-path decode B=4 per-row", 4, 1, [527, 520, 300, 543],
             [528, 521, 301, 544]),
            ("idle row B=3 per-row", 3, 4, [0, 9, 3], [4, 13, 0])):
        for dtype in (torch.float32, torch.bfloat16):
            q = rnd(B, T, 32, 64, dt=dtype)
            k, v = rnd(B, 544, 8, 64, dt=dtype), rnd(B, 544, 8, 64, dt=dtype)
            qs = torch.tensor(q_start, dtype=torch.int32, device=dev)
            kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
            kw = dict(scale=0.125, causal=True, q_start=qs, kv_len=kl)
            run(f"{label} T={T} S=544 Hq=32 Hkv=8 D=64", q, k, v, qs, kl,
                True, lambda: FA.flash_attend(q, k, v, **kw),
                lambda: FA.attend_ref(q, k, v, **kw), dtype)
    return bad


def phase_parity(serve_mods) -> float:
    """Phase 5: full-width llama3.2-1b cut to 2 layers, served on the card
    (flash kernel) and on the CPU (plain version) with the same weights
    and teacher-forced tokens.  Returns the largest logit difference."""
    get_config, RT, ST = serve_mods
    cfg = dataclasses.replace(get_config("llama3.2-1b"), n_layers=2,
                              stages=2, tensor=1)
    B, prompt_len, gen = 4, 128, 8
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
        fail(f"parity: logits {tuple(a.shape)} finite={torch.isfinite(a).all()}")
    err = (a - b).abs().max().item()
    rel = ((a - b).abs() / (PATH_TOL + PATH_TOL * b.abs())).max().item()
    print(f"parity: {gen} steps x batch {B}, logits [{B}, 1, "
          f"{cfg.padded_vocab(1)}] card vs CPU (card decode steps free of "
          f"host syncs): max |diff| {err:.3e} "
          f"(|a-b| <= {PATH_TOL} + {PATH_TOL}|b|: worst ratio {rel:.3f})",
          flush=True)
    if rel > 1.0:
        fail(f"parity: card and CPU logits differ by {err:.3e}")
    return err


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the port's kernels need a "
             "CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import serve
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
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    # ---- 3. kernels against their plain versions --------------------------
    rows: list = []
    bad = phase_kernels(FA, rows)
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")

    # ---- 4. the main path at full width -----------------------------------
    argv = ["--arch", "llama3.2-1b", "--stages", "8", "--tensor", "1",
            "--microbatches", "2", "--batch", "8", "--prompt-len", "512",
            "--gen", "32", "--device", "cuda"]
    print(f"serve: python -m repro_torch.launch.serve {' '.join(argv)}",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    FA.flash_attend.launches = 0
    out = serve.main(argv)
    launches = FA.flash_attend.launches
    want = 16 * 2 * (1 + 31)
    toks = out["tokens"]
    print(f"serve: prefill {out['prefill_tok_s']:.1f} tok/s, decode "
          f"{out['decode_tok_s']:.1f} tok/s, warm-up {out['warmup_s']:.3f}s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"flash_attention launches {launches} (want {want})", flush=True)
    if launches != want:
        fail(f"flash_attention launched {launches} times, want {want}")
    if tuple(toks.shape) != (8, 32) or not ((toks >= 0) & (toks < 128256)).all():
        fail(f"serve tokens {tuple(toks.shape)} out of range")
    if not torch.isfinite(out["last_logits"]).all():
        fail("serve logits are not finite")
    del out
    torch.cuda.empty_cache()

    # ---- 5. whole-path parity, kernel vs plain ----------------------------
    path_err = phase_parity((get_config, RT, ST))

    main_row = next(r for r in rows
                    if r["label"].startswith("main-path prefill")
                    and r["dtype"] == "float32")
    decode_row = next(r for r in rows
                      if r["label"].startswith("main-path decode")
                      and r["dtype"] == "float32")
    kernel = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:84",
        launches=launches, max_abs_err=main_row["max_abs_err"],
        ms=main_row["ms"], call_ms=main_row["call_ms"],
        plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=main_row["library_ms"],
        shape=main_row["label"] + " f32",
        decode=dict((k, decode_row[k]) for k in
                    ("label", "ms", "call_ms", "plain_ms", "library_ms",
                     "bound_ms",
                     "bound_by", "max_abs_err")),
        path_parity_max_abs_err=path_err)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
