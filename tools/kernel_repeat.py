#!/usr/bin/env python3
"""Repeat every kernel call of the port's serving and training paths on one
card and check that each repeat is bitwise equal to the first: a kernel
that races (a missing barrier, a read before a write lands) shows as a
repeat that differs, or as a non-finite value.

    python3 tools/kernel_repeat.py                 # 300 repeats a case
    python3 tools/kernel_repeat.py --nan-fill      # uninitialised memory NaN

Every other repeat runs beside a stream of f32 4096^3 GEMMs, so the
kernels' blocks are scheduled onto fewer, changing SMs.  The cases are the
flash forward at chip_smoke.py's serving-parity shapes (phase 5:
llama3.2-1b cut to 2 layers, micro-batches of 2 rows, prompt 128, a cache
of 136) and main-path shapes (phases 3, 4 and 10), the flash backward at
the training shape, the SSD scan at the mamba2-2.7b serving shape, and
phase 5's whole card path (prefill, then 7 decode steps).  The first call
of each case is also held against its plain version (the bars of
chip_smoke.py: f32 2e-5, absolute for the forward and of max |ref| for
the scan, 1e-4 of max |ref| for the backward; bf16 3e-2), and phase 5's
logits against the same path on the CPU (2e-4 + 2e-4 |ref|).

With ``--nan-fill`` every ``torch.empty`` (the kernels' outputs and
workspaces) is filled with NaN (``torch.utils.deterministic.
fill_uninitialized_memory``) and 12 GiB of NaN is left in the caching
allocator first, so a kernel that reads memory it never wrote returns
NaN.  One JSON line per case; the line before the last names the card;
the last is ``{"ok": ...}``.  Exits 1 if any case failed.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import get_config                  # noqa: E402
from repro_torch.kernels import flash_attention as FA        # noqa: E402
from repro_torch.kernels import ssd_scan as SSD              # noqa: E402
from repro_torch.pipeline import runtime as RT               # noqa: E402
from repro_torch.pipeline import stage as ST                 # noqa: E402

FWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
PATH_TOL = 2e-4

#: (label, B, T, S, q_start, kv_len): 32 query heads, 8 kv heads, D 64
FLASH_CASES = (
    ("parity prefill", 2, 128, 136, [0, 0], [128, 128]),
    ("parity decode", 2, 1, 136, [130, 130], [131, 131]),
    ("parity decode last", 2, 1, 136, [134, 134], [135, 135]),
    ("serve prefill", 4, 512, 544, [0] * 4, [512] * 4),
    ("serve decode", 4, 1, 544, [527, 520, 300, 543], [528, 521, 301, 544]),
    ("idle row", 3, 4, 544, [0, 9, 3], [4, 13, 0]),
    ("train", 2, 1024, 1024, [0, 0], [1024, 1024]),
)


def rel_err(out, ref) -> float:
    return max(((a.float() - b.float()).abs().max()
                / (b.float().abs().max() + 1e-9)).item()
               for a, b in zip(out, ref))


def repeat(label: str, fn, n: int, noise) -> dict:
    """Call ``fn`` n + 1 times; count the repeats that differ bitwise from
    the first call or hold a non-finite value."""
    first = fn()
    first = tuple(t.clone() for t in (first if isinstance(first, tuple)
                                      else (first,)))
    nonfinite = int(not all(torch.isfinite(t).all() for t in first))
    differ = 0
    for i in range(n):
        if i % 2:
            noise()
        out = fn()
        out = out if isinstance(out, tuple) else (out,)
        differ += not all(torch.equal(a, b) for a, b in zip(out, first))
        nonfinite += not all(torch.isfinite(a).all() for a in out)
    torch.cuda.synchronize()
    return dict(label=label, repeats=n, differ=differ, nonfinite=nonfinite,
                first=first)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=300)
    ap.add_argument("--nan-fill", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_repeat.py needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.nan_fill:
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.utils.deterministic.fill_uninitialized_memory = True
        pool = torch.full((12 * 2**30 // 4,), float("nan"), device="cuda")
        del pool
    dev = "cuda"
    g = torch.Generator().manual_seed(0)
    rnd = lambda *s, dt=torch.float32: torch.randn(*s, generator=g).to(dev, dt)
    side = torch.cuda.Stream()
    ga, gb = rnd(4096, 4096), rnd(4096, 4096)

    def noise():
        with torch.cuda.stream(side):
            for _ in range(4):
                ga @ gb

    rows = []

    def report(r: dict, err: float, tol: float) -> None:
        r.pop("first")
        r.update(err_vs_plain=err, tol=tol,
                 ok=r["differ"] == 0 and r["nonfinite"] == 0 and err <= tol)
        print(json.dumps(r), flush=True)
        rows.append(r)

    n = args.repeats
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for label, B, T, S, qs, kl in FLASH_CASES:
            q = rnd(B, T, 32, 64, dt=dtype)
            k, v = rnd(B, S, 8, 64, dt=dtype), rnd(B, S, 8, 64, dt=dtype)
            kw = dict(scale=0.125, causal=True,
                      q_start=torch.tensor(qs, dtype=torch.int32, device=dev),
                      kv_len=torch.tensor(kl, dtype=torch.int32, device=dev))
            r = repeat(f"flash {label} B={B} T={T} S={S} {dname}",
                       lambda: FA.flash_attend(q, k, v, **kw), n, noise)
            ref = FA.attend_ref(q, k, v, **kw)
            report(r, (r["first"][0].float() - ref.float()).abs().max()
                   .item(), FWD_TOL[dtype])
            if label != "train":
                continue
            o, lse = FA.flash_attend(q, k, v, return_lse=True, **kw)
            do = rnd(B, T, 32, 64, dt=dtype)
            r = repeat(f"flash backward B={B} T=S={S} {dname}",
                       lambda: FA.flash_attend_bwd(q, k, v, o, lse, do, **kw),
                       n, noise)
            report(r, rel_err(r["first"], FA.attend_bwd_ref(
                q, k, v, o, lse, do, **kw)), REL_TOL[dtype])
        for B in (4, 2):
            T, H, P, N, chunk = 512, 80, 64, 128, 256
            x = rnd(B, T, H, P, dt=dtype)
            dt_ = torch.nn.functional.softplus(rnd(B, T, H))
            A = -torch.exp(rnd(H) * 0.5)
            Bm, Cm = rnd(B, T, N, dt=dtype), rnd(B, T, N, dt=dtype)
            kw = dict(chunk=chunk, init_state=rnd(B, H, P, N))
            r = repeat(f"ssd_scan B={B} T={T} H={H} P={P} N={N} {dname}",
                       lambda: SSD.ssd_chunked(x, dt_, A, Bm, Cm, **kw), n,
                       noise)
            report(r, rel_err(r["first"], SSD.ssd_chunked_ref(
                x, dt_, A, Bm, Cm, **kw)), FWD_TOL[dtype])

    # chip_smoke.py phase 5's path, on the card repeatedly, then the CPU
    cfg = dataclasses.replace(get_config("llama3.2-1b"), n_layers=2,
                              stages=2, tensor=1)
    plan = ST.plan_stages(cfg)
    pcfg = RT.PipelineConfig(n_microbatches=2)
    prefill = RT.make_serve_step(cfg, plan, pcfg, q_len=128)
    decode = RT.make_serve_step(cfg, plan, pcfg, q_len=1)
    params = ST.init_stacked_params(cfg, 0, plan, device=dev)
    gg = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (4, 128), generator=gg)
    forced = torch.randint(0, cfg.vocab, (4, 7), generator=gg)
    to = lambda tree, d: {k: to(v, d) if isinstance(v, dict) else v.to(d)
                          for k, v in tree.items()}

    def path(p, d):
        cache = RT.init_pipeline_cache(cfg, plan, 4, 136, device=d)
        lg, cache = prefill(p, cache, dict(tokens=prompt.to(d)))
        steps = [lg[:, 0]]
        for t in range(7):
            lg, cache = decode(p, cache, dict(tokens=forced[:, t:t + 1]
                                              .to(d)))
            steps.append(lg[:, 0])
        return torch.stack(steps)

    r = repeat("phase-5 path llama3.2-1b 2 layers, prompt 128, 7 decode "
               "steps", lambda: path(params, dev), max(1, n // 10), noise)
    a, b = r["first"][0].cpu(), path(to(params, "cpu"), "cpu")
    report(r, ((a - b).abs() / (PATH_TOL + PATH_TOL * b.abs())).max().item(),
           1.0)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else torch.cuda.get_device_name(0), flush=True)
    ok = all(r["ok"] for r in rows)
    print(json.dumps({"ok": ok, "nan_fill": args.nan_fill,
                      "cases": len(rows)}), flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
