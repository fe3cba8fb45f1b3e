#!/usr/bin/env python3
"""Time the port's flash-attention kernel against another version of its
source, on one card, in one process.

    git show <commit>:src/repro_torch/kernels/csrc/flash_attention.cu \\
        > build/flash_baseline.cu
    python3 tools/flash_ab.py --baseline build/flash_baseline.cu
    python3 tools/flash_ab.py --bwd --profile --baseline build/flash_baseline.cu

The baseline is a ``flash_attention.cu`` with the two-route C interface
without statistics (``flash_attention_fwd(..., scale, causal, n_split,
split_len, workspace, stream)``, from the redesign of the kernel up to the
version before the backward).  It is compiled with the same nvcc flags as the
port's kernels into ``build/kernels/``; ``--baseline`` may be given more
than once (the sources are compiled in parallel, and every version is
timed in the same turns).  At the serving path's shapes
(llama3.2-1b: 32 query heads, 8 kv heads, head_dim 64, S = 544, a
micro-batch of 4 rows) each shape is timed in turns, baselines, current,
current, baselines in reverse (device time of one call, CUDA-graph replay, as
chip_smoke.py times it), after both outputs were checked against the
plain version.  One JSON line per shape; the last line names the card.
With ``--profile``, each shape's line also carries the current version's
device time per CUDA kernel (``torch.profiler``, mean over 50 calls), so
the decode route's split and combine kernels show apart.

With ``--bwd`` the backward is compared instead, at the training path's
shape (llama3.2-1b: batch 2, T = S = 1024, 32/8 heads, D 64, causal), the
inputs' output and statistics from the current forward: a baseline must
have the same ``flash_attention_bwd`` C interface.  Every version's dq,
dk, dv are checked against the plain version (relative to max |ref|: f32
1e-4, bf16 3e-2); with ``--profile`` the line carries every version's
device time per CUDA kernel.
"""
import argparse
import concurrent.futures as cf
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


def build_baselines(paths: list, stem: str) -> list:
    """Each source compiled (all at once) and loaded: one library each."""
    from repro_torch.kernels import build
    with cf.ThreadPoolExecutor(len(paths)) as pool:
        return list(pool.map(lambda ip: build.load_file(ip[1], f"{stem}{ip[0]}"),
                             enumerate(paths)))


def turns(fns: dict) -> dict:
    """Device ms of each named call, timed in turns: in order, then in
    reverse (so no version always runs first)."""
    from chip_smoke import time_ms
    out = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            out[name].append(time_ms(fns[name]))
    return out


def baseline_call(lib, q, k, v, q_start, kv_len, scale, causal):
    from repro_torch.kernels import flash_attention as FA
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    decode = FA.route(T, Hq, Hkv) == "decode"
    n_split, split_len = FA.decode_splits(B, S, Hkv) if decode else (0, 0)
    work = (torch.empty(B * Hkv * n_split * T * (Hq // Hkv) * (D + 2),
                        dtype=torch.float32, device=q.device)
            if n_split > 1 else None)
    rc = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        q_start.data_ptr(), kv_len.data_ptr(), B, T, S, Hq, Hkv, D,
        {torch.float32: 0, torch.bfloat16: 1}[q.dtype],
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], float(scale), int(causal), n_split, split_len,
        None if work is None else work.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"baseline flash_attention_fwd: CUDA error {rc}")
    return out


def baseline_bwd_call(lib, q, k, v, out, lse, dout, q_start, kv_len, scale,
                      causal):
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, Hq, T), dtype=torch.float32, device=q.device)
    rc = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), q_start.data_ptr(), kv_len.data_ptr(),
        B, T, S, Hq, Hkv, D, {torch.float32: 0, torch.bfloat16: 1}[q.dtype],
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], *dout.stride()[:3], float(scale), int(causal),
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"baseline flash_attention_bwd: CUDA error {rc}")
    return dq, dk, dv


def main_bwd(paths: list, profile: bool) -> None:
    from chip_smoke import kernel_us
    from repro_torch.kernels import flash_attention as FA
    bases = build_baselines(paths, "flash_bwd_baseline")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for base in bases:
        base.flash_attention_bwd.argtypes = (
            [p] * 12 + [i] * 7 + [ll] * 15 + [ctypes.c_float, i, p])
        base.flash_attention_bwd.restype = ctypes.c_int
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    tol = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
    rel = lambda a, b: ((a.float() - b.float()).abs().max()
                        / (b.float().abs().max() + 1e-12)).item()
    B, T, Hq, Hkv, D = 2, 1024, 32, 8, 64
    for dtype in (torch.float32, torch.bfloat16):
        rnd = lambda *s: torch.randn(*s, generator=g).to(dev, dtype)
        q, do = rnd(B, T, Hq, D), rnd(B, T, Hq, D)
        k, v = rnd(B, T, Hkv, D), rnd(B, T, Hkv, D)
        qs = torch.zeros(B, dtype=torch.int32, device=dev)
        kl = torch.full((B,), T, dtype=torch.int32, device=dev)
        kw = dict(scale=D ** -0.5, causal=True, q_start=qs, kv_len=kl)
        out, lse = FA.flash_attend(q, k, v, return_lse=True, **kw)
        fns = {path: (lambda base=base: baseline_bwd_call(
                   base, q, k, v, out, lse, do, qs, kl, D ** -0.5, True))
               for path, base in zip(paths, bases)}
        fns["current"] = lambda: FA.flash_attend_bwd(q, k, v, out, lse, do,
                                                     **kw)
        want = FA.attend_bwd_ref(q, k, v, out, lse, do, **kw)
        errs = {name: max(rel(a, b) for a, b in zip(fn(), want))
                for name, fn in fns.items()}
        if max(errs.values()) > tol[dtype]:
            sys.exit(f"backward disagrees with the plain version: {errs}")
        print(json.dumps(dict(
            label=f"backward B={B} T=S={T} Hq={Hq} Hkv={Hkv} D={D} causal",
            dtype=str(dtype).replace("torch.", ""), ms=turns(fns),
            rel_err=errs,
            **({"kernel_us": {name: kernel_us(fn) for name, fn in fns.items()}}
               if profile else {}))), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True, action="append",
                    help="flash_attention.cu of a version to compare with "
                         "(repeatable)")
    ap.add_argument("--profile", action="store_true",
                    help="also print the current version's device time per "
                         "CUDA kernel")
    ap.add_argument("--bwd", action="store_true",
                    help="compare the backward at the training shape")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("tools/flash_ab.py: needs a CUDA card")
    if args.bwd:
        main_bwd(args.baseline, args.profile)
        card_line()
        return
    from chip_smoke import kernel_us
    from repro_torch.kernels import flash_attention as FA
    bases = build_baselines(args.baseline, "flash_baseline")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for base in bases:
        base.flash_attention_fwd.argtypes = (
            [p] * 6 + [i] * 7 + [ll] * 12 + [ctypes.c_float, i, i, i, p, p])
        base.flash_attention_fwd.restype = ctypes.c_int
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    cases = (("main-path prefill B=4", 4, 512, [0] * 4, [512] * 4),
             ("main-path decode B=4 per-row", 4, 1, [527, 520, 300, 543],
              [528, 521, 301, 544]))
    for label, B, T, q_start, kv_len in cases:
        for dtype in (torch.float32, torch.bfloat16):
            rnd = lambda *s: torch.randn(*s, generator=g).to(dev, dtype)
            q, k, v = rnd(B, T, 32, 64), rnd(B, 544, 8, 64), rnd(B, 544, 8, 64)
            qs = torch.tensor(q_start, dtype=torch.int32, device=dev)
            kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
            kw = dict(scale=0.125, causal=True, q_start=qs, kv_len=kl)
            fns = {path: (lambda base=base: baseline_call(
                       base, q, k, v, qs, kl, 0.125, True))
                   for path, base in zip(args.baseline, bases)}
            fns["current"] = lambda: FA.flash_attend(q, k, v, **kw)
            want = FA.attend_ref(q, k, v, **kw).float()
            errs = {name: (fn().float() - want).abs().max().item()
                    for name, fn in fns.items()}
            if max(errs.values()) > TOL[dtype]:
                sys.exit(f"{label}: disagrees with the plain version: {errs}")
            print(json.dumps(dict(
                label=f"{label} T={T} S=544 Hq=32 Hkv=8 D=64",
                dtype=str(dtype).replace("torch.", ""),
                route=FA.route(T, 32, 8), ms=turns(fns), max_abs_err=errs,
                **({"kernel_us": kernel_us(fns["current"])}
                   if args.profile else {}))), flush=True)
    card_line()


def card_line() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(json.dumps({"card": smi.stdout.strip(),
                      "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
