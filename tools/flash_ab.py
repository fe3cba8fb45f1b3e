#!/usr/bin/env python3
"""Time the port's flash-attention kernel against another version of its
source, on one card, in one process.

    git show <commit>:src/repro_torch/kernels/csrc/flash_attention.cu \\
        > build/flash_baseline.cu
    python3 tools/flash_ab.py --baseline build/flash_baseline.cu
    python3 tools/flash_ab.py --bwd --profile --baseline build/flash_baseline.cu

The baseline is a ``flash_attention.cu`` with the two-route C interface
(from the redesign of the kernel on).  Its ``flash_attention_fwd`` and
``flash_attention_bwd`` are called by the parameter names of their
definitions in the baseline source, so a version with or without the
statistics pointer (``lse``) or the ``window`` argument (passed 0) is
taken as it is.  It is compiled with the same nvcc flags as the port's
kernels into ``build/kernels/``; ``--baseline`` may be given more than
once (the sources are compiled in parallel, and every version is timed in
the same turns).  At the serving path's shapes (llama3.2-1b: 32 query
heads, 8 kv heads, head_dim 64, S = 544, a micro-batch of 4 rows) and its
training shape (batch 2, T = S = 1024, without and, when every baseline
has the statistics pointer, with the statistics) each shape is timed in
turns, baselines, current, current, baselines in reverse (device
time of one call, CUDA-graph replay, as chip_smoke.py times it), after
both outputs were checked against the plain version.  One JSON line per shape; the last line names the card.
With ``--profile``, each shape's line also carries the current version's
device time per CUDA kernel (``torch.profiler``, mean over 50 calls), so
the decode route's split and combine kernels show apart.

With ``--bwd`` the backward is compared instead, at a training path's
shape (``--shape``, repeatable; batch 2, T = S = 1024, causal): ``llama``
(llama3.2-1b, 32/8 heads, D 64, the default), ``gemma3-global`` and
``gemma3-local`` (gemma3-1b, 4/1 heads, D 256, global or window 512),
``qwen3`` (qwen3-1.7b, 16/8 heads, D 128); the inputs' output and
statistics come from the current forward (a baseline needs a
``flash_attention_bwd``; its ``window`` and ``workspace`` are passed when
it has them).  Every version's dq, dk, dv are checked against the plain
version (relative to max |ref|: f32 1e-4, bf16 3e-2); with ``--profile``
the line carries every version's device time per CUDA kernel.

    python3 tools/flash_ab.py --bwd --shape gemma3-global \
        --shape gemma3-local --profile --baseline build/flash_baseline.cu
"""
import argparse
import concurrent.futures as cf
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
#: --bwd shapes: (Hq, Hkv, D, window), batch 2, T = S = 1024, causal
BWD_SHAPES = {"llama": (32, 8, 64, 0), "gemma3-global": (4, 1, 256, 0),
              "gemma3-local": (4, 1, 256, 512), "qwen3": (16, 8, 128, 0)}


def build_baselines(paths: list, stem: str) -> list:
    """Each source compiled (all at once) and loaded: one library each."""
    from repro_torch.kernels import build
    with cf.ThreadPoolExecutor(len(paths)) as pool:
        return list(pool.map(lambda ip: build.load_file(ip[1], f"{stem}{ip[0]}"),
                             enumerate(paths)))


def c_params(path: str, fn: str) -> list:
    """(name, ctypes type) of each parameter of the C function ``fn`` as
    the source at ``path`` defines it."""
    with open(path) as f:
        m = re.search(rf"\bint {fn}\(([^)]*)\)\s*{{", f.read())
    if m is None:
        sys.exit(f"{path}: no definition of {fn}")
    out = []
    for decl in m.group(1).split(","):
        name = re.findall(r"\w+", decl)[-1]
        out.append((name, ctypes.c_void_p if "*" in decl
                    else ctypes.c_longlong if "long long" in decl
                    else ctypes.c_float if "float" in decl else ctypes.c_int))
    return out


def bind(lib, path: str, fn: str):
    """``lib.fn`` called with keyword arguments named as in the source."""
    params = c_params(path, fn)
    f = getattr(lib, fn)
    f.argtypes = [t for _, t in params]
    f.restype = ctypes.c_int

    def call(**kw):
        rc = f(*(kw[name] for name, _ in params))
        if rc:
            raise RuntimeError(f"baseline {fn}: CUDA error {rc}")
    call.names = {name for name, _ in params}
    return call


def strides(prefix: str, t, dims: str) -> dict:
    return {f"s{prefix}_{d}": s for d, s in zip(dims, t.stride()[:3])}


def turns(fns: dict) -> dict:
    """Device ms of each named call, timed in turns: in order, then in
    reverse (so no version always runs first)."""
    from chip_smoke import time_ms
    out = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            out[name].append(time_ms(fns[name]))
    return out


def baseline_call(fwd, q, k, v, q_start, kv_len, scale, causal,
                  stats=False):
    """One call of a baseline's forward (``bind``); ``stats``: fill the
    statistics (the prefill route)."""
    from repro_torch.kernels import flash_attention as FA
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((B, Hq, T), dtype=torch.float32, device=q.device)
           if stats else None)
    decode = not stats and FA.route(T, Hq, Hkv) == "decode"
    n_split, split_len = FA.decode_splits(B, S, Hkv) if decode else (0, 0)
    work = (torch.empty(B * Hkv * n_split * T * (Hq // Hkv) * (D + 2),
                        dtype=torch.float32, device=q.device)
            if n_split > 1 else None)
    fwd(q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), o=out.data_ptr(),
        q_start=q_start.data_ptr(), kv_len=kv_len.data_ptr(), B=B, T=T, S=S,
        Hq=Hq, Hkv=Hkv, D=D,
        dtype={torch.float32: 0, torch.bfloat16: 1}[q.dtype],
        **strides("q", q, "bth"), **strides("k", k, "bsh"),
        **strides("v", v, "bsh"), **strides("o", out, "bth"),
        scale=float(scale), causal=int(causal), window=0, n_split=n_split,
        split_len=split_len,
        workspace=None if work is None else work.data_ptr(),
        lse=None if lse is None else lse.data_ptr(),
        stream=torch.cuda.current_stream().cuda_stream)
    return out


def baseline_bwd_call(bwd, q, k, v, out, lse, dout, q_start, kv_len, scale,
                      causal, window=0):
    from repro_torch.kernels import flash_attention as FA
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, Hq, T), dtype=torch.float32, device=q.device)
    parts = FA.bwd_parts(B, S, Hq, Hkv, D)
    work = (torch.empty(parts, dtype=torch.float32, device=q.device)
            if parts and "workspace" in bwd.names else None)
    bwd(q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), o=out.data_ptr(),
        dout=dout.data_ptr(), lse=lse.data_ptr(), delta=delta.data_ptr(),
        dq=dq.data_ptr(), dk=dk.data_ptr(), dv=dv.data_ptr(),
        q_start=q_start.data_ptr(), kv_len=kv_len.data_ptr(), B=B, T=T, S=S,
        Hq=Hq, Hkv=Hkv, D=D,
        dtype={torch.float32: 0, torch.bfloat16: 1}[q.dtype],
        **strides("q", q, "bth"), **strides("k", k, "bsh"),
        **strides("v", v, "bsh"), **strides("o", out, "bth"),
        **strides("d", dout, "bth"), scale=float(scale), causal=int(causal),
        window=window, workspace=None if work is None else work.data_ptr(),
        stream=torch.cuda.current_stream().cuda_stream)
    return dq, dk, dv


def main_bwd(paths: list, profile: bool, shapes: list) -> None:
    from chip_smoke import kernel_us
    from repro_torch.kernels import flash_attention as FA
    bases = [bind(lib, path, "flash_attention_bwd") for lib, path in
             zip(build_baselines(paths, "flash_bwd_baseline"), paths)]
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    tol = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
    rel = lambda a, b: ((a.float() - b.float()).abs().max()
                        / (b.float().abs().max() + 1e-12)).item()
    B, T = 2, 1024
    for shape, dtype in [(s, d) for s in shapes
                         for d in (torch.float32, torch.bfloat16)]:
        Hq, Hkv, D, window = BWD_SHAPES[shape]
        if window and not all("window" in base.names for base in bases):
            sys.exit(f"--shape {shape}: a baseline has no window argument")
        rnd = lambda *s: torch.randn(*s, generator=g).to(dev, dtype)
        q, do = rnd(B, T, Hq, D), rnd(B, T, Hq, D)
        k, v = rnd(B, T, Hkv, D), rnd(B, T, Hkv, D)
        qs = torch.zeros(B, dtype=torch.int32, device=dev)
        kl = torch.full((B,), T, dtype=torch.int32, device=dev)
        kw = dict(scale=D ** -0.5, causal=True, q_start=qs, kv_len=kl,
                  window=window)
        out, lse = FA.flash_attend(q, k, v, return_lse=True, **kw)
        fns = {path: (lambda base=base: baseline_bwd_call(
                   base, q, k, v, out, lse, do, qs, kl, D ** -0.5, True,
                   window))
               for path, base in zip(paths, bases)}
        fns["current"] = lambda: FA.flash_attend_bwd(q, k, v, out, lse, do,
                                                     **kw)
        want = FA.attend_bwd_ref(q, k, v, out, lse, do, **kw)
        errs = {name: max(rel(a, b) for a, b in zip(fn(), want))
                for name, fn in fns.items()}
        if max(errs.values()) > tol[dtype]:
            sys.exit(f"backward disagrees with the plain version: {errs}")
        print(json.dumps(dict(
            label=f"backward {shape} B={B} T=S={T} Hq={Hq} Hkv={Hkv} D={D} "
                  f"causal window={window}",
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
                    help="compare the backward at a training shape")
    ap.add_argument("--shape", action="append", choices=sorted(BWD_SHAPES),
                    help="the backward's shape (repeatable; default llama)")
    args = ap.parse_args()
    if args.shape and not args.bwd:
        ap.error("--shape applies to --bwd")
    if not torch.cuda.is_available():
        sys.exit("tools/flash_ab.py: needs a CUDA card")
    if args.bwd:
        main_bwd(args.baseline, args.profile, args.shape or ["llama"])
        card_line()
        return
    from chip_smoke import kernel_us
    from repro_torch.kernels import flash_attention as FA
    bases = [bind(lib, path, "flash_attention_fwd") for lib, path in
             zip(build_baselines(args.baseline, "flash_baseline"),
                 args.baseline)]
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    # (label, B, T, S, q_start, kv_len, with statistics)
    cases = [("main-path prefill B=4", 4, 512, 544, [0] * 4, [512] * 4,
              False),
             ("main-path decode B=4 per-row", 4, 1, 544, [527, 520, 300, 543],
              [528, 521, 301, 544], False),
             ("train B=2", 2, 1024, 1024, [0, 0], [1024, 1024], False)]
    if all("lse" in base.names for base in bases):
        cases.append(("train B=2 with statistics", 2, 1024, 1024, [0, 0],
                      [1024, 1024], True))
    for label, B, T, S, q_start, kv_len, stats in cases:
        for dtype in (torch.float32, torch.bfloat16):
            rnd = lambda *s: torch.randn(*s, generator=g).to(dev, dtype)
            q, k, v = rnd(B, T, 32, 64), rnd(B, S, 8, 64), rnd(B, S, 8, 64)
            qs = torch.tensor(q_start, dtype=torch.int32, device=dev)
            kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
            kw = dict(scale=0.125, causal=True, q_start=qs, kv_len=kl)
            fns = {path: (lambda base=base: baseline_call(
                       base, q, k, v, qs, kl, 0.125, True, stats))
                   for path, base in zip(args.baseline, bases)}
            fns["current"] = ((lambda: FA.flash_attend(
                q, k, v, return_lse=True, **kw)[0]) if stats
                else (lambda: FA.flash_attend(q, k, v, **kw)))
            want = FA.attend_ref(q, k, v, **kw).float()
            errs = {name: (fn().float() - want).abs().max().item()
                    for name, fn in fns.items()}
            if max(errs.values()) > TOL[dtype]:
                sys.exit(f"{label}: disagrees with the plain version: {errs}")
            print(json.dumps(dict(
                label=f"{label} T={T} S={S} Hq=32 Hkv=8 D=64",
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
