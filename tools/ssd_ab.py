#!/usr/bin/env python3
"""Time the port's SSD scan kernel against another version of its source,
on one card, in one process.

    git show <commit>:src/repro_torch/kernels/csrc/ssd_scan.cu \\
        > build/ssd_baseline.cu
    python3 tools/ssd_ab.py --baseline build/ssd_baseline.cu [--profile]

The baseline is an ``ssd_scan.cu`` with the first version's C interface
(``ssd_scan_fwd(x, dt, A, Bm, Cm, init_state, y, final_state, scores,
B, T, H, P, N, chunk, dtype, <15 strides>, stream)``: one scores scratch,
no chunk-state scratch).  It is compiled with the same nvcc flags as the
port's kernels into ``build/kernels/``.  Shapes: the serving path's call
(mamba2-2.7b: 80 heads of 64, d_state 128, chunk 256, a micro-batch of 4
rows, prompt 512, seeded with a state) in f32 and bf16, and the same
with a 1024-token prompt (four chunks).  Each shape is timed in turns,
baseline, current, current, baseline (device time of one call, CUDA-graph
replay, as chip_smoke.py times it), after both outputs were checked
against the plain version (y and the final state, max |err| / max |ref|:
f32 2e-5, bf16 3e-2).  One JSON line per shape; the last line names the
card.  With ``--profile``, each line also carries the current version's
device time per CUDA kernel (``torch.profiler``, mean over 50 calls).

    python3 tools/ssd_ab.py --bwd --baseline build/ssd_baseline.cu [--profile]

``--bwd`` compares the backward instead, at the training path's call
(mamba2-2.7b: a micro-batch of 2 rows, seq 1024, no state in or out) in
f32 and bf16.  The baseline then needs the C interfaces of this version's
``ssd_scan_fwd`` (three scratch buffers) and of an ``ssd_scan_bwd`` with
ten scratch buffers, either this version's (``ssd_scan.bwd_scratch``) or
the first backward's (commit 1723ab5: :func:`first_bwd_scratch`, taken
when the baseline source declares ``void* dwl``):

    git show 1723ab5:src/repro_torch/kernels/csrc/ssd_scan.cu \
        > build/ssd_baseline.cu
    python3 tools/ssd_ab.py --bwd --baseline build/ssd_baseline.cu --profile

Each version's backward runs from its own forward's scratch and is checked
against ``ssd_chunked_bwd_ref`` (every gradient, max |err| / max |ref|: f32
1e-4, bf16 3e-2) before the turns; with ``--profile`` the line carries
both versions' device time per CUDA kernel.  ``--baseline`` repeats
(every version timed in the same turns: the others in order, the current
twice, the others in reverse).
"""
import argparse
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
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
CASES = (("main-path prefill", 4, 512, 80, 64, 128, 256),
         ("four-chunk prefill", 4, 1024, 80, 64, 128, 256))
BWD_CASES = (("train", 2, 1024, 80, 64, 128, 256),)


def build_baseline(path: str) -> ctypes.CDLL:
    from repro_torch.kernels import build
    lib = build.load_file(path, "ssd_baseline")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_fwd.argtypes = [p] * 9 + [i] * 7 + [ll] * 15 + [p]
    lib.ssd_scan_fwd.restype = ctypes.c_int
    return lib


def baseline_call(lib, x, dt, A, Bm, Cm, chunk, init_state):
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty_like(x)
    final = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    scores = torch.empty((B, T // chunk, chunk, chunk), dtype=torch.float32,
                         device=x.device)
    rc = lib.ssd_scan_fwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), init_state.data_ptr(), y.data_ptr(), final.data_ptr(),
        scores.data_ptr(), B, T, H, P, N, chunk,
        {torch.float32: 0, torch.bfloat16: 1}[x.dtype],
        *x.stride()[:3], *dt.stride(), *Bm.stride()[:2], *Cm.stride()[:2],
        *y.stride()[:3], *init_state.stride()[:2],
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"baseline ssd_scan_fwd: CUDA error {rc}")
    return y, final


def first_bwd_scratch(B: int, T: int, H: int, P: int, N: int,
                      chunk: int) -> dict:
    """The first backward's scratch (commit 1723ab5), in its C order:
    dWL and dB, dC per head ([B,nc,H,c,c], [B,nc,H,c,N])."""
    nc, c = T // chunk, chunk
    nt, nnb, npass = -(-c // 64), -(-N // 64), -(-(P * N // 4) // 256)
    return dict(dstates=(B, nc, H, P, N), dwl=(B, nc, H, c, c),
                rs=(B, nc, H, nt, c), cs=(B, nc, H, nt, c),
                yoff=(B, nc, H, nnb, c), r=(B, nc, H, c),
                gpart=(B, nc, H, npass), dbh=(B, nc, H, c, N),
                dch=(B, nc, H, c, N), dapart=(B, nc, H))


def ab_bwd(paths: list, profile: bool) -> None:
    """The backward of this source against the ones at ``paths``, each
    checked against the plain version first.  Every version is timed in
    the same turns: the others in order, the current twice, the others in
    reverse order."""
    from chip_smoke import kernel_us, time_ms
    from repro_torch.kernels import build
    from repro_torch.kernels import ssd_scan as SSD
    versions = []                       # (name, lib, scratch)
    for i, path in enumerate(paths):
        lib = build.load_file(path, f"ssd_baseline{i}")
        SSD._declare(lib)
        with open(path) as f:
            scratch = (first_bwd_scratch if "void* dwl" in f.read()
                       else SSD.bwd_scratch)
        versions.append((path, lib, scratch))
    cur_lib = build.load("ssd_scan", SSD._declare)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    rel = lambda a, b: ((a.float() - b.float()).abs().max()
                        / (b.float().abs().max() + 1e-12)).item()
    for label, B, T, H, P, N, chunk in BWD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            rnd = lambda *s: torch.randn(*s, generator=g)
            x = rnd(B, T, H, P).to(dev, dtype)
            dt = torch.nn.functional.softplus(rnd(B, T, H)).to(dev)
            A = -torch.exp(rnd(H) * 0.5).to(dev)
            Bm, Cm = rnd(B, T, N).to(dev, dtype), rnd(B, T, N).to(dev, dtype)
            dy = rnd(B, T, H, P).to(dev, dtype)
            args = (x, dt, A, Bm, Cm)
            want = SSD.ssd_chunked_bwd_ref(*args, dy, chunk=chunk)[:5]
            fns, errs = {}, {}
            for name, lib, scratch in versions + [
                    ("current", cur_lib, SSD.bwd_scratch)]:
                saved = SSD._launch_fwd(*args, chunk, None, lib=lib)[2]
                fns[name] = (
                    lambda lib=lib, saved=saved, scratch=scratch:
                    SSD._launch_bwd(lib, *args, dy, None, chunk, None, saved,
                                    scratch))
                got = fns[name]()[:5]
                errs[name] = max(rel(a, b) for a, b in zip(got, want))
                if errs[name] >= BWD_TOL[dtype]:
                    sys.exit(f"{label}: {name} disagrees with the plain "
                             f"version: {errs}")
            names = [v[0] for v in versions]
            order = names + ["current", "current"] + names[::-1]
            t = [time_ms(fns[n]) for n in order]
            ms = {n: [t[order.index(n)], t[len(order) - 1 - order.index(n)]]
                  for n in names + ["current"]}
            print(json.dumps(dict(
                label=f"backward {label} B={B} T={T} H={H} P={P} N={N} "
                      f"chunk={chunk}",
                dtype=str(dtype).replace("torch.", ""),
                baseline_ms=ms[names[0]], current_ms=ms["current"],
                ms=ms, rel_err=errs,
                **({"kernel_us": {n: kernel_us(fns[n])
                                  for n in ["current"] + names}}
                   if profile else {}))),
                flush=True)
            del x, Bm, Cm, dy, want, fns


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True, action="append",
                    help="ssd_scan.cu of a version to compare with "
                         "(--bwd: repeatable)")
    ap.add_argument("--profile", action="store_true",
                    help="also print the current version's device time per "
                         "CUDA kernel")
    ap.add_argument("--bwd", action="store_true",
                    help="compare the backward at the training shape")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("tools/ssd_ab.py: needs a CUDA card")
    if args.bwd:
        ab_bwd(args.baseline, args.profile)
        print_card()
        return
    if len(args.baseline) > 1:
        sys.exit("tools/ssd_ab.py: the forward takes one --baseline")
    from chip_smoke import kernel_us, time_ms
    from repro_torch.kernels import ssd_scan as SSD
    base = build_baseline(args.baseline[0])
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    rel = lambda a, b: ((a.float() - b.float()).abs().max()
                        / b.float().abs().max()).item()
    for label, B, T, H, P, N, chunk in CASES:
        for dtype in (torch.float32, torch.bfloat16):
            rnd = lambda *s: torch.randn(*s, generator=g)
            x = rnd(B, T, H, P).to(dev, dtype)
            dt = torch.nn.functional.softplus(rnd(B, T, H)).to(dev)
            A = -torch.exp(rnd(H) * 0.5).to(dev)
            Bm, Cm = rnd(B, T, N).to(dev, dtype), rnd(B, T, N).to(dev, dtype)
            init = rnd(B, H, P, N).to(dev)
            cur = lambda: SSD.ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk,
                                          init_state=init)
            old = lambda: baseline_call(base, x, dt, A, Bm, Cm, chunk, init)
            yr, fr = SSD.ssd_chunked_ref(x, dt, A, Bm, Cm, chunk=chunk,
                                         init_state=init)
            errs = {}
            for name, fn in (("baseline", old), ("current", cur)):
                y, fin = fn()
                errs[name] = dict(y=rel(y, yr), state=rel(fin, fr))
            if max(max(e.values()) for e in errs.values()) >= TOL[dtype]:
                sys.exit(f"{label}: disagrees with the plain version: {errs}")
            t = [time_ms(fn) for fn in (old, cur, cur, old)]
            print(json.dumps(dict(
                label=f"{label} B={B} T={T} H={H} P={P} N={N} chunk={chunk}",
                dtype=str(dtype).replace("torch.", ""),
                baseline_ms=[t[0], t[3]], current_ms=[t[1], t[2]],
                rel_err=errs,
                **({"kernel_us": kernel_us(cur)} if args.profile else {}))),
                flush=True)
            del x, Bm, Cm, yr, fr
    print_card()


def print_card() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(json.dumps({"card": smi.stdout.strip(),
                      "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
