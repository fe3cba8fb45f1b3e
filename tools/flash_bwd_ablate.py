#!/usr/bin/env python3
"""Where the D = 128 and 256 flash backward's time goes, on one card: the
kernel timed with parts of its work cut out.

    python3 tools/flash_bwd_ablate.py
    python3 tools/flash_bwd_ablate.py --shape qwen3 --source build/variant.cu

Each source (default: the port's ``flash_attention.cu``) is compiled four
ways: as it is; without phase B (the sums over a step's rows: dV, dK,
dQ); without phase A's products (S and dP over D; P and dS are still
formed from zeros and handed over); without both.  What is left in the
last is the skeleton: the tiles' loads, the exchange, the barriers, the
stores, the pre-pass and the parts' sum.  The cut versions compute wrong
gradients by design, so nothing is checked: every version is timed in
turns (``tools/flash_ab.py``'s), at training shapes (``--shape``,
repeatable: ``tools/flash_ab.py``'s D = 128 and 256 ones, batch 2, T = S
= 1024; default qwen3-1.7b's and gemma3-1b's global and window 512), f32
and bf16.  One JSON line per shape and dtype; the last line names the
card.
"""
import argparse
import json
import os
import re
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import flash_ab as AB  # noqa: E402

#: the call of phase B in the body, and phase A's test for a tile with no
#: visible pair (true: the products are skipped)
PHASE_B = re.compile(r"\n\s*bwdwg_accumulate<[^;]*;")
SKIP_A = "const bool skip = iw >= p.T"


def cut(src: str, phase_a: bool, phase_b: bool) -> str:
    if len(PHASE_B.findall(src)) != 1 or src.count(SKIP_A) != 1:
        sys.exit("the source has no single phase-B call or phase-A test")
    if phase_a:
        src = src.replace(SKIP_A, "const bool skip = true || iw >= p.T")
    if phase_b:
        src = PHASE_B.sub("", src)
    return src


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append",
                    help="flash_attention.cu to cut (repeatable; default "
                         "the port's)")
    ap.add_argument("--shape", action="append",
                    choices=["qwen3", "gemma3-global", "gemma3-local"],
                    help="the backward's shape (repeatable; default all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("tools/flash_bwd_ablate.py: needs a CUDA card")
    from repro_torch.kernels import flash_attention as FA
    sources = args.source or [os.path.join(
        ROOT, "src/repro_torch/kernels/csrc/flash_attention.cu")]
    out_dir = os.path.join(ROOT, "build", "ablate")
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, path in enumerate(sources):
        with open(path) as f:
            src = f.read()
        for name, a, b in (("as is", False, False), ("no B", False, True),
                           ("no A products", True, False),
                           ("neither", True, True)):
            out = os.path.join(out_dir, f"{i}-{name.replace(' ', '_')}.cu")
            with open(out, "w") as f:
                f.write(cut(src, a, b))
            paths.append((f"{os.path.basename(path)}: {name}", out))
    libs = AB.build_baselines([p for _, p in paths], "flash_ablate")
    bases = {label: AB.bind(lib, p, "flash_attention_bwd")
             for (label, p), lib in zip(paths, libs)}
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    B, T = 2, 1024
    for shape in args.shape or ("qwen3", "gemma3-global", "gemma3-local"):
        Hq, Hkv, D, window = AB.BWD_SHAPES[shape]
        for dtype in (torch.float32, torch.bfloat16):
            rnd = lambda *s: torch.randn(*s, generator=g).to(dev, dtype)
            q, do = rnd(B, T, Hq, D), rnd(B, T, Hq, D)
            k, v = rnd(B, T, Hkv, D), rnd(B, T, Hkv, D)
            qs = torch.zeros(B, dtype=torch.int32, device=dev)
            kl = torch.full((B,), T, dtype=torch.int32, device=dev)
            out, lse = FA.flash_attend(q, k, v, return_lse=True,
                                       scale=D ** -0.5, causal=True,
                                       q_start=qs, kv_len=kl, window=window)
            fns = {label: (lambda base=base: AB.baseline_bwd_call(
                       base, q, k, v, out, lse, do, qs, kl, D ** -0.5, True,
                       window)) for label, base in bases.items()}
            print(json.dumps(dict(shape=shape,
                                  dtype=str(dtype).replace("torch.", ""),
                                  ms=AB.turns(fns))), flush=True)
    AB.card_line()


if __name__ == "__main__":
    main()
