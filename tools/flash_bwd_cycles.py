#!/usr/bin/env python3
"""Where a step of the D = 128 and 256 flash backward goes, on one card:
SM cycles per step of each of its parts, read with ``clock64()``.

    python3 tools/flash_bwd_cycles.py
    python3 tools/flash_bwd_cycles.py --shape qwen3 --source build/variant.cu

The source (default: the port's ``flash_attention.cu``) is copied with
timers added around the parts of ``bwdwg_body``'s step loop: the top
barrier, phase A's products (S and dP), P and dS into the exchange, the
proxy fence, the middle barrier, phase B (the sums; the next step's
copies where they go out inside it) and the wait for the copies with the
landing pass; the copies at a step's start, where they go out there.
Each warp adds its cycles and its block's step count into a table per
kind of block (dK/dV, dQ) with one atomic each at its end; the table is
read after one call at a training shape (``--shape``, repeatable:
``tools/flash_ab.py``'s D = 128 and 256 ones, batch 2, T = S = 1024;
default qwen3-1.7b's), f32 and bf16.  The timers cost a few percent of
the step; the parts' cycles overlap other warps' work and sum to more
than the step's share of the call.  One JSON line per shape, dtype and
kind of block (cycles per step, each warp's and their mean); the last
line names the card.
"""
import argparse
import ctypes
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import flash_ab as AB  # noqa: E402

#: the parts, in the order of their timers
PARTS = ("top barrier", "copies at the start", "phase A products",
         "P and dS", "fence", "middle barrier", "phase B", "wait and land")
NP = len(PARTS) + 1                     # and the step count

#: (anchor in the source, what goes before or after it)
EDITS = [
    ("template <int D_>\nstruct BwdWg {",
     "__device__ unsigned long long g_cyc[2][8][%d];\n" % NP, "before"),
    ("                                             int i0, int j0) {\n"
     "  constexpr int LD = C::LD, BT = C::BT, PL = C::PLANE, NN = C::NN;",
     "", "sig"),
    ("  // every row valid and seeing all of the tile's keys: no mask\n"
     "  const bool full = iw + ni <= p.T && jw + nj <= p.S",
     "  const long long c1 = clock64(); cyc[2] += c1 - c0;\n", "before"),
    ("  // the planes are read by wgmma (the async proxy) after the barrier\n"
     "  asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: \"memory\");\n"
     "}",
     "", "fence"),
    ("  for (int it = 0; it < n_steps; ++it) {\n"
     "    __syncthreads();                    // step it landed; slot it-1 is"
     " free\n"
     "    if constexpr (!C::COPY_IN_B) copy(it + ST - 1);",
     "", "top"),
    ("    __syncthreads();                    // P and dS are in the exchange",
     "", "middle"),
    ("    cp_async_wait<ST - 2>();\n    land(it + 1);\n  }", "", "end"),
    ("const char* flash_attention_error_string(int code) {",
     "int flash_cycles(void* host) {\n"
     "  return (int)cudaMemcpyFromSymbol(host, g_cyc, sizeof(g_cyc));\n}\n"
     "int flash_cycles_zero() {\n"
     "  static unsigned long long z[2][8][%d] = {};\n"
     "  return (int)cudaMemcpyToSymbol(g_cyc, z, sizeof(g_cyc));\n}\n" % NP,
     "before"),
]


def instrument(src: str) -> str:
    """The source with the timers (a part's cycles in ``cyc``, per warp)."""
    for anchor, text, how in EDITS:
        if src.count(anchor) != 1:
            sys.exit(f"the source has no single anchor {anchor[:60]!r}")
        if how == "before":
            new = text + anchor
        elif how == "sig":
            new = anchor.replace(
                "int i0, int j0) {",
                "int i0, int j0, unsigned long long* cyc) {") \
                + "\n  const long long c0 = clock64();"
        elif how == "fence":
            new = ("  const long long c2 = clock64(); cyc[3] += c2 - c1;\n"
                   + anchor[:-1] + "  cyc[4] += clock64() - c2;\n}")
        elif how == "top":
            new = ("  unsigned long long cyc[%d] = {};\n" % NP
                   + anchor.replace(
                       "    __syncthreads();",
                       "    const long long s0 = clock64();\n"
                       "    __syncthreads();").replace(
                       "    if constexpr (!C::COPY_IN_B) copy(it + ST - 1);",
                       "    const long long s1 = clock64(); cyc[0] += s1 - s0;"
                       "\n    if constexpr (!C::COPY_IN_B) copy(it + ST - 1);"
                       "\n    cyc[1] += clock64() - s1;"))
        elif how == "middle":
            new = ("    const long long s2 = clock64();\n" + anchor
                   + "\n    const long long s3 = clock64();"
                   " cyc[5] += s3 - s2;")
        else:                           # end of the loop
            new = ("    const long long s4 = clock64(); cyc[6] += s4 - s3;\n"
                   "    cp_async_wait<ST - 2>();\n    land(it + 1);\n"
                   "    cyc[7] += clock64() - s4;\n  }\n"
                   "  if (lane == 0) {\n"
                   "    for (int i = 0; i < %d; ++i)\n"
                   "      atomicAdd(&g_cyc[DQ][warp][i], cyc[i]);\n"
                   "    atomicAdd(&g_cyc[DQ][warp][%d],\n"
                   "              (unsigned long long)n_steps);\n  }"
                   % (NP - 1, NP - 1))
        src = src.replace(anchor, new)
    # phase A gets the table
    for call in ("first, r0);", "r0, first);"):
        if src.count(call) != 1:
            sys.exit(f"the source has no single phase-A call ending {call!r}")
        src = src.replace(call, call[:-2] + ", cyc);")
    return src


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", default=os.path.join(
        ROOT, "src/repro_torch/kernels/csrc/flash_attention.cu"),
        help="flash_attention.cu to time (default the port's)")
    ap.add_argument("--shape", action="append",
                    choices=["qwen3", "gemma3-global", "gemma3-local"],
                    help="the backward's shape (repeatable; default qwen3)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("tools/flash_bwd_cycles.py: needs a CUDA card")
    from repro_torch.kernels import flash_attention as FA
    out_dir = os.path.join(ROOT, "build", "cycles")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "flash_attention_cycles.cu")
    with open(args.source) as f:
        src = instrument(f.read())
    with open(path, "w") as f:
        f.write(src)
    lib = AB.build_baselines([path], "flash_cycles")[0]
    call = AB.bind(lib, path, "flash_attention_bwd")
    lib.flash_cycles.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    B, T = 2, 1024
    for shape in args.shape or ["qwen3"]:
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
            fn = lambda: AB.baseline_bwd_call(call, q, k, v, out, lse, do,
                                              qs, kl, D ** -0.5, True,
                                              window)
            fn()                        # warm-up (and the first launch's
            torch.cuda.synchronize()    # attribute setting)
            lib.flash_cycles_zero()
            fn()
            torch.cuda.synchronize()
            table = (ctypes.c_ulonglong * (2 * 8 * NP))()
            lib.flash_cycles(ctypes.cast(table, ctypes.c_void_p))
            for kind, name in ((0, "dK/dV"), (1, "dQ")):
                rows = [table[(kind * 8 + w) * NP:(kind * 8 + w + 1) * NP]
                        for w in range(8)]
                steps = max(rows[0][NP - 1], 1)
                per = {part: [round(r[i] / steps) for r in rows]
                       for i, part in enumerate(PARTS)}
                print(json.dumps(dict(
                    shape=shape, dtype=str(dtype).replace("torch.", ""),
                    blocks=name, steps=rows[0][NP - 1],
                    cycles_per_step_mean={k_: round(sum(v_) / 8)
                                          for k_, v_ in per.items()},
                    cycles_per_step_by_warp=per)), flush=True)
    AB.card_line()


if __name__ == "__main__":
    main()
