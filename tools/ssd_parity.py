#!/usr/bin/env python3
"""chip_smoke.py's phase 22 check (a 3-layer mamba2-2.7b at full width,
seq 1024, 1f1b, against autograd of the model with the plain SSD scan in
float64) for several versions of the SSD source, on one card.

    git show 1723ab5:src/repro_torch/kernels/csrc/ssd_scan.cu \\
        > build/ssd_baseline.cu
    python3 tools/ssd_parity.py current build/ssd_baseline.cu

``current`` is this checkout's source.  Each version's library is swapped
in under the port's SSD wrappers (a source with the first backward's C
interface, ``void* dwl``, gets that version's scratch); then
``chip_smoke.phase_train_parity`` runs as phase 22 runs it.  One line per
version: whether the bar held (each layer leaf within 1e-4 of the float64
model's gradient, or within the plain f32 model's own distance where that
misses 1e-4), each leaf's error, and, for the [layers, heads] leaves
(a_log, dt_bias, d_skip), each layer's share, relative to the leaf's max
|ref|.  a_log's gradient sums dt R with heavy cancellation, so its error
sits at the f32 noise floor and moves with any change of rounding.
"""
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))


def main() -> None:
    if not torch.cuda.is_available() or len(sys.argv) < 2:
        sys.exit("usage (on a CUDA card): tools/ssd_parity.py "
                 "current|SOURCE [...]")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as CS
    import ssd_ab
    from repro_torch.configs import get_config
    from repro_torch.core import schedplan as SP
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.models import model as M
    from repro_torch.pipeline import runtime as RT
    from repro_torch.pipeline import stage as ST
    counters = dict(flash_attention=FA.flash_attend, ssd_scan=SSD.ssd_chunked)
    mods = (get_config, RT, ST, M, SP, SyntheticLM)
    scratch_default = SSD._launch_bwd.__defaults__
    per_layer = {}
    leaf_errs = CS._leaf_errs

    def layered(grads, ref):
        """_leaf_errs, keeping each [layers, heads] leaf's rows too."""
        rows = []
        for a, b in zip(ST.tree_leaves(grads["layers"]),
                        ST.tree_leaves(ref["layers"])):
            if a.dim() == 2:
                m = b.float().abs().max() + 1e-9
                rows.append([((a[k].float() - b[k].float()).abs().max()
                              / m).item() for k in range(a.shape[0])])
        per_layer.setdefault("rows", []).append(rows)
        return leaf_errs(grads, ref)

    CS._leaf_errs = layered
    for name in sys.argv[1:]:
        if name == "current":
            lib, first = build.load("ssd_scan", SSD._declare), False
        else:
            lib = build.load_file(name, "ssd_parity"
                                  + str(abs(hash(name)) % 10**8))
            SSD._declare(lib)
            with open(name) as f:
                first = "void* dwl" in f.read()
        build._LIBS["ssd_scan"] = lib
        SSD._launch_bwd.__defaults__ = ((ssd_ab.first_bwd_scratch,) if first
                                        else scratch_default)
        per_layer.clear()
        row = dict(version=name)
        try:
            res = CS.phase_train_parity(
                FA, counters, mods, arch="mamba2-2.7b",
                runs=[r for r in CS.PARITY_RUNS if r[0] == "1f1b"],
                card_vs_cpu=(), seq=1024)["1f1b"]
            row.update(ok=True, leaf_errs=res["leaf_errs"],
                       leaf_errs_f32_plain_model=res[
                           "leaf_errs_f32_plain_model"])
        except SystemExit:                # the bar missed: printed above
            row.update(ok=False)
        rows = per_layer.get("rows", [])
        row.update(per_layer=rows[0] if rows else None,
                   per_layer_f32_plain_model=rows[1] if len(rows) > 1
                   else None)
        print("parity " + json.dumps(row), flush=True)
    SSD._launch_bwd.__defaults__ = scratch_default
    ssd_ab.print_card()


if __name__ == "__main__":
    main()
