#!/usr/bin/env python3
"""How far the SSD scan's gradient lands from float64, on the CPU.

    PYTHONPATH=src python3 tools/ssd_dcum_check.py

1. The scan at hymba-1.5b's shape (B 2, T 1024, H 50, P 64, N 16, chunk
   256; A = -linspace(1, 16, 50) as ``init_ssm`` draws it, dt the
   softplus of a normal draw, the rest normal): ``ssd_chunked_bwd_ref``
   (the backward kernel's plain version, in f32 with dt*A scanned in
   double) and torch autograd of ``ssd_chunked_ref`` in f32 (the JAX
   model's arithmetic), each gradient's max |got - ref| / max |ref|
   against autograd of ``ssd_chunked_ref`` in float64; ``a_log`` is dA
   times A, a_log's gradient.
2. A 3-layer hymba-1.5b at d_model 256 (chunk 256, window 1024; batch
   2, seq 1024), the SSM leaves' gradients of the model in f32, and of
   the model in f32 with the SSD scan in float64, against the model in
   float64: which part of the f32 model's error the SSD's rounding is.

Run it with another checkout's ``src`` on ``PYTHONPATH`` to compare two
versions of the plain backward.
"""
import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ssd_scan as SSD
from repro_torch.models import layers as LYR
from repro_torch.models import model as M
from repro_torch.pipeline import stage as ST

NAMES = ("dx", "ddt", "dA", "dB", "dC")


def rel(a, b) -> float:
    return ((a.double() - b).abs().max() / b.abs().max()).item()


def scan_check() -> None:
    B, T, H, P, N, c = 2, 1024, 50, 64, 16, 256
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    x, dt = r(B, T, H, P), torch.nn.functional.softplus(r(B, T, H))
    A = -torch.linspace(1.0, 16.0, H)
    Bm, Cm, dy = r(B, T, N), r(B, T, N), r(B, T, H, P)
    leaves = [t.double().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    y, _ = SSD.ssd_chunked_ref(*leaves, chunk=c)
    ref = torch.autograd.grad(y, leaves, dy.double())
    got = SSD.ssd_chunked_bwd_ref(x, dt, A, Bm, Cm, dy, chunk=c)[:5]
    l32 = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    y32, _ = SSD.ssd_chunked_ref(*l32, chunk=c)
    auto = torch.autograd.grad(y32, l32, dy)
    a64 = A.double()
    for label, gs in (("ssd_chunked_bwd_ref", got), ("f32 autograd", auto)):
        errs = {n: f"{rel(a, b):.3e}" for n, a, b in zip(NAMES, gs, ref)}
        errs["a_log"] = f"{rel(gs[2].double() * a64, ref[2] * a64):.3e}"
        print(f"scan {label}: {errs}", flush=True)


def _plain_attend(dtype):
    def f(q, k, v, *, scale, causal=True, q_start=0, kv_len=None,
          window=None):
        B, S = q.shape[0], k.shape[1]
        return FA.attend_ref(
            q.to(dtype), k.to(dtype), v.to(dtype), scale=scale,
            causal=causal, q_start=LYR._per_row(q_start, B, q.device),
            kv_len=LYR._per_row(S if kv_len is None else kv_len, B,
                                q.device), window=window or 0).to(q.dtype)
    return f


def _plain_ssd(dtype):
    def f(xh, dt, A, Bm, Cm, chunk, init_state=None):
        cast = lambda t: None if t is None else t.to(dtype)
        y, fin = SSD.ssd_chunked_ref(cast(xh), cast(dt), cast(A), cast(Bm),
                                     cast(Cm), chunk=chunk,
                                     init_state=cast(init_state))
        return y.to(xh.dtype), fin.float()
    return f


def model_check() -> None:
    cfg = get_config("hymba-1.5b").reduced(n_layers=3, d_model=256,
                                           seq=2048)
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                           chunk=256))
    p = ST.init_stacked_params(cfg, 0, ST.plan_stages(cfg), device="cpu")
    p = dict(p, layers=ST._map_layers(lambda a: a[0], p["layers"]))
    batch = SyntheticLM(cfg.vocab, 1024, 2, seed=1, device="cpu").batch(0)
    names = ["/".join(k) for k in ST.leaf_paths(p["layers"])]
    kernel_attend, kernel_ssd = LYR.attend, LYR._ssd_chunked

    def grads(dtype, ssd_dtype):
        leaves = ST._map_layers(
            lambda a: a.detach().to(dtype).requires_grad_(), p)
        LYR.attend, LYR._ssd_chunked = (_plain_attend(dtype),
                                        _plain_ssd(ssd_dtype))
        try:
            loss = M.loss_fn(cfg, leaves, batch)
            return torch.autograd.grad(loss, ST.tree_leaves(leaves["layers"]))
        finally:
            LYR.attend, LYR._ssd_chunked = kernel_attend, kernel_ssd

    ref = grads(torch.float64, torch.float64)
    for label, ssd_dtype in (("f32", torch.float32),
                             ("f32, SSD in float64", torch.float64)):
        g = grads(torch.float32, ssd_dtype)
        errs = {n: f"{rel(a, b):.3e}" for n, a, b in zip(names, g, ref)
                if n.startswith("ssm/")}
        print(f"model {label}: {errs}", flush=True)


if __name__ == "__main__":
    torch.set_num_threads(4)
    scan_check()
    model_check()
