"""Flash attention forward and backward: the hand-written Hopper kernels
(``csrc/flash_attention.cu``), their wrappers, and their plain versions.

Port of the Pallas TPU kernel ``repro/kernels/flash_attention.py`` (and of
its oracle ``repro/kernels/ref.py::flash_attention_ref``), grown to the
function ``repro/models/layers.py::attend`` computes: GQA by head index,
per-row ``q_start``/``kv_len``, causal mask ``kpos <= q_start + i``, a
per-call sliding ``window`` (key j seen by row i only if ``j > q_start + i
- window``; 0 is global), masked logits at ``-1e30``.  Head dims 32, 64,
128 and 256.

* :func:`flash_attend` — ``q [B,T,Hq,D]``, ``k/v [B,S,Hkv,D]``, per-row
  ``q_start``/``kv_len`` ``[B]`` int32 tensors; what the model calls.
* :func:`flash_attention` — the Pallas function's signature, ``[BH,T,D]``
  with scalar ``kv_len`` (a view with one head over the same kernel).

* :func:`flash_attend_bwd` — the gradient (dq, dk, dv) of
  :func:`flash_attend`'s function from its output and per-row statistics
  (``flash_attend(..., return_lse=True)``); :class:`FlashAttention` is the
  ``torch.autograd.Function`` that joins the two.  The Pallas kernel has no
  backward (the JAX model trains through XLA's gradient of
  ``layers.attend``), so this one has no TPU counterpart.

A tensor on the CPU takes the plain version (:func:`attend_ref`,
:func:`flash_attention_ref`, :func:`attend_bwd_ref`); a CUDA tensor
launches the kernel or raises.  ``flash_attend.launches`` counts forward
launches (one per call), ``launches_prefill`` / ``launches_decode`` count
them by route, and ``launches_bwd`` counts backward launches.

The forward has two routes, picked from static shapes by :func:`route`:
``decode`` (split-KV, all query heads of a kv head in one block) when
``T * Hq / Hkv <= DECODE_MAX_ROWS``, else ``prefill`` (tensor cores).
Only the prefill route writes the per-row statistics, so a call that asks
for them (``return_lse=True``) takes the prefill route whatever its shape.
:func:`attend_split_ref` is the decode route's algorithm in plain torch
(per-split partials and their merge), for the tests.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the decode route takes a call when T * Hq / Hkv query rows fit one block
DECODE_MAX_ROWS = 16
#: keys per shared-memory tile of the decode route; a split is a multiple
DECODE_TILE = 64
#: blocks the decode grid aims for: four per SM of an H100 (132 SMs)
DECODE_BLOCKS = 4 * 132
DECODE_MAX_SPLITS = 64


def bwd_parts(B: int, S: int, Hq: int, Hkv: int, D: int):
    """The workspace shape of the backward's dK/dV split, or None for a
    head_dim whose kernels take none (D < 256: one block sums a kv head's
    whole group).  At D = 256 each of the G = Hq / Hkv query heads of a
    group is one part: query head h is part h % G of kv head h // G, and
    writes f32 partial sums of dV and dK into ``workspace[0, h % G]`` and
    ``workspace[1, h % G]`` (shape [2, G, B, S, Hkv, D]); the last kernel
    adds the parts in order 0 .. G - 1 (:func:`attend_bwd_parts_ref`)."""
    if D != 256:
        return None
    return (2, Hq // Hkv, B, S, Hkv, D)


def route(T: int, Hq: int, Hkv: int) -> str:
    """The kernel's route for these static shapes: ``"decode"`` when the
    T rows of all Hq / Hkv query heads of a kv head fit one block
    (``T * Hq / Hkv <= DECODE_MAX_ROWS``), else ``"prefill"``."""
    return "decode" if T * (Hq // Hkv) <= DECODE_MAX_ROWS else "prefill"


def decode_splits(B: int, S: int, Hkv: int) -> tuple[int, int]:
    """``(n_split, split_len)`` of the decode route: S cut into key ranges
    of a multiple of DECODE_TILE keys so that B * Hkv * n_split blocks come
    near DECODE_BLOCKS (at most DECODE_MAX_SPLITS ranges).  From static
    shapes only, never from ``kv_len``."""
    want = min(DECODE_MAX_SPLITS, -(-DECODE_BLOCKS // (B * Hkv)))
    per = -(-S // want)
    split_len = max(DECODE_TILE, -(-per // DECODE_TILE) * DECODE_TILE)
    return -(-S // split_len), split_len


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the card's reference in chip_smoke.py).
# ---------------------------------------------------------------------------

def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        scale: float, causal: bool = True,
                        kv_len: Optional[int] = None) -> torch.Tensor:
    """q: [BH, T, D], k/v: [BH, S, D].  f32 scores, full [T, S] logits."""
    T, S = q.shape[1], k.shape[1]
    logits = torch.einsum("btd,bsd->bts", q.float(), k.float()) * scale
    kpos = torch.arange(S, device=q.device)
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= torch.arange(T, device=q.device)[:, None]
    if kv_len is not None:
        mask &= kpos[None, :] < kv_len
    logits = torch.where(mask[None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bts,bsd->btd", p, v.float()).to(q.dtype)


def _scores(q, k, *, scale, causal, q_start, kv_len, window=0):
    """f32 logits [B,Hkv,G,T,S] of q [B,T,Hq,D] against k [B,S,Hkv,D] (GQA
    by head index) and the visibility mask [B,T,S] (key j seen by row i iff
    j < kv_len, when causal j <= q_start + i, and when ``window`` > 0
    j > q_start + i - window)."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, T, Hkv, Hq // Hkv, D).float()
    logits = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) * scale
    kpos = torch.arange(S, device=q.device)
    qpos = q_start.to(torch.int64)[:, None] + torch.arange(T, device=q.device)
    m = kpos[None, None, :] < kv_len.to(torch.int64)[:, None, None]
    if causal:
        m = m & (kpos[None, None, :] <= qpos[:, :, None])
    if window:
        m = m & (kpos[None, None, :] > qpos[:, :, None] - window)
    return logits, m


def attend_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               scale: float, causal: bool, q_start: torch.Tensor,
               kv_len: torch.Tensor, window: int = 0) -> torch.Tensor:
    """The model's attention math (``layers._block_attend``) in one block:
    q [B,T,Hq,D], k/v [B,S,Hkv,D], per-row q_start/kv_len [B], sliding
    ``window`` (0: global).  Masked logits are -1e30 (``torch.where``, so
    they take no gradient)."""
    B, T, Hq, D = q.shape
    logits, m = _scores(q, k, scale=scale, causal=causal, q_start=q_start,
                        kv_len=kv_len, window=window)
    logits = torch.where(m[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v.float())
    return out.reshape(B, T, Hq, v.shape[-1]).to(q.dtype)


def attend_lse_ref(q: torch.Tensor, k: torch.Tensor, *, scale: float,
                   causal: bool, q_start: torch.Tensor,
                   kv_len: torch.Tensor, window: int = 0) -> torch.Tensor:
    """The per-row statistics the forward saves for the backward: the
    natural-log log-sum-exp of the masked logits, f32 [B, Hq, T].  A row
    that sees no key has -1e30 (-1e30 + log S rounds to it in f32)."""
    B, T, Hq, _ = q.shape
    logits, m = _scores(q, k, scale=scale, causal=causal, q_start=q_start,
                        kv_len=kv_len, window=window)
    lse = torch.logsumexp(torch.where(m[:, None, None], logits, NEG_INF), -1)
    return lse.reshape(B, Hq, T)


def attend_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                   *, scale: float, causal: bool, q_start: torch.Tensor,
                   kv_len: torch.Tensor, window: int = 0):
    """The backward's math in plain torch (not autograd): P recomputed from
    the saved statistics ``lse`` [B,Hq,T], D = rowsum(dO o O),
    dS = P o (dP - D) with dP = dO V^T, zero where the forward masked (a
    masked logit is the constant -1e30);  dV = P^T dO, dQ = scale dS K,
    dK = scale dS^T Q, GQA heads summed into their kv head.  A row that
    sees no key has P = 1/S over all S keys (its output is the mean of V)
    and dS = 0: its statistic, -1e30, cannot give 1/S, so such rows are
    picked out by their mask, as the kernel does.  Returns (dq, dk, dv) in
    the inputs' dtypes."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    logits, m = _scores(q, k, scale=scale, causal=causal, q_start=q_start,
                        kv_len=kv_len, window=window)
    seen = m[:, None, None]                                   # [B,1,1,T,S]
    idle = ~seen.any(-1, keepdim=True)                        # [B,1,1,T,1]
    p = torch.exp(torch.where(seen, logits, -torch.inf)
                  - lse.float().reshape(B, Hkv, G, T)[..., None])
    p = torch.where(idle, 1.0 / S, p)
    do = dout.reshape(B, T, Hkv, G, D).float()
    delta = (do * out.reshape(B, T, Hkv, G, D).float()).sum(-1)
    dp = torch.einsum("btkgd,bskd->bkgts", do, v.float())
    ds = torch.where(seen, p * (dp - delta.permute(0, 2, 3, 1)[..., None]),
                     0.0)
    dv = torch.einsum("bkgts,btkgd->bskd", p, do)
    dq = torch.einsum("bkgts,bskd->btkgd", ds, k.float()) * scale
    dk = torch.einsum("bkgts,btkgd->bskd", ds,
                      q.reshape(B, T, Hkv, G, D).float()) * scale
    return (dq.reshape(B, T, Hq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def attend_bwd_parts_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, lse: torch.Tensor,
                         dout: torch.Tensor, *, scale: float, causal: bool,
                         q_start: torch.Tensor, kv_len: torch.Tensor,
                         window: int = 0):
    """:func:`attend_bwd_ref`'s function computed as the D = 256 kernels
    split it (:func:`bwd_parts`): part g takes query heads g, G + g, ...
    (one of each kv head's group) and forms f32 partial sums of dK and dV
    alone; the parts are added in order 0 .. G - 1.  Returns (dq, dk, dv)
    in the inputs' dtypes."""
    G = q.shape[2] // k.shape[2]
    kw = dict(scale=scale, causal=causal, q_start=q_start, kv_len=kv_len,
              window=window)
    f = lambda t: t.float()
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = dv = None
    for g in range(G):
        dq_g, dk_g, dv_g = attend_bwd_ref(
            f(q[:, :, g::G]), f(k), f(v), f(out[:, :, g::G]),
            lse[:, g::G], f(dout[:, :, g::G]), **kw)
        dq[:, :, g::G] = dq_g
        dk = dk_g if dk is None else dk + dk_g
        dv = dv_g if dv is None else dv + dv_g
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attend_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     scale: float, causal: bool, q_start: torch.Tensor,
                     kv_len: torch.Tensor, n_split: int,
                     window: int = 0) -> torch.Tensor:
    """:func:`attend_ref`'s function computed as the decode route computes
    it: the S keys cut into ``n_split`` ranges of ceil(S / n_split), each
    range's partial (max m, sum l, unnormalised acc) over the keys a row
    sees, then the merge out = sum_s w_s acc_s / sum_s w_s l_s with
    w_s = exp(m_s - max m).  A range outside a row's visible keys (past
    them, or wholly before its ``window``) has (m, l, acc) = (-1e30, 0, 0)
    and adds nothing; a row that sees no key takes -1e30 logits over all S
    keys in every range, so it averages V."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    L = -(-S // n_split)
    qg = q.reshape(B, T, Hkv, Hq // Hkv, D).float()
    logits = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) * scale
    kpos = torch.arange(S, device=q.device)
    qpos = q_start.to(torch.int64)[:, None] + torch.arange(T, device=q.device)
    end = kv_len.to(torch.int64).clamp(max=S)[:, None].expand(B, T)
    if causal:
        end = torch.minimum(end, qpos + 1)
    start = (qpos - window + 1).clamp(min=0) if window else torch.zeros_like(
        end)
    idle = (start >= end)[:, None, None, :, None]              # [B,1,1,T,1]
    seen = ((kpos[None, None, :] >= start[:, :, None])
            & (kpos[None, None, :] < end[:, :, None]))[:, None, None]
    logits = torch.where(idle, NEG_INF,
                         torch.where(seen, logits, -torch.inf))
    pad = n_split * L - S
    logits = torch.nn.functional.pad(logits, (0, pad), value=-torch.inf)
    vs = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    lg = logits.unflatten(-1, (n_split, L))                    # [..,T,n,L]
    m = lg.amax(-1)
    m = torch.where(m == -torch.inf, NEG_INF, m)               # empty range
    e = torch.exp(lg - m[..., None])
    l = e.sum(-1)
    acc = torch.einsum("bkgtnl,bnlkd->bkgtnd", e,
                       vs.unflatten(1, (n_split, L)))
    w = torch.exp(m - m.amax(-1, keepdim=True))
    out = (w[..., None] * acc).sum(-2) / (w * l).sum(-1)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, D).to(q.dtype)


# ---------------------------------------------------------------------------
# The kernel's wrappers.
# ---------------------------------------------------------------------------

def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_fwd.argtypes = (
        [p] * 6 + [i] * 7 + [ll] * 12 + [ctypes.c_float, i, i, i, i, p, p, p])
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_bwd.argtypes = (
        [p] * 12 + [i] * 7 + [ll] * 15 + [ctypes.c_float, i, i, p, p])
    lib.flash_attention_bwd.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [i]
    lib.flash_attention_error_string.restype = ctypes.c_char_p


def _check_window(window) -> int:
    """The sliding window as the kernel takes it: a Python int >= 0 (0 is
    global), static per call; never a tensor (reading one would wait for
    the device)."""
    if isinstance(window, torch.Tensor) or int(window) != window or window < 0:
        raise ValueError(f"window must be a Python int >= 0 (0: global), got "
                         f"{window!r}")
    return int(window)


def _check_shapes(q, k, v, q_start, kv_len):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"want q [B,T,Hq,D], k/v [B,S,Hkv,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, T, Hq, D = q.shape
    if k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[-1] != D:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if Hq % k.shape[2]:
        raise ValueError(f"{Hq} query heads are not a multiple of "
                         f"{k.shape[2]} kv heads")
    for name, t in (("q_start", q_start), ("kv_len", kv_len)):
        if t.shape != (B,) or t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32 [{B}], got "
                             f"{t.dtype} {tuple(t.shape)}")


def _check_cuda(q, k, v, q_start, kv_len):
    dev = q.device
    for name, t in (("k", k), ("v", v), ("q_start", q_start),
                    ("kv_len", kv_len)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the kernel takes float32 or bfloat16 q/k/v of one "
                        f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[-1] not in HEAD_DIMS or v.shape[-1] != q.shape[-1]:
        raise ValueError(f"the kernel takes head_dim in {HEAD_DIMS} for q, "
                         f"k and v; got {q.shape[-1]}, {v.shape[-1]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a unit-stride head dim, "
                             f"strides {t.stride()}")
        # rows arrive by 16-byte copies (a size-1 dim's stride moves none)
        el = t.element_size()
        if t.data_ptr() % 16 or any(st * el % 16 for st, n in zip(
                t.stride()[:3], t.shape[:3]) if n > 1):
            raise ValueError(f"{name} rows must be 16-byte aligned: data "
                             f"pointer {t.data_ptr()}, strides {t.stride()}")
    if not (q_start.is_contiguous() and kv_len.is_contiguous()):
        raise ValueError("q_start and kv_len must be contiguous")
    if q.shape[1] == 0 or k.shape[1] == 0:
        raise ValueError(f"empty sequence: T={q.shape[1]}, S={k.shape[1]}")


def flash_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 scale: float, causal: bool, q_start: torch.Tensor,
                 kv_len: torch.Tensor, return_lse: bool = False,
                 window: int = 0):
    """Attention of q [B,T,Hq,D] over k/v [B,S,Hkv,D] (GQA by head index)
    with per-row ``q_start``/``kv_len`` [B] int32 on q's device and a
    sliding ``window`` (a Python int; 0 is global).  Returns [B,T,Hq,D] in
    q's dtype; with ``return_lse`` also the per-row statistics f32
    [B,Hq,T] (:func:`attend_lse_ref`) the backward needs, and then the
    kernel takes the prefill route, the one that writes them."""
    _check_shapes(q, k, v, q_start, kv_len)
    window = _check_window(window)
    if q.device.type == "cpu":
        out = attend_ref(q, k, v, scale=scale, causal=causal,
                         q_start=q_start, kv_len=kv_len, window=window)
        if not return_lse:
            return out
        return out, attend_lse_ref(q, k, scale=scale, causal=causal,
                                   q_start=q_start, kv_len=kv_len,
                                   window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attend runs on cuda or cpu, not {q.device}")
    _check_cuda(q, k, v, q_start, kv_len)
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    out = torch.empty((B, T, Hq, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, Hq, T), dtype=torch.float32, device=q.device)
           if return_lse else None)
    decode = not return_lse and route(T, Hq, Hkv) == "decode"
    n_split, split_len = decode_splits(B, S, Hkv) if decode else (0, 0)
    # the decode route's split partials: acc [.., R, D], then (m, l) [.., R]
    work = (torch.empty(B * Hkv * n_split * T * (Hq // Hkv) * (D + 2),
                        dtype=torch.float32, device=q.device)
            if n_split > 1 else None)
    lib = build.load("flash_attention", _declare)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            q_start.data_ptr(), kv_len.data_ptr(),
            B, T, S, Hq, Hkv, D, _DTYPE_CODE[q.dtype],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], float(scale), int(bool(causal)), window,
            n_split, split_len, None if work is None else work.data_ptr(),
            None if lse is None else lse.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd failed: CUDA error {rc} "
                           f"({lib.flash_attention_error_string(rc).decode()})")
    flash_attend.launches += 1
    if decode:
        flash_attend.launches_decode += 1
    else:
        flash_attend.launches_prefill += 1
    return (out, lse) if return_lse else out


flash_attend.launches = 0
flash_attend.launches_prefill = 0
flash_attend.launches_decode = 0
flash_attend.launches_bwd = 0


def flash_attend_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     out: torch.Tensor, lse: torch.Tensor,
                     dout: torch.Tensor, *, scale: float, causal: bool,
                     q_start: torch.Tensor, kv_len: torch.Tensor,
                     window: int = 0):
    """The gradient of :func:`flash_attend` with respect to q, k and v,
    from its output ``out`` and statistics ``lse`` (f32 [B,Hq,T], from
    ``return_lse=True``) and the output gradient ``dout`` [B,T,Hq,D].
    Returns (dq, dk, dv) in the inputs' dtype, contiguous.  One launch of
    the backward kernel on a CUDA tensor (counted in
    ``flash_attend.launches_bwd``; at D = 256 with a workspace of
    :func:`bwd_parts`' shape); :func:`attend_bwd_ref` on a CPU tensor."""
    _check_shapes(q, k, v, q_start, kv_len)
    window = _check_window(window)
    B, T, Hq, D = q.shape
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} must match q "
                             f"{tuple(q.shape)}")
    if lse.shape != (B, Hq, T) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 [{B}, {Hq}, {T}], got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if q.device.type == "cpu":
        return attend_bwd_ref(q, k, v, out, lse, dout, scale=scale,
                              causal=causal, q_start=q_start, kv_len=kv_len,
                              window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attend_bwd runs on cuda or cpu, not "
                         f"{q.device}")
    _check_cuda(q, k, v, q_start, kv_len)
    _check_cuda(out, dout, dout, q_start, kv_len)
    if lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous on {q.device}")
    S, Hkv = k.shape[1], k.shape[2]
    dq = torch.empty((B, T, Hq, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, S, Hkv, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, S, Hkv, D), dtype=q.dtype, device=q.device)
    delta = torch.empty((B, Hq, T), dtype=torch.float32, device=q.device)
    parts = bwd_parts(B, S, Hq, Hkv, D)
    work = (torch.empty(parts, dtype=torch.float32, device=q.device)
            if parts else None)
    lib = build.load("flash_attention", _declare)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            q_start.data_ptr(), kv_len.data_ptr(),
            B, T, S, Hq, Hkv, D, _DTYPE_CODE[q.dtype],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], *dout.stride()[:3], float(scale),
            int(bool(causal)), window,
            None if work is None else work.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd failed: CUDA error {rc} "
                           f"({lib.flash_attention_error_string(rc).decode()})")
    flash_attend.launches_bwd += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attend` with a gradient: the forward saves the output
    and the per-row statistics, the backward is one :func:`flash_attend_bwd`
    (q/k/v get gradients; the offsets and the window do not)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool,
                q_start: torch.Tensor, kv_len: torch.Tensor, window: int = 0):
        out, lse = flash_attend(q, k, v, scale=scale, causal=causal,
                                q_start=q_start, kv_len=kv_len,
                                return_lse=True, window=window)
        ctx.save_for_backward(q, k, v, out, lse, q_start, kv_len)
        ctx.scale, ctx.causal, ctx.window = scale, causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, q_start, kv_len = ctx.saved_tensors
        # autograd may hand a strided or unaligned gradient
        dq, dk, dv = flash_attend_bwd(
            q, k, v, out, lse, dout.contiguous(), scale=ctx.scale,
            causal=ctx.causal, q_start=q_start, kv_len=kv_len,
            window=ctx.window)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = True,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """The Pallas function's interface: q [BH,T,D], k/v [BH,S,D] ->
    [BH,T,D]; ``kv_len`` masks the valid key prefix (defaults to S)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, scale=scale, causal=causal,
                                   kv_len=kv_len)
    BH, S = q.shape[0], k.shape[1]
    q_start = torch.zeros((BH,), dtype=torch.int32, device=q.device)
    kl = torch.full((BH,), S if kv_len is None else kv_len,
                    dtype=torch.int32, device=q.device)
    out = flash_attend(q.unsqueeze(2), k.unsqueeze(2), v.unsqueeze(2),
                       scale=scale, causal=causal, q_start=q_start,
                       kv_len=kl)
    return out.squeeze(2)
