"""Functional building blocks of the dense GQA decoder, whisper's
cross-attention and the Mamba-2 block (the port's share of
``repro/models/layers.py``).

Plain functions over explicit parameter dictionaries, as in the JAX
package.  Attention and the SSD scan go through the hand-written kernels
on a CUDA tensor and through their plain versions on a CPU tensor; the
projections and MLP products stay ``torch.matmul``.

Tensor parallelism (Megatron): with ``tp`` (a
:class:`repro_torch.pipeline.comm.TensorAxis`, the JAX layers'
``tp_axis`` / ``tp_index``) a block holds its shard of the heads and of
the MLP's hidden units; its input enters through ``tp.copy_to_tensor``
(the gradient summed over the shards) and its row-parallel output
leaves through ``tp.reduce_from_tensor`` (the sum over the shards,
where the JAX layers call ``_maybe_psum``).  The Mamba-2 block stays
replicated over tensor, with no reduction, as in the JAX package; in a
hybrid block its input is the attention's normed input taken before
``copy_to_tensor`` (its gradient is whole on every shard already), and
the attention's output is summed over the shards before the two are
fused (``models.model.block_apply``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import FlashAttention, flash_attend
from repro_torch.kernels.ssd_scan import SSDChunked, ssd_chunked

Params = dict


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def init_rms_norm(d: int, dtype, device) -> torch.Tensor:
    return torch.zeros((d,), dtype=dtype, device=device)   # stored as (scale - 1)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, T, H, D]; pos: [B, T] int."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # [D/2]
    ang = pos.float()[..., None] * freqs                   # [B, T, D/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention core
# ---------------------------------------------------------------------------

def _per_row(val, B: int, device) -> torch.Tensor:
    """A scalar or per-row offset as an int32 [B] tensor on ``device``."""
    if isinstance(val, torch.Tensor):
        val = val.to(device=device, dtype=torch.int32)
        return val.expand(B).contiguous() if val.dim() == 0 else val
    return torch.full((B,), int(val), dtype=torch.int32, device=device)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           scale: float, causal: bool = True, q_start=0,
           kv_len=None, window=None) -> torch.Tensor:
    """q: [B,T,Hq,D], k/v: [B,S,Hkv,D] (GQA by head index).
    ``q_start``: absolute position of q[0], a scalar or per-row [B];
    ``kv_len``: valid prefix of k/v (scalar or per-row [B]) or None;
    ``window``: sliding window size, a Python int (0/None = global).
    On a CUDA tensor this is one launch of the flash kernel; on a CPU
    tensor its plain version.  Offsets stay on the device.  When autograd
    records and q/k/v require grad, a CUDA tensor goes through
    :class:`FlashAttention` (the forward with statistics, then one launch
    of the backward kernel) and a CPU tensor through the plain version
    under torch autograd.  Attention over zero keys (S = 0: a cross
    cache with no encoder frames) is zeros, as the JAX ``attend`` gives,
    on either device and with no launch: there is no work to do."""
    B, S = q.shape[0], k.shape[1]
    if S == 0:
        return q.new_zeros(q.shape[:3] + (v.shape[-1],))
    q_start = _per_row(q_start, B, q.device)
    kv_len = _per_row(S if kv_len is None else kv_len, B, q.device)
    window = window or 0
    if (q.device.type == "cuda" and torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return FlashAttention.apply(q, k, v, scale, causal, q_start, kv_len,
                                    window)
    return flash_attend(q, k, v, scale=scale, causal=causal,
                        q_start=q_start, kv_len=kv_len, window=window)


def _cache_write(buf: torch.Tensor, new: torch.Tensor, idx) -> torch.Tensor:
    """Write ``new`` [B,T,...] into the sequence axis (dim 1) of ``buf``
    [B,S,...] at offset ``idx`` — a scalar shared by the batch, or a
    per-row [B] vector.  Updates ``buf`` IN PLACE (the JAX version returns
    a new buffer) and returns it.  Like ``lax.dynamic_update_slice``, a
    start is clamped so the write fits."""
    B, T = new.shape[:2]
    S = buf.shape[1]
    start = _per_row(idx, B, buf.device).long().clamp(0, S - T)
    cols = start[:, None] + torch.arange(T, device=buf.device)[None]
    rows = torch.arange(B, device=buf.device)[:, None]
    buf[rows, cols] = new.to(buf.dtype)
    return buf


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

def init_gqa(gen: torch.Generator, cfg: ArchConfig, dtype, device) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nh, nkv = cfg.n_heads, max(1, cfg.n_kv_heads)
    s = 1.0 / math.sqrt(d)
    rn = lambda *shape: torch.randn(shape, generator=gen, dtype=dtype,
                                    device=device)
    p = dict(
        wq=rn(d, nh * hd) * s,
        wk=rn(d, nkv * hd) * s,
        wv=rn(d, nkv * hd) * s,
        wo=rn(nh * hd, d) * (s / math.sqrt(2 * cfg.n_layers)),
    )
    if cfg.qk_norm:
        p["q_norm"] = init_rms_norm(hd, dtype, device)
        p["k_norm"] = init_rms_norm(hd, dtype, device)
    return p


def sliced_kv_heads(cfg: ArchConfig, nh_l: int) -> int:
    """The kv heads that ``nh_l`` consecutive query heads read: what a
    shard slices out of replicated k/v projections, and so the kv heads
    its cache holds (``stage.kv_heads``)."""
    return max(1, nh_l // (cfg.n_heads // cfg.n_kv_heads))


def _slice_kv_heads(w: torch.Tensor, cfg: ArchConfig, nh_l: int, hd: int,
                    tp_index) -> torch.Tensor:
    """When the k/v projections are replicated over tensor (n_kv_heads
    does not split over it), the columns of the kv head(s) this shard's
    query heads read (a view); otherwise ``w`` as it is."""
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    if w.shape[-1] // hd != nkv or nh_l == nh or tp_index is None:
        return w                        # sharded already, or tensor 1
    start = tp_index * nh_l // (nh // nkv)
    return w[:, start * hd:(start + sliced_kv_heads(cfg, nh_l)) * hd]


def gqa_attention(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
                  pos: torch.Tensor, rope_theta: float,
                  is_global: bool = True, cache: Optional[dict] = None,
                  tp=None) -> tuple[torch.Tensor, Optional[dict]]:
    """One GQA self-attention.  ``is_global`` (a host bool from the layer's
    metadata) picks global masking or the config's sliding window.  With
    ``cache`` (k/v [B,S,Hkv,D] and ``len`` [B]), the new keys/values are
    written into it in place at the per-row offsets and the returned cache
    carries ``len + T``.  With ``tp`` the block runs on this shard's
    heads (``wq.shape[1] // head_dim`` of them, the kv heads sliced by
    :func:`_slice_kv_heads`) and its output is summed over the shards."""
    if cfg.mrope_sections is not None:
        raise NotImplementedError("M-RoPE is not ported yet")
    B, T, _ = x.shape
    hd = cfg.resolved_head_dim
    nh = p["wq"].shape[1] // hd
    wk, wv = p["wk"], p["wv"]
    if tp is not None:
        x = tp.copy_to_tensor(x)
        wk = _slice_kv_heads(wk, cfg, nh, hd, tp.index)
        wv = _slice_kv_heads(wv, cfg, nh, hd, tp.index)
    nkv = wk.shape[1] // hd
    q = (x @ p["wq"]).reshape(B, T, nh, hd)
    k = (x @ wk).reshape(B, T, nkv, hd)
    v = (x @ wv).reshape(B, T, nkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope_theta:        # static off-switch (learned absolute positions)
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    new_cache = None
    scale = 1.0 / math.sqrt(hd)
    window = 0 if is_global else cfg.window
    if cache is not None:
        idx = _per_row(cache["len"], B, x.device)
        ck = _cache_write(cache["k"], k, idx)
        cv = _cache_write(cache["v"], v, idx)
        new_len = idx + T
        new_cache = dict(k=ck, v=cv, len=new_len)
        out = attend(q, ck, cv, scale=scale, causal=True, q_start=idx,
                     kv_len=new_len, window=window)
    else:
        out = attend(q, k, v, scale=scale, causal=True, window=window)
    out = out.reshape(B, T, nh * hd) @ p["wo"]
    return (out if tp is None else tp.reduce_from_tensor(out)), new_cache


# ---------------------------------------------------------------------------
# Cross-attention (whisper decoder)
# ---------------------------------------------------------------------------

def init_cross(gen: torch.Generator, cfg: ArchConfig, dtype, device) -> Params:
    return init_gqa(gen, cfg, dtype, device)


def cross_attention(p: Params, x: torch.Tensor, enc: torch.Tensor,
                    cfg: ArchConfig, tp=None) -> torch.Tensor:
    """Non-causal attention of ``x`` [B,T,d] over ``enc`` [B,S,d] (no
    rope, no mask): the whisper decoder's cross-attention, and, with
    ``enc`` the same tensor as ``x``, its encoder's self-attention.  With
    ``tp`` the block runs on this shard's heads: both inputs enter
    through ``copy_to_tensor`` (``x`` once when it is ``enc``) and the
    output is summed over the shards."""
    B, T, _ = x.shape
    S = enc.shape[1]
    if tp is not None:
        same = enc is x
        x = tp.copy_to_tensor(x)
        enc = x if same else tp.copy_to_tensor(enc)
    hd = cfg.resolved_head_dim
    nh = p["wq"].shape[1] // hd
    nkv = p["wk"].shape[1] // hd
    q = (x @ p["wq"]).reshape(B, T, nh, hd)
    k = (enc @ p["wk"]).reshape(B, S, nkv, hd)
    v = (enc @ p["wv"]).reshape(B, S, nkv, hd)
    out = attend(q, k, v, scale=1.0 / math.sqrt(hd), causal=False)
    out = out.reshape(B, T, nh * hd) @ p["wo"]
    return out if tp is None else tp.reduce_from_tensor(out)


def cross_attention_cached(p: Params, x: torch.Tensor, xk: torch.Tensor,
                           xv: torch.Tensor, cfg: ArchConfig,
                           tp=None) -> torch.Tensor:
    """The decoder's cross-attention in decode: ``x`` [B,T,d] attends,
    non-causally, over the cached encoder keys and values ``xk``/``xv``
    [B,S,H,D] (this shard's heads with ``tp``)."""
    B, T, _ = x.shape
    if tp is not None:
        x = tp.copy_to_tensor(x)
    hd = cfg.resolved_head_dim
    nh = p["wq"].shape[1] // hd
    q = (x @ p["wq"]).reshape(B, T, nh, hd)
    out = attend(q, xk, xv, scale=1.0 / math.sqrt(hd), causal=False)
    out = out.reshape(B, T, nh * hd) @ p["wo"]
    return out if tp is None else tp.reduce_from_tensor(out)


# ---------------------------------------------------------------------------
# Dense (gated) MLP
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, ff: int, n_layers: int, dtype,
             device) -> Params:
    s = 1.0 / math.sqrt(d)
    rn = lambda *shape: torch.randn(shape, generator=gen, dtype=dtype,
                                    device=device)
    return dict(
        w1=rn(d, ff) * s,
        w3=rn(d, ff) * s,
        w2=rn(ff, d) * ((1.0 / math.sqrt(ff)) / math.sqrt(2 * n_layers)),
    )


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh") if kind == "gelu" else F.silu(x)


def mlp(p: Params, x: torch.Tensor, act: str = "silu",
        tp=None) -> torch.Tensor:
    """The gated MLP; with ``tp``, ``w1``/``w3`` column-parallel and
    ``w2`` row-parallel, the output summed over the shards."""
    if tp is not None:
        x = tp.copy_to_tensor(x)
    h = _act(x @ p["w1"], act) * (x @ p["w3"])
    out = h @ p["w2"]
    return out if tp is None else tp.reduce_from_tensor(out)


# ---------------------------------------------------------------------------
# Mamba-2 (SSD — state-space duality, chunked)
# ---------------------------------------------------------------------------

def init_ssm(gen: torch.Generator, cfg: ArchConfig, dtype, device) -> Params:
    """Mamba-2 block parameters.  ``a_log``, ``d_skip`` and ``dt_bias``
    stay float32 whatever ``dtype`` is; ``conv_w`` is [d_conv, conv_ch]
    (the JAX layout)."""
    s = cfg.ssm
    d = cfg.d_model
    d_inner = s.expand * d
    nh = max(1, s.n_heads(d))
    conv_ch = d_inner + 2 * s.d_state
    sc = 1.0 / math.sqrt(d)
    rn = lambda *shape: torch.randn(shape, generator=gen, dtype=dtype,
                                    device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return dict(
        in_proj=rn(d, 2 * d_inner + 2 * s.d_state + nh) * sc,
        conv_w=rn(s.d_conv, conv_ch) * 0.1,
        conv_b=torch.zeros((conv_ch,), dtype=dtype, device=device),
        a_log=torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        d_skip=torch.ones((nh,), **f32),
        dt_bias=torch.zeros((nh,), **f32),
        gate_norm=init_rms_norm(d_inner, dtype, device),
        out_proj=rn(d_inner, d) * ((1.0 / math.sqrt(s.expand * d))
                                   / math.sqrt(2 * cfg.n_layers)),
    )


def _ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                 init_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan (Mamba-2, arXiv:2405.21060 §6): one launch of the
    SSD kernel on a CUDA tensor, its plain version on a CPU tensor.
    xh [B,T,H,P], dt [B,T,H] f32, A [H] (negative), Bm/Cm [B,T,N].
    Returns (y [B,T,H,P] in xh's dtype, final_state [B,H,P,N] f32).  When
    autograd records and an input requires grad, a CUDA tensor goes
    through :class:`SSDChunked` (the forward launch keeping its scratch,
    then one launch of the backward kernel) and a CPU tensor through the
    plain version under torch autograd."""
    init = None if init_state is None else init_state.float()
    if (xh.device.type == "cuda" and torch.is_grad_enabled()
            and any(t is not None and t.requires_grad
                    for t in (xh, dt, A, Bm, Cm, init))):
        return SSDChunked.apply(xh, dt, A, Bm, Cm, chunk, init)
    return ssd_chunked(xh, dt, A, Bm, Cm, chunk=chunk, init_state=init)


def ssm_block(p: Params, x: torch.Tensor, cfg: ArchConfig,
              cache: Optional[dict] = None
              ) -> tuple[torch.Tensor, Optional[dict]]:
    """Mamba-2 block: in_proj -> causal depthwise conv -> SSD -> gated norm
    -> out_proj.  Without ``cache``: the chunked scan from a zero state.
    With ``cache`` (conv [B,d_conv-1,conv_ch], state [B,H,P,N]) and T > 1:
    the chunked scan seeded with the cached state; with T = 1: the O(1)
    recurrent update in plain torch, as the JAX package computes it.  The
    new conv window and state are written into the cache in place and the
    returned cache is the argument."""
    s = cfg.ssm
    B, T, d = x.shape
    d_inner = p["out_proj"].shape[0]
    nh = p["a_log"].shape[0]
    P, N = s.head_dim, s.d_state
    zxbcdt = x @ p["in_proj"]
    z, xin, Bm, Cm, dt = torch.split(zxbcdt, [d_inner, d_inner, N, N, nh],
                                     dim=-1)
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)                # [B,T,conv_ch]
    # depthwise causal conv as a sum of d_conv shifted products (no
    # F.conv1d: cuDNN would run an f32 convolution in TF32)
    if cache is None:
        window = F.pad(conv_in, (0, 0, s.d_conv - 1, 0))
    else:
        window = torch.cat([cache["conv"], conv_in], dim=1)  # [B,dc-1+T,ch]
    conv = sum(window[:, i:i + T] * p["conv_w"][i] for i in range(s.d_conv))
    conv = F.silu(conv + p["conv_b"])
    xc, Bc, Cc = torch.split(conv, [d_inner, N, N], dim=-1)
    xh = xc.reshape(B, T, nh, P)
    dt = F.softplus(dt.float() + p["dt_bias"])                # [B,T,H]
    A = -torch.exp(p["a_log"])                                # [H] negative
    if cache is None:
        y, _ = _ssd_chunked(xh, dt, A, Bc, Cc, min(s.chunk, T))
        y = y.float()
    elif T > 1:
        y, final = _ssd_chunked(xh, dt, A, Bc, Cc, min(s.chunk, T),
                                init_state=cache["state"])
        y = y.float()
        cache["state"].copy_(final)
    else:
        st = cache["state"].float()                           # [B,H,P,N]
        dA = torch.exp(dt[:, 0] * A[None])                    # [B,H]
        upd = (dt[:, 0, :, None] * xh[:, 0].float())[..., None] \
            * Bc[:, 0].float()[:, None, None, :]              # [B,H,P,N]
        st = st * dA[:, :, None, None] + upd
        y = torch.einsum("bn,bhpn->bhp", Cc[:, 0].float(), st)[:, None]
        cache["state"].copy_(st)
    if cache is not None:
        cache["conv"].copy_(window[:, -(s.d_conv - 1):])
    y = y + xh.float() * p["d_skip"][None, None, :, None]
    y = y.reshape(B, T, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return y @ p["out_proj"], cache
