"""Functional building blocks of the dense GQA decoder and the Mamba-2
block (the port's share of ``repro/models/layers.py``: tensor parallel
degree 1).

Plain functions over explicit parameter dictionaries, as in the JAX
package.  Attention and the SSD scan go through the hand-written kernels
on a CUDA tensor and through their plain versions on a CPU tensor; the
projections and MLP products stay ``torch.matmul``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import FlashAttention, flash_attend
from repro_torch.kernels.ssd_scan import ssd_chunked

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
    ``kv_len``: valid prefix of k/v (scalar or per-row [B]) or None.
    On a CUDA tensor this is one launch of the flash kernel; on a CPU
    tensor its plain version.  Offsets stay on the device.  When autograd
    records and q/k/v require grad, a CUDA tensor goes through
    :class:`FlashAttention` (the forward with statistics, then one launch
    of the backward kernel) and a CPU tensor through the plain version
    under torch autograd."""
    if window is not None:
        raise NotImplementedError("sliding-window attention is not ported "
                                  "yet")
    B, S = q.shape[0], k.shape[1]
    q_start = _per_row(q_start, B, q.device)
    kv_len = _per_row(S if kv_len is None else kv_len, B, q.device)
    if (q.device.type == "cuda" and torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return FlashAttention.apply(q, k, v, scale, causal, q_start, kv_len)
    return flash_attend(q, k, v, scale=scale, causal=causal,
                        q_start=q_start, kv_len=kv_len)


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


def gqa_attention(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
                  pos: torch.Tensor, rope_theta: float,
                  cache: Optional[dict] = None
                  ) -> tuple[torch.Tensor, Optional[dict]]:
    """One GQA self-attention.  With ``cache`` (k/v [B,S,Hkv,D] and
    ``len`` [B]), the new keys/values are written into it in place at the
    per-row offsets and the returned cache carries ``len + T``."""
    if cfg.window:
        raise NotImplementedError("sliding-window layers are not ported yet")
    if cfg.mrope_sections is not None:
        raise NotImplementedError("M-RoPE is not ported yet")
    B, T, _ = x.shape
    hd = cfg.resolved_head_dim
    nh = p["wq"].shape[1] // hd
    nkv = p["wk"].shape[1] // hd
    q = (x @ p["wq"]).reshape(B, T, nh, hd)
    k = (x @ p["wk"]).reshape(B, T, nkv, hd)
    v = (x @ p["wv"]).reshape(B, T, nkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope_theta:        # static off-switch (learned absolute positions)
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    new_cache = None
    scale = 1.0 / math.sqrt(hd)
    if cache is not None:
        idx = _per_row(cache["len"], B, x.device)
        ck = _cache_write(cache["k"], k, idx)
        cv = _cache_write(cache["v"], v, idx)
        new_len = idx + T
        new_cache = dict(k=ck, v=cv, len=new_len)
        out = attend(q, ck, cv, scale=scale, causal=True, q_start=idx,
                     kv_len=new_len)
    else:
        out = attend(q, k, v, scale=scale, causal=True)
    return out.reshape(B, T, nh * hd) @ p["wo"], new_cache


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


def mlp(p: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    h = _act(x @ p["w1"], act) * (x @ p["w3"])
    return h @ p["w2"]


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
    Returns (y [B,T,H,P] in xh's dtype, final_state [B,H,P,N] f32)."""
    return ssd_chunked(xh, dt, A, Bm, Cm, chunk=chunk,
                       init_state=None if init_state is None
                       else init_state.float())


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
