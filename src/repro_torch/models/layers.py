"""Functional building blocks of the dense GQA decoder (the port's share of
``repro/models/layers.py``: tensor parallel degree 1).

Plain functions over explicit parameter dictionaries, as in the JAX
package.  Attention goes through the hand-written flash kernel on a CUDA
tensor and through its plain version on a CPU tensor; the projections and
MLP products stay ``torch.matmul``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attend

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
    tensor its plain version.  Offsets stay on the device."""
    if window is not None:
        raise NotImplementedError("sliding-window attention is not ported "
                                  "yet")
    B, S = q.shape[0], k.shape[1]
    return flash_attend(q, k, v, scale=scale, causal=causal,
                        q_start=_per_row(q_start, B, q.device),
                        kv_len=_per_row(S if kv_len is None else kv_len, B,
                                        q.device))


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
