"""Model assembly, dense GQA and SSM branches (the port's share of
``repro/models/model.py``): ArchConfig -> init / forward / loss / decode.

Layer parameters are stacked on a leading ``[L, ...]`` axis, as in the JAX
package, so stage slicing and the numpy bridge (``repro_torch.convert``)
see the same layout; a Python loop over the layers takes the place of
``lax.scan``.  Per-layer metadata are host-side Python lists.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

Params = dict


def check_ported(cfg: ArchConfig) -> None:
    """Admit the families the port runs so far: dense GQA and pure SSM
    (Mamba-2).  MoE, MLA, hybrid, audio and VLM raise."""
    dense = (cfg.family == "dense" and cfg.attn_kind == "gqa"
             and cfg.moe is None)
    if not (dense or cfg.family == "ssm"):
        raise NotImplementedError(
            f"{cfg.arch_id}: only the dense GQA and ssm families are ported "
            f"so far (family={cfg.family}, attn={cfg.attn_kind})")


# ---------------------------------------------------------------------------
# Per-layer static metadata.
# ---------------------------------------------------------------------------

def layer_meta(cfg: ArchConfig) -> dict:
    is_global = [cfg.is_global_layer(i) for i in range(cfg.n_layers)]
    theta = [float(cfg.rope_theta_global or cfg.rope_theta) if g
             else float(cfg.rope_theta) for g in is_global]
    return dict(is_global=is_global, rope_theta=theta)


# ---------------------------------------------------------------------------
# Single-layer init / apply.
# ---------------------------------------------------------------------------

def init_block(cfg: ArchConfig, gen: torch.Generator, dtype, device) -> Params:
    check_ported(cfg)
    d = cfg.d_model
    if cfg.family == "ssm":
        return {"ln1": L.init_rms_norm(d, dtype, device),
                "ssm": L.init_ssm(gen, cfg, dtype, device)}
    return {"ln1": L.init_rms_norm(d, dtype, device),
            "attn": L.init_gqa(gen, cfg, dtype, device),
            "ln2": L.init_rms_norm(d, dtype, device),
            "mlp": L.init_mlp(gen, d, cfg.d_ff, cfg.n_layers, dtype, device)}


def block_apply(cfg: ArchConfig, p: Params, x: torch.Tensor, meta_l: dict, *,
                pos: torch.Tensor, cache_l: Optional[dict] = None, tp=None):
    """Apply one dense or SSM block.  ``meta_l`` holds this layer's
    scalars (``rope_theta``, ``is_global``).  Returns (x', cache_l', aux_loss); the
    leaves of ``cache_l`` (k/v, or the SSM conv window and state) are
    updated in place.  Neither block has an auxiliary loss: aux is the
    Python float 0.0 (no device work, no host sync).  ``tp`` (a
    ``comm.TensorAxis``, or None) runs the dense block on this tensor
    shard's parameters; the SSM block is replicated over tensor and
    ignores it, as in the JAX package."""
    if cfg.family == "ssm":
        h, new_ssm = L.ssm_block(
            p["ssm"], L.rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
            cache=None if cache_l is None else cache_l["ssm"])
        new_cache = None if cache_l is None else dict(cache_l, ssm=new_ssm)
        return x + h, new_cache, 0.0
    xin = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    h, new_kv = L.gqa_attention(
        p["attn"], xin, cfg, pos=pos, rope_theta=meta_l["rope_theta"],
        is_global=meta_l["is_global"],
        cache=None if cache_l is None else cache_l["kv"], tp=tp)
    x = x + h
    x = x + L.mlp(p["mlp"], L.rms_norm(x, p["ln2"], cfg.norm_eps), cfg.act,
                  tp)
    new_cache = None if cache_l is None else dict(cache_l, kv=new_kv)
    return x, new_cache, 0.0


# ---------------------------------------------------------------------------
# Whole-model init.
# ---------------------------------------------------------------------------

def stack_layers(blocks: list) -> Params:
    """[per-layer dict] -> dict of leaves stacked on a leading [L] axis."""
    return {k: stack_layers([b[k] for b in blocks]) if isinstance(v, dict)
            else torch.stack([b[k] for b in blocks])
            for k, v in blocks[0].items()}


def layer_slice(stacked: Params, idx) -> Params:
    """Index every leaf of a stacked layer dict (a view, no copy)."""
    return {k: layer_slice(v, idx) if isinstance(v, dict) else v[idx]
            for k, v in stacked.items()}


def init_params(cfg: ArchConfig, seed: int = 0, *, dtype=torch.float32,
                device="cuda") -> Params:
    """Unstaged parameters, layers stacked [L, ...].  Weights come from a
    ``torch.Generator`` on ``device`` seeded with ``seed``."""
    check_ported(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    embed = torch.randn((cfg.vocab, cfg.d_model), generator=gen, dtype=dtype,
                        device=device) / math.sqrt(cfg.d_model)
    layers = stack_layers([init_block(cfg, gen, dtype, device)
                           for _ in range(cfg.n_layers)])
    p = dict(embed=embed, layers=layers,
             final_norm=L.init_rms_norm(cfg.d_model, dtype, device))
    if not cfg.tie_embeddings:
        p["head"] = torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                                dtype=dtype, device=device) / math.sqrt(cfg.d_model)
    return p


# ---------------------------------------------------------------------------
# Embedding.
# ---------------------------------------------------------------------------

def embed_tokens(cfg: ArchConfig, table: torch.Tensor,
                 tokens: torch.Tensor, tp=None) -> torch.Tensor:
    """Token embedding, scaled by sqrt(d_model) in the table's dtype for
    the gemma family, as the JAX package does.  With ``tp`` the table is
    this shard's rows of the vocab: tokens outside them gather zeros and
    the shards' gathers are summed (vocab-parallel, the JAX package's
    masked ``take`` and ``psum``)."""
    if tp is None:
        x = table[tokens]
    else:
        vl = table.shape[0]
        local = tokens - tp.index * vl
        ok = (local >= 0) & (local < vl)
        x = table[local.clamp(0, vl - 1)]
        x = tp.reduce_from_tensor(torch.where(ok[..., None], x,
                                              x.new_zeros(())))
    if cfg.arch_id.startswith("gemma"):
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


# ---------------------------------------------------------------------------
# Full forward / decode (single device).
# ---------------------------------------------------------------------------

def forward(cfg: ArchConfig, params: Params, batch: dict, *, cache=None):
    """Full forward.  ``batch``: tokens [B,T] (optional ``pos``).  Returns
    (hidden, aux, cache); the cache is updated in place."""
    check_ported(cfg)
    meta = layer_meta(cfg)
    x = embed_tokens(cfg, params["embed"], batch["tokens"])
    pos = batch.get("pos")
    if pos is None:
        pos = _default_pos(batch["tokens"], cache)
    aux = 0.0
    for i in range(cfg.n_layers):
        cl = None if cache is None else layer_slice(cache, i)
        x, new_cl, a = block_apply(cfg, layer_slice(params["layers"], i), x,
                                   {k: v[i] for k, v in meta.items()},
                                   pos=pos, cache_l=cl)
        aux += a
        if cache is not None and "kv" in cache:
            cache["kv"]["len"][i] = new_cl["kv"]["len"]
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux, cache


def logits_and_xent(cfg: ArchConfig, params: Params, x: torch.Tensor,
                    labels: torch.Tensor, tp=None) -> torch.Tensor:
    """Mean cross-entropy of the f32 logits ``x @ table.T`` against
    ``labels``.  Rows of a table padded past ``cfg.vocab`` (the stacked
    parameters' padded vocab) are masked at -1e30, as the JAX pipeline's
    head does.  With ``tp`` the table is this shard's rows of the vocab
    and the softmax is decomposed over the shards (the JAX package's):
    the max of the logits taken over the shards outside autograd, the
    sum of the exponentials and the label's logit summed over them;
    ``x`` enters through ``tp.copy_to_tensor``, so its gradient sums the
    shards' parts."""
    table = params.get("head", params["embed"])
    if tp is not None:
        return _vocab_parallel_xent(cfg, table, x, labels, tp)
    logits = (x @ table.T).float()                           # [B,T,V]
    if table.shape[0] > cfg.vocab:
        valid = torch.arange(table.shape[0], device=x.device) < cfg.vocab
        logits = torch.where(valid, logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    lab = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - lab)


def _vocab_parallel_xent(cfg: ArchConfig, table: torch.Tensor,
                         x: torch.Tensor, labels: torch.Tensor, tp
                         ) -> torch.Tensor:
    logits = (tp.copy_to_tensor(x) @ table.T).float()        # [B,T,Vl]
    vl = table.shape[0]
    valid = tp.index * vl + torch.arange(vl, device=x.device) < cfg.vocab
    logits = torch.where(valid, logits, -1e30)
    gmax = tp.max(logits.detach().amax(dim=-1))
    sumexp = tp.reduce_from_tensor(
        torch.exp(logits - gmax[..., None]).sum(dim=-1))
    lse = gmax + torch.log(sumexp)
    local = labels.long() - tp.index * vl
    ok = (local >= 0) & (local < vl)
    lab = torch.gather(logits, -1, local.clamp(0, vl - 1)[..., None])[..., 0]
    lab = tp.reduce_from_tensor(torch.where(ok, lab, lab.new_zeros(())))
    return torch.mean(lse - lab)


def loss_fn(cfg: ArchConfig, params: Params, batch: dict) -> torch.Tensor:
    """Non-pipelined loss: ``batch`` holds tokens and labels [B,T];
    ``params`` the unstaged tree (layers stacked [L, ...])."""
    x, aux, _ = forward(cfg, params, batch)
    return logits_and_xent(cfg, params, x, batch["labels"]) + aux


def _default_pos(tokens: torch.Tensor, cache) -> torch.Tensor:
    B, T = tokens.shape
    pos = torch.arange(T, device=tokens.device)[None].expand(B, T)
    if cache is not None:
        off = _cache_len(cache)
        pos = pos + (off[:, None] if isinstance(off, torch.Tensor) else off)
    return pos


def _cache_len(cache):
    """Per-slot [B] offsets: ``cache["kv"]["len"]`` is stacked with
    layer-like leading axes ([L, B], or [S, Lps, B] for a pipeline cache),
    reduced with max.  0 for a cache without a ``kv`` subtree (an SSM
    cache carries no positions)."""
    if "kv" not in cache:
        return 0
    l = cache["kv"]["len"]
    return l.reshape(-1, l.shape[-1]).amax(dim=0)


# ---------------------------------------------------------------------------
# Decode caches.
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               dtype=torch.float32, device="cuda") -> dict:
    """Stacked [L, ...] decode cache for every layer: GQA k/v and
    per-slot ``len``, or the SSM conv window and state (no positions)."""
    check_ported(cfg)
    n, hd, nkv = cfg.n_layers, cfg.resolved_head_dim, max(1, cfg.n_kv_heads)
    z = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=device)
    if cfg.family == "ssm":
        return {"ssm": _ssm_cache(cfg, n, batch, z)}
    return {"kv": dict(k=z(n, batch, max_len, nkv, hd),
                       v=z(n, batch, max_len, nkv, hd),
                       len=z(n, batch, dt=torch.int32))}


def _ssm_cache(cfg: ArchConfig, n: int, batch: int, z) -> dict:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nh = max(1, s.n_heads(cfg.d_model))
    conv_ch = d_inner + 2 * s.d_state
    return dict(conv=z(n, batch, s.d_conv - 1, conv_ch),
                state=z(n, batch, nh, s.head_dim, s.d_state))


def decode_step(cfg: ArchConfig, params: Params, batch: dict, cache: dict):
    """One decode (or prefill) step: batch['tokens'] is [B,T].  Returns
    (f32 logits [B,T,V], cache updated in place)."""
    x, _, cache = forward(cfg, params, batch, cache=cache)
    table = params.get("head", params["embed"])
    return (x @ table.T).float(), cache
