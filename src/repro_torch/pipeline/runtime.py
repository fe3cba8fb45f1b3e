"""BaPipe pipelined serving on one device (the port's share of
``repro/pipeline/runtime.py``: serving, V = 1, tensor = 1, data = 1).

The JAX runtime runs every stage on its own device inside ``shard_map``
and shifts activations around a ``ppermute`` ring, one tick at a time.
Here every stage lives on the one card and :func:`make_serve_step` is an
in-process executor of the same :func:`repro_torch.core.schedplan.
lower_to_ring` tables: at tick t, stage s runs element ``e = t - s`` on the
activation stage s-1 produced at tick t-1.  (stage, tick) pairs with no
element (pipeline fill and drain) are skipped, not computed and masked,
which gives what the JAX runtime gives with ``gate_ticks``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import schedplan as SP
from repro_torch.models import layers as LYR
from repro_torch.models import model as M
from repro_torch.pipeline import stage as ST


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    n_microbatches: int = 4
    schedule: str = "auto"          # schedplan name: auto | gpipe | 1f1b


def apply_stage(cfg: ArchConfig, stage_params: dict, stage_meta: list, x, *,
                pos, cache=None):
    """Run this stage's Lps layers over hidden state ``x`` [mb,T,d].
    Padded (inactive) layer slots pass ``x`` through and are not computed
    (their cache rows, k/v or SSM state, are left untouched).  ``cache``
    holds this stage's [Lps, mb, ...] leaves: k/v are written in place at
    the ``len`` offsets, which stay as they were (the serve step advances
    them once per step); the SSM conv window and state are overwritten in
    place.  Returns (x', aux, cache)."""
    aux = 0.0
    for j, ml in enumerate(stage_meta):
        if not ml["active"]:
            continue
        cl = None if cache is None else M.layer_slice(cache, j)
        x, _, a = M.block_apply(cfg, M.layer_slice(stage_params, j), x, ml,
                                pos=pos, cache_l=cl)
        aux += a
    return x, aux, cache


def init_pipeline_cache(cfg: ArchConfig, plan: ST.StagePlan, batch: int,
                        max_len: int, *, dtype=torch.float32,
                        device="cuda") -> dict:
    """Cache [S, Lps, B, ...]: k/v [S, Lps, B, max_len, Hkv, D] and
    per-slot ``len`` offsets [S, Lps, B]; or, for the SSM family, the conv
    window [S, Lps, B, d_conv-1, conv_ch] and state [S, Lps, B, H, P, N]
    (``max_len`` unused)."""
    if plan.tensor != 1 or plan.virtual != 1:
        raise NotImplementedError("the port's pipeline cache is V = 1, "
                                  "tensor = 1 so far")
    pad_cfg = dataclasses.replace(cfg, n_layers=plan.n_layers_padded)
    c = M.init_cache(pad_cfg, batch, max_len, dtype=dtype, device=device)
    return ST._map_layers(lambda a: ST._stack_chunks(a, plan), c)


def make_serve_step(cfg: ArchConfig, plan: ST.StagePlan,
                    pcfg: PipelineConfig, *, q_len: int = 1,
                    data: int = 1):
    """Build the pipelined decode/prefill step
    ``serve_step(params, cache, batch) -> (last_logits, cache)``.

    ``q_len=1`` is one-token decode; ``q_len=seq`` is prefill (KV cache
    populated, logits returned for the last position).  Micro-batches
    split the batch dimension; each (stage, element) pair runs the
    stage's layers on its micro-batch's rows of the stage's cache.  KV
    cache ``len`` offsets are per-slot [B] vectors, frozen during the
    ticks (each row is processed exactly once per step) and advanced once
    at the end, only where the cache has a ``kv`` subtree.  The cache (k/v
    or SSM conv/state) is updated IN PLACE (the JAX step donates it and
    returns a new one); the returned cache is the argument.

    Returns f32 logits ``[B, 1, padded_vocab]``.  Continuous batching
    (``n_valid``) is not ported yet, and the SSM family refuses it."""
    if plan.virtual != 1:
        raise NotImplementedError("virtual > 1 serving is not ported yet")
    if plan.tensor != 1 or data != 1:
        raise NotImplementedError(
            f"tensor={plan.tensor}, data={data}: the port serves on one "
            f"card with tensor = data = 1 so far")
    S, M_ = plan.n_stages, pcfg.n_microbatches
    sched = SP.resolve_ring_schedule(pcfg.schedule, plan.virtual)
    lowering = SP.lower_to_ring(SP.build_schedule(sched, M_, S))
    smeta = ST.stacked_meta(cfg, plan)
    MV = lowering.M * lowering.V

    def serve_step(params: dict, cache: dict, batch: dict):
        if "n_valid" in batch and cfg.family in ("ssm", "hybrid", "audio"):
            raise ValueError(
                f"continuous batching (n_valid) needs per-token cache "
                f"offsets to mask padding columns; the {cfg.family} "
                f"family carries recurrent ssm/conv (or cross-attention) "
                f"state that padding tokens would pollute — serve it "
                f"with uniform steps instead")
        if set(batch) != {"tokens"}:
            raise NotImplementedError(
                f"serve batch keys {sorted(batch)}: only 'tokens' is "
                f"ported (n_valid / pos3 come later)")
        tokens = batch["tokens"]
        B, T = tokens.shape
        if T != q_len:
            raise ValueError(f"step built for q_len={q_len}, got {T}")
        if B % M_:
            raise ValueError(f"batch {B} not divisible by M={M_}")
        mb = B // M_
        x_all = M.embed_tokens(cfg, params["embed"], tokens)   # [B,q,d]
        # per-slot cache offsets -> per-row positions
        pos_all = M._default_pos(tokens, cache)

        carry = [None] * S              # stage s's output at the last tick
        outbuf = [None] * M_
        for t in range(lowering.n_ticks):
            nxt = [None] * S
            for s in range(S):
                e = t - s
                if not 0 <= e < MV:
                    continue            # fill/drain: no element here
                mc = lowering.m_of_e[e]
                rows = slice(mc * mb, (mc + 1) * mb)
                x_in = x_all[rows] if s == 0 else carry[s - 1]
                # this micro-batch's rows of the stage's cache; the views
                # are written in place, 'len' stays frozen
                c_mb = ST._map_layers(lambda a: a[s, :, rows], cache)
                y, _, _ = apply_stage(cfg, M.layer_slice(params["layers"], s),
                                      smeta[s], x_in, pos=pos_all[rows],
                                      cache=c_mb)
                nxt[s] = y
                if s == S - 1 and lowering.collect[e]:
                    outbuf[mc] = y
            carry = nxt
        if "kv" in cache:
            cache["kv"]["len"] += q_len     # advance every offset once

        hidden = torch.cat(outbuf, dim=0)[:, -1:]             # [B,1,d]
        h = LYR.rms_norm(hidden, params["final_norm"], cfg.norm_eps)
        table = params.get("head", params["embed"])
        return (h @ table.T).float(), cache

    return serve_step
