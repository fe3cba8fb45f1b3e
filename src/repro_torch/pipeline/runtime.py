"""BaPipe pipelined serving and training on one device (the port's share
of ``repro/pipeline/runtime.py``: tensor = 1, data = 1).

The JAX runtime runs every stage on its own device inside ``shard_map``
and shifts activations around ``ppermute`` rings, one tick at a time.
Here every stage lives on the one card, and the two step factories are
in-process executors of the same schedule-plan tables:

* :func:`make_serve_step` replays :func:`repro_torch.core.schedplan.
  lower_to_ring`: at tick t, stage s runs element ``e = t - s`` on the
  activation stage s-1 produced at tick t-1; stage 0 takes a fresh
  micro-batch, the ring return of the last stage (``direct``) or one
  parked in a per-micro-batch return slot (``park``).  (stage, tick)
  pairs with no element (pipeline fill and drain) are skipped, not
  computed and masked, which gives what the JAX runtime gives with
  ``gate_ticks``.
* :func:`make_train_step` replays :func:`repro_torch.core.schedplan.
  lower_to_ticks`: every F, B and W op of the schedule is a tick of its
  stage, and the forward and backward rings are lists of the previous
  tick's outputs, cyclic as the JAX package's ``ppermute`` rings (at
  V > 1 stage S-1's chunk-v output is stage 0's chunk-(v+1) input).
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import schedplan as SP
from repro_torch.models import layers as LYR
from repro_torch.models import model as M
from repro_torch.pipeline import stage as ST


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    n_microbatches: int = 4
    schedule: str = "auto"          # schedplan name: auto | gpipe | 1f1b |
                                    # 1f1b-2x | dapple | zb-h1 | zb-h2 |
                                    # zb-auto | 1f1b-interleaved |
                                    # 1f1b-interleaved-memlean
    mem_limit: int = 0              # zb-auto peak-live cap (resident
                                    # micro-batch residuals per stage);
                                    # 0 = unbounded
    remat: str = "stage"            # none | stage | stage_save_moe | full.
                                    # B/W ticks recompute the stage from
                                    # its stashed input, so the first three
                                    # are the same; 'full' also recomputes
                                    # each layer inside that backward
    # training knobs of the JAX PipelineConfig; the port runs the
    # synchronous tick replay with no data-parallel sync, so only these
    # values are taken (the rest raise, naming their ROADMAP item)
    runtime: str = "ticks"          # ticks (stream: not ported)
    grad_sync: str = "auto"         # auto | end (overlap / 2bw: not ported)
    ar_groups: int = 1


def apply_stage(cfg: ArchConfig, layer_params: list, stage_meta: list, x, *,
                pos, cache=None, remat: str = "none"):
    """Run this stage's Lps layers over hidden state ``x`` [mb,T,d];
    ``layer_params[j]`` is layer slot j's parameter dict.
    Padded (inactive) layer slots pass ``x`` through and are not computed
    (their cache rows, k/v or SSM state, are left untouched).  ``cache``
    holds this stage's [Lps, mb, ...] leaves: k/v are written in place at
    the ``len`` offsets, which stay as they were (the serve step advances
    them once per step); the SSM conv window and state are overwritten in
    place.  ``remat='full'`` (training, no cache) runs each layer under
    ``torch.utils.checkpoint``: its activations are recomputed in the
    backward, as ``jax.checkpoint(layer_body)`` does in the JAX package.
    Returns (x', aux, cache)."""
    aux = 0.0
    for j, ml in enumerate(stage_meta):
        if not ml["active"]:
            continue
        lp = layer_params[j]
        if remat == "full":
            x, _, a = checkpoint(M.block_apply, cfg, lp, x, ml, pos=pos,
                                 use_reentrant=False)
        else:
            cl = None if cache is None else M.layer_slice(cache, j)
            x, _, a = M.block_apply(cfg, lp, x, ml, pos=pos, cache_l=cl)
        aux += a
    return x, aux, cache


def init_pipeline_cache(cfg: ArchConfig, plan: ST.StagePlan, batch: int,
                        max_len: int, *, dtype=torch.float32,
                        device="cuda") -> dict:
    """Cache [S, Lps, B, ...] (or [S, V, Lc, B, ...] for an interleaved
    plan, as :func:`stage._stack_chunks` lays out parameters): k/v
    [S, Lps, B, max_len, Hkv, D] and per-slot ``len`` offsets
    [S, Lps, B]; or, for the SSM family, the conv window
    [S, Lps, B, d_conv-1, conv_ch] and state [S, Lps, B, H, P, N]
    (``max_len`` unused)."""
    if plan.tensor != 1:
        raise NotImplementedError("the port's pipeline cache is tensor = 1 "
                                  "so far")
    pad_cfg = dataclasses.replace(cfg, n_layers=plan.n_layers_padded)
    c = M.init_cache(pad_cfg, batch, max_len, dtype=dtype, device=device)
    return ST._map_layers_(lambda a: ST._stack_chunks(a, plan), c)


def _kv_len_leaves(cache: dict, kv: bool = False) -> list:
    """The ``kv`` subtree's ``len`` offset leaves, and nothing else (the
    JAX package's ``_is_kv_len`` scope): a field named ``len`` outside a
    ``kv`` subtree is never bumped."""
    out = []
    for k, a in cache.items():
        if isinstance(a, dict):
            out += _kv_len_leaves(a, kv or k == "kv")
        elif kv and k == "len":
            out.append(a)
    return out


def _advance_len(cache: dict, adv) -> dict:
    """Advance the kv ``len`` offsets IN PLACE by ``adv``: a scalar
    (uniform step) or a per-slot [B] tensor (continuous batching: each
    slot by its own valid count), broadcast over the trailing slot axis of
    the [.., B] leaves."""
    for a in _kv_len_leaves(cache):
        a += adv
    return cache


def _chunk_index(V: int):
    """``(s, v) ->`` the index of chunk v of stage s in a stacked
    [S, Lps, ...] (V = 1) or [S, V, Lc, ...] leaf."""
    return (lambda s, v: (s,)) if V == 1 else (lambda s, v: (s, v))


def make_serve_step(cfg: ArchConfig, plan: ST.StagePlan,
                    pcfg: PipelineConfig, *, q_len: int = 1,
                    data: int = 1):
    """Build the pipelined decode/prefill step
    ``serve_step(params, cache, batch) -> (last_logits, cache)``.

    ``q_len=1`` is one-token decode; ``q_len=seq`` is prefill (KV cache
    populated, logits returned for the last position).  Micro-batches
    split the batch dimension; each (stage, element) pair runs chunk
    ``lowering.v_of_e[e]`` of the stage (its ``[Lc]`` parameters and
    cache rows) on its micro-batch's rows.  KV cache ``len`` offsets are
    per-slot [B] vectors, frozen during the ticks (each row is processed
    exactly once per step) and advanced once at the end, only where the
    cache has a ``kv`` subtree.  The cache (k/v or SSM conv/state) is
    updated IN PLACE (the JAX step donates it and returns a new one); the
    returned cache is the argument.

    Continuous batching: the batch may carry ``n_valid`` [B] int32 — slot
    b's first ``n_valid[b]`` columns are real tokens (0 = idle, 1 =
    decode, up to ``q_len`` = a prefill chunk); each slot starts at its
    own offset and advances it by exactly that count, and the logits are
    gathered at its last valid column (column 0 for an idle slot, whose
    logits mean nothing).  Padding columns write keys past the slot's
    offset, which valid queries never see (causal mask) and the next step
    overwrites.  Attention families only: the SSM family's recurrent state
    has no per-token offsets to mask padding with.

    Interleaved plans (``plan.virtual`` = V > 1) replay the same ring
    table for prefill and for one-token decode; the cache and parameter
    leaves are [S, V, Lc, ...] and each tick indexes its chunk.

    Returns f32 logits ``[B, 1, padded_vocab]``.  ``serve_step.lowering``
    is the replayed ring table."""
    if plan.tensor != 1 or data != 1:
        raise NotImplementedError(
            f"tensor={plan.tensor}, data={data}: the port serves on one "
            f"card with tensor = data = 1 so far")
    S, V, M_ = plan.n_stages, plan.virtual, pcfg.n_microbatches
    sched = SP.resolve_ring_schedule(pcfg.schedule, V)
    ml = (pcfg.mem_limit or None) if sched == "zb-auto" else None
    lowering = SP.lower_to_ring(SP.build_schedule(sched, M_, S, V,
                                                  mem_limit=ml))
    smeta = ST.stacked_meta(cfg, plan)
    MV = lowering.M * lowering.V
    chunk = _chunk_index(V)

    def serve_step(params: dict, cache: dict, batch: dict):
        if "n_valid" in batch and cfg.family in ("ssm", "hybrid", "audio"):
            raise ValueError(
                f"continuous batching (n_valid) needs per-token cache "
                f"offsets to mask padding columns; the {cfg.family} "
                f"family carries recurrent ssm/conv (or cross-attention) "
                f"state that padding tokens would pollute — serve it "
                f"with uniform steps instead")
        if not set(batch) <= {"tokens", "n_valid"}:
            raise NotImplementedError(
                f"serve batch keys {sorted(batch)}: only 'tokens' and "
                f"'n_valid' are ported (pos3 comes with M-RoPE)")
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
        retbuf = [None] * M_            # stage 0's parked ring returns
        outbuf = [None] * M_
        for t in range(lowering.n_ticks):
            # the ring return reaching stage 0 now is element t - S's
            e_arr = t - S
            if 0 <= e_arr < MV and lowering.park[e_arr]:
                retbuf[lowering.m_of_e[e_arr]] = carry[S - 1]
            nxt = [None] * S
            for s in range(S):
                e = t - s
                if not 0 <= e < MV:
                    continue            # fill/drain: no element here
                mc, v = lowering.m_of_e[e], lowering.v_of_e[e]
                rows = slice(mc * mb, (mc + 1) * mb)
                if s > 0:
                    x_in = carry[s - 1]
                elif lowering.fresh[e]:
                    x_in = x_all[rows]
                else:
                    x_in = carry[S - 1] if lowering.direct[e] else retbuf[mc]
                # this micro-batch's rows of the chunk's cache; the views
                # are written in place, 'len' stays frozen
                c_mb = ST._map_layers(
                    lambda a: a[chunk(s, v) + (slice(None), rows)], cache)
                layers = [M.layer_slice(params["layers"], chunk(s, v) + (j,))
                          for j in range(plan.layers_per_stage)]
                y, _, _ = apply_stage(cfg, layers,
                                      smeta[s] if V == 1 else smeta[s][v],
                                      x_in, pos=pos_all[rows], cache=c_mb)
                nxt[s] = y
                if s == S - 1 and lowering.collect[e]:
                    outbuf[mc] = y
            carry = nxt

        hidden = torch.cat(outbuf, dim=0)                     # [B,q,d]
        nv = batch.get("n_valid")
        if nv is None:
            _advance_len(cache, q_len)      # advance every offset once
            hidden = hidden[:, -1:]
        else:
            nv = torch.as_tensor(nv, dtype=torch.int32, device=tokens.device)
            _advance_len(cache, nv)
            # each slot's last valid column (an idle slot's column 0)
            col = nv.long().clamp(1, q_len) - 1
            hidden = hidden[torch.arange(B, device=tokens.device), col][:, None]
        h = LYR.rms_norm(hidden, params["final_norm"], cfg.norm_eps)
        table = params.get("head", params["embed"])
        return (h @ table.T).float(), cache

    serve_step.lowering = lowering
    return serve_step


# ---------------------------------------------------------------------------
# Training step factory.
# ---------------------------------------------------------------------------

def _check_train_config(cfg: ArchConfig, plan: ST.StagePlan,
                        pcfg: PipelineConfig) -> None:
    """Refuse what the port's train executor does not run yet, naming the
    ROADMAP item that ports it."""
    if plan.tensor != 1:
        raise NotImplementedError(
            f"tensor={plan.tensor}: tensor parallelism is not ported yet "
            f"(ROADMAP 'Still to port': tensor and data parallel over NCCL)")
    if pcfg.runtime != "ticks":
        raise NotImplementedError(
            f"runtime={pcfg.runtime!r}: the stream runtime is not ported yet "
            f"(ROADMAP 'Still to port': the stream runtime)")
    if pcfg.grad_sync not in ("auto", "end") or pcfg.ar_groups != 1:
        raise NotImplementedError(
            f"grad_sync={pcfg.grad_sync!r}, ar_groups={pcfg.ar_groups}: "
            f"scheduled gradient sync is not ported yet (ROADMAP 'Still to "
            f"port': tensor and data parallel over NCCL)")


def make_train_step(cfg: ArchConfig, plan: ST.StagePlan,
                    pcfg: PipelineConfig, *, optimizer=None):
    """Build the pipelined train step.

    Without an optimizer ``step(params, batch) -> (loss, grads)``; with one
    ``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    (``metrics["loss"]``), the parameters and the optimizer state updated
    in place.  ``batch`` holds ``tokens`` and ``labels`` [B, T]; the loss
    is the mean cross-entropy over the batch, a 0-dim f32 tensor on the
    parameters' device (no host sync).

    One call replays the schedule's ``lower_to_ticks`` table once.  At
    each tick each stage runs its op on chunk ``lowering.v[s][t]`` (the
    parameters ``[s, v]`` of an interleaved ``[S, V, Lc, ...]`` stack):

    * F applies the chunk under ``torch.no_grad()`` and stashes its input
      in residual slot ``xw``;
    * B re-runs the chunk from the stashed input under
      ``torch.enable_grad()`` and back-propagates the ring cotangent (for
      zero-bubble plans with respect to the input only, stashing the
      cotangent in slot ``cw`` for its W);
    * B_SEED, on the last virtual stage, also runs the loss head (final
      norm, logits, cross-entropy) and seeds it with ``1/M``;
    * W (zero-bubble plans) re-runs the chunk and takes the weight
      gradient from the stashed cotangent.

    ``pcfg.remat == 'full'`` also recomputes each layer inside the B/W
    ticks' backward.  Each layer's weights enter each B/W tick as fresh
    leaves ``p[s(, v), j].detach().requires_grad_()`` (one leaf per
    layer, so autograd hands back each layer's gradient as it is, with
    no zero-filled stage-sized sum); each chunk's first writing tick,
    found once from the table, stores its gradients into a grads tree of
    the stacked shape and the later ones add to it (padded slots get
    zeros).  The stage-0 input
    cotangents are back-propagated through ``embed_tokens`` once at the
    end, and a tied head's gradient is added to ``embed``.
    ``step.lowering`` is the replayed table; after a call,
    ``step.stash_slots[s]`` is the number of residual slots stage s wrote
    (its peak-live count; their maximum is ``lowering.n_x``)."""
    M.check_ported(cfg)
    _check_train_config(cfg, plan, pcfg)
    if pcfg.remat not in ("none", "stage", "stage_save_moe", "full"):
        raise ValueError(
            f"unknown remat {pcfg.remat!r}: expected none | stage | "
            f"stage_save_moe | full (the first three are equivalent under "
            f"first-class backward ticks — B recomputes the stage from "
            f"its stashed input)")
    S, V, M_ = plan.n_stages, plan.virtual, pcfg.n_microbatches
    sched = SP.resolve_ring_schedule(pcfg.schedule, V)
    ml = (pcfg.mem_limit or None) if sched == "zb-auto" else None
    lo = SP.lower_to_ticks(SP.build_schedule(sched, M_, S, V, mem_limit=ml))
    smeta = ST.stacked_meta(cfg, plan)
    remat = "full" if pcfg.remat == "full" else "none"
    ct_scale = 1.0 / M_
    Lc = plan.layers_per_stage
    chunk = _chunk_index(V)
    # the ticks that write a chunk's weight gradients first (B/B_SEED, or
    # W in zero-bubble plans): they store it, the later ones add to it
    grad_kinds = ((SP.TICK_W,) if lo.has_w
                  else (SP.TICK_B, SP.TICK_B_SEED))
    first_write = set()
    for s in range(S):
        seen = set()
        for t in range(lo.n_ticks):
            if lo.kind[s][t] in grad_kinds and lo.v[s][t] not in seen:
                seen.add(lo.v[s][t])
                first_write.add((s, t))

    def loss_and_grads(params: dict, batch: dict):
        tokens, labels = batch["tokens"], batch["labels"]
        B, T = tokens.shape
        if B % M_:
            raise ValueError(f"batch {B} not divisible by M={M_}")
        mb = B // M_
        dev = tokens.device
        pos = torch.arange(T, device=dev)[None].expand(mb, T)
        labels_mb = labels.reshape(M_, mb, T)
        fn_p = params["final_norm"]
        head_key = "head" if "head" in params else "embed"
        head_p = params[head_key]
        # the injections under autograd: the stage-0 B ticks' input
        # cotangents are back-propagated through this gather at the end
        with torch.enable_grad():
            emb = params["embed"].detach().requires_grad_()
            inj = M.embed_tokens(cfg, emb, tokens).reshape(M_, mb, T, -1)

        def stage_fn(s, v, lp, x, remat="none"):
            y, _, _ = apply_stage(cfg, lp, smeta[s] if V == 1 else smeta[s][v],
                                  x, pos=pos, remat=remat)
            return y

        def head_loss(fnp, hdp, y, m):
            h = LYR.rms_norm(y, fnp, cfg.norm_eps)
            return M.logits_and_xent(cfg, {head_key: hdp, "embed": hdp}, h,
                                     labels_mb[m])

        def layers_of(s, v) -> list:
            """Chunk (s, v)'s per-layer parameter dicts (views)."""
            return [M.layer_slice(params["layers"], chunk(s, v) + (j,))
                    for j in range(Lc)]

        def leaves_of(s, v, grad: bool):
            """Chunk (s, v)'s per-layer weights as fresh autograd leaves
            (or plain views), and the flat list of them, layer by
            layer."""
            lps = [ST._map_layers(lambda a: a.detach().requires_grad_(grad),
                                  lp) for lp in layers_of(s, v)]
            return lps, [x for lp in lps for x in ST.tree_leaves(lp)]

        dlp = ST._map_layers(torch.empty_like, params["layers"])
        dlp_flat = ST.tree_leaves(dlp)
        n_leaf = len(dlp_flat)
        dfn = dhd = None
        ce = torch.zeros((), dtype=torch.float32, device=dev)
        dinj = [None] * M_
        xs = [[None] * lo.n_x for _ in range(S)]      # residual stash
        fin = [[None] * lo.n_f for _ in range(S)]     # parked fwd arrivals
        bin_ = [[None] * lo.n_b for _ in range(S)]    # parked bwd arrivals
        cts = [[None] * lo.n_c for _ in range(S)]     # zb cotangent stash
        written = [set() for _ in range(S)]
        f_arr = [None] * S      # forward ring: what stage s-1 sent last tick
        b_arr = [None] * S      # backward ring: what stage s+1 sent

        def add_dlp(s, t, v, grads):
            """Store (at the chunk's first writing tick) or add chunk
            (s, v)'s layer gradients; a padded layer has none and is
            stored as zeros."""
            first = (s, t) in first_write
            for k, g in enumerate(grads):
                j, i = divmod(k, n_leaf)
                slot = dlp_flat[i][chunk(s, v) + (j,)]
                if g is None:
                    if first:
                        slot.zero_()
                elif first:
                    slot.copy_(g)
                else:
                    slot.add_(g)

        for t in range(lo.n_ticks):
            f_out = [None] * S
            b_out = [None] * S
            for s in range(S):
                if lo.fpark[s][t] >= 0:
                    fin[s][lo.fpark[s][t]] = f_arr[s]
                if lo.bpark[s][t] >= 0:
                    bin_[s][lo.bpark[s][t]] = b_arr[s]
                kind, m, v = lo.kind[s][t], lo.m[s][t], lo.v[s][t]
                if kind == SP.TICK_IDLE:
                    continue
                if kind == SP.TICK_F:
                    src = lo.fsrc[s][t]
                    x_in = (inj[m].detach() if src == 0 else
                            f_arr[s] if src == 1 else fin[s][lo.fr[s][t]])
                    with torch.no_grad():
                        f_out[s] = stage_fn(s, v, layers_of(s, v), x_in)
                    xs[s][lo.xw[s][t]] = x_in
                    written[s].add(lo.xw[s][t])
                    continue
                x_res = xs[s][lo.xr[s][t]]
                if kind == SP.TICK_W:
                    ctan = cts[s][lo.cr[s][t]]
                    with torch.enable_grad():
                        lp, flat = leaves_of(s, v, True)
                        y = stage_fn(s, v, lp, x_res, remat)
                        # no graph when every slot of the chunk is padding
                        add_dlp(s, t, v, torch.autograd.grad(
                            y, flat, ctan, allow_unused=True)
                            if y.requires_grad else [None] * len(flat))
                    continue
                with torch.enable_grad():
                    x = x_res.detach().requires_grad_()
                    lp, flat = leaves_of(s, v, not lo.has_w)
                    if kind == SP.TICK_B:
                        ctan = (b_arr[s] if lo.bsrc[s][t] == 1
                                else bin_[s][lo.br[s][t]])
                        y = stage_fn(s, v, lp, x, remat)
                        if lo.has_w:        # zb: input gradient only
                            (dx,) = torch.autograd.grad(y, [x], ctan)
                            cts[s][lo.cw[s][t]] = ctan
                        else:
                            dx, *gs = torch.autograd.grad(
                                y, [x] + flat, ctan, allow_unused=True)
                            add_dlp(s, t, v, gs)
                    else:                   # TICK_B_SEED: the loss head
                        fnp = fn_p.detach().requires_grad_()
                        hdp = head_p.detach().requires_grad_()
                        seed = torch.full((), ct_scale, device=dev)
                        if lo.has_w:
                            # zb: the head's y-cotangent is stashed for W
                            y = stage_fn(s, v, lp, x, remat)
                            yd = y.detach().requires_grad_()
                            ce_m = head_loss(fnp, hdp, yd, m)
                            dfn_d, dhd_d, dy = torch.autograd.grad(
                                ce_m, [fnp, hdp, yd], seed)
                            (dx,) = torch.autograd.grad(y, [x], dy)
                            cts[s][lo.cw[s][t]] = dy
                        else:
                            ce_m = head_loss(fnp, hdp,
                                             stage_fn(s, v, lp, x, remat), m)
                            dx, dfn_d, dhd_d, *gs = torch.autograd.grad(
                                ce_m, [x, fnp, hdp] + flat, seed,
                                allow_unused=True)
                            add_dlp(s, t, v, gs)
                        dfn = dfn_d if dfn is None else dfn.add_(dfn_d)
                        dhd = dhd_d if dhd is None else dhd.add_(dhd_d)
                        ce += ce_m.detach()
                b_out[s] = dx
                if lo.dinj[s][t]:
                    dinj[m] = dx
            # one-tick neighbour hops on cyclic rings: s receives from s-1
            # (forward) and from s+1 (backward); the wrapped values carry
            # chunk passes v -> v+1 (forward) and v+1 -> v (backward)
            f_arr = f_out[-1:] + f_out[:-1]
            b_arr = b_out[1:] + b_out[:1]

        (d_embed,) = torch.autograd.grad(inj, emb, torch.stack(dinj))
        grads = dict(embed=d_embed, layers=dlp, final_norm=dfn)
        if head_key == "head":
            grads["head"] = dhd
        else:
            grads["embed"] = d_embed + dhd
        step.stash_slots = [len(w) for w in written]
        return ce / M_, grads

    if optimizer is None:
        step = loss_and_grads
    else:
        def step(params: dict, opt_state: dict, batch: dict):
            loss, grads = loss_and_grads(params, batch)
            params, opt_state = optimizer.update(params, grads, opt_state)
            return params, opt_state, dict(loss=loss)
    step.lowering = lo
    step.stash_slots = None
    return step
