"""BaPipe pipelined serving and training (the port's share of
``repro/pipeline/runtime.py``; fsdp is not ported).

The JAX runtime runs every stage on its own device inside ``shard_map``
and shifts activations around ``ppermute`` rings, one tick at a time.
Here the two step factories are executors of the same schedule-plan
tables, either every stage in one process on one card or, with
``group=...``, one process per stage: each rank replays its own row of
the table and the rings are ``torch.distributed`` messages
(:mod:`repro_torch.pipeline.comm`).  One body of per-stage tick code
(:class:`_ServeRun`, :class:`_StageRun`) serves every executor.

* :func:`make_serve_step` replays :func:`repro_torch.core.schedplan.
  lower_to_ring`: at tick t, stage s runs element ``e = t - s`` on the
  activation stage s-1 produced at tick t-1; stage 0 takes a fresh
  micro-batch, the ring return of the last stage (``direct``) or one
  parked in a per-micro-batch return slot (``park``).  (stage, tick)
  pairs with no element (pipeline fill and drain) are skipped, not
  computed and masked, which gives what the JAX runtime gives with
  ``gate_ticks``.  On ranks the last rank broadcasts the logits, as the
  JAX runtime's ``psum`` over the stage axis does.
* :func:`make_train_step` replays :func:`repro_torch.core.schedplan.
  lower_to_ticks`: every F, B and W op of the schedule is a tick of its
  stage, and the forward and backward rings are lists of the previous
  tick's outputs, cyclic as the JAX package's ``ppermute`` rings (at
  V > 1 stage S-1's chunk-v output is stage 0's chunk-(v+1) input).
  Under ``runtime='ticks'`` a rank runs in lockstep with its neighbours:
  after each tick it exchanges that tick's hops and waits for all of
  them.  Under ``runtime='stream'`` it walks its own
  :func:`repro_torch.core.schedplan.lower_to_instructions` stream
  instead: it blocks only where a RUN reads an arrival, never waits for
  a send before the step's end, and each FREE empties its register.

The data axis runs as ranks only: on a (data, stage) grid
(:mod:`repro_torch.launch.mesh`) each replica takes its rows of the
batch on its own stage ring.  Training sums the gradients over the
replicas (``PipelineConfig.grad_sync``): after the walk (``end``), at
the ARSYNC slots of each rank's stream (``overlap``: the JAX runtime's
AR ops), or after the walk with the update one step behind (``2bw``,
PipeDream-2BW); serving gathers the replicas' logits in row order.

The audio family (whisper) carries a pair ``{h_enc, h_dec}`` through
the training stages where the other families carry one hidden state:
the stash, the rings and the cotangents hold the pair, a hop sends it as
one flat buffer (:func:`repro_torch.pipeline.comm.pack`), and the
stage-0 input cotangent reaches the tied embedding through ``h_dec``
only (the frames are data).  Serving carries ``h_dec`` alone: in decode
the cross keys and values come from the cache and nothing reads
``h_enc``.

The tensor axis runs as ranks only too: on a (data, stage, tensor) grid
each rank holds its tensor shard of its stage's parameters
(:func:`repro_torch.pipeline.stage.tensor_share`) and runs the blocks
Megatron-style (:class:`repro_torch.pipeline.comm.TensorAxis`: the
column-parallel inputs through ``copy_to_tensor``, the row-parallel
outputs through ``reduce_from_tensor``, the vocab-parallel embedding,
loss and logits); the activations between blocks are the same on every
shard, so shard t of stage s hops to shard t of stage s+1, as the JAX
runtime's ``ppermute`` over ``stage`` pairs devices.  Where JAX runs
``shard_map`` over ``("data", "stage", "tensor")``, here each tensor
shard is a process.
"""
from __future__ import annotations

import dataclasses
import itertools

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import schedplan as SP
from repro_torch.launch import PAR_ITEM
from repro_torch.models import layers as LYR
from repro_torch.models import model as M
from repro_torch.optim import adamw as OPT
from repro_torch.pipeline import comm as C
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
    runtime: str = "ticks"          # ticks | stream: the lockstep tick
                                    # replay, or each stage walking its own
                                    # lower_to_instructions stream
    grad_sync: str = "auto"         # auto | end | overlap | 2bw: where
                                    # the data-axis gradient sum runs —
                                    # after the walk (end), at the ARSYNC
                                    # slots of the stream (overlap; needs
                                    # runtime='stream'), or after the walk
                                    # with step k applying step k-1's
                                    # gradients (2bw: needs an optimizer
                                    # and init_2bw_state); auto overlaps
                                    # iff runtime='stream'
    ar_groups: int = 1              # overlap: AR sub-buckets a chunk (one
                                    # per layer group; must divide the
                                    # layers a chunk)


def apply_stage(cfg: ArchConfig, layer_params: list, stage_meta: list, x, *,
                pos, cache=None, remat: str = "none", tp=None):
    """Run this stage's Lps layers over hidden state ``x`` [mb,T,d] (for
    the audio family the pair ``{h_enc [mb,Sf,d], h_dec [mb,T,d]}``);
    ``layer_params[j]`` is layer slot j's parameter dict.
    Padded (inactive) layer slots pass ``x`` through and are not computed
    (their cache rows, k/v or SSM state, are left untouched).  ``cache``
    holds this stage's [Lps, mb, ...] leaves: k/v are written in place at
    the ``len`` offsets, which stay as they were (the serve step advances
    them once per step); the SSM conv window and state are overwritten in
    place.  ``remat='full'`` (training, no cache) runs each layer under
    ``torch.utils.checkpoint``: its activations are recomputed in the
    backward, as ``jax.checkpoint(layer_body)`` does in the JAX package
    (the non-reentrant checkpoint takes the audio pair as it is).
    ``tp`` (a ``comm.TensorAxis``, or None) runs each block on this
    rank's tensor shard.  Returns (x', aux, cache)."""
    aux = 0.0
    for j, ml in enumerate(stage_meta):
        if not ml["active"]:
            continue
        lp = layer_params[j]
        if remat == "full":
            x, _, a = checkpoint(M.block_apply, cfg, lp, x, ml, pos=pos,
                                 tp=tp, use_reentrant=False)
        else:
            cl = None if cache is None else M.layer_slice(cache, j)
            x, _, a = M.block_apply(cfg, lp, x, ml, pos=pos, cache_l=cl,
                                    tp=tp)
        aux += a
    return x, aux, cache


def init_pipeline_cache(cfg: ArchConfig, plan: ST.StagePlan, batch: int,
                        max_len: int, *, dtype=torch.float32,
                        device="cuda", enc_len: int = 0) -> dict:
    """Cache [S, Lps, B, ...] (or [S, V, Lc, B, ...] for an interleaved
    plan, as :func:`stage._stack_chunks` lays out parameters): k/v
    [S, Lps, B, max_len, Hkv, D] and per-slot ``len`` offsets
    [S, Lps, B]; or, for the SSM family, the conv window
    [S, Lps, B, d_conv-1, conv_ch] and state [S, Lps, B, H, P, N]
    (``max_len`` unused); or, for the hybrid family, both subtrees side
    by side; an encoder-decoder adds the cross keys and values
    ``xk``/``xv`` [S, Lps, B, enc_len, H, D] (:func:`lay_cross_cache`
    fills them).  This is the in-process executor's cache, so
    tensor 1: at ``plan.tensor`` T > 1 each rank holds its shard's cache
    (:func:`init_stage_cache`) and this raises."""
    if plan.tensor > 1:
        raise ValueError(tensor_needs_ranks(plan.tensor, plan.n_stages))
    pad_cfg = dataclasses.replace(cfg, n_layers=plan.n_layers_padded)
    c = M.init_cache(pad_cfg, batch, max_len, dtype=dtype, device=device,
                     enc_len=enc_len)
    return ST._map_layers_(lambda a: ST._stack_chunks(a, plan), c)


def init_stage_cache(cfg: ArchConfig, plan: ST.StagePlan, stage: int,
                     batch: int, max_len: int, *, data: int = 1,
                     dtype=torch.float32, device="cuda",
                     enc_len: int = 0) -> dict:
    """Stage ``stage``'s share of :func:`init_pipeline_cache` (one rank's
    cache): ``[Lps, B, ...]`` or ``[V, Lc, B, ...]`` leaves with no stage
    axis, equal to row ``stage`` of the stacked cache bit for bit (every
    layer's cache starts as zeros).  With ``data`` = D replicas a rank
    holds its replica's ``B / D`` rows of k/v and of the SSM conv window
    and state (whichever the family has) and every slot's ``len``
    offsets (``[.., B]``), so the offsets are advanced, and reset by a
    continuous-batching engine, for the whole batch on every rank.  At
    ``plan.tensor`` T > 1 a rank's k/v hold its tensor shard's
    ``stage.kv_heads(cfg, T)`` heads and its SSM state every head (the
    SSM is replicated over tensor; any shard's cache starts as zeros;
    there is no stacked cache to be a row of); an encoder-decoder's
    ``xk``/``xv`` hold its rows and its shard's ``n_heads / T`` heads (the
    JAX package shards them over heads as it does k/v)."""
    if not 0 <= stage < plan.n_stages:
        raise ValueError(f"stage {stage} of a {plan.n_stages}-stage plan")
    if data < 1 or batch % data:
        raise ValueError(f"batch {batch} does not split over data {data}")
    n_cfg = dataclasses.replace(
        cfg, n_layers=plan.virtual * plan.layers_per_stage,
        n_kv_heads=ST.kv_heads(cfg, plan.tensor),
        n_heads=cfg.n_heads // plan.tensor, head_dim=cfg.resolved_head_dim)
    c = M.init_cache(n_cfg, batch // data, max_len, dtype=dtype,
                     device=device, enc_len=enc_len)
    if data > 1 and "kv" in c:
        n = c["kv"]["len"]
        c["kv"]["len"] = n.new_zeros(n.shape[:-1] + (batch,))
    return ST._map_layers_(lambda a: ST._stage_rows(a, plan), c)


def lay_cross_cache(cfg: ArchConfig, plan: ST.StagePlan, cache: dict,
                    cross: dict, *, stage=None, tensor_rank: int = 0,
                    data: int = 1, data_rank: int = 0) -> dict:
    """Write the cross keys and values that :func:`repro_torch.models.
    model.prefill_audio_cache` made (``cross["xk"]``/``["xv"]``,
    [L, B, S, H, D], every layer's) into a serve cache, IN PLACE: the
    layers padded by repeating the last and stacked as
    :func:`stage._stack_chunks` stacks parameters ([S, Lps, ...] or
    [S, V, Lc, ...], as the JAX package lays its filled cache), then, for
    a rank's cache (:func:`init_stage_cache`), stage ``stage``'s row,
    tensor shard ``tensor_rank``'s heads and data replica ``data_rank``'s
    rows.  Returns ``cache``."""
    T = plan.tensor
    for name in ("xk", "xv"):
        a = cross[name]
        pad = plan.n_layers_padded - a.shape[0]
        a = ST._stack_chunks(torch.cat([a] + [a[-1:]] * pad) if pad else a,
                             plan)
        if stage is not None:
            a = a[stage]
        if T > 1:
            a = a.chunk(T, dim=-2)[tensor_rank]
        B = a.shape[-4]
        rows = slice(data_rank * (B // data), (data_rank + 1) * (B // data))
        cache[name].copy_(a[(slice(None),) * (a.dim() - 4) + (rows,)])
    return cache


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


class _ServeRun:
    """Stage ``s``'s share of one replay of a ``lower_to_ring`` table: its
    parked ring returns (stage 0), its collected outputs (the last stage)
    and the body of its ticks.  The in-process executor runs every
    stage's in one loop; a rank runs its own.  ``layers`` and ``cache``
    are the stage's ``[Lps, ...]`` or ``[V, Lc, ...]`` trees (row s of a
    stacked tree, or a rank's own); ``pos`` the batch's positions and
    ``x_all`` its embedded tokens (stage 0 only); ``tp`` the rank's
    tensor axis (or None)."""

    def __init__(self, cfg: ArchConfig, lo: SP.RingLowering, meta: list,
                 s: int, layers: dict, cache: dict, pos: torch.Tensor,
                 x_all, mb: int, len_off: int = 0, tp=None):
        self.cfg, self.lo, self.meta, self.s, self.tp = cfg, lo, meta, s, tp
        self.layers, self.cache = layers, cache
        self.pos, self.x_all, self.mb = pos, x_all, mb
        self.len_off = len_off          # a replica's first row in ``len``
        self.lc = len(meta if lo.V == 1 else meta[0])
        self.retbuf = [None] * lo.M         # stage 0's parked returns
        self.outbuf = [None] * lo.M         # the last stage's outputs

    def tick(self, t: int, arr):
        """Run tick t on what arrived from the previous stage (stage 0:
        from the last, the ring return; None where nothing did); returns
        the tick's output, None where the stage has no element."""
        lo, s, S = self.lo, self.s, self.lo.N
        MV = lo.M * lo.V
        # the ring return reaching stage 0 now is element t - S's
        if s == 0 and 0 <= t - S < MV and lo.park[t - S]:
            self.retbuf[lo.m_of_e[t - S]] = arr
        e = t - s
        if not 0 <= e < MV:
            return None                 # fill/drain: no element here
        mc, v = lo.m_of_e[e], lo.v_of_e[e]
        rows = slice(mc * self.mb, (mc + 1) * self.mb)
        if s > 0:
            x_in = arr
        elif lo.fresh[e]:
            x_in = self.x_all[rows]
        else:
            x_in = arr if lo.direct[e] else self.retbuf[mc]
        ch = () if lo.V == 1 else (v,)
        # this micro-batch's rows of the chunk's cache; the views are
        # written in place, 'len' stays frozen
        c_mb = _cache_rows(self.cache, ch, rows, self.len_off)
        layers = [M.layer_slice(self.layers, ch + (j,))
                  for j in range(self.lc)]
        audio = self.cfg.family == "audio"
        if audio:
            # the ring carries h_dec alone: in decode the cross K/V come
            # from the cache and no block reads h_enc
            x_in = dict(h_enc=None, h_dec=x_in)
        y, _, _ = apply_stage(self.cfg, layers,
                              self.meta if lo.V == 1 else self.meta[v],
                              x_in, pos=self.pos[rows], cache=c_mb,
                              tp=self.tp)
        if audio:
            y = y["h_dec"]
        if s == S - 1 and lo.collect[e]:
            self.outbuf[mc] = y
        return y


def _cache_rows(cache: dict, ch: tuple, rows: slice, len_off: int,
                kv: bool = False) -> dict:
    """Views of ``rows`` of a stage cache's chunk ``ch``; the ``kv``
    subtree's ``len`` offsets are read ``len_off`` rows further on (a
    replica's cache holds its own rows of k/v but every slot's offsets:
    :func:`init_stage_cache`)."""
    out = {}
    for k, a in cache.items():
        if isinstance(a, dict):
            out[k] = _cache_rows(a, ch, rows, len_off, kv or k == "kv")
        else:
            r = (slice(rows.start + len_off, rows.stop + len_off)
                 if kv and k == "len" else rows)
            out[k] = a[ch + (slice(None), r)]
    return out


def data_needs_ranks(D: int, S: int) -> str:
    """Why a data axis of D replicas of S stages cannot run in one
    process, and what it needs."""
    return (f"data {D} x {S} stages: the data axis runs only as ranks, "
            f"{D * S} processes on a (data, stage) grid "
            f"(launch.mesh.init_stage_group(..., data={D}), or torchrun "
            f"--nproc-per-node {D * S} with --data {D}); the in-process "
            f"executor runs one replica")


def tensor_needs_ranks(T: int, S: int, D: int = 1) -> str:
    """Why tensor parallelism of degree T cannot run in one process, and
    the world it needs (data x stages x tensor processes)."""
    return (f"tensor {T}: tensor parallelism runs only as ranks, one a "
            f"tensor shard: data {D} x {S} stages x tensor {T} = "
            f"{D * S * T} processes on a (data, stage, tensor) grid "
            f"(launch.mesh.init_stage_group(..., tensor={T}), or torchrun "
            f"--nproc-per-node {D * S * T} with --tensor {T}); the "
            f"in-process executor runs tensor 1")


#: a bare process group's tied-embedding group: made by the train step
_MAKE_TIE = object()


@dataclasses.dataclass(frozen=True)
class _Grid:
    """A step's place on the grid: its stage group (None in process),
    the replicas and its replica, the data group, the tied-embedding
    group, and the tensor group (None at tensor 1)."""
    group: object
    data: int
    data_rank: int
    data_group: object
    tie_group: object
    tensor_group: object = None


def _grid(group, data: int, plan: ST.StagePlan) -> _Grid:
    """The :class:`_Grid` of ``group``: a :class:`repro_torch.launch.
    mesh.StageMesh` (its grid, whose tensor degree must be the plan's),
    a bare process group of one replica's stages (data 1, tensor 1; the
    tied group :data:`_MAKE_TIE`), or None (in process: data and tensor
    must be 1)."""
    S, T = plan.n_stages, plan.tensor
    if group is None:
        if T != 1:
            raise ValueError(tensor_needs_ranks(T, S, data))
        if data != 1:
            raise ValueError(data_needs_ranks(data, S))
        return _Grid(None, 1, 0, None, None)
    if hasattr(group, "data_group"):
        if group.tensor != T:
            raise ValueError(f"a tensor-{T} plan on a grid of tensor "
                             f"{group.tensor}")
        return _Grid(group.group, group.data, group.data_rank,
                     group.data_group, group.tie_group, group.tensor_group)
    if T != 1:
        raise ValueError(f"tensor={T} with a bare process group: pass the "
                         f"rank's launch.mesh.StageMesh, which holds the "
                         f"(data, stage, tensor) grid")
    if data != 1:
        raise ValueError(f"data={data} with a bare process group: pass "
                         f"the rank's launch.mesh.StageMesh, which holds "
                         f"the (data, stage) grid")
    return _Grid(group, 1, 0, None, _MAKE_TIE)


def _serve_head(cfg: ArchConfig, params: dict, outbuf: list, nv,
                q_len: int, tp=None) -> torch.Tensor:
    """The collected hidden states' logits: at the last column, or at
    each slot's last valid one (``nv``; an idle slot's column 0).  With
    ``tp`` the head is this shard's vocab rows and the shards' logits
    are gathered in shard order, ``[B, 1, padded_vocab]``."""
    hidden = torch.cat(outbuf, dim=0)                     # [B,q,d]
    if nv is None:
        hidden = hidden[:, -1:]
    else:
        col = nv.long().clamp(1, q_len) - 1
        hidden = hidden[torch.arange(hidden.shape[0], device=hidden.device),
                        col][:, None]
    h = LYR.rms_norm(hidden, params["final_norm"], cfg.norm_eps)
    table = params.get("head", params["embed"])
    logits = (h @ table.T).float()
    return logits if tp is None else tp.gather(logits)


def make_serve_step(cfg: ArchConfig, plan: ST.StagePlan,
                    pcfg: PipelineConfig, *, q_len: int = 1,
                    data: int = 1, group=None):
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
    overwrites.  Attention families only: the SSM and hybrid families'
    recurrent state has no per-token offsets to mask padding with, and
    the audio family is refused as in JAX.

    The audio family (whisper) serves from a cache whose cross keys and
    values ``prefill_audio_cache`` made and :func:`lay_cross_cache` laid
    in; stage 0 adds the sinusoid at the per-row positions to the
    embedded tokens, and the ring carries ``h_dec`` alone.

    Interleaved plans (``plan.virtual`` = V > 1) replay the same ring
    table for prefill and for one-token decode; the cache and parameter
    leaves are [S, V, Lc, ...] and each tick indexes its chunk.

    With ``group`` (a ``torch.distributed`` process group of
    ``plan.n_stages`` ranks, every rank calling this factory) the step is
    the rank executor: this rank runs stage ``group.rank()`` of the same
    table on its share of the parameters (``stage.init_stage_params``)
    and its own cache (:func:`init_stage_cache`); every rank takes the
    same ``batch``, derives the positions from its own cache's offsets
    and advances them.  Rank 0 embeds the tokens; the ring's hops
    (``comm.serve_hops``) go as one ``batch_isend_irecv`` a tick; the
    last rank applies the final norm and the head and broadcasts the
    logits, so every rank returns the same logits.
    ``serve_step.transport`` (a :class:`repro_torch.pipeline.comm.
    Transport`) then holds the last call's message counts.

    With ``group`` a :class:`repro_torch.launch.mesh.StageMesh` of D > 1
    replicas (the data axis, ranks only; ``data`` > 1 in process raises
    a ValueError naming the ranks it needs) replica d serves rows
    ``[d B/D, (d+1) B/D)`` of the batch on its stage ring with its own
    cache rows (:func:`init_stage_cache` with ``data=D``: its k/v rows,
    every slot's offsets); its last stage broadcasts its rows' logits in
    the stage group and an all-gather over the data group puts the
    replicas' rows in order, so every rank returns the whole batch's.

    With ``group`` a mesh of tensor degree T = ``plan.tensor`` > 1 (the
    tensor axis, ranks only; in process it raises a ValueError naming the
    world it needs) each rank holds its tensor shard of the parameters
    (``stage.tensor_share``) and a cache of its shard's kv heads
    (:func:`init_stage_cache`); the blocks run Megatron-style, stage 0's
    shards embed the tokens vocab-parallel, the last stage's shards
    gather their vocab shards' logits in shard order and each
    broadcasts them along its own stage group.

    Returns f32 logits ``[B, 1, padded_vocab]``.  ``serve_step.lowering``
    is the replayed ring table."""
    if cfg.fsdp:
        raise NotImplementedError(
            f"fsdp={cfg.fsdp}: not ported yet ({PAR_ITEM}); the port "
            f"serves without fsdp")
    S, V, M_ = plan.n_stages, plan.virtual, pcfg.n_microbatches
    grid = _grid(group, data, plan)
    group, D, d_rank = grid.group, grid.data, grid.data_rank
    data_group = grid.data_group
    sched = SP.resolve_ring_schedule(pcfg.schedule, V)
    ml = (pcfg.mem_limit or None) if sched == "zb-auto" else None
    lowering = SP.lower_to_ring(SP.build_schedule(sched, M_, S, V,
                                                  mem_limit=ml))
    smeta = ST.stacked_meta(cfg, plan)

    def inject(x, pos):
        """Stage 0's input: the embedded tokens, plus (audio) the
        sinusoid at the per-row positions."""
        if cfg.family == "audio":
            x = x + M.sinusoid_pos(pos, cfg.d_model, x.dtype)
        return x

    def check(batch: dict):
        """The batch's tokens, micro-batch rows and ``n_valid`` (or
        None), once the batch is one this step serves."""
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
        if B % (M_ * D):
            raise ValueError(f"batch {B} not divisible by M={M_}"
                             + (f" x data {D}" if D > 1 else ""))
        nv = batch.get("n_valid")
        if nv is not None:
            nv = torch.as_tensor(nv, dtype=torch.int32, device=tokens.device)
        return tokens, B // (M_ * D), nv

    if group is None:
        row = lambda tree, s: ST._map_layers(lambda a: a[s], tree)

        def serve_step(params: dict, cache: dict, batch: dict):
            tokens, mb, nv = check(batch)
            # per-slot cache offsets -> per-row positions
            pos_all = M._default_pos(tokens, cache)
            x_all = inject(M.embed_tokens(cfg, params["embed"], tokens),
                           pos_all)                              # [B,q,d]
            runs = [_ServeRun(cfg, lowering, smeta[s], s,
                              row(params["layers"], s), row(cache, s),
                              pos_all, x_all if s == 0 else None, mb)
                    for s in range(S)]
            carry = [None] * S          # stage s's output at the last tick
            for t in range(lowering.n_ticks):
                # s receives from s-1; stage 0 the ring return of S-1
                arr = carry[-1:] + carry[:-1]
                carry = [r.tick(t, arr[s]) for s, r in enumerate(runs)]
            _advance_len(cache, q_len if nv is None else nv)
            return _serve_head(cfg, params, runs[-1].outbuf, nv,
                               q_len), cache

        serve_step.lowering = lowering
        return serve_step

    # ---- the rank executor: this process runs stage `rank` of replica
    # d_rank ---------------------------------------------------------------
    tp = C.Transport(group, data_group, grid.tensor_group)
    axis = C.TensorAxis(tp) if grid.tensor_group is not None else None
    rank = tp.rank
    if tp.size != S:
        raise ValueError(f"a {S}-stage plan needs a group of {S} ranks, "
                         f"got {tp.size}")
    hops = C.serve_hops(lowering)
    msgs = [([dst for src, dst in h if src == rank],
             [src for src, dst in h if dst == rank]) for h in hops]
    vocab = cfg.padded_vocab(plan.tensor)

    def rank_serve_step(params: dict, cache: dict, batch: dict):
        tp.reset()
        tokens, mb, nv = check(batch)
        dev = tokens.device
        B = tokens.shape[0]
        r0 = d_rank * (B // D)                  # this replica's first row
        mine = slice(r0, r0 + B // D)
        pos = M._default_pos(tokens, cache)[mine]
        x_all = (inject(M.embed_tokens(cfg, params["embed"], tokens[mine],
                                       axis), pos)
                 if rank == 0 else None)
        run = _ServeRun(cfg, lowering, smeta[rank], rank, params["layers"],
                        cache, pos, x_all, mb, len_off=r0, tp=axis)
        like = torch.empty((mb, q_len, cfg.d_model), device=dev,
                           dtype=params["layers"]["ln1"].dtype)
        arr = None
        for t in range(lowering.n_ticks):
            y = run.tick(t, arr)
            arr = None
            if t + 1 < lowering.n_ticks:
                sends, recvs = msgs[t + 1]
                arr = tp.exchange([(C.FWD, dst, y) for dst in sends],
                                  [(C.FWD, src) for src in recvs],
                                  like).get(C.FWD)
        _advance_len(cache, q_len if nv is None else nv)
        logits = (_serve_head(cfg, params, run.outbuf,
                              None if nv is None else nv[mine], q_len, axis)
                  if rank == S - 1 else
                  torch.empty((B // D, 1, vocab), dtype=torch.float32,
                              device=dev))
        logits = tp.broadcast(logits, S - 1, kind="logits")
        if D > 1:           # the replicas' rows, in row order
            logits = tp.all_gather(logits, data_group, kind="logits"
                                   ).reshape(B, 1, vocab)
        return logits, cache

    rank_serve_step.lowering = lowering
    rank_serve_step.transport = tp
    return rank_serve_step


# ---------------------------------------------------------------------------
# Training step factory.
# ---------------------------------------------------------------------------

def _check_train_config(cfg: ArchConfig, plan: ST.StagePlan,
                        pcfg: PipelineConfig, optimizer) -> None:
    """Refuse what the port's train executor does not run yet, naming the
    ROADMAP item that ports it, and the knobs the JAX runtime rejects,
    with its ValueErrors."""
    if cfg.fsdp:
        raise NotImplementedError(
            f"{cfg.arch_id}: fsdp (stage weights sharded over the data "
            f"axis) is not ported yet ({PAR_ITEM})")
    if pcfg.runtime not in ("ticks", "stream"):
        raise ValueError(f"unknown runtime {pcfg.runtime!r}: "
                         f"expected ticks | stream")
    if pcfg.grad_sync not in ("auto", "end", "overlap", "2bw"):
        raise ValueError(f"unknown grad_sync {pcfg.grad_sync!r}: "
                         f"expected auto | end | overlap | 2bw")
    if pcfg.grad_sync == "overlap" and pcfg.runtime != "stream":
        raise ValueError("grad_sync='overlap' requires runtime='stream' "
                         "(the tick replay has no AR slots)")
    if pcfg.grad_sync == "2bw" and optimizer is None:
        raise ValueError("grad_sync='2bw' double-buffers the weight "
                         "update and needs an optimizer")
    if pcfg.ar_groups < 1:
        raise ValueError(f"ar_groups must be >= 1, got {pcfg.ar_groups}")
    if pcfg.ar_groups > 1 and not (
            pcfg.runtime == "stream"
            and pcfg.grad_sync in ("auto", "overlap")):
        raise ValueError("ar_groups > 1 splits the OVERLAPPED AR buckets; "
                         "it requires runtime='stream' with "
                         "grad_sync='overlap' (or 'auto')")


@dataclasses.dataclass(frozen=True)
class _Tables:
    """What a train step fixes once: the model, the replayed table, the
    per-slot layer metadata and the ticks that store a chunk's gradients
    first (the later ones add to them)."""
    cfg: ArchConfig
    lo: SP.TickLowering
    smeta: list
    remat: str
    lc: int                         # layers a chunk
    first_write: frozenset
    data: int = 1                   # replicas: the loss seed is 1/(M D)


@dataclasses.dataclass
class _Call:
    """One call's inputs: positions and per-micro-batch labels; on the
    first stage the injections under autograd (``emb`` the embedding
    leaf they hang from) and, for the audio family, the frames' (data,
    no gradient); on the last the loss head's parameters; the rank's
    tensor axis (None at tensor 1); ``like``, the carry's shapes (a
    tensor, or the audio pair) for the messages."""
    dev: torch.device
    pos: torch.Tensor
    labels_mb: torch.Tensor
    like: object = None
    tp: object = None
    emb: torch.Tensor = None
    inj: torch.Tensor = None
    inj_enc: torch.Tensor = None
    fn_p: torch.Tensor = None
    head_p: torch.Tensor = None
    head_key: str = ""


def _call_inputs(cfg, M_: int, params: dict, batch: dict, *, first: bool,
                 last: bool, tp=None) -> _Call:
    tokens, labels = batch["tokens"], batch["labels"]
    B, T = tokens.shape
    if B % M_:
        raise ValueError(f"batch {B} not divisible by M={M_}")
    audio = cfg.family == "audio"
    if audio and "frames" not in batch:
        raise ValueError(f"{cfg.arch_id}: the audio family trains on "
                         f"frames [B, S_frames, d] beside the tokens")
    mb = B // M_
    dev = tokens.device
    dt = params["layers"]["ln1"].dtype
    like = torch.empty((mb, T, cfg.d_model), dtype=dt, device=dev)
    if audio:
        like = dict(h_enc=torch.empty((mb, batch["frames"].shape[1],
                                       cfg.d_model), dtype=dt, device=dev),
                    h_dec=like)
    call = _Call(dev=dev, pos=torch.arange(T, device=dev)[None].expand(mb, T),
                 labels_mb=labels.reshape(M_, mb, T), like=like, tp=tp)
    if first:
        # the injections under autograd: the stage-0 B ticks' input
        # cotangents are back-propagated through this gather at the end
        with torch.enable_grad():
            call.emb = params["embed"].detach().requires_grad_()
            x = M.embed_tokens(cfg, call.emb, tokens, tp)
            if audio:
                pair = M.audio_inputs(
                    cfg, x, torch.arange(T, device=dev)[None].expand(B, T),
                    batch["frames"])
                x = pair["h_dec"]
                call.inj_enc = pair["h_enc"].detach().reshape(M_, mb, -1,
                                                              cfg.d_model)
            call.inj = x.reshape(M_, mb, T, -1)
    if last:
        call.head_key = "head" if "head" in params else "embed"
        call.fn_p, call.head_p = params["final_norm"], params[call.head_key]
    return call


class _StageRun:
    """Stage ``s``'s share of one replay of a ``lower_to_ticks`` table:
    its residual stash, parked arrivals and zero-bubble cotangents (the
    registers), its gradient sums, and the body of its ticks.  The
    in-process executors run every stage's in one loop; a rank runs its
    own; under ``runtime='stream'`` the same ticks run at the slots of
    the stage's instruction stream, an arrival may still be in flight
    (a :class:`repro_torch.pipeline.comm.Posted`, waited by the tick that
    reads it) and FREE instructions empty registers (:meth:`free`).
    ``layers`` and ``dlp`` are the stage's ``[Lps, ...]`` or ``[V, Lc,
    ...]`` parameter and gradient trees (row s of a stacked tree, or a
    rank's own)."""

    def __init__(self, tb: _Tables, s: int, layers: dict, dlp: dict,
                 call: _Call):
        lo = tb.lo
        self.tb, self.s, self.layers, self.call = tb, s, layers, call
        self.dlp_flat = ST.tree_leaves(dlp)
        self.xs = [None] * lo.n_x           # residual stash
        self.fin = [None] * lo.n_f          # parked forward arrivals
        self.bin = [None] * lo.n_b          # parked backward arrivals
        self.cts = [None] * lo.n_c          # zero-bubble cotangent stash
        self.written = set()
        self.peak_live = 0                  # most registers held at once
        self.dfn = self.dhd = None
        self.ce = torch.zeros((), dtype=torch.float32, device=call.dev)
        self.dinj = [None] * lo.M

    def _chunk(self, v: int) -> tuple:
        return () if self.tb.lo.V == 1 else (v,)

    def _inject(self, m: int):
        """Micro-batch m's stage-0 input (no graph back to the
        embedding: its cotangent goes there at the end)."""
        x = self.call.inj[m].detach()
        if self.call.inj_enc is None:
            return x
        return dict(h_enc=self.call.inj_enc[m], h_dec=x)

    def _got(self, x):
        """An arrival as the carry: waited for if still in flight, and a
        flat audio pair viewed as the pair (:func:`comm.unpack`)."""
        return C.unpack(_arrived(x), self.call.like)

    def _apply(self, v, lp, x, remat="none"):
        meta = self.tb.smeta[self.s]
        y, _, _ = apply_stage(self.tb.cfg, lp,
                              meta if self.tb.lo.V == 1 else meta[v], x,
                              pos=self.call.pos, remat=remat,
                              tp=self.call.tp)
        return y

    def _head_loss(self, fnp, hdp, y, m):
        h = LYR.rms_norm(_hidden_of(y), fnp, self.tb.cfg.norm_eps)
        return M.logits_and_xent(self.tb.cfg,
                                 {self.call.head_key: hdp, "embed": hdp}, h,
                                 self.call.labels_mb[m], self.call.tp)

    def _layers(self, v) -> list:
        """Chunk v's per-layer parameter dicts (views)."""
        return [M.layer_slice(self.layers, self._chunk(v) + (j,))
                for j in range(self.tb.lc)]

    def _leaves(self, v, grad: bool):
        """Chunk v's per-layer weights as fresh autograd leaves (or plain
        views), and the flat list of them, layer by layer."""
        lps = [ST._map_layers(lambda a: a.detach().requires_grad_(grad), lp)
               for lp in self._layers(v)]
        return lps, [x for lp in lps for x in ST.tree_leaves(lp)]

    def _add_dlp(self, t, v, grads):
        """Store (at the chunk's first writing tick) or add chunk v's
        layer gradients; a padded layer has none and is stored as
        zeros."""
        first = (self.s, t) in self.tb.first_write
        n_leaf = len(self.dlp_flat)
        for k, g in enumerate(grads):
            j, i = divmod(k, n_leaf)
            slot = self.dlp_flat[i][self._chunk(v) + (j,)]
            if g is None:
                if first:
                    slot.zero_()
            elif first:
                slot.copy_(g)
            else:
                slot.add_(g)

    _REGS = dict(x="xs", f="fin", b="bin", c="cts")

    def free(self, buf: str, idx: int) -> None:
        """Empty register ``idx`` of ``buf`` (a FREE instruction)."""
        getattr(self, self._REGS[buf])[idx] = None

    def tick(self, t: int, f_arr, b_arr):
        """Run tick t on what arrived on the forward and backward rings
        (None where nothing did); returns the tick's (forward, backward)
        outputs, None where it makes none."""
        out = self._tick(t, f_arr, b_arr)
        self.peak_live = max(self.peak_live, sum(
            x is not None for x in self.xs + self.fin + self.bin + self.cts))
        return out

    def _tick(self, t: int, f_arr, b_arr):
        lo, s, call, remat = self.tb.lo, self.s, self.call, self.tb.remat
        if lo.fpark[s][t] >= 0:
            self.fin[lo.fpark[s][t]] = f_arr
        if lo.bpark[s][t] >= 0:
            self.bin[lo.bpark[s][t]] = b_arr
        kind, m, v = lo.kind[s][t], lo.m[s][t], lo.v[s][t]
        if kind in (SP.TICK_IDLE, SP.TICK_AR):  # AR: no compute here
            return None, None
        if kind == SP.TICK_F:
            src = lo.fsrc[s][t]
            x_in = (self._inject(m) if src == 0 else
                    self._got(f_arr if src == 1 else self.fin[lo.fr[s][t]]))
            with torch.no_grad():
                y = self._apply(v, self._layers(v), x_in)
            self.xs[lo.xw[s][t]] = x_in
            self.written.add(lo.xw[s][t])
            return y, None
        x_res = self.xs[lo.xr[s][t]]
        if kind == SP.TICK_W:
            ctan = self.cts[lo.cr[s][t]]
            with torch.enable_grad():
                lp, flat = self._leaves(v, True)
                y = self._apply(v, lp, x_res, remat)
                # no graph when every slot of the chunk is padding
                self._add_dlp(t, v, _vjp(y, ctan, flat))
            return None, None
        with torch.enable_grad():
            x = _carry_map(lambda a: a.detach().requires_grad_(), x_res)
            xs = _parts(x)
            lp, flat = self._leaves(v, not lo.has_w)
            if kind == SP.TICK_B:
                ctan = self._got(b_arr if lo.bsrc[s][t] == 1
                                 else self.bin[lo.br[s][t]])
                y = self._apply(v, lp, x, remat)
                if lo.has_w:        # zb: input gradient only
                    dx = _carry_of(x, _vjp(y, ctan, xs))
                    self.cts[lo.cw[s][t]] = ctan
                else:
                    gs = _vjp(y, ctan, xs + flat)
                    dx = _carry_of(x, gs[:len(xs)])
                    self._add_dlp(t, v, gs[len(xs):])
            else:                   # TICK_B_SEED: the loss head
                fnp = call.fn_p.detach().requires_grad_()
                hdp = call.head_p.detach().requires_grad_()
                seed = torch.full((), 1.0 / (lo.M * self.tb.data),
                                  device=call.dev)
                if lo.has_w:
                    # zb: the head's y-cotangent is stashed for W
                    y = self._apply(v, lp, x, remat)
                    yd = _carry_map(lambda a: a.detach().requires_grad_(),
                                    y)
                    ce_m = self._head_loss(fnp, hdp, yd, m)
                    dfn_d, dhd_d, *dys = torch.autograd.grad(
                        ce_m, [fnp, hdp] + _parts(yd), seed,
                        allow_unused=True)
                    dy = _carry_of(yd, dys)
                    dx = _carry_of(x, _vjp(y, dy, xs))
                    self.cts[lo.cw[s][t]] = dy
                else:
                    ce_m = self._head_loss(fnp, hdp,
                                           self._apply(v, lp, x, remat), m)
                    n = len(xs)
                    gs = torch.autograd.grad(ce_m, xs + [fnp, hdp] + flat,
                                             seed, allow_unused=True)
                    dx = _carry_of(x, gs[:n])
                    dfn_d, dhd_d = gs[n:n + 2]
                    self._add_dlp(t, v, gs[n + 2:])
                self.dfn = dfn_d if self.dfn is None else self.dfn.add_(dfn_d)
                self.dhd = dhd_d if self.dhd is None else self.dhd.add_(dhd_d)
                self.ce += ce_m.detach()
        if lo.dinj[s][t]:
            self.dinj[m] = dx
        return None, dx

    def embed_grad(self) -> torch.Tensor:
        """The first stage's input cotangents back-propagated through the
        embedding gather."""
        (d_embed,) = torch.autograd.grad(
            self.call.inj, self.call.emb,
            torch.stack([_hidden_of(d) for d in self.dinj]))
        return d_embed


#: the instruction streams' rings: their message tags
_RING = {"fwd": C.FWD, "bwd": C.BWD}


def _ring_peers(ring: str, s: int, S: int) -> tuple:
    """(source, destination) of stage s's messages on ``ring``: the
    forward ring runs s-1 -> s -> s+1, the backward one s+1 -> s -> s-1
    (both cyclic)."""
    step = 1 if ring == "fwd" else -1
    return (s - step) % S, (s + step) % S


def _slot_groups(stream) -> list:
    """A stream's instructions grouped by slot: [(slot, instrs)]."""
    return [(t, list(ins))
            for t, ins in itertools.groupby(stream, lambda i: i.slot)]


def _run_slot(run: "_StageRun", t: int, ins, got: dict,
              on_ar=None) -> list:
    """Slot t of a stage's instruction stream: what each RECV took off
    its ring (``got[instr]``: a tensor, or a posted receive that the tick
    reading it waits for) goes to the tick, which parks it or runs on it;
    the SENDs' (ring, value) pairs are returned; the FREEs empty their
    registers; an ARSYNC hands its instruction to ``on_ar``."""
    arr = {"fwd": None, "bwd": None}
    for i in ins:
        if i.op == SP.INSTR_RECV:
            arr[i.ring] = got[i]
    out = dict(zip(("fwd", "bwd"), run.tick(t, arr["fwd"], arr["bwd"])))
    sends = []
    for i in ins:
        if i.op == SP.INSTR_SEND:
            sends.append((i.ring, out[i.ring]))
        elif i.op == SP.INSTR_FREE:
            run.free(i.buf, i.idx)
        elif i.op == SP.INSTR_AR:
            on_ar(i)
    return sends


def _walk_stream(tp: C.Transport, run: "_StageRun", stream,
                 like: torch.Tensor, on_ar=None) -> None:
    """One rank's walk of its instruction stream.  The RECVs of a slot
    are posted once the slot before it in the stream has run, in one
    ``batch_isend_irecv`` with that slot's SENDs; a RUN waits only for
    the arrivals it reads (a parked one stays in flight in its inbox
    register until then); no send is waited for before the stream's
    end, where all are; slots with no instruction cost nothing; each
    ARSYNC goes to ``on_ar``, which posts its bucket's reduction."""
    S, rank = tp.size, tp.rank
    groups = _slot_groups(stream)

    def post(sends, ins) -> dict:
        recvs = [i for i in ins if i.op == SP.INSTR_RECV]
        handles = tp.post(
            [(_RING[ring], _ring_peers(ring, rank, S)[1], C.pack(y))
             for ring, y in sends],
            [(_RING[i.ring], _ring_peers(i.ring, rank, S)[0])
             for i in recvs], like)
        return dict(zip(recvs, handles))

    got = post((), groups[0][1] if groups else ())
    for k, (t, ins) in enumerate(groups):
        sends = _run_slot(run, t, ins, got, on_ar)
        got = post(sends, groups[k + 1][1] if k + 1 < len(groups) else ())
    tp.drain()


def _arrived(x):
    """An arrival: a tensor, or a posted receive waited for here."""
    return x.wait() if isinstance(x, C.Posted) else x


def _parts(x) -> list:
    """A carry's tensors: the hidden state, or the audio pair's two."""
    return [x[k] for k in C.PAIR] if isinstance(x, dict) else [x]


def _carry_map(fn, x):
    """``fn`` on each tensor of a carry, the carry's structure kept."""
    return {k: fn(x[k]) for k in C.PAIR} if isinstance(x, dict) else fn(x)


def _carry_of(like, grads: list):
    """The carry of ``grads`` (one a tensor of ``like``): a gradient
    that autograd left None (a part the graph never read, such as
    ``h_enc`` below a loss head with no decoder layer on its stage) is
    zeros, as a message must carry something."""
    gs = [torch.zeros_like(a) if g is None else g
          for a, g in zip(_parts(like), grads)]
    return dict(zip(C.PAIR, gs)) if isinstance(like, dict) else gs[0]


def _hidden_of(y):
    """The hidden state the loss head reads: the decoder's of a pair."""
    return y["h_dec"] if isinstance(y, dict) else y


def _vjp(y, ctan, inputs: list) -> list:
    """The gradient of the carry ``y`` along the cotangent carry ``ctan``
    with respect to ``inputs`` (None for one the graph does not reach).
    A part of ``y`` outside the graph (a stage's chunk of padding, or the
    ``h_dec`` that an encoder-only stage passes through unrecorded in a
    W tick) has no gradient to give and is left out."""
    pairs = [(a, c) for a, c in zip(_parts(y), _parts(ctan))
             if a.requires_grad]
    if not pairs:
        return [None] * len(inputs)
    return list(torch.autograd.grad([a for a, _ in pairs], inputs,
                                    [c for _, c in pairs],
                                    allow_unused=True))


def _rank_norm(tp: C.Transport, grads: dict, S: int, rank: int,
               untied: bool, cfg: ArchConfig = None,
               tensor: int = 1) -> torch.Tensor:
    """The global gradient norm from one rank's share: each rank's terms
    (:func:`repro_torch.optim.adamw.norm_terms` of the whole tree: the
    embedding on rank 0, the final norm and the untied head on the last,
    its row of every layer leaf everywhere) are all-gathered over the
    stage group and added in the in-process order, so every rank gets
    the in-process norm's bits.  On a data axis the replicas' gradients
    are summed first, so each replica forms the same norm alone.  At
    tensor T > 1 a sharded leaf's term is first summed over the tensor
    shards in shard order and a replicated leaf's counted once (shard
    0's; after the tensor sums the shards hold it alike)."""
    sq = OPT.sum_squares
    layer = [sq(x) for x in ST.tree_leaves(grads["layers"])]
    zero = torch.zeros((), dtype=torch.float32, device=layer[0].device)
    own = torch.stack([sq(grads["embed"]) if rank == 0 else zero,
                       sq(grads["final_norm"]) if rank == S - 1 else zero,
                       sq(grads["head"]) if rank == S - 1 and untied
                       else zero] + layer)
    if tensor > 1:
        paths = [("embed",), ("final_norm",), ("head",)] + [
            ("layers",) + p for p in ST.leaf_paths(grads["layers"])]
        shards = tp.all_gather(own, tp.tensor_group, kind="tensor")
        own = torch.stack([
            sum(shards[1:, i], shards[0, i])
            if ST.tensor_dim(p, cfg, tensor) is not None else shards[0, i]
            for i, p in enumerate(paths)])
    g = tp.all_gather(own)                               # [S, 3 + leaves]
    terms = [[g[0, 0]], [g[S - 1, 1]]] + ([[g[S - 1, 2]]] if untied else [])
    terms += [[g[r, 3 + i] for r in range(S)] for i in range(len(layer))]
    return torch.sqrt(OPT.add_terms(terms))


def _bucket(dlp: dict, v: int, g: int, groups: int, V: int) -> list:
    """Layer group ``g`` of ``groups`` of chunk ``v``'s gradients: each
    layer leaf's rows ``[g Lc/G, (g+1) Lc/G)`` of the chunk (views), in
    tree order; the JAX runtime's AR bucket."""
    out = []
    for a in ST.tree_leaves(dlp):
        ch = a[v] if V > 1 else a
        rg = ch.shape[0] // groups
        out.append(ch[g * rg:(g + 1) * rg])
    return out


def init_2bw_state(opt_state: dict, params: dict) -> dict:
    """Wrap an optimizer state for ``grad_sync='2bw'`` (PipeDream-2BW
    double-buffered weights, the JAX package's ``init_2bw_state``):
    ``pending`` holds the previous step's gradients (zeros until the
    first step), ``primed`` (a host bool tensor) turns True after step 0,
    so that step applies its own gradients instead of the zero
    buffer."""
    return dict(inner=opt_state,
                pending=ST._map_layers(torch.zeros_like, params),
                primed=torch.zeros((), dtype=torch.bool))


def _with_update(loss_and_grads, optimizer, two_bw: bool, norm_of=None):
    """``step(params, opt_state, batch)`` over ``loss_and_grads``: the
    optimizer's update on this step's gradients or, under 2bw, on the
    previous step's (``pending``; step 0 applies its own), the clip
    norm taken from the gradients applied (``norm_of(grads)`` on ranks,
    where a rank holds a share)."""
    def norm(grads):
        if norm_of is None or not getattr(optimizer, "clip_norm", None):
            return None
        return norm_of(grads)

    if not two_bw:
        def step(params: dict, opt_state: dict, batch: dict):
            loss, grads = loss_and_grads(params, batch)
            params, opt_state = optimizer.update(params, grads, opt_state,
                                                 norm=norm(grads))
            return params, opt_state, dict(loss=loss)
        return step

    def step(params: dict, opt_state: dict, batch: dict):
        loss, grads = loss_and_grads(params, batch)
        apply = opt_state["pending"] if bool(opt_state["primed"]) else grads
        params, inner = optimizer.update(params, apply, opt_state["inner"],
                                         norm=norm(apply))
        return params, dict(inner=inner, pending=grads,
                            primed=torch.ones((), dtype=torch.bool)), \
            dict(loss=loss)
    return step


def make_train_step(cfg: ArchConfig, plan: ST.StagePlan,
                    pcfg: PipelineConfig, *, optimizer=None, group=None,
                    data: int = 1):
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
      norm, logits, cross-entropy) and seeds it with ``1/(M D)`` (D the
      replicas, 1 in process);
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
    (its peak-live count; their maximum is ``lowering.n_x``).

    ``pcfg.runtime == 'stream'`` runs the same ticks at the slots of
    :func:`repro_torch.core.schedplan.lower_to_instructions`' streams
    (``step.instructions``; None under ``'ticks'``): in process, every
    stage's stream replayed slot by slot, a SEND at slot t handed to the
    neighbour's RECV at t + 1, each FREE emptying its register; the bits
    are the tick replay's.  ``step.live_registers[s]`` is the most
    registers (stash, inboxes, cotangents) stage s held at once.

    ``pcfg.grad_sync == '2bw'`` (with an optimizer; the state wrapped by
    :func:`init_2bw_state`) applies the previous step's gradients
    (``pending``; step 0 its own) and keeps this step's as the next
    ``pending``: PipeDream-2BW's one-step staleness, in process and on
    ranks.

    With ``group`` (a ``torch.distributed`` process group of
    ``plan.n_stages`` ranks, or a :class:`repro_torch.launch.mesh.
    StageMesh`, every rank calling this factory) the step is the rank
    executor: this rank runs stage ``group.rank()`` of the same table on
    its share of the parameters (``stage.init_stage_params`` /
    ``stage.stage_share``) and returns its share of the gradients.  The
    rings become messages (``comm.ring_hops``: an output hops only where
    the neighbour's row reads it at the next tick) between the ranks of
    the stage group, addressed by stage.  Under ``'ticks'`` they go as
    one ``batch_isend_irecv`` a tick, all waited for before the next
    tick.  Under ``'stream'`` the rank walks its own stream: a slot's
    RECVs are posted once the slot before it has run, with that slot's
    SENDs, in one ``batch_isend_irecv``; a RUN waits only for the arrival
    it reads (a parked one stays in flight until then); the sends are
    waited for only after the stream's last slot.  Then the last rank
    broadcasts the loss, so every rank returns the same 0-dim loss; a
    tied embedding's gradient is one all-reduce between the first and
    the last rank (``d_embed + dhd``, the in-process sum's bits); the
    optimizer's clip takes the global norm formed from every rank's
    terms in the in-process order.  ``step.stash_slots`` and
    ``step.live_registers`` are then this rank's counts and
    ``step.transport`` (a :class:`repro_torch.pipeline.comm.Transport`)
    holds the last call's message counts, bytes and times.

    On a mesh of D > 1 replicas (``data`` > 1 in process raises a
    ValueError naming the ranks it needs) replica d takes rows ``[d B/D,
    (d+1) B/D)`` of the batch (every rank is handed the whole batch), the
    last stages' losses are summed over the data group, so every rank
    returns the whole batch's mean, and the gradients are summed over
    the replicas (:func:`repro_torch.pipeline.stage.grad_sync_axes`),
    each bucket through ``Transport.reduce_bucket``: the layer
    gradients one bucket a chunk after the walk under ``'end'`` (and
    ``'2bw'``), or at the stream's ARSYNC slots under ``'overlap'``
    (``'auto'`` with ``runtime='stream'``; ``ar_groups`` buckets a
    chunk, one per layer group), all waited for at the step's end; then
    ``embed``, ``final_norm`` and ``head`` as one bucket, then the tied
    embedding over its two stages.  The same buckets go through the same
    collective in both modes, so ``'overlap'`` gives ``'end'``'s bits.
    The clip norm's terms are gathered over the stage group only (the
    replicas' gradients are equal by then).

    On a mesh of tensor degree T = ``plan.tensor`` > 1 (ranks only; in
    process it raises a ValueError naming the world it needs) each rank
    holds its tensor shard of its stage's parameters
    (``stage.tensor_share``; ``stage.init_stage_params(...,
    tensor_rank=)``) and returns its shard of the gradients: the blocks,
    the embedding and the loss run Megatron-style (``comm.TensorAxis``),
    the seed stays ``1/(M D)``, and the replicated leaves whose gradient
    differs by shard (``stage.grad_sync_axes``: ``q_norm``/``k_norm``,
    sliced ``wk``/``wv``) are summed over the tensor group after the
    walk; the clip norm sums a sharded leaf's terms over the shards.  A B
    or W tick re-runs its chunk's forward, and with it the forward's
    collectives, in the same order on every shard (ticks and stream
    alike)."""
    M.check_ported(cfg)
    _check_train_config(cfg, plan, pcfg, optimizer)
    if pcfg.remat not in ("none", "stage", "stage_save_moe", "full"):
        raise ValueError(
            f"unknown remat {pcfg.remat!r}: expected none | stage | "
            f"stage_save_moe | full (the first three are equivalent under "
            f"first-class backward ticks — B recomputes the stage from "
            f"its stashed input)")
    S, V, M_ = plan.n_stages, plan.virtual, pcfg.n_microbatches
    grid = _grid(group, data, plan)
    group, D, d_rank = grid.group, grid.data, grid.data_rank
    data_group, tie_group = grid.data_group, grid.tie_group
    overlap = D > 1 and (pcfg.grad_sync == "overlap" or (
        pcfg.grad_sync == "auto" and pcfg.runtime == "stream"))
    n_groups = pcfg.ar_groups if overlap else 1
    if plan.layers_per_stage % n_groups:
        raise ValueError(f"ar_groups={n_groups} must divide the "
                         f"{plan.layers_per_stage} layers per chunk")
    sched = SP.resolve_ring_schedule(pcfg.schedule, V)
    ml = (pcfg.mem_limit or None) if sched == "zb-auto" else None
    plan_ir = SP.build_schedule(sched, M_, S, V, mem_limit=ml,
                                grad_sync=n_groups if overlap else False)
    instr = (SP.lower_to_instructions(plan_ir) if pcfg.runtime == "stream"
             else None)
    lo = instr.ticks if instr is not None else SP.lower_to_ticks(plan_ir)
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
    tb = _Tables(cfg=cfg, lo=lo, smeta=ST.stacked_meta(cfg, plan),
                 remat="full" if pcfg.remat == "full" else "none",
                 lc=plan.layers_per_stage, first_write=frozenset(first_write),
                 data=D)
    row = lambda tree, s: ST._map_layers(lambda a: a[s], tree)
    two_bw = pcfg.grad_sync == "2bw"

    def loss_and_grads(params: dict, batch: dict):
        call = _call_inputs(cfg, M_, params, batch, first=True, last=True)
        dlp = ST._map_layers(torch.empty_like, params["layers"])
        runs = [_StageRun(tb, s, row(params["layers"], s), row(dlp, s), call)
                for s in range(S)]
        if instr is None:
            f_arr = b_arr = [None] * S
            for t in range(lo.n_ticks):
                outs = [r.tick(t, f_arr[s], b_arr[s])
                        for s, r in enumerate(runs)]
                f_out, b_out = [o[0] for o in outs], [o[1] for o in outs]
                # one-tick neighbour hops on cyclic rings: s receives from
                # s-1 (forward) and from s+1 (backward); the wrapped values
                # carry chunk passes v -> v+1 (forward) and v+1 -> v
                # (backward)
                f_arr = f_out[-1:] + f_out[:-1]
                b_arr = b_out[1:] + b_out[:1]
        else:
            # every stage's stream, slot by slot: a SEND at slot t is its
            # neighbour's RECV at t + 1 (one queue a ring and receiver)
            box = {(ring, s): [] for ring in _RING for s in range(S)}
            slots = [dict(_slot_groups(st)) for st in instr.streams]
            for t in range(lo.n_ticks):
                for s, r in enumerate(runs):
                    ins = slots[s].get(t)
                    if ins is None:
                        continue
                    got = {i: box[i.ring, s].pop(0) for i in ins
                           if i.op == SP.INSTR_RECV}
                    for ring, y in _run_slot(r, t, ins, got):
                        box[ring, _ring_peers(ring, s, S)[1]].append(y)
        d_embed, last = runs[0].embed_grad(), runs[-1]
        grads = dict(embed=d_embed, layers=dlp, final_norm=last.dfn)
        if call.head_key == "head":
            grads["head"] = last.dhd
        else:
            grads["embed"] = d_embed + last.dhd
        step.stash_slots = [len(r.written) for r in runs]
        step.live_registers = [r.peak_live for r in runs]
        return last.ce / M_, grads

    if group is None:
        step = (loss_and_grads if optimizer is None
                else _with_update(loss_and_grads, optimizer, two_bw))
        step.lowering, step.instructions = lo, instr
        step.stash_slots = step.live_registers = None
        return step

    # ---- the rank executor: this process runs stage `rank` of replica
    # d_rank ---------------------------------------------------------------
    tp = C.Transport(group, data_group, grid.tensor_group)
    axis = C.TensorAxis(tp) if grid.tensor_group is not None else None
    rank = tp.rank
    if tp.size != S:
        raise ValueError(f"a {S}-stage plan needs a group of {S} ranks, "
                         f"got {tp.size}")
    first, last, tied = rank == 0, rank == S - 1, cfg.tie_embeddings
    # the tied embedding's gradient: one all-reduce between the first and
    # the last rank of the replica (a mesh brings its group; for a bare
    # group every rank of the default group makes it here)
    if not tied or S == 1:
        tie_group = None
    elif S == 2:
        tie_group = group
    elif tie_group is _MAKE_TIE:
        tie_group = dist.new_group([dist.get_global_rank(group, 0),
                                    dist.get_global_rank(group, S - 1)],
                                   timeout=C.GROUP_TIMEOUT)
    hops = C.ring_hops(lo)
    msgs = [([(ring, dst) for ring, src, dst in h if src == rank],
             [(ring, src) for ring, src, dst in h if dst == rank])
            for h in hops]

    def rank_loss_and_grads(params: dict, batch: dict):
        if last and ("head" in params) == tied:
            raise ValueError(f"{cfg.arch_id}: tie_embeddings={tied} but the "
                             f"last rank's parameters "
                             f"{'have' if tied else 'lack'} a head")
        if D > 1:           # this replica's rows of the batch
            B = batch["tokens"].shape[0]
            if B % D:
                raise ValueError(f"batch {B} does not split over data {D}")
            mine = slice(d_rank * (B // D), (d_rank + 1) * (B // D))
            batch = {k: batch[k][mine] for k in ("tokens", "labels",
                                                 "frames") if k in batch}
        call = _call_inputs(cfg, M_, params, batch, first=first, last=last,
                            tp=axis)
        dlp = ST._map_layers(torch.empty_like, params["layers"])
        run = _StageRun(tb, rank, params["layers"], dlp, call)
        # what a hop carries, as one buffer: the hidden state, or the
        # audio pair flattened (comm.pack; the tick views it as the pair)
        like = C.flat_like(call.like)
        posted = []         # the gradient buckets in flight, post order
        if instr is None:
            f_arr = b_arr = None
            for t in range(lo.n_ticks):
                f_out, b_out = run.tick(t, f_arr, b_arr)
                f_arr = b_arr = None
                if t + 1 < lo.n_ticks:
                    sends, recvs = msgs[t + 1]
                    got = tp.exchange(
                        [(ring, dst, C.pack(f_out if ring == C.FWD
                                            else b_out))
                         for ring, dst in sends], recvs, like)
                    f_arr, b_arr = got.get(C.FWD), got.get(C.BWD)
        else:
            # overlap: each ARSYNC slot posts its chunk's layer group
            on_ar = (lambda i: posted.append(tp.reduce_bucket(
                _bucket(dlp, i.v, i.m, n_groups, V)))) if overlap else None
            _walk_stream(tp, run, instr.streams[rank], like, on_ar)
        if D > 1 and not overlap:       # end (and 2bw): after the walk
            posted += [tp.reduce_bucket(_bucket(dlp, v, 0, 1, V))
                       for v in range(V)]
        grads = dict(layers=dlp)
        if first:
            grads["embed"] = run.embed_grad()
        if last:
            grads["final_norm"] = run.dfn
            if not tied:
                grads["head"] = run.dhd
            elif first:
                grads["embed"] = grads["embed"] + run.dhd
        # this rank's leaves outside the layers; a tied embedding's share
        # on the last rank is its head gradient
        rest = {k: g for k, g in grads.items() if k != "layers"}
        if tied and last and not first:
            rest["embed"] = run.dhd
        if D > 1:           # every leaf sums over data, the rest last
            leaves = [rest[k] for k in sorted(rest)
                      if "data" in ST.grad_sync_axes(k)]
            if leaves:
                posted.append(tp.reduce_bucket(leaves))
            for r in posted:
                r.wait()
        if axis is not None:    # the leaves each shard saw a part of
            for path, g in zip(ST.leaf_paths(dlp), ST.tree_leaves(dlp)):
                if "tensor" in ST.grad_sync_axes(("layers",) + path, cfg,
                                                 plan.tensor):
                    tp.all_reduce(g, grid.tensor_group, kind="tensor")
        if tie_group is not None and (first or last):
            # d_embed + dhd on both ranks (two operands: the sum commutes)
            grads["embed"] = tp.all_reduce(rest["embed"], tie_group)
        ce = (run.ce / (M_ * D) if last
              else torch.zeros((), dtype=torch.float32, device=call.dev))
        if D > 1 and last:      # the replicas' terms of the batch mean
            ce = tp.all_reduce(ce, data_group, kind="scalars")
        step.stash_slots = len(run.written)
        step.live_registers = run.peak_live
        return tp.broadcast(ce, S - 1), grads

    if optimizer is None:
        def step(params: dict, batch: dict):
            tp.reset()
            return rank_loss_and_grads(params, batch)
    else:
        inner = _with_update(rank_loss_and_grads, optimizer, two_bw,
                             lambda g: _rank_norm(tp, g, S, rank, not tied,
                                                  cfg, plan.tensor))

        def step(params: dict, opt_state: dict, batch: dict):
            tp.reset()
            return inner(params, opt_state, batch)
    step.lowering, step.instructions = lo, instr
    step.stash_slots = step.live_registers = None
    step.transport = tp
    return step
