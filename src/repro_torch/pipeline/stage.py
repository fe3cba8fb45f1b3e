"""Stage partitioning: ArchConfig -> stacked per-stage parameters and
their tensor-parallel shares (the port's copy of
``repro/pipeline/stage.py``).

The BaPipe partitioner decides which contiguous layers each stage owns;
stages are homogeneous, so layers are stacked to ``[S, Lps, ...]``
(Lps = ceil(L/S)), or ``[S, V, Lc, ...]`` for an interleaved plan of V
chunks per stage, with an ``active`` mask for the padded slots (inactive
slots pass activations through unchanged).

At tensor degree T each leaf is sharded over the tensor axis as the JAX
package's ``param_specs`` says (:func:`tensor_dim`): the column-parallel
projections on their last dim, the row-parallel ones on their
next-to-last, the embedding and head on their vocab rows
(``padded_vocab(T)`` of them), the rest replicated;
:func:`tensor_share` cuts a rank's share and :func:`tensor_gather` puts
the shares back together.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import sliced_kv_heads
from repro_torch.models import model as M

# parameter-name classes for the tensor sharding rules (the JAX package's)
_TP_LAST = {"wq", "wk", "wv", "w1", "w3"}       # output dim sharded
_TP_PENULT = {"wo", "w2"}                       # input dim sharded


@dataclasses.dataclass(frozen=True)
class StagePlan:
    n_stages: int
    tensor: int
    layers_per_stage: int        # layers per CHUNK (a device owns `virtual`)
    n_layers_padded: int
    virtual: int = 1             # 1F1B-I interleave depth V (chunks/device)


def plan_stages(cfg: ArchConfig, n_stages: Optional[int] = None,
                tensor: Optional[int] = None,
                virtual: Optional[int] = None) -> StagePlan:
    S = n_stages or cfg.stages
    tp = tensor or cfg.tensor
    V = virtual or cfg.virtual
    lps = math.ceil(cfg.n_layers / (S * V))
    return StagePlan(n_stages=S, tensor=tp, layers_per_stage=lps,
                     n_layers_padded=S * V * lps, virtual=V)


def _stack_chunks(a, plan: StagePlan):
    """[Lp, ...] -> [S, Lps, ...] (V == 1) or [S, V, Lc, ...] (V > 1),
    where element [n, v] is virtual stage v*S + n (the Megatron
    assignment of the JAX package: a micro-batch's pass v visits stages
    0..S-1 applying chunks v*S .. v*S + S - 1).  Works on tensors and
    numpy arrays; the V > 1 layout is a contiguous copy, since the
    optimizer updates the stacked leaves in place."""
    S, V, Lc = plan.n_stages, plan.virtual, plan.layers_per_stage
    if V == 1:
        return a.reshape((S, Lc) + tuple(a.shape[1:]))
    out = a.reshape((V, S, Lc) + tuple(a.shape[1:])).swapaxes(0, 1)
    return out.contiguous() if isinstance(out, torch.Tensor) else out.copy()


def unstack_chunks(a, plan: StagePlan):
    """Inverse of ``_stack_chunks``: recover the global [L, ...] order."""
    if plan.virtual == 1:
        return a.reshape((-1,) + tuple(a.shape[2:]))
    return a.swapaxes(0, 1).reshape((-1,) + tuple(a.shape[3:]))


def _slot_of_layer(plan: StagePlan) -> list:
    """``out[i]``: the global layer held by flat slot i of a leaf whose
    stacked leading axes ([S, Lps] or [S, V, Lc]) are merged into one."""
    S, V, Lc = plan.n_stages, plan.virtual, plan.layers_per_stage
    return [(v * S + s) * Lc + j
            for s in range(S) for v in range(V) for j in range(Lc)]


def restack_layers(a, plan_from: StagePlan, plan_to: StagePlan,
                   n_layers: int):
    """Re-fold a layer-stacked leaf from one plan's chunk layout to
    another's (e.g. the interleaved-prefill [S, V, Lc, ...] cache into the
    contiguous [S, Lps, ...] decode layout): the global layer order is
    kept, trimmed to the ``n_layers`` real layers and re-padded by
    repeating the last real layer (padded slots are inactive), as the JAX
    package's unstack / trim / pad / restack does.  One gather: the result
    is the one new array the call allocates.  Works on tensors and numpy
    arrays."""
    lead = 2 if plan_from.virtual == 1 else 3
    held = {g: f for f, g in enumerate(_slot_of_layer(plan_from))}
    idx = [held[min(g, n_layers - 1)] for g in _slot_of_layer(plan_to)]
    flat = a.reshape((-1,) + tuple(a.shape[lead:]))
    if isinstance(a, torch.Tensor):
        out = flat[torch.tensor(idx, device=a.device)]
    else:
        out = flat[idx]
    S, V, Lc = plan_to.n_stages, plan_to.virtual, plan_to.layers_per_stage
    return out.reshape(((S, Lc) if V == 1 else (S, V, Lc))
                       + tuple(a.shape[lead:]))


def restack_params(params: dict, plan_from: StagePlan, plan_to: StagePlan,
                   n_layers: int) -> dict:
    """Re-stack the ``layers`` subtree of a stacked parameter tree from
    one stage plan to another (embed/head/final_norm pass through)."""
    return dict(params, layers=_map_layers(
        lambda a: restack_layers(a, plan_from, plan_to, n_layers),
        params["layers"]))


def restack_tree_(tree: dict, plan_from: StagePlan, plan_to: StagePlan,
                  n_layers: int) -> dict:
    """:func:`restack_layers` on every leaf of ``tree`` (a ``layers``
    subtree or a pipeline cache), in place and leaf by leaf
    (:func:`_map_layers_`): the handoff never holds more than one leaf
    twice (the JAX serve CLI donates its buffers instead)."""
    return _map_layers_(
        lambda a: restack_layers(a, plan_from, plan_to, n_layers), tree)


def handoff_routes(plan_from: StagePlan, plan_to: StagePlan,
                   n_layers: int) -> list:
    """Where :func:`restack_layers` takes each slot of the new layout
    from, by rank: ``(layer, src, src_row, dst, dst_row)`` for every
    slot of ``plan_to`` (``dst`` its stage, ``dst_row`` its index in the
    stage's flattened ``[V * Lc]`` rows), ``layer`` the global layer it
    holds (a padded slot repeats layer ``n_layers - 1``), ``src`` and
    ``src_row`` the stage and row of ``plan_from`` that hold that
    layer."""
    held = {g: f for f, g in enumerate(_slot_of_layer(plan_from))}
    n_from = plan_from.virtual * plan_from.layers_per_stage
    n_to = plan_to.virtual * plan_to.layers_per_stage
    out = []
    for f, g in enumerate(_slot_of_layer(plan_to)):
        g = min(g, n_layers - 1)
        src, src_row = divmod(held[g], n_from)
        out.append((g, src, src_row, *divmod(f, n_to)))
    return out


def restack_share_(share: dict, plan_from: StagePlan, plan_to: StagePlan,
                   n_layers: int, stage: int, transport) -> dict:
    """:func:`restack_tree_` on one rank's share (a ``layers`` subtree or
    a stage cache, ``[Lps, ...]`` or ``[V, Lc, ...]`` leaves): stage
    ``stage`` of ``plan_from`` becomes stage ``stage`` of ``plan_to``,
    in place and leaf by leaf.  The layers another rank holds in the new
    layout are sent to it and the ones this rank lacks received, one
    ``batch_isend_irecv`` a leaf over ``transport`` (a
    :class:`repro_torch.pipeline.comm.Transport` of the stage group,
    counted as ``handoff``); the trim and the re-pad are
    :func:`handoff_routes`'.  Each old leaf is dropped as its new one is
    made, so a rank never holds more than its share and one leaf's new
    share.  Afterwards the share equals row ``stage`` of the stacked
    tree's re-fold bit for bit."""
    routes = handoff_routes(plan_from, plan_to, n_layers)
    n_from = plan_from.virtual * plan_from.layers_per_stage
    n_to = plan_to.virtual * plan_to.layers_per_stage
    lead = 1 if plan_from.virtual == 1 else 2

    def fold(a):
        tail = tuple(a.shape[lead:])
        old = a.reshape((n_from,) + tail)
        new = old.new_empty((n_to,) + tail)
        sends, recvs = [], []
        for _, src, src_row, dst, dst_row in routes:
            if src == stage and dst == stage:
                new[dst_row].copy_(old[src_row])
            elif src == stage:      # the tag: the receiver's row
                sends.append((dst_row, dst, old[src_row]))
            elif dst == stage:
                recvs.append((dst_row, src, new[dst_row]))
        transport.exchange_into(sends, recvs, "handoff", a.device)
        return _stage_rows(new, plan_to)

    return _map_layers_(fold, share)


def _map_layers(fn, tree: dict) -> dict:
    return {k: _map_layers(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _map_layers_(fn, tree: dict) -> dict:
    """``fn`` on every leaf of ``tree``, IN PLACE: each old leaf is
    dropped as its new one is made, so no more than one leaf is ever held
    twice.  The caller must hold no other reference to the leaves."""
    for k, a in tree.items():
        tree[k] = _map_layers_(fn, a) if isinstance(a, dict) else fn(a)
    return tree


def tree_leaves(tree) -> list:
    """The leaves of a nested dict in sorted-key order (the order
    ``jax.tree.leaves`` gives), so two trees with the same keys pair up."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def init_stacked_params(cfg: ArchConfig, seed: int, plan: StagePlan, *,
                        dtype=torch.float32, device="cuda") -> dict:
    """Parameters with layers stacked [S, Lps, ...] or [S, V, Lc, ...]
    (padded slots get real weights and are skipped by the ``active``
    mask); the global layers are drawn in the same order for any V.  The
    embedding (and untied head) has ``cfg.padded_vocab(plan.tensor)``
    rows: the ``padded_vocab(1)`` rows drawn at tensor 1, then zero rows
    (at tensor T the same model as at tensor 1: pad rows are never
    looked up and their logits are masked).  Weights come from a
    ``torch.Generator`` on ``device`` seeded with ``seed``."""
    M.check_ported(cfg)
    vocab = cfg.padded_vocab(1)
    gen = torch.Generator(device=device).manual_seed(seed)
    embed = _pad_vocab(torch.randn(
        (vocab, cfg.d_model), generator=gen, dtype=dtype, device=device)
        / math.sqrt(cfg.d_model), cfg, plan.tensor)
    blocks = [M.init_block(cfg, gen, dtype, device)
              for _ in range(plan.n_layers_padded)]
    layers = M.stack_layers(blocks)
    del blocks
    # at V > 1 each leaf is re-laid out by a copy: one leaf at a time
    p = dict(embed=embed,
             layers=_map_layers_(lambda a: _stack_chunks(a, plan), layers),
             final_norm=torch.zeros((cfg.d_model,), dtype=dtype,
                                    device=device))
    if not cfg.tie_embeddings:
        p["head"] = _pad_vocab(torch.randn(
            (vocab, cfg.d_model), generator=gen, dtype=dtype, device=device)
            / math.sqrt(cfg.d_model), cfg, plan.tensor)
    return p


def _pad_vocab(table: torch.Tensor, cfg: ArchConfig,
               tensor: int) -> torch.Tensor:
    """``table`` ([padded_vocab(1), d]) with zero rows added up to
    ``padded_vocab(tensor)``."""
    extra = cfg.padded_vocab(tensor) - table.shape[0]
    if extra <= 0:
        return table
    return torch.cat([table, table.new_zeros((extra,) + table.shape[1:])])


def _stage_rows(a, plan: StagePlan):
    """[V * Lc, ...] -> [Lps, ...] (V == 1) or [V, Lc, ...]."""
    if plan.virtual == 1:
        return a
    return a.reshape((plan.virtual, plan.layers_per_stage)
                     + tuple(a.shape[1:]))


def init_stage_params(cfg: ArchConfig, seed: int, plan: StagePlan,
                      stage: int, *, tensor_rank: int = 0,
                      dtype=torch.float32, device="cuda") -> dict:
    """Stage ``stage``'s share of :func:`init_stacked_params`, drawn in
    the same order from one generator (the embedding, the padded layers
    one block at a time, the untied head), so every leaf equals row
    ``stage`` of the stacked tree bit for bit.  Only this stage's blocks
    are kept: layers ``[Lps, ...]`` or ``[V, Lc, ...]`` with no stage
    axis.  Stage 0 keeps ``embed``; the last stage keeps ``final_norm``
    and ``head`` or, with tied embeddings, its own copy of ``embed``.  A
    stage that keeps no table still draws the embedding (the draw
    advances the generator) and drops it, so its peak is the larger of
    that table and one block, not the model.  At ``plan.tensor`` T > 1
    the share is tensor shard ``tensor_rank``'s (:func:`tensor_share`)
    of the same draws, each block cut as it is drawn."""
    M.check_ported(cfg)
    S, T = plan.n_stages, plan.tensor
    if not 0 <= stage < S:
        raise ValueError(f"stage {stage} of a {S}-stage plan")
    if not 0 <= tensor_rank < T:
        raise ValueError(f"tensor rank {tensor_rank} of tensor {T}")
    first, last = stage == 0, stage == S - 1
    cut = lambda tree, top: tensor_share({top: tree}, cfg, plan,
                                         tensor_rank)[top]
    vocab = cfg.padded_vocab(1)
    gen = torch.Generator(device=device).manual_seed(seed)
    embed = torch.randn((vocab, cfg.d_model), generator=gen, dtype=dtype,
                        device=device) / math.sqrt(cfg.d_model)
    keep_embed = first or (last and cfg.tie_embeddings)
    embed = cut(embed, "embed") if keep_embed else None
    n = plan.virtual * plan.layers_per_stage
    mine = _slot_of_layer(plan)[stage * n:(stage + 1) * n]  # in row order
    blocks = {}
    for i in range(plan.n_layers_padded):   # every block, in order
        b = M.init_block(cfg, gen, dtype, device)
        if i in mine:
            blocks[i] = cut(b, "layers")
    layers = M.stack_layers([blocks[i] for i in mine])
    del blocks, b
    p = dict(layers=_map_layers_(lambda a: _stage_rows(a, plan), layers))
    if keep_embed:
        p["embed"] = embed
    if last:
        p["final_norm"] = torch.zeros((cfg.d_model,), dtype=dtype,
                                      device=device)
    if not cfg.tie_embeddings:
        head = torch.randn((vocab, cfg.d_model), generator=gen, dtype=dtype,
                           device=device) / math.sqrt(cfg.d_model)
        if last:
            p["head"] = cut(head, "head")
    return p


def kv_replicated(cfg: ArchConfig, tensor: int) -> bool:
    """The k/v projections are replicated over the tensor axis (each
    shard slices the kv heads its query heads read) when the kv heads do
    not split over it, as in the JAX package's ``param_specs``."""
    return cfg.attn_kind == "gqa" and cfg.n_kv_heads % tensor != 0


def kv_heads(cfg: ArchConfig, tensor: int) -> int:
    """The kv heads one tensor shard's k/v projections (and cache) give:
    its share of them, or, when :func:`kv_replicated`, the ones its
    query heads read (the JAX package's ``_slice_kv_heads`` and its
    cache's one kv slot a shard: the duplication of serving few-kv-head
    models under tensor parallelism).  The SSM family has none to split:
    ``max(1, n_kv_heads)``, as ``model.init_cache`` reads it."""
    nkv = max(1, cfg.n_kv_heads)
    if cfg.family == "ssm":
        return nkv
    if not kv_replicated(cfg, tensor):
        return nkv // tensor
    return sliced_kv_heads(cfg, cfg.n_heads // tensor)


def tensor_dim(path: tuple, cfg: ArchConfig, tensor: int):
    """The dim (counted from the end: -1 or -2) that the tensor axis
    shards of the leaf at ``path`` (its keys from the top of the
    parameter tree), or None for a replicated leaf: the JAX package's
    ``param_specs`` in the port's terms (``embed``/``head`` on their
    vocab rows; ``wq``, ``wk``, ``wv``, ``w1``, ``w3`` on their last
    dim; ``wo``, ``w2`` on their next-to-last; ``wk``/``wv`` replicated
    when :func:`kv_replicated`; the norms, ``final_norm`` and the SSM
    block replicated)."""
    top, name = path[0], path[-1]
    if top in ("embed", "head"):
        return -2
    if top != "layers":
        return None
    if name in ("wk", "wv") and kv_replicated(cfg, tensor):
        return None
    if name in _TP_LAST:
        return -1
    if name in _TP_PENULT:
        return -2
    return None


def _map_paths(fn, tree: dict, path: tuple = ()) -> dict:
    return {k: _map_paths(fn, v, path + (k,)) if isinstance(v, dict)
            else fn(path + (k,), v) for k, v in tree.items()}


def tensor_share(tree: dict, cfg: ArchConfig, plan: StagePlan,
                 t: int) -> dict:
    """Tensor shard ``t``'s share of a parameter-shaped tree (parameters,
    gradients, moments; any leading stack axes; tops ``embed``,
    ``head``, ``final_norm``, ``layers``): chunk ``t`` of ``plan.tensor``
    along each leaf's :func:`tensor_dim` (a contiguous copy), a
    replicated leaf as it is.  An ``embed``/``head`` table with fewer
    rows than ``padded_vocab(plan.tensor)`` (a tensor-1 tree) is first
    padded with zero rows up to it."""
    T = plan.tensor

    def cut(path, a):
        dim = tensor_dim(path, cfg, T)
        if dim is None or T == 1:
            return a
        if path[0] in ("embed", "head"):
            a = _pad_vocab(a, cfg, T)
        return a.chunk(T, dim=dim)[t].contiguous()

    return _map_paths(cut, tree)


def tensor_gather(shares: list, cfg: ArchConfig, plan: StagePlan) -> dict:
    """The inverse of :func:`tensor_share`: the shards' shares (in shard
    order) put back into one tree, each sharded leaf concatenated along
    its :func:`tensor_dim`, a replicated one taken from shard 0 (the
    embedding and head keep ``padded_vocab(plan.tensor)`` rows)."""
    def join(path, a):
        dim = tensor_dim(path, cfg, plan.tensor)
        if dim is None or plan.tensor == 1:
            return a
        parts = [_leaf_at(s, path) for s in shares]
        return torch.cat(parts, dim=dim)

    return _map_paths(join, shares[0])


def _leaf_at(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def leaf_paths(tree) -> list:
    """The paths of a nested dict's leaves, in :func:`tree_leaves`
    order."""
    if not isinstance(tree, dict):
        return [()]
    return [(k,) + p for k in sorted(tree) for p in leaf_paths(tree[k])]


def stage_share(tree: dict, plan: StagePlan, stage: int) -> dict:
    """Stage ``stage``'s share of a stacked tree (parameters, gradients,
    optimizer moments): row ``stage`` of every ``layers`` leaf (a view),
    ``embed`` on the first stage and, tied, on the last, ``final_norm``
    and ``head`` on the last; the shares :func:`init_stage_params`
    makes."""
    S = plan.n_stages
    first, last = stage == 0, stage == S - 1
    out = dict(layers=_map_layers(lambda a: a[stage], tree["layers"]))
    if first or (last and "head" not in tree):
        out["embed"] = tree["embed"]
    if last:
        out["final_norm"] = tree["final_norm"]
        if "head" in tree:
            out["head"] = tree["head"]
    return out


def grad_sync_axes(path, cfg: Optional[ArchConfig] = None,
                   tensor: int = 1) -> tuple:
    """The grid axes the gradient of the leaf at ``path`` (its keys from
    the top of the tree, or the top-level key alone) is summed over (the
    JAX package's ``grad_sync_axes``, without fsdp).  A ``layers`` leaf
    is held by one stage of every replica: it sums over ``data``.
    ``embed``, ``head`` and ``final_norm`` sum over ``data`` and
    ``stage``; over the stage axis the sum runs over the stages that hold
    the leaf, which is two only for a tied embedding (the first stage's
    and the last's).  The data sum comes first, as in the JAX runtime;
    once it is done the replicas hold the same gradients, so the clip
    norm's terms are gathered over one replica's stages only.

    At tensor T > 1 a replicated ``layers`` leaf whose gradient differs
    by shard also sums over ``tensor``: ``q_norm``/``k_norm`` (each shard
    normalises only its own heads) and ``wk``/``wv`` when
    :func:`kv_replicated` (each shard slices the kv heads it reads).
    Every other replicated leaf (the block norms, ``final_norm``, the
    SSM block) sees the whole activation, whose gradient the Megatron
    operators (``comm.TensorAxis.copy_to_tensor``) already sum over the
    shards, so each shard holds its whole gradient; the JAX runtime
    instead seeds
    the backward with ``1/T`` and sums every replicated leaf over
    ``tensor``, which gives the same gradients."""
    path = (path,) if isinstance(path, str) else tuple(path)
    if path[0] != "layers":
        return ("data", "stage")
    name = path[-1]
    if tensor > 1 and (name in ("q_norm", "k_norm") or (
            name in ("wk", "wv") and kv_replicated(cfg, tensor))):
        return ("data", "tensor")
    return ("data",)


def stacked_meta(cfg: ArchConfig, plan: StagePlan) -> list:
    """Per-slot layer metadata: ``meta[s][j]`` (V == 1) or
    ``meta[s][v][j]`` (V > 1) is the dict of layer scalars
    (``rope_theta``, ...) of that slot, plus ``active`` (False for padded
    slots).  Slots are numbered as :func:`_stack_chunks` stacks layers."""
    meta = M.layer_meta(cfg)
    S, V, Lc = plan.n_stages, plan.virtual, plan.layers_per_stage

    def slot(i: int) -> dict:
        src = min(i, cfg.n_layers - 1)         # pads repeat the last layer
        ml = {k: v[src] for k, v in meta.items()}
        ml["active"] = i < cfg.n_layers
        return ml

    if V == 1:
        return [[slot(s * Lc + j) for j in range(Lc)] for s in range(S)]
    return [[[slot((v * S + s) * Lc + j) for j in range(Lc)]
             for v in range(V)] for s in range(S)]
