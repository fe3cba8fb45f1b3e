"""Stage partitioning: ArchConfig -> stacked per-stage parameters (the
port's copy of ``repro/pipeline/stage.py``, tensor parallel degree 1).

The BaPipe partitioner decides which contiguous layers each stage owns;
stages are homogeneous, so layers are stacked to ``[S, Lps, ...]``
(Lps = ceil(L/S)), or ``[S, V, Lc, ...]`` for an interleaved plan of V
chunks per stage, with an ``active`` mask for the padded slots (inactive
slots pass activations through unchanged).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M


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


def _map_layers(fn, tree: dict) -> dict:
    return {k: _map_layers(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


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
    mask); the global layers are drawn in the same order for any V.  Vocab is padded to
    ``cfg.padded_vocab(plan.tensor)``.  Weights come from a
    ``torch.Generator`` on ``device`` seeded with ``seed``."""
    M.check_ported(cfg)
    vocab = cfg.padded_vocab(plan.tensor)
    gen = torch.Generator(device=device).manual_seed(seed)
    embed = torch.randn((vocab, cfg.d_model), generator=gen, dtype=dtype,
                        device=device) / math.sqrt(cfg.d_model)
    blocks = [M.init_block(cfg, gen, dtype, device)
              for _ in range(plan.n_layers_padded)]
    p = dict(embed=embed,
             layers=_map_layers(lambda a: _stack_chunks(a, plan),
                                M.stack_layers(blocks)),
             final_norm=torch.zeros((cfg.d_model,), dtype=dtype,
                                    device=device))
    if not cfg.tie_embeddings:
        p["head"] = torch.randn((vocab, cfg.d_model), generator=gen,
                                dtype=dtype, device=device) / math.sqrt(cfg.d_model)
    return p


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
