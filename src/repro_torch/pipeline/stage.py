"""Stage partitioning: ArchConfig -> stacked per-stage parameters (the
port's copy of ``repro/pipeline/stage.py``, tensor parallel degree 1).

The BaPipe partitioner decides which contiguous layers each stage owns;
stages are homogeneous, so layers are stacked to ``[S, Lps, ...]``
(Lps = ceil(L/S)) with an ``active`` mask for the padded slots (inactive
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


def _check_contiguous(plan: StagePlan) -> None:
    if plan.virtual != 1:
        raise NotImplementedError("interleaved (V > 1) stage layouts are "
                                  "not ported yet")


def _stack_chunks(a, plan: StagePlan):
    """[Lp, ...] -> [S, Lps, ...]: stage s owns layers s*Lps .. s*Lps +
    Lps - 1.  Works on tensors and numpy arrays."""
    _check_contiguous(plan)
    return a.reshape((plan.n_stages, plan.layers_per_stage)
                     + tuple(a.shape[1:]))


def unstack_chunks(a, plan: StagePlan):
    """Inverse of ``_stack_chunks``: recover the global [L, ...] order."""
    _check_contiguous(plan)
    return a.reshape((-1,) + tuple(a.shape[2:]))


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
    """Parameters with layers stacked [S, Lps, ...] (padded slots get real
    weights and are skipped by the ``active`` mask).  Vocab is padded to
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
    """Per-stage, per-slot layer metadata: ``meta[s][j]`` is the dict of
    layer scalars (``rope_theta``, ...) of slot j on stage s, plus
    ``active`` (False for padded slots)."""
    _check_contiguous(plan)
    meta = M.layer_meta(cfg)
    Lps = plan.layers_per_stage
    out = []
    for s in range(plan.n_stages):
        row = []
        for j in range(Lps):
            i = s * Lps + j
            src = min(i, cfg.n_layers - 1)     # pads repeat the last layer
            ml = {k: v[src] for k, v in meta.items()}
            ml["active"] = i < cfg.n_layers
            row.append(ml)
        out.append(row)
    return out
