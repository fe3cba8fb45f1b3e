"""Plan-to-plan checkpoint resharding, the elastic loop's relayout step
(the port's copy of ``repro/checkpoint/reshard.py``).

A training job saves ``{params, opt}`` and its step with every
layer-stacked leaf in the layout of its
:class:`~repro_torch.pipeline.stage.StagePlan`: ``[S, Lps, ...]`` for a
contiguous plan, ``[S, V, Lc, ...]`` for an interleaved one.  When the
fleet shrinks, grows or re-skews, the next run of the job uses another
``(S, V)`` layout: this module moves a saved checkpoint between any two
such layouts, so that the job resumes with the real layers' weights and
optimizer moments bit for bit.

Every leaf under a ``layers`` subtree (the parameters, both AdamW
moments and 2bw's ``pending``, which mirror the parameters) is re-folded
by :func:`repro_torch.pipeline.stage.restack_layers`: the global layer
order kept, trimmed to the real layers and re-padded by repeating the
last one (padded slots are inactive).  Every other leaf (embed, head,
final_norm, the step counters) passes through untouched, so the two
layouts must agree outside the stage stacking, the tensor degree (its
vocab padding) included.

- :func:`reshard_tree`: a tree of tensors or numpy arrays in memory.
- :func:`reshard_checkpoint`: file to file on the host, one leaf at a
  time, with no device: the checkpoint of a job that lost ranks is
  re-laid out for the survivors before the relaunch.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np

from repro_torch.checkpoint.ckpt import (CheckpointMismatch,
                                         CheckpointReader, CheckpointWriter)
from repro_torch.pipeline.stage import StagePlan, restack_layers


def layout_dict(plan: StagePlan, n_layers: int) -> dict:
    """The layout stored in a checkpoint's ``extra["layout"]``, so that a
    resume can tell a layout change."""
    return dict(stages=plan.n_stages, tensor=plan.tensor,
                virtual=plan.virtual,
                layers_per_stage=plan.layers_per_stage,
                n_layers_padded=plan.n_layers_padded,
                n_layers=int(n_layers))


def plan_from_layout(layout: dict) -> StagePlan:
    return StagePlan(n_stages=layout["stages"], tensor=layout["tensor"],
                     layers_per_stage=layout["layers_per_stage"],
                     n_layers_padded=layout["n_layers_padded"],
                     virtual=layout.get("virtual", 1))


def _lead_shape(plan: StagePlan) -> tuple:
    if plan.virtual == 1:
        return (plan.n_stages, plan.layers_per_stage)
    return (plan.n_stages, plan.virtual, plan.layers_per_stage)


def _is_layer_path(names) -> bool:
    """A leaf under a ``layers`` subtree (the stacked layers' parameters
    and their mirrors in the optimizer state)."""
    return "layers" in names[:-1]


def _check_lead(name: str, shape, plan: StagePlan) -> None:
    lead = _lead_shape(plan)
    if tuple(shape[:len(lead)]) != lead:
        raise CheckpointMismatch(
            f"layer leaf {name!r} has shape {tuple(shape)}, which does not "
            f"carry the source plan's stacking {lead} "
            f"(S={plan.n_stages}, V={plan.virtual}, "
            f"Lc={plan.layers_per_stage})")


def _check_fits(plan_to: StagePlan, n_layers: int) -> None:
    if n_layers > plan_to.n_layers_padded:
        raise CheckpointMismatch(
            f"target plan holds {plan_to.n_layers_padded} padded layers "
            f"< {n_layers} real layers")


def reshard_tree(tree: Any, plan_from: StagePlan, plan_to: StagePlan,
                 n_layers: int) -> Any:
    """Every layer-stacked leaf of ``tree`` (a ``{params, opt}`` state or
    any subtree of one; tensors or numpy arrays) re-folded from
    ``plan_from``'s stacking to ``plan_to``'s; a new tree, the real
    layers' values bit for bit."""
    _check_fits(plan_to, n_layers)

    def walk(node, names):
        if isinstance(node, dict):
            return {k: walk(v, names + (k,)) for k, v in node.items()}
        if not _is_layer_path(names):
            return node
        _check_lead("/".join(names), node.shape, plan_from)
        return restack_layers(node, plan_from, plan_to, n_layers)

    return walk(tree, ())


def reshard_checkpoint(src: str, dst: str, plan_to: StagePlan,
                       plan_from: Optional[StagePlan] = None,
                       n_layers: Optional[int] = None) -> dict:
    """File to file: read the checkpoint at ``src`` one leaf at a time,
    re-fold every ``layers`` leaf from ``plan_from`` to ``plan_to`` and
    write it to ``dst`` before reading the next.  ``plan_from`` and
    ``n_layers`` default to the layout the source records
    (``extra["layout"]``).  Dtypes, the step and every other leaf are
    kept; the written meta records ``plan_to``'s layout, which is
    returned.  Runs on the host with no device."""
    with CheckpointReader(src) as ck:
        meta = ck.meta
        layout = (meta.get("extra") or {}).get("layout")
        if plan_from is None or n_layers is None:
            if layout is None:
                raise CheckpointMismatch(
                    f"checkpoint {src!r} records no layout in its meta; "
                    f"pass plan_from and n_layers explicitly")
            plan_from = plan_from or plan_from_layout(layout)
            if n_layers is None:
                n_layers = layout["n_layers"]
        if plan_from.tensor != plan_to.tensor:
            raise CheckpointMismatch(
                f"tensor degree change ({plan_from.tensor} -> "
                f"{plan_to.tensor}) would re-pad the vocab; reshard only "
                f"moves stage boundaries and virtual chunks")
        _check_fits(plan_to, n_layers)
        layers = [k for k in ck.keys if _is_layer_path(k.split("/"))]
        for key in layers:      # from the headers, before any write
            _check_lead(key, ck.shape(key), plan_from)
        writer = CheckpointWriter(dst)
        for key in ck.keys:
            a = ck.array(key)
            if key in layers:
                a = np.asarray(restack_layers(a, plan_from, plan_to,
                                              n_layers))
            writer.write(key, a)
    new_layout = layout_dict(plan_to, n_layers)
    meta = dict(meta)       # the source's, its dtypes (bfloat16) included
    meta["extra"] = dict(meta.get("extra") or {}, layout=new_layout)
    writer.close(meta=meta)
    return new_layout
