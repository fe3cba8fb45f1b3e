"""Numpy bridge between the JAX package's parameter trees and the port's,
leaf by leaf.

Both packages keep the same tree: ``embed``, ``final_norm`` (and ``head``
when untied) and ``layers`` with leaves stacked ``[S, Lps, ...]`` (or
``[S, V, Lc, ...]`` for an interleaved plan of V chunks per stage: element
``[n, v]`` is virtual stage ``v*S + n`` in both) under the same names: ``ln1``, ``attn/{wq,wk,wv,wo}``, ``ln2``, ``mlp/{w1,w3,w2}``
for a dense block; ``ln1``, ``ssm/{in_proj,conv_w,conv_b,a_log,d_skip,
dt_bias,gate_norm,out_proj}`` for a Mamba-2 block.  The JAX side is given
as numpy arrays, e.g. ``jax.tree.map(np.asarray,
ST.init_stacked_params(...))``.  Every leaf keeps its own dtype: float32
as is (``a_log``, ``d_skip`` and ``dt_bias`` stay float32 inside a
bfloat16 tree), bfloat16 through ``ml_dtypes`` (imported only when a
bfloat16 tensor is exported).

The AdamW state crosses the same way: ``{"m": tree, "v": tree, "step":
int}`` in both packages (f32 moments shaped like the parameters; the step
an int32 scalar, a 0-d array or a Python int on the JAX side, a 0-d int32
tensor in the port), so one optimizer step can be compared.

A rank of the port's (data, stage, tensor) grid holds one share of such a
tree: :func:`to_rank_share` cuts it from the JAX side's stacked tree (its
stage's rows, then its tensor shard), and :func:`from_rank_shares` puts
the ranks' shares (gradients, say) back into the whole stacked tree, as
numpy, to compare with ``jax.grad``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.pipeline import stage as ST


def _to_torch(a, device) -> torch.Tensor:
    if isinstance(a, (int, np.integer)):    # the optimizer's step counter
        return torch.tensor(int(a), dtype=torch.int32, device=device)
    if a.dtype.name == "bfloat16":          # ml_dtypes.bfloat16, 2 bytes
        t = torch.from_numpy(np.array(a).view(np.int16))    # a copy
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def from_jax(tree, *, device="cuda"):
    """A (nested dict) tree of numpy arrays -> the same tree of tensors on
    ``device`` (the card unless the caller asks for the CPU)."""
    if isinstance(tree, dict):
        return {k: from_jax(v, device=device) for k, v in tree.items()}
    return _to_torch(tree, device)


def to_jax(tree):
    """The port's tree of tensors -> the same tree of numpy arrays (hand it
    to ``jax.numpy.asarray`` / ``jax.tree.map``)."""
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    return _to_numpy(tree)


def to_rank_share(tree, cfg, plan, stage: int, tensor_rank: int = 0, *,
                  device="cuda") -> dict:
    """The share of the rank running tensor shard ``tensor_rank`` of stage
    ``stage`` of ``plan``, from a JAX-side tree of numpy arrays stacked for
    ``plan`` (``[S, Lps, ...]`` or ``[S, V, Lc, ...]`` layers): the
    stage's rows (``stage.stage_share``), then the shard
    (``stage.tensor_share``: an embedding of ``padded_vocab(1)`` rows is
    padded with zero rows up to ``padded_vocab(plan.tensor)``), as
    tensors on ``device``."""
    share = ST.stage_share(from_jax(tree, device=device), plan, stage)
    return ST.tensor_share(share, cfg, plan, tensor_rank)


def from_rank_shares(shares: list, cfg, plan) -> dict:
    """The whole stacked tree, as numpy, from every rank's share of one
    replica: ``shares[s][t]`` is tensor shard t of stage s (parameters or
    gradients).  Each stage's shards are joined (``stage.
    tensor_gather``); the layers are stacked by stage; ``embed`` is stage
    0's, ``final_norm`` and ``head`` the last stage's (the embedding and
    head keep their ``padded_vocab(plan.tensor)`` rows)."""
    full = [ST.tensor_gather(list(row), cfg, plan) for row in shares]

    def stack(trees):
        return {k: stack([t[k] for t in trees])
                if isinstance(trees[0][k], dict)
                else torch.stack([t[k] for t in trees]) for k in trees[0]}

    out = dict(layers=stack([f["layers"] for f in full]),
               embed=full[0]["embed"], final_norm=full[-1]["final_norm"])
    if "head" in full[-1]:
        out["head"] = full[-1]["head"]
    return to_jax(out)
