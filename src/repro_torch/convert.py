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
"""
from __future__ import annotations

import numpy as np
import torch


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
