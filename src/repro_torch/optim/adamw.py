"""AdamW, its learning-rate schedule and global-norm clipping (the port's
copy of ``repro/optim/adamw.py``).

Parameters, gradients and the optimizer state are nested dicts of tensors
with the same keys.  Leaves are visited in sorted-key order
(:func:`repro_torch.pipeline.stage.tree_leaves`, the order
``jax.tree.leaves`` gives), so sums over leaves (the global norm) add in
the JAX package's order.  :meth:`AdamW.update` updates the parameters and the
moments IN PLACE under ``torch.no_grad()`` (the JAX update returns new
trees), with the JAX ``upd``'s arithmetic in the same order; the step
counter and the learning rate stay on the parameters' device, so a step
needs no host sync.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from repro_torch.pipeline.stage import tree_leaves as _leaves


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def warmup_cosine(peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> Callable:
    """Linear warm-up to ``peak_lr`` over ``warmup`` steps, then a cosine
    decay to ``floor * peak_lr`` at ``total``; f32 arithmetic on the step
    tensor's device."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = peak_lr * step / max(1, warmup)
        frac = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr


def sum_squares(x: torch.Tensor) -> torch.Tensor:
    """The f32 sum of squares of one leaf (or one stage's row of one)."""
    return torch.sum(torch.square(x.float()))


def norm_terms(tree) -> list:
    """Each leaf's terms of the squared global norm, in ``tree_leaves``
    order: a leaf of the top-level ``layers`` subtree is stacked by stage
    (``[S, ...]``) and gives one term a stage, its rows' sums of squares;
    any other leaf gives one.  A pipeline rank holds one row of each
    stacked leaf, so the ranks' gathered terms are these very tensors'
    values (:func:`repro_torch.pipeline.runtime.make_train_step`)."""
    if not isinstance(tree, dict):
        return [[sum_squares(tree)]]
    out = []
    for k in sorted(tree):
        if k == "layers":
            out += [[sum_squares(row) for row in x.unbind(0)]
                    for x in _leaves(tree[k])]
        else:
            out += [[sum_squares(x)] for x in _leaves(tree[k])]
    return out


def add_terms(terms: list) -> torch.Tensor:
    """The squared norm from :func:`norm_terms`: each leaf's terms added
    in stage order, then the leaves in tree order (one f32 addition
    order, whichever process holds the terms)."""
    total = None
    for parts in terms:
        term = parts[0]
        for p in parts[1:]:
            term = term + p
        total = term if total is None else total + term
    return total


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of the f32 sum of squares (a stacked
    ``layers`` leaf's as the sum of its stages', :func:`norm_terms`)."""
    return torch.sqrt(add_terms(norm_terms(tree)))


def _clip_scale(grads, max_norm: float, norm=None):
    n = global_norm(grads) if norm is None else norm
    return torch.clamp(max_norm / (n + 1e-9), max=1.0), n


def clip_by_global_norm(grads, max_norm: float):
    """``grads`` scaled by min(1, max_norm / (norm + 1e-9)); a new tree,
    and the norm."""
    scale, n = _clip_scale(grads, max_norm)
    return _map(lambda g: (g * scale).to(g.dtype), grads), n


#: elements of one piece of a leaf in :meth:`AdamW.update`
PIECE = 1 << 26


def _pieces(leaves):
    """Each (param, grad, m, v) of ``leaves``, a leaf above PIECE elements
    cut into flat views of PIECE elements: the update is elementwise, so
    the pieces give the whole leaf's bits while its temporaries stay a
    piece in size (mamba2-2.7b's stacked in_proj is 1.7e9 elements)."""
    for quad in leaves:
        if quad[0].numel() <= PIECE or not all(t.is_contiguous()
                                               for t in quad):
            yield quad
        else:
            yield from zip(*(t.view(-1).split(PIECE) for t in quad))


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: Optional[float] = 1.0

    def init(self, params) -> dict:
        """f32 moments ``m``/``v`` shaped like ``params`` and an int32
        ``step`` on their device."""
        zeros = lambda p: _map(
            lambda x: torch.zeros_like(x, dtype=torch.float32), p)
        dev = _leaves(params)[0].device
        return dict(m=zeros(params), v=zeros(params),
                    step=torch.zeros((), dtype=torch.int32, device=dev))

    @torch.no_grad()
    def update(self, params, grads, state, *, norm=None):
        """One step: clip, then decoupled-decay Adam on every leaf.  Writes
        ``params``, ``state["m"]`` and ``state["v"]`` in place and returns
        (params, new state).  The clipped gradient is formed one leaf at a
        time (as :func:`clip_by_global_norm` forms it), not as a second
        tree.  ``norm`` is the gradients' global norm where ``grads`` is
        one pipeline rank's share of them (the ranks form it together);
        by default it is ``global_norm(grads)``."""
        step = state["step"] + 1
        scale = (_clip_scale(grads, self.clip_norm, norm)[0]
                 if self.clip_norm else None)
        lr = self.lr(step) if callable(self.lr) else self.lr
        b1, b2 = self.b1, self.b2
        stepf = step.to(torch.float32)
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32,
                               device=step.device) ** stepf
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32,
                               device=step.device) ** stepf
        for p, g, m, v in _pieces(zip(_leaves(params), _leaves(grads),
                                      _leaves(state["m"]),
                                      _leaves(state["v"]))):
            if scale is not None:
                g = (g * scale).to(g.dtype)
            g32 = g.float()
            m.copy_(b1 * m + (1 - b1) * g32)
            v.copy_(b2 * v + (1 - b2) * torch.square(g32))
            mh = m / bc1
            vh = v / bc2
            p32 = p.float()
            delta = mh / (torch.sqrt(vh) + self.eps) + self.weight_decay * p32
            p.copy_((p32 - lr * delta).to(p.dtype))
        return params, dict(m=state["m"], v=state["v"], step=step)
