"""Deterministic synthetic LM data (the port's copy of
``repro/data/synthetic.py``).

Sequences follow a fixed random bigram chain over the vocabulary with
tunable noise, so a model that learns bigram statistics drives the loss
well below the unigram entropy.  Batches are a pure function of
(seed, step) and are made with numpy exactly as the JAX package makes
them, so both packages train on bit-identical tokens.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.1
    branch: int = 4          # successors per token in the bigram chain
    device: str = "cuda"     # where :meth:`batch` puts its tensors

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.table = rng.integers(0, self.vocab,
                                  size=(self.vocab, self.branch),
                                  dtype=np.int64)

    def batch(self, step: int) -> dict:
        """``tokens`` and ``labels`` [global_batch, seq_len], int32 tensors
        on ``device``; labels are the tokens shifted by one."""
        rng = np.random.default_rng((self.seed, step))
        B, T = self.global_batch, self.seq_len + 1
        toks = np.empty((B, T), np.int64)
        toks[:, 0] = rng.integers(0, self.vocab, size=B)
        branch = rng.integers(0, self.branch, size=(B, T))
        noise_mask = rng.random((B, T)) < self.noise
        noise_tok = rng.integers(0, self.vocab, size=(B, T))
        for t in range(1, T):
            nxt = self.table[toks[:, t - 1], branch[:, t]]
            toks[:, t] = np.where(noise_mask[:, t], noise_tok[:, t], nxt)
        as_t = lambda a: torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.int32)).to(self.device)
        return dict(tokens=as_t(toks[:, :-1]), labels=as_t(toks[:, 1:]))
