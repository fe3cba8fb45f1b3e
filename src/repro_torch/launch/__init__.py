"""Command-line entry points (python -m repro_torch.launch.serve,
python -m repro_torch.launch.train) and the process grid
(:mod:`repro_torch.launch.mesh`): every stage in one process on one
card, or, under ``torchrun``, one process per tensor shard of each stage
of each replica, for serving and for training alike."""
from __future__ import annotations

import dataclasses

PAR_ITEM = "ROADMAP 'Still to port': tensor and data parallel over NCCL"


def with_tensor(cfg, tensor: int):
    """``cfg`` at the CLI's ``--tensor`` degree (0 keeps the config's
    own, as the JAX CLI does: llama3.2-1b's is 2, gemma3-1b's and
    qwen3-1.7b's 4).  A degree above 1 runs only as ranks; the CLIs
    refuse it in one process before anything is allocated.  A degree
    that does not divide the attention heads (hymba-1.5b's 25 split
    only over 1, 5 or 25) raises here, before any process group is set
    up: each shard holds ``n_heads / T`` whole heads."""
    if tensor < 0:
        raise ValueError(f"--tensor {tensor}: expected 0 (the config's) "
                         f"or a degree >= 1")
    t = tensor or cfg.tensor
    if cfg.attn_kind != "none" and cfg.n_heads % t:
        raise ValueError(
            f"--tensor {t}: {cfg.arch_id}'s {cfg.n_heads} attention heads "
            f"do not split over {t} shards; pick a degree that divides "
            f"{cfg.n_heads}")
    return dataclasses.replace(cfg, tensor=t)
