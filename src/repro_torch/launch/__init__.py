"""Command-line entry points (python -m repro_torch.launch.serve,
python -m repro_torch.launch.train) and the stage process group
(:mod:`repro_torch.launch.mesh`): every stage in one process on one
card, or, under ``torchrun``, one process per stage, for serving and
for training alike."""
from __future__ import annotations

import dataclasses

PAR_ITEM = "ROADMAP 'Still to port': tensor and data parallel over NCCL"


def one_card(cfg, tensor: int):
    """``cfg`` with tensor = 1, the one degree the port runs.  ``tensor``
    is the CLI's ``--tensor`` (0 keeps the config's own).  A degree above
    1, from the flag or from the config (llama3.2-1b's is 2), raises
    NotImplementedError by the ROADMAP item's name, before anything is
    allocated."""
    degree = tensor or cfg.tensor
    if degree != 1:
        raise NotImplementedError(
            f"tensor={degree}: not ported yet ({PAR_ITEM}); the port runs "
            f"tensor = 1 (pass --tensor 1)")
    return dataclasses.replace(cfg, tensor=1)
