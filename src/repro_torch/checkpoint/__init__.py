"""Checkpoints in the JAX package's format (npz + msgpack ``.meta``),
on one process or on ranks, and their reshard between stage layouts
(the port's ``repro/checkpoint``)."""
from repro_torch.checkpoint.ckpt import (CheckpointMismatch, checkpoint_meta,
                                         checkpoint_step, restore_checkpoint,
                                         save_checkpoint)
from repro_torch.checkpoint.reshard import (layout_dict, plan_from_layout,
                                            reshard_checkpoint, reshard_tree)
