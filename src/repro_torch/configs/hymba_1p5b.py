"""Hymba-1.5B [arXiv:2411.13676] — hybrid: parallel attention + mamba heads.

32L d_model=1600 25H (kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Sliding-window attention everywhere except three full-attention layers
(first, middle, last — per the paper).
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    arch_id="hymba-1.5b", family="hybrid", source="arXiv:2411.13676",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_ff=5504,
    vocab=32001, head_dim=64,
    attn_kind="gqa",
    window=1024, global_layers=(0, 15, 31),
    ssm=SSMConfig(d_state=16, head_dim=64, expand=2, d_conv=4, chunk=256),
    rope_theta=10_000.0,
    stages=16, tensor=1,
)
