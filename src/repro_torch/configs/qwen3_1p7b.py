"""Qwen3-1.7B [hf:Qwen/Qwen3-8B family] — dense GQA with qk_norm.

28L d_model=2048 16H (kv=8) d_ff=6144 vocab=151936, head_dim=128.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen3-1.7b", family="dense", source="hf:Qwen/Qwen3-8B",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=6144,
    vocab=151936, head_dim=128,
    attn_kind="gqa", qk_norm=True,
    rope_theta=1_000_000.0,
    stages=4, tensor=4,    # 7 layers/stage
)
