"""Gemma3-1B [hf:google/gemma-3-1b-pt] — dense, 5:1 local:global, 128k rope.

26L d_model=1152 4H (kv=1) d_ff=6912 vocab=262144, head_dim=256,
sliding window 512 on local layers, every 6th layer global with
rope_theta 1M (local layers use 10k).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="gemma3-1b", family="dense", source="hf:google/gemma-3-1b-pt",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, d_ff=6912,
    vocab=262144, head_dim=256,
    attn_kind="gqa", qk_norm=True,
    window=512, global_every=6,
    rope_theta=10_000.0, rope_theta_global=1_000_000.0,
    act="gelu",
    stages=4, tensor=4,    # 7 layers/stage (2 pad); kv=1 replicated over tensor
)
