"""Llama-3.2-1B [hf:meta-llama/Llama-3.2-1B] — small llama3 dense GQA.

16L d_model=2048 32H (kv=8) d_ff=8192 vocab=128256.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="llama3.2-1b", family="dense", source="hf:meta-llama/Llama-3.2-1B",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, d_ff=8192,
    vocab=128256, head_dim=64,
    attn_kind="gqa",
    rope_theta=500_000.0,
    stages=8, tensor=2,    # 2 layers/stage
)
