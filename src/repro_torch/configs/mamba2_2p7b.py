"""Mamba2-2.7B [arXiv:2405.21060] — pure SSM (SSD), attention-free.

64L d_model=2560, vocab=50280, ssm_state=128.  No attention, no FFN
(mamba2 blocks only, d_ff=0 per the assignment).
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    arch_id="mamba2-2.7b", family="ssm", source="arXiv:2405.21060",
    n_layers=64, d_model=2560, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab=50280,
    attn_kind="none",
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, d_conv=4, chunk=256),
    rope_theta=0.0, tie_embeddings=True,
    stages=16, tensor=1,
)
