"""Whisper-base [arXiv:2212.04356] — encoder-decoder audio backbone.

6L total (3 enc + 3 dec) d_model=512 8H d_ff=2048 vocab=51865.
The mel-spectrogram + conv frontend is a STUB: the caller provides
precomputed frame embeddings [B, S_frames, d].  rope_theta=0 selects
sinusoidal absolute positions (whisper uses absolute embeddings).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="whisper-base", family="audio", source="arXiv:2212.04356",
    n_layers=6, n_enc_layers=3, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51865, head_dim=64,
    attn_kind="gqa",
    rope_theta=0.0, act="gelu",
    frontend="audio", tie_embeddings=True,
    stages=2, tensor=8,
)
