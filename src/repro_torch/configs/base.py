"""Architecture configuration schema (the port's copy of
``repro/configs/base.py``).

One ``ArchConfig`` fully describes a model family member: the transformer /
SSM backbone, attention flavour, FFN flavour, modality frontend stubs, and
the BaPipe pipeline defaults.  Every field is kept so a config reads the
same in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_routed: int
    n_shared: int
    top_k: int
    d_ff_expert: int
    first_k_dense: int = 0           # leading layers that stay dense
    router_aux_weight: float = 0.001
    capacity_factor: float = 1.25
    ep_data: bool = False            # shard experts over the data axis too


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int                 # 0 => direct q projection
    kv_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk: int = 256

    def n_heads(self, d_model: int) -> int:
        return self.expand * d_model // self.head_dim


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 => d_model // n_heads
    source: str = ""                 # citation

    # attention flavour -----------------------------------------------------
    attn_kind: str = "gqa"           # gqa | mla | none (pure ssm)
    mla: Optional[MLAConfig] = None
    qk_norm: bool = False
    # sliding-window pattern: window>0 and global_every=k => every k-th layer
    # (1-indexed) is global, the rest use a local window.
    window: int = 0
    global_every: int = 0
    global_layers: Optional[tuple[int, ...]] = None   # explicit global set
    rope_theta: float = 10_000.0
    rope_theta_global: float = 0.0   # gemma3: different theta on global layers
    mrope_sections: Optional[tuple[int, int, int]] = None  # qwen2-vl M-RoPE

    # FFN / MoE --------------------------------------------------------------
    moe: Optional[MoEConfig] = None
    act: str = "silu"

    # SSM / hybrid ------------------------------------------------------------
    ssm: Optional[SSMConfig] = None  # set for family in {ssm, hybrid}

    # encoder-decoder (audio) -------------------------------------------------
    n_enc_layers: int = 0            # >0 => enc-dec; n_layers counts TOTAL
    frontend: Optional[str] = None   # audio | vision (STUB embeddings)

    # extras -------------------------------------------------------------------
    mtp: bool = False                # deepseek-v3 multi-token prediction head
    tie_embeddings: bool = True
    norm_eps: float = 1e-6

    # BaPipe pipeline defaults (stage * tensor == mesh "model" axis size) ------
    stages: int = 16
    tensor: int = 1
    virtual: int = 1                 # 1F1B-I virtual stages (chunks) per device
    schedule: str = "auto"           # op order (schedplan name)
    mem_limit: int = 0               # zb-auto peak-live cap; 0 = unbounded
    runtime: str = "ticks"           # training executor: ticks | stream
    fsdp: bool = False               # shard stage weights over "data" axis too
    profile_w_frac: str = "analytic" # backward B/W split source: analytic |
                                     # measured

    # ----------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_dec_layers(self) -> int:
        return self.n_layers - self.n_enc_layers

    def is_global_layer(self, i: int) -> bool:
        """Layer i (0-indexed) uses global attention?"""
        if self.window <= 0:
            return True
        if self.global_layers is not None:
            return i in self.global_layers
        if self.global_every <= 0:
            return False
        return (i + 1) % self.global_every == 0

    def param_count(self) -> int:
        """Analytic parameter count (embedding included once if tied)."""
        from repro_torch.core.profiler import profile_arch   # avoids a cycle
        prof = profile_arch(self)
        body = sum(l.bytes_weights for l in prof.layers) // prof.bytes_per_param
        emb = self.vocab * self.d_model
        head = 0 if self.tie_embeddings else self.vocab * self.d_model
        return body + emb + head

    def padded_vocab(self, tp: int) -> int:
        """Vocab rounded up so the embedding shards evenly over ``tp``."""
        mult = tp * 128
        return (self.vocab + mult - 1) // mult * mult

    def reduced(self, *, n_layers: int = 2, d_model: int = 256,
                seq: int = 64) -> "ArchConfig":
        """Smoke-test variant: same family/flavours, tiny dims."""
        n_heads = max(2, min(4, self.n_heads))
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        hd = max(16, d_model // n_heads)
        changes: dict = dict(
            n_layers=n_layers, d_model=d_model, n_heads=n_heads,
            n_kv_heads=n_kv, head_dim=hd, d_ff=2 * d_model,
            vocab=min(self.vocab, 1024), stages=1, tensor=1, virtual=1,
            schedule="auto", mem_limit=0, fsdp=False,
        )
        if self.mla is not None:
            changes["mla"] = MLAConfig(
                q_lora_rank=min(self.mla.q_lora_rank, d_model // 2) if self.mla.q_lora_rank else 0,
                kv_lora_rank=min(self.mla.kv_lora_rank, d_model // 4),
                qk_nope_dim=hd, qk_rope_dim=max(8, hd // 2),
                v_head_dim=hd)
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe, n_routed=4, n_shared=min(self.moe.n_shared, 1),
                top_k=2, d_ff_expert=d_model, first_k_dense=min(self.moe.first_k_dense, 1))
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=32, chunk=16)
        if self.window:
            changes["window"] = min(self.window, seq // 2)
            changes["global_every"] = min(self.global_every, n_layers) or 0
            if self.global_layers is not None:
                changes["global_layers"] = (0,)
        if self.mrope_sections is not None:
            half = hd // 2
            q = half // 4
            changes["mrope_sections"] = (half - 2 * q, q, q)
        if self.n_enc_layers:
            changes["n_enc_layers"] = n_layers // 2
            changes["n_layers"] = n_layers if n_layers % 2 == 0 else n_layers + 1
        return dataclasses.replace(self, **changes)
