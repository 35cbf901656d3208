"""Architecture configuration for the port.

A torch counterpart of ``repro.configs.base.ArchConfig`` holding the
fields the ported decoder uses. MoE, SSM, hybrid, encoder-decoder and
local/global windows are not ported yet (ROADMAP Queue A item 12).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.features import SlayFeatureConfig
from repro_torch.core.slay import AttentionSpec


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # only "decoder" is ported
    num_layers: int
    d_model: int
    vocab_size: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    final_logit_softcap: float = 0.0
    gated_mlp: bool = True
    tie_embeddings: bool = True
    rope_theta: float = 10000.0
    attn_kind: str = "slay"          # only "slay" is ported
    slay_anchors: int = 8
    slay_prf: int = 16
    slay_quad_nodes: int = 3
    chunk_size: int = 256
    fuse_attention_features: bool = True
    dtype: str = "bfloat16"
    source: str = ""

    @property
    def activation_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    def slay_config(self) -> SlayFeatureConfig:
        return SlayFeatureConfig(
            head_dim=self.resolved_head_dim, num_anchors=self.slay_anchors,
            num_prf=self.slay_prf, num_quad_nodes=self.slay_quad_nodes)

    def attention_spec(self) -> AttentionSpec:
        return AttentionSpec(kind=self.attn_kind, slay=self.slay_config(),
                             chunk_size=self.chunk_size,
                             fuse_features=self.fuse_attention_features)

    def check_supported(self) -> None:
        if self.family != "decoder" or self.attn_kind != "slay":
            raise NotImplementedError(
                f"{self.name}: family={self.family!r}, attn_kind="
                f"{self.attn_kind!r}; the port has the SLAY decoder only so "
                f"far (ROADMAP Queue A items 7 and 12)")
