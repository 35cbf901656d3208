"""grok-1-314b — 8-expert top-2 MoE decoder [hf:xai-org/grok-1; unverified]."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b", family="decoder",
    num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=32768, vocab_size=131072, tie_embeddings=False,
    moe_experts=8, moe_top_k=2,
    source="hf:xai-org/grok-1; unverified",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=96, vocab_size=256, moe_experts=4, chunk_size=16)
