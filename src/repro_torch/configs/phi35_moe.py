"""phi3.5-moe-42b-a6.6b — 16-expert top-2 MoE decoder
[hf:microsoft/Phi-3.5-MoE-instruct; hf]."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="decoder",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=6400, vocab_size=32064, tie_embeddings=True,
    moe_experts=16, moe_top_k=2,
    source="hf:microsoft/Phi-3.5-MoE-instruct; hf",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=96, vocab_size=256, moe_experts=4, chunk_size=16)
