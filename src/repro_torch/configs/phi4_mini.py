"""phi4-mini-3.8b — dense decoder, RoPE SwiGLU GQA [arXiv:2412.08905; hf]."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b", family="decoder",
    num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=200064, tie_embeddings=True,
    source="arXiv:2412.08905; hf",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256, chunk_size=16)
