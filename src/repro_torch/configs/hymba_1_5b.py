"""hymba-1.5b — hybrid: attention and mamba heads in parallel in every
layer [arXiv:2411.13676; hf]."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001, tie_embeddings=True,
    ssm_state=16, ssm_expand=2, ssm_head_dim=64,
    source="arXiv:2411.13676; hf",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256, ssm_state=8, ssm_head_dim=16,
        chunk_size=16)
