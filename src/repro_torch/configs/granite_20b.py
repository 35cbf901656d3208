"""granite-20b — llama-arch code model with MQA (kv=1) [arXiv:2405.04324]."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b", family="decoder",
    num_layers=52, d_model=6144, num_heads=48, num_kv_heads=1, head_dim=128,
    d_ff=24576, vocab_size=49152, tie_embeddings=True,
    source="arXiv:2405.04324; hf",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=1,
        head_dim=16, d_ff=128, vocab_size=256, chunk_size=16)
