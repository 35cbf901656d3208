"""qwen3-32b — dense decoder with qk-norm, GQA [hf:Qwen/Qwen3-8B; hf]."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b", family="decoder",
    num_layers=64, d_model=5120, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=25600, vocab_size=151936, qk_norm=True, tie_embeddings=False,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B; hf",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256, chunk_size=16)
