"""internvl2-76b — VLM: InternLM2-style LM backbone; InternViT frontend is a
STUB (``patch_embeds`` provides precomputed patch embeddings)
[arXiv:2404.16821; unverified]."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b", family="decoder",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256, tie_embeddings=False,
    frontend="vision", num_patches=256,
    source="arXiv:2404.16821; unverified",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256, num_patches=8, chunk_size=16)
