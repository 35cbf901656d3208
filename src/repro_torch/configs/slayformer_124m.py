"""slayformer-124m — the paper's own model (§3.5): GPT-2 Small scale with
SLAY attention, 12L x 768d x 12H, vocab 50257 [paper App. H]."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="slayformer-124m", family="decoder",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=50257, gated_mlp=False, tie_embeddings=True,
    attn_kind="slay",
    source="paper App. H (GPT-2 Small + SLAY)",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=256, chunk_size=16)
