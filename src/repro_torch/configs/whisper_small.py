"""whisper-small — enc-dec audio backbone; conv frontend is a STUB
(``frame_embeds`` provides precomputed frame embeddings)
[arXiv:2212.04356; unverified]."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="encdec",
    num_layers=12, enc_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    head_dim=64, d_ff=3072, vocab_size=51865, gated_mlp=False,
    enc_seq=1500, frontend="audio", tie_embeddings=True,
    source="arXiv:2212.04356; unverified",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, enc_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256, enc_seq=32,
        chunk_size=16)
