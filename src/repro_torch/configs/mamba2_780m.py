"""mamba2-780m — attention-free SSD (state-space duality)
[arXiv:2405.21060; unverified].

SLAY does not apply (no Q/K/V attention anywhere): every layer is an SSD
block (``models/ssm.py``), linear-time with a constant-size decode carry.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, vocab_size=50280, tie_embeddings=True,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    attn_kind="none",
    source="arXiv:2405.21060; unverified",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, vocab_size=256, ssm_state=16,
        ssm_head_dim=16, chunk_size=16)
