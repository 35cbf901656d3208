"""gemma2-27b — local+global alternating attention, logit softcaps
[arXiv:2408.00118; hf].

Under the SLAY backend the *global* layers linearize; local layers keep the
O(L·w) sliding-window softmax (already sub-quadratic). The attention-logit
softcap is a softmax-logit device and does not apply to kernel scores
(DESIGN.md §Arch-applicability); the final-logit softcap is kept.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b", family="decoder",
    num_layers=46, d_model=4608, num_heads=32, num_kv_heads=16, head_dim=128,
    d_ff=36864, vocab_size=256000, tie_embeddings=True,
    local_window=4096, local_global_period=2,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    source="arXiv:2408.00118; hf",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256, local_window=32,
        chunk_size=16)
